"""The port's renderer against the JAX package's, on the same inputs.

Both sides get the same field params (carried across by ``convert``), the
same boxes and rays, and the same jitter: the JAX renderer draws it from key
splits, which the tests replay here with ``jax.random`` and hand to the
port's one draw (``renderer._uniform``) in the order the port asks for it.
The port's field is the kernels' plain version on the CPU; the JAX side runs
its default XLA field. Hits, winners, hit counts and bin counts must be
equal. Depth and opacity agree within 1e-5 (max abs), colour within 5e-5 and
composited part features (values up to ~20) within 2e-4: XLA contracts the
bin arithmetic into FMAs inside ``jit``, so its sample positions differ from
the port's by an ulp, and where a field's colour varies fast along a ray
that moves a composited colour by up to 2.8e-5 (measured; the port's
composite lies within 1e-10 of a float64 one on the same samples).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openobj_tpu.core import renderer as jr  # noqa: E402
from openobj_tpu.models import object_field as jof  # noqa: E402
from openobj_tpu.ops import sampling as js  # noqa: E402
from openobj_tpu.utils.geometry import OrientedBox  # noqa: E402
from openobj_torch import convert  # noqa: E402
from openobj_torch.core import renderer as tr  # noqa: E402
from openobj_torch.ops import fused_field as tff  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ATOL = {"color": 5e-5, "partfeat": 2e-4}   # else 1e-5
# bf16: the two encodings differ by up to 1e-5 (test_torch_ops.PE_ATOL), so
# an operand that close to a bf16 rounding boundary rounds the other way
# (one bf16 ulp, 2^-8 of it) and moves a sample's colour; measured here
# depth 2.4e-7, colour 4.5e-4, opacity 6e-8, against bf16-vs-f32
# differences of 2.0e-4 (depth) and 1.5e-3 (colour)
BF16_ATOL = 1e-3
H, W = 12, 16


class Replay:
    """Stands in for ``renderer._uniform``: hands out the given draws in
    order, checking each one's shape against the port's request."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, gen, shape, device):
        a = self.draws.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a).to(device)


def obb_draws(key, n, chunk_size, n_bins):
    """``render_rays_obb``'s jitter: one key per padded chunk, the last
    chunk's draw cut to its rays."""
    n_chunks = -(-n // chunk_size)
    keys = jax.random.split(key, n_chunks)
    return [np.asarray(jax.random.uniform(keys[c], (chunk_size, n_bins)))[
        :min(chunk_size, n - c * chunk_size)] for c in range(n_chunks)]


def batched_draws(key, o, m, chunk, n_bins):
    """``render_frame_batched``'s jitter, one [O, chunk, bins] draw per chunk
    (the port draws all objects of a chunk at once)."""
    n_chunks = -(-m // chunk)
    per_obj = [jax.random.split(k, n_chunks) for k in jax.random.split(key, o)]
    return [np.stack([np.asarray(jax.random.uniform(ks[c], (chunk, n_bins)))
                      for ks in per_obj]) for c in range(n_chunks)]


def make_params(o, h=32, seed=0, alpha_bias=(0.6,)):
    """A stack of JAX fields with noise on every leaf, and an alpha bias per
    object that sets how dense each one is."""
    p = jof.init_stacked_fields(jax.random.PRNGKey(seed), o, hidden=h, clip_size=16)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    p["mlp"] = jax.tree.map(
        lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32), p["mlp"])
    bias = np.resize(np.asarray(alpha_bias, np.float32), o)
    p["mlp"]["out_alpha"]["b"] = bias[:, None]
    return p


def scene(o=3):
    """Boxes in front of a camera at the origin looking down +z."""
    rng = np.random.default_rng(1)
    t_wo = np.tile(np.eye(4, dtype=np.float32), (o, 1, 1))
    for i in range(o):
        a = 0.3 * (i + 1)
        c, s = np.cos(a), np.sin(a)
        t_wo[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        t_wo[i, :3, 3] = [0.4 * (i - 1), 0.1 * i, 2.0 + 0.3 * i]
    extents = rng.uniform(0.6, 1.0, (o, 3)).astype(np.float32)
    centers = t_wo[:, :3, 3] + rng.normal(0, 0.05, (o, 3)).astype(np.float32)
    cam = js.camera_ray_dirs(W, H, 10.0, 10.0, W / 2, H / 2)
    t_wc = np.eye(4, dtype=np.float32)
    t_wc[:3, 3] = [0.05, -0.02, 0.0]
    dirs_c = np.asarray(cam).reshape(-1, 3)
    origins, dirs_w = js.origin_dirs_w(jnp.broadcast_to(jnp.asarray(t_wc), (H * W, 4, 4)),
                                       jnp.asarray(dirs_c))
    return t_wo, extents, centers, np.asarray(origins), np.asarray(dirs_w), np.asarray(cam), t_wc


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, name):
    np.testing.assert_allclose(got.numpy() if hasattr(got, "numpy") else got,
                               np.asarray(ref), atol=ATOL.get(name, 1e-5), rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("two_pass", [False, True])
def test_probe_tighten(two_pass):
    p = make_params(1)
    one_j = jax.tree.map(lambda x: x[0], p)
    one_t = convert.params_from_numpy(one_j, "cpu")
    t_wo, ext, cen, origins, dirs, _, _ = scene(1)
    rng = np.random.default_rng(2)
    near = rng.uniform(1.0, 1.5, 20).astype(np.float32)
    far = near + rng.uniform(0.5, 1.5, 20).astype(np.float32)
    args = (origins[:20], dirs[:20], near, far, cen[0])
    n0, f0 = jr._probe_tighten(one_j, *map(jnp.asarray, args), 16 if two_pass else 8, 5, "f32")
    field = tr._evaluator(one_t, False, 5, "f32")
    n1, f1 = tr._probe_tighten(field, *map(_t, args), 16 if two_pass else 8)
    _close(n1, n0, "near")
    _close(f1, f0, "far")


@pytest.mark.parametrize("two_pass,render_part,n", [
    (False, False, 192),     # three chunks of 64
    (True, False, 150),      # two pass, a ragged last chunk
    (False, True, 100),      # part features composited and projected
])
def test_render_rays_obb(two_pass, render_part, n, monkeypatch):
    p = make_params(1)
    one_j = jax.tree.map(lambda x: x[0], p)
    one_t = convert.params_from_numpy(one_j, "cpu")
    t_wo, ext, cen, origins, dirs, _, _ = scene(1)
    key = jax.random.PRNGKey(4)
    kw = dict(n_bins=24, chunk_size=64, two_pass=two_pass, n_probe=12,
              render_part=render_part)
    ref = jr.render_rays_obb(one_j, jnp.asarray(origins[:n]), jnp.asarray(dirs[:n]),
                             jnp.asarray(t_wo[0]), jnp.asarray(ext[0]), jnp.asarray(cen[0]),
                             key, **kw)
    monkeypatch.setattr(tr, "_uniform", Replay(obb_draws(key, n, 64, 24)))
    got = tr.render_rays_obb(one_t, _t(origins[:n]), _t(dirs[:n]), _t(t_wo[0]), _t(ext[0]),
                             _t(cen[0]), torch.Generator(), **kw)
    assert tr._uniform.draws == []
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(ref["hit"]))
    assert 0 < int(ref["hit"].sum()) < n
    for k in ("depth", "color", "opacity") + (("partfeat",) if render_part else ()):
        _close(got[k], ref[k], k)


def test_render_object_view_and_composite(monkeypatch):
    p = make_params(3)
    t_wo, ext, cen, _, _, cam, t_wc = scene(3)
    views_j, views_t = {}, {}
    for i in range(3):
        pj = jax.tree.map(lambda x: x[i], p)
        obb = OrientedBox(center=t_wo[i, :3, 3].astype(np.float64),
                          r=t_wo[i, :3, :3].astype(np.float64), extent=ext[i].astype(np.float64))
        key = jax.random.PRNGKey(10 + i)
        views_j[i] = jr.render_object_view(pj, obb, cen[i], t_wc, jnp.asarray(cam), key,
                                           n_bins=20, chunk_size=128)
        monkeypatch.setattr(tr, "_uniform", Replay(obb_draws(key, H * W, 128, 20)))
        views_t[i] = tr.render_object_view(convert.params_from_numpy(pj, "cpu"), obb, cen[i],
                                           t_wc, _t(cam), torch.Generator(), n_bins=20,
                                           chunk_size=128)
        np.testing.assert_array_equal(views_t[i]["hit"], views_j[i]["hit"])
        _close(views_t[i]["depth"], views_j[i]["depth"], "depth")
    class_of = {0: 5, 1: 6, 2: 7}
    cj = jr.composite_views(views_j, class_of, H, W, bg_ids=(2,))
    ct = tr.composite_views(views_t, class_of, H, W, bg_ids=(2,))
    for k in ("maskid", "instid"):
        np.testing.assert_array_equal(ct[k], cj[k])
    assert np.abs(ct["rgb"].astype(int) - cj["rgb"].astype(int)).max() <= 1
    _close(ct["depth"], cj["depth"], "depth")


# (name, alpha biases, active, max_hit_rays, two_pass)
_BATCHED = {
    "plain": ((0.6, 0.4, 0.8), (1, 1, 1), 192, False),
    "two_pass": ((0.6, 0.4, 0.8), (1, 1, 1), 192, True),
    "hit_cap": ((0.6, 0.4, 0.8), (1, 1, 1), 16, False),   # under a chunk: padded
    "inactive": ((0.6, 0.4, 0.8), (1, 0, 1), 192, False),
    "transparent": ((0.6, -3.0, 0.8), (1, 1, 1), 192, False),
}


def _batched_inputs(case):
    bias, active, cap, two_pass = _BATCHED[case]
    p = make_params(3, alpha_bias=bias)
    t_wo, ext, cen, origins, dirs, _, _ = scene(3)
    act = np.asarray(active, bool)
    return p, (t_wo, ext, cen, act, origins, dirs), cap, two_pass


@pytest.mark.parametrize("case", list(_BATCHED))
def test_render_frame_batched(case, monkeypatch):
    p, geo, cap, two_pass = _batched_inputs(case)
    key = jax.random.PRNGKey(7)
    kw = dict(n_bins=16, max_hit_rays=cap, chunk=32, two_pass=two_pass, n_probe=8)
    ref = jr.render_frame_batched(p, *map(jnp.asarray, geo), key, **kw)
    monkeypatch.setattr(tr, "_uniform", Replay(batched_draws(key, 3, cap, 32, 16)))
    tff.reset_counts()
    got = tr.render_frame_batched(convert.params_from_numpy(p, "cpu"), *map(_t, geo),
                                  torch.Generator(), **kw)
    n_chunks = -(-cap // 32)
    # one field call per chunk for all objects (two with the probe)
    assert tff.COUNTS["fused_field_plain"] == n_chunks * (2 if two_pass else 1)
    assert tff.COUNTS["field_eager"] == 0
    for k in ("winner", "n_hit"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    hit = np.asarray(ref["winner"]) >= 0
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(np.isinf(got["depth"].numpy()), ~hit)
    _close(got["depth"].numpy()[hit], np.asarray(ref["depth"])[hit], "depth")
    _close(got["color"], ref["color"], "color")
    counts = tr.obb_hit_counts(*map(_t, geo[:2]), _t(geo[3]), *map(_t, geo[4:]))
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jr.obb_hit_counts(*map(jnp.asarray, geo[:2]),
                                                     jnp.asarray(geo[3]),
                                                     *map(jnp.asarray, geo[4:]))))
    if case == "hit_cap":
        assert int(got["n_hit"].max()) > cap
    if case == "inactive":
        assert int(got["n_hit"][1]) == 0 and not (got["winner"] == 1).any()
    if case == "transparent":
        assert not (got["winner"] == 1).any()


@pytest.mark.parametrize("two_pass", [False, True])
def test_render_frame_bucketed(two_pass, monkeypatch):
    p = make_params(4, alpha_bias=(0.6, 0.4, 0.8, 0.5))
    t_wo, ext, cen, origins, dirs, _, _ = scene(4)
    ext[1] *= 0.3    # a small object: fewer bins
    ext[3] *= 0.5
    geo = (t_wo, ext, cen, np.ones(4, bool), origins, dirs)
    key = jax.random.PRNGKey(9)
    kw = dict(n_bins=32, max_hit_rays=H * W, chunk=32, two_pass=two_pass, n_probe=8,
              min_bins=8)
    calls = []
    orig = jr.render_frame_batched

    def record(params, t_wo_, *args, **kwargs):
        calls.append((args[-1], t_wo_.shape[0], kwargs["max_hit_rays"], kwargs["n_bins"]))
        return orig(params, t_wo_, *args, **kwargs)

    monkeypatch.setattr(jr, "render_frame_batched", record)
    ref = jr.render_frame_bucketed(p, *map(jnp.asarray, geo), key, **kw)
    assert len(calls) >= 2
    draws = [d for k, o, m, b in calls for d in batched_draws(k, o, m, 32, b)]
    monkeypatch.setattr(tr, "_uniform", Replay(draws))
    got = tr.render_frame_bucketed(convert.params_from_numpy(p, "cpu"), *map(_t, geo),
                                   torch.Generator(), **kw)
    assert tr._uniform.draws == []
    np.testing.assert_array_equal(got["bins"], np.asarray(ref["bins"]))
    np.testing.assert_array_equal(tr.bucket_bin_counts(ext, np.ones(4, bool), 32, min_bins=8),
                                  jr.bucket_bin_counts(ext, np.ones(4, bool), 32, min_bins=8))
    for k in ("winner", "n_hit"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    hit = np.asarray(ref["winner"]) >= 0
    assert hit.any()
    _close(got["depth"].numpy()[hit], np.asarray(ref["depth"])[hit], "depth")
    _close(got["color"], ref["color"], "color")


def test_bf16_not_ported():
    """render_rays_obb at compute_dtype="bf16" (the plain version of K1's
    bf16 build here, the XLA field in bf16 on the JAX side; their forwards
    round the same operands) against the JAX package's: hits equal, depth, colour and
    opacity within BF16_ATOL; and the JAX test's own bound on bf16 against
    f32 (test_batched_render.py: depth and colour within 0.05)."""
    p = make_params(1)
    one_j = jax.tree.map(lambda x: x[0], p)
    one_t = convert.params_from_numpy(one_j, "cpu")
    t_wo, ext, cen, origins, dirs, _, _ = scene(1)
    n, key = 150, jax.random.PRNGKey(4)
    kw = dict(n_bins=24, chunk_size=64)
    args = (origins[:n], dirs[:n], t_wo[0], ext[0], cen[0])
    ref = jr.render_rays_obb(one_j, *map(jnp.asarray, args), key, compute_dtype="bf16", **kw)
    got = {}
    for cd in ("bf16", "f32"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tr, "_uniform", Replay(obb_draws(key, n, 64, 24)))
            got[cd] = tr.render_rays_obb(one_t, *map(_t, args), torch.Generator(),
                                         compute_dtype=cd, **kw)
    np.testing.assert_array_equal(got["bf16"]["hit"].numpy(), np.asarray(ref["hit"]))
    assert 0 < int(ref["hit"].sum()) < n
    for k in ("depth", "color", "opacity"):
        np.testing.assert_allclose(got["bf16"][k].numpy(), np.asarray(ref[k]),
                                   atol=BF16_ATOL, rtol=0, err_msg=k)
    hit = (got["bf16"]["hit"] & got["f32"]["hit"]).numpy()
    for k in ("depth", "color"):
        d = np.abs(got["bf16"][k].numpy() - got["f32"][k].numpy())
        assert (d[hit] if k == "depth" else d).max() < 0.05, k

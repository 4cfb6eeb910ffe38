"""The port's array ops against the JAX package on the same numpy inputs:
positional encoding, the object field, the loss, ray sampling and the
frame store."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from openobj_tpu.core import frame_store as jfs  # noqa: E402
from openobj_tpu.models import object_field as jof  # noqa: E402
from openobj_tpu.ops import embedding as jemb  # noqa: E402
from openobj_tpu.ops import losses as jlosses  # noqa: E402
from openobj_tpu.ops import sampling as jsamp  # noqa: E402
from openobj_torch import convert  # noqa: E402
from openobj_torch.core import frame_store as tfs  # noqa: E402
from openobj_torch.models import object_field as tof  # noqa: E402
from openobj_torch.ops import embedding as temb  # noqa: E402
from openobj_torch.ops import losses as tlosses  # noqa: E402
from openobj_torch.ops import sampling as tsamp  # noqa: E402


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


# --------------------------------------------------------------------------- #
# positional encoding
# --------------------------------------------------------------------------- #

# "direct" agrees to an ulp of sine. "recurrence" derives band k from the
# first band's (sin, cos) by k doublings; each doubling multiplies a
# difference in (s, c) by 2 to 4, and the JAX and PyTorch CPU sines differ
# by an ulp on some inputs, so the top band (k = 5) can differ by ~100 ulp:
# this test at 1e-6 failed with 6.1e-6 on these inputs.
PE_ATOL = {"direct": 1e-6, "recurrence": 1e-5}


@pytest.mark.parametrize("impl", ["recurrence", "direct"])
def test_positional_encoding_matches_jax(impl):
    rng = np.random.default_rng(0)
    # points on a 2^-8 grid and directions on a 2^-10 grid: every product
    # t_i d_i and every partial sum of the projection is exact in float32,
    # so the projection is the same bits however it is rounded (XLA's CPU
    # dot contracts it to FMAs or not, in an order of its code generation's
    # choosing, and the doublings amplify one ulp of it ~32x past PE_ATOL)
    x = np.round(rng.normal(size=(256, 3)) * 0.8 * 256).astype(np.float32) / 256
    dirs = np.round((jemb.ICOSPHERE_DIRS + 0.01 * rng.normal(size=(21, 3))) * 1024
                    ).astype(np.float32) / 1024
    ct = rng.normal(size=(256, 129)).astype(np.float32)

    def jf(d):
        return jemb.positional_encoding({"dirs": d, "scale": jnp.float32(2.0)},
                                        jnp.asarray(x), impl=impl)

    e0 = np.asarray(jf(jnp.asarray(dirs)))
    g0 = np.asarray(jax.grad(lambda d: jnp.sum(jf(d) * ct))(jnp.asarray(dirs)))

    d1 = _t(dirs).requires_grad_(True)
    e1 = temb.positional_encoding({"dirs": d1, "scale": torch.tensor(2.0)}, _t(x), impl=impl)
    (g1,) = torch.autograd.grad((e1 * _t(ct)).sum(), d1)
    assert e1.shape == (256, 129)
    np.testing.assert_allclose(e1.detach().numpy(), e0, atol=PE_ATOL[impl], rtol=0)
    # the dirs gradient sums 256 points x 6 bands with factors up to 32 pi
    assert _rel(g1.numpy(), g0) < 1e-5


def test_embedding_layout():
    assert temb.embedding_split(5) == jemb.embedding_split(5) == (87, 42)
    assert temb.embedding_dim(5) == jemb.embedding_dim(5) == 129
    np.testing.assert_array_equal(temb.ICOSPHERE_DIRS, jemb.ICOSPHERE_DIRS)


# --------------------------------------------------------------------------- #
# the object field
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("clip_hidden_only", [False, True])
def test_object_field_forward_and_grads(clip_hidden_only):
    O, N, H, C = 3, 24, 16, 12
    p = jof.init_stacked_fields(jax.random.PRNGKey(0), O, hidden=H, clip_size=C)
    p["pe"]["scale"] = jnp.asarray([2.0, 5.0, 2.0])
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(O, 2, N // 2, 3)) * 0.6).astype(np.float32)
    cw = H if clip_hidden_only else C
    cts = [rng.normal(size=(O, 2, N // 2, k)).astype(np.float32) for k in (1, 3, cw)]

    def jloss(params):
        a, c, f = jof.field_apply_stacked(params, jnp.asarray(pts),
                                          clip_hidden_only=clip_hidden_only)
        return sum(jnp.sum(o * t) for o, t in zip((a, c, f), cts)), (a, c, f)

    (_, outs0), g0 = jax.value_and_grad(jloss, has_aux=True)(p)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    leaves = []
    for path, leaf in _paths(tp):
        leaf.requires_grad_(path[-1] != "scale")
        leaves.append((path, leaf))
    outs1 = tof.field_apply_stacked(tp, _t(pts), clip_hidden_only=clip_hidden_only)
    loss1 = sum((o * _t(t)).sum() for o, t in zip(outs1, cts))
    trainable = [(q, x) for q, x in leaves if x.requires_grad]
    grads = torch.autograd.grad(loss1, [x for _, x in trainable], allow_unused=True)
    # an unused head (out_clip under clip_hidden_only) gets no gradient
    # here and zeros in JAX
    grads = [torch.zeros_like(x) if g is None else g
             for (_, x), g in zip(trainable, grads)]
    for o0, o1 in zip(outs0, outs1):
        assert o1.shape == o0.shape
        assert _rel(o1.detach().numpy(), o0) < 1e-5
    g0n = jax.tree.map(np.asarray, g0)
    for (path, _), g in zip(trainable, grads):
        ref = g0n
        for k in path:
            ref = ref[k]
        assert _rel(g.numpy(), ref) < 1e-5, path
    assert np.abs(g0n["pe"]["scale"]).max() == 0.0


# bf16 against the JAX package's XLA field in bf16 (both round every matmul's
# operands to bf16, sum in f32, and round each operand's gradient to bf16 by
# the cast's transpose): outputs rel 1e-3, gradients per leaf rel 5e-3. The
# two positional encodings differ by up to 1e-5 (PE_ATOL), and an operand
# that lies that close to a bf16 rounding boundary rounds the other way: one
# bf16 ulp (2^-8 relative) on that element. Measured over three seeds:
# outputs <= 5.7e-4, leaves <= 3.0e-3 (seed 0, this test: 4.8e-5 and
# 7.4e-4), against bf16-vs-f32 distances of 2e-3 to 0.2; the JAX package's
# own two bf16 paths differ by 8e-3.
BF16_FWD_RTOL, BF16_RTOL = 1e-3, 5e-3


def test_object_field_bf16_matches_jax_xla():
    O, N, H, C = 3, 24, 16, 12
    p = jof.init_stacked_fields(jax.random.PRNGKey(0), O, hidden=H, clip_size=C)
    p["pe"]["scale"] = jnp.asarray([2.0, 5.0, 2.0])
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(O, N, 3)) * 0.6).astype(np.float32)
    cts = [rng.normal(size=(O, N, k)).astype(np.float32) for k in (1, 3, H)]

    def jloss(params):
        a, c, f = jof.field_apply_stacked(params, jnp.asarray(pts), clip_hidden_only=True,
                                          compute_dtype="bf16")
        return sum(jnp.sum(o * t) for o, t in zip((a, c, f), cts)), (a, c, f)

    (_, outs0), g0 = jax.jit(jax.value_and_grad(jloss, has_aux=True))(p)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    trainable = [(q, x.requires_grad_(True)) for q, x in _paths(tp)
                 if q[-1] != "scale" and q[1] != "out_clip"]
    outs1 = tof.field_apply_stacked(tp, _t(pts), clip_hidden_only=True, compute_dtype="bf16")
    grads = torch.autograd.grad(sum((o * _t(t)).sum() for o, t in zip(outs1, cts)),
                                [x for _, x in trainable])
    for o0, o1 in zip(outs0, outs1):
        assert _rel(o1.detach().numpy(), o0) < BF16_FWD_RTOL
    g0n = jax.tree.map(np.asarray, g0)
    for (path, _), g in zip(trainable, grads):
        ref = g0n
        for k in path:
            ref = ref[k]
        assert _rel(g.numpy(), ref) < BF16_RTOL, path


@pytest.mark.parametrize("stacked", [True, False])
def test_factored_cosine_loss_bf16_matches_jax(stacked):
    """The part term at bf16, value and jax.grad: W' rounded once, the
    C-wide products summed in f32, each product's W' gradient rounded to
    bf16 and the two added in bf16 (equal bit for bit here; stated rel
    1e-6)."""
    rng = np.random.default_rng(4)
    o, r, h, c = 3, 20, 8, 64
    lead = (o,) if stacked else ()
    w = (rng.normal(size=(*lead, h, c)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(*lead, c)) * 0.1).astype(np.float32)
    hid = rng.normal(size=(o, r, h)).astype(np.float32)
    op = rng.uniform(0, 1, (o, r)).astype(np.float32)
    gt = rng.integers(-127, 128, (o, r, c)).astype(np.int8)
    ct = rng.normal(size=(o, r)).astype(np.float32)

    def jf(*a):
        head = {"out_clip": {"w": a[0], "b": a[1]}}
        return jnp.sum(jlosses.factored_cosine_loss(head, a[2], a[3], jnp.asarray(gt),
                                                    compute_dtype="bf16") * ct)

    v0, g0 = jax.value_and_grad(jf, argnums=(0, 1, 2, 3))(w, b, hid, op)
    targs = [_t(x).requires_grad_(True) for x in (w, b, hid, op)]
    v1 = (tlosses.factored_cosine_loss({"out_clip": {"w": targs[0], "b": targs[1]}},
                                       targs[2], targs[3], _t(gt), compute_dtype="bf16")
          * _t(ct)).sum()
    g1 = torch.autograd.grad(v1, targs)
    assert _rel(v1.detach().numpy(), np.asarray(v0)) < 1e-6
    for x, y in zip(g1, g0):
        assert _rel(x.numpy(), np.asarray(y)) < 1e-6


def test_clip_project_matches_jax():
    """Composite-then-project: the stacked and single-model forms, with the
    bias weighted by the ray opacity."""
    from openobj_tpu.ops import mlp as jmlp
    from openobj_torch.ops import mlp as tmlp

    rng = np.random.default_rng(7)
    w = rng.normal(size=(3, 8, 12)).astype(np.float32)
    b = rng.normal(size=(3, 12)).astype(np.float32)
    hid = rng.normal(size=(3, 5, 8)).astype(np.float32)
    op = rng.uniform(size=(3, 5)).astype(np.float32)
    for sl in (slice(None), 1):     # stacked [O, h, C], then one model [h, C]
        jp = {"out_clip": {"w": jnp.asarray(w[sl]), "b": jnp.asarray(b[sl])}}
        tp = {"out_clip": {"w": _t(w[sl]), "b": _t(b[sl])}}
        for o in (None, op[sl]):
            y0 = np.asarray(jmlp.clip_project(jp, jnp.asarray(hid[sl]),
                                              None if o is None else jnp.asarray(o)))
            y1 = tmlp.clip_project(tp, _t(hid[sl]), None if o is None else _t(o)).numpy()
            np.testing.assert_allclose(y1, y0, rtol=1e-5, atol=1e-6)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_slot_ops_roundtrip():
    gen = torch.Generator().manual_seed(0)
    st = tof.init_stacked_fields(gen, 4, hidden=8, clip_size=4, device="cpu")
    one = tof.init_field_params(gen, hidden=8, clip_size=4, scale=3.0, device="cpu")
    st2 = tof.write_slot(st, 2, one)
    got = tof.slice_slot(st2, 2)
    for (path, a), (_, b) in zip(_paths(got), _paths(one)):
        assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(_paths(tof.slice_slot(st2, 1)), _paths(tof.slice_slot(st, 1))):
        assert torch.equal(a, b), path


# --------------------------------------------------------------------------- #
# the loss
# --------------------------------------------------------------------------- #


def test_step_batch_loss_matches_jax():
    O, R, P, H, C = 3, 16, 10, 8, 32
    rng = np.random.default_rng(2)
    alpha = rng.normal(size=(O, R, P)).astype(np.float32) * 3
    color = rng.uniform(size=(O, R, P, 3)).astype(np.float32)
    hidden = np.maximum(rng.normal(size=(O, R, P, H)), 0).astype(np.float32)
    gt_d = rng.uniform(0.5, 3.0, (O, R)).astype(np.float32)
    gt_rgb = rng.uniform(size=(O, R, 3)).astype(np.float32)
    state = rng.integers(0, 3, (O, R)).astype(np.int32)
    state[2] = jsamp.STATE_UNKNOWN                   # an all-masked row
    z = np.sort(rng.uniform(0.1, 4.0, (O, R, P)), -1).astype(np.float32)
    gt_pf = rng.integers(-127, 128, (O, R, C)).astype(np.int8)
    gt_pf[0, 3] = 0                                  # a zero part feature
    head = {"out_clip": {"w": rng.normal(size=(O, H, C)).astype(np.float32) * 0.3,
                         "b": rng.normal(size=(O, C)).astype(np.float32) * 0.1}}
    active = np.array([True, True, False])

    def jf(a, c, f, w, b):
        return jlosses.step_batch_loss(
            a, c, gt_d, gt_rgb, state, z, active=active,
            gt_partfeat=jnp.asarray(gt_pf), pred_partfeat_hidden=f,
            partfeat_head={"out_clip": {"w": w, "b": b}})

    args = (alpha, color, hidden, head["out_clip"]["w"], head["out_clip"]["b"])
    tot0, per0 = jf(*args)
    g0 = jax.grad(lambda *a: jf(*a)[0], argnums=(0, 1, 2, 3, 4))(*args)

    targs = [_t(a).requires_grad_(True) for a in args]
    tot1, per1 = tlosses.step_batch_loss(
        targs[0], targs[1], _t(gt_d), _t(gt_rgb), _t(state), _t(z), active=_t(active),
        gt_partfeat=_t(gt_pf), pred_partfeat_hidden=targs[2],
        partfeat_head={"out_clip": {"w": targs[3], "b": targs[4]}})
    g1 = torch.autograd.grad(tot1, targs)
    assert _rel(tot1.detach().numpy(), np.asarray(tot0)) < 1e-5
    assert _rel(per1.detach().numpy(), np.asarray(per0)) < 1e-5
    assert float(per1[2].detach()) == 0.0
    for a, b in zip(g1, g0):
        assert np.isfinite(a.numpy()).all()
        assert _rel(a.numpy(), np.asarray(b)) < 1e-5


# --------------------------------------------------------------------------- #
# sampling
# --------------------------------------------------------------------------- #


def test_deterministic_sampling_exact():
    d0 = np.asarray(jsamp.camera_ray_dirs(32, 24, 20.0, 21.0, 15.5, 11.5))
    d1 = tsamp.camera_ray_dirs(32, 24, 20.0, 21.0, 15.5, 11.5, device="cpu").numpy()
    np.testing.assert_array_equal(d1, d0)
    e0 = np.asarray(jsamp.camera_ray_dirs(8, 6, 5.0, 5.0, 4.0, 3.0, depth_type="euclidean"))
    e1 = tsamp.camera_ray_dirs(8, 6, 5.0, 5.0, 4.0, 3.0, depth_type="euclidean", device="cpu")
    np.testing.assert_allclose(e1.numpy(), e0, rtol=1e-7, atol=0)

    rng = np.random.default_rng(3)
    o = rng.normal(size=(40, 3)).astype(np.float32)
    dr = rng.normal(size=(40, 3)).astype(np.float32)
    z = rng.uniform(0, 4, (40, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tsamp.rays_to_points(_t(o), _t(dr), _t(z), 0.5).numpy(),
        np.asarray(jsamp.rays_to_points(o, dr, z, 0.5)))
    lo, hi = np.array([-1.0, -1.0, -1.0], np.float32), np.array([1.0, 2.0, 1.0], np.float32)
    for a, b in zip(tsamp.ray_box_intersection(_t(o), _t(dr), _t(lo), _t(hi)),
                    jsamp.ray_box_intersection(o, dr, lo, hi)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    t_wc = rng.normal(size=(5, 4, 4)).astype(np.float32)
    dc = rng.normal(size=(5, 9, 3)).astype(np.float32)
    for a, b in zip(tsamp.origin_dirs_w(_t(t_wc)[:, None], _t(dc)),
                    jsamp.origin_dirs_w(jnp.asarray(t_wc)[:, None], jnp.asarray(dc))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_normal_and_stratified_bins_same_law():
    """Random pieces agree in distribution: a two-sample KS test per order
    statistic (per bin) between the JAX and the port's draws."""
    n = 20000
    depth = np.full((n,), 2.0, np.float32)
    zj = np.asarray(jsamp.normal_bins(jax.random.PRNGKey(0), jnp.asarray(depth), 9, 0.1))
    gen = torch.Generator().manual_seed(0)
    zt = tsamp.normal_bins(gen, _t(depth), 9, 0.1).numpy()
    assert zt.shape == (n, 9)
    assert (np.diff(zt, axis=-1) >= 0).all()
    assert np.abs(zt - 2.0).max() <= 0.1 + 1e-6
    for i in range(9):
        assert stats.ks_2samp(zj[:, i], zt[:, i]).pvalue > 1e-3, i

    lo = np.full((n,), 0.5, np.float32)
    hi = np.full((n,), 2.5, np.float32)
    sj = np.asarray(jsamp.stratified_bins(jax.random.PRNGKey(1), lo, hi, 4, (n,)))
    st = tsamp.stratified_bins(gen, _t(lo), _t(hi), 4, (n,), device="cpu").numpy()
    for i in range(4):
        assert st[:, i].min() >= 0.5 + 0.5 * i - 1e-6
        assert st[:, i].max() <= 0.5 + 0.5 * (i + 1) + 1e-6
        assert stats.ks_2samp(sj[:, i], st[:, i]).pvalue > 1e-3, i


def test_sample_z_values_modes():
    """Every ray's lattice follows its mode: invalid depth -> [0, max],
    valid -> front bins below d - eps (clamped at min), back bins within
    [d - eps, d + eps] for this-object rays, [d - eps, d + stop] else."""
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.0, 3.0, (2000,)).astype(np.float32)
    depth[:300] = 0.0
    depth[300:400] = 0.05                       # closer than surface_eps
    state = rng.integers(0, 3, (2000,)).astype(np.int32)
    gen = torch.Generator().manual_seed(1)
    z = tsamp.sample_z_values(gen, _t(depth), _t(state), 0.0, 1, 9, 0.1, 0.05).numpy()
    assert z.shape == (2000, 10)
    assert (z[:300] >= 0).all() and (z[:300] <= depth.max() + 1e-6).all()
    v = depth > 0
    assert (z[v, 0] <= np.maximum(depth[v] - 0.1, 0.0) + 1e-6).all()
    this = v & (state == 1)
    assert (np.abs(z[this, 1:] - depth[this, None]) <= 0.1 + 1e-6).all()
    other = v & (state != 1)
    assert (z[other, 1:] >= np.maximum(depth[other, None] - 0.1, 0) - 1e-6).all()
    assert (z[other, 1:] <= depth[other, None] + 0.05 + 1e-6).all()


# --------------------------------------------------------------------------- #
# frame store
# --------------------------------------------------------------------------- #


def test_pack_unpack_bit_exact_against_jax():
    rng = np.random.default_rng(5)
    depth = rng.uniform(0, 8, (2, 6, 7)).astype(np.float32)
    depth[0, 0, 0] = np.nan
    inst = rng.integers(-1, 60, (2, 6, 7)).astype(np.int32)
    rgb = rng.integers(0, 256, (2, 6, 7, 3)).astype(np.uint8)
    pj = np.asarray(jfs.pack_pixels(jnp.asarray(depth), jnp.asarray(inst), jnp.asarray(rgb)))
    pt = tfs.pack_pixels(_t(depth), _t(inst), _t(rgb))
    assert pt.dtype == torch.int32 and pt.shape == (3, 2, 6, 7)
    np.testing.assert_array_equal(pt.numpy(), pj.view(np.int32))
    np.testing.assert_array_equal(tfs.unpack_depth(pt).numpy().view(np.int32),
                                  depth.view(np.int32))
    np.testing.assert_array_equal(tfs.unpack_inst(pt).numpy(), inst)
    np.testing.assert_array_equal(tfs.unpack_rgb(pt).numpy(), rgb)


def test_append_frame_and_partfeat_store():
    rng = np.random.default_rng(6)
    js = jfs.init_frame_store(2, 8, 10, part_feat_dim=16, part_down=2)
    ts = tfs.init_frame_store(2, 8, 10, part_feat_dim=16, part_down=2, device="cpu")
    for at in (None, None, 0):                 # two appends, then an overwrite
        frame = (rng.integers(0, 256, (8, 10, 3)).astype(np.uint8),
                 rng.uniform(0, 5, (8, 10)).astype(np.float32),
                 rng.integers(-1, 5, (8, 10)).astype(np.int32),
                 rng.normal(size=(4, 4)).astype(np.float32),
                 rng.normal(size=(4, 5, 16)).astype(np.float32))
        js, i0 = jfs.append_frame(js, *frame[:4], partfeat=frame[4], at=at)
        ts, i1 = tfs.append_frame(ts, *frame[:4], partfeat=frame[4], at=at)
        assert i0 == i1
    np.testing.assert_array_equal(ts.packed.numpy(), np.asarray(js.packed).view(np.int32))
    np.testing.assert_array_equal(ts.t_wc.numpy(), np.asarray(js.t_wc))
    assert ts.n_frames == int(js.n_frames) == 2
    np.testing.assert_array_equal(ts.partfeat.numpy(), np.asarray(js.partfeat))
    with pytest.raises(ValueError):
        tfs.append_frame(ts, *frame[:4])

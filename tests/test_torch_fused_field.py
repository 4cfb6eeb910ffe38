"""The port's fused field against the JAX fused field.

On the CPU the port runs the kernels' plain version; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_fused_field.py does, at
hidden widths 16, 32 and 64 (the card runs all three on its tensor-core
K1/K2), and in bf16 (``compute_dtype``) at 32, the foreground's width: the
plain version is one code for every width, and the bf16 kernels are held
to it at every width in tests/test_torch_kernel_emulation.py. The
CUDA kernels are held against the plain version in
tests/test_torch_kernels.py (needs a GPU, not JAX).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openobj_tpu.models import object_field as jof  # noqa: E402
from openobj_tpu.ops import fused_field as jff  # noqa: E402
from openobj_torch import convert  # noqa: E402
from openobj_torch.models import object_field as tof  # noqa: E402
from openobj_torch.ops import fused_field as tff  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

FWD_ATOL = 1e-5


def _setup(o=3, n=40, h=32, seed=0):
    p = jof.init_stacked_fields(jax.random.PRNGKey(seed), o, hidden=h, clip_size=64, scale=2.0)
    # heterogeneous per-object scales (bg=5 vs fg=2 in the real system)
    p["pe"]["scale"] = jnp.asarray(([2.0, 5.0, 2.0] * o)[:o])
    rng = np.random.default_rng(seed + 1)
    pts = (rng.normal(size=(o, n, 3)) * 0.7).astype(np.float32)
    return p, pts, rng


def _torch_params(p, requires_grad=False):
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    leaves = []

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            elif requires_grad and k != "scale":
                v.requires_grad_(True)
                leaves.append((prefix + (k,), v))
    walk(tp, ())
    return tp, leaves


def _grads_match(g_jax, leaves, grads, rtol):
    gn = jax.tree.map(np.asarray, g_jax)
    for (path, _), g in zip(leaves, grads):
        ref = gn
        for k in path:
            ref = ref[k]
        g = np.zeros_like(ref) if g is None else g.numpy()
        d = np.abs(g - ref).max()
        rel = d / (np.abs(ref).max() + 1e-8)
        assert rel < rtol, f"{path}: rel {rel:.2e}"


@pytest.mark.parametrize("h", [16, 32, 64])
@pytest.mark.parametrize("do_clip", [True, False])
def test_forward_matches_jax(do_clip, h):
    p, pts, _ = _setup(h=h)
    a0, c0, f0 = jff.field_apply_stacked_fused(p, jnp.asarray(pts), do_clip=do_clip)
    tp, _ = _torch_params(p)
    a1, c1, f1 = tff.field_apply_stacked_fused(tp, torch.from_numpy(pts), do_clip=do_clip)
    np.testing.assert_allclose(a1.numpy(), np.asarray(a0), atol=FWD_ATOL)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c0), atol=FWD_ATOL)
    if do_clip:
        np.testing.assert_allclose(f1.numpy(), np.asarray(f0), atol=FWD_ATOL)
    else:
        assert f0 is None and f1 is None


@pytest.mark.parametrize("h", [16, 32, 64])
@pytest.mark.parametrize("n,do_clip,rtol", [
    (40, True, 3e-5),      # one tile
    (40, False, 3e-5),
    (600, True, 2e-4),     # N > 512: two backward tiles on the JAX side
])
def test_grads_match_jax(n, do_clip, rtol, h):
    p, pts, rng = _setup(o=2 if n > 512 else 3, n=n, h=h)
    o = pts.shape[0]
    cts = [rng.normal(size=(o, n, k)).astype(np.float32) for k in (1, 3, h)]

    def jloss(params):
        a, c, f = jff.field_apply_stacked_fused(params, jnp.asarray(pts), do_clip=do_clip)
        out = jnp.sum(a * cts[0]) + jnp.sum(c * cts[1])
        return out + (jnp.sum(f * cts[2]) if do_clip else 0.0)

    g0 = jax.grad(jloss)(p)
    tp, leaves = _torch_params(p, requires_grad=True)
    a, c, f = tff.field_apply_stacked_fused(tp, torch.from_numpy(pts), do_clip=do_clip)
    loss = (a * torch.from_numpy(cts[0])).sum() + (c * torch.from_numpy(cts[1])).sum()
    if do_clip:
        loss = loss + (f * torch.from_numpy(cts[2])).sum()
    grads = torch.autograd.grad(loss, [x for _, x in leaves], allow_unused=True)
    _grads_match(g0, leaves, grads, rtol)
    # the PE scale is a constant on both sides
    assert float(jnp.abs(g0["pe"]["scale"]).max()) == 0.0
    assert tp["pe"]["scale"].grad is None


def test_single_object_wrapper_h128():
    p, pts, _ = _setup(o=2, n=48, h=128)
    p1 = jof.slice_slot(p, 1)
    a0, c0, f0 = jff.field_apply_fused(p1, jnp.asarray(pts[1]))
    tp, _ = _torch_params(p)
    a1, c1, f1 = tff.field_apply_fused(tof.slice_slot(tp, 1), torch.from_numpy(pts[1]))
    assert a1.shape == (48, 1) and c1.shape == (48, 3) and f1.shape == (48, 128)
    for x1, x0 in ((a1, a0), (c1, c0), (f1, f0)):
        np.testing.assert_allclose(x1.numpy(), np.asarray(x0), atol=FWD_ATOL)


def test_max_deg_and_dtype_errors():
    """max_deg 4 is refused; bf16 is computed, equal to the JAX kernel's bf16
    (clip head off, single-object wrapper)."""
    p, pts, _ = _setup()
    tp, _ = _torch_params(p)
    with pytest.raises(NotImplementedError, match="max_deg"):
        tff.field_apply_stacked_fused(tp, torch.from_numpy(pts), max_deg=4)
    p1 = jof.slice_slot(p, 1)
    want = jff.field_apply_fused(p1, jnp.asarray(pts[1]), do_clip=False, compute_dtype="bf16")
    got = tff.field_apply_fused(tof.slice_slot(tp, 1), torch.from_numpy(pts[1]), do_clip=False,
                                compute_dtype="bf16")
    assert got[2] is None and want[2] is None
    for x1, x0 in zip(got[:2], want[:2]):
        np.testing.assert_allclose(x1.numpy(), np.asarray(x0), atol=FWD_ATOL)


# bf16 against the JAX kernel in bf16 (interpret mode): forward max abs 1e-5
# and per leaf max|d|/max|ref| 1e-4, both at roundoff (measured ~1e-6 and
# <= 4e-5, the latter pe.dirs at h=64). The JAX package's two bf16 paths
# (this kernel and the XLA field) differ by 8e-3 on their worst leaf, and
# bf16 moves every leaf but b_alpha by 4e-4 (out_color.b) to 0.3 against
# f32, so 1e-4 tells the kernel's numerics from either.
BF16_GRAD_RTOL = 1e-4


@pytest.mark.parametrize("h", [32])
def test_bf16_matches_jax_kernel(h):
    p, pts, rng = _setup(h=h)
    o, n = pts.shape[:2]
    cts = [rng.normal(size=(o, n, k)).astype(np.float32) for k in (1, 3, h)]

    def jloss(params):
        a, c, f = jff.field_apply_stacked_fused(params, jnp.asarray(pts), compute_dtype="bf16")
        return jnp.sum(a * cts[0]) + jnp.sum(c * cts[1]) + jnp.sum(f * cts[2]), (a, c, f)

    (_, outs0), g0 = jax.value_and_grad(jloss, has_aux=True)(p)
    tp, leaves = _torch_params(p, requires_grad=True)
    outs1 = tff.field_apply_stacked_fused(tp, torch.from_numpy(pts), compute_dtype="bf16")
    for x1, x0 in zip(outs1, outs0):
        np.testing.assert_allclose(x1.detach().numpy(), np.asarray(x0), atol=FWD_ATOL)
    loss = sum((x * torch.from_numpy(c)).sum() for x, c in zip(outs1, cts))
    grads = torch.autograd.grad(loss, [x for _, x in leaves], allow_unused=True)
    _grads_match(g0, leaves, grads, BF16_GRAD_RTOL)


def test_bf16_output_check_tells_kernels_apart():
    """bf16_output_errors, the card's gate on K1 bf16's outputs, on the
    plain version's: the plain bf16 itself passes, and so does a copy with a
    rounding flip's worth of change on a few entries; plain f32 in its
    place, a NaN, or one object's outputs gone wrong fail."""
    p, pts, _ = _setup(o=3, n=200, h=32)
    tp, _ = _torch_params(p)
    w, x = tff._pack_params(tp, 32, True), torch.from_numpy(pts)
    ref = tff.fused_field_plain(w, x, 32, True, "bf16")
    ref32 = tff.fused_field_plain(w, x, 32, True)
    for r, r32 in zip(ref, ref32):
        e = tff.bf16_output_errors(r, r, r32, FWD_ATOL)
        assert e["ok"] and e["off"] == 0.0 and e["control_off"] > 10 * tff.BF16_OFF_FRAC, e
        flip = r.clone()
        flip.view(-1)[::499] += 0.5 * e["bf16_max"]      # 0.2% of the entries
        assert tff.bf16_output_errors(flip, r, r32, FWD_ATOL)["ok"]
        assert not tff.bf16_output_errors(r32, r, r32, FWD_ATOL)["ok"]
        nan = r.clone()
        nan.view(-1)[7] = float("nan")
        assert not tff.bf16_output_errors(nan, r, r32, FWD_ATOL)["ok"]
        wrong = r.clone()
        wrong[-1] *= 1.0 + 2.0 ** -7                      # the last object off by a bf16 ulp
        assert not tff.bf16_output_errors(wrong, r, r32, FWD_ATOL)["ok"]


def test_packed_layout_matches_kernel_layout():
    """The packed vector holds every leaf once, in param_layout order, and
    its size is 5h^2 + 268h + 67 (the CUDA source's make_layout)."""
    gen = torch.Generator().manual_seed(0)
    for h in (8, 32, 128):
        params = tof.init_stacked_fields(gen, 2, hidden=h, clip_size=16, device="cpu")
        w = tff._pack_params(params, h, True)
        assert w.shape == (2, tff.packed_size(h)) == (2, 5 * h * h + 268 * h + 67)
        un = tff._unpack(w, h)
        m = params["mlp"]
        assert torch.equal(un["w_cat"], m["cat_layer"]["w"])
        assert torch.equal(un["b_oc"][:, 0], m["out_color"]["b"])
        assert torch.equal(un["dirs"], params["pe"]["dirs"])
        assert torch.equal(un["w_clip"], m["clip_linear"]["w"])
        assert not tff._pack_params(params, h, False)[:, -(h + 42) * h - h:].any()


def test_bwd_tile_choice():
    # room_0: fg 64 x 1200 at h=32 takes 608-point tiles (128 blocks, one
    # wave on 132 SMs); bg 1 x 16800 at h=128 one 32-point chunk per tile
    assert tff.bwd_tile(64, 1200, 32, 132, 1 << 30) == 608
    assert tff.bwd_tile(1, 16800, 32, 132, 32) == 32
    assert tff.bwd_tile(1, 40, 32, 132, 1 << 30) == 32


def test_cpu_path_counts_plain_calls():
    p, pts, _ = _setup()
    tp, _ = _torch_params(p)
    before = dict(tff.COUNTS)
    tff.field_apply_stacked_fused(tp, torch.from_numpy(pts))
    assert tff.COUNTS["fused_field_plain"] == before["fused_field_plain"] + 1
    assert tff.COUNTS["fused_field_fwd"] == before["fused_field_fwd"]

"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU (sm_90a) and nvcc: the kernels have no
CPU mode, so without a card they skip. The file imports neither jax nor
openobj_tpu, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import pytest

torch = pytest.importorskip("torch")

from openobj_torch.models import object_field as tof  # noqa: E402
from openobj_torch.ops import fused_field as tff  # noqa: E402

FWD_ATOL = 1e-4      # kernel vs plain forward, max abs
GRAD_RTOL = 1e-3     # per leaf max|d| / max|ref|: sums over points in another order


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused field kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(gen, o, h, device):
    params = tof.init_stacked_fields(gen, o, hidden=h, clip_size=16, device=device)
    return tof.tree_map(
        lambda x: x + 0.05 * torch.randn(x.shape, generator=gen, device=device), params)


@pytest.mark.cuda
@pytest.mark.parametrize("o,n,h,do_clip,wide", [
    (3, 700, 32, True, False),     # ragged last chunk
    (2, 90, 32, False, False),     # clip head off
    (1, 1000, 128, True, False),   # the bg width
    (2, 5, 32, True, False),       # fewer points than a chunk
    # K2 walks 32-point chunks: one chunk - 1, + 1, and a 16-row edge
    (2, 31, 32, True, False),
    (2, 33, 32, True, False),
    (2, 48, 32, True, False),
    (1, 31, 128, True, False),
    (1, 33, 128, True, False),
    (1, 48, 128, True, False),
    (1, 100, 128, False, False),   # h=128, clip head off
    # 104 blocks of 96-point tiles (3 chunks each): fewer blocks than SMs,
    # gradients accumulated on chip across chunks
    (8, 1200, 32, True, False),
    # |t| up to 1.5: the top band's phases pass 32 pi
    (2, 300, 32, True, True),
    (1, 300, 128, True, True),
    # K1 walks 64-point chunks: one chunk - 1 and + 1 at both widths
    (2, 63, 32, True, False),
    (2, 65, 32, True, False),
    (1, 127, 128, True, False),
    (1, 129, 128, True, False),
    # K1's tiles on 132 SMs: 2 chunks per block (80 blocks), clip head off;
    # 4 chunks per block at h=128 (108 blocks), the last tile 40 points
    (2, 5000, 32, False, False),
    (3, 9000, 128, True, False),
])
def test_cuda_kernels_match_plain(cuda_device, o, n, h, do_clip, wide):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = tff._pack_params(_params(gen, o, h, cuda_device), h, do_clip).contiguous()
    if wide:
        pts = 3.0 * torch.rand((o, n, 3), generator=gen, device=cuda_device) - 1.5
    else:
        pts = 0.5 * torch.randn((o, n, 3), generator=gen, device=cuda_device)
    cts = [torch.randn((o, n, k), generator=gen, device=cuda_device) for k in (1, 3, h)]
    outs_k = tff.fused_field_forward_cuda(w, pts, h, do_clip)
    wr = w.detach().requires_grad_(True)
    outs_p = tff.fused_field_plain(wr, pts, h, do_clip)
    for xk, xp in zip(outs_k, outs_p):
        if xp is None:
            assert xk is None
        else:
            assert float((xk - xp.detach()).abs().max()) <= FWD_ATOL
    g_k = tff.fused_field_backward_cuda(w, pts, *cts[:2], cts[2] if do_clip else None,
                                        h, do_clip)
    obj = sum((x * c).sum() for x, c in zip(outs_p, cts) if x is not None)
    (g_p,) = torch.autograd.grad(obj, wr)
    ofs = 0
    for name, (r, c) in tff.param_layout(h):
        ref, got = g_p[:, ofs:ofs + r * c], g_k[:, ofs:ofs + r * c]
        ofs += r * c
        if not do_clip and name in ("w_clip", "b_clip"):
            assert not got.any(), name
            continue
        assert float((got - ref).abs().max()) <= GRAD_RTOL * float(ref.abs().max()) + 1e-7, name


@pytest.mark.cuda
def test_autograd_on_cuda_matches_cpu_plain(cuda_device):
    """field_apply_stacked_fused through the autograd Function on the card
    vs the plain version on the CPU: outputs and every leaf's gradient;
    the card path launches K1, K2 and the reduction, never the plain one."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    p_gpu = _params(gen, 3, 32, cuda_device)
    p_cpu = tof.tree_map(lambda x: x.detach().cpu(), p_gpu)
    pts = torch.randn((3, 40, 10, 3), generator=gen, device=cuda_device)

    def run(params, x):
        leaves = []

        def req(t):
            t = t.detach().requires_grad_(True)
            leaves.append(t)
            return t
        ps = {"pe": {"dirs": req(params["pe"]["dirs"]), "scale": params["pe"]["scale"]},
              "mlp": tof.tree_map(req, params["mlp"])}
        a, c, f = tff.field_apply_stacked_fused(ps, x)
        loss = (a ** 2).sum() + (c * c).sum() + f.abs().sum()
        return (a, c, f), torch.autograd.grad(loss, leaves, allow_unused=True)

    before = dict(tff.COUNTS)
    outs_g, grads_g = run(p_gpu, pts)
    after = dict(tff.COUNTS)
    assert after["fused_field_fwd"] == before["fused_field_fwd"] + 1
    assert after["fused_field_bwd"] == before["fused_field_bwd"] + 1
    assert after["fused_field_bwd_reduce"] == before["fused_field_bwd_reduce"] + 1
    assert after["fused_field_plain"] == before["fused_field_plain"]
    outs_c, grads_c = run(p_cpu, pts.cpu())
    for a, b in zip(outs_g, outs_c):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= FWD_ATOL
    for a, b in zip(grads_g, grads_c):
        if b is None:       # out_clip: unused by the clip-hidden output
            assert a is None
            continue
        assert float((a.cpu() - b).abs().max()) <= GRAD_RTOL * float(b.abs().max()) + 1e-7


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    w = tff._pack_params(_params(gen, 2, 32, cuda_device), 32, True).contiguous()
    pts = torch.randn((2, 8, 3), generator=gen, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tff.fused_field_forward_cuda(w, pts.double(), 32, True)
    with pytest.raises(ValueError, match="contiguous"):
        tff.fused_field_forward_cuda(w, pts.transpose(0, 1).contiguous().transpose(0, 1),
                                     32, True)
    with pytest.raises(ValueError, match="shape"):
        tff.fused_field_forward_cuda(w[:, :-1].contiguous(), pts, 32, True)
    with pytest.raises(ValueError, match="CUDA"):
        tff.fused_field_forward_cuda(w.cpu(), pts.cpu(), 32, True)


@pytest.mark.cuda
def test_unbuilt_width_raises_before_the_forward(cuda_device):
    """K2 is built for h in BWD_WIDTHS: a differentiable call at another
    width raises before K1 runs; without gradients K1 alone runs."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w = tff._pack_params(_params(gen, 2, 64, cuda_device), 64, True).contiguous()
    pts = torch.randn((2, 8, 3), generator=gen, device=cuda_device)
    before = tff.COUNTS["fused_field_fwd"]
    with pytest.raises(ValueError, match="built for"):
        tff.fused_field_apply(w.requires_grad_(True), pts, 64, True)
    assert tff.COUNTS["fused_field_fwd"] == before
    with torch.no_grad():
        alpha, _, _ = tff.fused_field_apply(w, pts, 64, True)
    assert tff.COUNTS["fused_field_fwd"] == before + 1
    assert alpha.shape == (2, 8, 1)

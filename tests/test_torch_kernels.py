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
    # the other tensor-core widths: weights and gradient accumulators on
    # chip at h=16 (K2's tile several chunks long), from L2 at 48 to 112 (one
    # chunk per K2 tile; K1 items of all 4 row tiles)
    (1, 3000, 64, True, False),
    (2, 90, 16, False, False),
    (1, 300, 64, True, True),
    (2, 700, 16, True, False),
    (1, 1792, 64, True, False),    # the synthetic scene's bg shape
    (1, 1000, 48, True, False),
    (2, 333, 48, False, False),
    (1, 2000, 96, True, False),
    (2, 150, 96, False, True),
    (1, 800, 80, True, False),
    (1, 500, 112, True, False),
    (1, 300, 112, False, True),
    # widths without a tensor-core kernel: the SIMT kernels (K2's tile
    # several chunks long)
    (2, 700, 8, True, False),
    (2, 300, 24, True, False),
    (1, 90, 24, False, True),
])
def test_cuda_kernels_match_plain(cuda_device, o, n, h, do_clip, wide):
    assert tff.tensor_core_width(h) == (h % 16 == 0 and 16 <= h <= 128)
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
@pytest.mark.parametrize("h,tc", [(64, True), (24, False)])
def test_unbuilt_width_raises_before_the_forward(cuda_device, h, tc):
    """No width is left unbuilt: a differentiable call launches K1 and,
    under autograd, K2 and the reduction, each counted once at its shape
    (at h=64 the tensor-core kernels, at h=24 the SIMT ones); without
    gradients K1 alone runs."""
    assert tff.tensor_core_width(h) == tc
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w = tff._pack_params(_params(gen, 2, h, cuda_device), h, True).contiguous()
    pts = torch.randn((2, 8, 3), generator=gen, device=cuda_device)
    tff.reset_counts()
    wr = w.detach().requires_grad_(True)
    alpha, color, hclip = tff.fused_field_apply(wr, pts, h, True)
    (g,) = torch.autograd.grad(alpha.sum() + color.sum() + hclip.sum(), wr)
    assert tff.COUNTS_BY_SHAPE == {(k, 2, 8, h): 1 for k in (
        "fused_field_fwd", "fused_field_bwd", "fused_field_bwd_reduce")}
    assert bool(torch.isfinite(g).all()) and g.abs().max() > 0
    with torch.no_grad():
        alpha, _, _ = tff.fused_field_apply(w, pts, h, True)
    assert tff.COUNTS["fused_field_fwd"] == 2 and tff.COUNTS["fused_field_bwd"] == 1
    assert alpha.shape == (2, 8, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,hidden_bg,tc", [
    (8, 24, False),    # widths without a tensor-core kernel: the SIMT K1/K2
    (16, 64, True),    # the tensor-core K1/K2 (weights on chip at 16, from L2 at 64)
])
def test_uncovered_widths_train_on_the_card(cuda_device, hidden, hidden_bg, tc):
    """Widths other than room_0's train on the card through K1/K2 (the SIMT
    kernels at hidden 8 / hidden_bg 24, the tensor-core ones at 16 / 64),
    never the eager field, and the card's per-step losses agree with the
    CPU's (the kernels' plain version) from the same state and batches (rel
    1e-4)."""
    import numpy as np

    from openobj_torch import convert
    from openobj_torch.core import trainer
    from openobj_torch.core.frame_store import append_frame, init_frame_store
    from openobj_torch.core.scene import Camera

    cfg = trainer.TrainConfig(
        n_iters_per_frame=3, win_size=2, n_samples_per_frame=8, win_size_bg=2,
        n_samples_per_frame_bg=16, hidden=hidden, hidden_bg=hidden_bg, clip_size=16,
        part_mode=True, part_down=4)
    assert tff.tensor_core_width(hidden) == tff.tensor_core_width(hidden_bg) == tc
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    state_cpu = trainer.init_train_state(gen, cfg, n_slots=2, device="cpu")
    store = init_frame_store(1, 16, 20, part_feat_dim=16, part_down=4, device="cpu")
    store, _ = append_frame(
        store, rng.integers(0, 255, (16, 20, 3)).astype(np.uint8),
        rng.uniform(0.5, 3.0, (16, 20)).astype(np.float32),
        rng.integers(-1, 3, (16, 20)).astype(np.int32), np.eye(4, dtype=np.float32),
        partfeat=rng.normal(size=(4, 5, 16)).astype(np.float32))
    fg = {"kf_frames": torch.zeros((2, 2), dtype=torch.int32),
          "kf_bbox": torch.tensor([0, 16, 0, 20], dtype=torch.float32).repeat(2, 2, 1),
          "n_kf": torch.ones(2, dtype=torch.int32),
          "latest2": torch.zeros((2, 2), dtype=torch.int32),
          "active": torch.tensor([True, True]),
          "obj_inst": torch.arange(1, 3, dtype=torch.int32),
          "obj_center": torch.zeros((2, 3))}
    bg = {"kf_frames": fg["kf_frames"][0], "kf_bbox": fg["kf_bbox"][0],
          "n_kf": torch.tensor(1, dtype=torch.int32), "latest2": fg["latest2"][0]}
    dirs = Camera(20, 16, 12.0, 12.0, 10.0, 8.0).ray_dirs("cpu")
    fg_b = trainer.sample_fg_batch(gen, store, dirs, fg, cfg, scan_order=True)
    bg_b = trainer.sample_bg_batch(gen, store, dirs, bg, cfg, scan_order=True)
    state_gpu = convert.train_state_from_numpy(convert.to_numpy(state_cpu), cuda_device)
    tff.reset_counts()
    for i in range(cfg.n_iters_per_frame):
        fsl = {k: x[i] for k, x in fg_b.items()}
        bsl = {k: x[i] for k, x in bg_b.items()}
        state_cpu, l_cpu = trainer.run_step(state_cpu, fsl, bsl, fg["active"], cfg,
                                            store.partfeat)
        state_gpu, l_gpu = trainer.run_step(
            state_gpu, {k: x.to(cuda_device) for k, x in fsl.items()},
            {k: x.to(cuda_device) for k, x in bsl.items()},
            fg["active"].to(cuda_device), cfg, store.partfeat.to(cuda_device))
        assert abs(float(l_gpu) - float(l_cpu)) <= 1e-4 * abs(float(l_cpu))
    steps = 2 * cfg.n_iters_per_frame   # fg + bg on each device
    assert tff.COUNTS["field_eager"] == 0
    assert tff.COUNTS["fused_field_fwd"] == tff.COUNTS["fused_field_bwd"] == steps
    assert tff.COUNTS["fused_field_plain"] == steps


@pytest.mark.cuda
def test_render_and_mesh_through_k1_match_plain(cuda_device, monkeypatch):
    """render_frame_batched and eval_grid_occupancy on the card: K1 carries
    every field evaluation (one launch per chunk for all objects) and agrees
    with the same calls through the plain field on the card, with the same
    jitter: winners equal but for at most one ray, depth and colour 1e-3
    where they agree, occupancy 1e-4."""
    import numpy as np

    from openobj_torch.core import meshing, renderer
    from openobj_torch.ops import sampling

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    params = _params(gen, 3, 32, cuda_device)
    params["mlp"]["out_alpha"]["b"] = torch.full((3, 1), 0.5, device=cuda_device)
    t_wo = torch.eye(4, device=cuda_device).repeat(3, 1, 1)
    t_wo[:, :3, 3] = torch.tensor([[-0.4, 0.0, 2.0], [0.0, 0.1, 2.3], [0.4, 0.2, 2.6]])
    ext = torch.full((3, 3), 0.8, device=cuda_device)
    cen = t_wo[:, :3, 3].clone()
    act = torch.ones(3, dtype=torch.bool, device=cuda_device)
    dirs = sampling.camera_ray_dirs(64, 48, 40.0, 40.0, 32.0, 24.0, device=cuda_device)
    dirs = dirs.reshape(-1, 3)
    origins = torch.zeros_like(dirs)
    u = torch.rand((3, 256, 48), generator=gen, device=cuda_device)
    monkeypatch.setattr(renderer, "_uniform",
                        lambda g, shape, device: u[tuple(slice(0, n) for n in shape)])
    args = (params, t_wo, ext, cen, act, origins, dirs, gen)
    kw = dict(n_bins=48, max_hit_rays=1024, chunk=256)
    tff.reset_counts()
    got = renderer.render_frame_batched(*args, **kw)
    assert tff.COUNTS["fused_field_fwd"] == 4 and tff.COUNTS["fused_field_plain"] == 0
    occ_k = meshing.eval_grid_occupancy(tof.slice_slot(params, 1), np.full(3, 0.45),
                                        np.eye(4), cen[1].cpu().numpy(), 40)
    monkeypatch.setattr(tff, "fused_field_apply", tff.fused_field_plain)
    ref = renderer.render_frame_batched(*args, **kw)
    occ_p = meshing.eval_grid_occupancy(tof.slice_slot(params, 1), np.full(3, 0.45),
                                        np.eye(4), cen[1].cpu().numpy(), 40)
    wk, wp = got["winner"], ref["winner"]
    assert int((wk != wp).sum()) <= 1 and int((wk >= 0).sum()) > 100
    same = (wk == wp) & (wk >= 0)
    assert float((got["depth"] - ref["depth"])[same].abs().max()) <= 1e-3
    assert float((got["color"] - ref["color"])[same].abs().max()) <= 1e-3
    assert np.abs(occ_k - occ_p).max() <= 1e-4

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


def bf16_limit(dist: float, cap: float) -> float:
    """The bf16 K2's gate on one gradient leaf: a tenth of the plain
    version's own bf16-vs-f32 distance there, at most ``cap`` (the f32
    gate), and ``cap`` where bf16 does not move it (b_alpha)."""
    return min(cap, 0.1 * dist) if dist > 0 else cap


@pytest.mark.cuda
@pytest.mark.parametrize("o,n,h,do_clip", [
    (3, 700, 32, True),      # ragged last chunk, weights on chip
    (2, 90, 32, False),      # clip head off
    (8, 1200, 32, True),     # K2 tiles of several chunks
    (1, 1000, 128, True),    # the bg width, weights through the ring
    (1, 100, 128, False),
    (1, 16800, 128, True),   # bg: 263 one-chunk tiles, the last 32 points
    (64, 1200, 32, True),    # fg
    (4, 305152, 32, False),  # the render chunk's shape, clip head off
    (2, 700, 16, True),
    (1, 1000, 48, True),
    (1, 1792, 64, True),
    (1, 800, 80, True),
    (1, 2000, 96, True),
    (1, 500, 112, True),
    (2, 300, 24, True),      # the SIMT kernels
    (1, 90, 24, False),
])
def test_cuda_bf16_kernels_match_plain(cuda_device, o, n, h, do_clip):
    """K1/K2 of fused_field_bf16.cu against the plain version in bf16: each
    output by ``bf16_output_errors`` (at most BF16_OFF_FRAC of its entries
    off by more than FWD_ATOL, none further off than the plain bf16 is from
    the plain f32, all finite, and plain f32 in K1's place would fail), each
    gradient leaf within a tenth of its bf16-vs-f32 distance in max abs (at
    most the f32 gate, ``bf16_limit``). K1 is ff_fwd_bf16_kernel and K2
    ff_bwd_bf16_kernel at the tensor-core widths (K2 behind its weight
    conversion), the SIMT kernels at 24; the kernels, K1's launch and the
    worst leaf are printed."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = tff._pack_params(_params(gen, o, h, cuda_device), h, do_clip).contiguous()
    pts = 0.5 * torch.randn((o, n, 3), generator=gen, device=cuda_device)
    cts = [torch.randn((o, n, k), generator=gen, device=cuda_device) for k in (1, 3, h)]
    outs_k = tff.fused_field_forward_cuda(w, pts, h, do_clip, "bf16")
    plain = {}
    for cd in ("bf16", "f32"):
        wr = w.detach().requires_grad_(True)
        outs = tff.fused_field_plain(wr, pts, h, do_clip, cd)
        obj = sum((x * c).sum() for x, c in zip(outs, cts) if x is not None)
        plain[cd] = [None if x is None else x.detach() for x in outs]
        (plain[cd + "_grad"],) = torch.autograd.grad(obj, wr)
    g_k = tff.fused_field_backward_cuda(w, pts, *cts[:2], cts[2] if do_clip else None,
                                        h, do_clip, "bf16")
    fwd = {name: tff.bf16_output_errors(xk, xp, x32, FWD_ATOL)
           for name, xk, xp, x32 in zip(("alpha", "color", "hclip"), outs_k, plain["bf16"],
                                        plain["f32"]) if xp is not None}
    dev = tff.leaf_errors(g_k, plain["bf16_grad"], h)
    dist = tff.leaf_errors(plain["bf16_grad"], plain["f32_grad"], h)
    worst = max(dev, key=lambda k: dev[k] / bf16_limit(dist[k], GRAD_RTOL))
    shown = "; ".join(f"{k} off {e['off']:.2e} (f32 {e['control_off']:.2e}) max abs "
                      f"{e['max_abs']:.2e} (bf16-vs-f32 {e['bf16_max']:.2e})"
                      for k, e in fwd.items())
    print(f"[bf16] {o}x{n} h={h} clip={do_clip} ({tff.kernel_names(h, 'bf16')}; K1 launch "
          f"{tff.fwd_launch(tff._lib('fused_field_bf16'), o, n, h)}): fwd {shown}; "
          f"worst leaf {worst} {dev[worst]:.2e} (bf16-vs-f32 {dist[worst]:.2e}, limit "
          f"{bf16_limit(dist[worst], GRAD_RTOL):.2e})")
    assert (outs_k[2] is None) == (not do_clip)
    for name, e in fwd.items():
        assert e["ok"], (name, e)
    for name, d in dev.items():
        if not do_clip and name in ("w_clip", "b_clip"):
            assert d == 0.0, name
            continue
        assert d <= bf16_limit(dist[name], GRAD_RTOL), (name, d, dist[name])


@pytest.mark.cuda
@pytest.mark.parametrize("o,n,h", [(64, 1200, 32), (1, 16800, 128), (48, 305152, 32),
                                   (2, 700, 16), (1, 1000, 48), (1, 1792, 64), (1, 800, 80),
                                   (1, 2000, 96), (1, 500, 112)])
def test_cuda_k1_bf16_launch(cuda_device, o, n, h):
    """K1 bf16's launch on the card (ff_fwd_launch): with the image on chip
    (h = 16 to 48) at least two blocks resident an SM (its shared memory and
    registers are sized for two) and 64-point chunks; through the ring (64
    to 128) one block of 512 threads and 128-point chunks; tiles of whole
    chunks, as many blocks as the tile implies."""
    plan = tff.fwd_launch(tff._lib("fused_field_bf16"), o, n, h)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    print(f"[bf16 K1 launch] {o}x{n} h={h}: {plan} on {n_sm} SMs")
    assert plan["ring"] == (h >= 64)
    assert plan["blocks_per_sm"] >= (1 if plan["ring"] else 2)
    assert plan["chunk"] == (128 if plan["ring"] else 64)
    assert plan["tile"] % plan["chunk"] == 0 and plan["blocks"] == o * -(-n // plan["tile"])
    assert plan["smem"] <= 232448


@pytest.mark.cuda
def test_bf16_autograd_on_cuda_counts_its_kernels(cuda_device):
    """field_apply_stacked_fused(compute_dtype="bf16") on the card launches
    the bf16 K1 and K2 (K2 behind its weight conversion) and the reduction,
    never the f32 kernels or the plain version, and agrees with the plain
    bf16 on the CPU."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    p_gpu = _params(gen, 3, 32, cuda_device)
    p_cpu = tof.tree_map(lambda x: x.detach().cpu(), p_gpu)
    pts = torch.randn((3, 40, 10, 3), generator=gen, device=cuda_device)

    def run(params, x):
        wr = tof.tree_map(lambda t: t.detach().requires_grad_(True), params)
        a, c, f = tff.field_apply_stacked_fused(wr, x, compute_dtype="bf16")
        g = torch.autograd.grad((a ** 2).sum() + (c * c).sum() + f.abs().sum(),
                                wr["mlp"]["mid1"]["w"])[0]
        return a, g

    tff.reset_counts()
    a_g, g_g = run(p_gpu, pts)
    assert {k: v for k, v in tff.COUNTS.items() if v} == {
        "fused_field_fwd_bf16": 1, "fused_field_bwd_bf16": 1, "fused_field_bwd_bf16_image": 1,
        "fused_field_bwd_reduce": 1}
    a_c, g_c = run(p_cpu, pts.cpu())
    assert float((a_g.detach().cpu() - a_c.detach()).abs().max()) <= FWD_ATOL
    assert float((g_g.cpu() - g_c).abs().max()) <= GRAD_RTOL * float(g_c.abs().max())


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
@pytest.mark.parametrize("hidden,hidden_bg,tc,dtype", [
    (8, 24, False, "f32"),    # widths without a tensor-core kernel: the SIMT K1/K2
    (16, 64, True, "f32"),    # the tensor-core K1/K2 (weights on chip at 16, from L2 at 64)
    (32, 128, True, "bf16"),  # room_0's widths at bf16
    (8, 24, False, "bf16"),
])
def test_uncovered_widths_train_on_the_card(cuda_device, hidden, hidden_bg, tc, dtype):
    """Widths other than room_0's train on the card through K1/K2 (the SIMT
    kernels at hidden 8 / hidden_bg 24, the tensor-core ones at 16 / 64),
    and bf16 through their bf16 build, never the eager field, and the
    card's per-step losses agree with the CPU's (the kernels' plain version)
    from the same state and batches (rel 1e-4)."""
    import numpy as np

    from openobj_torch import convert
    from openobj_torch.core import trainer
    from openobj_torch.core.frame_store import append_frame, init_frame_store
    from openobj_torch.core.scene import Camera

    cfg = trainer.TrainConfig(
        n_iters_per_frame=3, win_size=2, n_samples_per_frame=8, win_size_bg=2,
        n_samples_per_frame_bg=16, hidden=hidden, hidden_bg=hidden_bg, clip_size=16,
        part_mode=True, part_down=4, compute_dtype=dtype)
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
    fwd, bwd = ("fused_field_fwd_bf16", "fused_field_bwd_bf16") if dtype == "bf16" else (
        "fused_field_fwd", "fused_field_bwd")
    assert tff.COUNTS["field_eager"] == 0
    assert tff.COUNTS[fwd] == tff.COUNTS[bwd] == steps
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


ADAMW_RTOL = 1e-6    # flat AdamW kernel vs plain, per leaf max|d| / max|ref|: powf's last bit


@pytest.mark.cuda
@pytest.mark.parametrize("o,h", [(64, 32), (None, 128), (3, 8)])
def test_cuda_adamw_flat_matches_plain(cuda_device, o, h):
    """The flat AdamW kernel against its plain version on the card (stacked
    with some slots frozen, and the unstacked bg model), through the
    trainer's packed-gradient views, three steps; the inputs stay as they
    were and the frozen slots pass through bit for bit."""
    from openobj_torch.core import optim

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    if o is None:
        params = tof.init_field_params(gen, hidden=h, clip_size=512, device=cuda_device)
        state, active = optim.init_adamw_state(params), None
    else:
        params = tof.init_stacked_fields(gen, o, hidden=h, clip_size=512, device=cuda_device)
        state = optim.init_adamw_state(params, n_slots=o)
        active = torch.arange(o, device=cuda_device) % 5 != 3
    kern = plain = (params, state)
    optim.reset_counts()
    for _ in range(3):
        leaves = optim.flatten_with_path(params)
        rows = [x[0].numel() if o else x.numel() for _, x in leaves]
        packed = torch.randn(((o,) if o else ()) + (sum(rows),), generator=gen,
                             device=cuda_device)
        grads, at = {}, 0
        for (path, x), k in zip(leaves, rows):
            optim.set_path(grads, path,
                           (packed[:, at:at + k] if o else packed[at:at + k]).view(x.shape))
            at += k
        before = {q: x.clone() for q, x in optim.flatten_with_path(kern[0])}
        new = optim.adamw_update_flat(kern[0], grads, kern[1], 1e-3, 0.013, active)
        for q, x in optim.flatten_with_path(kern[0]):
            assert torch.equal(before[q], x), q
        kern = new
        plain = optim.adamw_update_flat_plain(plain[0], grads, plain[1], 1e-3, 0.013, active)
    torch.cuda.synchronize()
    assert optim.COUNTS["adamw_flat"] == 3
    assert torch.equal(kern[1].count, plain[1].count)
    for a, b in ((kern[0], plain[0]), (kern[1].mu, plain[1].mu), (kern[1].nu, plain[1].nu)):
        fb = dict(optim.flatten_with_path(b))
        for q, x in optim.flatten_with_path(a):
            scale = float(fb[q].abs().max()) + 1e-30
            assert float((x - fb[q]).abs().max()) / scale <= ADAMW_RTOL, q
            if o is not None and o > 3 and optim.trainable(q):   # slot 3 frozen throughout
                start = dict(optim.flatten_with_path(params))[q][3] if a is kern[0] else 0 * x[3]
                assert torch.equal(x[3], start), q

"""The probe kernels (openobj_torch/csrc/probes.cu) against their plain
PyTorch versions, on a GPU, at ragged shapes: N not a multiple of the tile,
one object, object counts not a multiple of the object tile, chain depths
0, 1, 2 and 4 in clusters of 1, 4 and 8 blocks, the no-op and the part
term's gt and hp on views that are not 16-byte aligned, the part term's C
wider than a quad slice's chunk.

Every test here needs an NVIDIA GPU (sm_90a) and nvcc: the kernels have no
CPU mode, so without a card they skip. The file imports neither jax nor
openobj_tpu, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_probe_kernels.py
"""

import pytest

torch = pytest.importorskip("torch")

from openobj_torch.ops import probes  # noqa: E402

GEMM_RTOL = 1e-5     # max|d| / max|ref|: FP32 sums in another order
CHAIN_RTOL = 1e-4    # the chain: up to five layers amplify rounding


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0)


def _rel(a, b) -> float:
    torch.cuda.synchronize()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _randn(gen, shape, device, scale=1.0):
    return torch.randn(shape, generator=gen, device=device) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", probes.SCHEDULES)
@pytest.mark.parametrize("sin", [False, True])
@pytest.mark.parametrize("o,n,k,h,obj_tile", [
    (1, 70, 87, 32, 8),           # one object, ragged tile, K not a multiple of 4
    (5, 130, 88, 32, 2),          # ragged object groups
    (3, 64, 13, 48, 4),           # H > 32 (two column passes), odd K
    (2, 1, 4, 1, 1),              # one row, one column, fewer items than blocks
    (3, 9000, 87, 32, 2),         # 423 items: persistent blocks walk 3-4 items
                                  # across object boundaries
    (8, 9000, 88, 32, 8),         # 1,128 items: each persistent block walks 8-9,
                                  # more than its ring's 4 stages
    (16, 1200, 87, 32, 16),       # the fused-step probe's q1 shape
    (3, 200, 128, 64, 2),         # the entry's largest K and H (objtile: one
                                  # warp group per block)
])
def test_ens_gemm_matches_plain(cuda_device, schedule, sin, o, n, k, h, obj_tile):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = _randn(gen, (o, n, k), cuda_device)
    w = _randn(gen, (o, k, h), cuda_device, 0.1)
    got = probes.ens_gemm_cuda(x, w, schedule, sin=sin, obj_tile=obj_tile)
    assert _rel(got, probes.ens_gemm_plain(x, w, sin)) <= GEMM_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 88), (3, 5), (1,), (100_003,)])
def test_launch_nop_is_a_copy(cuda_device, shape):
    x = torch.randn(shape, device=cuda_device)
    assert torch.equal(probes.launch_nop_cuda(x), x)


@pytest.mark.cuda
@pytest.mark.parametrize("n,ofs", [(704, 1), (100_003, 1), (5, 3), (2, 1)])
def test_launch_nop_copies_offset_views(cuda_device, n, ofs):
    """x starts ofs floats past its buffer's (16-byte aligned) start, y at a
    fresh allocation's: not aligned alike, every float goes singly."""
    x = torch.randn(n + ofs, device=cuda_device)[ofs:]
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * ofs
    assert torch.equal(probes.launch_nop_cuda(x), x)


@pytest.mark.cuda
@pytest.mark.parametrize("s,o,r,dx,k,h,ot", [
    (3, 5, 70, 8, 87, 32, 2),     # ragged last object tile
    (2, 1, 1, 4, 8, 8, 8),        # one object, one ray
    (4, 16, 600, 8, 87, 32, 8),   # several 16 KB chunks per block, odd chunk count
])
def test_slab_stream_matches_plain(cuda_device, s, o, r, dx, k, h, ot):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    xs = _randn(gen, (s, o, r, dx), cuda_device)
    w0 = _randn(gen, (o, dx, k), cuda_device)
    assert torch.equal(probes.slab_stream_cuda(xs, w0, h, ot),
                       probes.slab_stream_plain(xs, w0, h))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 2, 4])
@pytest.mark.parametrize("s,o,n,dx,k,h", [
    (2, 1, 70, 8, 87, 32),        # one object, N not a multiple of 64
    (3, 3, 129, 8, 87, 32),
    (1, 2, 5, 3, 20, 16),         # fewer rays than a tile, small widths
    (1, 1, 64, 8, 87, 64),        # H = 64: two columns per lane
    (4, 8, 1200, 8, 87, 32),      # q4's shape: 32 pairs, clusters of 4 blocks on an H100
    (1, 1, 70, 8, 87, 32),        # one pair, 8 ranks of 8-9 rays each
    (5, 64, 130, 8, 87, 32),      # 320 pairs: a block per pair (clusters of 1)
])
def test_step_chain_matches_plain(cuda_device, depth, s, o, n, dx, k, h):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    xs = _randn(gen, (s, o, n, dx), cuda_device, 0.1)
    w0 = _randn(gen, (o, dx, k), cuda_device)
    w1 = _randn(gen, (o, k, h), cuda_device)
    w2 = _randn(gen, (o, h, h), cuda_device, 0.3)
    got = probes.step_chain_cuda(xs, w0, w1, w2, depth)
    assert got.shape == (s, o, 1, h)
    assert _rel(got, probes.step_chain_plain(xs, w0, w1, w2, depth)) <= CHAIN_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("o,r,hp,c,gt_ofs,h_ofs", [
    (1, 45, 33, 100, 0, 0),       # one object, ragged row block and C chunk
    (3, 120, 33, 512, 0, 0),      # the probe's widths
    (2, 7, 64, 70, 0, 0),         # Hp = 64, the widest the kernels take
    (2, 33, 1, 3, 0, 0),
    (2, 37, 48, 100, 0, 0),       # dw: ragged 64-column slice, R not a multiple of 8, Hp = 48
    (2, 1, 33, 512, 0, 0),        # one ray
    (3, 120, 33, 512, 1, 0),      # gt starts one float past a 16-byte boundary:
                                  # 4-byte copies although C % 4 == 0
    (3, 120, 33, 512, 0, 1),      # hp (the quad's rows, dw's dt) one float past it
    (1, 300, 17, 2100, 0, 0),     # C = 2100: quad's 1056-column slices take nine
                                  # chunks through two stages; 150 rows per rank,
                                  # staged in three runs
])
def test_part_term_matches_plain(cuda_device, o, r, hp, c, gt_ofs, h_ofs):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    base = torch.empty(o * r * c + gt_ofs, device=cuda_device)
    gt = base[gt_ofs:].view(o, r, c)
    gt.copy_(_randn(gen, (o, r, c), cuda_device, 0.1))
    assert (gt.data_ptr() % 16 == 0) == (gt_ofs == 0)
    wb = _randn(gen, (o, hp, c), cuda_device, 0.1)
    h_base = torch.empty(o * r * hp + h_ofs, device=cuda_device)
    h = h_base[h_ofs:].view(o, r, hp)
    h.copy_(_randn(gen, (o, r, hp), cuda_device, 0.1))
    assert (h.data_ptr() % 16 == 0) == (h_ofs == 0)
    t, g = probes.part_tg_cuda(gt, wb)
    t_ref, g_ref = probes.part_tg_plain(gt, wb)
    assert _rel(t, t_ref) <= GEMM_RTOL
    assert _rel(g, g_ref) <= GEMM_RTOL
    assert _rel(probes.part_dw_cuda(h, gt), probes.part_dw_plain(h, gt)) <= GEMM_RTOL
    assert _rel(probes.part_quad_cuda(h, wb), probes.part_quad_plain(h, wb)) <= GEMM_RTOL


@pytest.mark.cuda
def test_dispatch_counts_kernel_launches(cuda_device):
    x = torch.randn((2, 10, 8), device=cuda_device)
    w = torch.randn((2, 8, 4), device=cuda_device)
    before = dict(probes.COUNTS)
    probes.ens_gemm(x, w, "persistent", sin=True)
    probes.part_dw(torch.randn((2, 10, 3), device=cuda_device), x)
    assert probes.COUNTS["ens_gemm_persistent_sin"] == before["ens_gemm_persistent_sin"] + 1
    assert probes.COUNTS["part_term_dw"] == before["part_term_dw"] + 1
    assert probes.COUNTS["probes_plain"] == before["probes_plain"]


@pytest.mark.cuda
def test_scan_time_replays_the_kernel(cuda_device):
    """Launches inside a captured graph are not counted; the timing is
    positive and the graph's output is the kernel's."""
    from openobj_torch.scripts._benchlib import eager_time, scan_time

    x = torch.randn((4, 100, 16), device=cuda_device)
    w = torch.randn((4, 16, 8), device=cuda_device)
    before = probes.COUNTS["ens_gemm_grid"]
    t = scan_time(probes.ens_gemm, (x, w), iters=20, reps=3)
    assert probes.COUNTS["ens_gemm_grid"] == before + 3      # the eager warm-up only
    assert t > 0 and eager_time(probes.launch_nop, (x,), iters=20) > 0


@pytest.mark.cuda
def test_measure_attributes_every_launch(cuda_device):
    """measure keeps the kernel's output and times all three calls; its
    launches and those made in a counted block are the case's."""
    from openobj_torch.scripts._benchlib import Case, counted, measure

    x = torch.randn((4, 100, 16), device=cuda_device)
    w = torch.randn((4, 16, 8), device=cuda_device)
    before = probes.COUNTS["ens_gemm_grid"]
    case = measure(Case("ens_gemm[grid]", "site", "ens_gemm_grid", lambda: probes.ens_gemm(x, w),
                        lambda: probes.ens_gemm_plain(x, w), lambda: torch.bmm(x, w),
                        1.0, 1.0, GEMM_RTOL, 10))
    with counted(case):
        probes.ens_gemm(x, w)
    # the kept output, three warm-ups, and the call in the counted block
    assert case.launches == probes.COUNTS["ens_gemm_grid"] - before == 5
    assert case.us > 0 and case.plain_us > 0 and case.library_us > 0
    assert _rel(case.out, case.plain()) <= GEMM_RTOL


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    x = torch.randn((2, 10, 8), device=cuda_device)
    w = torch.randn((2, 8, 4), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        probes.ens_gemm_cuda(x.double(), w)
    with pytest.raises(ValueError, match="contiguous"):
        probes.ens_gemm_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="shape"):
        probes.ens_gemm_cuda(x, w[:, :-1].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        probes.ens_gemm_cuda(x.cpu(), w.cpu())
    with pytest.raises(ValueError, match="K="):
        probes.ens_gemm_cuda(torch.randn((1, 4, 200), device=cuda_device),
                             torch.randn((1, 200, 4), device=cuda_device))
    with pytest.raises(ValueError, match="schedule"):
        probes.ens_gemm_cuda(x, w, "rowwise")
    with pytest.raises(ValueError, match="depth"):
        probes.step_chain_cuda(torch.randn((1, 1, 4, 8), device=cuda_device),
                               torch.randn((1, 8, 4), device=cuda_device),
                               torch.randn((1, 4, 8), device=cuda_device), None, 0)

"""The part term's {t, g}, dW and quadratic kernels, the step chain, the
ensemble GEMM's kernels and the launch probe of openobj_torch/csrc/probes.cu,
run on the CPU through the host compiler's build (tests/cuda_emulation.py)
against their plain versions in openobj_torch/ops/probes.py; their launch
layouts and refusals; and the edited copies of probes.cu that the parts
scripts build. tests/test_torch_probe_kernels.py holds the real kernels to
the same plain versions on a GPU.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from cuda_emulation import CHAIN_RTOL, CSRC, GEMM_RTOL, emulated, ptr
from openobj_torch.ops import probes
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def emu_probes(tmp_path_factory):
    lib = emulated(tmp_path_factory, "probes")
    lib.pr_part_dw.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pr_part_dw.restype = ctypes.c_int
    lib.pr_part_tg.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pr_part_tg.restype = ctypes.c_int
    lib.pr_part_quad.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pr_part_quad.restype = ctypes.c_int
    lib.pr_part_quad_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pr_part_quad_launch.restype = ctypes.c_int
    lib.pr_ens_gemm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.pr_ens_gemm.restype = ctypes.c_int
    lib.pr_ens_gemm_occupancy.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.pr_ens_gemm_occupancy.restype = ctypes.c_int
    lib.pr_step_chain.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.pr_step_chain.restype = ctypes.c_int
    lib.pr_step_chain_launch.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.pr_step_chain_launch.restype = ctypes.c_int
    lib.pr_launch_nop.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    lib.pr_launch_nop.restype = ctypes.c_int
    lib.emu_set_sm_count.argtypes = [ctypes.c_int]
    return lib


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
@pytest.mark.parametrize("s,o,n,dx,k,h,n_sm,cluster", [
    (2, 1, 70, 8, 87, 32, 1, 1),      # one object, one ragged tile (warp 4 partly, 5-7 idle)
    (3, 3, 129, 8, 87, 32, 1, 1),     # two tiles: 128 rows, then 1
    (1, 2, 600, 8, 87, 32, 1, 1),     # five tiles: each stage is refilled
    (1, 2, 5, 3, 20, 16, 132, 8),     # DX = 3 (4-byte copies), small widths; 8 ranks for
                                      # 5 rays: three ranks have no rows
    (1, 1, 64, 8, 87, 64, 2, 2),      # H = 64; two ranks of 32 rays
    (1, 1, 300, 8, 87, 32, 2, 4),     # four ranks of 75 rays, more ranks than tiles
])
def test_emulated_step_chain_matches_plain(emu_probes, depth, s, o, n, dx, k, h, n_sm, cluster):
    """step_chain_kernel against step_chain_plain, in clusters of 1, 2, 4
    and 8 blocks (the SM count and the stub's residency by shared memory
    decide; pr_step_chain_launch reports it)."""
    rng = np.random.default_rng(2)
    xs = (0.1 * rng.standard_normal((s, o, n, dx))).astype(np.float32)
    w0 = rng.standard_normal((o, dx, k)).astype(np.float32)
    w1 = rng.standard_normal((o, k, h)).astype(np.float32)
    w2 = (0.3 * rng.standard_normal((o, h, h))).astype(np.float32)
    out = np.full((s, o, 1, h), np.nan, np.float32)
    res = (ctypes.c_int * 6)()
    emu_probes.emu_set_sm_count(n_sm)
    try:
        assert emu_probes.pr_step_chain_launch(s, o, n, dx, k, h, depth, res) == 0
        err = emu_probes.pr_step_chain(ptr(xs), ptr(w0), ptr(w1), ptr(w2), ptr(out),
                                       s, o, n, dx, k, h, depth, None)
    finally:
        emu_probes.emu_set_sm_count(132)
    assert err == 0
    assert res[4] == cluster and res[3] == s * o * cluster
    ref = probes.step_chain_plain(*(torch.from_numpy(a) for a in (xs, w0, w1, w2)), depth).numpy()
    assert float(np.abs(out - ref).max()) <= CHAIN_RTOL * float(np.abs(ref).max())


@pytest.mark.parametrize("s,o,n,dx,k,h,depth,cluster,blocks,smem", [
    (100, 64, 1200, 8, 87, 32, 4, 1, 6400, 60_920),   # q3: a block per pair
    (4, 16, 1200, 8, 87, 32, 0, 4, 256, 60_920),      # q4: 4 ranks of 300 rays (8 would
                                                      # not all be resident at 3 a SM)
    (4, 8, 1200, 8, 87, 32, 1, 8, 256, 60_920),       # 8 ranks of 150 rays
    (1, 1, 10, 16, 128, 64, 2, 8, 8, 182_552),        # the largest widths
])
def test_emulated_step_chain_launch_layout(emu_probes, s, o, n, dx, k, h, depth, cluster, blocks,
                                           smem):
    """pr_step_chain_launch reports the launch pr_step_chain makes on 132
    SMs: threads, dynamic shared memory, blocks and blocks per cluster (the
    largest cluster whose blocks are all resident at once)."""
    res = (ctypes.c_int * 6)()
    assert emu_probes.pr_step_chain_launch(s, o, n, dx, k, h, depth, res) == 0
    assert list(res)[1:5] == [256, smem, blocks, cluster]
    assert res[5] >= s * o or cluster == 1   # every pair's cluster resident at once


def test_emulated_step_chain_rejects_bad_arguments(emu_probes):
    """DX > 16, K > 128, H not a multiple of 4 or over 64, depth < 0 and
    depth 0 with H > K are refused."""
    buf = np.zeros(1, np.float32)
    for dx, k, h, depth in ((17, 8, 8, 1), (8, 129, 8, 1), (8, 8, 6, 1), (8, 87, 68, 1),
                            (8, 8, 8, -1), (8, 8, 12, 0)):
        assert emu_probes.pr_step_chain(*[ptr(buf)] * 5, 1, 1, 4, dx, k, h, depth, None) != 0


def _at(n: int, ofs: int):
    """A NaN-filled float32 buffer and the view of n floats in it that starts
    ofs floats past a 16-byte boundary."""
    buf = np.full(n + 8, np.nan, np.float32)
    start = (-(buf.ctypes.data // 4)) % 4 + ofs
    return buf, buf[start:start + n]


@pytest.mark.parametrize("n,x_ofs,y_ofs", [
    (704, 0, 0),       # the probe's [8, 88]: 176 float4s, one block of 192 threads
    (704, 1, 1),       # aligned alike: 3 head floats, 175 float4s, 1 tail float
    (7, 3, 3),         # 1 head float, 1 float4, 2 tail floats
    (2, 1, 1),         # shorter than the head
    (705, 1, 2),       # not aligned alike: every float singly
    (100_003, 0, 0),   # 25 blocks of 256 threads, 4 float4s each
    (100_003, 2, 3),   # the same grid, singly
])
def test_emulated_launch_nop_is_a_copy(emu_probes, n, x_ofs, y_ofs):
    """launch_nop_kernel copies exactly, and writes nothing around y."""
    _, x = _at(n, x_ofs)
    x[:] = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    ybuf, y = _at(n, y_ofs)
    assert emu_probes.pr_launch_nop(ptr(x), ptr(y), n, None) == 0
    assert np.array_equal(x, y)
    assert np.isnan(ybuf).sum() == ybuf.size - n


@pytest.mark.parametrize("schedule", probes.SCHEDULES)
@pytest.mark.parametrize("sin", [False, True])
@pytest.mark.parametrize("o,n,k,h,obj_tile,n_blocks,n_sm", [
    (4, 200, 16, 8, 3, 1, 1),     # persistent: one block walks 16 items, the ring
                                  # wraps 4 times, crosses 3 object boundaries,
                                  # ragged last tiles; objtile: groups of 3 and 1
                                  # objects; one SM: 128-row tiles (128 + 72)
    (3, 100, 87, 32, 2, 1, 132),  # K = 87 (k >= K masked), every tile 16-byte
                                  # aligned; 64-row tiles
    (3, 130, 13, 48, 2, 2, 132),  # K = 13, H = 48: tiles of odd objects and the
                                  # 2-row tails are unaligned (cp.async), the rest
    (3, 130, 13, 48, 2, 2, 1),    # bulk copies; 64-row, then 128-row tiles
    (5, 64, 8, 16, 5, 2, 132),    # one tile per object: a new object at every item;
                                  # objtile: 5 objects on a ring of 2 stages (3 and
                                  # 2 per warp group)
    (2, 1, 4, 1, 1, 5, 132),      # one row; fewer items than blocks; H = 1 (odd:
                                  # scalar stores)
    (2, 40, 8, 7, 2, 3, 1),       # H = 7
    (2, 20, 128, 64, 2, 1, 132),  # the entry's largest K and H: objtile takes one
    (2, 20, 128, 64, 2, 1, 1),    # warp group, which walks both objects
])
def test_emulated_ens_gemm_persistent_matches_plain(emu_probes, schedule, sin, o, n, k, h,
                                                    obj_tile, n_blocks, n_sm):
    """Each schedule's kernel (the persistent one, and the tiled one on GRID's
    and OBJTILE's grids, with 64- or 128-row tiles as the SM count makes it
    choose) against the plain einsum."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((o, n, k)).astype(np.float32)
    w = (0.1 * rng.standard_normal((o, k, h))).astype(np.float32)
    out = np.full((o, n, h), np.nan, np.float32)
    emu_probes.emu_set_sm_count(n_sm)
    err = emu_probes.pr_ens_gemm(ptr(x), ptr(w), ptr(out), o, n, k, h,
                                 probes.SCHEDULES.index(schedule), int(sin), obj_tile,
                                 n_blocks, None)
    emu_probes.emu_set_sm_count(132)
    assert err == 0
    ref = probes.ens_gemm_plain(torch.from_numpy(x), torch.from_numpy(w), sin).numpy()
    assert float(np.abs(out - ref).max()) <= GEMM_RTOL * float(np.abs(ref).max())


@pytest.mark.parametrize("schedule,o,k,h,obj_tile,threads,smem,blocks", [
    ("grid", 64, 88, 32, 8, 256, 78_864, 10 * 64),       # 128-row tiles: 5 per SM
                                                          # against 10 of 64 rows
    ("objtile", 64, 88, 32, 8, 512, 157_728, 10 * 8),    # two groups of 8 warps
    ("objtile", 64, 88, 32, 1, 256, 78_864, 10 * 64),    # one object per block: GRID's
    ("objtile", 64, 128, 64, 8, 256, 163_856, 10 * 8),   # two groups would not fit
    ("grid", 16, 87, 32, 16, 128, 55_952, 19 * 16),      # q1: 64-row tiles (3 per SM
                                                          # against 2 of 128 rows)
    ("objtile", 16, 87, 32, 16, 256, 111_904, 19),       # q1: 64-row tiles
    ("persistent", 64, 88, 32, 8, 256, 123_944, 132),
])
def test_emulated_ens_gemm_launch_layout(emu_probes, schedule, o, k, h, obj_tile, threads, smem,
                                         blocks):
    """pr_ens_gemm_occupancy reports the launch pr_ens_gemm makes on 132 SMs
    at N = 1200: threads per block, dynamic shared memory and blocks."""
    res = (ctypes.c_int * 4)()
    assert emu_probes.pr_ens_gemm_occupancy(o, 1200, k, h, probes.SCHEDULES.index(schedule), 0,
                                            obj_tile, 132, res) == 0
    assert list(res)[1:] == [threads, smem, blocks]


def test_emulated_ens_gemm_rejects_bad_arguments(emu_probes):
    """K > 128, H > 64, obj_tile < 1 and an unknown schedule are refused."""
    buf = np.zeros(1, np.float32)
    for o, k, h, schedule, ot in ((1, 129, 8, 0, 1), (1, 8, 65, 1, 1), (1, 8, 8, 1, 0),
                                  (1, 8, 8, 3, 1)):
        assert emu_probes.pr_ens_gemm(ptr(buf), ptr(buf), ptr(buf), o, 1, k, h, schedule, 0,
                                      ot, 1, None) != 0


@pytest.mark.parametrize("o,r,hp,c", [
    (2, 120, 33, 512),   # the probe's widths: 8 column slices, 5 tiles of Hp
    (2, 37, 48, 100),    # ragged slice (16-byte copies), R not a multiple of 8
    (2, 7, 64, 70),      # Hp = 64, C % 4 != 0 (4-byte copies)
    (2, 33, 1, 3),
    (1, 300, 17, 130),   # three chunks of rays
])
def test_emulated_part_dw_matches_plain(emu_probes, o, r, hp, c):
    rng = np.random.default_rng(3)
    dt = (0.1 * rng.standard_normal((o, r, hp))).astype(np.float32)
    gt = (0.1 * rng.standard_normal((o, r, c))).astype(np.float32)
    out = np.full((o, hp, c), np.nan, np.float32)
    assert emu_probes.pr_part_dw(ptr(dt), ptr(gt), ptr(out), o, r, hp, c, None) == 0
    ref = probes.part_dw_plain(torch.from_numpy(dt), torch.from_numpy(gt)).numpy()
    assert float(np.abs(out - ref).max()) <= GEMM_RTOL * float(np.abs(ref).max())


@pytest.mark.parametrize("o,r,hp,c", [
    (2, 120, 33, 512),   # the probe's widths: three gt tiles (48, 48, 24 rows) and
                         # the Gram tile, 4 chunks through the 2 stages
    (1, 45, 33, 100),    # a ragged row tile, a ragged chunk (bulk copies)
    (2, 7, 64, 70),      # Hp = 64: two Gram tiles; C % 4 != 0 (4-byte copies)
    (2, 33, 1, 3),
    (1, 300, 17, 130),   # seven row tiles, 2 chunks (128, then 2 columns)
])
def test_emulated_part_tg_matches_plain(emu_probes, o, r, hp, c):
    """part_tg_kernel against part_tg_plain: t from the gt tiles, g from the
    Gram tile; every element of both written."""
    rng = np.random.default_rng(6)
    gt = (0.1 * rng.standard_normal((o, r, c))).astype(np.float32)
    wb = (0.1 * rng.standard_normal((o, hp, c))).astype(np.float32)
    t = np.full((o, r, hp), np.nan, np.float32)
    g = np.full((o, hp, hp), np.nan, np.float32)
    assert emu_probes.pr_part_tg(ptr(gt), ptr(wb), ptr(t), ptr(g), o, r, hp, c, None) == 0
    t_ref, g_ref = (x.numpy() for x in probes.part_tg_plain(torch.from_numpy(gt),
                                                             torch.from_numpy(wb)))
    assert float(np.abs(t - t_ref).max()) <= GEMM_RTOL * float(np.abs(t_ref).max())
    assert float(np.abs(g - g_ref).max()) <= GEMM_RTOL * float(np.abs(g_ref).max())


def test_emulated_part_tg_rejects_bad_arguments(emu_probes):
    """Hp outside 1..64 is refused."""
    buf = np.zeros(1, np.float32)
    for hp in (0, 65):
        assert emu_probes.pr_part_tg(*[ptr(buf)] * 4, 1, 1, hp, 1, None) != 0


@pytest.mark.parametrize("o,r,hp,c", [
    (2, 120, 33, 512),   # the probe's widths: a 256-column slice (two chunks) and 60 rows
                         # per rank
    (1, 45, 33, 100),    # ragged slices (56, 44 columns) and rows (23, 22)
    (2, 7, 64, 70),      # Hp = 64; C % 4 != 0 (4-byte copies); rows 4, 3
    (2, 3, 1, 3),        # a rank with no columns
    (1, 1, 5, 3),        # R < QD_CL: a rank with no rows and no columns
    (1, 300, 17, 2100),  # 1056-column slices, nine chunks through the two stages; 150
                         # rows per rank, staged as 64, 64 and 22
])
def test_emulated_part_quad_matches_plain(emu_probes, o, r, hp, c):
    """part_quad_kernel against part_quad_plain: the cluster's ranks sum their
    Gram partials over distributed shared memory; every element of z written."""
    rng = np.random.default_rng(7)
    h = (0.1 * rng.standard_normal((o, r, hp))).astype(np.float32)
    wb = (0.1 * rng.standard_normal((o, hp, c))).astype(np.float32)
    z = np.full((o, r, hp), np.nan, np.float32)
    assert emu_probes.pr_part_quad(ptr(h), ptr(wb), ptr(z), o, r, hp, c, None) == 0
    ref = probes.part_quad_plain(torch.from_numpy(h), torch.from_numpy(wb)).numpy()
    assert float(np.abs(z - ref).max()) <= GEMM_RTOL * float(np.abs(ref).max())


@pytest.mark.parametrize("o,r,hp,c,smem", [
    (64, 120, 33, 512, 75_192),     # q5: two stages of 48 rows, partials inside them
    (1, 300, 17, 2100, 43_576),     # two stages of 32 rows; 64 hp rows staged
    (2, 7, 64, 70, 138_520),        # the widest: the partials [8][20][32] float4 beyond
                                    # the one stage
])
def test_emulated_part_quad_launch_layout(emu_probes, o, r, hp, c, smem):
    """pr_part_quad_launch reports the launch pr_part_quad makes: 256 threads,
    the dynamic shared memory, a cluster of 2 blocks per object."""
    res = (ctypes.c_int * 6)()
    assert emu_probes.pr_part_quad_launch(o, r, hp, c, res) == 0
    assert list(res)[1:5] == [256, smem, 2 * o, 2]


def test_emulated_part_quad_rejects_bad_arguments(emu_probes):
    """Hp outside 1..64 is refused."""
    buf = np.zeros(1, np.float32)
    for hp in (0, 65):
        assert emu_probes.pr_part_quad(*[ptr(buf)] * 3, 1, 1, hp, 1, None) != 0


def test_ens_gemm_parts_edits_the_persistent_kernel(tmp_path, monkeypatch):
    """openobj_torch.scripts.ens_gemm_parts builds copies of probes.cu
    without the persistent and tiled kernels' products, without their bulk
    copies, without those and two of their three mma.sync, and without the
    bulk copies and the weight splits."""
    from openobj_torch import kernels
    from openobj_torch.scripts import ens_gemm_parts

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    srcs = ens_gemm_parts.part_sources()
    whole = srcs["whole"].read_text()
    copies, product = srcs["copies"].read_text(), srcs["product"].read_text()
    assert srcs["whole"] == CSRC / "probes.cu"
    for unroll in (4, 2):   # the persistent kernel's k-loop unroll, then the tiled one's
        item = f"gemm_item<SIN, PAIR, NB, SIN ? 1 : {unroll}>(g"
        assert whole.count(item) == 1 and product.count(item) == 1
        assert item not in copies
    for kernel in ("ens_gemm_persistent_kernel(GemmArgs g)", "ens_gemm_tiled_kernel(GemmArgs g)"):
        assert kernel in copies
        body = copies[copies.index(kernel):]
        body = body[:body.index("\n}\n")]
        assert "start_" in body and "mbar_wait(" in body and "split_weights(g" in body
    assert whole.count("bulk_copy_g2s(dst, src, bytes, bar);") == 1
    assert "bulk_copy_g2s(dst, src, bytes, bar);" not in product
    one = srcs["product_1mma"].read_text()
    assert one.count("mma_tf32(") == product.count("mma_tf32(") - 2   # two of mma_step's
    assert "bulk_copy_g2s(dst, src, bytes, bar);" not in one
    nosplit = srcs["product_nosplit"].read_text()
    assert whole.count("split_weights(g") == 2 and nosplit.count("split_weights(g") == 2
    body = nosplit[nosplit.index("void split_weights("):]
    assert body[body.index("{"):].startswith("{\n  return;\n")   # returns before any split
    assert "bulk_copy_g2s(dst, src, bytes, bar);" not in nosplit
    assert all(p.parent == tmp_path / "parts" for k, p in srcs.items() if k != "whole")


def test_step_chain_parts_edits_the_chain(tmp_path, monkeypatch):
    """openobj_torch.scripts.step_chain_parts builds copies of probes.cu
    whose chain kernel has no mma_step (noproduct) or no sinf (nosine), and
    leaves the ensemble GEMM's products and sines as they are."""
    from openobj_torch import kernels
    from openobj_torch.scripts import step_chain_parts

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    srcs = step_chain_parts.part_sources(parts=step_chain_parts.PARTS)
    assert srcs["whole"] == CSRC / "probes.cu" and set(srcs) == {"whole", "noproduct", "nosine"}
    whole = srcs["whole"].read_text()

    def chain(text):   # chain_rows, where the edits fall
        body = text[text.index("__device__ inline void chain_rows("):]
        return body[:body.index("\n}\n")]

    noproduct, nosine = srcs["noproduct"].read_text(), srcs["nosine"].read_text()
    assert chain(whole).count("mma_step<") == 2 and "mma_step<" not in chain(noproduct)
    assert chain(whole).count("sinf(") == 4 and "sinf(" not in chain(nosine)
    assert chain(nosine).count("mma_step<false, NB>") == 2
    for text in (noproduct, nosine):   # the rest of the source is untouched
        assert text.replace(chain(text), "") == whole.replace(chain(whole), "")


def test_part_quad_parts_edits_the_kernel(tmp_path, monkeypatch):
    """openobj_torch.scripts.part_quad_parts builds copies of probes.cu whose
    quad kernel runs no k-steps and no z (copies), sums its own partial with
    no cluster barrier or peer read (no_exchange), runs no z (no_z), also
    copies nothing (empty), or takes clusters of 2 or 8 blocks; each edit
    falls in the quad kernel's code and leaves the other kernels as they are."""
    from openobj_torch import kernels
    from openobj_torch.scripts import part_quad_parts

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    srcs = part_quad_parts.part_sources(parts=part_quad_parts.PARTS)
    assert srcs["whole"] == CSRC / "probes.cu" and set(srcs) == {"whole", *part_quad_parts.PARTS}
    text = {k: p.read_text() for k, p in srcs.items()}

    def quad(t):   # the quad kernel and its helpers, where the edits fall
        return t[t.index("struct QuadSmem {"):t.index("using QuadKernel")]

    def rest(t):   # the source without them and without the block and cluster sizes
        return re.sub(r"constexpr int QD_(CL = \d|NT = \d+);", "", t.replace(quad(t), ""))

    whole = quad(text["whole"])
    for part in part_quad_parts.PARTS:
        assert rest(text[part]) == rest(text["whole"]), part
        assert (quad(text[part]) == whole) == part.startswith(("cl", "nt")), part
    assert whole.count("cluster_wait();") == 2 and whole.count("bulk_copy_s2peer(") == 1
    assert "&& C < 0" not in whole
    assert quad(text["copies"]).count("&& C < 0") == 2
    assert quad(text["no_z"]).count("&& C < 0") == 1
    for part in ("copies", "no_z", "empty"):
        assert "zo[" not in quad(text[part]), part
    assert "8 * ks < cw && C < 0" in quad(text["empty"])
    assert "bulk_copy_g2s(" not in quad(text["empty"]) and "cp_async4(hs" not in quad(text["empty"])
    ex = quad(text["no_exchange"])
    assert "cluster_" not in ex and "bulk_copy_s2peer(" not in ex and "gx" not in ex.split("g = ")[-1]
    for n in (1, 4):
        assert f"constexpr int QD_CL = {n};" in text[f"cl{n}"]
    assert "constexpr int QD_NT = 128;" in text["nt128"] and "QD_CL = 4;" in text["cl4_nt128"]

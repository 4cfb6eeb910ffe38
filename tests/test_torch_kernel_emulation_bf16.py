"""The bf16 fused field: csrc/fused_field.cu built with FF_BF16 (all that
csrc/fused_field_bf16.cu is), K1 bf16 and K2 bf16 and K2 bf16's weight
images, run on the CPU through the host compiler's build
(tests/cuda_emulation.py) against the plain version in bf16; the width
table of both builds; the stub's own ldmatrix, bf16 mma.sync, bulk copy
and mbarrier against numpy; and the phase scripts' stamped copies of the
bf16 kernels. tests/test_torch_kernels.py holds the real kernels to the
same plain version on a GPU.
"""

import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch

from cuda_emulation import (CSRC, EMU_TC_WIDTHS, FWD_ATOL, GRAD_RTOL, STUB, compile_start,
                            emulated_bf16_copy, emulated_finish, emulated_start, field,
                            fused_field_emu, host_cxx, host_source, ptr)
from openobj_torch.ops import fused_field as tff
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def fused_field_emus(tmp_path_factory):
    """fused_field.cu for the host, built twice at once: as it is ("f32")
    and with FF_BF16 defined ("bf16", all that csrc/fused_field_bf16.cu
    is)."""
    widths = " ".join(f"X({h})" for h in EMU_TC_WIDTHS)
    jobs = {cd: emulated_start(tmp_path_factory, "fused_field",
                               [f"-DFF_TC_WIDTHS(X)={widths}", *defines])
            for cd, defines in (("f32", []), ("bf16", ["-DFF_BF16=1"]))}
    return {cd: fused_field_emu(emulated_finish(job)) for cd, job in jobs.items()}


@pytest.fixture(scope="module")
def emu_lib(fused_field_emus):
    return fused_field_emus["f32"]


@pytest.fixture(scope="module")
def emu_lib_bf16(fused_field_emus):
    return fused_field_emus["bf16"]


def _bf16_grads(w, pts, cts, h, do_clip):
    """The plain version's packed gradient in bf16 and in f32."""
    out = {}
    for cd in ("bf16", "f32"):
        wr = w.detach().requires_grad_(True)
        outs = tff.fused_field_plain(wr, pts, h, do_clip, cd)
        obj = sum((x * c).sum() for x, c in zip(outs, cts) if x is not None)
        (out[cd],) = torch.autograd.grad(obj, wr)
    return out["bf16"], out["f32"]


# the bf16 kernels (fused_field.cu built with FF_BF16, as csrc/fused_field_bf16.cu
# builds it) against the plain version in bf16: K1's outputs by the card's
# gate (tff.bf16_output_errors at FWD_ATOL: the two sum in other orders, and
# a rounding flip moves a few outputs by a bf16 ulp of one product, here
# too), K2 per leaf at most a tenth of that leaf's distance between the
# plain bf16 and f32 gradients where bf16 moves the leaf at all (it does
# not move b_alpha)
@pytest.mark.parametrize("o,n,h,do_clip", [
    # on one emulated SM, K1 bf16 (ff_fwd_bf16_kernel) tiles by its resident
    # blocks: at h = 16 to 48 the image in shared memory, 64-point chunks,
    # two blocks an SM (four at 16 by the stub's count), so a block walks
    # both chunks (64, then 6) of an object where there are two objects, and
    # each is a block of its own where there is one; from 64 the ring, one
    # ragged chunk of 128
    *((2 if h <= 32 else 1, 70, h, True) for h in EMU_TC_WIDTHS),
    (1, 37, 32, False),          # clip head off, one ragged chunk
    (1, 37, 96, False),
    (2, 40, 24, True),           # the SIMT kernel
    # the ring at h = 128, one block an SM: a tile of two chunks, 128, then 72
    (1, 200, 128, True),
    (2, 100, 64, False),         # the ring with the clip head off, a ragged chunk an object
    # the tile rule puts two blocks on the one emulated SM: 3 chunks, then 2 (64 + 44)
    (1, 300, 32, True),
])
def test_emulated_k1_bf16_matches_plain(emu_lib_bf16, o, n, h, do_clip):
    lib = emu_lib_bf16
    w, pts = field(np.random.default_rng(1), o, n, h, do_clip)
    ref = tff.fused_field_plain(w, pts, h, do_clip, "bf16")
    ref32 = tff.fused_field_plain(w, pts, h, do_clip)
    outs = [np.full((o, n, k), np.nan, np.float32) for k in (1, 3, h)]
    wn, pn = (np.ascontiguousarray(x.numpy()) for x in (w, pts))
    lib.emu_set_sm_count(1)
    plan = tff.fwd_launch(lib, o, n, h)
    err = lib.ff_forward(ptr(pn), ptr(wn), ptr(outs[0]), ptr(outs[1]),
                         ptr(outs[2]) if do_clip else None, o, n, h, int(do_clip), None)
    lib.emu_set_sm_count(132)
    assert err == 0
    if (o, n, h) in ((1, 200, 128), (2, 100, 64), (1, 300, 32)):   # the cases' launches
        assert (plan["tile"], plan["blocks"]) == {128: (256, 1), 64: (128, 2), 32: (192, 2)}[h]
        assert (plan["blocks_per_sm"], plan["ring"]) == ((2, False) if h == 32 else (1, True))
    for got, want, want32 in zip(outs, ref, ref32):
        if want is None:
            assert np.isnan(got).all()
            continue
        e = tff.bf16_output_errors(torch.from_numpy(got), want, want32, FWD_ATOL)
        assert e["ok"], e


@pytest.mark.parametrize("o,n,h,do_clip,chunks", [
    # chunks per tile; K2 bf16's chunk is 64 points at h = 16, 32 and 64 to
    # 128, 32 at h = 48 (and in the SIMT kernel)
    (2, 70, 16, True, 2),        # on chip across a tile of 2 chunks (64, then 6)
    (2, 70, 32, True, 2),
    (1, 40, 48, True, 1),        # on chip, tiles of one chunk (32, then 8)
    (2, 40, 64, True, 1),        # the weight ring, one ragged chunk per tile
    (1, 45, 96, True, 1),
    (1, 40, 128, True, 1),
    (2, 37, 32, False, 1),       # clip head off
    (1, 33, 128, False, 1),
    (2, 70, 24, True, 2),        # the SIMT kernel
    # at h = 128 a tile is one chunk: 3 tiles, the last ragged (22 points);
    # every chunk streams 60 slabs through the ring's stages
    (1, 150, 128, True, 1),
    # the ring with the clip head off (32 slabs a chunk) at h = 64, 2 x 2 tiles
    (2, 100, 64, False, 1),
])
def test_emulated_k2_bf16_matches_plain(emu_lib_bf16, o, n, h, do_clip, chunks):
    lib = emu_lib_bf16
    tile = chunks * lib.ff_bwd_chunk(h)
    assert tile <= lib.ff_bwd_max_tile(h)
    rng = np.random.default_rng(0)
    w, pts = field(rng, o, n, h, do_clip)
    cts = [torch.from_numpy(rng.standard_normal((o, n, k)).astype(np.float32)) for k in (1, 3, h)]
    g_bf, g_32 = _bf16_grads(w, pts, cts, h, do_clip)
    p, n_tiles = lib.ff_param_count(h), -(-n // tile)
    # the slots, then the scratch the kernel takes after them (the weight
    # images at a tensor-core width)
    buf = np.full(o * n_tiles * p + lib.ff_bwd_scratch(o, h), np.nan, np.float32)
    wn, pn, dan, dcn, dhn = (np.ascontiguousarray(x.detach().numpy()) for x in (w, pts, *cts))
    err = lib.ff_backward(ptr(pn), ptr(wn), ptr(dan), ptr(dcn),
                          ptr(dhn) if do_clip else None, ptr(buf), o, n, h,
                          int(do_clip), tile, None)
    assert err == 0
    g_k = torch.from_numpy(buf[:o * n_tiles * p].reshape(o, n_tiles, p).sum(axis=1))
    dev = tff.leaf_errors(g_k, g_bf, h)
    dist = tff.leaf_errors(g_bf, g_32, h)
    for name, d in dev.items():
        if not do_clip and name in ("w_clip", "b_clip"):
            assert d == 0.0, name
            continue
        limit = min(GRAD_RTOL, 0.1 * dist[name]) if dist[name] > 0 else GRAD_RTOL
        assert d <= limit, (name, d, dist[name])


@pytest.mark.parametrize("o,h,do_clip", [(2, 32, True), (1, 128, False), (3, 48, True)])
def test_emulated_bf16_weight_image_matches_plain(emu_lib_bf16, o, h, do_clip):
    """ff_bf16_image_kernel, K2 bf16's first launch, against its plain
    version, fused_field.bf16_weight_image: the images ff_backward leaves in
    the scratch after the slots (fused_field.bwd_image) equal bit for bit,
    padding zero."""
    lib, n = emu_lib_bf16, 4
    rng = np.random.default_rng(3)
    w, pts = field(rng, o, n, h, do_clip)
    cts = [rng.standard_normal((o, n, k)).astype(np.float32) for k in (1, 3, h)]
    ref = tff.bf16_weight_image(w, h).view(torch.int16)
    buf = np.full(o * lib.ff_param_count(h) + lib.ff_bwd_scratch(o, h), np.nan, np.float32)
    assert lib.ff_bwd_scratch(o, h) >= ref.numel() // 2
    err = lib.ff_backward(ptr(np.ascontiguousarray(pts.numpy())),
                          ptr(np.ascontiguousarray(w.numpy())), *(ptr(c) for c in cts),
                          ptr(buf), o, n, h, int(do_clip), lib.ff_bwd_chunk(h), None)
    assert err == 0
    got = tff.bwd_image(torch.from_numpy(buf), o, 1, h).view(torch.int16)
    assert torch.equal(got, ref)


def test_emulated_k2_bf16_masks_are_the_plain_versions(tmp_path, monkeypatch):
    """K2 bf16's recompute masks, read from the kernel's own stored operands
    by bench_fused_field's probed copy (emulated), equal the plain bf16
    version's at every point and unit of every ReLU layer: on chip across a
    tile of two chunks (h=32), through the ring with a ragged last tile
    (h=128), and with the clip head off."""
    from openobj_torch import kernels
    from openobj_torch.scripts import bench_fused_field as bench

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    lib = emulated_bf16_copy(bench.probed_source(), tmp_path)
    lib.ff_mask_out.argtypes = [ctypes.c_void_p]
    for o, n, h, do_clip, chunks in ((2, 70, 32, True, 2), (1, 150, 128, True, 1),
                                     (1, 33, 128, False, 1)):
        rng = np.random.default_rng(5)
        w, pts = field(rng, o, n, h, do_clip)
        cts = [rng.standard_normal((o, n, k)).astype(np.float32) for k in (1, 3, h)]
        tile = chunks * lib.ff_bwd_chunk(h)
        buf = np.zeros(o * -(-n // tile) * w.shape[1] + lib.ff_bwd_scratch(o, h), np.float32)
        got = np.full((o, n, h), 0xFF, np.uint8)
        assert lib.ff_mask_out(ptr(got)) == 0
        err = lib.ff_backward(ptr(np.ascontiguousarray(pts.numpy())),
                              ptr(np.ascontiguousarray(w.numpy())), *(ptr(c) for c in cts),
                              ptr(buf), o, n, h, int(do_clip), tile, None)
        lib.ff_mask_out(None)
        assert err == 0
        assert not (got >> (6 if do_clip else 5)).any()   # every unit written, no stray bit
        want = bench.plain_masks(w, pts, torch.from_numpy(cts[2]), h, do_clip)
        for layer in range(6 if do_clip else 5):          # each layer has both signs
            assert 0 < int(((want >> layer) & 1).sum()) < o * n * h, layer
        flips = bench.mask_flips(torch.from_numpy(got), want, do_clip)
        assert not any(flips.values()), flips


@pytest.mark.parametrize("h,chunk,max_tile,images", [
    (16, 64, 1 << 30, True),    # image and accumulators on chip across the tile
    (32, 64, 1 << 30, True),
    (48, 32, 1 << 30, True),    # on chip, a shorter chunk beside them
    (64, 64, 64, True),         # the weight ring: one chunk per tile
    (96, 64, 64, True),
    (128, 64, 64, True),
    (8, 32, 1 << 30, False),    # the SIMT kernel, as in f32
    (24, 32, 1 << 30, False),
    (136, 32, 1 << 30, False),
    (320, 16, 1 << 30, False),
])
def test_emulated_tc_width_table_bf16(emu_lib, emu_lib_bf16, h, chunk, max_tile, images):
    """The bf16 library's table: K2 bf16's chunk and largest tile at the
    tensor-core widths, and the scratch its weight images take after the
    slots (O x (5h + 272) x (h + 8) bf16, and 16 bytes of alignment); the
    SIMT kernel's elsewhere. And K1's launch (ff_fwd_launch) for 3 x 1000
    points on 4 emulated SMs: K1 bf16 with its image on chip (h = 16 to 48)
    sized for at least two resident blocks an SM of 256 threads (the stub's
    occupancy counts threads and shared memory), tiles of 64-point chunks,
    and 16 points of fixed cost a block for the image's conversion; through
    its ring (64 to 128) one block of 512 threads, 128-point chunks; tiles
    by fwd_tile over every resident block. The f32 K1 one block an SM; the
    SIMT kernel a chunk a block."""
    lib = emu_lib_bf16
    assert lib.ff_tc_width(h) == (h in EMU_TC_WIDTHS)
    assert lib.ff_bwd_chunk(h) == chunk
    assert lib.ff_bwd_max_tile(h) == max_tile
    want = 3 * ((5 * h + 272) * (h + 8) // 2) + 4 if images else 0
    assert lib.ff_bwd_scratch(3, h) == want
    assert emu_lib.ff_bwd_scratch(3, h) == 0

    def rule(o, n, slots, start, chunk):   # fused_field.cu's fwd_tile
        best = None
        for k in range(1, -(-n // chunk) + 1):
            blocks = o * -(-n // (chunk * k))
            cost = (-(-blocks // slots) * (chunk * k + start), blocks)
            best = best if best is not None and best[0] <= cost else (cost, chunk * k)
        return best[1]

    for lb, cd in ((lib, "bf16"), (emu_lib, "f32")):
        lb.emu_set_sm_count(4)
        plan = tff.fwd_launch(lb, 3, 1000, h)
        lb.emu_set_sm_count(132)
        if not images:   # the SIMT kernel: a chunk a block
            tp = 64 if h <= 64 else 32
            assert (plan["tile"], plan["blocks"]) == (tp, 3 * -(-1000 // tp)), (cd, plan)
            continue
        per, ring = plan["blocks_per_sm"], plan["ring"]
        assert ring == (cd == "bf16" and h >= 64), (cd, plan)
        assert plan["chunk"] == (128 if ring else 64), (cd, plan)
        threads = 4 * plan["chunk"]
        assert per == (min(2048 // threads, 232448 // plan["smem"]) if cd == "bf16" else 1)
        assert per >= (2 if cd == "bf16" and not ring else 1), plan
        start = 16 if cd == "bf16" and not ring else 0
        assert plan["tile"] == rule(3, 1000, 4 * per, start, plan["chunk"]), (cd, plan)
        assert plan["blocks"] == 3 * -(-1000 // plan["tile"]), (cd, plan)


def test_bf16_source_compiles_at_every_tensor_core_width(tmp_path):
    """csrc/fused_field_bf16.cu through the host compiler's semantic checks
    with every width the card builds (FF_TC_WIDTHS as the source has it:
    16 to 128), so that a static_assert of a width the emulation does not
    build (80, 112) fails here rather than in nvcc on the card."""
    cxx = host_cxx()
    src = (CSRC / "fused_field.cu").read_text()
    widths = re.search(r"#define FF_TC_WIDTHS\(X\) (.*)", src).group(1)
    assert widths.split() == [f"X({h})" for h in range(16, 129, 16)]
    (tmp_path / "emu.cpp").write_text(host_source("fused_field_bf16"))
    (tmp_path / "stub.h").write_text(STUB)
    proc = subprocess.run([cxx, "-std=c++20", "-fsyntax-only", "-Wno-unknown-pragmas",
                           "-include", str(tmp_path / "stub.h"), str(tmp_path / "emu.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]


# One warp through the stub's ldmatrix and bf16 mma.sync: C = A B from
# A [16][16] row-major with ldmatrix.x4 and B^T [8][16] with .x2 (the input
# gradients' pattern), from A^T [16][16] with .x4.trans and B [16][8] with
# .x2.trans (the weight gradients'), and from the same A^T and two n-tiles of
# B' [16][16] with .x4.trans; .x1 and .x1.trans of A's first 8 x 8 matrix,
# register by register.
STUB_CHECK = r"""
extern "C" int stub_check(const uint16_t* src, float* out, uint32_t* regs) {
  emu_launch(dim3(1), 32, 4096, nullptr, [&] {
    uint16_t* sh = reinterpret_cast<uint16_t*>(emu_smem());
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    for (int i = lane; i < 1024; i += 32) sh[i] = src[i];
    __syncthreads();
    const uint16_t *A = sh, *At = sh + 256, *Bt = sh + 512, *B = sh + 640, *B2 = sh + 768;
    const auto put = [&](int k, const float (&c)[4], int ldc, int n0) {
      out[k + g * ldc + n0 + 2 * t] = c[0];
      out[k + g * ldc + n0 + 2 * t + 1] = c[1];
      out[k + (g + 8) * ldc + n0 + 2 * t] = c[2];
      out[k + (g + 8) * ldc + n0 + 2 * t + 1] = c[3];
    };
    uint32_t a[4], b[2], b4[4], r1[1];
    ldsm_x4(a, A + ((lane & 7) + 8 * ((lane >> 3) & 1)) * 16 + 8 * (lane >> 4));
    ldsm_x2(b, Bt + (lane & 7) * 16 + 8 * ((lane >> 3) & 1));
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(c, a, b);
    put(0, c, 8, 0);
    ldsm_x4_t(a, At + ((lane & 7) + 8 * (lane >> 4)) * 16 + 8 * ((lane >> 3) & 1));
    ldsm_x2_t(b, B + ((lane & 7) + 8 * ((lane >> 3) & 1)) * 8);
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(d, a, b);
    put(128, d, 8, 0);
    ldsm_x4_t(b4, B2 + ((lane & 7) + 8 * ((lane >> 3) & 1)) * 16 + 8 * (lane >> 4));
    for (int j = 0; j < 2; ++j) {
      const uint32_t bj[2] = {b4[2 * j], b4[2 * j + 1]};
      float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(e, a, bj);
      put(256, e, 16, 8 * j);
    }
    ldsm_x1(r1, A + (lane & 7) * 16);
    regs[lane] = r1[0];
    ldsm_x1_t(r1, A + (lane & 7) * 16);
    regs[32 + lane] = r1[0];
  });
  return 0;
}
"""


def test_stub_ldmatrix_and_bf16_mma_match_numpy(tmp_path):
    """The stub's m16n8k16 bf16 mma.sync and ldmatrix (.x1, .x2, .x4, and
    .trans) against numpy on random bf16 tiles, as the PTX fragment layouts
    define them: C = A B in float64 within f32 rounding (the products are
    exact), and every .x1 register exactly."""
    lib = emulated_finish(compile_start(STUB_CHECK, tmp_path))
    lib.stub_check.argtypes = [ctypes.c_void_p] * 3
    rng = np.random.default_rng(5)
    bf = lambda shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    a, b, b2 = bf((16, 16)), bf((16, 8)), bf((16, 16))
    bits = lambda x: x.contiguous().view(torch.int16).numpy().astype(np.uint16).ravel()
    src = np.concatenate([bits(a), bits(a.T), bits(b.T), bits(b), bits(b2)])
    out = np.full(512, np.nan, np.float32)
    regs = np.zeros(64, np.uint32)
    lib.stub_check(ptr(src), ptr(out), ptr(regs))
    a64, b64, b264 = (x.double().numpy() for x in (a, b, b2))
    np.testing.assert_allclose(out[:128].reshape(16, 8), a64 @ b64, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[128:256].reshape(16, 8), a64 @ b64, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[256:].reshape(16, 16), a64 @ b264, rtol=1e-5, atol=1e-5)
    ab = bits(a).reshape(16, 16).astype(np.uint32)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    assert np.array_equal(regs[:32], ab[g, 2 * t] | (ab[g, 2 * t + 1] << 16))
    assert np.array_equal(regs[32:], ab[2 * t, g] | (ab[2 * t + 1, g] << 16))

# One block through the stub's bulk copy and mbarrier as K1 bf16's weight
# ring uses them: a slab's rows from the 16-byte boundary at or below them,
# into one of two stages, each stage's mbarrier reused (its phase parity
# alternating), the rows read back past the skipped floats.
STUB_BULK = r"""
extern "C" int stub_bulk(const float* src, int n, const int* starts, int k, float* out) {
  emu_launch(dim3(1), 32, 4 * 2 * (n + 4) + 16, nullptr, [&] {
    float* stage = emu_smem();
    uint64_t* bar = reinterpret_cast<uint64_t*>(stage + 2 * (n + 4));
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_init(bar + 1, 1);
      mbar_init_fence();
    }
    __syncthreads();
    for (int j = 0; j < k; ++j) {
      const float* p = src + starts[j];
      const float* a = reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) & ~(uintptr_t)15);
      const int skip = (int)(p - a);
      const unsigned bytes = (unsigned)(4 * (skip + n) + 15) & ~15u;
      if (threadIdx.x == 0) {
        fence_proxy_async();
        mbar_arrive_expect_tx(bar + (j & 1), bytes);
        bulk_copy_g2s(stage + (j & 1) * (n + 4), a, bytes, bar + (j & 1));
      }
      mbar_wait(bar + (j & 1), (j >> 1) & 1);
      for (int i = threadIdx.x; i < n; i += 32) out[j * n + i] = stage[(j & 1) * (n + 4) + skip + i];
      __syncthreads();
    }
  });
  return 0;
}
"""


def test_stub_bulk_copy_and_mbarrier_match_numpy(tmp_path):
    """The stub's bulk copy (cp.async.bulk on an mbarrier) and mbarrier
    phases as K1 bf16's ring uses them: rows copied from the 16-byte boundary
    at or below them, at every misalignment of 0 to 3 floats, into two
    stages whose mbarriers are each waited on at parity 0, 1, 0: every row
    read back past its skipped floats equals numpy's slice of the source."""
    lib = emulated_finish(compile_start(STUB_BULK, tmp_path))
    lib.stub_bulk.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p]
    src = np.random.default_rng(7).standard_normal(4096).astype(np.float32)
    assert src.ctypes.data % 16 == 0
    n = 96
    starts = np.array([63, 300, 1001, 2046, 4, 513], np.int32)   # 3, 0, 1, 2, 0, 1 floats past
    out = np.full(len(starts) * n, np.nan, np.float32)
    lib.stub_bulk(ptr(src), n, ptr(starts), len(starts), ptr(out))
    want = np.concatenate([src[s:s + n] for s in starts])
    assert np.array_equal(out, want)


def test_k2_bf16_phases_names_every_barrier(tmp_path, monkeypatch):
    """openobj_torch.scripts.k1_phases in its K2 bf16 mode stamps every
    barrier of K2 bf16 (its weight ring's too) and none of fused_field.cu's
    kernels, and its span names are the barriers a block passes, in number:
    the stamped copy, emulated with a stamp that counts block (0, 0)'s
    barriers, at h=128 (the ring, one chunk a tile, the clip head on and
    off) and h=32 (on chip, a tile of two chunks)."""
    from openobj_torch import kernels
    from openobj_torch.scripts import k1_phases as kp

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    src = kp.stamped_source(CSRC / "fused_field_bf16.cu", kp.K2_BF16_STAMPED)
    hdr = (src.parent / "fused_field_bwd_bf16.cuh").read_text()
    assert "__syncthreads();" not in hdr
    assert hdr.count("stamped_syncthreads();") == (
        CSRC / "fused_field_bwd_bf16.cuh").read_text().count("__syncthreads();")
    assert (src.parent / "fused_field.cu").read_text() == (CSRC / "fused_field.cu").read_text()
    counting = ("#include <atomic>\ninline std::atomic<int> g_bars{0};\n"
                "inline void stamped_syncthreads() {\n  __syncthreads();\n"
                "  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) ++g_bars;\n}\n"
                'extern "C" int emu_bars() { int n = g_bars; g_bars = 0; return n; }\n')
    src.write_text(counting + (kernels.CSRC / "fused_field_bf16.cu").read_text())
    lib = emulated_bf16_copy(src, tmp_path)
    for o, n, h, do_clip, chunks in ((1, 64, 128, True, 1), (1, 64, 128, False, 1),
                                     (1, 100, 32, True, 2)):
        w, pts = field(np.random.default_rng(0), o, n, h, do_clip)
        cts = [np.ones((o, n, k), np.float32) for k in (1, 3, h)]
        tile = chunks * lib.ff_bwd_chunk(h)
        buf = np.zeros(o * -(-n // tile) * w.shape[1] + lib.ff_bwd_scratch(o, h), np.float32)
        err = lib.ff_backward(ptr(pts.numpy()), ptr(w.numpy()), *(ptr(c) for c in cts),
                              ptr(buf), o, n, h, int(do_clip), tile, None)
        assert err == 0
        ring = lib.ff_bwd_max_tile(h) < (1 << 30)
        assert ring == (h == 128)
        assert lib.emu_bars() == chunks * len(kp.span_names(h, ring, do_clip))


def test_k1_bf16_phases_names_every_barrier(tmp_path, monkeypatch):
    """openobj_torch.scripts.k1_phases in its K1 bf16 mode stamps every
    barrier of K1 bf16 (its weight ring's too) and none of fused_field.cu's
    or K2 bf16's, and its span names are the barriers a block passes, in
    number, after the one before its first chunk: the stamped copy,
    emulated with a stamp that counts block (0, 0)'s barriers, at h=128
    (the ring, the clip head on and off, tiles of one and two 128-point
    chunks) and h=32 (the image on chip, a tile of three chunks)."""
    from openobj_torch import kernels
    from openobj_torch.scripts import k1_phases as kp

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    src = kp.stamped_source(CSRC / "fused_field_bf16.cu", kp.K1_BF16_STAMPED)
    hdr = (src.parent / kp.K1_BF16_STAMPED).read_text()
    assert "__syncthreads();" not in hdr
    assert hdr.count("stamped_syncthreads();") == (
        CSRC / kp.K1_BF16_STAMPED).read_text().count("__syncthreads();")
    for other in ("fused_field.cu", kp.K2_BF16_STAMPED):
        assert (src.parent / other).read_text() == (CSRC / other).read_text()
    counting = ("#include <atomic>\ninline std::atomic<int> g_bars{0};\n"
                "inline void stamped_syncthreads() {\n  __syncthreads();\n"
                "  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) ++g_bars;\n}\n"
                'extern "C" int emu_bars() { int n = g_bars; g_bars = 0; return n; }\n')
    src.write_text(counting + (kernels.CSRC / "fused_field_bf16.cu").read_text())
    lib = emulated_bf16_copy(src, tmp_path)
    lib.emu_set_sm_count(1)
    for o, n, h, do_clip in ((1, 64, 128, True), (1, 64, 128, False), (1, 200, 128, True),
                             (1, 300, 32, True)):
        w, pts = field(np.random.default_rng(0), o, n, h, do_clip)
        outs = [np.zeros((o, n, k), np.float32) for k in (1, 3, h)]
        plan = tff.fwd_launch(lib, o, n, h)
        err = lib.ff_forward(ptr(pts.numpy()), ptr(w.numpy()), *(ptr(x) for x in outs),
                             o, n, h, int(do_clip), None)
        assert err == 0
        assert plan["ring"] == (h == 128)
        chunks = -(-min(plan["tile"], n) // plan["chunk"])
        assert chunks == (2 if n == 200 else 3 if n == 300 else 1)
        names = kp.k1_bf16_span_names(h, plan["ring"], do_clip)
        assert lib.emu_bars() == 1 + chunks * len(names)   # and one before the first chunk
    lib.emu_set_sm_count(132)

"""K1 and K2, the fused-field forward and backward of
openobj_torch/csrc/fused_field.cu, run on the CPU against their plain
versions through the host compiler's build (tests/cuda_emulation.py: the
stub that stands in for the CUDA built-ins and runs each block's threads
as fibers). It checks the kernels' indexing: fragments, swizzled shared
memory, the packed layout and its bias rows, ragged chunks, tiles of
several chunks, the clip head on and off, for the tensor-core K1 and K2 at
the widths ``EMU_TC_WIDTHS`` (weights in shared memory at h = 16 and 32,
from L2 at 48 to 128), and for the SIMT kernels at widths outside them.
The emulation builds only the tensor-core widths its tests use
(``FF_TC_WIDTHS``, defined for the host compiler); the card builds every
multiple of 16 up to 128. The bf16 build is
tests/test_torch_kernel_emulation_bf16.py's, the part term's and the
ensemble GEMM's kernels (csrc/probes.cu)
tests/test_torch_kernel_emulation_probes.py's.
"""

import ctypes

import numpy as np
import pytest
import torch

from cuda_emulation import (CSRC, EMU_TC_WIDTHS, FWD_ATOL, GRAD_RTOL, emulated, field,
                            fused_field_emu, ptr)
from openobj_torch.ops import fused_field as tff
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """fused_field.cu for the host at the tensor-core widths EMU_TC_WIDTHS."""
    widths = " ".join(f"X({h})" for h in EMU_TC_WIDTHS)
    return fused_field_emu(emulated(tmp_path_factory, "fused_field",
                                    [f"-DFF_TC_WIDTHS(X)={widths}"]))


@pytest.mark.parametrize("o,n,h,do_clip,n_sm", [
    (2, 70, 32, True, 1),        # one block per object: a chunk, then 6 points
    (2, 37, 32, False, 132),     # clip head off, one ragged chunk
    (3, 150, 32, True, 4),       # tiles of 3 chunks (64, 64, 22 points)
    (1, 150, 128, True, 1),      # h=128: one block walks 3 chunks
    (1, 100, 128, False, 132),   # h=128, clip head off: a chunk per block
    (2, 40, 64, True, 132),      # h=64: weights from L2, all 4 row tiles per item
    # the other tensor-core widths: weights in shared memory at h=16, from L2
    # at 48 and 64 (one n-tile per item) and 96 (two); one ragged chunk per
    # block but for a tile of several chunks at h=16 and at h=48
    (2, 150, 16, True, 1),       # one block per object walks 3 chunks (64, 64, 22)
    (2, 37, 16, False, 132),     # clip head off, one ragged chunk
    (1, 40, 48, True, 132),
    (1, 70, 48, False, 1),       # one block walks 2 chunks (64, 6), clip head off
    (1, 40, 64, False, 132),     # clip head off
    (1, 40, 96, True, 132),
    (1, 37, 96, False, 132),
    # widths without a tensor-core kernel: the SIMT kernel
    (2, 40, 24, True, 132),
    (1, 70, 24, False, 132),
])
def test_emulated_k1_matches_plain(emu_lib, o, n, h, do_clip, n_sm):
    lib = emu_lib
    assert lib.ff_tc_width(h) == (h in EMU_TC_WIDTHS)
    w, pts = field(np.random.default_rng(1), o, n, h, do_clip)
    ref = tff.fused_field_plain(w, pts, h, do_clip)
    outs = [np.full((o, n, k), np.nan, np.float32) for k in (1, 3, h)]
    wn, pn = (np.ascontiguousarray(x.numpy()) for x in (w, pts))
    lib.emu_set_sm_count(n_sm)
    err = lib.ff_forward(ptr(pn), ptr(wn), ptr(outs[0]), ptr(outs[1]),
                         ptr(outs[2]) if do_clip else None, o, n, h, int(do_clip), None)
    lib.emu_set_sm_count(132)
    assert err == 0
    for got, want in zip(outs, ref):
        if want is None:
            assert np.isnan(got).all()
            continue
        assert float(np.abs(got - want.numpy()).max()) <= FWD_ATOL


@pytest.mark.parametrize("o,n,h,do_clip,tile", [
    (2, 70, 32, True, 64),       # 2 tiles: 2 chunks, then 6 points
    (2, 37, 32, False, 64),      # clip head off
    (3, 40, 32, True, 32),       # one chunk per tile, then 8 points
    (1, 40, 128, True, 32),      # h=128: one chunk per tile
    (1, 33, 128, False, 32),
    # the other tensor-core widths: on chip across the tile at h=16, one
    # chunk per tile from L2 at 48 to 128
    (1, 75, 64, True, 32),       # 3 tiles, the last 11 points
    (2, 37, 16, False, 32),      # clip head off
    (2, 100, 16, True, 64),      # 2 tiles: 2 chunks, then 32 + 4 points
    (1, 75, 16, True, 96),       # one tile of 3 chunks, the last 11 points
    (2, 40, 64, False, 32),      # clip head off
    (1, 40, 48, True, 32),       # 2 tiles, the last 8 points
    (1, 33, 48, False, 32),
    (1, 45, 96, True, 32),
    (1, 20, 96, False, 32),      # fewer points than a chunk
    # widths without a tensor-core kernel: the SIMT kernel, gradients added
    # into the slot per chunk
    (2, 70, 8, True, 64),        # 2 tiles: 2 chunks, then 6 points
    (1, 75, 24, True, 96),       # one tile of 3 chunks, the last 11 points
    (2, 37, 24, False, 32),      # clip head off
])
def test_emulated_k2_matches_plain(emu_lib, o, n, h, do_clip, tile):
    lib = emu_lib
    assert lib.ff_tc_width(h) == (h in EMU_TC_WIDTHS)
    assert tile % lib.ff_bwd_chunk(h) == 0 and tile <= lib.ff_bwd_max_tile(h)
    rng = np.random.default_rng(0)
    w, pts = field(rng, o, n, h, do_clip)
    cts = [torch.from_numpy(rng.standard_normal((o, n, k)).astype(np.float32)) for k in (1, 3, h)]

    wr = w.detach().requires_grad_(True)
    outs = tff.fused_field_plain(wr, pts, h, do_clip)
    obj = sum((x * c).sum() for x, c in zip(outs, cts) if x is not None)
    (g_p,) = torch.autograd.grad(obj, wr)

    p = lib.ff_param_count(h)
    assert p == w.shape[1]
    part = np.full((o, -(-n // tile), p), np.nan, np.float32)
    arrs = [np.ascontiguousarray(x.detach().numpy()) for x in (w, pts, *cts)]
    wn, pn, dan, dcn, dhn = arrs
    err = lib.ff_backward(ptr(pn), ptr(wn), ptr(dan), ptr(dcn),
                          ptr(dhn) if do_clip else None, ptr(part), o, n, h,
                          int(do_clip), tile, None)
    assert err == 0
    g_k = torch.from_numpy(part.sum(axis=1))
    ofs = 0
    for name, (r, c) in tff.param_layout(h):
        ref, got = g_p[:, ofs:ofs + r * c], g_k[:, ofs:ofs + r * c]
        ofs += r * c
        if not do_clip and name in ("w_clip", "b_clip"):
            assert not got.any(), name
            continue
        assert float((got - ref).abs().max()) <= GRAD_RTOL * float(ref.abs().max()) + 1e-7, name


def test_emulated_k2_rejects_bad_tiles(emu_lib):
    """The entry point refuses a tile that is not a whole number of chunks
    (at tensor-core widths and at a SIMT one), a multi-chunk tile where the
    tensor-core K2 reads its weights from L2 (h=128, h=64) and a width whose
    chunk cannot fit in shared memory."""
    lib = emu_lib
    buf = np.zeros(1, np.float32)
    args = [ptr(buf)] * 6
    assert lib.ff_backward(*args, 1, 40, 32, 1, 48, None) != 0
    assert lib.ff_backward(*args, 1, 40, 128, 1, 64, None) != 0
    assert lib.ff_backward(*args, 1, 40, 64, 1, 48, None) != 0
    assert lib.ff_backward(*args, 1, 40, 64, 1, 64, None) != 0
    assert lib.ff_backward(*args, 1, 40, 24, 1, 48, None) != 0
    assert lib.ff_backward(*args, 1, 40, 9000, 1, 1, None) != 0


@pytest.mark.parametrize("h,chunk,max_tile", [
    (16, 32, 1 << 30),   # weights and accumulators on chip across the tile
    (32, 32, 1 << 30),
    (48, 32, 32),        # weights from L2: one chunk per tile
    (64, 32, 32),
    (96, 32, 32),
    (128, 32, 32),
    (8, 32, 1 << 30),    # the SIMT kernel: any whole number of chunks
    (24, 32, 1 << 30),
    (136, 32, 1 << 30),
    (320, 16, 1 << 30),  # a shorter chunk, so that it fits in shared memory
])
def test_emulated_tc_width_table(emu_lib, h, chunk, max_tile):
    """ff_tc_width, ff_bwd_chunk and ff_bwd_max_tile read the one width table:
    the tensor-core kernels at the widths built, the SIMT ones elsewhere."""
    assert emu_lib.ff_tc_width(h) == (h in EMU_TC_WIDTHS)
    assert emu_lib.ff_bwd_chunk(h) == chunk
    assert emu_lib.ff_bwd_max_tile(h) == max_tile


def test_k1_phases_stamps_every_barrier(tmp_path, monkeypatch):
    """openobj_torch.scripts.k1_phases builds a copy of the source, beside
    copies of what it includes, in which every barrier books its cycles,
    with the stamps ahead of the kernels."""
    from openobj_torch import kernels
    from openobj_torch.scripts import k1_phases

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    src = CSRC / "fused_field.cu"
    out = k1_phases.stamped_source(src)
    text = out.read_text()
    assert text.count("stamped_syncthreads();") == src.read_text().count("__syncthreads();")
    assert text.count("__syncthreads();") == 1          # the barrier inside the stamp
    assert text.index("void stamped_syncthreads(") < text.index("namespace {")
    assert kernels.lib_path(out).name.startswith("libfused_field-")   # its includes are there


def test_sass_diff_compares_kernels_by_instruction():
    """openobj_torch.scripts.sass_diff reads cuobjdump's listing per kernel,
    without addresses, encodings or the namespace hash, and names the
    kernels that differ or that one side lacks."""
    from openobj_torch.scripts import sass_diff

    def listing(ns, ops):
        out = "\n\tcode for sm_90a\n"
        for name, body in ops.items():
            out += f"\t\tFunction : _ZN{ns}{name}Ev\n\t.headerflags @\"EF_CUDA_SM90\"\n"
            out += "".join(f"        /*{16 * i:04x}*/   {op} ;   /* 0x{i:016x} */\n"
                           for i, op in enumerate(body))
        return out

    a = sass_diff.functions(listing("_GLOBAL__N__1a2b_", {"k1": ["LDC R1, c[0x0][0x28]", "EXIT"],
                                                           "k2": ["FFMA R0, R1, R2, R0", "EXIT"]}))
    b = sass_diff.functions(listing("_GLOBAL__N__9f8e_", {"k1": ["LDC  R1,  c[0x0][0x28]", "EXIT"],
                                                           "k2": ["FADD R0, R1, R2", "EXIT"],
                                                           "k3": ["EXIT"]}))
    assert a["_ZNNS_k1Ev"] == ["LDC R1, c[0x0][0x28] ;", "EXIT ;"]
    assert sass_diff.compare(a, b) == (1, ["_ZNNS_k2Ev", "_ZNNS_k3Ev"])
    assert sass_diff.compare(a, a) == (2, [])

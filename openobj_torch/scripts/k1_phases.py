"""Where K1, the fused-field forward, K1 bf16 (``ff_fwd_bf16_kernel``) or
K2 bf16 (``ff_bwd_bf16_kernel``) spends its block cycles: the share of each
barrier-to-barrier phase, at the main path's two shapes, on one card.

    python -m openobj_torch.scripts.k1_phases --per-chunk 7
    python -m openobj_torch.scripts.k1_phases --per-chunk 15 \\
        --source chip_proof/parent/openobj_torch/csrc/fused_field.cu
    python -m openobj_torch.scripts.k1_phases --k1-bf16
    python -m openobj_torch.scripts.k1_phases --k2-bf16
    python -m openobj_torch.scripts.k1_phases --per-chunk 7 --stamp fused_field.cu \\
        --source chip_proof/parent/openobj_torch/csrc/fused_field_bf16.cu

It builds a copy of the source (this checkout's ``csrc/fused_field.cu`` by
default, or another with the same entry points, e.g. an older commit's from
a ``git archive``; with ``--k1-bf16`` or ``--k2-bf16``,
``csrc/fused_field_bf16.cu``), beside copies of the files it includes, in
which every ``__syncthreads()`` of the stamped file (the source, or the one
``--stamp`` names; with ``--k1-bf16``, ``fused_field_fwd_bf16.cuh``; with
``--k2-bf16``, ``fused_field_bwd_bf16.cuh``, so that only that kernel's
barriers, its weight ring's too, count) also has thread 0 of the block add
the ``clock64()`` cycles since its previous barrier to a counter of that
barrier's place within the block's chunk of points. It runs the kernel
once at fg (64 objects x 1200 points, h=32) and bg (1 x 16800, h=128), clip
head on, inputs from a seed: K1 through ``ff_forward`` with ``--per-chunk``
barriers a chunk (K1's in that source: 7 in f32, and in the bf16 library
before K1 bf16 had a kernel of its own, with ``--stamp fused_field.cu``);
K1 bf16 through ``ff_forward``, K2 bf16 through ``ff_backward``, each with
its barriers named (``k1_bf16_span_names``, ``span_names``) and summed by
stage. It prints each phase's share of the summed cycles; what comes
before a block's first barrier and after its last is not counted. Stamps
cost time of their own, so read the shares, not the stamped kernel's time.
The copy is written under ``build/kernels/`` and never loaded by the
package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from openobj_torch import kernels
from openobj_torch.models import object_field
from openobj_torch.ops import fused_field as ff

SHAPES = (dict(name="fg", o=64, n=1200, h=32), dict(name="bg", o=1, n=16800, h=128))
MAX_PHASES = 256
SLAB_ROWS = 32      # csrc/fused_field_bwd_bf16.cuh's SLAB_ROWS
FW_SLAB = 64        # csrc/fused_field_fwd_bf16.cuh's FW_SLAB
K2_BF16_STAMPED = "fused_field_bwd_bf16.cuh"
K1_BF16_STAMPED = "fused_field_fwd_bf16.cuh"

STAMPS = r"""
#include <cuda_runtime.h>
constexpr int PHASE_BLOCKS = 1 << 16;
__device__ unsigned long long g_phase_cycles[%(n)d];
__device__ long long g_phase_last[PHASE_BLOCKS];
__device__ int g_phase_ord[PHASE_BLOCKS];
__device__ int g_phase_per = 1;

// the block's barrier, then thread 0 books the cycles since its previous one
// to that barrier's place in the chunk: those ending at the block's barrier
// j >= 1 to phase (j - 1) mod g_phase_per
__device__ void stamped_syncthreads() {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int b = (blockIdx.y * gridDim.x + blockIdx.x) %% PHASE_BLOCKS;
    const long long now = clock64();
    const int ord = g_phase_ord[b]++;
    if (ord > 0)
      atomicAdd(&g_phase_cycles[(ord - 1) %% g_phase_per], (unsigned long long)(now - g_phase_last[b]));
    g_phase_last[b] = now;
  }
}

extern "C" int ff_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
}
// zero the counters; `per` barriers a chunk
extern "C" int ff_phase_reset(int per) {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_phase_cycles);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_phase_cycles));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, g_phase_ord);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_phase_ord));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_per, &per, sizeof(per));
  return (int)err;
}
"""


def stamped_source(src: Path, stamp: str | None = None) -> Path:
    """A copy of ``src``, beside copies of the files it includes, whose file
    ``stamp`` (``src`` itself by default) has every barrier book its cycles;
    the stamps go ahead of the copy of ``src``. Returns that copy."""
    stamp = stamp or src.name
    files = kernels.included(src)
    if stamp not in [f.name for f in files]:
        raise ValueError(f"{src.name} does not include {stamp}")
    out = kernels.BUILD_DIR / f"phases_{src.stem}_{Path(stamp).stem}"
    out.mkdir(parents=True, exist_ok=True)
    for f in files:
        text = f.read_text()
        if f.name == stamp:
            text = text.replace("__syncthreads();", "stamped_syncthreads();")
        if f == src:
            text = STAMPS % {"n": MAX_PHASES} + text
        (out / f.name).write_text(text)
    return out / src.name


def span_names(h: int, ring: bool, do_clip: bool = True) -> list[str]:
    """K2 bf16's work that ends at each barrier of one chunk, in the
    kernel's order (its weight ring's slab releases too, where it
    streams)."""
    names = ["encode: points", "encode: bands"]

    def slabs(stage, *rows):
        for r in rows:
            names.extend([f"{stage}: slab"] * (-(-r // SLAB_ROWS) if ring else 0))

    for layer, rows in (("recompute h1", (88,)), ("recompute h2", (h,)),
                        ("recompute hc", (h, 88)), ("recompute h3", (h,))):
        slabs(layer, *rows)
        names.append(layer)
    slabs("recompute hcol, hclip", h, 48, *((h, 48) if do_clip else ()))
    names.append("recompute hcol, hclip")
    names += ["colour head", "d_hcol, small grads"]
    for stage, rows in (("b: col/clip grads, d_h3", (h, 48)), ("c: mid2", (h,)),
                        ("d: cat", (h, 88)), ("e: mid1", (h,)), ("f: in", (88,))):
        slabs(stage, *rows)
        names.append(stage)
    return names + ["g: d_proj", "g: d_dirs"]


def k1_bf16_span_names(h: int, ring: bool, do_clip: bool = True) -> list[str]:
    """K1 bf16's work that ends at each barrier of one chunk, in the
    kernel's order: the encode (after the previous chunk's alpha, colour and
    hclip stores, which have no barrier of their own), then each layer, the
    two heads ending at one barrier. Through the weight ring a barrier
    follows each slab's rounding into bf16 instead, so each span holds the
    slab before's products (its layer's epilogue after the last) and that
    rounding; it is named after the rounded slab's layer."""
    names = ["out + encode"]
    if not ring:
        return names + ["h1", "h2", "hc", "h3", "heads"]
    layers = [("h1", (96,)), ("h2", (h,)), ("hc", (h, 96)), ("h3", (h,)), ("hcol", (h, 48))]
    for layer, rows in layers + ([("hclip", (h, 48))] if do_clip else []):
        names += [f"{layer}: slab"] * sum(-(-r // FW_SLAB) for r in rows)
    return names + ["heads"]


def _stage(span: str) -> str:
    return span.split(":")[0].split(" h")[0] if span.startswith("recompute") else span.split(":")[0]


def shares(src: Path, per_chunk: int | None = None, k2_bf16: bool = False,
           k1_bf16: bool = False, stamp: str | None = None) -> dict:
    """Each shape's phase shares of K1 (``per_chunk`` barriers a chunk, in
    the file ``stamp`` of the source's, the source by default) or, with
    ``k1_bf16`` or ``k2_bf16``, of K1 bf16 or K2 bf16, named."""
    stamp = K2_BF16_STAMPED if k2_bf16 else K1_BF16_STAMPED if k1_bf16 else stamp
    path = stamped_source(src, stamp)
    kernels.build([path])
    lib = ff._lib(path)
    lib.ff_phase_read.argtypes = [ctypes.c_void_p]
    lib.ff_phase_reset.argtypes = [ctypes.c_int]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for shape in SHAPES:
        o, n, h = shape["o"], shape["n"], shape["h"]
        params = object_field.init_stacked_fields(gen, o, hidden=h, clip_size=512, scale=2.0,
                                                  device=dev)
        params = object_field.tree_map(
            lambda x: x + 0.05 * torch.randn(x.shape, generator=gen, device=dev), params)
        w = ff._pack_params(params, h, True).contiguous()
        pts = (0.5 * torch.randn((o, n, 3), generator=gen, device=dev)).contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if k2_bf16:
            cts = [torch.randn((o, n, k), generator=gen, device=dev) for k in (1, 3, h)]
            tile, n_tiles = ff.bwd_tiling(lib, o, n, h, dev)
            buf, _ = ff.bwd_scratch(lib, o, n_tiles, h, dev)
            ring = lib.ff_bwd_max_tile(h) < (1 << 30)
            names = span_names(h, ring)
            per = len(names)
            args = [*[x.data_ptr() for x in cts], buf.data_ptr(), o, n, h, 1, tile, stream]
            entry = lib.ff_backward
        else:
            outs = [torch.empty((o, n, k), device=dev) for k in (1, 3, h)]
            per = per_chunk
            args = [*[x.data_ptr() for x in outs], o, n, h, 1, stream]
            entry = lib.ff_forward
            if k1_bf16:
                launch = ff.fwd_launch(lib, o, n, h)
                ring = launch["ring"]
                names = k1_bf16_span_names(h, ring)
                per = len(names)
        if not 0 < per <= MAX_PHASES:
            raise ValueError(f"{per} barriers a chunk: 1 to {MAX_PHASES}")
        if lib.ff_phase_reset(per):
            raise RuntimeError("ff_phase_reset failed")
        err = entry(pts.data_ptr(), w.data_ptr(), *args)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"the stamped kernel: CUDA error {err}")
        buf_c = (ctypes.c_ulonglong * MAX_PHASES)()
        if lib.ff_phase_read(ctypes.addressof(buf_c)):
            raise RuntimeError("ff_phase_read failed")
        cycles = list(buf_c)[:per]
        total = sum(cycles)
        if k1_bf16:   # one barrier before the first chunk: phase i ends at a chunk's barrier i
            spans: dict[str, int] = {}
            for i, c in enumerate(cycles):
                spans[names[i].split(":")[0]] = spans.get(names[i].split(":")[0], 0) + c
            out[shape["name"]] = {"o": o, "n": n, "h": h, **launch,
                                  "barriers_per_chunk": per, "total_cycles": total,
                                  "by_barrier": [[names[i], c] for i, c in enumerate(cycles)],
                                  "share": {k: v / total for k, v in spans.items()}}
            print(f"[k1 bf16 spans] {shape['name']} O={o} N={n} h={h} tile {launch['tile']} "
                  f"({launch['blocks_per_sm']} blocks an SM, {'ring' if ring else 'on chip'}, "
                  f"{per} barriers a chunk): "
                  + ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in spans.items()), flush=True)
            continue
        if not k2_bf16:
            out[shape["name"]] = {"shares": [round(c / total, 3) for c in cycles],
                                  "cycles": total}
            print(f"[phases] {src.name} {shape['name']}: {out[shape['name']]}", flush=True)
            continue
        # phase i ends at a chunk's barrier i + 1: names[(i + 1) mod per]
        spans: dict[str, int] = {}
        stages: dict[str, int] = {}
        for i, c in enumerate(cycles):
            name = names[(i + 1) % per]
            spans[name] = spans.get(name, 0) + c
            stages[_stage(name)] = stages.get(_stage(name), 0) + c
        out[shape["name"]] = {"o": o, "n": n, "h": h, "tile": tile, "ring": ring,
                              "barriers_per_chunk": per, "total_cycles": total,
                              "by_barrier": [[names[(i + 1) % per], c]
                                             for i, c in enumerate(cycles)],
                              "share": {k: v / total for k, v in spans.items()},
                              "stage_share": {k: v / total for k, v in stages.items()}}
        print(f"[k2 bf16 spans] {shape['name']} O={o} N={n} h={h} tile {tile} "
              f"({'ring' if ring else 'on chip'}, {per} barriers a chunk): "
              + ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in stages.items()), flush=True)
        print(f"[k2 bf16 spans] {shape['name']} by span: "
              + ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in spans.items()), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=None,
                    help="the fused_field.cu (with --k1-bf16 or --k2-bf16: fused_field_bf16.cu) "
                         "to build")
    ap.add_argument("--stamp", default=None,
                    help="with --per-chunk: the file of the source's that K1's barriers are in")
    ap.add_argument("--per-chunk", type=int, default=None,
                    help="barriers per chunk of points in that source's K1")
    ap.add_argument("--k1-bf16", action="store_true",
                    help="stamp K1 bf16 (fused_field_fwd_bf16.cuh) and run ff_forward")
    ap.add_argument("--k2-bf16", action="store_true",
                    help="stamp K2 bf16 (fused_field_bwd_bf16.cuh) and run ff_backward")
    args = ap.parse_args(argv)
    if (args.per_chunk is not None) + args.k1_bf16 + args.k2_bf16 != 1:
        ap.error("give one of --per-chunk (K1), --k1-bf16 or --k2-bf16")
    if args.stamp and args.per_chunk is None:
        ap.error("--stamp goes with --per-chunk")
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device", file=sys.stderr)
        return 2
    bf16 = args.k1_bf16 or args.k2_bf16
    src = args.source or kernels.CSRC / ("fused_field_bf16.cu" if bf16 else "fused_field.cu")
    res = shares(src.resolve(), args.per_chunk, args.k2_bf16, args.k1_bf16, args.stamp)
    key = "k2_bf16_spans" if args.k2_bf16 else "k1_bf16_spans" if args.k1_bf16 else "phases"
    print(json.dumps({"device": torch.cuda.get_device_name(0), key: res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

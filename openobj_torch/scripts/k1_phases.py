"""Where K1, the fused-field forward, spends its block cycles: the share of
each barrier-to-barrier phase, at the main path's two shapes, on one card.

    python -m openobj_torch.scripts.k1_phases --per-chunk 7
    python -m openobj_torch.scripts.k1_phases --per-chunk 15 \\
        --source chip_proof/parent/openobj_torch/csrc/fused_field.cu

It builds a copy of the source (this checkout's ``csrc/fused_field.cu`` by
default, or another with the same entry points, e.g. an older commit's from
a ``git archive``) in which every ``__syncthreads()`` also has thread 0 of
the block add the ``clock64()`` cycles since its previous barrier to a
counter of that barrier's place within the block's chunk of points
(``--per-chunk``: K1's barriers per chunk in that source). It runs
``ff_forward`` once at fg (64 objects x 1200 points, h=32) and bg (1 x
16800, h=128), clip head on, inputs from a seed, and prints each phase's
share of the summed cycles (what comes before a block's first barrier and
after its last is not counted). Stamps cost time of their own, so read the
shares, not the stamped kernel's time. The copy is written under
``build/kernels/`` and never loaded by the package.
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
MAX_PHASES = 64

STAMPS = r"""
constexpr int PHASE_BLOCKS = 1 << 16;
__device__ unsigned long long g_phase_cycles[%(n)d];
__device__ long long g_phase_last[PHASE_BLOCKS];
__device__ int g_phase_ord[PHASE_BLOCKS];

// the block's barrier, then thread 0 books the cycles since its previous one
__device__ void stamped_syncthreads(int per_chunk) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int b = (blockIdx.y * gridDim.x + blockIdx.x) %% PHASE_BLOCKS;
    const long long now = clock64();
    const int ord = g_phase_ord[b]++;
    if (ord > 0)
      atomicAdd(&g_phase_cycles[(ord - 1) %% per_chunk], (unsigned long long)(now - g_phase_last[b]));
    g_phase_last[b] = now;
  }
}

extern "C" int ff_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
}
extern "C" int ff_phase_reset() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_phase_cycles);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_phase_cycles));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, g_phase_ord);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_phase_ord));
  return (int)err;
}
"""


def stamped_source(src: Path, per_chunk: int) -> Path:
    """A copy of ``src`` whose barriers book their cycles. A block's first
    barrier only starts its clock; the cycles that end at its barrier
    j >= 1 go to phase (j - 1) mod ``per_chunk``: phase i ends at a chunk's
    barrier i + 1, and the last phase runs from a chunk's last barrier to
    the next chunk's first."""
    text = src.read_text()
    head = "#include <cuda_runtime.h>\n" + STAMPS % {"n": MAX_PHASES}
    body = text.replace("__syncthreads();", f"stamped_syncthreads({per_chunk});")
    ns = body.index("namespace {")
    out = kernels.BUILD_DIR / f"{src.stem}_phases_{per_chunk}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(body[:ns] + head + body[ns:])
    return out


def shares(src: Path, per_chunk: int) -> dict:
    path = stamped_source(src, per_chunk)
    kernels.build([path])
    lib = ff._lib(path)
    lib.ff_phase_read.argtypes = [ctypes.c_void_p]
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
        outs = [torch.empty((o, n, k), device=dev) for k in (1, 3, h)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.ff_phase_reset()
        err = lib.ff_forward(pts.data_ptr(), w.data_ptr(), *[x.data_ptr() for x in outs],
                             o, n, h, 1, stream)
        if err:
            raise RuntimeError(f"ff_forward: CUDA error {err}")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * MAX_PHASES)()
        lib.ff_phase_read(ctypes.addressof(buf))
        cycles = list(buf)[:per_chunk]
        total = sum(cycles)
        out[shape["name"]] = {"shares": [round(c / total, 3) for c in cycles], "cycles": total}
        print(f"[phases] {src.name} {shape['name']}: {out[shape['name']]}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=kernels.CSRC / "fused_field.cu",
                    help="the fused_field.cu to stamp")
    ap.add_argument("--per-chunk", type=int, required=True,
                    help="barriers per chunk of points in that source's K1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device", file=sys.stderr)
        return 2
    res = shares(args.source.resolve(), args.per_chunk)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "phases": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

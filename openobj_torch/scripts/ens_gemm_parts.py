"""What bounds the ensemble GEMM's kernels (``ens_gemm_persistent_kernel``
and ``ens_gemm_tiled_kernel``, K3 and K4a/b): each placement's time whole,
with its copies only, with its product only, and with one mma.sync of the
three of 3xTF32, at the two probe shapes, on one card.

    python -m openobj_torch.scripts.ens_gemm_parts

It builds edited copies of ``csrc/probes.cu`` beside the real one, under
``build/kernels/``: "copies" drops both kernels' products and stores (the
stages, the weight copies and splits, the waits and the barriers stay),
"product" drops the bulk copies (every thread still arrives on the stage's
mbarrier, so the waits pass at once; the product reads whatever the stages
hold, and the output is not checked), "product_1mma" also drops two of
each step's three mma.sync (al.bh and ah.bl), so that product -
product_1mma is the time of 2/3 of the tensor-core work, and
"product_nosplit" drops the bulk copies and the weight splits
(``split_weights`` returns at once; the products read whatever the
fragment buffers hold), so that product -
product_nosplit is the time of the splits. It times each
placement with ``_benchlib.scan_time`` (CUDA graphs of 1 and 200 calls) at
K3's shape [64,1200,88]x[64,88,32] (K3c persistent, K3a grid, K3b objtile
at 8 objects per block) and at q1's [16,1200,87]x[16,87,32] with sin (K4a
persistent and grid, K4b objtile at 16), in turns (whole, the parts, then
again in reverse), beside ``torch.bmm`` on the same inputs, and prints one
JSON line per case with the launch's resident blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads, dynamic
shared memory and blocks. The package never loads the copies.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from openobj_torch import kernels
from openobj_torch.ops import probes

SHAPES = (dict(name="K3", o=64, n=1200, k=88, h=32, sin=False, obj_tile=8,
               cases=(("K3c", "persistent"), ("K3a", "grid"), ("K3b", "objtile"))),
          dict(name="q1", o=16, n=1200, k=87, h=32, sin=True, obj_tile=16,
               cases=(("K4a persistent", "persistent"), ("K4a grid", "grid"),
                      ("K4b", "objtile"))))
ITERS = 200

# the text each part removes from the kernels, and what takes its place
_PRODUCTS = [
    ("      gemm_item<SIN, PAIR, NB, SIN ? 1 : 4>(g, xs + (j % RING) * stage, wf, nks,\n"
     "                                            g.out + ((size_t)o * g.N + r0) * g.H,\n"
     "                                            min(TM, g.N - r0), "
     "16 * ((threadIdx.x >> 5) & 3));\n", ""),
    ("    gemm_item<SIN, PAIR, NB, SIN ? 1 : 2>(g, xs, wf, nks, "
     "g.out + ((size_t)o * g.N + r0) * g.H,\n"
     "                                          nv, 16 * (tid >> 5));\n", ""),
]
_BULK = ("    if (tid == 0) {\n"
         "      fence_proxy_async();\n"
         "      mbar_arrive_expect_tx(bar, bytes);\n"
         "      bulk_copy_g2s(dst, src, bytes, bar);\n"
         "    } else {\n"
         "      mbar_arrive(bar);\n"
         "    }")
_NO_BULK = (_BULK, "    mbar_arrive(bar);")
_TWO_MMA = ("    mma_tf32(c[NB + j], al, bh);\n    mma_tf32(c[NB + j], ah, bl);\n", "")
_SPLIT = ("                                     int nb, int tid, int nth) {\n",
          "                                     int nb, int tid, int nth) {\n  return;\n")
PARTS = {"copies": _PRODUCTS, "product": [_NO_BULK], "product_1mma": [_NO_BULK, _TWO_MMA],
         "product_nosplit": [_NO_BULK, _SPLIT]}


def part_sources(src: Path | None = None, parts: dict | None = None) -> dict[str, Path]:
    """{"whole": the source, part: its edited copy under build/kernels/}, for
    each part of ``parts`` (default PARTS): a list of (old, new) texts, each
    old text found exactly once."""
    src = src or kernels.CSRC / "probes.cu"
    text = src.read_text()
    out = {"whole": src}
    for part, edits in (parts or PARTS).items():
        edited = text
        for old, new in edits:
            if edited.count(old) != 1:
                raise RuntimeError(f"{src}: the text the {part!r} part removes is not there once")
            edited = edited.replace(old, new)
        path = kernels.BUILD_DIR / "parts" / f"probes_{part}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(edited)
        out[part] = path
    return out


def _typed(path: Path) -> ctypes.CDLL:
    lib = kernels.load(path)
    lib.pr_ens_gemm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.pr_ens_gemm.restype = ctypes.c_int
    lib.pr_ens_gemm_occupancy.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.pr_ens_gemm_occupancy.restype = ctypes.c_int
    return lib


def occupancy(lib, o, n, k, h, schedule, sin, obj_tile, n_sm) -> dict:
    """The launch pr_ens_gemm makes for these arguments."""
    res = (ctypes.c_int * 4)()
    err = lib.pr_ens_gemm_occupancy(o, n, k, h, probes.SCHEDULES.index(schedule), int(sin),
                                    obj_tile, n_sm, res)
    if err:
        raise RuntimeError(f"pr_ens_gemm_occupancy: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "blocks"), res))


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("ens_gemm_parts: no CUDA device", file=sys.stderr)
        return 2
    from openobj_torch.scripts._benchlib import scan_time

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    srcs = part_sources()
    kernels.build(tuple(srcs.values()))
    libs = {part: _typed(path) for part, path in srcs.items()}
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    for shape in SHAPES:
        o, n, k, h, sin, ot = (shape[key] for key in ("o", "n", "k", "h", "sin", "obj_tile"))
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((o, n, k), generator=gen, device=device)
        w = torch.randn((o, k, h), generator=gen, device=device) * 0.1
        out = torch.empty((o, n, h), device=device)
        ref = probes.ens_gemm_plain(x, w, sin)
        bmm = scan_time(lambda: torch.bmm(torch.sin(x) if sin else x, w), iters=ITERS) * 1e6
        for name, schedule in shape["cases"]:
            sched = probes.SCHEDULES.index(schedule)

            def call(lib, sched=sched):
                err = lib.pr_ens_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(), o, n, k, h,
                                      sched, int(sin), ot, n_sm,
                                      torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"pr_ens_gemm: CUDA error {err}")

            out.fill_(float("nan"))
            call(libs["whole"])
            rel = float((out - ref).abs().max() / ref.abs().max())
            us = {part: [] for part in libs}
            for order in (list(libs), list(libs)[::-1]):
                for part in order:
                    us[part].append(round(scan_time(lambda: call(libs[part]), iters=ITERS) * 1e6,
                                          3))
            print(json.dumps({"case": name, "shape": shape["name"], "schedule": schedule,
                              "obj_tile": ot, "us": us, "bmm_us": round(bmm, 3),
                              "whole_rel_err": rel,
                              "launch": occupancy(libs["whole"], o, n, k, h, schedule, sin, ot,
                                                  n_sm)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

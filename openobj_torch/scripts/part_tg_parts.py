"""What bounds the part term's {t, g} kernel (``part_tg_kernel``, K4f): its
time whole, with its copies only, with its product only, and with one
mma.sync of the three of 3xTF32, at the probe's shape (q5: gt
[64,120,512], wb [64,33,512]), on one card.

    python -m openobj_torch.scripts.part_tg_parts [--against OLD/probes.cu]

It builds edited copies of ``csrc/probes.cu`` beside the real one, under
``build/kernels/`` (``ens_gemm_parts.part_sources``): "copies" never runs
the k-step loop (the copies, waits, barriers and the epilogue's sums and
stores of zeros stay), "product" issues no bulk copy (the stage's one
arrival announces no bytes, so the waits pass at once; the product reads
whatever the stages hold, and the output is not checked),
"product_1mma" also drops two of each step's three mma.sync (al.bh and
ah.bl), so that product - product_1mma is the time of 2/3 of the
tensor-core work, "product_nosplit" passes each operand unsplit (hi = lo =
x), "empty" runs neither the copies nor the k-steps (the waits, barriers
and epilogue stay), "no_last_ntile" (copies kept) skips the last 8-column
tile of Hp, which holds one column of 33 at the probe's shape (the output
is not checked), "whole_1mma" keeps the copies and drops two
mma.sync of three, and "no_chunk_barrier" drops the barrier at the top of
each chunk (stages are refilled while they may still be read: the output
is not checked). ``--against`` adds other
``probes.cu`` files with the same C entry (the parent's, say), each one
more case named by its path.
Each case is timed with ``_benchlib.scan_time`` (CUDA graphs of 1 and 100
calls) in turns: the cases in order, then in reverse. One JSON line: the
times and, for the whole kernel and each ``--against`` file, max|d|/max|ref|
against ``part_tg_plain`` for t and g. The package never loads the copies.
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
from openobj_torch.scripts.ens_gemm_parts import part_sources

O, R, HP, C = 64, 120, 33, 512   # q5's shape
ITERS = 100

_NO_PRODUCT = ("    for (int ks = warp; 8 * ks < cw; ks += NW) {\n",
               "    for (int ks = warp; 8 * ks < cw && C < 0; ks += NW) {\n")
_NO_COPY = ("    if (j == 0) mbar_arrive_expect_tx(bar, 4u * cw * rows);\n",
            "    if (j == 0) mbar_arrive(bar);\n")
_NO_BULK = ("      bulk_copy_g2s(d, (is_a ? a + (size_t)j * C : w + (size_t)(j - na) * C) + c0, "
            "4u * cw, bar);\n", "")
_TWO_MMA = ("          mma_tf32(acc[m][j], al[m], bh);\n"
            "          mma_tf32(acc[m][j], ah[m], bl);\n", "")
_NO_SPLIT = ("  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;\n"
             "  lo = __float_as_uint(a - __uint_as_float(hi));\n",
             "  hi = lo = __float_as_uint(a);\n")
_LAST_NTILE = ("      for (int j = 0; j < NB; ++j) {\n        // b0, b1",
               "      for (int j = 0; j < NB - 1; ++j) {\n        // b0, b1")
_NO_BARRIER = ("    __syncthreads();    // chunk ch - 1 is consumed: its stage takes chunk ch + "
               "TG_STAGES - 1\n", "")
PARTS = {"copies": [_NO_PRODUCT], "product": [_NO_COPY, _NO_BULK],
         "product_1mma": [_NO_COPY, _NO_BULK, _TWO_MMA],
         "product_nosplit": [_NO_COPY, _NO_BULK, _NO_SPLIT],
         "empty": [_NO_COPY, _NO_BULK, _NO_PRODUCT],
         "no_last_ntile": [_LAST_NTILE], "whole_1mma": [_TWO_MMA],
         "no_chunk_barrier": [_NO_BARRIER]}


def _typed(path: Path) -> ctypes.CDLL:
    lib = kernels.load(path)
    lib.pr_part_tg.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pr_part_tg.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, nargs="*", default=[],
                    help="other probes.cu files with the same pr_part_tg, each timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("part_tg_parts: no CUDA device", file=sys.stderr)
        return 2
    from openobj_torch.scripts._benchlib import rel_err, scan_time

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    srcs = part_sources(parts=PARTS)
    for path in args.against:
        srcs[str(path)] = path.resolve()
    kernels.build(tuple(srcs.values()))
    libs = {part: _typed(path) for part, path in srcs.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    gt = torch.sin(torch.randn((O, R, C), generator=gen, device=device) * 0.1)
    wb = torch.randn((O, HP, C), generator=gen, device=device) * 0.1
    t = torch.empty((O, R, HP), device=device)
    g = torch.empty((O, HP, HP), device=device)

    def call(part):
        err = libs[part].pr_part_tg(gt.data_ptr(), wb.data_ptr(), t.data_ptr(), g.data_ptr(),
                                    O, R, HP, C, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pr_part_tg ({part}): CUDA error {err}")

    t_ref, g_ref = probes.part_tg_plain(gt, wb)
    errs = {}
    for part in ["whole"] + [str(path) for path in args.against]:
        t.fill_(float("nan"))
        g.fill_(float("nan"))
        call(part)
        errs[part] = {"t": rel_err(t, t_ref), "g": rel_err(g, g_ref)}
    us = {part: [] for part in libs}
    for order in (list(libs), list(libs)[::-1]):
        for part in order:
            us[part].append(round(scan_time(lambda: call(part), iters=ITERS) * 1e6, 3))
    print(json.dumps({"shape": [O, R, HP, C], "us": us, "rel_err": errs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

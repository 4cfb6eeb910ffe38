"""Ensemble-GEMM and launch-cost probe on one CUDA device.

Port of ``scripts/bench_ensemble_mm.py``. At the room_0 training shape
(O=64 objects, N=1200 points, K=88 embedding width padded from 87, H=32)
it measures:

  1. the library batched GEMM ``torch.bmm`` in full FP32 (TF32 off);
  2-3. the hand-written ensemble GEMM (``csrc/probes.cu`` P1) in its three
     placements: ``grid`` (one block per tile of every object),
     ``objtile`` (8 objects per block) and ``persistent`` (one block per
     SM walking its objects through a 4-stage ring of bulk copies, 3xTF32
     tensor-core products);
  4. the launch cost of an empty kernel (P2), launched eagerly from
     Python and inside a CUDA graph.

Each section prints one JSON line with ``us`` and ``tflops`` (and, for the
GEMMs, the max abs difference from ``torch.bmm``). Times come from
``openobj_torch.scripts._benchlib``.

Run on a CUDA device:  python -m openobj_torch.scripts.bench_ensemble_mm
Without one it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

O, N, K, H = 64, 1200, 88, 32
TO = 8          # objects per block of the objtile schedule
ITERS = 200     # calls in the long CUDA graph, and eager launches of the no-op
GEMM_RTOL = 1e-5   # max|d| / max|ref| against the plain version: FP32 sums in another order
SITES = {"grid": 52, "objtile": 79, "persistent": 105}   # the Pallas bodies' lines


def run(device, seed: int = 0) -> tuple[list[dict], list]:
    """Every section's result, as the JSON lines ``main`` prints, and the
    measured ``_benchlib.Case`` of each kernel."""
    from openobj_torch.ops import probes
    from openobj_torch.scripts._benchlib import Case, counted, eager_time, measure

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((O, N, K), generator=gen, device=device)
    w = torch.randn((O, K, H), generator=gen, device=device) * 0.1
    flops = 2 * O * N * K * H
    nbytes = 4 * (O * N * K + O * K * H + O * N * H)

    def row(which: str, us: float) -> dict:
        return {"which": which, "us": round(us, 3), "tflops": round(flops / us / 1e6, 3)}

    # the three placements share one plain version and one library call:
    # those are timed with the first
    ref = torch.bmm(x, w)
    cases, rows = [], []
    for schedule in probes.SCHEDULES:
        case = measure(Case(
            f"ens_gemm[{schedule}]", f"scripts/bench_ensemble_mm.py:{SITES[schedule]}",
            f"ens_gemm_{schedule}",
            lambda s=schedule: probes.ens_gemm(x, w, schedule=s, obj_tile=TO),
            lambda: probes.ens_gemm_plain(x, w), lambda: torch.bmm(x, w),
            flops, nbytes, GEMM_RTOL, ITERS), same_as=cases[0] if cases else None)
        if not cases:
            rows.append(row("torch_bmm", case.library_us))
        cases.append(case)
        name = f"cuda_{schedule}" + (str(TO) if schedule == "objtile" else "")
        rows.append({**row(name, case.us), "max_abs_err": float((case.out - ref).abs().max())})

    x0 = x[0, :8]       # [8, K], contiguous: the no-op's operand
    nop = measure(Case("launch_nop", "scripts/bench_ensemble_mm.py:135", "launch_nop",
                       lambda: probes.launch_nop(x0), lambda: probes.launch_nop_plain(x0),
                       lambda: torch.clone(x0), 0, 2 * 4 * x0.numel(), None, ITERS))
    with counted(nop):
        t_eager = eager_time(probes.launch_nop, (x0,), iters=ITERS)
    cases.append(nop)
    rows.append({"which": "cuda_nop_launch", "us": round(nop.us, 3),
                 "us_eager": round(t_eager * 1e6, 3), "tflops": 0.0})
    return rows, cases


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ensemble_mm: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for r in run(device)[0]:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

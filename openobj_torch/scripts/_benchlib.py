"""Micro-benchmark timing for the port's probe scripts, on a CUDA device.

``scan_time`` is the counterpart of ``scripts/_benchlib.py``'s protocol:
time a program of 1 call and a program of N calls separately, ``reps``
times each, and return (median(t_N) - median(t_1)) / (N - 1), so that
the fixed cost of starting a program cancels. Here the two programs are
CUDA graphs (``torch.cuda.CUDAGraph``) that capture 1 and N calls of
``fn``; each replay is timed with CUDA events on the stream.

It adds no operand perturbation. The JAX protocol perturbs an operand in
every iteration because its remote runtime deduplicates identical
dispatches and XLA hoists work that is linear in the perturbation out of
the loop. Neither happens to CUDA launches: every captured launch runs.

``eager_time`` times back-to-back calls of ``fn`` issued from Python on
one stream, the cost a caller that launches from Python sees. A probe of
launch cost reports both.

The work of a fused-field call and the least time the card could take for
it (``field_bounds``, ``bound_ms``) are here too, for ``chip_smoke.py`` and
``bench_fused_field``.

A ``Case`` is one probe kernel at fixed inputs beside its plain version,
the library call that computes the same function (if one does) and the
work that bounds it. ``measure`` runs its kernel once, keeps the output
for a later check against the plain version, and times kernel, plain
version and library call once each; ``counted`` adds the kernel's
launches inside a block to the case, so that every launch of a probe
driver is attributed to exactly one case.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
from typing import Any, Callable

import torch


# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, dense
# TF32 and bf16 on the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_TF32 = 494.7e12
PEAK_BF16 = 989.4e12
PEAK_BYTES = 3.35e12
# operations charged per sinf in the chain's bound and in the field
# forward's encode floor: the 24 SASS instructions of sinf's path for
# |x| < 105615 on sm_90a (8 to the range check's branch, 16 after it, not
# counting the convergence barrier's two; the SASS that ``step_chain_parts``
# writes), each one issue slot of the 67 TFLOP/s of FMAs (2 FLOP)
SINF_OPS = 2 * 24


def fwd_mm_macs(h: int) -> int:
    """Multiply-adds per point of the forward's matrix products (the trunk
    and the two e2-fed heads, N = h)."""
    return 87 * h + h * h + (h + 87) * h + h * h + 2 * (h + 42) * h


def fwd_macs(h: int) -> int:
    """Multiply-adds per point of the field forward (clip head on): the
    matrix products, the projection, the alpha and colour heads."""
    return 21 * 3 + fwd_mm_macs(h) + h + 3 * h


def fwd_macs_noclip(h: int) -> tuple[int, int]:
    """(all, matrix-product) multiply-adds per point of the forward with the
    clip head off, as rendering and meshing run it."""
    clip = (h + 42) * h
    return fwd_macs(h) - clip, fwd_mm_macs(h) - clip


def bwd_macs(h: int) -> int:
    """Per point: the recomputed forward, the weight gradients (one MAC per
    weight), the input gradients of every layer, and the PE backward."""
    dx = 3 * h + h + 2 * h * h + 2 * 42 * h + h * h + (h + 87) * h + h * h + 87 * h
    return fwd_macs(h) + fwd_macs(h) + dx + 6 * 21


def bwd_mm_macs(h: int) -> int:
    """The backward's matrix products: the recomputed forward's, the weight
    gradients X^T dY and the input gradients dY W^T, each as many
    multiply-adds as the forward's products."""
    return 3 * fwd_mm_macs(h)


def bound_ms(flops: float, nbytes: float, mm_flops: float = 0.0,
             compute_dtype: str = "f32") -> tuple[float, str]:
    """Least time (ms) for ``flops`` FP32-accurate operations moving
    ``nbytes``, and what bounds it. The ``mm_flops`` of them that are matrix
    products may run on the tensor cores in 3xTF32 (three TF32 products for
    one FP32-accurate one), or, with ``compute_dtype="bf16"``, as bf16
    products at the dense bf16 rate; the rest run at the FP32 rate. The two
    kinds of unit may overlap, so the operations take the longer of the two
    times. With mm_flops = 0 this is the SIMT-only bound."""
    t_mm = mm_flops / PEAK_BF16 if compute_dtype == "bf16" else 3.0 * mm_flops / PEAK_TF32
    t_ops = max(t_mm, (flops - mm_flops) / PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def field_bounds(o: int, n: int, h: int, p: int, compute_dtype: str = "f32") -> dict:
    """Bounds of one fused-field forward and backward (clip head on) over O
    objects x N points at width h, P packed parameters per object: the
    points, weights and cotangents read once, the outputs (or one gradient
    per object) written once; ``*_simt`` with every product on the SIMT
    cores. Values are ``bound_ms`` pairs (ms, what bounds it).
    ``fwd_encode`` is the forward's encode alone on the SIMT cores, which
    the bound does not count: the projection's 63 multiply-adds and 126
    sines a point, each sine SINF_OPS."""
    cd = compute_dtype
    npts = o * n
    wbytes = o * p * 4
    fwd_bytes = npts * 12 + wbytes + npts * 4 * (1 + 3 + h)
    bwd_bytes = fwd_bytes + wbytes
    return {
        "fwd": bound_ms(2.0 * fwd_macs(h) * npts, fwd_bytes, 2.0 * fwd_mm_macs(h) * npts, cd),
        "bwd": bound_ms(2.0 * bwd_macs(h) * npts, bwd_bytes, 2.0 * bwd_mm_macs(h) * npts, cd),
        "fwd_simt": bound_ms(2.0 * fwd_macs(h) * npts, fwd_bytes),
        "fwd_encode": bound_ms((2.0 * 63 + 126 * SINF_OPS) * npts, 0.0),
        "bwd_simt": bound_ms(2.0 * bwd_macs(h) * npts, bwd_bytes),
    }


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device")


def scan_time(fn, args=(), iters: int = 400, reps: int = 5, warmup: int = 3) -> float:
    """Seconds per call of ``fn(*args)`` inside a CUDA graph."""
    _require_cuda()
    if iters < 2:
        raise ValueError(f"iters={iters}: need at least 2")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the default stream, as capture wants
        for _ in range(warmup):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    def capture(n: int) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn(*args)
        return graph

    g1, gn = capture(1), capture(iters)
    g1.replay()
    gn.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t1s, tns = [], []
    for _ in range(reps):
        for graph, acc in ((g1, t1s), (gn, tns)):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end) * 1e-3)
    del g1, gn
    return (statistics.median(tns) - statistics.median(t1s)) / (iters - 1)


def eager_time(fn, args=(), iters: int = 200, warmup: int = 10) -> float:
    """Seconds per call of ``fn(*args)`` launched back to back from Python."""
    _require_cuda()
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / iters


@dataclasses.dataclass
class Case:
    """One probe kernel call at fixed inputs. ``key`` is its entry in
    ``openobj_torch.ops.probes.COUNTS``; ``site`` the Pallas kernel it ports
    (``scripts/<file>.py:<line>``); ``tol`` the limit on max|d|/max|ref|
    against ``plain`` (None: exact); ``flops`` and ``nbytes`` the work of
    one call, ``mm_flops`` the part of ``flops`` that is matrix products the
    kernel runs on the tensor cores (in 3xTF32). The fields after ``iters``
    but ``mm_flops`` are filled by ``measure``."""

    name: str
    site: str
    key: str
    kernel: Callable[[], Any]
    plain: Callable[[], Any]
    library: Callable[[], Any] | None
    flops: float
    nbytes: float
    tol: float | None
    iters: int
    out: Any = None
    us: float = 0.0
    plain_us: float = 0.0
    library_us: float | None = None
    launches: int = 0
    mm_flops: float = 0.0


@contextlib.contextmanager
def counted(case: Case):
    """Add the launches of ``case``'s kernel inside the block to the case."""
    from openobj_torch.ops.probes import COUNTS

    before = COUNTS.get(case.key, 0)
    try:
        yield case
    finally:
        case.launches += COUNTS.get(case.key, 0) - before


def measure(case: Case, same_as: Case | None = None) -> Case:
    """Run the case's kernel once (kept in ``case.out``) and time it with
    ``scan_time``; time the plain version and the library call too, or take
    their times from ``same_as``, a measured case of the same function on
    the same inputs."""
    with counted(case):
        case.out = case.kernel()
        case.us = scan_time(case.kernel, iters=case.iters) * 1e6
    if same_as is not None:
        case.plain_us, case.library_us = same_as.plain_us, same_as.library_us
        return case
    case.plain_us = scan_time(case.plain, iters=case.iters) * 1e6
    if case.library is not None:
        case.library_us = scan_time(case.library, iters=case.iters) * 1e6
    return case


def rel_err(got, ref) -> float:
    """max|d| / max|ref| over a tensor or a tuple of tensors."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref))

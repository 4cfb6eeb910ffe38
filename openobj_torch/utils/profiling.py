"""Tracing / profiling instrumentation.

Port of ``openobj_tpu.utils.profiling``: the reference's
``performance_measure`` context manager (objnerf/utils.py:13-27, wrapped
around every training phase at train.py:161-478), an aggregating registry
so steady-state per-stage statistics survive past a single print, and a
``torch.profiler`` trace capture.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

# thread-local so concurrent scenes keep separate per-stage aggregates
_TLS = threading.local()


def _stats_dict() -> dict[str, list[float]]:
    if not hasattr(_TLS, "stats"):
        _TLS.stats = defaultdict(list)
    return _TLS.stats


@contextlib.contextmanager
def performance_measure(name: str, verbose: bool = True, block: bool = False):
    """Time a stage. With block=True, waits for the card's queued work to
    finish first (otherwise asynchronous launches make wall times
    meaningless)."""
    t0 = time.perf_counter_ns()
    yield
    if block and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt_ms = (time.perf_counter_ns() - t0) / 1e6
    _stats_dict()[name].append(dt_ms)
    if verbose:
        print(f"[perf] {name}: {dt_ms:.2f} ms")


def stats() -> dict[str, dict]:
    out = {}
    for name, xs in _stats_dict().items():
        out[name] = {
            "n": len(xs),
            "mean_ms": sum(xs) / len(xs),
            "last_ms": xs[-1],
            "min_ms": min(xs),
        }
    return out


def reset_stats():
    _stats_dict().clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block (host, and the card
    when one is in use) into ``logdir/trace.json``, viewable in
    chrome://tracing or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

"""Scene-level scale-out across device groups.

Port of ``openobj_tpu.parallel.multislice``. Every Replica/ScanNet scene is
an independent mapping job, so the parallelism across scenes is
scene-per-device-group: each group trains its own scene end to end, and the
only traffic between groups is file output. One process drives every group
from a thread pool (the per-frame host work is small and the kernels run
asynchronously); separate processes split the scene list with
``shard_scene_list`` (``scripts/run_scenes.py --scene-shard i:n``).

  * ``device_groups(n)`` partitions the visible devices (``torch.device``s;
    by default every visible CUDA device) into ``n`` contiguous groups,
    ordered by (rank, index) so a group never straddles processes unless it
    must;
  * ``run_parallel(tasks, groups)`` runs one task per group in a thread
    pool. Each worker thread makes its group's first device current
    (``torch.cuda.set_device``, the counterpart of ``jax.default_device``)
    before its task: CUDA's current device is per host thread, the native
    kernels launch on the calling thread's current device, and the port's
    ``device="cuda"`` defaults resolve to it.

``utils.profiling``'s spans are thread-local, so each scene records its
own; ``ops.fused_field.COUNTS`` (the kernels' launch counts) is
process-wide, so scenes that run at once add into the same counts.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def default_devices() -> list[torch.device]:
    """Every visible CUDA device of this process."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_groups(n_groups: int, devices: Sequence | None = None) -> list[list]:
    """Partition devices into ``n_groups`` contiguous groups whose sizes
    differ by at most 1, ordered by (process rank, device index)."""
    devices = [torch.device(d) for d in devices] if devices is not None else default_devices()
    if n_groups < 1:
        raise ValueError("n_groups must be >= 1")
    if n_groups > len(devices):
        raise ValueError(f"n_groups={n_groups} exceeds device count {len(devices)}")
    rank = _rank()
    devices.sort(key=lambda d: (rank, d.index if d.index is not None else -1))
    base, rem = divmod(len(devices), n_groups)
    groups, start = [], 0
    for g in range(n_groups):
        size = base + (1 if g < rem else 0)
        groups.append(devices[start:start + size])
        start += size
    return groups


@dataclass
class TaskResult:
    """Outcome of one parallel task: exactly one of result/error is set."""
    name: str
    result: Any = None
    error: Exception | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


def run_parallel(
    tasks: Sequence[tuple[str, Callable]],
    groups: list[list] | None = None,
    n_groups: int | None = None,
) -> list[TaskResult]:
    """Run tasks across device groups, one thread per group.

    tasks: (name, fn) pairs; fn is called as ``fn(devices)`` with its
    group's device list, its thread's current CUDA device set to the
    group's first device when that is a CUDA device. More tasks than groups
    queue up (a group starts its next task when its current one finishes).
    Exceptions are captured per task, never aborting siblings. Returns
    TaskResults in task order.
    """
    if groups is None:
        groups = device_groups(n_groups or max(len(default_devices()), 1))
    results = [TaskResult(name=name) for name, _ in tasks]
    it_lock = threading.Lock()
    it = iter(enumerate(tasks))

    def worker(group):
        if group[0].type == "cuda":
            torch.cuda.set_device(group[0])
        while True:
            with it_lock:
                nxt = next(it, None)
            if nxt is None:
                return
            i, (name, fn) = nxt
            try:
                results[i].result = fn(group)
            except Exception as e:  # noqa: BLE001 — reported per task
                results[i].error = e

    with ThreadPoolExecutor(max_workers=len(groups)) as ex:
        futures = [ex.submit(worker, g) for g in groups]
        for f in futures:
            f.result()
    return results


def shard_scene_list(scenes: Sequence, shard: str) -> list:
    """Split a scene list across processes: ``shard`` is "i:n" (0-based).
    Deterministic round-robin so every process gets a balanced mix."""
    i, n = (int(x) for x in shard.split(":"))
    if not (0 <= i < n):
        raise ValueError(f"bad scene shard {shard!r}")
    return [s for j, s in enumerate(scenes) if j % n == i]

"""Processes joined by ``torch.distributed``, and the scene shard of each.

Port of ``openobj_tpu.parallel.distributed``. Each host (or each card) is
one process; ``initialize`` joins them into one process group and
``process_scene_shard`` gives each its share of the independent scene list
(scenes never communicate, so the group carries no training traffic, only
barriers). Within a process, ``parallel.multislice`` trains scenes on
device groups. NCCL joins processes on the card; gloo joins CPU processes,
which is how tests/test_torch_distributed.py runs two local ones.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device="cuda") -> None:
    """Join this process into a group of ``num_processes`` at
    ``coordinator_address`` ("host:port"; process 0 listens there). On the
    card (``device`` "cuda", the default) the process makes card
    ``process_id`` modulo the visible count current and joins with NCCL;
    with ``device="cpu"`` it joins with gloo."""
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs num_processes and process_id")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_scene_shard() -> str:
    """This process's scene-shard spec "rank:world" for
    ``multislice.shard_scene_list``: each process trains every
    world-th scene."""
    return f"{dist.get_rank()}:{dist.get_world_size()}"


def barrier(name: str = "openobj_barrier") -> None:
    """Block until every process reaches this point (e.g. before reading a
    sibling's outputs). ``name`` labels the call site only."""
    del name
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()

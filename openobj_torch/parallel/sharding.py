"""The object axis split across GPUs: one process per device.

Port of ``openobj_tpu.parallel.sharding``. The JAX package shards the
stacked object axis over a single-controller mesh and lets GSPMD place
every [O, ...] leaf; torch runs one process per device, joined by
``torch.distributed`` (``parallel.distributed.initialize``), so here each
rank holds its contiguous block of object slots as plain contiguous
tensors on its own device: the fg params, their AdamW moments and counts,
and the fg keyframe tables with ``active``. The background model, its
moments and the frame store are replicated: every rank holds the same
copy. A mesh is a ``DeviceMesh`` whose dimensions are named ``("object",)``
or ``("data", "object")``; on a 2D mesh the ranks of one "data" group hold
the same object block and split each step's rays between them.

The trainer follows the ambient mesh, as the JAX trainer follows
``jax.set_mesh``: inside ``use_mesh(mesh)``, ``trainer.train_frame`` takes
the state and tables as this rank's block, gathers the small tables
(``gather_objects``) and draws for every slot what the unsharded run draws,
so every rank draws the same rays; each step keeps the rank's block of
slots and its share of the rays on "data" (``maybe_constrain``, as in the
JAX trainer), the masked means' counts (``ops.rendering``) and the
gradients are summed over "data" (``data_sum``), and the step losses over
the mesh once a frame (``mesh_sum``). Without a mesh, or on axes of size 1,
each of these returns its input. Over "object" the update needs no
collective: the fg loss is a sum over objects, so a block's gradients are
its own, and the replicated background sees the same rays on every rank.

Usage, on every rank after ``distributed.initialize`` (every rank passes the
same state, tables and store, e.g. built from the same seed)::

    mesh = make_mesh()                  # ("object",) over every rank
    state, tables, store = shard_scene(mesh, state, fg_tables, store)
    with use_mesh(mesh):
        state, losses = trainer.train_frame(state, store, cam_dirs, tables,
                                            bg_tables, gen, cfg)

The mapper runs on a split axis too: every rank builds the same
``SceneMapper`` (same config and seed), cuts its state and feeds it the same
frames. Growth (``trainer.grow_train_state``) has every rank draw the new
slots and keep its block of the grown axis (``grow_objects``); one slot's
params go from the rank holding it to every rank (``broadcast_slot``); the
npz snapshot gathers the state and one rank writes it; the batched render
merges the blocks' z-buffers in rank order::

    mapper.state, _ = shard_scene(mesh, mapper.state, {})
    with use_mesh(mesh):
        losses = mapper.process_frame(rgb, depth, inst, t_wc)

NCCL joins ranks on the cards, one card each; gloo joins CPU processes, which
is how the tests run 2 and 4 ranks.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

# the ambient (mesh, {axis name: (size, this rank's coordinate)}), or None:
# the trainer asks for axes many times a step, so they are read once
_MESH: contextvars.ContextVar = contextvars.ContextVar("openobj_mesh", default=None)


def _require_group() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh spans the ranks of a torch.distributed process group: call "
            "parallel.distributed.initialize (or init_process_group) first")
    return dist.get_world_size()


def make_mesh(device_type=None, axis_names=("object",), shape=None):
    """A ``DeviceMesh`` over every rank of the process group, one device
    each: all of them on the last named axis unless ``shape`` says
    otherwise. ``device_type`` defaults to "cuda" under NCCL, else "cpu".
    Raises without an initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _require_group()
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def make_mesh_2d(device_type=None, n_data: int = 2):
    """2D ("data", "object") mesh: object slots split over "object", each
    step's rays over "data". Activate with ``use_mesh(mesh)`` around the
    trainer's calls."""
    n = _require_group()
    if n % n_data:
        raise ValueError(f"{n} devices not divisible by data axis {n_data}")
    return make_mesh(device_type, ("data", "object"), (n_data, n // n_data))


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of the trainer's calls (and of the
    sharded snapshot) inside the block."""
    token = _MESH.set((mesh, _axes(mesh)))
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def _axes(mesh) -> dict:
    return {name: (mesh.size(i), mesh.get_local_rank(name))
            for i, name in enumerate(mesh.mesh_dim_names or ())}


def current_mesh():
    ambient = _MESH.get()
    return None if ambient is None else ambient[0]


def _axis(name: str, mesh) -> tuple[int, int]:
    if mesh is not None:
        axes = _axes(mesh)
    else:
        ambient = _MESH.get()
        axes = {} if ambient is None else ambient[1]
    return axes.get(name, (1, 0))


def axis_size(name: str, mesh=None) -> int:
    """Size of the named axis of ``mesh`` (default: the ambient one); 1
    when there is no mesh or it has no such axis."""
    return _axis(name, mesh)[0]


def axis_rank(name: str, mesh=None) -> int:
    """This rank's coordinate on the named axis (0 without one)."""
    return _axis(name, mesh)[1]


def maybe_constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along each leading dimension
    whose entry in ``axes`` names an axis of the ambient mesh of size > 1
    (``None`` leaves a dimension whole). Without a mesh, or on axes of
    size 1, ``x`` itself: library code can split without making callers
    think about meshes."""
    for dim, name in enumerate(axes):
        n = axis_size(name) if name is not None else 1
        if n > 1:
            x = torch.tensor_split(x, n, dim=dim)[axis_rank(name)]
    return x


def object_sharding(mesh) -> list:
    """The placements of an object-axis leaf on ``mesh``: its leading axis
    split over "object", whole on every other axis."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if n == "object" else Replicate() for n in mesh.mesh_dim_names]


def replicated(mesh) -> list:
    """The placements of a leaf every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def slot_offset(n_block: int) -> int:
    """The whole run's index of the first slot of this rank's block of
    ``n_block`` slots; 0 where the "object" axis is whole."""
    return axis_rank("object") * n_block


def mesh_leader() -> bool:
    """Whether this rank is the ambient mesh's first (every coordinate 0):
    the one that writes what every rank holds alike. True without a mesh."""
    ambient = _MESH.get()
    return ambient is None or all(r == 0 for _, r in ambient[1].values())


def gather_objects(tree):
    """The whole run's [O, ...] leaves from every rank's block of ``tree``
    (a dict of tensors, nested or not, or one tensor; an all-gather over
    "object", leaf by leaf); ``tree`` itself where that axis is whole."""
    from openobj_torch.models.object_field import tree_map

    n = axis_size("object")
    if n == 1:
        return tree
    group = current_mesh().get_group("object")

    def gather(x):
        y = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts).to(x.dtype)

    return tree_map(gather, tree)


def grow_objects(tree, extra):
    """``tree``'s [O, ...] leaves followed by ``extra``'s [E, ...] along the
    slot axis, as this rank's block of the O + E slots: ``tree`` is this
    rank's block of the old axis and ``extra`` the same whole stack on
    every rank, so each rank gathers the old blocks over "object",
    appends ``extra`` and keeps its block of the result. Both may be
    nested dicts or tensors. ``torch.cat`` of the two where the axis is
    whole. Raises when O + E does not divide the axis."""
    from openobj_torch.models.object_field import tree_map

    n = axis_size("object")
    grown = tree_map(lambda a, b: torch.cat([a, b], dim=0), gather_objects(tree), extra)
    if n == 1:
        return grown
    total = next(iter(_leaves(grown))).shape[0]
    if total % n:
        raise ValueError(f"object slots ({total}) must divide the 'object' mesh axis ({n})")
    size = total // n
    return tree_map(lambda x: _block(x, axis_rank("object") * size, size), grown)


def broadcast_slot(tree, slot: int):
    """The leaves of the whole run's slot ``slot`` (the slot axis dropped)
    on every rank, sent over "object" from the rank whose block of
    ``tree`` holds it. A collective: every rank of the object group calls
    it with the same slot, in the same order. Where the axis is whole, the
    slot's views of ``tree``."""
    from openobj_torch.models.object_field import tree_map

    n = axis_size("object")
    if n == 1:
        return tree_map(lambda x: x[slot], tree)
    n_block = next(iter(_leaves(tree))).shape[0]
    if not 0 <= slot < n_block * n:
        raise IndexError(f"slot {slot} outside the {n_block * n} slots of the run")
    owner, local = divmod(slot, n_block)
    group = current_mesh().get_group("object")
    src = dist.get_global_rank(group, owner)
    mine = axis_rank("object") == owner

    def send(x):
        y = x[local].contiguous() if mine else x.new_empty(x.shape[1:])
        dist.broadcast(y, src=src, group=group)
        return y

    return tree_map(send, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ambient mesh's "data" axis (in place); ``x``
    itself where that axis is of size 1."""
    if axis_size("data") > 1:
        dist.all_reduce(x, group=current_mesh().get_group("data"))
    return x


def data_sum_all(tensors):
    """Every tensor of the sequence (None entries kept) summed over "data"
    in one collective; the sequence itself where that axis is of size 1."""
    present = [t for t in tensors if t is not None]
    if axis_size("data") == 1 or not present:
        return tensors
    flat = data_sum(torch.cat([t.reshape(-1) for t in present]))
    out, at = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def mesh_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the ambient mesh (in place); ``x``
    itself without a mesh."""
    mesh = current_mesh()
    if mesh is not None:
        for name in mesh.mesh_dim_names:
            dist.all_reduce(x, group=mesh.get_group(name))
    return x


def _block(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    # a copy, not a view: the rank keeps its block, not the whole [O] storage
    return x.narrow(0, start, n).clone(memory_format=torch.contiguous_format)


def shard_scene(mesh, state, fg_tables: dict, store=None):
    """This rank's share of a TrainState and the fg keyframe tables: every
    stacked [O, ...] leaf (fg params, AdamW mu/nu/count, the tables) cut
    to the rank's contiguous block of slots, as plain contiguous tensors;
    the bg model and its moments replicated (kept). The state records the
    number of blocks it was cut into (``TrainState.n_shards``), and the
    trainer and the mapper refuse it under any other "object" axis.
    Returns (state, fg_tables[, store replicated])."""
    from openobj_torch.core import optim, trainer
    from openobj_torch.models.object_field import tree_map

    n_shards = axis_size("object", mesh)
    if state.n_shards != 1:
        raise ValueError(f"the state is already cut into {state.n_shards} object blocks")
    if state.n_slots % n_shards:
        raise ValueError(
            f"object slots ({state.n_slots}) must divide the 'object' mesh "
            f"axis ({n_shards}); grow the bucket first")
    n = state.n_slots // n_shards
    start = axis_rank("object", mesh) * n

    def cut(tree):
        return tree_map(lambda x: _block(x, start, n), tree)

    new_state = trainer.TrainState(
        fg_params=cut(state.fg_params),
        fg_opt=optim.AdamWState(mu=cut(state.fg_opt.mu), nu=cut(state.fg_opt.nu),
                                count=_block(state.fg_opt.count, start, n)),
        bg_params=state.bg_params,
        bg_opt=state.bg_opt,
        n_shards=n_shards,
    )
    out = (new_state, cut(fg_tables))
    if store is not None:
        out = out + (store,)
    return out

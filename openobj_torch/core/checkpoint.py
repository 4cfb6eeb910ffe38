"""Per-object checkpoints and whole-mapper snapshots, as ``.npz``.

Port of the JAX package's ``core.checkpoint`` (the per-object contract and
``save_scene`` / ``load_scene``). The files are the same: one
``obj_<id>.npz`` per object holding the field's leaves under
``params/<path>`` (``params/mlp/in_layer/w``, ...), ``obj_id``,
``obj_scale``, ``obj_center``, the oriented box (``bbox_center``,
``bbox_r``, ``bbox_extent``), the stacked CLIP/caption observation features
and the semantic id; and one ``scene_state.npz`` per snapshot with the
stacked params, the AdamW moments and counts, and the registry tables. Key
names, dtypes and shapes are the JAX package's, so a file written by either
package loads in the other.

The sharded snapshot (``save_scene_sharded`` / ``load_scene_sharded``) is a
``torch.distributed.checkpoint`` (DCP) directory where the JAX package
writes an orbax one: under ``parallel.sharding.use_mesh`` each rank writes
its own block of the object axis, with no gather to one host, and a load
puts each block back on its rank. Beside it, ``scene_meta.npz`` holds the
registry tables under the JAX package's keys. ``save_scene``'s npz stays
the format both packages read: from a mapper split over "object" it is
the whole state, gathered, written once, and ``load_scene`` gives each
rank its block of it.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _flatten(tree: dict, prefix: str) -> dict:
    """{prefix + "a/b/c": numpy leaf} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def _unflatten(files, prefix: str, template: dict) -> dict:
    """Leaves of ``files`` shaped like ``template``, with its dtypes and
    devices."""
    out = {}
    for k, v in template.items():
        if isinstance(v, dict):
            out[k] = _unflatten(files, f"{prefix}{k}/", v)
        else:
            out[k] = torch.as_tensor(np.asarray(files[prefix + k]), dtype=v.dtype,
                                     device=v.device)
    return out


def save_object_checkpoint(
    path: str,
    obj_id: int,
    params: dict,
    obj_scale: float,
    bbox3d=None,            # utils.geometry.OrientedBox | None
    obj_center=None,
    clip_feats: np.ndarray | None = None,
    caption_feats: np.ndarray | None = None,
    semantic_id: int | None = None,
):
    """One object's field + metadata."""
    data = _flatten(params, "params/")
    data["obj_id"] = np.asarray(obj_id, np.int32)
    data["obj_scale"] = np.asarray(obj_scale, np.float32)
    data["obj_center"] = np.asarray(
        obj_center if obj_center is not None else np.zeros(3), np.float32)
    if bbox3d is not None:
        data["bbox_center"] = np.asarray(bbox3d.center, np.float32)
        data["bbox_r"] = np.asarray(bbox3d.r, np.float32)
        data["bbox_extent"] = np.asarray(bbox3d.extent, np.float32)
    if clip_feats is not None:
        data["clip_feats"] = np.asarray(clip_feats, np.float32)
    if caption_feats is not None:
        data["caption_feats"] = np.asarray(caption_feats, np.float32)
    if semantic_id is not None:
        data["semantic_id"] = np.asarray(semantic_id, np.int32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **data)


def load_object_checkpoint(path: str, params_template: dict) -> dict:
    """Returns {obj_id, params (shaped, typed and placed like the template),
    obj_scale, obj_center, bbox (OrientedBox | None), clip_feats,
    caption_feats, semantic_id}."""
    from openobj_torch.utils.geometry import OrientedBox

    z = np.load(path)
    out = {
        "obj_id": int(z["obj_id"]),
        "obj_scale": float(z["obj_scale"]),
        "obj_center": z["obj_center"],
        "params": _unflatten(z, "params/", params_template),
        "bbox": None,
        "clip_feats": z["clip_feats"] if "clip_feats" in z else None,
        "caption_feats": z["caption_feats"] if "caption_feats" in z else None,
        "semantic_id": int(z["semantic_id"]) if "semantic_id" in z else None,
    }
    if "bbox_center" in z:
        out["bbox"] = OrientedBox(
            center=z["bbox_center"].astype(np.float64),
            r=z["bbox_r"].astype(np.float64),
            extent=z["bbox_extent"].astype(np.float64),
        )
    return out


def _device_state_tree(st) -> dict:
    """The mapper's device state as one nested dict (the snapshot's
    state dict)."""
    tree = {
        "fg_params": st.fg_params,
        "fg_mu": st.fg_opt.mu,
        "fg_nu": st.fg_opt.nu,
        "fg_count": st.fg_opt.count,
    }
    if st.bg_params is not None:
        tree.update(bg_params=st.bg_params, bg_mu=st.bg_opt.mu, bg_nu=st.bg_opt.nu,
                    bg_count=st.bg_opt.count)
    return tree


_OBJECT_AXIS = ("fg_params", "fg_mu", "fg_nu", "fg_count")


def _on_mesh(tree: dict, mesh) -> dict:
    """``tree`` with its object-axis leaves as DTensors of this rank's
    block on ``mesh`` (split over "object", whole over "data"); the rest
    as it is, replicated. DTensors exist only here, at DCP's boundary."""
    if mesh is None:
        return tree
    from torch.distributed.tensor import DTensor

    from openobj_torch.models.object_field import tree_map
    from openobj_torch.parallel import sharding

    place = sharding.object_sharding(mesh)

    def wrap(x):
        return DTensor.from_local(x, mesh, place, run_check=False)

    return {k: tree_map(wrap, v) if k in _OBJECT_AXIS else v for k, v in tree.items()}


def save_state_sharded(path: str, state) -> None:
    """TrainState -> a DCP directory. Inside ``sharding.use_mesh`` the
    state is this rank's block of slots, and each rank writes its own
    block (no gather to one host); outside, the state as it is."""
    import torch.distributed.checkpoint as dcp

    from openobj_torch.parallel import sharding

    tree = _on_mesh(_device_state_tree(state), sharding.current_mesh())
    # an existing snapshot at ``path`` is replaced, as the JAX package's
    # orbax save does with force=True
    dcp.save(tree, storage_writer=dcp.FileSystemWriter(os.path.abspath(path), overwrite=True))


def load_state_sharded(path: str, state_template):
    """Restore a ``save_state_sharded`` snapshot into the template's
    placement: every leaf with the template's shape, dtype and device,
    and inside ``sharding.use_mesh`` the template's block of slots read
    from the blocks that were written, whatever mesh wrote them. Returns a
    new TrainState (bg from the template when it has none)."""
    import torch.distributed.checkpoint as dcp

    from openobj_torch.core import optim, trainer
    from openobj_torch.models.object_field import tree_map
    from openobj_torch.parallel import sharding

    mesh = sharding.current_mesh()
    tree = _on_mesh(tree_map(torch.empty_like, _device_state_tree(state_template)), mesh)
    dcp.load(tree, checkpoint_id=os.path.abspath(path))
    if mesh is not None:
        tree = {k: tree_map(lambda x: x.to_local(), v) if k in _OBJECT_AXIS else v
                for k, v in tree.items()}
    bg = "bg_params" in tree
    return trainer.TrainState(
        fg_params=tree["fg_params"],
        fg_opt=optim.AdamWState(tree["fg_mu"], tree["fg_nu"], tree["fg_count"]),
        bg_params=tree["bg_params"] if bg else state_template.bg_params,
        bg_opt=optim.AdamWState(tree["bg_mu"], tree["bg_nu"], tree["bg_count"])
        if bg else state_template.bg_opt,
        n_shards=state_template.n_shards,
    )


def _is_writer() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_scene_sharded(dirpath: str, mapper) -> None:
    """Scene snapshot for scale-out runs: the device state as a DCP
    directory (``save_state_sharded``: each rank its own block inside
    ``sharding.use_mesh``), the host registry as ``scene_meta.npz`` beside
    it, written by rank 0. Counterpart of ``save_scene``."""
    from openobj_torch.core import trainer

    trainer.check_mesh(mapper.state)
    dirpath = os.path.abspath(dirpath)
    os.makedirs(dirpath, exist_ok=True)
    if _is_writer():
        # written before the state, whose save ends with a collective: no
        # rank returns before the metadata is on disk
        np.savez_compressed(
            os.path.join(dirpath, "scene_meta.npz"),
            n_slots=np.asarray(mapper.state.global_slots, np.int64),
            has_bg=np.asarray(int(mapper.state.bg_params is not None), np.int64),
            **_registry_meta(mapper),
        )
    save_state_sharded(os.path.join(dirpath, "dcp_state"), mapper.state)


def load_scene_sharded(dirpath: str, mapper) -> None:
    """Restore a ``save_scene_sharded`` snapshot into the mapper's current
    placement: construct the mapper (and ``shard_scene`` its state inside
    ``sharding.use_mesh`` if desired) first; each leaf is read with the
    shape, dtype and device of the mapper's state, a sharded state's block
    from the blocks on disk. A snapshot with more slots grows the state
    first."""
    from openobj_torch.core import trainer

    dirpath = os.path.abspath(dirpath)
    z = np.load(os.path.join(dirpath, "scene_meta.npz"))
    n_slots = int(z["n_slots"])
    trainer.check_mesh(mapper.state)
    have = mapper.state.global_slots
    if have > n_slots:
        raise ValueError(
            f"snapshot has {n_slots} object slots but the mapper already "
            f"has {have}; construct the mapper with "
            f"initial_bucket <= {n_slots} before restoring")
    snap_bg = bool(int(z["has_bg"])) if "has_bg" in z else True
    if snap_bg != (mapper.state.bg_params is not None):
        raise ValueError(
            "snapshot and mapper disagree on the background model "
            f"(snapshot has_bg={snap_bg}); construct the mapper with the "
            "same do_bg config")
    if have != n_slots:
        gen = torch.Generator(device=mapper.device).manual_seed(0)
        mapper.state = trainer.grow_train_state(gen, mapper.state, mapper.cfg, n_slots)
    mapper.state = load_state_sharded(os.path.join(dirpath, "dcp_state"), mapper.state)
    _restore_registry_meta(mapper, z)


def _registry_meta(mapper) -> dict:
    """Host-side registry and bookkeeping arrays."""
    r = mapper.registry
    return {
        "kf_frames": r.kf_frames,
        "kf_bbox": r.kf_bbox,
        "n_kf": r.n_kf,
        "latest2": r.latest2,
        "active": r.active,
        "obj_inst": r.obj_inst,
        "slot_inst_ids": np.asarray(
            [r.slots[s].inst_id for s in sorted(r.slots)], np.int64),
        "frame_count": np.asarray(mapper.frame_count, np.int64),
        # temporal frame -> store slot (eviction recycles slots)
        "frame_slots": np.asarray(mapper.frame_slots, np.int64),
        # the store capacity the run was trained with: a restore rebuilds a
        # smaller store at this size
        "frame_capacity": np.asarray(mapper.store.capacity, np.int64),
        "bg_seen": np.asarray(int(r.bg_seen), np.int64),
        "bg_kf_frames": r.bg_kf_frames,
        "bg_kf_bbox": r.bg_kf_bbox,
        "bg_latest2": r.bg_latest2,
        "bg_n_kf": np.asarray(r.bg.n_kf if r.bg else 0, np.int64),
    }


def save_scene(dirpath: str, mapper) -> None:
    """Resumable snapshot of a SceneMapper's device and host state. Inside
    ``sharding.use_mesh`` with the object axis split, every rank gathers
    the fg leaves over "object" (a collective: every rank calls it), the
    mesh's first rank alone writes the whole state, the file the unsharded
    mapper would write, and no rank returns before it is on disk."""
    from openobj_torch.core import trainer
    from openobj_torch.parallel import distributed, sharding

    st = mapper.state
    trainer.check_mesh(st)
    fg = sharding.gather_objects({"fg_params": st.fg_params, "fg_mu": st.fg_opt.mu,
                                  "fg_nu": st.fg_opt.nu, "fg_count": st.fg_opt.count})
    if sharding.mesh_leader():
        os.makedirs(dirpath, exist_ok=True)
        data = _flatten(fg, "")
        if st.bg_params is not None:
            data.update(_flatten(st.bg_params, "bg_params/"))
            data.update(_flatten(st.bg_opt.mu, "bg_mu/"))
            data.update(_flatten(st.bg_opt.nu, "bg_nu/"))
            data["bg_count"] = st.bg_opt.count.cpu().numpy()
        data.update(_registry_meta(mapper))
        np.savez_compressed(os.path.join(dirpath, "scene_state.npz"), **data)
    mesh = sharding.current_mesh()
    if mesh is not None and mesh.size() > 1:
        distributed.barrier("save_scene")


def load_scene(dirpath: str, mapper) -> None:
    """Restore a ``save_scene`` snapshot into a freshly constructed mapper
    with the same config (device state and keyframe tables; the per-slot
    host policy counters resume approximately: frame counts restart). A
    mapper whose state is cut over the ambient "object" axis
    (``sharding.shard_scene`` inside ``sharding.use_mesh``) gets its block
    of the snapshot's slots on each rank."""
    from openobj_torch.core import optim, trainer
    from openobj_torch.parallel import sharding

    st = mapper.state
    trainer.check_mesh(st)
    z = np.load(os.path.join(dirpath, "scene_state.npz"))
    n_slots = z["fg_count"].shape[0]
    if st.global_slots > n_slots:
        raise ValueError(
            f"snapshot has {n_slots} object slots but the mapper already "
            f"has {st.global_slots}; construct the mapper with "
            f"initial_bucket <= {n_slots} before restoring")
    dev = st.fg_opt.count.device

    def count(key, like):
        return torch.as_tensor(z[key], dtype=like.dtype, device=dev)

    # the leaves as the file holds them (every slot), typed and placed like
    # the mapper's, then cut to this rank's block
    fg_params = _unflatten(z, "fg_params/", st.fg_params)
    fg_opt = optim.AdamWState(
        mu=_unflatten(z, "fg_mu/", st.fg_opt.mu),
        nu=_unflatten(z, "fg_nu/", st.fg_opt.nu),
        count=count("fg_count", st.fg_opt.count))
    bg_params, bg_opt = st.bg_params, st.bg_opt
    if (st.bg_params is not None) != ("bg_count" in z):
        # continuing with fresh bg params as if they were trained state
        # would be a silent corruption
        raise ValueError(
            "snapshot/mapper background mismatch: "
            f"mapper do_bg={st.bg_params is not None}, "
            f"snapshot has bg={'bg_count' in z}")
    if st.bg_params is not None:
        bg_params = _unflatten(z, "bg_params/", st.bg_params)
        bg_opt = optim.AdamWState(
            mu=_unflatten(z, "bg_mu/", st.bg_opt.mu),
            nu=_unflatten(z, "bg_nu/", st.bg_opt.nu),
            count=count("bg_count", st.bg_opt.count))
    state = trainer.TrainState(fg_params, fg_opt, bg_params, bg_opt)
    if st.n_shards > 1:
        state, _ = sharding.shard_scene(sharding.current_mesh(), state, {})
    mapper.state = state
    _restore_registry_meta(mapper, z)


def _restore_registry_meta(mapper, z) -> None:
    from openobj_torch.core.registry import SlotState

    r = mapper.registry
    r.kf_frames[:] = z["kf_frames"]
    r.kf_bbox[:] = z["kf_bbox"]
    r.n_kf[:] = z["n_kf"]
    r.latest2[:] = z["latest2"]
    r.active[:] = z["active"]
    r.obj_inst[:] = z["obj_inst"]
    for slot, inst_id in enumerate(z["slot_inst_ids"]):
        inst_id = int(inst_id)
        stt = SlotState(inst_id, is_bg=False)
        stt.n_kf = int(r.n_kf[slot])
        stt.latest = [int(x) for x in r.latest2[slot]]
        r.slots[slot] = stt
        r.inst_to_slot[inst_id] = slot
    if "frame_count" in z:
        mapper.frame_count = int(z["frame_count"])
        for stt in r.slots.values():
            stt.frame_cnt = mapper.frame_count  # approximate policy resume
    if "frame_slots" in z:
        mapper.frame_slots = [int(x) for x in z["frame_slots"]]
    if "frame_capacity" in z:
        snap_cap = int(z["frame_capacity"])
        if mapper.store.capacity < snap_cap:
            # the keyframe tables index store slots up to the original
            # capacity: rebuild the (still empty) store at that size
            from openobj_torch.core.frame_store import init_frame_store

            cfg = mapper.cfg
            mapper.store = init_frame_store(
                snap_cap, mapper.camera.height, mapper.camera.width,
                part_feat_dim=cfg.clip_size if cfg.part_mode else 0,
                part_down=cfg.part_down, part_dtype=cfg.part_dtype,
                device=mapper.device)
    if "bg_seen" in z and r.bg is not None:
        r.bg_seen = bool(int(z["bg_seen"]))
        r.bg_kf_frames[:] = z["bg_kf_frames"]
        r.bg_kf_bbox[:] = z["bg_kf_bbox"]
        r.bg_latest2[:] = z["bg_latest2"]
        r.bg.n_kf = int(z["bg_n_kf"])
        r.bg.latest = [int(x) for x in r.bg_latest2]
        r.bg.frame_cnt = mapper.frame_count

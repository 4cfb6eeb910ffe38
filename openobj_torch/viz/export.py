"""Map export: checkpoints -> per-object mesh + feature bundle.

Port of the JAX package's ``viz.export``; meshing runs through the port's
``core.meshing`` (K1 on the card). Reading a reference training run's
``.pth`` checkpoints (``interop``) is not ported: ``export_from_checkpoints``
takes ``obj_<id>.npz`` directories, as either package's ``save_checkpoints``
writes them.

Parity with the reference visualization/gen_map_vis.py: load every
object's field, mesh it at grid 128 with vertex colors and vertex part
features (:113-124), L2-normalize the part features, and bundle
{clip_feat, caption_feat, class_id, mesh, color, part_feat} per object into
a gzipped pickle (map_vis.pkl.gz contract, :128-146) consumed by the query
layer."""

from __future__ import annotations

import gzip
import os
import pickle

import numpy as np

from openobj_torch.core import meshing


def export_object_entry(
    params: dict,
    obb,
    obj_center,
    clip_feat: np.ndarray | None,
    caption_feat: np.ndarray | None,
    class_id: int | None,
    grid_dim: int = 128,
    is_bg: bool = False,
    max_deg: int = 5,
) -> dict | None:
    mesh = meshing.mesh_object(
        params, obb, np.asarray(obj_center), grid_dim=grid_dim, is_bg=is_bg,
        with_color=True, with_part=True, max_deg=max_deg,
    )
    if mesh is None:
        return None
    pf = mesh.vertex_attrs["partfeat"]
    pf = pf / np.maximum(np.linalg.norm(pf, axis=-1, keepdims=True), 1e-12)
    return {
        "mesh": {"vertices": mesh.vertices, "faces": mesh.faces},
        "color": mesh.vertex_colors,
        "part_feat": pf.astype(np.float32),
        "clip_feat": clip_feat,
        "caption_feat": caption_feat,
        "class_id": class_id,
    }


class _BagUnpickler(pickle.Unpickler):
    """Unpickler that turns unimportable classes (the reference's trimesh
    meshes and box objects where those packages are missing) into attribute
    bags; pickle sets their ``__dict__`` as usual."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (), {"__module__": module})


def save_map_bundle(path: str, objects: dict[int, dict]):
    """Write map_vis bundle: {obj_id: entry} gzipped pickle."""
    with gzip.open(path, "wb") as f:
        pickle.dump(objects, f)


def load_map_bundle(path: str, normalize: bool = True) -> dict[int, dict]:
    """Load a map_vis bundle — ours, or one written by the reference's
    gen_map_vis.py (:128-146). Unknown pickled classes (e.g. the
    reference's trimesh mesh objects when trimesh isn't importable here)
    deserialize as attribute bags, and ``normalize`` rewrites every entry
    into this package's schema (dict mesh, [V,3] color, numpy features) —
    see ``normalize_bundle``."""
    with gzip.open(path, "rb") as f:
        bundle = _BagUnpickler(f).load()
    return normalize_bundle(bundle) if normalize else bundle


def _to_numpy(x, dtype=np.float32):
    if x is None:
        return None
    if hasattr(x, "detach"):  # torch tensor (reference saves these raw)
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def normalize_bundle(bundle: dict) -> dict[int, dict]:
    """Rewrite reference-written map_vis entries into our schema.

    The reference pickles trimesh meshes, RGBA uint8 vertex colors, and
    raw torch feature tensors (gen_map_vis.py:128-137); our consumers
    (viz.query, viz.viewer, viz.server) expect {"vertices", "faces"} dict
    meshes, [V, 3] colors, and numpy features. Entries already in our
    schema pass through unchanged, so this is safe to apply always."""
    out: dict[int, dict] = {}
    for oid, e in bundle.items():
        mesh = e.get("mesh")
        if not isinstance(mesh, dict):
            v = getattr(mesh, "vertices", None)
            f = getattr(mesh, "faces", None)
            if v is None or f is None:
                raise ValueError(
                    f"object {oid}: mesh of type {type(mesh).__name__} "
                    "carries no vertices/faces — install trimesh so the "
                    "reference's mesh objects unpickle fully"
                )
            mesh = {
                "vertices": np.asarray(v, np.float32),
                "faces": np.asarray(f, np.uint32),
            }
        else:
            mesh = {
                "vertices": np.asarray(mesh["vertices"], np.float32),
                "faces": np.asarray(mesh["faces"], np.uint32),
            }
        color = _to_numpy(e.get("color"), dtype=None)
        if color is not None:
            if color.ndim == 2 and color.shape[1] == 4:  # trimesh RGBA
                color = color[:, :3]
            if color.dtype != np.uint8:  # floats in [0,1] -> uint8
                color = (np.clip(color, 0.0, 1.0) * 255).astype(np.uint8)
        class_id = e.get("class_id")
        if class_id is not None:
            class_id = int(
                class_id.item() if hasattr(class_id, "item") else class_id
            )
        out[int(oid)] = {
            "mesh": mesh,
            "color": color,
            "part_feat": _to_numpy(e.get("part_feat")),
            "clip_feat": _to_numpy(e.get("clip_feat")),
            "caption_feat": _to_numpy(e.get("caption_feat")),
            "class_id": class_id,
        }
    return out


def export_scene_map(
    mapper,
    path: str,
    grid_dim: int = 128,
    live_voxel_size: float = 0.005,
) -> dict[int, dict]:
    """Mesh + bundle every mapped object of a SceneMapper (reference
    gen_map_vis.py:64-146 flow, with adaptive grid dim train.py:626)."""
    out: dict[int, dict] = {}
    for inst_id, slot in mapper.registry.inst_to_slot.items():
        st = mapper.registry.slots[slot]
        if st.bbox3d is None:
            continue
        dim = meshing.adaptive_grid_dim(st.bbox3d, live_voxel_size, grid_dim)
        clip = np.stack(st.clip_feats) if st.clip_feats else None
        cap = np.stack(st.caption_feats) if st.caption_feats else None
        entry = export_object_entry(
            mapper.slot_params(slot), st.bbox3d, st.obj_center,
            clip, cap, st.semantic_id, grid_dim=dim,
        )
        if entry is not None:
            out[inst_id] = entry
    if path:
        save_map_bundle(path, out)
    return out


def export_from_checkpoints(
    ckpt_root: str,
    out_path: str,
    hidden: int = 32,
    hidden_bg: int = 128,
    clip_size: int = 512,
    max_deg: int = 5,
    grid_dim: int = 128,
    live_voxel_size: float = 0.005,
    bg_id: int = 0,
    device="cuda",
) -> dict[int, dict]:
    """Checkpoint directory -> map_vis bundle (the reference's standalone
    gen_map_vis.py flow, :64-146: load every ckpt/<id>/obj_<id> checkpoint,
    mesh with vertex colors + part features, bundle).

    ``ckpt_root`` is the training CLI's <logdir>/ckpt with one
    subdirectory per object id. The fields are loaded onto ``device``.
    """
    import glob as _glob
    import re

    import torch

    from openobj_torch.core import checkpoint
    from openobj_torch.models import object_field

    paths = sorted(_glob.glob(os.path.join(ckpt_root, "*", "obj_*.npz")))
    if not paths:
        raise FileNotFoundError(
            f"no obj_<id>.npz checkpoints under {ckpt_root} (converting a "
            "reference run's obj_<id>.pth files is not ported)")
    out: dict[int, dict] = {}
    templates = {}
    for p in paths:
        oid = int(re.search(r"obj_(\d+)\.npz$", p).group(1))
        is_bg = oid == bg_id
        h = hidden_bg if is_bg else hidden
        if h not in templates:
            templates[h] = object_field.init_field_params(
                torch.Generator(device=device).manual_seed(0), hidden=h,
                clip_size=clip_size, scale=1.0, max_deg=max_deg, device=device,
            )
        ck = checkpoint.load_object_checkpoint(p, templates[h])
        if ck["bbox"] is None:
            continue
        dim = meshing.adaptive_grid_dim(ck["bbox"], live_voxel_size, grid_dim)
        entry = export_object_entry(
            ck["params"], ck["bbox"], ck["obj_center"],
            ck["clip_feats"], ck["caption_feats"], ck["semantic_id"],
            grid_dim=dim, is_bg=is_bg, max_deg=max_deg,
        )
        if entry is not None:
            out[oid] = entry
    if out_path:
        save_map_bundle(out_path, out)
    return out

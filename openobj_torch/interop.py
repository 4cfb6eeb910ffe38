"""Reference-checkpoint interop: the reference's torch ``obj_<id>.pth``
files <-> this port's param trees / npz checkpoints.

Port of ``openobj_tpu.interop``. The reference saves one .pth per object
with the ``OccupancyMap`` + ``UniDirsEmbed`` torch state dicts, obj_id,
oriented bbox, obj_scale, the stacked per-keyframe CLIP/caption features,
and the semantic id (objnerf/vmap.py:556-576); its export/vis consumers read
them back (gen_map_vis.py:86-90). This module brings those trained objects
into the port (mesh, render, query, eval — no retraining), and exports back
the other way so reference tooling can consume maps trained here.

The params are nested dicts of float32 tensors, as everywhere in the port.
The .pth files hold float32 CPU tensors; every function that makes params
takes the ``device`` to put them on, and every function that writes a .pth
copies the params to the CPU first, so no device is left implicit. A whole
directory is converted on the CPU: the conversion only moves float32 values
from file to file.

Layer-name / layout mapping (reference model.py:16-103, fc_block =
Sequential(Linear, ReLU), so trained Linears sit at ``<name>.0`` and the
``mid*`` blocks at ``mid*.0.0``; torch Linear weights are [out, in], ours
are [in, out]):

    FC_state_dict                         params["mlp"]
    ------------------------------------  --------------------
    in_layer.0.{weight,bias}              in_layer.{w^T, b}
    mid1.0.0.{weight,bias}                mid1.{w^T, b}
    cat_layer.0.{weight,bias}             cat_layer.{w^T, b}
    mid2.0.0.{weight,bias}                mid2.{w^T, b}
    out_alpha.{weight,bias}               out_alpha.{w^T, b}
    color_linear.0.{weight,bias}          color_linear.{w^T, b}
    out_color.{weight,bias}               out_color.{w^T, b}
    clip_linear.0.{weight,bias}           clip_linear.{w^T, b}
    out_clip.{weight,bias}                out_clip.{w^T, b}

    PE_state_dict                         params["pe"]
    ------------------------------------  --------------------
    B_layer.weight  [21, 3]               dirs  [21, 3]   (same layout:
                                          both compute (x/scale) @ dirs^T)
    scale           (persistent buffer)   scale (stop-grad constant)

``frequency_bands`` is a non-persistent buffer (embedding.py:44) so it is
absent from reference state dicts; both sides derive it from max_deg.
Hidden width, clip size, and max_deg are inferred from the weight shapes,
so object (32) and background (128) checkpoints import with no flags. The
reference's ``obj_center`` is the constant 0 (vmap.py:162, its
init_obj_center path is commented out in train.py:239-245).

    python -m openobj_torch.interop <src> <dst> [--reverse]
"""

from __future__ import annotations

import glob
import os
import pickle
import re
import types

import numpy as np
import torch

from openobj_torch.ops import embedding
from openobj_torch.utils.geometry import OrientedBox

# (reference linear key prefix, our mlp key)
_FC_LAYERS = (
    ("in_layer.0", "in_layer"),
    ("mid1.0.0", "mid1"),
    ("cat_layer.0", "cat_layer"),
    ("mid2.0.0", "mid2"),
    ("out_alpha", "out_alpha"),
    ("color_linear.0", "color_linear"),
    ("out_color", "out_color"),
    ("clip_linear.0", "clip_linear"),
    ("out_clip", "out_clip"),
)


class _BagUnpickler(pickle.Unpickler):
    """Unpickler that turns unimportable classes into attribute bags.

    The reference pickles its custom ``utils.BoundingBox`` instance inside
    the checkpoint dict (and trimesh meshes inside its map_vis bundles);
    loading here must not require those packages, so unknown globals
    deserialize into plain attribute holders (their ``__dict__`` is set by
    pickle as usual)."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (), {"__module__": module})


def _tolerant_pickle_module():
    mod = types.ModuleType("openobj_torch._tolerant_pickle")
    for attr in dir(pickle):
        if not attr.startswith("_"):
            setattr(mod, attr, getattr(pickle, attr))
    mod.Unpickler = _BagUnpickler
    return mod


def _np(x) -> np.ndarray | None:
    """torch tensor / array / scalar -> float32 numpy (None passes)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _tensor(x, device) -> torch.Tensor:
    """A float32 leaf on ``device``, copied from a tensor or an array."""
    return torch.as_tensor(_np(x)).to(device=device, dtype=torch.float32, copy=True)


def reference_state_dicts_to_params(fc_state: dict, pe_state: dict, device="cuda") -> dict:
    """Torch state dicts -> our {"pe", "mlp"} param tree of float32 tensors
    on ``device``.

    Raises KeyError on a missing layer and ValueError on an inconsistent
    trunk shape (e.g. hidden_layers_block != 1, which the reference never
    configures — all shipped configs use the default single block)."""
    extra = [k for k in fc_state if re.match(r"mid[12]\.(?!0\.0\.)", k)]
    if extra:
        raise ValueError(
            f"unsupported hidden_layers_block > 1 (keys {extra})"
        )
    mlp_params = {}
    for ref_key, our_key in _FC_LAYERS:
        wk, bk = f"{ref_key}.weight", f"{ref_key}.bias"
        if wk not in fc_state:
            if our_key in ("color_linear", "out_color", "clip_linear",
                           "out_clip"):
                continue  # do_color/do_clip=False variants
            raise KeyError(f"reference FC_state_dict missing {wk}")
        mlp_params[our_key] = {
            "w": _tensor(_np(fc_state[wk]).T, device).contiguous(),
            "b": _tensor(fc_state[bk], device),
        }
    emb1, hidden = mlp_params["in_layer"]["w"].shape
    cat_in = mlp_params["cat_layer"]["w"].shape[0]
    if cat_in != hidden + emb1:
        raise ValueError(
            f"cat_layer expects {cat_in} inputs, not hidden+emb1 = "
            f"{hidden + emb1}"
        )
    dirs = _tensor(pe_state["B_layer.weight"], device)
    if tuple(dirs.shape) != (embedding.N_DIRS, 3):
        raise ValueError(f"PE direction table shape {tuple(dirs.shape)}")
    scale = _tensor(pe_state.get("scale", 1.0), device).reshape(())
    return {"pe": {"dirs": dirs, "scale": scale}, "mlp": mlp_params}


def _cpu(x, dtype) -> torch.Tensor:
    """A leaf (tensor on any device, or array) as a fresh CPU tensor."""
    return torch.as_tensor(x).detach().to(device="cpu", dtype=dtype, copy=True)


def params_to_reference_state_dicts(params: dict, dtype=torch.float32):
    """Our {"pe", "mlp"} param tree (on any device) -> (FC_state_dict,
    PE_state_dict) of CPU torch tensors in the reference's key layout.
    ``dtype`` defaults to the reference's float32."""
    fc = {}
    for ref_key, our_key in _FC_LAYERS:
        if our_key not in params["mlp"]:
            continue
        layer = params["mlp"][our_key]
        fc[f"{ref_key}.weight"] = _cpu(layer["w"], dtype).T.contiguous()
        fc[f"{ref_key}.bias"] = _cpu(layer["b"], dtype)
    pe = {
        "B_layer.weight": _cpu(params["pe"]["dirs"], dtype),
        "scale": _cpu(params["pe"]["scale"], dtype).reshape(()),
    }
    return fc, pe


def _bbox_from_bag(bag) -> OrientedBox | None:
    """Reference utils.BoundingBox (attribute bag) -> OrientedBox."""
    if bag is None:
        return None
    center = getattr(bag, "center", None)
    rot = getattr(bag, "R", getattr(bag, "r", None))
    extent = getattr(bag, "extent", None)
    if center is None or rot is None or extent is None:
        return None
    return OrientedBox(
        center=np.asarray(_np(center), np.float64).reshape(3),
        r=np.asarray(_np(rot), np.float64).reshape(3, 3),
        extent=np.asarray(_np(extent), np.float64).reshape(3),
    )


def import_torch_checkpoint(path: str, device="cuda") -> dict:
    """Reference obj_<id>.pth -> the load_object_checkpoint schema:
    {obj_id, params (on ``device``), obj_scale, obj_center, bbox,
    clip_feats, caption_feats, semantic_id} plus inferred {hidden,
    clip_size, max_deg, epoch}."""
    ck = torch.load(
        path, map_location="cpu", weights_only=False,
        pickle_module=_tolerant_pickle_module(),
    )
    params = reference_state_dicts_to_params(
        ck["FC_state_dict"], ck["PE_state_dict"], device=device
    )
    mlp_p = params["mlp"]
    emb1, hidden = mlp_p["in_layer"]["w"].shape
    emb2 = (
        mlp_p["color_linear"]["w"].shape[0] - hidden
        if "color_linear" in mlp_p else 0
    )
    clip_size = mlp_p["out_clip"]["w"].shape[1] if "out_clip" in mlp_p else 0
    n_freq = (emb1 + emb2 - 3) // embedding.N_DIRS
    sem = ck.get("semantic_id")
    if sem is not None and hasattr(sem, "item"):
        sem = sem.item()
    return {
        "obj_id": int(ck["obj_id"]),
        "params": params,
        "obj_scale": float(_np(ck.get("obj_scale", 1.0))),
        # the reference's obj_center is the constant 0 (vmap.py:162)
        "obj_center": np.zeros(3, np.float32),
        "bbox": _bbox_from_bag(ck.get("bbox")),
        "clip_feats": _np(ck.get("clip_feat")),
        "caption_feats": _np(ck.get("caption_feat")),
        "semantic_id": None if sem is None else int(sem),
        "hidden": int(hidden),
        "clip_size": int(clip_size),
        "max_deg": n_freq - 1,
        "epoch": int(ck.get("epoch", 0)),
    }


def export_torch_checkpoint(
    path: str,
    obj_id: int,
    params: dict,
    obj_scale: float | None = None,
    bbox3d: OrientedBox | None = None,
    clip_feats: np.ndarray | None = None,
    caption_feats: np.ndarray | None = None,
    semantic_id: int | None = None,
    epoch: int = 0,
) -> None:
    """Write a reference-layout .pth the reference's load_checkpoints /
    gen_map_vis consumers accept. The bbox is stored as a SimpleNamespace
    with the reference BoundingBox's attribute names (center/R/extent) —
    its consumers only read attributes, never the class."""
    fc, pe = params_to_reference_state_dicts(params)
    if obj_scale is None:
        obj_scale = float(pe["scale"])
    bbox = None
    if bbox3d is not None:
        bbox = types.SimpleNamespace(
            center=np.asarray(bbox3d.center, np.float64),
            R=np.asarray(bbox3d.r, np.float64),
            extent=np.asarray(bbox3d.extent, np.float64),
        )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(
        {
            "epoch": epoch,
            "FC_state_dict": fc,
            "PE_state_dict": pe,
            "obj_id": obj_id,
            "bbox": bbox,
            "obj_scale": obj_scale,
            "clip_feat": None if clip_feats is None
            else torch.from_numpy(np.asarray(clip_feats, np.float32)),
            "caption_feat": None if caption_feats is None
            else torch.from_numpy(np.asarray(caption_feats, np.float32)),
            "semantic_id": semantic_id,
        },
        path,
    )


def convert_checkpoint_dir(src: str, dst: str, reverse: bool = False):
    """Convert a whole checkpoint directory.

    Forward: reference ``<src>/**/obj_<id>.pth`` -> ``<dst>/<id>/
    obj_<id>.npz`` (the layout viz.export.export_from_checkpoints and the
    eval CLI consume). Reverse: our npz tree -> reference-layout .pth. The
    params pass through the CPU, bit for bit. Returns the list of written
    paths."""
    from openobj_torch.core import checkpoint as ckpt
    from openobj_torch.models import object_field

    written = []
    if not reverse:
        paths = sorted(glob.glob(os.path.join(src, "**", "obj_*.pth"),
                                 recursive=True))
        if not paths:
            raise FileNotFoundError(f"no obj_<id>.pth under {src}")
        for p in paths:
            info = import_torch_checkpoint(p, device="cpu")
            out = os.path.join(
                dst, str(info["obj_id"]), f"obj_{info['obj_id']}.npz"
            )
            ckpt.save_object_checkpoint(
                out, info["obj_id"], info["params"], info["obj_scale"],
                bbox3d=info["bbox"], obj_center=info["obj_center"],
                clip_feats=info["clip_feats"],
                caption_feats=info["caption_feats"],
                semantic_id=info["semantic_id"],
            )
            written.append(out)
        return written

    paths = sorted(glob.glob(os.path.join(src, "**", "obj_*.npz"),
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f"no obj_<id>.npz under {src}")
    templates = {}
    for p in paths:
        with np.load(p) as z:
            hidden = int(z["params/mlp/in_layer/w"].shape[1])
            clip_size = int(z["params/mlp/out_clip/w"].shape[1]) \
                if "params/mlp/out_clip/w" in z else 0
        if (hidden, clip_size) not in templates:
            templates[(hidden, clip_size)] = object_field.init_field_params(
                torch.Generator().manual_seed(0), hidden=hidden,
                clip_size=clip_size, scale=1.0, device="cpu",
            )
        info = ckpt.load_object_checkpoint(p, templates[(hidden, clip_size)])
        out = os.path.join(
            dst, str(info["obj_id"]), f"obj_{info['obj_id']}.pth"
        )
        export_torch_checkpoint(
            out, info["obj_id"], info["params"],
            obj_scale=info["obj_scale"], bbox3d=info["bbox"],
            clip_feats=info["clip_feats"],
            caption_feats=info["caption_feats"],
            semantic_id=info["semantic_id"],
        )
        written.append(out)
    return written


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert reference torch checkpoints (obj_<id>.pth) "
        "<-> openobj npz checkpoints"
    )
    ap.add_argument("src", help="source checkpoint directory")
    ap.add_argument("dst", help="destination directory")
    ap.add_argument("--reverse", action="store_true",
                    help="npz -> .pth instead of .pth -> npz")
    args = ap.parse_args(argv)
    written = convert_checkpoint_dir(args.src, args.dst, reverse=args.reverse)
    for w in written:
        print(w)
    print(f"converted {len(written)} object checkpoints -> {args.dst}")


if __name__ == "__main__":
    main()

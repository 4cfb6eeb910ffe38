"""Perception-stage CLIs — the reference's three pipeline programs.

The reference workflow (README.md:72-118) is three commands before
training: ``mask_gen.py`` (entity masks + captions + CLIP crops ->
mask_init_all.pkl), ``mask_graph.py`` (cross-frame association ->
instance/class PNGs + object_*.pkl), ``sam_clip_dir.py`` (per-pixel
part-level CLIP maps -> partlevel/<i>.npy). This module gives each one a
first-party CLI over the same on-disk contracts:

  openobj-maskgen    maskclustering/mask_gen.py:231-550
  openobj-associate  maskclustering/mask_graph.py:897-1280
  openobj-partfeat   partlevel/sam_clip_dir.py:61-133

All three run weights-free by default (GraphSegmenter entity masks,
ColorNameCaptioner captions, HashingTextEncoder / VisualDescriptorEncoder
features — deterministic first-party stand-ins) and switch to live
transformers models with ``--clip hf`` / ``--sbert hf`` / ``--captioner
hf`` when local weights are mounted. ``openobj-associate`` also reads the
reference's per-scene YAML config schema
(maskclustering/config/room_0.yaml) via ``--config``.

Port of ``openobj_tpu.perception.cli``, with every flag of the JAX CLIs and
one more, ``--device`` (the card unless the caller asks for the CPU): the
association's similarity matrices, the part maps' painting and the
transformers models run there. Frames are read with the port's PNG codec
(``utils.png``) and JPEG decoder (``utils.jpeg``) through
``data.loaders.read_image``, which picks the decoder by the file's first
bytes as OpenCV does. The association YAML is read and written without PyYAML
(``load_assoc_yaml`` here, ``utils.yaml_subset.dump_flat`` in
``perception.auto``), for the subset the reference schema and
``perception.auto`` use. Each stage is
timed under ``utils.profiling`` spans ("maskgen: frame", "associate: association",
"partfeat: frame", "partfeat: part map painting"). Run a stage as
``python -m openobj_torch.perception.cli {maskgen,associate,partfeat}
scene_dir [options]``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from openobj_torch.data.loaders import _read_rgb, read_image
from openobj_torch.data.transforms import resize, scale_depth
from openobj_torch.perception import encoders as enc
from openobj_torch.perception import graph as graph_mod
from openobj_torch.perception import merge, partfeat, pipeline
from openobj_torch.perception.mask_generation import (
    generate_frame_masks, min_rect_bbox, save_mask_init,
)
from openobj_torch.perception.segmentation import GraphSegmenter
from openobj_torch.utils import yaml_subset
from openobj_torch.utils.profiling import performance_measure


def _natsort_key(p):
    import re

    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", p)]


class RawFrames:
    """Posed RGB-D frames straight off disk — the perception stages run
    BEFORE association, so they cannot use data.loaders (which requires
    the association artifacts this pipeline produces). Replica layout:
    rgb/rgb_<i>.png + depth/depth_<i>.png (reference dataset.py:86-87);
    ScanNet: color/*.jpg + depth/*.png natsorted (dataset.py:204-218);
    poses from traj_w_c.txt rows. Colour larger than its depth frame is
    resized to it (the JAX package's RawFrames leaves it, and its stages
    then fail on a real ScanNet scan's 968x1296 colour)."""

    def __init__(self, root: str, fmt: str = "Replica",
                 depth_scale: float = 1e-3, max_depth: float = 10.0):
        self.root = root
        self.fmt = fmt
        self.depth_scale = depth_scale
        self.max_depth = max_depth
        if fmt == "ScanNet":
            self.rgb_paths = sorted(
                glob.glob(os.path.join(root, "color", "*.jpg")),
                key=_natsort_key,
            )
            self.depth_paths = sorted(
                glob.glob(os.path.join(root, "depth", "*.png")),
                key=_natsort_key,
            )
        else:
            n = len(os.listdir(os.path.join(root, "depth")))
            self.rgb_paths = [
                os.path.join(root, "rgb", f"rgb_{i}.png") for i in range(n)
            ]
            self.depth_paths = [
                os.path.join(root, "depth", f"depth_{i}.png") for i in range(n)
            ]
        traj = os.path.join(root, "traj_w_c.txt")
        self.t_wc = (
            np.loadtxt(traj, delimiter=" ").reshape(-1, 4, 4)
            if os.path.exists(traj) else None
        )

    def __len__(self):
        return len(self.rgb_paths)

    def __getitem__(self, i: int):
        rgb = _read_rgb(self.rgb_paths[i])
        depth = scale_depth(
            read_image(self.depth_paths[i]).astype(np.float32),
            self.depth_scale, self.max_depth,
        )
        if rgb.shape[:2] != depth.shape:
            # ScanNet's colour (968x1296) is larger than its depth (480x640):
            # bring it to the depth camera, as data.loaders does, so masks,
            # depth and the config's (depth) intrinsics agree
            rgb = resize(rgb, (depth.shape[1], depth.shape[0]))
        pose = self.t_wc[i] if self.t_wc is not None else np.eye(4)
        return rgb.astype(np.uint8), depth, pose.astype(np.float32)


def _frame_indices(n: int, start: int, skip: int, use_num: int):
    idx = list(range(start, n, skip))
    if use_num > 0:
        idx = idx[:use_num]
    return idx


def _add_encoder_flags(ap: argparse.ArgumentParser):
    ap.add_argument("--clip", choices=("hash", "hf"), default="hash",
                    help="CLIP image features: 'hash' = first-party "
                         "VisualDescriptorEncoder (weights-free), 'hf' = "
                         "transformers CLIP from --clip-model")
    ap.add_argument("--clip-model", default="openai/clip-vit-base-patch32")
    ap.add_argument("--clip-dim", type=int, default=512)
    ap.add_argument("--sbert", choices=("hash", "hf"), default="hash",
                    help="caption features: 'hash' = HashingTextEncoder")
    ap.add_argument("--sbert-model",
                    default="sentence-transformers/all-MiniLM-L6-v2")
    ap.add_argument("--sbert-dim", type=int, default=384)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the stage's device work (default the "
                         "card; 'cpu' runs it on the host)")


def _device(args) -> torch.device:
    """The stage's torch device; raises at once when it does not exist
    (``cuda`` without a card)."""
    torch.empty(0, device=args.device)
    return torch.device(args.device)


def _clip_encoder(args):
    if args.clip == "hf":
        return enc.HFClipEncoder(args.clip_model, device=args.device).encode_images
    return enc.VisualDescriptorEncoder(dim=args.clip_dim).encode_images


def _sbert_encoder(args):
    if args.sbert == "hf":
        return enc.HFSbertEncoder(args.sbert_model, device=args.device).encode_texts
    return enc.HashingTextEncoder(dim=args.sbert_dim).encode_texts


# --------------------------------------------------------------------------- #
# openobj-maskgen (reference mask_gen.py)
# --------------------------------------------------------------------------- #


def maskgen_main(argv=None):
    ap = argparse.ArgumentParser(
        description="Stage 1: per-frame entity masks + captions + crop "
                    "features -> mask_init_all.pkl (reference mask_gen.py)"
    )
    ap.add_argument("scene_dir")
    ap.add_argument("--format", choices=("Replica", "ScanNet"),
                    default="Replica")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--skip", type=int, default=10,
                    help="process every skip-th raw frame (mask_gen.py:252)")
    ap.add_argument("--use-num", type=int, default=-1)
    ap.add_argument("--out", default=None,
                    help="default <scene_dir>/mask_init_all.pkl")
    ap.add_argument("--depth-scale", type=float, default=1e-3)
    ap.add_argument("--max-depth", type=float, default=10.0)
    ap.add_argument("--score-thresh", type=float, default=0.5)
    ap.add_argument("--min-px", type=int, default=100)
    ap.add_argument("--crop-pad", type=int, default=20)
    ap.add_argument("--seg-k", type=float, default=3.0)
    ap.add_argument("--seg-min-size", type=int, default=64)
    ap.add_argument("--seg-stride", type=int, default=2,
                    help="segmentation subsample stride; use 1 for small "
                         "frames so min-size objects survive")
    ap.add_argument("--seg-fx", type=float, default=None,
                    help="camera focal length (px, full resolution): "
                         "enables the head-on depth-continuity RAG merge "
                         "(texture bands painted on one smooth surface "
                         "re-fuse regardless of color)")
    ap.add_argument("--captioner", choices=("color", "hf"), default="color",
                    help="'color' = ColorNameCaptioner (weights-free), "
                         "'hf' = transformers BLIP from --captioner-model")
    ap.add_argument("--captioner-model",
                    default="Salesforce/blip-image-captioning-base")
    _add_encoder_flags(ap)
    args = ap.parse_args(argv)
    _device(args)

    frames = RawFrames(args.scene_dir, args.format,
                       args.depth_scale, args.max_depth)
    segmenter = GraphSegmenter(k=args.seg_k, min_size=args.seg_min_size,
                               stride=args.seg_stride, fx=args.seg_fx)
    captioner = (
        enc.HFCaptioner(args.captioner_model, crop_pad=args.crop_pad,
                        device=args.device)
        if args.captioner == "hf" else enc.ColorNameCaptioner()
    )
    clip_fn, sbert_fn = _clip_encoder(args), _sbert_encoder(args)

    mask_init = {}
    sel = _frame_indices(len(frames), args.start, args.skip, args.use_num)
    for raw_idx in sel:
        with performance_measure("maskgen: frame", verbose=False):
            rgb, depth, _ = frames[raw_idx]
            mask_init[raw_idx] = generate_frame_masks(
                rgb, segmenter, captioner, clip_fn, sbert_fn,
                score_thresh=args.score_thresh, min_px=args.min_px,
                crop_pad=args.crop_pad, depth=depth,
            )
        print(f"[maskgen] frame {raw_idx}: "
              f"{len(mask_init[raw_idx]['mask'])} masks")
    out = args.out or os.path.join(args.scene_dir, "mask_init_all.pkl")
    save_mask_init(out, mask_init)
    print(f"[maskgen] wrote {out} ({len(mask_init)} frames)")
    return 0


# --------------------------------------------------------------------------- #
# openobj-associate (reference mask_graph.py)
# --------------------------------------------------------------------------- #


_YAML_DEFAULTS = {
    "skip": 10, "start": 0, "use_num": -1, "graph_method": "weighted",
    "if_bg": 0, "gt_wall_id": -1, "gt_floor_id": -1, "gt_ceiling_id": -1,
    "captions_wall": ["wall"], "captions_floor": ["floor"],
    "captions_ceiling": ["ceiling"],
    "weight_geo": 0.30, "weight_cap": 0.20, "weight_clip": 0.30,
    "weight_color": 0.20, "weight_geo_2d": 0.60,
    "threshold_geo": 0.5, "threshold_cap": 0.3, "threshold_clip": 0.3,
    "threshold_color": 0.5,
    "cap_thre": 0.85, "weight_pc": 0.6, "dis_thre": 0.05,
    "weightcaption": 0.3, "weightcolor": 0.6,
    "depth_scale": 1000.0, "fx": 600.0, "fy": 600.0,
    "cx": 599.5, "cy": 339.5,
}


def load_assoc_yaml(path: str | None) -> dict:
    """Reference per-scene YAML schema
    (maskclustering/config/room_0.yaml) -> flat dict with
    defaults filled in. Unknown keys pass through."""
    cfg = dict(_YAML_DEFAULTS)
    if path:
        with open(path) as f:
            cfg.update(yaml_subset.parse_flat(f.read()))
    return cfg


def _assoc_config_from_yaml(y: dict) -> pipeline.AssociationConfig:
    if y["graph_method"] == "threshold":
        weights = {
            "geo": y["threshold_geo"], "cap": y["threshold_cap"],
            "clip": y["threshold_clip"], "color": y["threshold_color"],
            "geo2d": 0.0,
        }
    else:
        weights = {
            "geo": y["weight_geo"], "cap": y["weight_cap"],
            "clip": y["weight_clip"], "color": y["weight_color"],
            "geo2d": y["weight_geo_2d"],
        }
    gt_bg = {}
    if y.get("if_bg"):
        for name in ("wall", "floor", "ceiling"):
            gid = int(y.get(f"gt_{name}_id", -1))
            if gid >= 0:
                gt_bg[name] = gid
    return pipeline.AssociationConfig(
        fx=float(y["fx"]), fy=float(y["fy"]),
        cx=float(y["cx"]), cy=float(y["cy"]),
        weights=weights, graph_method=y["graph_method"],
        use_geo2d=weights.get("geo2d", 0) > 0,
        cap_thre=float(y["cap_thre"]), dis_thre=float(y["dis_thre"]),
        weight_pc=float(y["weight_pc"]),
        weight_caption=float(y["weightcaption"]),
        weight_color=float(y["weightcolor"]),
        contact_pc=float(y.get("contact_pc", 0.0)),
        contact_cap=float(y.get("contact_cap", 0.9)),
        gt_bg_ids=gt_bg,
    )


def associate_main(argv=None):
    ap = argparse.ArgumentParser(
        description="Stage 2: cross-frame mask association -> "
                    "instance_our/class_our PNGs + object_*.pkl "
                    "(reference mask_graph.py)"
    )
    ap.add_argument("scene_dir")
    ap.add_argument("--config", default=None,
                    help="per-scene YAML in the reference schema "
                         "(maskclustering/config/*.yaml)")
    ap.add_argument("--format", choices=("Replica", "ScanNet"),
                    default="Replica")
    ap.add_argument("--mask-init", default=None,
                    help="default <scene_dir>/mask_init_all.pkl")
    ap.add_argument("--out", default=None, help="default <scene_dir>")
    ap.add_argument("--gt-semantic-glob", default=None,
                    help="GT semantic PNGs for bg anchoring "
                         "(mask_graph.py:957-961), e.g. "
                         "'<scene>/semantic_class/semantic_class_*.png'")
    ap.add_argument("--max-depth", type=float, default=10.0)
    ap.add_argument("--min-component-px", type=int, default=100)
    ap.add_argument("--dbscan-min-points", type=int, default=100)
    ap.add_argument("--dbscan-eps", type=float, default=0.05)
    ap.add_argument("--fixed-eps", action="store_true",
                    help="disable the adaptive per-component DBSCAN radius "
                         "(reference fixed-eps denoise parity, "
                         "mask_graph.py:244-316)")
    ap.add_argument("--geo-bg", action="store_true",
                    help="geometric bg anchoring: large thin planes -> "
                         "reserved wall/floor/ceiling ids (weights-free "
                         "stand-in for TAP caption anchoring)")
    ap.add_argument("--geo-bg-up-axis", type=int, default=2)
    ap.add_argument("--geo-bg-min-extent", type=float, default=2.0)
    ap.add_argument("--debug-overlays", default=None, metavar="DIR",
                    help="write color-coded association overlays to "
                         "DIR/before (pre-merge clusters) and DIR/after "
                         "(final ids) — the reference's cross-view QA "
                         "PNGs (mask_graph.py:1204-1238)")
    _add_encoder_flags(ap)
    args = ap.parse_args(argv)
    device = _device(args)

    y = load_assoc_yaml(args.config)
    acfg = _assoc_config_from_yaml(y)
    acfg.max_depth = args.max_depth
    acfg.min_component_px = args.min_component_px
    acfg.dbscan_min_points = args.dbscan_min_points
    acfg.dbscan_eps = args.dbscan_eps
    acfg.adaptive_eps = not args.fixed_eps
    acfg.geo_bg = bool(args.geo_bg or y.get("if_bg_geo"))
    acfg.geo_bg_up_axis = args.geo_bg_up_axis
    acfg.geo_bg_min_extent = args.geo_bg_min_extent

    mask_init = enc.load_mask_init(
        args.mask_init or os.path.join(args.scene_dir, "mask_init_all.pkl")
    )
    raw = RawFrames(args.scene_dir, args.format,
                    1.0 / float(y["depth_scale"]), args.max_depth)
    sel = _frame_indices(
        len(raw), int(y["start"]), int(y["skip"]), int(y["use_num"])
    )
    gt_paths = None
    if args.gt_semantic_glob:
        gt_paths = sorted(glob.glob(args.gt_semantic_glob), key=_natsort_key)
        if len(gt_paths) == len(raw):
            # one GT image per raw frame: subsample like the reference
            # (mask_graph.py:959-961 natsorted glob then [::skip])
            gt_paths = [gt_paths[i] for i in sel]
        elif len(gt_paths) != len(sel):
            # anything else is ambiguous: positional pairing with a stray
            # extra/missing file would silently anchor every cluster with
            # the WRONG GT image
            raise ValueError(
                f"--gt-semantic-glob matched {len(gt_paths)} files — "
                f"expected one per raw frame ({len(raw)}) or one per "
                f"association frame ({len(sel)})"
            )

    # first-party pickles key frames by RAW index (load_mask_init) — the
    # pairing below is then correct by construction for ANY start/skip;
    # reference pickles carry no frame record, so dense ordinal keys pair
    # positionally (the reference's own behavior) and only a count
    # mismatch is detectable
    by_raw_index = set(mask_init) != set(range(len(mask_init)))
    frames = []
    for ordinal, raw_idx in enumerate(sel):
        key = raw_idx if (by_raw_index or raw_idx in mask_init) else ordinal
        if key not in mask_init:
            raise KeyError(
                f"mask_init_all.pkl has no masks for raw frame {raw_idx} "
                f"(ordinal {ordinal}) — was maskgen run with the same "
                "--start/--skip?"
            )
        rgb, depth, t_wc = raw[raw_idx]
        fm = mask_init[key]
        gt_sem = None
        if gt_paths is not None:
            gt_sem = read_image(gt_paths[ordinal]).astype(np.int32)
        frames.append(pipeline.FrameInput(
            masks=[np.asarray(m, bool) for m in fm["mask"]],
            captions=list(fm["caption"]),
            capfeats=list(fm["capfeat"]),
            clipfeats=list(fm["clipfeat"]),
            depth=depth, rgb=rgb, t_wc=t_wc, gt_semantic=gt_sem,
        ))

    # canonical bg caption features, encoded with the same text encoder
    # that produced the mask capfeats (mask_graph.py:1106-1187)
    sbert_fn = _sbert_encoder(args)
    bg_feats = {
        name: np.asarray(sbert_fn(list(y[f"captions_{name}"])))
        for name in ("wall", "floor", "ceiling")
    }

    with performance_measure("associate: association", verbose=False, block=True):
        out = pipeline.associate(frames, bg_feats=bg_feats, cfg=acfg, device=device)
        out_dir = args.out or args.scene_dir
        merge.write_artifacts(
            out_dir,
            out["masks"], out["final_ids"],
            out["clipfeats"], out["capfeats"], out["captions"],
            image_hw=frames[0].depth.shape,
            inst_images=out["inst_images"],   # reprojection-healed maps
        )
    if args.debug_overlays:
        hw = frames[0].depth.shape
        merge.write_cluster_overlays(
            os.path.join(args.debug_overlays, "before"),
            out["masks"], out["cluster_ids"], hw, skip_id=graph_mod.JUNK_ID,
        )
        merge.write_cluster_overlays(
            os.path.join(args.debug_overlays, "after"),
            out["masks"], out["final_ids"], hw, skip_id=0,
        )
    print(f"[associate] {out['n_objects']} global objects over "
          f"{len(frames)} frames -> {out_dir}")
    return 0


# --------------------------------------------------------------------------- #
# openobj-partfeat (reference sam_clip_dir.py)
# --------------------------------------------------------------------------- #


def partfeat_main(argv=None):
    ap = argparse.ArgumentParser(
        description="Part-level per-pixel feature maps -> partlevel/<i>.npy "
                    "(reference sam_clip_dir.py: SAM auto-masks + CLIP "
                    "crops; weights-free default = GraphSegmenter + "
                    "VisualDescriptorEncoder)"
    )
    ap.add_argument("scene_dir")
    ap.add_argument("--format", choices=("Replica", "ScanNet"),
                    default="Replica")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--skip", type=int, default=10)
    ap.add_argument("--use-num", type=int, default=-1)
    ap.add_argument("--out-dir", default=None,
                    help="default <scene_dir>/partlevel")
    ap.add_argument("--down", type=int, default=5,
                    help="map downsample factor (sam_clip_dir.py:113)")
    ap.add_argument("--bbox-scale", type=float, default=1.3,
                    help="crop bbox enlargement (sam_clip_dir.py:42-59)")
    ap.add_argument("--depth-scale", type=float, default=1e-3)
    ap.add_argument("--max-depth", type=float, default=10.0)
    ap.add_argument("--seg-k", type=float, default=1.0,
                    help="finer than maskgen's default: part-level masks "
                         "are SAM's over-segmentation, not entities")
    ap.add_argument("--seg-min-size", type=int, default=32)
    ap.add_argument("--seg-stride", type=int, default=2)
    _add_encoder_flags(ap)
    args = ap.parse_args(argv)
    device = _device(args)

    frames = RawFrames(args.scene_dir, args.format,
                       args.depth_scale, args.max_depth)
    segmenter = GraphSegmenter(k=args.seg_k, min_size=args.seg_min_size,
                               stride=args.seg_stride)
    clip_fn = _clip_encoder(args)
    out_dir = args.out_dir or os.path.join(args.scene_dir, "partlevel")
    os.makedirs(out_dir, exist_ok=True)

    for raw_idx in _frame_indices(
        len(frames), args.start, args.skip, args.use_num
    ):
        with performance_measure("partfeat: frame", verbose=False, block=True):
            rgb, depth, _ = frames[raw_idx]
            masks, feats, scores = part_map_inputs(rgb, depth, segmenter, clip_fn,
                                                   args.bbox_scale)
            with performance_measure("partfeat: part map painting", verbose=False,
                                     block=True):
                pf = partfeat.build_part_feature_map(
                    masks, feats, stability_scores=scores, down=args.down, device=device)
            path = os.path.join(out_dir, f"{raw_idx}.npy")
            partfeat.save_part_features(path, pf)
        print(f"[partfeat] frame {raw_idx}: {len(masks)} masks -> {path}")
    return 0


def part_map_inputs(rgb, depth, segmenter, clip_fn, bbox_scale: float = 1.3):
    """One frame's part masks, their crops' features and their scores, as
    ``partfeat_main`` paints them: (masks, features, stability scores)."""
    h, w = depth.shape
    masks, scores = segmenter(rgb, depth)
    masks = [np.asarray(m, bool) for m in masks]
    crops = []
    for m in masks:
        r0, r1, c0, c1 = min_rect_bbox(m)
        er0, ec0, er1, ec1 = partfeat.enlarge_bbox_xyxy((r0, c0, r1, c1), bbox_scale, h, w)
        crops.append(enc.crop_with_padding(rgb, (er0, er1, ec0, ec1), pad=0))
    return masks, list(clip_fn(crops)), list(map(float, scores))


STAGES = {"maskgen": maskgen_main, "associate": associate_main, "partfeat": partfeat_main}

if __name__ == "__main__":
    import sys

    if len(sys.argv) < 2 or sys.argv[1] not in STAGES:
        sys.exit(f"usage: python -m openobj_torch.perception.cli {{{','.join(STAGES)}}} "
                 "scene_dir [options]")
    sys.exit(STAGES[sys.argv[1]](sys.argv[2:]))

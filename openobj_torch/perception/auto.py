"""Weights-free perception over a raw RGB-D scene directory, in one call.

Runs the three perception-stage CLIs (openobj-maskgen -> openobj-associate
--geo-bg -> openobj-partfeat) — the reference's pre-training programs
(mask_gen.py / mask_graph.py / sam_clip_dir.py) — with every
pixel-count-sensitive knob scaled from the scene's camera config, so the
same entry point works from 64x48 fixtures to full-resolution scans.
Extracted from scripts/run_scenes.py so programmatic callers (the
perception stress matrix, notebooks) share the exact CLI-path behavior.

Port of ``openobj_tpu.perception.auto``: the stages' device work runs on
``device`` (the card unless the caller asks for the CPU), and the
association YAML is written without PyYAML (``utils.yaml_subset.dump_flat``).
"""

from __future__ import annotations

import os


def keyframe_skip(n_frames: int, train_stride: int = 10) -> int:
    """Association keyframe stride, scaled to the sequence length. The
    reference uses a fixed skip=10 on 2000-frame scenes — 200 keyframes a
    degree or two of camera motion apart, so consecutive views of an object
    overlap heavily and Louvain chains them transitively
    (mask_graph.py:464-735 computes all-pairs similarity, but partial-view
    AABBs from opposite sides share only a thin slab: smaller-volume IoU
    ~0.2, below any edge the weighted rule admits). A fixed 10 on a
    40-frame fixture leaves 4 keyframes ~90 degrees apart — the same
    object re-enters as a new cluster. Target >= 10 keyframes, capped at
    the reference's stride.

    The result must DIVIDE ``train_stride``: the trainer loads raw frames
    0, T, 2T, ... and maps each to artifact index frame//skip and to
    partlevel/<frame>.npy (loaders.py) — a skip that does not divide T
    hands trained frames a NEIGHBORING keyframe's instance map and leaves
    partlevel holes. So the skip is the largest divisor of train_stride
    within the length-scaled target (for T=10: 1, 2, 5, or 10)."""
    target = max(1, min(train_stride, n_frames // 10))
    for s in range(target, 0, -1):
        if train_stride % s == 0:
            return s
    return 1


def count_raw_frames(root: str) -> int:
    """Number of rgb frames in a raw scene directory."""
    rgb = os.path.join(root, "rgb")
    if not os.path.isdir(rgb):
        return 0
    return sum(1 for f in os.listdir(rgb) if f.endswith(".png"))


def scaled_knobs(cam, max_depth: float) -> dict:
    """Pixel-count-scaled perception knobs. The reference's fixed values
    (min 100 px masks, DBSCAN min 100 points, 20 px CLIP crop padding,
    subsample stride 2) assume 680x1200 frames (mask_gen.py:320-322,
    mask_graph.py:244-316); scale them to the actual frame size."""
    npx = cam.height * cam.width
    return dict(
        min_px=max(20, npx // 8000),
        # floor 16 (not the CLI's 32/64): a fixture-scale object can be
        # ~24 px; spurious fragments that low floors admit are re-fused by
        # the segmenter's per-cue RAG merge pass (_rag_merge)
        seg_min=max(16, npx // 12000),
        # subsample stride 2 is for full-res frames; at fixture scale a
        # min-size object (~100 px) would shrink below seg_min
        seg_stride=2 if min(cam.height, cam.width) >= 200 else 1,
        # the reference's 20 px crop pad assumes 1200-wide frames; fixed 20
        # at 64x48 makes every crop ~ the whole frame and saturates the
        # clip similarity cue
        crop_pad=max(2, min(20, int(round(20 * cam.width / 1200.0)))),
        # DBSCAN eps tracks the pixel footprint at mid-range depth (~2z/fx)
        eps=max(0.05, max_depth / float(cam.fx)),
        dbscan_min=max(10, npx // 8000),
    )


def run_auto_perception(cfg, device="cuda") -> None:
    """Generate every training artifact (mask_init_all.pkl, instance_our/,
    class_our/, object_*.pkl, partlevel/) from raw rgb/depth/traj under
    ``cfg.dataset_dir`` with the weights-free stages. ``cfg`` is a
    SceneConfig; intrinsics/stride/depth-scale come from it so the stages
    and the trainer agree. The stages' device work runs on ``device``."""
    from openobj_torch.perception import cli as pcli
    from openobj_torch.utils import yaml_subset

    root, cam = cfg.dataset_dir, cfg.camera
    k = scaled_knobs(cam, cfg.max_depth)
    skip = keyframe_skip(count_raw_frames(root), train_stride=cfg.stride)
    common = [root, "--format", cfg.dataset_format,
              "--depth-scale", str(cfg.depth_scale),
              "--max-depth", str(cfg.max_depth), "--device", str(device)]
    pcli.maskgen_main(common + [
        "--skip", str(skip), "--min-px", str(k["min_px"]),
        "--seg-min-size", str(k["seg_min"]),
        "--seg-stride", str(k["seg_stride"]),
        "--crop-pad", str(k["crop_pad"]),
        # intrinsics unlock the texture-band (head-on depth-continuity)
        # merge — entity masks want whole striped/patterned objects.
        # NOT passed to partfeat below: parts ARE color regions there
        "--seg-fx", str(cam.fx),
    ])
    ycfg = dict(
        skip=skip, graph_method="weighted",
        depth_scale=1.0 / cfg.depth_scale,
        fx=float(cam.fx), fy=float(cam.fy),
        cx=float(cam.cx), cy=float(cam.cy),
        # second-stage point-cloud overlap threshold, relaxed from the
        # reference's 0.6: when Louvain splits one object temporally, the
        # early-view and late-view clouds of the SAME object can overlap
        # only ~0.5 (opposite faces), while clouds of DISTINCT objects in
        # exact contact overlap ~0.03 (measured both ways) and the color/
        # caption gates still apply — 0.4 heals splits with ~10x margin
        weight_pc=0.4,
        # part-of contact tier: same-caption clusters in contact whose
        # footprint nests merge (table legs <-> top measured overlap
        # 0.024, caption cos 1.0; objects resting ON the table are
        # blocked at caption cos 0.667 — merge.second_stage_mapping)
        contact_pc=0.02,
    )
    ypath = os.path.join(root, "assoc_generated.yaml")
    with open(ypath, "w") as f:
        f.write(yaml_subset.dump_flat(ycfg))
    pcli.associate_main([
        root, "--config", ypath, "--format", cfg.dataset_format,
        "--max-depth", str(cfg.max_depth), "--device", str(device),
        "--min-component-px", str(k["min_px"]),
        "--dbscan-min-points", str(k["dbscan_min"]),
        "--dbscan-eps", str(k["eps"]),
        # weights-free captions carry no wall/floor semantics; anchor the
        # background geometrically (boundary-shell clusters -> ids 1/2/3)
        "--geo-bg",
    ])
    if cfg.train.part_mode:
        pcli.partfeat_main(common + [
            "--skip", str(skip), "--down", str(cfg.train.part_down),
            "--clip-dim", str(cfg.train.clip_size),
            "--seg-min-size", str(max(8, k["seg_min"] // 2)),
            "--seg-stride", str(k["seg_stride"]),
        ])

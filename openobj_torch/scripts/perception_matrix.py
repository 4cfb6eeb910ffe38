#!/usr/bin/env python
"""Weights-free perception stress matrix over the synthetic archetypes, on
the port.

For each archetype (data.synthetic.ARCHETYPES: easy control, textured,
touching, non-convex, tabletop, grazing walls, clones, occlusion): write a
RAW rgb/depth/traj scene (ground-truth instance maps held aside where the
stages cannot see them), run the full weights-free perception stack
(perception.auto.run_auto_perception: segmenter -> captioner/encoders ->
projection -> similarity graph on ``--device`` -> Louvain -> geo-bg anchoring
-> merge), and score the written instance_our maps against the ground truth
with optimally matched instance mIoU and background IoU.

    python -m openobj_torch.scripts.perception_matrix [--size 96 72] [--frames 40]
        [--device cuda] [--out matrix.json] [--only name...] [--noise 0.0]

The port of scripts/perception_matrix.py without its ``--full`` stage
(training and rendering each archetype through scripts/run_scenes.py).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def run_archetype(name, h, w, n_frames, keep=None, noise=0.0, device="cuda"):
    from openobj_torch.config import SceneConfig
    from openobj_torch.core.scene import Camera
    from openobj_torch.core.trainer import TrainConfig
    from openobj_torch.data import synthetic
    from openobj_torch.eval import matched_instance_miou
    from openobj_torch.perception.auto import keyframe_skip, run_auto_perception
    from openobj_torch.utils.png import read_png

    fx = fy = 0.65 * w
    cam = Camera(width=w, height=h, fx=fx, fy=fy, cx=w / 2.0, cy=h / 2.0)
    scene, orbit = synthetic.archetype_scene(name)

    root = keep or tempfile.mkdtemp(prefix=f"percmat_{name}_")
    os.makedirs(root, exist_ok=True)
    try:
        gt_maps = synthetic.write_raw_scene(
            root, scene, cam.ray_dirs("cpu").numpy(), n_frames=n_frames, orbit_kwargs=orbit,
            assoc_stride=keyframe_skip(n_frames), noise_level=noise,
        )
        cfg = SceneConfig(train=TrainConfig(part_mode=False), camera=cam,
                          dataset_format="Replica", dataset_dir=root)
        t0 = time.perf_counter()
        run_auto_perception(cfg, device=device)
        seconds = time.perf_counter() - t0
        pred_maps = [
            read_png(os.path.join(root, "instance_our", f"semantic_instance_{i}.png")).astype(
                np.int32)
            for i in range(len(gt_maps))]
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)
    score = matched_instance_miou(pred_maps, gt_maps)
    score["root"] = root
    score["n_gt_instances"] = len(score["per_gt_iou"])
    score["perception_s"] = seconds
    return score


def main(argv=None):
    from openobj_torch.data.synthetic import ARCHETYPES

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", nargs=2, type=int, default=(96, 72), metavar=("W", "H"))
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the stages' device work ('cpu' for the host)")
    ap.add_argument("--out", default=None, help="write JSON here")
    ap.add_argument("--keep", default=None, help="keep scene dirs under this root (debugging)")
    ap.add_argument("--only", nargs="*", default=None, help="subset of archetypes")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="sensor-noise level (synthetic.apply_sensor_noise; 1.0 ~ a real "
                         "Kinect, the ground truth stays clean)")
    args = ap.parse_args(argv)
    w, h = args.size

    rows = {}
    for name in args.only or list(ARCHETYPES):
        keep = os.path.join(args.keep, name) if args.keep else None
        try:
            s = run_archetype(name, h, w, args.frames, keep=keep, noise=args.noise,
                              device=args.device)
        except Exception as e:  # noqa: BLE001 — the matrix keeps going
            rows[name] = {"error": f"{type(e).__name__}: {e}"}
            print(f"{name:10s}  ERROR {rows[name]['error']}", flush=True)
            continue
        rows[name] = s
        print(f"{name:10s}  inst_mIoU {s['inst_miou']:.3f}   bg_IoU {s['bg_iou']:.3f}   "
              f"gt {s['n_gt_instances']} / pred {s['n_pred_instances']} inst  "
              f"per-gt { {k: round(v, 2) for k, v in s['per_gt_iou'].items()} }  "
              f"{s['perception_s']:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2, default=str)
    ok = [r for r in rows.values() if "inst_miou" in r]
    if ok:
        mean = float(np.mean([r["inst_miou"] for r in ok]))
        print(f"\nmatrix mean inst_mIoU over {len(ok)} archetypes: {mean:.3f}")
    return rows


if __name__ == "__main__":
    main()

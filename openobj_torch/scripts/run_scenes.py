"""Multi-scene pipeline runner: train -> checkpoints -> map bundle (-> eval)
for every scene config in a directory.

    python -m openobj_torch.scripts.run_scenes configs/replica \
        --data-root /data/replica --out runs/ [--class-features cf.npz] \
        [--max-frames N] [--parallel N] [--scene-shard i:n] [--device cpu]

Port of ``scripts/run_scenes.py``, with every flag of the JAX script and
``--device`` (default the card), which is passed on to the perception
stages (``perception.auto``), the train CLI (``openobj_torch.train``) and
the checkpoint -> bundle export (``viz.export``); the eval
(``openobj_torch.eval``, with ``--eval``) is host numpy and takes no
device. Writes runs/<scene>/summary.json per scene and a combined
runs/summary.json.

Scale-out (``parallel.multislice``, ``parallel.distributed``):
  --parallel N      split the visible cards into N groups and train N scenes
                    at once, each on its group's first card (with --device
                    cpu, N threads on the host); more scenes queue up.
                    ``--parallel 1`` runs serially, as the JAX script does.
  --scene-shard i:n this invocation takes every n-th scene from i.
  --distributed HOST:PORT with --num-processes and --process-id: join a
                    torch.distributed group (NCCL on the card, gloo with
                    --device cpu); the scene shard defaults to rank:world.

As in the JAX script, ``perception.auto.count_raw_frames`` counts rgb/*.png,
so on a ScanNet layout the perception keyframe skip comes out 1.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch


def run_perception(cfg_path: str, args) -> None:
    """Generate the training artifacts from raw posed RGB-D with the
    weights-free perception stages (``perception.auto``)."""
    from openobj_torch.config import load_scene_config
    from openobj_torch.perception.auto import run_auto_perception

    run_auto_perception(load_scene_config(cfg_path), device=args.device)


def run_one_scene(cfg_path: str, scene: str, args) -> dict:
    from openobj_torch import train as train_cli
    from openobj_torch.viz import export as viz_export

    logdir = os.path.join(args.out, scene)
    os.makedirs(logdir, exist_ok=True)
    if args.data_root:
        with open(cfg_path) as f:
            cfg = json.load(f)
        cfg["dataset"]["path"] = os.path.join(args.data_root, scene)
        cfg_path = os.path.join(logdir, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f, indent=2)
    print(f"=== {scene} ===")
    with open(cfg_path) as f:
        jcfg = json.load(f)
    root = jcfg["dataset"]["path"]
    if args.perception != "off":
        required = [os.path.join(root, "object_clipfeat.pkl"),
                    os.path.join(root, "object_capfeat.pkl"),
                    os.path.join(root, "instance_our")]
        if jcfg.get("trainer", {}).get("part_mode", 0):
            required.append(os.path.join(root, "partlevel"))
        have = all(os.path.exists(p) for p in required)
        if args.perception == "always" or not have:
            print(f"[{scene}] running perception stages "
                  f"({'forced' if have else 'artifacts missing'})")
            try:
                run_perception(cfg_path, args)
            except Exception as e:  # noqa: BLE001 — isolate per scene
                print(f"[{scene}] perception FAILED: {type(e).__name__}: {e}")
                return {"status": "perception_failed", "error": str(e)}
    cli = ["--config", cfg_path, "--logdir", logdir, "--device", str(args.device)]
    if args.class_features:
        cli += ["--class-features", args.class_features]
    if args.max_frames:
        cli += ["--max-frames", str(args.max_frames)]
    try:
        train_cli.main(cli)
        entry = {"status": "ok"}
        if not args.skip_export:
            out = viz_export.export_from_checkpoints(
                os.path.join(logdir, "ckpt"), os.path.join(logdir, "map_vis.pkl.gz"),
                device=args.device)
            entry["objects"] = len(out)
        timing = os.path.join(logdir, "timing.json")
        if os.path.exists(timing):
            with open(timing) as f:
                entry["timing"] = json.load(f)
        render_dir = os.path.join(logdir, "render")
        if args.eval and os.path.isdir(render_dir):
            from openobj_torch.data.loaders import infer_assoc_stride
            from openobj_torch.eval import evaluate_run
            from openobj_torch.perception.auto import count_raw_frames

            # semantic GT: a real class-id GT dir if the dataset ships one
            # (class_our carries global instance ids); otherwise
            # evaluate_run derives class GT from instance_our and the run's
            # render/mapping_class.json
            gt_sem = os.path.join(root, "semantic_class")
            gt_inst = os.path.join(root, "instance_our")
            sem_stride = infer_assoc_stride(
                gt_inst, count_raw_frames(root),
                train_stride=jcfg.get("trainer", {}).get("stride", 1))
            entry["eval"] = {
                k: (round(float(v), 4) if np.isscalar(v) else v)
                for k, v in evaluate_run(
                    render_dir, os.path.join(root, "rgb"), os.path.join(root, "depth"),
                    gt_sem if os.path.isdir(gt_sem) else None, args.n_classes,
                    sem_stride=sem_stride,
                    gt_inst_dir=gt_inst if os.path.isdir(gt_inst) else None,
                ).items()
            }
            print(f"{scene} eval: {entry['eval']}")
    except Exception as e:  # noqa: BLE001 — keep going across scenes
        entry = {"status": f"failed: {e}"}
        print(f"{scene} FAILED: {e}")
    with open(os.path.join(logdir, "summary.json"), "w") as f:
        json.dump(entry, f, indent=2)
    return entry


def main(argv=None) -> dict:
    """The command line; returns the combined summary."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config_dir")
    ap.add_argument("--out", default="runs")
    ap.add_argument("--data-root", default=None,
                    help="override dataset.path root: <data-root>/<scene>")
    ap.add_argument("--class-features", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--skip-export", action="store_true")
    ap.add_argument("--perception", choices=("off", "auto", "always"), default="off",
                    help="run the perception stages (maskgen/associate/partfeat, "
                         "weights-free defaults) before training: 'auto' = only when "
                         "the association artifacts are missing from the scene dir")
    ap.add_argument("--eval", action="store_true",
                    help="score renders vs the dataset's rgb/depth/class_our/"
                         "instance_our GT (PSNR, depth L1, zero-shot mIoU, instance IoU)")
    ap.add_argument("--n-classes", type=int, default=102)
    ap.add_argument("--parallel", type=int, default=None,
                    help="train N scenes concurrently on N device groups")
    ap.add_argument("--scene-shard", default=None,
                    help='"i:n": this process takes every n-th scene from i')
    ap.add_argument("--distributed", default=None, metavar="HOST:PORT",
                    help="coordinator address: join a torch.distributed group "
                         "(scene shard defaults to this process's rank:world)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the perception, training and export "
                         "(default cuda: the card; cpu runs them on the host)")
    args = ap.parse_args(argv)

    if args.distributed:
        from openobj_torch.parallel import distributed

        distributed.initialize(args.distributed, args.num_processes, args.process_id,
                               device=args.device)
        if args.scene_shard is None:
            args.scene_shard = distributed.process_scene_shard()

    configs = sorted(glob.glob(os.path.join(args.config_dir, "*.json")))
    if not configs:
        raise FileNotFoundError(f"no configs in {args.config_dir}")
    if args.scene_shard:
        from openobj_torch.parallel.multislice import shard_scene_list

        configs = shard_scene_list(configs, args.scene_shard)
        print(f"scene shard {args.scene_shard}: {[os.path.basename(c) for c in configs]}")

    scenes = [os.path.splitext(os.path.basename(c))[0] for c in configs]
    summary = {}
    if args.parallel and args.parallel > 1:
        from openobj_torch.parallel.multislice import device_groups, run_parallel

        on_card = torch.device(args.device).type == "cuda"
        groups = device_groups(args.parallel, None if on_card
                               else [torch.device(args.device)] * args.parallel)

        def task(cfg_path, scene):
            def run(devs):
                scene_args = argparse.Namespace(**vars(args))
                if on_card:
                    scene_args.device = str(devs[0])
                return run_one_scene(cfg_path, scene, scene_args)
            return run

        print(f"{len(groups)} device groups: {[[str(d) for d in g] for g in groups]}")
        tasks = [(scene, task(c, scene)) for c, scene in zip(configs, scenes)]
        for r in run_parallel(tasks, groups=groups):
            summary[r.name] = r.result if r.ok else {"status": f"failed: {r.error}"}
    else:
        for cfg_path, scene in zip(configs, scenes):
            summary[scene] = run_one_scene(cfg_path, scene, args)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v.get("status") for k, v in summary.items()}))
    return summary


if __name__ == "__main__":
    main()

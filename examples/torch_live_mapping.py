"""LIVE mapping with openobj_torch (the port of examples/live_mapping.py): a
raw posed RGB-D stream becomes an object map frame by frame, with no
association artifacts and no model weights:

  GraphSegmenter (weights-free entity masks)
    -> OnlineInstanceTracker.propose_ids (masks matched to tracked 3D boxes,
       fresh ids for new objects, a geometric background test -> id 0)
    -> OnlineInstanceTracker.ingest (a temporally consistent instance image)
    -> SceneMapper.process_frame (the frame's sampling and training steps)

then one held-out view rendered through ``render_object_view`` per object,
composited by depth, and its PSNR on object pixels.

Run:  python examples/torch_live_mapping.py [--device cuda|cpu]
          [--frames 10] [--iters 40]
At the published run (10 frames, 40 iterations) the example's gates apply:
PSNR > 15 dB, then "LIVE MAPPING OK". A cut run (fewer frames or
iterations) prints the same numbers and checks only that the losses are
finite.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openobj_torch.core import renderer  # noqa: E402
from openobj_torch.core.scene import Camera, SceneMapper  # noqa: E402
from openobj_torch.core.trainer import TrainConfig  # noqa: E402
from openobj_torch.data import synthetic  # noqa: E402
from openobj_torch.perception.segmentation import GraphSegmenter  # noqa: E402
from openobj_torch.perception.tracking import OnlineInstanceTracker  # noqa: E402
from openobj_torch.utils.geometry import object_bound_from_keyframes  # noqa: E402

W, H, FX, FY = 64, 48, 40.0, 40.0
CX, CY = (W - 1) / 2, (H - 1) / 2
N_FRAMES, N_ITERS = 10, 40


def camera() -> Camera:
    return Camera(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY)


def stream(n_frames: int = N_FRAMES):
    """The orbit's frames: (t_wc, rgb, depth); the scene's own instance
    image is not used."""
    scene = synthetic.default_scene(n_spheres=2)
    dirs = camera().ray_dirs("cpu").numpy()
    for i in range(n_frames):
        t_wc = synthetic.orbit_pose(np.pi / 2 - 0.5 + 1.0 * i / N_FRAMES)
        rgb, depth, _ = scene.render(t_wc, dirs)
        yield t_wc, rgb, depth


def front_end(segmenter_cls=GraphSegmenter, tracker_cls=OnlineInstanceTracker):
    """The example's segmenter and tracker (classes of either package)."""
    return (segmenter_cls(min_size=48, stride=1),
            tracker_cls(fx=FX, fy=FY, cx=CX, cy=CY, min_pixels=40, min_points=10,
                        erode_size=3, erode_iters=1))


def bg_test(pts) -> bool:
    """Live geometric background test: a large spread is a room surface
    (the offline path's hull test needs the accumulated scene; extent
    alone is enough for a stream)."""
    return float((pts.max(0) - pts.min(0)).max()) > 2.0


def segment_and_track(segmenter, tracker, rgb, depth, t_wc):
    """One frame through the front end: (masks, proposed ids, instance image)."""
    masks, _scores = segmenter(rgb, depth)
    masks = [np.asarray(m, bool) for m in masks]
    ids = tracker.propose_ids(masks, depth, t_wc, bg_test=bg_test)
    inst = tracker.ingest(masks, ids, depth, t_wc)
    return masks, ids, inst


def held_out_psnr(mapper: SceneMapper, device) -> tuple[float, int]:
    """Every trained object rendered at a held-out pose, composited by
    depth; PSNR on the pixels any object covers."""
    t_eval = synthetic.orbit_pose(np.pi / 2)
    rgb_gt, _, _ = synthetic.default_scene(n_spheres=2).render(
        t_eval, camera().ray_dirs("cpu").numpy())
    gen = torch.Generator(device=device).manual_seed(0)
    hit_any = np.zeros((H, W), bool)
    rgb_pred = np.zeros((H, W, 3), np.float32)
    zbuf = np.full((H, W), 1e9, np.float32)
    reg, store = mapper.registry, mapper.store
    n_obj = 0
    for slot, st in reg.slots.items():
        if st.is_bg:
            continue
        n_obj += 1
        if st.bbox3d is None:   # derived lazily, as train.py's export does
            kfs = torch.as_tensor(reg.kf_frames[slot][: st.n_kf], device=store.depth.device)
            st.bbox3d = object_bound_from_keyframes(
                store.depth[kfs].cpu().numpy(),
                (store.inst[kfs] == st.inst_id).cpu().numpy(),
                store.t_wc[kfs].cpu().numpy(), FX, FY, CX, CY)
        if st.bbox3d is None:
            continue
        v = renderer.render_object_view(mapper.slot_params(slot), st.bbox3d, st.obj_center,
                                        t_eval.astype(np.float32), mapper.cam_dirs, gen,
                                        n_bins=64)
        hit = v["hit"]
        d = np.where(hit, v["depth"], 1e9)
        ok = zbuf > d
        rgb_pred[ok] = v["color"][ok]
        zbuf[ok] = d[ok]
        hit_any |= hit
    if not hit_any.any():
        raise AssertionError("no object rendered on the held-out view")
    mse = float(np.mean((rgb_pred[hit_any] - rgb_gt[hit_any].astype(np.float32) / 255.0) ** 2))
    return -10.0 * np.log10(mse + 1e-12), n_obj


def run(device="cuda", n_frames: int = N_FRAMES, n_iters: int = N_ITERS) -> dict:
    """The live loop; returns {"losses", "ids", "psnr", "objects", "seconds"}."""
    cfg = TrainConfig(n_iters_per_frame=n_iters, win_size=2, n_samples_per_frame=24,
                      win_size_bg=2, n_samples_per_frame_bg=24,
                      hidden=16, hidden_bg=16, clip_size=8)
    mapper = SceneMapper(camera(), cfg, frame_capacity=16, max_objects=8,
                         initial_bucket=4, device=device)
    segmenter, tracker = front_end()
    t0 = time.perf_counter()
    all_ids = []
    for i, (t_wc, rgb, depth) in enumerate(stream(n_frames)):
        masks, ids, inst = segment_and_track(segmenter, tracker, rgb, depth, t_wc)
        all_ids.append([int(x) for x in ids])
        losses = mapper.process_frame(rgb, depth, inst.astype(np.int32),
                                      t_wc.astype(np.float32))
        tail = float(losses[-1]) if losses is not None else None
        print(f"[live] frame {i}: {len(masks)} masks -> {len(tracker.instances)} "
              f"tracked objects, loss {tail}")
    mapper.finish()
    psnr, n_obj = held_out_psnr(mapper, device)
    if device != "cpu":
        torch.cuda.synchronize()
    return {"losses": list(mapper.loss_history), "ids": all_ids, "psnr": psnr,
            "objects": n_obj, "seconds": time.perf_counter() - t0}


def check(res: dict, gates: bool = True) -> None:
    """Finite losses; at the published run also the original's PSNR gate."""
    if not res["losses"] or not np.isfinite(res["losses"]).all():
        raise AssertionError(f"losses not finite: {res['losses']}")
    if gates and not res["psnr"] > 15.0:
        raise AssertionError(f"live pipeline diverged (psnr {res['psnr']:.1f})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--iters", type=int, default=N_ITERS)
    args = ap.parse_args(argv)
    res = run(args.device, args.frames, args.iters)
    print(f"[live] held-out object-pixel PSNR {res['psnr']:.1f} dB over "
          f"{res['objects']} live-tracked objects; {res['seconds']:.1f} s")
    full = (args.frames, args.iters) == (N_FRAMES, N_ITERS)
    check(res, gates=full)
    print("LIVE MAPPING OK" if full else "cut run: losses finite (the gates apply at "
          f"{N_FRAMES} frames, {N_ITERS} iterations)")
    return res


if __name__ == "__main__":
    main()

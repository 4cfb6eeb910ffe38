"""Scale check with openobj_torch (the port of examples/scale_check.py): 24
objects, the slot bucket growing while it trains, and a batched held-out
render.

A 24-sphere synthetic scene at 160x120 (objects come into view over 16
orbit frames, so the slot bucket grows 8 -> 16 -> 32), trained at hidden 32,
background 64, clip 32, in part mode; then a held-out pose rendered through
the batched whole-frame renderer (``render_frame_batched``), with the
silhouette IoU against the scene's objects and the colour error on object
pixels.

Run:  python examples/torch_scale_check.py [--device cuda|cpu]
          [--frames 16] [--iters 40] [--max-hit-rays 8192]
At the published run (16 frames, 40 iterations) the example's gates apply:
>= 20 objects, 32 slots, finite losses, the last loss under 1.2x the
first, colour MAE < 0.2 on object pixels, then "SCALE CHECK OK". A cut run
(fewer frames or iterations; fewer rays rendered) prints the same numbers
and checks only that the losses are finite.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openobj_torch.core import renderer, trainer  # noqa: E402
from openobj_torch.core.scene import Camera, SceneMapper  # noqa: E402
from openobj_torch.data import synthetic  # noqa: E402
from openobj_torch.models.object_field import tree_map  # noqa: E402
from openobj_torch.ops import sampling  # noqa: E402
from openobj_torch.utils.geometry import object_bound_from_keyframes  # noqa: E402

W, H = 160, 120
N_FRAMES, N_ITERS = 16, 40
MAX_HIT_RAYS = 8192     # rays the batched renderer shades (the rest stay empty)


def make_scene(rng) -> synthetic.SyntheticScene:
    """24 spheres in a 6x4 grid on the back wall of a box room."""
    spheres = []
    for i in range(24):
        gx, gy = i % 6, i // 6
        spheres.append(synthetic.Sphere(
            center=np.array([-1.25 + 0.5 * gx, -0.75 + 0.5 * gy, -0.5 + 0.33 * (i % 4)]),
            radius=0.2, color=rng.uniform(0.2, 1.0, 3), inst_id=4 + i))
    return synthetic.SyntheticScene(
        room=synthetic.BoxRoom(half_extent=np.array([3.5, 3.5, 3.5]),
                               color=np.array([0.6, 0.6, 0.62])),
        spheres=spheres)


def run(device="cuda", n_frames: int = N_FRAMES, n_iters: int = N_ITERS,
        max_hit_rays: int = MAX_HIT_RAYS) -> dict:
    """Train and render; returns {"losses", "objects", "slots", "buckets",
    "rendered", "iou", "mae", "psnr", "train_s", "render_s"}."""
    cam = Camera(width=W, height=H, fx=100.0, fy=100.0, cx=80.0, cy=60.0)
    rng = np.random.default_rng(0)
    scene = make_scene(rng)
    dirs = cam.ray_dirs("cpu").numpy()
    cfg = trainer.TrainConfig(
        n_iters_per_frame=n_iters, win_size=3, n_samples_per_frame=24,
        win_size_bg=3, n_samples_per_frame_bg=64,
        hidden=32, hidden_bg=64, clip_size=32, part_mode=True, part_down=4)
    m = SceneMapper(cam, cfg, frame_capacity=24, max_objects=32,
                    keyframe_buffer_size=8, keyframe_step=2, keyframe_step_bg=4,
                    device=device)
    buckets = [m.state.n_slots]
    t0 = time.perf_counter()
    for i in range(n_frames):
        t_wc = synthetic.orbit_pose(np.pi / 2 - 0.35 + 0.7 * i / N_FRAMES, radius=2.8)
        rgb, depth, inst = scene.render(t_wc, dirs)
        pf = rng.normal(size=(H // 4, W // 4, 32)).astype(np.float32)
        m.process_frame(rgb, depth, inst, t_wc, partfeat=pf)
        if m.state.n_slots != buckets[-1]:
            buckets.append(m.state.n_slots)
    m.finish()
    if device != "cpu":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print(f"trained {n_frames} frames, {m.n_objects} objects, slots={m.state.n_slots} "
          f"(buckets {buckets}), {train_s:.1f} s")
    print("losses:", [round(x, 2) for x in m.loss_history[::4]])

    # held-out render of every boxed object through the batched renderer
    t0 = time.perf_counter()
    t_eval = synthetic.orbit_pose(np.pi / 2, radius=2.8)
    rgb_gt, _, inst_gt = scene.render(t_eval, dirs)
    reg, store = m.registry, m.store
    fg = []
    for inst_id, slot in reg.inst_to_slot.items():
        st = reg.slots[slot]
        kfs = torch.as_tensor(reg.kf_frames[slot][: st.n_kf], device=store.depth.device)
        try:
            st.bbox3d = object_bound_from_keyframes(
                store.depth[kfs].cpu().numpy(), (store.inst[kfs] == inst_id).cpu().numpy(),
                store.t_wc[kfs].cpu().numpy(), cam.fx, cam.fy, cam.cx, cam.cy)
        except Exception:
            continue
        if st.bbox3d is not None:
            fg.append((inst_id, slot, st))
    if not fg:
        raise AssertionError("no object has a box to render")
    dev = m.cam_dirs.device
    slot_idx = torch.as_tensor([s for _, s, _ in fg], device=dev)
    params_sub = tree_map(lambda x: x[slot_idx], m.state.fg_params)
    t_wo = np.tile(np.eye(4, dtype=np.float32), (len(fg), 1, 1))
    ext = np.zeros((len(fg), 3), np.float32)
    ctr = np.zeros((len(fg), 3), np.float32)
    for j, (_, _, st) in enumerate(fg):
        t_wo[j, :3, :3] = st.bbox3d.r
        t_wo[j, :3, 3] = st.bbox3d.center
        ext[j] = st.bbox3d.extent
        ctr[j] = st.obj_center
    dirs_c = m.cam_dirs.reshape(-1, 3)
    t_eval_d = torch.as_tensor(t_eval, dtype=torch.float32, device=dev)
    origins, dirs_w = sampling.origin_dirs_w(t_eval_d.expand(dirs_c.shape[0], 4, 4), dirs_c)
    out = renderer.render_frame_batched(
        params_sub, torch.as_tensor(t_wo, device=dev), torch.as_tensor(ext, device=dev),
        torch.as_tensor(ctr, device=dev), torch.ones((len(fg),), dtype=torch.bool, device=dev),
        origins, dirs_w, torch.Generator(device=dev).manual_seed(5),
        n_bins=80, max_hit_rays=max_hit_rays, chunk=1024)
    win = out["winner"].cpu().numpy().reshape(H, W)
    col = out["color"].cpu().numpy().reshape(H, W, 3)
    render_s = time.perf_counter() - t0
    hit = win >= 0
    gt_obj = inst_gt >= 4
    iou = float((hit & gt_obj).sum() / max((hit | gt_obj).sum(), 1))
    pix = hit & gt_obj
    mae = psnr = None
    if pix.any():
        err = col[pix] - rgb_gt[pix].astype(np.float64) / 255
        mae = float(np.abs(err).mean())
        psnr = float(-10 * np.log10((err ** 2).mean() + 1e-12))
    print(f"fg objects rendered: {len(fg)}; silhouette IoU {iou:.2f}; "
          f"object-pixel colour MAE {mae}, PSNR {psnr} dB; render {render_s:.1f} s")
    return {"losses": list(m.loss_history), "objects": m.n_objects, "slots": m.state.n_slots,
            "buckets": buckets, "rendered": len(fg), "iou": iou, "mae": mae, "psnr": psnr,
            "train_s": train_s, "render_s": render_s}


def check(res: dict, gates: bool = True) -> None:
    """Finite losses; at the published run also the original's gates."""
    ls = res["losses"]
    if not ls or not np.isfinite(ls).all():
        raise AssertionError(f"losses not finite: {ls}")
    if not gates:
        return
    if res["objects"] < 20:
        raise AssertionError(f"{res['objects']} objects")
    if res["slots"] != 32:
        raise AssertionError(f"bucket {res['slots']}")
    if not ls[-1] < ls[0] * 1.2:
        raise AssertionError(f"loss exploding: {ls[0]} -> {ls[-1]}")
    if res["mae"] is not None and not res["mae"] < 0.2:
        raise AssertionError(f"colour MAE {res['mae']}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--iters", type=int, default=N_ITERS)
    ap.add_argument("--max-hit-rays", type=int, default=MAX_HIT_RAYS)
    args = ap.parse_args(argv)
    res = run(args.device, args.frames, args.iters, args.max_hit_rays)
    full = (args.frames, args.iters, args.max_hit_rays) == (N_FRAMES, N_ITERS, MAX_HIT_RAYS)
    check(res, gates=full)
    print("SCALE CHECK OK" if full else "cut run: losses finite (the gates apply at "
          f"{N_FRAMES} frames, {N_ITERS} iterations)")
    return res


if __name__ == "__main__":
    main()

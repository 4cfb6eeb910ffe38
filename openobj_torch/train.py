"""Training entry point: config-driven incremental multi-object mapping.

Port of ``openobj_tpu.train``:

    python -m openobj_torch.train --config configs/replica/room_0.json \
        --logdir logs/room_0 [--class-features class_feats.npz] [--device cpu]

Per frame: the loader's sample (numpy) goes to ``SceneMapper.process_frame``
on the mapper's device (the card unless ``--device`` says otherwise), which
trains it through K1/K2/K2r. At the end: open-vocabulary semantic
assignment, per-object checkpoints + camera pose, the resumable scene
snapshot, and, as the config's ``vis`` block gates them, whole-dataset
rendering (``if_render``) and meshing (``if_obj``); ``timing.json`` holds
the mean time per frame (on the card each frame's span waits for the
frame's device work; the JAX package's does not wait).

The command line is the JAX package's but for two flags that only make
sense there: ``--prng`` (the JAX PRNG implementation) and
``--compilation-cache`` (XLA's persistent cache; the port compiles its
kernels once per checkout into ``build/kernels/``). ``--device`` is added.

The run's outputs:

  * ``save_checkpoints``: one ``obj_<id>.npz`` per object (and the
    background model) under ``<log_dir>/ckpt/<id>/``, each object's
    oriented box computed from its keyframes where it has none, and the
    last camera pose;
  * ``render_dataset``: every pose of a dataset rendered through every
    object field and composited by z-buffer, written as rgb / depth (mm,
    16 bit) / maskid / inst PNGs under ``<log_dir>/render/``;
  * ``export_meshes``: one OBJ per object (and optionally its occupied grid
    points as a PLY) under ``<log_dir>/scene_mesh/``.

The field evaluations run on the mapper's device, through K1 on the card.
Class-name CLIP/SBERT features come from a precomputed .npz (names,
clipfeat [C, 512], capfeat [C, 384]).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch


def load_class_features(path: str | None):
    if path is None:
        return None
    z = np.load(path, allow_pickle=True)
    return {
        "names": list(z["names"]),
        "clipfeat": z["clipfeat"].astype(np.float32),
        "capfeat": z["capfeat"].astype(np.float32),
    }


def assign_all_semantics(mapper, class_feats):
    """Reference train.py:497-526: reserved ids 0/2/3 -> wall/floor/ceiling
    class indices; others via DBSCAN-majority features + caption-confident
    argmax."""
    from openobj_torch.viz.query import assign_semantics

    names = class_feats["names"]
    mapping = {}
    reserved = {0: "wall", 2: "floor", 3: "ceiling"}
    for inst_id, cname in reserved.items():
        if cname in names:
            mapping[inst_id] = names.index(cname)
    for inst_id, slot in mapper.registry.inst_to_slot.items():
        if inst_id in mapping:
            mapper.registry.slots[slot].semantic_id = mapping[inst_id]
            continue
        st = mapper.registry.slots[slot]
        if not st.clip_feats:
            continue
        cid = assign_semantics(
            np.stack(st.clip_feats), np.stack(st.caption_feats),
            class_feats["clipfeat"], class_feats["capfeat"],
        )
        mapping[inst_id] = cid
        st.semantic_id = cid
    if mapper.registry.bg is not None and "wall" in names:
        mapper.registry.bg.semantic_id = names.index("wall")
        mapping[0] = names.index("wall")
    return mapping


def _keyframe_bound(mapper, kfs, inst_id: int):
    """Oriented box of ``inst_id`` from the store's keyframes ``kfs``: only
    those frames are unpacked and brought to the host."""
    from openobj_torch.core import frame_store as FS
    from openobj_torch.utils.geometry import object_bound_from_keyframes

    cam = mapper.camera
    store = mapper.store
    idx = torch.as_tensor(np.asarray(kfs, np.int64), device=store.packed.device)
    packed = store.packed[:, idx]
    return object_bound_from_keyframes(
        FS.unpack_depth(packed).cpu().numpy(),
        FS.unpack_inst(packed).cpu().numpy() == inst_id,
        store.t_wc[idx].cpu().numpy(),
        cam.fx, cam.fy, cam.cx, cam.cy,
    )


def save_checkpoints(mapper, log_dir: str, t_wc_last: np.ndarray):
    """Per-object .npz checkpoints + the last camera pose."""
    from openobj_torch.core import checkpoint

    reg = mapper.registry
    for inst_id, slot in reg.inst_to_slot.items():
        st = reg.slots[slot]
        if st.bbox3d is None or not st.bbox_final:
            st.bbox3d = _keyframe_bound(mapper, reg.kf_frames[slot][: st.n_kf], inst_id)
        checkpoint.save_object_checkpoint(
            os.path.join(log_dir, "ckpt", str(inst_id), f"obj_{inst_id}.npz"),
            inst_id, mapper.slot_params(slot), mapper.cfg.obj_scale,
            bbox3d=st.bbox3d, obj_center=st.obj_center,
            clip_feats=np.stack(st.clip_feats) if st.clip_feats else None,
            caption_feats=np.stack(st.caption_feats) if st.caption_feats else None,
            semantic_id=st.semantic_id,
        )
    if mapper.cfg.do_bg and reg.bg_seen:
        bg = reg.bg
        bg.bbox3d = _keyframe_bound(mapper, reg.bg_kf_frames[: bg.n_kf], 0)
        checkpoint.save_object_checkpoint(
            os.path.join(log_dir, "ckpt", "0", "obj_0.npz"),
            0, mapper.state.bg_params, mapper.cfg.bg_scale,
            bbox3d=bg.bbox3d,
            clip_feats=np.stack(bg.clip_feats) if bg.clip_feats else None,
            caption_feats=np.stack(bg.caption_feats) if bg.caption_feats else None,
            semantic_id=bg.semantic_id,
        )
    cam_dir = os.path.join(log_dir, "cam_pose")
    os.makedirs(cam_dir, exist_ok=True)
    np.savez(os.path.join(cam_dir, "twc_frame.npz"), twc=t_wc_last)


def render_stack(mapper, bg_ids=(0, 2, 3)):
    """The objects ``render_dataset`` renders together: every object with a
    box whose id is not a background id, in registry order. Returns
    (instance ids [O] int32 numpy, stacked params, OBB->world [O, 4, 4],
    extents [O, 3], centres [O, 3]) on the mapper's device, or None when
    there is no such object."""
    from openobj_torch.models import object_field

    reg = mapper.registry
    fg = [(i, s) for i, s in reg.inst_to_slot.items()
          if reg.slots[s].bbox3d is not None and i not in bg_ids]
    if not fg:
        return None
    dev = mapper.device
    boxes = [reg.slots[s].bbox3d for _, s in fg]
    t_wo = np.tile(np.eye(4, dtype=np.float32), (len(fg), 1, 1))
    t_wo[:, :3, :3] = [b.r for b in boxes]
    t_wo[:, :3, 3] = [b.center for b in boxes]
    extents = np.asarray([b.extent for b in boxes], np.float32)
    centers = np.asarray([reg.slots[s].obj_center for _, s in fg], np.float32)
    slot_idx = torch.as_tensor([s for _, s in fg], device=dev)
    return (np.asarray([i for i, _ in fg], np.int32),
            object_field.tree_map(lambda x: x[slot_idx], mapper.state.fg_params),
            *(torch.as_tensor(x, device=dev) for x in (t_wo, extents, centers)))


def render_dataset(mapper, dataset, log_dir: str, mapping_class: dict,
                   bg_ids=(0, 2, 3), n_bins: int = 150, chunk: int = 2048,
                   hit_frac: float = 0.25, two_pass: bool = False,
                   n_probe: int = 32, refine_bins: int | None = None,
                   adaptive_bins: bool = False):
    """Render every pose of ``dataset`` (a sequence of samples with
    ``t_wc`` and ``frame_id``) through all object fields with z-buffer
    compositing; write rgb/depth/maskid/inst PNGs.

    Foreground objects render together per frame
    (``renderer.render_frame_batched``, box-hit compacted, the cap sized
    from ``obb_hit_counts``); background-id entries (and the background
    model), which paint colour but never the z-buffer, render one by one.
    ``two_pass``: probe-and-tighten with ``refine_bins`` bins in the refine
    pass (default max(n_bins // 2, 48)); ``adaptive_bins``: per-object bin
    counts (``renderer.render_frame_bucketed``). The jitter comes from a
    generator seeded 0 on the mapper's device."""
    from openobj_torch.core import renderer
    from openobj_torch.ops import sampling
    from openobj_torch.utils.png import write_png

    eff_bins = n_bins
    if two_pass:
        eff_bins = refine_bins if refine_bins is not None else max(n_bins // 2, 48)
    out_dir = os.path.join(log_dir, "render")
    os.makedirs(out_dir, exist_ok=True)
    # the instance -> class mapping the maskid images were painted with
    with open(os.path.join(out_dir, "mapping_class.json"), "w") as f:
        json.dump({str(k): int(v) for k, v in mapping_class.items()}, f)
    h, w = mapper.camera.height, mapper.camera.width
    dev = mapper.device
    reg = mapper.registry

    fg = render_stack(mapper, bg_ids)
    bg_entries = [(i, mapper.slot_params(s), reg.slots[s]) for i, s in reg.inst_to_slot.items()
                  if i in bg_ids and reg.slots[s].bbox3d is not None]
    if mapper.cfg.do_bg and reg.bg is not None and reg.bg.bbox3d is not None:
        bg_entries.append((0, mapper.state.bg_params, reg.bg))

    if fg is not None:
        inst_arr, params_sub, t_wo, extents, centers = fg
        active = torch.ones((len(inst_arr),), dtype=torch.bool, device=dev)
        class_arr = np.asarray([mapping_class.get(int(x), 0) for x in inst_arr], np.uint16)
        mhr_full = -(-(h * w) // chunk) * chunk
        mhr = min(-(-int(h * w * hit_frac) // chunk) * chunk, mhr_full)

    dirs_c = mapper.cam_dirs.reshape(-1, 3)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(len(dataset)):
        sample = dataset[i]
        t = torch.as_tensor(np.asarray(sample.t_wc), dtype=torch.float32, device=dev)
        origins, dirs_w = sampling.origin_dirs_w(t.expand(dirs_c.shape[0], 4, 4), dirs_c)
        rgb_img = np.zeros((h, w, 3), np.uint8)
        maskid = np.zeros((h, w), np.uint16)
        instid = np.zeros((h, w), np.int32)
        zbuf = np.full((h, w), 100.0, np.float32)
        if fg is not None:
            # size the compaction cap from the true per-object coverage so a
            # close-up object never loses pixels
            counts = renderer.obb_hit_counts(t_wo, extents, active, origins, dirs_w)
            need = int(counts.max())
            while mhr < min(need, mhr_full):
                mhr = min(mhr * 2, mhr_full)
                print(f"render: raising max_hit_rays to {mhr} "
                      f"(an object covers {need} rays)")
            extra = {"hit_counts": counts} if adaptive_bins else {}
            render_fn = (renderer.render_frame_bucketed if adaptive_bins
                         else renderer.render_frame_batched)
            out = render_fn(
                params_sub, t_wo, extents, centers, active, origins, dirs_w, gen,
                n_bins=eff_bins, max_hit_rays=mhr, chunk=chunk,
                max_deg=mapper.cfg.max_deg, two_pass=two_pass, n_probe=n_probe,
                **extra,
            )
            if int(out["n_hit"].max()) > mhr:
                raise ValueError(
                    f"render cap regression: an object covers "
                    f"{int(out['n_hit'].max())} rays > cap {mhr}")
            win = out["winner"].cpu().numpy().reshape(h, w)
            zb = out["depth"].cpu().numpy().reshape(h, w)
            col = out["color"].cpu().numpy().reshape(h, w, 3)
            hitm = win >= 0
            rgb_img[hitm] = (np.clip(col[hitm], 0, 1) * 255).astype(np.uint8)
            instid[hitm] = inst_arr[np.maximum(win, 0)][hitm]
            maskid[hitm] = class_arr[np.maximum(win, 0)][hitm]
            zbuf[hitm] = zb[hitm]
        bg_zbuf = np.full((h, w), 100.0, np.float32)
        for inst_id, params, st in bg_entries:
            v = renderer.render_object_view(
                params, st.bbox3d, st.obj_center, sample.t_wc, mapper.cam_dirs, gen,
                n_bins=eff_bins, two_pass=two_pass, n_probe=n_probe,
            )
            d = np.where(v["hit"], v["depth"], 100.0)
            # bg ids never write the main depth buffer; bg-vs-bg overlaps
            # depth-test against their own buffer
            ok = (zbuf > d) & (bg_zbuf > d)
            rgb_img[ok] = (np.clip(v["color"], 0, 1)[ok] * 255).astype(np.uint8)
            maskid[ok] = mapping_class.get(inst_id, 0)
            instid[ok] = inst_id
            bg_zbuf[ok] = d[ok]
        depth_img = np.where(zbuf >= 100.0, 0.0, zbuf)
        fid = sample.frame_id
        write_png(os.path.join(out_dir, f"rgb_{fid}.png"), rgb_img)
        write_png(os.path.join(out_dir, f"depth_{fid}.png"),
                  (depth_img * 1000).astype(np.uint16))
        write_png(os.path.join(out_dir, f"maskid_{fid}.png"), maskid.astype(np.uint16))
        write_png(os.path.join(out_dir, f"inst_{fid}.png"),
                  np.maximum(instid, 0).astype(np.uint16))


def export_meshes(mapper, log_dir: str, grid_dim: int, live_voxel_size: float,
                  save_mesh: bool = True, save_pcd: bool = False):
    """Mesh every object with a box and export it as OBJ; with ``save_pcd``
    also the occ > 0.5 grid points as a PLY. Returns the number of objects
    meshed."""
    from openobj_torch.core import meshing
    from openobj_torch.utils.geometry import TriangleMesh

    mesh_dir = os.path.join(log_dir, "scene_mesh")
    os.makedirs(mesh_dir, exist_ok=True)
    n = 0
    for inst_id, slot in mapper.registry.inst_to_slot.items():
        st = mapper.registry.slots[slot]
        if st.bbox3d is None:
            continue
        dim = meshing.adaptive_grid_dim(st.bbox3d, live_voxel_size, grid_dim)
        params = mapper.slot_params(slot)
        mesh = meshing.mesh_object(params, st.bbox3d, st.obj_center, grid_dim=dim,
                                   with_color=True)
        if mesh is None:
            print(f"meshing failed obj {inst_id}")
            continue
        if save_mesh:
            mesh.export_obj(os.path.join(mesh_dir, f"obj{inst_id}.obj"))
        if save_pcd:
            pc = meshing.object_point_cloud(params, st.bbox3d, st.obj_center,
                                            grid_dim=dim)
            if pc is not None:
                pts, cols = pc
                TriangleMesh(
                    vertices=pts.astype(np.float32),
                    faces=np.zeros((0, 3), np.int32),
                    vertex_colors=(np.clip(cols, 0, 1) * 255).astype(np.uint8),
                ).export_ply(os.path.join(mesh_dir, f"obj{inst_id}_pcd.ply"))
        n += 1
    return n


def main(argv=None):
    """The training command line; returns the trained ``SceneMapper``."""
    parser = argparse.ArgumentParser(description="openobj_torch training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--logdir", default="./logs/debug")
    parser.add_argument("--class-features", default=None,
                        help=".npz with names/clipfeat/capfeat")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--frame-capacity", type=int, default=256,
                        help="device frame-store slots; sequences longer "
                             "than this train in constant memory via "
                             "keyframe-ring eviction (SceneMapper)")
    parser.add_argument("--tensorboard", action="store_true",
                        help="log per-frame scalars via tensorboardX")
    parser.add_argument("--ckpt-every", type=int, default=None,
                        help="also checkpoint every N frames (the reference's "
                             "n_vis_iter cadence; default: end of run only)")
    parser.add_argument("--render-two-pass", action="store_true",
                        help="empty-space-skipping render (probe pass + "
                             "tightened refine pass)")
    parser.add_argument("--render-refine-bins", type=int, default=None,
                        help="bin count for the two-pass refine pass "
                             "(default: max(render n_bins // 2, 48)); only "
                             "used with --render-two-pass")
    parser.add_argument("--render-adaptive-bins", action="store_true",
                        help="per-object render bin counts (density anchored "
                             "at the largest object, bucketed static sizes); "
                             "composes with --render-two-pass")
    parser.add_argument("--resume", action="store_true",
                        help="resume from <logdir>/scene_state.npz (full "
                             "training state incl. optimizer); already-seen "
                             "frames are re-ingested into the frame store "
                             "without re-training")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the mapper (default cuda: the "
                             "card; cpu runs the plain versions of the kernels)")
    args = parser.parse_args(argv)

    from openobj_torch.config import load_scene_config, make_mapper
    from openobj_torch.core.checkpoint import load_scene, save_scene
    from openobj_torch.core.frame_store import append_frame
    from openobj_torch.data.loaders import init_loader, make_dataset
    from openobj_torch.utils.profiling import performance_measure, reset_stats, stats

    reset_stats()  # timing.json covers THIS run only (the dict is thread-local)
    os.makedirs(args.logdir, exist_ok=True)
    if os.path.abspath(os.path.dirname(args.config)) != os.path.abspath(args.logdir):
        shutil.copy(args.config, args.logdir)   # (run_scenes writes it there itself)
    cfg = load_scene_config(args.config)
    dataset = make_dataset(cfg)
    n_frames = len(dataset)
    if args.max_frames:
        n_frames = min(n_frames, args.max_frames)
    mapper = make_mapper(cfg, frame_capacity=min(n_frames + 1, args.frame_capacity),
                         device=args.device)
    class_feats = load_class_features(args.class_features)

    resume_from = 0
    if args.resume:
        load_scene(args.logdir, mapper)
        resume_from = mapper.frame_count
        print(f"resuming after frame {resume_from}")

    tb = None
    if args.tensorboard:
        try:
            from tensorboardX import SummaryWriter

            tb = SummaryWriter(os.path.join(args.logdir, "tb"))
        except Exception as e:  # pragma: no cover
            print(f"tensorboard logging unavailable: {e}")

    t_wc_last = np.eye(4)
    for i, sample in enumerate(init_loader(dataset)):
        if i >= n_frames:
            break
        if args.resume and i < resume_from:
            # store-only re-ingest: keyframe tables index into the store by
            # frame slot, so each frame lands in the SAME slot it had
            # (frame_slots replays the eviction mapping); the registry and
            # optimizer state came from the snapshot
            at = mapper.frame_slots[i] if i < len(mapper.frame_slots) else None
            mapper.store, _ = append_frame(
                mapper.store, sample.rgb, sample.depth, sample.inst,
                sample.t_wc, sample.part_feat, at=at,
            )
            t_wc_last = sample.t_wc
            continue
        # blocking on the card: the span holds this frame's device work
        # rather than the wait for the frame before it
        with performance_measure(f"frame {i}", verbose=False,
                                 block=mapper.device.type == "cuda"):
            losses = mapper.process_frame(
                sample.rgb, sample.depth, sample.inst, sample.t_wc,
                bboxes=sample.bboxes, partfeat=sample.part_feat,
                obj_clip=sample.obj_clip, obj_cap=sample.obj_cap,
            )
        t_wc_last = sample.t_wc
        if losses is not None and i % 10 == 0:
            lv = losses.cpu().numpy()
            print(f"frame {i}/{n_frames}: loss {lv[0]:.3f} -> "
                  f"{lv[-1]:.3f}, objects {mapper.n_objects}")
        if tb is not None and losses is not None:
            tb.add_scalar("train/frame_loss", float(losses[-1]), i)
            tb.add_scalar("train/n_objects", mapper.n_objects, i)
        if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            save_checkpoints(mapper, args.logdir, t_wc_last)
    mapper.finish()   # drain the pipeline (validates the last frame)
    save_scene(args.logdir, mapper)   # full resumable snapshot
    if tb is not None:
        tb.close()

    mapping_class = {}
    if class_feats is not None:
        mapping_class = assign_all_semantics(mapper, class_feats)
    save_checkpoints(mapper, args.logdir, t_wc_last)
    vis = cfg.raw.get("vis", {})
    if bool(vis.get("if_render", 0)):
        render_dataset(mapper, dataset, args.logdir, mapping_class,
                       bg_ids=cfg.bg_ids,
                       two_pass=args.render_two_pass or bool(vis.get("two_pass", 0)),
                       refine_bins=args.render_refine_bins,
                       adaptive_bins=args.render_adaptive_bins)
    # reference gate: meshing runs iff if_obj (train.py:617-652); save_mesh
    # only selects the output kind inside the block (room_0 ships
    # if_obj: 0, save_mesh: 1 and exports nothing)
    if bool(vis.get("if_obj", 0)):
        n = export_meshes(mapper, args.logdir, cfg.grid_dim,
                          cfg.live_voxel_size, cfg.save_mesh, cfg.save_pcd)
        print(f"exported {n} meshes")
    summary = {k: round(v["mean_ms"], 1) for k, v in stats().items()}
    with open(os.path.join(args.logdir, "timing.json"), "w") as f:
        json.dump(summary, f)
    print("done:", args.logdir)
    return mapper


if __name__ == "__main__":
    main()

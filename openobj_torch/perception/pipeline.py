"""The cross-frame instance-association pipeline (mask_graph equivalent).

Port of ``openobj_tpu.perception.pipeline``: the similarity matrices run on
a torch device (the card unless the caller asks for the CPU); projection,
clustering, merging and healing run on the host in numpy. The whole pipeline,
with the reference's stage order (maskclustering/mask_graph.py:897-1280):

  frames of (masks, captions, capfeats, clipfeats) + posed RGB-D
    -> project_masks (3D evidence, mask filtering)
    -> 5 similarity matrices (3D IoU, caption, CLIP, color, projected 2D IoU)
    -> weighted graph + Louvain -> junk filter (<= frames/50)
    -> global cluster accumulation w/ bg caption anchoring
    -> second-stage merge -> final global ids (1/2/3 reserved, 4+ objects,
       junk -> 0)
    -> instance/class PNGs + per-frame feature pickles.

The perception MODELS (CropFormer/TAP/SAM/CLIP/SBERT) are pluggable
encoders (``openobj_tpu.perception.encoders``; not ported yet); this
pipeline consumes their outputs: precomputed artifacts (reference
contract) or live encoder calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from openobj_torch.perception import graph, merge, projection, similarity
from openobj_torch.utils.profiling import performance_measure


@dataclass
class FrameInput:
    masks: list[np.ndarray]            # [H, W] bool per mask
    captions: list[str]
    capfeats: list[np.ndarray]         # 384-d unit
    clipfeats: list[np.ndarray]        # 512-d unit
    depth: np.ndarray                  # [H, W] meters
    rgb: np.ndarray                    # [H, W, 3] uint8
    t_wc: np.ndarray                   # [4, 4]
    gt_semantic: np.ndarray | None = None   # [H, W] GT ids (bg anchoring)


@dataclass
class AssociationConfig:
    fx: float = 600.0
    fy: float = 600.0
    cx: float = 599.5
    cy: float = 339.5
    weights: dict = field(default_factory=lambda: {
        "geo": 0.30, "cap": 0.20, "clip": 0.30, "color": 0.20, "geo2d": 0.60,
    })
    graph_method: str = "weighted"
    skip_2d: int = 10
    use_geo2d: bool = True
    cap_thre: float = 0.8
    dis_thre: float = 0.02
    weight_pc: float = 0.6
    weight_caption: float = 0.3
    weight_color: float = 0.6
    # part-of contact tier in the second-stage merge (0 = off; see
    # merge.second_stage_mapping docstring — heals table legs etc.)
    contact_pc: float = 0.0
    contact_cap: float = 0.9
    # reprojection healing of the written instance maps (deliberate
    # capability beyond the reference — see perception.healing docstring;
    # measured: recovers the frames where the 2D segmenter dropped or
    # swallowed a small object under sensor noise)
    heal_reproject: bool = True
    heal_min_support: int = 2
    heal_base_tol: float = 0.02
    # >1: rebuild per-object clouds from the healed maps and heal again.
    # Default 1: measured on the noise-tier matrix, the weighted-evidence
    # clouds (healing.weighted_voxel_clouds) already resolve the swallow-
    # contamination the iteration targeted, and the label->cloud feedback
    # loop fed contact-bleed pixels back as geometry (tabletop 0.925 ->
    # 0.916). Kept as a knob for scenes with grosser per-frame misses.
    heal_iterations: int = 1
    min_component_px: int = 100
    dbscan_min_points: int = 100
    dbscan_eps: float = 0.05    # scale with pixel footprint: ~2 * depth / fx
    adaptive_eps: bool = True   # raise eps to each component's 3D pixel
    #                             spacing; False = reference fixed-eps parity
    max_depth: float = 10.0
    gt_bg_ids: dict = field(default_factory=dict)  # {"wall": id, ...}
    geo_bg: bool = False       # geometric bg anchoring (classify_bg_hull)
    geo_bg_up_axis: int = 2
    geo_bg_shell_tol: float = 0.10
    geo_bg_min_extent: float = 2.0
    seed: int = 0


def associate(
    frames: list[FrameInput],
    bg_feats: dict[str, np.ndarray],   # canonical wall/floor/ceiling SBERT feats
    cfg: AssociationConfig,
    device="cuda",
):
    """Run the full association. Returns dict with per-frame final ids +
    filtered masks + the global instance images, ready for write_artifacts,
    and the weighted similarity matrix whose entries >= 1.0 became the
    graph's edges. The similarity matrices are computed on ``device``, under
    the ``utils.profiling`` span "association: similarity matrices"."""
    # stage 1: project all masks to 3D evidence
    ev_per_frame: list[list[projection.MaskEvidence]] = []
    kept_caps, kept_capft, kept_clipft = [], [], []
    for fr in frames:
        evs, ok = projection.project_masks(
            fr.masks, fr.depth, fr.rgb, fr.t_wc,
            cfg.fx, cfg.fy, cfg.cx, cfg.cy,
            max_depth=cfg.max_depth,
            min_component_px=cfg.min_component_px,
            dbscan_min_points=cfg.dbscan_min_points,
            dbscan_eps=cfg.dbscan_eps,
            adaptive_eps=cfg.adaptive_eps,
        )
        ev_per_frame.append(evs)
        kept_caps.append([c for c, k in zip(fr.captions, ok) if k])
        kept_capft.append([c for c, k in zip(fr.capfeats, ok) if k])
        kept_clipft.append([c for c, k in zip(fr.clipfeats, ok) if k])

    flat_ev = [e for evs in ev_per_frame for e in evs]
    if not flat_ev:
        raise ValueError("no valid masks survived projection")
    bboxes = np.stack([e.bbox for e in flat_ev])
    capft = np.stack([f for fs in kept_capft for f in fs])
    clipft = np.stack([f for fs in kept_clipft for f in fs])
    colors = np.stack([e.color_hist for e in flat_ev])

    # stage 2: similarity matrices, timed under this span (each returns
    # numpy, so the span ends with the device's work done)
    with performance_measure("association: similarity matrices", verbose=False,
                             block=True):
        geo = similarity.iou3d_matrix(bboxes, device=device)
        cap = similarity.cosine_matrix(capft, device=device)
        clip = similarity.cosine_matrix(clipft, device=device)
        color = similarity.cosine_matrix(colors, device=device)
        geo2d = None
        if cfg.use_geo2d and cfg.weights.get("geo2d", 0) > 0:
            geo2d = similarity.projected_iou2d_matrix(
                [f.depth for f in frames],
                np.stack([f.t_wc for f in frames]),
                cfg.fx, cfg.fy, cfg.cx, cfg.cy, bboxes, skip=cfg.skip_2d,
                device=device,
            )

    # stage 3: graph clustering + junk filter
    adj, weighted = graph.build_adjacency(
        geo, cap, clip, color, geo2d, method=cfg.graph_method,
        weights=cfg.weights,
    )
    ids = graph.louvain_cluster(adj, weighted, seed=cfg.seed)
    ids = graph.filter_rare_ids(ids, int(len(frames) / 50))

    # unflatten ids back per frame
    per_frame_ids: list[list[int]] = []
    cur = 0
    for evs in ev_per_frame:
        per_frame_ids.append(ids[cur : cur + len(evs)])
        cur += len(evs)

    # stage 4: global accumulation with bg caption anchoring
    clusters = merge.GlobalClusters(bg_feats, cap_thre=cfg.cap_thre,
                                gt_mode=bool(cfg.gt_bg_ids))
    for i, (evs, fids) in enumerate(zip(ev_per_frame, per_frame_ids)):
        fr = frames[i]
        for j, (ev, cid) in enumerate(zip(evs, fids)):
            gt_sem = None
            if fr.gt_semantic is not None and cfg.gt_bg_ids:
                vals, counts = np.unique(
                    fr.gt_semantic[ev.mask], return_counts=True
                )
                if len(vals):
                    mode_id = int(vals[np.argmax(counts)])
                    for name, gid in cfg.gt_bg_ids.items():
                        if mode_id == gid:
                            gt_sem = name
            clusters.add(cid, ev.points, kept_capft[i][j], ev.color_hist, gt_sem)
    pcs, caps_g, cols_g, views_g = clusters.finalize()

    # stage 4.5 (weights-free path): geometric bg anchoring — large thin
    # planes route to the reserved wall/floor/ceiling ids when captions
    # carry no bg semantics (classify_bg_hull docstring)
    forced_bg: dict[int, int] = {}
    if cfg.geo_bg and pcs:
        all_pts = np.concatenate([p for p in pcs.values() if len(p)])
        # percentile AABB: under sensor noise the min/max AABB is a max
        # over ~1e5 noisy samples (~4 sigma out); 0.2/99.8 percentiles
        # keep it ~2.9 sigma out, which the hull test's noise-widened
        # shell accounts for (classify_bg_hull docstring)
        scene_aabb = np.concatenate([
            np.percentile(all_pts, 0.2, axis=0),
            np.percentile(all_pts, 99.8, axis=0),
        ])
        noise_sigma = merge.estimate_depth_noise(
            [fr.depth for fr in frames]
        )
        cam_up = np.asarray(
            [fr.t_wc[cfg.geo_bg_up_axis, 3] for fr in frames], np.float64
        )
        cam_up_range = (float(cam_up.min()), float(cam_up.max()))
        for cid, pts in pcs.items():
            name = merge.classify_bg_hull(
                pts, scene_aabb, up_axis=cfg.geo_bg_up_axis,
                shell_tol=cfg.geo_bg_shell_tol,
                min_extent=cfg.geo_bg_min_extent,
                cam_up_range=cam_up_range,
                noise_sigma=noise_sigma,
            )
            if name is not None:
                forced_bg[cid] = merge.RESERVED[name]

    # stage 5: second-stage merge -> final ids
    mapping, n_final = merge.second_stage_mapping(
        pcs, caps_g, cols_g, bg_feats,
        cap_thre=cfg.cap_thre, dis_thre=cfg.dis_thre,
        weight_pc=cfg.weight_pc, weight_caption=cfg.weight_caption,
        weight_color=cfg.weight_color, forced_bg=forced_bg,
        contact_pc=cfg.contact_pc, contact_cap=cfg.contact_cap,
        up_axis=cfg.geo_bg_up_axis,
        # bridge gate scales with sequence length: a cluster must be
        # seen in ≥10% of the association frames (min 2) to weld
        # components; below that it one-hop attaches to its best match
        n_views=views_g, bridge_min_views=max(2, len(frames) // 10),
    )
    final_ids = [
        [mapping.get(c, 0) for c in fids] for fids in per_frame_ids
    ]

    h, w = frames[0].depth.shape
    inst_images = []
    for evs, fids in zip(ev_per_frame, final_ids):
        img = np.zeros((h, w), np.int32)
        for ev, gid in zip(evs, fids):
            if gid != 0:
                img[ev.mask] = gid
        inst_images.append(img)

    heal_stats = None
    if cfg.heal_reproject:
        from openobj_torch.perception import healing

        # weighted evidence clouds straight from the per-mask raw points:
        # the per-voxel raw-observation count is the healing support
        # weight (an object's 16-frame evidence at a spot out-votes a
        # 2-frame swallow contamination in another object's cloud)
        raw_pcs: dict[int, list] = {}
        for evs, fids in zip(ev_per_frame, final_ids):
            for ev, g in zip(evs, fids):
                if g != 0 and len(ev.points):
                    raw_pcs.setdefault(g, []).append(ev.points)
        depths_l = [fr.depth for fr in frames]
        poses_l = [fr.t_wc for fr in frames]
        sigma = merge.estimate_depth_noise(depths_l)
        object_points = healing.weighted_voxel_clouds(raw_pcs)
        for it in range(max(1, cfg.heal_iterations)):
            inst_images, heal_stats = healing.heal_instance_images(
                inst_images, object_points, depths_l, poses_l,
                cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                noise_sigma=sigma,
                min_support=cfg.heal_min_support,
                base_tol=cfg.heal_base_tol,
            )
            if it + 1 < max(1, cfg.heal_iterations):
                object_points = healing.clouds_from_labels(
                    inst_images, depths_l, poses_l,
                    cfg.fx, cfg.fy, cfg.cx, cfg.cy)

    return {
        "heal_stats": heal_stats,
        "final_ids": final_ids,
        "cluster_ids": per_frame_ids,
        "masks": [[e.mask for e in evs] for evs in ev_per_frame],
        "captions": kept_caps,
        "capfeats": kept_capft,
        "clipfeats": kept_clipft,
        "inst_images": inst_images,
        "weighted": weighted,
        "n_objects": n_final,
        "global_points": pcs,
        "global_capft": caps_g,
    }

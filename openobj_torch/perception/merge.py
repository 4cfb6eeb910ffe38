"""Global merge + id mapping + artifact export.

Port of ``openobj_tpu.perception.merge`` (numpy + scipy); the DBSCAN is
``utils.dbscan`` (scikit-learn's labels) and the PNGs go through
``utils.png`` (the files OpenCV writes). Parity with the reference's
post-clustering stages (maskclustering/mask_graph.py:1105-1280):

  * per-cluster global point clouds accumulated and 1 cm voxel-downsampled;
  * per-observation caption features overridden by canonical wall/floor/
    ceiling features when SBERT similarity > cap_thre (or, with GT
    semantics, by the mask's majority GT id — :1111-1173);
  * per-cluster caption feature = DBSCAN majority-cluster mean, normalized
    (:1181-1184); color histogram = normalized mean (:1185-1187);
  * second-stage merge via ``compute_similarity_matrix_thre`` (:820-895):
    clusters merge when point-overlap ratio > weight_pc AND caption cos >
    weightcaption AND color cos > weightcolor, OR overlap > 0.9; wall/
    floor/ceiling captions map to reserved ids 1/2/3; everything else
    numbered from 4; junk (999) -> 0;
  * writers for the instance/class PNGs and the three per-frame feature
    pickles (:1240-1280) — the data contracts the NeRF stage consumes.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from scipy.spatial import cKDTree

from openobj_torch.perception.graph import JUNK_ID
from openobj_torch.utils.dbscan import dbscan_labels
from openobj_torch.utils.geometry import voxel_downsample

RESERVED = {"wall": 1, "floor": 2, "ceiling": 3}


def check_similarity(feats: np.ndarray, feat: np.ndarray, threshold: float = 0.8):
    """Any row of ``feats`` with cos > threshold (mask_graph.py:737-745)."""
    if feats is None or len(feats) == 0:
        return False
    return bool((np.asarray(feats) @ np.asarray(feat) > threshold).any())


def majority_cluster_mean(vectors: np.ndarray, eps: float = 0.2,
                          min_samples: int = 2) -> np.ndarray:
    """DBSCAN majority-cluster mean (mask_graph.py:604-619 /
    objnerf utils.py:138-155). Noise label (-1) competes like any other."""
    labels = dbscan_labels(vectors, eps, min_samples)
    uniq, counts = np.unique(labels, return_counts=True)
    major = uniq[np.argmax(counts)]
    return vectors[labels == major].mean(axis=0)


class GlobalClusters:
    """Per-cluster accumulated evidence across the sequence."""

    def __init__(self, bg_feats: dict[str, np.ndarray], cap_thre: float = 0.8,
                 gt_mode: bool = False):
        self.bg_feats = bg_feats  # {"wall": [K,384], "floor": ..., "ceiling": ...}
        self.cap_thre = cap_thre
        # gt_mode: GT semantics drive bg anchoring EXCLUSIVELY (reference
        # if_bg branch, mask_graph.py:1125-1146) — a mask whose majority GT
        # id is a real object class must not fall through to the caption-
        # similarity override ('a wall of books' clearing cap_thre would
        # route a bookshelf to reserved wall id 1 against the GT)
        self.gt_mode = gt_mode
        self.points: dict[int, list] = {}
        self.capft: dict[int, list] = {}
        self.color: dict[int, list] = {}

    def _canonical_capft(self, capft: np.ndarray, gt_sem: str | None):
        if gt_sem in self.bg_feats:
            return self.bg_feats[gt_sem][0]
        if gt_sem is None and not self.gt_mode:
            for name, fts in self.bg_feats.items():
                if check_similarity(fts, capft, self.cap_thre):
                    return fts[0]
        return capft

    def add(self, cluster_id: int, points: np.ndarray, capft: np.ndarray,
            color_hist: np.ndarray, gt_sem: str | None = None):
        if cluster_id == JUNK_ID:
            return
        self.points.setdefault(cluster_id, []).append(points)
        self.capft.setdefault(cluster_id, []).append(
            self._canonical_capft(capft, gt_sem)
        )
        self.color.setdefault(cluster_id, []).append(color_hist)

    def finalize(self, voxel: float = 0.01):
        """Returns ({id: pts}, {id: capft-384}, {id: color-96}, {id: n_views})
        — n_views is how many per-frame masks fed the cluster (the
        second-stage bridge gate's evidence count)."""
        pcs, caps, cols, views = {}, {}, {}, {}
        for cid in self.points:
            pcs[cid] = voxel_downsample(
                np.concatenate(self.points[cid]).astype(np.float64), voxel
            )
            ft = np.stack(self.capft[cid])
            f = majority_cluster_mean(ft) if ft.shape[0] > 1 else ft[0]
            caps[cid] = f / max(np.linalg.norm(f), 1e-12)
            c = np.stack(self.color[cid]).mean(0)
            cols[cid] = c / max(np.linalg.norm(c), 1e-12)
            views[cid] = len(self.capft[cid])
        return pcs, caps, cols, views


def estimate_depth_noise(depth_maps, quantile: float = 0.75) -> float:
    """Robust per-scene depth-noise sigma at SHELL range (the far
    surfaces the bg hull test cares about), estimated from the depth
    maps themselves: the horizontal second difference z[i-1] - 2 z[i] +
    z[i+1] is exactly 0 on any linear ramp (planar structure at any
    slant contributes nothing), has variance 6 sigma^2 on iid noise, and
    occlusion steps land in the tail that the median ignores. Restricted
    to pixels in the top depth ``quantile`` because structured-light /
    ToF noise grows ~quadratically with range — the near-field estimate
    would understate the noise where the walls are. Returns ~0 on clean
    (quantized) depth."""
    sigs = []
    for z in depth_maps:
        z = np.asarray(z, np.float64)
        if z.shape[1] < 3:
            continue
        d2 = z[:, 2:] - 2.0 * z[:, 1:-1] + z[:, :-2]
        zc = z[:, 1:-1]
        valid = (z[:, 2:] > 0) & (zc > 0) & (z[:, :-2] > 0)
        if not valid.any():
            continue
        far = zc >= np.quantile(zc[valid], quantile)
        sel = valid & far
        if sel.sum() >= 100:
            sigs.append(1.4826 * np.median(np.abs(d2[sel])) / np.sqrt(6.0))
    return float(np.median(sigs)) if sigs else 0.0


def classify_bg_hull(
    points: np.ndarray,
    scene_aabb: np.ndarray,          # [6] (min_xyz, max_xyz) of ALL clusters
    up_axis: int = 2,
    shell_tol: float = 0.10,
    frac_required: float = 0.75,
    min_extent: float = 2.0,
    cam_up_range: tuple[float, float] | None = None,
    noise_sigma: float = 0.0,
) -> str | None:
    """Geometric background classification — the weights-free stand-in for
    the reference's caption anchoring (mask_graph.py:1111-1135, which needs
    TAP captions literally saying 'wall'/'floor'/'ceiling').

    A cluster is background iff >= ``frac_required`` of its points lie
    within ``shell_tol`` of the scene's bounding-box shell (walls, floor
    and ceiling ARE the scene's enclosing surfaces; interior objects are
    off the shell — a sofa pushed against a wall still fails because its
    frontside points sit tens of centimeters inside) AND its spread clears
    ``min_extent`` along some axis (rejects small wall-mounted fixtures).
    Works for corner unions spanning several planes, where a single
    plane-fit test fails. Naming: majority vote of each near-shell point's
    nearest box face — up-max face -> ceiling, up-min -> floor, the four
    side faces -> wall. When ``cam_up_range`` (min/max camera height along
    the up axis over the trajectory) is given, ceiling additionally
    requires the cluster's median height ABOVE the highest camera and
    floor BELOW the lowest — a physical constraint that stops a large
    table top from becoming 'ceiling' in a scan that never looks up (the
    tabletop would otherwise define the scene's up-max face); candidates
    failing the height check fall back to 'wall' only if vertical-ish,
    else None. Returns the reserved name or None. Opt-in via
    AssociationConfig.geo_bg; the caption path stays the default whenever
    real captions are available.

    ``noise_sigma`` (estimate_depth_noise) widens the shell: under
    sensor noise a wall's points spread ~N(0, sigma) around the true
    plane AND the scene AABB itself sits ~2-3 sigma outside it (it is a
    max over noisy samples), so the effective tolerance becomes
    max(shell_tol, 7 * noise_sigma) — ~2.6 sigma for the AABB offset +
    ~4 sigma of point spread (measured on the Kinect-model stress:
    wall near-fraction at sigma~40 mm is 0.37 @ 0.10 m but 0.98 @
    0.30 m). Capped at 15% of the scene's largest extent so noise can
    never widen the shell into the room's interior; interior-object
    rejection still rides frac_required + min_extent."""
    if len(points) < 10:
        return None
    pts = np.asarray(points, np.float64)
    lo, hi = np.asarray(scene_aabb[:3]), np.asarray(scene_aabb[3:])
    if float((pts.max(0) - pts.min(0)).max()) < min_extent:
        return None
    tol = max(shell_tol,
              min(7.0 * noise_sigma, 0.15 * float((hi - lo).max())))
    # distance to each of the 6 faces: (axis, min-side) then (axis, max-side)
    d_lo = pts - lo[None, :]                 # [N, 3] distance to min faces
    d_hi = hi[None, :] - pts                 # [N, 3] distance to max faces
    d_all = np.concatenate([d_lo, d_hi], 1)  # [N, 6]
    nearest = np.argmin(d_all, 1)
    d_min = d_all[np.arange(len(pts)), nearest]
    near = d_min < tol
    if near.mean() < frac_required:
        return None
    votes = nearest[near]
    n_floor = int((votes == up_axis).sum())           # min face along up
    n_ceil = int((votes == 3 + up_axis).sum())        # max face along up
    n_wall = len(votes) - n_floor - n_ceil
    best = max((n_wall, "wall"), (n_floor, "floor"), (n_ceil, "ceiling"))[1]
    if best in ("floor", "ceiling") and cam_up_range is not None:
        med_up = float(np.median(pts[:, up_axis]))
        ok = (med_up > cam_up_range[1] if best == "ceiling"
              else med_up < cam_up_range[0])
        if not ok:
            return "wall" if n_wall >= 0.25 * len(votes) else None
    return best


def overlap_ratio(pc1: np.ndarray, pc2: np.ndarray, dis_thre: float = 0.02,
                  tree1: cKDTree | None = None,
                  tree2: cKDTree | None = None):
    """max of (fraction of pc1 within dis_thre of pc2, vice versa)
    (open3d compute_point_cloud_distance parity, mask_graph.py:839-845).
    Pass prebuilt ``tree1``/``tree2`` when calling over many pairs — the
    second-stage merge is O(n^2) pairs and would otherwise rebuild each
    cluster's KD-tree n times."""
    if len(pc1) == 0 or len(pc2) == 0:
        return 0.0
    # cheap AABB prefilter: disjoint boxes (beyond dis_thre) cannot overlap
    if (pc1.min(0) - pc2.max(0)).max() > dis_thre or \
       (pc2.min(0) - pc1.max(0)).max() > dis_thre:
        return 0.0
    # searches bounded at dis_thre (a point with no neighbour that close
    # gets inf): the same counts as unbounded nearest-neighbour distances,
    # without searching the whole tree for the far points of a wall-sized
    # cloud
    d12 = (tree2 or cKDTree(pc2)).query(pc1, k=1, distance_upper_bound=dis_thre)[0]
    d21 = (tree1 or cKDTree(pc1)).query(pc2, k=1, distance_upper_bound=dis_thre)[0]
    return float(max((d12 < dis_thre).mean(), (d21 < dis_thre).mean()))


def second_stage_mapping(
    pcs: dict, caps: dict, cols: dict, bg_feats: dict,
    cap_thre: float = 0.8, dis_thre: float = 0.02,
    weight_pc: float = 0.7, weight_caption: float = 0.7, weight_color: float = 0.7,
    forced_bg: dict | None = None,
    contact_pc: float = 0.0, contact_cap: float = 0.9, up_axis: int = 2,
    n_views: dict | None = None, bridge_min_views: int = 2,
):
    """compute_similarity_matrix_thre parity (mask_graph.py:820-895).
    ``forced_bg`` maps cluster_id -> reserved id (1/2/3), taking precedence
    over caption anchoring (used by the geometric bg path, classify_bg_hull).

    ``contact_pc`` > 0 enables a PART-OF tier beyond the reference: two
    clusters also merge when they are in contact (point-overlap above
    ``contact_pc`` — far below ``weight_pc``), their captions are
    near-identical (> ``contact_cap``, stricter than ``weight_caption``),
    their colors pass the usual gate, AND the smaller cluster's
    footprint (the two non-``up_axis`` extents) lies inside the larger's
    (5%-expanded). This is a weights-free stand-in for whole-object
    entity masks: a table's legs are separate per-frame components —
    their seam to the top is a genuine occlusion boundary from above —
    yet they are the same material and stand inside the top's footprint
    (measured: leg-top overlap 0.024, caption cos 1.0, vs sphere/torus
    resting ON the table at caption cos 0.667 — blocked by the caption
    gate; two same-colored objects side by side have disjoint footprints
    — blocked by containment). Known residual cost: a same-captioned
    object standing on and within a larger one (a brown cushion centered
    on a brown sofa) reads as a part — that call takes learned
    objectness (reference: CropFormer, mask_gen.py:231-367).

    Returns (mapping {cluster_id: final_id}, next_free_id)."""
    keys = list(pcs.keys())
    n = len(keys)
    pc_l = [pcs[k] for k in keys]
    cap_l = [caps[k] for k in keys]
    col_l = [cols[k] for k in keys]

    trees = [cKDTree(pc) if len(pc) else None for pc in pc_l]
    sim_pc = np.zeros((n, n))
    sim_cap = np.zeros((n, n))
    sim_col = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            sim_pc[i, j] = sim_pc[j, i] = overlap_ratio(
                pc_l[i], pc_l[j], dis_thre, tree1=trees[i], tree2=trees[j]
            )
            sim_cap[i, j] = sim_cap[j, i] = float(cap_l[i] @ cap_l[j])
            sim_col[i, j] = sim_col[j, i] = float(col_l[i] @ col_l[j])
    merge = (
        (sim_pc > weight_pc) & (sim_cap > weight_caption) & (sim_col > weight_color)
    ) | (sim_pc > 0.9)

    if contact_pc > 0:
        ax = [a for a in range(3) if a != up_axis]
        boxes = [
            (pc[:, ax].min(0), pc[:, ax].max(0)) if len(pc) else None
            for pc in pc_l
        ]

        def _contained(si, sj):
            """smaller-footprint cluster inside the larger's footprint
            (expanded by 5% of its extent per side)"""
            if boxes[si] is None or boxes[sj] is None:
                return False
            (lo_i, hi_i), (lo_j, hi_j) = boxes[si], boxes[sj]
            if np.prod(hi_i - lo_i) > np.prod(hi_j - lo_j):
                (lo_i, hi_i), (lo_j, hi_j) = (lo_j, hi_j), (lo_i, hi_i)
            pad = 0.05 * (hi_j - lo_j)
            return bool(np.all(lo_i >= lo_j - pad)
                        and np.all(hi_i <= hi_j + pad))

        for i in range(n):
            for j in range(i + 1, n):
                if (not merge[i, j] and sim_pc[i, j] > contact_pc
                        and sim_cap[i, j] > contact_cap
                        and sim_col[i, j] > weight_color
                        and _contained(i, j)):
                    merge[i, j] = merge[j, i] = True

    def _bg_id_of(i):
        if forced_bg and keys[i] in forced_bg:
            return forced_bg[keys[i]]
        for name, rid in RESERVED.items():
            if check_similarity(bg_feats.get(name), cap_l[i], cap_thre):
                return rid
        return None

    # pure function of the cluster index — evaluate once, not per pair
    bg_of = [_bg_id_of(i) for i in range(n)]

    # TRANSITIVE closure over the merge relation (deliberate deviation
    # from the reference, mask_graph.py:855-887, which assigns ids
    # pairwise in index order: when pair (i, j) merges but j already
    # holds an id from an earlier pair, the reference gives i a FRESH id
    # and the chain breaks. Measured failure: an orbit's front-half and
    # back-half clusters of one box, bridged by two top-face strip
    # clusters — chain 4~5, 5~7, 7~6 — came out as TWO objects, halving
    # that instance's mIoU in the touching-boxes stress archetype. The
    # merge gates are pairwise-symmetric, so connected components are
    # the only order-independent reading of them.) Background-anchored
    # clusters never participate — reserved ids must not absorb objects.
    #
    # BRIDGE GATE: clusters backed by fewer than ``bridge_min_views``
    # per-frame masks may ATTACH to a component but never act as a
    # bridge inside the closure. Measured failure (noise-tier tabletop,
    # sensor noise 1.0): mixed-pixel boundary slivers at the
    # sphere/torus contact formed 1-mask clusters whose small noisy
    # clouds overlapped BOTH parents above every gate (chain
    # sphere ~ sliver ~ torus, direct sphere-torus pc overlap 0.063 —
    # far below the 0.4 gate) and the closure welded two distinct
    # objects (torus mIoU 0.87 -> 0.00). Legit healing chains (temporal
    # split halves, top-face strips) are all multi-view and unaffected.
    parent = list(range(n))
    if n_views is None:
        core = [True] * n
    else:
        core = [n_views.get(keys[i], 1) >= bridge_min_views
                for i in range(n)]

    # APPEARANCE-TWIN tier (core-core, only when view counts are known):
    # sensor noise can split one object into temporal-half clusters whose
    # clouds are near-DISJOINT opposite-face slabs — no pc overlap, no
    # shared bridge, thin AABB intersection. What the halves DO share is
    # strong appearance: measured (noise-tier touching) cap 1.000 /
    # col 0.926 between one box's halves vs col <= 0.59 for every
    # cross-object core pair in two scenes. Adjacent-extent + twin
    # appearance merges them; the adjacency pad keeps identical objects
    # apart unless they touch (that case is the contact tier's
    # documented learned-objectness limit, shared by the reference).
    if n_views is not None:
        twin_col = max(weight_color, 0.8)
        for i in range(n):
            if not core[i]:
                continue
            for j in range(i + 1, n):
                if (core[j] and not merge[i, j]
                        and sim_cap[i, j] > contact_cap
                        and sim_col[i, j] > twin_col
                        and len(pc_l[i]) and len(pc_l[j])):
                    lo_i, hi_i = pc_l[i].min(0), pc_l[i].max(0)
                    lo_j, hi_j = pc_l[j].min(0), pc_l[j].max(0)
                    # adjacency in UNION units: for one object's halves
                    # the union envelope is object-sized and the
                    # inter-slab gap a fraction of it (measured 0.17 m
                    # gap in a 0.62 m box = 0.27), while two identical
                    # objects placed apart gap by >= their own size
                    # (clones: 0.42 with noise-fattened AABBs, 0.65
                    # geometric). Slab extents themselves shrink exactly
                    # when evidence is worst, so the gap is normalized
                    # by the union extent, per axis. 0.33 splits the
                    # measured 0.27 / 0.42.
                    union = np.maximum(hi_i, hi_j) - np.minimum(lo_i, lo_j)
                    gap = np.maximum(np.maximum(lo_j - hi_i, lo_i - hi_j),
                                     0.0)
                    if np.all(gap <= 0.33 * union):
                        merge[i, j] = merge[j, i] = True

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        if bg_of[i] is not None or not core[i]:
            continue
        for j in range(i + 1, n):
            if bg_of[j] is None and core[j] and merge[i, j]:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[rj] = ri

    # leaves: full closure among THEMSELVES (a fully fragmented object —
    # grazing thin boxes where every orbit view is its own 1-mask
    # cluster — heals into one component), then each leaf GROUP attaches
    # to at most ONE core component: the one holding its single
    # best-overlapping passing edge. A group touching two cores (the
    # tabletop sliver cloud between sphere and torus) goes to the better
    # side instead of welding them; a group with no core edge keeps its
    # own id — oversegmentation beats welding.
    for i in range(n):
        if core[i] or bg_of[i] is not None:
            continue
        for j in range(i + 1, n):
            if (not core[j] and bg_of[j] is None and merge[i, j]):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[rj] = ri
    group_cores: dict[int, list] = {}   # leaf-group root -> [(sim_pc, core j)]
    for i in range(n):
        if core[i] or bg_of[i] is not None:
            continue
        r = find(i)
        for j in range(n):
            if core[j] and bg_of[j] is None and merge[i, j]:
                group_cores.setdefault(r, []).append((sim_pc[i, j], j))
    aabb = [(pc.min(0), pc.max(0)) if len(pc) else None for pc in pc_l]

    def _aabb_touch(a, b, pad):
        if aabb[a] is None or aabb[b] is None:
            return False
        return bool(np.all(aabb[a][0] <= aabb[b][1] + pad)
                    and np.all(aabb[b][0] <= aabb[a][1] + pad))

    for r, edges in group_cores.items():
        _, hub = max(edges)
        rr, rh = find(r), find(hub)
        if rr != rh:
            parent[rr] = rh
        # BRIDGED WELD: the group reaches other core components too.
        # The bridge supplies the geometric continuity the cores lack
        # (temporal halves of one object have near-disjoint clouds), so
        # the cores themselves must supply the appearance evidence:
        # near-identical captions AND colors AND interleaved extents.
        # Measured separation (noise tier): one box's halves cap 1.000 /
        # col 0.926 / AABBs interpenetrating vs sphere-torus through a
        # boundary sliver cap 0.667 / col 0.590 and every other
        # cross-object core pair col <= 0.51.
        for _, j in edges:
            rj = find(j)
            if (rj != find(hub)
                    and sim_cap[hub, j] > contact_cap
                    and sim_col[hub, j] > weight_color
                    and _aabb_touch(hub, j, dis_thre)):
                parent[rj] = find(hub)

    mapping: dict[int, int] = {}
    counter = 4
    root_id: dict[int, int] = {}
    for i in range(n):
        if bg_of[i] is not None:
            mapping[keys[i]] = bg_of[i]
            continue
        r = find(i)
        if r not in root_id:
            root_id[r] = counter
            counter += 1
        mapping[keys[i]] = root_id[r]
    mapping[JUNK_ID] = 0
    return mapping, counter


def write_artifacts(
    output_dir: str,
    frame_masks: list[list[np.ndarray]],     # filtered masks per frame
    frame_final_ids: list[list[int]],        # final global id per mask
    frame_clipft: list[list[np.ndarray]],
    frame_capft: list[list[np.ndarray]],
    frame_caps: list[list[str]],
    image_hw: tuple[int, int],
    inst_images: list[np.ndarray] | None = None,
):
    """Write the reference data contracts (mask_graph.py:1240-1280):
    class_our/semantic_class_<i>.png and instance_our/semantic_instance_<i>.png
    (identical int32 id images) + object_{clipfeat,capfeat,caption}.pkl
    (per-frame {global_id: feature}).

    ``inst_images``: pre-built per-frame id images (e.g. the pipeline's
    reprojection-HEALED maps, perception.healing) used verbatim instead
    of rebuilding from masks; the per-frame feature dicts still come
    from the masks/ids."""
    from openobj_torch.utils.png import write_png

    h, w = image_hw
    top = max((max(ids) for ids in frame_final_ids if ids), default=0)
    if top > 65535:
        raise ValueError(
            f"final id {top} exceeds the uint16 PNG id range — the "
            "instance/class images would silently alias small ids"
        )
    dir_class = os.path.join(output_dir, "class_our")
    dir_inst = os.path.join(output_dir, "instance_our")
    os.makedirs(dir_class, exist_ok=True)
    os.makedirs(dir_inst, exist_ok=True)
    all_clip, all_cap, all_caption = [], [], []
    for i, (masks, ids) in enumerate(zip(frame_masks, frame_final_ids)):
        if inst_images is not None:
            inst_img = np.asarray(inst_images[i], np.int32)
        else:
            inst_img = np.zeros((h, w), np.int32)
        clip_d, capft_d, cap_d = {}, {}, {}
        for j, (mask, gid) in enumerate(zip(masks, ids)):
            if gid != 0:
                if inst_images is None:
                    inst_img[mask] = gid
                clip_d[gid] = frame_clipft[i][j]
                capft_d[gid] = frame_capft[i][j]
                cap_d[gid] = frame_caps[i][j]
        write_png(os.path.join(dir_class, f"semantic_class_{i}.png"),
                  inst_img.astype(np.uint16))
        write_png(os.path.join(dir_inst, f"semantic_instance_{i}.png"),
                  inst_img.astype(np.uint16))
        all_clip.append(clip_d)
        all_cap.append(capft_d)
        all_caption.append(cap_d)
    for name, data in (
        ("object_clipfeat.pkl", all_clip),
        ("object_capfeat.pkl", all_cap),
        ("object_caption.pkl", all_caption),
    ):
        with open(os.path.join(output_dir, name), "wb") as f:
            pickle.dump(data, f)


def write_cluster_overlays(
    out_dir: str,
    frame_masks: list[list[np.ndarray]],
    frame_ids: list[list[int]],
    image_hw: tuple[int, int],
    skip_id: int = 0,
    seed: int = 0,
):
    """Color-coded association overlays — the reference's cross-view QA
    artifact (mask_graph.py:1204-1238 writes before/ and after/ trees of
    inst_<i>.png, each mask painted with its cluster's random color; the
    pre-merge pass skips junk 999, the post-merge pass skips bg 0).

    One call writes one tree; the CLI calls it twice with
    (cluster_ids, skip_id=JUNK_ID) and (final_ids, skip_id=0)."""
    from openobj_torch.utils.png import write_png
    from openobj_torch.viz.colors import distinct_colors

    os.makedirs(out_dir, exist_ok=True)
    top = max((max(ids) for ids in frame_ids if ids), default=0)
    palette = distinct_colors(top + 1, seed=seed)   # [n, 3] uint8
    h, w = image_hw
    for i, (masks, ids) in enumerate(zip(frame_masks, frame_ids)):
        img = np.zeros((h, w, 3), np.uint8)
        for mask, cid in zip(masks, ids):
            if cid != skip_id:
                img[mask] = palette[cid % len(palette)]
        write_png(os.path.join(out_dir, f"inst_{i}.png"), img)

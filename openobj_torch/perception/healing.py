"""Reprojection healing: the global 3D map fixes per-frame 2D label misses.

Port of ``openobj_tpu.perception.healing`` (numpy).

Deliberate capability BEYOND the reference (mask_graph.py:1240-1264 writes
each frame's instance image purely from that frame's own masks): once
association has built per-object global point clouds, a frame where an
object's 2D mask went missing is detectable and fixable — project the
object's merged world points into the frame and claim the pixels whose
measured depth agrees with the projected point depth.

Why this matters (measured on the noise-tier perception matrix,
scripts/perception_matrix.py --noise 1.0): the weak rows' losses are
concentrated in a FEW frames per object where the per-frame segmenter
dropped or swallowed the object entirely —

  * tabletop: the 26-80 px box/torus absorbed into the table's mask in 2
    frames each (contact + z²-scaled depth noise bury the rim edge), and
    unlabeled in the 2 grazing end frames;
  * textured: the checker box fully unlabeled in 4 of 20 frames;
  * clones: one clone unlabeled in 3 of 20 frames.

Every one of those objects has solid 3D evidence from the OTHER frames.
The reference, with no global geometry feedback into its 2D output,
cannot recover these; a mapping system that already paid for the fused
point cloud can.

Safety rules (clean rows must not regress):
  * a pixel is claimed only with >= ``min_support`` projected points
    whose depth matches the pixel's measured depth within a
    noise-adaptive tolerance (occluded points never match — they are
    BEHIND the measured surface by more than the tolerance);
  * a pixel with an existing label is re-claimed only when the claimant's
    depth-consistent support BEATS the incumbent's by ``majority`` (2x by
    default) — not merely "incumbent has none", because a swallow frame
    contaminates the swallowing object's global cloud with the victim's
    surface points (measured: the tabletop table cloud carries torus
    points from the 2 frames whose torus mask it absorbed, so the
    incumbent shows weak support exactly where healing is needed; the
    victim's own 16-frame evidence out-votes it);
  * claims are restricted to the claimant's dilated projected footprint;
    no morphology ever grows labels beyond measured-depth agreement.
"""

from __future__ import annotations

import numpy as np


def _support_map(points_w, t_wc, depth, fx, fy, cx, cy, tol,
                 weights=None):
    """Per-pixel EVIDENCE WEIGHT of world points that project into the
    frame AND agree with its measured depth within ``tol`` meters.
    [H, W] float32. ``weights`` (default 1/point) carries how many raw
    observations each (voxel-downsampled) point represents — an object
    seen at a spot across 16 frames out-votes a cloud contaminated there
    by a 2-frame swallow, even though both have one point per voxel."""
    h, w = depth.shape
    if points_w is None or len(points_w) == 0:
        return np.zeros((h, w), np.float32)
    r_cw = t_wc[:3, :3].T
    t = t_wc[:3, 3]
    pc = (points_w - t) @ r_cw.T
    z = pc[:, 2]
    front = z > 1e-6
    pc = pc[front]
    z = z[front]
    wt = (np.ones(len(z), np.float32) if weights is None
          else np.asarray(weights, np.float32)[front])
    u = np.rint(pc[:, 0] / z * fx + cx).astype(np.int64)
    v = np.rint(pc[:, 1] / z * fy + cy).astype(np.int64)
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    u, v, z, wt = u[ok], v[ok], z[ok], wt[ok]
    if not len(u):
        return np.zeros((h, w), np.float32)
    d = depth[v, u]
    err = np.abs(d - z)
    hit = (d > 0) & (err <= tol)
    # depth-proximity weighting inside the window: the surface actually AT
    # the pixel matches at ~0 error; a nearby surface bleeding in through
    # the tolerance (e.g. the table under a torus rim, 2-4 cm off) decays.
    # sigma = tol/2 keeps a hard-edge-equivalent acceptance while making
    # contested pixels a proximity vote instead of a coin flip.
    prox = np.exp(-0.5 * (err / max(tol / 2.0, 1e-6)) ** 2)
    sup = np.zeros((h, w), np.float32)
    np.add.at(sup, (v[hit], u[hit]), (wt * prox)[hit])
    return sup


def weighted_voxel_clouds(raw_points: dict[int, list],
                          voxel: float = 0.01):
    """{gid: [per-mask raw [N,3] arrays]} -> {gid: (mean-point-per-voxel
    [M,3], raw-observation count per voxel [M])}. The counts are the
    healing support weights (see _support_map)."""
    out = {}
    for g, ps in raw_points.items():
        pts = np.concatenate(ps).astype(np.float64)
        if not len(pts):
            continue
        vox = np.floor(pts / voxel).astype(np.int64)
        uniq, inv, cnt = np.unique(vox, axis=0, return_inverse=True,
                                   return_counts=True)
        sums = np.zeros((len(uniq), 3))
        np.add.at(sums, inv, pts)
        out[g] = (sums / cnt[:, None], cnt.astype(np.float32))
    return out


def _dilate(mask: np.ndarray, it: int) -> np.ndarray:
    """Binary dilation with a 3x3 box, ``it`` iterations (no scipy dep in
    the hot path — a shift-OR is plenty at these sizes)."""
    m = mask.copy()
    for _ in range(it):
        p = np.pad(m, 1)
        m = (
            p[:-2, :-2] | p[:-2, 1:-1] | p[:-2, 2:]
            | p[1:-1, :-2] | p[1:-1, 1:-1] | p[1:-1, 2:]
            | p[2:, :-2] | p[2:, 1:-1] | p[2:, 2:]
        )
    return m


def clouds_from_labels(
    inst_images: list[np.ndarray],
    depths: list[np.ndarray],
    poses: list[np.ndarray],
    fx: float, fy: float, cx: float, cy: float,
    voxel: float = 0.01,
    min_id: int = 1,
) -> dict[int, np.ndarray]:
    """Rebuild per-id world point clouds by backprojecting every labeled
    pixel of every frame. Used between healing iterations: the first
    heal's output labels are cleaner than the association masks (a
    swallow frame's stolen pixels have moved back to their true object),
    so clouds rebuilt from them shed the cross-object contamination that
    capped the first pass (see heal_instance_images docstring)."""
    from openobj_torch.utils.geometry import voxel_downsample

    acc: dict[int, list] = {}
    for img, depth, t_wc in zip(inst_images, depths, poses):
        v, u = np.nonzero((img >= min_id) & (depth > 0))
        if not len(v):
            continue
        z = depth[v, u]
        pc = np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], -1)
        pw = pc @ t_wc[:3, :3].T + t_wc[:3, 3]
        gids = img[v, u]
        for g in np.unique(gids):
            acc.setdefault(int(g), []).append(pw[gids == g])
    return {
        g: voxel_downsample(np.concatenate(ps).astype(np.float64), voxel)
        for g, ps in acc.items()
    }


def heal_instance_images(
    inst_images: list[np.ndarray],       # [H, W] int32, modified copies returned
    object_points: dict,                 # gid -> [N,3] pts or (pts, weights)
    depths: list[np.ndarray],
    poses: list[np.ndarray],             # [4, 4] T_WC per frame
    fx: float, fy: float, cx: float, cy: float,
    noise_sigma: float = 0.0,
    min_support: int = 2,
    base_tol: float = 0.02,
    dilate_px: int = 1,
    majority: float = 2.0,
    reserved_bg=(1, 2, 3),
) -> tuple[list[np.ndarray], dict]:
    """Heal every frame's instance image with global-map reprojection.

    ``object_points`` should contain the FOREGROUND objects (gid >= 4 in
    the reference id scheme) — reserved bg ids in the dict are used as
    incumbents only, never as claimants (walls/floors are huge; their
    labels don't need healing and aggressive wall claims could eat
    silhouettes). Returns (healed images, stats)."""
    tol = max(base_tol, 6.0 * noise_sigma)
    fg_ids = sorted(g for g in object_points if g not in reserved_bg)
    stats = {"tol": tol, "claimed_px": 0, "relabeled_px": 0, "frames": 0}

    def _pts_w(entry):
        return entry if isinstance(entry, tuple) else (entry, None)

    healed = []
    for img, depth, t_wc in zip(inst_images, depths, poses):
        sup = {}
        for gid in fg_ids:
            pts, wts = _pts_w(object_points[gid])
            s = _support_map(pts, t_wc, depth,
                             fx, fy, cx, cy, tol, weights=wts)
            if s.any():
                sup[gid] = s
        if not sup:
            healed.append(img)
            continue
        out = img.copy()
        ids = list(sup)
        stack = np.stack([sup[g] for g in ids])          # [G, H, W]
        best = np.argmax(stack, axis=0)                   # [H, W]
        best_sup = np.take_along_axis(stack, best[None], 0)[0]
        best_gid = np.asarray(ids, np.int32)[best]
        # incumbent support at each pixel (0 when the incumbent has no
        # cloud or the pixel is unlabeled/background)
        inc_sup = np.zeros(img.shape, np.float32)
        for gid in ids:
            m = img == gid
            if m.any():
                inc_sup[m] = sup[gid][m]
        # also treat reserved bg incumbents as zero-support UNLESS their
        # cloud actually backs the pixel
        for gid in reserved_bg:
            if gid in object_points:
                m = img == gid
                if m.any():
                    pts, wts = _pts_w(object_points[gid])
                    s = _support_map(pts, t_wc, depth,
                                     fx, fy, cx, cy, tol, weights=wts)
                    inc_sup[m] = s[m]
        beats = (best_sup >= min_support) \
            & (best_sup >= majority * inc_sup)
        claim = beats & (best_gid != img)
        if dilate_px:
            # a claim may extend into the claimant's OWN dilated footprint
            # (per gid — dilating the union would let object B claim
            # pixels adjacent only to object A's beat region), still only
            # onto pixels whose own depth agrees (>= 1 supporting point)
            # and where the incumbent has nothing
            for gid in ids:
                mine = beats & (best_gid == gid)
                if not mine.any():
                    continue
                foot = _dilate(mine, dilate_px)
                claim |= foot & (best_gid == gid) & (best_sup >= 1) \
                    & (inc_sup == 0) & (best_gid != img)
        relabeled = claim & (img != 0)
        out[claim] = best_gid[claim]
        stats["claimed_px"] += int(claim.sum())
        stats["relabeled_px"] += int(relabeled.sum())
        stats["frames"] += int(claim.any())
        healed.append(out)
    return healed, stats

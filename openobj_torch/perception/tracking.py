"""Online (live-mode) instance tracking.

The reference carries a live-stream path that maintains a dict of 3D object
boxes and filters/merges per-frame detections against them
(objnerf/utils.py:125-271 ``InstData`` / ``box_filter``;
its ROS entry is a commented stub, train.py:88-100). This module is that
capability as a first-class component: when no offline association
artifacts exist, ``OnlineInstanceTracker`` turns per-frame (mask, candidate
id) detections into a temporally-consistent instance image the SceneMapper
can ingest directly.

Per detection (box_filter semantics):
  * backproject the masked depth; <= min_points 3D points -> background;
  * KNOWN id: points inside the tracked oriented box are merged into its
    point cloud (voxel-downsampled) and the box is refit + rescaled;
    pixels whose points fall OUTSIDE the box -> -1 (unsure); zero inliers
    -> the whole mask is unsure this frame;
  * NEW id: the mask is eroded (mask borders have unreliable depth), too
    few pixels -> background, else a new tracked box is created;
  * OBB fit failures -> the detection is skipped for this frame (the
    reference's Qhull-failure path).

Port of ``openobj_tpu.perception.tracking`` (host numpy). The JAX package
erodes new masks with OpenCV where it is installed; the port erodes with
``scipy.ndimage`` as OpenCV does, the image border never eroding.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy import ndimage

from openobj_torch.utils.geometry import (
    OrientedBox, backproject_depth, oriented_bounds,
)


def _erode(mask: np.ndarray, size: int = 5, iterations: int = 3) -> np.ndarray:
    """``cv2.erode`` with a size x size box, ``iterations`` times: pixels
    beyond the image count as set, so the border never erodes."""
    return ndimage.binary_erosion(
        mask, structure=np.ones((size, size), bool), iterations=iterations,
        border_value=1,
    )


def _points_inside(box: OrientedBox, points: np.ndarray) -> np.ndarray:
    local = (points - box.center) @ box.r
    return np.all(np.abs(local) <= box.extent / 2.0 + 1e-9, axis=1)


@dataclass
class TrackedInstance:
    inst_id: int
    box: OrientedBox
    points: np.ndarray
    class_id: int | None = None
    merge_cnt: int = 0
    cmp_cnt: int = 0


@dataclass
class OnlineInstanceTracker:
    fx: float
    fy: float
    cx: float
    cy: float
    min_pixels: int = 500
    min_points: int = 10
    voxel_size: float = 0.01
    bbox_scale: float = 1.0
    # new-object mask erosion (mask borders have unreliable depth,
    # utils.py:246-249); the defaults assume full-res frames — scale down
    # for small images or the erosion eats whole objects
    erode_size: int = 5
    erode_iters: int = 3
    instances: dict[int, TrackedInstance] = field(default_factory=dict)

    def ingest(
        self,
        masks: list[np.ndarray],       # [H, W] bool per detection
        ids: list[int],                # candidate instance id per detection
        depth: np.ndarray,             # [H, W] meters (0 = invalid)
        t_wc: np.ndarray,              # [4, 4]
        classes: list[int] | None = None,
    ) -> np.ndarray:
        """One frame of detections -> instance image ([H, W] int32:
        0 background, -1 unsure, else instance id)."""
        from openobj_torch import native

        inst_img = np.zeros_like(depth, dtype=np.int32)
        for k, (mask, inst_id) in enumerate(zip(masks, ids)):
            if inst_id == 0:
                continue
            pts = backproject_depth(
                np.where(mask, depth, 0.0), self.fx, self.fy, self.cx,
                self.cy, t_wc,
            )
            if len(pts) <= self.min_points:
                continue  # too small in 3D -> background (utils.py:175-177)
            diff_mask = None
            if inst_id in self.instances:
                tr = self.instances[inst_id]
                tr.cmp_cnt += 1
                inside = _points_inside(tr.box, pts)
                if not inside.any():
                    inst_img[mask] = -1   # unsure this frame (utils.py:225)
                    continue
                merged = np.concatenate([tr.points, pts[inside]])
                tr.points = native.voxel_downsample(merged, self.voxel_size)
                try:
                    box = oriented_bounds(tr.points)
                except Exception:
                    inst_img[mask] = -1
                    continue
                tr.box = OrientedBox(
                    center=box.center, r=box.r,
                    extent=box.extent * self.bbox_scale,
                )
                tr.merge_cnt += 1
                # pixels with depth whose points fall outside the box
                valid = mask & (depth > 0)
                out_pix = np.zeros_like(mask)
                out_pix[valid] = ~inside
                diff_mask = out_pix
            else:
                small = _erode(mask, self.erode_size, self.erode_iters)
                if small.sum() < self.min_pixels:
                    continue  # background (utils.py:251-255)
                pts_s = backproject_depth(
                    np.where(small, depth, 0.0), self.fx, self.fy, self.cx,
                    self.cy, t_wc,
                )
                if len(pts_s) <= self.min_points:
                    continue
                pts_s = native.voxel_downsample(pts_s, self.voxel_size)
                try:
                    box = oriented_bounds(pts_s)
                except Exception:
                    continue  # Qhull-failure path (utils.py:262-266)
                self.instances[inst_id] = TrackedInstance(
                    inst_id=inst_id,
                    box=OrientedBox(
                        center=box.center, r=box.r,
                        extent=box.extent * self.bbox_scale,
                    ),
                    points=pts_s,
                    class_id=classes[k] if classes is not None else None,
                )
            inst_img[mask] = inst_id
            if diff_mask is not None:
                inst_img[diff_mask] = -1
        return inst_img

    def propose_ids(
        self,
        masks: list[np.ndarray],
        depth: np.ndarray,
        t_wc: np.ndarray,
        match_frac: float = 0.3,
        bg_test=None,
    ) -> list[int]:
        """Candidate instance ids for RAW (tracker-less) detections — the
        piece the reference's live path left to an external detector.

        Each mask's 3D points are tested against every tracked box; the
        box containing the largest fraction (>= ``match_frac``) claims the
        mask, each tracked id claiming at most one mask per frame (largest
        overlap wins). Unmatched masks get fresh ids from 4 upward (1-3
        are the reserved bg ids). ``bg_test(points) -> bool`` (e.g. a
        merge.classify_bg_hull closure) routes background surfaces to id
        0, which ``ingest`` skips — the SceneMapper's bg convention."""
        props: list[tuple[int, float, int | None]] = []  # (k, frac, iid)
        pts_per_mask: list[np.ndarray | None] = []
        for mask in masks:
            pts = backproject_depth(
                np.where(mask, depth, 0.0), self.fx, self.fy, self.cx,
                self.cy, t_wc,
            )
            pts_per_mask.append(pts if len(pts) > self.min_points else None)
        ids = [0] * len(masks)
        for k, pts in enumerate(pts_per_mask):
            if pts is None:
                continue
            if bg_test is not None and bg_test(pts):
                continue                      # stays 0 -> background
            best_frac, best_id = 0.0, None
            for iid, tr in self.instances.items():
                frac = float(_points_inside(tr.box, pts).mean())
                if frac > best_frac:
                    best_frac, best_id = frac, iid
            props.append((k, best_frac, best_id))
        # greedy assignment, strongest overlap first; one mask per id
        taken: set[int] = set()
        fresh = max(self.instances, default=3) + 1
        fresh = max(fresh, 4)
        for k, frac, iid in sorted(props, key=lambda t: -t[1]):
            if iid is not None and frac >= match_frac and iid not in taken:
                ids[k] = iid
                taken.add(iid)
            else:
                ids[k] = fresh
                fresh += 1
        return ids

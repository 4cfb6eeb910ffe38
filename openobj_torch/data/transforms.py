"""Host-side frame preprocessing shared by all dataset loaders.

A copy of ``openobj_tpu.data.transforms`` (numpy only), without the
undistortion maps, which the JAX package computes with OpenCV: the port
needs them only in its dataset loaders, which are not ported yet.

Parity targets:
  * depth scaling + max-depth clamp-to-zero
    (reference image_transforms.py:13-33, dataset.py:86);
  * per-instance 2D bboxes from the instance map with x1.2 enlargement and
    a 10-px minimum side (reference utils.py:64-121, dataset.py:140-158);
  * background (instance 0) gets the full-frame bbox (dataset.py:172-175).

Bboxes are (r0, r1, c0, c1), half-open, rows=v, cols=u — the transpose of
the reference's [w_low, w_high, h_low, h_high] convention (we keep images
[H, W] instead of the reference's [W, H]).
"""

from __future__ import annotations

import numpy as np


def scale_depth(depth: np.ndarray, depth_scale: float, max_depth: float) -> np.ndarray:
    """uint16 millimeter depth -> float32 meters, with >max_depth zeroed
    (invalid), matching image_transforms.py:13-33."""
    d = depth.astype(np.float32) * depth_scale
    d[d > max_depth] = 0.0
    return d


def enlarge_bbox(bbox, scale: float, h: int, w: int):
    """Scale a (r0, r1, c0, c1) half-open bbox about its center by ``scale``,
    clipped to the image (reference utils.py:64-88)."""
    r0, r1, c0, c1 = bbox
    rc, cc = (r0 + r1) / 2.0, (c0 + c1) / 2.0
    rh, ch = (r1 - r0) * scale / 2.0, (c1 - c0) * scale / 2.0
    return (
        int(max(0, np.floor(rc - rh))),
        int(min(h, np.ceil(rc + rh))),
        int(max(0, np.floor(cc - ch))),
        int(min(w, np.ceil(cc + ch))),
    )


def instance_bboxes(
    inst: np.ndarray,
    enlarge: float = 1.2,
    min_side: int = 10,
    bg_id: int = 0,
) -> dict[int, tuple[int, int, int, int]]:
    """One pass over the instance map -> {instance_id: bbox}.

    Drops instances whose raw bbox has a side < min_side px
    (reference dataset.py:147) and the unknown id -1; the background id gets
    the full frame (dataset.py:172-175). Bboxes for objects are enlarged
    x``enlarge`` (dataset.py:140-158).
    """
    h, w = inst.shape
    ids, inv = np.unique(inst, return_inverse=True)
    inv = inv.reshape(h, w)
    n = len(ids)
    r0 = np.full(n, h, np.int64)
    r1 = np.full(n, -1, np.int64)
    c0 = np.full(n, w, np.int64)
    c1 = np.full(n, -1, np.int64)
    rows = np.broadcast_to(np.arange(h)[:, None], (h, w))
    cols = np.broadcast_to(np.arange(w)[None, :], (h, w))
    np.minimum.at(r0, inv, rows)
    np.maximum.at(r1, inv, rows)
    np.minimum.at(c0, inv, cols)
    np.maximum.at(c1, inv, cols)

    out: dict[int, tuple[int, int, int, int]] = {}
    for k, oid in enumerate(ids):
        oid = int(oid)
        if oid == -1:
            continue
        if oid == bg_id:
            out[oid] = (0, h, 0, w)
            continue
        bb = (int(r0[k]), int(r1[k]) + 1, int(c0[k]), int(c1[k]) + 1)
        # <= : same boundary as process_instance_frame / the reference's
        # 'w <= 10: continue' (dataset.py:147) — an exactly-10-px object is
        # dropped by BOTH ingestion paths, not just the loader's
        if (bb[1] - bb[0]) <= min_side or (bb[3] - bb[2]) <= min_side:
            continue
        out[oid] = enlarge_bbox(bb, enlarge, h, w)
    return out

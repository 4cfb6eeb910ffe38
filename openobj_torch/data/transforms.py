"""Host-side frame preprocessing shared by all dataset loaders.

Port of ``openobj_tpu.data.transforms`` (numpy only). Where the JAX
package calls OpenCV, the port computes the same thing in numpy: the
undistortion maps in closed form (``cv2.initUndistortRectifyMap``'s
8-coefficient rational model), the remap as a gather (``cv2.remap``,
nearest or bilinear, constant-0 border) and the loaders' resizes
(``cv2.resize``, nearest and bilinear).

Parity targets:
  * depth scaling + max-depth clamp-to-zero
    (reference image_transforms.py:13-33, dataset.py:86);
  * fisheye/radial undistortion maps from the config's 8-coefficient
    distortion array [k1, k2, p1, p2, k3, k4, k5, k6]
    (reference image_transforms.py:36-59, cfg.py:52-63 — the reference
    parses the array and ships the Undistort transform but never wires it
    into its offline loaders; here it IS applied when configured);
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


def undistort_maps(
    w: int, h: int, fx: float, fy: float, cx: float, cy: float,
    distortion,
):
    """Pixel remap tables for the reference's 8-coefficient model
    [k1, k2, p1, p2, k3, k4, k5, k6] (image_transforms.py:44-56). Returns
    (map_x, map_y) float32 [H, W]: for every output pixel, where to sample
    the distorted image. ``cv2.initUndistortRectifyMap`` with no
    rectification and the same camera matrix, in float64, cast once."""
    k1, k2, p1, p2, k3, k4, k5, k6 = (
        [float(c) for c in np.asarray(distortion, np.float64).ravel()] + [0.0] * 8)[:8]
    x, y = np.meshgrid((np.arange(w, dtype=np.float64) - cx) / fx,
                       (np.arange(h, dtype=np.float64) - cy) / fy)
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2.0 * x * y
    kr = (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1.0 + ((k6 * r2 + k5) * r2 + k4) * r2)
    map_x = fx * (x * kr + p1 * xy2 + p2 * (r2 + 2.0 * x2)) + cx
    map_y = fy * (y * kr + p1 * (r2 + 2.0 * y2) + p2 * xy2) + cy
    return map_x.astype(np.float32), map_y.astype(np.float32)


def remap(im: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          nearest: bool = False) -> np.ndarray:
    """``cv2.remap`` with a constant-0 border: output pixel (v, u) samples
    ``im`` at (map_y[v, u], map_x[v, u]). Nearest rounds half to even;
    bilinear weights the four neighbours in float32 (a neighbour outside
    the image counts as 0) and rounds integer images to nearest."""
    h, w = im.shape[:2]
    out_shape = map_x.shape + im.shape[2:]

    def gather(xs, ys, dtype):
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        v = np.zeros(out_shape, dtype)
        v[ok] = im[ys[ok], xs[ok]]
        return v

    if nearest:
        return gather(np.rint(map_x).astype(np.int64), np.rint(map_y).astype(np.int64),
                      im.dtype)
    x0 = np.floor(map_x)
    y0 = np.floor(map_y)
    fx = (map_x - x0).astype(np.float32)
    fy = (map_y - y0).astype(np.float32)
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    one = np.float32(1.0)
    acc = np.zeros(out_shape, np.float32)
    for dy, wy in ((0, one - fy), (1, fy)):
        for dx, wx in ((0, one - fx), (1, fx)):
            wgt = wy * wx
            acc += gather(x0 + dx, y0 + dy, np.float32) * (
                wgt[..., None] if im.ndim == 3 else wgt)
    if np.issubdtype(im.dtype, np.integer):
        info = np.iinfo(im.dtype)
        return np.clip(np.rint(acc), info.min, info.max).astype(im.dtype)
    return acc.astype(im.dtype)


def undistort(im: np.ndarray, maps, nearest: bool = False) -> np.ndarray:
    """Apply precomputed undistortion maps (image_transforms.py:57-59).
    Use nearest=True for depth/instance images so invalid zeros and ids are
    never blended."""
    return remap(im, maps[0], maps[1], nearest=nearest)


def _linear_taps(n_out: int, n_in: int):
    """Source taps and weights of ``cv2.resize``'s bilinear interpolation
    along one axis: half-pixel centres, the fraction in float64 cast to
    float32, clamped at both edges."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    lo = s < 0
    f[lo], s[lo] = 0.0, 0
    hi = s >= n_in - 1
    f[hi], s[hi] = 0.0, n_in - 1
    return s, np.minimum(s + 1, n_in - 1), (1.0 - f).astype(np.float32), f.astype(np.float32)


def resize(im: np.ndarray, size: tuple[int, int], nearest: bool = False) -> np.ndarray:
    """``cv2.resize(im, (w, h))`` for ``size`` = (w, h), INTER_NEAREST or
    INTER_LINEAR. Nearest takes source index floor(i * (1 / (out / in)))
    as OpenCV does (bit for bit); bilinear interpolates rows, then
    columns, in float32, and rounds integer images to nearest (OpenCV's
    fixed-point 8-bit path can differ by one level)."""
    ow, oh = size
    h, w = im.shape[:2]
    if nearest:
        sx = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))).astype(np.int64), w - 1)
        sy = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))).astype(np.int64), h - 1)
        return im[sy][:, sx]
    x0, x1, ax0, ax1 = _linear_taps(ow, w)
    y0, y1, ay0, ay1 = _linear_taps(oh, h)
    a = im.astype(np.float32)
    tail = (None,) * (a.ndim - 2)
    t = a[:, x0] * ax0[(None, slice(None)) + tail] + a[:, x1] * ax1[(None, slice(None)) + tail]
    out = t[y0] * ay0[(slice(None), None) + tail] + t[y1] * ay1[(slice(None), None) + tail]
    if np.issubdtype(im.dtype, np.integer):
        info = np.iinfo(im.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(im.dtype)
    return out.astype(im.dtype)


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

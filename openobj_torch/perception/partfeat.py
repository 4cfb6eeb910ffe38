"""Part-level per-pixel CLIP feature maps.

Parity with partlevel/sam_clip_dir.py:
  * per SAM mask: bbox enlarged x1.3 clipped to the image (:42-59);
  * CLIP crop features assigned to the mask's pixels at 1/down resolution
    (:113-126). The reference computes a stability-score weight sum but
    never divides — the effective behavior is stability-scaled
    LAST-WRITER-WINS per pixel; we reproduce that (later masks overwrite);
  * saved as (H/down, W/down, C) .npy (:133).

Port of ``openobj_tpu.perception.partfeat``. The map is painted on a torch
device (the card unless the caller asks for the CPU): the down-sampled
masks are stacked, each pixel takes the last mask that covers it, and the
rows of feature x score (both float32) are gathered; that is exact, so the
map equals the JAX package's numpy loop (``build_part_feature_map_plain``)
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def enlarge_bbox_xyxy(bbox, scale: float, h: int, w: int):
    """(r0, c0, r1, c1) enlarged about center, clipped (sam_clip_dir.py:42-59)."""
    r0, c0, r1, c1 = bbox
    rc, cc = (r0 + r1) / 2, (c0 + c1) / 2
    rh, ch = (r1 - r0) * scale / 2, (c1 - c0) * scale / 2
    return (
        int(max(0, rc - rh)), int(max(0, cc - ch)),
        int(min(h, rc + rh)), int(min(w, cc + ch)),
    )


def build_part_feature_map(
    masks: list[np.ndarray],            # [H, W] bool, in SAM output order
    features: list[np.ndarray],         # [C] CLIP feature per mask
    stability_scores: list[float] | None = None,
    down: int = 5,
    device="cuda",
) -> np.ndarray:
    """(H/down, W/down, C) float32 map; later masks overwrite earlier ones
    at shared pixels, each scaled by its stability score
    (sam_clip_dir.py:113-126). Painted on ``device``, returned as numpy."""
    if not masks:
        raise ValueError("no masks")
    h, w = masks[0].shape
    hd, wd = h // down, w // down
    if stability_scores is None:
        stability_scores = [1.0] * len(masks)
    md = np.stack([m[: hd * down : down, : wd * down : down] for m in masks])
    md = torch.as_tensor(md, device=device)                        # [N, hd, wd]
    feats = torch.as_tensor(np.stack([np.asarray(f, np.float32) for f in features]),
                            device=device)
    scores = torch.as_tensor(np.asarray(stability_scores, np.float32), device=device)
    # row 0 = no mask; row i + 1 = mask i's feature x score
    table = torch.cat([feats.new_zeros(1, feats.shape[1]), feats * scores[:, None]])
    order = torch.arange(1, len(masks) + 1, device=device, dtype=torch.int64)
    last = (md.to(torch.int64) * order[:, None, None]).amax(0)    # [hd, wd]
    return table[last].cpu().numpy()


def build_part_feature_map_plain(
    masks: list[np.ndarray],
    features: list[np.ndarray],
    stability_scores: list[float] | None = None,
    down: int = 5,
) -> np.ndarray:
    """The plain version of ``build_part_feature_map``: the JAX package's
    numpy loop, one mask painted over the map at a time."""
    if not masks:
        raise ValueError("no masks")
    h, w = masks[0].shape
    c = len(features[0])
    hd, wd = h // down, w // down
    out = np.zeros((hd, wd, c), np.float32)
    if stability_scores is None:
        stability_scores = [1.0] * len(masks)
    for mask, feat, s in zip(masks, features, stability_scores):
        md = mask[: hd * down : down, : wd * down : down]
        out[md] = np.asarray(feat, np.float32) * float(s)
    return out


def save_part_features(path: str, pf: np.ndarray):
    np.save(path, pf)

"""Per-frame mask generation: segmentation -> captions -> features.

The reference's stage-1 program (maskclustering/mask_gen.py)
runs three sequential model passes over every frame — CropFormer entity
masks, TAP box-prompted captions (spaCy subject + SBERT), CLIP crop
features — and writes ``mask_init_all.pkl``. The models are third-party
pretrained networks; here they are injected callables, and everything the
reference does AROUND them is first-party:

  * score filter >= score_thresh (mask_gen.py:107-110,284-287);
  * rank-ordered mask-id image: masks painted largest-score-last so later
    (higher-score) masks overwrite earlier ones (:291-295), then re-read
    per id so overlaps resolve to the winner;
  * drop masks < min_px pixels (:320-322);
  * multi-component splitting via connected components + DBSCAN regrouping
    (encoders.split_mask, :139-209,325-338);
  * per-mask bboxes (:125-137);
  * caption -> leading-noun-chunk subject (encoders.caption_subject,
    :429-440) -> normalized SBERT 384-d;
  * 20 px-padded bbox crops -> normalized CLIP 512-d (:477-529);
  * the mask_init_all.pkl contract (:534-550): per-frame dict of lists
    'mask', 'bbox', 'caption', 'capfeat', 'clipfeat'.

Model injection signatures:
  segmenter(rgb [H,W,3] u8) -> (masks [N,H,W] bool, scores [N])
  captioner(rgb, bboxes [(r0,r1,c0,c1)...]) -> [N] str
  clip_encoder(crops: list[[h,w,3] u8]) -> [N, 512]
  sbert_encoder(texts: list[str]) -> [N, 384]

A weights-free default segmenter exists (perception.segmentation
.GraphSegmenter — first-party RGB-D graph segmentation); pass ``depth``
to route it the frame's depth map (any segmenter that accepts a second
positional argument gets it).

Port of ``openobj_tpu.perception.mask_generation`` (host numpy). The
``mask_init_all.pkl`` it writes holds numpy arrays, lists and strings only,
so a pickle written by either package loads in the other.
"""

from __future__ import annotations

import pickle

import numpy as np

from openobj_torch.perception.encoders import (
    caption_subject, crop_with_padding, split_mask,
)


def rank_order_masks(masks: np.ndarray, scores: np.ndarray):
    """Paint masks into one id image in DESCENDING score order (reference
    :291-296: ranks sorted descending, painted in that order, so later —
    lower-score — masks overwrite and the lowest-scoring overlapping mask
    wins the shared pixels), then split the image back into disjoint
    masks. Returns (list of masks, kept indices)."""
    h, w = masks.shape[-2:]
    idimg = np.zeros((h, w), np.int32)
    order = np.argsort(-np.asarray(scores))  # descending; worst painted last
    for rank, i in enumerate(order):
        idimg[masks[i].astype(bool)] = rank + 1
    out_masks, kept = [], []
    for rank, i in enumerate(order):
        m = idimg == rank + 1
        if m.any():
            out_masks.append(m)
            kept.append(int(i))
    return out_masks, kept


def min_rect_bbox(mask: np.ndarray):
    """Tight (r0, r1, c0, c1) half-open bbox of a mask (reference
    min_rect_bbox :125-137 returns rect corners; we carry the axis-aligned
    box the downstream crop actually uses)."""
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    r0, r1 = np.argmax(rows), len(rows) - np.argmax(rows[::-1])
    c0, c1 = np.argmax(cols), len(cols) - np.argmax(cols[::-1])
    return int(r0), int(r1), int(c0), int(c1)


def generate_frame_masks(
    rgb: np.ndarray,
    segmenter,
    captioner,
    clip_encoder,
    sbert_encoder,
    score_thresh: float = 0.5,
    min_px: int = 100,
    crop_pad: int = 20,
    depth: np.ndarray | None = None,
) -> dict:
    """One frame -> {'mask': [...], 'bbox': [...], 'caption': [...],
    'capfeat': [...], 'clipfeat': [...]} (the mask_init_all.pkl per-frame
    schema)."""
    masks, scores = (
        segmenter(rgb, depth) if depth is not None else segmenter(rgb)
    )
    masks = np.asarray(masks).astype(bool)
    scores = np.asarray(scores, np.float64)
    keep = scores >= score_thresh
    masks, scores = masks[keep], scores[keep]

    final_masks: list[np.ndarray] = []
    if len(masks):
        ranked, _ = rank_order_masks(masks, scores)
        for m in ranked:
            if m.sum() < min_px:
                continue
            final_masks.extend(
                s for s in split_mask(m, min_px=min_px) if s.sum() >= min_px
            )

    out = {"mask": [], "bbox": [], "caption": [], "capfeat": [], "clipfeat": []}
    if not final_masks:
        return out
    bboxes = [min_rect_bbox(m) for m in final_masks]
    captions = [caption_subject(c) for c in captioner(rgb, bboxes)]
    capfeat = np.asarray(sbert_encoder(captions), np.float32)
    capfeat /= np.maximum(np.linalg.norm(capfeat, axis=-1, keepdims=True), 1e-12)
    crops = [crop_with_padding(rgb, bb, pad=crop_pad) for bb in bboxes]
    clipfeat = np.asarray(clip_encoder(crops), np.float32)
    clipfeat /= np.maximum(np.linalg.norm(clipfeat, axis=-1, keepdims=True), 1e-12)

    out["mask"] = final_masks
    out["bbox"] = bboxes
    out["caption"] = captions
    out["capfeat"] = list(capfeat)
    out["clipfeat"] = list(clipfeat)
    return out


def generate_masks(
    frames_rgb,
    segmenter,
    captioner,
    clip_encoder,
    sbert_encoder,
    frame_ids=None,
    frames_depth=None,
    **kw,
) -> dict:
    """All frames -> the mask_init_all dict {frame_id: per-frame dict}."""
    out = {}
    for i, rgb in enumerate(frames_rgb):
        fid = frame_ids[i] if frame_ids is not None else i
        out[fid] = generate_frame_masks(
            rgb, segmenter, captioner, clip_encoder, sbert_encoder,
            depth=frames_depth[i] if frames_depth is not None else None,
            **kw,
        )
    return out


def save_mask_init(path: str, mask_init: dict):
    """Write the mask_init_all.pkl artifact in the REFERENCE layout
    (:534-550): field-major {"mask": [per-frame lists], "bbox": ...,
    "caption": ..., "capfeat": ..., "clipfeat": ...} so reference-produced
    and first-party pickles interoperate both ways. ``mask_init`` is the
    in-memory frame-major dict {raw_frame_idx: {field: list}}; the keys
    are recorded under an extra "frame_idx" entry (first-party extension —
    the associate stage pairs masks with raw frames BY INDEX instead of
    positionally, so a start/skip mismatch cannot silently misalign;
    reference readers ignore unknown keys)."""
    keys = sorted(mask_init)
    fields = ("mask", "bbox", "caption", "capfeat", "clipfeat")
    all_data: dict = {f: [mask_init[k][f] for k in keys] for f in fields}
    all_data["frame_idx"] = [int(k) for k in keys]
    with open(path, "wb") as f:
        pickle.dump(all_data, f)

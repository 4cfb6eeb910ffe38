"""Evaluation harness: render PSNR + zero-shot semantic segmentation mIoU.

A copy of the JAX package's ``eval`` (numpy only). ``evaluate_run`` reads
the PNG renders and ground truth with the port's own codec
(``utils.png``), not OpenCV; colour images come back in RGB order where
OpenCV gives BGR, which no score depends on.

The reference ships NO eval code (SURVEY.md §4); its paper protocol is
reconstructed here from the artifacts it writes: rendered ``maskid_*.png``
class-id images (train.py:591,611) vs GT semantic labels for mIoU, and
rendered RGB vs GT images for PSNR. These are the parity metrics in
BASELINE.md.
"""

from __future__ import annotations

import numpy as np


def psnr(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray | None = None,
         max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio; inputs in [0, max_val] (or uint8)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if mask is not None:
        pred, gt = pred[mask], gt[mask]
    mse = np.mean((pred - gt) ** 2)
    return float(-10.0 * np.log10(mse / (max_val**2) + 1e-12))


def depth_l1(pred: np.ndarray, gt: np.ndarray,
             mask: np.ndarray | None = None) -> float:
    if mask is None:
        mask = gt > 0
    return float(np.abs(pred[mask] - gt[mask]).mean())


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, n_classes: int,
                     ignore: int = -1) -> np.ndarray:
    valid = gt != ignore
    idx = gt[valid].astype(np.int64) * n_classes + pred[valid].astype(np.int64)
    return np.bincount(idx, minlength=n_classes**2).reshape(n_classes, n_classes)


def miou_from_confusion(conf: np.ndarray):
    """(mIoU, frequency-weighted mIoU, mean accuracy, per-class IoU) —
    the paper's zero-shot seg metrics (mIoU / fmIoU / mAcc)."""
    inter = np.diag(conf).astype(np.float64)
    union = conf.sum(0) + conf.sum(1) - inter
    freq = conf.sum(1).astype(np.float64)
    present = freq > 0
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    miou = float(iou[present].mean()) if present.any() else 0.0
    fmiou = float((iou * freq / max(freq.sum(), 1))[present].sum())
    acc = np.where(freq > 0, inter / np.maximum(freq, 1), 0.0)
    macc = float(acc[present].mean()) if present.any() else 0.0
    return {"miou": miou, "fmiou": fmiou, "macc": macc, "per_class_iou": iou}


def evaluate_semantic_maps(pred_maps: list[np.ndarray],
                           gt_maps: list[np.ndarray],
                           n_classes: int, ignore: int = -1):
    conf = np.zeros((n_classes, n_classes), np.int64)
    for p, g in zip(pred_maps, gt_maps):
        conf += confusion_matrix(p, g, n_classes, ignore)
    return miou_from_confusion(conf)


def evaluate_instance_maps(pred_maps: list[np.ndarray],
                           gt_maps: list[np.ndarray],
                           ignore_ids=(1, 2, 3)):
    """Instance-level agreement: per-id IoU over every positive instance id
    present in the GT (the association pipeline's OWN global ids appear in
    both the instance_our GT images and the renders' inst_*.png, so this
    needs no matching step). The reserved wall/floor/ceiling ids 1/2/3
    (mask_graph.py:854-855) render through the background model as id 0,
    so they are ignored by default. Returns {inst_miou, per_instance_iou}."""
    # sequence-level IoU: the union must count an id's PREDICTED pixels in
    # every frame, including frames whose GT lacks the id — otherwise a
    # false-positive render of object i where it doesn't exist never
    # penalizes i's score
    all_ids: set[int] = set()
    for g in gt_maps:
        ids = np.unique(g)
        all_ids.update(int(x) for x in ids[(ids > 0) & ~np.isin(ids, ignore_ids)])
    inter: dict[int, float] = {i: 0.0 for i in all_ids}
    union: dict[int, float] = {i: 0.0 for i in all_ids}
    for p, g in zip(pred_maps, gt_maps):
        for i in all_ids:
            pi, gi = p == i, g == i
            inter[i] += float((pi & gi).sum())
            union[i] += float((pi | gi).sum())
    per = {int(i): inter[i] / max(union[i], 1.0) for i in inter}
    miou = float(np.mean(list(per.values()))) if per else 0.0
    return {"inst_miou": miou, "per_instance_iou": per}


def matched_instance_miou(pred_maps, gt_maps, pred_bg=(0, 1, 2, 3, 999),
                          gt_bg=(0, 1, 2, 3)):
    """Instance agreement when the two id SPACES differ (e.g. association
    output vs held-aside GT): sequence-level IoU matrix between every
    non-background pred id and gt id, optimal one-to-one matching
    (Hungarian, maximizing total IoU), unmatched GT instances score 0.
    Also reports background IoU (pred background ids vs gt background).

    Returns {inst_miou, per_gt_iou: {gt_id: iou}, matches: {gt_id:
    pred_id|None}, bg_iou, n_pred_instances}."""
    from scipy.optimize import linear_sum_assignment

    pred_ids = sorted(
        {int(i) for p in pred_maps for i in np.unique(p)} - set(pred_bg)
    )
    gt_ids = sorted(
        {int(i) for g in gt_maps for i in np.unique(g)} - set(gt_bg)
    )
    # one bincount confusion matrix per frame (O(H*W)) instead of a
    # G x P double loop of full-image mask compares (O(G*P*H*W) — minutes
    # at real resolution). Index space: gt ids -> 1..G (0 = background),
    # pred ids -> 1..P (0 = background); cell (a, b) counts pixels.
    g_lut = {gi: a + 1 for a, gi in enumerate(gt_ids)}
    p_lut = {pi: b + 1 for b, pi in enumerate(pred_ids)}
    ng, npd = len(gt_ids) + 1, len(pred_ids) + 1
    conf = np.zeros((ng, npd), np.int64)
    for p, g in zip(pred_maps, gt_maps):
        gi = np.zeros(g.shape, np.int64)
        for v, a in g_lut.items():
            gi[g == v] = a
        pi = np.zeros(p.shape, np.int64)
        for v, b in p_lut.items():
            pi[p == v] = b
        conf += np.bincount(
            (gi * npd + pi).ravel(), minlength=ng * npd
        ).reshape(ng, npd)
    # bucket 0 = exactly the bg ids: pred_ids/gt_ids enumerate EVERY
    # non-bg id that occurs in the sequence, so nothing else can land in 0
    bg_i = float(conf[0, 0])
    bg_u = float(conf[0, :].sum() + conf[:, 0].sum() - conf[0, 0])
    inter = conf[1:, 1:].astype(np.float64)
    area_g = conf[1:, :].sum(1).astype(np.float64)
    area_p = conf[:, 1:].sum(0).astype(np.float64)
    union = area_g[:, None] + area_p[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1.0), 0.0)
    matches: dict[int, int | None] = {gi: None for gi in gt_ids}
    per: dict[int, float] = {gi: 0.0 for gi in gt_ids}
    if iou.size:
        rows, cols = linear_sum_assignment(-iou)
        for a, b in zip(rows, cols):
            if iou[a, b] > 0:
                matches[gt_ids[a]] = pred_ids[b]
                per[gt_ids[a]] = float(iou[a, b])
    miou = float(np.mean(list(per.values()))) if per else 0.0
    return {
        "inst_miou": miou,
        "per_gt_iou": per,
        "matches": matches,
        "bg_iou": bg_i / max(bg_u, 1.0),
        "n_pred_instances": len(pred_ids),
    }


def evaluate_renders(pred_rgbs, gt_rgbs, pred_depths=None, gt_depths=None,
                     masks=None):
    """Aggregate PSNR (and depth L1) over a set of rendered frames."""
    ps, dl = [], []
    for i, (p, g) in enumerate(zip(pred_rgbs, gt_rgbs)):
        m = masks[i] if masks is not None else None
        ps.append(psnr(np.asarray(p) / 255.0, np.asarray(g) / 255.0, m))
        if pred_depths is not None:
            # depth L1 where BOTH sides have depth: the render's depth
            # buffer intentionally covers foreground objects only (bg ids
            # never write z, reference train.py:592-594), so pred==0
            # pixels are out-of-protocol, not errors
            dm = (np.asarray(gt_depths[i]) > 0) & (np.asarray(pred_depths[i]) > 0)
            if m is not None:
                dm &= m
            if dm.any():
                dl.append(depth_l1(np.asarray(pred_depths[i]),
                                   np.asarray(gt_depths[i]), dm))
    out = {"psnr": float(np.mean(ps))}
    if dl:
        out["depth_l1"] = float(np.mean(dl))
    return out


# --------------------------------------------------------------------------- #
# CLI: evaluate a training run's renders against ground truth
# --------------------------------------------------------------------------- #


def evaluate_run(render_dir: str, gt_rgb_dir: str, gt_depth_dir: str | None,
                 gt_semantic_dir: str | None, n_classes: int,
                 depth_scale: float = 1e-3, sem_stride: int = 1,
                 gt_inst_dir: str | None = None,
                 inst_to_class: dict | None = None):
    """Score the train CLI's render artifacts (rgb_<i>.png, depth_<i>.png,
    maskid_<i>.png — the reference's mIoU-eval convention, train.py:591-611)
    against a ground-truth directory. Returns {psnr, depth_l1?, miou?...}.

    sem_stride: GT semantic/instance files are indexed i // sem_stride (the
    association pipeline numbers its class_our/instance_our artifacts by
    ITS stride-10 index, reference dataset.py:82 — pass 10 for the standard
    Replica/ScanNet layout). gt_inst_dir: semantic_instance_<i>.png GT adds
    instance-level IoU over the renders' inst_*.png.

    inst_to_class: the instance->class mapping the maskid renders were
    painted with (render/mapping_class.json). When gt_semantic_dir is
    absent (no REAL semantic GT — note class_our images carry global
    INSTANCE ids, reference mask_graph.py:1240-1264, so they are NOT a
    class GT), the semantic score is derived by remapping the instance GT
    through this same mapping — pred and GT in one id space."""
    import glob
    import json as _json
    import os
    import re

    from openobj_torch.data.loaders import imread

    if inst_to_class is None:
        mpath = os.path.join(render_dir, "mapping_class.json")
        if os.path.exists(mpath):
            inst_to_class = {int(k): int(v)
                             for k, v in _json.load(open(mpath)).items()}
    derive_sem = bool(inst_to_class) and not gt_semantic_dir and gt_inst_dir

    frames = sorted(
        int(re.search(r"rgb_(\d+)\.png$", p).group(1))
        for p in glob.glob(os.path.join(render_dir, "rgb_*.png"))
    )
    if not frames:
        raise FileNotFoundError(f"no rgb_<i>.png renders in {render_dir}")
    pred_rgbs, gt_rgbs, pred_d, gt_d, pred_sem, gt_sem = [], [], [], [], [], []
    pred_inst, gt_inst = [], []
    for i in frames:
        pred_rgbs.append(imread(os.path.join(render_dir, f"rgb_{i}.png"), colour=True))
        gt_rgbs.append(imread(os.path.join(gt_rgb_dir, f"rgb_{i}.png"), colour=True))
        if gt_depth_dir:
            pd = imread(os.path.join(render_dir, f"depth_{i}.png"))
            gd = imread(os.path.join(gt_depth_dir, f"depth_{i}.png"))
            # the train CLI always encodes its depth renders at x1000
            # (train.py render writer); depth_scale applies to the GT only
            pred_d.append(pd.astype(np.float64) * 1e-3)
            gt_d.append(gd.astype(np.float64) * depth_scale)
        if gt_semantic_dir:
            ps = imread(os.path.join(render_dir, f"maskid_{i}.png"))
            gs = imread(os.path.join(
                gt_semantic_dir, f"semantic_class_{i // sem_stride}.png"))
            pred_sem.append(ps.astype(np.int64))
            gt_sem.append(gs.astype(np.int64))
        if gt_inst_dir:
            pi = imread(os.path.join(render_dir, f"inst_{i}.png"))
            gi = imread(os.path.join(
                gt_inst_dir, f"semantic_instance_{i // sem_stride}.png"))
            if pi is not None and gi is not None:
                pred_inst.append(pi.astype(np.int64))
                gt_inst.append(gi.astype(np.int64))
                ps = (imread(os.path.join(render_dir, f"maskid_{i}.png"))
                      if derive_sem else None)
                # a missing/corrupt maskid render skips the frame's semantic
                # rows (same policy as the None-guarded inst reads above)
                if derive_sem and ps is not None:
                    # two id spaces meet here: instance_our GT uses
                    # 0=unknown, 1/2/3=reserved wall/floor/ceiling
                    # (mask_graph.py:854-855), while mapping_class keys are
                    # the LOADER-remapped ids (wall -> bg id 0,
                    # loaders.py:process_instance_frame). So GT 0 is
                    # ignored, GT 1/2/3 take the bg slot's class, and
                    # object ids (4+) map through directly; GT ids absent
                    # from the mapping are ignored, not scored as class 0.
                    gi64 = gi.astype(np.int64)
                    lut = np.full(int(gi64.max()) + 1, -1, np.int64)
                    bg_class = inst_to_class.get(0)
                    if bg_class is not None:
                        for rid in (1, 2, 3):
                            if rid < lut.size:
                                lut[rid] = bg_class
                    for k, v in inst_to_class.items():
                        if 4 <= k < lut.size:
                            lut[k] = v
                    pred_sem.append(ps.astype(np.int64))
                    gt_sem.append(lut[gi64])
    out = evaluate_renders(
        pred_rgbs, gt_rgbs,
        pred_depths=pred_d or None, gt_depths=gt_d or None,
    )
    if pred_sem:
        out.update(evaluate_semantic_maps(pred_sem, gt_sem, n_classes))
        out.pop("per_class_iou", None)
    if pred_inst:
        out["inst_miou"] = evaluate_instance_maps(pred_inst, gt_inst)[
            "inst_miou"
        ]
    return out


def _main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="PSNR / depth-L1 / zero-shot mIoU over a run's renders")
    ap.add_argument("render_dir", help="<logdir>/render from the train CLI")
    ap.add_argument("--gt-rgb", required=True)
    ap.add_argument("--gt-depth", default=None)
    ap.add_argument("--gt-semantic", default=None,
                    help="dir of semantic_class_<i>.png GT label images")
    ap.add_argument("--gt-instance", default=None,
                    help="dir of semantic_instance_<i>.png GT (instance IoU)")
    ap.add_argument("--n-classes", type=int, default=102)
    ap.add_argument("--depth-scale", type=float, default=1e-3)
    ap.add_argument("--sem-stride", type=int, default=1,
                    help="GT semantic/instance files indexed i//stride "
                         "(10 for the standard class_our/instance_our "
                         "association artifacts)")
    args = ap.parse_args(argv)
    out = evaluate_run(args.render_dir, args.gt_rgb, args.gt_depth,
                       args.gt_semantic, args.n_classes, args.depth_scale,
                       sem_stride=args.sem_stride,
                       gt_inst_dir=args.gt_instance)
    print(json.dumps({k: round(float(v), 4) for k, v in out.items()}))


if __name__ == "__main__":
    _main()


def retrieval_metrics(
    query_scores: list[dict],        # per query: {obj_id: similarity}
    gt_object_ids: list,             # per query: the correct object id(s)
    ks=(1, 3, 5),
):
    """Open-vocabulary retrieval metrics (the paper's retrieval task): for
    each text query, rank objects by similarity (viz.query.query_objects)
    and score top-k accuracy + mean reciprocal rank against the annotated
    target object(s)."""
    hits = {k: 0 for k in ks}
    rr = 0.0
    for scores, gt in zip(query_scores, gt_object_ids):
        gts = set(gt) if isinstance(gt, (list, tuple, set)) else {gt}
        ranked = sorted(scores, key=scores.get, reverse=True)
        for k in ks:
            if gts & set(ranked[:k]):
                hits[k] += 1
        for rank, oid in enumerate(ranked, start=1):
            if oid in gts:
                rr += 1.0 / rank
                break
    n = max(len(query_scores), 1)
    out = {f"top{k}_acc": hits[k] / n for k in ks}
    out["mrr"] = rr / n
    return out

"""Headless open-vocabulary query API over an exported object map.

Port of ``openobj_tpu.viz.query`` (numpy; the DBSCAN majority means through
``utils.dbscan``, the part-feature PCA without scikit-learn). The math of
the reference's interactive viewer (visualization/vis_interaction.py),
decoupled from Open3D:

  * per-object canonical features: DBSCAN majority-cluster mean of the
    stacked per-observation CLIP/caption features (:196-203);
  * text -> object retrieval: similarity = 0.2 * sbert_cos + 0.8 * clip_cos
    (:356-376), rainbow colormap or top-k highlighting;
  * object+part query: pick top-k objects by the object query, then
    per-vertex cosine between the distilled part-CLIP field and the part
    text feature (:410-438);
  * part-feature PCA -> RGB visualization colors (StandardScaler + 3-PCA
    scaled to [0, 1] per object, :205-215).

Text encoders are injected (callables str list -> [N, D]), so the API works
with live CLIP/SBERT, precomputed vocabularies, or test fakes.
"""

from __future__ import annotations

import numpy as np

from openobj_torch.perception.merge import majority_cluster_mean

CLIP_WEIGHT = 0.8   # reference vis_interaction.py:369
SBERT_WEIGHT = 0.2


def canonical_object_features(bundle: dict[int, dict]):
    """{obj_id: (clip_512, cap_384)} — majority-cluster means, normalized."""
    out = {}
    for oid, e in bundle.items():
        clip, cap = e.get("clip_feat"), e.get("caption_feat")
        if clip is None or cap is None:
            continue
        clip = np.asarray(clip)
        cap = np.asarray(cap)
        if clip.ndim == 2:
            clip = majority_cluster_mean(clip) if clip.shape[0] > 1 else clip[0]
        if cap.ndim == 2:
            cap = majority_cluster_mean(cap) if cap.shape[0] > 1 else cap[0]
        clip = clip / max(np.linalg.norm(clip), 1e-12)
        cap = cap / max(np.linalg.norm(cap), 1e-12)
        out[oid] = (clip, cap)
    return out


def query_objects(
    text: str,
    bundle: dict[int, dict],
    clip_text_encoder,
    sbert_text_encoder,
    top_k: int | None = None,
):
    """Text -> per-object similarity (0.2 sbert + 0.8 clip). Returns
    {obj_id: score} (all objects, or the top_k)."""
    feats = canonical_object_features(bundle)
    clip_q = np.asarray(clip_text_encoder([text]))[0]
    sbert_q = np.asarray(sbert_text_encoder([text]))[0]
    clip_q = clip_q / max(np.linalg.norm(clip_q), 1e-12)
    sbert_q = sbert_q / max(np.linalg.norm(sbert_q), 1e-12)
    scores = {
        oid: float(CLIP_WEIGHT * (c @ clip_q) + SBERT_WEIGHT * (s @ sbert_q))
        for oid, (c, s) in feats.items()
    }
    if top_k is not None:
        top = sorted(scores, key=scores.get, reverse=True)[:top_k]
        scores = {k: scores[k] for k in top}
    return scores


def query_part(
    object_text: str,
    part_text: str,
    bundle: dict[int, dict],
    clip_text_encoder,
    sbert_text_encoder,
    top_k_objects: int = 1,
):
    """Object+part query (reference :378-438): select objects with the
    object text, then score each vertex of their distilled part-CLIP field
    against the part text. Returns {obj_id: per-vertex similarity [V]}."""
    picked = query_objects(
        object_text, bundle, clip_text_encoder, sbert_text_encoder,
        top_k=top_k_objects,
    )
    part_q = np.asarray(clip_text_encoder([part_text]))[0]
    part_q = part_q / max(np.linalg.norm(part_q), 1e-12)
    out = {}
    for oid in picked:
        pf = bundle[oid].get("part_feat")
        if pf is None:
            continue
        out[oid] = pf @ part_q
    return out


def part_feature_pca_colors(part_feat: np.ndarray) -> np.ndarray:
    """Per-object part-feature PCA -> [0, 1] RGB (reference :205-215).

    scikit-learn's ``StandardScaler`` then ``PCA(n_components=3)``, in
    numpy: columns scaled to zero mean and unit population variance (a
    constant column keeps scale 1), centred, projected on the first three
    right singular vectors, each signed so that its entry of largest
    magnitude is positive (sklearn's ``svd_flip`` on the components)."""
    x = np.asarray(part_feat, np.float64)
    mean = x.mean(0)
    scale = x.std(0)
    scale[scale < 10 * np.finfo(np.float64).eps] = 1.0
    x = (x - mean) / scale
    x = x - x.mean(0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    vt = vt[:3]
    signs = np.sign(vt[np.arange(len(vt)), np.argmax(np.abs(vt), axis=1)])
    y = x @ (vt * signs[:, None]).T
    lo, hi = y.min(0), y.max(0)
    return (y - lo) / np.maximum(hi - lo, 1e-12)


def assign_semantics(
    clip_feats: np.ndarray,          # [N_obs, 512] stacked per-observation
    caption_feats: np.ndarray,       # [N_obs, 384]
    class_clipfeat: np.ndarray,      # [C, 512] class-name CLIP features
    class_capfeat: np.ndarray,       # [C, 384] class-name SBERT features
    caption_confidence: float = 0.5,
) -> int:
    """Open-vocab class assignment (reference train.py:497-526): DBSCAN
    majority means, argmax cosine per modality; the caption decision wins
    when its best similarity exceeds caption_confidence, else CLIP's."""
    clip = clip_feats
    cap = caption_feats
    if np.ndim(clip) == 2:
        clip = majority_cluster_mean(clip) if clip.shape[0] > 1 else clip[0]
        cap = majority_cluster_mean(cap) if cap.shape[0] > 1 else cap[0]
    sim_clip = class_clipfeat @ clip
    sim_cap = class_capfeat @ cap
    if float(sim_cap.max()) > caption_confidence:
        return int(np.argmax(sim_cap))
    return int(np.argmax(sim_clip))

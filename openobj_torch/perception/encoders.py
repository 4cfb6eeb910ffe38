"""Pluggable perception encoders + precomputed-artifact loaders.

The reference's per-frame perception models — CropFormer entity
segmentation, TAP captioning + spaCy subject extraction, SBERT caption
embedding, CLIP crop embedding, SAM automatic masks
(maskclustering/mask_gen.py, partlevel/sam_clip_dir.py) —
are pretrained third-party networks. This framework treats them as
encoders behind small interfaces with three interchangeable backends:

  1. ``Precomputed*`` — load the reference's artifact files verbatim
     (mask_init_all.pkl contract, mask_gen.py:534-550) so the pipeline is
     drop-in compatible with already-extracted data;
  2. ``HFClipEncoder`` / ``HFSbertEncoder`` / ``HFCaptioner`` — live
     transformers-based CLIP / SBERT / box-crop captioning (the TAP
     stage's equivalent) (lazy; require local model weights — this
     container has no egress);
  3. test fakes (deterministic random projections) in tests/.

Mask postprocessing that the reference does around CropFormer — score
filtering, small-mask dropping, multi-component splitting via
connected-components + pairwise min-distance + DBSCAN regrouping
(mask_gen.py:107-209,284-338) — is first-party here (``split_mask``).

Port of ``openobj_tpu.perception.encoders``. The weights-free encoders are
host numpy, as in the JAX package, and give its outputs bit for bit (the
descriptor's projection is drawn from numpy's generator with the same
seed). ``split_mask`` regroups components by its own single-linkage pass
over the precomputed distances, which is what scikit-learn's DBSCAN with
``min_samples=1`` computes. The transformers-based encoders import
``transformers`` in their constructors only and run on ``device`` (the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass

import numpy as np
from scipy.sparse import csgraph


# --------------------------------------------------------------------------- #
# artifact loaders (the reference file contracts)
# --------------------------------------------------------------------------- #


def load_mask_init(path: str) -> dict:
    """Load mask_init_all.pkl -> frame-major {key: {field: list}}.

    Accepts BOTH layouts: the reference's field-major
    {"mask": [per-frame lists], "bbox": ..., ...} (mask_gen.py:534-550 —
    also what save_mask_init writes) and the legacy first-party
    frame-major dict. Keys are RAW frame indices when the pickle carries
    the first-party "frame_idx" extension (the associate stage then pairs
    masks to raw frames by index — immune to start/skip mismatches);
    reference pickles have no frame record, so keys fall back to dense
    ordinals 0..N-1 (positional pairing, the reference's own behavior)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    if "mask" not in data:
        return data                       # already frame-major
    n = len(data["mask"])
    fields = ("mask", "bbox", "caption", "capfeat", "clipfeat")
    keys = [int(k) for k in data["frame_idx"]] if "frame_idx" in data \
        else list(range(n))
    return {
        k: {f: data[f][o] for f in fields if f in data}
        for o, k in enumerate(keys)
    }


def load_object_features(output_dir: str):
    """Load the three association outputs object_{clipfeat,capfeat,caption}
    .pkl (mask_graph.py:1268-1280): per-frame {global_id: feature}."""
    import os

    out = {}
    for name in ("clipfeat", "capfeat", "caption"):
        with open(os.path.join(output_dir, f"object_{name}.pkl"), "rb") as f:
            out[name] = pickle.load(f)
    return out


def load_part_features(path: str) -> np.ndarray:
    """Load a per-frame part-level CLIP map .npy (sam_clip_dir.py:133):
    (H/down, W/down, 512) float."""
    return np.load(path)


# --------------------------------------------------------------------------- #
# mask postprocessing (first-party, reference mask_gen.py:107-209)
# --------------------------------------------------------------------------- #


def split_mask(
    mask: np.ndarray,
    min_px: int = 100,
    eps_factor: float = 0.1,
) -> list[np.ndarray]:
    """Split a multi-component mask into spatially-coherent submasks:
    8-connected components, components < min_px dropped, then regrouped by
    DBSCAN over pairwise minimum inter-component distances with
    eps = (H + W) * eps_factor (mask_gen.py:139-209). Returns list of
    submasks (possibly merging nearby components)."""
    from scipy.spatial import cKDTree

    from openobj_torch.perception.projection import connected_components

    h, w = mask.shape
    comps = [c for c in connected_components(mask) if c.sum() >= min_px]
    if len(comps) <= 1:
        return comps

    pts = [np.argwhere(c) for c in comps]
    k = len(comps)
    dist = np.zeros((k, k))
    for i in range(k):
        tree = cKDTree(pts[i])
        for j in range(i + 1, k):
            d = tree.query(pts[j], k=1)[0].min()
            dist[i, j] = dist[j, i] = d
    eps = (h + w) * eps_factor
    labels = _group_within(dist, eps)
    out = []
    for g in np.unique(labels):
        m = np.zeros((h, w), bool)
        for c, l in zip(comps, labels):
            if l == g:
                m |= c
        out.append(m)
    return out


def _group_within(dist: np.ndarray, eps: float) -> np.ndarray:
    """Labels of scikit-learn's ``DBSCAN(eps, min_samples=1,
    metric="precomputed")`` over the distance matrix ``dist``: every point
    is a core point, so the clusters are the connected components of
    ``dist <= eps``, numbered 0, 1, ... by their lowest index."""
    _, comp = csgraph.connected_components(dist <= eps, directed=False)
    _, first = np.unique(comp, return_index=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[comp]


def crop_with_padding(image: np.ndarray, bbox, pad: int = 20) -> np.ndarray:
    """Padded bbox crop for CLIP (mask_gen.py:477-529). bbox (r0, r1, c0, c1)."""
    h, w = image.shape[:2]
    r0, r1, c0, c1 = bbox
    return image[max(0, r0 - pad) : min(h, r1 + pad),
                 max(0, c0 - pad) : min(w, c1 + pad)]


# --------------------------------------------------------------------------- #
# live encoders (lazy, optional weights)
# --------------------------------------------------------------------------- #


def _to(inputs, device):
    """A processor's or tokenizer's batch of tensors, moved to ``device``."""
    return {k: v.to(device) if hasattr(v, "to") else v for k, v in inputs.items()}


@dataclass
class HFClipEncoder:
    """CLIP ViT-B/32 image+text encoder on transformers (the reference's
    `clip.load("ViT-B/32")`, mask_gen.py:477, train.py:135). Requires local
    weights — pass a local path as model_name in an egress-less env, or
    inject a prebuilt (model, processor) pair (how the tests run this code
    with tiny randomly-initialized CLIPConfig models)."""

    model_name: str = "openai/clip-vit-base-patch32"
    model: object = None
    processor: object = None
    device: str = "cuda"

    def __post_init__(self):
        if self.model is None or self.processor is None:
            from transformers import CLIPModel, CLIPProcessor

            self.model = CLIPModel.from_pretrained(self.model_name)
            self.processor = CLIPProcessor.from_pretrained(self.model_name)
        self.model = self.model.to(self.device)

    def encode_images(self, images: list[np.ndarray]) -> np.ndarray:
        import torch

        inputs = _to(self.processor(images=images, return_tensors="pt"), self.device)
        with torch.no_grad():
            f = self.model.get_image_features(**inputs)
        f = f / f.norm(dim=-1, keepdim=True)
        return f.cpu().numpy()

    def encode_texts(self, texts: list[str]) -> np.ndarray:
        import torch

        inputs = _to(self.processor(text=texts, return_tensors="pt", padding=True),
                     self.device)
        with torch.no_grad():
            f = self.model.get_text_features(**inputs)
        f = f / f.norm(dim=-1, keepdim=True)
        return f.cpu().numpy()


@dataclass
class HFSbertEncoder:
    """all-MiniLM-L6-v2 sentence encoder (the reference's SBERT,
    train.py:143). Mean-pooled, L2-normalized 384-d. A prebuilt
    (model, tokenizer) pair can be injected instead of model_name."""

    model_name: str = "sentence-transformers/all-MiniLM-L6-v2"
    model: object = None
    tokenizer: object = None
    device: str = "cuda"

    def __post_init__(self):
        if self.model is None or self.tokenizer is None:
            from transformers import AutoModel, AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(self.model_name)
            self.model = AutoModel.from_pretrained(self.model_name)
        self.model = self.model.to(self.device)

    def encode_texts(self, texts: list[str]) -> np.ndarray:
        import torch

        inputs = _to(self.tokenizer(
            texts, padding=True, truncation=True, return_tensors="pt"
        ), self.device)
        with torch.no_grad():
            out = self.model(**inputs).last_hidden_state
        mask = inputs["attention_mask"][..., None].float()
        emb = (out * mask).sum(1) / mask.sum(1)
        emb = emb / emb.norm(dim=-1, keepdim=True)
        return emb.cpu().numpy()


@dataclass
class HFCaptioner:
    """Box-prompted image captioner on transformers — the live equivalent
    of the reference's TAP stage (mask_gen.py:373-427: TAP is prompted
    with each mask's bbox as a 2-point box prompt and emits a caption per
    mask). Here each padded bbox crop is captioned by a
    vision-encoder-decoder model (BLIP by default); the output plugs
    straight into the ``captioner(rgb, bboxes) -> [N] str`` slot of
    mask_generation.generate_frame_masks, then caption_subject + SBERT as
    in the reference. Requires local weights, or inject a prebuilt
    (model, processor) pair (how the tests run this code with a tiny
    config-built BLIP)."""

    model_name: str = "Salesforce/blip-image-captioning-base"
    model: object = None
    processor: object = None
    crop_pad: int = 20
    max_new_tokens: int = 12
    device: str = "cuda"

    def __post_init__(self):
        if self.model is None or self.processor is None:
            from transformers import (
                BlipForConditionalGeneration, BlipProcessor,
            )

            self.model = BlipForConditionalGeneration.from_pretrained(
                self.model_name
            )
            self.processor = BlipProcessor.from_pretrained(self.model_name)
        self.model = self.model.to(self.device)

    def __call__(self, rgb: np.ndarray, bboxes) -> list[str]:
        import torch

        if not len(bboxes):
            return []
        crops = [crop_with_padding(rgb, bb, pad=self.crop_pad)
                 for bb in bboxes]
        inputs = _to(self.processor(images=crops, return_tensors="pt"), self.device)
        with torch.no_grad():
            ids = self.model.generate(
                **inputs, max_new_tokens=self.max_new_tokens
            )
        return [self.processor.decode(i, skip_special_tokens=True).strip()
                for i in ids]


# --------------------------------------------------------------------------- #
# weights-free stand-in encoders (no third-party weights, fully deterministic)
#
# These fill the CLIP/SBERT/TAP slots when no model weights are mounted
# (this container has no egress) so the FULL perception pipeline runs
# end-to-end first-party. They are honest hand-crafted descriptors, not
# semantic models: visual similarity (same object seen twice) and lexical
# similarity (shared caption words) are preserved — which is exactly what
# the association graph's clip/caption cues consume
# (maskclustering/mask_graph.py:573-584) — but
# cross-modal text->image retrieval needs real CLIP weights.
# --------------------------------------------------------------------------- #


class HashingTextEncoder:
    """Deterministic token-hash bag-of-words text encoder (SBERT slot).

    Each lowercase token hashes (blake2b, seeded) to a signed coordinate of
    a ``dim``-d vector; the sum is L2-normalized. Identical texts -> cosine
    1, texts sharing tokens -> proportionally positive cosine, disjoint
    texts -> ~0. Stands in for the reference's all-MiniLM-L6-v2
    (mask_gen.py:465-468) in weights-free runs; the bg caption anchoring
    ('wall' vs a mask captioned 'wall', mask_graph.py:1106-1187) works
    exactly because equal words collide."""

    def __init__(self, dim: int = 384, seed: int = 0):
        self.dim = dim
        self.seed = seed

    def encode_texts(self, texts: list[str]) -> np.ndarray:
        import hashlib

        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            for tok in str(text).lower().split():
                h = hashlib.blake2b(
                    tok.encode(), digest_size=8, salt=str(self.seed).encode()
                ).digest()
                v = int.from_bytes(h, "little")
                out[i, v % self.dim] += 1.0 if (v >> 60) & 1 else -1.0
        n = np.linalg.norm(out, axis=-1, keepdims=True)
        return out / np.maximum(n, 1e-12)

    __call__ = encode_texts


class VisualDescriptorEncoder:
    """Deterministic hand-crafted visual descriptor (CLIP-image slot).

    Per crop: 3x16-bin color histogram + 8x8 downsampled luminance +
    16-bin gradient-orientation histogram, each block L2-normalized, then
    projected to ``dim`` through a fixed seeded Gaussian projection and
    L2-normalized. Two crops of the same surface land close in cosine;
    different-looking crops don't — the property the association graph's
    clip cue (mask_graph.py:573-584) and the part-feature distillation
    target (sam_clip_dir.py:94-111) actually rely on. No text tower:
    open-vocabulary *queries* need real CLIP weights (HFClipEncoder)."""

    def __init__(self, dim: int = 512, seed: int = 0):
        self.dim = dim
        rng = np.random.default_rng(seed)
        self._proj = rng.normal(
            size=(48 + 64 + 16, dim)
        ).astype(np.float32) / np.sqrt(dim)

    def _descriptor(self, im: np.ndarray) -> np.ndarray:
        im = np.asarray(im, np.float32)
        if im.ndim == 2:
            im = im[..., None].repeat(3, -1)
        npix = max(im.shape[0] * im.shape[1], 1)
        # each block is normalized by a SCALE-stable denominator, never by
        # its own norm — a near-zero block (flat crop: no gradients, no
        # contrast) must stay near zero, not blow up into unit noise
        hist = np.concatenate([
            np.histogram(im[..., c], bins=16, range=(0, 255))[0]
            for c in range(3)
        ]).astype(np.float32) / npix
        gray = im.mean(-1)
        h, w = gray.shape
        ys = np.clip((np.arange(8) + 0.5) / 8 * h, 0, h - 1).astype(int)
        xs = np.clip((np.arange(8) + 0.5) / 8 * w, 0, w - 1).astype(int)
        thumb = gray[np.ix_(ys, xs)].reshape(-1)
        thumb = (thumb - thumb.mean()) / 255.0
        if min(h, w) >= 2:      # np.gradient needs >= 2 samples per axis
            gy, gx = np.gradient(gray)
            mag = np.hypot(gx, gy).reshape(-1)
            ang = np.arctan2(gy, gx).reshape(-1)
            ohist, _ = np.histogram(
                ang, bins=16, range=(-np.pi, np.pi), weights=mag
            )
            ohist = ohist.astype(np.float32) / (float(mag.sum()) + npix)
        else:                   # degenerate sliver crop: no gradient signal
            ohist = np.zeros(16, np.float32)
        return np.concatenate([hist, thumb, ohist])

    def encode_images(self, images: list[np.ndarray]) -> np.ndarray:
        d = np.stack([self._descriptor(im) for im in images])
        f = d @ self._proj
        return f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)

    __call__ = encode_images


_COLOR_NAMES = (
    ("red", (200, 40, 40)), ("orange", (230, 140, 40)),
    ("yellow", (220, 210, 60)), ("green", (60, 170, 70)),
    ("cyan", (70, 190, 190)), ("blue", (50, 80, 200)),
    ("purple", (140, 70, 180)), ("brown", (120, 80, 50)),
    ("white", (235, 235, 235)), ("gray", (128, 128, 128)),
    ("black", (25, 25, 25)),
)


class ColorNameCaptioner:
    """Weights-free captioner (TAP slot): names each padded bbox crop by
    its dominant color — 'a red object'. Deterministic and crude, but it
    gives the caption cue real discriminative signal under the hashing
    text encoder (same-colored views of one object agree, different
    colors disagree), and bg surfaces can still be anchored via GT ids
    (mask_graph.py:1112-1135) when captions carry no 'wall'/'floor'
    semantics. Swap HFCaptioner when weights are mounted."""

    def __init__(self, crop_pad: int = 0):
        self.crop_pad = crop_pad

    def __call__(self, rgb: np.ndarray, bboxes) -> list[str]:
        caps = []
        for bb in bboxes:
            crop = crop_with_padding(rgb, bb, pad=self.crop_pad)
            mean = np.asarray(crop, np.float32).reshape(-1, 3).mean(0)
            dists = [
                ((mean - np.asarray(c, np.float32)) ** 2).sum()
                for _, c in _COLOR_NAMES
            ]
            caps.append(f"a {_COLOR_NAMES[int(np.argmin(dists))][0]} object")
        return caps


# --------------------------------------------------------------------------- #
# caption subject extraction (reference mask_gen.py:429-440)
# --------------------------------------------------------------------------- #


_NLP = None
_ARTICLES = ("a ", "an ", "the ", "this ", "that ", "some ")
_BREAKERS = (" with ", " on ", " in ", " at ", " next to ", " under ",
             " that ", " which ", " is ", " are ", " sitting ", " standing ")


def caption_subject(caption: str) -> str:
    """Leading noun-chunk of a caption (reference mask_gen.py:429-440: the
    first spaCy noun chunk the sentence STARTS with, else the full caption).
    Uses spaCy when its model is installed; otherwise a deterministic
    heuristic (cut at the first verb-ish/prepositional breaker) — adequate
    for the short TAP captions this feeds."""
    global _NLP
    caption = str(caption).strip()
    if _NLP is None:
        try:
            import spacy

            _NLP = spacy.load("en_core_web_sm")
        except Exception:
            _NLP = False
    if _NLP:
        doc = _NLP(caption)
        for np_ in doc.noun_chunks:
            if caption.startswith(str(np_)):
                return str(np_)
        return caption
    # heuristic fallback: keep the leading article + up to the first breaker
    low = caption.lower()
    cut = len(caption)
    for b in _BREAKERS:
        i = low.find(b)
        if 0 < i < cut:
            cut = i
    head = caption[:cut].strip().rstrip(".,")
    return head if head else caption

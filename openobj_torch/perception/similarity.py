"""The multi-cue similarity matrices over all masks of a sequence, on a
torch device.

Port of ``openobj_tpu.perception.similarity``; parity with the reference
maskclustering/mask_graph.py:

  * ``iou3d_matrix``: pairwise AABB intersection normalized by the SMALLER
    box volume (not the union; :501-530);
  * ``cosine_matrix``: feature Gram with row-norm normalization (:573-584,
    :592-601; the same formula for caption, CLIP and colour-histogram cues);
  * ``projected_iou2d_matrix``: per frame, every ``skip``-th pixel's ray
    scaled by depth is intersected with every mask AABB (the slab test,
    :634-643) in one batched [n_rays, M, 3] pass; each AABB's hit-pixel set
    gives a tight 2D box (:660-680); pairwise union-normalized 2D IoU
    (:533-558), averaged over frames (:697-712).

They are dense [M, M] batched ops and run on ``device`` (the card unless
the caller asks for the CPU); each returns numpy, as the JAX functions do.
Everything is FP32 as in the JAX package, and the Gram product is exact
FP32 whatever the caller's TF32 setting: the graph cuts edges at a weighted
sum ``>= 1.0`` (``graph.build_adjacency``), so a TF32 product could move
edges.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def exact_fp32():
    """FP32 (IEEE) CUDA matrix products, no TF32, inside the block; the
    caller's setting is restored after it. Through the backend's own flag:
    reading the global precision after a caller set the legacy
    ``allow_tf32`` raises in torch 2.11."""
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    m.fp32_precision = "ieee"
    try:
        yield
    finally:
        m.fp32_precision = prev


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def iou3d_matrix(bboxes: np.ndarray, device="cuda") -> np.ndarray:
    """bboxes [M, 6] (min_xyz, max_xyz) -> [M, M] intersection / smaller-vol."""
    b = _f32(bboxes, device)
    lo, hi = b[:, :3], b[:, 3:]
    vol = torch.prod(hi - lo, dim=-1)
    inter_lo = torch.maximum(lo[:, None, :], lo[None, :, :])
    inter_hi = torch.minimum(hi[:, None, :], hi[None, :, :])
    inter = torch.prod(torch.clamp(inter_hi - inter_lo, min=0.0), dim=-1)
    smaller = torch.minimum(vol[:, None], vol[None, :])
    out = torch.where(smaller > 0, inter / smaller, torch.zeros_like(inter))
    return torch.nan_to_num(out).cpu().numpy()


def cosine_matrix(feats: np.ndarray, device="cuda") -> np.ndarray:
    """Row-normalized Gram matrix (mask_graph.py:573-584)."""
    f = _f32(feats, device)
    norm = torch.linalg.norm(f, dim=1, keepdim=True)
    f = f / torch.clamp(norm, min=1e-12)
    with exact_fp32():
        g = f @ f.T
    return g.cpu().numpy()


def iou2d(boxes: torch.Tensor) -> torch.Tensor:
    """boxes [M, 4] (r0, c0, r1, c1) -> [M, M] union-normalized IoU
    (mask_graph.py:533-558); degenerate pairs -> 0."""
    r0, c0, r1, c1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (r1 - r0) * (c1 - c0)
    ir0 = torch.maximum(r0[:, None], r0[None, :])
    ir1 = torch.minimum(r1[:, None], r1[None, :])
    ic0 = torch.maximum(c0[:, None], c0[None, :])
    ic1 = torch.minimum(c1[:, None], c1[None, :])
    inter = torch.clamp(ir1 - ir0, min=0) * torch.clamp(ic1 - ic0, min=0)
    union = area[:, None] + area[None, :] - inter
    return torch.nan_to_num(torch.where(union > 0, inter / union, torch.zeros_like(inter)))


def _hit_bboxes(hit: torch.Tensor, hs: int, ws: int) -> torch.Tensor:
    """hit [M, hs*ws] bool -> [M, 4] float32 tight bbox of hit pixels per
    mask (min_rect_bbox parity; empty -> zeros, mask_graph.py:660-680)."""
    hit = hit.reshape(-1, hs, ws)
    dev = hit.device
    rows = torch.arange(hs, device=dev)[None, :, None]
    cols = torch.arange(ws, device=dev)[None, None, :]
    big = torch.tensor(10**6, device=dev)
    none = torch.tensor(-1, device=dev)
    r0 = torch.where(hit, rows, big).amin(dim=(1, 2))
    r1 = torch.where(hit, rows, none).amax(dim=(1, 2)) + 1
    c0 = torch.where(hit, cols, big).amin(dim=(1, 2))
    c1 = torch.where(hit, cols, none).amax(dim=(1, 2)) + 1
    any_hit = hit.any(dim=2).any(dim=1)
    box = torch.stack([r0, c0, r1, c1], dim=-1).to(torch.float32)
    return torch.where(any_hit[:, None], box, torch.zeros_like(box))


def projected_iou2d_matrix(
    depths: list[np.ndarray],     # per frame [H, W] meters
    t_wcs: np.ndarray,            # [F, 4, 4]
    fx: float, fy: float, cx: float, cy: float,
    bboxes: np.ndarray,           # [M, 6] world AABBs
    skip: int = 10,
    device="cuda",
) -> np.ndarray:
    """Running mean over frames of pairwise 2D IoU between each AABB's
    projected ray-hit footprint (mask_graph.py:683-735)."""
    b = _f32(bboxes, device)
    lo, hi = b[:, :3], b[:, 3:]
    m = b.shape[0]
    acc = torch.zeros((m, m), dtype=torch.float32, device=b.device)
    for i, depth in enumerate(depths):
        d = depth[::skip, ::skip]
        hs, ws = d.shape
        vs, us = np.meshgrid(
            np.arange(0, depth.shape[0], skip),
            np.arange(0, depth.shape[1], skip),
            indexing="ij",
        )
        # the rays in float64 on the host, cast to float32 where the JAX
        # package casts them
        dirs = np.stack(
            [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float32)], -1
        )
        rays_d = (dirs * d[..., None]).reshape(-1, 3) @ t_wcs[i][:3, :3].T
        rays_o = np.broadcast_to(t_wcs[i][:3, 3], rays_d.shape)
        o = _f32(rays_o, b.device)[:, None, :]
        dd = _f32(rays_d, b.device)[:, None, :]
        dd = torch.where(dd.abs() < 1e-12, torch.full_like(dd, 1e-12), dd)
        tmin = (lo[None] - o) / dd                   # [n_rays, M, 3]
        tmax = (hi[None] - o) / dd
        t1 = torch.minimum(tmin, tmax)
        t2 = torch.maximum(tmin, tmax)
        near = t1.amax(dim=2)
        far = t2.amin(dim=2)
        hit = ((near <= far) & (far > 0)).T         # [M, n_rays]
        boxes2d = _hit_bboxes(hit, hs, ws)
        acc = (acc * i + iou2d(boxes2d)) / (i + 1)
    return acc.cpu().numpy()

"""Occupancy -> termination compositing, residuals and masked reductions.

Port of ``openobj_tpu.ops.rendering``:

  * ``occupancy_activation``: sigmoid(alpha) or 1 - exp(-alpha * d);
  * ``occupancy_to_termination``: w_i = occ_i * prod_{j<i}(1 - occ_j + 1e-10);
  * ``render``: sum(w * val);
  * ``render_loss``: L1 / L2 / NaN-safe cosine residuals;
  * ``reduce_masked_loss``: masked mean with optional inverse-variance
    weighting; a row with no valid sample contributes exactly zero (the
    reference zeroes the whole batch instead, which a slot-allocated object
    axis with dead slots cannot use);
  * ``make_3d_grid``: the scaled, rigidly placed cube lattice for meshing.
"""

from __future__ import annotations

import torch

from openobj_torch.parallel import sharding

FREE_PROB_EPS = 1e-10
INFO_EPS = 1e-4
MASK_EPS = 1e-10


def occupancy_activation(alpha: torch.Tensor, distances=None) -> torch.Tensor:
    if distances is not None:
        return 1.0 - torch.exp(-alpha * distances)
    return torch.sigmoid(alpha)


def occupancy_to_termination(occupancy: torch.Tensor) -> torch.Tensor:
    """occupancy [..., P] -> termination [..., P]."""
    free = 1.0 - occupancy + FREE_PROB_EPS
    shifted = torch.cat([torch.ones_like(free[..., :1]), free[..., :-1]], dim=-1)
    return occupancy * torch.cumprod(shifted, dim=-1)


def render(termination: torch.Tensor, vals: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.sum(termination * vals, dim=axis)


def render_loss(pred: torch.Tensor, gt: torch.Tensor, loss: str = "L1") -> torch.Tensor:
    if loss == "L2":
        mat = (pred - gt) ** 2
    elif loss == "L1":
        mat = torch.abs(pred - gt)
    elif loss == "cos":
        num = torch.sum(pred * gt, dim=-1)
        # eps inside the sqrt: a zero (all-transparent) feature must not
        # produce a NaN gradient
        den = torch.sqrt(torch.sum(pred ** 2, dim=-1) + 1e-12) * torch.sqrt(
            torch.sum(gt ** 2, dim=-1) + 1e-12)
        mat = 1.0 - num / den
    else:
        raise ValueError(f"loss type {loss} not implemented")
    return mat


def reduce_masked_loss(
    loss_mat: torch.Tensor,
    mask: torch.Tensor,
    var: torch.Tensor | None = None,
    loss_type: str = "L1",
) -> torch.Tensor:
    """Masked mean over the last axis, per leading row; rows with no valid
    samples give exactly zero. Inside ``sharding.use_mesh`` with a "data"
    axis the rays are split across its ranks: each row's count is summed
    over them, so this rank's term is its share of the whole mean."""
    if var is not None:
        if loss_type == "L2":
            information = 1.0 / (var + INFO_EPS)
        else:
            information = 1.0 / (torch.sqrt(var) + INFO_EPS)
        loss_mat = loss_mat * information
    mask_f = mask.to(loss_mat.dtype)
    num = torch.sum(loss_mat * mask_f, dim=-1)
    den = sharding.data_sum(torch.sum(mask_f, dim=-1))
    return torch.where(den > 0, num / (den + MASK_EPS), torch.zeros_like(num))


def make_3d_grid(occ_range=(-1.0, 1.0), dim: int = 256, transform=None,
                 scale=None, device="cpu") -> torch.Tensor:
    """[dim, dim, dim, 3] lattice ('ij' order), optionally scaled per axis,
    then rigidly transformed by ``transform`` [4, 4]. The rotation is
    elementwise products summed, exact f32 on every device (a matmul may
    take a reduced-precision path)."""
    t = torch.linspace(occ_range[0], occ_range[1], dim, device=device)
    gx, gy, gz = torch.meshgrid(t, t, t, indexing="ij")
    grid = torch.stack([gx, gy, gz], dim=-1)
    if scale is not None:
        grid = grid * torch.as_tensor(scale, dtype=torch.float32, device=device)
    if transform is not None:
        tr = torch.as_tensor(transform, dtype=torch.float32, device=device)
        grid = (grid[..., None, :] * tr[:3, :3]).sum(-1) + tr[:3, 3]
    return grid

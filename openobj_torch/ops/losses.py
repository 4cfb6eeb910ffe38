"""The batched multi-term training loss.

Port of ``openobj_tpu.ops.losses`` over tensors shaped [O, R, P]:

  * mask_obj = state != other, mask_sem = state != unknown, both constants;
  * composite depth, per-ray depth variance (detached), colour and
    opacity = sum(termination);
  * depth L1 on mask_sem & mask_obj, weighted by 1/(sqrt(var)+1e-4);
  * colour L1 summed over channels, x color_scaling;
  * opacity L1 toward the object silhouette on mask_sem, x opacity_scaling;
  * optional part-feature cosine loss, x partfeat_scaling;
  * an ``active`` [O] mask zeroes dead slots; total = sum over objects.
"""

from __future__ import annotations

import torch

from openobj_torch.ops import rendering
from openobj_torch.ops.sampling import STATE_OTHER, STATE_UNKNOWN


def factored_cosine_loss(
    head: dict,
    hidden: torch.Tensor,     # [O, R, h] composited clip hidden
    opacity: torch.Tensor,    # [O, R]
    gt: torch.Tensor,         # [O, R, C] (int8 store values allowed)
    compute_dtype: str = "f32",
) -> torch.Tensor:
    """1 - cos(hidden @ W + opacity*b, gt) without the [O, R, C] projection.

    With h' = [hidden, opacity] and W' = [W; b]: pred.gt = h'.(gt W'^T),
    |pred|^2 = h' (W'W'^T) h'. The quadratic form is clamped at 0, since
    cancellation can make it slightly negative on all-transparent rays.

    ``compute_dtype="bf16"``: gt and W' are rounded to bf16 once (gt is
    exact there: int8 store values, or a bf16 store) and the C-wide
    products gt W'^T, W'W'^T and |gt|^2 sum in f32; the products of bf16
    values are exact in f32, so they are taken in f32 on the rounded values
    (an einsum of bf16 tensors would round its result to bf16). Each of the
    two products reads W' through a cast of its own, so that each one's
    gradient is rounded to bf16 and the two are added in bf16, as the
    transposes of the JAX package's products are (equal bit for bit). The
    [h+1]-wide forms stay f32.
    """
    if compute_dtype not in ("f32", "bf16"):
        raise ValueError(f"compute_dtype={compute_dtype!r}: 'f32' or 'bf16'")
    bf16 = compute_dtype == "bf16"
    w, b = head["out_clip"]["w"], head["out_clip"]["b"]
    gtc = gt.to(hidden.dtype)
    if bf16:
        gtc = gtc.to(torch.bfloat16).float()
    hp = torch.cat([hidden, opacity[..., None]], dim=-1)          # [O,R,h+1]
    stacked = w.ndim == 3   # w [O, h, C], b [O, C]; else w [h, C], b [C]
    wb = torch.cat([w, b[:, None, :]], dim=1) if stacked else torch.cat([w, b[None, :]], dim=0)
    if bf16:
        wb = wb.to(torch.bfloat16)
    wt, wg = (wb.float(), wb.float()) if bf16 else (wb, wb)
    if stacked:
        t = torch.einsum("orc,ohc->orh", gtc, wt)
        g = torch.einsum("ohc,okc->ohk", wg, wg)
        pn2 = torch.einsum("orh,ohk,ork->or", hp, g, hp)
    else:
        t = torch.einsum("orc,hc->orh", gtc, wt)
        g = torch.einsum("hc,kc->hk", wg, wg)
        pn2 = torch.einsum("orh,hk,ork->or", hp, g, hp)
    num = torch.sum(hp * t, dim=-1)
    gn2 = torch.einsum("orc,orc->or", gtc, gtc)
    den = torch.sqrt(torch.clamp(pn2, min=0.0) + 1e-12) * torch.sqrt(gn2 + 1e-12)
    return 1.0 - num / den


def step_batch_loss(
    alpha: torch.Tensor,          # [O, R, P] raw density (already x10)
    color: torch.Tensor,          # [O, R, P, 3]
    gt_depth: torch.Tensor,       # [O, R]
    gt_color: torch.Tensor,       # [O, R, 3] in [0, 1]
    state: torch.Tensor,          # [O, R] {0 other, 1 this, 2 unknown}
    z_vals: torch.Tensor,         # [O, R, P]
    active: torch.Tensor | None = None,   # [O] bool
    color_scaling: float = 5.0,
    opacity_scaling: float = 10.0,
    gt_partfeat: torch.Tensor | None = None,            # [O, R, C]
    pred_partfeat: torch.Tensor | None = None,          # [O, R, P, C]
    pred_partfeat_hidden: torch.Tensor | None = None,   # [O, R, P, h]
    partfeat_head: dict | None = None,
    partfeat_scaling: float = 5.0,
    compute_dtype: str = "f32",
):
    """Returns (scalar total loss, per-object loss [O])."""
    mask_obj = state != STATE_OTHER
    mask_sem = state != STATE_UNKNOWN
    mask_so = mask_sem & mask_obj

    occupancy = rendering.occupancy_activation(alpha)
    termination = rendering.occupancy_to_termination(occupancy)

    render_depth = rendering.render(termination, z_vals)
    diff_sq = (z_vals - render_depth[..., None]) ** 2
    var = rendering.render(termination, diff_sq).detach()
    render_color = rendering.render(termination[..., None], color, axis=-2)
    render_opacity = torch.sum(termination, dim=-1)

    loss_depth_raw = rendering.render_loss(render_depth, gt_depth, loss="L1")
    loss_depth = rendering.reduce_masked_loss(
        loss_depth_raw * mask_so, mask_so, var=var, loss_type="L1")

    loss_col_raw = rendering.render_loss(render_color, gt_color, loss="L1").sum(-1)
    loss_col = rendering.reduce_masked_loss(loss_col_raw * mask_so, mask_so)

    loss_opacity_raw = rendering.render_loss(
        render_opacity, mask_obj.to(render_opacity.dtype), loss="L1")
    loss_opacity = rendering.reduce_masked_loss(loss_opacity_raw * mask_sem, mask_sem)

    per_obj = loss_depth + loss_col * color_scaling + loss_opacity * opacity_scaling

    loss_pf_raw = None
    if gt_partfeat is not None and pred_partfeat_hidden is not None:
        render_hidden = rendering.render(
            termination[..., None], pred_partfeat_hidden, axis=-2)
        loss_pf_raw = factored_cosine_loss(
            partfeat_head, render_hidden, render_opacity, gt_partfeat,
            compute_dtype=compute_dtype)
    elif gt_partfeat is not None and pred_partfeat is not None:
        render_partfeat = rendering.render(
            termination[..., None], pred_partfeat, axis=-2)
        loss_pf_raw = rendering.render_loss(
            render_partfeat, gt_partfeat.to(torch.float32), loss="cos")
    if loss_pf_raw is not None:
        loss_pf = rendering.reduce_masked_loss(loss_pf_raw * mask_so, mask_so)
        per_obj = per_obj + loss_pf * partfeat_scaling

    if active is not None:
        per_obj = per_obj * active.to(per_obj.dtype)

    return per_obj.sum(), per_obj

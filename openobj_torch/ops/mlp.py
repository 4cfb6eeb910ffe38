"""The per-object occupancy/color/CLIP field MLP, as plain functions.

Port of ``openobj_tpu.ops.mlp``:

  trunk:  in_layer(emb1 -> h) -> mid1(h -> h) -> cat_layer(h+emb1 -> h)
          -> mid2(h -> h), all Linear+ReLU;
  heads:  out_alpha(h -> 1), raw * 10;
          color_linear(h+emb2 -> h)+ReLU -> out_color(h -> 3) -> sigmoid;
          clip_linear(h+emb2 -> h)+ReLU -> out_clip(h -> clip_size), linear.

Params are nested dicts of (weight ``w`` [in, out], bias ``b`` [out]). A
stack of O objects carries a leading [O] axis on every leaf, and the
ensemble then runs as batched matmuls. Xavier-normal weights, zero biases.

``compute_dtype="bf16"`` rounds both operands of every matmul to bf16 and
multiplies in f32 (a bf16 product is exact in f32), as the JAX package's
``jnp.dot(x.astype(bf16), w.astype(bf16), preferred_element_type=f32)``;
biases add in f32. Autograd through the casts rounds each operand's
gradient to bf16, as the transpose of that JAX product does: this is the
JAX package's XLA field at bf16, the path taken where the fused kernels do
not cover a shape. Params stay f32 masters.
"""

from __future__ import annotations

import torch

ALPHA_SCALE = 10.0  # UniSurf raw-density scale (reference model.py:88)


def _xavier_normal(gen, lead: tuple, fan_in: int, fan_out: int, device):
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return std * torch.randn((*lead, fan_in, fan_out), generator=gen,
                             dtype=torch.float32, device=device)


def _linear_init(gen, lead, fan_in: int, fan_out: int, device) -> dict:
    return {
        "w": _xavier_normal(gen, lead, fan_in, fan_out, device),
        "b": torch.zeros((*lead, fan_out), dtype=torch.float32, device=device),
    }


def init_mlp_params(
    gen: torch.Generator,
    emb_size1: int = 87,
    emb_size2: int = 42,
    hidden: int = 32,
    clip_size: int = 512,
    do_color: bool = True,
    do_clip: bool = True,
    device="cuda",
    lead: tuple = (),
) -> dict:
    """``lead`` prepends axes to every leaf (``(O,)`` for a stack)."""
    p = {
        "in_layer": _linear_init(gen, lead, emb_size1, hidden, device),
        "mid1": _linear_init(gen, lead, hidden, hidden, device),
        "cat_layer": _linear_init(gen, lead, hidden + emb_size1, hidden, device),
        "mid2": _linear_init(gen, lead, hidden, hidden, device),
        "out_alpha": _linear_init(gen, lead, hidden, 1, device),
    }
    if do_color:
        p["color_linear"] = _linear_init(gen, lead, hidden + emb_size2, hidden, device)
        p["out_color"] = _linear_init(gen, lead, hidden, 3, device)
    if do_clip:
        p["clip_linear"] = _linear_init(gen, lead, hidden + emb_size2, hidden, device)
        p["out_clip"] = _linear_init(gen, lead, hidden, clip_size, device)
    return p


def _bias(b: torch.Tensor) -> torch.Tensor:
    # b [out] or [O, out] against y [M, out] or [O, M, out]
    return b.unsqueeze(-2)


def _matmul(x: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    if bf16:
        x, w = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    return torch.matmul(x, w)


def _linear(p: dict, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    return _matmul(x, p["w"], bf16) + _bias(p["b"])


def _segments_linear_relu(p: dict, segs, bf16: bool = False) -> torch.Tensor:
    """relu(concat(segs) @ w + b) as a sum of row-partitioned matmuls."""
    w = p["w"]
    ofs, y = 0, None
    for s in segs:
        k = s.shape[-1]
        term = _matmul(s, w[..., ofs:ofs + k, :], bf16)
        ofs += k
        y = term if y is None else y + term
    return torch.relu(y + _bias(p["b"]))


def mlp_apply(
    params: dict,
    emb,
    emb_size1: int = 87,
    do_alpha: bool = True,
    do_color: bool = True,
    do_clip: bool = True,
    clip_hidden_only: bool = False,
    compute_dtype: str = "f32",
):
    """Evaluate the field at embedded points.

    emb: [(O,) M, emb_size1 + emb_size2], or the unconcatenated PE pieces
    ``(t, sins)``. Returns (alpha [.., 1] | None, color [.., 3] | None,
    clip [.., clip_size] | None); ``clip_hidden_only`` returns the h-wide
    clip hidden instead of the projected feature (see ``clip_project``).
    """
    if compute_dtype not in ("f32", "bf16"):
        raise ValueError(f"compute_dtype={compute_dtype!r}: 'f32' or 'bf16'")
    bf16 = compute_dtype == "bf16"
    if isinstance(emb, tuple):
        t, sins = emb
        n_raw = t.shape[-1]
        e1_segs = [t, sins[..., : emb_size1 - n_raw]]
        e2_segs = [sins[..., emb_size1 - n_raw:]]
    else:
        e1_segs = [emb[..., :emb_size1]]
        e2_segs = [emb[..., emb_size1:]]

    h = _segments_linear_relu(params["in_layer"], e1_segs, bf16)
    h = torch.relu(_linear(params["mid1"], h, bf16))
    h = _segments_linear_relu(params["cat_layer"], [h] + e1_segs, bf16)
    h = torch.relu(_linear(params["mid2"], h, bf16))

    alpha = None
    if do_alpha:
        alpha = _linear(params["out_alpha"], h, bf16) * ALPHA_SCALE

    color = None
    if do_color and "out_color" in params:
        hc = _segments_linear_relu(params["color_linear"], [h] + e2_segs, bf16)
        color = torch.sigmoid(_linear(params["out_color"], hc, bf16))

    clip = None
    if do_clip and "out_clip" in params:
        hf = _segments_linear_relu(params["clip_linear"], [h] + e2_segs, bf16)
        clip = hf if clip_hidden_only else _linear(params["out_clip"], hf, bf16)
    return alpha, color, clip


def clip_project(params: dict, hidden: torch.Tensor,
                 opacity: torch.Tensor | None = None) -> torch.Tensor:
    """Apply the final (linear) clip head to possibly ray-composited hidden
    features. ``w`` may carry a leading object axis [O, h, C] with hidden
    [O, ..., h]. Pass ``opacity`` (sum of termination weights) when
    ``hidden`` is composited, so that the bias is weighted by sum(w)."""
    w, b = params["out_clip"]["w"], params["out_clip"]["b"]
    if w.ndim == 3:
        y = torch.einsum("o...h,ohc->o...c", hidden, w)
        b = b.reshape(b.shape[0], *([1] * (y.ndim - 2)), b.shape[-1])
    else:
        y = hidden @ w
    if opacity is not None:
        return y + opacity[..., None] * b
    return y + b


"""Icosphere-projection frequency positional encoding.

Port of ``openobj_tpu.ops.embedding``: the input point is divided by a
per-object scale, projected onto 21 icosphere half-vertex directions, each
projection multiplied by frequency bands 2^0..2^max_deg, passed through
sin(x * pi), and concatenated after the scaled raw point. With max_deg = 5
the embedding is 3 + 21*6 = 129 wide, split 87 / 42 between the density
trunk and the color/feature heads.

The direction table is a trainable per-object [21, 3] matrix; ``scale`` is
a constant carried in the param dict and never receives a gradient.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# 21 icosphere half-vertex directions (reference embedding.py:15-37).
ICOSPHERE_DIRS = np.array(
    [
        [0.8506508, 0.0, 0.5257311],
        [0.809017, 0.5, 0.309017],
        [0.5257311, 0.8506508, 0.0],
        [1.0, 0.0, 0.0],
        [0.809017, 0.5, -0.309017],
        [0.8506508, 0.0, -0.5257311],
        [0.309017, 0.809017, -0.5],
        [0.0, 0.5257311, -0.8506508],
        [0.5, 0.309017, -0.809017],
        [0.0, 1.0, 0.0],
        [-0.5257311, 0.8506508, 0.0],
        [-0.309017, 0.809017, -0.5],
        [0.0, 0.5257311, 0.8506508],
        [-0.309017, 0.809017, 0.5],
        [0.309017, 0.809017, 0.5],
        [0.5, 0.309017, 0.809017],
        [0.5, -0.309017, 0.809017],
        [0.0, 0.0, 1.0],
        [-0.5, 0.309017, 0.809017],
        [-0.809017, 0.5, 0.309017],
        [-0.809017, 0.5, -0.309017],
    ],
    dtype=np.float32,
)

N_DIRS = ICOSPHERE_DIRS.shape[0]  # 21


def n_freqs(max_deg: int, min_deg: int = 0) -> int:
    return max_deg - min_deg + 1


def frequency_bands(max_deg: int, min_deg: int = 0, device="cpu") -> torch.Tensor:
    """2^min_deg .. 2^max_deg, one per integer degree."""
    return torch.as_tensor(
        2.0 ** np.linspace(min_deg, max_deg, n_freqs(max_deg, min_deg)),
        dtype=torch.float32, device=device,
    )


def embedding_dim(max_deg: int = 5, min_deg: int = 0) -> int:
    return 3 + N_DIRS * n_freqs(max_deg, min_deg)


def embedding_split(max_deg: int = 5) -> tuple[int, int]:
    """(emb_size1, emb_size2): scaled point + first 4 bands / the rest."""
    size1 = N_DIRS * 4 + 3
    return size1, embedding_dim(max_deg) - size1


def init_pe_params(scale: float, device="cuda") -> dict:
    return {
        "dirs": torch.as_tensor(ICOSPHERE_DIRS, device=device).clone(),
        "scale": torch.tensor(scale, dtype=torch.float32, device=device),
    }


def project(t: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """proj[..., d] = t[..., :] . dirs[d, :] in full float32.

    Evaluated as a fused multiply-add chain, acc = t0 d0, then
    acc = fma(t1, d1, acc), acc = fma(t2, d2, acc), never as a matmul, so
    that no TF32 or reduced-precision path can touch it: the phases it feeds
    reach 2^max_deg * pi, where one ulp of proj is already ~4e-6 of sine.
    Each fma is formed in float64, where the product of two float32 values
    is exact, and rounded once to float32 (float64 inputs stay float64).
    ``t`` is [..., M, 3] and ``dirs`` [..., 21, 3] with matching leading
    dims (or none)."""
    d = dirs.unsqueeze(-3)                       # [..., 1, 21, 3]
    x = t.unsqueeze(-2)                          # [..., M, 1, 3]
    acc = x[..., 0] * d[..., 0]
    for c in (1, 2):
        acc = (x[..., c].double() * d[..., c].double() + acc.double()).to(t.dtype)
    return acc


def _expand_scale(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return scale.reshape(scale.shape + (1,) * (x.ndim - scale.ndim))


def positional_encoding(
    pe_params: dict, x: torch.Tensor, max_deg: int = 5, min_deg: int = 0,
    impl: str = "recurrence", concat: bool = True,
):
    """Encode points ``x`` [..., M, 3] -> [..., M, 3 + 21 * n_freqs].

    ``pe_params`` leaves may carry a leading object axis ([O, 21, 3] dirs
    and [O] scale against x [O, M, 3]). The band layout is frequency-major /
    direction-minor: [t(3), sin(pi f0 proj(0..20)), sin(pi f1 proj), ...].

    impl "recurrence" (default) derives every band from one sin/cos pair by
    the double-angle identities; "direct" evaluates each band's sine.
    concat=False returns the pieces ``(t, sins)``.
    """
    scale = _expand_scale(pe_params["scale"].detach(), x)
    t = x / scale
    proj = project(t, pe_params["dirs"])
    f = n_freqs(max_deg, min_deg)
    if impl == "recurrence":
        # each doubling doubles an error in (s, c), so the seed pair is
        # taken correctly rounded (via float64) and 1 - 2 s^2 is one fused
        # multiply-add (formed in float64, rounded once)
        theta = (proj * (math.pi * (2.0 ** min_deg))).double()
        s, c = torch.sin(theta).to(proj.dtype), torch.cos(theta).to(proj.dtype)
        outs = [s]
        for _ in range(f - 1):
            s, c = 2.0 * s * c, (1.0 - 2.0 * s.double() * s.double()).to(proj.dtype)
            outs.append(s)
        sins = torch.cat(outs, dim=-1)
    elif impl == "direct":
        bands = frequency_bands(max_deg, min_deg, device=x.device)
        xb = proj.unsqueeze(-2) * bands[:, None]             # [..., F, 21]
        xb = xb.reshape(*proj.shape[:-1], -1)
        sins = torch.sin(xb * math.pi)
    else:
        raise ValueError(f"unknown positional encoding impl {impl!r}")
    if not concat:
        return t, sins
    return torch.cat([t, sins], dim=-1)

"""The stacked object-field forward/backward as one fused kernel pair.

Port of ``openobj_tpu.ops.fused_field``. The function is the whole field
per (object, point): icosphere positional encoding -> 4-layer trunk with
skip -> alpha / colour / clip-hidden heads. On a CUDA tensor it runs as the
hand-written kernels in ``openobj_torch/csrc/fused_field.cu`` (forward K1;
backward K2 plus a deterministic cross-tile reduction; on the tensor cores
at every hidden width that is a multiple of 16 up to 128, on the SIMT cores
at any other)
under a ``torch.autograd.Function``. On a CPU tensor it runs ``fused_field_plain``,
the plain PyTorch version of the same function (following the JAX kernel
body ``_fwd_body``), differentiated by autograd. A CUDA tensor never takes
the plain path.

Points receive no gradient: nothing upstream of them is trainable (poses
and z samples are data; the PE ``scale`` is a constant).

The 17 per-object parameter tensors are packed by ``_pack_params`` into one
row-major flat vector per object (``param_layout``); the packing is plain
``torch.cat``, so autograd splits the packed gradient back into the tree.
"""

from __future__ import annotations

import ctypes
import math

import torch

from openobj_torch.models import object_field
from openobj_torch.ops import embedding
from openobj_torch.ops.mlp import ALPHA_SCALE

_F32 = torch.float32
_E1, _E2, _ND, _NF = 87, 42, 21, 6

# launches of each kernel, calls of the plain version, and calls that took
# the eager field because the kernels do not cover them, as plain ints
COUNTS = {"fused_field_fwd": 0, "fused_field_bwd": 0,
          "fused_field_bwd_reduce": 0, "fused_field_plain": 0,
          "field_eager": 0}
# the kernels' launches by shape: (count name, O, N, h) -> launches
COUNTS_BY_SHAPE: dict[tuple[str, int, int, int], int] = {}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    COUNTS_BY_SHAPE.clear()


def _count(name: str, o: int, n: int, h: int) -> None:
    COUNTS[name] += 1
    key = (name, o, n, h)
    COUNTS_BY_SHAPE[key] = COUNTS_BY_SHAPE.get(key, 0) + 1


def param_layout(h: int) -> list[tuple[str, tuple[int, int]]]:
    """(name, (rows, cols)) in packed order; weights are [in, out]."""
    return [
        ("dirs", (_ND, 3)),
        ("w_in", (_E1, h)), ("b_in", (1, h)),
        ("w_mid1", (h, h)), ("b_mid1", (1, h)),
        ("w_cat", (h + _E1, h)), ("b_cat", (1, h)),
        ("w_mid2", (h, h)), ("b_mid2", (1, h)),
        ("w_alpha", (h, 1)), ("b_alpha", (1, 1)),
        ("w_col", (h + _E2, h)), ("b_col", (1, h)),
        ("w_oc", (h, 3)), ("b_oc", (1, 3)),
        ("w_clip", (h + _E2, h)), ("b_clip", (1, h)),
    ]


def packed_size(h: int) -> int:
    return sum(r * c for _, (r, c) in param_layout(h))


def _pack_params(params: dict, h: int, do_clip: bool) -> torch.Tensor:
    """Stacked param tree -> packed [O, packed_size(h)] float32."""
    m = params["mlp"]
    o = m["in_layer"]["w"].shape[0]
    if do_clip:
        clip_w, clip_b = m["clip_linear"]["w"], m["clip_linear"]["b"]
    else:
        dev = m["in_layer"]["w"].device
        clip_w = torch.zeros((o, h + _E2, h), dtype=_F32, device=dev)
        clip_b = torch.zeros((o, h), dtype=_F32, device=dev)
    pieces = [
        params["pe"]["dirs"],
        m["in_layer"]["w"], m["in_layer"]["b"],
        m["mid1"]["w"], m["mid1"]["b"],
        m["cat_layer"]["w"], m["cat_layer"]["b"],
        m["mid2"]["w"], m["mid2"]["b"],
        m["out_alpha"]["w"], m["out_alpha"]["b"],
        m["color_linear"]["w"], m["color_linear"]["b"],
        m["out_color"]["w"], m["out_color"]["b"],
        clip_w, clip_b,
    ]
    return torch.cat([x.reshape(o, -1).to(_F32) for x in pieces], dim=1)


def _unpack(wflat: torch.Tensor, h: int) -> dict:
    o = wflat.shape[0]
    out, ofs = {}, 0
    for name, (r, c) in param_layout(h):
        out[name] = wflat[:, ofs:ofs + r * c].reshape(o, r, c)
        ofs += r * c
    return out


def fused_field_plain(wflat: torch.Tensor, pts_scaled: torch.Tensor, h: int,
                      do_clip: bool):
    """Plain PyTorch version of K1 (its autograd is K2's plain version).

    wflat [O, P] packed params, pts_scaled [O, N, 3] points already divided
    by the per-object scale. Returns (alpha [O,N,1], color [O,N,3],
    hclip [O,N,h] | None)."""
    w = _unpack(wflat, h)
    t = pts_scaled
    proj = embedding.project(t, w["dirs"]).to(t.dtype)          # [O, N, 21], FP32 rounding
    sins = [torch.sin((math.pi * (2.0 ** k)) * proj) for k in range(_NF)]
    e1 = torch.cat([t] + sins[:4], dim=-1)                       # [O, N, 87]
    e2 = torch.cat(sins[4:], dim=-1)                             # [O, N, 42]
    w_cat, w_col, w_clip = w["w_cat"], w["w_col"], w["w_clip"]
    h1 = torch.relu(torch.bmm(e1, w["w_in"]) + w["b_in"])
    h2 = torch.relu(torch.bmm(h1, w["w_mid1"]) + w["b_mid1"])
    hc = torch.relu(torch.bmm(h2, w_cat[:, :h]) + torch.bmm(e1, w_cat[:, h:])
                    + w["b_cat"])
    h3 = torch.relu(torch.bmm(hc, w["w_mid2"]) + w["b_mid2"])
    alpha = (torch.bmm(h3, w["w_alpha"]) + w["b_alpha"]) * ALPHA_SCALE
    hcol = torch.relu(torch.bmm(h3, w_col[:, :h]) + torch.bmm(e2, w_col[:, h:])
                      + w["b_col"])
    color = torch.sigmoid(torch.bmm(hcol, w["w_oc"]) + w["b_oc"])
    hclip = None
    if do_clip:
        hclip = torch.relu(torch.bmm(h3, w_clip[:, :h])
                           + torch.bmm(e2, w_clip[:, h:]) + w["b_clip"])
    return alpha, color, hclip


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

_VP = ctypes.c_void_p
_INT = ctypes.c_int


def _lib(source="fused_field"):
    """The loaded, typed library of ``csrc/fused_field.cu`` (or of another
    copy of it with the same entry points, given as a path)."""
    from openobj_torch import kernels

    lib = kernels.load(source)
    if not getattr(lib, "_openobj_typed", False):
        lib.ff_param_count.argtypes = [_INT]
        lib.ff_param_count.restype = _INT
        for fn in (lib.ff_bwd_chunk, lib.ff_bwd_max_tile):
            fn.argtypes = [_INT]
            fn.restype = _INT
        if hasattr(lib, "ff_tc_width"):   # not in copies older than the width table
            lib.ff_tc_width.argtypes = [_INT]
            lib.ff_tc_width.restype = _INT
        lib.ff_forward.argtypes = [_VP] * 5 + [_INT] * 4 + [_VP]
        lib.ff_forward.restype = _INT
        lib.ff_backward.argtypes = [_VP] * 6 + [_INT] * 5 + [_VP]
        lib.ff_backward.restype = _INT
        lib.ff_reduce.argtypes = [_VP, _VP, _INT, _INT, _INT, _VP]
        lib.ff_reduce.restype = _INT
        lib._openobj_typed = True
    return lib


def tensor_core_width(h: int) -> bool:
    """Whether K1 and K2 run on the tensor cores at hidden width ``h`` (the
    library's width table, ``FF_TC_WIDTHS``: every multiple of 16 up to
    128); at any other width the SIMT kernels run."""
    return bool(_lib().ff_tc_width(h))


def kernel_names(h: int) -> dict:
    """The CUDA kernel behind each launch count at hidden width ``h``."""
    if tensor_core_width(h):
        fwd, bwd = f"ff_fwd_kernel<{h}>", f"ff_bwd_kernel<{h}>"
    else:
        fwd, bwd = "ff_fwd_generic_kernel", "ff_bwd_generic_kernel"
    return {"fused_field_fwd": fwd, "fused_field_bwd": bwd,
            "fused_field_bwd_reduce": "ff_reduce_kernel"}


def _check(x: torch.Tensor, name: str, shape: tuple) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != _F32:
        raise ValueError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def bwd_tile(o: int, n: int, chunk: int, n_sm: int, max_tile: int) -> int:
    """Points per backward block: a multiple of the chunk, at most
    ``max_tile``, that finishes in the least waves x tile length (a K2 block
    fills an SM); among equals, the one with the fewest blocks."""
    best = None
    for tile in range(chunk, min(max_tile, -(-n // chunk) * chunk) + 1, chunk):
        blocks = o * -(-n // tile)
        cost = (-(-blocks // n_sm) * tile, blocks)
        if best is None or cost < best[0]:
            best = (cost, tile)
    return best[1]


def bwd_tiling(lib, o: int, n: int, h: int, device) -> tuple[int, int]:
    """(tile, number of tiles) of K2 for O objects x N points on ``device``."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    tile = bwd_tile(o, n, lib.ff_bwd_chunk(h), n_sm, lib.ff_bwd_max_tile(h))
    return tile, -(-n // tile)


def fused_field_forward_cuda(wflat, pts, h: int, do_clip: bool):
    """Launch K1. Returns (alpha [O,N,1], color [O,N,3], hclip [O,N,h] |
    None)."""
    o, n, _ = pts.shape
    lib = _lib()
    p = lib.ff_param_count(h)
    _check(pts, "pts", (o, n, 3))
    _check(wflat, "wflat", (o, p))
    alpha = torch.empty((o, n, 1), dtype=_F32, device=pts.device)
    color = torch.empty((o, n, 3), dtype=_F32, device=pts.device)
    hclip = torch.empty((o, n, h), dtype=_F32, device=pts.device) if do_clip else None
    err = lib.ff_forward(pts.data_ptr(), wflat.data_ptr(), alpha.data_ptr(),
                         color.data_ptr(), hclip.data_ptr() if do_clip else None,
                         o, n, h, int(do_clip), _stream(pts))
    _raise_on(err, "fused_field forward")
    _count("fused_field_fwd", o, n, h)
    return alpha, color, hclip


def fused_field_backward_cuda(wflat, pts, d_alpha, d_color, d_hclip, h: int,
                              do_clip: bool):
    """Launch K2 and its reduction. Returns the packed gradient [O, P]."""
    o, n, _ = pts.shape
    lib = _lib()
    p = lib.ff_param_count(h)
    _check(pts, "pts", (o, n, 3))
    _check(wflat, "wflat", (o, p))
    _check(d_alpha, "d_alpha", (o, n, 1))
    _check(d_color, "d_color", (o, n, 3))
    if do_clip:
        _check(d_hclip, "d_hclip", (o, n, h))
    tile, n_tiles = bwd_tiling(lib, o, n, h, pts.device)
    part = torch.empty((o, n_tiles, p), dtype=_F32, device=pts.device)
    grad = torch.empty((o, p), dtype=_F32, device=pts.device)
    stream = _stream(pts)
    err = lib.ff_backward(pts.data_ptr(), wflat.data_ptr(), d_alpha.data_ptr(),
                          d_color.data_ptr(), d_hclip.data_ptr() if do_clip else None,
                          part.data_ptr(), o, n, h, int(do_clip), tile, stream)
    _raise_on(err, "fused_field backward")
    _count("fused_field_bwd", o, n, h)
    err = lib.ff_reduce(part.data_ptr(), grad.data_ptr(), o, n_tiles, p, stream)
    _raise_on(err, "fused_field backward reduction")
    _count("fused_field_bwd_reduce", o, n, h)
    return grad


class _FusedField(torch.autograd.Function):
    """K1 forward, K2 backward; no gradient to the points."""

    @staticmethod
    def forward(ctx, wflat, pts, h, do_clip):
        alpha, color, hclip = fused_field_forward_cuda(wflat, pts, h, do_clip)
        ctx.save_for_backward(wflat, pts)
        ctx.h, ctx.do_clip = h, do_clip
        if hclip is None:
            hclip = alpha.new_empty((0,))
        return alpha, color, hclip

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_alpha, d_color, d_hclip):
        wflat, pts = ctx.saved_tensors
        g = fused_field_backward_cuda(
            wflat, pts, d_alpha.contiguous(), d_color.contiguous(),
            d_hclip.contiguous() if ctx.do_clip else None, ctx.h, ctx.do_clip)
        return g, None, None, None


def fused_field_apply(wflat: torch.Tensor, pts_scaled: torch.Tensor, h: int,
                      do_clip: bool):
    """The kernel pair on a CUDA tensor, the plain version on a CPU one."""
    if pts_scaled.is_cuda:
        alpha, color, hclip = _FusedField.apply(
            wflat.contiguous(), pts_scaled.contiguous(), h, do_clip)
        return alpha, color, (hclip if do_clip else None)
    if pts_scaled.device.type != "cpu":
        raise ValueError(f"fused field: unsupported device {pts_scaled.device}")
    COUNTS["fused_field_plain"] += 1
    return fused_field_plain(wflat, pts_scaled, h, do_clip)


def kernels_cover(max_deg: int, compute_dtype: str) -> bool:
    """Whether the kernels compute a field call of this shape: the reference
    PE layout (``max_deg`` 5, the 87/42 split the packed layout hard-codes)
    and f32. K1 and K2 take any hidden width."""
    return max_deg == 5 and compute_dtype == "f32"


def field_evaluator(params: dict, stacked: bool, max_deg: int = 5,
                    do_clip: bool = True, compute_dtype: str = "f32"):
    """A function ``points -> (alpha, color, clip_hidden | None)`` for one
    field (``stacked=False``: points [..., 3]) or a stack (points
    [O, ..., 3]), the counterpart of ``object_field.field_apply(_stacked)(...,
    clip_hidden_only=True)``. Gradients flow to all field params, including
    the trainable PE direction table.

    Where the kernels cover the call (``kernels_cover``), the params are
    packed once, here, and every call runs K1 (K2 behind it under autograd;
    their plain version on a CPU tensor). Otherwise every call runs the
    eager field and counts one ``field_eager``. The choice is made on the
    shape alone, before anything is launched."""
    if not kernels_cover(max_deg, compute_dtype):
        apply = object_field.field_apply_stacked if stacked else object_field.field_apply

        def eager(points):
            COUNTS["field_eager"] += 1
            return apply(params, points, max_deg=max_deg, do_clip=do_clip,
                         clip_hidden_only=True, compute_dtype=compute_dtype)
        return eager

    sp = params if stacked else object_field.tree_map(lambda x: x.unsqueeze(0), params)
    h = sp["mlp"]["in_layer"]["w"].shape[-1]
    do_clip = do_clip and "clip_linear" in sp["mlp"]
    wflat = _pack_params(sp, h, do_clip)
    scale = sp["pe"]["scale"].detach()

    def fused(points):
        pts = points if stacked else points[None]
        o, lead = pts.shape[0], pts.shape[1:-1]
        pts_scaled = (pts.reshape(o, -1, 3) / scale[:, None, None]).detach()
        a, c, f = fused_field_apply(wflat, pts_scaled, h, do_clip)
        a, c = a.reshape(o, *lead, 1), c.reshape(o, *lead, 3)
        f = f.reshape(o, *lead, h) if do_clip else None
        if stacked:
            return a, c, f
        return a[0], c[0], (f[0] if f is not None else None)
    return fused


def _check_fused_shape(max_deg: int, compute_dtype: str) -> None:
    if max_deg != 5:
        # the packed layout hard-codes the 87/42 split (3 + 21*4 trunk rows,
        # 21*2 head rows); other band counts would mispack
        raise NotImplementedError(
            "the fused kernel supports the reference PE layout only "
            f"(max_deg=5, 87/42 split); got max_deg={max_deg}. "
            "Use object_field.field_apply_stacked for other layouts."
        )
    if compute_dtype != "f32":
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the fused field is f32 only so far")


def field_apply_stacked_fused(
    stacked_params: dict,
    points: torch.Tensor,     # [O, ..., 3]
    max_deg: int = 5,
    do_clip: bool = True,
    compute_dtype: str = "f32",
):
    """Counterpart of ``object_field.field_apply_stacked(...,
    clip_hidden_only=True)`` through the kernels: returns (alpha [O, ..., 1],
    color [O, ..., 3], clip_hidden [O, ..., h] | None)."""
    _check_fused_shape(max_deg, compute_dtype)
    return field_evaluator(stacked_params, stacked=True, do_clip=do_clip)(points)


def field_apply_fused(params: dict, points: torch.Tensor, max_deg: int = 5,
                      do_clip: bool = True, compute_dtype: str = "f32"):
    """Single-object wrapper (background model / eval paths)."""
    _check_fused_shape(max_deg, compute_dtype)
    return field_evaluator(params, stacked=False, do_clip=do_clip)(points)

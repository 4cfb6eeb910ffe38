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

``compute_dtype="bf16"`` is the JAX kernel's bf16 instantiation (``cdt``):
every product but the PE projection rounds both operands to bf16 (round to
nearest even) and sums in f32, biases are added in f32, and the backward
rounds the operands of every gradient product the same way (the dirs
gradient too) while bias gradients sum in f32. On the card that is K1 and
K2 built from ``csrc/fused_field_bf16.cu``; their plain version is
``fused_field_plain(..., "bf16")``, whose backward is written out
(``_PlainBf16``) because autograd through the casts would round each
weight gradient to bf16, which is the JAX package's XLA path and not its
kernel.

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

# launches of each kernel (K1 and K2 in f32 and in bf16; K2 bf16's weight
# conversion, which it launches first at the tensor-core widths; K2r serves
# both), calls of the plain version, and calls that took the eager field
# because the kernels do not cover them, as plain ints
COUNTS = {"fused_field_fwd": 0, "fused_field_bwd": 0,
          "fused_field_fwd_bf16": 0, "fused_field_bwd_bf16": 0,
          "fused_field_bwd_bf16_image": 0,
          "fused_field_bwd_reduce": 0, "fused_field_plain": 0,
          "field_eager": 0}
# the kernels' library and count names by compute dtype
_SOURCE = {"f32": "fused_field", "bf16": "fused_field_bf16"}
_FWD = {"f32": "fused_field_fwd", "bf16": "fused_field_fwd_bf16"}
_BWD = {"f32": "fused_field_bwd", "bf16": "fused_field_bwd_bf16"}
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
    """Stacked param tree -> packed [O, packed_size(h)] in the params'
    dtype (float32; float64 params, which only the plain version takes,
    stay float64)."""
    m = params["mlp"]
    o = m["in_layer"]["w"].shape[0]
    dt = m["in_layer"]["w"].dtype
    if do_clip:
        clip_w, clip_b = m["clip_linear"]["w"], m["clip_linear"]["b"]
    else:
        dev = m["in_layer"]["w"].device
        clip_w = torch.zeros((o, h + _E2, h), dtype=dt, device=dev)
        clip_b = torch.zeros((o, h), dtype=dt, device=dev)
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
    return torch.cat([x.reshape(o, -1).to(dt) for x in pieces], dim=1)


def leaf_errors(got: torch.Tensor, ref: torch.Tensor, h: int) -> dict:
    """{leaf: max|got - ref| / max|ref|} of two packed [O, P] tensors, by
    ``param_layout(h)``; 0 where both are zero."""
    out, ofs = {}, 0
    for name, (r, c) in param_layout(h):
        g, x = got[:, ofs:ofs + r * c], ref[:, ofs:ofs + r * c]
        ofs += r * c
        d, m = float((g - x).abs().max()), float(x.abs().max())
        out[name] = d / m if m > 0 else d
    return out


# K1 bf16 against the plain version in bf16. The two sum in other orders,
# so now and then an activation lands on the other side of a bf16 rounding
# boundary and the outputs after it move by about one bf16 ulp of one
# product. So at most this share of the outputs may be off by more than the
# f32 gate, none further off than the plain bf16 is from the plain f32
# anywhere in the tensor, and every output is finite; plain f32 in K1's
# place must fail the share. On an H100 the kernels' share at 1e-4 was
# 0 to 3.7e-3 at the main path's and the render's shapes and 1.1e-2 at most
# (alpha, [1, 1000] h=128, 11 entries); the plain f32's was 0.43 at least
# (the clip hidden, whose ReLU zeros agree).
BF16_OFF_FRAC = 3e-2


def bf16_output_errors(got: torch.Tensor, ref: torch.Tensor, ref32: torch.Tensor,
                       atol: float) -> dict:
    """One output of K1 bf16 (``got``) against the plain version's in bf16
    (``ref``) and in f32 (``ref32``), over every entry: ``off`` is the share
    with |got - ref| > atol, ``control_off`` the share that ``ref32`` in
    ``got``'s place shows, ``max_abs`` max|got - ref|, ``bf16_max``
    max|ref - ref32|; ``ok`` applies BF16_OFF_FRAC's gate."""
    d = (got - ref).abs()
    e = dict(off=float((d > atol).double().mean()),
             control_off=float(((ref32 - ref).abs() > atol).double().mean()),
             max_abs=float(d.max()), bf16_max=float((ref - ref32).abs().max()),
             finite=bool(torch.isfinite(got).all()))
    e["ok"] = (e["finite"] and e["off"] <= BF16_OFF_FRAC < e["control_off"]
               and e["max_abs"] <= e["bf16_max"])
    return e


def _unpack(wflat: torch.Tensor, h: int) -> dict:
    o = wflat.shape[0]
    out, ofs = {}, 0
    for name, (r, c) in param_layout(h):
        out[name] = wflat[:, ofs:ofs + r * c].reshape(o, r, c)
        ofs += r * c
    return out


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), as f32."""
    return x.to(torch.bfloat16).to(_F32)


def _bmm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b with both operands rounded to bf16 and f32 sums: the products
    of two bf16 values are exact in f32."""
    return torch.bmm(_round_bf16(a), _round_bf16(b))


def bf16_weight_image(wflat: torch.Tensor, h: int) -> torch.Tensor:
    """Plain version of K2 bf16's weight conversion (``ff_bf16_image_kernel``): each
    object's weights without their bias rows as bf16 (round to nearest
    even), [O, 5h + 272, h + 8]: w_in, w_mid1, w_cat's h2 rows, its e1 rows,
    w_mid2, w_col's h3 rows, its e2 rows, then w_clip's, each padded with
    zero rows to a multiple of 8 and with 8 zero columns."""
    w = _unpack(wflat, h)
    o = wflat.shape[0]

    def rows(x, n):
        return torch.cat([x, x.new_zeros((o, n - x.shape[1], h))], dim=1)

    parts = [rows(w["w_in"], 88), w["w_mid1"], w["w_cat"][:, :h], rows(w["w_cat"][:, h:], 88),
             w["w_mid2"], w["w_col"][:, :h], rows(w["w_col"][:, h:], 48),
             w["w_clip"][:, :h], rows(w["w_clip"][:, h:], 48)]
    img = torch.cat(parts, dim=1)
    img = torch.cat([img, img.new_zeros((o, img.shape[1], 8))], dim=2)
    return img.to(torch.bfloat16)


def _plain_forward(w: dict, t: torch.Tensor, h: int, do_clip: bool, mm):
    """The field on unpacked params with the product ``mm``; returns
    (alpha, color, hclip | None, activations)."""
    proj = embedding.project(t, w["dirs"]).to(t.dtype)          # [O, N, 21], FP32 rounding
    sins = [torch.sin((math.pi * (2.0 ** k)) * proj) for k in range(_NF)]
    e1 = torch.cat([t] + sins[:4], dim=-1)                       # [O, N, 87]
    e2 = torch.cat(sins[4:], dim=-1)                             # [O, N, 42]
    w_cat, w_col, w_clip = w["w_cat"], w["w_col"], w["w_clip"]
    h1 = torch.relu(mm(e1, w["w_in"]) + w["b_in"])
    h2 = torch.relu(mm(h1, w["w_mid1"]) + w["b_mid1"])
    hc = torch.relu(mm(h2, w_cat[:, :h]) + mm(e1, w_cat[:, h:]) + w["b_cat"])
    h3 = torch.relu(mm(hc, w["w_mid2"]) + w["b_mid2"])
    alpha = (mm(h3, w["w_alpha"]) + w["b_alpha"]) * ALPHA_SCALE
    hcol = torch.relu(mm(h3, w_col[:, :h]) + mm(e2, w_col[:, h:]) + w["b_col"])
    color = torch.sigmoid(mm(hcol, w["w_oc"]) + w["b_oc"])
    hclip = None
    if do_clip:
        hclip = torch.relu(mm(h3, w_clip[:, :h]) + mm(e2, w_clip[:, h:]) + w["b_clip"])
    acts = dict(proj=proj, e1=e1, e2=e2, h1=h1, h2=h2, hc=hc, h3=h3, hcol=hcol)
    return alpha, color, hclip, acts


def fused_field_plain(wflat: torch.Tensor, pts_scaled: torch.Tensor, h: int,
                      do_clip: bool, compute_dtype: str = "f32"):
    """Plain PyTorch version of K1 (its backward is K2's plain version:
    autograd in f32, ``_PlainBf16`` in bf16).

    wflat [O, P] packed params, pts_scaled [O, N, 3] points already divided
    by the per-object scale. Returns (alpha [O,N,1], color [O,N,3],
    hclip [O,N,h] | None)."""
    if compute_dtype == "bf16":
        alpha, color, hclip = _PlainBf16.apply(wflat, pts_scaled, h, do_clip)
        return alpha, color, (hclip if do_clip else None)
    if compute_dtype != "f32":
        raise ValueError(f"compute_dtype={compute_dtype!r}: 'f32' or 'bf16'")
    alpha, color, hclip, _ = _plain_forward(_unpack(wflat, h), pts_scaled, h, do_clip,
                                            torch.bmm)
    return alpha, color, hclip


def _plain_bf16_grad(wflat, t, d_alpha, d_color, d_hclip, h: int, do_clip: bool):
    """The packed gradient [O, P] of the bf16 field, as the JAX kernel's
    ``_bwd_kernel`` computes it: the forward recomputed in bf16 (its signs
    are the ReLU masks), every product's operands rounded to bf16 with f32
    sums, bias gradients summed in f32."""
    w = _unpack(wflat, h)
    _, color, hclip, a = _plain_forward(w, t, h, do_clip, _bmm_bf16)
    e1, e2, h1, h2, hc, h3, hcol = (a[k] for k in ("e1", "e2", "h1", "h2", "hc", "h3", "hcol"))

    def mmT(x, dy):      # x [O, N, in], dy [O, N, out] -> [O, in, out]
        return _bmm_bf16(x.transpose(1, 2), dy)

    def mmBT(dy, wm):    # dy [O, N, out], w [O, in, out] -> [O, N, in]
        return _bmm_bf16(dy, wm.transpose(1, 2))

    def bsum(dy):
        return dy.sum(dim=1, keepdim=True)

    g = {}
    dcol = d_color * color * (1.0 - color)                       # sigmoid'
    g["w_oc"], g["b_oc"] = mmT(hcol, dcol), bsum(dcol)
    d_hcol = mmBT(dcol, w["w_oc"]) * (hcol > 0)
    da = d_alpha * ALPHA_SCALE
    g["w_alpha"], g["b_alpha"] = mmT(h3, da), bsum(da)
    g["w_col"] = torch.cat([mmT(h3, d_hcol), mmT(e2, d_hcol)], dim=1)
    g["b_col"] = bsum(d_hcol)
    d_h3 = mmBT(da, w["w_alpha"]) + mmBT(d_hcol, w["w_col"][:, :h])
    d_e2 = mmBT(d_hcol, w["w_col"][:, h:])
    if do_clip:
        d_hclip = d_hclip * (hclip > 0)
        g["w_clip"] = torch.cat([mmT(h3, d_hclip), mmT(e2, d_hclip)], dim=1)
        g["b_clip"] = bsum(d_hclip)
        d_h3 = d_h3 + mmBT(d_hclip, w["w_clip"][:, :h])
        d_e2 = d_e2 + mmBT(d_hclip, w["w_clip"][:, h:])
    else:
        g["w_clip"], g["b_clip"] = torch.zeros_like(w["w_clip"]), torch.zeros_like(w["b_clip"])
    d_h3 = d_h3 * (h3 > 0)
    g["w_mid2"], g["b_mid2"] = mmT(hc, d_h3), bsum(d_h3)
    d_hc = mmBT(d_h3, w["w_mid2"]) * (hc > 0)
    g["w_cat"] = torch.cat([mmT(h2, d_hc), mmT(e1, d_hc)], dim=1)
    g["b_cat"] = bsum(d_hc)
    d_h2 = mmBT(d_hc, w["w_cat"][:, :h]) * (h2 > 0)
    d_e1 = mmBT(d_hc, w["w_cat"][:, h:])
    g["w_mid1"], g["b_mid1"] = mmT(h1, d_h2), bsum(d_h2)
    d_h1 = mmBT(d_h2, w["w_mid1"]) * (h1 > 0)
    g["w_in"], g["b_in"] = mmT(e1, d_h1), bsum(d_h1)
    d_e1 = d_e1 + mmBT(d_h1, w["w_in"])
    # PE: d_proj = sum_k pi 2^k cos(pi 2^k proj) d_sin_k, in band order
    proj = a["proj"]
    d_proj = torch.zeros_like(proj)
    for k in range(_NF):
        ds = d_e1[..., 3 + _ND * k: 3 + _ND * (k + 1)] if k < 4 else \
            d_e2[..., _ND * (k - 4): _ND * (k - 3)]
        f = math.pi * (2.0 ** k)
        d_proj = d_proj + (f * torch.cos(f * proj)) * ds
    g["dirs"] = mmT(d_proj, t)                                   # [O, 21, 3]
    o = wflat.shape[0]
    return torch.cat([g[name].reshape(o, -1) for name, _ in param_layout(h)], dim=1)


class _PlainBf16(torch.autograd.Function):
    """The plain bf16 field: forward by ``_plain_forward`` with bf16
    products, backward by ``_plain_bf16_grad``; no gradient to the points."""

    @staticmethod
    def forward(ctx, wflat, pts, h, do_clip):
        alpha, color, hclip, _ = _plain_forward(_unpack(wflat, h), pts, h, do_clip, _bmm_bf16)
        ctx.save_for_backward(wflat, pts)
        ctx.h, ctx.do_clip = h, do_clip
        return alpha, color, (hclip if do_clip else alpha.new_empty((0,)))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_alpha, d_color, d_hclip):
        wflat, pts = ctx.saved_tensors
        g = _plain_bf16_grad(wflat, pts, d_alpha, d_color, d_hclip if ctx.do_clip else None,
                             ctx.h, ctx.do_clip)
        return g, None, None, None


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

_VP = ctypes.c_void_p
_INT = ctypes.c_int


def _lib(source="fused_field"):
    """The loaded, typed library of ``csrc/fused_field.cu`` (``"fused_field_bf16"``:
    its bf16 instantiation; or another copy with the same entry points,
    given as a path)."""
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
        if hasattr(lib, "ff_bwd_scratch"):   # nor older than K2 bf16's weight images
            lib.ff_bwd_scratch.argtypes = [_INT, _INT]
            lib.ff_bwd_scratch.restype = _INT
        if hasattr(lib, "ff_fwd_launch"):    # nor older than K1 bf16's own kernel
            lib.ff_fwd_launch.argtypes = [_INT, _INT, _INT, _VP]
            lib.ff_fwd_launch.restype = _INT
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


def kernel_names(h: int, compute_dtype: str = "f32") -> dict:
    """The CUDA kernel behind each launch count at hidden width ``h``
    (in bf16: the kernels of ``csrc/fused_field_bf16.cu``, named with
    " bf16"; at the tensor-core widths its K1 is ``ff_fwd_bf16_kernel``
    and its K2 ``ff_bwd_bf16_kernel``, behind the weight conversion
    ``ff_bf16_image_kernel``)."""
    tc = tensor_core_width(h)
    fwd, bwd = ((f"ff_fwd_kernel<{h}>", f"ff_bwd_kernel<{h}>") if tc
                else ("ff_fwd_generic_kernel", "ff_bwd_generic_kernel"))
    if compute_dtype != "bf16":
        return {_FWD[compute_dtype]: fwd, _BWD[compute_dtype]: bwd,
                "fused_field_bwd_reduce": "ff_reduce_kernel"}
    out = {_FWD[compute_dtype]: (f"ff_fwd_bf16_kernel<{h}>" if tc else fwd) + " bf16",
           _BWD[compute_dtype]: (f"ff_bwd_bf16_kernel<{h}>" if tc else bwd) + " bf16",
           "fused_field_bwd_reduce": "ff_reduce_kernel"}
    if tc:
        out["fused_field_bwd_bf16_image"] = "ff_bf16_image_kernel bf16"
    return out


def fwd_launch(lib, o: int, n: int, h: int) -> dict:
    """The launch K1 of ``lib`` makes for O objects x N points at width h
    (``ff_fwd_launch``): blocks resident on an SM (the occupancy the tile
    rule counts), points a block, blocks, dynamic shared memory in bytes,
    points a chunk, and whether K1 bf16 streams its weights through its
    ring (else they are on chip, or it is another K1)."""
    out = (ctypes.c_int * 6)()
    _raise_on(lib.ff_fwd_launch(o, n, h, ctypes.addressof(out)), "ff_fwd_launch")
    plan = dict(zip(("blocks_per_sm", "tile", "blocks", "smem", "chunk", "ring"), out))
    plan["ring"] = bool(plan["ring"])
    return plan


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


def bwd_scratch(lib, o: int, n_tiles: int, h: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(buffer, slots): the scratch ``ff_backward`` takes, one f32 buffer
    whose first O x T x P floats are the per-tile gradient slots (``slots``,
    a view [O, T, P], what K2r sums) and whose rest (``ff_bwd_scratch``;
    none in copies without it) holds K2 bf16's weight images."""
    p = lib.ff_param_count(h)
    extra = lib.ff_bwd_scratch(o, h) if hasattr(lib, "ff_bwd_scratch") else 0
    buf = torch.empty(o * n_tiles * p + extra, dtype=_F32, device=device)
    return buf, buf[:o * n_tiles * p].view(o, n_tiles, p)


def bwd_image(buf: torch.Tensor, o: int, n_tiles: int, h: int) -> torch.Tensor:
    """The bf16 weight images that K2 bf16 wrote into ``buf`` (the scratch of
    ``bwd_scratch``, 16-byte aligned) after its O x T slots: [O, 5h + 272,
    h + 8], what ``bf16_weight_image`` computes, from the first 16-byte
    boundary after the slots."""
    rows = 5 * h + 272
    start = -(-o * n_tiles * packed_size(h) // 4) * 4
    return buf[start:start + o * rows * (h + 8) // 2].view(torch.bfloat16).view(o, rows, h + 8)


def fused_field_forward_cuda(wflat, pts, h: int, do_clip: bool, compute_dtype: str = "f32"):
    """Launch K1 (of the ``compute_dtype`` build). Returns (alpha [O,N,1],
    color [O,N,3], hclip [O,N,h] | None)."""
    o, n, _ = pts.shape
    lib = _lib(_SOURCE[compute_dtype])
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
    _count(_FWD[compute_dtype], o, n, h)
    return alpha, color, hclip


def fused_field_backward_cuda(wflat, pts, d_alpha, d_color, d_hclip, h: int,
                              do_clip: bool, compute_dtype: str = "f32"):
    """Launch K2 (of the ``compute_dtype`` build) and its reduction.
    Returns the packed gradient [O, P]."""
    o, n, _ = pts.shape
    lib = _lib(_SOURCE[compute_dtype])
    p = lib.ff_param_count(h)
    _check(pts, "pts", (o, n, 3))
    _check(wflat, "wflat", (o, p))
    _check(d_alpha, "d_alpha", (o, n, 1))
    _check(d_color, "d_color", (o, n, 3))
    if do_clip:
        _check(d_hclip, "d_hclip", (o, n, h))
    tile, n_tiles = bwd_tiling(lib, o, n, h, pts.device)
    buf, part = bwd_scratch(lib, o, n_tiles, h, pts.device)
    grad = torch.empty((o, p), dtype=_F32, device=pts.device)
    stream = _stream(pts)
    err = lib.ff_backward(pts.data_ptr(), wflat.data_ptr(), d_alpha.data_ptr(),
                          d_color.data_ptr(), d_hclip.data_ptr() if do_clip else None,
                          buf.data_ptr(), o, n, h, int(do_clip), tile, stream)
    _raise_on(err, "fused_field backward")
    if compute_dtype == "bf16" and lib.ff_tc_width(h):   # the weight images first
        _count("fused_field_bwd_bf16_image", o, n, h)
    _count(_BWD[compute_dtype], o, n, h)
    err = lib.ff_reduce(part.data_ptr(), grad.data_ptr(), o, n_tiles, p, stream)
    _raise_on(err, "fused_field backward reduction")
    _count("fused_field_bwd_reduce", o, n, h)
    return grad


class _FusedField(torch.autograd.Function):
    """K1 forward, K2 backward; no gradient to the points."""

    @staticmethod
    def forward(ctx, wflat, pts, h, do_clip, compute_dtype):
        alpha, color, hclip = fused_field_forward_cuda(wflat, pts, h, do_clip, compute_dtype)
        ctx.save_for_backward(wflat, pts)
        ctx.h, ctx.do_clip, ctx.compute_dtype = h, do_clip, compute_dtype
        if hclip is None:
            hclip = alpha.new_empty((0,))
        return alpha, color, hclip

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_alpha, d_color, d_hclip):
        wflat, pts = ctx.saved_tensors
        g = fused_field_backward_cuda(
            wflat, pts, d_alpha.contiguous(), d_color.contiguous(),
            d_hclip.contiguous() if ctx.do_clip else None, ctx.h, ctx.do_clip,
            ctx.compute_dtype)
        return g, None, None, None, None


def fused_field_apply(wflat: torch.Tensor, pts_scaled: torch.Tensor, h: int,
                      do_clip: bool, compute_dtype: str = "f32"):
    """The kernel pair on a CUDA tensor, the plain version on a CPU one."""
    if compute_dtype not in _SOURCE:
        raise ValueError(f"compute_dtype={compute_dtype!r}: 'f32' or 'bf16'")
    if pts_scaled.is_cuda:
        alpha, color, hclip = _FusedField.apply(
            wflat.contiguous(), pts_scaled.contiguous(), h, do_clip, compute_dtype)
        return alpha, color, (hclip if do_clip else None)
    if pts_scaled.device.type != "cpu":
        raise ValueError(f"fused field: unsupported device {pts_scaled.device}")
    COUNTS["fused_field_plain"] += 1
    return fused_field_plain(wflat, pts_scaled, h, do_clip, compute_dtype)


def kernels_cover(max_deg: int, compute_dtype: str) -> bool:
    """Whether the kernels compute a field call of this shape: the reference
    PE layout (``max_deg`` 5, the 87/42 split the packed layout hard-codes),
    in f32 or bf16. K1 and K2 take any hidden width."""
    return max_deg == 5 and compute_dtype in _SOURCE


def field_evaluator(params: dict, stacked: bool, max_deg: int = 5,
                    do_clip: bool = True, compute_dtype: str = "f32"):
    """A function ``points -> (alpha, color, clip_hidden | None)`` for one
    field (``stacked=False``: points [..., 3]) or a stack (points
    [O, ..., 3]), the counterpart of ``object_field.field_apply(_stacked)(...,
    clip_hidden_only=True)``. Gradients flow to all field params, including
    the trainable PE direction table.

    Where the kernels cover the call (``kernels_cover``), the params are
    packed once, here, and every call runs K1 (K2 behind it under autograd;
    their plain version on a CPU tensor) of the compute dtype. Otherwise
    every call runs the eager field and counts one ``field_eager``. The
    choice is made on the shape alone, before anything is launched."""
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
        a, c, f = fused_field_apply(wflat, pts_scaled, h, do_clip, compute_dtype)
        a, c = a.reshape(o, *lead, 1), c.reshape(o, *lead, 3)
        f = f.reshape(o, *lead, h) if do_clip else None
        if stacked:
            return a, c, f
        return a[0], c[0], (f[0] if f is not None else None)
    return fused


def _check_fused_shape(max_deg: int) -> None:
    if max_deg != 5:
        # the packed layout hard-codes the 87/42 split (3 + 21*4 trunk rows,
        # 21*2 head rows); other band counts would mispack
        raise NotImplementedError(
            "the fused kernel supports the reference PE layout only "
            f"(max_deg=5, 87/42 split); got max_deg={max_deg}. "
            "Use object_field.field_apply_stacked for other layouts."
        )


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
    _check_fused_shape(max_deg)
    return field_evaluator(stacked_params, stacked=True, do_clip=do_clip,
                           compute_dtype=compute_dtype)(points)


def field_apply_fused(params: dict, points: torch.Tensor, max_deg: int = 5,
                      do_clip: bool = True, compute_dtype: str = "f32"):
    """Single-object wrapper (background model / eval paths)."""
    _check_fused_shape(max_deg)
    return field_evaluator(params, stacked=False, do_clip=do_clip,
                           compute_dtype=compute_dtype)(points)

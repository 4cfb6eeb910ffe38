"""View synthesis from object fields and multi-object z-buffer compositing.

Port of the JAX package's ``core.renderer``:

  * per-object render (``render_rays_obb``, ``render_object_view``): rays
    intersected with the object's oriented box in the box frame, ``n_bins``
    stratified jittered bins over [near, far + 0.2] whose pairwise midpoints
    are the samples, occupancy -> termination, opacity < 0.9 transparent,
    rendered depth outside [near, far] rejected;
  * ``composite_views``: per-object renders merged by z-buffer on the host,
    background ids excluded from the depth buffer;
  * ``render_frame_batched``: every object of a stack at one pose, each
    object evaluating only the rays that hit its box (compaction to a fixed
    cap ``max_hit_rays``), composited by a z-buffer on the device; on a
    split object axis (``parallel.sharding``) each rank renders its block
    and the blocks merge in rank order; ``obb_hit_counts`` sizes the cap;
    ``render_frame_bucketed`` gives small objects proportionally fewer
    bins (``bucket_bin_counts``);
  * ``two_pass``: an alpha-only probe (``_probe_tighten``) narrows each
    ray's interval around the surface before the full pass.

Every field evaluation goes through ``ops.fused_field.field_evaluator``,
forward only: the kernel K1 on a CUDA tensor, its plain version on a CPU
tensor, the eager field where the kernels do not cover the shape. The params
are packed once per render. Where the JAX package maps a chunk over objects
(``lax.map``), ``render_frame_batched`` evaluates all objects of a chunk in
one K1 launch over [O, chunk * bins, 3]; the probe computes the colour head
too (K1 has no alpha-only mode), which costs time and leaves alpha as it is.
The chunks run one after another, so a frame never holds more than one
chunk's points.

Random jitter is drawn from a ``torch.Generator`` in place of a JAX key, by
``_uniform`` alone, so the draws follow the JAX package's law, not its bits.
``compute_dtype="bf16"`` evaluates the field in bf16: K1's bf16 build on a
CUDA tensor (products on bf16-rounded operands, f32 sums and biases), its
plain version on a CPU tensor; the JAX package evaluates its XLA field in
bf16 here, whose forward rounds the same operands.
"""

from __future__ import annotations

import numpy as np
import torch

from openobj_torch.models import object_field
from openobj_torch.ops import fused_field, mlp, rendering, sampling
from openobj_torch.parallel import sharding

_F32 = torch.float32


def _uniform(gen: torch.Generator, shape: tuple, device) -> torch.Tensor:
    """U(0, 1) jitter of the stratified bins; the renderer's only draw."""
    return torch.rand(shape, generator=gen, device=device)


def _bin_midpoints(gen, near, far, n_bins: int, rows=None) -> torch.Tensor:
    """Stratified bins over [near, far] per ray (bin i starts at
    near + i * span / n_bins, plus U(0, span / n_bins) jitter), then the
    midpoints of neighbouring bins: [..., n_bins - 1]. ``rows=(start,
    total)``: ``near`` is rows start.. of a leading axis of ``total``, and
    the jitter is drawn for all of them and these rows kept, so that a
    block draws what the whole would."""
    span = far - near
    edges = torch.linspace(0.0, 1.0, n_bins + 1, device=near.device)[:-1]
    lower = span[..., None] * edges + near[..., None]
    if rows is None:
        u = _uniform(gen, (*near.shape, n_bins), near.device)
    else:
        u = _uniform(gen, (rows[1], *near.shape[1:], n_bins), near.device)
        u = u[rows[0]:rows[0] + near.shape[0]]
    z = lower + u * (span[..., None] / n_bins)
    return 0.5 * (z[..., 1:] + z[..., :-1])


def _evaluator(params, stacked: bool, max_deg: int, compute_dtype: str,
               do_clip: bool = False):
    return fused_field.field_evaluator(params, stacked=stacked, max_deg=max_deg,
                                       do_clip=do_clip, compute_dtype=compute_dtype)


def _rotate(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x [..., 3] -> x @ r (r [..., 3, 3] broadcast against x's lead), as
    elementwise products summed: exact f32 on every device."""
    return (x[..., 0:1] * r[..., 0, :] + x[..., 1:2] * r[..., 1, :]
            + x[..., 2:3] * r[..., 2, :])


def _composite(w, z, color):
    """(depth, colour, opacity) of termination weights w [..., P]."""
    return (rendering.render(w, z), rendering.render(w[..., None], color, axis=-2),
            torch.sum(w, dim=-1))


def _probe_tighten(
    field,                     # points -> (alpha, ...), as field_evaluator returns
    origins,                   # [..., 3] (broadcastable against near)
    dirs_w,                    # [..., 3]
    near,                      # [...]
    far,                       # [...]
    obj_center,
    n_probe: int,
    opacity_floor: float = 0.3,
    widen_bins: float = 3.0,
):
    """Alpha-only probe: n_probe deterministic bin midpoints over
    [near, far] -> termination-weighted surface depth -> a (near', far')
    window of +-widen_bins probe-bin widths around it. Rays whose probe
    opacity is below opacity_floor (no surface) keep [near, far]. The
    field comes prepared (packed once by the caller)."""
    e = torch.linspace(0.0, 1.0, n_probe + 1, device=near.device)
    mids = 0.5 * (e[1:] + e[:-1])
    span = far - near
    z = near[..., None] + span[..., None] * mids
    a, _, _ = field(sampling.rays_to_points(origins, dirs_w, z, obj_center))
    w = rendering.occupancy_to_termination(rendering.occupancy_activation(a[..., 0]))
    opacity = torch.sum(w, dim=-1)
    d = rendering.render(w, z) / torch.clamp(opacity, min=1e-6)
    delta = widen_bins * span / n_probe
    found = opacity > opacity_floor
    t0 = torch.where(found, torch.maximum(near, d - delta), near)
    t1 = torch.where(found, torch.minimum(far, d + delta), far)
    return t0, torch.maximum(t1, t0 + 1e-3)


@torch.no_grad()
def render_rays_obb(
    params: dict,
    origins: torch.Tensor,     # [N, 3] world
    dirs_w: torch.Tensor,      # [N, 3] world (z=1 convention, unnormalized)
    t_wo: torch.Tensor,        # [4, 4] OBB frame -> world
    extents: torch.Tensor,     # [3] OBB full extents
    obj_center: torch.Tensor,  # [3]
    gen: torch.Generator,
    n_bins: int = 150,
    max_deg: int = 5,
    chunk_size: int = 4096,
    opacity_thresh: float = 0.9,
    far_extension: float = 0.2,
    render_part: bool = False,
    two_pass: bool = False,
    n_probe: int = 32,
    compute_dtype: str = "f32",
):
    """Render depth/colour (and optionally part features) of N rays against
    one object field bounded by an oriented box. Returns a dict of hit [N]
    bool, depth [N], color [N, 3], opacity [N] (and partfeat [N, C])."""
    field = _evaluator(params, False, max_deg, compute_dtype, do_clip=render_part)
    probe = (_evaluator(params, False, max_deg, compute_dtype)
             if two_pass and render_part else field)
    rot = t_wo[:3, :3]
    o_obb = _rotate(origins - t_wo[:3, 3], rot)
    d_obb = _rotate(dirs_w, rot)
    near, far, hit = sampling.ray_box_intersection(o_obb, d_obb, -extents / 2.0,
                                                   extents / 2.0)
    near = torch.clamp(near, min=0.0)
    far = far + far_extension  # the camera may sit inside the box
    far_s = torch.where(far > near, far, near + 1e-3)

    depth, color, opacity, part = [], [], [], []
    for s in range(0, origins.shape[0], chunk_size):
        o_c, d_c = origins[s:s + chunk_size], dirs_w[s:s + chunk_size]
        nr, fr = near[s:s + chunk_size], far_s[s:s + chunk_size]
        if two_pass:
            nr, fr = _probe_tighten(probe, o_c, d_c, nr, fr, obj_center, n_probe)
        z = _bin_midpoints(gen, nr, fr, n_bins)
        a, c, f = field(sampling.rays_to_points(o_c, d_c, z, obj_center))
        w = rendering.occupancy_to_termination(rendering.occupancy_activation(a[..., 0]))
        d, col, op = _composite(w, z, c)
        depth.append(d)
        color.append(col)
        opacity.append(op)
        if render_part:
            # composite the h-wide clip hidden, project once per ray (exact:
            # the clip head is linear)
            hid = rendering.render(w[..., None], f, axis=-2)
            part.append(mlp.clip_project(params["mlp"], hid, opacity=op))
    depth, color, opacity = torch.cat(depth), torch.cat(color), torch.cat(opacity)
    valid = hit & (opacity >= opacity_thresh) & (depth >= near) & (depth <= far)
    out = {"hit": valid, "depth": depth, "color": color, "opacity": opacity}
    if render_part:
        out["partfeat"] = torch.cat(part)
    return out


def render_object_view(
    params: dict,
    obb,                      # utils.geometry.OrientedBox
    obj_center: np.ndarray,
    t_wc: np.ndarray,
    cam_dirs: torch.Tensor,   # [H, W, 3]
    gen: torch.Generator,
    n_bins: int = 150,
    render_part: bool = False,
    chunk_size: int = 4096,
    two_pass: bool = False,
    n_probe: int = 32,
    compute_dtype: str = "f32",
):
    """Full-frame render of one object; numpy arrays shaped [H, W, ...]."""
    h, w, _ = cam_dirs.shape
    dev = cam_dirs.device
    dirs_c = cam_dirs.reshape(-1, 3)
    t = torch.as_tensor(np.asarray(t_wc), dtype=_F32, device=dev)
    origins, dirs_w = sampling.origin_dirs_w(t.expand(dirs_c.shape[0], 4, 4), dirs_c)
    t_wo = np.eye(4, dtype=np.float32)
    t_wo[:3, :3] = obb.r
    t_wo[:3, 3] = obb.center
    out = render_rays_obb(
        params, origins, dirs_w, torch.as_tensor(t_wo, device=dev),
        torch.as_tensor(np.asarray(obb.extent), dtype=_F32, device=dev),
        torch.as_tensor(np.asarray(obj_center), dtype=_F32, device=dev), gen,
        n_bins=n_bins, chunk_size=chunk_size, render_part=render_part,
        two_pass=two_pass, n_probe=n_probe, compute_dtype=compute_dtype,
    )
    return {k: v.cpu().numpy().reshape((h, w) + tuple(v.shape[1:]))
            for k, v in out.items()}


def composite_views(
    views: dict[int, dict],
    class_of: dict[int, int],
    h: int,
    w: int,
    bg_ids=(0, 2, 3),
):
    """Z-buffer composite of per-object full-frame renders. ``views``:
    {obj_id: render_object_view output}; ``class_of``: {obj_id: semantic
    class id} for the maskid image. Background ids paint colour but never
    write the depth buffer; bg-vs-bg overlaps test against their own
    buffer."""
    rgb = np.zeros((h, w, 3), np.uint8)
    maskid = np.zeros((h, w), np.uint16)
    instid = np.zeros((h, w), np.int32)
    zbuf = np.full((h, w), 100.0, np.float32)
    bg_zbuf = np.full((h, w), 100.0, np.float32)
    for obj_id, v in views.items():
        if v is None:
            continue
        this_depth = np.where(v["hit"], v["depth"], 100.0)
        ok = zbuf > this_depth
        if obj_id in bg_ids:
            ok &= bg_zbuf > this_depth
        rgb[ok] = (np.clip(v["color"], 0, 1)[ok] * 255).astype(np.uint8)
        maskid[ok] = class_of.get(obj_id, 0)
        instid[ok] = obj_id
        if obj_id not in bg_ids:
            zbuf[ok] = this_depth[ok]
        else:
            bg_zbuf[ok] = this_depth[ok]
    depth = np.where(zbuf >= 100.0, 0.0, zbuf)
    return {"rgb": rgb, "depth": depth, "maskid": maskid, "instid": instid}


# --------------------------------------------------------------------------- #
# batched whole-frame rendering (all objects, one pass over the chunks)
# --------------------------------------------------------------------------- #


def _obb_ray_geometry(t_wo, extents, active, origins, dirs_w, far_extension):
    """Slab-test every ray against every OBB: (near, far, hit), each [O, N]."""
    rot = t_wo[:, None, :3, :3]                          # [O, 1, 3, 3]
    o_obb = _rotate(origins[None] - t_wo[:, None, :3, 3], rot)
    d_obb = _rotate(dirs_w[None], rot)
    half = extents[:, None, :] / 2.0
    near, far, hit = sampling.ray_box_intersection(o_obb, d_obb, -half, half)
    hit = hit & active[:, None]
    near = torch.clamp(near, min=0.0)
    far = torch.where(far > near, far, near + 1e-3) + far_extension
    return near, far, hit


@torch.no_grad()
def obb_hit_counts(t_wo, extents, active, origins, dirs_w) -> torch.Tensor:
    """Per-object OBB-hit ray counts [O] int32: the pre-pass that sizes
    ``render_frame_batched``'s ``max_hit_rays`` so nothing is cut."""
    _, _, hit = _obb_ray_geometry(t_wo, extents, active, origins, dirs_w, 0.0)
    return torch.sum(hit, dim=1).to(torch.int32)


def _compact(hit: torch.Tensor, m: int) -> torch.Tensor:
    """Per row, the indices of the first m hits in increasing order, filled
    with N (the row length) past the last: [O, m] int64."""
    o, n = hit.shape
    pos = torch.cumsum(hit, dim=1) - 1
    slot = torch.where(hit & (pos < m), pos, m)          # column m: discarded
    idx = torch.full((o, m + 1), n, dtype=torch.int64, device=hit.device)
    idx.scatter_(1, slot, torch.arange(n, device=hit.device).expand(o, n))
    return idx[:, :m]


@torch.no_grad()
def render_frame_batched(
    stacked_params: dict,      # leaves [O, ...] (fg stack or a gathered subset)
    t_wo: torch.Tensor,        # [O, 4, 4] OBB->world
    extents: torch.Tensor,     # [O, 3]
    centers: torch.Tensor,     # [O, 3] object centers (field-frame offsets)
    active: torch.Tensor,      # [O] bool
    origins: torch.Tensor,     # [N, 3] (one camera: all rows identical)
    dirs_w: torch.Tensor,      # [N, 3]
    gen: torch.Generator,
    n_bins: int = 150,
    max_deg: int = 5,
    max_hit_rays: int = 65536,
    chunk: int = 2048,
    opacity_thresh: float = 0.9,
    far_extension: float = 0.2,
    two_pass: bool = False,
    n_probe: int = 32,
    compute_dtype: str = "f32",
):
    """Render every object of a stack at one pose and z-buffer composite
    them on the device. Each object evaluates only the rays that hit its box
    (compacted in ray order to ``max_hit_rays``, padded with ray N); chunk
    by chunk, all objects' points go through the field in one call.

    Returns {"depth" [N] (inf = no hit), "winner" [N] int32 (index into the
    stack, -1 = none), "color" [N, 3], "n_hit" [O] int32}. ``n_hit`` is each
    object's true hit count: where ``n_hit[o] > max_hit_rays`` the surplus
    rays were not rendered, so callers size the cap from ``obb_hit_counts``.
    The z-buffer takes objects in stack order and a later object only where
    it is strictly nearer, as the JAX package's does.

    Inside ``sharding.use_mesh`` with the object axis split, and
    ``stacked_params`` this rank's block of the O objects (the boxes,
    centres and ``active`` whole), each rank renders its block, drawing
    each chunk's jitter for all O objects and keeping its rows, then the
    ranks' buffers merge in rank order, a later rank winning only where it
    is strictly nearer: every rank returns the unsharded result. A whole
    stack renders whole on every rank. The ranks of one "data" group
    render alike."""
    field = _evaluator(stacked_params, True, max_deg, compute_dtype)
    o_all, n, m = extents.shape[0], origins.shape[0], max_hit_rays
    o_count = _stack_size(stacked_params)
    n_shards = sharding.axis_size("object") if o_count != o_all else 1
    if o_count * n_shards != o_all:
        raise ValueError(
            f"a stack of {o_count} objects against {o_all} boxes: inside a mesh the "
            f"params are the whole stack or this rank's block of the 'object' axis "
            f"({sharding.axis_size('object')})")
    start = sharding.slot_offset(o_count) if n_shards > 1 else 0
    if n_shards > 1:
        t_wo, extents, centers, active = (x.narrow(0, start, o_count)
                                          for x in (t_wo, extents, centers, active))
    dev = origins.device

    near, far, hit = _obb_ray_geometry(t_wo, extents, active, origins, dirs_w,
                                       far_extension)
    n_hit = torch.sum(hit, dim=1).to(torch.int32)
    idx = _compact(hit, m)
    valid = idx < n
    idx_c = torch.clamp(idx, max=n - 1)
    near_g = torch.gather(near, 1, idx_c)                # [O, M]
    far_g = torch.gather(far, 1, idx_c)
    dirs_g = dirs_w[idx_c]                               # [O, M, 3]
    del near, far, hit
    origin = origins[0]
    center = centers[:, None, None, :]

    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m

    def _pad(x, fill=0.0):
        if pad == 0:
            return x
        return torch.cat([x, torch.full((o_count, pad, *x.shape[2:]), fill,
                                        dtype=x.dtype, device=dev)], dim=1)

    near_p, far_p, dirs_p = _pad(near_g), _pad(far_g, 1.0), _pad(dirs_g)
    depth_m = torch.empty((o_count, n_chunks * chunk), dtype=_F32, device=dev)
    opac_m = torch.empty_like(depth_m)
    color_m = torch.empty((o_count, n_chunks * chunk, 3), dtype=_F32, device=dev)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        nr, fr, dg = near_p[:, sl], far_p[:, sl], dirs_p[:, sl]
        if two_pass:
            nr, fr = _probe_tighten(field, origin, dg, nr, fr, center, n_probe)
        z = _bin_midpoints(gen, nr, fr, n_bins, rows=(start, o_all))
        a, col, _ = field(origin + dg[..., None, :] * z[..., None] - center)
        w = rendering.occupancy_to_termination(rendering.occupancy_activation(a[..., 0]))
        depth_m[:, sl], color_m[:, sl], opac_m[:, sl] = _composite(w, z, col)
    depth_m, color_m, opac_m = depth_m[:, :m], color_m[:, :m], opac_m[:, :m]

    ok = valid & (opac_m >= opacity_thresh) & (depth_m >= near_g) & (depth_m <= far_g)
    # buffers of N + 1 entries: writes that do not win go to entry N, dropped
    zb = torch.full((n + 1,), float("inf"), dtype=_F32, device=dev)
    win = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    rgbb = torch.zeros((n + 1, 3), dtype=_F32, device=dev)
    for o in range(o_count):
        i = idx[o]
        d = torch.where(ok[o], depth_m[o], float("inf"))
        upd = (d < zb[idx_c[o]]) & (i < n)
        tgt = torch.where(upd, i, n)
        zb[tgt] = d
        win[tgt] = start + o
        rgbb[tgt] = color_m[o]
    out = {"depth": zb[:n], "winner": win[:n], "color": rgbb[:n], "n_hit": n_hit}
    if n_shards > 1:
        out = _merge_blocks(out)
    return out


def _stack_size(stacked_params: dict) -> int:
    return stacked_params["mlp"]["in_layer"]["w"].shape[0]


def _merge_blocks(out: dict) -> dict:
    """Every rank's block render, gathered over "object" and merged in rank
    order: a later rank's object wins only where it is strictly nearer,
    the unsharded z-buffer's rule. ``n_hit`` becomes the whole [O]."""
    g = sharding.gather_objects({"depth": out["depth"][None], "winner": out["winner"][None],
                                 "color": out["color"][None], "n_hit": out["n_hit"]})
    depth, winner, color = g["depth"][0], g["winner"][0], g["color"][0]
    for r in range(1, g["depth"].shape[0]):
        better = g["depth"][r] < depth
        depth = torch.where(better, g["depth"][r], depth)
        winner = torch.where(better, g["winner"][r], winner)
        color = torch.where(better[:, None], g["color"][r], color)
    return {"depth": depth, "winner": winner, "color": color, "n_hit": g["n_hit"]}


# --------------------------------------------------------------------------- #
# adaptive per-object bin counts (bucketed dispatch)
# --------------------------------------------------------------------------- #


def bucket_bin_counts(
    extents,
    active,
    n_bins: int,
    min_bins: int = 24,
    levels=(1.0, 0.5, 0.25),
    far_extension: float = 0.2,
):
    """Per-object bin counts [O] (host, numpy) for the bucketed renderer:
    ``n_bins`` anchors the sampling density at the largest active box
    diagonal; smaller objects get proportionally fewer bins, quantized up to
    ``n_bins * level`` for the given levels (never sparser than the anchor),
    floor ``min_bins``."""
    ext = np.asarray(extents, np.float64)
    act = np.asarray(active, bool)
    spans = np.linalg.norm(ext, axis=1) + far_extension
    ref = float(spans[act].max()) if act.any() else 1.0
    need = n_bins * spans / max(ref, 1e-6)
    sizes = sorted({max(min_bins, int(round(n_bins * lv))) for lv in levels} | {n_bins})
    out = np.full(ext.shape[0], n_bins, np.int32)
    for o in np.nonzero(act)[0]:
        out[o] = next(s for s in sizes if s >= min(need[o], n_bins))
    return out


@torch.no_grad()
def render_frame_bucketed(
    stacked_params: dict,
    t_wo: torch.Tensor,
    extents: torch.Tensor,
    centers: torch.Tensor,
    active: torch.Tensor,
    origins: torch.Tensor,
    dirs_w: torch.Tensor,
    gen: torch.Generator,
    n_bins: int = 150,
    max_deg: int = 5,
    max_hit_rays: int = 65536,
    chunk: int = 2048,
    opacity_thresh: float = 0.9,
    far_extension: float = 0.2,
    two_pass: bool = False,
    n_probe: int = 32,
    compute_dtype: str = "f32",
    min_bins: int = 24,
    levels=(1.0, 0.5, 0.25),
    hit_counts=None,
):
    """``render_frame_batched`` with per-object adaptive bin counts.

    Objects are grouped by ``bucket_bin_counts`` into a few bin sizes, in
    increasing order; each bucket renders through one
    ``render_frame_batched`` call whose hit-ray cap is sized to that
    bucket's true coverage (rounded up to a power-of-two number of chunks),
    and the buckets' z-buffers merge by strictly nearer depth. Returns the
    ``render_frame_batched`` dict (winner indices into the full stack) plus
    ``"bins"`` [O] (numpy). ``hit_counts``: a precomputed
    ``obb_hit_counts`` [O], so the slab test runs once per frame. The
    stack is whole, also on a split object axis (``sharding.gather_objects``
    of a block): its buckets pick objects across the blocks."""
    o_count = extents.shape[0]
    if _stack_size(stacked_params) != o_count:
        raise ValueError(f"render_frame_bucketed takes the whole stack of {o_count} "
                         f"objects, not {_stack_size(stacked_params)}")
    n = origins.shape[0]
    dev = origins.device
    bins = bucket_bin_counts(extents.cpu().numpy(), active.cpu().numpy(), n_bins,
                             min_bins=min_bins, levels=levels,
                             far_extension=far_extension)
    counts = (obb_hit_counts(t_wo, extents, active, origins, dirs_w)
              if hit_counts is None else torch.as_tensor(hit_counts)).cpu().numpy()
    act = active.cpu().numpy().astype(bool)
    n_cap = -(-n // chunk) * chunk

    depth = torch.full((n,), float("inf"), dtype=_F32, device=dev)
    winner = torch.full((n,), -1, dtype=torch.int32, device=dev)
    color = torch.zeros((n, 3), dtype=_F32, device=dev)
    n_hit = np.zeros(o_count, np.int32)
    n_hit[act] = counts[act]

    for b in sorted({int(x) for x in bins[act]}):
        sel = np.nonzero(act & (bins == b))[0]
        sel_t = torch.as_tensor(sel, device=dev)
        need = int(counts[sel].max())
        n_chunks = max(1, -(-min(need, max_hit_rays, n) // chunk))
        n_chunks = 1 << (n_chunks - 1).bit_length()   # next power of two
        m = min(n_chunks * chunk, n_cap, -(-max_hit_rays // chunk) * chunk)
        out = render_frame_batched(
            object_field.tree_map(lambda x: x[sel_t], stacked_params),
            t_wo[sel_t], extents[sel_t], centers[sel_t],
            torch.ones((len(sel),), dtype=torch.bool, device=dev), origins, dirs_w,
            gen, n_bins=b, max_deg=max_deg, max_hit_rays=m, chunk=chunk,
            opacity_thresh=opacity_thresh, far_extension=far_extension,
            two_pass=two_pass, n_probe=n_probe, compute_dtype=compute_dtype,
        )
        better = out["depth"] < depth   # a bucket's depth is inf where it has no winner
        depth = torch.where(better, out["depth"], depth)
        winner = torch.where(better, sel_t.to(torch.int32)[out["winner"].clamp(min=0)],
                             winner)
        color = torch.where(better[:, None], out["color"], color)

    return {"depth": depth, "winner": winner, "color": color,
            "n_hit": torch.as_tensor(n_hit, device=dev), "bins": bins}

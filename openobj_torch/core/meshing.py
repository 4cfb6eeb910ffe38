"""Object mesh extraction: box-framed grid evaluation -> marching
tetrahedra -> world-space vertex-coloured mesh (+ optional part features).

Port of the JAX package's ``core.meshing``:

  * the grid spans [-1, 1]^3 scaled by extent / (2 * bound_extent) (0.995
    bg, 0.9 objects) and rigidly placed by the oriented box;
  * adaptive grid dim = min(max_extent // voxel_size + 1, grid_dim);
  * the field is evaluated in chunks with no gradient, through
    ``ops.fused_field.field_evaluator`` (K1 on a CUDA tensor, its plain
    version on a CPU tensor; the params are packed once per grid);
    occupancy = sigmoid(alpha); no surface -> None;
  * surface at level 0.5 (``native.marching_tetrahedra``); vertices
    re-evaluated for colours (x255 uint8) and part features;
  * ``object_point_cloud``: the occ > level grid points and their colours.

The field runs on the device of the params. Where the JAX package pads the
points to whole chunks (and the coarse-to-fine block list to a power of
two) to bound recompiles, the port runs the ragged last chunk as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from openobj_torch.ops import fused_field, mlp, rendering
from openobj_torch.utils.geometry import OrientedBox, TriangleMesh

_F32 = torch.float32


def _device(params: dict):
    return params["mlp"]["in_layer"]["w"].device


def _place(x: torch.Tensor, scale, transform) -> torch.Tensor:
    """[-1, 1]-lattice coordinates [..., 3] -> (x * scale) @ R^T + t, the
    rotation as elementwise products summed (exact f32 on every device)."""
    dev = x.device
    tr = torch.as_tensor(np.asarray(transform), dtype=_F32, device=dev)
    x = x * torch.as_tensor(np.asarray(scale), dtype=_F32, device=dev)
    return (x[..., None, :] * tr[:3, :3]).sum(-1) + tr[:3, 3]


@torch.no_grad()
def eval_points_chunked(
    params: dict,
    points: torch.Tensor,     # [N, 3]
    max_deg: int = 5,
    chunk_size: int = 65536,
    do_clip: bool = False,
):
    """Chunked no-grad field evaluation. Returns (occ [N], color [N, 3],
    clip [N, C], or zeros [N, 1] without the clip head)."""
    field = fused_field.field_evaluator(params, stacked=False, max_deg=max_deg,
                                        do_clip=do_clip)
    occ, color, clip = [], [], []
    for s in range(0, points.shape[0], chunk_size):
        a, c, f = field(points[s:s + chunk_size])
        occ.append(rendering.occupancy_activation(a[..., 0]))
        color.append(c)
        clip.append(mlp.clip_project(params["mlp"], f) if f is not None
                    else torch.zeros((c.shape[0], 1), dtype=_F32, device=c.device))
    return torch.cat(occ), torch.cat(color), torch.cat(clip)


def adaptive_grid_dim(obb: OrientedBox, voxel_size: float, grid_dim: int) -> int:
    return int(min(np.max(obb.extent) // voxel_size + 1, grid_dim))


def _world_points(coords01: np.ndarray, scale, transform, obj_center, device):
    """[-1,1]-lattice coords -> field-frame (object-centred) points, the
    convention of ``rendering.make_3d_grid`` + ``mesh_object``."""
    pts = coords01 * scale
    pts = pts @ np.asarray(transform[:3, :3]).T + np.asarray(transform[:3, 3])
    return torch.as_tensor(pts - obj_center, dtype=_F32, device=device)


@torch.no_grad()
def _eval_blocks(
    params: dict,
    idx: torch.Tensor,         # [A, 3] int block indices
    scale,
    transform,
    obj_center,
    block: int,
    d: int,
    max_deg: int = 5,
    chunk_blocks: int = 256,
) -> torch.Tensor:
    """Occupancy of the block^3 voxels of each listed block, [A, B, B, B].
    The coordinates are built on the device from the index array."""
    dev = idx.device
    field = fused_field.field_evaluator(params, stacked=False, max_deg=max_deg,
                                        do_clip=False)
    off = torch.arange(block, device=dev)
    cube = torch.stack(torch.meshgrid(off, off, off, indexing="ij"), dim=-1)
    center = torch.as_tensor(np.asarray(obj_center), dtype=_F32, device=dev)
    out = []
    for s in range(0, idx.shape[0], chunk_blocks):
        vi = idx[s:s + chunk_blocks, None, None, None, :] * block + cube[None]
        coords = -1.0 + 2.0 * vi.to(_F32) / (d - 1)
        alpha, _, _ = field(_place(coords, scale, transform) - center)
        out.append(rendering.occupancy_activation(alpha[..., 0]))
    return torch.cat(out)


def eval_grid_occupancy(
    params: dict,
    scale: np.ndarray,
    transform: np.ndarray,
    obj_center: np.ndarray,
    grid_dim: int,
    max_deg: int = 5,
    coarse_to_fine: bool = False,
    block: int = 8,
    level: float = 0.5,
    margin: float = 0.35,
    chunk_size: int = 65536,
) -> np.ndarray:
    """occ [dim, dim, dim] over the meshing lattice.

    ``coarse_to_fine=True`` skips empty space: evaluate the
    (dim/block + 1)^3 block-corner lattice first, keep only blocks whose
    corner occupancies bracket [level - margin, level + margin] (dilated by
    one block), and evaluate the full-resolution field only inside those;
    skipped blocks take their min corner's side of the level set. Exact when
    the surface crosses block corners monotonically; features thinner than a
    block entirely inside one can be missed, so it is opt-in."""
    dev = _device(params)
    d = grid_dim
    center = torch.as_tensor(np.asarray(obj_center), dtype=_F32, device=dev)
    if not coarse_to_fine or d % block or d // block < 3:
        grid = rendering.make_3d_grid(
            occ_range=(-1.0, 1.0), dim=d, scale=np.asarray(scale, np.float32),
            transform=np.asarray(transform), device=dev).reshape(-1, 3) - center
        occ, _, _ = eval_points_chunked(params, grid, max_deg=max_deg,
                                        chunk_size=min(chunk_size, d ** 3))
        return occ.cpu().numpy().astype(np.float32).reshape(d, d, d)

    nb = d // block
    # block-corner lattice: voxel indices 0, block, ..., nb*block (the last
    # lies one step past dim-1; it only gates the boundary blocks)
    u = -1.0 + 2.0 * (np.arange(nb + 1) * block) / (d - 1)
    cc = np.stack(np.meshgrid(u, u, u, indexing="ij"), axis=-1).reshape(-1, 3)
    occ_c, _, _ = eval_points_chunked(
        params, _world_points(cc, scale, transform, obj_center, dev),
        max_deg=max_deg, chunk_size=min(chunk_size, cc.shape[0]))
    occ_c = occ_c.cpu().numpy().astype(np.float32).reshape(nb + 1, nb + 1, nb + 1)

    # per-block corner min/max via the 8 shifted corner views
    mn = np.full((nb, nb, nb), np.inf, np.float32)
    mx = np.full((nb, nb, nb), -np.inf, np.float32)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                c = occ_c[di:nb + di, dj:nb + dj, dk:nb + dk]
                mn = np.minimum(mn, c)
                mx = np.maximum(mx, c)
    active = (mn <= level + margin) & (mx >= level - margin)
    # dilate by one block so surfaces grazing a block face are kept
    from scipy import ndimage

    active = ndimage.binary_dilation(active, iterations=1)

    # skipped blocks: constant on their side of the level set
    occ = np.where(
        np.repeat(np.repeat(np.repeat(mn, block, 0), block, 1), block, 2)
        > level, 1.0, 0.0,
    ).astype(np.float32)[:d, :d, :d]

    idx = np.argwhere(active)                    # [A, 3] block indices
    if idx.shape[0] == 0:
        return occ
    occ_f = _eval_blocks(
        params, torch.as_tensor(idx, dtype=torch.int64, device=dev),
        np.asarray(scale, np.float32), np.asarray(transform, np.float32),
        np.asarray(obj_center, np.float32), block=block, d=d, max_deg=max_deg,
    ).cpu().numpy().astype(np.float32)
    # view occ as [nb, B, nb, B, nb, B]; advanced block indices land in the
    # leading result axis
    occ6 = occ.reshape(nb, block, nb, block, nb, block)
    occ6[idx[:, 0], :, idx[:, 1], :, idx[:, 2], :] = occ_f
    return occ


def _box_frame(obb: OrientedBox, is_bg: bool):
    bound_extent = 0.995 if is_bg else 0.9
    scale = obb.extent / (2.0 * bound_extent)
    transform = np.eye(4, dtype=np.float32)
    transform[:3, :3] = obb.r
    transform[:3, 3] = obb.center
    return scale, transform


def mesh_object(
    params: dict,
    obb: OrientedBox,
    obj_center: np.ndarray,
    grid_dim: int = 128,
    is_bg: bool = False,
    with_color: bool = True,
    with_part: bool = False,
    max_deg: int = 5,
    level: float = 0.5,
    coarse_to_fine: bool = False,
    block: int = 8,
) -> TriangleMesh | None:
    """Extract one object's mesh in world coordinates."""
    from openobj_torch import native

    scale, transform = _box_frame(obb, is_bg)
    occ = eval_grid_occupancy(
        params, scale, transform, obj_center, grid_dim, max_deg=max_deg,
        coarse_to_fine=coarse_to_fine, block=block, level=level,
    )
    if occ.max() <= level:
        return None
    out = native.marching_tetrahedra(occ, level=level)
    if out is None:
        return None
    verts01, faces = out

    # [0,1] grid coords -> [-1,1] -> scaled -> world
    verts = (verts01 * 2.0 - 1.0) * scale
    verts = verts @ transform[:3, :3].T + transform[:3, 3]
    mesh = TriangleMesh(vertices=verts.astype(np.float32), faces=faces)

    if with_color or with_part:
        # field inputs are object-centred (training subtracts obj_center)
        pts = torch.as_tensor(mesh.vertices - np.asarray(obj_center, np.float32),
                              device=_device(params))
        _, color, clip = eval_points_chunked(params, pts, max_deg=max_deg,
                                             do_clip=with_part)
        if with_color:
            mesh.vertex_colors = (np.clip(color.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        if with_part:
            mesh.vertex_attrs = {"partfeat": clip.cpu().numpy().astype(np.float32)}
    return mesh


def object_point_cloud(
    params: dict,
    obb: OrientedBox,
    obj_center: np.ndarray,
    grid_dim: int = 128,
    is_bg: bool = False,
    max_deg: int = 5,
    level: float = 0.5,
):
    """The occ > level grid points (world frame) and their colours, or
    None. Returns (points [N, 3], colors [N, 3])."""
    dev = _device(params)
    scale, transform = _box_frame(obb, is_bg)
    center = np.asarray(obj_center, np.float32)
    grid = rendering.make_3d_grid(
        occ_range=(-1.0, 1.0), dim=grid_dim, scale=np.asarray(scale, np.float32),
        transform=transform, device=dev).reshape(-1, 3) - torch.as_tensor(center, device=dev)
    occ, color, _ = eval_points_chunked(params, grid, max_deg=max_deg,
                                        chunk_size=min(65536, grid_dim ** 3))
    mask = (occ > level).cpu().numpy()
    if not mask.any():
        return None
    pts = grid.cpu().numpy()[mask] + center  # world
    return pts, color.cpu().numpy()[mask]

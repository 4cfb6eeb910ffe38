"""Iso-surface extraction: vectorized marching tetrahedra (numpy, CPU).

A copy of the JAX package's ``ops.marching`` (numpy only); the numpy
fallback of ``native.marching_tetrahedra``.

Replaces the reference's skimage.measure.marching_cubes
(reference objnerf/vis.py:6-22). Marching tetrahedra (each cube split
into 6 tets sharing the main diagonal) produces a watertight, hole-free
triangulation with a trivially-derivable 16-case table — no 256-entry
lookup to get wrong — at the cost of ~2x triangle count; for downstream use
(vertex-colored exports, query visualization, mIoU rendering) that is
immaterial.

Matches the reference contract: ``marching_tetrahedra(occ, level)`` returns
vertices normalized to [0, 1] by /(dim-1) (vis.py:17-18) with shared
(deduplicated) vertices, or None when the surface is empty (the reference's
skimage failure -> skip-object path).
"""

from __future__ import annotations

import numpy as np

# cube corners, binary order with v6 = (1,1,1)
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int64,
)
# 6-tet decomposition sharing diagonal v0-v6
_TETS = np.array(
    [
        [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
        [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
    ],
    dtype=np.int64,
)


def _tet_case_table():
    """case (4-bit inside mask) -> list of triangles, each = 3 edges (i, j)
    with i inside, j outside; surface vertex interpolated on edge (i, j)."""
    table = []
    for case in range(16):
        inside = [(case >> i) & 1 for i in range(4)]
        ins = [i for i in range(4) if inside[i]]
        outs = [i for i in range(4) if not inside[i]]
        tris = []
        if len(ins) == 1:
            a = ins[0]
            tris = [[(a, outs[0]), (a, outs[1]), (a, outs[2])]]
        elif len(ins) == 3:
            a = outs[0]
            tris = [[(ins[0], a), (ins[2], a), (ins[1], a)]]
        elif len(ins) == 2:
            a, b = ins
            c, d = outs
            tris = [
                [(a, c), (a, d), (b, d)],
                [(a, c), (b, d), (b, c)],
            ]
        table.append(tris)
    return table


_CASE_TABLE = _tet_case_table()


def marching_tetrahedra(values: np.ndarray, level: float = 0.5):
    """Extract the iso-surface of a scalar grid.

    values: [N0, N1, N2] float. Returns (vertices [V, 3] float64 normalized
    to [0, 1] by /(max(N)-1), faces [F, 3] int64) or None if no surface.
    """
    values = np.asarray(values, dtype=np.float32)
    n0, n1, n2 = values.shape
    if min(n0, n1, n2) < 2:
        return None

    # active cubes: straddle the level. Running min/max over the 8 shifted
    # views keeps the transient at ~2 cube-grids instead of the 8-wide
    # corner stack (~0.5 GB at 256^3); corner values are gathered only for
    # the (usually sparse) active set afterwards.
    corner_views = [
        values[dx : n0 - 1 + dx, dy : n1 - 1 + dy, dz : n2 - 1 + dz]
        for dx, dy, dz in _CORNERS
    ]
    cmin = np.minimum.reduce(corner_views).reshape(-1)
    cmax = np.maximum.reduce(corner_views).reshape(-1)
    active = np.nonzero((cmin < level) & (cmax >= level))[0]
    if len(active) == 0:
        return None
    stack = np.stack(
        [c.reshape(-1)[active] for c in corner_views], axis=-1
    )  # [M, 8] — active cubes only

    cube_idx = np.stack(
        np.unravel_index(active, (n0 - 1, n1 - 1, n2 - 1)), axis=-1
    )  # [M, 3]
    # global grid-vertex linear id per corner [M, 8]
    corner_ijk = cube_idx[:, None, :] + _CORNERS[None, :, :]
    corner_lid = (
        corner_ijk[..., 0] * (n1 * n2) + corner_ijk[..., 1] * n2 + corner_ijk[..., 2]
    )
    corner_val = stack  # [M, 8] (already active-only)

    # expand to tets [M*6, 4]
    tet_lid = corner_lid[:, _TETS].reshape(-1, 4)
    tet_val = corner_val[:, _TETS].reshape(-1, 4)
    inside = tet_val > level
    case = (
        inside[:, 0].astype(np.int64)
        + inside[:, 1] * 2
        + inside[:, 2] * 4
        + inside[:, 3] * 8
    )

    tri_e1, tri_e2 = [], []  # per entry: [n_tets_of_case, 3] edge endpoints
    for c in range(1, 15):
        sel = np.nonzero(case == c)[0]
        if len(sel) == 0:
            continue
        for tri in _CASE_TABLE[c]:
            tri_e1.append(np.stack([tet_lid[sel, i] for i, _ in tri], axis=1))
            tri_e2.append(np.stack([tet_lid[sel, j] for _, j in tri], axis=1))
    if not tri_e1:
        return None
    e1 = np.concatenate(tri_e1)
    e2 = np.concatenate(tri_e2)

    # dedup shared surface vertices by (sorted) edge key
    lo = np.minimum(e1, e2).reshape(-1)
    hi = np.maximum(e1, e2).reshape(-1)
    keys = lo * (n0 * n1 * n2) + hi
    uniq, inverse = np.unique(keys, return_inverse=True)
    faces = inverse.reshape(-1, 3)

    u_lo = uniq // (n0 * n1 * n2)
    u_hi = uniq % (n0 * n1 * n2)
    val_flat = values.reshape(-1)
    va, vb = val_flat[u_lo], val_flat[u_hi]
    t = np.clip((level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va), 0.0, 1.0)

    def coords(lid):
        return np.stack(np.unravel_index(lid, (n0, n1, n2)), axis=-1).astype(np.float64)

    verts = coords(u_lo) + t[:, None] * (coords(u_hi) - coords(u_lo))

    # drop degenerate faces (two corners on the same edge)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]
    if len(faces) == 0:
        return None

    # normalize to [0, 1] like the reference (vis.py:17-18); uses per-axis
    # (dim - 1) so non-cubic grids stay proportional
    dims = np.array([n0 - 1, n1 - 1, n2 - 1], dtype=np.float64)
    verts = verts / dims
    return verts, faces

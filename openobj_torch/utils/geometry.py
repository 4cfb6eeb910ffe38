"""CPU geometry: oriented bounding boxes, point-cloud utilities, meshes.

A copy of the JAX package's ``utils.geometry`` (numpy/scipy), without
OpenCV:

  * ``oriented_bounds``: trimesh's algorithm: for each convex-hull face
    normal, rotate it to +z and take the min-area rectangle of the projected
    hull by rotating calipers (the JAX package's own path where OpenCV is
    missing); keep the min-volume box.
  * ``backproject_depth``: posed pinhole depth -> world points.
  * ``voxel_downsample``: grid hashing (the numpy fallback of
    ``native.voxel_downsample``).
  * ``TriangleMesh`` with OBJ/PLY writers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from scipy.spatial import ConvexHull, QhullError


@dataclass
class OrientedBox:
    center: np.ndarray   # [3]
    r: np.ndarray        # [3, 3] box-frame -> world rotation
    extent: np.ndarray   # [3] full side lengths

    @property
    def corners(self) -> np.ndarray:
        """[8, 3] world-frame corners (reference vmap.py:349-363 order)."""
        offs = np.array(
            [
                [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
            ],
            dtype=np.float64,
        )
        return (offs * self.extent / 2.0) @ self.r.T + self.center

    @property
    def volume(self) -> float:
        return float(np.prod(self.extent))

    def contains(self, points: np.ndarray) -> np.ndarray:
        local = (points - self.center) @ self.r
        return np.all(np.abs(local) <= self.extent / 2.0 + 1e-9, axis=-1)


def _rot_to_z(n: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector n to +z."""
    n = n / np.linalg.norm(n)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(n, z)
    c = float(np.dot(n, z))
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))


def _min_area_rect(points2d: np.ndarray):
    """Min-area rectangle of 2D points -> (angle_rad, extents[2], center[2])
    by rotating calipers over the hull's edges."""
    hull = ConvexHull(points2d)
    pts = points2d[hull.vertices]
    best = None
    for i in range(len(pts)):
        e = pts[(i + 1) % len(pts)] - pts[i]
        ang = np.arctan2(e[1], e[0])
        c, s = np.cos(-ang), np.sin(-ang)
        rot = np.array([[c, -s], [s, c]])
        p = points2d @ rot.T
        lo, hi = p.min(0), p.max(0)
        area = np.prod(hi - lo)
        if best is None or area < best[0]:
            best = (area, ang, hi - lo, rot.T @ ((lo + hi) / 2))
    return best[1], best[2], best[3]


def oriented_bounds(points: np.ndarray, min_extent: float = 0.0) -> OrientedBox:
    """Minimal-volume oriented bounding box over hull-face normals
    (trimesh.bounds.oriented_bounds parity, used at reference vmap.py:334).
    Raises QhullError for degenerate inputs (reference's skip-object path,
    vmap.py:333-338)."""
    points = np.asarray(points, dtype=np.float64)
    if len(points) < 4:
        raise QhullError("need >= 4 points for an oriented box")
    hull = ConvexHull(points)  # may raise QhullError — caller handles
    hull_pts = points[hull.vertices]

    best: OrientedBox | None = None
    normals = np.unique(np.round(hull.equations[:, :3], 6), axis=0)
    for n in normals:
        r1 = _rot_to_z(n)
        p = hull_pts @ r1.T
        ang, ext2, cen2 = _min_area_rect(p[:, :2])
        c, s = np.cos(ang), np.sin(ang)
        r2 = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        # box frame B: world -> box is r2^T @ r1
        pb = p @ r2  # rotate xy by -ang
        lo, hi = pb.min(0), pb.max(0)
        extent = hi - lo
        vol = float(np.prod(extent))
        if best is None or vol < best.volume:
            r_wb = (r2.T @ r1).T  # box->world
            center_b = (lo + hi) / 2.0
            center_w = r_wb @ center_b
            best = OrientedBox(center=center_w, r=r_wb, extent=extent)
    if min_extent > 0:
        best = OrientedBox(
            best.center, best.r, np.maximum(best.extent, min_extent)
        )
    return best


def backproject_depth(
    depth: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    t_wc: np.ndarray | None = None,
    mask: np.ndarray | None = None,
) -> np.ndarray:
    """Pinhole depth image [H, W] (z-depth, 0 = invalid) -> [N, 3] points
    (world frame if t_wc given)."""
    h, w = depth.shape
    valid = depth > 0
    if mask is not None:
        valid &= mask.astype(bool)
    v, u = np.nonzero(valid)
    z = depth[v, u]
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts = np.stack([x, y, z], axis=-1)
    if t_wc is not None:
        pts = pts @ t_wc[:3, :3].T + t_wc[:3, 3]
    return pts


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Average points per occupied voxel (open3d voxel_down_sample parity)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(points.dtype)


def object_bound_from_keyframes(
    depths: np.ndarray,        # [K, H, W]
    masks: np.ndarray,         # [K, H, W] bool (state == this)
    t_wcs: np.ndarray,         # [K, 4, 4]
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float = 0.05,
    min_extent: float = 0.10,
) -> OrientedBox | None:
    """3D oriented bound from the union of masked depth backprojections
    (reference get_bound, vmap.py:287-379): accumulate -> voxel downsample
    0.05 m -> minimal OBB -> extents floored at 10 cm. Returns None when the
    hull is degenerate (reference's Qhull failure path)."""
    from openobj_torch import native

    all_pts = []
    for k in range(len(depths)):
        pts = backproject_depth(depths[k], fx, fy, cx, cy, t_wcs[k], masks[k])
        if len(pts):
            all_pts.append(pts)
    if not all_pts:
        return None
    pts = native.voxel_downsample(np.concatenate(all_pts), voxel_size)
    try:
        return oriented_bounds(pts, min_extent=min_extent)
    except (QhullError, ValueError):
        return None


# --------------------------------------------------------------------------- #
# mesh container + exporters (replaces trimesh)
# --------------------------------------------------------------------------- #


@dataclass
class TriangleMesh:
    vertices: np.ndarray              # [V, 3] float
    faces: np.ndarray                 # [F, 3] int
    vertex_colors: np.ndarray | None = None   # [V, 3] uint8
    vertex_attrs: dict | None = None  # extra per-vertex arrays (e.g. partfeat)

    def apply_scale(self, s) -> "TriangleMesh":
        self.vertices = self.vertices * s
        return self

    def apply_translation(self, t) -> "TriangleMesh":
        self.vertices = self.vertices + np.asarray(t)
        return self

    def apply_transform(self, t: np.ndarray) -> "TriangleMesh":
        self.vertices = self.vertices @ t[:3, :3].T + t[:3, 3]
        return self

    def export_obj(self, path: str):
        with open(path, "w") as f:
            if self.vertex_colors is not None:
                c = self.vertex_colors.astype(np.float64) / 255.0
                for v, col in zip(self.vertices, c):
                    f.write(f"v {v[0]} {v[1]} {v[2]} {col[0]} {col[1]} {col[2]}\n")
            else:
                for v in self.vertices:
                    f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for tri in self.faces + 1:
                f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")

    def export_ply(self, path: str):
        has_c = self.vertex_colors is not None
        with open(path, "wb") as f:
            hdr = [
                "ply", "format binary_little_endian 1.0",
                f"element vertex {len(self.vertices)}",
                "property float x", "property float y", "property float z",
            ]
            if has_c:
                hdr += [
                    "property uchar red", "property uchar green",
                    "property uchar blue",
                ]
            hdr += [
                f"element face {len(self.faces)}",
                "property list uchar int vertex_indices", "end_header", "",
            ]
            f.write("\n".join(hdr).encode())
            if has_c:
                vt = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                arr = np.empty(len(self.vertices), vt)
                arr["xyz"] = self.vertices.astype(np.float32)
                arr["rgb"] = self.vertex_colors
            else:
                arr = self.vertices.astype(np.float32)
            f.write(arr.tobytes())
            ft = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
            farr = np.empty(len(self.faces), ft)
            farr["n"] = 3
            farr["idx"] = self.faces.astype(np.int32)
            f.write(farr.tobytes())

"""Native (C++) CPU geometry and graph code, loaded with ctypes.

The port's counterpart of ``openobj_tpu.native``. ``geometry.cc`` and
``louvain.cc`` beside this file are copies of the JAX package's sources:

  * ``geometry.cc``: ``marching_tetrahedra`` (meshing), ``voxel_downsample``
    (object bounds), and the largest-cluster DBSCAN denoise of the
    association's mask point clouds (``dbscan_largest_raw``,
    ``dbscan_largest_cluster``);
  * ``louvain.cc``: Louvain community detection over the association graph
    (``louvain_labels``).

Each is compiled with ``g++ -O3`` at first use into ``build/native/`` at the
root of the checkout, under a name that carries a digest of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing is built at import. Where ``g++`` is missing or the build
fails, the meshing and bounds entry points fall back to their numpy
versions (``ops.marching``, ``utils.geometry``), as the reference does, and
``load()`` returns None; the association's entry points (DBSCAN, Louvain)
have no such fallback here and raise instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "geometry.cc"
LOUVAIN_SRC = Path(__file__).resolve().parent / "louvain.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_libs: dict[Path, object] = {}
_tried: set[Path] = set()


def lib_path(src: Path = SRC) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def _build(src: Path, out: Path) -> bool:
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)   # atomic: a concurrent build never sees a partial file
    return True


def _load_src(src: Path, declare):
    """The library built from ``src`` with ``declare`` applied to it, or
    None when it cannot be built or loaded (tried once per process)."""
    if src in _libs or src in _tried:
        return _libs.get(src)
    _tried.add(src)
    path = lib_path(src)
    if not path.exists() and not _build(src, path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    declare(lib)
    _libs[src] = lib
    return lib


c_f, c_d, c_i64 = ctypes.c_float, ctypes.c_double, ctypes.c_int64
p_f, p_d, p_i64 = (ctypes.POINTER(c_f), ctypes.POINTER(c_d), ctypes.POINTER(c_i64))
p_u8 = ctypes.POINTER(ctypes.c_uint8)


def _declare_geometry(lib) -> None:
    lib.marching_tetrahedra.restype = ctypes.c_int
    lib.marching_tetrahedra.argtypes = [
        p_f, c_i64, c_i64, c_i64, c_f, p_d, c_i64, p_i64, p_i64, c_i64, p_i64]
    lib.voxel_downsample.restype = c_i64
    lib.voxel_downsample.argtypes = [p_d, c_i64, c_d, p_d, c_i64]
    for fn in (lib.grid_dbscan_largest, lib.voxel_flood_largest):
        fn.restype = c_i64
        fn.argtypes = [p_d, c_i64, c_d, c_i64, p_u8]


def _declare_louvain(lib) -> None:
    lib.louvain.restype = c_i64
    lib.louvain.argtypes = [p_i64, p_i64, p_d, c_i64, c_i64, c_d, ctypes.c_uint64, p_i64]


def load():
    """The typed geometry library, or None when it cannot be built."""
    return _load_src(SRC, _declare_geometry)


def load_louvain():
    """The typed Louvain library, or None when it cannot be built."""
    return _load_src(LOUVAIN_SRC, _declare_louvain)


def _require(lib, what: str):
    if lib is None:
        raise RuntimeError(
            f"native {what} library could not be built (g++ {' '.join(CXX_FLAGS)} "
            f"into {BUILD_DIR}); the association has no fallback for it")
    return lib


def marching_tetrahedra(values: np.ndarray, level: float = 0.5):
    """Iso-surface of a scalar grid: (vertices [V, 3] in [0, 1], faces
    [F, 3]) or None when there is no surface. The numpy version
    (``ops.marching``) runs when the library is unavailable."""
    lib = load()
    if lib is None:
        from openobj_torch.ops.marching import marching_tetrahedra as mt

        return mt(values, level)
    v = np.ascontiguousarray(values, dtype=np.float32)
    n0, n1, n2 = v.shape
    # start modestly (surfaces touch few cubes); grow x4 on overflow
    cap = max(1 << 16, int(v.size) // 8)
    for _ in range(4):
        verts = np.empty((cap, 3), np.float64)
        faces = np.empty((cap * 2, 3), np.int64)
        nv = ctypes.c_int64(0)
        nf = ctypes.c_int64(0)
        r = lib.marching_tetrahedra(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n0, n1, n2, ctypes.c_float(level),
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), verts.size,
            ctypes.byref(nv),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), faces.size,
            ctypes.byref(nf),
        )
        if r == 0:
            if nf.value == 0:
                return None
            return verts[: nv.value].copy(), faces[: nf.value].copy()
        cap *= 4
    raise RuntimeError("marching_tetrahedra capacity overflow")


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Mean point per occupied voxel; the numpy version
    (``utils.geometry.voxel_downsample``) runs when the library is
    unavailable."""
    lib = load()
    if lib is None:
        from openobj_torch.utils.geometry import voxel_downsample as vd

        return vd(points, voxel)
    p = np.ascontiguousarray(points, dtype=np.float64)
    out = np.empty_like(p)
    n = lib.voxel_downsample(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(p),
        ctypes.c_double(voxel),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), out.size,
    )
    if n < 0:
        raise RuntimeError("voxel_downsample overflow")
    return out[:n].astype(points.dtype)


def dbscan_largest_raw(points: np.ndarray, eps: float, min_points: int,
                       large_n: int = 100_000):
    """Largest-cluster keep mask of a DBSCAN over ``points``, or None when
    no cluster exists. Clouds above ``large_n`` points use the O(n) voxel
    flood-fill variant: exact grid DBSCAN scans every point in each
    eps-cell, which explodes on dense surface clouds whenever eps far
    exceeds the point spacing (the adaptive-eps denoise regime). Raises
    when the library cannot be built."""
    lib = _require(load(), "geometry")
    p = np.ascontiguousarray(points, dtype=np.float64)
    if p.ndim != 2 or p.shape[1] != 3:
        raise ValueError(f"dbscan_largest_raw: points of shape {p.shape}, expected [N, 3]")
    mask = np.zeros(len(p), np.uint8)
    fn = lib.voxel_flood_largest if len(p) > large_n else lib.grid_dbscan_largest
    kept = fn(p.ctypes.data_as(p_d), len(p), ctypes.c_double(eps), min_points,
              mask.ctypes.data_as(p_u8))
    if kept == 0:
        return None
    return mask.astype(bool)


def dbscan_largest_cluster(points: np.ndarray, eps: float, min_points: int):
    """Largest-cluster filter: (points kept, keep mask); keeps everything
    when no cluster is found."""
    mask = dbscan_largest_raw(points, eps, min_points)
    if mask is None:
        return points, np.ones(len(points), bool)
    return points[mask], mask


def louvain_labels(
    edges_i: np.ndarray,
    edges_j: np.ndarray,
    edges_w: np.ndarray,
    n_nodes: int,
    resolution: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Community label per node from weighted undirected edges, by the
    native Louvain (``louvain.cc``). Raises when the library cannot be
    built."""
    lib = _require(load_louvain(), "Louvain")
    ei = np.ascontiguousarray(edges_i, np.int64)
    ej = np.ascontiguousarray(edges_j, np.int64)
    ew = np.ascontiguousarray(edges_w, np.float64)
    if not len(ei) == len(ej) == len(ew):
        raise ValueError(f"louvain: {len(ei)}, {len(ej)}, {len(ew)} edge ends and weights")
    labels = np.empty(n_nodes, np.int64)
    k = lib.louvain(
        ei.ctypes.data_as(p_i64), ej.ctypes.data_as(p_i64), ew.ctypes.data_as(p_d),
        len(ei), n_nodes, ctypes.c_double(resolution), ctypes.c_uint64(seed),
        labels.ctypes.data_as(p_i64),
    )
    if k < 0:
        raise ValueError("louvain: edge index out of range")
    return labels

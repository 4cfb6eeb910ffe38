"""Native (C++) CPU geometry, loaded with ctypes.

The port's counterpart of ``openobj_tpu.native`` for the map's outputs:
``marching_tetrahedra`` (meshing) and ``voxel_downsample`` (object bounds).
``geometry.cc`` beside this file is a copy of the JAX package's source. It
is compiled with ``g++ -O3`` at first use into ``build/native/`` at the root
of the checkout, under a name that carries a digest of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Where ``g++`` is missing or the build fails, each entry point falls back to
its numpy version (``ops.marching``, ``utils.geometry``), as the reference
does; ``load()`` returns None then. Nothing is built at import.
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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgeometry-{digest[:16]}.so"


def _build(out: Path) -> bool:
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)   # atomic: a concurrent build never sees a partial file
    return True


def load():
    """The typed ctypes library, or None when it cannot be built."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = lib_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    c_f, c_d, c_i64 = ctypes.c_float, ctypes.c_double, ctypes.c_int64
    p_f, p_d, p_i64 = (ctypes.POINTER(c_f), ctypes.POINTER(c_d),
                       ctypes.POINTER(c_i64))
    lib.marching_tetrahedra.restype = ctypes.c_int
    lib.marching_tetrahedra.argtypes = [
        p_f, c_i64, c_i64, c_i64, c_f, p_d, c_i64, p_i64, p_i64, c_i64, p_i64]
    lib.voxel_downsample.restype = c_i64
    lib.voxel_downsample.argtypes = [p_d, c_i64, c_d, p_d, c_i64]
    _lib = lib
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

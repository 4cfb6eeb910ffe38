"""Build and load the port's hand-written CUDA kernels.

Each source ``openobj_torch/csrc/<name>.cu`` exposes a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout, at first use, then loaded with ``ctypes``. The library's file
name carries a digest of the source, of the files it includes with
``#include "..."`` and of the flags, so an edited source or header is
rebuilt and a stale library is never loaded. ``build`` and ``load`` also take
the path of a source outside ``csrc/`` (for example an older copy of a
kernel, to time it beside the current one). Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_field", "fused_field_bf16", "probes", "adamw_flat")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}   # by name or source path


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"   # the toolkit's conventional home
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
        "openobj_torch/csrc at first use")


def _source(name) -> Path:
    """``csrc/<name>.cu`` for a name, the path itself for a ``Path``."""
    return name if isinstance(name, Path) else CSRC / f"{name}.cu"


def included(src: Path) -> list[Path]:
    """``src`` and every file it includes with ``#include "..."`` (beside the
    file that includes it), depth first in order, each once."""
    out: list[Path] = []

    def walk(f: Path) -> None:
        if f in out:
            return
        out.append(f)
        for inc in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', f.read_bytes(), flags=re.M):
            walk(f.parent / inc.decode())

    walk(src)
    return out


def lib_path(name) -> Path:
    src = _source(name)
    text = b"".join(f.read_bytes() for f in included(src))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> dict[str, float]:
    """Compile every named source not built yet, one ``nvcc`` per source,
    all started together. Returns {name: seconds from the start to that
    compiler's end}; raises with the
    compiler's output if any build fails. ``verbose`` adds ``-Xptxas -v``
    and prints the compiler's report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(_source(name))]
        jobs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    # each compiler's own seconds: its output drained and its end taken by a
    # thread of its own, so that one build's wait does not count in another's
    logs, secs = {}, {}

    def reap(name, proc):
        logs[name] = proc.communicate()[0]
        secs[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=reap, args=(name, job[0])) for name, job in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errors = []
    for name, (proc, tmp, out) in jobs.items():
        log = logs[name]
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {_source(name)} (rc {proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {_source(name).name}]\n{log}", flush=True)
        os.replace(tmp, out)   # atomic: a concurrent build never sees a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or a source path),
    building it if needed."""
    key = str(name)
    lib = _LIBS.get(key)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[key] = lib
    return lib

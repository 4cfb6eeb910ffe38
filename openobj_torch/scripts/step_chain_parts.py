"""What bounds the fused-step chain kernel (``step_chain_kernel``, K4d and
K4e): its time whole, with its products dropped and with its sines
dropped, at q3's and q4's shapes, on one card.

    python -m openobj_torch.scripts.step_chain_parts

It builds edited copies of ``csrc/probes.cu`` beside the real one, under
``build/kernels/parts/`` (with ``ens_gemm_parts``' helper): "noproduct"
replaces the chain's two ``mma_step`` calls (e w1 and each h w2) by a sum of
the A fragment into one accumulator, so that the encode (projection FMAs and
sines), the copies and the row sums stay and the tensor-core work goes;
"nosine" passes the projection to the products (and, at depth 0, to the row
sums) without ``sinf``. Each case is timed with ``_benchlib.scan_time``
(CUDA graphs of 1 and N calls) in turns (whole, the parts, then again in
reverse) at q3's shape (xs [100,64,1200,8], K = 87, H = 32, depth 4: K4d)
and q4's (xs [4,o,1200,8], depth 0 at o = 16 and depth 1 at o = 8 and 16:
K4e). It prints one JSON line per case with the launch
(``pr_step_chain_launch``: blocks per cluster, blocks, threads, dynamic
shared memory, resident blocks per SM, resident clusters) and the whole
kernel's distance from the plain version. It also compiles a kernel of one
``sinf`` for ``sm_90a`` and writes its SASS to ``chiprun_out/sinf_sass.txt``
(the instruction count of ``sinf``'s path for |x| < 105615 is what the
chain's bound charges per sine). The package never loads the copies.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from openobj_torch import kernels
from openobj_torch.ops import probes
from openobj_torch.scripts.ens_gemm_parts import part_sources

N, DX, K, H = 1200, 8, 87, 32
CASES = (("K4d", 100, 64, 4, 5), ("K4e d0 o16", 4, 16, 0, 50), ("K4e d1 o8", 4, 8, 1, 50),
         ("K4e d1 o16", 4, 16, 1, 50))   # name, S, O, depth, calls per graph

_E_PRODUCT = ("    mma_step<true, NB>(p, w1f + ks * NB * 32, c);\n",
              "    c[0][0] += sinf(p[0]) + sinf(p[1]) + sinf(p[2]) + sinf(p[3]);\n")
_H_PRODUCT = ("      mma_step<false, NB>(a, w2f + j * NB * 32, c);\n",
              "      c[0][0] += a[0] + a[1] + a[2] + a[3];\n")
_E_SINE = (_E_PRODUCT[0], "    mma_step<false, NB>(p, w1f + ks * NB * 32, c);\n")
_D0_SINE = ("      rs[j][0] += sinf(p[0]) + sinf(p[1]);\n      rs[j][1] += sinf(p[2]) + sinf(p[3]);\n",
            "      rs[j][0] += p[0] + p[1];\n      rs[j][1] += p[2] + p[3];\n")
PARTS = {"noproduct": [_E_PRODUCT, _H_PRODUCT], "nosine": [_E_SINE, _D0_SINE]}

SINF_PROBE = """\
extern "C" __global__ void sinf_probe(const float* x, float* y) {
  y[threadIdx.x] = sinf(x[threadIdx.x]);
}
"""


def _typed(path: Path) -> ctypes.CDLL:
    lib = kernels.load(path)
    lib.pr_step_chain.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.pr_step_chain.restype = ctypes.c_int
    lib.pr_step_chain_launch.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.pr_step_chain_launch.restype = ctypes.c_int
    return lib


def launch(lib, s, o, n, dx, k, h, depth) -> dict:
    """The launch pr_step_chain makes for these arguments."""
    res = (ctypes.c_int * 6)()
    err = lib.pr_step_chain_launch(s, o, n, dx, k, h, depth, res)
    if err:
        raise RuntimeError(f"pr_step_chain_launch: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "blocks", "cluster",
                     "clusters_resident"), res))


def sinf_sass(out_dir: Path) -> Path:
    """Compile SINF_PROBE for sm_90a and write its SASS to out_dir."""
    nvcc = Path(kernels.nvcc_path())
    work = kernels.BUILD_DIR / "parts"
    work.mkdir(parents=True, exist_ok=True)
    src, cubin = work / "sinf_probe.cu", work / "sinf_probe.cubin"
    src.write_text(SINF_PROBE)
    subprocess.run([str(nvcc), "-cubin", "-arch=sm_90a", "-O3", "-o", str(cubin), str(src)],
                   check=True, timeout=300)
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "sinf_sass.txt"
    path.write_text(sass)
    return path


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("step_chain_parts: no CUDA device", file=sys.stderr)
        return 2
    from openobj_torch.scripts._benchlib import rel_err, scan_time

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    srcs = part_sources(parts=PARTS)
    kernels.build(tuple(srcs.values()))
    libs = {part: _typed(path) for part, path in srcs.items()}
    for name, s, o, depth, iters in CASES:
        gen = torch.Generator(device=device).manual_seed(0)
        xs = torch.randn((s, o, N, DX), generator=gen, device=device) * 0.1
        w0 = torch.randn((o, DX, K), generator=gen, device=device)
        w1 = torch.randn((o, K, H), generator=gen, device=device)
        w2 = torch.randn((o, H, H), generator=gen, device=device)
        out = torch.empty((s, o, 1, H), device=device)

        def call(lib):
            err = lib.pr_step_chain(xs.data_ptr(), w0.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                                    out.data_ptr(), s, o, N, DX, K, H, depth,
                                    torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"pr_step_chain: CUDA error {err}")

        out.fill_(float("nan"))
        call(libs["whole"])
        rel = rel_err(out, probes.step_chain_plain(xs, w0, w1, w2, depth))
        us = {part: [] for part in libs}
        for order in (list(libs), list(libs)[::-1]):
            for part in order:
                us[part].append(round(scan_time(lambda: call(libs[part]), iters=iters) * 1e6, 3))
        print(json.dumps({"case": name, "S": s, "O": o, "N": N, "depth": depth, "us": us,
                          "whole_rel_err": rel,
                          "launch": launch(libs["whole"], s, o, N, DX, K, H, depth)}), flush=True)
    path = sinf_sass(kernels.BUILD_DIR.parents[1] / "chiprun_out")
    print(f"sinf SASS (sm_90a): {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

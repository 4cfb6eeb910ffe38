"""What bounds the part term's quadratic kernel (``part_quad_kernel``, K4g
quad): its time whole, with its copies only, without the cluster's
exchange, without z, with other cluster and block sizes, and where a block's
time goes, at the probe's shape (q5: hp [64,120,33], wb [64,33,512]), on one
card.

    python -m openobj_torch.scripts.part_quad_parts [--against OLD/probes.cu]

It builds edited copies of ``csrc/probes.cu`` beside the real one, under
``build/kernels/`` (``ens_gemm_parts.part_sources``): "copies" never runs
the k-steps or z (the copies, waits, barriers, the partials' sums of zeros
and the exchange stay; nothing is stored), "no_exchange" sums each block's
own partial in place of the cluster's (no copy to a peer and no cluster
barrier; the output is not checked), "no_z" forms and exchanges g but
computes and stores no z (the output is not checked), "empty" also drops
the copies (the stage's one arrival announces no bytes, so the waits pass
at once), so that the launch, the barriers and the exchange are left,
"cl1" and "cl4" give each object 1 or 4 blocks, and "nt128" and
"cl4_nt128" take blocks of 128 threads (checked). ``--against`` adds other
``probes.cu`` files with the same ``pr_part_quad`` (the parent's, say), each
one more case named by its path. Each case is timed with
``_benchlib.scan_time`` (CUDA graphs of 1 and 100 calls) in turns: the
cases in order, then in reverse. One JSON line: the times, max|d|/max|ref|
against ``part_quad_plain`` for each checked case, and the launch of each
copy that reports it (``pr_part_quad_launch``: blocks resident per SM,
threads, dynamic shared memory, blocks, blocks per cluster, clusters
resident at once). A second line: the phases of a block, from one more
copy in which thread 0 of each block stamps ``clock64()`` at the places
``_PLACES`` names (and ``%globaltimer`` at entry and exit, and its SM): per
phase the mean and the largest over the blocks, in ns. Stamps cost time of
their own. The package never loads the copies.
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

O, R, HP, C = 64, 120, 33, 512   # q5's shape
ITERS = 100

_NO_PRODUCT = ("    for (int ks = warp; 8 * ks < cw; ks += QD_NW) {\n",
               "    for (int ks = warp; 8 * ks < cw && C < 0; ks += QD_NW) {\n")
_NO_Z = [("    for (int item = warp; item < HN * ((nb + 15) / 16); item += QD_NW) {\n",
          "    for (int item = warp; item < HN * ((nb + 15) / 16) && C < 0; item += QD_NW) {\n"),
         ("    for (int i = tid; i < nb * Hp; i += QD_NT) zo[(size_t)b0 * Hp + i] = zs[i];\n", "")]
_NO_EXCHANGE = [
    ("  cluster_arrive_relaxed();   // this block's mbarriers are set up (waited for before the "
     "exchange)\n", ""),
    ("  cluster_wait();       // every peer's mbarriers are set up\n", ""),
    ("    mbar_arrive_expect_tx(xbar, 4u * (QD_CL - 1) * hl);\n"
     "    for (int r = 1; r < QD_CL; ++r) bulk_copy_s2peer(gp, 4u * hl, xbar, (q + r) % QD_CL);\n",
     "    mbar_arrive(xbar);\n"),
    ("  mbar_wait(xbar, 0);   // every peer's partial is in its slot\n", ""),
    ("  cluster_arrive_relaxed();   // so the copies from the peers are done (waited for at exit)\n",
     ""),
    ("    float4 v = reinterpret_cast<const float4*>(gx)[i];\n",
     "    float4 v = reinterpret_cast<const float4*>(gp)[i];\n"),
    ("      const float4 u = reinterpret_cast<const float4*>(gx + r * hl)[i];\n",
     "      const float4 u = reinterpret_cast<const float4*>(gp)[i];\n"),
    ("  cluster_wait();       // every peer's copy of this block's partial is done: it may exit\n", ""),
]
_NO_COPY = [("    if (j == 0) mbar_arrive_expect_tx(bar, 4u * cw * Hp);\n",
             "    if (j == 0) mbar_arrive(bar);\n"),
            ("      bulk_copy_g2s(d, w + (size_t)j * C, 4u * cw, bar);\n", ""),
            ("    for (int c = threadIdx.x & 31; c < Hp; c += 32) cp_async4(hs + r * ldg + c, h + r * Hp + c);\n",
             "")]
_CLUSTER = "constexpr int QD_CL = 2;        // blocks per object (quad): a cluster\n"
_THREADS = "constexpr int QD_NT = 256;      // threads per block (quad)\n"
PARTS = {"copies": [_NO_PRODUCT] + _NO_Z, "no_exchange": _NO_EXCHANGE, "no_z": _NO_Z,
         "empty": _NO_COPY + [_NO_PRODUCT] + _NO_Z,
         "cl1": [(_CLUSTER, _CLUSTER.replace("= 2;", "= 1;"))],
         "cl4": [(_CLUSTER, _CLUSTER.replace("= 2;", "= 4;"))],
         "nt128": [(_THREADS, _THREADS.replace("256", "128"))],
         "cl4_nt128": [(_CLUSTER, _CLUSTER.replace("= 2;", "= 4;")),
                       (_THREADS, _THREADS.replace("256", "128"))]}
CHECKED = ("whole", "cl1", "cl4", "nt128", "cl4_nt128")   # the parts whose output is z

# The stamped copy: thread 0 of each block writes clock64() at each of these
# places (before or after the text), %globaltimer at entry and exit and its
# SM's id; the stamps of the last launch are read back.
_STAMPS = r"""
constexpr int QD_SLOTS = 16;    // per block: 11 clocks, 2 times, the SM
__device__ long long g_qd_stamps[4096 * QD_SLOTS];
__device__ inline void qd_stamp(int p) {
  if (threadIdx.x != 0 || blockIdx.x >= 4096) return;
  long long* s = g_qd_stamps + blockIdx.x * QD_SLOTS;
  s[p] = clock64();
  if (p == 0 || p == 10) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    s[11 + (p == 10)] = t;
  }
  if (p == 0) {
    unsigned sm_id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_id));
    s[13] = sm_id;
  }
}
"""
_READ = """
extern "C" int pr_quad_stamps(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_qd_stamps, sizeof(long long) * n);
}
"""
# (text, stamp before it or after it, place)
_PLACES = [
    ("  const QuadSmem L = quad_smem(Hp, cs, rs);\n", "before", 0, "entry"),
    ("    mbar_wait(full + sc, (ch / TG_STAGES) & 1);\n    const float* as = sm + sc * STAGE;\n",
     "after", 1, "chunk 0 landed"),   # and chunk 1, at place 2
    ("  __syncthreads();      // every warp is done with the ring: it takes the partials\n"
     "  float4* part = reinterpret_cast<float4*>(sm);  // [QD_NW][TILES][32], fragment order\n",
     "after", 3, "Gram partial"),
    ("  fence_proxy_async();  // this thread's stores to gp, before the bulk copies read it\n",
     "before", 4, "warps' partials summed"),
    ("  cluster_wait();       // every peer's mbarriers are set up\n", "after", 5, "peers set up"),
    ("  mbar_wait(xbar, 0);   // every peer's partial is in its slot\n", "after", 6,
     "peers' partials landed"),
    ("  float* zs = sm;       // a run of z's rows [nb][Hp], in the ring\n", "before", 7,
     "partials summed"),
    ("    __syncthreads();    // g and the run's hp rows are whole\n", "after", 8,
     "hp rows landed"),
    ("    __syncthreads();    // the run's z is whole: stored as one contiguous run\n", "after", 9,
     "z products"),
    ("  cluster_wait();       // every peer's copy of this block's partial is done: it may exit\n",
     "after", 10, "z stored, exit barrier"),
]
NAMES = ["entry", "chunk 0 landed", "chunk 1 landed"] + [p[3] for p in _PLACES[2:]]


def stamped_source() -> Path:
    """probes.cu with the quad kernel's stamps, under build/kernels/parts/."""
    text = (kernels.CSRC / "probes.cu").read_text()
    if text.count("namespace {\n") != 1:
        raise RuntimeError("probes.cu: no single anonymous namespace for the stamps")
    text = text.replace("namespace {\n", "namespace {\n" + _STAMPS, 1)
    for old, where, place, _ in _PLACES:
        if text.count(old) != 1:
            raise RuntimeError(f"probes.cu: the text of stamp {place} is not there once")
        stamp = ("    if (ch < 2) qd_stamp(1 + ch);\n" if place == 1
                 else " " * (len(old) - len(old.lstrip())) + f"qd_stamp({place});\n")
        text = text.replace(old, stamp + old if where == "before" else old + stamp)
    path = kernels.BUILD_DIR / "parts" / "probes_stamps.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text + _READ)
    return path


def phases(lib, call) -> dict:
    """Per phase (place p-1 to p) the mean and largest of the blocks' clock64
    cycles, the SM clock from globaltimer, the spread of the blocks' entries
    and exits (ns after the first entry) and the blocks per SM."""
    lib.pr_quad_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pr_quad_stamps.restype = ctypes.c_int
    nb = launch(lib)["blocks"]
    buf = torch.zeros(nb * 16, dtype=torch.int64)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    if lib.pr_quad_stamps(buf.data_ptr(), buf.numel()):
        raise RuntimeError("pr_quad_stamps failed")
    st = buf.view(nb, 16).double()
    clk, t0, t1 = st[:, :11], st[:, 11], st[:, 12]
    ghz = float((clk[:, 10] - clk[:, 0]).sum() / (t1 - t0).sum())
    d = clk[:, 1:] - clk[:, :-1]
    out = {NAMES[p]: [round(float(d[:, p - 1].mean()) / ghz, 1),
                      round(float(d[:, p - 1].max()) / ghz, 1)] for p in range(1, 11)}
    first = float(t0.min())
    per_sm = torch.bincount(st[:, 13].long()).tolist()
    return {"ns_mean_max": out, "sm_ghz": round(ghz, 3),
            "entry_ns": [round(float(t0.min()) - first), round(float(t0.max()) - first)],
            "exit_ns": [round(float(t1.min()) - first), round(float(t1.max()) - first)],
            "block_ns_mean_max": [round(float((t1 - t0).mean())), round(float((t1 - t0).max()))],
            "blocks_per_sm": {str(k): per_sm.count(k) for k in sorted(set(per_sm))}}


def _typed(path: Path) -> ctypes.CDLL:
    lib = kernels.load(path)
    lib.pr_part_quad.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pr_part_quad.restype = ctypes.c_int
    if hasattr(lib, "pr_part_quad_launch"):
        lib.pr_part_quad_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.pr_part_quad_launch.restype = ctypes.c_int
    return lib


def launch(lib) -> dict | None:
    """The launch ``lib``'s pr_part_quad makes at q5's shape, where it says."""
    if not hasattr(lib, "pr_part_quad_launch"):
        return None
    res = (ctypes.c_int * 6)()
    err = lib.pr_part_quad_launch(O, R, HP, C, res)
    if err:
        raise RuntimeError(f"pr_part_quad_launch: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "blocks", "cluster",
                     "clusters_resident"), res))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, nargs="*", default=[],
                    help="other probes.cu files with the same pr_part_quad, each timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("part_quad_parts: no CUDA device", file=sys.stderr)
        return 2
    from openobj_torch.scripts._benchlib import rel_err, scan_time

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    srcs = part_sources(parts=PARTS)
    for path in args.against:
        srcs[str(path)] = path.resolve()
    stamped = stamped_source()
    kernels.build(tuple(srcs.values()) + (stamped,))
    libs = {part: _typed(path) for part, path in srcs.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    wb = torch.randn((O, HP, C), generator=gen, device=device) * 0.1
    hp = torch.randn((O, R, HP), generator=gen, device=device) * 0.1
    z = torch.empty((O, R, HP), device=device)

    def call(part):
        err = libs[part].pr_part_quad(hp.data_ptr(), wb.data_ptr(), z.data_ptr(), O, R, HP, C,
                                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pr_part_quad ({part}): CUDA error {err}")

    ref = probes.part_quad_plain(hp, wb)
    errs = {}
    for part in list(CHECKED) + [str(path) for path in args.against]:
        z.fill_(float("nan"))
        call(part)
        errs[part] = rel_err(z, ref)
    us = {part: [] for part in libs}
    for order in (list(libs), list(libs)[::-1]):
        for part in order:
            us[part].append(round(scan_time(lambda: call(part), iters=ITERS) * 1e6, 3))
    print(json.dumps({"shape": [O, R, HP, C], "us": us, "rel_err": errs,
                      "launch": {part: launch(lib) for part, lib in libs.items()}}), flush=True)
    slib = _typed(stamped)
    print(json.dumps({"phases": phases(slib, lambda: slib.pr_part_quad(
        hp.data_ptr(), wb.data_ptr(), z.data_ptr(), O, R, HP, C,
        torch.cuda.current_stream().cuda_stream))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

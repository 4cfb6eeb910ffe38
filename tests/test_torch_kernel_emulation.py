"""K1 and K2, the fused-field forward and backward of
openobj_torch/csrc/fused_field.cu, and the part term's {t, g}, dW and
quadratic kernels, the chain and the ensemble GEMM's kernels of
openobj_torch/csrc/probes.cu, run on the CPU against their plain versions.

Each CUDA source is compiled by the host C++ compiler with ``STUB`` (below)
included ahead of it: the stub stands in for the CUDA built-ins and the
inline-PTX helpers that the source builds only under nvcc, runs each
block's threads as ``std::thread``s and emulates ``mma.sync`` from its
documented fragment layout. That checks the kernel's indexing: fragments,
swizzled shared memory, the packed layout and its bias rows, ragged
chunks, tiles of several chunks, the clip head on and off, for the
tensor-core K1 and K2 at the widths ``EMU_TC_WIDTHS`` (weights in shared
memory at h = 16 and 32, from L2 at 48 to 128), and for the SIMT kernels at
widths outside them; and the same for their bf16 build (``FF_BF16``, what
``csrc/fused_field_bf16.cu`` compiles) against the plain version in bf16. The emulation builds only the tensor-core widths its
tests use (``FF_TC_WIDTHS``, defined for the host compiler); the card
builds every multiple of 16 up to 128. It says nothing of speed or of the
card's own rounding;
``tests/test_torch_kernels.py`` holds the real kernels to the same plain
version on a GPU (``tests/test_torch_probe_kernels.py`` for the part term
and the ensemble GEMM).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from openobj_torch.models import object_field as tof
from openobj_torch.ops import fused_field as tff
from openobj_torch.ops import probes

CSRC = Path(__file__).resolve().parents[1] / "openobj_torch" / "csrc"
FWD_ATOL = 1e-4      # as tests/test_torch_kernels.py
GRAD_RTOL = 1e-3
GEMM_RTOL = 1e-5     # as tests/test_torch_probe_kernels.py
CHAIN_RTOL = 1e-4    # as tests/test_torch_probe_kernels.py
# the tensor-core widths the emulated fused_field.cu is built with
EMU_TC_WIDTHS = (16, 32, 48, 64, 96, 128)

# What the CUDA source needs from the CUDA runtime and from its inline-PTX
# helpers, for a host C++20 compiler:
STUB = r"""
//  * each block's threads are std::threads, __syncthreads a std::barrier,
//    and each named barrier (bar.sync id, n) a std::barrier of n made at
//    its first use in a block;
//  * the blocks of a thread-block cluster (cudaLaunchKernelEx with a cluster
//    dimension) run their threads together, and a cluster's blocks are
//    consecutive in x; barrier.cluster is a std::barrier over all of the
//    cluster's threads (its arrive and wait, apart, the barrier's), ld_cluster
//    (mapa + ld.shared::cluster) reads and a bulk copy to a peer
//    (cp.async.bulk.shared::cluster) writes the same offset in the peer
//    block's shared buffer;
//  * mma.sync m16n8k8 (tf32 operands, f32 accumulator) and __shfl_sync are
//    warp-wide exchanges through a std::barrier of 32 threads, mma computed
//    from the PTX
//    fragment layout (g = lane >> 2, t = lane & 3; a0..a3 = A[g][t],
//    A[g+8][t], A[g][t+4], A[g+8][t+4]; b0, b1 = B[t][g], B[t+4][g];
//    c0..c3 = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]);
//  * mma.sync m16n8k16 with bf16 operands likewise (each register holds two
//    bf16, the first in its low half: a regs = A[g][2t..], A[g+8][2t..],
//    A[g][2t+8..], A[g+8][2t+8..]; b regs = B[2t..][g], B[2t+8..][g]; the
//    same C), summed in f32 in k order;
//  * ldmatrix (.x1, .x2, .x4, .trans) is a warp exchange of the lanes' row
//    addresses: row i of matrix j at lane 8j + i's address; register j of
//    lane (g, t) holds row g's columns 2t, 2t + 1 of matrix j, or with .trans
//    column g's rows 2t, 2t + 1;
//  * __syncwarp is the warp's std::barrier;
//  * cvt.rna.tf32.f32 rounds to 10 mantissa bits, ties away from zero, and
//    cvt.rn.bf16x2.f32 to 7, ties to even (finite values);
//  * dynamic shared memory is filled with NaN before each block, so that a
//    read of memory the kernel never wrote shows in its outputs;
//  * the device has emu_set_sm_count(n) SMs (132 unless set), so that a test
//    can make K1's tile rule give tiles of several chunks at small sizes;
//  * an mbarrier is 8 bytes of the kernel's shared memory (its transaction
//    count, pending arrivals, expected arrivals and phase bit), changed
//    under one lock; a phase completes when no arrival and no byte is
//    pending, and try_wait.parity blocks the waiting thread until the phase
//    of that parity has completed. A bulk copy is a memcpy, made while a
//    thread waits on its mbarrier (so a read that does not wait sees the
//    old contents), that then completes its bytes; cp.async is a plain
//    copy, so the arrival that waits for a thread's cp.asyncs is made at
//    once.
// It checks indexing, layouts and synchronisation, not the card's rounding
// (the tensor cores truncate where this rounds) and not speed.
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <functional>
#include <memory>
#include <mutex>
#include <optional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __align__(x)
#define __launch_bounds__(...)
#define __restrict__
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local uint3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
struct WarpRegs { uint32_t a[32][4], b[32][2]; float f[32]; const uint16_t* p[32]; };
struct EmuBlock {   // one running block: its shared memory, barriers and warp exchanges
  float* smem = nullptr;
  std::barrier<>* bar = nullptr;
  std::barrier<>* warp_bar[32] = {};
  WarpRegs wr[32];
  std::mutex named_mu;
  std::barrier<>* named_bar[16] = {};
  ~EmuBlock() {
    delete bar;
    for (auto* b : warp_bar) delete b;
    for (auto* b : named_bar) delete b;
  }
};
struct EmuCluster { std::barrier<>* bar; std::vector<EmuBlock*> blocks; };
inline thread_local EmuBlock* t_blk;
inline thread_local EmuCluster* t_clu;
inline float* emu_smem() { return t_blk->smem; }
inline void __syncthreads() { t_blk->bar->arrive_and_wait(); }
inline void named_sync(int id, int n) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(t_blk->named_mu);
    if (!t_blk->named_bar[id]) t_blk->named_bar[id] = new std::barrier<>(n);
    b = t_blk->named_bar[id];
  }
  b->arrive_and_wait();
}
inline void cluster_sync() { t_clu->bar->arrive_and_wait(); }
inline thread_local std::optional<std::barrier<>::arrival_token> t_cluster_token;
inline void cluster_arrive_relaxed() { t_cluster_token.emplace(t_clu->bar->arrive()); }
inline void cluster_wait() { t_clu->bar->wait(std::move(*t_cluster_token)); }
inline float ld_cluster(const float* p, unsigned rank) {
  return t_clu->blocks[rank]->smem[p - t_blk->smem];
}
inline float __ldg(const float* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
template <class T> T min(T a, T b) { return a < b ? a : b; }
template <class T> T max(T a, T b) { return a > b ? a : b; }
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int threads, size_t smem) {
  // by threads (2,048 an SM) and shared memory (227 KB) alone: the
  // registers are not known without the card
  *n = (int)std::min<size_t>(2048 / threads, smem ? 232448 / smem : 32);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <class T> cudaError_t cudaMemcpyToSymbol(T& sym, const void* src, size_t n) {
  std::memcpy(&sym, src, n);
  return 0;
}
inline int g_sm_count = 132;
extern "C" void emu_set_sm_count(int n) { g_sm_count = n; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = g_sm_count; return 0; }
inline size_t g_smem_max = 0;

inline float round_bf16(float x) {   // cvt.rn.bf16x2.f32: nearest, ties to even
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}
inline uint32_t to_tf32(float x) {
  uint32_t u; std::memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x1000u;
  return u & 0xffffe000u;
}
inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int w = threadIdx.x >> 5, L = threadIdx.x & 31;
  WarpRegs& R = t_blk->wr[w];
  for (int i = 0; i < 4; ++i) R.a[L][i] = a[i];
  R.b[L][0] = b[0]; R.b[L][1] = b[1];
  t_blk->warp_bar[w]->arrive_and_wait();
  float A[16][8], B[8][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    A[g][t] = __uint_as_float(R.a[l][0]); A[g + 8][t] = __uint_as_float(R.a[l][1]);
    A[g][t + 4] = __uint_as_float(R.a[l][2]); A[g + 8][t + 4] = __uint_as_float(R.a[l][3]);
    B[t][g] = __uint_as_float(R.b[l][0]); B[t + 4][g] = __uint_as_float(R.b[l][1]);
  }
  const int g = L >> 2, t = L & 3;
  const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int i = 0; i < 4; ++i) {
    float s = c[i];
    for (int k = 0; k < 8; ++k) s += A[rows[i]][k] * B[k][cols[i]];
    c[i] = s;
  }
  t_blk->warp_bar[w]->arrive_and_wait();
}
inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int w = threadIdx.x >> 5, L = threadIdx.x & 31;
  WarpRegs& R = t_blk->wr[w];
  for (int i = 0; i < 4; ++i) R.a[L][i] = a[i];
  R.b[L][0] = b[0]; R.b[L][1] = b[1];
  t_blk->warp_bar[w]->arrive_and_wait();
  const auto lo = [](uint32_t u) { return __uint_as_float(u << 16); };
  const auto hi = [](uint32_t u) { return __uint_as_float(u & 0xffff0000u); };
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int i = 0; i < 4; ++i) {   // rows g (+8 for odd i), columns 2t (+8 for i >= 2)
      const int r = g + 8 * (i & 1), k = 2 * t + 8 * (i >> 1);
      A[r][k] = lo(R.a[l][i]); A[r][k + 1] = hi(R.a[l][i]);
    }
    for (int i = 0; i < 2; ++i) {
      B[2 * t + 8 * i][g] = lo(R.b[l][i]); B[2 * t + 8 * i + 1][g] = hi(R.b[l][i]);
    }
  }
  const int g = L >> 2, t = L & 3;
  const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int i = 0; i < 4; ++i) {
    float s = c[i];
    for (int k = 0; k < 16; ++k) s += A[rows[i]][k] * B[k][cols[i]];
    c[i] = s;
  }
  t_blk->warp_bar[w]->arrive_and_wait();
}
template <int NM, bool TRANS>
inline void emu_ldsm(uint32_t* r, const uint16_t* p) {
  const int w = threadIdx.x >> 5, L = threadIdx.x & 31;
  WarpRegs& R = t_blk->wr[w];
  R.p[L] = p;
  t_blk->warp_bar[w]->arrive_and_wait();
  const int g = L >> 2, t = L & 3;
  for (int j = 0; j < NM; ++j) {
    const uint16_t* rows = nullptr;
    uint32_t e0, e1;
    if (TRANS) {   // column g of rows 2t and 2t + 1
      e0 = R.p[8 * j + 2 * t][g];
      e1 = R.p[8 * j + 2 * t + 1][g];
    } else {       // row g, columns 2t and 2t + 1
      rows = R.p[8 * j + g];
      e0 = rows[2 * t];
      e1 = rows[2 * t + 1];
    }
    r[j] = e0 | (e1 << 16);
  }
  t_blk->warp_bar[w]->arrive_and_wait();
}
inline void ldsm_x1(uint32_t (&r)[1], const uint16_t* p) { emu_ldsm<1, false>(r, p); }
inline void ldsm_x2(uint32_t (&r)[2], const uint16_t* p) { emu_ldsm<2, false>(r, p); }
inline void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) { emu_ldsm<4, false>(r, p); }
inline void ldsm_x1_t(uint32_t (&r)[1], const uint16_t* p) { emu_ldsm<1, true>(r, p); }
inline void ldsm_x2_t(uint32_t (&r)[2], const uint16_t* p) { emu_ldsm<2, true>(r, p); }
inline void ldsm_x4_t(uint32_t (&r)[4], const uint16_t* p) { emu_ldsm<4, true>(r, p); }
inline float __shfl_sync(unsigned, float v, int src) {   // through the warp's exchange
  const int w = threadIdx.x >> 5;
  t_blk->wr[w].f[threadIdx.x & 31] = v;
  t_blk->warp_bar[w]->arrive_and_wait();
  const float r = t_blk->wr[w].f[src & 31];
  t_blk->warp_bar[w]->arrive_and_wait();
  return r;
}
inline void __syncwarp() { t_blk->warp_bar[threadIdx.x >> 5]->arrive_and_wait(); }
inline void cp_async4(float* dst, const float* src) { *dst = *src; }
inline void cp_async16(float* dst, const float* src) { std::memcpy(dst, src, 16); }
inline void cp_async_commit() {}
template <int N> void cp_async_wait() {}
inline void cp_async_wait_all() {}

struct EmuBar { int32_t tx; uint16_t pending; uint16_t expected_phase; };   // phase: bit 15
static_assert(sizeof(EmuBar) == sizeof(uint64_t));
inline std::mutex g_bar_mu;
inline std::condition_variable g_bar_cv;
struct EmuCopy { uint64_t* bar; void* dst; const void* src; unsigned bytes; };
inline std::vector<EmuCopy> g_copies;   // bulk copies started, not landed yet
inline EmuBar& emu_bar(uint64_t* bar) { return *reinterpret_cast<EmuBar*>(bar); }
inline void emu_bar_update(uint64_t* bar, int arrivals, int64_t tx) {   // under the lock
  EmuBar& m = emu_bar(bar);
  m.pending -= arrivals;
  m.tx += (int32_t)tx;
  if (m.pending == 0 && m.tx == 0) {   // the phase completes
    m.expected_phase ^= 0x8000;
    m.pending = m.expected_phase & 0x7fff;
    g_bar_cv.notify_all();
  }
}
inline void mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> lock(g_bar_mu);
  emu_bar(bar) = {0, (uint16_t)count, (uint16_t)count};
}
inline void mbar_init_fence() {}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(g_bar_mu);
  emu_bar_update(bar, 1, 0);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> lock(g_bar_mu);
  emu_bar_update(bar, 1, bytes);
}
// A bulk copy lands when a thread waits on its mbarrier, no earlier (a copy
// from a peer block while the thread waits): a read of the stage that does
// not wait for it sees the old contents.
inline void bulk_copy_g2s(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  std::lock_guard<std::mutex> lock(g_bar_mu);
  g_copies.push_back({bar, dst, src, bytes});
  g_bar_cv.notify_all();
}
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> lock(g_bar_mu);
  g_bar_cv.wait(lock, [&] {
    for (size_t i = 0; i < g_copies.size();) {
      const EmuCopy c = g_copies[i];
      if (c.bar != bar) { ++i; continue; }
      g_copies.erase(g_copies.begin() + i);
      std::memcpy(c.dst, c.src, c.bytes);
      emu_bar_update(bar, 0, -(int64_t)c.bytes);
    }
    return (unsigned)(emu_bar(bar).expected_phase >> 15) != parity;
  });
}
inline void cp_async_mbar_arrive(uint64_t* bar) { mbar_arrive(bar); }
inline void bulk_copy_s2peer(float* p, unsigned bytes, uint64_t* bar, unsigned rank) {
  float* peer = t_clu->blocks[rank]->smem;
  bulk_copy_g2s(peer + (p - t_blk->smem), p, bytes,
                reinterpret_cast<uint64_t*>(peer + (reinterpret_cast<float*>(bar) - t_blk->smem)));
}
inline void fence_proxy_async() {}

// Blocks in clusters of nc (consecutive in x), one cluster at a time, each
// block's shared memory NaN-filled: catches reads of unset memory.
template <class F>
void emu_launch_cluster(dim3 grid, int nt, size_t smem, unsigned nc, F fn) {
  if (smem > g_smem_max) g_smem_max = smem;
  gridDim = grid; blockDim = dim3(nt);
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x0 = 0; x0 < grid.x; x0 += nc) {
      std::vector<std::vector<float>> mem(nc, std::vector<float>(smem / 4 + 16, std::nanf("")));
      std::vector<std::unique_ptr<EmuBlock>> blocks;
      std::barrier<> cb(nc * nt);
      EmuCluster clu{&cb, {}};
      for (unsigned r = 0; r < nc; ++r) {
        blocks.push_back(std::make_unique<EmuBlock>());
        EmuBlock* b = blocks.back().get();
        b->smem = mem[r].data();
        b->bar = new std::barrier<>(nt);
        for (int w = 0; w < nt / 32; ++w) b->warp_bar[w] = new std::barrier<>(32);
        clu.blocks.push_back(b);
      }
      std::vector<std::thread> th;
      for (unsigned r = 0; r < nc; ++r)
        for (int i = 0; i < nt; ++i)
          th.emplace_back([&, r, i] {
            threadIdx = {(unsigned)i, 0, 0};
            blockIdx = {x0 + r, y, 0};
            t_blk = clu.blocks[r];
            t_clu = &clu;
            fn();
          });
      for (auto& t : th) t.join();
      g_copies.clear();   // a copy no thread waited for never lands
    }
}

template <class F>
void emu_launch(dim3 grid, int nt, size_t smem, cudaStream_t, F fn) {
  emu_launch_cluster(grid, nt, smem, 1, fn);
}

struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { int id; cudaLaunchAttributeValue val; };
enum { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(P...), A&&... args) {
  unsigned nc = 1;
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension) nc = c->attrs[i].val.clusterDim.x;
  if (nc < 1 || nc > 8 || c->gridDim.x % nc) return cudaErrorInvalidValue;
  emu_launch_cluster(c->gridDim, c->blockDim.x, c->dynamicSmemBytes, nc, [&] { k(args...); });
  return 0;
}
// every SM's resident blocks in whole clusters, as if one GPC held them all
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F k, const cudaLaunchConfig_t* c) {
  unsigned nc = 1;
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension) nc = c->attrs[i].val.clusterDim.x;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, c->blockDim.x, c->dynamicSmemBytes);
  *n = per_sm * g_sm_count / (int)nc;
  return 0;
}
"""


def _host_source(name: str, root: Path = CSRC) -> str:
    """<root>/<name>.cu (csrc/ by default) for the host compiler, with the
    files it includes from beside it inlined: dynamic shared memory is the
    stub's buffer, and each <<<grid, block, smem, stream>>> launch goes
    through ``emu_launch``."""
    def inline(text: str) -> str:
        return re.sub(r'^#include "([^"]+)"', lambda m: inline((root / m.group(1)).read_text()),
                      text, flags=re.M)

    s = inline((root / f"{name}.cu").read_text())
    s = re.sub(r"extern __shared__ (__align__\(16\) )?float sm\[\];", "float* sm = emu_smem();", s)
    return re.sub(r"(\w+(?:<[\w, ]+>)?)<<<([^>]*)>>>\((.*?)\);",
                  r"emu_launch(\2, [&] { \1(\3); });", s, flags=re.S)


def _emulated_start(tmp_path_factory, name: str, defines=()):
    """Start the host compiler on csrc/<name>.cu; ``_emulated_finish`` loads
    the library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the CUDA source")
    out = tmp_path_factory.mktemp(f"{name}_emu")
    cpp, stub, so = out / f"{name}_emu.cpp", out / "cuda_emu.h", out / f"lib{name}_emu.so"
    cpp.write_text(_host_source(name))
    stub.write_text(STUB)
    proc = subprocess.Popen([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                             "-Wno-unknown-pragmas", *defines, "-include", str(stub), "-o",
                             str(so), str(cpp)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, so


def _emulated_finish(job) -> ctypes.CDLL:
    proc, so = job
    out, err = proc.communicate()
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, proc.args, out, err)
    return ctypes.CDLL(str(so))


def _emulated(tmp_path_factory, name: str, defines=()) -> ctypes.CDLL:
    return _emulated_finish(_emulated_start(tmp_path_factory, name, defines))


def _fused_field_emu(lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn in (lib.ff_tc_width, lib.ff_bwd_chunk, lib.ff_bwd_max_tile):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.ff_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.ff_forward.restype = ctypes.c_int
    lib.ff_backward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.ff_backward.restype = ctypes.c_int
    lib.emu_set_sm_count.argtypes = [ctypes.c_int]
    lib.ff_param_count.argtypes = [ctypes.c_int]
    lib.ff_param_count.restype = ctypes.c_int
    lib.ff_bwd_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ff_bwd_scratch.restype = ctypes.c_int
    lib.ff_fwd_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.ff_fwd_launch.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def fused_field_emus(tmp_path_factory):
    """fused_field.cu for the host, built twice at once: as it is ("f32")
    and with FF_BF16 defined ("bf16", all that csrc/fused_field_bf16.cu
    is)."""
    widths = " ".join(f"X({h})" for h in EMU_TC_WIDTHS)
    jobs = {cd: _emulated_start(tmp_path_factory, "fused_field",
                                [f"-DFF_TC_WIDTHS(X)={widths}", *defines])
            for cd, defines in (("f32", []), ("bf16", ["-DFF_BF16=1"]))}
    return {cd: _fused_field_emu(_emulated_finish(job)) for cd, job in jobs.items()}


@pytest.fixture(scope="module")
def emu_lib(fused_field_emus):
    return fused_field_emus["f32"]


@pytest.fixture(scope="module")
def emu_lib_bf16(fused_field_emus):
    return fused_field_emus["bf16"]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _field(rng, o, n, h, do_clip):
    """Packed weights (random biases too) and points of o objects."""
    gen = torch.Generator().manual_seed(0)
    params = tof.init_stacked_fields(gen, o, hidden=h, clip_size=16, device="cpu")
    params = tof.tree_map(lambda x: x + 0.05 * torch.randn(x.shape, generator=gen), params)
    w = tff._pack_params(params, h, do_clip).contiguous()
    pts = torch.from_numpy((0.5 * rng.standard_normal((o, n, 3))).astype(np.float32))
    return w, pts


@pytest.mark.parametrize("o,n,h,do_clip,n_sm", [
    (2, 70, 32, True, 1),        # one block per object: a chunk, then 6 points
    (2, 37, 32, False, 132),     # clip head off, one ragged chunk
    (3, 150, 32, True, 4),       # tiles of 3 chunks (64, 64, 22 points)
    (1, 150, 128, True, 1),      # h=128: one block walks 3 chunks
    (1, 100, 128, False, 132),   # h=128, clip head off: a chunk per block
    (2, 40, 64, True, 132),      # h=64: weights from L2, all 4 row tiles per item
    # the other tensor-core widths: weights in shared memory at h=16, from L2
    # at 48 and 64 (one n-tile per item) and 96 (two); one ragged chunk per
    # block but for a tile of several chunks at h=16 and at h=48
    (2, 150, 16, True, 1),       # one block per object walks 3 chunks (64, 64, 22)
    (2, 37, 16, False, 132),     # clip head off, one ragged chunk
    (1, 40, 48, True, 132),
    (1, 70, 48, False, 1),       # one block walks 2 chunks (64, 6), clip head off
    (1, 40, 64, False, 132),     # clip head off
    (1, 40, 96, True, 132),
    (1, 37, 96, False, 132),
    # widths without a tensor-core kernel: the SIMT kernel
    (2, 40, 24, True, 132),
    (1, 70, 24, False, 132),
])
def test_emulated_k1_matches_plain(emu_lib, o, n, h, do_clip, n_sm):
    lib = emu_lib
    assert lib.ff_tc_width(h) == (h in EMU_TC_WIDTHS)
    w, pts = _field(np.random.default_rng(1), o, n, h, do_clip)
    ref = tff.fused_field_plain(w, pts, h, do_clip)
    outs = [np.full((o, n, k), np.nan, np.float32) for k in (1, 3, h)]
    wn, pn = (np.ascontiguousarray(x.numpy()) for x in (w, pts))
    lib.emu_set_sm_count(n_sm)
    err = lib.ff_forward(_ptr(pn), _ptr(wn), _ptr(outs[0]), _ptr(outs[1]),
                         _ptr(outs[2]) if do_clip else None, o, n, h, int(do_clip), None)
    lib.emu_set_sm_count(132)
    assert err == 0
    for got, want in zip(outs, ref):
        if want is None:
            assert np.isnan(got).all()
            continue
        assert float(np.abs(got - want.numpy()).max()) <= FWD_ATOL


@pytest.mark.parametrize("o,n,h,do_clip,tile", [
    (2, 70, 32, True, 64),       # 2 tiles: 2 chunks, then 6 points
    (2, 37, 32, False, 64),      # clip head off
    (3, 40, 32, True, 32),       # one chunk per tile, then 8 points
    (1, 40, 128, True, 32),      # h=128: one chunk per tile
    (1, 33, 128, False, 32),
    # the other tensor-core widths: on chip across the tile at h=16, one
    # chunk per tile from L2 at 48 to 128
    (1, 75, 64, True, 32),       # 3 tiles, the last 11 points
    (2, 37, 16, False, 32),      # clip head off
    (2, 100, 16, True, 64),      # 2 tiles: 2 chunks, then 32 + 4 points
    (1, 75, 16, True, 96),       # one tile of 3 chunks, the last 11 points
    (2, 40, 64, False, 32),      # clip head off
    (1, 40, 48, True, 32),       # 2 tiles, the last 8 points
    (1, 33, 48, False, 32),
    (1, 45, 96, True, 32),
    (1, 20, 96, False, 32),      # fewer points than a chunk
    # widths without a tensor-core kernel: the SIMT kernel, gradients added
    # into the slot per chunk
    (2, 70, 8, True, 64),        # 2 tiles: 2 chunks, then 6 points
    (1, 75, 24, True, 96),       # one tile of 3 chunks, the last 11 points
    (2, 37, 24, False, 32),      # clip head off
])
def test_emulated_k2_matches_plain(emu_lib, o, n, h, do_clip, tile):
    lib = emu_lib
    assert lib.ff_tc_width(h) == (h in EMU_TC_WIDTHS)
    assert tile % lib.ff_bwd_chunk(h) == 0 and tile <= lib.ff_bwd_max_tile(h)
    rng = np.random.default_rng(0)
    w, pts = _field(rng, o, n, h, do_clip)
    cts = [torch.from_numpy(rng.standard_normal((o, n, k)).astype(np.float32)) for k in (1, 3, h)]

    wr = w.detach().requires_grad_(True)
    outs = tff.fused_field_plain(wr, pts, h, do_clip)
    obj = sum((x * c).sum() for x, c in zip(outs, cts) if x is not None)
    (g_p,) = torch.autograd.grad(obj, wr)

    p = lib.ff_param_count(h)
    assert p == w.shape[1]
    part = np.full((o, -(-n // tile), p), np.nan, np.float32)
    arrs = [np.ascontiguousarray(x.detach().numpy()) for x in (w, pts, *cts)]
    wn, pn, dan, dcn, dhn = arrs
    err = lib.ff_backward(_ptr(pn), _ptr(wn), _ptr(dan), _ptr(dcn),
                          _ptr(dhn) if do_clip else None, _ptr(part), o, n, h,
                          int(do_clip), tile, None)
    assert err == 0
    g_k = torch.from_numpy(part.sum(axis=1))
    ofs = 0
    for name, (r, c) in tff.param_layout(h):
        ref, got = g_p[:, ofs:ofs + r * c], g_k[:, ofs:ofs + r * c]
        ofs += r * c
        if not do_clip and name in ("w_clip", "b_clip"):
            assert not got.any(), name
            continue
        assert float((got - ref).abs().max()) <= GRAD_RTOL * float(ref.abs().max()) + 1e-7, name


def _bf16_grads(w, pts, cts, h, do_clip):
    """The plain version's packed gradient in bf16 and in f32."""
    out = {}
    for cd in ("bf16", "f32"):
        wr = w.detach().requires_grad_(True)
        outs = tff.fused_field_plain(wr, pts, h, do_clip, cd)
        obj = sum((x * c).sum() for x, c in zip(outs, cts) if x is not None)
        (out[cd],) = torch.autograd.grad(obj, wr)
    return out["bf16"], out["f32"]


# the bf16 kernels (fused_field.cu built with FF_BF16, as csrc/fused_field_bf16.cu
# builds it) against the plain version in bf16: K1's outputs by the card's
# gate (tff.bf16_output_errors at FWD_ATOL: the two sum in other orders, and
# a rounding flip moves a few outputs by a bf16 ulp of one product, here
# too), K2 per leaf at most a tenth of that leaf's distance between the
# plain bf16 and f32 gradients where bf16 moves the leaf at all (it does
# not move b_alpha)
@pytest.mark.parametrize("o,n,h,do_clip", [
    # on one emulated SM, K1 bf16 (ff_fwd_bf16_kernel) tiles by its resident
    # blocks: at h = 16 to 48 the image in shared memory, 64-point chunks,
    # two blocks an SM (four at 16 by the stub's count), so a block walks
    # both chunks (64, then 6) of an object where there are two objects, and
    # each is a block of its own where there is one; from 64 the ring, one
    # ragged chunk of 128
    *((2 if h <= 32 else 1, 70, h, True) for h in EMU_TC_WIDTHS),
    (1, 37, 32, False),          # clip head off, one ragged chunk
    (1, 37, 96, False),
    (2, 40, 24, True),           # the SIMT kernel
    # the ring at h = 128, one block an SM: a tile of two chunks, 128, then 72
    (1, 200, 128, True),
    (2, 100, 64, False),         # the ring with the clip head off, a ragged chunk an object
    # the tile rule puts two blocks on the one emulated SM: 3 chunks, then 2 (64 + 44)
    (1, 300, 32, True),
])
def test_emulated_k1_bf16_matches_plain(emu_lib_bf16, o, n, h, do_clip):
    lib = emu_lib_bf16
    w, pts = _field(np.random.default_rng(1), o, n, h, do_clip)
    ref = tff.fused_field_plain(w, pts, h, do_clip, "bf16")
    ref32 = tff.fused_field_plain(w, pts, h, do_clip)
    outs = [np.full((o, n, k), np.nan, np.float32) for k in (1, 3, h)]
    wn, pn = (np.ascontiguousarray(x.numpy()) for x in (w, pts))
    lib.emu_set_sm_count(1)
    plan = tff.fwd_launch(lib, o, n, h)
    err = lib.ff_forward(_ptr(pn), _ptr(wn), _ptr(outs[0]), _ptr(outs[1]),
                         _ptr(outs[2]) if do_clip else None, o, n, h, int(do_clip), None)
    lib.emu_set_sm_count(132)
    assert err == 0
    if (o, n, h) in ((1, 200, 128), (2, 100, 64), (1, 300, 32)):   # the cases' launches
        assert (plan["tile"], plan["blocks"]) == {128: (256, 1), 64: (128, 2), 32: (192, 2)}[h]
        assert (plan["blocks_per_sm"], plan["ring"]) == ((2, False) if h == 32 else (1, True))
    for got, want, want32 in zip(outs, ref, ref32):
        if want is None:
            assert np.isnan(got).all()
            continue
        e = tff.bf16_output_errors(torch.from_numpy(got), want, want32, FWD_ATOL)
        assert e["ok"], e


@pytest.mark.parametrize("o,n,h,do_clip,chunks", [
    # chunks per tile; K2 bf16's chunk is 64 points at h = 16, 32 and 64 to
    # 128, 32 at h = 48 (and in the SIMT kernel)
    (2, 70, 16, True, 2),        # on chip across a tile of 2 chunks (64, then 6)
    (2, 70, 32, True, 2),
    (1, 40, 48, True, 1),        # on chip, tiles of one chunk (32, then 8)
    (2, 40, 64, True, 1),        # the weight ring, one ragged chunk per tile
    (1, 45, 96, True, 1),
    (1, 40, 128, True, 1),
    (2, 37, 32, False, 1),       # clip head off
    (1, 33, 128, False, 1),
    (2, 70, 24, True, 2),        # the SIMT kernel
    # at h = 128 a tile is one chunk: 3 tiles, the last ragged (22 points);
    # every chunk streams 60 slabs through the ring's stages
    (1, 150, 128, True, 1),
    # the ring with the clip head off (32 slabs a chunk) at h = 64, 2 x 2 tiles
    (2, 100, 64, False, 1),
])
def test_emulated_k2_bf16_matches_plain(emu_lib_bf16, o, n, h, do_clip, chunks):
    lib = emu_lib_bf16
    tile = chunks * lib.ff_bwd_chunk(h)
    assert tile <= lib.ff_bwd_max_tile(h)
    rng = np.random.default_rng(0)
    w, pts = _field(rng, o, n, h, do_clip)
    cts = [torch.from_numpy(rng.standard_normal((o, n, k)).astype(np.float32)) for k in (1, 3, h)]
    g_bf, g_32 = _bf16_grads(w, pts, cts, h, do_clip)
    p, n_tiles = lib.ff_param_count(h), -(-n // tile)
    # the slots, then the scratch the kernel takes after them (the weight
    # images at a tensor-core width)
    buf = np.full(o * n_tiles * p + lib.ff_bwd_scratch(o, h), np.nan, np.float32)
    wn, pn, dan, dcn, dhn = (np.ascontiguousarray(x.detach().numpy()) for x in (w, pts, *cts))
    err = lib.ff_backward(_ptr(pn), _ptr(wn), _ptr(dan), _ptr(dcn),
                          _ptr(dhn) if do_clip else None, _ptr(buf), o, n, h,
                          int(do_clip), tile, None)
    assert err == 0
    g_k = torch.from_numpy(buf[:o * n_tiles * p].reshape(o, n_tiles, p).sum(axis=1))
    dev = tff.leaf_errors(g_k, g_bf, h)
    dist = tff.leaf_errors(g_bf, g_32, h)
    for name, d in dev.items():
        if not do_clip and name in ("w_clip", "b_clip"):
            assert d == 0.0, name
            continue
        limit = min(GRAD_RTOL, 0.1 * dist[name]) if dist[name] > 0 else GRAD_RTOL
        assert d <= limit, (name, d, dist[name])


@pytest.mark.parametrize("o,h,do_clip", [(2, 32, True), (1, 128, False), (3, 48, True)])
def test_emulated_bf16_weight_image_matches_plain(emu_lib_bf16, o, h, do_clip):
    """ff_bf16_image_kernel, K2 bf16's first launch, against its plain
    version, fused_field.bf16_weight_image: the images ff_backward leaves in
    the scratch after the slots (fused_field.bwd_image) equal bit for bit,
    padding zero."""
    lib, n = emu_lib_bf16, 4
    rng = np.random.default_rng(3)
    w, pts = _field(rng, o, n, h, do_clip)
    cts = [rng.standard_normal((o, n, k)).astype(np.float32) for k in (1, 3, h)]
    ref = tff.bf16_weight_image(w, h).view(torch.int16)
    buf = np.full(o * lib.ff_param_count(h) + lib.ff_bwd_scratch(o, h), np.nan, np.float32)
    assert lib.ff_bwd_scratch(o, h) >= ref.numel() // 2
    err = lib.ff_backward(_ptr(np.ascontiguousarray(pts.numpy())),
                          _ptr(np.ascontiguousarray(w.numpy())), *(_ptr(c) for c in cts),
                          _ptr(buf), o, n, h, int(do_clip), lib.ff_bwd_chunk(h), None)
    assert err == 0
    got = tff.bwd_image(torch.from_numpy(buf), o, 1, h).view(torch.int16)
    assert torch.equal(got, ref)


def _emulated_bf16_copy(src: Path, out: Path) -> ctypes.CDLL:
    """An edited copy ``src`` of csrc/fused_field_bf16.cu (beside copies of
    what it includes) for the host, at the tensor-core widths 32 and 128."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the CUDA source")
    (out / "emu.cpp").write_text(_host_source("fused_field_bf16", src.parent))
    (out / "stub.h").write_text(STUB)
    so = out / "libemu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", "-DFF_TC_WIDTHS(X)=X(32) X(128)", "-include",
                    str(out / "stub.h"), "-o", str(so), str(out / "emu.cpp")],
                   check=True, capture_output=True, text=True)
    return _fused_field_emu(ctypes.CDLL(str(so)))


def test_emulated_k2_bf16_masks_are_the_plain_versions(tmp_path, monkeypatch):
    """K2 bf16's recompute masks, read from the kernel's own stored operands
    by bench_fused_field's probed copy (emulated), equal the plain bf16
    version's at every point and unit of every ReLU layer: on chip across a
    tile of two chunks (h=32), through the ring with a ragged last tile
    (h=128), and with the clip head off."""
    from openobj_torch import kernels
    from openobj_torch.scripts import bench_fused_field as bench

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    lib = _emulated_bf16_copy(bench.probed_source(), tmp_path)
    lib.ff_mask_out.argtypes = [ctypes.c_void_p]
    for o, n, h, do_clip, chunks in ((2, 70, 32, True, 2), (1, 150, 128, True, 1),
                                     (1, 33, 128, False, 1)):
        rng = np.random.default_rng(5)
        w, pts = _field(rng, o, n, h, do_clip)
        cts = [rng.standard_normal((o, n, k)).astype(np.float32) for k in (1, 3, h)]
        tile = chunks * lib.ff_bwd_chunk(h)
        buf = np.zeros(o * -(-n // tile) * w.shape[1] + lib.ff_bwd_scratch(o, h), np.float32)
        got = np.full((o, n, h), 0xFF, np.uint8)
        assert lib.ff_mask_out(_ptr(got)) == 0
        err = lib.ff_backward(_ptr(np.ascontiguousarray(pts.numpy())),
                              _ptr(np.ascontiguousarray(w.numpy())), *(_ptr(c) for c in cts),
                              _ptr(buf), o, n, h, int(do_clip), tile, None)
        lib.ff_mask_out(None)
        assert err == 0
        assert not (got >> (6 if do_clip else 5)).any()   # every unit written, no stray bit
        want = bench.plain_masks(w, pts, torch.from_numpy(cts[2]), h, do_clip)
        for layer in range(6 if do_clip else 5):          # each layer has both signs
            assert 0 < int(((want >> layer) & 1).sum()) < o * n * h, layer
        flips = bench.mask_flips(torch.from_numpy(got), want, do_clip)
        assert not any(flips.values()), flips


def test_emulated_k2_rejects_bad_tiles(emu_lib):
    """The entry point refuses a tile that is not a whole number of chunks
    (at tensor-core widths and at a SIMT one), a multi-chunk tile where the
    tensor-core K2 reads its weights from L2 (h=128, h=64) and a width whose
    chunk cannot fit in shared memory."""
    lib = emu_lib
    buf = np.zeros(1, np.float32)
    args = [_ptr(buf)] * 6
    assert lib.ff_backward(*args, 1, 40, 32, 1, 48, None) != 0
    assert lib.ff_backward(*args, 1, 40, 128, 1, 64, None) != 0
    assert lib.ff_backward(*args, 1, 40, 64, 1, 48, None) != 0
    assert lib.ff_backward(*args, 1, 40, 64, 1, 64, None) != 0
    assert lib.ff_backward(*args, 1, 40, 24, 1, 48, None) != 0
    assert lib.ff_backward(*args, 1, 40, 9000, 1, 1, None) != 0


@pytest.mark.parametrize("h,chunk,max_tile", [
    (16, 32, 1 << 30),   # weights and accumulators on chip across the tile
    (32, 32, 1 << 30),
    (48, 32, 32),        # weights from L2: one chunk per tile
    (64, 32, 32),
    (96, 32, 32),
    (128, 32, 32),
    (8, 32, 1 << 30),    # the SIMT kernel: any whole number of chunks
    (24, 32, 1 << 30),
    (136, 32, 1 << 30),
    (320, 16, 1 << 30),  # a shorter chunk, so that it fits in shared memory
])
def test_emulated_tc_width_table(emu_lib, h, chunk, max_tile):
    """ff_tc_width, ff_bwd_chunk and ff_bwd_max_tile read the one width table:
    the tensor-core kernels at the widths built, the SIMT ones elsewhere."""
    assert emu_lib.ff_tc_width(h) == (h in EMU_TC_WIDTHS)
    assert emu_lib.ff_bwd_chunk(h) == chunk
    assert emu_lib.ff_bwd_max_tile(h) == max_tile


@pytest.mark.parametrize("h,chunk,max_tile,images", [
    (16, 64, 1 << 30, True),    # image and accumulators on chip across the tile
    (32, 64, 1 << 30, True),
    (48, 32, 1 << 30, True),    # on chip, a shorter chunk beside them
    (64, 64, 64, True),         # the weight ring: one chunk per tile
    (96, 64, 64, True),
    (128, 64, 64, True),
    (8, 32, 1 << 30, False),    # the SIMT kernel, as in f32
    (24, 32, 1 << 30, False),
    (136, 32, 1 << 30, False),
    (320, 16, 1 << 30, False),
])
def test_emulated_tc_width_table_bf16(emu_lib, emu_lib_bf16, h, chunk, max_tile, images):
    """The bf16 library's table: K2 bf16's chunk and largest tile at the
    tensor-core widths, and the scratch its weight images take after the
    slots (O x (5h + 272) x (h + 8) bf16, and 16 bytes of alignment); the
    SIMT kernel's elsewhere. And K1's launch (ff_fwd_launch) for 3 x 1000
    points on 4 emulated SMs: K1 bf16 with its image on chip (h = 16 to 48)
    sized for at least two resident blocks an SM of 256 threads (the stub's
    occupancy counts threads and shared memory), tiles of 64-point chunks,
    and 16 points of fixed cost a block for the image's conversion; through
    its ring (64 to 128) one block of 512 threads, 128-point chunks; tiles
    by fwd_tile over every resident block. The f32 K1 one block an SM; the
    SIMT kernel a chunk a block."""
    lib = emu_lib_bf16
    assert lib.ff_tc_width(h) == (h in EMU_TC_WIDTHS)
    assert lib.ff_bwd_chunk(h) == chunk
    assert lib.ff_bwd_max_tile(h) == max_tile
    want = 3 * ((5 * h + 272) * (h + 8) // 2) + 4 if images else 0
    assert lib.ff_bwd_scratch(3, h) == want
    assert emu_lib.ff_bwd_scratch(3, h) == 0

    def rule(o, n, slots, start, chunk):   # fused_field.cu's fwd_tile
        best = None
        for k in range(1, -(-n // chunk) + 1):
            blocks = o * -(-n // (chunk * k))
            cost = (-(-blocks // slots) * (chunk * k + start), blocks)
            best = best if best is not None and best[0] <= cost else (cost, chunk * k)
        return best[1]

    for lb, cd in ((lib, "bf16"), (emu_lib, "f32")):
        lb.emu_set_sm_count(4)
        plan = tff.fwd_launch(lb, 3, 1000, h)
        lb.emu_set_sm_count(132)
        if not images:   # the SIMT kernel: a chunk a block
            tp = 64 if h <= 64 else 32
            assert (plan["tile"], plan["blocks"]) == (tp, 3 * -(-1000 // tp)), (cd, plan)
            continue
        per, ring = plan["blocks_per_sm"], plan["ring"]
        assert ring == (cd == "bf16" and h >= 64), (cd, plan)
        assert plan["chunk"] == (128 if ring else 64), (cd, plan)
        threads = 4 * plan["chunk"]
        assert per == (min(2048 // threads, 232448 // plan["smem"]) if cd == "bf16" else 1)
        assert per >= (2 if cd == "bf16" and not ring else 1), plan
        start = 16 if cd == "bf16" and not ring else 0
        assert plan["tile"] == rule(3, 1000, 4 * per, start, plan["chunk"]), (cd, plan)
        assert plan["blocks"] == 3 * -(-1000 // plan["tile"]), (cd, plan)



def test_bf16_source_compiles_at_every_tensor_core_width(tmp_path):
    """csrc/fused_field_bf16.cu through the host compiler's semantic checks
    with every width the card builds (FF_TC_WIDTHS as the source has it:
    16 to 128), so that a static_assert of a width the emulation does not
    build (80, 112) fails here rather than in nvcc on the card."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to check the CUDA source")
    src = (CSRC / "fused_field.cu").read_text()
    widths = re.search(r"#define FF_TC_WIDTHS\(X\) (.*)", src).group(1)
    assert widths.split() == [f"X({h})" for h in range(16, 129, 16)]
    (tmp_path / "emu.cpp").write_text(_host_source("fused_field_bf16"))
    (tmp_path / "stub.h").write_text(STUB)
    proc = subprocess.run([cxx, "-std=c++20", "-fsyntax-only", "-pthread", "-Wno-unknown-pragmas",
                           "-include", str(tmp_path / "stub.h"), str(tmp_path / "emu.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]


# One warp through the stub's ldmatrix and bf16 mma.sync: C = A B from
# A [16][16] row-major with ldmatrix.x4 and B^T [8][16] with .x2 (the input
# gradients' pattern), from A^T [16][16] with .x4.trans and B [16][8] with
# .x2.trans (the weight gradients'), and from the same A^T and two n-tiles of
# B' [16][16] with .x4.trans; .x1 and .x1.trans of A's first 8 x 8 matrix,
# register by register.
STUB_CHECK = r"""
extern "C" int stub_check(const uint16_t* src, float* out, uint32_t* regs) {
  emu_launch(dim3(1), 32, 4096, nullptr, [&] {
    uint16_t* sh = reinterpret_cast<uint16_t*>(emu_smem());
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    for (int i = lane; i < 1024; i += 32) sh[i] = src[i];
    __syncthreads();
    const uint16_t *A = sh, *At = sh + 256, *Bt = sh + 512, *B = sh + 640, *B2 = sh + 768;
    const auto put = [&](int k, const float (&c)[4], int ldc, int n0) {
      out[k + g * ldc + n0 + 2 * t] = c[0];
      out[k + g * ldc + n0 + 2 * t + 1] = c[1];
      out[k + (g + 8) * ldc + n0 + 2 * t] = c[2];
      out[k + (g + 8) * ldc + n0 + 2 * t + 1] = c[3];
    };
    uint32_t a[4], b[2], b4[4], r1[1];
    ldsm_x4(a, A + ((lane & 7) + 8 * ((lane >> 3) & 1)) * 16 + 8 * (lane >> 4));
    ldsm_x2(b, Bt + (lane & 7) * 16 + 8 * ((lane >> 3) & 1));
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(c, a, b);
    put(0, c, 8, 0);
    ldsm_x4_t(a, At + ((lane & 7) + 8 * (lane >> 4)) * 16 + 8 * ((lane >> 3) & 1));
    ldsm_x2_t(b, B + ((lane & 7) + 8 * ((lane >> 3) & 1)) * 8);
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(d, a, b);
    put(128, d, 8, 0);
    ldsm_x4_t(b4, B2 + ((lane & 7) + 8 * ((lane >> 3) & 1)) * 16 + 8 * (lane >> 4));
    for (int j = 0; j < 2; ++j) {
      const uint32_t bj[2] = {b4[2 * j], b4[2 * j + 1]};
      float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(e, a, bj);
      put(256, e, 16, 8 * j);
    }
    ldsm_x1(r1, A + (lane & 7) * 16);
    regs[lane] = r1[0];
    ldsm_x1_t(r1, A + (lane & 7) * 16);
    regs[32 + lane] = r1[0];
  });
  return 0;
}
"""


def test_stub_ldmatrix_and_bf16_mma_match_numpy(tmp_path):
    """The stub's m16n8k16 bf16 mma.sync and ldmatrix (.x1, .x2, .x4, and
    .trans) against numpy on random bf16 tiles, as the PTX fragment layouts
    define them: C = A B in float64 within f32 rounding (the products are
    exact), and every .x1 register exactly."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to build the stub")
    (tmp_path / "stub.h").write_text(STUB)
    (tmp_path / "check.cpp").write_text(STUB_CHECK)
    so = tmp_path / "libcheck.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-include",
                    str(tmp_path / "stub.h"), "-o", str(so), str(tmp_path / "check.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.stub_check.argtypes = [ctypes.c_void_p] * 3
    rng = np.random.default_rng(5)
    bf = lambda shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    a, b, b2 = bf((16, 16)), bf((16, 8)), bf((16, 16))
    bits = lambda x: x.contiguous().view(torch.int16).numpy().astype(np.uint16).ravel()
    src = np.concatenate([bits(a), bits(a.T), bits(b.T), bits(b), bits(b2)])
    out = np.full(512, np.nan, np.float32)
    regs = np.zeros(64, np.uint32)
    lib.stub_check(_ptr(src), _ptr(out), _ptr(regs))
    a64, b64, b264 = (x.double().numpy() for x in (a, b, b2))
    np.testing.assert_allclose(out[:128].reshape(16, 8), a64 @ b64, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[128:256].reshape(16, 8), a64 @ b64, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[256:].reshape(16, 16), a64 @ b264, rtol=1e-5, atol=1e-5)
    ab = bits(a).reshape(16, 16).astype(np.uint32)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    assert np.array_equal(regs[:32], ab[g, 2 * t] | (ab[g, 2 * t + 1] << 16))
    assert np.array_equal(regs[32:], ab[2 * t, g] | (ab[2 * t + 1, g] << 16))

# One block through the stub's bulk copy and mbarrier as K1 bf16's weight
# ring uses them: a slab's rows from the 16-byte boundary at or below them,
# into one of two stages, each stage's mbarrier reused (its phase parity
# alternating), the rows read back past the skipped floats.
STUB_BULK = r"""
extern "C" int stub_bulk(const float* src, int n, const int* starts, int k, float* out) {
  emu_launch(dim3(1), 32, 4 * 2 * (n + 4) + 16, nullptr, [&] {
    float* stage = emu_smem();
    uint64_t* bar = reinterpret_cast<uint64_t*>(stage + 2 * (n + 4));
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_init(bar + 1, 1);
      mbar_init_fence();
    }
    __syncthreads();
    for (int j = 0; j < k; ++j) {
      const float* p = src + starts[j];
      const float* a = reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) & ~(uintptr_t)15);
      const int skip = (int)(p - a);
      const unsigned bytes = (unsigned)(4 * (skip + n) + 15) & ~15u;
      if (threadIdx.x == 0) {
        fence_proxy_async();
        mbar_arrive_expect_tx(bar + (j & 1), bytes);
        bulk_copy_g2s(stage + (j & 1) * (n + 4), a, bytes, bar + (j & 1));
      }
      mbar_wait(bar + (j & 1), (j >> 1) & 1);
      for (int i = threadIdx.x; i < n; i += 32) out[j * n + i] = stage[(j & 1) * (n + 4) + skip + i];
      __syncthreads();
    }
  });
  return 0;
}
"""


def test_stub_bulk_copy_and_mbarrier_match_numpy(tmp_path):
    """The stub's bulk copy (cp.async.bulk on an mbarrier) and mbarrier
    phases as K1 bf16's ring uses them: rows copied from the 16-byte boundary
    at or below them, at every misalignment of 0 to 3 floats, into two
    stages whose mbarriers are each waited on at parity 0, 1, 0: every row
    read back past its skipped floats equals numpy's slice of the source."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to build the stub")
    (tmp_path / "stub.h").write_text(STUB)
    (tmp_path / "check.cpp").write_text(STUB_BULK)
    so = tmp_path / "libbulk.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-include",
                    str(tmp_path / "stub.h"), "-o", str(so), str(tmp_path / "check.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.stub_bulk.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p]
    src = np.random.default_rng(7).standard_normal(4096).astype(np.float32)
    assert src.ctypes.data % 16 == 0
    n = 96
    starts = np.array([63, 300, 1001, 2046, 4, 513], np.int32)   # 3, 0, 1, 2, 0, 1 floats past
    out = np.full(len(starts) * n, np.nan, np.float32)
    lib.stub_bulk(_ptr(src), n, _ptr(starts), len(starts), _ptr(out))
    want = np.concatenate([src[s:s + n] for s in starts])
    assert np.array_equal(out, want)


@pytest.fixture(scope="module")
def emu_probes(tmp_path_factory):
    lib = _emulated(tmp_path_factory, "probes")
    lib.pr_part_dw.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pr_part_dw.restype = ctypes.c_int
    lib.pr_part_tg.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pr_part_tg.restype = ctypes.c_int
    lib.pr_part_quad.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pr_part_quad.restype = ctypes.c_int
    lib.pr_part_quad_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pr_part_quad_launch.restype = ctypes.c_int
    lib.pr_ens_gemm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.pr_ens_gemm.restype = ctypes.c_int
    lib.pr_ens_gemm_occupancy.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.pr_ens_gemm_occupancy.restype = ctypes.c_int
    lib.pr_step_chain.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.pr_step_chain.restype = ctypes.c_int
    lib.pr_step_chain_launch.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.pr_step_chain_launch.restype = ctypes.c_int
    lib.pr_launch_nop.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    lib.pr_launch_nop.restype = ctypes.c_int
    lib.emu_set_sm_count.argtypes = [ctypes.c_int]
    return lib


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
@pytest.mark.parametrize("s,o,n,dx,k,h,n_sm,cluster", [
    (2, 1, 70, 8, 87, 32, 1, 1),      # one object, one ragged tile (warp 4 partly, 5-7 idle)
    (3, 3, 129, 8, 87, 32, 1, 1),     # two tiles: 128 rows, then 1
    (1, 2, 600, 8, 87, 32, 1, 1),     # five tiles: each stage is refilled
    (1, 2, 5, 3, 20, 16, 132, 8),     # DX = 3 (4-byte copies), small widths; 8 ranks for
                                      # 5 rays: three ranks have no rows
    (1, 1, 64, 8, 87, 64, 2, 2),      # H = 64; two ranks of 32 rays
    (1, 1, 300, 8, 87, 32, 2, 4),     # four ranks of 75 rays, more ranks than tiles
])
def test_emulated_step_chain_matches_plain(emu_probes, depth, s, o, n, dx, k, h, n_sm, cluster):
    """step_chain_kernel against step_chain_plain, in clusters of 1, 2, 4
    and 8 blocks (the SM count and the stub's residency by shared memory
    decide; pr_step_chain_launch reports it)."""
    rng = np.random.default_rng(2)
    xs = (0.1 * rng.standard_normal((s, o, n, dx))).astype(np.float32)
    w0 = rng.standard_normal((o, dx, k)).astype(np.float32)
    w1 = rng.standard_normal((o, k, h)).astype(np.float32)
    w2 = (0.3 * rng.standard_normal((o, h, h))).astype(np.float32)
    out = np.full((s, o, 1, h), np.nan, np.float32)
    res = (ctypes.c_int * 6)()
    emu_probes.emu_set_sm_count(n_sm)
    try:
        assert emu_probes.pr_step_chain_launch(s, o, n, dx, k, h, depth, res) == 0
        err = emu_probes.pr_step_chain(_ptr(xs), _ptr(w0), _ptr(w1), _ptr(w2), _ptr(out),
                                       s, o, n, dx, k, h, depth, None)
    finally:
        emu_probes.emu_set_sm_count(132)
    assert err == 0
    assert res[4] == cluster and res[3] == s * o * cluster
    ref = probes.step_chain_plain(*(torch.from_numpy(a) for a in (xs, w0, w1, w2)), depth).numpy()
    assert float(np.abs(out - ref).max()) <= CHAIN_RTOL * float(np.abs(ref).max())


@pytest.mark.parametrize("s,o,n,dx,k,h,depth,cluster,blocks,smem", [
    (100, 64, 1200, 8, 87, 32, 4, 1, 6400, 60_920),   # q3: a block per pair
    (4, 16, 1200, 8, 87, 32, 0, 4, 256, 60_920),      # q4: 4 ranks of 300 rays (8 would
                                                      # not all be resident at 3 a SM)
    (4, 8, 1200, 8, 87, 32, 1, 8, 256, 60_920),       # 8 ranks of 150 rays
    (1, 1, 10, 16, 128, 64, 2, 8, 8, 182_552),        # the largest widths
])
def test_emulated_step_chain_launch_layout(emu_probes, s, o, n, dx, k, h, depth, cluster, blocks,
                                           smem):
    """pr_step_chain_launch reports the launch pr_step_chain makes on 132
    SMs: threads, dynamic shared memory, blocks and blocks per cluster (the
    largest cluster whose blocks are all resident at once)."""
    res = (ctypes.c_int * 6)()
    assert emu_probes.pr_step_chain_launch(s, o, n, dx, k, h, depth, res) == 0
    assert list(res)[1:5] == [256, smem, blocks, cluster]
    assert res[5] >= s * o or cluster == 1   # every pair's cluster resident at once


def test_emulated_step_chain_rejects_bad_arguments(emu_probes):
    """DX > 16, K > 128, H not a multiple of 4 or over 64, depth < 0 and
    depth 0 with H > K are refused."""
    buf = np.zeros(1, np.float32)
    for dx, k, h, depth in ((17, 8, 8, 1), (8, 129, 8, 1), (8, 8, 6, 1), (8, 87, 68, 1),
                            (8, 8, 8, -1), (8, 8, 12, 0)):
        assert emu_probes.pr_step_chain(*[_ptr(buf)] * 5, 1, 1, 4, dx, k, h, depth, None) != 0


def _at(n: int, ofs: int):
    """A NaN-filled float32 buffer and the view of n floats in it that starts
    ofs floats past a 16-byte boundary."""
    buf = np.full(n + 8, np.nan, np.float32)
    start = (-(buf.ctypes.data // 4)) % 4 + ofs
    return buf, buf[start:start + n]


@pytest.mark.parametrize("n,x_ofs,y_ofs", [
    (704, 0, 0),       # the probe's [8, 88]: 176 float4s, one block of 192 threads
    (704, 1, 1),       # aligned alike: 3 head floats, 175 float4s, 1 tail float
    (7, 3, 3),         # 1 head float, 1 float4, 2 tail floats
    (2, 1, 1),         # shorter than the head
    (705, 1, 2),       # not aligned alike: every float singly
    (100_003, 0, 0),   # 25 blocks of 256 threads, 4 float4s each
    (100_003, 2, 3),   # the same grid, singly
])
def test_emulated_launch_nop_is_a_copy(emu_probes, n, x_ofs, y_ofs):
    """launch_nop_kernel copies exactly, and writes nothing around y."""
    _, x = _at(n, x_ofs)
    x[:] = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    ybuf, y = _at(n, y_ofs)
    assert emu_probes.pr_launch_nop(_ptr(x), _ptr(y), n, None) == 0
    assert np.array_equal(x, y)
    assert np.isnan(ybuf).sum() == ybuf.size - n


@pytest.mark.parametrize("schedule", probes.SCHEDULES)
@pytest.mark.parametrize("sin", [False, True])
@pytest.mark.parametrize("o,n,k,h,obj_tile,n_blocks,n_sm", [
    (4, 200, 16, 8, 3, 1, 1),     # persistent: one block walks 16 items, the ring
                                  # wraps 4 times, crosses 3 object boundaries,
                                  # ragged last tiles; objtile: groups of 3 and 1
                                  # objects; one SM: 128-row tiles (128 + 72)
    (3, 100, 87, 32, 2, 1, 132),  # K = 87 (k >= K masked), every tile 16-byte
                                  # aligned; 64-row tiles
    (3, 130, 13, 48, 2, 2, 132),  # K = 13, H = 48: tiles of odd objects and the
                                  # 2-row tails are unaligned (cp.async), the rest
    (3, 130, 13, 48, 2, 2, 1),    # bulk copies; 64-row, then 128-row tiles
    (5, 64, 8, 16, 5, 2, 132),    # one tile per object: a new object at every item;
                                  # objtile: 5 objects on a ring of 2 stages (3 and
                                  # 2 per warp group)
    (2, 1, 4, 1, 1, 5, 132),      # one row; fewer items than blocks; H = 1 (odd:
                                  # scalar stores)
    (2, 40, 8, 7, 2, 3, 1),       # H = 7
    (2, 20, 128, 64, 2, 1, 132),  # the entry's largest K and H: objtile takes one
    (2, 20, 128, 64, 2, 1, 1),    # warp group, which walks both objects
])
def test_emulated_ens_gemm_persistent_matches_plain(emu_probes, schedule, sin, o, n, k, h,
                                                    obj_tile, n_blocks, n_sm):
    """Each schedule's kernel (the persistent one, and the tiled one on GRID's
    and OBJTILE's grids, with 64- or 128-row tiles as the SM count makes it
    choose) against the plain einsum."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((o, n, k)).astype(np.float32)
    w = (0.1 * rng.standard_normal((o, k, h))).astype(np.float32)
    out = np.full((o, n, h), np.nan, np.float32)
    emu_probes.emu_set_sm_count(n_sm)
    err = emu_probes.pr_ens_gemm(_ptr(x), _ptr(w), _ptr(out), o, n, k, h,
                                 probes.SCHEDULES.index(schedule), int(sin), obj_tile,
                                 n_blocks, None)
    emu_probes.emu_set_sm_count(132)
    assert err == 0
    ref = probes.ens_gemm_plain(torch.from_numpy(x), torch.from_numpy(w), sin).numpy()
    assert float(np.abs(out - ref).max()) <= GEMM_RTOL * float(np.abs(ref).max())


@pytest.mark.parametrize("schedule,o,k,h,obj_tile,threads,smem,blocks", [
    ("grid", 64, 88, 32, 8, 256, 78_864, 10 * 64),       # 128-row tiles: 5 per SM
                                                          # against 10 of 64 rows
    ("objtile", 64, 88, 32, 8, 512, 157_728, 10 * 8),    # two groups of 8 warps
    ("objtile", 64, 88, 32, 1, 256, 78_864, 10 * 64),    # one object per block: GRID's
    ("objtile", 64, 128, 64, 8, 256, 163_856, 10 * 8),   # two groups would not fit
    ("grid", 16, 87, 32, 16, 128, 55_952, 19 * 16),      # q1: 64-row tiles (3 per SM
                                                          # against 2 of 128 rows)
    ("objtile", 16, 87, 32, 16, 256, 111_904, 19),       # q1: 64-row tiles
    ("persistent", 64, 88, 32, 8, 256, 123_944, 132),
])
def test_emulated_ens_gemm_launch_layout(emu_probes, schedule, o, k, h, obj_tile, threads, smem,
                                         blocks):
    """pr_ens_gemm_occupancy reports the launch pr_ens_gemm makes on 132 SMs
    at N = 1200: threads per block, dynamic shared memory and blocks."""
    res = (ctypes.c_int * 4)()
    assert emu_probes.pr_ens_gemm_occupancy(o, 1200, k, h, probes.SCHEDULES.index(schedule), 0,
                                            obj_tile, 132, res) == 0
    assert list(res)[1:] == [threads, smem, blocks]


def test_emulated_ens_gemm_rejects_bad_arguments(emu_probes):
    """K > 128, H > 64, obj_tile < 1 and an unknown schedule are refused."""
    buf = np.zeros(1, np.float32)
    for o, k, h, schedule, ot in ((1, 129, 8, 0, 1), (1, 8, 65, 1, 1), (1, 8, 8, 1, 0),
                                  (1, 8, 8, 3, 1)):
        assert emu_probes.pr_ens_gemm(_ptr(buf), _ptr(buf), _ptr(buf), o, 1, k, h, schedule, 0,
                                      ot, 1, None) != 0


@pytest.mark.parametrize("o,r,hp,c", [
    (2, 120, 33, 512),   # the probe's widths: 8 column slices, 5 tiles of Hp
    (2, 37, 48, 100),    # ragged slice (16-byte copies), R not a multiple of 8
    (2, 7, 64, 70),      # Hp = 64, C % 4 != 0 (4-byte copies)
    (2, 33, 1, 3),
    (1, 300, 17, 130),   # three chunks of rays
])
def test_emulated_part_dw_matches_plain(emu_probes, o, r, hp, c):
    rng = np.random.default_rng(3)
    dt = (0.1 * rng.standard_normal((o, r, hp))).astype(np.float32)
    gt = (0.1 * rng.standard_normal((o, r, c))).astype(np.float32)
    out = np.full((o, hp, c), np.nan, np.float32)
    assert emu_probes.pr_part_dw(_ptr(dt), _ptr(gt), _ptr(out), o, r, hp, c, None) == 0
    ref = probes.part_dw_plain(torch.from_numpy(dt), torch.from_numpy(gt)).numpy()
    assert float(np.abs(out - ref).max()) <= GEMM_RTOL * float(np.abs(ref).max())


@pytest.mark.parametrize("o,r,hp,c", [
    (2, 120, 33, 512),   # the probe's widths: three gt tiles (48, 48, 24 rows) and
                         # the Gram tile, 4 chunks through the 2 stages
    (1, 45, 33, 100),    # a ragged row tile, a ragged chunk (bulk copies)
    (2, 7, 64, 70),      # Hp = 64: two Gram tiles; C % 4 != 0 (4-byte copies)
    (2, 33, 1, 3),
    (1, 300, 17, 130),   # seven row tiles, 2 chunks (128, then 2 columns)
])
def test_emulated_part_tg_matches_plain(emu_probes, o, r, hp, c):
    """part_tg_kernel against part_tg_plain: t from the gt tiles, g from the
    Gram tile; every element of both written."""
    rng = np.random.default_rng(6)
    gt = (0.1 * rng.standard_normal((o, r, c))).astype(np.float32)
    wb = (0.1 * rng.standard_normal((o, hp, c))).astype(np.float32)
    t = np.full((o, r, hp), np.nan, np.float32)
    g = np.full((o, hp, hp), np.nan, np.float32)
    assert emu_probes.pr_part_tg(_ptr(gt), _ptr(wb), _ptr(t), _ptr(g), o, r, hp, c, None) == 0
    t_ref, g_ref = (x.numpy() for x in probes.part_tg_plain(torch.from_numpy(gt),
                                                             torch.from_numpy(wb)))
    assert float(np.abs(t - t_ref).max()) <= GEMM_RTOL * float(np.abs(t_ref).max())
    assert float(np.abs(g - g_ref).max()) <= GEMM_RTOL * float(np.abs(g_ref).max())


def test_emulated_part_tg_rejects_bad_arguments(emu_probes):
    """Hp outside 1..64 is refused."""
    buf = np.zeros(1, np.float32)
    for hp in (0, 65):
        assert emu_probes.pr_part_tg(*[_ptr(buf)] * 4, 1, 1, hp, 1, None) != 0


@pytest.mark.parametrize("o,r,hp,c", [
    (2, 120, 33, 512),   # the probe's widths: a 256-column slice (two chunks) and 60 rows
                         # per rank
    (1, 45, 33, 100),    # ragged slices (56, 44 columns) and rows (23, 22)
    (2, 7, 64, 70),      # Hp = 64; C % 4 != 0 (4-byte copies); rows 4, 3
    (2, 3, 1, 3),        # a rank with no columns
    (1, 1, 5, 3),        # R < QD_CL: a rank with no rows and no columns
    (1, 300, 17, 2100),  # 1056-column slices, nine chunks through the two stages; 150
                         # rows per rank, staged as 64, 64 and 22
])
def test_emulated_part_quad_matches_plain(emu_probes, o, r, hp, c):
    """part_quad_kernel against part_quad_plain: the cluster's ranks sum their
    Gram partials over distributed shared memory; every element of z written."""
    rng = np.random.default_rng(7)
    h = (0.1 * rng.standard_normal((o, r, hp))).astype(np.float32)
    wb = (0.1 * rng.standard_normal((o, hp, c))).astype(np.float32)
    z = np.full((o, r, hp), np.nan, np.float32)
    assert emu_probes.pr_part_quad(_ptr(h), _ptr(wb), _ptr(z), o, r, hp, c, None) == 0
    ref = probes.part_quad_plain(torch.from_numpy(h), torch.from_numpy(wb)).numpy()
    assert float(np.abs(z - ref).max()) <= GEMM_RTOL * float(np.abs(ref).max())


@pytest.mark.parametrize("o,r,hp,c,smem", [
    (64, 120, 33, 512, 75_192),     # q5: two stages of 48 rows, partials inside them
    (1, 300, 17, 2100, 43_576),     # two stages of 32 rows; 64 hp rows staged
    (2, 7, 64, 70, 138_520),        # the widest: the partials [8][20][32] float4 beyond
                                    # the one stage
])
def test_emulated_part_quad_launch_layout(emu_probes, o, r, hp, c, smem):
    """pr_part_quad_launch reports the launch pr_part_quad makes: 256 threads,
    the dynamic shared memory, a cluster of 2 blocks per object."""
    res = (ctypes.c_int * 6)()
    assert emu_probes.pr_part_quad_launch(o, r, hp, c, res) == 0
    assert list(res)[1:5] == [256, smem, 2 * o, 2]


def test_emulated_part_quad_rejects_bad_arguments(emu_probes):
    """Hp outside 1..64 is refused."""
    buf = np.zeros(1, np.float32)
    for hp in (0, 65):
        assert emu_probes.pr_part_quad(*[_ptr(buf)] * 3, 1, 1, hp, 1, None) != 0


def test_k1_phases_stamps_every_barrier(tmp_path, monkeypatch):
    """openobj_torch.scripts.k1_phases builds a copy of the source, beside
    copies of what it includes, in which every barrier books its cycles,
    with the stamps ahead of the kernels."""
    from openobj_torch import kernels
    from openobj_torch.scripts import k1_phases

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    src = CSRC / "fused_field.cu"
    out = k1_phases.stamped_source(src)
    text = out.read_text()
    assert text.count("stamped_syncthreads();") == src.read_text().count("__syncthreads();")
    assert text.count("__syncthreads();") == 1          # the barrier inside the stamp
    assert text.index("void stamped_syncthreads(") < text.index("namespace {")
    assert kernels.lib_path(out).name.startswith("libfused_field-")   # its includes are there


def test_k2_bf16_phases_names_every_barrier(tmp_path, monkeypatch):
    """openobj_torch.scripts.k1_phases in its K2 bf16 mode stamps every
    barrier of K2 bf16 (its weight ring's too) and none of fused_field.cu's
    kernels, and its span names are the barriers a block passes, in number:
    the stamped copy, emulated with a stamp that counts block (0, 0)'s
    barriers, at h=128 (the ring, one chunk a tile, the clip head on and
    off) and h=32 (on chip, a tile of two chunks)."""
    from openobj_torch import kernels
    from openobj_torch.scripts import k1_phases as kp

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    src = kp.stamped_source(CSRC / "fused_field_bf16.cu", kp.K2_BF16_STAMPED)
    hdr = (src.parent / "fused_field_bwd_bf16.cuh").read_text()
    assert "__syncthreads();" not in hdr
    assert hdr.count("stamped_syncthreads();") == (
        CSRC / "fused_field_bwd_bf16.cuh").read_text().count("__syncthreads();")
    assert (src.parent / "fused_field.cu").read_text() == (CSRC / "fused_field.cu").read_text()
    counting = ("#include <atomic>\ninline std::atomic<int> g_bars{0};\n"
                "inline void stamped_syncthreads() {\n  __syncthreads();\n"
                "  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) ++g_bars;\n}\n"
                'extern "C" int emu_bars() { int n = g_bars; g_bars = 0; return n; }\n')
    src.write_text(counting + (kernels.CSRC / "fused_field_bf16.cu").read_text())
    lib = _emulated_bf16_copy(src, tmp_path)
    for o, n, h, do_clip, chunks in ((1, 64, 128, True, 1), (1, 64, 128, False, 1),
                                     (1, 100, 32, True, 2)):
        w, pts = _field(np.random.default_rng(0), o, n, h, do_clip)
        cts = [np.ones((o, n, k), np.float32) for k in (1, 3, h)]
        tile = chunks * lib.ff_bwd_chunk(h)
        buf = np.zeros(o * -(-n // tile) * w.shape[1] + lib.ff_bwd_scratch(o, h), np.float32)
        err = lib.ff_backward(_ptr(pts.numpy()), _ptr(w.numpy()), *(_ptr(c) for c in cts),
                              _ptr(buf), o, n, h, int(do_clip), tile, None)
        assert err == 0
        ring = lib.ff_bwd_max_tile(h) < (1 << 30)
        assert ring == (h == 128)
        assert lib.emu_bars() == chunks * len(kp.span_names(h, ring, do_clip))


def test_k1_bf16_phases_names_every_barrier(tmp_path, monkeypatch):
    """openobj_torch.scripts.k1_phases in its K1 bf16 mode stamps every
    barrier of K1 bf16 (its weight ring's too) and none of fused_field.cu's
    or K2 bf16's, and its span names are the barriers a block passes, in
    number, after the one before its first chunk: the stamped copy,
    emulated with a stamp that counts block (0, 0)'s barriers, at h=128
    (the ring, the clip head on and off, tiles of one and two 128-point
    chunks) and h=32 (the image on chip, a tile of three chunks)."""
    from openobj_torch import kernels
    from openobj_torch.scripts import k1_phases as kp

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    src = kp.stamped_source(CSRC / "fused_field_bf16.cu", kp.K1_BF16_STAMPED)
    hdr = (src.parent / kp.K1_BF16_STAMPED).read_text()
    assert "__syncthreads();" not in hdr
    assert hdr.count("stamped_syncthreads();") == (
        CSRC / kp.K1_BF16_STAMPED).read_text().count("__syncthreads();")
    for other in ("fused_field.cu", kp.K2_BF16_STAMPED):
        assert (src.parent / other).read_text() == (CSRC / other).read_text()
    counting = ("#include <atomic>\ninline std::atomic<int> g_bars{0};\n"
                "inline void stamped_syncthreads() {\n  __syncthreads();\n"
                "  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) ++g_bars;\n}\n"
                'extern "C" int emu_bars() { int n = g_bars; g_bars = 0; return n; }\n')
    src.write_text(counting + (kernels.CSRC / "fused_field_bf16.cu").read_text())
    lib = _emulated_bf16_copy(src, tmp_path)
    lib.emu_set_sm_count(1)
    for o, n, h, do_clip in ((1, 64, 128, True), (1, 64, 128, False), (1, 200, 128, True),
                             (1, 300, 32, True)):
        w, pts = _field(np.random.default_rng(0), o, n, h, do_clip)
        outs = [np.zeros((o, n, k), np.float32) for k in (1, 3, h)]
        plan = tff.fwd_launch(lib, o, n, h)
        err = lib.ff_forward(_ptr(pts.numpy()), _ptr(w.numpy()), *(_ptr(x) for x in outs),
                             o, n, h, int(do_clip), None)
        assert err == 0
        assert plan["ring"] == (h == 128)
        chunks = -(-min(plan["tile"], n) // plan["chunk"])
        assert chunks == (2 if n == 200 else 3 if n == 300 else 1)
        names = kp.k1_bf16_span_names(h, plan["ring"], do_clip)
        assert lib.emu_bars() == 1 + chunks * len(names)   # and one before the first chunk
    lib.emu_set_sm_count(132)


def test_sass_diff_compares_kernels_by_instruction():
    """openobj_torch.scripts.sass_diff reads cuobjdump's listing per kernel,
    without addresses, encodings or the namespace hash, and names the
    kernels that differ or that one side lacks."""
    from openobj_torch.scripts import sass_diff

    def listing(ns, ops):
        out = "\n\tcode for sm_90a\n"
        for name, body in ops.items():
            out += f"\t\tFunction : _ZN{ns}{name}Ev\n\t.headerflags @\"EF_CUDA_SM90\"\n"
            out += "".join(f"        /*{16 * i:04x}*/   {op} ;   /* 0x{i:016x} */\n"
                           for i, op in enumerate(body))
        return out

    a = sass_diff.functions(listing("_GLOBAL__N__1a2b_", {"k1": ["LDC R1, c[0x0][0x28]", "EXIT"],
                                                           "k2": ["FFMA R0, R1, R2, R0", "EXIT"]}))
    b = sass_diff.functions(listing("_GLOBAL__N__9f8e_", {"k1": ["LDC  R1,  c[0x0][0x28]", "EXIT"],
                                                           "k2": ["FADD R0, R1, R2", "EXIT"],
                                                           "k3": ["EXIT"]}))
    assert a["_ZNNS_k1Ev"] == ["LDC R1, c[0x0][0x28] ;", "EXIT ;"]
    assert sass_diff.compare(a, b) == (1, ["_ZNNS_k2Ev", "_ZNNS_k3Ev"])
    assert sass_diff.compare(a, a) == (2, [])


def test_ens_gemm_parts_edits_the_persistent_kernel(tmp_path, monkeypatch):
    """openobj_torch.scripts.ens_gemm_parts builds copies of probes.cu
    without the persistent and tiled kernels' products, without their bulk
    copies, without those and two of their three mma.sync, and without the
    bulk copies and the weight splits."""
    from openobj_torch import kernels
    from openobj_torch.scripts import ens_gemm_parts

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    srcs = ens_gemm_parts.part_sources()
    whole = srcs["whole"].read_text()
    copies, product = srcs["copies"].read_text(), srcs["product"].read_text()
    assert srcs["whole"] == CSRC / "probes.cu"
    for unroll in (4, 2):   # the persistent kernel's k-loop unroll, then the tiled one's
        item = f"gemm_item<SIN, PAIR, NB, SIN ? 1 : {unroll}>(g"
        assert whole.count(item) == 1 and product.count(item) == 1
        assert item not in copies
    for kernel in ("ens_gemm_persistent_kernel(GemmArgs g)", "ens_gemm_tiled_kernel(GemmArgs g)"):
        assert kernel in copies
        body = copies[copies.index(kernel):]
        body = body[:body.index("\n}\n")]
        assert "start_" in body and "mbar_wait(" in body and "split_weights(g" in body
    assert whole.count("bulk_copy_g2s(dst, src, bytes, bar);") == 1
    assert "bulk_copy_g2s(dst, src, bytes, bar);" not in product
    one = srcs["product_1mma"].read_text()
    assert one.count("mma_tf32(") == product.count("mma_tf32(") - 2   # two of mma_step's
    assert "bulk_copy_g2s(dst, src, bytes, bar);" not in one
    nosplit = srcs["product_nosplit"].read_text()
    assert whole.count("split_weights(g") == 2 and nosplit.count("split_weights(g") == 2
    body = nosplit[nosplit.index("void split_weights("):]
    assert body[body.index("{"):].startswith("{\n  return;\n")   # returns before any split
    assert "bulk_copy_g2s(dst, src, bytes, bar);" not in nosplit
    assert all(p.parent == tmp_path / "parts" for k, p in srcs.items() if k != "whole")


def test_step_chain_parts_edits_the_chain(tmp_path, monkeypatch):
    """openobj_torch.scripts.step_chain_parts builds copies of probes.cu
    whose chain kernel has no mma_step (noproduct) or no sinf (nosine), and
    leaves the ensemble GEMM's products and sines as they are."""
    from openobj_torch import kernels
    from openobj_torch.scripts import step_chain_parts

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    srcs = step_chain_parts.part_sources(parts=step_chain_parts.PARTS)
    assert srcs["whole"] == CSRC / "probes.cu" and set(srcs) == {"whole", "noproduct", "nosine"}
    whole = srcs["whole"].read_text()

    def chain(text):   # chain_rows, where the edits fall
        body = text[text.index("__device__ inline void chain_rows("):]
        return body[:body.index("\n}\n")]

    noproduct, nosine = srcs["noproduct"].read_text(), srcs["nosine"].read_text()
    assert chain(whole).count("mma_step<") == 2 and "mma_step<" not in chain(noproduct)
    assert chain(whole).count("sinf(") == 4 and "sinf(" not in chain(nosine)
    assert chain(nosine).count("mma_step<false, NB>") == 2
    for text in (noproduct, nosine):   # the rest of the source is untouched
        assert text.replace(chain(text), "") == whole.replace(chain(whole), "")


def test_part_quad_parts_edits_the_kernel(tmp_path, monkeypatch):
    """openobj_torch.scripts.part_quad_parts builds copies of probes.cu whose
    quad kernel runs no k-steps and no z (copies), sums its own partial with
    no cluster barrier or peer read (no_exchange), runs no z (no_z), also
    copies nothing (empty), or takes clusters of 2 or 8 blocks; each edit
    falls in the quad kernel's code and leaves the other kernels as they are."""
    from openobj_torch import kernels
    from openobj_torch.scripts import part_quad_parts

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    srcs = part_quad_parts.part_sources(parts=part_quad_parts.PARTS)
    assert srcs["whole"] == CSRC / "probes.cu" and set(srcs) == {"whole", *part_quad_parts.PARTS}
    text = {k: p.read_text() for k, p in srcs.items()}

    def quad(t):   # the quad kernel and its helpers, where the edits fall
        return t[t.index("struct QuadSmem {"):t.index("using QuadKernel")]

    def rest(t):   # the source without them and without the block and cluster sizes
        return re.sub(r"constexpr int QD_(CL = \d|NT = \d+);", "", t.replace(quad(t), ""))

    whole = quad(text["whole"])
    for part in part_quad_parts.PARTS:
        assert rest(text[part]) == rest(text["whole"]), part
        assert (quad(text[part]) == whole) == part.startswith(("cl", "nt")), part
    assert whole.count("cluster_wait();") == 2 and whole.count("bulk_copy_s2peer(") == 1
    assert "&& C < 0" not in whole
    assert quad(text["copies"]).count("&& C < 0") == 2
    assert quad(text["no_z"]).count("&& C < 0") == 1
    for part in ("copies", "no_z", "empty"):
        assert "zo[" not in quad(text[part]), part
    assert "8 * ks < cw && C < 0" in quad(text["empty"])
    assert "bulk_copy_g2s(" not in quad(text["empty"]) and "cp_async4(hs" not in quad(text["empty"])
    ex = quad(text["no_exchange"])
    assert "cluster_" not in ex and "bulk_copy_s2peer(" not in ex and "gx" not in ex.split("g = ")[-1]
    for n in (1, 4):
        assert f"constexpr int QD_CL = {n};" in text[f"cl{n}"]
    assert "constexpr int QD_NT = 128;" in text["nt128"] and "QD_CL = 4;" in text["cl4_nt128"]

"""The host compiler's build of the CUDA sources in openobj_torch/csrc/, for
the emulation tests (tests/test_torch_kernel_emulation*.py).

Each source is compiled by the host C++ compiler with ``STUB`` (below)
included ahead of it: the stub stands in for the CUDA built-ins and the
inline-PTX helpers that the source builds only under nvcc, runs each
cluster's threads as fibers on the launching thread, and emulates
``mma.sync`` from its documented fragment layout. It says nothing of speed
or of the card's own rounding: tests/test_torch_kernels.py and
tests/test_torch_probe_kernels.py hold the real kernels to the same plain
versions on a GPU.
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

CSRC = Path(__file__).resolve().parents[1] / "openobj_torch" / "csrc"
FWD_ATOL = 1e-4      # as tests/test_torch_kernels.py
GRAD_RTOL = 1e-3
GEMM_RTOL = 1e-5     # as tests/test_torch_probe_kernels.py
CHAIN_RTOL = 1e-4    # as tests/test_torch_probe_kernels.py
# the tensor-core widths the emulated fused_field.cu is built with
EMU_TC_WIDTHS = (16, 32, 48, 64, 96, 128)
# the host compiler's flags for an emulated source
CXX_FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas")

# What the CUDA source needs from the CUDA runtime and from its inline-PTX
# helpers, for a host C++20 compiler:
STUB = r"""
//  * each thread of the running cluster (one block, or the blocks of a
//    thread-block cluster) is a fiber, a user-level thread with a stack of
//    its own, on the thread that launched the kernel; the fibers run in
//    turn, each until it waits (at a barrier, a warp exchange, an
//    mbarrier), which passes to the next. Every thread waiting while no
//    thread moves is a deadlock, which aborts. __syncthreads is a barrier
//    of the block's threads, and each named barrier (bar.sync id, n) a
//    barrier of n made at its first use in a block;
//  * the blocks of a thread-block cluster (cudaLaunchKernelEx with a cluster
//    dimension) run their threads together, and a cluster's blocks are
//    consecutive in x; barrier.cluster is a barrier over all of the
//    cluster's threads (its arrive and wait, apart, the barrier's), ld_cluster
//    (mapa + ld.shared::cluster) reads and a bulk copy to a peer
//    (cp.async.bulk.shared::cluster) writes the same offset in the peer
//    block's shared buffer;
//  * mma.sync m16n8k8 (tf32 operands, f32 accumulator) and __shfl_sync are
//    warp-wide exchanges through a barrier of 32 threads, mma computed
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
//  * __syncwarp is the warp's barrier;
//  * cvt.rna.tf32.f32 rounds to 10 mantissa bits, ties away from zero, and
//    cvt.rn.bf16x2.f32 to 7, ties to even (finite values);
//  * dynamic shared memory is filled with NaN before each block, so that a
//    read of memory the kernel never wrote shows in its outputs;
//  * the device has emu_set_sm_count(n) SMs (132 unless set), so that a test
//    can make K1's tile rule give tiles of several chunks at small sizes;
//  * an mbarrier is 8 bytes of the kernel's shared memory (its transaction
//    count, pending arrivals, expected arrivals and phase bit); a phase
//    completes when no arrival and no byte is pending, and try_wait.parity
//    blocks the waiting thread until the phase of that parity has
//    completed. A bulk copy is a memcpy, made while a
//    thread waits on its mbarrier (so a read that does not wait sees the
//    old contents), that then completes its bytes; cp.async is a plain
//    copy, so the arrival that waits for a thread's cp.asyncs is made at
//    once.
// It checks indexing, layouts and synchronisation, not the card's rounding
// (the tensor cores truncate where this rounds) and not speed.
#include <sys/mman.h>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <functional>
#include <memory>
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
inline uint3 threadIdx, blockIdx;   // the running fiber's, set as it is switched to
inline dim3 gridDim, blockDim;

// The fiber switch: save the callee-saved registers on the running stack,
// store its pointer in *save, load `to` and pop the other fiber's registers.
#if defined(__x86_64__)
extern "C" void emu_switch(void** save, void* to);
asm(".text\n.p2align 4\n.hidden emu_switch\n.globl emu_switch\n"
    ".type emu_switch,@function\nemu_switch:\n"
    "  pushq %rbp\n  pushq %rbx\n  pushq %r12\n  pushq %r13\n  pushq %r14\n  pushq %r15\n"
    "  movq %rsp, (%rdi)\n  movq %rsi, %rsp\n"
    "  popq %r15\n  popq %r14\n  popq %r13\n  popq %r12\n  popq %rbx\n  popq %rbp\n"
    "  ret\n.size emu_switch, .-emu_switch\n");
#else
#error "the emulation's fiber switch is written for x86-64"
#endif

struct EmuBlock;
struct EmuCluster;
struct EmuFiber {   // one emulated thread
  void* sp = nullptr;       // its stack pointer while switched out
  uint3 tid{}, bid{};
  EmuBlock* blk = nullptr;
  bool done = false;
  unsigned cluster_token = 0;
};
inline EmuFiber* g_cur = nullptr;
inline void* g_sched_sp = nullptr;
inline const std::function<void()>* g_body = nullptr;
inline unsigned long g_progress = 0;   // arrivals, waits passed, copies landed, exits
inline void emu_yield() { emu_switch(&g_cur->sp, g_sched_sp); }
[[noreturn]] inline void emu_fiber_main() {
  (*g_body)();
  g_cur->done = true;
  ++g_progress;
  emu_switch(&g_cur->sp, g_sched_sp);
  __builtin_unreachable();
}
// stacks, a guard page below each, kept from launch to launch
constexpr size_t kEmuStack = 512 << 10;
inline std::vector<char*> g_stacks;
inline void emu_start(EmuFiber& f, size_t i) {
  while (g_stacks.size() <= i) {
    char* p = static_cast<char*>(mmap(nullptr, kEmuStack + 4096, PROT_READ | PROT_WRITE,
                                      MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0));
    if (p == MAP_FAILED || mprotect(p, 4096, PROT_NONE)) abort();
    g_stacks.push_back(p + 4096);
  }
  void** sp = reinterpret_cast<void**>(g_stacks[i] + kEmuStack);   // 16-byte aligned
  *--sp = nullptr;                                  // emu_fiber_main's return address
  *--sp = reinterpret_cast<void*>(&emu_fiber_main); // where emu_switch first returns
  for (int r = 0; r < 6; ++r) *--sp = nullptr;      // rbp, rbx, r12 - r15
  f.sp = sp;
}

struct EmuBarrier {   // a barrier of n of the running fibers
  int n, arrived = 0;
  unsigned phase = 0;
  explicit EmuBarrier(int count) : n(count) {}
  unsigned arrive() {
    ++g_progress;
    const unsigned p = phase;
    if (++arrived == n) {
      arrived = 0;
      ++phase;
    }
    return p;
  }
  void wait(unsigned p) {
    while (phase == p) emu_yield();
    ++g_progress;
  }
  void arrive_and_wait() { wait(arrive()); }
};
struct WarpRegs { uint32_t a[32][4], b[32][2]; float f[32]; const uint16_t* p[32]; };
struct EmuBlock {   // one running block: its shared memory, barriers and warp exchanges
  float* smem = nullptr;
  EmuBarrier* bar = nullptr;
  EmuBarrier* warp_bar[32] = {};
  WarpRegs wr[32];
  EmuBarrier* named_bar[16] = {};
  ~EmuBlock() {
    delete bar;
    for (auto* b : warp_bar) delete b;
    for (auto* b : named_bar) delete b;
  }
};
struct EmuCluster { EmuBarrier* bar; std::vector<EmuBlock*> blocks; };
inline EmuBlock* t_blk;     // the running fiber's block, and its cluster
inline EmuCluster* t_clu;
inline float* emu_smem() { return t_blk->smem; }
inline void __syncthreads() { t_blk->bar->arrive_and_wait(); }
inline void named_sync(int id, int n) {
  if (!t_blk->named_bar[id]) t_blk->named_bar[id] = new EmuBarrier(n);
  t_blk->named_bar[id]->arrive_and_wait();
}
inline void cluster_sync() { t_clu->bar->arrive_and_wait(); }
inline void cluster_arrive_relaxed() { g_cur->cluster_token = t_clu->bar->arrive(); }
inline void cluster_wait() { t_clu->bar->wait(g_cur->cluster_token); }
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
struct EmuCopy { uint64_t* bar; void* dst; const void* src; unsigned bytes; };
inline std::vector<EmuCopy> g_copies;   // bulk copies started, not landed yet
inline EmuBar& emu_bar(uint64_t* bar) { return *reinterpret_cast<EmuBar*>(bar); }
inline void emu_bar_update(uint64_t* bar, int arrivals, int64_t tx) {
  ++g_progress;
  EmuBar& m = emu_bar(bar);
  m.pending -= arrivals;
  m.tx += (int32_t)tx;
  if (m.pending == 0 && m.tx == 0) {   // the phase completes
    m.expected_phase ^= 0x8000;
    m.pending = m.expected_phase & 0x7fff;
  }
}
inline void mbar_init(uint64_t* bar, unsigned count) {
  emu_bar(bar) = {0, (uint16_t)count, (uint16_t)count};
}
inline void mbar_init_fence() {}
inline void mbar_arrive(uint64_t* bar) {
  emu_bar_update(bar, 1, 0);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  emu_bar_update(bar, 1, bytes);
}
// A bulk copy lands when a thread waits on its mbarrier, no earlier (a copy
// from a peer block while the thread waits): a read of the stage that does
// not wait for it sees the old contents.
inline void bulk_copy_g2s(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  ++g_progress;
  g_copies.push_back({bar, dst, src, bytes});
}
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  for (;;) {
    for (size_t i = 0; i < g_copies.size();) {
      const EmuCopy c = g_copies[i];
      if (c.bar != bar) { ++i; continue; }
      g_copies.erase(g_copies.begin() + i);
      std::memcpy(c.dst, c.src, c.bytes);
      emu_bar_update(bar, 0, -(int64_t)c.bytes);
    }
    if ((unsigned)(emu_bar(bar).expected_phase >> 15) != parity) break;
    emu_yield();
  }
  ++g_progress;
}
inline void cp_async_mbar_arrive(uint64_t* bar) { mbar_arrive(bar); }
inline void bulk_copy_s2peer(float* p, unsigned bytes, uint64_t* bar, unsigned rank) {
  float* peer = t_clu->blocks[rank]->smem;
  bulk_copy_g2s(peer + (p - t_blk->smem), p, bytes,
                reinterpret_cast<uint64_t*>(peer + (reinterpret_cast<float*>(bar) - t_blk->smem)));
}
inline void fence_proxy_async() {}

// Run the fibers in turn, each until it waits or ends, until all have
// ended; abort where a whole turn of them moves nothing (a deadlock).
inline void emu_run(std::vector<EmuFiber>& fibers, const std::function<void()>& body) {
  g_body = &body;
  size_t live = fibers.size();
  while (live) {
    const unsigned long before = g_progress;
    for (EmuFiber& f : fibers) {
      if (f.done) continue;
      g_cur = &f;
      threadIdx = f.tid;
      blockIdx = f.bid;
      t_blk = f.blk;
      emu_switch(&g_sched_sp, f.sp);
      live -= f.done;
    }
    if (live && g_progress == before) {
      std::fprintf(stderr, "emulation: every thread of the cluster waits (a deadlock)\n");
      std::abort();
    }
  }
  g_cur = nullptr;
}

// Blocks in clusters of nc (consecutive in x), one cluster at a time, each
// block's shared memory NaN-filled: catches reads of unset memory.
template <class F>
void emu_launch_cluster(dim3 grid, int nt, size_t smem, unsigned nc, F fn) {
  if (smem > g_smem_max) g_smem_max = smem;
  gridDim = grid; blockDim = dim3(nt);
  const std::function<void()> body = fn;
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x0 = 0; x0 < grid.x; x0 += nc) {
      std::vector<std::vector<float>> mem(nc, std::vector<float>(smem / 4 + 16, std::nanf("")));
      std::vector<std::unique_ptr<EmuBlock>> blocks;
      EmuBarrier cb(nc * nt);
      EmuCluster clu{&cb, {}};
      for (unsigned r = 0; r < nc; ++r) {
        blocks.push_back(std::make_unique<EmuBlock>());
        EmuBlock* b = blocks.back().get();
        b->smem = mem[r].data();
        b->bar = new EmuBarrier(nt);
        for (int w = 0; w < nt / 32; ++w) b->warp_bar[w] = new EmuBarrier(32);
        clu.blocks.push_back(b);
      }
      std::vector<EmuFiber> fibers(nc * nt);
      for (unsigned r = 0; r < nc; ++r)
        for (int i = 0; i < nt; ++i) {
          EmuFiber& f = fibers[r * nt + i];
          f.tid = {(unsigned)i, 0, 0};
          f.bid = {x0 + r, y, 0};
          f.blk = clu.blocks[r];
          emu_start(f, r * nt + i);
        }
      t_clu = &clu;
      emu_run(fibers, body);
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


def host_source(name: str, root: Path = CSRC) -> str:
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


def host_cxx() -> str:
    """The host C++20 compiler; the test skips where there is none."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the CUDA source")
    return cxx


def compile_start(text: str, out: Path, defines=()):
    """Start the host compiler on ``text`` with the stub included ahead of
    it, into out/libemu.so; ``emulated_finish`` loads the library."""
    cpp, stub, so = out / "emu.cpp", out / "stub.h", out / "libemu.so"
    cpp.write_text(text)
    stub.write_text(STUB)
    proc = subprocess.Popen([host_cxx(), *CXX_FLAGS, *defines, "-include", str(stub), "-o",
                             str(so), str(cpp)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, so


def emulated_start(tmp_path_factory, name: str, defines=()):
    """Start the host compiler on csrc/<name>.cu."""
    return compile_start(host_source(name), tmp_path_factory.mktemp(f"{name}_emu"), defines)


def emulated_finish(job) -> ctypes.CDLL:
    proc, so = job
    out, err = proc.communicate()
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, proc.args, out, err)
    return ctypes.CDLL(str(so))


def emulated(tmp_path_factory, name: str, defines=()) -> ctypes.CDLL:
    return emulated_finish(emulated_start(tmp_path_factory, name, defines))


def fused_field_emu(lib: ctypes.CDLL) -> ctypes.CDLL:
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


def ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def field(rng, o, n, h, do_clip):
    """Packed weights (random biases too) and points of o objects."""
    gen = torch.Generator().manual_seed(0)
    params = tof.init_stacked_fields(gen, o, hidden=h, clip_size=16, device="cpu")
    params = tof.tree_map(lambda x: x + 0.05 * torch.randn(x.shape, generator=gen), params)
    w = tff._pack_params(params, h, do_clip).contiguous()
    pts = torch.from_numpy((0.5 * rng.standard_normal((o, n, 3))).astype(np.float32))
    return w, pts


def emulated_bf16_copy(src: Path, out: Path) -> ctypes.CDLL:
    """An edited copy ``src`` of csrc/fused_field_bf16.cu (beside copies of
    what it includes) for the host, at the tensor-core widths 32 and 128."""
    job = compile_start(host_source("fused_field_bf16", src.parent), out,
                        ["-DFF_TC_WIDTHS(X)=X(32) X(128)"])
    return fused_field_emu(emulated_finish(job))

// Probe kernels for Hopper (sm_90a): the design probes of the fused-step and
// part-term plans, written for this card.
//
// Replaces the Pallas TPU kernels of the two probe scripts:
//   ens_gemm<GRID>         <- scripts/bench_ensemble_mm.py batched_kernel (:52)
//                             and, with the sin prologue,
//                             scripts/bench_fused_step_probe.py
//                             _batched_dot_kernel (:74); the kernel
//                             ens_gemm_tiled_kernel, one object per block
//   ens_gemm<OBJTILE>      <- bench_ensemble_mm.py tiled_kernel (:79); with
//                             sin, bench_fused_step_probe.py
//                             _unrolled_dot_kernel (:82); the same kernel,
//                             obj_tile objects per block
//   ens_gemm<PERSISTENT>   <- bench_ensemble_mm.py loop_kernel (:105); the
//                             kernel ens_gemm_persistent_kernel
//   launch_nop_kernel      <- bench_ensemble_mm.py nop_kernel (:135)
//   slab_stream_kernel     <- bench_fused_step_probe.py q2 noop_kernel (:144)
//   step_chain_kernel      <- bench_fused_step_probe.py q3 kernel (:192) at
//                             depth 4, q4's compile_case bodies (:281, :286,
//                             :290) at depth 0 and 1
//   part_tg_kernel         <- bench_fused_step_probe.py q5 kernel (:342)
//   part_dw_kernel<NB>     <- q5 compile_case body bwd_dw (:422)
//   part_quad_kernel<NB>   <- q5 compile_case body fwd_quadratic_chained (:426)
//
// All arithmetic is FP32-accurate, no fast math: FP32 FMA on the SIMT cores,
// except part_tg_kernel, part_dw_kernel, part_quad_kernel, the ensemble
// GEMM's two kernels (ens_gemm_persistent_kernel, ens_gemm_tiled_kernel) and
// step_chain_kernel, whose products run on the tensor cores in 3xTF32 (hi/lo
// TF32 split, three mma.sync per tile, f32 sums). The plain PyTorch versions
// (openobj_torch/ops/probes.py) run in full FP32 and are the reference. Each
// kernel's note says what bounds it on an H100 and what its design does about
// that (part_tg_kernel: bytes, 6.4 us at the probe's shape; one product of
// [gt; wb] rows against wb, C streamed through two stages, one wave;
// part_quad_kernel: bytes, 1.9 us; an object's C split across a cluster of
// two blocks, each copying its Gram partial into the other's shared memory).
// The ensemble GEMM's kernels, step_chain_kernel, part_tg_kernel and
// part_quad_kernel get their operands by Hopper's one-dimensional bulk copy
// (TMA without a tensor map) into mbarrier-tracked stages; step_chain_kernel
// and part_quad_kernel split their work across a thread-block cluster and
// sum the blocks' partials through distributed shared memory (the chain by
// reading its peers' shared memory, part_quad by bulk copies into it). None
// of the kernels uses wgmma yet.
//
// The C entry points return cudaGetLastError() after each launch (or a CUDA
// error code for an argument the kernel cannot take); the Python wrapper
// raises if it is not cudaSuccess.

// Without nvcc (tests/test_torch_kernel_emulation.py runs launch_nop_kernel,
// step_chain_kernel, the part term's three kernels and the ensemble GEMM's
// kernels on the CPU), a header included ahead of this
// file stands in for the CUDA runtime and the inline-PTX helpers under
// `#ifdef __CUDACC__` below.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int TM = 64;           // rows per tile of the persistent kernel (P1)

__host__ __device__ inline int round4(int k) { return (k + 3) & ~3; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// ------------------------------------------------------------ 3xTF32 tiles
// (the helpers of fused_field.cu, copied: each source builds on its own)

#ifdef __CUDACC__
__device__ inline uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += a . b for one m16n8k8 tile, tf32 operands, f32 accumulation
__device__ inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// the 3xTF32 split: x = hi + lo + O(2^-22 |x|), hi and lo both tf32
__device__ inline void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// ---------------------------------------------------------------- cp.async

#ifdef __CUDACC__
__device__ inline void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ inline void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif

// wait until at most n (0..3) committed groups are still in flight
__device__ inline void cp_async_wait_pending(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// ------------------------------------------------- mbarriers and bulk copies
//
// An mbarrier in shared memory completes a phase when its expected number of
// arrivals has been made and the bytes announced with expect_tx have landed;
// a thread waits for the phase of a given parity to complete.

#ifdef __CUDACC__
__device__ inline unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ inline void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// the arrival of the calling thread, made once its earlier cp.asyncs land
__device__ inline void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// order this thread's earlier shared-memory accesses before later bulk copies
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing that many bytes of `bar`'s transaction count
__device__ inline void bulk_copy_g2s(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads') for n threads, whole warps
__device__ inline void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ------------------------------------------------------------ clusters

// every thread of every block of the cluster arrives, then waits for all:
// shared-memory writes before it are visible to the cluster's reads after
__device__ inline void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// cluster_sync in two halves, without its memory ordering: after the
// arrival the thread may go on, and the wait returns once every thread of
// the cluster has arrived
__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float at `p`'s offset in the shared memory of the cluster's block `rank`
__device__ inline float ld_cluster(const float* p, unsigned rank) {
  unsigned addr;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// `bytes` (a multiple of 16, 16-byte aligned) from this block's shared
// memory at `p` to the same offset in the shared memory of the cluster's
// block `rank`, completing that many bytes of that block's mbarrier at
// `bar`'s offset; the source is read through the async proxy
__device__ inline void bulk_copy_s2peer(float* p, unsigned bytes, uint64_t* bar, unsigned rank) {
  unsigned dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(smem_u32(p)), "r"(bytes), "r"(rbar) : "memory");
}
#endif

// ------------------------------------------------------------------- P1
//
// out[o] = f(x[o]) w[o] with f = identity or sin; x [O,N,K], w [O,K,H].
//
// Bound: bytes. At the ensemble probe's shape (O=64, N=1200, K=88, H=32)
// the product is 0.43 GFLOP against 37.6 MB moved: 11 FLOP per byte, under
// the card's FP32 ratio (20); its 3xTF32 work, 1.3 GFLOP, is 2.6 us at the
// dense TF32 rate, under a quarter of the 11.2 us bytes bound. Each input
// element is read from device memory once (x by exactly one block, w[o] by
// the blocks of object o, through L2) and each output written once.
//
// The three schedules are three placements of the same function:
//  GRID       one block per (64-row tile, object): every tile of the whole
//             ensemble in one launch, the counterpart of the TPU's single
//             grid step over the whole ensemble;
//  OBJTILE    one block per (64-row tile, group of `obj_tile` objects),
//             walking its objects in turn: the TPU's object-tiled grid;
//  PERSISTENT one block per SM, each walking a contiguous run of (object,
//             tile) items through a ring of asynchronous copies: the TPU's
//             per-object loop with a DMA into scratch.
// Which placement fills 132 SMs best at O=16 and O=64 is what the probe
// measures. PERSISTENT is ens_gemm_persistent_kernel; GRID and OBJTILE are
// ens_gemm_tiled_kernel, launched on their own grids (its note below). All
// three share their building blocks: a range of x or w comes by one bulk
// copy on an mbarrier (start_copy), w[o] is split once into hi/lo TF32 B
// fragments in shared memory (split_weights), and each warp multiplies 16
// rows of a tile by all of H in 3xTF32 mma.sync and stores C as float2
// (gemm_item).

enum Schedule { GRID = 0, OBJTILE = 1, PERSISTENT = 2 };

struct GemmArgs {
  const float* x;
  const float* w;
  float* out;
  int O, N, K, H, obj_tile;
  int tiles;        // PERSISTENT: 64-row tiles per object
  int tiled_rows;   // GRID, OBJTILE: rows per tile of the tiled kernel
};

// PERSISTENT, on the tensor cores.
//
// Items are (object, 64-row tile) in object-major order; block b of the
// n_blocks = SM-count blocks takes the contiguous run [b*items/G,
// (b+1)*items/G) (9 or 10 items at the ensemble probe's shape, 1,216 items).
//
// Bound: bytes, as above (11.2 us at the ensemble probe's shape). The block
// with 10 items moves 10 x 30.5 KB, ~12 us at its SM's 1/132 share of 3.35
// TB/s, so the design keeps every SM's copies in flight and makes the
// product cheap enough to hide behind them:
//  * x tiles come through a ring of RING = 4 stages in dynamic shared
//    memory, 22.5 KB each at K = 88: while a pair of tiles (below) is
//    multiplied, the next pair is in flight, 5.9 MB across the card, about
//    what Little's law asks for at ~1.5 us latency. A tile of x is
//    one contiguous byte range (rows r0.. of object o, row stride K kept,
//    no padding), so one thread fills a stage with one bulk copy that
//    completes the stage's mbarrier's bytes; a range that is not 16-byte
//    aligned (K = 13, N = 130, a ragged tail) goes through 4-byte
//    cp.asyncs into the same stage, each thread's arrival made when its
//    copies land. Every thread arrives on the stage's mbarrier once per
//    fill (NT arrivals), so both kinds of fill complete a phase alike.
//  * The block takes its items in pairs of one object: warps 0-3 multiply
//    the first, warps 4-7 the second (a pair that would cross an object
//    boundary, or the run's end, is one item, and warps 4-7 wait). After
//    the __syncthreads that ends a pair, its two stages are refilled with
//    the items RING on. Each warp owns 16 rows and all of H, so each A
//    value is loaded, split (and with SIN passed through sinf) once; with
//    two column halves per row tile instead, every A value was split twice
//    and the kernel was slower on an H100, the more so with sin.
//  * w[o] comes the same way, one object ahead, into a staging buffer with
//    its own mbarrier: when the run enters object o the block splits the
//    staged w[o] once into hi/lo TF32 B fragments in mma.sync order (as
//    part_dw_kernel's: one 128-bit load per fragment, zero past K and H;
//    B's rows in the order of A's columns below) and starts the copy of
//    w[o + 1]. A second fragment buffer would not fit beside the ring at
//    K = 128, H = 64 (64 KB each); the staged copy (32 KB at most) does,
//    and the split from shared memory takes a fraction of an item.
//  * The product is 3xTF32 mma.sync.m16n8k8 (al.bh + ah.bl + ah.bh per
//    8-deep step; the small products in accumulators of their own, added
//    to the large one's after the last step, so that no add stands between
//    the mma.sync): FP32-accurate. No branch separates the NB column tiles'
//    chains of three dependent mma.sync (NB is a template parameter): with
//    one, the compiler ran the chains one after another, and on an H100 the
//    product was bound by their latency. The k-loop is unrolled by 4 (by 1
//    with sin, whose sinf calls leave the chains company enough), the best
//    on an H100 at the probe's shapes. Within a step, fragment columns t
//    and t + 4 hold k = 2t and 2t + 1 (B's rows are stored in the same
//    order), so that with K even a lane reads both with one 64-bit load.
//    The hi parts of A and w are rounded to TF32 with an integer add and
//    mask (cvt.rna takes seven instructions on sm_90a), and their lo parts
//    are passed as they are (the tensor core reads their top 19 bits):
//    |lo| <= 2^-11 |a|, so the dropped bits are 2^-21 |a|, as with a
//    rounded lo. k >= K is masked to 0 before sinf and the split in the
//    last step: in the unpadded layout column K of a row is the next row's
//    column 0, and past the tile's last row shared memory holds stale or
//    unwritten values (NaN . 0 is NaN).
//  * C fragments go straight to global memory as float2 (row g, columns
//    2t, 2t + 1: whole 32-byte sectors per warp store), rows >= N and
//    columns >= H masked.
// TM = 64 keeps the last block's extra item at 8% over the bound and four
// warps' rows to a tile. mma.sync and not wgmma: the 3xTF32 work, 1.3
// GFLOP at the probe's shape, is 2.6 us at the dense TF32 rate, under a
// quarter of the bytes bound. Measured on an H100 (scripts/
// ens_gemm_parts.py), the product alone still takes more than twice the
// copies alone: the warps' shared-memory loads, splits and mma.sync rate
// bound the kernel now, not the bytes (PERF.md).
// Shared memory: B fragments [ceil(K/8)][ceil(H/8)][32] uint4, staged w
// [K][H], RING x tiles [TM][K], RING + 1 mbarriers (121.0 KiB at K = 88,
// H = 32; 224.0 KiB at K = 128, H = 64).

constexpr int RING = 4;   // x-tile stages of the persistent kernel

size_t persistent_smem(int K, int H) {
  return (size_t)((K + 7) / 8) * ((H + 7) / 8) * 32 * 16 +
         sizeof(float) * (RING * TM * K + ((K * H + 3) & ~3)) + sizeof(uint64_t) * (RING + 1);
}

// Each of the nth threads that share `bar` (tid = 0 .. nth - 1): start
// copying n floats from src to dst, one arrival on `bar` each.
__device__ inline void start_copy(float* dst, const float* src, int n, uint64_t* bar, int tid,
                                  int nth) {
  const unsigned bytes = 4u * n;
  if (((uintptr_t)src & 15) == 0 && bytes % 16 == 0) {
    if (tid == 0) {
      fence_proxy_async();
      mbar_arrive_expect_tx(bar, bytes);
      bulk_copy_g2s(dst, src, bytes, bar);
    } else {
      mbar_arrive(bar);
    }
  } else {
    for (int i = tid; i < n; i += nth) cp_async4(dst + i, src + i);
    cp_async_mbar_arrive(bar);
  }
}

__device__ inline void start_tile(const GemmArgs& g, int item, float* dst, uint64_t* bar) {
  const int o = item / g.tiles, r0 = (item - o * g.tiles) * TM;
  start_copy(dst, g.x + ((size_t)o * g.N + r0) * g.K, min(TM, g.N - r0) * g.K, bar,
             threadIdx.x, NT);
}

// a = hi + lo, hi rounded to TF32 (to nearest, ties away, for finite a),
// lo exact in FP32; mma.sync reads lo's top 19 bits
__device__ inline void split_a(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// A [K][H] matrix `wr` (staged in shared memory, or in device memory) into
// split B fragments, by nth threads (tid = 0 .. nth - 1): warp by warp, a
// (k-step, n-tile) pair, each lane b0 = w[8 ks + 2t][8 nt + g] and b1 = the
// next row, stored as {b0 hi, b1 hi, b0 lo, b1 lo} with one 128-bit store,
// split as A is (split_a); zero past K and H.
__device__ inline void split_weights(int K, int H, const float* wr, uint4* wf, int nks,
                                     int nb, int tid, int nth) {
  const int lane = tid & 31;
  const int k = 2 * (lane & 3), h = lane >> 2;
  for (int p = tid >> 5; p < nks * nb; p += nth >> 5) {
    const int ks = p / nb, nt = p - ks * nb;
    const int kk = 8 * ks + k, hh = 8 * nt + h;
    const bool ok = hh < H;
    const float v0 = ok && kk < K ? wr[kk * H + hh] : 0.0f;
    const float v1 = ok && kk + 1 < K ? wr[(kk + 1) * H + hh] : 0.0f;
    uint4 f;
    split_a(v0, f.x, f.z);
    split_a(v1, f.y, f.w);
    wf[p * 32 + lane] = f;
  }
}

// One 8-deep step of this warp's NB tiles: a[] = A[g][2t], A[g+8][2t],
// A[g][2t+1], A[g+8][2t+1]; bf = the step's first fragment. No branch: the
// NB chains of three dependent mma.sync interleave. The small products
// (al.bh, ah.bl) accumulate in c[NB + j] and the large (ah.bh) in c[j], with
// no sums between the mma.sync.
template <bool SIN, int NB>
__device__ inline void mma_step(float (&a)[4], const uint4* bf, float (&c)[2 * NB][4]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_a(SIN ? sinf(a[i]) : a[i], ah[i], al[i]);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const uint4 u = bf[j * 32];
    const uint32_t bh[2] = {u.x, u.y}, bl[2] = {u.z, u.w};
    mma_tf32(c[NB + j], al, bh);
    mma_tf32(c[NB + j], ah, bl);
    mma_tf32(c[j], ah, bh);
  }
}

// This warp's 16 rows m0 .. m0 + 15 of out[r0:r0+nv] = f(x tile) . w[o],
// all NB 8-column tiles of H. PAIR: K is even, so a lane's two values of a
// row in a step are one aligned 64-bit load. UNROLL k-steps unrolled.
template <bool SIN, bool PAIR, int NB, int UNROLL>
__device__ inline void gemm_item(const GemmArgs& g, const float* xs, const uint4* wf, int nks,
                                 float* out, int nv, int m0) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int K = g.K;
  const float* x0 = xs + (m0 + gq) * K + 2 * t;   // row g, k = 2t; row g + 8 is 8 K on
  const uint4* bf = wf + lane;
  float c[2 * NB][4];
#pragma unroll
  for (int j = 0; j < 2 * NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.0f;
  const int kfull = K >> 3;                // steps with every k < K
#pragma unroll UNROLL
  for (int ks = 0; ks < kfull; ++ks) {
    const float* p = x0 + 8 * ks;
    float a[4];
    if (PAIR) {
      const float2 u = *reinterpret_cast<const float2*>(p);
      const float2 v = *reinterpret_cast<const float2*>(p + 8 * K);
      a[0] = u.x; a[2] = u.y; a[1] = v.x; a[3] = v.y;
    } else {
      a[0] = p[0]; a[2] = p[1]; a[1] = p[8 * K]; a[3] = p[8 * K + 1];
    }
    mma_step<SIN, NB>(a, bf + ks * NB * 32, c);
  }
  if (kfull < nks) {                       // the last step: k >= K masked to 0
    const float* p = x0 + 8 * kfull;
    const int k = 8 * kfull + 2 * t;
    float a[4] = {k < K ? p[0] : 0.0f, k < K ? p[8 * K] : 0.0f,
                  k + 1 < K ? p[1] : 0.0f, k + 1 < K ? p[8 * K + 1] : 0.0f};
    mma_step<SIN, NB>(a, bf + kfull * NB * 32, c);
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] += c[NB + j][i];
  const int H = g.H;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int n = 8 * j + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = m0 + gq + 8 * hr;
      if (r >= nv || n >= H) continue;
      float* q = out + (size_t)r * H + n;
      if ((H & 1) == 0) {
        *reinterpret_cast<float2*>(q) = make_float2(c[j][2 * hr], c[j][2 * hr + 1]);
      } else {
        q[0] = c[j][2 * hr];
        if (n + 1 < H) q[1] = c[j][2 * hr + 1];
      }
    }
  }
}

template <bool SIN, bool PAIR, int NB>
__global__ void __launch_bounds__(NT, 1) ens_gemm_persistent_kernel(GemmArgs g) {
  extern __shared__ __align__(16) float sm[];
  const long items = (long)g.O * g.tiles;
  const int i0 = (int)(items * blockIdx.x / gridDim.x);
  const int i1 = (int)(items * (blockIdx.x + 1) / gridDim.x);
  if (i0 >= i1) return;
  const int nks = (g.K + 7) / 8;
  const int stage = TM * g.K, wn = g.K * g.H;            // floats
  uint4* wf = reinterpret_cast<uint4*>(sm);               // [nks][NB][32]
  float* wr = sm + nks * NB * 32 * 4;                     // staged w [K][H]
  float* xs = wr + ((wn + 3) & ~3);                       // RING x [TM][K]
  uint64_t* bar = reinterpret_cast<uint64_t*>(xs + RING * stage);   // RING, then w's
  uint64_t* wbar = bar + RING;
  if (threadIdx.x == 0) {
    for (int s = 0; s <= RING; ++s) mbar_init(bar + s, NT);
    mbar_init_fence();
  }
  __syncthreads();
  const int olast = (i1 - 1) / g.tiles;
  start_copy(wr, g.w + (size_t)(i0 / g.tiles) * wn, wn, wbar, threadIdx.x, NT);
  for (int j = 0; j < RING && i0 + j < i1; ++j) start_tile(g, i0 + j, xs + j * stage, bar + j);

  const int grp = threadIdx.x >> 7;   // warps 0-3 take the first item of a pair, 4-7 the second
  int wobj = -1, wphase = 0;          // the object whose fragments wf holds
  for (int it = i0; it < i1;) {
    const int o = it / g.tiles;
    if (o != wobj) {                  // wf and wr are free: the last pair ended in a barrier
      mbar_wait(wbar, wphase);
      wphase ^= 1;
      split_weights(g.K, g.H, wr, wf, nks, NB, threadIdx.x, NT);
      __syncthreads();
      if (o < olast) start_copy(wr, g.w + (size_t)(o + 1) * wn, wn, wbar, threadIdx.x, NT);
      wobj = o;
    }
    // items it and it + 1 when both are of object o, else it alone
    const int n_it = it + 1 < i1 && (it + 1) / g.tiles == o ? 2 : 1;
    if (grp < n_it) {
      const int j = it + grp - i0, r0 = (it + grp - o * g.tiles) * TM;
      mbar_wait(bar + j % RING, (j / RING) & 1);
      gemm_item<SIN, PAIR, NB, SIN ? 1 : 4>(g, xs + (j % RING) * stage, wf, nks,
                                            g.out + ((size_t)o * g.N + r0) * g.H,
                                            min(TM, g.N - r0), 16 * ((threadIdx.x >> 5) & 3));
    }
    __syncthreads();   // every warp is done with the pair's stages (and with wf)
    for (int q = 0; q < n_it; ++q) {
      const int j = it + q - i0;
      if (it + q + RING < i1) start_tile(g, it + q + RING, xs + (j % RING) * stage, bar + j % RING);
    }
    it += n_it;
  }
}

// GRID and OBJTILE, on the tensor cores: ens_gemm_tiled_kernel.
//
// Block (i, j) takes row tile i of objects j*ot .. j*ot + ot - 1, with
// ot = 1 for GRID and ot = obj_tile for OBJTILE. A tile is 64 or 128 rows
// (choose_tiled_rows, below) and a warp group a warp per 16 of them. Each group
// owns one stage in shared memory (x tile [rows][K] and w[o] [K][H],
// unpadded, each one contiguous range with its own mbarrier) and one buffer
// of w[o]'s split B fragments; with two groups, the first takes the block's
// objects 0, 2, 4, ... and the second 1, 3, 5, ..., so the block's ring of
// two stages is filled two objects ahead. Per object a group waits for
// w[o], splits it once into B fragments (split_weights; in K1, splitting
// per use cost as much as the product) while x's tile may still be landing,
// starts the copy of its next object's w (it lands behind the product),
// waits for x, multiplies (gemm_item), and once its warps are done with the
// stage (a named barrier of the group's threads) starts its next x tile.
// Every copy is start_copy's: one bulk copy, or 4-byte cp.asyncs where a
// range is not 16-byte aligned. The groups never wait for each other.
//
// Bound: bytes at the probe's shapes, as above; measured on an H100
// (scripts/ens_gemm_parts.py), the product side (the weight splits,
// mma.sync, stores), not the copies, takes the time, and the splits are a
// fifth to a quarter of it (PERF.md). So a 128-row tile, which splits each w[o] once for
// twice the rows, is taken wherever it puts no more rows on the busiest SM
// than 64-row tiles would: at the ensemble probe's shape, GRID's 640 blocks
// (5 a SM, against 10 of 64 rows) and OBJTILE's 80 (one a SM, against 2 of
// 64 rows on 20 SMs, the same rows with half the splits). With O = 16
// (q1) it takes 64 rows. Copy latency hides behind other resident warps,
// not behind a deeper ring: one group's shared memory at K = 88, H = 32 is
// 77.0 KB at 128 rows (x 44.0, w 11.0, fragments 22.0) and 55.0 KB at 64,
// so GRID keeps 2 or 4 blocks, 16 warps, on an SM (twice the persistent
// kernel's 8), and OBJTILE with two groups 1 or 2 blocks, all its blocks
// resident. Every block needs at most 128 registers a thread: the
// two-group launch has 512 threads, and the one-group launches' resident
// blocks (2 of 256 threads, 4 of 128) need the same cap. So the kernel is
// built with __launch_bounds__(512, 1), and gemm_item runs with the k-loop
// unrolled by 2 (by 1 with sin), the best on an H100 under that cap. At
// H = 64 without sin (NB = 8, a width no probe times) ptxas spills 20
// bytes under it; a looser bound would need a second instance kept from
// the two-group launch. OBJTILE takes one group per block where two do
// not fit in a block's 227 KB (K = 128, H = 64: 160.0 KB a group at 128
// rows), GRID always one; every shape that pr_ens_gemm accepts fits one
// group.

constexpr size_t SMEM_MAX = 232448;    // dynamic shared memory a block may opt into (sm_90a)

// floats of one warp group's stage (rows of x, w) and fragment buffer
__host__ __device__ inline int group_floats(int rows, int K, int H) {
  return rows * K + round4(K * H) + (K + 7) / 8 * ((H + 7) / 8) * 32 * 4;
}

size_t tiled_smem(int rows, int K, int H, int groups) {
  return sizeof(float) * groups * group_floats(rows, K, H) + 2 * sizeof(uint64_t) * groups;
}

template <bool SIN, bool PAIR, int NB>
__global__ void __launch_bounds__(512, 1) ens_gemm_tiled_kernel(GemmArgs g) {
  extern __shared__ __align__(16) float sm[];
  const int rows = g.tiled_rows, gt = 2 * rows;                // a warp per 16 rows
  const int groups = blockDim.x / gt, grp = threadIdx.x / gt, tid = threadIdx.x % gt;
  const int nks = (g.K + 7) / 8, wn = g.K * g.H;
  const int gf = group_floats(rows, g.K, g.H);
  float* xs = sm + grp * gf;                                    // x tile [rows][K]
  float* ws = xs + rows * g.K;                                  // w [K][H]
  uint4* wf = reinterpret_cast<uint4*>(ws + round4(wn));        // [nks][NB][32]
  uint64_t* xbar = reinterpret_cast<uint64_t*>(sm + groups * gf) + 2 * grp;
  uint64_t* wbar = xbar + 1;
  if (tid == 0) {
    mbar_init(xbar, gt);
    mbar_init(wbar, gt);
    mbar_init_fence();
  }
  __syncthreads();
  const int r0 = blockIdx.x * rows, nv = min(rows, g.N - r0);
  const int o1 = min(g.O, (int)(blockIdx.y + 1) * g.obj_tile);
  const float* x = g.x + (size_t)r0 * g.K;                      // x[o] at x + o N K
  int o = blockIdx.y * g.obj_tile + grp;
  if (o < o1) {
    start_copy(ws, g.w + (size_t)o * wn, wn, wbar, tid, gt);
    start_copy(xs, x + (size_t)o * g.N * g.K, nv * g.K, xbar, tid, gt);
  }
  for (unsigned phase = 0; o < o1; o += groups, phase ^= 1) {
    const bool more = o + groups < o1;
    mbar_wait(wbar, phase);
    split_weights(g.K, g.H, ws, wf, nks, NB, tid, gt);
    named_sync(1 + grp, gt);   // wf is whole, and ws free for the next object's w
    if (more) start_copy(ws, g.w + (size_t)(o + groups) * wn, wn, wbar, tid, gt);
    mbar_wait(xbar, phase);
    gemm_item<SIN, PAIR, NB, SIN ? 1 : 2>(g, xs, wf, nks, g.out + ((size_t)o * g.N + r0) * g.H,
                                          nv, 16 * (tid >> 5));
    if (more) {
      named_sync(1 + grp, gt);   // the group's warps are done with xs and wf
      start_copy(xs, x + (size_t)(o + groups) * g.N * g.K, nv * g.K, xbar, tid, gt);
    }
  }
}

// ------------------------------------------------------- P1's launches

using GemmKernel = void (*)(GemmArgs);

template <bool SIN, bool PAIR, int NB>
GemmKernel instance(int schedule) {
  return schedule == PERSISTENT ? ens_gemm_persistent_kernel<SIN, PAIR, NB>
                                : ens_gemm_tiled_kernel<SIN, PAIR, NB>;
}

// the instance for a schedule, K's parity and H's 8-column tiles
template <bool SIN, bool PAIR>
GemmKernel instance_nb(int schedule, int H) {
  switch ((H + 7) / 8) {
    case 1: return instance<SIN, PAIR, 1>(schedule);
    case 2: return instance<SIN, PAIR, 2>(schedule);
    case 3: return instance<SIN, PAIR, 3>(schedule);
    case 4: return instance<SIN, PAIR, 4>(schedule);
    case 5: return instance<SIN, PAIR, 5>(schedule);
    case 6: return instance<SIN, PAIR, 6>(schedule);
    case 7: return instance<SIN, PAIR, 7>(schedule);
    default: return instance<SIN, PAIR, 8>(schedule);
  }
}

struct GemmLaunch {
  GemmKernel kernel;
  dim3 grid;
  int threads;
  size_t smem;   // dynamic shared memory, bytes
};

// The tiled kernel's rows per tile: 128 (8 warps a group) unless that puts
// more rows of x on the busiest SM than 64 (4 warps a group) would; a 128-row
// tile splits each w[o] once for twice the rows.
int choose_tiled_rows(int N, int O, int ot) {
  int dev = 0, n_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long groups = (O + ot - 1) / ot, per_block = min(ot, O);
  auto busiest = [&](int rows) {
    const long blocks = (N + rows - 1) / rows * groups;
    return (blocks + n_sm - 1) / n_sm * per_block * rows;
  };
  return busiest(128) <= busiest(64) ? 128 : 64;
}

// P1's arguments checked, GemmArgs filled (obj_tile 1 for GRID), the launch
// pr_ens_gemm makes for them chosen and its dynamic shared memory opted
// into: cudaSuccess, or the CUDA error code with which pr_ens_gemm refuses
// them (cudaErrorInvalidValue where the layout does not fit).
int gemm_setup(GemmArgs& g, GemmLaunch& l, const float* x, const float* w, float* out, int O,
               int N, int K, int H, int schedule, bool sin, int obj_tile, int n_blocks) {
  if (O < 1 || N < 1 || K < 1 || K > 128 || H < 1 || H > 64 || obj_tile < 1 ||
      n_blocks < 1 || schedule < GRID || schedule > PERSISTENT)
    return (int)cudaErrorInvalidValue;
  g.x = x; g.w = w; g.out = out;
  g.O = O; g.N = N; g.K = K; g.H = H;
  g.obj_tile = schedule == GRID ? 1 : obj_tile;
  g.tiles = g.tiled_rows = 0;
  const bool pair = K % 2 == 0;
  l.kernel = sin ? (pair ? instance_nb<true, true>(schedule, H)
                         : instance_nb<true, false>(schedule, H))
                 : (pair ? instance_nb<false, true>(schedule, H)
                         : instance_nb<false, false>(schedule, H));
  if (schedule == PERSISTENT) {
    g.tiles = (N + TM - 1) / TM;
    l.grid = dim3(n_blocks);
    l.threads = NT;
    l.smem = persistent_smem(K, H);
  } else {
    const int rows = g.tiled_rows = choose_tiled_rows(N, O, g.obj_tile);
    const int groups = g.obj_tile >= 2 && tiled_smem(rows, K, H, 2) <= SMEM_MAX ? 2 : 1;
    l.grid = dim3((N + rows - 1) / rows, (O + g.obj_tile - 1) / g.obj_tile);
    l.threads = groups * 2 * rows;
    l.smem = tiled_smem(rows, K, H, groups);
  }
  if (l.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)l.smem);
}

// ------------------------------------------------------------------- P2
//
// y = x for a few hundred floats: the kernel whose cost is the launch.
//
// Bound: the launch. The bytes ([8, 88] floats, 5.6 KB read and written) take
// 1.7 ns at 3.35 TB/s; what is left is the launch and one round trip to
// memory. So each thread issues every load it has before any store: up to
// NOP_V float4 loads (4 NOP_V single floats where x and y are not 16-byte
// aligned alike), then the stores, so that one round of loads is in flight
// and no load waits behind a store. A grid-stride loop instead made each
// thread wait on one load per round (the compiler does not hoist loads out of
// a loop whose trip count it does not know). The head and tail that are not
// 16-byte aligned (at most 3 floats each) go by single floats, by threads
// 0-2. The block is ceil(n/4) threads rounded up to a warp, at most NT; larger
// n takes more blocks. No launch attribute: the probe measures an ordinary
// launch.

constexpr int NOP_V = 4;   // float4 loads per thread

// head >= 0: x + head and y + head are both 16-byte aligned (head <= 3);
// head < 0: they are not aligned alike, and every float goes singly
__global__ void __launch_bounds__(NT)
launch_nop_kernel(const float* __restrict__ x, float* __restrict__ y, int n, int head) {
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x, nth = gridDim.x * blockDim.x;
  if (head >= 0) {
    const int nv = (n - head) / 4, tail = head + 4 * nv;
    const float4* xv = reinterpret_cast<const float4*>(x + head);
    float4* yv = reinterpret_cast<float4*>(y + head);
    const bool h = i0 < head, t = i0 < n - tail;
    float4 v[NOP_V];
    float hv = 0.0f, tv = 0.0f;
#pragma unroll
    for (int u = 0; u < NOP_V; ++u)
      if (i0 + u * nth < nv) v[u] = xv[i0 + u * nth];
    if (h) hv = x[i0];
    if (t) tv = x[tail + i0];
#pragma unroll
    for (int u = 0; u < NOP_V; ++u)
      if (i0 + u * nth < nv) yv[i0 + u * nth] = v[u];
    if (h) y[i0] = hv;
    if (t) y[tail + i0] = tv;
  } else {
    float v[4 * NOP_V];
#pragma unroll
    for (int u = 0; u < 4 * NOP_V; ++u)
      if (i0 + u * nth < n) v[u] = x[i0 + u * nth];
#pragma unroll
    for (int u = 0; u < 4 * NOP_V; ++u)
      if (i0 + u * nth < n) y[i0 + u * nth] = v[u];
  }
}


// ------------------------------------------------------------------- P3
//
// Grid (object tiles, steps). Block (i, j) streams the step's ray slab
// xs[j, i*ot:(i+1)*ot] (ot*R*DX contiguous floats) through shared memory in
// 16 KB chunks with cp.async, double-buffered, and discards it, as the
// Pallas pipeline streams a block its body never reads; then it writes
// out[j, i*ot + b, 0, :H] = w0[i*ot + b, 0, :H] * 1.000001.
//
// Bound: bytes, the slab read once (246 MB at the probe's full shape). The
// copies are 16 bytes a thread, consecutive threads on consecutive
// addresses, and wait on no compute.

constexpr int SLAB_CHUNK = 4096;   // floats per chunk (16 KB)

__global__ void __launch_bounds__(NT)
slab_stream_kernel(const float* __restrict__ xs, const float* __restrict__ w0,
                   float* __restrict__ out, int O, int slab_floats, int w0_floats,
                   int H, int ot) {
  __shared__ __align__(16) float buf[2][SLAB_CHUNK];
  const int b0 = blockIdx.x * ot, j = blockIdx.y;
  const int nobj = min(ot, O - b0);
  const float* src = xs + ((size_t)j * O + b0) * slab_floats;
  const long total = (long)nobj * slab_floats;   // a multiple of 4
  const int n_chunks = (int)((total + SLAB_CHUNK - 1) / SLAB_CHUNK);
  for (int c = 0; c < n_chunks; ++c) {
    const long base = (long)c * SLAB_CHUNK;
    const int len = (int)min((long)SLAB_CHUNK, total - base);
    float* dst = buf[c & 1];
    for (int q = threadIdx.x * 4; q < len; q += NT * 4) cp_async16(dst + q, src + base + q);
    cp_async_commit();
    cp_async_wait<1>();   // chunk c-1 has landed; its half is free again
    __syncthreads();
  }
  cp_async_wait<0>();
  for (int q = threadIdx.x; q < nobj * H; q += NT) {
    const int b = q / H, c = q - b * H;
    out[((size_t)j * O + b0 + b) * H + c] = w0[(size_t)(b0 + b) * w0_floats + c] * 1.000001f;
  }
}

// ------------------------------------------------------------------- P4
//
// Per (step s, object o), over the object's N rays:
//   e = sin(x w0)              x [N, DX], w0 [DX, K]
//   h = relu(e w1)             w1 [K, H]             (depth >= 1)
//   h = relu(h w2), depth-1 times                    w2 [H, H]
//   out[s, o, :] = sum over rows of h   (depth 0: of e[:, :H])
// Nothing but the [H] result per pair is written to device memory: the
// fused-step kernel's forward in miniature.
//
// Bound: operations. At q3's shape a ray costs 8 * 87 projection FMAs and 87
// sines (the encode, on the SIMT cores) and 87 * 32 + 3 * 32 * 32 = 5,856
// multiply-adds of products (89% of the multiply-adds) against 32 bytes of
// input. The products run on the tensor cores in 3xTF32, so the encode's
// FMAs and sines take as long as the products at the card's peak rates; the
// design keeps both units fed and keeps everything else off the path:
//  * A warp owns 16 rows and all of H, and the layers are chained in
//    registers: mma_step's fragment order holds k = 2t, 2t + 1 of a step in
//    fragment columns t, t + 4 (and B's rows in the same order), so a
//    layer's C tile j (c0, c1 = row g, columns 8j + 2t, 8j + 2t + 1; c2, c3
//    = row g + 8) is the next layer's A fragment of k-step j as {c0, c2, c1,
//    c3}. relu(C) feeds the next mma_step with no shuffle and no shared
//    memory. Each product is mma_step's 3xTF32 mma.sync with separate small
//    and large accumulators, as the ensemble GEMM's.
//  * w0, w1 and w2 come by bulk copy (start_copy) into a staging area on an
//    mbarrier of their own, in flight together with the first two x tiles;
//    then w1 and w2 are split once per block into B fragments in shared
//    memory (split_weights) and w0 is laid out zero-padded. Read straight
//    from device memory, each of a thread's weight loads waited a round trip
//    of its own, and at q4 that prologue weighed as much as the tiles.
//  * The encode runs on FMAs straight into A fragment positions: each lane
//    projects its rows g and g + 8 at k = 8 ks + 2t, 2t + 1 from x in
//    registers and w0 in shared memory ([DXP][8 ceil(K/8)], zero past DX and
//    K, so k >= K gives sin(0) = 0), an FMA chain over d in order; rows past
//    the tile's last are set to 0 before the sine (their stage holds stale
//    rows, or NaN), so they add relu(0 w) = 0. mma_step<true> takes the
//    sines and the split, as for K4a.
//  * x tiles of 128 rows (16 a warp) come by one bulk copy each (start_copy:
//    a pair's rows are one contiguous range; 4-byte cp.asyncs where it is
//    not 16-byte aligned) into CSTAGES = 2 stages on mbarriers: the next
//    tile lands while this one is computed, and one __syncthreads per tile
//    frees a stage for the tile after next. (Three stages, which put all of
//    a rank's tiles at q4 in flight from the start, measured no faster on
//    an H100.)
//  * The row sum is taken in registers (each lane its columns over its two
//    rows, tile after tile), then over the warp's 16 rows by shuffles, then
//    over warps in order through shared memory: a fixed order, so the result
//    does not depend on scheduling.
//  * When the (step, object) pairs do not fill the card (q4: 32 or 64 pairs
//    on 132 SMs), the pair's rays are split evenly across a cluster of c
//    blocks (choose_cluster: the largest c in {1, 2, 4, 8} with which all
//    the pairs' clusters are resident at once, by
//    cudaOccupancyMaxActiveClusters: a cluster's blocks share a GPC, and
//    on an H100 at two blocks an SM 132 clusters of 2 fit but only 62 of
//    4; q3's 6,400 pairs take c = 1, q4's 32 pairs c = 4 and 64 pairs
//    c = 2. Clusters that did not all fit ran as a second wave and took
//    1.4 times as long.) After a cluster barrier, rank
//    0 adds the ranks' partial sums in rank order from their shared memory
//    (mapa / ld.shared::cluster) and writes the result; a second barrier
//    keeps the other ranks' shared memory alive until then. One launch, no
//    workspace, and the same order every run. A rank with no rows adds 0.
// Shared memory: w1's and w2's B fragments, w0 padded, two x stages, the
// warps' sums, the block's partial, the staged weights and three mbarriers
// (60.9 KB at q3's DX = 8, K = 87, H = 32; 182.6 KB at DX = 16, K = 128,
// H = 64).

struct ChainArgs {
  const float* xs;
  const float* w0;
  const float* w1;
  const float* w2;
  float* out;
  int S, O, N, DX, K, H, depth;
  int cluster;   // blocks per (step, object) pair, each a share of its rays
};

constexpr int CT = 16 * NW;   // rows per x tile of the chain: a warp per 16
constexpr int CSTAGES = 2;    // x stages of the chain

// One warp's 16 rows of the chain, added to the lane's row sums rs[j][e]
// (column 8j + 2t + e over rows g and g + 8). x0, x1: rows g and g + 8 (0
// past DX); ok0, ok1: those rows exist; w0t: w0's shared copy at column 2t,
// row stride kp; w1f, w2f: the lane's B fragments.
template <int NB, int DXP>
__device__ inline void chain_rows(int depth, const float (&x0)[DXP], const float (&x1)[DXP],
                                  bool ok0, bool ok1, const float* w0t, int kp, int nks,
                                  const uint4* w1f, const uint4* w2f, float (&rs)[NB][2]) {
  // p = x w0 at {(g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)} of k-step ks
  auto encode = [&](int ks, float (&p)[4]) {
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
    const float* w = w0t + 8 * ks;
#pragma unroll
    for (int d = 0; d < DXP; ++d) {
      const float2 u = *reinterpret_cast<const float2*>(w + d * kp);
      p0 = fmaf(x0[d], u.x, p0);
      p1 = fmaf(x1[d], u.x, p1);
      p2 = fmaf(x0[d], u.y, p2);
      p3 = fmaf(x1[d], u.y, p3);
    }
    p[0] = ok0 ? p0 : 0.0f;
    p[1] = ok1 ? p1 : 0.0f;
    p[2] = ok0 ? p2 : 0.0f;
    p[3] = ok1 ? p3 : 0.0f;
  };
  if (depth == 0) {   // e's first 8 NB columns (the caller keeps those < H)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float p[4];
      encode(j, p);
      rs[j][0] += sinf(p[0]) + sinf(p[1]);
      rs[j][1] += sinf(p[2]) + sinf(p[3]);
    }
    return;
  }
  float c[2 * NB][4], h[NB][4];
  auto relu_of = [&]() {   // h = relu(large + small), c zeroed for the next layer
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = c[j][i] + c[NB + j][i];
        h[j][i] = v > 0.0f ? v : 0.0f;
        c[j][i] = c[NB + j][i] = 0.0f;
      }
  };
#pragma unroll
  for (int j = 0; j < 2 * NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.0f;
  for (int ks = 0; ks < nks; ++ks) {
    float p[4];
    encode(ks, p);
    mma_step<true, NB>(p, w1f + ks * NB * 32, c);
  }
  relu_of();
  for (int l = 1; l < depth; ++l) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float a[4] = {h[j][0], h[j][2], h[j][1], h[j][3]};
      mma_step<false, NB>(a, w2f + j * NB * 32, c);
    }
    relu_of();
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    rs[j][0] += h[j][0] + h[j][2];
    rs[j][1] += h[j][1] + h[j][3];
  }
}

template <int NB, int DXP>
__global__ void __launch_bounds__(NT, 1) step_chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int K = a.K, H = a.H, DX = a.DX, nks = (K + 7) / 8, kp = 8 * nks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nc = a.cluster, o = blockIdx.x / nc, rank = blockIdx.x - o * nc, s = blockIdx.y;
  uint4* w1f = reinterpret_cast<uint4*>(sm);                   // [nks][NB][32]
  uint4* w2f = w1f + nks * NB * 32;                            // [NB][NB][32]
  float* w0s = reinterpret_cast<float*>(w2f + NB * NB * 32);   // [DXP][kp]
  float* xt = w0s + DXP * kp;                                  // CSTAGES x [CT][DX]
  float* red = xt + CSTAGES * CT * DX;                         // [NW][8 NB]
  float* part = red + NW * 8 * NB;                             // [8 NB]
  float* w0r = part + 8 * NB;                                  // staged w0 [DX][K]
  float* w1r = w0r + round4(DX * K);                           // staged w1 [K][H]
  float* w2r = w1r + round4(K * H);                            // staged w2 [H][H]
  uint64_t* bar = reinterpret_cast<uint64_t*>(w2r + round4(H * H));   // x stages, then w's
  uint64_t* wbar = bar + CSTAGES;
  // this rank's rows rb .. re - 1 of the pair
  const int rb = (int)((long)a.N * rank / nc), re = (int)((long)a.N * (rank + 1) / nc);
  const int nrows = re - rb, ntiles = (nrows + CT - 1) / CT;
  const float* xg = a.xs + (((size_t)s * a.O + o) * a.N + rb) * DX;
  const int nw = 1 + (a.depth >= 1) + (a.depth >= 2);          // weight matrices read
  if (tid == 0) {
    for (int i = 0; i < CSTAGES; ++i) mbar_init(bar + i, NT);
    mbar_init(wbar, NT * nw);
    mbar_init_fence();
  }
  __syncthreads();
  start_copy(w0r, a.w0 + (size_t)o * DX * K, DX * K, wbar, tid, NT);
  if (a.depth >= 1) start_copy(w1r, a.w1 + (size_t)o * K * H, K * H, wbar, tid, NT);
  if (a.depth >= 2) start_copy(w2r, a.w2 + (size_t)o * H * H, H * H, wbar, tid, NT);
  for (int i = 0; i < CSTAGES && i < ntiles; ++i)
    start_copy(xt + i * CT * DX, xg + (size_t)i * CT * DX, min(CT, nrows - i * CT) * DX, bar + i,
               tid, NT);
  mbar_wait(wbar, 0);
  for (int i = tid; i < DXP * kp; i += NT) {
    const int d = i / kp, k = i - d * kp;
    w0s[i] = d < DX && k < K ? w0r[d * K + k] : 0.0f;
  }
  if (a.depth >= 1) split_weights(K, H, w1r, w1f, nks, NB, tid, NT);
  if (a.depth >= 2) split_weights(H, H, w2r, w2f, NB, NB, tid, NT);
  __syncthreads();

  float rs[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j) rs[j][0] = rs[j][1] = 0.0f;
  const int m0 = 16 * warp;
  for (int i = 0; i < ntiles; ++i) {
    const int nv = min(CT, nrows - i * CT);
    const int st = i % CSTAGES;
    const float* x = xt + st * CT * DX;
    mbar_wait(bar + st, (i / CSTAGES) & 1);
    if (m0 < nv) {   // the whole warp: mma.sync wants every lane
      float x0[DXP], x1[DXP];
#pragma unroll
      for (int d = 0; d < DXP; ++d) {
        x0[d] = d < DX ? x[(m0 + g) * DX + d] : 0.0f;
        x1[d] = d < DX ? x[(m0 + g + 8) * DX + d] : 0.0f;
      }
      chain_rows<NB, DXP>(a.depth, x0, x1, m0 + g < nv, m0 + g + 8 < nv, w0s + 2 * t, kp, nks,
                          w1f + lane, w2f + lane, rs);
    }
    if (i + CSTAGES < ntiles) {
      __syncthreads();   // every warp is done with the stage
      start_copy(xt + st * CT * DX, xg + (size_t)(i + CSTAGES) * CT * DX,
                 min(CT, nrows - (i + CSTAGES) * CT) * DX, bar + st, tid, NT);
    }
  }
  // over the warp's 16 rows (the 8 lanes of each t), then over warps in order
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = rs[j][e];
      v += __shfl_sync(0xffffffffu, v, lane ^ 4);
      v += __shfl_sync(0xffffffffu, v, lane ^ 8);
      v += __shfl_sync(0xffffffffu, v, lane ^ 16);
      if (g == 0) red[warp * 8 * NB + 8 * j + 2 * t + e] = v;
    }
  __syncthreads();
  float* og = a.out + ((size_t)s * a.O + o) * H;
  for (int col = tid; col < H; col += NT) {
    float v = 0.0f;
    for (int w = 0; w < NW; ++w) v += red[w * 8 * NB + col];
    if (nc == 1) og[col] = v;
    else part[col] = v;
  }
  if (nc > 1) {
    cluster_sync();   // every rank's partial is in its shared memory
    if (rank == 0) {
      for (int col = tid; col < H; col += NT) {
        float v = 0.0f;
        for (int r = 0; r < nc; ++r) v += ld_cluster(part + col, r);
        og[col] = v;
      }
    }
    cluster_sync();   // rank 0 has read them: the ranks may exit
  }
}

using ChainKernel = void (*)(ChainArgs);

template <int DXP>
ChainKernel chain_instance(int H) {
  switch ((H + 7) / 8) {
    case 1: return step_chain_kernel<1, DXP>;
    case 2: return step_chain_kernel<2, DXP>;
    case 3: return step_chain_kernel<3, DXP>;
    case 4: return step_chain_kernel<4, DXP>;
    case 5: return step_chain_kernel<5, DXP>;
    case 6: return step_chain_kernel<6, DXP>;
    case 7: return step_chain_kernel<7, DXP>;
    default: return step_chain_kernel<8, DXP>;
  }
}

struct ChainLaunch {
  ChainKernel kernel;
  dim3 grid;
  size_t smem;   // dynamic shared memory, bytes
  int per_sm;    // blocks resident per SM
  int active;    // clusters resident at once
};

size_t chain_smem(int DXP, int DX, int K, int H) {
  const int nks = (K + 7) / 8, nb = (H + 7) / 8;
  return 16 * (size_t)(nks * nb + nb * nb) * 32 +
         sizeof(float) * (size_t)(DXP * 8 * nks + CSTAGES * CT * DX + NW * 8 * nb + 8 * nb +
                                  round4(DX * K) + round4(K * H) + round4(H * H)) +
         (CSTAGES + 1) * sizeof(uint64_t);
}

// A launch of `grid` blocks of `threads` with `smem` bytes of dynamic shared
// memory, in clusters of c blocks
cudaLaunchConfig_t cluster_config(dim3 grid, int threads, size_t smem, unsigned c,
                                  cudaLaunchAttribute& attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks per (step, object) pair: the largest c in {1, 2, 4, 8} with which
// every pair's cluster is resident at once (cudaOccupancyMaxActiveClusters:
// a cluster's blocks share one GPC, so this is less than the SM count times
// the blocks per SM over c), else 1. l.active = the clusters of c resident.
int choose_cluster(long pairs, ChainLaunch& l, int& c) {
  for (c = 8; c >= 1; c /= 2) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(dim3(c), NT, l.smem, c, attr, nullptr);
    const int err = (int)cudaOccupancyMaxActiveClusters(&l.active, l.kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (pairs <= l.active || c == 1) break;
  }
  return cudaSuccess;
}

// P4's arguments checked, ChainArgs filled, the launch pr_step_chain makes
// for them chosen and its shared memory opted into: cudaSuccess, or the CUDA
// error code with which pr_step_chain refuses them.
int chain_setup(ChainArgs& a, ChainLaunch& l, const float* xs, const float* w0, const float* w1,
                const float* w2, float* out, int S, int O, int N, int DX, int K, int H,
                int depth) {
  if (S < 1 || S > 65535 || O < 1 || N < 1 || DX < 1 || DX > 16 || K < 1 || K > 128 || H < 4 ||
      H > 64 || H % 4 != 0 || depth < 0 || (depth == 0 && H > K))
    return (int)cudaErrorInvalidValue;
  a.xs = xs; a.w0 = w0; a.w1 = w1; a.w2 = w2; a.out = out;
  a.S = S; a.O = O; a.N = N; a.DX = DX; a.K = K; a.H = H; a.depth = depth;
  const int dxp = DX <= 8 ? 8 : 16;
  l.kernel = dxp == 8 ? chain_instance<8>(H) : chain_instance<16>(H);
  l.smem = chain_smem(dxp, DX, K, H);
  int err = (int)cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)l.smem);
  if (err == cudaSuccess)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.per_sm, l.kernel, NT, l.smem);
  if (err == cudaSuccess) err = choose_cluster((long)S * O, l, a.cluster);
  l.grid = dim3(O * a.cluster, S);
  return err;
}

// ------------------------------------------------------------------- P5
//
// The part term's contractions, per object:
//   tg    t = gt wb^T [R, Hp] and g = wb wb^T [Hp, Hp], over C (512)
//   dw    dW = dt^T gt [Hp, C], over the R rays
//   quad  z = hp (wb wb^T) [R, Hp], the Gram matrix formed in the kernel
//
// Bound: bytes (tg 21.4 MB for 0.33 GFLOP, about 16 FLOP per byte; dw and
// quad less). All three run their products on the tensor cores in 3xTF32
// (their notes below); quad (part_quad_kernel) splits each object's C across
// a cluster of two blocks, 128 in one wave, and sums their Gram partials
// through distributed shared memory: 7.0 us at the probe's shape on an H100
// against the 1.9 us bound (PERF.md).

constexpr int TG_RT = 48;       // rows of A per block (tg): three m-tiles
constexpr int TG_MT = TG_RT / 16;
constexpr int TG_KC = 128;      // columns of C per stage (tg, quad)
constexpr int TG_LD = TG_KC + 4;    // tg's and quad's shared row stride, 4 mod 32
constexpr int TG_STAGES = 2;    // stages of the ring (tg, quad)
constexpr int DW_CT = 16 * NW;  // columns of C per block (dw): a warp per 16
constexpr int DW_RC = 128;      // rays staged at once (dw)
constexpr int DW_G = 32;        // rays per cp.async group (dw)
constexpr int DW_B = 4;         // dt fragments loaded at once per thread (dw)
constexpr int DW_LDG = DW_CT + 8;   // gt's shared row stride, 8 mod 32
constexpr int QD_CL = 2;        // blocks per object (quad): a cluster
constexpr int QD_NT = 256;      // threads per block (quad)
constexpr int QD_NW = QD_NT / 32;
constexpr int QD_HR = 64;       // rows of hp staged at once (quad): four m-tiles

// Start the copies of C chunk ch (TG_KC columns) of the block's na A rows
// (from `a`) and of wb[o]'s Hp rows (from `w`) into stage st, A rows at 0
// and B rows at TG_RT, all at stride TG_LD, completing on `bar`: where vec,
// one bulk copy a row (row j by lane j / NW of warp j % NW, so that every
// warp issues a few) and one arrival, that of row 0's thread, which
// announces all of the chunk's bytes (a bulk copy may land before it: the
// transaction count goes below zero, and the phase waits for the arrival);
// else 4-byte cp.asyncs by every thread, one arrival each.
// Columns past C are zeroed with plain stores, which the next
// __syncthreads publishes.
__device__ inline void tg_start(float* st, const float* a, int na, const float* w, int Hp, int C,
                                int ch, int vec, uint64_t* bar) {
  const int c0 = ch * TG_KC, cw = min(TG_KC, C - c0);
  const int rows = na + Hp;
  if (vec) {
    const int j = (threadIdx.x & 31) * NW + (threadIdx.x >> 5);
    if (j == 0) mbar_arrive_expect_tx(bar, 4u * cw * rows);
    if (j < rows) {
      const bool is_a = j < na;
      float* d = st + (is_a ? j : TG_RT + j - na) * TG_LD;
      for (int q = cw; q < TG_KC; ++q) d[q] = 0.0f;
      fence_proxy_async();
      bulk_copy_g2s(d, (is_a ? a + (size_t)j * C : w + (size_t)(j - na) * C) + c0, 4u * cw, bar);
    }
  } else {
    for (int i = threadIdx.x; i < rows * TG_KC; i += NT) {
      const int j = i / TG_KC, q = i % TG_KC;
      const bool is_a = j < na;
      float* d = st + (is_a ? j : TG_RT + j - na) * TG_LD + q;
      if (q < cw) cp_async4(d, (is_a ? a + (size_t)j * C : w + (size_t)(j - na) * C) + c0 + q);
      else *d = 0.0f;
    }
    cp_async_mbar_arrive(bar);
  }
}

// Floats of part_tg_kernel's shared memory before its mbarriers: the ring,
// then the rows a Gram tile's A reads past the last stage's B rows (its
// tiles reach ceil(Hp / TG_RT) TG_RT rows), or the warps' partials if more.
__host__ __device__ inline int tg_floats(int nb, int hp) {
  const int slack = max(0, (hp + TG_RT - 1) / TG_RT * TG_RT - 8 * nb);
  return max((TG_STAGES * (TG_RT + 8 * nb) + slack) * TG_LD, NW * TG_RT * 8 * nb);
}

// t = gt[o] wb[o]^T and g = wb[o] wb[o]^T as one product on the tensor cores
// in 3xTF32: A is the R rows of gt[o] followed by the Hp rows of wb[o], B is
// wb[o] (N = Hp padded to 8 NB), K = C. A block owns TG_RT rows of A: one of
// the ceil(R / TG_RT) tiles of gt[o], which writes t, or one of the ceil(Hp /
// TG_RT) tiles of wb[o], which writes g and reads its A rows from the B rows
// it stages anyway; one code path.
//
// Bound: bytes (21.4 MB at the probe's shape, 6.4 us at 3.35 TB/s; the
// products in 3xTF32 2.0 us at the dense TF32 rate, 3.1 us as padded to the
// tiles here). At the probe's shape (R = 120, Hp = 33) an object has three gt
// tiles and one Gram tile: 256 blocks, two resident per SM (97 KB of shared
// memory, registers under __launch_bounds__(NT, 2)), so the grid is one wave.
// C streams in chunks of TG_KC columns through TG_STAGES stages, each on its
// own mbarrier: a bulk copy per row where C % 4 == 0 and gt, wb are 16-byte
// aligned (4-byte cp.asyncs else). A stage is refilled right after the
// barrier that follows its last reads, one barrier per chunk, so one chunk is
// in flight while the warps multiply the other. Measured on an H100
// (scripts/part_tg_parts.py, PERF.md), every chunk costs a fixed time beyond
// its bytes and products: 128-column chunks in two stages took under three
// quarters of the time of 64-column chunks in four (and four stages were no
// faster than two), and spreading the row copies over all warps, rather than
// the first three, took off another few percent. The warps split K: each
// takes two k-steps of a chunk and holds every (m-tile, n-tile) of the tile,
// so each element of A and of B in shared memory is read by one warp once,
// and split where it is read (split_a: an add and a mask); a pre-split copy
// of B would split as many elements and add a pass and a barrier. The three
// mma.sync of a tile accumulate in place, small products first. The row
// stride of 4 mod 32 floats puts a fragment's 32 reads (row g, column t) in
// 32 banks. Rows past nv and past Hp hold whatever the stage held: a row of A
// meets only its own row of the product, a row of B its own column, and
// neither is stored. At the end the warps' partials meet in shared memory
// (the ring, reused) and are summed in warp order, so the result does not
// depend on timing, and whole rows of t or g are stored, coalesced.
template <int NB>
__global__ void __launch_bounds__(NT, 2)
part_tg_kernel(const float* __restrict__ gt, const float* __restrict__ wb,
               float* __restrict__ t, float* __restrict__ g, int R, int Hp, int C,
               int vec) {
  extern __shared__ __align__(16) float sm[];
  constexpr int NP = 8 * NB;                     // B rows: Hp padded
  constexpr int STAGE = (TG_RT + NP) * TG_LD;    // floats: A rows, then B rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fr = lane >> 2, fc = lane & 3;       // fragment row and column
  const int o = blockIdx.y;
  const int n_rt = (R + TG_RT - 1) / TG_RT;      // gt's tiles, then wb's
  const bool gram = (int)blockIdx.x >= n_rt;
  const int r0 = ((int)blockIdx.x - (gram ? n_rt : 0)) * TG_RT;
  const int nv = min(TG_RT, (gram ? Hp : R) - r0);
  const int na = gram ? 0 : nv;                  // A rows copied
  const float* wo = wb + (size_t)o * Hp * C;
  const float* ao = gt + ((size_t)o * R + r0) * C;
  const int nch = (C + TG_KC - 1) / TG_KC;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + tg_floats(NB, Hp));

  if (tid == 0) {
    for (int s = 0; s < TG_STAGES; ++s) mbar_init(full + s, vec ? 1 : NT);
    mbar_init_fence();
  }
  __syncthreads();
  for (int s = 0; s < min(TG_STAGES - 1, nch); ++s)
    tg_start(sm + s * STAGE, ao, na, wo, Hp, C, s, vec, full + s);

  float acc[TG_MT][NB][4];
#pragma unroll
  for (int m = 0; m < TG_MT; ++m)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;

  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();    // chunk ch - 1 is consumed: its stage takes chunk ch + TG_STAGES - 1
    const int next = ch + TG_STAGES - 1, sn = next % TG_STAGES, sc = ch % TG_STAGES;
    if (next < nch) tg_start(sm + sn * STAGE, ao, na, wo, Hp, C, next, vec, full + sn);
    mbar_wait(full + sc, (ch / TG_STAGES) & 1);
    const float* bs = sm + sc * STAGE + TG_RT * TG_LD;
    const float* as = gram ? bs + r0 * TG_LD : bs - TG_RT * TG_LD;
    const int cw = min(TG_KC, C - ch * TG_KC);
    for (int ks = warp; 8 * ks < cw; ks += NW) {
      const int k = 8 * ks + fc;
      // a0..a3 = A[fr][k], A[fr + 8][k], A[fr][k + 4], A[fr + 8][k + 4]
      uint32_t ah[TG_MT][4], al[TG_MT][4];
#pragma unroll
      for (int m = 0; m < TG_MT; ++m) {
        const float* ar = as + (16 * m + fr) * TG_LD + k;
        split_a(ar[0], ah[m][0], al[m][0]);
        split_a(ar[8 * TG_LD], ah[m][1], al[m][1]);
        split_a(ar[4], ah[m][2], al[m][2]);
        split_a(ar[8 * TG_LD + 4], ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        // b0, b1 = B[k][n] = wb[n][k] and wb[n][k + 4], n = 8 j + fr
        const float* br = bs + (8 * j + fr) * TG_LD + k;
        uint32_t bh[2], bl[2];
        split_a(br[0], bh[0], bl[0]);
        split_a(br[4], bh[1], bl[1]);
#pragma unroll
        for (int m = 0; m < TG_MT; ++m) {
          mma_tf32(acc[m][j], al[m], bh);
          mma_tf32(acc[m][j], ah[m], bl);
          mma_tf32(acc[m][j], ah[m], bh);
        }
      }
    }
  }

  __syncthreads();      // every warp is done with the ring: it takes the partials
  float* part = sm + warp * TG_RT * NP;          // [TG_RT][NP] per warp
#pragma unroll
  for (int m = 0; m < TG_MT; ++m)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[(16 * m + fr + 8 * (i >> 1)) * NP + 8 * j + 2 * fc + (i & 1)] = acc[m][j][i];
  __syncthreads();
  float* out = gram ? g + ((size_t)o * Hp + r0) * Hp : t + ((size_t)o * R + r0) * Hp;
  for (int i = tid; i < nv * Hp; i += NT) {      // the tile's rows are contiguous
    const int m = i / Hp, n = i - m * Hp;
    float v = 0.0f;
    for (int w = 0; w < NW; ++w) v += sm[(w * TG_RT + m) * NP + n];
    out[i] = v;
  }
}

template <int NB>
int launch_tg(const float* gt, const float* wb, float* t, float* g, int O, int R, int Hp,
              int C, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * tg_floats(NB, Hp) + (int)sizeof(uint64_t) * TG_STAGES;
  cudaError_t err = cudaFuncSetAttribute(
      part_tg_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = C % 4 == 0 && aligned16(gt) && aligned16(wb);
  dim3 grid((R + TG_RT - 1) / TG_RT + (Hp + TG_RT - 1) / TG_RT, O);
  part_tg_kernel<NB><<<grid, NT, smem, stream>>>(gt, wb, t, g, R, Hp, C, vec);
  return (int)cudaGetLastError();
}

// dW[o] = dt[o]^T gt[o], computed as its transpose dW[o]^T = gt[o]^T dt[o]
// (M = the block's DW_CT columns of C, N = Hp padded to 8 NB, K = the rays)
// on the tensor cores in 3xTF32: each gt element is split once, where its
// warp reads it, and dt[o] is split once per block, into the order of
// mma.sync's B fragments (zero past R and Hp), so that a warp reads a B
// fragment with one 128-bit load.
//
// Bound: bytes (21 MB at the probe's shape, 6.3 us at 3.35 TB/s). A block
// owns (object, 128 columns of C): 256 blocks at the probe's shape, two
// resident per SM (101 KB of shared memory each), so the whole grid is one
// wave and every block's copies are in flight from the start. dt's loads go
// out first (behind the gt stream they would hold up the first products);
// each thread then stores whole B fragments of it, so the stores meet no
// bank conflicts. The gt slice (up to DW_RC rays at a time) comes in
// DW_G-ray cp.async groups, 16 bytes a thread where C allows; the warps
// multiply each group as it lands, while the later ones are still in flight.
// Each warp owns 16 columns of the slice and all Hp rows. gt's row stride of
// 8 mod 32 floats makes its fragment reads hit 32 different banks; columns
// past C are never stored.
template <int NB>
__global__ void __launch_bounds__(NT, 2)
part_dw_kernel(const float* __restrict__ dt, const float* __restrict__ gt,
               float* __restrict__ dw, int R, int Hp, int C, int rc, int vec) {
  extern __shared__ __align__(16) float sm[];
  float* gs = sm;                                                // [rc][DW_LDG]
  uint32_t* ds = reinterpret_cast<uint32_t*>(sm + rc * DW_LDG);  // dt, split B fragments
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int o = blockIdx.y, c0 = blockIdx.x * DW_CT;
  const int cw = min(DW_CT, C - c0);
  const int m0 = warp * 16;
  const float* dto = dt + (size_t)o * R * Hp;
  const float* gto = gt + (size_t)o * R * C + c0;
  float c[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.0f;

  for (int r0 = 0; r0 < R; r0 += rc) {
    const int nr = min(rc, R - r0), rp = (nr + 7) & ~7;
    const int groups = (nr + DW_G - 1) / DW_G;
    if (r0 > 0) __syncthreads();        // the previous rays are consumed
    // dt into split B fragments: a task is one lane's fragment of one
    // (k-step, n-tile), b0 = dt[8 ks + t][8 nt + g] and b1 four rays on,
    // stored as {b0 hi, b1 hi, b0 lo, b1 lo} with one 128-bit store;
    // DW_B tasks' loads in flight per thread
    const int ntask = (rp / 8) * NB * 32;
    for (int i0 = tid; i0 < ntask; i0 += NT * DW_B) {
      float v[DW_B][2];
#pragma unroll
      for (int u = 0; u < DW_B; ++u) {
        const int i = i0 + u * NT, ln = i & 31, nt = (i >> 5) % NB, ks = (i >> 5) / NB;
        const int r = 8 * ks + (ln & 3), h = 8 * nt + (ln >> 2);
        const bool ok = i < ntask && h < Hp;
        v[u][0] = ok && r < nr ? __ldg(dto + (size_t)(r0 + r) * Hp + h) : 0.0f;
        v[u][1] = ok && r + 4 < nr ? __ldg(dto + (size_t)(r0 + r + 4) * Hp + h) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < DW_B; ++u) {
        const int i = i0 + u * NT;
        if (i >= ntask) break;
        uint4 f;
        split(v[u][0], f.x, f.z);
        split(v[u][1], f.y, f.w);
        reinterpret_cast<uint4*>(ds)[i] = f;
      }
    }
    for (int gi = 0; gi < groups; ++gi) {
      const int ra = gi * DW_G, rb = min(nr, ra + DW_G);
      if (vec) {
        for (int i = tid; i < (rb - ra) * (DW_CT / 4); i += NT) {
          const int r = ra + i / (DW_CT / 4), q = (i % (DW_CT / 4)) * 4;
          float* d = gs + r * DW_LDG + q;
          if (q < cw) cp_async16(d, gto + (size_t)(r0 + r) * C + q);
          else d[0] = d[1] = d[2] = d[3] = 0.0f;
        }
      } else {
        for (int i = tid; i < (rb - ra) * DW_CT; i += NT) {
          const int r = ra + i / DW_CT, q = i % DW_CT;
          if (q < cw) cp_async4(gs + r * DW_LDG + q, gto + (size_t)(r0 + r) * C + q);
          else gs[r * DW_LDG + q] = 0.0f;
        }
      }
      cp_async_commit();
    }
    for (int i = tid; i < (rp - nr) * DW_LDG; i += NT) gs[nr * DW_LDG + i] = 0.0f;
    for (int gi = 0; gi < groups; ++gi) {
      cp_async_wait_pending(groups - 1 - gi);
      __syncthreads();
      const int ks1 = min(rp, (gi + 1) * DW_G) / 8;
      for (int ks = gi * DW_G / 8; ks < ks1; ++ks) {
        const float* ar = gs + (8 * ks + t) * DW_LDG + m0 + g;
        uint32_t ah[4], al[4];
        split(ar[0], ah[0], al[0]);
        split(ar[8], ah[1], al[1]);
        split(ar[4 * DW_LDG], ah[2], al[2]);
        split(ar[4 * DW_LDG + 8], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint4 u = reinterpret_cast<const uint4*>(ds + (ks * NB + j) * 128)[lane];
          const uint32_t bh[2] = {u.x, u.y}, bl[2] = {u.z, u.w};
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(d, al, bh);
          mma_tf32(d, ah, bl);
          mma_tf32(d, ah, bh);
#pragma unroll
          for (int i = 0; i < 4; ++i) c[j][i] += d[i];
        }
      }
    }
  }
  // C fragment (m, n) of dW^T is dW[o][n][c0 + m]
  float* out = dw + (size_t)o * Hp * C + c0;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + 8 * (i >> 1), n = 8 * j + 2 * t + (i & 1);
      if (m < cw && n < Hp) out[(size_t)n * C + m] = c[j][i];
    }
}

template <int NB>
int launch_dw(const float* dt, const float* gt, float* dw, int O, int R, int Hp, int C,
              cudaStream_t stream) {
  const int rc = min(DW_RC, (R + 7) & ~7);
  const size_t smem = sizeof(float) * rc * (DW_LDG + 16 * NB);   // dt: hi and lo
  cudaError_t err = cudaFuncSetAttribute(
      part_dw_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = C % 4 == 0 && aligned16(gt);
  dim3 grid((C + DW_CT - 1) / DW_CT, O);
  part_dw_kernel<NB><<<grid, NT, smem, stream>>>(dt, gt, dw, R, Hp, C, rc, vec);
  return (int)cudaGetLastError();
}

// z[o] = hp[o] g with g = wb[o] wb[o]^T, by a cluster of QD_CL blocks per
// object. Rank q of the cluster owns the q-th slice of C (cs columns, a
// multiple of 8; 256 at the probe's C = 512) and the q-th run of rows of hp
// and z (rs = ceil(R / QD_CL); 60 at R = 120). Either may be empty (C or R
// smaller than the cluster): the rank still adds its partial, of zeros.
//
// Bound: bytes (wb 4.33 MB, hp and z 1.01 MB each at the probe's shape,
// 1.9 us at 3.35 TB/s; the Gram in 3xTF32 0.4 us at the dense TF32 rate).
// One block per object would put 64 blocks on 132 SMs, each streaming its
// object's 67.6 KB alone; here 128 blocks of 8 warps take an SM each, every
// block's copies in flight from its first instructions. The work of a block
// is small and done once, so its time is the data's arrival (~2.3 us on an
// H100) and then a chain of short phases, each made as short as the design
// could make it (PERF.md: clusters of 4 blocks of 4 warps, 256 blocks, ran
// slower than 2 of 8, and 4 of 8 do not all fit at once):
//  * At entry the block starts the copies of its slice of wb[o] (the Hp
//    rows, TG_KC columns a chunk, through part_tg's two stages: one bulk
//    copy a row on the stage's mbarrier where C % 4 == 0 and wb is 16-byte
//    aligned, else 4-byte cp.asyncs) and of its hp rows (4-byte cp.asyncs, a
//    row per warp at a time, as a row of 33 floats is not 16-byte aligned),
//    which land while the Gram is formed.
//  * The Gram partial g_q = wb[:, slice] wb[:, slice]^T runs on mma.sync
//    m16n8k8 in 3xTF32 (as part_tg's Gram tile), M = Hp padded to 16-row
//    m-tiles, N = Hp padded to 8 NB. A and B are the same rows, so B's
//    fragments are A's registers (n-tile j is half of m-tile j / 2): each
//    warp loads and splits only A. g is symmetric, so only the tiles on or
//    right of the diagonal blocks (n-tile j >= 2 m) are multiplied, 9 of 15
//    at Hp = 33, and a tile right of them is stored twice, as itself and
//    mirrored. The warps split K (two k-steps a chunk each) and each holds
//    all of its tiles; they store their partials in fragment order (16 bytes
//    a lane, no bank conflict), and each lane sums, in warp order, the
//    warps' partials of its own fragment positions in a tile of its warp's
//    share into its rank's slot of gx. The 4 mod 32 row stride puts a
//    fragment's reads in 32 banks.
//  * Exchange: gx holds a partial per rank, [QD_CL][Hp][LDG]. One thread
//    copies the block's own, by one bulk copy from shared memory to the
//    cluster's (cp.async.bulk.shared::cluster.shared::cta), into the same
//    slot of every peer, completing on the peer's mbarrier; each block waits
//    on its own mbarrier and sums the slots in rank order 0 .. QD_CL - 1
//    into gf, so that every block has the same g, whatever the timing. The
//    cluster barriers left are relaxed arrivals waited for long after: one
//    once the block's mbarriers are set up (waited for before the copies,
//    so that none meets an unset mbarrier), one once its peers' partials
//    have landed (waited for at exit, so that no block leaves while a copy
//    may still read its shared memory). Cluster barriers with release and
//    acquire around reads of the peers' shared memory (ld.shared::cluster)
//    took over three times as long on an H100 (PERF.md).
//  * z = hp g for the block's rows on the tensor cores too, in 3xTF32 (B[k][n]
//    = g[n][k], g being symmetric; k >= Hp masked to 0 in the last k-step):
//    a warp per (m-tile, half of the n-tiles), the tile then stored through
//    shared memory as one contiguous, coalesced run of rows. Rows past QD_HR
//    are staged in further runs after the first. On FP32 FMAs z took about
//    a quarter of the kernel on an H100 (PERF.md).
// Rows of a stage past Hp hold whatever it held: a row of A meets only its
// own row of the product and its own column through B, and neither is
// stored; columns past the slice up to the last k-step are zeroed.

// gx's, gf's and hs' row stride: at least Hp, 4 mod 8, so that a fragment's
// reads (8 rows by 4 columns) fall in 32 banks
__host__ __device__ inline int quad_ldg(int hp) { return (hp + 3) / 8 * 8 + 4; }

// Offsets (floats) in part_quad_kernel's shared memory: the ring of stages
// (each 16 ceil(Hp / 16) rows of TG_LD); after the last chunk the same floats
// take the warps' partials in fragment order, then a run of z's rows; the
// ranks' partials gx [QD_CL][Hp][LDG], gf [8 NB][LDG] and up to QD_HR hp rows
// hs (rounded up to 16) [.][LDG]; the stages' mbarriers and the exchange's
// (bars).
struct QuadSmem {
  int gx, gf, hs, bars;
};

__host__ __device__ inline QuadSmem quad_smem(int hp, int cs, int rs) {
  const int stages = min(TG_STAGES, (cs + TG_KC - 1) / TG_KC);
  const int nb = (hp + 7) / 8, mt = (nb + 1) / 2, ldg = quad_ldg(hp), hr = min(rs, QD_HR);
  const int tiles = mt * nb - mt * (mt - 1);     // (m, j) with j >= 2 m
  QuadSmem s;
  s.gx = max(max(stages * 16 * mt * TG_LD, QD_NW * tiles * 128), round4(hr * hp));
  s.gf = s.gx + QD_CL * hp * ldg;
  s.hs = s.gf + 8 * nb * ldg;
  s.bars = s.hs + (hr + 15) / 16 * 16 * ldg;
  return s;
}

// Start the copies of the cw columns of wb's Hp rows at `w` (row stride C)
// into stage st, at row stride TG_LD, completing on `bar`: where vec, one
// bulk copy a row (row j by lane j / QD_NW of warp j % QD_NW) and one
// arrival, that of row 0's thread, which announces the chunk's bytes; else
// 4-byte cp.asyncs by every thread, one arrival each. The columns from cw
// to the last k-step's end are zeroed with plain stores, which the next
// __syncthreads publishes.
__device__ inline void quad_start(float* st, const float* w, int Hp, int C, int cw, int vec,
                                  uint64_t* bar) {
  const int cp = (cw + 7) & ~7;
  if (vec) {
    const int j = (threadIdx.x & 31) * QD_NW + (threadIdx.x >> 5);
    if (j == 0) mbar_arrive_expect_tx(bar, 4u * cw * Hp);
    if (j < Hp) {
      float* d = st + j * TG_LD;
      for (int q = cw; q < cp; ++q) d[q] = 0.0f;
      fence_proxy_async();
      bulk_copy_g2s(d, w + (size_t)j * C, 4u * cw, bar);
    }
  } else {
    for (int i = threadIdx.x; i < Hp * cp; i += QD_NT) {
      const int j = i / cp, q = i - j * cp;
      float* d = st + j * TG_LD + q;
      if (q < cw) cp_async4(d, w + (size_t)j * C + q);
      else *d = 0.0f;
    }
    cp_async_mbar_arrive(bar);
  }
}

// Start the 4-byte cp.asyncs of n rows of hp (Hp floats each, contiguous at
// `h`) into hs at row stride ldg, a warp per row, as one group.
__device__ inline void quad_rows(float* hs, const float* h, int n, int Hp, int ldg) {
  for (int r = threadIdx.x >> 5; r < n; r += QD_NW)
    for (int c = threadIdx.x & 31; c < Hp; c += 32) cp_async4(hs + r * ldg + c, h + r * Hp + c);
  cp_async_commit();
}

// z's rows m0 .. m0 + 15 of a run (nb rows) by n-tiles J0 .. J0 + JN - 1, on
// the tensor cores in 3xTF32: A = hs, B[k][n] = g[n][k] (g is symmetric),
// K = Hp padded to 8 NB, k >= Hp (only in the last k-step) masked to 0, as
// hs' and gf's rows end there; into zs [nb][Hp]. J0 and JN are constants,
// so that no branch separates the tiles' chains of mma.sync.
template <int NB, int J0, int JN>
__device__ inline void quad_z_tile(const float* hs, const float* gf, int ldg, int Hp, int m0,
                                   int nb, float* zs) {
  const int lane = threadIdx.x & 31, fr = lane >> 2, fc = lane & 3;
  float c[JN][4];
#pragma unroll
  for (int j = 0; j < JN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < NB; ++ks) {
    const int k = 8 * ks + fc;
    const bool k0 = ks < NB - 1 || k < Hp, k4 = ks < NB - 1 || k + 4 < Hp;
    const float* ar = hs + (m0 + fr) * ldg + k;
    uint32_t ah[4], al[4];
    split_a(k0 ? ar[0] : 0.0f, ah[0], al[0]);
    split_a(k0 ? ar[8 * ldg] : 0.0f, ah[1], al[1]);
    split_a(k4 ? ar[4] : 0.0f, ah[2], al[2]);
    split_a(k4 ? ar[8 * ldg + 4] : 0.0f, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const float* br = gf + (8 * (J0 + j) + fr) * ldg + k;
      uint32_t bh[2], bl[2];
      split_a(k0 ? br[0] : 0.0f, bh[0], bl[0]);
      split_a(k4 ? br[4] : 0.0f, bh[1], bl[1]);
      mma_tf32(c[j], al, bh);
      mma_tf32(c[j], ah, bl);
      mma_tf32(c[j], ah, bh);
    }
  }
#pragma unroll
  for (int j = 0; j < JN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + fr + 8 * (i >> 1), n = 8 * (J0 + j) + 2 * fc + (i & 1);
      if (r < nb && n < Hp) zs[r * Hp + n] = c[j][i];
    }
}

template <int NB>
__global__ void __launch_bounds__(QD_NT, 2)
part_quad_kernel(const float* __restrict__ hp, const float* __restrict__ wb,
                 float* __restrict__ z, int R, int Hp, int C, int cs, int rs, int vec) {
  extern __shared__ __align__(16) float sm[];
  constexpr int MT = (NB + 1) / 2;               // 16-row m-tiles of Hp
  constexpr int STAGE = 16 * MT * TG_LD;         // floats
  constexpr int TILES = MT * NB - MT * (MT - 1); // (m, j) with j >= 2 m
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fr = lane >> 2, fc = lane & 3;       // fragment row and column
  const int o = blockIdx.x / QD_CL, q = blockIdx.x - o * QD_CL;   // object, rank
  const int ldg = quad_ldg(Hp);
  const QuadSmem L = quad_smem(Hp, cs, rs);
  const int hl = Hp * ldg;                       // floats of a partial
  float* gx = sm + L.gx;
  float* gp = gx + q * hl;                       // this rank's partial, in its slot
  float* gf = sm + L.gf;
  float* hs = sm + L.hs;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* xbar = full + TG_STAGES;             // the peers' partials have landed
  const int width = max(0, min(cs, C - q * cs));   // this rank's columns
  const int nr = max(0, min(rs, R - q * rs));      // and rows
  const int nch = (width + TG_KC - 1) / TG_KC;
  const float* wo = wb + (size_t)o * Hp * C + (size_t)q * cs;
  const float* ho = hp + ((size_t)o * R + (size_t)q * rs) * Hp;
  float* zo = z + ((size_t)o * R + (size_t)q * rs) * Hp;

  if (tid == 0) {
    for (int s = 0; s < TG_STAGES; ++s) mbar_init(full + s, vec ? 1 : QD_NT);
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  cluster_arrive_relaxed();   // this block's mbarriers are set up (waited for before the exchange)
  for (int s = 0; s < min(TG_STAGES - 1, nch); ++s)
    quad_start(sm + s * STAGE, wo + s * TG_KC, Hp, C, min(TG_KC, width - s * TG_KC), vec, full + s);
  quad_rows(hs, ho, min(nr, QD_HR), Hp, ldg);

  float gq[MT][NB][4];                            // the tiles with j >= 2 m
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) gq[m][j][i] = 0.0f;

  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();    // the warps are done with chunk ch - 1: its stage takes chunk ch + 1
    const int next = ch + TG_STAGES - 1, sn = next % TG_STAGES, sc = ch % TG_STAGES;
    if (next < nch)
      quad_start(sm + sn * STAGE, wo + next * TG_KC, Hp, C, min(TG_KC, width - next * TG_KC), vec,
                 full + sn);
    mbar_wait(full + sc, (ch / TG_STAGES) & 1);
    const float* as = sm + sc * STAGE;
    const int cw = min(TG_KC, width - ch * TG_KC);
    for (int ks = warp; 8 * ks < cw; ks += QD_NW) {
      const int k = 8 * ks + fc;
      // a0..a3 = wb[16 m + fr][k], [16 m + 8 + fr][k], [16 m + fr][k + 4], [16 m + 8 + fr][k + 4]
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* ar = as + (16 * m + fr) * TG_LD + k;
        split_a(ar[0], ah[m][0], al[m][0]);
        split_a(ar[8 * TG_LD], ah[m][1], al[m][1]);
        split_a(ar[4], ah[m][2], al[m][2]);
        split_a(ar[8 * TG_LD + 4], ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 2 * m; j < NB; ++j) {
          // b0, b1 = wb[8 j + fr][k], [8 j + fr][k + 4]: a0, a2 (j even) or a1, a3
          // (j odd) of m-tile j / 2
          const int mb = j >> 1, hb = j & 1;
          const uint32_t bh[2] = {ah[mb][hb], ah[mb][hb + 2]};
          const uint32_t bl[2] = {al[mb][hb], al[mb][hb + 2]};
          mma_tf32(gq[m][j], al[m], bh);
          mma_tf32(gq[m][j], ah[m], bl);
          mma_tf32(gq[m][j], ah[m], bh);
        }
    }
  }

  __syncthreads();      // every warp is done with the ring: it takes the partials
  float4* part = reinterpret_cast<float4*>(sm);  // [QD_NW][TILES][32], fragment order
  {
    int t = 0;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 2 * m; j < NB; ++j, ++t)
        part[(warp * TILES + t) * 32 + lane] =
            make_float4(gq[m][j][0], gq[m][j][1], gq[m][j][2], gq[m][j][3]);
  }
  __syncthreads();
  {
    int t = 0;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 2 * m; j < NB; ++j, ++t) {
        if (t % QD_NW != warp) continue;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int w = 0; w < QD_NW; ++w) {
          const float4 u = part[(w * TILES + t) * 32 + lane];
          v[0] += u.x;
          v[1] += u.y;
          v[2] += u.z;
          v[3] += u.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * m + fr + 8 * (i >> 1), c = 8 * j + 2 * fc + (i & 1);
          if (r < Hp && c < Hp) {
            gp[r * ldg + c] = v[i];
            if (j >= 2 * m + 2) gp[c * ldg + r] = v[i];   // its mirror is not multiplied
          }
        }
      }
  }
  fence_proxy_async();  // this thread's stores to gp, before the bulk copies read it
  __syncthreads();
  cluster_wait();       // every peer's mbarriers are set up
  if (tid == 0) {       // gp to the same slot of every peer
    mbar_arrive_expect_tx(xbar, 4u * (QD_CL - 1) * hl);
    for (int r = 1; r < QD_CL; ++r) bulk_copy_s2peer(gp, 4u * hl, xbar, (q + r) % QD_CL);
  }
  mbar_wait(xbar, 0);   // every peer's partial is in its slot
  cluster_arrive_relaxed();   // so the copies from the peers are done (waited for at exit)
  // g = the ranks' partials summed in rank order
  for (int i = tid; i < hl / 4; i += QD_NT) {
    float4 v = reinterpret_cast<const float4*>(gx)[i];
#pragma unroll
    for (int r = 1; r < QD_CL; ++r) {
      const float4 u = reinterpret_cast<const float4*>(gx + r * hl)[i];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    reinterpret_cast<float4*>(gf)[i] = v;
  }

  float* zs = sm;       // a run of z's rows [nb][Hp], in the ring
  for (int b0 = 0; b0 < nr; b0 += QD_HR) {
    const int nb = min(QD_HR, nr - b0);
    if (b0 > 0) {
      __syncthreads();  // every warp is done with the last run's hs and zs
      quad_rows(hs, ho + (size_t)b0 * Hp, nb, Hp, ldg);
    }
    cp_async_wait<0>();
    __syncthreads();    // g and the run's hp rows are whole
    // z: an item is an m-tile of the run by half of the n-tiles (all of them
    // where NB = 1)
    constexpr int JH = (NB + 1) / 2, HN = NB > 1 ? 2 : 1;
    for (int item = warp; item < HN * ((nb + 15) / 16); item += QD_NW) {
      const int m0 = 16 * (item / HN);
      if (item % HN == 0) quad_z_tile<NB, 0, JH>(hs, gf, ldg, Hp, m0, nb, zs);
      else quad_z_tile<NB, JH, (NB > 1 ? NB - JH : 1)>(hs, gf, ldg, Hp, m0, nb, zs);
    }
    __syncthreads();    // the run's z is whole: stored as one contiguous run
    for (int i = tid; i < nb * Hp; i += QD_NT) zo[(size_t)b0 * Hp + i] = zs[i];
  }
  cluster_wait();       // every peer's copy of this block's partial is done: it may exit
}

using QuadKernel = void (*)(const float*, const float*, float*, int, int, int, int, int, int);

struct QuadLaunch {
  QuadKernel kernel;
  int cs, rs;           // columns of C and rows of hp per rank
  size_t smem;          // dynamic shared memory, bytes
};

// pr_part_quad's arguments checked, the launch it makes for them chosen and
// its shared memory opted into: cudaSuccess, or the CUDA error code with
// which pr_part_quad refuses them.
int quad_setup(QuadLaunch& l, int O, int R, int Hp, int C) {
  if (O < 1 || R < 1 || C < 1 || Hp < 1 || Hp > 64) return (int)cudaErrorInvalidValue;
  l.cs = ((C + QD_CL - 1) / QD_CL + 7) & ~7;
  l.rs = (R + QD_CL - 1) / QD_CL;
  switch ((Hp + 7) / 8) {   // the 8-column tiles of Hp
    case 1: l.kernel = part_quad_kernel<1>; break;
    case 2: l.kernel = part_quad_kernel<2>; break;
    case 3: l.kernel = part_quad_kernel<3>; break;
    case 4: l.kernel = part_quad_kernel<4>; break;
    case 5: l.kernel = part_quad_kernel<5>; break;
    case 6: l.kernel = part_quad_kernel<6>; break;
    case 7: l.kernel = part_quad_kernel<7>; break;
    default: l.kernel = part_quad_kernel<8>; break;
  }
  l.smem = sizeof(float) * quad_smem(Hp, l.cs, l.rs).bars + sizeof(uint64_t) * (TG_STAGES + 1);
  return (int)cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)l.smem);
}

}  // namespace

extern "C" {

// schedule: 0 grid, 1 objtile, 2 persistent (n_blocks blocks)
int pr_ens_gemm(const float* x, const float* w, float* out, int O, int N, int K,
                int H, int schedule, int use_sin, int obj_tile, int n_blocks,
                void* stream) {
  GemmArgs g;
  GemmLaunch l;
  const int err = gemm_setup(g, l, x, w, out, O, N, K, H, schedule, use_sin != 0, obj_tile,
                             n_blocks);
  if (err != cudaSuccess) return err;
  const GemmKernel kernel = l.kernel;
  kernel<<<l.grid, l.threads, l.smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// The launch pr_ens_gemm makes for these arguments, without making it:
// out[0..3] = its blocks resident per SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor), threads per block, dynamic shared memory in bytes, blocks.
int pr_ens_gemm_occupancy(int O, int N, int K, int H, int schedule, int use_sin,
                          int obj_tile, int n_blocks, int* out) {
  GemmArgs g;
  GemmLaunch l;
  const int err = gemm_setup(g, l, nullptr, nullptr, nullptr, O, N, K, H, schedule,
                             use_sin != 0, obj_tile, n_blocks);
  if (err != cudaSuccess) return err;
  out[1] = l.threads;
  out[2] = (int)l.smem;
  out[3] = (int)(l.grid.x * l.grid.y);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, l.kernel, l.threads, l.smem);
}

int pr_launch_nop(const float* x, float* y, int n, void* stream) {
  if (n < 1 || ((uintptr_t)x & 3) || ((uintptr_t)y & 3)) return (int)cudaErrorInvalidValue;
  const int hx = (int)((16 - ((uintptr_t)x & 15)) & 15) / 4;
  const int hy = (int)((16 - ((uintptr_t)y & 15)) & 15) / 4;
  // a thread per float4, whole warps, at most NT a block, NOP_V float4s each
  const int units = (n + 3) / 4, threads = min(NT, (units + 31) / 32 * 32);
  const int blocks = (units + NOP_V * threads - 1) / (NOP_V * threads);
  launch_nop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(x, y, n,
                                                                 hx == hy ? min(hx, n) : -1);
  return (int)cudaGetLastError();
}

// xs [S, O, R, DX], w0 [O, DX, K], out [S, O, H]
int pr_slab_stream(const float* xs, const float* w0, float* out, int S, int O,
                   int R, int DX, int K, int H, int obj_tile, void* stream) {
  if (S < 1 || O < 1 || obj_tile < 1 || H > K || ((R * DX) % 4) != 0 || !aligned16(xs))
    return (int)cudaErrorInvalidValue;
  dim3 grid((O + obj_tile - 1) / obj_tile, S);
  slab_stream_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(xs, w0, out, O, R * DX,
                                                           DX * K, H, obj_tile);
  return (int)cudaGetLastError();
}

// xs [S, O, N, DX], w0 [O, DX, K], w1 [O, K, H], w2 [O, H, H], out [S, O, H];
// one launch, a cluster of blocks per (step, object) pair (choose_cluster)
int pr_step_chain(const float* xs, const float* w0, const float* w1, const float* w2,
                  float* out, int S, int O, int N, int DX, int K, int H, int depth,
                  void* stream) {
  ChainArgs a;
  ChainLaunch l;
  int err = chain_setup(a, l, xs, w0, w1, w2, out, S, O, N, DX, K, H, depth);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(l.grid, NT, l.smem, a.cluster, attr, stream);
  err = (int)cudaLaunchKernelEx(&cfg, l.kernel, a);
  if (err != cudaSuccess) return err;
  return (int)cudaGetLastError();
}

// The launch pr_step_chain makes for these arguments, without making it:
// out[0..5] = its blocks resident per SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor), threads per block, dynamic shared memory in bytes, blocks,
// blocks per cluster, clusters resident at once.
int pr_step_chain_launch(int S, int O, int N, int DX, int K, int H, int depth, int* out) {
  ChainArgs a;
  ChainLaunch l;
  const int err = chain_setup(a, l, nullptr, nullptr, nullptr, nullptr, nullptr, S, O, N, DX, K,
                              H, depth);
  if (err != cudaSuccess) return err;
  out[0] = l.per_sm;
  out[1] = NT;
  out[2] = (int)l.smem;
  out[3] = (int)(l.grid.x * l.grid.y);
  out[4] = a.cluster;
  out[5] = l.active;
  return cudaSuccess;
}

// gt [O, R, C], wb [O, Hp, C] -> t [O, R, Hp], g [O, Hp, Hp]
int pr_part_tg(const float* gt, const float* wb, float* t, float* g, int O, int R,
               int Hp, int C, void* stream) {
  if (O < 1 || R < 1 || C < 1 || Hp < 1 || Hp > 64) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((Hp + 7) / 8) {   // the 8-column tiles of Hp
    case 1: return launch_tg<1>(gt, wb, t, g, O, R, Hp, C, s);
    case 2: return launch_tg<2>(gt, wb, t, g, O, R, Hp, C, s);
    case 3: return launch_tg<3>(gt, wb, t, g, O, R, Hp, C, s);
    case 4: return launch_tg<4>(gt, wb, t, g, O, R, Hp, C, s);
    case 5: return launch_tg<5>(gt, wb, t, g, O, R, Hp, C, s);
    case 6: return launch_tg<6>(gt, wb, t, g, O, R, Hp, C, s);
    case 7: return launch_tg<7>(gt, wb, t, g, O, R, Hp, C, s);
    default: return launch_tg<8>(gt, wb, t, g, O, R, Hp, C, s);
  }
}

// dt [O, R, Hp], gt [O, R, C] -> dw [O, Hp, C]
int pr_part_dw(const float* dt, const float* gt, float* dw, int O, int R, int Hp,
               int C, void* stream) {
  if (O < 1 || R < 1 || C < 1 || Hp < 1 || Hp > 64) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((Hp + 7) / 8) {   // the 8-column tiles of Hp
    case 1: return launch_dw<1>(dt, gt, dw, O, R, Hp, C, s);
    case 2: return launch_dw<2>(dt, gt, dw, O, R, Hp, C, s);
    case 3: return launch_dw<3>(dt, gt, dw, O, R, Hp, C, s);
    case 4: return launch_dw<4>(dt, gt, dw, O, R, Hp, C, s);
    case 5: return launch_dw<5>(dt, gt, dw, O, R, Hp, C, s);
    case 6: return launch_dw<6>(dt, gt, dw, O, R, Hp, C, s);
    case 7: return launch_dw<7>(dt, gt, dw, O, R, Hp, C, s);
    default: return launch_dw<8>(dt, gt, dw, O, R, Hp, C, s);
  }
}

// hp [O, R, Hp], wb [O, Hp, C] -> z [O, R, Hp]; one launch, a cluster of
// QD_CL blocks per object; a refused cluster launch returns its error
int pr_part_quad(const float* hp, const float* wb, float* z, int O, int R, int Hp,
                 int C, void* stream) {
  QuadLaunch l;
  int err = quad_setup(l, O, R, Hp, C);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(O * QD_CL), QD_NT, l.smem, QD_CL, attr, stream);
  const int vec = C % 4 == 0 && aligned16(wb);
  err = (int)cudaLaunchKernelEx(&cfg, l.kernel, hp, wb, z, R, Hp, C, l.cs, l.rs, vec);
  if (err != cudaSuccess) return err;
  return (int)cudaGetLastError();
}

// The launch pr_part_quad makes for these arguments, without making it:
// out[0..5] = its blocks resident per SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor), threads per block, dynamic shared memory in bytes, blocks,
// blocks per cluster, clusters resident at once.
int pr_part_quad_launch(int O, int R, int Hp, int C, int* out) {
  QuadLaunch l;
  int err = quad_setup(l, O, R, Hp, C);
  if (err != cudaSuccess) return err;
  out[1] = QD_NT;
  out[2] = (int)l.smem;
  out[3] = O * QD_CL;
  out[4] = QD_CL;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, l.kernel, QD_NT, l.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(QD_CL), QD_NT, l.smem, QD_CL, attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out + 5, l.kernel, &cfg);
}

}  // extern "C"

// K1 at compute_dtype="bf16" on Hopper's bf16 tensor cores:
// ff_fwd_bf16_kernel<H> at the tensor-core widths (FF_TC_WIDTHS).
//
// fused_field.cu includes this file only where FF_BF16 is defined (the
// build of csrc/fused_field_bf16.cu), inside its anonymous namespace and
// after fused_field_bwd_bf16.cuh: it uses that file's bf16 helpers (bf,
// bf_bits, lo_f, hi_f, smem_addr, ldsm_x4, ldsm_x4_t, mma_bf16) and
// fused_field.cu's Layout, ND, NF, ALPHA_SCALE, tc_shape, op, sigmoid_f and
// fwd_tile. The f32 build compiles none of it.
//
// Replaces the bf16 instantiation (`cdt`) of _fwd_kernel in
// openobj_tpu/ops/fused_field.py (:160, launched at :360) and computes what
// _fwd_body (:131-157) computes: the projection t . dirs^T in exact f32 (the
// FMA chain of the plain version), the bands with sinf, every other product
// (the trunk, the skip layer, mid2, the colour and clip heads' h and e2
// parts, the 1- and 3-wide alpha and colour heads) on bf16-rounded operands
// with f32 sums, biases added in f32, alpha, colour and hclip written in f32.
//
// What bounds it on an H100: one point's products are ~14k multiply-adds at
// h = 32 (~60k at h = 128), a few cycles of an SM at the bf16 rate, but its
// encode is 126 sinf (~24 instructions each) on the SIMT cores and its hclip
// row is 4h bytes to write. So the kernel is bound by the SIMT encode and
// by latency (dependent layers, a barrier between each), not by the tensor
// cores. What the design does about it:
//  * Every product operand lives in shared memory as bf16, rounded once where
//    it is written (the encode, each layer's epilogue: bias, ReLU, round to
//    nearest even, as .astype(bfloat16)), so a fragment is one ldmatrix and
//    no lo word or per-load rounding remains. Rows are padded to an odd
//    number of 16-byte units, so that ldmatrix's eight row addresses fall in
//    eight different bank groups.
//  * Products run mma.sync m16n8k16 bf16 with f32 sums, A (the activations,
//    [point][k]) by ldmatrix, B (the weights, [k][n] as packed) by
//    ldmatrix.trans. The k-steps accumulate in the mma's own f32
//    accumulator, which starts at the layer's bias: unlike K2 bf16, whose
//    steps start from zero and are added with round to nearest, because no
//    sign of K1's sums is a mask, the tensor cores' truncating accumulation
//    moves an output by ~1e-6 of its size over the deepest product (224),
//    and it ran 3% faster at both room_0 shapes on an H100 (PERF.md). Each
//    output tile has one owning warp: no atomics, deterministic.
//  * The weights become bf16 in the kernel, from the packed f32 weights
//    (ff_forward's signature carries no scratch for an image). Where the
//    image fits beside a 64-point chunk with two blocks an SM (h = 16 to
//    48), a block of 256 threads converts the object's image into shared
//    memory once for its tile; the two resident blocks' encodes and
//    products interleave. Otherwise (h = 64 to 128; 465 KB of f32 weights
//    at h = 128) the weights stream through a ring of two 64-row bf16 slabs,
//    one block of 512 threads an SM with chunks of 128 points, so that each
//    slab serves 128 rows: a slab's f32 rows come by one bulk copy (TMA) a
//    slab ahead, every thread rounds its pairs into the free bf16 stage,
//    one barrier a slab.
//  * The tile rule counts resident blocks
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor; ff_fwd_launch reports
//    the launch) and charges the image's conversion to each block.
//  * The alpha and colour heads are SIMT FMAs with four f32 partial sums on
//    the bf16 h3 and hcol rows (widening a bf16 is a shift). With the image
//    on chip hclip goes from the C fragments to a row-major staging buffer
//    and then to device memory in 16-byte stores, a warp writing 512
//    contiguous bytes; through the ring (no room to stage it) from the C
//    fragments, each pair of a row's 8 columns a whole 32-byte sector.

#ifdef __CUDACC__
__device__ inline void ldsm_x2_t(uint32_t (&r)[2], const bf* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}

// bf16(lo) in the low half, bf16(hi) in the high half (round to nearest even)
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
#else
inline uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)bf_bits(lo) | ((uint32_t)bf_bits(hi) << 16);
}
#endif

constexpr int FW_LE1 = 104;     // e1 row: t, bands 0-3 (87), 9 zero columns (k to 96), 8 of padding
constexpr int FW_LE2 = 56;      // e2 row: bands 4, 5 (42), 6 zero columns (k to 48), 8 of padding
constexpr int FW_SLAB = 64;     // rows of a weight slab in the ring
constexpr int FW_STAGES = 2;    // slabs the ring has in flight (f32 stages)
constexpr int FW_SUBS = 9;      // weight sub-matrices, below
constexpr int FW_MAX_SLABS = 40;
constexpr int SMEM_SM_BYTES = 233472;   // sm_90's shared memory an SM, 1 KB of it reserved per block

// Shapes of K1 bf16 at width H. The weights are nine sub-matrices of the
// packed layout without their bias rows, in the order a chunk uses them,
// each [rows][LW] bf16 with rows past `valid` zero (k padded to 16):
// 0 w_in (e1 -> h1), 1 w_mid1, 2 w_cat's h2 rows, 3 its e1 rows, 4 w_mid2,
// 5 w_col's h3 rows, 6 its e2 rows, 7 w_clip's h3 rows, 8 its e2 rows.
template <int H>
struct Fw {
  static_assert(tc_shape(H), "ff_fwd_bf16_kernel takes H = 16, 32, ..., 128");
  static constexpr int LW = H + 8;      // row of the weights and of an h-wide activation
  static constexpr int LS = H + 8;      // row of the f32 hclip staging
  __host__ __device__ static constexpr int rows(int s) {
    return s == 0 || s == 3 ? 96 : s == 6 || s == 8 ? 48 : H;
  }
  __host__ __device__ static constexpr int valid(int s) {
    return s == 0 || s == 3 ? 87 : s == 6 || s == 8 ? 42 : H;
  }
  __host__ __device__ static constexpr int slabs(int s) { return (rows(s) + FW_SLAB - 1) / FW_SLAB; }
  // first image row, and first slab of a chunk's stream, of sub-matrix s
  __host__ __device__ static constexpr int row0(int s) {
    int r = 0;
    for (int i = 0; i < s; ++i) r += rows(i);
    return r;
  }
  __host__ __device__ static constexpr int slabs_to(int s) {
    int n = 0;
    for (int i = 0; i < s; ++i) n += slabs(i);
    return n;
  }
  static constexpr int IMG_ROWS = row0(FW_SUBS);   // 5h + 288
  // f32: the six biases, w_alpha and w_oc rounded as operands, b_alpha and
  // b_oc, the direction table
  static constexpr int SMALL = (10 * H + 4 + ND * 3 + 3) / 4 * 4;
  // shared memory of a chunk of p points: e1, e2, two activations, the
  // hclip staging where there is one, two chunks' points, the small
  // parameters, the slab table
  __host__ __device__ static constexpr int chunk_bytes(int p, bool staged) {
    return 2 * p * (FW_LE1 + FW_LE2 + 2 * LW) + (staged ? 4 * p * LS : 0) + 4 * 2 * p * 4 +
           4 * SMALL + 16 * FW_MAX_SLABS;
  }
  static constexpr int IMG_BYTES = 2 * IMG_ROWS * LW;
  // the ring: two bf16 stages and FW_STAGES f32 stages (a slab's rows as
  // packed, from the 16-byte boundary at or below them), their mbarriers
  static constexpr int STG = FW_SLAB * H + 4;   // f32 a stage
  static constexpr int RING_BYTES = 2 * 2 * FW_SLAB * LW + 4 * FW_STAGES * STG + 8 * FW_STAGES;
  // The image on chip where it fits beside a chunk of 64 points with two
  // blocks an SM (h = 16 to 48): 256 threads, so that one block's SIMT
  // encode runs beside the other's products. Otherwise the ring, whose
  // every slab costs each block the same reads from L2 whatever its chunk:
  // chunks of 128 points (a slab serves 128 rows), 512 threads, one block
  // an SM; hclip goes from the C fragments to device memory (no room to
  // stage it).
  static constexpr bool RES = 2 * (IMG_BYTES + chunk_bytes(64, true) + 1024) <= SMEM_SM_BYTES;
  static constexpr int BLOCKS = RES ? 2 : 1; // resident an SM, by design
  static constexpr int P = RES ? 64 : 128;   // points per chunk
  static constexpr int T = 4 * P;            // threads: (P / 16) x 2 warps of 16 x h/2
  static constexpr int SMEM_BYTES = chunk_bytes(P, RES) + (RES ? IMG_BYTES : RING_BYTES);
  // a block's fixed cost in points, for the tile rule: the image's
  // conversion, about a quarter of a chunk's SIMT work at h = 32 (the ring
  // starts with two slabs, as any other chunk goes on)
  static constexpr int START = RES ? 16 : 0;
  static constexpr int WN = H / 2;           // a warp's 16 rows x h/2 columns of each layer
  static constexpr int NB = WN / 8;          // its 8-wide n-tiles
  static_assert(BLOCKS * (SMEM_BYTES + 1024) <= SMEM_SM_BYTES, "the blocks an SM");
  static_assert(slabs_to(FW_SUBS) <= FW_MAX_SLABS, "the slab table");
};

// First element of row r of sub-matrix s in an object's packed weights
// (a row past the sub-matrix's valid rows reads as zero)
template <int H>
__device__ inline int fw_source(int s, const Layout& L) {
  switch (s) {
    case 0: return L.w_in;
    case 1: return L.w_mid1;
    case 2: return L.w_cat;
    case 3: return L.w_cat + H * H;
    case 4: return L.w_mid2;
    case 5: return L.w_col;
    case 6: return L.w_col + H * H;
    case 7: return L.w_clip;
    default: return L.w_clip + H * H;
  }
}

// Slab j of a chunk's stream through the ring: (its first row's first f32
// in the object's packed weights, its first row in its sub-matrix, rows,
// the sub-matrix's valid rows)
template <int H>
__device__ inline int4 fw_slab(int j, const Layout& L) {
  using C = Fw<H>;
  int s = 0;
  while (j >= C::slabs_to(s + 1)) ++s;
  const int r = (j - C::slabs_to(s)) * FW_SLAB;
  return make_int4(fw_source<H>(s, L), r, min(FW_SLAB, C::rows(s) - r), C::valid(s));
}

// The weights of the chunks of one block's tile, sub-matrix by sub-matrix.
// RES: the image in shared memory, converted once. Otherwise the ring: the
// slabs of a chunk in a fixed order (`tab`, the same every chunk). Slab j's
// rows, contiguous in the packed weights, come by one bulk copy (TMA) into
// f32 stage j % FW_STAGES, from the 16-byte boundary at or below them (an
// object's weights start at any float), FW_STAGES slabs ahead; every thread
// rounds its pairs of it into bf16 stage j & 1 (rows past the sub-matrix's
// valid ones as zero), a barrier, and thread 0 refills the f32 stage.
// Every thread calls it, in the same order.
template <int H, bool RES>
struct FwW {
  using C = Fw<H>;
  bf* sm;            // the image, or the ring's two bf16 stages
  float* stg;        // ring: FW_STAGES f32 stages of C::STG
  uint64_t* bar;     // ring: their mbarriers
  const float* W;    // the object's packed weights
  const int4* tab;   // ring: (first f32 element, first row, rows, valid rows) of each slab
  int per, total;    // ring: slabs of a chunk, of the tile
  int q;             // ring: slabs multiplied so far

  // slab s's valid rows from the 16-byte boundary at or below them: (that
  // address, the floats before the first row, bytes to copy)
  __device__ void span(int4 s, const float*& a, int& skip, unsigned& bytes) const {
    const float* src = W + s.x + s.y * H;
    a = reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(src) & ~(uintptr_t)15);
    skip = (int)(src - a);
    bytes = (unsigned)(4 * (skip + min(s.z, s.w - s.y) * H) + 15) & ~15u;
  }
  // thread 0: slab j (s) into its f32 stage, on its mbarrier
  __device__ void issue(int j, int4 s) const {
    if (j >= total) return;
    const float* a;
    int skip;
    unsigned bytes;
    span(s, a, skip, bytes);
    uint64_t* b = bar + j % FW_STAGES;
    fence_proxy_async();
    mbar_arrive_expect_tx(b, bytes);
    bulk_copy_g2s(stg + (j % FW_STAGES) * C::STG, a, bytes, b);
  }
  // thread 0, ahead of the block's first barrier (which publishes the
  // table): the mbarriers, the first slabs
  __device__ void start(const Layout& L) {
    for (int i = 0; i < FW_STAGES; ++i) mbar_init(bar + i, 1);
    mbar_init_fence();
    for (int j = 0; j < FW_STAGES; ++j) issue(j, fw_slab<H>(j % per, L));
  }
  // every thread: wait for slab j, round its pairs into bf16 stage j & 1
  __device__ void round_in(int j) const {
    const int4 s = tab[j % per];
    const float* a;
    int skip;
    unsigned bytes;
    span(s, a, skip, bytes);
    mbar_wait(bar + j % FW_STAGES, (j / FW_STAGES) & 1);
    const float* g = stg + (j % FW_STAGES) * C::STG + skip;
    bf* d = sm + (j & 1) * FW_SLAB * C::LW;
#pragma unroll 4
    for (int i = threadIdx.x; i < s.z * (H / 2); i += C::T) {
      const int r = i / (H / 2), c = 2 * (i - r * (H / 2));
      float2 v = make_float2(0.0f, 0.0f);
      if (s.y + r < s.w) v = make_float2(g[r * H + c], g[r * H + c + 1]);
      *reinterpret_cast<uint32_t*>(d + r * C::LW + c) = pack_bf16(v.x, v.y);
    }
  }
  // f(w, r, nr) for each piece of sub-matrix s: w its rows r .. r + nr - 1
  // (nr a multiple of 16); `last` (the caller's epilogue) runs after the
  // last piece's f. Through the ring each piece is rounded in and a barrier
  // passed first (which also orders the layer before's epilogue).
  template <class F, class G>
  __device__ void each(int s, F f, G last) {
    if constexpr (RES) {
      f(sm + C::row0(s) * C::LW, 0, C::rows(s));
      last();
    } else {
      for (int r = 0; r < C::rows(s); r += FW_SLAB) {
        round_in(q);
        __syncthreads();
        if (threadIdx.x == 0) issue(q + FW_STAGES, tab[(q + FW_STAGES) % per]);
        f(sm + (q & 1) * FW_SLAB * C::LW, r, min(FW_SLAB, C::rows(s) - r));
        if (r + FW_SLAB >= C::rows(s)) last();
        ++q;
      }
    }
  }
};

// acc[j] += A . B over k-steps of 16 for the warp's 16 x WN tile (row tile
// warp % (P / 16), columns from (warp / (P / 16)) WN): A the activations
// from column 0 of `a` (rows lda apart), B the nr weight rows of `w`
// ([k][LW]); acc[j] is n-tile j of the warp's columns
template <int H>
__device__ inline void fw_mma(float (&acc)[Fw<H>::NB][4], const bf* a, int lda, const bf* w, int nr) {
  constexpr int NB = Fw<H>::NB, LW = Fw<H>::LW, MT = Fw<H>::P / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf* ap = a + (16 * (warp % MT) + (lane & 7) + 8 * ((lane >> 3) & 1)) * lda + 8 * (lane >> 4);
  const bf* bp = w + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LW + (warp / MT) * Fw<H>::WN + 8 * (lane >> 4);
#pragma unroll 2
  for (int ks = 0; ks < nr / 16; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, ap + 16 * ks);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t b[4];
      if (j + 1 < NB) ldsm_x4_t(b, bp + 16 * ks * LW + 8 * j);
      else ldsm_x2_t(reinterpret_cast<uint32_t (&)[2]>(b), bp + 16 * ks * LW + 8 * j);
#pragma unroll
      for (int jj = 0; jj < 2 && j + jj < NB; ++jj) {
        const uint32_t bj[2] = {b[2 * jj], b[2 * jj + 1]};
        mma_bf16(acc[j + jj], af, bj);
      }
    }
  }
}

template <int H>
__global__ void __launch_bounds__(Fw<H>::T, Fw<H>::BLOCKS)
ff_fwd_bf16_kernel(const float* __restrict__ pts, const float* __restrict__ w,
                   float* __restrict__ alpha, float* __restrict__ color,
                   float* __restrict__ hclip, int N, int do_clip, int tile) {
  using C = Fw<H>;
  constexpr bool RES = C::RES;
  constexpr int P = C::P, T = C::T, LW = C::LW, LS = C::LS, NB = C::NB, WN = C::WN;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int o = blockIdx.y;
  const Layout L = make_layout(H);
  const float* W = w + (size_t)o * L.total;

  unsigned char* q = reinterpret_cast<unsigned char*>(sm);
  const auto take = [&](int bytes) { unsigned char* p = q; q += bytes; return p; };
  // the image, or the ring's two bf16 stages, f32 stages and mbarriers
  bf* wsm = reinterpret_cast<bf*>(take(RES ? C::IMG_BYTES : 2 * 2 * FW_SLAB * LW));
  float* stg = reinterpret_cast<float*>(take(RES ? 0 : 4 * FW_STAGES * C::STG));
  uint64_t* bars = reinterpret_cast<uint64_t*>(take(RES ? 0 : 8 * FW_STAGES));
  float* st = reinterpret_cast<float*>(take(RES ? 4 * P * LS : 0));   // hclip, staged in rows
  bf* E1 = reinterpret_cast<bf*>(take(2 * P * FW_LE1));       // [t | bands 0-3 | 0]
  bf* E2 = reinterpret_cast<bf*>(take(2 * P * FW_LE2));       // [bands 4, 5 | 0]
  bf* A = reinterpret_cast<bf*>(take(2 * P * LW));            // h1, hc, hcol
  bf* B = reinterpret_cast<bf*>(take(2 * P * LW));            // h2, h3
  float* tt = reinterpret_cast<float*>(take(4 * 2 * P * 4));    // points: this chunk's, the next
  int4* tab = reinterpret_cast<int4*>(take(16 * FW_MAX_SLABS));
  float* bias = reinterpret_cast<float*>(q);   // b_in, b_mid1, b_cat, b_mid2, b_col, b_clip
  float* wal = bias + 6 * H;                   // w_alpha, rounded
  float* woc = wal + H;                        // w_oc [h][3], rounded
  float* bao = woc + 3 * H;                    // b_alpha, b_oc
  float* dirs = bao + 4;                       // [21][3]

  const int t0 = blockIdx.x * tile;
  const int t1 = min(N, t0 + tile);
  // the points of the chunk at c0 into buffer b; rows past the tile get t = 0
  const auto stage_points = [&](int b, int c0) {
    for (int i = tid; i < P * 3; i += T) {
      const int p = i / 3;
      tt[b * P * 4 + p * 4 + i - 3 * p] = c0 + p < t1 ? pts[((size_t)o * N + c0) * 3 + i] : 0.0f;
    }
  };

  const int boff[6] = {L.b_in, L.b_mid1, L.b_cat, L.b_mid2, L.b_col, L.b_clip};
  for (int i = tid; i < 6 * H; i += T) bias[i] = W[boff[i / H] + i % H];
  for (int i = tid; i < 4 * H; i += T) wal[i] = op(i < H ? W[L.w_alpha + i] : W[L.w_oc + i - H]);
  if (tid == 0) bao[0] = W[L.b_alpha];
  if (tid < 3) bao[1 + tid] = W[L.b_oc + tid];
  for (int i = tid; i < ND * 3; i += T) dirs[i] = W[L.dirs + i];
  stage_points(0, t0);
  for (int i = tid; i < P * 9; i += T) E1[(i / 9) * FW_LE1 + 87 + i % 9] = 0;   // k padding
  for (int i = tid; i < P * 6; i += T) E2[(i / 6) * FW_LE2 + 42 + i % 6] = 0;

  FwW<H, RES> ws;
  ws.sm = wsm;
  ws.stg = stg;
  ws.bar = bars;
  ws.W = W;
  ws.tab = tab;
  if constexpr (RES) {   // the object's image, once for the tile
#pragma unroll 1
    for (int s = 0; s < (do_clip ? FW_SUBS : 7); ++s) {
      const float* g = W + fw_source<H>(s, L);
      bf* d = wsm + C::row0(s) * LW;
      for (int i = tid; i < C::rows(s) * (H / 2); i += T) {
        const int r = i / (H / 2), c = 2 * (i - r * (H / 2));
        const float2 v = r < C::valid(s) ? make_float2(g[r * H + c], g[r * H + c + 1])
                                         : make_float2(0.0f, 0.0f);
        *reinterpret_cast<uint32_t*>(d + r * LW + c) = pack_bf16(v.x, v.y);
      }
    }
  } else {   // the ring's slab table (the clip head's slabs last)
    for (int j = tid; j < C::slabs_to(FW_SUBS); j += T) tab[j] = fw_slab<H>(j, L);
    ws.per = C::slabs_to(do_clip ? FW_SUBS : 7);
    ws.total = ws.per * ((t1 - t0 + P - 1) / P);
    ws.q = 0;
    if (tid == 0) ws.start(L);
  }

  __syncthreads();

  const float PI_F = (float)3.14159265358979323846;   // band k: PI_F 2^k, exactly
  // the warp's outputs: rows m0 + g (+ 8), columns n0 + 8j + 2t (+ 1)
  const int m0 = 16 * (warp % (P / 16)) + (lane >> 2);
  const int n0 = (warp / (P / 16)) * WN + 2 * (lane & 3);
  float acc[NB][4];
  const auto init = [&](int l) {   // the accumulators start at layer l's bias
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float* b = bias + l * H + n0 + 8 * j;
      acc[j][0] = acc[j][2] = b[0];
      acc[j][1] = acc[j][3] = b[1];
    }
  };
  const auto relu_to = [&](bf* dst) {   // the epilogue: ReLU, rounded, the next layer's operand
    return [&, dst] {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        bf* d = dst + m0 * LW + n0 + 8 * j;
        *reinterpret_cast<uint32_t*>(d) = pack_bf16(fmaxf(acc[j][0], 0.0f), fmaxf(acc[j][1], 0.0f));
        *reinterpret_cast<uint32_t*>(d + 8 * LW) =
            pack_bf16(fmaxf(acc[j][2], 0.0f), fmaxf(acc[j][3], 0.0f));
      }
    };
  };
  const auto part = [&](const bf* a, int lda) {
    return [&, a, lda](const bf* wr, int r, int nr) { fw_mma<H>(acc, a + r, lda, wr, nr); };
  };
  const auto none = [] {};

  int ci = 0;
  for (int c0 = t0; c0 < t1; c0 += P, ++ci) {
    const int nv = min(P, t1 - c0);
    const size_t row0 = (size_t)o * N + c0;
    const float* tc = tt + (ci & 1) * P * 4;
    if (c0 + P < t1) stage_points((ci + 1) & 1, c0 + P);   // read after this chunk's encode

    // ---- encode: t, and per (point, direction) the projection (the plain
    // version's FMA chain) and its six bands. The previous chunk's outputs
    // (after its last barrier) read none of e1 / e2, and this chunk's first
    // layer writes A, which they read, only after this encode's barrier.
    for (int i = tid; i < P * 3; i += T) E1[(i / 3) * FW_LE1 + i % 3] = bf_bits(tc[(i / 3) * 4 + i % 3]);
    for (int i = tid; i < P * ND; i += T) {
      const int p = i / ND, d = i - p * ND;
      const float* t = tc + p * 4;
      const float* dr = dirs + d * 3;
      const float pr = fmaf(t[2], dr[2], fmaf(t[1], dr[1], __fmul_rn(t[0], dr[0])));
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const bf s = bf_bits(sinf(__fmul_rn(PI_F * (float)(1 << k), pr)));
        if (k < 4) E1[p * FW_LE1 + 3 + ND * k + d] = s;
        else E2[p * FW_LE2 + ND * (k - 4) + d] = s;
      }
    }
    __syncthreads();

    // ---- the trunk: h1, h2, hc = [h2 | e1] . w_cat, h3
    init(0);
    ws.each(0, part(E1, FW_LE1), relu_to(A));
    if constexpr (RES) __syncthreads();
    init(1);
    ws.each(1, part(A, LW), relu_to(B));
    if constexpr (RES) __syncthreads();
    init(2);
    ws.each(2, part(B, LW), none);
    ws.each(3, part(E1, FW_LE1), relu_to(A));
    if constexpr (RES) __syncthreads();
    init(3);
    ws.each(4, part(A, LW), relu_to(B));
    if constexpr (RES) __syncthreads();

    // ---- the e2-fed heads: hcol = [h3 | e2] . w_col into A; hclip, in f32,
    // into the staging rows (image on chip) or to device memory, a C
    // fragment's pairs of 8 columns a whole 32-byte sector of a row (ring)
    init(4);
    ws.each(5, part(B, LW), none);
    ws.each(6, part(E2, FW_LE2), relu_to(A));
    if (do_clip) {
      init(5);
      ws.each(7, part(B, LW), none);
      ws.each(8, part(E2, FW_LE2), [&] {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 v = make_float2(fmaxf(acc[j][2 * r], 0.0f), fmaxf(acc[j][2 * r + 1], 0.0f));
            if constexpr (RES)
              *reinterpret_cast<float2*>(st + (m0 + 8 * r) * LS + n0 + 8 * j) = v;
            else if (m0 + 8 * r < nv)
              *reinterpret_cast<float2*>(hclip + (row0 + m0 + 8 * r) * H + n0 + 8 * j) = v;
          }
        }
      });
    }
    __syncthreads();

    // ---- alpha and colour (SIMT FMAs, four partial sums per dot); hclip
    // rows to device memory. No barrier after: the next chunk's encode
    // writes none of what this reads.
    for (int i = tid; i < nv * 4; i += T) {
      const int p = i >> 2, c = i & 3;
      // alpha: h3 . w_alpha + b_alpha; colour c: hcol . w_oc[:, c] + b_oc[c]
      const bf* x = (c == 3 ? B : A) + p * LW;
      const float* wv = c == 3 ? wal : woc + c;
      const int sw = c == 3 ? 1 : 3;
      float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
      for (int k = 0; k < H; k += 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(x + k);
        const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s4[(2 * e) & 3] = fmaf(lo_f(v[e]), wv[(k + 2 * e) * sw], s4[(2 * e) & 3]);
          s4[(2 * e + 1) & 3] = fmaf(hi_f(v[e]), wv[(k + 2 * e + 1) * sw], s4[(2 * e + 1) & 3]);
        }
      }
      const float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      if (c == 3) alpha[row0 + p] = (s + bao[0]) * ALPHA_SCALE;
      else color[(row0 + p) * 3 + c] = sigmoid_f(s + bao[1 + c]);
    }
    if (RES && do_clip) {
      for (int i = tid; i < nv * (H / 4); i += T) {
        const int r = i / (H / 4), u = i - r * (H / 4);
        *reinterpret_cast<float4*>(hclip + (row0 + r) * H + 4 * u) =
            *reinterpret_cast<const float4*>(st + r * LS + 4 * u);
      }
    }
  }
}

// The launch K1 bf16 makes for O objects x N points: {blocks resident an
// SM, points a block (a whole number of chunks, by fwd_tile over every
// resident block of the card, with the image's conversion as a block's
// fixed cost), blocks, dynamic shared memory in bytes, points a chunk,
// 1 if the weights stream through the ring (0: the image on chip)}
template <int H>
int plan_fwd_bf16(int O, int N, int* out) {
  int dev = 0, n_sm = 0, per_sm = 0;
  const int smem = Fw<H>::SMEM_BYTES;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ff_fwd_bf16_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ff_fwd_bf16_kernel<H>, Fw<H>::T,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int tile = fwd_tile(O, N, n_sm * per_sm, Fw<H>::START, Fw<H>::P);
  out[0] = per_sm;
  out[1] = tile;
  out[2] = O * ((N + tile - 1) / tile);
  out[3] = smem;
  out[4] = Fw<H>::P;
  out[5] = !Fw<H>::RES;
  return 0;
}

template <int H>
int launch_fwd_bf16(const float* pts, const float* w, float* alpha, float* color,
                    float* hclip, int O, int N, int do_clip, cudaStream_t stream) {
  if (do_clip && (uintptr_t)hclip % 16 != 0) return (int)cudaErrorInvalidValue;
  int plan[6];
  const int err = plan_fwd_bf16<H>(O, N, plan);
  if (err != 0) return err;
  const int tile = plan[1], threads = Fw<H>::T;
  dim3 grid((N + tile - 1) / tile, O);
  ff_fwd_bf16_kernel<H><<<grid, threads, plan[3], stream>>>(pts, w, alpha, color, hclip, N,
                                                              do_clip, tile);
  return (int)cudaGetLastError();
}

// K2 at compute_dtype="bf16" on Hopper's bf16 tensor cores:
// ff_bwd_bf16_kernel<H> at the tensor-core widths (FF_TC_WIDTHS), and
// ff_bf16_image_kernel, which converts the objects' packed f32 weights to
// bf16 once per launch.
//
// fused_field.cu includes this file only where FF_BF16 is defined (the
// build of csrc/fused_field_bf16.cu), inside its anonymous namespace: it
// uses that file's Layout, NT, ND, NF, ALPHA_SCALE, round_bf16, op and
// sigmoid_f. The f32 build compiles none of it.
//
// Replaces the bf16 instantiation (`cdt`) of _bwd_kernel in
// openobj_tpu/ops/fused_field.py (:172, launched at :392) and computes what
// it computes: the forward recomputed on bf16-rounded product operands
// with f32 sums (its signs are the backward's ReLU masks), every weight-
// and input-gradient product on bf16-rounded operands with f32 sums, and
// the bias gradients summed in f32 from the f32 cotangents.
//
// What bounds it on an H100: about a third of its multiply-adds are the
// recomputed forward, which stays on the SIMT cores in the plain version's
// order (an FMA chain from k = 0, as fused_field.cu's f32 K2 does): another
// order flips ReLU masks, and one flipped mask moves a leaf by more than its
// gate. Those FMAs (67 TFLOP/s) take longer than the two thirds on the bf16
// tensor cores (989 TFLOP/s); the weights (465 KB in f32 at h = 128), read
// twice per chunk, are what the block must keep fed.
//
// What the design does about it:
//  * Every product operand lives in shared memory as bf16, rounded once
//    where it is written (the embedding, each post-ReLU activation, each
//    layer's cotangent): the value the JAX kernel's .astype(cdt) gives at
//    each use. A ReLU output is stored as bf16(z) where z > 0 and as +0
//    elsewhere, and a z > 0 that rounds to +0 as -0, so its mask is "bits
//    != 0": the f32 sign, not the rounded value's. Bias gradients are summed
//    from the f32 cotangents in the product epilogues, before rounding.
//  * The recompute reads the bf16 operands eight k at a time (16-byte
//    loads of an activation row, RN-wide loads of a weight row); widening a
//    bf16 to f32 is one shift or mask. Each thread owns RM x RN outputs
//    (`Lay`), every output one FMA chain from k = 0, as the plain version.
//  * The gradient products run mma.sync m16n8k16 bf16 with f32 sums, their
//    fragments loaded by ldmatrix (.trans for the X^T of the weight
//    gradients and the dY of their B operand). Each 16-deep step is summed
//    from zero and the steps are added in f32 with round to nearest (the
//    tensor cores' own f32 accumulation truncates). Every output tile has
//    one owning warp: no atomics, deterministic. Rows of every bf16 matrix
//    are padded to an odd number of 16-byte units, so that ldmatrix's eight
//    row addresses fall in eight different bank groups.
//  * ff_bf16_image_kernel writes each object's weights once per launch as
//    a bf16 image (`Bf` below: the nine sub-matrices of rows the products
//    and the recompute take, each [rows][H + 8], zero-padded) into scratch
//    after the gradient slots. Where the image and f32 weight-gradient
//    accumulators fit in shared memory beside a chunk (h = 16, 32, 48), a
//    block copies it in once with bulk copies and walks a tile of chunks.
//    Otherwise (h = 64 to 128) a tile is one chunk of 64 points and the
//    image streams through a ring of 32-row slabs (bulk copies on
//    mbarriers, NSTG slabs in flight), in the order the chunk uses them;
//    the weight gradients go from registers to the tile's slot once.
//
// The SIMT ff_bwd_generic_kernel serves the bf16 build at other widths.

using bf = uint16_t;   // the bits of a bf16 value

#ifdef __CUDACC__
__device__ inline unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ldmatrix: four (or two) 8 x 8 matrices of 16-bit elements, row i of
// matrix j at the address of lane 8j + i; r[j] holds row g, columns 2t and
// 2t + 1 of matrix j (g = lane >> 2, t = lane & 3), or with .trans rows 2t
// and 2t + 1 of column g
__device__ inline void ldsm_x4(uint32_t (&r)[4], const bf* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}
__device__ inline void ldsm_x4_t(uint32_t (&r)[4], const bf* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}
__device__ inline void ldsm_x2(uint32_t (&r)[2], const bf* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}

// c += a . b for one m16n8k16 tile, bf16 operands, f32 accumulation
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ inline void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// order this thread's earlier shared-memory accesses before later bulk copies
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing that many bytes of `bar`'s transaction count
__device__ inline void bulk_copy_g2s(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
#endif

__device__ inline float bf_f(bf b) { return __uint_as_float((uint32_t)b << 16); }
__device__ inline float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ inline float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ inline bf bf_bits(float x) { return (bf)(__float_as_uint(round_bf16(x)) >> 16); }

// a ReLU output as a product operand that also carries its mask (`on`):
// bf16(z) where z > 0, -0 where z > 0 rounds to +0, +0 elsewhere
__device__ inline bf act_bits(float z) {
  if (!(z > 0.0f)) return 0;
  const bf b = bf_bits(z);
  return b ? b : (bf)0x8000;
}
__device__ inline bool on(bf b) { return b != 0; }

constexpr int SMEM_OPTIN_BYTES = 232448;   // sm_90's opt-in limit per block
constexpr int SLAB_ROWS = 32;              // rows of a weight slab in the ring
constexpr int MAX_SLABS = 64;              // slabs of one chunk's weight stream, at most

// Shapes of K2 bf16 at width H.
template <int H>
struct Bf {
  static_assert(tc_shape(H), "ff_bwd_bf16_kernel takes H = 16, 32, ..., 128");
  static constexpr int LW = H + 8;   // row of the weight image and of an h-wide activation
  // The weight image: sub-matrices of the packed weights (bias rows left
  // out), rows zero-padded to a multiple of 8 and columns to LW. [w_in]
  // feeds h1 from e1; [w_cat] splits at row H into the h2 and e1 parts; the
  // e2-fed heads likewise.
  static constexpr int IN = 0, MID1 = 88, CAT_H = MID1 + H, CAT_E = CAT_H + H,
                       MID2 = CAT_E + 88, COL_H = MID2 + H, COL_E = COL_H + H,
                       CLIP_H = COL_E + 48, CLIP_E = CLIP_H + H, IMG_ROWS = CLIP_E + 48;
  static constexpr int IMG = IMG_ROWS * LW;   // bf16 per object
  // activations: [h2 | e1 | 0 x 9], [h3 | e2 | 0 x 6], [d_hcol | d_hclip]
  static constexpr int LX2 = H + 104, LX3 = H + 56, LDH = 2 * H + 8;
  static constexpr int LE1 = 88, LE2 = 44;   // f32 d_e1, d_e2
  // d_e1 takes the space of [h3 | e2] and [d_hcol | d_hclip] (dead by then)
  // where it fits there
  static constexpr bool DE1_IN_X3 = 2 * (LX3 + LDH) >= 4 * LE1;
  // weight-gradient accumulators (where they stay in shared memory), rows
  static constexpr int G_IN = 0, G_MID1 = 96, G_CAT = G_MID1 + H, G_MID2 = G_CAT + H + 96,
                       G_COL = G_MID2 + H, G_CLIP = G_COL + H + 48, G_ROWS = G_CLIP + H + 48,
                       LDG = H + 8;
  // small gradients, each summed by a fixed thread
  static constexpr int S_DIRS = 0, S_WA = ND * 3, S_BA = S_WA + H, S_WOC = S_BA + 1,
                       S_BOC = S_WOC + 3 * H, S_BM1 = S_BOC + 3, S_BM2 = S_BM1 + H,
                       S_BIN = S_BM2 + H, S_BCAT = S_BIN + H, S_BCOL = S_BCAT + H,
                       S_BCLIP = S_BCOL + H, NS = S_BCLIP + H;
  // a buffer of bias column sums: one per 16-row tile of a product's
  // epilogue, or (phase a) one per row group of NT / H rows
  static constexpr int cp_floats(int p) { return (p / 16) * H > NT ? (p / 16) * H : NT; }
  // w_alpha and w_oc rounded as operands, b_oc
  static constexpr int SMALL_W = 4 * H + 4;
  static constexpr int chunk_bytes(int p) {
    return 2 * p * (LX2 + LX3 + LDH + 4 * LW) + 4 * p * (LE2 + 4 + ND + 4 + 1) +
           (DE1_IN_X3 ? 0 : 4 * p * LE1) + 4 * 2 * cp_floats(p) + 8 * 16 + 8 * MAX_SLABS +
           4 * SMALL_W + 4 * NS;
  }
  static constexpr int RES_BYTES = 2 * IMG + 4 * G_ROWS * LDG;
  static constexpr int SLAB_BYTES = 2 * SLAB_ROWS * LW;
  static constexpr bool fits_res(int p) { return RES_BYTES + chunk_bytes(p) <= SMEM_OPTIN_BYTES; }
  static constexpr int ring_stages(int p) {
    const int n = (SMEM_OPTIN_BYTES - chunk_bytes(p)) / SLAB_BYTES;
    return n > 6 ? 6 : n;
  }
  // the image and the accumulators on chip where they fit beside a chunk
  // (of 64 points, else 32), with tiles of several chunks; otherwise the
  // ring, with one chunk (of 64 points where 3 slabs fit beside it) a tile
  static constexpr bool SMEM_W = fits_res(64) || fits_res(32);
  static constexpr int P = SMEM_W ? (fits_res(64) ? 64 : 32) : (ring_stages(64) >= 3 ? 64 : 32);
  static constexpr int NSTG = SMEM_W ? 0 : ring_stages(P);
  static constexpr int CPF = cp_floats(P);
  static_assert(SMEM_W || NSTG >= 2, "two weight slabs must fit beside a chunk");
  static constexpr int SMEM_BYTES = chunk_bytes(P) + (SMEM_W ? RES_BYTES : NSTG * SLAB_BYTES);
  static_assert(SMEM_BYTES <= SMEM_OPTIN_BYTES, "a chunk must fit in shared memory");
};

// The thread tile of one recomputed layer (P points x H outputs): TN
// threads along n with RN adjacent columns each (one weight-row load),
// TM along m with RM rows each (strided by TM); RN and RM as close as the
// shape allows, the larger RN among equals.
constexpr int lay_tn(int h, int p) {
  int best = 0, bd = 1 << 30;
  for (int tn = 1; tn <= NT; tn *= 2) {
    if (h % tn != 0 || (NT / tn) > p || p % (NT / tn) != 0 || h / tn > 8) continue;
    const int rn = h / tn, rm = p / (NT / tn), d = rn > rm ? rn - rm : rm - rn;
    if (d < bd) { best = tn; bd = d; }
  }
  return best;
}

template <int H, int P>
struct Lay {
  static constexpr int TN = lay_tn(H, P), RN = H / TN, TM = NT / TN, RM = P / TM;
  static_assert(TN > 0 && RM >= 1, "layer shape");
};

// RN bf16 of a weight row as f32, with the widest loads its alignment allows
template <int RN>
__device__ inline void load_row(const bf* p, float (&v)[RN]) {
  if constexpr (RN % 8 == 0) {
#pragma unroll
    for (int q = 0; q < RN / 8; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      v[8 * q] = lo_f(u.x); v[8 * q + 1] = hi_f(u.x); v[8 * q + 2] = lo_f(u.y);
      v[8 * q + 3] = hi_f(u.y); v[8 * q + 4] = lo_f(u.z); v[8 * q + 5] = hi_f(u.z);
      v[8 * q + 6] = lo_f(u.w); v[8 * q + 7] = hi_f(u.w);
    }
  } else if constexpr (RN % 4 == 0) {
#pragma unroll
    for (int q = 0; q < RN / 4; ++q) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[q];
      v[4 * q] = lo_f(u.x); v[4 * q + 1] = hi_f(u.x); v[4 * q + 2] = lo_f(u.y);
      v[4 * q + 3] = hi_f(u.y);
    }
  } else if constexpr (RN % 2 == 0) {
#pragma unroll
    for (int q = 0; q < RN / 2; ++q) {
      const uint32_t u = reinterpret_cast<const uint32_t*>(p)[q];
      v[2 * q] = lo_f(u); v[2 * q + 1] = hi_f(u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < RN; ++j) v[j] = bf_f(p[j]);
  }
}

// s[i][j] = fma(x[m_i][k], w[k][n0 + j], s[i][j]) for k = 0 .. nr - 1 in
// order (nr a multiple of 8; rows m_i = cy + TM i of x, ldx apart): x from
// 16-byte loads of eight k, w one row at a time
template <int H, int P>
__device__ inline void fma_rows(float (&s)[Lay<H, P>::RM][Lay<H, P>::RN], const bf* x, int ldx,
                                const bf* w, int nr) {
  using Y = Lay<H, P>;
  constexpr int LW = Bf<H>::LW;
  const int cx = threadIdx.x % Y::TN, cy = threadIdx.x / Y::TN;
  const bf* wp = w + cx * Y::RN;
#pragma unroll 1
  for (int kb = 0; kb < nr; kb += 8) {
    uint4 xv[Y::RM];
#pragma unroll
    for (int i = 0; i < Y::RM; ++i)
      xv[i] = *reinterpret_cast<const uint4*>(x + (cy + Y::TM * i) * ldx + kb);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float wv[Y::RN];
      load_row<Y::RN>(wp + (kb + kk) * LW, wv);
#pragma unroll
      for (int i = 0; i < Y::RM; ++i) {
        const uint32_t u = kk < 2 ? xv[i].x : kk < 4 ? xv[i].y : kk < 6 ? xv[i].z : xv[i].w;
        const float a = (kk & 1) ? hi_f(u) : lo_f(u);
#pragma unroll
        for (int j = 0; j < Y::RN; ++j) s[i][j] = fmaf(a, wv[j], s[i][j]);
      }
    }
  }
}

// The weights of one chunk, sub-matrix by sub-matrix of the image: from
// the block's copy in shared memory (RES), or slab by slab through the ring
// in the order `slab_table` lists them, which is the order the kernel
// calls `each`. Every thread calls it, in the same order.
template <int H, bool RES>
struct WSrc {
  const bf* img;           // RES: the image in shared memory; else in device memory
  bf* ring;                // NSTG slabs of SLAB_ROWS x LW
  uint64_t* bar;           // one mbarrier per slab of the ring
  const int2* slabs;       // (first image row, rows) of each slab of the chunk
  int n_slabs, used;

  // thread 0: slab q into its stage, on its mbarrier
  __device__ void issue(int q) const {
    constexpr int LW = Bf<H>::LW, NSTG = Bf<H>::NSTG;
    const int2 s = slabs[q];
    const unsigned bytes = 2u * s.y * LW;
    fence_proxy_async();
    mbar_arrive_expect_tx(bar + q % NSTG, bytes);
    bulk_copy_g2s(ring + (q % NSTG) * SLAB_ROWS * LW, img + s.x * LW, bytes, bar + q % NSTG);
  }
  __device__ const bf* acquire() {
    constexpr int NSTG = Bf<H>::NSTG;
    const int q = used++;
    mbar_wait(bar + q % NSTG, (q / NSTG) & 1);
    return ring + (q % NSTG) * SLAB_ROWS * Bf<H>::LW;
  }
  // every thread is done with the last k slabs: refill their stages
  __device__ void release(int k) const {
    __syncthreads();
    if (threadIdx.x == 0)
      for (int q = used - k; q < used; ++q)
        if (q + Bf<H>::NSTG < n_slabs) issue(q + Bf<H>::NSTG);
  }
  // f(wa, wb, r, nr): rows r .. r + nr - 1 of the sub-matrix at image row
  // row_a (`rows` rows), wa pointing at row r, and where `two` the same rows
  // of the one at row_b at once (else wb is nullptr)
  template <class F>
  __device__ void each(int row_a, int row_b, int rows, bool two, F f) {
    if constexpr (RES) {
      f(img + row_a * Bf<H>::LW, two ? img + row_b * Bf<H>::LW : nullptr, 0, rows);
    } else {
      for (int r = 0; r < rows; r += SLAB_ROWS) {
        const bf* wa = acquire();
        const bf* wb = two ? acquire() : nullptr;
        f(wa, wb, r, min(SLAB_ROWS, rows - r));
        release(two ? 2 : 1);
      }
    }
  }
};

// The slabs of one chunk's weight stream, in the order the kernel takes
// them: the recompute's nine sub-matrices (the clip head's two only with
// it), then the backward's, the heads' two in pairs (w_col's slab, then
// w_clip's). Returns their number.
template <int H>
__device__ int slab_table(int2* t, int do_clip) {
  using C = Bf<H>;
  int n = 0;
  const auto add = [&](int row, int rows, int pair) {
    for (int r = 0; r < rows; r += SLAB_ROWS) {
      const int nr = min(SLAB_ROWS, rows - r);
      t[n++] = make_int2(row + r, nr);
      if (pair >= 0) t[n++] = make_int2(pair + r, nr);
    }
  };
  add(C::IN, 88, -1);
  add(C::MID1, H, -1);
  add(C::CAT_H, H, -1);
  add(C::CAT_E, 88, -1);
  add(C::MID2, H, -1);
  add(C::COL_H, H, -1);
  add(C::COL_E, 48, -1);
  if (do_clip) {
    add(C::CLIP_H, H, -1);
    add(C::CLIP_E, 48, -1);
  }
  add(C::COL_H, H, do_clip ? C::CLIP_H : -1);
  add(C::COL_E, 48, do_clip ? C::CLIP_E : -1);
  add(C::MID2, H, -1);
  add(C::CAT_H, H, -1);
  add(C::CAT_E, 88, -1);
  add(C::MID1, H, -1);
  add(C::IN, 88, -1);
  return n;
}

// A weight gradient, out (M x H) = init + X^T dY over the chunk's P points
// (X [P][ldx] from column 0 of `x`, dY [P][ldd] from `d`), for the items (16
// rows x 16 columns) dealt to the warps round-robin from `slot`; returns
// the slot after the last. Where the weight gradients stay on chip (SMEM_W)
// the items add into `gacc` ([M][LDG]); otherwise each goes to `gout` ([R][H]
// in the slot, rows past R dropped) through the warp's 16 x 17 tile of
// `stage` (dead shared memory), two rows of 16 adjacent columns a store.
template <int H, int P>
__device__ int mm_t(int slot, int M, const bf* x, int ldx, const bf* d, int ldd, float* gacc,
                    float* gout, int R, float* stage) {
  constexpr int NP = H / 16, LDG = Bf<H>::LDG;
  const int items = (M / 16) * NP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf* xa = x + ((lane & 7) + 8 * (lane >> 4)) * ldx + 8 * ((lane >> 3) & 1);
  const bf* db = d + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldd + 8 * (lane >> 4);
  float* st = stage + warp * 16 * 17;
  for (int it = (warp - slot % NW + NW) % NW; it < items; it += NW) {
    const int m0 = (it / NP) * 16, n0 = (it % NP) * 16;
    float c[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if constexpr (Bf<H>::SMEM_W) {
        const float* gp = gacc + (m0 + g) * LDG + n0 + 8 * j + 2 * t;
        const float2 u = *reinterpret_cast<const float2*>(gp);
        const float2 v = *reinterpret_cast<const float2*>(gp + 8 * LDG);
        c[j][0] = u.x; c[j][1] = u.y; c[j][2] = v.x; c[j][3] = v.y;
      } else {
        c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks) {
      uint32_t a[4], b[4];
      ldsm_x4_t(a, xa + 16 * ks * ldx + m0);
      ldsm_x4_t(b, db + 16 * ks * ldd + n0);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t bj[2] = {b[2 * j], b[2 * j + 1]};
        float dd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(dd, a, bj);
#pragma unroll
        for (int i = 0; i < 4; ++i) c[j][i] += dd[i];
      }
    }
    if constexpr (Bf<H>::SMEM_W) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* gp = gacc + (m0 + g) * LDG + n0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(gp) = make_float2(c[j][0], c[j][1]);
        *reinterpret_cast<float2*>(gp + 8 * LDG) = make_float2(c[j][2], c[j][3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        st[g * 17 + 8 * j + 2 * t] = c[j][0];
        st[g * 17 + 8 * j + 2 * t + 1] = c[j][1];
        st[(g + 8) * 17 + 8 * j + 2 * t] = c[j][2];
        st[(g + 8) * 17 + 8 * j + 2 * t + 1] = c[j][3];
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = 2 * k + (lane >> 4);
        if (m0 + r < R) gout[(m0 + r) * H + n0 + (lane & 15)] = st[r * 17 + (lane & 15)];
      }
      __syncwarp();
    }
  }
  return slot + items;
}

// An input gradient, out (P x rows) = dY W^T (+ dY2 W2^T) with W the `rows`
// rows of the sub-matrix at image row `wa` (W2 at `wb`, where `two`), dY
// [P][lda] from `a` (dY2 from `a2`), K = H; for each 16 x 8 tile,
// epi(mt, n, c) with c its C fragment (rows 16 mt + g and + 8, columns
// n + 2t and + 1).
template <int H, int P, class WS, class FE>
__device__ void mm_bt(WS& ws, int wa, int wb, int rows, bool two, const bf* a, const bf* a2,
                      int lda, FE epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ao = ((lane & 7) + 8 * ((lane >> 3) & 1)) * lda + 8 * (lane >> 4);
  const int bo = (lane & 7) * Bf<H>::LW + 8 * ((lane >> 3) & 1);
  ws.each(wa, wb, rows, two, [&](const bf* w, const bf* w2, int r, int nr) {
    const int nt = nr / 8, items = (P / 16) * nt;
    for (int it = warp; it < items; it += NW) {
      const int mt = it / nt, j = it % nt;
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int src = 0; src < (w2 ? 2 : 1); ++src) {
        const bf* ap = (src ? a2 : a) + 16 * mt * lda + ao;
        const bf* bp = (src ? w2 : w) + 8 * j * Bf<H>::LW + bo;
#pragma unroll 4
        for (int ks = 0; ks < H / 16; ++ks) {
          uint32_t af[4], bfr[2];
          ldsm_x4(af, ap + 16 * ks);
          ldsm_x2(bfr, bp + 16 * ks);
          float dd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(dd, af, bfr);
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] += dd[i];
        }
      }
      epi(mt, r + 8 * j, c);
    }
  });
}

// column sums over a 16-row tile of the f32 values (rows g and g + 8, as in
// a C fragment) whose sums per lane are a0 (column n) and a1 (n + 1): into
// cp[n], cp[n + 1] by the lanes of g = 0
__device__ inline void tile_colsum(float* cp, int n, float a0, float a1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int x = 4; x < 32; x <<= 1) {
    a0 += __shfl_sync(0xffffffffu, a0, lane ^ x);
    a1 += __shfl_sync(0xffffffffu, a1, lane ^ x);
  }
  if (lane < 4) {
    cp[n] = a0;
    cp[n + 1] = a1;
  }
}

template <int H>
__global__ void __launch_bounds__(NT, 1)
ff_bwd_bf16_kernel(const float* __restrict__ pts, const float* __restrict__ w,
                   const bf* __restrict__ img, const float* __restrict__ da,
                   const float* __restrict__ dc, const float* __restrict__ dh,
                   float* __restrict__ part, int N, int do_clip, int tile) {
  using C = Bf<H>;
  constexpr bool SW = C::SMEM_W;
  constexpr int P = C::P, LW = C::LW, LX2 = C::LX2, LX3 = C::LX3, LDH = C::LDH;
  constexpr int LE1 = C::LE1, LE2 = C::LE2, MT = P / 16, CP = C::CPF;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int o = blockIdx.y;
  const int ti = blockIdx.x;
  const Layout L = make_layout(H);
  const float* W = w + (size_t)o * L.total;
  const bf* gimg = img + (size_t)o * C::IMG;
  float* G = part + ((size_t)o * gridDim.x + ti) * L.total;

  unsigned char* q = reinterpret_cast<unsigned char*>(sm);
  const auto take = [&](int bytes) { unsigned char* p = q; q += bytes; return p; };
  bf* wsm = reinterpret_cast<bf*>(take(SW ? 2 * C::IMG : 2 * C::NSTG * SLAB_ROWS * LW));
  float* gs = reinterpret_cast<float*>(take(SW ? 4 * C::G_ROWS * C::LDG : 0));
  bf* X2 = reinterpret_cast<bf*>(take(2 * P * LX2));    // [h2 | e1 | 0]
  bf* X3 = reinterpret_cast<bf*>(take(2 * P * LX3));    // [h3 | e2 | 0]
  bf* DH = reinterpret_cast<bf*>(take(2 * P * LDH));    // [d_hcol | d_hclip]
  bf* A1 = reinterpret_cast<bf*>(take(2 * P * LW));     // h1
  bf* AC = reinterpret_cast<bf*>(take(2 * P * LW));     // hc
  bf* AO = reinterpret_cast<bf*>(take(2 * P * LW));     // hcol, then d_hc, then d_h1
  bf* D3 = reinterpret_cast<bf*>(take(2 * P * LW));     // d_h3, then d_h2
  float* DE2 = reinterpret_cast<float*>(take(4 * P * LE2));   // d_e2
  float* DE1 = C::DE1_IN_X3 ? reinterpret_cast<float*>(X3)
                            : reinterpret_cast<float*>(take(4 * P * LE1));   // d_e1
  float* tt = reinterpret_cast<float*>(take(4 * P * 4));      // scaled points
  float* pj = reinterpret_cast<float*>(take(4 * P * ND));     // proj, then d_proj
  float* dcp = reinterpret_cast<float*>(take(4 * P * 4));     // sigmoid-input cotangent
  float* dal = reinterpret_cast<float*>(take(4 * P));         // alpha pre-scale cotangent
  float* cpart = reinterpret_cast<float*>(take(4 * 2 * CP));   // two buffers of bias column sums
  uint64_t* bar = reinterpret_cast<uint64_t*>(take(8 * 16));
  int2* slabs = reinterpret_cast<int2*>(take(8 * MAX_SLABS));
  float* wal = reinterpret_cast<float*>(take(4 * C::SMALL_W));  // w_alpha, w_oc rounded; b_oc
  float* woc = wal + H;
  float* boc = woc + 3 * H;
  float* S = reinterpret_cast<float*>(q);                     // small gradients

  WSrc<H, SW> ws{SW ? wsm : gimg, wsm, bar, slabs, 0, 0};
  for (int i = tid; i < C::NS; i += NT) S[i] = 0.0f;
  for (int i = tid; i < 4 * H; i += NT) wal[i] = op(i < H ? W[L.w_alpha + i] : W[L.w_oc + i - H]);
  if (tid < 3) boc[tid] = W[L.b_oc + tid];
  if constexpr (SW) {
    for (int i = tid; i < C::G_ROWS * C::LDG; i += NT) gs[i] = 0.0f;
    if (tid == 0) {   // the object's image, behind the first encode
      mbar_init(bar, 1);
      mbar_init_fence();
      constexpr unsigned BYTES = 2u * C::IMG, PIECE = 16384u;
      mbar_arrive_expect_tx(bar, BYTES);
      for (unsigned b = 0; b < BYTES; b += PIECE)
        bulk_copy_g2s(reinterpret_cast<unsigned char*>(wsm) + b,
                      reinterpret_cast<const unsigned char*>(gimg) + b,
                      BYTES - b < PIECE ? BYTES - b : PIECE, bar);
    }
  } else if (tid == 0) {   // the first slabs, behind the encode
    ws.n_slabs = slab_table<H>(slabs, do_clip);
    for (int s = 0; s < C::NSTG; ++s) mbar_init(bar + s, 1);
    mbar_init_fence();
    for (int s = 0; s < C::NSTG && s < ws.n_slabs; ++s) ws.issue(s);
  }

  // the bias partial sums of one row tile (buffer b), the output pair
  // (n, n + 1) of C fragment c with its two rows masked as given
  const auto colsum = [&](int b, int mt, int n, float2 u, float2 v) {
    tile_colsum(cpart + b * CP + mt * H, n, u.x + v.x, u.y + v.y);
  };
  // S[off + j] += the nr column sums of buffer b, in order
  const auto fold = [&](int b, int off, int nr) {
    for (int j = tid; j < H; j += NT) {
      float s = 0.0f;
      for (int r = 0; r < nr; ++r) s += cpart[b * CP + r * H + j];
      S[off + j] += s;
    }
  };
  constexpr int RG = NT / H;   // phase a's row groups
  // staging for the ring's weight-gradient stores (mm_t): hcol's space in
  // the e2-fed heads' phase, then what [d_hcol | d_hclip] leaves beside d_e1
  constexpr int STAGE_BYTES = 4 * NW * 16 * 17;
  static_assert(SW || (2 * P * LW >= STAGE_BYTES && C::DE1_IN_X3 &&
                       2 * P * (LX3 + LDH) - 4 * P * LE1 >= STAGE_BYTES), "staging space");
  float* stage_b = reinterpret_cast<float*>(AO);
  float* stage_cf = DE1 + P * LE1;
  using Y = Lay<H, P>;
  // b_clip's gradient: each recompute thread's sums over its RM rows of
  // d_hclip, [TM][H] in the space of d_e2 (free until the e2-fed heads'
  // phase), folded in thread-row order
  static_assert(Y::TM * H <= P * LE2, "b_clip's partial sums fit where d_e2 goes");
  float* hcp = DE2;
  const float PI_F = (float)3.14159265358979323846;   // band k: PI_F 2^k, exactly

  const int t0 = ti * tile;
  const int t1 = min(N, t0 + tile);
  for (int c0 = t0; c0 < t1; c0 += P) {
    const int nv = min(P, t1 - c0);
    const size_t row0 = (size_t)o * N + c0;

    // ---- encode; rows past nv get t = 0 and zero cotangents
    for (int i = tid; i < P * 3; i += NT) {
      const int p = i / 3, c = i - p * 3;
      const float v = p < nv ? pts[row0 * 3 + i] : 0.0f;
      tt[p * 4 + c] = v;
      X2[p * LX2 + H + c] = bf_bits(v);
    }
    for (int p = tid; p < P; p += NT) {
      dal[p] = p < nv ? da[row0 + p] * ALPHA_SCALE : 0.0f;
      for (int c = H + 87; c < H + 96; ++c) X2[p * LX2 + c] = 0;
      for (int c = H + 42; c < H + 48; ++c) X3[p * LX3 + c] = 0;
    }
    __syncthreads();
    for (int i = tid; i < P * ND; i += NT) {
      const int p = i / ND, d = i - p * ND;
      const float* t = tt + p * 4;
      const float* dr = W + L.dirs + d * 3;
      // full f32 as an explicit FMA chain, the same rounding as the plain
      // version (embedding.project): fma(t2, d2, fma(t1, d1, t0 d0))
      const float pr = fmaf(t[2], dr[2], fmaf(t[1], dr[1], __fmul_rn(t[0], dr[0])));
      pj[i] = pr;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const bf s = bf_bits(sinf(__fmul_rn(PI_F * (float)(1 << k), pr)));
        if (k < 4) X2[p * LX2 + H + 3 + ND * k + d] = s;
        else X3[p * LX3 + H + ND * (k - 4) + d] = s;
      }
    }
    if constexpr (SW) {
      if (c0 == t0) mbar_wait(bar, 0);
    }
    __syncthreads();

    // ---- recompute the forward, a layer at a time (the slabs' order:
    // slab_table): z = (x_h . w_h + x_e . w_e) + bias, each dot an FMA chain
    // from k = 0 on the rounded operands, as the plain version's products
    // round them; x_e (e1 or e2) follows x_h (h2 or h3) in its buffer. The
    // ReLU outputs go to the next layer's operand (act_bits); the clip head's
    // pre-activations give d_hclip = dh * (hclip > 0) (hclip is not kept).
    // Unrolled where the weights are on chip; through the ring, one copy of
    // the loop serves every layer (measured faster there: the kernel's code
    // outgrows the instruction cache, PERF.md)
#pragma unroll (Bf<H>::SMEM_W ? 6 : 1)
    for (int l = 0; l < (do_clip ? 6 : 5); ++l) {
      int mh, me = 0, rh = H, re = 0, ldx, ldd = 0;
      const bf* xh;
      const float* bias;
      bf* dst = nullptr;
      switch (l) {
        case 0: mh = C::IN; rh = 88; xh = X2 + H; ldx = LX2; bias = W + L.b_in; dst = A1; ldd = LW; break;
        case 1: mh = C::MID1; xh = A1; ldx = LW; bias = W + L.b_mid1; dst = X2; ldd = LX2; break;
        case 2: mh = C::CAT_H; me = C::CAT_E; re = 88; xh = X2; ldx = LX2; bias = W + L.b_cat;
                dst = AC; ldd = LW; break;
        case 3: mh = C::MID2; xh = AC; ldx = LW; bias = W + L.b_mid2; dst = X3; ldd = LX3; break;
        case 4: mh = C::COL_H; me = C::COL_E; re = 48; xh = X3; ldx = LX3; bias = W + L.b_col;
                dst = AO; ldd = LW; break;
        default: mh = C::CLIP_H; me = C::CLIP_E; re = 48; xh = X3; ldx = LX3; bias = W + L.b_clip;
      }
      const int n0 = tid % Y::TN * Y::RN, cy = tid / Y::TN;
      float s[Y::RM][Y::RN], acc[Y::RM][Y::RN], bn[Y::RN];
#pragma unroll
      for (int j = 0; j < Y::RN; ++j) bn[j] = __ldg(bias + n0 + j);   // in flight behind the FMAs
      for (int part = 0; part < (re ? 2 : 1); ++part) {
#pragma unroll
        for (int i = 0; i < Y::RM; ++i)
#pragma unroll
          for (int j = 0; j < Y::RN; ++j) acc[i][j] = 0.0f;
        const bf* x = part ? xh + H : xh;
        ws.each(part ? me : mh, 0, part ? re : rh, false, [&](const bf* wr, const bf*, int r, int nr) {
          fma_rows<H, P>(acc, x + r, ldx, wr, nr);
        });
        if (part == 0) {
#pragma unroll
          for (int i = 0; i < Y::RM; ++i)
#pragma unroll
            for (int j = 0; j < Y::RN; ++j) s[i][j] = acc[i][j];
        }
      }
      float hs[Y::RN];
#pragma unroll
      for (int j = 0; j < Y::RN; ++j) hs[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < Y::RM; ++i) {
        const int m = cy + Y::TM * i;
        float z[Y::RN];
#pragma unroll
        for (int j = 0; j < Y::RN; ++j) z[j] = (re ? s[i][j] + acc[i][j] : acc[i][j]) + bn[j];
        if (dst) {   // two ReLU outputs to a 32-bit store where RN is even
          if constexpr (Y::RN % 2 == 0) {
#pragma unroll
            for (int j = 0; j < Y::RN; j += 2)
              *reinterpret_cast<uint32_t*>(dst + m * ldd + n0 + j) =
                  (uint32_t)act_bits(z[j]) | ((uint32_t)act_bits(z[j + 1]) << 16);
          } else {
#pragma unroll
            for (int j = 0; j < Y::RN; ++j) dst[m * ldd + n0 + j] = act_bits(z[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < Y::RN; ++j) {
            const float d = (z[j] > 0.0f && m < nv) ? dh[(row0 + m) * H + n0 + j] : 0.0f;
            DH[m * LDH + H + n0 + j] = bf_bits(d);
            hs[j] += d;
          }
        }
      }
      if (!dst) {
#pragma unroll
        for (int j = 0; j < Y::RN; ++j) hcp[cy * H + n0 + j] = hs[j];
      }
      if (l != 4 || !do_clip) __syncthreads();   // hcol and hclip read h3 side by side
    }

    // ---- colour head: sigmoid-input cotangent (four partial sums, as K1's);
    // b_clip's gradient from the recompute's partial sums
    if (do_clip) {
      for (int j = tid; j < H; j += NT) {
        float s = 0.0f;
        for (int r = 0; r < Y::TM; ++r) s += hcp[r * H + j];
        S[C::S_BCLIP + j] += s;
      }
    }
    for (int i = tid; i < P * 3; i += NT) {
      const int p = i / 3, c = i - p * 3;
      float d = 0.0f;
      if (p < nv) {
        float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int k = 0; k < H; ++k) s4[k & 3] = fmaf(bf_f(AO[p * LW + k]), woc[k * 3 + c], s4[k & 3]);
        const float col = sigmoid_f((s4[0] + s4[1]) + (s4[2] + s4[3]) + boc[c]);
        d = dc[(row0 + p) * 3 + c] * col * (1.0f - col);
      }
      dcp[p * 4 + c] = d;
    }
    __syncthreads();
    // d_hcol = (dcp w_oc^T) * (hcol > 0) by column j and row group r (rows
    // r, r + RG, ...), with the row groups' sums for b_col's gradient into
    // bias buffer 1, folded in the next phase; the small heads' gradients,
    // each a sum over the points in four partial sums
    if (tid < RG * H) {
      const int j = tid % H, r = tid / H;
      const float w0 = woc[j * 3], w1 = woc[j * 3 + 1], w2 = woc[j * 3 + 2];
      float s = 0.0f;
      for (int p = r; p < P; p += RG) {
        const float* d = dcp + p * 4;
        float v = fmaf(op(d[2]), w2, fmaf(op(d[1]), w1, op(d[0]) * w0));
        v = on(AO[p * LW + j]) ? v : 0.0f;
        DH[p * LDH + j] = bf_bits(v);
        s += v;
      }
      cpart[CP + r * H + j] = s;
    }
    for (int e = tid; e < 4 * H + 4; e += NT) {
      float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (e < 3 * H) {          // w_oc[j][c] += sum_p hcol[p][j] dcp[p][c]
        const int j = e / 3, c = e - j * 3;
#pragma unroll 4
        for (int p = 0; p < nv; ++p)
          s4[p & 3] = fmaf(bf_f(AO[p * LW + j]), op(dcp[p * 4 + c]), s4[p & 3]);
      } else if (e < 3 * H + 3) {
#pragma unroll 4
        for (int p = 0; p < nv; ++p) s4[p & 3] += dcp[p * 4 + e - 3 * H];
      } else if (e < 4 * H + 3) {   // w_alpha[j] += sum_p h3[p][j] dal[p]
        const int j = e - 3 * H - 3;
#pragma unroll 4
        for (int p = 0; p < nv; ++p)
          s4[p & 3] = fmaf(bf_f(X3[p * LX3 + j]), op(dal[p]), s4[p & 3]);
      } else {
#pragma unroll 4
        for (int p = 0; p < nv; ++p) s4[p & 3] += dal[p];
      }
      const float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      S[e < 3 * H ? C::S_WOC + e : e < 3 * H + 3 ? C::S_BOC + e - 3 * H
                  : e < 4 * H + 3 ? C::S_WA + e - 3 * H - 3 : C::S_BA] += s;
    }
    __syncthreads();

    // ---- the backward layers, a phase each (the slabs' order: slab_table):
    // 0 the e2-fed heads ([w_col; w_clip] grads; [d_h3 | d_e2]), 1 mid2
    // (d_hc), 2 the skip layer (w_cat's grad; d_h2 and d_e1), 3 mid1 (d_h1),
    // 4 in_layer (d_e1 += d_h1 w_in^T). Each first folds the bias sums of
    // the cotangent the phase before wrote (b_col, b_mid2, b_cat, b_mid1,
    // b_in), then runs its weight gradients and its input gradients, whose
    // epilogues mask and round the next cotangent (its bias sums into buffer
    // ph & 1) or store d_e1 / d_e2 in f32.
    enum { EPI_D3, EPI_MASK, EPI_E2, EPI_E1, EPI_E1_ADD };
#pragma unroll
    for (int ph = 0; ph < 5; ++ph) {
      {
        const int off[5] = {C::S_BCOL, C::S_BM2, C::S_BCAT, C::S_BM1, C::S_BIN};
        fold(ph & 1 ? 0 : 1, off[ph], ph == 0 ? RG : MT);
      }
      int slot = 0;
#pragma unroll
      for (int q = 0; q < (ph == 0 && do_clip ? 2 : 1); ++q) {   // weight gradients
        int M, ldx, ldd, gr0, off, R;
        const bf* x;
        const bf* d;
        switch (ph) {
          case 0: M = H + 48; x = X3; ldx = LX3; d = q ? DH + H : DH; ldd = LDH;
                  gr0 = q ? C::G_CLIP : C::G_COL; off = q ? L.w_clip : L.w_col; R = H + 42; break;
          case 1: M = H; x = AC; ldx = LW; d = D3; ldd = LW; gr0 = C::G_MID2; off = L.w_mid2;
                  R = H; break;
          case 2: M = H + 96; x = X2; ldx = LX2; d = AO; ldd = LW; gr0 = C::G_CAT; off = L.w_cat;
                  R = H + 87; break;
          case 3: M = H; x = A1; ldx = LW; d = D3; ldd = LW; gr0 = C::G_MID1; off = L.w_mid1;
                  R = H; break;
          default: M = 96; x = X2 + H; ldx = LX2; d = AO; ldd = LW; gr0 = C::G_IN; off = L.w_in;
                   R = 87;
        }
        slot = mm_t<H, P>(slot, M, x, ldx, d, ldd, gs + gr0 * C::LDG, G + off, R,
                          ph == 0 ? stage_b : stage_cf);
      }
#pragma unroll
      for (int q = 0; q < (ph == 0 || ph == 2 ? 2 : 1); ++q) {   // input gradients
        int wa, wb = 0, rows = H, lda = LW, mode = EPI_MASK, ldm = LW;
        const bf* a;
        const bf* act = nullptr;   // EPI_D3, EPI_MASK: the mask's activation
        bf* dst = nullptr;
        switch (ph) {
          case 0: wa = q ? C::COL_E : C::COL_H; wb = q ? C::CLIP_E : C::CLIP_H; rows = q ? 48 : H;
                  a = DH; lda = LDH; mode = q ? EPI_E2 : EPI_D3; act = X3; ldm = LX3; dst = D3;
                  break;
          case 1: wa = C::MID2; a = D3; act = AC; dst = AO; break;
          case 2: wa = q ? C::CAT_E : C::CAT_H; rows = q ? 88 : H; a = AO; act = X2; ldm = LX2;
                  dst = D3; mode = q ? EPI_E1 : EPI_MASK; break;
          case 3: wa = C::MID1; a = D3; act = A1; dst = AO; break;
          default: wa = C::IN; rows = 88; a = AO; mode = EPI_E1_ADD;
        }
        const int buf = ph & 1;
        mm_bt<H, P>(ws, wa, wb, rows, ph == 0 && do_clip, a, DH + H, lda,
                    [&](int mt, int n, const float (&c)[4]) {
          const int m = 16 * mt + ((tid & 31) >> 2), nn = n + 2 * (tid & 3);
          if (mode >= EPI_E2) {   // d_e2 (columns 42 .. 47 are padding) or d_e1, f32
            if (mode == EPI_E2 && nn >= 42) return;
            float* e = mode == EPI_E2 ? DE2 : DE1;
            const int ld = mode == EPI_E2 ? LE2 : LE1;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float* p = e + (m + 8 * r) * ld + nn;
              p[0] = mode == EPI_E1_ADD ? p[0] + c[2 * r] : c[2 * r];
              p[1] = mode == EPI_E1_ADD ? p[1] + c[2 * r + 1] : c[2 * r + 1];
            }
            return;
          }
          float2 v[2] = {make_float2(c[0], c[1]), make_float2(c[2], c[3])};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int mm = m + 8 * r;
            if (mode == EPI_D3) {   // d_h3 = (. + dal w_alpha^T) * (h3 > 0)
              const float al = op(dal[mm]);
              v[r].x = fmaf(al, wal[nn], v[r].x);
              v[r].y = fmaf(al, wal[nn + 1], v[r].y);
            }
            if (!on(act[mm * ldm + nn])) v[r].x = 0.0f;
            if (!on(act[mm * ldm + nn + 1])) v[r].y = 0.0f;
            dst[mm * LW + nn] = bf_bits(v[r].x);
            dst[mm * LW + nn + 1] = bf_bits(v[r].y);
          }
          colsum(buf, mt, nn, v[0], v[1]);
        });
      }
      __syncthreads();
    }

    // ---- PE backward: d_proj = sum_k f_k cos(f_k proj) d_sin_k; d_dirs
    for (int i = tid; i < P * ND; i += NT) {
      const int p = i / ND, d = i - p * ND;
      const float pr = pj[i];
      float g = 0.0f;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const float f = PI_F * (float)(1 << k);
        const float ds = k < 4 ? DE1[p * LE1 + 3 + ND * k + d] : DE2[p * LE2 + ND * (k - 4) + d];
        g += (f * cosf(__fmul_rn(f, pr))) * ds;
      }
      pj[i] = g;
    }
    __syncthreads();
    {   // d_dirs[d][c] += sum_p d_proj[p][d] t[p][c]: four lanes an entry, a
        // quarter of the points each, their sums added in lane order
      static_assert(4 * ND * 3 <= NT, "d_dirs: four lanes an entry");
      const int e = tid >> 2, d = e / 3, c = e - d * 3;
      float s = 0.0f;
      if (e < ND * 3)
        for (int p = tid & 3; p < nv; p += 4) s = fmaf(op(pj[p * ND + d]), op(tt[p * 4 + c]), s);
      s += __shfl_sync(0xffffffffu, s, (tid & 31) ^ 1);
      s += __shfl_sync(0xffffffffu, s, (tid & 31) ^ 2);
      if ((tid & 3) == 0 && e < ND * 3) S[C::S_DIRS + e] += s;
    }
    __syncthreads();   // the next chunk's encode overwrites t, proj and [h3 | e2]
  }

  // ---- the block's slot, written once
  if constexpr (SW) {
    const auto put = [&](int gr0, int off, int rows) {
      for (int i = tid; i < rows * H; i += NT) G[off + i] = gs[(gr0 + i / H) * C::LDG + i % H];
    };
    put(C::G_IN, L.w_in, 87);
    put(C::G_MID1, L.w_mid1, H);
    put(C::G_CAT, L.w_cat, H + 87);
    put(C::G_MID2, L.w_mid2, H);
    put(C::G_COL, L.w_col, H + 42);
    put(C::G_CLIP, L.w_clip, H + 42);
  } else if (!do_clip) {
    for (int i = tid; i < (H + 42) * H; i += NT) G[L.w_clip + i] = 0.0f;
  }
  for (int e = tid; e < ND * 3; e += NT) G[L.dirs + e] = S[C::S_DIRS + e];
  for (int j = tid; j < H; j += NT) {
    G[L.b_in + j] = S[C::S_BIN + j];
    G[L.b_mid1 + j] = S[C::S_BM1 + j];
    G[L.b_cat + j] = S[C::S_BCAT + j];
    G[L.b_mid2 + j] = S[C::S_BM2 + j];
    G[L.w_alpha + j] = S[C::S_WA + j];
    G[L.b_col + j] = S[C::S_BCOL + j];
    G[L.b_clip + j] = S[C::S_BCLIP + j];   // zero with the clip head off
  }
  for (int e = tid; e < 3 * H; e += NT) G[L.w_oc + e] = S[C::S_WOC + e];
  if (tid < 3) G[L.b_oc + tid] = S[C::S_BOC + tid];
  if (tid == 0) G[L.b_alpha] = S[C::S_BA];
}

// The image row r's first element in an object's packed weights, or -1 for
// a zero row of padding (Bf's sub-matrices, at any width h)
__host__ __device__ inline int image_source(int r, int h, const Layout& L) {
  if (r < 88) return r < 87 ? L.w_in + r * h : -1;
  r -= 88;
  if (r < h) return L.w_mid1 + r * h;
  r -= h;
  if (r < h) return L.w_cat + r * h;
  r -= h;
  if (r < 88) return r < 87 ? L.w_cat + (h + r) * h : -1;
  r -= 88;
  if (r < h) return L.w_mid2 + r * h;
  r -= h;
  if (r < h) return L.w_col + r * h;
  r -= h;
  if (r < 48) return r < 42 ? L.w_col + (h + r) * h : -1;
  r -= 48;
  if (r < h) return L.w_clip + r * h;
  r -= h;
  return r < 42 ? L.w_clip + (h + r) * h : -1;
}

__host__ __device__ inline int image_rows(int h) { return 5 * h + 272; }

// The objects' bf16 weight images: element (o, r, c) of [O][rows][h + 8]
// is bf16(w[o][image_source(r) + c]) (round to nearest even), zero in the
// padding; a thread per pair of columns (h is even).
__global__ void __launch_bounds__(NT)
ff_bf16_image_kernel(const float* __restrict__ w, uint32_t* __restrict__ img, int h) {
  const int lw = h + 8, pairs = image_rows(h) * lw / 2;
  const int o = blockIdx.y;
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= pairs) return;
  const Layout L = make_layout(h);
  const int r = 2 * i / lw, c = 2 * i - r * lw;
  const int src = image_source(r, h, L);
  float a = 0.0f, b = 0.0f;
  if (src >= 0 && c < h) {
    a = w[(size_t)o * L.total + src + c];
    b = w[(size_t)o * L.total + src + c + 1];
  }
  img[(size_t)o * pairs + i] = (uint32_t)bf_bits(a) | ((uint32_t)bf_bits(b) << 16);
}

// floats of scratch K2 bf16 takes after the O x T slots of `part`: the
// images, from the first 16-byte boundary
inline size_t image_scratch_floats(int O, int h) {
  return (size_t)O * image_rows(h) * (h + 8) / 2 + 4;
}

inline uint32_t* image_in(float* part, size_t slot_floats) {
  return reinterpret_cast<uint32_t*>(part + (slot_floats + 3) / 4 * 4);
}

int launch_image(const float* w, uint32_t* img, int O, int h, cudaStream_t stream) {
  const int pairs = image_rows(h) * (h + 8) / 2;
  dim3 grid((pairs + NT - 1) / NT, O);
  ff_bf16_image_kernel<<<grid, NT, 0, stream>>>(w, img, h);
  return (int)cudaGetLastError();
}

// the images into the scratch after the slots, then the kernel
template <int H>
int launch_bwd_bf16(const float* pts, const float* w, const float* da, const float* dc,
                    const float* dh, float* part, int O, int N, int do_clip, int tile,
                    cudaStream_t stream) {
  using C = Bf<H>;
  const int T = (N + tile - 1) / tile;
  uint32_t* img = image_in(part, (size_t)O * T * make_layout(H).total);
  if ((uintptr_t)part % 16 != 0) return (int)cudaErrorInvalidValue;
  int err = launch_image(w, img, O, H, stream);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ff_bwd_bf16_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(T, O);
  ff_bwd_bf16_kernel<H><<<grid, NT, C::SMEM_BYTES, stream>>>(
      pts, w, reinterpret_cast<const bf*>(img), da, dc, dh, part, N, do_clip, tile);
  return (int)cudaGetLastError();
}

// Fused object-field forward (K1) and backward (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in openobj_tpu/ops/fused_field.py:
//   ff_fwd_kernel    <- _fwd_kernel (:160), launched by _fused_core_fwd (:360);
//                       ff_fwd_generic_kernel at widths without a tensor-core
//                       instance (FF_TC_WIDTHS: every multiple of 16 to 128)
//   ff_bwd_kernel    <- _bwd_kernel (:172), launched by _fused_core_bwd (:392);
//                       ff_bwd_generic_kernel at the other widths
//   ff_reduce_kernel <- the cross-tile gradient accumulation that _bwd_kernel
//                       carries along its sequential grid axis (:285-309)
//
// What the function is: per object o and point p, the icosphere positional
// encoding (proj = t . dirs^T, then sin(pi 2^k proj) for k = 0..5), a 4-layer
// ReLU trunk with a skip layer, and the alpha / sigmoid-colour / ReLU
// clip-hidden heads; the backward recomputes that forward and produces every
// weight and bias gradient and the gradient of the direction table. Points
// receive no gradient (nothing upstream of them is trainable).
//
// What bounds both: arithmetic. One point costs about 5h^2 + 268h
// multiply-adds forward (h = hidden width) and about three times that
// backward, against 12 bytes of point in and (4 + 3*4 + 4h) bytes out; at
// h = 32 that is about 70 FLOP per byte, above the card's ratio even for
// FP32-accurate work on the tensor cores. Both kernels therefore keep every
// activation of a chunk of points in shared memory and never write one to
// device memory.
//
// Shared by both, against the TPU kernel:
//  * Pallas pads N to its tile; here each block masks its ragged edge.
//  * The projection t . dirs^T is an explicit FMA chain with the plain
//    version's rounding, and the bands use sinf/cosf, never the __sinf
//    intrinsics: a phase error of one ulp at 32 pi is already 4e-6.
//
// K1 at h = 16, 32, ..., 128 (FF_TC_WIDTHS) runs its matrix products on the
// tensor cores in 3xTF32, as K2's gradient products do (its section below);
// each template derives its layout from H and the shared-memory budget
// (`Dims`, `FwdDims`). At any other width, ff_fwd_generic_kernel and
// ff_bwd_generic_kernel: FP32 FMAs on the SIMT cores, up to 4x4 outputs per
// thread (`mm`), weights read through the read-only/L2 path by all tiles of
// an object. The choice is made by width before any launch.
//
// K2, what bounds it: about 98% of its multiply-adds are matrix products
// (the recomputed trunk and heads, the weight gradients X^T dY, the input
// gradients dY W^T). On the tensor cores in 3xTF32 they could run at the dense
// TF32 rate / 3 (165 TFLOP/s of FP32-accurate work on an H100 SXM); the rest
// (the 3- and 1-wide heads, d_dirs, the projection) at the FP32 rate of 67
// TFLOP/s. Its bytes (points, cotangents and weights in, one gradient slot per
// block out) at 3.35 TB/s take far less time than either.
// What the design does about it:
//  * The gradient products (two thirds of the work) run on the tensor cores:
//    mma.sync m16n8k8 with tf32 operands, each split into hi = tf32(x) and
//    lo = tf32(x - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi per 8-deep step,
//    the steps summed in f32 (`product`): within ~2^-22 of FP32, no TF32
//    rounding left in the result. Fragments are loaded element by element,
//    so a width pads only to the tile (K to 8, M to 16), and bias gradients
//    ride along as a column of ones (`Dims`).
//  * The recomputed forward stays on the SIMT cores in FP32 with the plain
//    version's rounding (`fp32_layer`): its signs are the backward's ReLU
//    masks, and 3xTF32 rounding flipped a few of them per room_0 step.
//  * Each warp owns a fixed set of 16 x 8 output tiles of each product, so
//    barriers sit only between dependent layers (16 per chunk of 32 points)
//    and every accumulator has one owner: no atomics, deterministic.
//  * Shared-memory matrices are XOR-swizzled (`Sw`), so that both fragment
//    patterns (X and X^T, W and W^T) read 32 different banks.
//  * Where the weights and the weight-gradient accumulators fit in shared
//    memory beside a chunk (h = 16 and 32; at h = 32 55 KB and 70 KB with
//    padding), the weights are copied there once per block with cp.async,
//    and the weight gradients are accumulated there across all chunks of
//    the block's tile; the block writes its slot once. The tile is as long
//    as fills the card in the fewest waves of one block per SM
//    (ops.fused_field.bwd_tile).
//  * Otherwise (h = 48 to 128; 465 KB of weights at h = 128) B fragments
//    come from global memory (L2-resident). A tile is one chunk, so the
//    accumulators of each weight-gradient tile go from registers to the slot
//    once: no per-chunk read-modify-write of the slot.
//  * The TPU accumulates weight gradients across ray tiles in order along
//    its grid. Blocks here run in parallel, so each block owns one (object,
//    tile) slot of a scratch buffer and ff_reduce_kernel sums the slots in
//    tile order, so that results are deterministic.
//
// The C entry points return cudaGetLastError() after each launch; the
// Python wrapper raises if it is not cudaSuccess.
//
// The bf16 instantiation (compute_dtype="bf16", the TPU kernels' `cdt`):
// csrc/fused_field_bf16.cu defines FF_BF16 and includes this file, so that
// every kernel here is built a second time, into its own library, with
// BF16 = true. Then every matrix product but the projection rounds both
// operands to bf16 (cvt.rn: round to nearest even, as astype(bfloat16))
// and sums in f32; biases are added, and bias gradients summed, in f32.
// The SIMT kernels round their operands before each FMA. K1 and K2 at the
// tensor-core widths are kernels of their own in the bf16 build, on the
// bf16 tensor cores: ff_fwd_bf16_kernel (csrc/fused_field_fwd_bf16.cuh) and
// ff_bwd_bf16_kernel (csrc/fused_field_bwd_bf16.cuh); ff_fwd_kernel and
// ff_bwd_kernel below are the f32 build's only.

// Without nvcc (tests/test_torch_kernel_emulation.py runs K2 on the CPU), a
// header included ahead of this file stands in for the CUDA runtime and the
// inline-PTX helpers under `#ifdef __CUDACC__` below.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <cstdint>

namespace {

#ifdef FF_BF16
constexpr bool BF16 = true;           // products on bf16-rounded operands
#else
constexpr bool BF16 = false;          // products in full f32
#endif

constexpr int NT = 256;               // threads per block
constexpr int E1 = 87;                // trunk embedding: t(3) + 4 bands x 21
constexpr int E2 = 42;                // head embedding: 2 bands x 21
constexpr int ND = 21;                // icosphere directions
constexpr int NF = 6;                 // frequency bands (max_deg = 5)
constexpr float ALPHA_SCALE = 10.0f;
// odd leading dimensions keep the strided shared-memory reads conflict-free
constexpr int LD_E1 = 87;
constexpr int LD_E2 = 43;
constexpr int LD_T = 3;
constexpr int LD_P = 21;

// Packed per-object parameter layout, identical to
// openobj_torch.ops.fused_field.param_layout (weights row-major [in][out]).
struct Layout {
  int dirs, w_in, b_in, w_mid1, b_mid1, w_cat, b_cat, w_mid2, b_mid2,
      w_alpha, b_alpha, w_col, b_col, w_oc, b_oc, w_clip, b_clip, total;
};

__host__ __device__ inline Layout make_layout(int h) {
  Layout L;
  int o = 0;
  L.dirs = o;    o += ND * 3;
  L.w_in = o;    o += E1 * h;
  L.b_in = o;    o += h;
  L.w_mid1 = o;  o += h * h;
  L.b_mid1 = o;  o += h;
  L.w_cat = o;   o += (h + E1) * h;
  L.b_cat = o;   o += h;
  L.w_mid2 = o;  o += h * h;
  L.b_mid2 = o;  o += h;
  L.w_alpha = o; o += h;
  L.b_alpha = o; o += 1;
  L.w_col = o;   o += (h + E2) * h;
  L.b_col = o;   o += h;
  L.w_oc = o;    o += h * 3;
  L.b_oc = o;    o += 3;
  L.w_clip = o;  o += (h + E2) * h;
  L.b_clip = o;  o += h;
  L.total = o;
  return L;
}

// Points per chunk held in shared memory at once: the largest that fits.
// Halving it to fit two blocks per SM was slower at both room_0 shapes on
// an H100 (PERF.md).
__host__ __device__ inline int chunk_points(int h) { return h <= 64 ? 64 : 32; }

__host__ __device__ inline int ld_h(int h) { return h | 1; }

#ifdef __CUDACC__
// x rounded to the nearest bf16 (ties to even), as an f32
__device__ inline float round_bf16(float x) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffff0000u);
}
#endif

// An operand of a product: rounded to bf16 in the bf16 build, as it is in f32.
__device__ inline float op(float x) {
  if constexpr (BF16) return round_bf16(x);
  else return x;
}

// C[m][n] (+)= sum_k A[m*sam + k*sak] * B[k*sbk + n*sbn] for m < M, n < N.
// Each thread owns up to RM x 4 outputs, strided by the thread grid so that
// neighbouring threads touch neighbouring columns.
template <int RM>
__device__ void mm_rows(int M, int N, int K,
                        const float* __restrict__ A, int sam, int sak,
                        const float* __restrict__ B, int sbk, int sbn,
                        float* C, int scm, int scn, bool acc) {
  const int n4 = (N + 3) / 4;
  int tn = 1;
  while (tn < n4 && tn < 32) tn <<= 1;
  const int tm = NT / tn;
  const int cx = threadIdx.x % tn;
  const int cy = threadIdx.x / tn;
  for (int m0 = cy; m0 < M; m0 += RM * tm) {
    for (int n0 = cx; n0 < N; n0 += 4 * tn) {
      const float* ap[RM];
      const float* bp[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) ap[i] = A + min(m0 + i * tm, M - 1) * sam;
#pragma unroll
      for (int j = 0; j < 4; ++j) bp[j] = B + min(n0 + j * tn, N - 1) * sbn;
      float c[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
      for (int k = 0; k < K; ++k) {
        float a[RM], b[4];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = op(ap[i][k * sak]);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = op(bp[j][k * sbk]);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = m0 + i * tm;
        if (m >= M) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + j * tn;
          if (n >= N) break;
          float* cp = C + m * scm + n * scn;
          *cp = acc ? *cp + c[i][j] : c[i][j];
        }
      }
    }
  }
}

// The rows per thread follow the output size, so that a small product does
// not spend FMAs on rows past M. The (m, n) -> thread mapping depends only on
// (M, N), so a later call with the same (M, N) and acc = true reads back
// exactly the values this thread wrote. No barrier inside; the caller
// synchronises.
__device__ void mm(int M, int N, int K,
                   const float* __restrict__ A, int sam, int sak,
                   const float* __restrict__ B, int sbk, int sbn,
                   float* C, int scm, int scn, bool acc) {
  if (M * N <= NT * 4) {
    mm_rows<1>(M, N, K, A, sam, sak, B, sbk, sbn, C, scm, scn, acc);
  } else if (M * N <= NT * 8) {
    mm_rows<2>(M, N, K, A, sam, sak, B, sbk, sbn, C, scm, scn, acc);
  } else {
    mm_rows<4>(M, N, K, A, sam, sak, B, sbk, sbn, C, scm, scn, acc);
  }
}

// X[p][j] = relu(X[p][j] + b[j])
__device__ void bias_relu(float* X, int ld, int P, int N, const float* b) {
  for (int i = threadIdx.x; i < P * N; i += NT) {
    const int p = i / N, j = i - p * N;
    const float v = X[p * ld + j] + b[j];
    X[p * ld + j] = v > 0.0f ? v : 0.0f;
  }
}

// Scaled points of one chunk -> t, proj and the two embedding pieces.
__device__ void encode(const float* __restrict__ pts, const float* __restrict__ dirs,
                       int nv, float* tt, float* pj, float* e1, float* e2) {
  for (int i = threadIdx.x; i < nv * 3; i += NT) {
    const int p = i / 3, c = i - p * 3;
    const float v = pts[i];
    tt[p * LD_T + c] = v;
    e1[p * LD_E1 + c] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nv * ND; i += NT) {
    const int p = i / ND, d = i - p * ND;
    const float* t = tt + p * LD_T;
    const float* dr = dirs + d * 3;
    // full f32 as an explicit FMA chain, the same rounding as the plain
    // version (embedding.project): fma(t2, d2, fma(t1, d1, t0 d0))
    const float pr = fmaf(t[2], dr[2], fmaf(t[1], dr[1], __fmul_rn(t[0], dr[0])));
    pj[p * LD_P + d] = pr;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const float f = (float)(3.14159265358979323846 * (double)(1 << k));
      const float s = sinf(__fmul_rn(f, pr));
      if (k < 4) e1[p * LD_E1 + 3 + ND * k + d] = s;
      else e2[p * LD_E2 + ND * (k - 4) + d] = s;
    }
  }
}

// The trunk: h1, h2, hc, h3 (bias + ReLU applied). Buffers may alias as
// long as h1 != h2 and hc != h2, hc != h3.
__device__ void trunk(const float* W, const Layout& L, int h, int nv,
                      const float* e1, float* h1, float* h2, float* hc,
                      float* h3) {
  const int ldh = ld_h(h);
  mm(nv, h, E1, e1, LD_E1, 1, W + L.w_in, h, 1, h1, ldh, 1, false);
  __syncthreads();
  bias_relu(h1, ldh, nv, h, W + L.b_in);
  __syncthreads();
  mm(nv, h, h, h1, ldh, 1, W + L.w_mid1, h, 1, h2, ldh, 1, false);
  __syncthreads();
  bias_relu(h2, ldh, nv, h, W + L.b_mid1);
  __syncthreads();
  mm(nv, h, h, h2, ldh, 1, W + L.w_cat, h, 1, hc, ldh, 1, false);
  mm(nv, h, E1, e1, LD_E1, 1, W + L.w_cat + h * h, h, 1, hc, ldh, 1, true);
  __syncthreads();
  bias_relu(hc, ldh, nv, h, W + L.b_cat);
  __syncthreads();
  mm(nv, h, h, hc, ldh, 1, W + L.w_mid2, h, 1, h3, ldh, 1, false);
  __syncthreads();
  bias_relu(h3, ldh, nv, h, W + L.b_mid2);
  __syncthreads();
}

// relu(h3 W[:h] + e2 W[h:] + b) into out (one of the two e2-fed heads)
__device__ void head(const float* W, int w_off, int b_off, int h, int nv,
                     const float* h3, const float* e2, float* out) {
  const int ldh = ld_h(h);
  mm(nv, h, h, h3, ldh, 1, W + w_off, h, 1, out, ldh, 1, false);
  mm(nv, h, E2, e2, LD_E2, 1, W + w_off + h * h, h, 1, out, ldh, 1, true);
  __syncthreads();
  bias_relu(out, ldh, nv, h, W + b_off);
  __syncthreads();
}

__device__ inline float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ inline float dot_w(const float* x, const float* w, int n, int sw) {
  float s = 0.0f;
  for (int k = 0; k < n; ++k) s = fmaf(op(x[k]), op(w[k * sw]), s);
  return s;
}

// ------------------------------------------------- K1 at other widths (SIMT)

__global__ void __launch_bounds__(NT)
ff_fwd_generic_kernel(const float* __restrict__ pts, const float* __restrict__ w,
              float* __restrict__ alpha, float* __restrict__ color,
              float* __restrict__ hclip, int N, int h, int do_clip) {
  extern __shared__ float sm[];
  const int TP = chunk_points(h);
  const int ldh = ld_h(h);
  const int o = blockIdx.y;
  const int p0 = blockIdx.x * TP;
  const int nv = min(TP, N - p0);
  const Layout L = make_layout(h);
  const float* W = w + (size_t)o * L.total;

  float* tt = sm;
  float* pj = tt + TP * LD_T;
  float* e1 = pj + TP * LD_P;
  float* e2 = e1 + TP * LD_E1;
  float* ha = e2 + TP * LD_E2;
  float* hb = ha + TP * ldh;

  const size_t row0 = (size_t)o * N + p0;
  encode(pts + row0 * 3, W + L.dirs, nv, tt, pj, e1, e2);
  __syncthreads();
  trunk(W, L, h, nv, e1, ha, hb, ha, hb);      // h3 in hb
  head(W, L.w_col, L.b_col, h, nv, hb, e2, ha);  // hcol in ha

  for (int i = threadIdx.x; i < nv * 4; i += NT) {
    const int p = i >> 2, c = i & 3;
    if (c == 3) {
      const float a = dot_w(hb + p * ldh, W + L.w_alpha, h, 1) + W[L.b_alpha];
      alpha[row0 + p] = a * ALPHA_SCALE;
    } else {
      const float v = dot_w(ha + p * ldh, W + L.w_oc + c, h, 3) + W[L.b_oc + c];
      color[(row0 + p) * 3 + c] = sigmoid_f(v);
    }
  }
  if (!do_clip) return;
  __syncthreads();
  head(W, L.w_clip, L.b_clip, h, nv, hb, e2, ha);  // hclip in ha
  for (int i = threadIdx.x; i < nv * h; i += NT) {
    const int p = i / h, j = i - p * h;
    hclip[(row0 + p) * h + j] = ha[p * ldh + j];
  }
}

// ------------------------------------------------- K2 at other widths (SIMT)
//
// ff_bwd_generic_kernel: the backward at any width, on the SIMT cores with
// K1-generic's building blocks (`encode`, `trunk`, `head`, `mm`). A block
// owns one (object, tile) slot of the scratch buffer, as ff_bwd_kernel does,
// and walks its tile in chunks of `tp` points: it recomputes the chunk's
// forward (the same FMAs as ff_fwd_generic_kernel) into shared memory, then
// runs the chain rule layer by layer, each weight gradient X^T dY written
// into its slot by `mm` (the first chunk stores, later chunks add: `mm`
// gives an output to the same thread whenever (M, N) are the same, so the
// read-modify-write needs no barrier). Deterministic, like ff_bwd_kernel.

// shared-memory floats of a chunk of tp points: t, proj, e1, e2, d_e1, d_e2,
// the colour and alpha cotangents, and 7 [tp][h] activations
__host__ __device__ inline int bwd_generic_floats(int h, int tp) {
  return tp * (LD_T + LD_P + 2 * LD_E1 + 2 * LD_E2 + 4 + 1 + 7 * ld_h(h));
}

constexpr int SMEM_OPTIN_FLOATS = 232448 / 4;   // sm_90's opt-in limit per block

// Points per chunk of the SIMT backward: 32, halved until the chunk fits.
inline int bwd_generic_chunk(int h) {
  int tp = 32;
  while (tp > 1 && bwd_generic_floats(h, tp) > SMEM_OPTIN_FLOATS) tp /= 2;
  return tp;
}

// dst[j] (+)= sum_{p < P} X[p][j] for j < N, one thread per column
__device__ void col_sum(const float* X, int ld, int P, int N, float* dst, bool acc) {
  for (int j = threadIdx.x; j < N; j += NT) {
    float s = 0.0f;
    for (int p = 0; p < P; ++p) s += X[p * ld + j];
    dst[j] = acc ? dst[j] + s : s;
  }
}

// D[p][j] = D[p][j] * (A[p][j] > 0): a ReLU's backward, in place
__device__ void relu_mask(float* D, const float* A, int ld, int P, int N) {
  for (int i = threadIdx.x; i < P * N; i += NT) {
    const int p = i / N, j = i - p * N;
    if (!(A[p * ld + j] > 0.0f)) D[p * ld + j] = 0.0f;
  }
}

// the weight gradients of one layer fed by [x | e]:
// G[w_off] (+)= [x | e]^T d over nv rows, G[b_off] (+)= column sums of d
__device__ void layer_grads(float* G, int w_off, int b_off, int h, int nv, int ne,
                            const float* x, const float* e, int lde, const float* d,
                            bool acc) {
  const int ldh = ld_h(h);
  mm(h, h, nv, x, 1, ldh, d, ldh, 1, G + w_off, h, 1, acc);
  if (ne) mm(ne, h, nv, e, 1, lde, d, ldh, 1, G + w_off + h * h, h, 1, acc);
  col_sum(d, ldh, nv, h, G + b_off, acc);
}

__global__ void __launch_bounds__(NT)
ff_bwd_generic_kernel(const float* __restrict__ pts, const float* __restrict__ w,
                      const float* __restrict__ da, const float* __restrict__ dc,
                      const float* __restrict__ dh, float* __restrict__ part,
                      int N, int h, int do_clip, int tile, int tp) {
  extern __shared__ float sm[];
  const int ldh = ld_h(h);
  const int o = blockIdx.y;
  const Layout L = make_layout(h);
  const float* W = w + (size_t)o * L.total;
  float* G = part + ((size_t)o * gridDim.x + blockIdx.x) * L.total;

  float* tt = sm;
  float* pj = tt + tp * LD_T;      // proj, then d_proj
  float* e1 = pj + tp * LD_P;
  float* e2 = e1 + tp * LD_E1;
  float* de1 = e2 + tp * LD_E2;
  float* de2 = de1 + tp * LD_E1;
  float* dcp = de2 + tp * LD_E2;   // sigmoid-input cotangent
  float* dal = dcp + tp * 4;       // alpha pre-scale cotangent
  float* h1 = dal + tp;
  float* h2 = h1 + tp * ldh;
  float* hc = h2 + tp * ldh;
  float* h3 = hc + tp * ldh;
  float* ha = h3 + tp * ldh;       // hcol -> d_hcol -> d_hc
  float* hb = ha + tp * ldh;       // d_hclip -> d_h2
  float* d3 = hb + tp * ldh;       // d_h3 -> d_h1

  if (!do_clip) {   // the clip head's slot, which no chunk writes
    for (int i = L.w_clip + threadIdx.x; i < L.total; i += NT) G[i] = 0.0f;
  }
  const int t0 = blockIdx.x * tile;
  const int t1 = min(N, t0 + tile);
  for (int c0 = t0; c0 < t1; c0 += tp) {
    const int nv = min(tp, t1 - c0);
    const bool acc = c0 != t0;
    const size_t row0 = (size_t)o * N + c0;

    // ---- recompute the forward (K1-generic's FMAs)
    encode(pts + row0 * 3, W + L.dirs, nv, tt, pj, e1, e2);
    __syncthreads();
    trunk(W, L, h, nv, e1, h1, h2, hc, h3);
    head(W, L.w_col, L.b_col, h, nv, h3, e2, ha);
    if (do_clip) head(W, L.w_clip, L.b_clip, h, nv, h3, e2, hb);

    // ---- the heads' cotangents: colour through its sigmoid, alpha, d_hclip
    for (int i = threadIdx.x; i < nv * 3; i += NT) {
      const int p = i / 3, c = i - p * 3;
      const float col = sigmoid_f(dot_w(ha + p * ldh, W + L.w_oc + c, h, 3) + W[L.b_oc + c]);
      dcp[p * 4 + c] = dc[(row0 + p) * 3 + c] * col * (1.0f - col);
    }
    for (int p = threadIdx.x; p < nv; p += NT) dal[p] = da[row0 + p] * ALPHA_SCALE;
    if (do_clip) {
      for (int i = threadIdx.x; i < nv * h; i += NT) {
        const int p = i / h, j = i - p * h;
        hb[p * ldh + j] = hb[p * ldh + j] > 0.0f ? dh[(row0 + p) * h + j] : 0.0f;
      }
    }
    __syncthreads();
    // the 3- and 1-wide heads' gradients
    mm(h, 3, nv, ha, 1, ldh, dcp, 4, 1, G + L.w_oc, 3, 1, acc);
    col_sum(dcp, 4, nv, 3, G + L.b_oc, acc);
    mm(h, 1, nv, h3, 1, ldh, dal, 1, 1, G + L.w_alpha, 1, 1, acc);
    col_sum(dal, 1, nv, 1, G + L.b_alpha, acc);
    __syncthreads();
    // d_hcol = (dcp w_oc^T) * (hcol > 0), in place
    for (int i = threadIdx.x; i < nv * h; i += NT) {
      const int p = i / h, j = i - p * h;
      const float* wo = W + L.w_oc + j * 3;
      const float* d = dcp + p * 4;
      const float v = fmaf(op(d[2]), op(wo[2]), fmaf(op(d[1]), op(wo[1]), op(d[0]) * op(wo[0])));
      ha[p * ldh + j] = ha[p * ldh + j] > 0.0f ? v : 0.0f;
    }
    __syncthreads();

    // ---- e2-fed heads: weight grads; d_h3 (before its mask) and d_e2
    layer_grads(G, L.w_col, L.b_col, h, nv, E2, h3, e2, LD_E2, ha, acc);
    mm(nv, h, h, ha, ldh, 1, W + L.w_col, 1, h, d3, ldh, 1, false);
    mm(nv, E2, h, ha, ldh, 1, W + L.w_col + h * h, 1, h, de2, LD_E2, 1, false);
    if (do_clip) {
      layer_grads(G, L.w_clip, L.b_clip, h, nv, E2, h3, e2, LD_E2, hb, acc);
      mm(nv, h, h, hb, ldh, 1, W + L.w_clip, 1, h, d3, ldh, 1, true);
      mm(nv, E2, h, hb, ldh, 1, W + L.w_clip + h * h, 1, h, de2, LD_E2, 1, true);
    }
    __syncthreads();
    // d_h3 = (. + dal w_alpha^T) * (h3 > 0)
    for (int i = threadIdx.x; i < nv * h; i += NT) {
      const int p = i / h, j = i - p * h;
      const float v = fmaf(op(dal[p]), op(W[L.w_alpha + j]), d3[p * ldh + j]);
      d3[p * ldh + j] = h3[p * ldh + j] > 0.0f ? v : 0.0f;
    }
    __syncthreads();

    // ---- mid2: weight grad; d_hc = (d_h3 w_mid2^T) * (hc > 0)
    layer_grads(G, L.w_mid2, L.b_mid2, h, nv, 0, hc, nullptr, 0, d3, acc);
    mm(nv, h, h, d3, ldh, 1, W + L.w_mid2, 1, h, ha, ldh, 1, false);
    __syncthreads();
    relu_mask(ha, hc, ldh, nv, h);
    __syncthreads();

    // ---- skip layer: [w_cat; b_cat] grads; d_h2 (masked) and d_e1
    layer_grads(G, L.w_cat, L.b_cat, h, nv, E1, h2, e1, LD_E1, ha, acc);
    mm(nv, h, h, ha, ldh, 1, W + L.w_cat, 1, h, hb, ldh, 1, false);
    mm(nv, E1, h, ha, ldh, 1, W + L.w_cat + h * h, 1, h, de1, LD_E1, 1, false);
    __syncthreads();
    relu_mask(hb, h2, ldh, nv, h);
    __syncthreads();

    // ---- mid1: weight grad; d_h1 = (d_h2 w_mid1^T) * (h1 > 0)
    layer_grads(G, L.w_mid1, L.b_mid1, h, nv, 0, h1, nullptr, 0, hb, acc);
    mm(nv, h, h, hb, ldh, 1, W + L.w_mid1, 1, h, d3, ldh, 1, false);
    __syncthreads();
    relu_mask(d3, h1, ldh, nv, h);
    __syncthreads();

    // ---- in_layer: [w_in; b_in] grads; d_e1 += d_h1 w_in^T
    mm(E1, h, nv, e1, 1, LD_E1, d3, ldh, 1, G + L.w_in, h, 1, acc);
    col_sum(d3, ldh, nv, h, G + L.b_in, acc);
    mm(nv, E1, h, d3, ldh, 1, W + L.w_in, 1, h, de1, LD_E1, 1, true);
    __syncthreads();

    // ---- PE backward: d_proj = sum_k f_k cos(f_k proj) d_sin_k; d_dirs
    for (int i = threadIdx.x; i < nv * ND; i += NT) {
      const int p = i / ND, d = i - p * ND;
      const float pr = pj[p * LD_P + d];
      float g = 0.0f;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const float f = (float)(3.14159265358979323846 * (double)(1 << k));
        const float ds = k < 4 ? de1[p * LD_E1 + 3 + ND * k + d]
                               : de2[p * LD_E2 + ND * (k - 4) + d];
        g += (f * cosf(__fmul_rn(f, pr))) * ds;
      }
      pj[p * LD_P + d] = g;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ND * 3; e += NT) {
      const int d = e / 3, c = e - d * 3;
      float s = 0.0f;
      for (int p = 0; p < nv; ++p) s = fmaf(op(pj[p * LD_P + d]), op(tt[p * LD_T + c]), s);
      G[L.dirs + e] = acc ? G[L.dirs + e] + s : s;
    }
    __syncthreads();   // the next chunk's encode overwrites t and proj
  }
}

// ------------------------------------------------------------------------ K2

constexpr int BP = 32;        // points per backward chunk
constexpr int NW = NT / 32;   // warps per block

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory matrix [rows][LD], LD a multiple of 32, whose columns are
// permuted within each row by an XOR of bits 2-4 with the row's low three
// bits. Both access patterns of the mma fragments then touch 32 different
// banks: row = lane&3 (+4), column = lane>>2 (+ a multiple of 8), and
// row = lane>>2 (+ a multiple of 8), column = lane&3 (+ a multiple of 4).
// The XOR keeps aligned pairs of columns adjacent (float2 access).
template <int LD>
struct Sw {
  float* p;
  __device__ float& operator()(int r, int c) const {
    return p[r * LD + (c ^ (((r & 3) << 3) | (r & 4)))];
  }
  __device__ float2& pair(int r, int c) const {   // columns c, c + 1; c even
    return *reinterpret_cast<float2*>(&(*this)(r, c));
  }
};

// The widths the tensor-core kernels take: every product's M and N are
// whole 16-row tiles (H, H + 48 and 2H; H + 88 in 8-column tiles), and one
// chunk's buffers fit in shared memory (196 KB for K2 at h = 128; a
// width over 128 would need a shorter chunk).
__host__ __device__ constexpr bool tc_shape(int h) { return h >= 16 && h <= 128 && h % 16 == 0; }

// Outputs per thread along N in `fp32_layer`: the fewest, from 2 (4 at
// N >= 128), with which a row of N / RN threads divides the block and the
// block's rows divide the chunk (3 at N = 48 and 96, 5 at 80, 7 at 112).
__host__ __device__ constexpr int layer_rn(int n) {
  int r = n >= 128 ? 4 : 2;
  while (n % r != 0 || NT % (n / r) != 0 || BP % (NT / (n / r)) != 0) ++r;
  return r;
}

// Shapes of K2 at hidden width H. Bias gradients ride along: e1 gets a
// column of ones after its 87 features, so row 87 of the weight-gradient
// product [e1 | 1]^T d_h1 is b_in's gradient, and the packed layout puts
// each bias right after its weight, so [w_in; b_in] is one block of rows.
// The same holds for the skip layer ([h2 | e1 | 1], w_cat, b_cat) and both
// e2-fed heads ([h3 | e2 | 1 | 0 x 5], w_col / w_clip and their biases).
template <int H>
struct Dims {
  static_assert(tc_shape(H), "the tensor-core kernels take H = 16, 32, ..., 128");
  // row length of an h-wide `Sw` matrix: its XOR permutes columns within
  // aligned groups of 32, so a row of 16 or 48 would spill into the next
  static constexpr int LH = round_up(H, 32);
  static constexpr int KX2 = H + 88;                 // [h2 | e1 | 1]
  static constexpr int LDX2 = round_up(KX2, 32);
  static constexpr int MX2 = round_up(KX2, 16);      // rows of w_cat's gradient product
  static constexpr int KX3 = H + 48;                 // [h3 | e2 | 1 | 0 x 5]
  static constexpr int LDX3 = round_up(KX3, 32);
  static constexpr int RH = H + 43;                  // head weight rows with the bias
  static constexpr int ME1 = 96;                     // rows of w_in's gradient product
  // The object's weights and the block's weight-gradient accumulators, in
  // shared memory for the whole tile where they fit (SMEM_W below). Row
  // offsets (multiples of 8).
  static constexpr int WR_IN = 0, WR_MID1 = 88, WR_CAT = WR_MID1 + H,
                       WR_MID2 = WR_CAT + KX2, WR_COL = WR_MID2 + H,
                       WR_CLIP = WR_COL + KX3, WROWS = WR_CLIP + KX3;
  static constexpr int LDG = H + 8;                  // float2 C fragments: no conflicts
  static constexpr int GR_IN = 0, GR_MID1 = ME1, GR_CAT = GR_MID1 + H,
                       GR_MID2 = GR_CAT + MX2, GR_COL = GR_MID2 + H,
                       GR_CLIP = GR_COL + KX3, GROWS = GR_CLIP + KX3;
  // small gradients accumulated by a fixed thread each
  static constexpr int S_DIRS = 0, S_WA = ND * 3, S_BA = S_WA + H, S_WOC = S_BA + 1,
                       S_BOC = S_WOC + 3 * H, S_BM1 = S_BOC + 3, S_BM2 = S_BM1 + H;
  static constexpr int NS = S_BM2 + H;
  // shared memory in floats: the weights and accumulators, and one chunk's
  // buffers (X2, D2, X3, D3, DH, A1, AC, AO, then t, proj, dcp, dal, S)
  static constexpr int W_FLOATS = WROWS * LH + GROWS * LDG;
  static constexpr int CHUNK_FLOATS =
      BP * (2 * LDX2 + 2 * LDX3 + 2 * H + 3 * LH) + BP * (4 + ND + 4 + 1) + NS;
  // Weights and accumulators stay on chip where both fit beside the chunk
  // (h = 16, 32); otherwise B fragments come from L2 and a tile is one chunk.
  static constexpr bool SMEM_W = W_FLOATS + CHUNK_FLOATS <= SMEM_OPTIN_FLOATS;
  static constexpr int SMEM_FLOATS = (SMEM_W ? W_FLOATS : 0) + CHUNK_FLOATS;
  static_assert(SMEM_FLOATS <= SMEM_OPTIN_FLOATS, "a chunk must fit in shared memory");
  // n-tiles per item of an N = H product: two (each A fragment serves both)
  // where the H x H products then take the 8 warps no longer than with one
  // (h = 64, 128); one otherwise (h = 48: 9 items of two, 18 of one).
  static constexpr int NBF =
      ((H / 16) * (H / 16) + NW - 1) / NW * 2 <= ((H / 16) * (H / 8) + NW - 1) / NW ? 2 : 1;
};

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

// out (M x N) = init + A (M x K) . B (K x N) on the tensor cores in 3xTF32
// (a_lo b_hi + a_hi b_lo + a_hi b_hi), for the items
// (16 rows x 8*NB columns) that fall to this warp. Items are dealt to the
// warps round-robin from `slot`, so that the independent products of one
// phase share the warps; returns the slot after the last item. a(m, k) and
// b(k, n) give single elements (no alignment needed); init(m, n) and
// epi(m, n, v) take the output pair (n, n + 1), n even. The tensor cores
// sum each 8-deep step from zero and the steps are added in f32 with round
// to nearest: the tensor cores' own f32 accumulation truncates, a bias that
// grows with the length of the sum. No barrier inside: an item, and so each
// output, belongs to one fixed thread per call site.
template <int M, int N, int K, int NB, class FI, class FA, class FB, class FE>
__device__ int product(int slot, FI init, FA a, FB b, FE epi) {
  static_assert(M % 16 == 0 && N % (8 * NB) == 0 && K % 8 == 0, "tile shape");
  constexpr int NI = N / (8 * NB), ITEMS = (M / 16) * NI;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int it = (warp - slot % NW + NW) % NW; it < ITEMS; it += NW) {
    const int m0 = (it / NI) * 16, n0 = (it % NI) * 8 * NB;
    float c[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const float2 u = init(m0 + g, n), v = init(m0 + g + 8, n);
      c[j][0] = u.x; c[j][1] = u.y; c[j][2] = v.x; c[j][3] = v.y;
    }
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t ah[4], al[4];
      split(a(m0 + g, k0 + t), ah[0], al[0]);
      split(a(m0 + g + 8, k0 + t), ah[1], al[1]);
      split(a(m0 + g, k0 + t + 4), ah[2], al[2]);
      split(a(m0 + g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t bh[2], bl[2];
        split(b(k0 + t, n0 + 8 * j + g), bh[0], bl[0]);
        split(b(k0 + t + 4, n0 + 8 * j + g), bh[1], bl[1]);
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(d, al, bh);
        mma_tf32(d, ah, bl);
        mma_tf32(d, ah, bh);
#pragma unroll
        for (int i = 0; i < 4; ++i) c[j][i] += d[i];
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      epi(m0 + g, n, make_float2(c[j][0], c[j][1]));
      epi(m0 + g + 8, n, make_float2(c[j][2], c[j][3]));
    }
  }
  return slot + ITEMS;
}

// One layer of the recomputed forward on the SIMT cores: out(m, n, z) for
// z = (x_h . w_h + x_e . w_e) + bias(n) over the chunk's BP points, x_h the
// first KH input columns and x_e the next KE, each dot an FP32 FMA chain from
// k = 0, as torch.bmm in the plain version and K1 round it. The backward's
// ReLU masks are the signs of these z. A pre-activation within a rounding
// error of zero takes the sign its rounding gives it; another rounding (a
// 3xTF32 product, or one chain over [x_h | x_e]) flips a few such masks per
// room_0 step against the plain version, and one flipped mask moves a leaf's
// gradient by more than 1e-3 of its largest entry (measured on an H100).
// Each thread owns RM x RN outputs, rows cy + TM i and columns cx + TN j.
template <int N, int KH, int KE, class FX, class FW, class FB, class FE>
__device__ void fp32_layer(FX x, FW w, FB bias, FE out) {
  constexpr int RN = layer_rn(N);
  constexpr int TN = N / RN, TM = NT / TN, RM = BP / TM;
  static_assert(N % RN == 0 && NT % TN == 0 && BP % TM == 0, "layer shape");
  const int cx = threadIdx.x % TN, cy = threadIdx.x / TN;
  float s[RM][RN], e[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) s[i][j] = e[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < KH; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = op(x(cy + TM * i, k));
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = op(w(k, cx + TN * j));
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll 4
  for (int k = KH; k < KH + KE; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = op(x(cy + TM * i, k));
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = op(w(k, cx + TN * j));
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) e[i][j] = fmaf(a[i], b[j], e[i][j]);
  }
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int n = cx + TN * j;
    const float bn = bias(n);
#pragma unroll
    for (int i = 0; i < RM; ++i) out(cy + TM * i, n, (KE > 0 ? s[i][j] + e[i][j] : s[i][j]) + bn);
  }
}

// One weight matrix of the packed layout, [R][H] row-major with its bias row
// (if any) counted in R: in the block's swizzled shared copy from row r0
// (SMEM_W; rows past R are zero there), or in global memory (L2-resident),
// where rows past R read as zero.
template <int H, bool SMEM>
struct Wm {
  Sw<Dims<H>::LH> s;
  const float* g;
  int r0, R;
  __device__ float at(int r, int c) const {
    if constexpr (SMEM) return s(r0 + r, c);
    else return r < R ? __ldg(g + r * H + c) : 0.0f;
  }
};

#ifdef __CUDACC__
__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }
#endif

// d * (x > 0), elementwise on a pair
__device__ inline float2 mask2(float2 d, float2 x) {
  return make_float2(x.x > 0.0f ? d.x : 0.0f, x.y > 0.0f ? d.y : 0.0f);
}

__device__ inline float2 relu2(float2 v) {
  return make_float2(v.x > 0.0f ? v.x : 0.0f, v.y > 0.0f ? v.y : 0.0f);
}

// ------------------------------------------------------------------------ K1
//
// The forward at h = 16, 32, ..., 128. Every matrix product (the trunk and the
// two e2-fed heads) runs on the tensor cores in 3xTF32 (`rows_product`), on
// K2's activation layouts: [h2 | e1 | 1] for the skip layer, then
// [h3 | e2 | 1 | 0 x 5] for the heads, in one buffer (the first is dead once
// the skip layer has read it), so that each bias rides as a row of its
// packed weight matrix and the skip layer and both heads are one product
// each; mid1's and mid2's biases start the accumulators.
//
// What bounds it on an H100: the matrix products, and with operands split
// at every use (as K2 does) the SIMT work around each mma.sync (swizzled
// addressing, the hi/lo split: about ten instructions per mma) rather than
// the tensor cores. So K1 keeps every shared-memory operand already split
// and in fragment order (`FragA`, `FragB`): each producer (the encode, each
// product's epilogue, the weight copy) splits a value once, and a warp
// reads a fragment with 128-bit loads and no arithmetic. Each epilogue
// applies bias and ReLU and writes the next layer's operand; hclip goes
// from the C fragments straight to device memory, and h3 and hcol also go
// to plain rows for the SIMT alpha and colour heads. The outputs are
// continuous in the rounding (a ReLU whose sign flips sits at ~0), so
// 3xTF32 stays far inside K1's 1e-4 gate.
//
// A block walks a tile of FP-point chunks of one object (`fwd_tile`):
// where they fit (h = 16, 32; at h = 32 55 KB, 110 KB split) it splits the
// object's weights into shared memory once per tile; otherwise (h = 48 to
// 128; 465 KB at h = 128) it reads B fragments from L2 and splits them, each
// fragment serving all FP rows of the chunk. One block fills an SM (up to
// 218 KB of shared memory).

constexpr int FP = 64;          // points per forward chunk

// A matrix of 16-row tiles x KS 8-column steps in shared memory, in the
// order of mma.sync's A fragments, each element pre-split into its TF32 hi
// and lo parts: a (row tile, k-step) block of 256 words holds lane l's
// hi parts (a0..a3) at 4l and its lo parts 128 words later, so that a warp
// reads a fragment with two conflict-free 128-bit loads.
template <int KS>
struct FragA {
  uint32_t* p;
  __device__ static int at(int m, int k) {
    const int r = m & 15, c = k & 7;
    return ((m >> 4) * KS + (k >> 3)) * 256 + ((r & 7) * 4 + (c & 3)) * 4 + (r >> 3) +
           ((c >> 2) << 1);
  }
  __device__ void put(int m, int k, float v) const {
    uint32_t h, l;
    split(v, h, l);
    p[at(m, k)] = h;
    p[at(m, k) + 128] = l;
  }
  // a 16 x 8 tile from its C fragments (c0, c1 = C[g][2t], C[g][2t + 1];
  // c2, c3 eight rows on) into A fragments (a0 = A[g][t], a1 eight rows on,
  // a2 = A[g][t + 4], a3): four values from the two lanes of the quad that
  // hold them, then two conflict-free 128-bit stores
  __device__ void put_tile(int mt, int ks, const float (&c)[4]) const {
    const int lane = threadIdx.x & 31, src = (lane & ~3) | ((lane & 3) >> 1);
    const bool odd = lane & 1;
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // a_i: row +8 if i is odd, column +4 if i >= 2
      const int from = src + (i >> 1) * 2, e = (i & 1) * 2;
      const float x = __shfl_sync(0xffffffffu, c[e], from);
      const float y = __shfl_sync(0xffffffffu, c[e + 1], from);
      a[i] = odd ? y : x;
    }
    uint4 h, l;
    split(a[0], h.x, l.x);
    split(a[1], h.y, l.y);
    split(a[2], h.z, l.z);
    split(a[3], h.w, l.w);
    uint4* q = reinterpret_cast<uint4*>(p + (mt * KS + ks) * 256) + lane;
    q[0] = h;
    q[32] = l;
  }
  __device__ void frag(int mt, int ks, uint32_t (&h)[4], uint32_t (&l)[4]) const {
    const uint4* q = reinterpret_cast<const uint4*>(p + (mt * KS + ks) * 256) + (threadIdx.x & 31);
    const uint4 u = q[0], v = q[32];
    h[0] = u.x; h[1] = u.y; h[2] = u.z; h[3] = u.w;
    l[0] = v.x; l[1] = v.y; l[2] = v.z; l[3] = v.w;
  }
};

// A [K][8 NTS] weight matrix in the order of mma.sync's B fragments,
// pre-split: a (k-step, n-tile) block of 128 words holds lane l's
// {b0 hi, b1 hi, b0 lo, b1 lo} at 4l (one 128-bit load).
template <int NTS>
struct FragB {
  uint32_t* p;
  __device__ void put(int k, int n, float v) const {
    const int i = (((k >> 3) * NTS + (n >> 3)) * 32 + (n & 7) * 4 + (k & 3)) * 4 + ((k >> 2) & 1);
    uint32_t h, l;
    split(v, h, l);
    p[i] = h;
    p[i + 2] = l;
  }
  __device__ void frag(int ks, int nt, uint32_t (&h)[2], uint32_t (&l)[2]) const {
    const uint4 u = reinterpret_cast<const uint4*>(p + (ks * NTS + nt) * 128)[threadIdx.x & 31];
    h[0] = u.x; h[1] = u.y; l[0] = u.z; l[1] = u.w;
  }
};

// One packed weight matrix [R][H] (bias row counted in R; rows past R read
// as zero) as B fragments: from its split copy in shared memory from k-step
// ks0 (SMEM_W), or from device memory (L2-resident), split as it is read.
template <int H, bool SMEM>
struct WFrag {
  FragB<H / 8> s;
  const float* g;
  int R;
  __device__ void frag(int ks, int nt, uint32_t (&h)[2], uint32_t (&l)[2]) const {
    if constexpr (SMEM) {
      s.frag(ks, nt, h, l);
    } else {
      const int lane = threadIdx.x & 31, k = 8 * ks + (lane & 3), n = 8 * nt + (lane >> 2);
      split(k < R ? __ldg(g + k * H + n) : 0.0f, h[0], l[0]);
      split(k + 4 < R ? __ldg(g + (k + 4) * H + n) : 0.0f, h[1], l[1]);
    }
  }
};

// out (M x N) = init + A (M x K) . B (K x N) in 3xTF32, as `product` (the
// same three mma.sync per tile and f32 sums of each 8-deep step), for items
// of MT 16-row tiles x NB 8-column tiles dealt to the warps round-robin:
// each B fragment serves MT row tiles, each A fragment NB column tiles.
// a(mt, ks, hi, lo) and b(ks, nt, hi, lo) give split fragments; init(m, n)
// takes the output pair (n, n + 1), n even; epi(mt, nt, c) takes the C
// fragment of the 16 x 8 tile (mt, nt).
template <int M, int N, int K, int NB, int MT, class FI, class FA, class FB, class FE>
__device__ void rows_product(FI init, FA a, FB b, FE epi) {
  static_assert(M % (16 * MT) == 0 && N % (8 * NB) == 0 && K % 8 == 0, "tile shape");
  constexpr int NI = N / (8 * NB), ITEMS = (M / (16 * MT)) * NI;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int it = warp; it < ITEMS; it += NW) {
    const int mt0 = (it / NI) * MT, nt0 = (it % NI) * NB;
    float c[MT][NB][4];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int m = 16 * (mt0 + r) + g, n = 8 * (nt0 + j) + 2 * t;
        const float2 u = init(m, n), v = init(m + 8, n);
        c[r][j][0] = u.x; c[r][j][1] = u.y; c[r][j][2] = v.x; c[r][j][3] = v.y;
      }
#pragma unroll 2
    for (int ks = 0; ks < K / 8; ++ks) {
      uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) b(ks, nt0 + j, bh[j], bl[j]);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        uint32_t ah[4], al[4];
        a(mt0 + r, ks, ah, al);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(d, al, bh[j]);
          mma_tf32(d, ah, bl[j]);
          mma_tf32(d, ah, bh[j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) c[r][j][i] += d[i];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int j = 0; j < NB; ++j) epi(mt0 + r, nt0 + j, c[r][j]);
  }
}

// f(m, n, v) for the two output pairs of a C fragment of tile (mt, nt)
template <class F>
__device__ void each_pair(int mt, int nt, const float (&c)[4], F f) {
  const int lane = threadIdx.x & 31, m = 16 * mt + (lane >> 2), n = 8 * nt + 2 * (lane & 3);
  f(m, n, make_float2(c[0], c[1]));
  f(m + 8, n, make_float2(c[2], c[3]));
}

template <int H>
struct FwdDims {
  static_assert(tc_shape(H), "ff_fwd_kernel takes H = 16, 32, ..., 128");
  using D = Dims<H>;
  static constexpr int KSX = D::KX2 / 8;        // k-steps of [h2 | e1 | 1]
  // k-step offsets of the split weights in shared memory (SMEM_W)
  static constexpr int WK_IN = 0, WK_MID1 = 11, WK_CAT = WK_MID1 + H / 8,
                       WK_MID2 = WK_CAT + KSX, WK_COL = WK_MID2 + H / 8,
                       WK_CLIP = WK_COL + D::KX3 / 8, WKS = WK_CLIP + D::KX3 / 8;
  static constexpr int LDP = H + 1;             // plain h3 and hcol rows
  static constexpr int SMALL = ND * 3 + 4 * H + 4;   // dirs, w_alpha, b_alpha, w_oc, b_oc
  static constexpr int W_WORDS = WKS * (H / 8) * 128;
  static constexpr int CHUNK_WORDS =
      (FP / 16) * (KSX + H / 8) * 256 + FP * LDP + FP * (4 + ND) + SMALL;
  // The split weights stay in shared memory where they fit beside the chunk
  // (h = 16, 32); otherwise B fragments come from L2.
  static constexpr bool SMEM_W = W_WORDS + CHUNK_WORDS <= SMEM_OPTIN_FLOATS;
  static constexpr int SMEM_WORDS = (SMEM_W ? W_WORDS : 0) + CHUNK_WORDS;
  static_assert(SMEM_WORDS <= SMEM_OPTIN_FLOATS, "a chunk must fit in shared memory");
  // Items of the N = H products, MT row tiles x NB n-tiles. From shared
  // memory a B fragment is one 128-bit load: an item is one row tile and
  // H/16 n-tiles, one item per warp. From L2 a B fragment is two loads and
  // two splits, so each serves all FP/16 row tiles (MT), and an item takes
  // two n-tiles where there are more n-tiles than warps (h = 80 to 128; at
  // most 4 x 2 accumulator tiles, 32 registers).
  static constexpr int MT = SMEM_W ? 1 : FP / 16;
  static constexpr int NB = SMEM_W ? H / 16 : (H / 8 > NW ? 2 : 1);
};

template <int H>
__global__ void __launch_bounds__(NT, 1)
ff_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ w,
              float* __restrict__ alpha, float* __restrict__ color,
              float* __restrict__ hclip, int N, int do_clip, int tile) {
  static_assert(tc_shape(H), "ff_fwd_kernel takes H = 16, 32, ..., 128");
  using D = Dims<H>;
  using F = FwdDims<H>;
  constexpr bool SW = F::SMEM_W;
  constexpr int HS = H / 8;   // k-steps (and n-tiles) of an h-wide operand
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int o = blockIdx.y;
  const Layout L = make_layout(H);
  const float* W = w + (size_t)o * L.total;

  uint32_t* q = reinterpret_cast<uint32_t*>(sm);
  uint32_t* wsp = q;             q += SW ? F::W_WORDS : 0;      // split weights (SMEM_W)
  const FragA<F::KSX> X{q};      q += (FP / 16) * F::KSX * 256;  // [h2 | e1 | 1], then [h3 | e2 | 1 | 0]
  const FragA<HS> HB{q};                                          // h1, then hc
  float* hcp = reinterpret_cast<float*>(q);  q += (FP / 16) * HS * 256;  // then hcol, plain
  float* h3p = reinterpret_cast<float*>(q);  q += FP * F::LDP;   // h3, plain
  float* tt = reinterpret_cast<float*>(q);   q += FP * 4;        // scaled points
  float* pj = reinterpret_cast<float*>(q);   q += FP * ND;       // proj
  // the small parameters: dirs, then [w_alpha; b_alpha] and [w_oc; b_oc]
  float* dirs = reinterpret_cast<float*>(q);
  const float* sh = dirs + ND * 3;

  const auto wm = [&](int ks0, int off, int R) {
    return WFrag<H, SW>{FragB<HS>{wsp + ks0 * HS * 128}, W + off, R};
  };
  const WFrag<H, SW> w_in = wm(F::WK_IN, L.w_in, 88);
  const WFrag<H, SW> w_mid1 = wm(F::WK_MID1, L.w_mid1, H);
  const WFrag<H, SW> w_cat = wm(F::WK_CAT, L.w_cat, D::KX2);
  const WFrag<H, SW> w_mid2 = wm(F::WK_MID2, L.w_mid2, H);
  const WFrag<H, SW> w_col = wm(F::WK_COL, L.w_col, D::RH);
  const WFrag<H, SW> w_clip = wm(F::WK_CLIP, L.w_clip, D::RH);

  if constexpr (SW) {   // the object's weights, split once per block
    const auto load = [&](const WFrag<H, SW>& m, int off, int rows, int padded) {
      for (int i = tid; i < padded * H; i += NT)
        m.s.put(i / H, i % H, i < rows * H ? W[off + i] : 0.0f);
    };
    load(w_in, L.w_in, 88, 88);
    load(w_mid1, L.w_mid1, H, H);
    load(w_cat, L.w_cat, D::KX2, D::KX2);
    load(w_mid2, L.w_mid2, H, H);
    load(w_col, L.w_col, D::RH, D::KX3);
    if (do_clip) load(w_clip, L.w_clip, D::RH, D::KX3);
  }
  // the ones column of [h2 | e1 | 1], past every column the heads' layout uses
  for (int p = tid; p < FP; p += NT) X.put(p, H + 87, 1.0f);
  for (int i = tid; i < ND * 3; i += NT) dirs[i] = W[L.dirs + i];
  for (int i = tid; i < H + 1; i += NT) dirs[ND * 3 + i] = W[L.w_alpha + i];
  for (int i = tid; i < 3 * H + 3; i += NT) dirs[ND * 3 + H + 1 + i] = W[L.w_oc + i];

  const auto bias_init = [&](int off) {
    return [=](int, int n) { return make_float2(W[off + n], W[off + n + 1]); };
  };
  // the start of a product whose bias is a row of its packed weights (the
  // bias rides on the ones column)
  const auto row_bias = [&](int) {
    return [=](int, int) { return make_float2(0.0f, 0.0f); };
  };
  const auto relu_to = [](const auto& buf) {   // the next layer's A fragments
    return [=](int mt, int nt, const float (&c)[4]) {
      const float r[4] = {fmaxf(c[0], 0.0f), fmaxf(c[1], 0.0f), fmaxf(c[2], 0.0f),
                          fmaxf(c[3], 0.0f)};
      buf.put_tile(mt, nt, r);
    };
  };
  const auto wb = [](const WFrag<H, SW>& m) {
    return [=](int ks, int nt, uint32_t (&h)[2], uint32_t (&l)[2]) { m.frag(ks, nt, h, l); };
  };
  const auto xa = [&](int mt, int ks, uint32_t (&h)[4], uint32_t (&l)[4]) { X.frag(mt, ks, h, l); };
  const auto ha = [&](int mt, int ks, uint32_t (&h)[4], uint32_t (&l)[4]) { HB.frag(mt, ks, h, l); };
  // pi 2^k in f32 (k unrolled: a constant)
  const auto band = [](int k) { return (float)(3.14159265358979323846 * (double)(1 << k)); };

  const int t0 = blockIdx.x * tile;
  const int t1 = min(N, t0 + tile);
  for (int c0 = t0; c0 < t1; c0 += FP) {
    const int nv = min(FP, t1 - c0);
    const size_t row0 = (size_t)o * N + c0;

    // ---- encode t, proj and e1 (bands 0-3); rows past nv get t = 0
    for (int i = tid; i < FP * 3; i += NT) {
      const int p = i / 3, c = i - p * 3;
      const float v = p < nv ? pts[row0 * 3 + i] : 0.0f;
      tt[p * 4 + c] = v;
      X.put(p, H + c, v);
    }
    __syncthreads();
    for (int i = tid; i < FP * ND; i += NT) {
      const int p = i / ND, d = i - p * ND;
      const float* t = tt + p * 4;
      const float* dr = dirs + d * 3;
      // full f32 as an explicit FMA chain, the same rounding as the plain
      // version (embedding.project): fma(t2, d2, fma(t1, d1, t0 d0))
      const float pr = fmaf(t[2], dr[2], fmaf(t[1], dr[1], __fmul_rn(t[0], dr[0])));
      pj[i] = pr;
#pragma unroll
      for (int k = 0; k < 4; ++k) X.put(p, H + 3 + ND * k + d, sinf(__fmul_rn(band(k), pr)));
    }
    __syncthreads();

    // ---- the trunk
    rows_product<FP, H, 88, F::NB, F::MT>(     // h1 = relu([e1 | 1] . [w_in; b_in])
        row_bias(L.b_in), [&](int mt, int ks, uint32_t (&h)[4], uint32_t (&l)[4]) { X.frag(mt, HS + ks, h, l); },
        wb(w_in), relu_to(HB));
    __syncthreads();
    rows_product<FP, H, H, F::NB, F::MT>(      // h2
        bias_init(L.b_mid1), ha, wb(w_mid1), relu_to(X));
    __syncthreads();
    rows_product<FP, H, D::KX2, F::NB, F::MT>(   // hc = relu([h2 | e1 | 1] . [w_cat; b_cat])
        row_bias(L.b_cat), xa, wb(w_cat), relu_to(HB));
    __syncthreads();
    // [h2 | e1 | 1] is dead: the heads' layout [h3 | e2 | 1 | 0 x 5] takes
    // its place, h3 from mid2 (and a plain copy for alpha), e2 (bands 4, 5)
    for (int i = tid; i < FP * ND; i += NT) {
      const int p = i / ND, d = i - p * ND;
#pragma unroll
      for (int k = 4; k < NF; ++k) X.put(p, H + ND * (k - 4) + d, sinf(__fmul_rn(band(k), pj[i])));
    }
    for (int i = tid; i < FP * 6; i += NT) {
      const int p = i / 6, c = i - p * 6;
      X.put(p, H + 42 + c, c == 0 ? 1.0f : 0.0f);
    }
    rows_product<FP, H, H, F::NB, F::MT>(      // h3
        bias_init(L.b_mid2), ha, wb(w_mid2), [&](int mt, int nt, const float (&c)[4]) {
          relu_to(X)(mt, nt, c);
          each_pair(mt, nt, c, [&](int m, int n, float2 v) {
            v = relu2(v);
            h3p[m * F::LDP + n] = v.x;
            h3p[m * F::LDP + n + 1] = v.y;
          });
        });
    __syncthreads();

    // ---- the e2-fed heads: hcol = relu([h3 | e2 | 1] . [w_col; b_col]),
    // hclip the same with w_clip, straight to device memory
    rows_product<FP, H, D::KX3, F::NB, F::MT>(
        row_bias(L.b_col), xa, wb(w_col), [&](int mt, int nt, const float (&c)[4]) {
          each_pair(mt, nt, c, [&](int m, int n, float2 v) {
            v = relu2(v);
            hcp[m * F::LDP + n] = v.x;
            hcp[m * F::LDP + n + 1] = v.y;
          });
        });
    if (do_clip) {
      rows_product<FP, H, D::KX3, F::NB, F::MT>(
          row_bias(L.b_clip), xa, wb(w_clip), [&](int mt, int nt, const float (&c)[4]) {
            each_pair(mt, nt, c, [&](int m, int n, float2 v) {
              if (m < nv) *reinterpret_cast<float2*>(hclip + (row0 + m) * H + n) = relu2(v);
            });
          });
    }
    __syncthreads();

    // ---- alpha and colour (SIMT FMAs, four partial sums per dot)
    for (int i = tid; i < nv * 4; i += NT) {
      const int p = i >> 2, c = i & 3;
      // alpha: h3 . w_alpha + b_alpha; colour c: hcol . w_oc[:, c] + b_oc[c]
      const float* x = (c == 3 ? h3p : hcp) + p * F::LDP;
      const float* wv = c == 3 ? sh : sh + H + 1 + c;
      const int sw = c == 3 ? 1 : 3;
      float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int k = 0; k < H; ++k) s4[k & 3] = fmaf(op(x[k]), op(wv[k * sw]), s4[k & 3]);
      const float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      if (c == 3) alpha[row0 + p] = (s + sh[H]) * ALPHA_SCALE;
      else color[(row0 + p) * 3 + c] = sigmoid_f(s + sh[4 * H + 1 + c]);
    }
    // the next chunk's encode writes none of what this step reads (the
    // plain h3 and hcol) before its first barrier
  }
}

template <int H>
__global__ void __launch_bounds__(NT, 1)
ff_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ w,
              const float* __restrict__ da, const float* __restrict__ dc,
              const float* __restrict__ dh, float* __restrict__ part,
              int N, int do_clip, int tile) {
  static_assert(tc_shape(H), "ff_bwd_kernel takes H = 16, 32, ..., 128");
  using D = Dims<H>;
  constexpr bool SW = D::SMEM_W;
  constexpr int LH = D::LH;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int o = blockIdx.y;
  const int ti = blockIdx.x;
  const Layout L = make_layout(H);
  const float* W = w + (size_t)o * L.total;
  float* G = part + ((size_t)o * gridDim.x + ti) * L.total;

  float* q = sm;
  const Sw<LH> ws{q};            q += SW ? D::WROWS * LH : 0;    // weights (SMEM_W)
  float* gs = q;                 q += SW ? D::GROWS * D::LDG : 0; // weight grads (SMEM_W)
  const Sw<D::LDX2> X2{q};       q += BP * D::LDX2;  // [h2 | e1 | 1]
  const Sw<D::LDX2> D2{q};       q += BP * D::LDX2;  // [d_h2 | d_e1]
  const Sw<D::LDX3> X3{q};       q += BP * D::LDX3;  // [h3 | e2 | 1 | 0]
  const Sw<D::LDX3> D3{q};       q += BP * D::LDX3;  // [d_h3 | d_e2]
  const Sw<2 * H> DH{q};         q += BP * 2 * H;    // [d_hcol | d_hclip]
  const Sw<LH> A1{q};            q += BP * LH;       // h1
  const Sw<LH> AC{q};            q += BP * LH;       // hc, then d_h1
  const Sw<LH> AO{q};            q += BP * LH;       // hcol, then d_hc
  float* tt = q;                 q += BP * 4;        // scaled points
  float* pj = q;                 q += BP * ND;       // proj, then d_proj
  float* dcp = q;                q += BP * 4;        // sigmoid-input cotangent
  float* dal = q;                q += BP;            // alpha pre-scale cotangent
  float* S = q;                                      // small gradients

  const Wm<H, SW> w_in{ws, W + L.w_in, D::WR_IN, 88};
  const Wm<H, SW> w_mid1{ws, W + L.w_mid1, D::WR_MID1, H};
  const Wm<H, SW> w_cat{ws, W + L.w_cat, D::WR_CAT, D::KX2};
  const Wm<H, SW> w_mid2{ws, W + L.w_mid2, D::WR_MID2, H};
  const Wm<H, SW> w_col{ws, W + L.w_col, D::WR_COL, D::RH};
  const Wm<H, SW> w_clip{ws, W + L.w_clip, D::WR_CLIP, D::RH};

  if constexpr (SW) {   // the object's weights, once per block, behind the first encode
    const auto load = [&](int r0, int off, int rows, int padded) {
      for (int i = tid; i < rows * H; i += NT) cp_async4(&ws(r0 + i / H, i % H), W + off + i);
      for (int i = rows * H + tid; i < padded * H; i += NT) ws(r0 + i / H, i % H) = 0.0f;
    };
    load(D::WR_IN, L.w_in, 88, 88);
    load(D::WR_MID1, L.w_mid1, H, H);
    load(D::WR_CAT, L.w_cat, D::KX2, D::KX2);
    load(D::WR_MID2, L.w_mid2, H, H);
    load(D::WR_COL, L.w_col, D::RH, D::KX3);
    load(D::WR_CLIP, L.w_clip, D::RH, D::KX3);
    for (int i = tid; i < D::GROWS * D::LDG; i += NT) gs[i] = 0.0f;
  }
  for (int i = tid; i < D::NS; i += NT) S[i] = 0.0f;

  const auto zero2 = [](int, int) { return make_float2(0.0f, 0.0f); };
  // weight-gradient accumulator of one matrix: in shared memory across the
  // tile's chunks (SMEM_W), or written once to the slot (one chunk per
  // tile); rows past R (padding) are dropped
  const auto g_init = [&](int gr0) {
    return [=](int m, int n) {
      if constexpr (SW) return *reinterpret_cast<const float2*>(gs + (gr0 + m) * D::LDG + n);
      else return make_float2(0.0f, 0.0f);
    };
  };
  const auto g_store = [&](int gr0, int off, int R) {
    return [=](int m, int n, float2 v) {
      if constexpr (SW) {
        *reinterpret_cast<float2*>(gs + (gr0 + m) * D::LDG + n) = v;
      } else if (m < R) {
        G[off + m * H + n] = v.x;
        G[off + m * H + n + 1] = v.y;
      }
    };
  };
  constexpr int NBF = D::NBF;   // n-tiles per item of an N = H product

  const int t0 = ti * tile;
  const int t1 = min(N, t0 + tile);
  for (int c0 = t0; c0 < t1; c0 += BP) {
    const int nv = min(BP, t1 - c0);
    const size_t row0 = (size_t)o * N + c0;

    // ---- encode; rows past nv get t = 0 and zero cotangents
    for (int i = tid; i < BP * 3; i += NT) {
      const int p = i / 3, c = i - p * 3;
      const float v = p < nv ? pts[row0 * 3 + i] : 0.0f;
      tt[p * 4 + c] = v;
      X2(p, H + c) = v;
    }
    for (int p = tid; p < BP; p += NT) {
      dal[p] = p < nv ? da[row0 + p] * ALPHA_SCALE : 0.0f;
      X2(p, H + 87) = 1.0f;   // the ones columns
      for (int c = D::KX2; c < D::MX2; ++c) X2(p, c) = 0.0f;
      X3(p, H + 42) = 1.0f;
      for (int c = H + 43; c < D::KX3; ++c) X3(p, c) = 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < BP * ND; i += NT) {
      const int p = i / ND, d = i - p * ND;
      const float* t = tt + p * 4;
      const float* dr = W + L.dirs + d * 3;
      // full f32 as an explicit FMA chain, the same rounding as the plain
      // version (embedding.project): fma(t2, d2, fma(t1, d1, t0 d0))
      const float pr = fmaf(t[2], dr[2], fmaf(t[1], dr[1], __fmul_rn(t[0], dr[0])));
      pj[i] = pr;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const float f = (float)(3.14159265358979323846 * (double)(1 << k));
        const float s = sinf(__fmul_rn(f, pr));
        if (k < 4) X2(p, H + 3 + ND * k + d) = s;
        else X3(p, H + ND * (k - 4) + d) = s;
      }
    }
    if constexpr (SW) {
      if (c0 == t0) cp_async_wait_all();
    }
    __syncthreads();

    // ---- recompute the forward (FP32, the plain version's rounding)
    const auto relu_to = [](const auto& buf) {
      return [=](int m, int n, float z) { buf(m, n) = z > 0.0f ? z : 0.0f; };
    };
    fp32_layer<H, 87, 0>(     // h1 = relu(e1 . w_in + b_in)
        [&](int m, int k) { return X2(m, H + k); }, [&](int k, int n) { return w_in.at(k, n); },
        [&](int n) { return w_in.at(87, n); }, relu_to(A1));
    __syncthreads();
    fp32_layer<H, H, 0>(      // h2
        [&](int m, int k) { return A1(m, k); }, [&](int k, int n) { return w_mid1.at(k, n); },
        [&](int n) { return W[L.b_mid1 + n]; }, relu_to(X2));
    __syncthreads();
    fp32_layer<H, H, 87>(     // hc = relu(h2 . w_cat[:h] + e1 . w_cat[h:] + b_cat)
        [&](int m, int k) { return X2(m, k); }, [&](int k, int n) { return w_cat.at(k, n); },
        [&](int n) { return w_cat.at(H + 87, n); }, relu_to(AC));
    __syncthreads();
    fp32_layer<H, H, 0>(      // h3
        [&](int m, int k) { return AC(m, k); }, [&](int k, int n) { return w_mid2.at(k, n); },
        [&](int n) { return W[L.b_mid2 + n]; }, relu_to(X3));
    __syncthreads();
    fp32_layer<H, H, 42>(     // hcol
        [&](int m, int k) { return X3(m, k); }, [&](int k, int n) { return w_col.at(k, n); },
        [&](int n) { return w_col.at(H + 42, n); }, relu_to(AO));
    if (do_clip) {   // d_hclip = dh * (hclip > 0); hclip itself is not kept
      fp32_layer<H, H, 42>(
          [&](int m, int k) { return X3(m, k); }, [&](int k, int n) { return w_clip.at(k, n); },
          [&](int n) { return w_clip.at(H + 42, n); },
          [&](int m, int n, float z) {
            DH(m, H + n) = (z > 0.0f && m < nv) ? dh[(row0 + m) * H + n] : 0.0f;
          });
    }
    __syncthreads();

    // ---- colour head: sigmoid-input cotangent (FMAs, as K1's dot_w)
    for (int i = tid; i < BP * 3; i += NT) {
      const int p = i / 3, c = i - p * 3;
      float d = 0.0f;
      if (p < nv) {
        float s = 0.0f;
        for (int k = 0; k < H; ++k) s = fmaf(op(AO(p, k)), op(W[L.w_oc + k * 3 + c]), s);
        const float col = sigmoid_f(s + W[L.b_oc + c]);
        d = dc[(row0 + p) * 3 + c] * col * (1.0f - col);
      }
      dcp[p * 4 + c] = d;
    }
    __syncthreads();
    // d_hcol = (dcp w_oc^T) * (hcol > 0); the small heads' gradients
    for (int i = tid; i < BP * H; i += NT) {
      const int p = i / H, j = i - p * H;
      const float* wo = W + L.w_oc + j * 3;
      const float* d = dcp + p * 4;
      const float v = fmaf(op(d[2]), op(wo[2]), fmaf(op(d[1]), op(wo[1]), op(d[0]) * op(wo[0])));
      DH(p, j) = AO(p, j) > 0.0f ? v : 0.0f;
    }
    for (int e = tid; e < 4 * H + 4; e += NT) {
      float s = 0.0f;
      if (e < 3 * H) {          // w_oc[j][c] += sum_p hcol[p][j] dcp[p][c]
        const int j = e / 3, c = e - j * 3;
        for (int p = 0; p < nv; ++p) s = fmaf(op(AO(p, j)), op(dcp[p * 4 + c]), s);
        S[D::S_WOC + e] += s;
      } else if (e < 3 * H + 3) {
        for (int p = 0; p < nv; ++p) s += dcp[p * 4 + e - 3 * H];
        S[D::S_BOC + e - 3 * H] += s;
      } else if (e < 4 * H + 3) {   // w_alpha[j] += sum_p h3[p][j] dal[p]
        const int j = e - 3 * H - 3;
        for (int p = 0; p < nv; ++p) s = fmaf(op(X3(p, j)), op(dal[p]), s);
        S[D::S_WA + j] += s;
      } else {
        for (int p = 0; p < nv; ++p) s += dal[p];
        S[D::S_BA] += s;
      }
    }
    __syncthreads();

    // ---- e2-fed heads: weight grads; [d_h3 | d_e2]
    {
      int slot = product<D::KX3, H, BP, NBF>(   // [w_col; b_col] += [h3 | e2 | 1]^T d_hcol
          0, g_init(D::GR_COL), [&](int m, int k) { return X3(k, m); },
          [&](int k, int n) { return DH(k, n); }, g_store(D::GR_COL, L.w_col, D::RH));
      const auto d3_epi = [&](int m, int n, float2 v) {
        if (n < H) {   // d_h3 = (. + dal w_alpha^T) * (h3 > 0)
          v.x = fmaf(op(dal[m]), op(W[L.w_alpha + n]), v.x);
          v.y = fmaf(op(dal[m]), op(W[L.w_alpha + n + 1]), v.y);
          v = mask2(v, X3.pair(m, n));
        }
        D3.pair(m, n) = v;
      };
      if (do_clip) {
        slot = product<D::KX3, H, BP, NBF>(
            slot, g_init(D::GR_CLIP), [&](int m, int k) { return X3(k, m); },
            [&](int k, int n) { return DH(k, H + n); },
            g_store(D::GR_CLIP, L.w_clip, D::RH));
        product<BP, D::KX3, 2 * H, 2>(   // d_hcol w_col^T + d_hclip w_clip^T
            slot, zero2, [&](int m, int k) { return DH(m, k); },
            [&](int k, int n) { return k < H ? w_col.at(n, k) : w_clip.at(n, k - H); }, d3_epi);
      } else {
        product<BP, D::KX3, H, 2>(
            slot, zero2, [&](int m, int k) { return DH(m, k); },
            [&](int k, int n) { return w_col.at(n, k); }, d3_epi);
      }
    }
    __syncthreads();

    // ---- mid2: weight grad; d_hc = (d_h3 w_mid2^T) * (hc > 0)
    {
      const int slot = product<H, H, BP, NBF>(
          0, g_init(D::GR_MID2), [&](int m, int k) { return AC(k, m); },
          [&](int k, int n) { return D3(k, n); }, g_store(D::GR_MID2, L.w_mid2, H));
      product<BP, H, H, NBF>(
          slot, zero2, [&](int m, int k) { return D3(m, k); },
          [&](int k, int n) { return w_mid2.at(n, k); },
          [&](int m, int n, float2 v) { AO.pair(m, n) = mask2(v, AC.pair(m, n)); });
      for (int j = tid; j < H; j += NT) {
        float s = 0.0f;
        for (int p = 0; p < BP; ++p) s += D3(p, j);
        S[D::S_BM2 + j] += s;
      }
    }
    __syncthreads();

    // ---- skip layer: [w_cat; b_cat] += [h2 | e1 | 1]^T d_hc; [d_h2 | d_e1]
    {
      const int slot = product<D::MX2, H, BP, NBF>(
          0, g_init(D::GR_CAT), [&](int m, int k) { return X2(k, m); },
          [&](int k, int n) { return AO(k, n); }, g_store(D::GR_CAT, L.w_cat, D::KX2));
      product<BP, D::KX2, H, 1>(
          slot, zero2, [&](int m, int k) { return AO(m, k); },
          [&](int k, int n) { return w_cat.at(n, k); },
          [&](int m, int n, float2 v) {
            D2.pair(m, n) = n < H ? mask2(v, X2.pair(m, n)) : v;   // d_h2 masked
          });
    }
    __syncthreads();

    // ---- mid1: weight grad; d_h1 = (d_h2 w_mid1^T) * (h1 > 0)
    {
      const int slot = product<H, H, BP, NBF>(
          0, g_init(D::GR_MID1), [&](int m, int k) { return A1(k, m); },
          [&](int k, int n) { return D2(k, n); }, g_store(D::GR_MID1, L.w_mid1, H));
      product<BP, H, H, NBF>(
          slot, zero2, [&](int m, int k) { return D2(m, k); },
          [&](int k, int n) { return w_mid1.at(n, k); },
          [&](int m, int n, float2 v) { AC.pair(m, n) = mask2(v, A1.pair(m, n)); });
      for (int j = tid; j < H; j += NT) {
        float s = 0.0f;
        for (int p = 0; p < BP; ++p) s += D2(p, j);
        S[D::S_BM1 + j] += s;
      }
    }
    __syncthreads();

    // ---- in_layer: [w_in; b_in] += [e1 | 1]^T d_h1; d_e1 += d_h1 w_in^T
    {
      const int slot = product<D::ME1, H, BP, NBF>(
          0, g_init(D::GR_IN), [&](int m, int k) { return X2(k, H + m); },
          [&](int k, int n) { return AC(k, n); }, g_store(D::GR_IN, L.w_in, 88));
      product<BP, 88, H, 1>(
          slot, [&](int m, int n) { return D2.pair(m, H + n); },
          [&](int m, int k) { return AC(m, k); }, [&](int k, int n) { return w_in.at(n, k); },
          [&](int m, int n, float2 v) { D2.pair(m, H + n) = v; });
    }
    __syncthreads();

    // ---- PE backward: d_proj = sum_k f_k cos(f_k proj) d_sin_k
    for (int i = tid; i < BP * ND; i += NT) {
      const int p = i / ND, d = i - p * ND;
      const float pr = pj[i];
      float g = 0.0f;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const float f = (float)(3.14159265358979323846 * (double)(1 << k));
        const float ds = k < 4 ? D2(p, H + 3 + ND * k + d) : D3(p, H + ND * (k - 4) + d);
        g += (f * cosf(__fmul_rn(f, pr))) * ds;
      }
      pj[i] = g;
    }
    __syncthreads();
    // d_dirs[d][c] += sum_p d_proj[p][d] t[p][c]
    for (int e = tid; e < ND * 3; e += NT) {
      const int d = e / 3, c = e - d * 3;
      float s = 0.0f;
      for (int p = 0; p < nv; ++p) s = fmaf(op(pj[p * ND + d]), op(tt[p * 4 + c]), s);
      S[D::S_DIRS + e] += s;
    }
    __syncthreads();
  }

  // ---- the block's slot, written once
  if constexpr (SW) {
    const auto put = [&](int gr0, int off, int rows) {
      for (int i = tid; i < rows * H; i += NT)
        G[off + i] = gs[(gr0 + i / H) * D::LDG + i % H];
    };
    put(D::GR_IN, L.w_in, 88);
    put(D::GR_MID1, L.w_mid1, H);
    put(D::GR_CAT, L.w_cat, D::KX2);
    put(D::GR_MID2, L.w_mid2, H);
    put(D::GR_COL, L.w_col, D::RH);
    put(D::GR_CLIP, L.w_clip, D::RH);
  } else if (!do_clip) {
    for (int i = tid; i < (D::RH) * H; i += NT) G[L.w_clip + i] = 0.0f;
  }
  for (int e = tid; e < ND * 3; e += NT) G[L.dirs + e] = S[D::S_DIRS + e];
  for (int j = tid; j < H; j += NT) {
    G[L.w_alpha + j] = S[D::S_WA + j];
    G[L.b_mid1 + j] = S[D::S_BM1 + j];
    G[L.b_mid2 + j] = S[D::S_BM2 + j];
  }
  for (int e = tid; e < 3 * H; e += NT) G[L.w_oc + e] = S[D::S_WOC + e];
  if (tid < 3) G[L.b_oc + tid] = S[D::S_BOC + tid];
  if (tid == 0) G[L.b_alpha] = S[D::S_BA];
}

// Sum the per-tile partials in tile order: grad[o][i] = sum_t part[o][t][i].
__global__ void ff_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ grad, int T, int P) {
  const int o = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const float* src = part + (size_t)o * T * P + i;
  float s = 0.0f;
  for (int t = 0; t < T; ++t) s += src[(size_t)t * P];
  grad[(size_t)o * P + i] = s;
}

size_t fwd_smem(int h) {
  return sizeof(float) * chunk_points(h) *
         (LD_T + LD_P + LD_E1 + LD_E2 + 2 * ld_h(h));
}

// Points per K1 block: a whole number of chunks (of `chunk` points) that
// finishes in the fewest waves x (tile length + `start`, a block's fixed
// cost in points) over `n_sm` blocks at once (the f32 K1: a block fills an
// SM, no fixed cost), among equals the fewest blocks; the rule of
// ops.fused_field.bwd_tile.
int fwd_tile(int O, int N, int n_sm, int start = 0, int chunk = FP) {
  const int chunks = (N + chunk - 1) / chunk;
  long best_cost = -1, best_blocks = 0;
  int best = chunk;
  for (int k = 1; k <= chunks; ++k) {
    const int tile = k * chunk;
    const long blocks = (long)O * ((N + tile - 1) / tile);
    const long cost = (blocks + n_sm - 1) / n_sm * (tile + start);
    if (best_cost < 0 || cost < best_cost || (cost == best_cost && blocks < best_blocks)) {
      best_cost = cost;
      best_blocks = blocks;
      best = tile;
    }
  }
  return best;
}

template <int H>
int launch_fwd(const float* pts, const float* w, float* alpha, float* color,
               float* hclip, int O, int N, int do_clip, cudaStream_t stream) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(uint32_t) * FwdDims<H>::SMEM_WORDS;
  err = cudaFuncSetAttribute(ff_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile = fwd_tile(O, N, n_sm);
  dim3 grid((N + tile - 1) / tile, O);
  ff_fwd_kernel<H><<<grid, NT, smem, stream>>>(pts, w, alpha, color, hclip, N, do_clip, tile);
  return (int)cudaGetLastError();
}

// The launch ff_fwd_kernel<H> makes (ff_fwd_launch): one block an SM, the
// tile by fwd_tile over the SMs
template <int H>
int plan_fwd(int O, int N, int* out) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tile = fwd_tile(O, N, n_sm);
  out[0] = 1;
  out[1] = tile;
  out[2] = O * ((N + tile - 1) / tile);
  out[3] = (int)(sizeof(uint32_t) * FwdDims<H>::SMEM_WORDS);
  out[4] = FP;
  out[5] = 0;
  return 0;
}

template <int H>
int launch_bwd(const float* pts, const float* w, const float* da, const float* dc,
               const float* dh, float* part, int O, int N, int do_clip, int tile,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * Dims<H>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      ff_bwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + tile - 1) / tile, O);
  ff_bwd_kernel<H><<<grid, NT, smem, stream>>>(pts, w, da, dc, dh, part, N, do_clip, tile);
  return (int)cudaGetLastError();
}

// The widths the tensor-core kernels are built for: every width they take
// (`tc_shape`). Dispatch reads this one list (`TC_WIDTHS`); every other
// width runs the SIMT kernels. A build may define FF_TC_WIDTHS with fewer
// (the CPU emulation in tests/test_torch_kernel_emulation.py does, to keep
// its host compile short).
#ifndef FF_TC_WIDTHS
#define FF_TC_WIDTHS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)
#endif

struct TcWidth {
  int h;
  bool smem_w;   // K2 keeps weights and accumulators on chip across a tile
  int chunk;     // K2's points per chunk
  int (*fwd)(const float*, const float*, float*, float*, float*, int, int, int, cudaStream_t);
  int (*fwd_plan)(int, int, int*);   // K1's launch (ff_fwd_launch)
  int (*bwd)(const float*, const float*, const float*, const float*, const float*, float*, int,
             int, int, int, cudaStream_t);
};

#ifdef FF_BF16
#include "fused_field_bwd_bf16.cuh"   // K2 at bf16: ff_bwd_bf16_kernel<H>
#include "fused_field_fwd_bf16.cuh"   // K1 at bf16: ff_fwd_bf16_kernel<H>
#define FF_TC_ENTRY(H) \
  {H, Bf<H>::SMEM_W, Bf<H>::P, launch_fwd_bf16<H>, plan_fwd_bf16<H>, launch_bwd_bf16<H>},
#else
#define FF_TC_ENTRY(H) {H, Dims<H>::SMEM_W, BP, launch_fwd<H>, plan_fwd<H>, launch_bwd<H>},
#endif
const TcWidth TC_WIDTHS[] = {FF_TC_WIDTHS(FF_TC_ENTRY)};
#undef FF_TC_ENTRY

const TcWidth* tc_width(int h) {
  for (const TcWidth& t : TC_WIDTHS)
    if (t.h == h) return &t;
  return nullptr;
}

}  // namespace

extern "C" {

int ff_param_count(int h) { return make_layout(h).total; }

// 1 if K1 and K2 run on the tensor cores at width h, 0 if the SIMT kernels do
int ff_tc_width(int h) { return tc_width(h) != nullptr; }

// K2 walks a tile of points in chunks of this many
int ff_bwd_chunk(int h) {
  const TcWidth* t = tc_width(h);
  return t ? t->chunk : bwd_generic_chunk(h);
}

// The largest K2 tile: one chunk where the tensor-core K2 keeps its weights
// off chip (each chunk's weight gradients go to the tile's slot once);
// unbounded otherwise (weights and gradients stay in shared memory across
// chunks: in f32 at h = 16 and 32, in bf16 at 16 to 48; the SIMT kernel
// adds each chunk's gradients into its slot).
int ff_bwd_max_tile(int h) {
  const TcWidth* t = tc_width(h);
  return t && !t->smem_w ? t->chunk : (1 << 30);
}

// Floats of `part` that ff_backward uses after the O x T gradient slots:
// in the bf16 build at a tensor-core width, each object's weights as a bf16
// image, [O][5h + 272][h + 8] from the first 16-byte boundary; 0 otherwise.
int ff_bwd_scratch(int O, int h) {
#ifdef FF_BF16
  if (tc_width(h)) return (int)image_scratch_floats(O, h);
#endif
  return 0;
}

// The launch ff_forward makes for O objects x N points at width h: {blocks
// resident an SM, points a block, blocks, dynamic shared memory in bytes,
// points a chunk, 1 if K1 bf16 streams its weights through its ring} into
// out[0..5]
int ff_fwd_launch(int O, int N, int h, int* out) {
  if (const TcWidth* t = tc_width(h)) return t->fwd_plan(O, N, out);
  const int tp = chunk_points(h), smem = (int)fwd_smem(h);
  cudaError_t err = cudaFuncSetAttribute(
      ff_fwd_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], ff_fwd_generic_kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  out[1] = tp;
  out[2] = O * ((N + tp - 1) / tp);
  out[3] = smem;
  out[4] = tp;
  out[5] = 0;
  return 0;
}

// K1 runs on the tensor cores at the widths of FF_TC_WIDTHS, and as the SIMT
// kernel at any other width.
int ff_forward(const float* pts, const float* w, float* alpha, float* color,
               float* hclip, int O, int N, int h, int do_clip, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (const TcWidth* t = tc_width(h)) return t->fwd(pts, w, alpha, color, hclip, O, N, do_clip, s);
  const size_t smem = fwd_smem(h);
  cudaError_t err = cudaFuncSetAttribute(
      ff_fwd_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tp = chunk_points(h);
  dim3 grid((N + tp - 1) / tp, O);
  ff_fwd_generic_kernel<<<grid, NT, smem, s>>>(
      pts, w, alpha, color, hclip, N, h, do_clip);
  return (int)cudaGetLastError();
}

// K2 runs on the tensor cores at the widths of FF_TC_WIDTHS, and as the SIMT
// kernel at any other width; the tile must be a multiple of ff_bwd_chunk(h)
// and at most ff_bwd_max_tile(h), and `part` holds the O x T slots and
// ff_bwd_scratch(O, h) floats after them.
int ff_backward(const float* pts, const float* w, const float* da,
                const float* dc, const float* dh, float* part, int O, int N,
                int h, int do_clip, int tile, void* stream) {
  const TcWidth* t = tc_width(h);
  const int chunk = ff_bwd_chunk(h);
  if (h <= 0 || tile <= 0 || tile % chunk != 0 || tile > ff_bwd_max_tile(h) ||
      (!t && bwd_generic_floats(h, chunk) > SMEM_OPTIN_FLOATS))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (t) return t->bwd(pts, w, da, dc, dh, part, O, N, do_clip, tile, s);
  const size_t smem = sizeof(float) * bwd_generic_floats(h, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ff_bwd_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + tile - 1) / tile, O);
  ff_bwd_generic_kernel<<<grid, NT, smem, s>>>(pts, w, da, dc, dh, part, N, h, do_clip,
                                               tile, chunk);
  return (int)cudaGetLastError();
}

int ff_reduce(const float* part, float* grad, int O, int T, int P,
              void* stream) {
  dim3 grid((P + NT - 1) / NT, O);
  ff_reduce_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(part, grad, T, P);
  return (int)cudaGetLastError();
}

}  // extern "C"

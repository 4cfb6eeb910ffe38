// The flat AdamW update: one launch over every trainable leaf of a model.
//
// Replaces no Pallas kernel. It ports openobj_tpu/core/optim.py's
// adamw_update_flat (:121), which the JAX trainer runs with
// TrainConfig.optim_impl == "flat" (openobj_tpu/core/trainer.py:618) and XLA
// compiles into one fused op over the concatenated leaves. The per-leaf
// update (core/optim.py adamw_update) runs some eighteen elementwise ops a
// leaf, 642 a training step over the room_0 fg and bg models (19 leaves
// each); this kernel is one launch a model.
//
// What it computes, per element of every trainable leaf (a stacked leaf is
// [O, row], the unstacked background model one slot of its whole size):
//   m' = b1 m + (1 - b1) g;  v' = b2 v + ((1 - b2) g) g
//   p' = p (1 - lr wd) - (lr (m' / bc1)) / (sqrt(v' / bc2) + eps)
// with bc = 1 - b^max(t, 1) of the slot's new count t = count + active; an
// inactive slot keeps p, m and v, and its count. Each product, sum and
// quotient is rounded on its own (the _rn intrinsics: no contraction into
// an FMA), in the plain version's order, so that only powf may differ from
// torch.pow, by its last bit.
//
// Bound: bytes. Each element reads p, g, m and v once and writes p', m' and
// v' once (an inactive slot reads no g); there are about 0.5 flops a byte.
// A gradient that autograd left transposed (the clip head's) is read at
// its stride, uncoalesced; its lines are re-read from L1/L2, not memory.
// The update is functional, as adamw_update is: p', m' and v' go to fresh
// outputs, so a caller that keeps the old state (a snapshot, a slot's views)
// sees it unchanged; the bytes are those of an update in place.
//
// Design: the leaves' pointers and row lengths travel in the kernel's
// parameter (a table of at most AF_MAX_LEAVES leaves, no copy to the device
// before the launch; __grid_constant__, so that indexing it by leaf reads
// the parameter bank and makes no copy of it a thread). Each block is one
// work item (leaf, slot, chunk of AF_CHUNK elements of the slot's row),
// found from the leaves' first item;
// it computes its slot's bias corrections once and its threads stride over
// the chunk with neighbouring threads on neighbouring elements. The block
// of a leaf-0 slot's first chunk writes the slot's new count. No
// concatenation is made: each leaf is read where it lies.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <cmath>
#include <cstdint>

#define AF_MAX_LEAVES 32
#define AF_THREADS 256
#define AF_CHUNK 2048      // elements a work item: 8 a thread

struct AfLeaf {
  const float* p;
  const float* g;          // null: a zero gradient
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  long long row;           // elements of one slot (the row of p, m, v and the outputs)
  // g's layout: a slot is a [row / cols, cols] matrix of g_rs, g_cs
  // elements between rows and columns, g_slot apart (a view into a packed
  // gradient, as autograd leaves it: slices, transposes)
  long long g_slot, cols, g_rs, g_cs;
  int chunks;              // work items of one slot's row
  int first;               // the leaf's first work item
};

struct AfTable {
  AfLeaf leaf[AF_MAX_LEAVES];
  int n_leaves;
  const int* count;              // [slots]
  int* count_out;                // [slots]
  const unsigned char* active;   // [slots] bool; null: every slot steps
  float b1, c1, b2, c2, lr, eps, decay;   // c = 1 - b, decay = 1 - lr wd, as f32
};

__global__ void __launch_bounds__(AF_THREADS)
adamw_flat_kernel(const __grid_constant__ AfTable t) {
  const int item = blockIdx.x;
  int l = 0;
  while (l + 1 < t.n_leaves && item >= t.leaf[l + 1].first) ++l;
  const AfLeaf& L = t.leaf[l];
  const int local = item - L.first;
  const int slot = local / L.chunks, chunk = local % L.chunks;
  const bool on = t.active == nullptr || t.active[slot] != 0;
  const int count = t.count[slot] + (on ? 1 : 0);
  if (l == 0 && chunk == 0 && threadIdx.x == 0) t.count_out[slot] = count;

  const long long at = (long long)slot * L.row;
  const float* p = L.p + at;
  const float* m = L.m + at;
  const float* v = L.v + at;
  float* p_out = L.p_out + at;
  float* m_out = L.m_out + at;
  float* v_out = L.v_out + at;
  const long long j0 = (long long)chunk * AF_CHUNK;
  const long long j1 = min(j0 + AF_CHUNK, L.row);
  if (!on) {   // the slot is frozen: its values go to the outputs as they are
    for (long long j = j0 + threadIdx.x; j < j1; j += AF_THREADS) {
      p_out[j] = p[j];
      m_out[j] = m[j];
      v_out[j] = v[j];
    }
    return;
  }
  const float* g = L.g != nullptr ? L.g + (long long)slot * L.g_slot : nullptr;
  const bool g_dense = L.g_cs == 1 && L.g_rs == L.cols;   // the row lies as p's
  const float tt = fmaxf((float)count, 1.0f);
  const float bc1 = __fsub_rn(1.0f, powf(t.b1, tt));
  const float bc2 = __fsub_rn(1.0f, powf(t.b2, tt));
  for (long long j = j0 + threadIdx.x; j < j1; j += AF_THREADS) {
    const float gj = g == nullptr ? 0.0f
                     : g[g_dense ? j : (j / L.cols) * L.g_rs + (j % L.cols) * L.g_cs];
    const float m_n = __fadd_rn(__fmul_rn(t.b1, m[j]), __fmul_rn(t.c1, gj));
    const float v_n = __fadd_rn(__fmul_rn(t.b2, v[j]), __fmul_rn(__fmul_rn(t.c2, gj), gj));
    const float step = __fdiv_rn(__fmul_rn(t.lr, __fdiv_rn(m_n, bc1)),
                                 __fadd_rn(__fsqrt_rn(__fdiv_rn(v_n, bc2)), t.eps));
    p_out[j] = __fsub_rn(__fmul_rn(p[j], t.decay), step);
    m_out[j] = m_n;
    v_out[j] = v_n;
  }
}

extern "C" {

int af_max_leaves() { return AF_MAX_LEAVES; }

// One AdamW step over n_leaves leaves of n_slots slots each. ptrs holds, for
// each leaf, 7 device pointers: p, g (or null), m, v, p_out, m_out, v_out;
// sizes, for each leaf, 5 numbers: its elements a slot, then g's layout
// (AfLeaf: g_slot, cols, g_rs, g_cs).
// count/count_out are [n_slots] int32 on the device, active [n_slots] bool
// or null. Returns the launch's CUDA error.
int af_update(const void* const* ptrs, const long long* sizes, int n_leaves, int n_slots,
              const int* count, int* count_out, const unsigned char* active, float b1,
              float c1, float b2, float c2, float lr, float eps, float decay, void* stream) {
  if (n_leaves < 1 || n_leaves > AF_MAX_LEAVES || n_slots < 1) return cudaErrorInvalidValue;
  AfTable t{};
  long long items = 0;
  for (int l = 0; l < n_leaves; ++l) {
    AfLeaf& L = t.leaf[l];
    const void* const* q = ptrs + 7 * l;
    L.p = static_cast<const float*>(q[0]);
    L.g = static_cast<const float*>(q[1]);
    L.m = static_cast<const float*>(q[2]);
    L.v = static_cast<const float*>(q[3]);
    L.p_out = static_cast<float*>(const_cast<void*>(q[4]));
    L.m_out = static_cast<float*>(const_cast<void*>(q[5]));
    L.v_out = static_cast<float*>(const_cast<void*>(q[6]));
    const long long* z = sizes + 5 * l;
    L.row = z[0];
    L.g_slot = z[1];
    L.cols = z[2];
    L.g_rs = z[3];
    L.g_cs = z[4];
    if (L.row < 1 || L.cols < 1 || L.row % L.cols) return cudaErrorInvalidValue;
    L.chunks = (int)((L.row + AF_CHUNK - 1) / AF_CHUNK);
    L.first = (int)items;
    items += (long long)n_slots * L.chunks;
    if (items > 0x7fffffff) return cudaErrorInvalidValue;
  }
  t.n_leaves = n_leaves;
  t.count = count;
  t.count_out = count_out;
  t.active = active;
  t.b1 = b1;
  t.c1 = c1;
  t.b2 = b2;
  t.c2 = c2;
  t.lr = lr;
  t.eps = eps;
  t.decay = decay;
  adamw_flat_kernel<<<(unsigned)items, AF_THREADS, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

}  // extern "C"

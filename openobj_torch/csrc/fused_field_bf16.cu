// K1 and K2 at compute_dtype="bf16": the kernels of fused_field.cu built a
// second time, into their own library, with BF16 = true. They replace the
// bf16 instantiation (`cdt`) of the Pallas TPU kernels in
// openobj_tpu/ops/fused_field.py: _fwd_kernel (:160, launched at :360) and
// _bwd_kernel (:172, launched at :392). What changes with BF16, and why, is
// set out at the head of fused_field.cu; the C entry points are the same.
// K1 and K2 at the tensor-core widths are this build's own kernels,
// ff_fwd_bf16_kernel in fused_field_fwd_bf16.cuh and ff_bwd_bf16_kernel in
// fused_field_bwd_bf16.cuh (both included by fused_field.cu where FF_BF16
// is defined). A source of its own, so that it compiles beside
// fused_field.cu, in parallel, rather than doubling that file's build.
#define FF_BF16 1
#include "fused_field.cu"

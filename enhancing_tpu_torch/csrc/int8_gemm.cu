// Weights-only int8 GEMM: y = act((x @ W_q^T) * scale + b) [+ residual].
//
// Replaces enhancing_tpu/ops/int8.py::_int8_gemm_kernel (entered through
// _int8_gemm_pallas). Numerics as there: W_q (n, d) int8 with one fp32
// scale per output channel, cast exactly to the activations' dtype; x fp32
// (the decode step's attention output) or bf16 (the prefill's shifted LN
// output); fp32 products and sums; then the scale, the fp32 bias, the
// activation and an fp32 residual, rounded once to x's dtype. The TPU
// kernel's block sizes (a VMEM budget) are not reproduced.
//
// Bound on the H100: bytes. The decode projection reads 37.7 MB of int8
// weights for 0.6 GFLOP at batch 8 (11.3 us at 3.35 TB/s); the prefill's
// fused qkv 113 MB. Design: gemv.cuh, 32 output channels a block, up to 8
// rows a block (more rows: more row tiles on the grid, each re-reading
// the weights).
#include "gemv.cuh"

ETK_API int etk_int8_gemm(const void* x, const void* w_q, const void* scale,
                          const void* bias, const void* residual, void* out,
                          int m, int d, int n, int act, int bias_dtype,
                          int x_dtype, void* stream) {
  if (gemv::bad_shape(m, d, n, act) || scale == nullptr) return ETK_BAD_ARGS;
  gemv::GemvArgs a{};
  a.x = x;
  a.w = w_q;
  a.scale = static_cast<const float*>(scale);
  a.bias = bias;
  a.bias_dtype = bias_dtype;
  a.residual = static_cast<const float*>(residual);
  a.out = out;
  a.m = m;
  a.d = d;
  a.n = n;
  a.act = act;
  return gemv::launch_x<int8_t, false>(a, x_dtype,
                                       static_cast<cudaStream_t>(stream));
}

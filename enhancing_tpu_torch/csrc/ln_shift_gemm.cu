// LayerNorm -> token shift -> GEMM of the decode step, full-precision
// weights:
//   y = act((LN(x) * tm + prev * (1 - tm)) @ W^T + b),  xn = LN(x)
//
// Replaces enhancing_tpu/ops/ln_gemm.py::_ln_shift_gemm_kernel (entered
// through _ln_shift_gemm_pallas), the bf16-weight twin of
// int8_ln_gemm.cu; it runs at the opt-in ENHANCING_TPU_DECODE_LNFUSE qkv
// site. Numerics as there: W in x's dtype (a bf16 W under fp32 x is read
// as it is and widened exactly, which is the cast the JAX wrapper makes),
// LN(x) rounded to x's dtype and returned, the shift blended in x's dtype,
// fp32 products and sums, fp32 bias and activation, one rounding.
//
// Bound on the H100: bytes: the fused qkv (6144 -> 18432) reads 226.5 MB
// of bf16 weights a layer at batch 8 (67.6 us). Design: gemv.cuh's
// cooperative LN kernel on bf16 (or fp32) weight vectors.
#include "gemv.cuh"

ETK_API int etk_ln_shift_gemm(const void* x, const void* gamma,
                              const void* beta, const void* tm,
                              const void* prev, const void* w,
                              const void* bias, void* out, void* xn,
                              void* ws, int m, int d, int n, int act,
                              float eps, int prev_dtype, int bias_dtype,
                              int x_dtype, int w_dtype, void* stream) {
  if (gemv::bad_shape(m, d, n, act) || xn == nullptr || ws == nullptr ||
      (tm != nullptr && prev == nullptr))
    return ETK_BAD_ARGS;
  gemv::GemvArgs a{};
  a.x = x;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.tm = static_cast<const float*>(tm);
  a.prev = prev;
  a.prev_dtype = prev_dtype;
  a.w = w;
  a.bias = bias;
  a.bias_dtype = bias_dtype;
  a.out = out;
  a.xn = xn;
  a.ws = static_cast<float*>(ws);
  a.m = m;
  a.d = d;
  a.n = n;
  a.act = act;
  a.eps = eps;
  auto s = static_cast<cudaStream_t>(stream);
  if (w_dtype == ETK_BF16 && x_dtype == ETK_F32)
    return gemv::launch<__nv_bfloat16, float>(a, s);
  if (w_dtype == ETK_BF16 && x_dtype == ETK_BF16)
    return gemv::launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (w_dtype == ETK_F32 && x_dtype == ETK_F32)
    return gemv::launch<float, float>(a, s);
  return ETK_BAD_ARGS;
}

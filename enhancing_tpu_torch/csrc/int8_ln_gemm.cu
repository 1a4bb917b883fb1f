// Int8 LayerNorm (+ token shift) -> GEMM of the decode step:
//   y = act((LN(x) * tm + prev * (1 - tm)) @ W_q^T * scale + b),  xn = LN(x)
// with tm = null skipping the shift (the vocab head).
//
// Replaces enhancing_tpu/ops/int8.py::_int8_ln_gemm_kernel (entered
// through _int8_ln_gemm_pallas). Numerics as there: fp32 row statistics
// with the fast variance, LN(x) rounded to x's dtype (and returned: the
// next token's shift state), the shift blended in x's dtype, W_q cast
// exactly, fp32 products and sums, then scale, bias and activation in
// fp32 and one rounding. On the decode path x is the fp32 residual stream.
//
// Bound on the H100: bytes: the fused qkv (6144 -> 18432) reads 113 MB of
// int8 weights a layer at batch 8 (33.8 us), the vocab head 50 MB.
// Design: gemv.cuh's cooperative LN kernel. The blocks of the first rows
// normalise (and shift) one row each into an fp32 workspace and write
// LN(x) once; after a grid-wide barrier every block streams units of 32
// output channels against the workspace's rows.
#include "gemv.cuh"

ETK_API int etk_int8_ln_gemm(const void* x, const void* gamma,
                             const void* beta, const void* tm,
                             const void* prev, const void* w_q,
                             const void* scale, const void* bias, void* out,
                             void* xn, void* ws, int m, int d, int n, int act,
                             float eps, int prev_dtype, int bias_dtype,
                             int x_dtype, void* stream) {
  if (gemv::bad_shape(m, d, n, act) || scale == nullptr || xn == nullptr ||
      ws == nullptr || (tm != nullptr && prev == nullptr))
    return ETK_BAD_ARGS;
  gemv::GemvArgs a{};
  a.x = x;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.tm = static_cast<const float*>(tm);
  a.prev = prev;
  a.prev_dtype = prev_dtype;
  a.w = w_q;
  a.scale = static_cast<const float*>(scale);
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
  return gemv::launch_x<int8_t, true>(a, x_dtype,
                                      static_cast<cudaStream_t>(stream));
}

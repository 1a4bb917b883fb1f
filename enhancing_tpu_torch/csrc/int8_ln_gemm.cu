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
// int8 weights a layer at batch 8 (33.8 us), the vocab head 50 MB (15 us).
// Design: int8_gemm.cuh, with the LayerNorm in front of the pieces: every
// block computes the statistics of its row tile itself (no grid barrier)
// while its producer streams the first weight stages, then normalises and
// shifts the split of K it multiplies.
#include "int8_gemm.cuh"

namespace {

template <typename XT>
__global__ void __launch_bounds__(i8g::kThreads, 1)
    int8_ln_gemm_kernel(const __grid_constant__ CUtensorMap tw,
                        const i8g::Args a) {
  i8g::gemm_body<XT, true>(&tw, a);
}

}  // namespace

// part, part_bytes, sync, sync_words: as etk_int8_gemm; xn (m, d) and
// out (m, n) in x's dtype; prev fp32 or bf16 (m, d) with tm, both null for
// no shift
ETK_API int etk_int8_ln_gemm(const void* x, const void* gamma,
                             const void* beta, const void* tm,
                             const void* prev, const void* w_q,
                             const void* scale, const void* bias, void* out,
                             void* xn, void* part, long long part_bytes,
                             void* sync, long long sync_words, int m, int d,
                             int n, int act, float eps, int prev_dtype,
                             int bias_dtype, int x_dtype, void* stream) {
  if (scale == nullptr || xn == nullptr || gamma == nullptr ||
      beta == nullptr || (tm != nullptr && prev == nullptr) ||
      act < ACT_NONE || act > ACT_GELU ||
      (x_dtype != ETK_F32 && x_dtype != ETK_BF16))
    return ETK_BAD_ARGS;
  i8g::Args a{};
  a.x = x;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.tm = static_cast<const float*>(tm);
  a.prev = prev;
  a.prev_dtype = prev_dtype;
  a.scale = static_cast<const float*>(scale);
  a.bias = bias;
  a.bias_dtype = bias_dtype;
  a.out = out;
  a.xn = xn;
  a.part = static_cast<float*>(part);
  a.sync = static_cast<unsigned*>(sync);
  a.m = m;
  a.d = d;
  a.n = n;
  a.act = act;
  a.eps = eps;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == ETK_F32)
    return i8g::launch<int8_ln_gemm_kernel<float>>(3, w_q, a, part_bytes,
                                                   sync_words, s);
  return i8g::launch<int8_ln_gemm_kernel<__nv_bfloat16>>(
      1, w_q, a, part_bytes, sync_words, s);
}

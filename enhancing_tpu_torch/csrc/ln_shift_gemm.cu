// LayerNorm -> token shift -> GEMM of the decode step, full-precision
// weights:
//   y = act((LN(x) * tm + prev * (1 - tm)) @ W^T + b),  xn = LN(x)
// with tm = null skipping the shift.
//
// Replaces enhancing_tpu/ops/ln_gemm.py::_ln_shift_gemm_kernel (entered
// through _ln_shift_gemm_pallas), the bf16- and fp32-weight twin of
// int8_ln_gemm.cu; it runs at the opt-in ENHANCING_TPU_DECODE_LNFUSE qkv
// site, and without the shift it takes fp32 B1's calls of a few rows (the
// LNFUSE mlp and head sites; ops/ln_gemm.py::ln_gemm_route). Numerics as
// there: W in x's dtype (a bf16 W under fp32 x is read as stored and used
// exactly, which is the cast the JAX wrapper makes), LN(x) rounded to x's
// dtype and returned, the shift blended in x's dtype, fp32 products and
// sums, fp32 bias and activation, one rounding.
//
// Bound on the H100: bytes: the fused qkv (6144 -> 18432) reads 226.5 MB
// of bf16 weights a layer at batch 8 (67.6 us). Design: int8_gemm.cuh, the
// body of B13 (every block computes its row tile's statistics, then LN,
// the shift and the activations' exact bf16 pieces into shared memory; K
// split to fill the SMs; epilogue warps sum the splits), with bf16 weights
// used as stored and fp32 weights split into three bf16 pieces in
// registers, and no scale.
#include "int8_gemm.cuh"

namespace {

template <typename XT, typename WT>
__global__ void __launch_bounds__(i8g::kThreads, 1)
    ln_shift_gemm_kernel(const __grid_constant__ CUtensorMap tw,
                         const i8g::Args a) {
  i8g::gemm_body<XT, WT, true>(&tw, a);
}

}  // namespace

// x (m, d) fp32 or bf16; w (n, d) bf16, or fp32 under fp32 x; out (m, n)
// and xn (m, d, or null: not written) in x's dtype; prev fp32 or bf16
// (m, d) with tm, both null for no shift; part, part_bytes, sync,
// sync_words: as etk_int8_gemm, for etk_ln_shift_gemm_plan's launch
ETK_API int etk_ln_shift_gemm(const void* x, const void* gamma,
                              const void* beta, const void* tm,
                              const void* prev, const void* w,
                              const void* bias, void* out, void* xn,
                              void* part, long long part_bytes, void* sync,
                              long long sync_words, int m, int d, int n,
                              int act, float eps, int prev_dtype,
                              int bias_dtype, int x_dtype, int w_dtype,
                              void* stream) {
  if (gamma == nullptr || beta == nullptr ||
      (tm != nullptr && prev == nullptr) || act < ACT_NONE ||
      act > ACT_GELU)
    return ETK_BAD_ARGS;
  i8g::Args a{};
  a.x = x;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.tm = static_cast<const float*>(tm);
  a.prev = prev;
  a.prev_dtype = prev_dtype;
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
  if (w_dtype == ETK_BF16 && x_dtype == ETK_F32)
    return i8g::launch<ln_shift_gemm_kernel<float, __nv_bfloat16>>(
        3, 2, w, a, part_bytes, sync_words, s);
  if (w_dtype == ETK_BF16 && x_dtype == ETK_BF16)
    return i8g::launch<ln_shift_gemm_kernel<__nv_bfloat16, __nv_bfloat16>>(
        1, 2, w, a, part_bytes, sync_words, s);
  if (w_dtype == ETK_F32 && x_dtype == ETK_F32)
    return i8g::launch<ln_shift_gemm_kernel<float, float>>(
        3, 4, w, a, part_bytes, sync_words, s);
  return ETK_BAD_ARGS;
}

// the launch for an (m, d) x (n, d) product of P-piece activations (3:
// fp32 x, 1: bf16) and w_bytes-byte weights (2: bf16, 4: fp32) on this
// device, as ops.int8.int8_gemm_plan mirrors it
ETK_API int etk_ln_shift_gemm_plan(int m, int d, int n, int pieces,
                                   int w_bytes, int* out) {
  if (w_bytes != 2 && w_bytes != 4) return ETK_BAD_ARGS;
  return i8g::plan_entry(m, d, n, pieces, w_bytes, out);
}

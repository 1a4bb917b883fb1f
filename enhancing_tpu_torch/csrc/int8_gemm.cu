// Weights-only int8 GEMM: y = act((x @ W_q^T) * scale + b) [+ residual].
//
// Replaces enhancing_tpu/ops/int8.py::_int8_gemm_kernel (entered through
// _int8_gemm_pallas). Numerics as there: W_q (n, d) int8 with one fp32
// scale per output channel, cast exactly to the activations' dtype; x fp32
// (the decode step's attention output) or bf16 (the prefill's shifted LN
// output); fp32 products and sums; then the scale, the bias, the
// activation and an fp32 residual, in fp32, rounded once to x's dtype.
// The TPU kernel's block sizes (a VMEM budget) are not reproduced.
//
// Bound on the H100: bytes. The decode projection reads 37.7 MB of int8
// weights for 0.6 GFLOP at batch 8 (11.3 us at 3.35 TB/s); the prefill's
// fused qkv 113 MB (33.8 us). Design: int8_gemm.cuh (wgmma on exact bf16
// pieces of x, weights streamed by TMA, K split to fill the SMs).
#include "int8_gemm.cuh"

namespace {

template <typename XT>
__global__ void __launch_bounds__(i8g::kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tw,
                     const i8g::Args a) {
  i8g::gemm_body<XT, int8_t, false>(&tw, a);
}

}  // namespace

// part: `part_bytes` bytes for int8_gemm_plan's fp32 partials; sync:
// `sync_words` persistent split counts, zero and left at zero (both may
// be null when the plan has one split; a launch whose plan needs more is
// refused); residual fp32 (m, n) or null; out (m, n) in x's dtype
ETK_API int etk_int8_gemm(const void* x, const void* w_q, const void* scale,
                          const void* bias, const void* residual, void* out,
                          void* part, long long part_bytes, void* sync,
                          long long sync_words, int m, int d, int n,
                          int act, int bias_dtype, int x_dtype,
                          void* stream) {
  if (scale == nullptr || act < ACT_NONE || act > ACT_GELU ||
      (x_dtype != ETK_F32 && x_dtype != ETK_BF16))
    return ETK_BAD_ARGS;
  i8g::Args a{};
  a.x = x;
  a.scale = static_cast<const float*>(scale);
  a.bias = bias;
  a.bias_dtype = bias_dtype;
  a.residual = static_cast<const float*>(residual);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.sync = static_cast<unsigned*>(sync);
  a.m = m;
  a.d = d;
  a.n = n;
  a.act = act;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == ETK_F32)
    return i8g::launch<int8_gemm_kernel<float>>(3, 1, w_q, a, part_bytes,
                                                sync_words, s);
  return i8g::launch<int8_gemm_kernel<__nv_bfloat16>>(
      1, 1, w_q, a, part_bytes, sync_words, s);
}

// the launch for an (m, d) x (n, d) product of P-piece activations (3:
// fp32 x, 1: bf16) on this device, as ops.int8.int8_gemm_plan mirrors it;
// the LN GEMM (int8_ln_gemm.cu) launches the same plan
ETK_API int etk_int8_gemm_plan(int m, int d, int n, int pieces, int* out) {
  return i8g::plan_entry(m, d, n, pieces, 1, out);
}

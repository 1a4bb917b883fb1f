// Single-pass LayerNorm: y = (x - mean) * (rstd * gamma) + beta.
//
// Replaces enhancing_tpu/ops/ln_gemm.py::_ln_kernel (the final LayerNorm of
// each ViT stack). Numerics as there: fp32 statistics with the fast
// variance max(E[x^2] - mean^2, 0), eps added inside rsqrt, fp32 affine,
// one rounding to the output dtype.
//
// Bound on the H100: bytes. It does ~8 flops per element against 4 bytes
// moved (bf16 in and out), far below the ~295 flop/byte ridge, so the
// floor is 2 * M * d * sizeof(T) over 3.35 TB/s. Design: one warp per row,
// each lane holding its slice of the row in registers after one 16-byte
// vectorised read, so the row is read once and written once; the two sums
// reduce with warp shuffles, no shared memory and no second pass.
#include "common.cuh"
#include "vec.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kMaxD = 2048;

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ out,
                     int m, int d, float eps) {
  constexpr int V = Vec<T>::N;
  constexpr int kMaxVecs = kMaxD / (32 * V);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= m) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* orow = out + static_cast<size_t>(row) * d;
  const int nvec = d / V;

  float v[kMaxVecs][V];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nvec) {
      Vec<T>::load(xr + vi * V, v[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s += v[i][j];
        ss += v[i][j] * v[i][j];
      }
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / d;
  const float var = fmaxf(ss / d - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nvec) {
      float y[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = vi * V + j;
        y[j] = (v[i][j] - mean) * (rstd * gamma[c]) + beta[c];
      }
      Vec<T>::store(orow + vi * V, y);
    }
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out,
           int m, int d, float eps, cudaStream_t stream) {
  if (d % Vec<T>::N != 0 || d > kMaxD || m <= 0) return ETK_BAD_ARGS;
  const int grid = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_kernel<T><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), m, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

ETK_API int etk_layernorm(const void* x, const void* gamma, const void* beta,
                          void* out, int m, int d, float eps, int dtype,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ETK_BF16)
    return launch<__nv_bfloat16>(x, gamma, beta, out, m, d, eps, s);
  if (dtype == ETK_F32) return launch<float>(x, gamma, beta, out, m, d, eps, s);
  return ETK_BAD_ARGS;
}

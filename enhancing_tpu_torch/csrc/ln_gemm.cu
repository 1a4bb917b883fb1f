// Fused LayerNorm -> GEMM: y = act(LN(x) @ W^T + b).
//
// Replaces enhancing_tpu/ops/ln_gemm.py::_ln_gemm_kernel (LN1 -> to_qkv and
// LN2 -> fc1 + tanh in every ViT block). Numerics as there: fp32 row
// statistics with the fast variance max(E[x^2] - mean^2, 0); the
// normalised row is rounded to the compute dtype before the product;
// fp32 accumulation; then fp32 bias, fp32 activation, one rounding.
// W is (n, d) with d contiguous: torch's Linear layout, which is the
// "col" operand that mma.sync wants.
//
// Bound on the H100: tensor-core operations. At the main path's shapes
// (M = B * 1024, d = 768, n = 2304 or 3072) it does 2*M*d*n flops against
// ~2*(M*d + M*n) bytes, hundreds of flops per byte, above the ridge.
// Design: a block owns a 128 x 128 output tile. It first computes mean and
// rstd of its 128 rows over the whole d (one extra read of the x block,
// which then stays in L2), then walks d in 32-wide tiles: each x tile is
// normalised in registers on its way to shared memory, rounded to bf16,
// and multiplied with the W tile by mma.sync m16n8k16 (eight warps, each
// 64 x 32), with the next tile's global loads in flight during the
// current tile's products and two shared-memory buffers so one barrier
// per tile suffices. The normalised activation never reaches device
// memory. fp32 inputs take a SIMT FMA path in full fp32 (no TF32).
// wgmma, TMA and a persistent schedule are left for later work.
#include "common.cuh"
#include "vec.cuh"

namespace {

// ---- row statistics ------------------------------------------------------

// mean and rstd of rows [row0, row0 + rows) into shared memory; one warp
// per row, rows past m get (0, 0)
template <typename T>
__device__ void row_stats(const T* __restrict__ x, int m, int d, float eps,
                          int row0, int rows, float* mean_s, float* rstd_s) {
  constexpr int V = Vec<T>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < rows; r += nwarps) {
    const int row = row0 + r;
    float s = 0.f, ss = 0.f;
    if (row < m) {
      const T* xr = x + static_cast<size_t>(row) * d;
      for (int c = lane * V; c < d; c += 32 * V) {
        float v[V];
        Vec<T>::load(xr + c, v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s += v[j];
          ss += v[j] * v[j];
        }
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      const float mean = s / d;
      const float var = fmaxf(ss / d - mean * mean, 0.f);
      mean_s[r] = row < m ? mean : 0.f;
      rstd_s[r] = row < m ? rsqrtf(var + eps) : 0.f;
    }
  }
}

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, LDS = BK + 8;  // +8: no conflicts
constexpr int kThreads = 256;                             // 2 x 4 warps

struct TileRegs {
  uint4 a[2];  // two 8-wide x vectors
  uint4 b[2];  // two 8-wide W vectors
};

__device__ __forceinline__ void load_tile(TileRegs& t,
                                          const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ w,
                                          int m, int n, int d, int row0,
                                          int col0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * kThreads;  // 0..511
    const int r = v / 4, c = (v % 4) * 8;
    const int gr = row0 + r, gn = col0 + r;
    t.a[i] = gr < m ? *reinterpret_cast<const uint4*>(
                          x + static_cast<size_t>(gr) * d + k0 + c)
                    : make_uint4(0, 0, 0, 0);
    t.b[i] = gn < n ? *reinterpret_cast<const uint4*>(
                          w + static_cast<size_t>(gn) * d + k0 + c)
                    : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void store_tile(const TileRegs& t,
                                           __nv_bfloat16 (*as)[LDS],
                                           __nv_bfloat16 (*bs)[LDS],
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           const float* mean_s,
                                           const float* rstd_s, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int r = v / 4, c = (v % 4) * 8;
    float xv[8], g[8], b[8];
    Vec<__nv_bfloat16>::load(reinterpret_cast<const __nv_bfloat16*>(&t.a[i]),
                             xv);
    Vec<float>::load(gamma + k0 + c, *reinterpret_cast<float(*)[4]>(g));
    Vec<float>::load(gamma + k0 + c + 4, *reinterpret_cast<float(*)[4]>(g + 4));
    Vec<float>::load(beta + k0 + c, *reinterpret_cast<float(*)[4]>(b));
    Vec<float>::load(beta + k0 + c + 4, *reinterpret_cast<float(*)[4]>(b + 4));
    const float mean = mean_s[r], rstd = rstd_s[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[j] = (xv[j] - mean) * (rstd * g[j]) + b[j];
    Vec<__nv_bfloat16>::store(&as[r][c], xv);
    *reinterpret_cast<uint4*>(&bs[r][c]) = t.b[i];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    ln_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int m, int d, int n,
                        int act, float eps) {
  __shared__ __align__(16) __nv_bfloat16 as[2][BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 bs[2][BN][LDS];
  __shared__ float mean_s[BM], rstd_s[BM];

  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: 64 rows x 32 cols

  row_stats(x, m, d, eps, row0, BM, mean_s, rstd_s);
  __syncthreads();

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  TileRegs regs;
  load_tile(regs, x, w, m, n, d, row0, col0, 0);
  store_tile(regs, as[0], bs[0], gamma, beta, mean_s, rstd_s, 0);
  __syncthreads();

  const int ktiles = d / BK;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) load_tile(regs, x, w, m, n, d, row0, col0, (kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], &as[cur][wm * 64 + mi * 16 + lane % 16]
                                [kk + (lane / 16) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, &bs[cur][wn * 32 + nj * 16 + lane % 8 + (lane / 16) * 8]
                          [kk + ((lane / 8) % 2) * 8]);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    if (more)
      store_tile(regs, as[cur ^ 1], bs[cur ^ 1], gamma, beta, mean_s, rstd_s,
                 (kt + 1) * BK);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = col0 + wn * 32 + ni * 8 + (lane % 4) * 2;
      if (col >= n) continue;
      const float b0 = bias ? bias[col] : 0.f;
      const float b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm * 64 + mi * 16 + lane / 4 + h * 8;
        if (row >= m) continue;
        const float y0 = apply_act(acc[mi][ni][2 * h] + b0, act);
        const float y1 = apply_act(acc[mi][ni][2 * h + 1] + b1, act);
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * n +
                                     col) = pack_bf16x2(y0, y1);
      }
    }
  }
}

// ---- fp32: SIMT FMA ----------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16, FLD = FM + 4;

__global__ void __launch_bounds__(kThreads)
    ln_gemm_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int m, int d, int n, int act, float eps) {
  __shared__ __align__(16) float as[FK][FLD];  // normalised x, k-major
  __shared__ __align__(16) float bs[FK][FLD];  // W, k-major
  __shared__ float mean_s[FM], rstd_s[FM];

  const int col0 = blockIdx.x * FN, row0 = blockIdx.y * FM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 4 x 4 outputs
  row_stats(x, m, d, eps, row0, FM, mean_s, rstd_s);
  __syncthreads();

  float acc[4][4] = {};
  const int lr = threadIdx.x / 4, lk = (threadIdx.x % 4) * 4;
  for (int k0 = 0; k0 < d; k0 += FK) {
    float xv[4] = {0.f, 0.f, 0.f, 0.f}, wv[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + lr < m)
      Vec<float>::load(x + static_cast<size_t>(row0 + lr) * d + k0 + lk, xv);
    if (col0 + lr < n)
      Vec<float>::load(w + static_cast<size_t>(col0 + lr) * d + k0 + lk, wv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + lk + j;
      as[lk + j][lr] =
          (xv[j] - mean_s[lr]) * (rstd_s[lr] * gamma[k]) + beta[k];
      bs[lk + j][lr] = wv[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
      Vec<float>::load(&as[k][ty * 4], a);
      Vec<float>::load(&bs[k][tx * 4], b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= n) continue;
      const float b = bias ? bias[col] : 0.f;
      out[static_cast<size_t>(row) * n + col] = apply_act(acc[i][j] + b, act);
    }
  }
}

}  // namespace

ETK_API int etk_ln_gemm(const void* x, const void* gamma, const void* beta,
                        const void* w, const void* bias, void* out, int m,
                        int d, int n, int act, float eps, int dtype,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || act < ACT_NONE || act > ACT_GELU)
    return ETK_BAD_ARGS;
  if (dtype == ETK_BF16) {
    if (d % BK != 0 || n % 8 != 0) return ETK_BAD_ARGS;
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    ln_gemm_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), m,
        d, n, act, eps);
  } else if (dtype == ETK_F32) {
    if (d % FK != 0) return ETK_BAD_ARGS;
    dim3 grid((n + FN - 1) / FN, (m + FM - 1) / FM);
    ln_gemm_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), m, d, n,
        act, eps);
  } else {
    return ETK_BAD_ARGS;
  }
  return static_cast<int>(cudaGetLastError());
}

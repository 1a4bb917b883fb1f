// Fused position-wise FFN: out = act(x W1^T + b1) W2^T + b2, the hidden
// never in device memory.
//
// Replaces enhancing_tpu/ops/ffn.py::_ffn_kernel as entered through
// _ffn_pallas (B16: the ViT block's FFN with ffn_impl='fused'). W1 is
// (h, d) and W2 (d, h), torch's Linear layout. Numerics as there: the
// hidden is an fp32 product plus the fp32 bias, the activation (tanh,
// squared ReLU or tanh-approximated GELU) runs in fp32, and the hidden is
// rounded to bf16 before W2; the W2 products sum in fp32 over the whole
// hidden dim, then + b2 in fp32 and one rounding.
//
// Bound on the H100: tensor-core operations, 4 * M * d * h flops against
// (2 * M * d + 2 * d * h) * 2 bytes. Design, the flash-attention forward
// with x rows as queries, W1 rows as keys and W2 columns as values: a block
// of four warps owns 64 rows (each warp 16) and one slab of DS output
// columns, and walks the hidden dim in chunks of 64. For each chunk, x and
// W1 arrive in 64-wide k tiles through two cp.async stages and S = x W1^T
// accumulates on mma.sync m16n8k16; bias and activation are applied to the
// S accumulators in registers, which become the bf16 A fragments of
// acc += H W2^T, W2's (DS, 64) chunk having arrived meanwhile. The (64, d)
// fp32 accumulator of a whole output row block does not fit a block's
// registers at d = 768 (192 a thread at 256 threads), so the output
// columns are split into slabs over the grid's y axis (DS = 256 where d
// allows: 128 accumulators a thread) and each slab's block recomputes the
// hidden: the first GEMM runs d / DS times, so at d = 768 the kernel does
// 2x the operations of the function (8 M d h flops), and reads each weight
// once per 64 rows from L2. Shared memory 72 KiB at DS = 256, two blocks
// an SM. wgmma, TMA and a slab-free schedule (a cluster sharing H) are
// later work.
#include "common.cuh"

namespace {

constexpr int BM = 64, HC = 64, BK = 64, kThreads = 128;
constexpr int LDK = BK + 8, LDH = HC + 8;  // padded rows: conflict-free ldmatrix

template <int DS>
__host__ __device__ constexpr int smem_bytes() {
  return (2 * (BM + HC) * LDK + DS * LDH) * 2;
}

template <int DS>
__global__ void __launch_bounds__(kThreads, 2)
    ffn_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w1,
               const float* __restrict__ b1,
               const __nv_bfloat16* __restrict__ w2,
               const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
               int m, int d, int h, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto xs = reinterpret_cast<__nv_bfloat16(*)[BM][LDK]>(smem_raw);
  auto w1s = reinterpret_cast<__nv_bfloat16(*)[HC][LDK]>(
      smem_raw + 2 * BM * LDK * 2);
  auto w2s = reinterpret_cast<__nv_bfloat16(*)[LDH]>(
      smem_raw + 2 * (BM + HC) * LDK * 2);

  const int r0 = blockIdx.x * BM, s0 = blockIdx.y * DS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k_tiles = d / BK, chunks = h / HC;

  auto load_xw1 = [&](int c, int kt, int stage) {
    const int k0 = kt * BK;
    for (int i = threadIdx.x; i < BM * (BK / 8); i += kThreads) {
      const int r = i / (BK / 8), cc = (i % (BK / 8)) * 8;
      const int row = r0 + r;
      cp_async_16(&xs[stage][r][cc],
                  x + static_cast<size_t>(row < m ? row : 0) * d + k0 + cc,
                  row < m ? 16 : 0);
      cp_async_16(&w1s[stage][r][cc],
                  w1 + static_cast<size_t>(c * HC + r) * d + k0 + cc, 16);
    }
    cp_async_commit();
  };
  auto load_w2 = [&](int c) {
    for (int i = threadIdx.x; i < DS * (HC / 8); i += kThreads) {
      const int r = i / (HC / 8), cc = (i % (HC / 8)) * 8;
      cp_async_16(&w2s[r][cc],
                  w2 + static_cast<size_t>(s0 + r) * h + c * HC + cc, 16);
    }
    cp_async_commit();
  };

  float acc[DS / 8][4];
#pragma unroll
  for (int i = 0; i < DS / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    __syncthreads();  // the previous chunk's W2 tile and stages are read
    load_w2(c);
    load_xw1(c, 0, 0);
    float s[HC / 8][4];
#pragma unroll
    for (int i = 0; i < HC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int stage = kt & 1;
      if (kt + 1 < k_tiles) {
        load_xw1(c, kt + 1, stage ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, &xs[stage][warp * 16 + lane % 16]
                           [kk * 16 + (lane / 16) * 8]);
#pragma unroll
        for (int nj = 0; nj < HC / 16; ++nj) {
          uint32_t r[4];
          ldmatrix_x4(r, &w1s[stage][nj * 16 + lane % 8 + (lane / 16) * 8]
                             [kk * 16 + ((lane / 8) % 2) * 8]);
          mma_bf16_16816(s[2 * nj], af, r[0], r[1]);
          mma_bf16_16816(s[2 * nj + 1], af, r[2], r[3]);
        }
      }
      __syncthreads();  // this stage is refilled two tiles from now
    }
    // (the last wait<0> and barrier also made this chunk's W2 tile visible)

    // hidden = act(S + b1) in fp32, rounded to bf16 as the A fragments
#pragma unroll
    for (int ni = 0; ni < HC / 8; ++ni) {
      const int col = c * HC + ni * 8 + (lane % 4) * 2;
      const float bb0 = b1[col], bb1 = b1[col + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[ni][e] = apply_act(s[ni][e] + ((e % 2) ? bb1 : bb0), act);
    }
#pragma unroll
    for (int kj = 0; kj < HC / 16; ++kj) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kj][0], s[2 * kj][1]);
      pa[1] = pack_bf16x2(s[2 * kj][2], s[2 * kj][3]);
      pa[2] = pack_bf16x2(s[2 * kj + 1][0], s[2 * kj + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kj + 1][2], s[2 * kj + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DS / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4(r, &w2s[dp * 16 + lane % 8 + (lane / 16) * 8]
                           [kj * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16_16816(acc[2 * dp], pa, r[0], r[1]);
        mma_bf16_16816(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  }

  // flush: + b2 in fp32, one rounding
#pragma unroll
  for (int dn = 0; dn < DS / 8; ++dn) {
    const int col = s0 + dn * 8 + (lane % 4) * 2;
    const float bb0 = b2[col], bb1 = b2[col + 1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + warp * 16 + lane / 4 + hh * 8;
      if (row >= m) continue;
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * d + col) =
          pack_bf16x2(acc[dn][2 * hh] + bb0, acc[dn][2 * hh + 1] + bb1);
    }
  }
}

template <int DS>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int m, int d, int h, int act,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DS>();
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((m + BM - 1) / BM, d / DS);
  ffn_kernel<DS><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), m, d, h, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: bf16 (m, d); w1: bf16 (h, d); w2: bf16 (d, h); b1 (h,), b2 (d,)
// fp32; all contiguous; d and h multiples of 64.
ETK_API int etk_ffn(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, int m, int d,
                    int h, int act, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || d <= 0 || h <= 0 || d % 64 || h % 64 || act < ACT_NONE ||
      act > ACT_GELU || (m + BM - 1) / BM > 2147483647 / 2)
    return ETK_BAD_ARGS;
  if (d % 256 == 0) return launch<256>(x, w1, b1, w2, b2, out, m, d, h, act, s);
  if (d % 128 == 0) return launch<128>(x, w1, b1, w2, b2, out, m, d, h, act, s);
  return launch<64>(x, w1, b1, w2, b2, out, m, d, h, act, s);
}

// Self-attention read straight from the fused (B, N, 3*H*D) qkv buffer:
// out[b, i, h*D:(h+1)*D] = softmax(scale * q_i . K^T) V per head.
//
// Replaces enhancing_tpu/ops/attention.py::_attn_kernel_packed as entered
// through _attention_packed_qkv_call (the ViT blocks' attention). q, k and
// v are read in place at lane offsets h*D, H*D + h*D and 2*H*D + h*D; there
// is no split copy. Numerics as there: q is scaled in bf16 (the scale
// itself rounded to bf16, then q * scale rounded), QK^T accumulates in
// fp32, the softmax is fp32, P is rounded to bf16 before PV, and the fp32
// output is multiplied by 1 / l and rounded once. Mask modes 'none' and
// 'prefix_causal' (col <= row, or both < cond_len); rows and columns past
// N are masked, so any N works.
//
// Bound on the H100: tensor-core operations. 4 * B * H * N^2 * D flops
// against ~(3 + 1) * B * N * H * D * 2 bytes: at N = 1024, D = 64 that is
// ~500 flops per byte. Design (flash-attention forward): a block of four
// warps owns 64 query rows of one (batch, head); each warp keeps its 16
// rows of scaled q as mma fragments in registers and walks the keys in
// tiles of 64 with an online fp32 softmax; S = q K^T and O += P V run on
// mma.sync m16n8k16, P going from the S accumulators to the A fragments
// in registers without touching shared memory; K and V tiles arrive by
// cp.async into two shared-memory stages, the next tile loading while the
// current one is used. The (N, N) score matrix never exists. With
// prefix_causal, key tiles past a block's last visible column are
// skipped. The TPU kernel's 128-lane slabs, q-lane masking and 4-chunk
// unroll are means of the TPU and are not reproduced.
#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, kThreads = 128;
constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;

template <int D>
constexpr int smem_bytes() {
  return (BQ + 4 * BKV) * (D + 8) * 2;  // q, two stages of k and v
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_qkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                    __nv_bfloat16* __restrict__ out, int n, int heads,
                    float scale, int mask_mode, int cond_len) {
  constexpr int LD = D + 8;  // padded rows: conflict-free ldmatrix
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto qs = reinterpret_cast<__nv_bfloat16(*)[LD]>(smem_raw);
  auto ks = reinterpret_cast<__nv_bfloat16(*)[BKV][LD]>(smem_raw + BQ * LD * 2);
  auto vs = reinterpret_cast<__nv_bfloat16(*)[BKV][LD]>(
      smem_raw + (BQ + 2 * BKV) * LD * 2);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(3) * heads * D;
  const __nv_bfloat16* base = qkv + static_cast<size_t>(b) * n * row_stride;
  const __nv_bfloat16* qb = base + h * D;
  const __nv_bfloat16* kb = base + (heads + h) * D;
  const __nv_bfloat16* vb = base + (2 * heads + h) * D;

  const bool causal = mask_mode == MASK_PREFIX_CAUSAL;
  int kv_tiles = (n + BKV - 1) / BKV;
  if (causal) {
    const int last_row = min(q0 + BQ, n) - 1;
    const int last_col = max(last_row, q0 < cond_len ? cond_len - 1 : 0);
    kv_tiles = min(kv_tiles, last_col / BKV + 1);
  }

  auto load_kv = [&](int t, int stage) {
    for (int v = threadIdx.x; v < BKV * VPR; v += kThreads) {
      const int r = v / VPR, c = (v % VPR) * 8;
      const int key = t * BKV + r;
      const size_t off = static_cast<size_t>(key < n ? key : 0) * row_stride + c;
      const int bytes = key < n ? 16 : 0;
      cp_async_16(&ks[stage][r][c], kb + off, bytes);
      cp_async_16(&vs[stage][r][c], vb + off, bytes);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // q tile, scaled in bf16 on its way to shared memory
  for (int v = threadIdx.x; v < BQ * VPR; v += kThreads) {
    const int r = v / VPR, c = (v % VPR) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < n)
      raw = *reinterpret_cast<const uint4*>(
          qb + static_cast<size_t>(q0 + r) * row_stride + c);
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(p[i]);
      p[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(&qs[r][c]) = raw;
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    ldmatrix_x4(qf[kd], &qs[warp * 16 + lane % 16][kd * 16 + (lane / 16) * 8]);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this lane's partial sums
  const int row_a = q0 + warp * 16 + lane / 4;  // rows row_a and row_a + 8

  for (int t = 0; t < kv_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < kv_tiles) {
      load_kv(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
      for (int nj = 0; nj < BKV / 16; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, &ks[stage][nj * 16 + lane % 8 + (lane / 16) * 8]
                          [kd * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16_16816(s[2 * nj], qf[kd], r[0], r[1]);
        mma_bf16_16816(s[2 * nj + 1], qf[kd], r[2], r[3]);
      }
    }

    // mask, then the online softmax update in fp32
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + (e / 2) * 8;
        const int col = t * BKV + ni * 8 + (lane % 4) * 2 + (e % 2);
        bool ok = col < n;
        if (causal) ok = ok && (col <= row || (row < cond_len && col < cond_len));
        if (!ok) s[ni][e] = -INFINITY;
        tile_max[e / 2] = fmaxf(tile_max[e / 2], s[ni][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tile_max[hh] = fmaxf(tile_max[hh],
                           __shfl_xor_sync(0xffffffffu, tile_max[hh], 1));
      tile_max[hh] = fmaxf(tile_max[hh],
                           __shfl_xor_sync(0xffffffffu, tile_max[hh], 2));
      const float m_new = fmaxf(row_max[hh], tile_max[hh]);
      alpha[hh] = expf(row_max[hh] - m_new);
      row_max[hh] = m_new;
      row_sum[hh] *= alpha[hh];
    }
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ni][e] = expf(s[ni][e] - row_max[e / 2]);
        row_sum[e / 2] += s[ni][e];
      }
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e / 2];

    // O += P V, P (bf16) straight from the S accumulators
#pragma unroll
    for (int kj = 0; kj < BKV / 16; ++kj) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kj][0], s[2 * kj][1]);
      pa[1] = pack_bf16x2(s[2 * kj][2], s[2 * kj][3]);
      pa[2] = pack_bf16x2(s[2 * kj + 1][0], s[2 * kj + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kj + 1][2], s[2 * kj + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &vs[stage][kj * 16 + lane % 8 + ((lane / 8) % 2) * 8]
                                [dp * 16 + (lane / 16) * 8]);
        mma_bf16_16816(o[2 * dp], pa, r[0], r[1]);
        mma_bf16_16816(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
  }

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = row_sum[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hh] = 1.f / l;
  }
  const size_t out_stride = static_cast<size_t>(heads) * D;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * n * out_stride + h * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_a + hh * 8;
    if (row >= n) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row) * out_stride +
                                   col) =
          pack_bf16x2(o[dn][2 * hh] * inv[hh], o[dn][2 * hh + 1] * inv[hh]);
    }
  }
}

template <int D>
int launch(const void* qkv, void* out, int b, int n, int heads, float scale,
           int mask_mode, int cond_len, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_qkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((n + BQ - 1) / BQ, heads, b);
  attn_qkv_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      n, heads, scale, mask_mode, cond_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

ETK_API int etk_attention_qkv(const void* qkv, void* out, int b, int n,
                              int heads, int head_dim, float scale,
                              int mask_mode, int cond_len, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  switch (head_dim) {
    case 32:
      return launch<32>(qkv, out, b, n, heads, scale, mask_mode, cond_len, s);
    case 64:
      return launch<64>(qkv, out, b, n, heads, scale, mask_mode, cond_len, s);
    case 128:
      return launch<128>(qkv, out, b, n, heads, scale, mask_mode, cond_len, s);
    default:
      return ETK_BAD_ARGS;
  }
}

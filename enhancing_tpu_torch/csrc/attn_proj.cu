// Attention -> output projection -> bias -> residual in one kernel:
// out[b, i] = residual[b, i] + concat_h(softmax(q_ih . K_h^T) V_h) Wp^T + bp.
//
// Replaces enhancing_tpu/ops/attention.py::_attn_proj_kernel as entered
// through _attention_proj_packed_call (B15: the ViT block's attention when
// ENHANCING_TPU_ATTN_PROJ is set; inference only). q, k and v are read in
// place as (B, N, H*D) row-strided views (the lane slices of the fused qkv
// buffer); Wp is (HO, H*D), torch's Linear layout. Numerics as there: q is
// scaled in bf16 (the scale rounded to bf16, then q * scale rounded; the
// TPU wrapper scales q in its dtype before the call), QK^T and the softmax
// in fp32, P rounded to bf16 before PV, each head's output multiplied by
// 1 / l and rounded to bf16 (the kernel casts the attention tile to the
// compute dtype before the projection); the projection accumulates in
// fp32, then bp and the residual are added in fp32 and the sum is rounded
// once. Mask modes 'none' and 'prefix_causal'; rows past N and keys past
// M are masked.
//
// Bound on the H100: tensor-core operations, 4 * B * H * N * M * D for the
// attention plus 2 * B * N * HD * HO for the projection, against
// (4 * B * N * HD + 2 * B * N * HO) * 2 bytes. Design: a block owns 64
// query rows of one batch row and all heads. Two groups of four warps
// each run the flash-attention tile of csrc/attention.cu (each warp 16
// query rows; key tiles of 64 through cp.async double buffers; S and PV on
// mma.sync m16n8k16, P from the S accumulators in registers) over the
// heads g, g + 2, ..., synchronising on their own named barrier; each head
// leaves its bf16 output in a (64, H*D) tile in shared memory (96 KiB at
// ViT-Base, 128 KiB at H*D = 1024), which never reaches device memory.
// Then all eight warps multiply that tile by Wp in column tiles of 128:
// a (64, 128) fp32 accumulator is 32 registers a thread, so the 768-wide
// (or 1280-wide) output row never has to live in registers at once; Wp
// tiles of 128 x 64 arrive by cp.async into two stages that reuse the
// first group's K/V buffers. bp and the residual are added at each tile's
// flush, and the output is written once. Shared memory: 64 x (HD + 8) x 2
// bytes for the tile plus 2 x 46 KiB for the groups' q, K and V stages,
// 187 KiB at HD = 768, 219 KiB at 1024, one block an SM. Only D = 64, the
// head dim of every stage-1 config, is built.
#include "common.cuh"

namespace {

constexpr int D = 64, BQ = 64, BKV = 64, CT = 128, BK = 64;
constexpr int kThreads = 256, kGroupThreads = 128;
constexpr int LD = D + 8, LDW = BK + 8;  // padded rows: conflict-free ldmatrix
constexpr int VPR = D / 8;               // 16-byte vectors per row
constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;
// one group's q tile and two stages of K and V
constexpr int kGroupBytes = (BQ + 4 * BKV) * LD * 2;
static_assert(2 * CT * LDW * 2 <= kGroupBytes, "Wp stages reuse a group");

__host__ __device__ constexpr int smem_bytes(int hd) {
  return BQ * (hd + 8) * 2 + 2 * kGroupBytes;
}

__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(kGroupThreads));
}

__global__ void __launch_bounds__(kThreads, 1)
    attn_proj_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ wp,
                     const float* __restrict__ bp,
                     const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ out, int q_row, int k_row,
                     int v_row, int n, int m, int heads, int ho, float scale,
                     int mask_mode, int cond_len) {
  const int hd = heads * D, ldo = hd + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4, lw = warp % 4, gt = threadIdx.x % kGroupThreads;
  unsigned char* gbase = smem_raw + BQ * ldo * 2 + g * kGroupBytes;
  auto qs = reinterpret_cast<__nv_bfloat16(*)[LD]>(gbase);
  auto ks = reinterpret_cast<__nv_bfloat16(*)[BKV][LD]>(gbase + BQ * LD * 2);
  auto vs = reinterpret_cast<__nv_bfloat16(*)[BKV][LD]>(
      gbase + (BQ + 2 * BKV) * LD * 2);

  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const __nv_bfloat16* qbat = q + static_cast<size_t>(b) * n * q_row;
  const __nv_bfloat16* kbat = k + static_cast<size_t>(b) * m * k_row;
  const __nv_bfloat16* vbat = v + static_cast<size_t>(b) * m * v_row;

  const bool causal = mask_mode == MASK_PREFIX_CAUSAL;
  int kv_tiles = (m + BKV - 1) / BKV;
  if (causal) {
    const int last_row = min(q0 + BQ, n) - 1;
    const int last_col = max(last_row, q0 < cond_len ? cond_len - 1 : 0);
    kv_tiles = min(kv_tiles, last_col / BKV + 1);
  }
  const int row_a = q0 + lw * 16 + lane / 4;  // rows row_a and row_a + 8

  // ---- attention, head by head, group g taking heads g, g + 2, ... ----
  for (int h = g; h < heads; h += 2) {
    const __nv_bfloat16* kb = kbat + h * D;
    const __nv_bfloat16* vb = vbat + h * D;
    auto load_kv = [&](int t, int stage) {
      for (int i = gt; i < BKV * VPR; i += kGroupThreads) {
        const int r = i / VPR, c = (i % VPR) * 8;
        const int key = t * BKV + r;
        const int bytes = key < m ? 16 : 0;
        const size_t kr = static_cast<size_t>(key < m ? key : 0);
        cp_async_16(&ks[stage][r][c], kb + kr * k_row + c, bytes);
        cp_async_16(&vs[stage][r][c], vb + kr * v_row + c, bytes);
      }
      cp_async_commit();
    };
    group_sync(g);  // the previous head's q, K and V are no longer read
    load_kv(0, 0);
    for (int i = gt; i < BQ * VPR; i += kGroupThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (q0 + r < n)
        raw = *reinterpret_cast<const uint4*>(
            qbat + static_cast<size_t>(q0 + r) * q_row + h * D + c);
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(p[e]);
        p[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(&qs[r][c]) = raw;
    }
    group_sync(g);
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      ldmatrix_x4(qf[kd], &qs[lw * 16 + lane % 16][kd * 16 + (lane / 16) * 8]);

    float o[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};  // this lane's partial sums

    for (int t = 0; t < kv_tiles; ++t) {
      const int stage = t & 1;
      if (t + 1 < kv_tiles) {
        load_kv(t + 1, stage ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(g);

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

      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_a + (e / 2) * 8;
          const int col = t * BKV + ni * 8 + (lane % 4) * 2 + (e % 2);
          bool ok = col < m;
          if (causal)
            ok = ok && (col <= row || (row < cond_len && col < cond_len));
          if (!ok) s[ni][e] = -INFINITY;
          tile_max[e / 2] = fmaxf(tile_max[e / 2], s[ni][e]);
        }
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tile_max[hh] = fmaxf(tile_max[hh],
                             __shfl_xor_sync(0xffffffffu, tile_max[hh], 1));
        tile_max[hh] = fmaxf(tile_max[hh],
                             __shfl_xor_sync(0xffffffffu, tile_max[hh], 2));
        const float m_new = fmaxf(row_max[hh], tile_max[hh]);
        // a row with nothing visible yet keeps exp(-inf - -inf) out
        m_use[hh] = m_new == -INFINITY ? 0.f : m_new;
        alpha[hh] = expf(row_max[hh] - m_use[hh]);
        row_max[hh] = m_new;
        row_sum[hh] *= alpha[hh];
      }
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[ni][e] = expf(s[ni][e] - m_use[e / 2]);
          row_sum[e / 2] += s[ni][e];
        }
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e / 2];

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
          ldmatrix_x4_trans(
              r, &vs[stage][kj * 16 + lane % 8 + ((lane / 8) % 2) * 8]
                    [dp * 16 + (lane / 16) * 8]);
          mma_bf16_16816(o[2 * dp], pa, r[0], r[1]);
          mma_bf16_16816(o[2 * dp + 1], pa, r[2], r[3]);
        }
      }
      group_sync(g);  // this stage is refilled two tiles from now
    }

    // the head's output, rounded to bf16, into the (64, H*D) tile
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = row_sum[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int r = lw * 16 + lane / 4 + hh * 8;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = h * D + dn * 8 + (lane % 4) * 2;
        *reinterpret_cast<uint32_t*>(&os[r * ldo + col]) =
            pack_bf16x2(o[dn][2 * hh] * inv, o[dn][2 * hh + 1] * inv);
      }
    }
  }
  __syncthreads();  // every head is in the tile; the K/V stages are free

  // ---- projection: (64, HD) x Wp^T in column tiles of CT ----
  auto ws = reinterpret_cast<__nv_bfloat16(*)[CT][LDW]>(
      smem_raw + BQ * ldo * 2);
  const int rg = warp % 4, ch = warp / 4;  // 16 rows, 64 of the CT columns
  const int k_tiles = hd / BK, c_tiles = (ho + CT - 1) / CT;
  const int n_tiles = k_tiles * c_tiles;
  auto load_w = [&](int t, int stage) {
    const int c0 = (t / k_tiles) * CT, k0 = (t % k_tiles) * BK;
    for (int i = threadIdx.x; i < CT * (BK / 8); i += kThreads) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int col = c0 + r;
      const size_t off =
          static_cast<size_t>(col < ho ? col : 0) * hd + k0 + c;
      cp_async_16(&ws[stage][r][c], wp + off, col < ho ? 16 : 0);
    }
    cp_async_commit();
  };
  load_w(0, 0);
  float acc[8][4];
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1, kt = t % k_tiles;
    if (t + 1 < n_tiles) {
      load_w(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, &os[(rg * 16 + lane % 16) * ldo + kt * BK + kk * 16 +
                          (lane / 16) * 8]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, &ws[stage][ch * 64 + nj * 16 + lane % 8 +
                                  (lane / 16) * 8]
                          [kk * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16_16816(acc[2 * nj], af, r[0], r[1]);
        mma_bf16_16816(acc[2 * nj + 1], af, r[2], r[3]);
      }
    }
    if (kt == k_tiles - 1) {
      // flush: + bp + residual in fp32, one rounding
      const int c0 = (t / k_tiles) * CT + ch * 64;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = c0 + ni * 8 + (lane % 4) * 2;
        if (col >= ho) continue;
        const float b0 = bp[col], b1 = bp[col + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = q0 + rg * 16 + lane / 4 + hh * 8;
          if (row >= n) continue;
          const size_t off = (static_cast<size_t>(b) * n + row) * ho + col;
          const float2 r2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + off));
          *reinterpret_cast<uint32_t*>(out + off) =
              pack_bf16x2(acc[ni][2 * hh] + b0 + r2.x,
                          acc[ni][2 * hh + 1] + b1 + r2.y);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
  }
}

}  // namespace

// q: bf16 (B, N, H*64) rows q_row elements apart; k, v: bf16 (B, M, H*64)
// rows k_row, v_row apart (multiples of 8; batches N or M rows apart); wp:
// bf16 (HO, H*64); bp: fp32 (HO,); res, out: bf16 (B, N, HO) contiguous.
ETK_API int etk_attn_proj(const void* q, const void* k, const void* v,
                          const void* wp, const void* bp, const void* res,
                          void* out, int q_row, int k_row, int v_row, int b,
                          int n, int m, int heads, int head_dim, int ho,
                          float scale, int mask_mode, int cond_len,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int hd = heads * head_dim;
  if (b <= 0 || n <= 0 || m <= 0 || heads <= 0 || ho <= 0 || b > 65535 ||
      head_dim != D || ho % 64 || q_row < hd || k_row < hd || v_row < hd ||
      q_row % 8 || k_row % 8 || v_row % 8 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  const int bytes = smem_bytes(hd);
  if (bytes > 232448) return ETK_BAD_ARGS;
  cudaError_t err = cudaFuncSetAttribute(
      attn_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BQ - 1) / BQ, b);
  attn_proj_kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const float*>(bp),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), q_row, k_row, v_row, n, m, heads, ho,
      scale, mask_mode, cond_len);
  return static_cast<int>(cudaGetLastError());
}

// Attention on separate q (B, N, H, D), k and v (B, M, H, D), each read in
// place through its own batch, head and row strides:
// out[b, i, h] = softmax(s_i) V per head, s_i = q_i . K^T.
//
// Replaces four TPU kernels of enhancing_tpu/ops/attention.py, one forward
// for all of them:
// - _attn_kernel_packed as entered through _attention_packed_call (B8: the
//   GPT prior's attention, reached by multihead_attention_bnhd) at head
//   dims up to the prior's 384;
// - _attn_kernel (B17, _attention_pallas: (B, H, N, D) tensors, M may
//   differ from N) and _attn_kernel_bnhd (B18, _attention_pallas_bnhd:
//   (B, N, H, D) tensors), which put the scale on the fp32 scores
//   (kScoreScale); the TPU kernels' whole-row softmax normalises P before
//   rounding it to bf16, this one rounds the unnormalised P against the
//   running row max and divides at the end, as B2 and B8 do;
// - _attn_kernel_packed_gridchunk (B19): prefix-causal on pre-scaled
//   packed q, k, v, whose point, key tiles past a block's last visible
//   column neither loaded nor computed, this kernel has always had. Its
//   block_q and k_chunk are TPU means and are not reproduced.
// Numerics otherwise as B8's: q is scaled in bf16 (the scale rounded to
// bf16, then q * scale rounded; the TPU wrapper scales q in its dtype
// before the call) unless kScoreScale, QK^T accumulates in fp32, the
// softmax is fp32, P is rounded to bf16 before PV, and the fp32 output is
// multiplied by 1 / l and rounded once. Mask modes 'none' and
// 'prefix_causal' (col <= row, or both < cond_len); rows past N and keys
// past M are masked, so any N and M work, N = 1 included.
//
// Bound on the H100: tensor-core operations, 4 * B * H * N^2 * D flops
// (about half with the causal mask) against 4 * B * N * H * D * 2 bytes.
// Design: the flash-attention forward of csrc/attention.cu (a block of four
// warps owns 64 query rows of one (batch, head), each warp 16 rows; key
// tiles of 64 through cp.async double buffers; S = q K^T and O += P V on
// mma.sync m16n8k16 with P passed from the S accumulators in registers;
// key tiles past the block's last visible column skipped), changed where
// D = 384 does not fit it. A 64 x 384 fp32 output accumulator would be 192
// registers a thread, so the output's head dim is cut into slabs of at
// most 128 lanes along the grid's y axis, and each block recomputes S for
// its slab: at D = 384 that is three slabs, S computed three times, twice
// the operations of one pass. q does not stay in registers either (24
// fragments of 4 registers at D = 384): the scaled q tile sits in shared
// memory and each k-step loads its fragment with ldmatrix. Shared memory
// at D = 384: q 64 x 392, two stages of K 64 x 392 and of V 64 x 136 bf16,
// 181 KB, one block per SM. On the packed qkv buffer's lane slices at the
// ViT's D = 64 it gives attention.cu's outputs bit for bit but runs
// slower (PERF.md), so the ViT keeps attention.cu. The strides and the key
// length are runtime arguments; the scale's place is a template argument,
// so B8's instruction stream gains no branch.
#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, kThreads = 128;
constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;

// output lanes per block: the whole head up to 128, else 128-lane slabs
template <int D>
__host__ __device__ constexpr int slab() {
  return D <= 128 ? D : 128;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return ((BQ + 2 * BKV) * (D + 8) + 2 * BKV * (slab<D>() + 8)) * 2;
}

// element strides of one tensor: between batches, heads and rows
struct Strides {
  int batch, head, row;
};

template <int D, bool kScoreScale>
__global__ void __launch_bounds__(kThreads)
    attn_bnhd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, Strides qs_, Strides ks_,
                     Strides vs_, Strides os_, int n, int m, int heads,
                     float scale, int mask_mode, int cond_len) {
  constexpr int DS = slab<D>();
  constexpr int SLABS = D / DS;
  constexpr int LD = D + 8, LDS = DS + 8;  // padded rows: conflict-free ldmatrix
  constexpr int VPR = D / 8, VPRS = DS / 8;  // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto qs = reinterpret_cast<__nv_bfloat16(*)[LD]>(smem_raw);
  auto ks = reinterpret_cast<__nv_bfloat16(*)[BKV][LD]>(smem_raw + BQ * LD * 2);
  auto vs = reinterpret_cast<__nv_bfloat16(*)[BKV][LDS]>(
      smem_raw + (BQ + 2 * BKV) * LD * 2);

  const int q0 = blockIdx.x * BQ, b = blockIdx.z;
  const int h = blockIdx.y / SLABS, sl = blockIdx.y % SLABS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * qs_.batch +
                            static_cast<size_t>(h) * qs_.head;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * ks_.batch +
                            static_cast<size_t>(h) * ks_.head;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * vs_.batch +
                            static_cast<size_t>(h) * vs_.head + sl * DS;
  const int q_stride = qs_.row, k_stride = ks_.row, v_stride = vs_.row;

  const bool causal = mask_mode == MASK_PREFIX_CAUSAL;
  int kv_tiles = (m + BKV - 1) / BKV;
  if (causal) {
    const int last_row = min(q0 + BQ, n) - 1;
    const int last_col = max(last_row, q0 < cond_len ? cond_len - 1 : 0);
    kv_tiles = min(kv_tiles, last_col / BKV + 1);
  }

  auto load_kv = [&](int t, int stage) {
    for (int i = threadIdx.x; i < BKV * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const int key = t * BKV + r;
      const size_t off = static_cast<size_t>(key < m ? key : 0) * k_stride + c;
      cp_async_16(&ks[stage][r][c], kb + off, key < m ? 16 : 0);
    }
    for (int i = threadIdx.x; i < BKV * VPRS; i += kThreads) {
      const int r = i / VPRS, c = (i % VPRS) * 8;
      const int key = t * BKV + r;
      const size_t off = static_cast<size_t>(key < m ? key : 0) * v_stride + c;
      cp_async_16(&vs[stage][r][c], vb + off, key < m ? 16 : 0);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // q tile, scaled in bf16 on its way to shared memory (or as it is, when
  // the scale goes on the scores)
  for (int i = threadIdx.x; i < BQ * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < n)
      raw = *reinterpret_cast<const uint4*>(
          qb + static_cast<size_t>(q0 + r) * q_stride + c);
    if (!kScoreScale) {
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(p[e]);
        p[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(&qs[r][c]) = raw;
  }

  float o[DS / 8][4];
#pragma unroll
  for (int i = 0; i < DS / 8; ++i)
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
    __syncthreads();  // the tile (and, at t = 0, the q tile) is in place

    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t qf[4];
      ldmatrix_x4(qf, &qs[warp * 16 + lane % 16][kd * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int nj = 0; nj < BKV / 16; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, &ks[stage][nj * 16 + lane % 8 + (lane / 16) * 8]
                          [kd * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16_16816(s[2 * nj], qf, r[0], r[1]);
        mma_bf16_16816(s[2 * nj + 1], qf, r[2], r[3]);
      }
    }

    // scale (kScoreScale), mask, then the online softmax update in fp32
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + (e / 2) * 8;
        const int col = t * BKV + ni * 8 + (lane % 4) * 2 + (e % 2);
        if (kScoreScale) s[ni][e] *= scale;
        bool ok = col < m;
        if (causal) ok = ok && (col <= row || (row < cond_len && col < cond_len));
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
      // a row with nothing visible yet (a padded row past N, whose every
      // column is masked) keeps exp() of -inf - -inf out of the sums
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
    for (int i = 0; i < DS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e / 2];

    // O += P V on this block's slab, P (bf16) straight from the S
    // accumulators
#pragma unroll
    for (int kj = 0; kj < BKV / 16; ++kj) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kj][0], s[2 * kj][1]);
      pa[1] = pack_bf16x2(s[2 * kj][2], s[2 * kj][3]);
      pa[2] = pack_bf16x2(s[2 * kj + 1][0], s[2 * kj + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kj + 1][2], s[2 * kj + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DS / 16; ++dp) {
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
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * os_.batch +
                      static_cast<size_t>(h) * os_.head + sl * DS;
  const int o_stride = os_.row;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_a + hh * 8;
    if (row >= n) continue;
#pragma unroll
    for (int dn = 0; dn < DS / 8; ++dn) {
      const int col = dn * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row) * o_stride +
                                   col) =
          pack_bf16x2(o[dn][2 * hh] * inv[hh], o[dn][2 * hh + 1] * inv[hh]);
    }
  }
}

template <int D, bool kScoreScale>
int launch(const void* q, const void* k, const void* v, void* out,
           const Strides* st, int b, int n, int m, int heads, float scale,
           int mask_mode, int cond_len, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bnhd_kernel<D, kScoreScale>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((n + BQ - 1) / BQ, heads * (D / slab<D>()), b);
  attn_bnhd_kernel<D, kScoreScale><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      st[0], st[1], st[2], st[3], n, m, heads, scale, mask_mode, cond_len);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             const Strides* st, int b, int n, int m, int heads, float scale,
             int score_scale, int mask_mode, int cond_len,
             cudaStream_t stream) {
  return score_scale
             ? launch<D, true>(q, k, v, out, st, b, n, m, heads, scale,
                               mask_mode, cond_len, stream)
             : launch<D, false>(q, k, v, out, st, b, n, m, heads, scale,
                                mask_mode, cond_len, stream);
}

}  // namespace

// q, out: bf16 (B, N, H, D); k, v: bf16 (B, M, H, D); each addressed as
// base + b * batch + h * head + row * row_stride + lane, its three strides
// in elements (multiples of 8) at strides[3 * i .. 3 * i + 2] for q, k, v,
// out. score_scale: 1 puts the scale on the fp32 scores, 0 scales q in
// bf16.
ETK_API int etk_attention_bnhd(const void* q, const void* k, const void* v,
                               void* out, const int* strides, int b, int n,
                               int m, int heads, int head_dim, float scale,
                               int score_scale, int mask_mode, int cond_len,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || m <= 0 || heads <= 0 || b > 65535 ||
      heads > 65535 / 3 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    if (st[i].batch < 0 || st[i].head < 0 || st[i].row < 0 ||
        st[i].batch % 8 || st[i].head % 8 || st[i].row % 8)
      return ETK_BAD_ARGS;
  }
  switch (head_dim) {
    case 32:
      return launch_d<32>(q, k, v, out, st, b, n, m, heads, scale,
                          score_scale, mask_mode, cond_len, s);
    case 64:
      return launch_d<64>(q, k, v, out, st, b, n, m, heads, scale,
                          score_scale, mask_mode, cond_len, s);
    case 128:
      return launch_d<128>(q, k, v, out, st, b, n, m, heads, scale,
                           score_scale, mask_mode, cond_len, s);
    case 384:
      return launch_d<384>(q, k, v, out, st, b, n, m, heads, scale,
                           score_scale, mask_mode, cond_len, s);
    default:
      return ETK_BAD_ARGS;
  }
}

// Backward of the packed-qkv self-attention: dq, dk and dv from q (already
// scaled), k, v and dO, each (B, N, H*D) bf16 with rows read in place at
// lane offset h*D (a row stride per tensor, so k and v can be lane slices
// of the fused qkv buffer). Outputs are (B, N, H*D) bf16.
//
// Replaces enhancing_tpu/ops/attention.py::_attn_bwd_kernel as entered
// through _attention_packed_bwd_call. Numerics as there: scores, softmax,
// dP = dO V^T and every accumulator in fp32; P = e / sum(e) with the exact
// row max; delta = rowsum(P * dP) in fp32; dS = P * (dP - delta) and P are
// rounded to bf16 before the dq / dk and dv products; dk and dv accumulate
// in fp32 over every query and are rounded once. Mask modes 'none' and
// 'prefix_causal' (col <= row, or both < cond_len); rows and columns past
// N are masked, so any N works.
//
// Bound on the H100: tensor-core operations, ~5 products of 2*N^2*D
// flops per (batch, head) against ~7 * B * N * H * D * 2 bytes. The TPU
// kernel holds a q block and the whole key row in VMEM and takes the
// softmax of the full row at once; a Hopper block cannot hold the row, so
// the backward is two kernels over the same 64 x 64 mma.sync m16n8k16
// tiles as csrc/attention.cu:
//   1. rows: a block owns 64 query rows of one (batch, head) and sweeps the
//      key tiles three times (the tiles stream through two cp.async
//      stages): (a) row max and sum, online; (b) delta = rowsum(P * dP);
//      (c) dS and dq += dS K, written once. It leaves the row max, 1/sum
//      and delta in a (3, B, H, N_pad) fp32 workspace.
//   2. cols: a block owns 64 keys; each warp keeps its 16 keys of K and V
//      as mma fragments and sweeps the query tiles (q, dO and the row
//      statistics through two cp.async stages), recomputing S^T = K q^T and
//      dP^T = V dO^T, and accumulating dv += P^T dO and dk += dS^T q in
//      registers, written once.
// Neither the (N, N) scores nor P ever reach device memory, and nothing is
// summed with atomics, so the result does not depend on scheduling. The
// scores are computed three times in (1) and once in (2): about twice the
// operations of a one-pass backward, the price of keeping it simple.
#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, kThreads = 128;
constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* stats;  // row max, 1 / row sum, delta: each (B, H, n_pad)
  int ld_q, ld_k, ld_v, ld_do, ld_dq, ld_dk, ld_dv;  // row strides
  int n, n_pad, heads, mask_mode, cond_len;
};

__device__ __forceinline__ bool causal_ok(int row, int col, int cond_len) {
  return col <= row || (row < cond_len && col < cond_len);
}

// rows [0, BQ) of a (rows, D) bf16 tile from global rows r0.. with stride
// ld, into padded shared rows; rows past n are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16 (*dst)[D + 8],
                                                const __nv_bfloat16* src,
                                                size_t ld, int r0, int n) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const int row = r0 + r;
    const size_t off = static_cast<size_t>(row < n ? row : 0) * ld + c;
    cp_async_16(&dst[r][c], src + off, row < n ? 16 : 0);
  }
}

template <int D>
constexpr int rows_smem_bytes() {
  return (2 * BQ + 4 * BKV) * (D + 8) * 2;  // q, dO, two stages of k and v
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_rows_kernel(BwdArgs a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto qs = reinterpret_cast<__nv_bfloat16(*)[LD]>(smem_raw);
  auto dos = reinterpret_cast<__nv_bfloat16(*)[LD]>(smem_raw + BQ * LD * 2);
  auto ks = reinterpret_cast<__nv_bfloat16(*)[BKV][LD]>(smem_raw +
                                                        2 * BQ * LD * 2);
  auto vs = reinterpret_cast<__nv_bfloat16(*)[BKV][LD]>(
      smem_raw + (2 * BQ + 2 * BKV) * LD * 2);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = a.n;
  const size_t bn = static_cast<size_t>(b) * n;
  const __nv_bfloat16* qb = a.q + bn * a.ld_q + h * D;
  const __nv_bfloat16* kb = a.k + bn * a.ld_k + h * D;
  const __nv_bfloat16* vb = a.v + bn * a.ld_v + h * D;
  const __nv_bfloat16* dob = a.dout + bn * a.ld_do + h * D;

  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  int kv_tiles = (n + BKV - 1) / BKV;
  if (causal) {
    const int last_row = min(q0 + BQ, n) - 1;
    const int last_col = max(last_row, q0 < a.cond_len ? a.cond_len - 1 : 0);
    kv_tiles = min(kv_tiles, last_col / BKV + 1);
  }
  // three sweeps over the key tiles, streamed as one sequence
  auto load_kv = [&](int it, int stage) {
    const int t = it % kv_tiles;
    load_rows_async<D, BKV>(ks[stage], kb, a.ld_k, t * BKV, n);
    load_rows_async<D, BKV>(vs[stage], vb, a.ld_v, t * BKV, n);
    cp_async_commit();
  };
  load_rows_async<D, BQ>(qs, qb, a.ld_q, q0, n);
  load_rows_async<D, BQ>(dos, dob, a.ld_do, q0, n);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    ldmatrix_x4(qf[kd], &qs[warp * 16 + lane % 16][kd * 16 + (lane / 16) * 8]);
    ldmatrix_x4(dof[kd],
                &dos[warp * 16 + lane % 16][kd * 16 + (lane / 16) * 8]);
  }

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this lane's partial sums
  float inv[2] = {0.f, 0.f};
  float delta[2] = {0.f, 0.f};  // partial until the second sweep ends
  const int row_a = q0 + warp * 16 + lane / 4;  // rows row_a and row_a + 8

  const int iters = 3 * kv_tiles;
  for (int it = 0; it < iters; ++it) {
    const int stage = it & 1, sweep = it / kv_tiles, t = it % kv_tiles;
    if (it + 1 < iters) {
      load_kv(it + 1, stage ^ 1);
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
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + (e / 2) * 8;
        const int col = t * BKV + ni * 8 + (lane % 4) * 2 + (e % 2);
        const bool ok = col < n && (!causal || causal_ok(row, col, a.cond_len));
        if (!ok) s[ni][e] = -INFINITY;
      }
    }

    if (sweep == 0) {  // online row max and sum
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tile_max[e / 2] = fmaxf(tile_max[e / 2], s[ni][e]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tile_max[hh] = fmaxf(tile_max[hh],
                             __shfl_xor_sync(0xffffffffu, tile_max[hh], 1));
        tile_max[hh] = fmaxf(tile_max[hh],
                             __shfl_xor_sync(0xffffffffu, tile_max[hh], 2));
        const float m_new = fmaxf(row_max[hh], tile_max[hh]);
        row_sum[hh] *= expf(row_max[hh] - m_new);
        row_max[hh] = m_new;
      }
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          row_sum[e / 2] += expf(s[ni][e] - row_max[e / 2]);
      if (t == kv_tiles - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float l = row_sum[hh];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          inv[hh] = 1.f / l;
        }
      }
    } else {
      // P (fp32) and dP = dO V^T
      float dp[BKV / 8][4];
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = expf(s[i][e] - row_max[e / 2]) * inv[e / 2];
          dp[i][e] = 0.f;
        }
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
        for (int nj = 0; nj < BKV / 16; ++nj) {
          uint32_t r[4];
          ldmatrix_x4(r, &vs[stage][nj * 16 + lane % 8 + (lane / 16) * 8]
                            [kd * 16 + ((lane / 8) % 2) * 8]);
          mma_bf16_16816(dp[2 * nj], dof[kd], r[0], r[1]);
          mma_bf16_16816(dp[2 * nj + 1], dof[kd], r[2], r[3]);
        }
      }
      if (sweep == 1) {
#pragma unroll
        for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) delta[e / 2] += s[ni][e] * dp[ni][e];
        if (t == kv_tiles - 1) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            delta[hh] += __shfl_xor_sync(0xffffffffu, delta[hh], 1);
            delta[hh] += __shfl_xor_sync(0xffffffffu, delta[hh], 2);
          }
        }
      } else {
        // dS = P (dP - delta), bf16 straight into A fragments; dq += dS K
#pragma unroll
        for (int kj = 0; kj < BKV / 16; ++kj) {
          uint32_t da[4];
          const float(&s0)[4] = s[2 * kj];
          const float(&s1)[4] = s[2 * kj + 1];
          const float(&p0)[4] = dp[2 * kj];
          const float(&p1)[4] = dp[2 * kj + 1];
          da[0] = pack_bf16x2(s0[0] * (p0[0] - delta[0]),
                              s0[1] * (p0[1] - delta[0]));
          da[1] = pack_bf16x2(s0[2] * (p0[2] - delta[1]),
                              s0[3] * (p0[3] - delta[1]));
          da[2] = pack_bf16x2(s1[0] * (p1[0] - delta[0]),
                              s1[1] * (p1[1] - delta[0]));
          da[3] = pack_bf16x2(s1[2] * (p1[2] - delta[1]),
                              s1[3] * (p1[3] - delta[1]));
#pragma unroll
          for (int dd = 0; dd < D / 16; ++dd) {
            uint32_t r[4];
            ldmatrix_x4_trans(
                r, &ks[stage][kj * 16 + lane % 8 + ((lane / 8) % 2) * 8]
                             [dd * 16 + (lane / 16) * 8]);
            mma_bf16_16816(dq[2 * dd], da, r[0], r[1]);
            mma_bf16_16816(dq[2 * dd + 1], da, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
  }

  __nv_bfloat16* dqb = a.dq + bn * a.ld_dq + h * D;
  const size_t stat_row =
      (static_cast<size_t>(b) * a.heads + h) * static_cast<size_t>(a.n_pad);
  const size_t stat_plane = static_cast<size_t>(gridDim.z) * a.heads * a.n_pad;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_a + hh * 8;
    // statistics for every row of the block, padding rows included: the
    // second kernel reads whole tiles
    if (lane % 4 == 0) {
      a.stats[stat_row + row] = row_max[hh];
      a.stats[stat_plane + stat_row + row] = inv[hh];
      a.stats[2 * stat_plane + stat_row + row] = delta[hh];
    }
    if (row >= n) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(dqb + static_cast<size_t>(row) * a.ld_dq +
                                   col) = pack_bf16x2(dq[dn][2 * hh],
                                                      dq[dn][2 * hh + 1]);
    }
  }
}

template <int D>
__host__ __device__ constexpr int cols_qt() {
  return D > 64 ? 32 : 64;  // query rows per tile: keeps the fragments of
                            // D = 128 in registers
}

template <int D>
constexpr int cols_smem_bytes() {
  // k and v, two stages of q and dO, two stages of the three row statistics
  return 2 * BKV * (D + 8) * 2 + 4 * cols_qt<D>() * (D + 8) * 2 +
         2 * 3 * cols_qt<D>() * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_cols_kernel(BwdArgs a) {
  constexpr int LD = D + 8, QT = cols_qt<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto ks = reinterpret_cast<__nv_bfloat16(*)[LD]>(smem_raw);
  auto vs = reinterpret_cast<__nv_bfloat16(*)[LD]>(smem_raw + BKV * LD * 2);
  auto qs = reinterpret_cast<__nv_bfloat16(*)[QT][LD]>(smem_raw +
                                                       2 * BKV * LD * 2);
  auto dos = reinterpret_cast<__nv_bfloat16(*)[QT][LD]>(
      smem_raw + (2 * BKV + 2 * QT) * LD * 2);
  auto st = reinterpret_cast<float(*)[3][QT]>(
      smem_raw + (2 * BKV + 4 * QT) * LD * 2);

  const int k0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = a.n;
  const size_t bn = static_cast<size_t>(b) * n;
  const __nv_bfloat16* qb = a.q + bn * a.ld_q + h * D;
  const __nv_bfloat16* kb = a.k + bn * a.ld_k + h * D;
  const __nv_bfloat16* vb = a.v + bn * a.ld_v + h * D;
  const __nv_bfloat16* dob = a.dout + bn * a.ld_do + h * D;
  const size_t stat_row =
      (static_cast<size_t>(b) * a.heads + h) * static_cast<size_t>(a.n_pad);
  const size_t stat_plane = static_cast<size_t>(gridDim.z) * a.heads * a.n_pad;

  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  // query rows before k0 see these keys only inside the prefix
  const int t_first = (causal && k0 >= a.cond_len) ? k0 / QT : 0;
  const int t_end = (n + QT - 1) / QT;

  auto load_q = [&](int t, int stage) {
    load_rows_async<D, QT>(qs[stage], qb, a.ld_q, t * QT, n);
    load_rows_async<D, QT>(dos[stage], dob, a.ld_do, t * QT, n);
    // the workspace holds every row up to n_pad, a multiple of 64
    for (int i = threadIdx.x; i < 3 * QT / 4; i += kThreads) {
      const int which = i / (QT / 4), c = (i % (QT / 4)) * 4;
      cp_async_16(&st[stage][which][c],
                  a.stats + which * stat_plane + stat_row + t * QT + c, 16);
    }
    cp_async_commit();
  };
  load_rows_async<D, BKV>(ks, kb, a.ld_k, k0, n);
  load_rows_async<D, BKV>(vs, vb, a.ld_v, k0, n);
  cp_async_commit();
  if (t_first < t_end) load_q(t_first, 0);
  cp_async_wait<1>();
  __syncthreads();

  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    ldmatrix_x4(kf[kd], &ks[warp * 16 + lane % 16][kd * 16 + (lane / 16) * 8]);
    ldmatrix_x4(vf[kd], &vs[warp * 16 + lane % 16][kd * 16 + (lane / 16) * 8]);
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int key_a = k0 + warp * 16 + lane / 4;  // keys key_a and key_a + 8

  for (int t = t_first; t < t_end; ++t) {
    const int stage = (t - t_first) & 1;
    if (t + 1 < t_end) {
      load_q(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K q^T and dP^T = V dO^T: 16 keys x QT queries per warp
    float s[QT / 8][4], dp[QT / 8][4];
#pragma unroll
    for (int i = 0; i < QT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
      for (int nj = 0; nj < QT / 16; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, &qs[stage][nj * 16 + lane % 8 + (lane / 16) * 8]
                          [kd * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16_16816(s[2 * nj], kf[kd], r[0], r[1]);
        mma_bf16_16816(s[2 * nj + 1], kf[kd], r[2], r[3]);
        ldmatrix_x4(r, &dos[stage][nj * 16 + lane % 8 + (lane / 16) * 8]
                           [kd * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16_16816(dp[2 * nj], vf[kd], r[0], r[1]);
        mma_bf16_16816(dp[2 * nj + 1], vf[kd], r[2], r[3]);
      }
    }
    // P^T and dS^T in place of S^T and dP^T; masked entries are exactly 0
#pragma unroll
    for (int ni = 0; ni < QT / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_a + (e / 2) * 8;
        const int qc = ni * 8 + (lane % 4) * 2 + (e % 2);
        const int query = t * QT + qc;
        const bool ok = query < n && key < n &&
                        (!causal || causal_ok(query, key, a.cond_len));
        const float p =
            ok ? expf(s[ni][e] - st[stage][0][qc]) * st[stage][1][qc] : 0.f;
        dp[ni][e] = ok ? p * (dp[ni][e] - st[stage][2][qc]) : 0.f;
        s[ni][e] = p;
      }
    }
    // dv += P^T dO and dk += dS^T q, both operands bf16
#pragma unroll
    for (int kj = 0; kj < QT / 16; ++kj) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16x2(s[2 * kj][0], s[2 * kj][1]);
      pa[1] = pack_bf16x2(s[2 * kj][2], s[2 * kj][3]);
      pa[2] = pack_bf16x2(s[2 * kj + 1][0], s[2 * kj + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kj + 1][2], s[2 * kj + 1][3]);
      da[0] = pack_bf16x2(dp[2 * kj][0], dp[2 * kj][1]);
      da[1] = pack_bf16x2(dp[2 * kj][2], dp[2 * kj][3]);
      da[2] = pack_bf16x2(dp[2 * kj + 1][0], dp[2 * kj + 1][1]);
      da[3] = pack_bf16x2(dp[2 * kj + 1][2], dp[2 * kj + 1][3]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &dos[stage][kj * 16 + lane % 8 + ((lane / 8) % 2) * 8]
                                   [dd * 16 + (lane / 16) * 8]);
        mma_bf16_16816(dv[2 * dd], pa, r[0], r[1]);
        mma_bf16_16816(dv[2 * dd + 1], pa, r[2], r[3]);
        ldmatrix_x4_trans(r, &qs[stage][kj * 16 + lane % 8 + ((lane / 8) % 2) * 8]
                                  [dd * 16 + (lane / 16) * 8]);
        mma_bf16_16816(dk[2 * dd], da, r[0], r[1]);
        mma_bf16_16816(dk[2 * dd + 1], da, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
  }

  __nv_bfloat16* dkb = a.dk + bn * a.ld_dk + h * D;
  __nv_bfloat16* dvb = a.dv + bn * a.ld_dv + h * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key_a + hh * 8;
    if (key >= n) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(dkb + static_cast<size_t>(key) * a.ld_dk +
                                   col) = pack_bf16x2(dk[dn][2 * hh],
                                                      dk[dn][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dvb + static_cast<size_t>(key) * a.ld_dv +
                                   col) = pack_bf16x2(dv[dn][2 * hh],
                                                      dv[dn][2 * hh + 1]);
    }
  }
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int launch(const BwdArgs& a, int b, cudaStream_t stream) {
  constexpr int rows_bytes = rows_smem_bytes<D>();
  constexpr int cols_bytes = cols_smem_bytes<D>();
  int err = allow_smem(attn_bwd_rows_kernel<D>, rows_bytes);
  if (err) return err;
  err = allow_smem(attn_bwd_cols_kernel<D>, cols_bytes);
  if (err) return err;
  dim3 grid_rows((a.n + BQ - 1) / BQ, a.heads, b);
  attn_bwd_rows_kernel<D><<<grid_rows, kThreads, rows_bytes, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 grid_cols((a.n + BKV - 1) / BKV, a.heads, b);
  attn_bwd_cols_kernel<D><<<grid_cols, kThreads, cols_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stats: 3 * b * heads * n_pad fp32 scratch, n_pad = n rounded up to 64.
// Row strides are in elements; every row start must be 16-byte aligned.
ETK_API int etk_attention_bwd(const void* q, const void* k, const void* v,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* stats, int ld_q, int ld_k, int ld_v,
                              int ld_do, int ld_dq, int ld_dk, int ld_dv,
                              int b, int n, int heads, int head_dim,
                              int mask_mode, int cond_len, void* stream) {
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  BwdArgs a{static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<const __nv_bfloat16*>(dout),
            static_cast<__nv_bfloat16*>(dq),
            static_cast<__nv_bfloat16*>(dk),
            static_cast<__nv_bfloat16*>(dv),
            static_cast<float*>(stats),
            ld_q, ld_k, ld_v, ld_do, ld_dq, ld_dk, ld_dv,
            n, (n + BQ - 1) / BQ * BQ, heads, mask_mode, cond_len};
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(a, b, s);
    case 64:
      return launch<64>(a, b, s);
    case 128:
      return launch<128>(a, b, s);
    default:
      return ETK_BAD_ARGS;
  }
}

// fp32 attention, forward and backward, on the SIMT cores: the fp32 blocks
// that the TPU kernels take and the Hopper kernels of attention_bnhd.cu and
// attention_bwd.cu (bf16 wgmma) do not.
//
// Replaces, for fp32 q, k and v, the TPU kernels of
// enhancing_tpu/ops/attention.py that those two files replace in bf16:
// - _attn_kernel_packed as entered through _attention_packed_qkv_call (B2,
//   the ViT blocks' self-attention on the fused qkv buffer) and through
//   _attention_packed_call (B8, the GPT prior's prefill, D up to 128 and
//   the prior's 384); _attn_kernel (B17) and _attn_kernel_bnhd (B18), the
//   scale on the scores; _attn_kernel_packed_gridchunk (B19, unit scale):
//   one forward, attn_f32_fwd_kernel, entry etk_attention_f32;
// - _attn_bwd_kernel as entered through _attention_packed_bwd_call (B5):
//   attn_f32_bwd_rows_kernel and attn_f32_bwd_cols_kernel, entry
//   etk_attention_bwd_f32, at D up to 128.
// Numerics: every product, the softmax and every sum in fp32 with fp32
// FMAs, no TF32 (its 10-bit mantissa misses the fp32 limits). q is scaled
// in fp32 (one rounding, as the plain version's q * scale) unless the
// scale goes on the scores (B17, B18: e^(scale (s - m)) by one FMA in the
// exponent). The forward's softmax is online over 64-key tiles with O and
// l rescaled whenever the row max moves; O is multiplied by 1 / l at the
// end. The backward recomputes P from the rows' max and sum, as
// attention_bwd.cu does: a rows kernel takes m, l and delta = rowsum(P *
// dP) in one online sweep and dq = dS K in a second; a cols kernel takes
// dk = dS^T q and dv = P^T dO per 64-key block over every query tile.
// Nothing is summed with atomics: two calls give the same bits. Mask modes
// 'none' and 'prefix_causal' (col <= row, or both < cond_len); rows past N
// and keys past M are masked, so any N and M work.
//
// Bound on the H100: fp32 operations outside the tensor cores, 4 D flops a
// visible (query, key) pair forward and 9 backward (as computed here; 5 as
// the function needs) at 67 TFLOP/s, against (N + 2 M) D * 4 bytes a
// (batch, head). This is the simple design: a block of 128 threads owns
// 64 query rows (32 at D = 384) of one (batch, head), each thread a 4-row
// by 8-column tile of every product (outer products of one 16-byte load
// of A and 8 scalar loads of B from shared memory per step), operands
// stored in shared memory with the contraction index outermost, loaded
// synchronously (no ring) and transposed on the way in. D runs in tiles of
// 32, 64, 96 or 128 lanes (the lanes past D are zeros) and 384. A
// tensor-core design (exact bf16 pieces, as int8_wgmma.cuh splits fp32
// activations, or 3xTF32) is later work.
#include "common.cuh"

namespace {

constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;
constexpr int kThreads = 128;
constexpr int RS = 4;   // rows of a thread's tile
constexpr int BK = 64;  // keys a tile (and queries a tile of the cols kernel)

// element strides of one tensor: between batches, heads and rows
struct Strides {
  int batch, head, row;
};

__device__ __forceinline__ long long offset(const Strides& s, int b, int h,
                                            int row) {
  return static_cast<long long>(b) * s.batch +
         static_cast<long long>(h) * s.head +
         static_cast<long long>(row) * s.row;
}

// rows [row0, row0 + R) of one (batch, head) of x, lanes [0, DP), times
// mul, transposed into xt[lane * LD + r]; zeros past nrows and past the
// head dim d (a multiple of 4, so a 16-byte chunk is all in or all out)
template <int R, int DP, int LD>
__device__ __forceinline__ void load_t(float* xt, const float* x,
                                       const Strides& s, int b, int h,
                                       int row0, int nrows, int d,
                                       float mul) {
  for (int i = threadIdx.x; i < R * (DP / 4); i += kThreads) {
    const int r = i % R, c = 4 * (i / R), row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < nrows && c < d)
      v = *reinterpret_cast<const float4*>(x + offset(s, b, h, row) + c);
    xt[(c + 0) * LD + r] = v.x * mul;
    xt[(c + 1) * LD + r] = v.y * mul;
    xt[(c + 2) * LD + r] = v.z * mul;
    xt[(c + 3) * LD + r] = v.w * mul;
  }
}

// acc[i][j] += sum over k < K of A[k * lda + r0 + i] * B(k, c0 + TX * j):
// A with the contraction outermost (four rows, one 16-byte load a step);
// B as B[k * ldb + col] or, kColMajor, B[col * ldb + k]
template <int K, int CS, int TX, bool kColMajor>
__device__ __forceinline__ void tile_fma(float (&acc)[RS][CS], const float* A,
                                         int lda, int r0, const float* B,
                                         int ldb, int c0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * lda + r0);
    float bv[CS];
#pragma unroll
    for (int j = 0; j < CS; ++j)
      bv[j] = kColMajor ? B[(c0 + TX * j) * ldb + k] : B[k * ldb + c0 + TX * j];
#pragma unroll
    for (int j = 0; j < CS; ++j) {
      acc[0][j] = fmaf(a.x, bv[j], acc[0][j]);
      acc[1][j] = fmaf(a.y, bv[j], acc[1][j]);
      acc[2][j] = fmaf(a.z, bv[j], acc[2][j]);
      acc[3][j] = fmaf(a.w, bv[j], acc[3][j]);
    }
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[i][j] = 0.f;
}

// max and sum over the TX lanes that hold one row (adjacent lanes)
template <int TX>
__device__ __forceinline__ float row_max_lanes(float x) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int TX>
__device__ __forceinline__ float row_sum_lanes(float x) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the key tiles rows r0 .. r0 + rows - 1 (those < n) may see
__device__ __forceinline__ int key_tiles(int r0, int rows, int n, int m,
                                         bool causal, int cond_len) {
  int t = (m + BK - 1) / BK;
  if (causal) {
    const int last_row = min(r0 + rows, n) - 1;
    const int last_col = max(last_row, r0 < cond_len ? cond_len - 1 : 0);
    t = min(t, last_col / BK + 1);
  }
  return t;
}

// ---- forward ---------------------------------------------------------------

// head-dim tile DP; TY x TX threads, each 4 rows by BK / TX keys of S and
// 4 rows by DP / TX lanes of O
template <int DP, int TY, int TX>
struct FwdGeo {
  static constexpr int BQ = TY * RS, LQ = BQ + 4, LK = BK + 4;
  static constexpr int CS = BK / TX, CO = DP / TX;
  // q^T, the tile's K^T and then V^T in one buffer, P^T
  static constexpr int SMEM = (DP * LQ + DP * LK + BK * LQ) * 4;
  static_assert(TY * TX == kThreads && DP % TX == 0, "thread tile");
};

struct FwdArgs {
  int n, m, d, mask_mode, cond_len;
  float scale;
};

template <int DP, int TY, int TX, bool kScoreScale>
__global__ void __launch_bounds__(kThreads)
    attn_f32_fwd_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        Strides sq, Strides sk, Strides sv, Strides so,
                        FwdArgs a) {
  using G = FwdGeo<DP, TY, TX>;
  constexpr int BQ = G::BQ, LQ = G::LQ, LK = G::LK, CS = G::CS, CO = G::CO;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DP][LQ]
  float* kvt = qt + DP * LQ;                     // [DP][LK]
  float* pt = kvt + DP * LK;                     // [BK][LQ]

  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  // under the causal mask the last row blocks see the most keys: first
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % TX, r0 = (threadIdx.x / TX) * RS;
  const int tiles = key_tiles(q0, BQ, a.n, a.m, causal, a.cond_len);
  const float c2 = kScoreScale ? a.scale * kLog2e : kLog2e;

  load_t<BQ, DP, LQ>(qt, q, sq, b, h, q0, a.n, a.d,
                     kScoreScale ? 1.f : a.scale);
  float acc[RS][CO];
  zero(acc);
  float row_max[RS], row_sum[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    __syncthreads();  // q stored; the last tile's P V done with kvt and pt
    load_t<BK, DP, LK>(kvt, k, sk, b, h, t * BK, a.m, a.d, 1.f);
    __syncthreads();
    float s[RS][CS];
    zero(s);
    tile_fma<DP, CS, TX, false>(s, qt, LQ, r0, kvt, LK, tx);
    if ((t + 1) * BK > a.m || (causal && (t + 1) * BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j)
          if (!visible(q0 + r0 + i, t * BK + tx + TX * j, a.m, causal,
                       a.cond_len))
            s[i][j] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CS; ++j) tmax = fmaxf(tmax, s[i][j]);
      const float m_new = fmaxf(row_max[i], row_max_lanes<TX>(tmax));
      // a row with nothing visible yet keeps exp(-inf - -inf) out
      const float ml2 = (m_new == -INFINITY ? 0.f : m_new) * c2;
      const float alpha = exp_shifted(row_max[i], ml2, c2);
      row_max[i] = m_new;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const float p = exp_shifted(s[i][j], ml2, c2);
        part += p;
        pt[(tx + TX * j) * LQ + r0 + i] = p;
      }
      row_sum[i] = row_sum[i] * alpha + part;
#pragma unroll
      for (int j = 0; j < CO; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // K read by every thread, P written
    load_t<BK, DP, LK>(kvt, v, sv, b, h, t * BK, a.m, a.d, 1.f);
    __syncthreads();
    // O[r][lane] += sum over keys c of P^T[c][r] V^T[lane][c]
    tile_fma<BK, CO, TX, true>(acc, pt, LQ, r0, kvt, LK, tx);
  }

#pragma unroll
  for (int i = 0; i < RS; ++i) {
    const int row = q0 + r0 + i;
    const float inv = 1.f / row_sum_lanes<TX>(row_sum[i]);
    if (row >= a.n) continue;
    float* out = o + offset(so, b, h, row);
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int lane = tx + TX * j;
      if (lane < a.d) out[lane] = acc[i][j] * inv;
    }
  }
}

template <int DP, int TY, int TX, bool kScoreScale>
int launch_fwd(const float* const* p, const Strides* st, int b, int heads,
               const FwdArgs& a, cudaStream_t stream) {
  using G = FwdGeo<DP, TY, TX>;
  auto kernel = attn_f32_fwd_kernel<DP, TY, TX, kScoreScale>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.n + G::BQ - 1) / G::BQ, heads, b);
  kernel<<<grid, kThreads, G::SMEM, stream>>>(p[0], p[1], p[2],
                                              const_cast<float*>(p[3]), st[0],
                                              st[1], st[2], st[3], a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kScoreScale>
int launch_fwd_d(const float* const* p, const Strides* st, int b, int heads,
                 const FwdArgs& a, cudaStream_t s) {
  const int d = a.d;
  if (d == 384) return launch_fwd<384, 8, 16, kScoreScale>(p, st, b, heads, a, s);
  if (d <= 0 || d % 8 || d > 128) return ETK_BAD_ARGS;
  if (d <= 32) return launch_fwd<32, 16, 8, kScoreScale>(p, st, b, heads, a, s);
  if (d <= 64) return launch_fwd<64, 16, 8, kScoreScale>(p, st, b, heads, a, s);
  if (d <= 96) return launch_fwd<96, 16, 8, kScoreScale>(p, st, b, heads, a, s);
  return launch_fwd<128, 16, 8, kScoreScale>(p, st, b, heads, a, s);
}

// ---- backward ----------------------------------------------------------------

constexpr int BTY = 16, BTX = 8;                 // 128 threads
constexpr int BBQ = BTY * RS, BLQ = BBQ + 4;     // 64 rows a tile
constexpr int BLK = BK + 4, BCS = BK / BTX;      // 8 key columns a thread
static_assert(BBQ == BK, "the cols kernel's query tiles are key tiles");

struct BwdArgs {
  const float *q, *k, *v, *dout;
  float *dq, *dk, *dv, *stats;  // stats: row max, 1 / row sum, delta
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int n, n_pad, heads, d, mask_mode, cond_len;
};

template <int DP>
constexpr int rows_smem() {
  return (2 * DP * BLQ + 2 * DP * BLK + BK * BLQ) * 4;
}
template <int DP>
constexpr int cols_smem() {
  return (2 * DP * BLK + 2 * DP * BLQ + 2 * BBQ * BLK + 3 * BBQ) * 4;
}

// rows: a block owns 64 query rows; sweep 1 takes m, l and sum(e dP)
// online, sweep 2 forms dS and dq += dS K
template <int DP>
__global__ void __launch_bounds__(kThreads)
    attn_f32_bwd_rows_kernel(BwdArgs a) {
  constexpr int CO = DP / BTX;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DP][BLQ]
  float* dot = qt + DP * BLQ;                    // [DP][BLQ]
  float* kt = dot + DP * BLQ;                    // [DP][BLK]
  float* vt = kt + DP * BLK;                     // [DP][BLK]
  float* dst = vt + DP * BLK;                    // [BK][BLQ]

  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  const int q0 = blockIdx.x * BBQ, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % BTX, r0 = (threadIdx.x / BTX) * RS;
  const int n = a.n;
  const int tiles = key_tiles(q0, BBQ, n, n, causal, a.cond_len);
  load_t<BBQ, DP, BLQ>(qt, a.q, a.sq, b, h, q0, n, a.d, 1.f);
  load_t<BBQ, DP, BLQ>(dot, a.dout, a.sdo, b, h, q0, n, a.d, 1.f);

  // S = q K^T and dP = dO V^T of key tile t, masked
  auto scores = [&](int t, float (&s)[RS][BCS], float (&dp)[RS][BCS]) {
    __syncthreads();  // q and dO stored; the last tile's products done
    load_t<BK, DP, BLK>(kt, a.k, a.sk, b, h, t * BK, n, a.d, 1.f);
    load_t<BK, DP, BLK>(vt, a.v, a.sv, b, h, t * BK, n, a.d, 1.f);
    __syncthreads();
    zero(s);
    zero(dp);
    tile_fma<DP, BCS, BTX, false>(s, qt, BLQ, r0, kt, BLK, tx);
    tile_fma<DP, BCS, BTX, false>(dp, dot, BLQ, r0, vt, BLK, tx);
    // rows past n keep the keys they may see: their statistics stay
    // finite, and the cols kernel masks them
    if ((t + 1) * BK > n || causal) {
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int j = 0; j < BCS; ++j)
          if (!visible(q0 + r0 + i, t * BK + tx + BTX * j, n, causal,
                       a.cond_len))
            s[i][j] = -INFINITY;
    }
  };

  float row_max[RS], row_sum[RS], row_edp[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = row_edp[i] = 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    float s[RS][BCS], dp[RS][BCS];
    scores(t, s, dp);
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < BCS; ++j) tmax = fmaxf(tmax, s[i][j]);
      const float m_new = fmaxf(row_max[i], row_max_lanes<BTX>(tmax));
      const float ml2 = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
      const float alpha = exp_shifted(row_max[i], ml2);
      row_max[i] = m_new;
      float l = row_sum[i] * alpha, g = row_edp[i] * alpha;
#pragma unroll
      for (int j = 0; j < BCS; ++j) {
        const float e = exp_shifted(s[i][j], ml2);
        l += e;
        g = fmaf(e, dp[i][j], g);
      }
      row_sum[i] = l;
      row_edp[i] = g;
    }
  }
  float inv[RS], delta[RS], ml2[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    ml2[i] = row_max[i] * kLog2e;
    inv[i] = 1.f / row_sum_lanes<BTX>(row_sum[i]);
    delta[i] = row_sum_lanes<BTX>(row_edp[i]) * inv[i];
  }

  float dq[RS][CO];
  zero(dq);
  for (int t = 0; t < tiles; ++t) {
    float s[RS][BCS], dp[RS][BCS];
    scores(t, s, dp);
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int j = 0; j < BCS; ++j) {
        const float p = exp_shifted(s[i][j], ml2[i]) * inv[i];
        dst[(tx + BTX * j) * BLQ + r0 + i] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    // dq[r][lane] += sum over keys c of dS^T[c][r] K^T[lane][c]
    tile_fma<BK, CO, BTX, true>(dq, dst, BLQ, r0, kt, BLK, tx);
  }

  // the statistics of every row of the block, padding rows included (the
  // cols kernel reads whole tiles), and dq
  const size_t stat_row =
      (static_cast<size_t>(b) * a.heads + h) * static_cast<size_t>(a.n_pad);
  const size_t plane = static_cast<size_t>(gridDim.z) * a.heads * a.n_pad;
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    const int row = q0 + r0 + i;
    if (tx == 0) {
      a.stats[stat_row + row] = row_max[i];
      a.stats[plane + stat_row + row] = inv[i];
      a.stats[2 * plane + stat_row + row] = delta[i];
    }
    if (row >= n) continue;
    float* out = a.dq + offset(a.sdq, b, h, row);
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int lane = tx + BTX * j;
      if (lane < a.d) out[lane] = dq[i][j];
    }
  }
}

// cols: a block owns 64 keys; K and V come once, the query tiles stream by
template <int DP>
__global__ void __launch_bounds__(kThreads)
    attn_f32_bwd_cols_kernel(BwdArgs a) {
  constexpr int CO = DP / BTX;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [DP][BLK]
  float* vt = kt + DP * BLK;                     // [DP][BLK]
  float* qt = vt + DP * BLK;                     // [DP][BLQ]
  float* dot = qt + DP * BLQ;                    // [DP][BLQ]
  float* pm = dot + DP * BLQ;                    // [BBQ][BLK]: P[i][key]
  float* dsm = pm + BBQ * BLK;                   // [BBQ][BLK]: dS[i][key]
  float* st = dsm + BBQ * BLK;                   // [3][BBQ]

  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % BTX, r0 = (threadIdx.x / BTX) * RS;
  const int n = a.n;
  // query rows before k0 see these keys only inside the prefix
  const int t_first = (causal && k0 >= a.cond_len) ? k0 / BBQ : 0;
  const int t_end = (n + BBQ - 1) / BBQ;
  const size_t stat_row =
      (static_cast<size_t>(b) * a.heads + h) * static_cast<size_t>(a.n_pad);
  const size_t plane = static_cast<size_t>(gridDim.z) * a.heads * a.n_pad;
  load_t<BK, DP, BLK>(kt, a.k, a.sk, b, h, k0, n, a.d, 1.f);
  load_t<BK, DP, BLK>(vt, a.v, a.sv, b, h, k0, n, a.d, 1.f);

  float dk[RS][CO], dv[RS][CO];
  zero(dk);
  zero(dv);
  for (int t = t_first; t < t_end; ++t) {
    const int i0 = t * BBQ;
    __syncthreads();  // K, V stored; the last tile's products done
    load_t<BBQ, DP, BLQ>(qt, a.q, a.sq, b, h, i0, n, a.d, 1.f);
    load_t<BBQ, DP, BLQ>(dot, a.dout, a.sdo, b, h, i0, n, a.d, 1.f);
    for (int i = threadIdx.x; i < 3 * BBQ; i += kThreads)
      st[i] = a.stats[(i / BBQ) * plane + stat_row + i0 + i % BBQ];
    __syncthreads();
    // S^T = K q^T and dP^T = V dO^T: 4 keys by 8 queries a thread
    float s[RS][BCS], dp[RS][BCS];
    zero(s);
    zero(dp);
    tile_fma<DP, BCS, BTX, false>(s, kt, BLK, r0, qt, BLQ, tx);
    tile_fma<DP, BCS, BTX, false>(dp, vt, BLK, r0, dot, BLQ, tx);
    const bool edge = causal || i0 + BBQ > n || k0 + BK > n;
#pragma unroll
    for (int j = 0; j < BCS; ++j) {
      const int ic = tx + BTX * j, query = i0 + ic;
      const float ml2 = st[ic] * kLog2e, inv = st[BBQ + ic];
      const float delta = st[2 * BBQ + ic];
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        float p = exp_shifted(s[i][j], ml2) * inv;
        float ds = p * (dp[i][j] - delta);
        if (edge && (query >= n || !visible(query, k0 + r0 + i, n, causal,
                                            a.cond_len)))
          p = ds = 0.f;
        pm[ic * BLK + r0 + i] = p;
        dsm[ic * BLK + r0 + i] = ds;
      }
    }
    __syncthreads();
    // dv[key][lane] += sum over queries of P[i][key] dO^T[lane][i], and
    // dk likewise with dS and q
    tile_fma<BBQ, CO, BTX, true>(dv, pm, BLK, r0, dot, BLQ, tx);
    tile_fma<BBQ, CO, BTX, true>(dk, dsm, BLK, r0, qt, BLQ, tx);
  }

#pragma unroll
  for (int i = 0; i < RS; ++i) {
    const int key = k0 + r0 + i;
    if (key >= n) continue;
    float* dkr = a.dk + offset(a.sdk, b, h, key);
    float* dvr = a.dv + offset(a.sdv, b, h, key);
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int lane = tx + BTX * j;
      if (lane < a.d) {
        dkr[lane] = dk[i][j];
        dvr[lane] = dv[i][j];
      }
    }
  }
}

template <int DP>
int launch_bwd(const BwdArgs& a, int b, cudaStream_t stream) {
  constexpr int rs = rows_smem<DP>(), cs = cols_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_f32_bwd_rows_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, rs);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_f32_bwd_cols_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.n + BK - 1) / BK, a.heads, b);
  attn_f32_bwd_rows_kernel<DP><<<grid, kThreads, rs, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_f32_bwd_cols_kernel<DP><<<grid, kThreads, cs, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: fp32 (B, N, H, D); k, v: fp32 (B, M, H, D); each addressed as
// base + b * batch + h * head + row * row_stride + lane, its three strides
// in elements (multiples of 8; 0 only on an axis of size 1) at
// strides[3 * i .. 3 * i + 2] for q, k, v, out; every base 16-byte
// aligned. score_scale: 1 puts the scale on the fp32 scores, 0 scales q.
// Head dims: multiples of 8 up to 128, and 384.
ETK_API int etk_attention_f32(const void* q, const void* k, const void* v,
                              void* out, const int* strides, int b, int n,
                              int m, int heads, int head_dim, float scale,
                              int score_scale, int mask_mode, int cond_len,
                              void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || heads <= 0 || b > 65535 ||
      heads > 65535 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    const int rows = i == 1 || i == 2 ? m : n;
    if (st[i].batch < 0 || st[i].head < 0 || st[i].row < 0 ||
        st[i].batch % 8 || st[i].head % 8 || st[i].row % 8 ||
        (st[i].batch == 0 && b > 1) || (st[i].head == 0 && heads > 1) ||
        (st[i].row == 0 && rows > 1))
      return ETK_BAD_ARGS;
  }
  const float* p[4] = {static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(out)};
  const FwdArgs a{n, m, head_dim, mask_mode, cond_len, scale};
  auto s = static_cast<cudaStream_t>(stream);
  return score_scale ? launch_fwd_d<true>(p, st, b, heads, a, s)
                     : launch_fwd_d<false>(p, st, b, heads, a, s);
}

// The backward of etk_attention_f32 with q already scaled, on fp32 (B, N,
// H*D) q, k, v and dO with rows ld_* elements apart (multiples of 8,
// 16-byte aligned rows; batches n rows apart), into dq, dk and dv likewise.
// stats: 3 * b * heads * n_pad fp32 scratch, n_pad = n rounded up to 128.
// Head dims: multiples of 8 up to 128.
ETK_API int etk_attention_bwd_f32(const void* q, const void* k, const void* v,
                                  const void* dout, void* dq, void* dk,
                                  void* dv, void* stats, int ld_q, int ld_k,
                                  int ld_v, int ld_do, int ld_dq, int ld_dk,
                                  int ld_dv, int b, int n, int heads,
                                  int head_dim, int mask_mode, int cond_len,
                                  void* stream) {
  const int hd = heads * head_dim;
  const int lds[7] = {ld_q, ld_k, ld_v, ld_do, ld_dq, ld_dk, ld_dv};
  for (int ld : lds)
    if (ld < hd || ld % 8) return ETK_BAD_ARGS;
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535 ||
      head_dim <= 0 || head_dim % 8 || head_dim > 128 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  auto strides = [&](int ld) {
    return Strides{n * ld, head_dim, ld};
  };
  BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(dout),
            static_cast<float*>(dq), static_cast<float*>(dk),
            static_cast<float*>(dv), static_cast<float*>(stats),
            strides(ld_q), strides(ld_k), strides(ld_v), strides(ld_do),
            strides(ld_dq), strides(ld_dk), strides(ld_dv),
            n, (n + 127) / 128 * 128, heads, head_dim, mask_mode, cond_len};
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 32) return launch_bwd<32>(a, b, s);
  if (head_dim <= 64) return launch_bwd<64>(a, b, s);
  if (head_dim <= 96) return launch_bwd<96>(a, b, s);
  return launch_bwd<128>(a, b, s);
}

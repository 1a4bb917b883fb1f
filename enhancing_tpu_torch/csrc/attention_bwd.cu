// Backward of the packed-qkv self-attention: dq, dk and dv from q (already
// scaled), k, v and dO, each (B, N, H*D) bf16 with rows read in place at
// lane offset h*D (a row stride per tensor, so k and v can be lane slices
// of the fused qkv buffer). Outputs are (B, N, H*D) bf16, contiguous.
//
// Replaces enhancing_tpu/ops/attention.py::_attn_bwd_kernel as entered
// through _attention_packed_bwd_call. Numerics as there: scores, softmax,
// dP = dO V^T and every accumulator in fp32; P = e / sum(e) with the exact
// row max; delta = rowsum(P * dP) in fp32; dS = P * (dP - delta) and P are
// rounded to bf16 before the dq / dk and dv products; dk and dv accumulate
// in fp32 over every query and are rounded once. Mask modes 'none' and
// 'prefix_causal' (col <= row, or both < cond_len); rows and columns past
// N are masked, so any N works. Head dims: multiples of 8 up to 128, each
// on the next tile of 32, 64 or 128 lanes (a head dim between them, as
// ViT-VQGAN-Large's 80, loads zeros past its lanes through 4-D maps whose
// lane extent is the head dim; they add nothing to S, dP, dq, dk or dv,
// and the stores drop them).
//
// Bound on the H100: tensor-core operations, 5 products of 2*N^2*D flops
// per (batch, head) against ~7 * B * N * H * D * 2 bytes. The TPU kernel
// holds a q block and the whole key row in VMEM and takes the softmax of
// the full row at once; a Hopper block cannot hold the row, and blocks run
// in no order, so the backward is two kernels, both on the Hopper core of
// sm90.cuh (a producer warp issuing TMA into an mbarrier ring, two
// consumer warpgroups of 64 rows issuing wgmma, setmaxnreg between them):
//   1. rows: a block owns 128 query rows of one (batch, head); q and dO
//      come once, the 64-key K and V tiles stream through the ring twice.
//      Sweep 1 computes S = q K^T and dP = dO V^T once per tile and carries
//      the online row max m, sum l and sum of e * dP (rescaled whenever m
//      moves), so that m, 1 / l and delta come from one sweep. Sweep 2
//      recomputes S and dP, forms P and dS in fp32 registers, rounds dS to
//      bf16 A fragments and accumulates dq += dS K (K read MN-major). It
//      leaves m, 1 / l and delta in a (3, B, H, N_pad) fp32 workspace.
//   2. cols: a block owns 128 keys; K and V come once, the q and dO tiles
//      (64 queries, 32 at D = 128) and their row statistics stream through
//      the ring. S^T = K q^T and dP^T = V dO^T are shared-memory wgmma;
//      P^T and dS^T stay in registers as bf16 A fragments for dv += P^T dO
//      and dk += dS^T q (dO and q read MN-major). Each thread loads its 16
//      columns' statistics once a tile, 8 bytes at a time (three loads an
//      element cost 0.18 ms of 0.42 on the H100), and masks only causal or
//      ragged tiles.
// The exponentials are fp32, one FMA and ex2 each (common.cuh). 9 products
// of 2*N^2*D where the function needs 5; each tile's products are waited
// on before its softmax (overlapping them made ptxas serialise the wgmmas:
// PERF.md §6). Neither the scores
// nor P reach device memory; dq, dk and dv are rounded once in shared
// memory and stored by TMA. Nothing is summed with atomics, so the result
// does not depend on scheduling. Under prefix_causal, key tiles that no
// row of a block sees are skipped (rows), and query tiles that see none of
// a block's keys (cols).
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 128, BKV = 64, BK = 128;  // rows, key tile, cols keys
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kRowStages = 4, kColStages = 6;
constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;

// a tile's geometry at head dim D: boxes of BOXC columns (rows of RB
// bytes, 64- or 128-byte swizzle), NBOX of them
template <int D>
struct Geo {
  static constexpr int BOXC = D == 32 ? 32 : 64;
  static constexpr int RB = BOXC * 2;
  static constexpr int NBOX = D / BOXC;
  static constexpr int KS = BOXC / 16;  // k16 slices a box
  // (rows, D) bf16 bytes
  __host__ __device__ static constexpr int tile(int rows) {
    return rows * D * 2;
  }
  // query rows a cols-kernel tile: keeps D = 128's accumulators in registers
  static constexpr int QT = D == 128 ? 32 : 64;
};

struct BwdArgs {
  float* stats;  // row max, 1 / row sum, delta: each (B, H, n_pad)
  int n, n_pad, heads, mask_mode, cond_len, stages;
};

template <int D>
__host__ __device__ constexpr int rows_stage_bytes() {
  return 2 * Geo<D>::tile(BKV);  // K and V tiles
}
template <int D>
__host__ __device__ constexpr int cols_stage_bytes() {
  return 2 * Geo<D>::tile(Geo<D>::QT) + 1024;  // q, dO, 3 x QT statistics
}
template <int D>
int rows_smem(int stages) {
  return 2 * Geo<D>::tile(BQ) + stages * rows_stage_bytes<D>() + 1024;
}
template <int D>
int cols_smem(int stages) {
  return 2 * Geo<D>::tile(BK) + stages * cols_stage_bytes<D>() + 1024;
}
int stages_for(int fixed, int stage, int most) {
  const int s = (sm90::kSmemLimit - fixed) / stage;
  return s > most ? most : s;
}

// a consumer's fp32 accumulators (n8 block j: rows r, r + 8, columns
// 8j + 2q, + 1), rounded to bf16 into a swizzled box at rows row0..
template <int RB, int R>
__device__ __forceinline__ void stage_acc(uint8_t* box, const float (&acc)[R],
                                          int row0) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int r = row0 + warp * 16 + lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(box + sm90::swz<RB>(r + 8 * hh, j) +
                                   4 * q) =
          pack_bf16x2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
}

// ---- 1. rows: statistics and dq ----------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_rows_kernel(const __grid_constant__ CUtensorMap tmap_q,
                         const __grid_constant__ CUtensorMap tmap_do,
                         const __grid_constant__ CUtensorMap tmap_k,
                         const __grid_constant__ CUtensorMap tmap_v,
                         const __grid_constant__ CUtensorMap tmap_dq,
                         BwdArgs a) {
  using G = Geo<D>;
  constexpr int RB = G::RB, SB = rows_stage_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qbar, full[kRowStages], empty[kRowStages];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* qs = smem;                     // NBOX boxes of (128, BOXC)
  uint8_t* dos = smem + G::tile(BQ);      // likewise
  uint8_t* ring_mem = smem + 2 * G::tile(BQ);
  const sm90::Ring ring{a.stages};

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int n = a.n;
  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  int kv_tiles = (n + BKV - 1) / BKV;
  if (causal) {
    const int last_row = min(q0 + BQ, n) - 1;
    const int last_col = max(last_row, q0 < a.cond_len ? a.cond_len - 1 : 0);
    kv_tiles = min(kv_tiles, last_col / BKV + 1);
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(&qbar, 1);
    for (int s = 0; s < a.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: q and dO once, then the key tiles twice
    sm90::regs_dealloc<40>();
    if (threadIdx.x != kConsumers) return;
    sm90::mbar_expect_tx(&qbar, 2 * G::tile(BQ));
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      const int c0 = bx * G::BOXC;
      sm90::tma_load_4d(qs + bx * BQ * RB, &tmap_q, &qbar, c0, h, q0, b);
      sm90::tma_load_4d(dos + bx * BQ * RB, &tmap_do, &qbar, c0, h, q0, b);
    }
    for (int it = 0; it < 2 * kv_tiles; ++it) {
      const int s = ring.stage(it), t = it % kv_tiles;
      sm90::mbar_wait(&empty[s], ring.parity(it) ^ 1u);
      uint8_t* st = ring_mem + s * SB;
      sm90::mbar_expect_tx(&full[s], SB);
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) {
        const int c0 = bx * G::BOXC;
        sm90::tma_load_4d(st + bx * BKV * RB, &tmap_k, &full[s], c0, h,
                          t * BKV, b);
        sm90::tma_load_4d(st + G::tile(BKV) + bx * BKV * RB, &tmap_v,
                          &full[s], c0, h, t * BKV, b);
      }
    }
    return;
  }

  sm90::regs_alloc<232>();
  const int w = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int row_a = q0 + w * 64 + warp * 16 + lane / 4;  // and row_a + 8
  const bool leader = threadIdx.x % 128 == 0;
  sm90::mbar_wait(&qbar, 0);

  // S = q K^T and dP = dO V^T of the tile in stage st, into s and dp
  auto scores = [&](const uint8_t* st, float (&s)[32], float (&dp)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    sm90::hold(s);
    sm90::hold(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      const uint64_t qd = sm90::smem_desc<RB>(qs + bx * BQ * RB + w * 64 * RB);
      const uint64_t dd =
          sm90::smem_desc<RB>(dos + bx * BQ * RB + w * 64 * RB);
      const uint64_t kd = sm90::smem_desc<RB>(st + bx * BKV * RB);
      const uint64_t vd =
          sm90::smem_desc<RB>(st + G::tile(BKV) + bx * BKV * RB);
#pragma unroll
      for (int ks = 0; ks < G::KS; ++ks) {
        sm90::Wgmma<64>::ss(s, sm90::desc_k(qd, ks), sm90::desc_k(kd, ks));
        sm90::Wgmma<64>::ss(dp, sm90::desc_k(dd, ks), sm90::desc_k(vd, ks));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::hold(s);
    sm90::hold(dp);
  };
  // rows past n keep the keys they may see: their statistics stay finite,
  // and the cols kernel masks them
  auto mask = [&](float (&s)[32], int t) {
    if (!causal && (t + 1) * BKV <= n) return;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = row_a + ((i / 2) % 2) * 8;
      const int col = t * BKV + (i / 4) * 8 + 2 * q + i % 2;
      if (!visible(row, col, n, causal, a.cond_len)) s[i] = -INFINITY;
    }
  };

  // sweep 1: online m, l and sum(e * dP)
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f}, row_edp[2] = {0.f, 0.f};  // partial
  int it = 0;
  for (int t = 0; t < kv_tiles; ++t, ++it) {
    const int s_i = ring.stage(it);
    sm90::mbar_wait(&full[s_i], ring.parity(it));
    float s[32], dp[32];
    scores(ring_mem + s_i * SB, s, dp);
    if (leader) sm90::mbar_arrive(&empty[s_i]);
    mask(s, t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(row_max[hh], tmax);
      const float ml2 = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
      const float alpha = exp_shifted(row_max[hh], ml2);
      row_max[hh] = m_new;
      float l = row_sum[hh] * alpha, g = row_edp[hh] * alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = exp_shifted(s[4 * j + 2 * hh + e], ml2);
          l += ex;
          g += ex * dp[4 * j + 2 * hh + e];
        }
      row_sum[hh] = l;
      row_edp[hh] = g;
    }
  }
  float inv[2], delta[2], ml2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ml2[hh] = row_max[hh] * kLog2e;
    float l = row_sum[hh], g = row_edp[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    g += __shfl_xor_sync(0xffffffffu, g, 1);
    g += __shfl_xor_sync(0xffffffffu, g, 2);
    inv[hh] = 1.f / l;
    delta[hh] = g * inv[hh];
  }

  // sweep 2: dS and dq += dS K
  float dq[G::NBOX][G::BOXC / 2];
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
    for (int i = 0; i < G::BOXC / 2; ++i) dq[bx][i] = 0.f;
  for (int t = 0; t < kv_tiles; ++t, ++it) {
    const int s_i = ring.stage(it);
    sm90::mbar_wait(&full[s_i], ring.parity(it));
    const uint8_t* st = ring_mem + s_i * SB;
    float s[32], dp[32];
    scores(st, s, dp);
    mask(s, t);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i / 2) % 2;
      const float p = exp_shifted(s[i], ml2[hh]) * inv[hh];
      s[i] = p * (dp[i] - delta[hh]);
    }
    uint32_t df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::frag_from_acc(df[kk], s, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::hold(df[kk]);
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) sm90::hold(dq[bx]);
    sm90::wgmma_fence();
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      const uint64_t kd = sm90::smem_desc<RB>(st + bx * BKV * RB);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<G::BOXC>::template rs<1>(dq[bx], df[kk],
                                             sm90::desc_mn<RB>(kd, kk));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) sm90::hold(dq[bx]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::hold(df[kk]);  // read until done
    if (leader) sm90::mbar_arrive(&empty[s_i]);
  }

  // the statistics of every row of the block, padding rows included (the
  // cols kernel reads whole tiles); dq through this warpgroup's rows of
  // the q tile and a TMA store
  const size_t stat_row =
      (static_cast<size_t>(b) * a.heads + h) * static_cast<size_t>(a.n_pad);
  const size_t plane = static_cast<size_t>(gridDim.z) * a.heads * a.n_pad;
  if (q == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t i = stat_row + row_a + 8 * hh;
      a.stats[i] = row_max[hh];
      a.stats[plane + i] = inv[hh];
      a.stats[2 * plane + i] = delta[hh];
    }
  }
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx)
    stage_acc<RB>(qs + bx * BQ * RB, dq[bx], w * 64);
  sm90::fence_async_cta();
  sm90::named_sync(2 + w, 128);
  if (leader && q0 + w * 64 < n) {
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx)
      sm90::tma_store_4d(&tmap_dq, qs + bx * BQ * RB + w * 64 * RB,
                         bx * G::BOXC, h, q0 + w * 64, b);
    sm90::bulk_commit();
    sm90::bulk_wait();
  }
}

// ---- 2. cols: dk and dv --------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_cols_kernel(const __grid_constant__ CUtensorMap tmap_k,
                         const __grid_constant__ CUtensorMap tmap_v,
                         const __grid_constant__ CUtensorMap tmap_q,
                         const __grid_constant__ CUtensorMap tmap_do,
                         const __grid_constant__ CUtensorMap tmap_dk,
                         const __grid_constant__ CUtensorMap tmap_dv,
                         BwdArgs a) {
  using G = Geo<D>;
  constexpr int RB = G::RB, QT = G::QT, SB = cols_stage_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kvbar, full[kColStages], empty[kColStages];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* ks = smem;                 // NBOX boxes of (128, BOXC)
  uint8_t* vs = smem + G::tile(BK);   // likewise
  uint8_t* ring_mem = smem + 2 * G::tile(BK);
  const sm90::Ring ring{a.stages};

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int n = a.n;
  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  // query rows before k0 see these keys only inside the prefix
  const int t_first = (causal && k0 >= a.cond_len) ? k0 / QT : 0;
  const int t_end = (n + QT - 1) / QT;
  const size_t stat_row =
      (static_cast<size_t>(b) * a.heads + h) * static_cast<size_t>(a.n_pad);
  const size_t plane = static_cast<size_t>(gridDim.z) * a.heads * a.n_pad;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&kvbar, 1);
    for (int s = 0; s < a.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: K and V once, then q, dO and statistics tile by tile
    sm90::regs_dealloc<40>();
    if (threadIdx.x != kConsumers) return;
    sm90::mbar_expect_tx(&kvbar, 2 * G::tile(BK));
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      const int c0 = bx * G::BOXC;
      sm90::tma_load_4d(ks + bx * BK * RB, &tmap_k, &kvbar, c0, h, k0, b);
      sm90::tma_load_4d(vs + bx * BK * RB, &tmap_v, &kvbar, c0, h, k0, b);
    }
    for (int t = t_first, it = 0; t < t_end; ++t, ++it) {
      const int s = ring.stage(it);
      sm90::mbar_wait(&empty[s], ring.parity(it) ^ 1u);
      uint8_t* st = ring_mem + s * SB;
      sm90::mbar_expect_tx(&full[s], 2 * G::tile(QT) + 3 * QT * 4);
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) {
        const int c0 = bx * G::BOXC;
        sm90::tma_load_4d(st + bx * QT * RB, &tmap_q, &full[s], c0, h,
                          t * QT, b);
        sm90::tma_load_4d(st + G::tile(QT) + bx * QT * RB, &tmap_do,
                          &full[s], c0, h, t * QT, b);
      }
      for (int p = 0; p < 3; ++p)
        sm90::bulk_load(st + 2 * G::tile(QT) + p * QT * 4,
                        a.stats + p * plane + stat_row + t * QT, QT * 4,
                        &full[s]);
    }
    return;
  }

  sm90::regs_alloc<232>();
  const int w = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int key_a = k0 + w * 64 + warp * 16 + lane / 4;  // and key_a + 8
  const bool leader = threadIdx.x % 128 == 0;
  float dk[G::NBOX][G::BOXC / 2], dv[G::NBOX][G::BOXC / 2];
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
    for (int i = 0; i < G::BOXC / 2; ++i) dk[bx][i] = dv[bx][i] = 0.f;
  sm90::mbar_wait(&kvbar, 0);

  for (int t = t_first, it = 0; t < t_end; ++t, ++it) {
    const int s_i = ring.stage(it);
    sm90::mbar_wait(&full[s_i], ring.parity(it));
    const uint8_t* st = ring_mem + s_i * SB;
    const uint8_t* qt = st;
    const uint8_t* dot = st + G::tile(QT);
    const float* stat = reinterpret_cast<const float*>(st + 2 * G::tile(QT));

    // S^T = K q^T and dP^T = V dO^T: this warpgroup's 64 keys x QT queries
    float s[QT / 2], dp[QT / 2];
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) s[i] = dp[i] = 0.f;
    sm90::hold(s);
    sm90::hold(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      const uint64_t kd = sm90::smem_desc<RB>(ks + bx * BK * RB + w * 64 * RB);
      const uint64_t vd = sm90::smem_desc<RB>(vs + bx * BK * RB + w * 64 * RB);
      const uint64_t qd = sm90::smem_desc<RB>(qt + bx * QT * RB);
      const uint64_t dd = sm90::smem_desc<RB>(dot + bx * QT * RB);
#pragma unroll
      for (int k = 0; k < G::KS; ++k) {
        sm90::Wgmma<QT>::ss(s, sm90::desc_k(kd, k), sm90::desc_k(qd, k));
        sm90::Wgmma<QT>::ss(dp, sm90::desc_k(vd, k), sm90::desc_k(dd, k));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::hold(s);
    sm90::hold(dp);

    // P^T and dS^T in place. This thread's columns are 8j + 2q and + 1:
    // their statistics into registers, two at a time; masked entries
    // (only on a causal or ragged tile) are exactly 0
    float2 mc[QT / 8], ic[QT / 8], dc[QT / 8];
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      mc[j] = *reinterpret_cast<const float2*>(stat + 8 * j + 2 * q);
      ic[j] = *reinterpret_cast<const float2*>(stat + QT + 8 * j + 2 * q);
      dc[j] = *reinterpret_cast<const float2*>(stat + 2 * QT + 8 * j + 2 * q);
      mc[j].x *= kLog2e;  // as the rows kernel's exponent
      mc[j].y *= kLog2e;
    }
    const bool edge = causal || (t + 1) * QT > n || k0 + BK > n;
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) {
      const int j = i / 4;
      const float ml2 = i % 2 ? mc[j].y : mc[j].x;
      const float inv = i % 2 ? ic[j].y : ic[j].x;
      const float delta = i % 2 ? dc[j].y : dc[j].x;
      float p = exp_shifted(s[i], ml2) * inv;
      float ds = p * (dp[i] - delta);
      if (edge) {
        const int key = key_a + ((i / 2) % 2) * 8;
        const int query = t * QT + 8 * j + 2 * q + i % 2;
        if (query >= n || !visible(query, key, n, causal, a.cond_len))
          p = ds = 0.f;
      }
      s[i] = p;
      dp[i] = ds;
    }
    uint32_t pf[QT / 16][4], df[QT / 16][4];
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      sm90::frag_from_acc(pf[kk], s, kk);
      sm90::frag_from_acc(df[kk], dp, kk);
    }
    // dv += P^T dO and dk += dS^T q, dO and q MN-major
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      sm90::hold(pf[kk]);
      sm90::hold(df[kk]);
    }
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      sm90::hold(dv[bx]);
      sm90::hold(dk[bx]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      const uint64_t dd = sm90::smem_desc<RB>(dot + bx * QT * RB);
      const uint64_t qd = sm90::smem_desc<RB>(qt + bx * QT * RB);
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        sm90::Wgmma<G::BOXC>::template rs<1>(dv[bx], pf[kk],
                                             sm90::desc_mn<RB>(dd, kk));
        sm90::Wgmma<G::BOXC>::template rs<1>(dk[bx], df[kk],
                                             sm90::desc_mn<RB>(qd, kk));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      sm90::hold(dv[bx]);
      sm90::hold(dk[bx]);
    }
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {  // read until done
      sm90::hold(pf[kk]);
      sm90::hold(df[kk]);
    }
    if (leader) sm90::mbar_arrive(&empty[s_i]);
  }

  // dk and dv through this warpgroup's rows of the K and V tiles, TMA
  // stores
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx) {
    stage_acc<RB>(ks + bx * BK * RB, dk[bx], w * 64);
    stage_acc<RB>(vs + bx * BK * RB, dv[bx], w * 64);
  }
  sm90::fence_async_cta();
  sm90::named_sync(2 + w, 128);
  if (leader && k0 + w * 64 < n) {
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      const int c0 = bx * G::BOXC;
      sm90::tma_store_4d(&tmap_dk, ks + bx * BK * RB + w * 64 * RB, c0, h,
                         k0 + w * 64, b);
      sm90::tma_store_4d(&tmap_dv, vs + bx * BK * RB + w * 64 * RB, c0, h,
                         k0 + w * 64, b);
    }
    sm90::bulk_commit();
    sm90::bulk_wait();
  }
}

struct Ptrs {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  int ld_q, ld_k, ld_v, ld_do, ld_dq, ld_dk, ld_dv;
};

// D: the tile (32, 64 or 128); head_dim: the lanes of a head, a multiple
// of 8 up to D. Each operand is a 4-D map over (lanes, heads, rows,
// batches) whose lane extent is the head dim: boxes past it load zeros and
// stores drop those lanes.
template <int D>
int launch(const Ptrs& p, BwdArgs a, int b, int head_dim,
           cudaStream_t stream) {
  using G = Geo<D>;
  const int n = a.n;
  const long long nl = n;
  auto map = [&](CUtensorMap* m, const void* ptr, int ld, int rows) {
    return sm90::tensor_map_4d(m, ptr, b, n, a.heads, head_dim, head_dim, ld,
                               nl * ld, rows, G::BOXC);
  };
  CUtensorMap tq, tdo, tk, tv, tdq, tkc, tvc, tqc, tdoc, tdk, tdv;
  if (map(&tq, p.q, p.ld_q, BQ) || map(&tdo, p.dout, p.ld_do, BQ) ||
      map(&tk, p.k, p.ld_k, BKV) || map(&tv, p.v, p.ld_v, BKV) ||
      map(&tdq, p.dq, p.ld_dq, 64) || map(&tkc, p.k, p.ld_k, BK) ||
      map(&tvc, p.v, p.ld_v, BK) || map(&tqc, p.q, p.ld_q, G::QT) ||
      map(&tdoc, p.dout, p.ld_do, G::QT) || map(&tdk, p.dk, p.ld_dk, 64) ||
      map(&tdv, p.dv, p.ld_dv, 64))
    return ETK_TMAP_FAILED;

  a.stages = stages_for(2 * G::tile(BQ) + 1024, rows_stage_bytes<D>(),
                           kRowStages);
  int smem = rows_smem<D>(a.stages);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_rows((n + BQ - 1) / BQ, a.heads, b);
  attn_bwd_rows_kernel<D><<<grid_rows, kThreads, smem, stream>>>(
      tq, tdo, tk, tv, tdq, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  a.stages = stages_for(2 * G::tile(BK) + 1024, cols_stage_bytes<D>(),
                           kColStages);
  smem = cols_smem<D>(a.stages);
  err = cudaFuncSetAttribute(attn_bwd_cols_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_cols((n + BK - 1) / BK, a.heads, b);
  attn_bwd_cols_kernel<D><<<grid_cols, kThreads, smem, stream>>>(
      tkc, tvc, tqc, tdoc, tdk, tdv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stats: 3 * b * heads * n_pad fp32 scratch, n_pad = n rounded up to 128.
// Row strides are in elements, multiples of 8; every row start must be
// 16-byte aligned; batches are n rows apart.
ETK_API int etk_attention_bwd(const void* q, const void* k, const void* v,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* stats, int ld_q, int ld_k, int ld_v,
                              int ld_do, int ld_dq, int ld_dk, int ld_dv,
                              int b, int n, int heads, int head_dim,
                              int mask_mode, int cond_len, void* stream) {
  const int hd = heads * head_dim;
  const int lds[7] = {ld_q, ld_k, ld_v, ld_do, ld_dq, ld_dk, ld_dv};
  for (int ld : lds)
    if (ld < hd || ld % 8) return ETK_BAD_ARGS;
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  const Ptrs p{q, k, v, dout, dq, dk, dv,
               ld_q, ld_k, ld_v, ld_do, ld_dq, ld_dk, ld_dv};
  const BwdArgs a{static_cast<float*>(stats), n, (n + BQ - 1) / BQ * BQ,
                  heads, mask_mode, cond_len, 0};
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 0 || head_dim % 8 || head_dim > 128) return ETK_BAD_ARGS;
  if (head_dim <= 32) return launch<32>(p, a, b, head_dim, s);
  if (head_dim <= 64) return launch<64>(p, a, b, head_dim, s);
  return launch<128>(p, a, b, head_dim, s);
}

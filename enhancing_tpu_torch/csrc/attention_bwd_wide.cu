// Backward of the prior's attention at head dim 384: dq, dk and dv from q
// (already scaled), k, v and dO, each (B, N, H*384) bf16 or fp32 with rows
// read in place at lane offset h*384 (a row stride per tensor; batches are
// N rows apart). Outputs in the inputs' dtype, (B, N, H*384).
//
// Replaces enhancing_tpu/ops/attention.py::_attn_bwd_kernel with
// heads_per_slab == 1 and a slab of 384 lanes, as _attention_packed_bwd_call
// enters it for the GPT prior (16 heads of 384). Numerics as there and as
// csrc/attention_bwd.cu states them for D <= 128: scores, softmax, dP =
// dO V^T and every accumulator in fp32; P = e / sum(e) with the exact row
// max; delta = rowsum(P * dP) in fp32. bf16: dS = P * (dP - delta) is
// rounded to bf16 before the dq and dk products, P before dv; dk and dv
// sum in fp32 over every query and are rounded once. fp32: nothing is
// rounded; every product runs on the bf16 tensor cores as six products of
// exact bf16 pieces (hi*hi, hi*mid, mid*hi, hi*lo, lo*hi, mid*mid; sm90.cuh
// "exact products"), split from fp32 shared memory as the fragments are
// loaded, so no piece scratch and no TF32. Masks 'none' and
// 'prefix_causal' (col <= row, or both < cond_len); rows and keys past N
// are masked, so any N works.
//
// Why not csrc/attention_bwd.cu's wgmma kernels: their rows kernel keeps a
// (128, D) dq accumulator and 128-row q and dO tiles, their cols kernel dk
// and dv of 128 keys; at D = 384 that is 192-393 KiB of fp32 registers a
// block. Here every block splits its accumulator's lanes over warps, and
// the score tile is formed once and handed over through shared memory:
//
//   1. rows (attn_bwd_wide_rows_kernel): a block owns RT query rows of one
//      (batch, head); q and dO stay in shared memory, KT-key K and V tiles
//      stream through it twice. Warp (r, c) forms rows 16r.. x keys
//      c*KT/CW.. of S = q K^T and dP = dO V^T (contractions 384 deep).
//      Sweep 1 carries the online row max, sum and sum of e * dP per warp;
//      the CW warps of a row band merge them once at the end into m, 1 / l
//      and delta, which go to a (3, B, H, N_pad) fp32 workspace. Sweep 2
//      recomputes S and dP, writes dS (bf16-rounded in bf16) to a shared
//      tile, and warp (r, c) accumulates lanes c*384/CW.. of its 16 rows of
//      dq += dS K.
//   2. cols (attn_bwd_wide_cols_kernel): a block owns 32 keys; K and V stay
//      in shared memory, QT-query q and dO tiles and their statistics
//      stream. Warp (r, c) forms keys 16r.. x queries c*QT/CW.. of S^T = K
//      q^T and dP^T = V dO^T, writes P^T and dS^T to shared tiles, and
//      accumulates lanes c*384/CW.. of its 16 keys of dv += P^T dO and dk
//      += dS^T q.
//
// Budgets (ptxas caps a block of 256 threads at 255 registers a thread;
// the last column is what ptxas reported for sm_90a):
//            block  warps  tile        accumulator a thread  shared   regs
//   bf16 rows 64 q  4 x 2  64 keys     dq 96 fp32 + S, dP 32 211 KiB  223
//   bf16 cols 32 k  2 x 4  64 queries  dk, dv 96 + S, dP 16  161 KiB  218
//   fp32 rows 32 q  2 x 4  32 keys     dq 48 + S, dP 8       207 KiB  255*
//   fp32 cols 32 k  2 x 4  32 queries  dk, dv 96 + S, dP 8   211 KiB  255*
// (* with 20 and 4 bytes of spill stores: the fp32 fragments hold three
// pieces each)
// One block an SM, one stage: a tile is copied (cp.async, 16-byte, zero
// fill past N), waited on, then computed; no ring. This is a first kernel
// on warp-level mma.sync (m16n8k16, HMMA) with ldmatrix (bf16) or fp32
// loads split into pieces; wgmma, TMA and overlapping the copies with the
// products are later work (ROADMAP queue B). Products: 9 of 2*N^2*D where
// the function needs 5 (S and dP three times, dq, dk, dv once), each
// fp32 product six bf16 ones. Under prefix_causal, key tiles no row of a
// block sees are skipped (rows), and query tiles that see none of a
// block's keys (cols); the rows grid runs its heaviest blocks first.
//
// Neither S nor P reaches device memory; nothing is summed with atomics,
// so two calls give the same bits.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 384;
constexpr int LDS = D + 8;  // shared row stride in elements: 4 or 8 banks
constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;
constexpr float NEG = -1e30f;

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// Fragments of m16n8k16 operands from shared memory, and the product, per
// element type. a: the 16 x 16 A tile at (r0, k0) of a row-major matrix;
// b_nk: the 16 x 8 B tile whose n rows are stored with k contiguous (B^T
// row-major, at (n0, k0)); b_kn: the B tile of a row-major (k rows, n
// contiguous) matrix at (k0, n0).
template <typename T>
struct Ops;

template <>
struct Ops<bf16> {
  static constexpr int P = 1;
  __device__ static void a(uint32_t (&f)[P][4], const bf16* s, int ld,
                           int r0, int k0) {
    const int l = threadIdx.x & 31;
    ldmatrix_x4(f[0], s + (r0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
  }
  __device__ static void b_nk(uint32_t (&f)[P][2], const bf16* s, int ld,
                              int n0, int k0) {
    const int l = threadIdx.x & 15;
    ldsm_x2(f[0], s + (n0 + (l & 7)) * ld + k0 + (l >> 3) * 8);
  }
  __device__ static void b_kn(uint32_t (&f)[P][2], const bf16* s, int ld,
                              int k0, int n0) {
    const int l = threadIdx.x & 15;
    ldsm_x2_t(f[0], s + (k0 + l) * ld + n0);
  }
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[P][4],
                             const uint32_t (&b)[P][2]) {
    mma_bf16_16816(d, a[0], b[0][0], b[0][1]);
  }
  // two consecutive elements (shared or global), bf16-rounded
  __device__ static void put2(bf16* s, float x, float y) {
    *reinterpret_cast<uint32_t*>(s) = pack_bf16x2(x, y);
  }
};

template <>
struct Ops<float> {
  static constexpr int P = sm90::kPieces;
  // the three exact bf16 pieces of (x, y), each pair packed as a fragment
  // register
  __device__ static void split2(uint32_t (&f)[P], float x, float y) {
    float px[P], py[P];
    sm90::bf16_pieces(x, px);
    sm90::bf16_pieces(y, py);
#pragma unroll
    for (int p = 0; p < P; ++p) f[p] = pack_bf16x2(px[p], py[p]);
  }
  __device__ static void a(uint32_t (&f)[P][4], const float* s, int ld,
                           int r0, int k0) {
    const int l = threadIdx.x & 31, g = l >> 2, c = l & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(
          s + (r0 + g + (i & 1) * 8) * ld + k0 + 2 * c + (i >> 1) * 8);
      uint32_t w[P];
      split2(w, v.x, v.y);
#pragma unroll
      for (int p = 0; p < P; ++p) f[p][i] = w[p];
    }
  }
  __device__ static void b_nk(uint32_t (&f)[P][2], const float* s, int ld,
                              int n0, int k0) {
    const int l = threadIdx.x & 31, g = l >> 2, c = l & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(
          s + (n0 + g) * ld + k0 + 2 * c + 8 * j);
      uint32_t w[P];
      split2(w, v.x, v.y);
#pragma unroll
      for (int p = 0; p < P; ++p) f[p][j] = w[p];
    }
  }
  __device__ static void b_kn(uint32_t (&f)[P][2], const float* s, int ld,
                              int k0, int n0) {
    const int l = threadIdx.x & 31, g = l >> 2, c = l & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* p0 = s + (k0 + 2 * c + 8 * j) * ld + n0 + g;
      uint32_t w[P];
      split2(w, p0[0], p0[ld]);
#pragma unroll
      for (int p = 0; p < P; ++p) f[p][j] = w[p];
    }
  }
  // hi*hi and the five small cross terms (sm90::small_a / small_b)
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[P][4],
                             const uint32_t (&b)[P][2]) {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int pa = sm90::small_a(i), pb = sm90::small_b(i);
      mma_bf16_16816(d, a[pa], b[pb][0], b[pb][1]);
    }
    mma_bf16_16816(d, a[0], b[0][0], b[0][1]);
  }
  __device__ static void put2(float* s, float x, float y) {
    *reinterpret_cast<float2*>(s) = make_float2(x, y);
  }
};

// block shapes: rows kernel RW x CW warps over RT = 16 RW query rows and
// KT-key tiles; cols kernel CRW x CCW warps over 16 CRW keys and QT-query
// tiles
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int RW = 4, CW = 2, KT = 64, CRW = 2, CCW = 4, QT = 64;
};
template <>
struct Cfg<float> {
  static constexpr int RW = 2, CW = 4, KT = 32, CRW = 2, CCW = 4, QT = 32;
};

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float* stats;  // row max, 1 / row sum, delta: each (B, H, n_pad)
  int ld_q, ld_k, ld_v, ld_do, ld_dq, ld_dk, ld_dv;
  int n, n_pad, heads, causal, cond_len;
};

template <typename T>
__host__ __device__ constexpr int rows_smem() {
  using C = Cfg<T>;
  return (2 * 16 * C::RW + 2 * C::KT) * LDS * sizeof(T) +
         16 * C::RW * (C::KT + 8) * sizeof(T) + C::CW * 16 * C::RW * 3 * 4;
}
template <typename T>
__host__ __device__ constexpr int cols_smem() {
  using C = Cfg<T>;
  return (2 * 16 * C::CRW + 2 * C::QT) * LDS * sizeof(T) +
         2 * 16 * C::CRW * (C::QT + 8) * sizeof(T) + 3 * C::QT * 4;
}
static_assert(rows_smem<bf16>() <= sm90::kSmemLimit, "bf16 rows smem");
static_assert(rows_smem<float>() <= sm90::kSmemLimit, "fp32 rows smem");
static_assert(cols_smem<bf16>() <= sm90::kSmemLimit, "bf16 cols smem");
static_assert(cols_smem<float>() <= sm90::kSmemLimit, "fp32 cols smem");

// ROWS rows of 384 elements from src (row r at src + r ld) into shared
// memory at stride LDS; rows at or past `valid` are zero-filled (their
// source address is `safe`, which is never read)
template <typename T, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          int valid, const T* safe) {
  constexpr int V = 16 / sizeof(T), CH = D / V;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    cp_async_16(dst + r * LDS + c * V, ok ? src + r * ld + c * V : safe,
                ok ? 16 : 0);
  }
}

// a warp's NT n8 tiles of S = A1 B1^T and dP = A2 B2^T over the 384 lanes:
// rows r0.. of A1 / A2, rows n0.. of B1 / B2, all at stride LDS
template <typename T, int NT>
__device__ __forceinline__ void score_tiles(float (&s)[NT][4],
                                            float (&dp)[NT][4], const T* a1,
                                            const T* a2, const T* b1,
                                            const T* b2, int r0, int n0) {
  using O = Ops<T>;
  constexpr int P = O::P;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa1[P][4], fa2[P][4];
    O::a(fa1, a1, LDS, r0, kk * 16);
    O::a(fa2, a2, LDS, r0, kk * 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t fb1[P][2], fb2[P][2];
      O::b_nk(fb1, b1, LDS, n0 + j * 8, kk * 16);
      O::b_nk(fb2, b2, LDS, n0 + j * 8, kk * 16);
      O::mma(s[j], fa1, fb1);
      O::mma(dp[j], fa2, fb2);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- 1. rows: statistics and dq ------------------------------------------

template <typename T>
__global__ void __launch_bounds__(32 * Cfg<T>::RW * Cfg<T>::CW, 1)
    attn_bwd_wide_rows_kernel(Args a) {
  using O = Ops<T>;
  using C = Cfg<T>;
  constexpr int RW = C::RW, CW = C::CW, KT = C::KT, RT = 16 * RW;
  constexpr int THREADS = 32 * RW * CW, P = O::P;
  constexpr int KW = KT / CW, NT = KW / 8;  // keys a warp: n8 tiles
  constexpr int LW = D / CW, NL = LW / 8;   // dq lanes a warp: n8 tiles
  constexpr int LDT = KT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + RT * LDS;
  T* sk = sdo + RT * LDS;
  T* sv = sk + KT * LDS;
  T* sds = sv + KT * LDS;
  float* sstat = reinterpret_cast<float*>(sds + RT * LDT);  // [CW][RT][3]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3, wr = warp % RW, wc = warp / RW;
  const int n = a.n, h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * RT;  // heaviest first
  const long long row0 = static_cast<long long>(b) * n;
  const T* gq = static_cast<const T*>(a.q) + row0 * a.ld_q + h * D;
  const T* gdo = static_cast<const T*>(a.dout) + row0 * a.ld_do + h * D;
  const T* gk = static_cast<const T*>(a.k) + row0 * a.ld_k + h * D;
  const T* gv = static_cast<const T*>(a.v) + row0 * a.ld_v + h * D;
  const bool causal = a.causal == MASK_PREFIX_CAUSAL;

  load_tile<T, RT, THREADS>(sq, gq + q0 * (long long)a.ld_q, a.ld_q, n - q0,
                            gq);
  load_tile<T, RT, THREADS>(sdo, gdo + q0 * (long long)a.ld_do, a.ld_do,
                            n - q0, gdo);
  cp_async_commit();
  int kend = n;
  if (causal) {
    const int seen = max(q0 + RT, q0 < a.cond_len ? a.cond_len : 0);
    kend = min(n, seen);
  }
  const int tiles = (kend + KT - 1) / KT;
  const int ra = q0 + 16 * wr + g;  // this thread's rows ra, ra + 8

  auto load_kv = [&](int k0) {
    load_tile<T, KT, THREADS>(sk, gk + k0 * (long long)a.ld_k, a.ld_k,
                              n - k0, gk);
    load_tile<T, KT, THREADS>(sv, gv + k0 * (long long)a.ld_v, a.ld_v,
                              n - k0, gv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };

  // sweep 1: online max, sum and sum of e * dP over this warp's keys
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * KT;
    load_kv(k0);
    float s[NT][4], dp[NT][4];
    score_tiles<T, NT>(s, dp, sq, sdo, sk, sv, 16 * wr, wc * KW);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = ra + 8 * rr;
      float mx = m[rr];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + wc * KW + j * 8 + 2 * c4 + e;
          if (!visible(row, col, n, causal, a.cond_len))
            s[j][2 * rr + e] = NEG;
          mx = fmaxf(mx, s[j][2 * rr + e]);
        }
      mx = quad_max(mx);
      const float ml2 = mx * kLog2e;
      // a running max still at NEG carries no sum (and NEG - NEG would
      // not round to 0 in the exponent's fused multiply-add)
      const float corr = m[rr] == NEG ? 0.f : exp_shifted(m[rr], ml2);
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * rr + e];
          const float p = x == NEG ? 0.f : exp_shifted(x, ml2);
          sum += p;
          dsum += p * dp[j][2 * rr + e];
        }
      l[rr] = l[rr] * corr + sum;
      dd[rr] = dd[rr] * corr + dsum;
      m[rr] = mx;
    }
    __syncthreads();  // before the next tile overwrites K and V
  }
  // merge the CW warps of each row band
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] = quad_sum(l[rr]);
    dd[rr] = quad_sum(dd[rr]);
    if (c4 == 0) {
      float* st = sstat + (wc * RT + 16 * wr + g + 8 * rr) * 3;
      st[0] = m[rr];
      st[1] = l[rr];
      st[2] = dd[rr];
    }
  }
  __syncthreads();
  float mrow[2], inv_l[2], delta[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int lr = 16 * wr + g + 8 * rr;
    float mm = NEG;
#pragma unroll
    for (int c = 0; c < CW; ++c) mm = fmaxf(mm, sstat[(c * RT + lr) * 3]);
    float ls = 0.f, ds = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const float* st = sstat + (c * RT + lr) * 3;
      const float w = st[0] == NEG ? 0.f : exp_shifted(st[0], mm * kLog2e);
      ls += st[1] * w;
      ds += st[2] * w;
    }
    mrow[rr] = mm;
    inv_l[rr] = 1.f / ls;
    delta[rr] = ds * inv_l[rr];
    const int row = ra + 8 * rr;
    if (wc == 0 && c4 == 0 && row < n) {
      const long long bh =
          (static_cast<long long>(b) * a.heads + h) * a.n_pad + row;
      const long long plane =
          static_cast<long long>(gridDim.z) * a.heads * a.n_pad;
      a.stats[bh] = mm;
      a.stats[plane + bh] = inv_l[rr];
      a.stats[2 * plane + bh] = delta[rr];
    }
  }

  // sweep 2: dS tiles, dq += dS K over this warp's lanes
  float dq[NL][4];
#pragma unroll
  for (int j = 0; j < NL; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * KT;
    load_kv(k0);
    float s[NT][4], dp[NT][4];
    score_tiles<T, NT>(s, dp, sq, sdo, sk, sv, 16 * wr, wc * KW);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = ra + 8 * rr;
      const float ml2 = mrow[rr] * kLog2e;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + wc * KW + j * 8 + 2 * c4 + e;
          const float p =
              visible(row, col, n, causal, a.cond_len)
                  ? exp_shifted(s[j][2 * rr + e], ml2) * inv_l[rr]
                  : 0.f;
          ds[e] = p * (dp[j][2 * rr + e] - delta[rr]);
        }
        O::put2(sds + (16 * wr + g + 8 * rr) * LDT + wc * KW + j * 8 + 2 * c4,
                ds[0], ds[1]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t fa[P][4];
      O::a(fa, sds, LDT, 16 * wr, kk * 16);
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        uint32_t fb[P][2];
        O::b_kn(fb, sk, LDS, kk * 16, wc * LW + j * 8);
        O::mma(dq[j], fa, fb);
      }
    }
    __syncthreads();  // before the next tile overwrites K, V and dS
  }
  T* gdq = static_cast<T*>(a.dq) + row0 * a.ld_dq + h * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = ra + 8 * rr;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < NL; ++j)
      O::put2(gdq + row * (long long)a.ld_dq + wc * LW + j * 8 + 2 * c4,
                dq[j][2 * rr], dq[j][2 * rr + 1]);
  }
}

// ---- 2. cols: dk and dv ----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(32 * Cfg<T>::CRW * Cfg<T>::CCW, 1)
    attn_bwd_wide_cols_kernel(Args a) {
  using O = Ops<T>;
  using C = Cfg<T>;
  constexpr int RW = C::CRW, CW = C::CCW, QT = C::QT, KR = 16 * RW;
  constexpr int THREADS = 32 * RW * CW, P = O::P;
  constexpr int QW = QT / CW, NT = QW / 8;  // queries a warp: n8 tiles
  constexpr int LW = D / CW, NL = LW / 8;   // dk, dv lanes a warp
  constexpr int LDT = QT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + KR * LDS;
  T* sq = sv + KR * LDS;
  T* sdo = sq + QT * LDS;
  T* sp = sdo + QT * LDS;
  T* sds = sp + KR * LDT;
  float* sst = reinterpret_cast<float*>(sds + KR * LDT);  // [3][QT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3, wr = warp % RW, wc = warp / RW;
  const int n = a.n, h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * KR;
  const long long row0 = static_cast<long long>(b) * n;
  const T* gq = static_cast<const T*>(a.q) + row0 * a.ld_q + h * D;
  const T* gdo = static_cast<const T*>(a.dout) + row0 * a.ld_do + h * D;
  const T* gk = static_cast<const T*>(a.k) + row0 * a.ld_k + h * D;
  const T* gv = static_cast<const T*>(a.v) + row0 * a.ld_v + h * D;
  const bool causal = a.causal == MASK_PREFIX_CAUSAL;
  const long long plane =
      static_cast<long long>(gridDim.z) * a.heads * a.n_pad;
  const float* gst =
      a.stats + (static_cast<long long>(b) * a.heads + h) * a.n_pad;

  load_tile<T, KR, THREADS>(sk, gk + k0 * (long long)a.ld_k, a.ld_k, n - k0,
                            gk);
  load_tile<T, KR, THREADS>(sv, gv + k0 * (long long)a.ld_v, a.ld_v, n - k0,
                            gv);
  cp_async_commit();
  // the first query tile that sees a key of this block
  const int qstart = causal && k0 >= a.cond_len ? k0 / QT * QT : 0;
  const int ka = k0 + 16 * wr + g;  // this thread's keys ka, ka + 8

  float dk[NL][4], dv[NL][4];
#pragma unroll
  for (int j = 0; j < NL; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int q0 = qstart; q0 < n; q0 += QT) {
    load_tile<T, QT, THREADS>(sq, gq + q0 * (long long)a.ld_q, a.ld_q,
                              n - q0, gq);
    load_tile<T, QT, THREADS>(sdo, gdo + q0 * (long long)a.ld_do, a.ld_do,
                              n - q0, gdo);
    cp_async_commit();
    for (int i = threadIdx.x; i < 3 * QT; i += THREADS)
      sst[i] = gst[(i / QT) * plane + q0 + i % QT];  // q0 + QT <= n_pad
    cp_async_wait<0>();
    __syncthreads();
    float s[NT][4], dp[NT][4];
    score_tiles<T, NT>(s, dp, sk, sv, sq, sdo, 16 * wr, wc * QW);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = ka + 8 * rr;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lq = wc * QW + j * 8 + 2 * c4 + e, qrow = q0 + lq;
          const bool vis =
              qrow < n && visible(qrow, key, n, causal, a.cond_len);
          p[e] = vis ? exp_shifted(s[j][2 * rr + e], sst[lq] * kLog2e) *
                           sst[QT + lq]
                     : 0.f;
          // rows past N have no statistics: select, never multiply
          ds[e] = vis ? p[e] * (dp[j][2 * rr + e] - sst[2 * QT + lq]) : 0.f;
        }
        const int off = (16 * wr + g + 8 * rr) * LDT + wc * QW + j * 8 + 2 * c4;
        O::put2(sp + off, p[0], p[1]);
        O::put2(sds + off, ds[0], ds[1]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t fp[P][4], fds[P][4];
      O::a(fp, sp, LDT, 16 * wr, kk * 16);
      O::a(fds, sds, LDT, 16 * wr, kk * 16);
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        uint32_t fb[P][2];
        O::b_kn(fb, sdo, LDS, kk * 16, wc * LW + j * 8);
        O::mma(dv[j], fp, fb);
        O::b_kn(fb, sq, LDS, kk * 16, wc * LW + j * 8);
        O::mma(dk[j], fds, fb);
      }
    }
    __syncthreads();  // before the next tile overwrites q, dO, P and dS
  }
  cp_async_wait<0>();  // K and V, when no query tile sees this block
  T* gdk = static_cast<T*>(a.dk) + row0 * a.ld_dk + h * D;
  T* gdv = static_cast<T*>(a.dv) + row0 * a.ld_dv + h * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = ka + 8 * rr;
    if (key >= n) continue;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int col = wc * LW + j * 8 + 2 * c4;
      O::put2(gdk + key * (long long)a.ld_dk + col, dk[j][2 * rr],
                dk[j][2 * rr + 1]);
      O::put2(gdv + key * (long long)a.ld_dv + col, dv[j][2 * rr],
                dv[j][2 * rr + 1]);
    }
  }
}

template <typename T>
int launch(const Args& a, int b, cudaStream_t stream) {
  using C = Cfg<T>;
  constexpr int rows_smem_bytes = rows_smem<T>();
  constexpr int cols_smem_bytes = cols_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_wide_rows_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, rows_smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_wide_cols_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             cols_smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rt = 16 * C::RW, kr = 16 * C::CRW;
  dim3 grid_rows((a.n + rt - 1) / rt, a.heads, b);
  attn_bwd_wide_rows_kernel<T><<<grid_rows, 32 * C::RW * C::CW,
                                 rows_smem_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_cols((a.n + kr - 1) / kr, a.heads, b);
  attn_bwd_wide_cols_kernel<T><<<grid_cols, 32 * C::CRW * C::CCW,
                                 cols_smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stats: 3 * b * heads * n_pad fp32 scratch, n_pad = n rounded up to 128.
// dtype ETK_BF16 or ETK_F32. Row strides are in elements, each row start
// 16-byte aligned; batches are n rows apart.
ETK_API int etk_attention_bwd_wide(const void* q, const void* k,
                                   const void* v, const void* dout, void* dq,
                                   void* dk, void* dv, void* stats, int ld_q,
                                   int ld_k, int ld_v, int ld_do, int ld_dq,
                                   int ld_dk, int ld_dv, int b, int n,
                                   int heads, int dtype, int mask_mode,
                                   int cond_len, void* stream) {
  if (dtype != ETK_BF16 && dtype != ETK_F32) return ETK_BAD_ARGS;
  const int vec = dtype == ETK_BF16 ? 8 : 4;  // elements of 16 bytes
  const int lds[7] = {ld_q, ld_k, ld_v, ld_do, ld_dq, ld_dk, ld_dv};
  for (int ld : lds)
    if (ld < heads * D || ld % vec) return ETK_BAD_ARGS;
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  const Args a{q,    k,     v,     dout,  dq,    dk,    dv,
               static_cast<float*>(stats),
               ld_q, ld_k,  ld_v,  ld_do, ld_dq, ld_dk, ld_dv,
               n,    (n + 127) / 128 * 128, heads, mask_mode, cond_len};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == ETK_BF16 ? launch<bf16>(a, b, s) : launch<float>(a, b, s);
}

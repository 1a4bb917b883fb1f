// The int8 GEMMs of the decode step on Hopper's tensor cores, shared by
// the int8 GEMM (B12, int8_gemm.cu) and the int8 LN (+ token shift) GEMM
// (B13, int8_ln_gemm.cu):
//
//   y = act((a @ W_q^T) * scale + b) [+ residual]
//   a = x (B12), or LN(x) rounded to x's dtype and then, with tm, the shift
//       LN(x) * tm + prev * (1 - tm) in x's dtype (B13, which also returns
//       LN(x))
//
// The products are int8_wgmma.cuh's: the int8 weights are the wgmma's A
// operand (64 output channels a warpgroup), the activations B as 8 rows x P
// exact bf16 pieces (3 for fp32 x, 1 for bf16), so every product is the
// fp32 product the JAX function forms; each 128-k stage is one wgmma group
// on a fresh accumulator, folded into the running fp32 sum smallest piece
// first. Only the order of the sums differs from JAX, and it is fixed: a
// result does not change from run to run.
//
// Bound on the H100: bytes, the int8 weights (at the prior's widths and
// batch 8: the projection 37.7 MB, the fused qkv 113 MB, the vocab head
// 50 MB; 11-34 us at 3.35 TB/s).
//
// Design. One launch of at most one block an SM: 3 consumer warpgroups, a
// producer warp and an epilogue warp a consumer warpgroup (512 threads).
// The work is cut into units of (row tile of 8, group of 192 output
// channels, split of the K axis); `make_plan` picks the splits so that the
// units fill the SMs (the projection's 32 groups x 4 splits make 128
// blocks, the qkv's 96 x 4 make 132 blocks of at most 3 units). The units
// of one (row tile, split) are a stream, and a block takes units of one
// stream only while there are blocks enough.
// - The producer streams each stage's weight box (192 channels x 128 k,
//   one TMA, evicted first from L2) through a 4-stage ring. It issues two
//   stages, then waits until the consumers have built their first pieces:
//   the activations' loads queue behind every block's weight loads in the
//   memory system, ~6 us behind full rings (PERF.md, section 6).
// - The activations are not in the ring. When a block starts a stream, its
//   consumers write that split's pieces, K permuted as the fragments read
//   the weights (perm_col), into a resident region of shared memory in the
//   swizzled K-major layout of a wgmma B operand (`build`). B13 first
//   computes the row tile's fp32 statistics in every block (the same sums
//   in the same order, so every block has the same bits), then LN(x), the
//   shift and the pieces; the block holding a stream's first group writes
//   that range of LN(x). (A workspace of per-block row sums and one grid
//   barrier instead measured slower.)
// - A consumer warpgroup hands each tile's fp32 sums to its epilogue warp
//   through two shared-memory slots and goes on with the next unit: the
//   partial's store, the split count (an atomic, reset by the last split
//   to finish), the last split's sum of the partials in split order and
//   the output wait on device memory there, not in the product loop.
#pragma once

#include <algorithm>
#include <atomic>
#include <climits>

#include "int8_wgmma.cuh"

namespace i8g {

using i8w::kChunk;
using i8w::kRows;
using i8w::kTileN;

constexpr int kWgs = 3;  // consumer warpgroups
constexpr int kConsumers = kWgs * 128;
constexpr int kProducer = kConsumers;           // the producer warp's lane 0
constexpr int kEpilogue = kConsumers + 32;      // the first epilogue warp
constexpr int kThreads = kEpilogue + kWgs * 32;  // + one a warpgroup
constexpr int kGroupN = kWgs * kTileN;     // output channels a unit
constexpr int kWBytes = kGroupN * kChunk;  // weight bytes a stage
constexpr int kMaxStages = 4;
constexpr int kMinStages = 2;
constexpr int kConsumerBar = 4;  // named barrier of all consumers (1-3: a
                                 // warpgroup's)
constexpr int kStartBar = 5;     // consumers release the producer
// a warpgroup's fp32 sums of one output tile (8 rows x 64 channels), in one
// of two slots it hands to its epilogue warp
constexpr int kSlotFloats = kRows * kTileN;
constexpr int kSlotBytes = kWgs * 2 * kSlotFloats * 4;
// dynamic shared memory for the resident pieces and the ring: a block's
// less the slots and 1 KB more of static barriers and statistics
constexpr int kSmemBudget = sm90::kSmemLimit - kSlotBytes - 1024;
// stages the producer issues before the block's first pieces are built: a
// deeper queue of weight loads ahead of the activations' loads slows
// those (every block's ring queues in the same memory system)
constexpr int kHeadStages = 2;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// a 64-k box of activation pieces: 8 rows x P pieces of 64 bf16
__host__ __device__ constexpr int act_box_bytes(int pieces) {
  return kRows * pieces * 128;
}
// the resident pieces of a split of `chunks` 128-k chunks
__host__ __device__ constexpr int res_bytes(int chunks, int pieces) {
  return 2 * chunks * act_box_bytes(pieces);
}

// The launch for an (m, d) x (n, d) product with P-piece activations on
// `sms` SMs (ops/int8.py::int8_gemm_plan mirrors it): grid, row tiles,
// channel groups, splits of K and 128-k chunks a split, ring stages,
// dynamic shared memory, bytes of fp32 partials, 32-bit words of split
// counts in the persistent sync buffer.
struct Plan {
  int grid, row_tiles, groups, splits, split_chunks, stages, smem,
      part_bytes, sync_words;
};

// The units of a (row tile, split) pair, a stream, share their resident
// pieces. With at least as many blocks as streams, each block takes units
// of one stream only (block b: stream b % streams, an even share of its
// groups), so it builds its pieces once; with fewer, each block takes a
// contiguous run of all units.
__host__ __device__ inline int max_units(int groups, int streams, int grid) {
  return grid >= streams ? cdiv(groups, grid / streams)
                         : cdiv(groups * streams, grid);
}

// Splits: the one with the least cost, counted in quarter chunks of the
// busiest block: its units (max_units) times their chunks and one quarter
// each for the partial's write, plus one a split for the last arriver's
// reads; fewer splits on a tie. A split's resident pieces must leave room
// for kMinStages stages. Returns false for shapes the kernel does not
// take.
inline bool make_plan(int m, int d, int n, int pieces, int sms, Plan* out) {
  if (m <= 0 || d <= 0 || n <= 0 || d % 16 || sms <= 0 ||
      (pieces != 1 && pieces != 3))
    return false;
  Plan p{};
  const int tiles = cdiv(n, kTileN), chunks = cdiv(d, kChunk);
  p.row_tiles = cdiv(m, kRows);
  p.groups = cdiv(tiles, kWgs);
  long long best = -1;
  for (int s = 1; s <= chunks; ++s) {
    const int sc = cdiv(chunks, s);
    if (cdiv(chunks, sc) != s ||
        kSmemBudget - res_bytes(sc, pieces) < kMinStages * kWBytes)
      continue;  // a split left empty, or no room for the ring
    const long long streams = 1LL * p.row_tiles * s;
    const long long units = streams * p.groups;
    if (units > INT_MAX) continue;
    const int grid = static_cast<int>(std::min<long long>(sms, units));
    const long long cost =
        1LL * max_units(p.groups, static_cast<int>(streams), grid) *
            (4LL * sc + 1) +
        (s > 1 ? s : 0);
    if (best < 0 || cost < best) {
      best = cost;
      p.splits = s;
      p.split_chunks = sc;
    }
  }
  if (best < 0) return false;
  const long long units = 1LL * p.row_tiles * p.groups * p.splits;
  const long long part =
      p.splits > 1 ? 4LL * p.row_tiles * p.splits * kRows * n : 0;
  const long long words = p.splits > 1 ? 1LL * p.row_tiles * tiles : 0;
  if (units > INT_MAX || part > INT_MAX || words > INT_MAX) return false;
  p.grid = static_cast<int>(std::min<long long>(sms, units));
  const int res = res_bytes(p.split_chunks, pieces);
  p.stages = std::min(kMaxStages, (kSmemBudget - res) / kWBytes);
  p.smem = res + p.stages * kWBytes + kSlotBytes + 1024;
  p.part_bytes = static_cast<int>(part);
  p.sync_words = static_cast<int>(words);
  *out = p;
  return true;
}

struct Args {
  const void* x;        // (m, d) fp32 or bf16
  const float* gamma;   // (d,) LayerNorm (B13)
  const float* beta;
  const float* tm;      // (d,) time_mix, null: no shift
  const void* prev;     // (m, d) shift state, fp32 or bf16
  int prev_dtype;
  const float* scale;   // (n,)
  const void* bias;     // (n,) fp32 or bf16, or null
  int bias_dtype;
  const float* residual;  // (m, n) fp32, or null (B12)
  void* out;            // (m, n), x's dtype
  void* xn;             // (m, d) LN(x), x's dtype (B13)
  float* part;          // (row tiles, splits, 8, n) fp32 partials
  unsigned* sync;       // a split count per (row tile, output tile)
  int m, d, n, act;
  float eps;
  int groups, splits, split_chunks, stages, units;
};

// a unit: its row tile, split and channel group; first channel; 128-k
// chunks [c0, c1)
struct Unit {
  int r, s, g, n0, c0, c1;
};

__device__ __forceinline__ Unit unit_at(const Args& a, int u) {
  const int g = u % a.groups, s = (u / a.groups) % a.splits;
  const int r = u / (a.groups * a.splits), c0 = s * a.split_chunks;
  return Unit{r, s, g, g * kGroupN, c0,
              min(c0 + a.split_chunks, cdiv(a.d, kChunk))};
}

// the fp32 statistics (mean, 1 / std) of the row tile's rows, from every
// consumer thread: the same sums in the same order in every block
template <typename XT>
__device__ __forceinline__ void row_stats(const Args& a, int row0, int rows,
                                          float (*red)[kConsumers / 32][kRows],
                                          float2* stats) {
  const XT* x = static_cast<const XT*>(a.x);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float s[kRows], ss[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    s[r] = 0.f;
    ss[r] = 0.f;
  }
#pragma unroll 2
  for (int k = 4 * threadIdx.x; k < a.d; k += 4 * kConsumers) {
    float4 v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      v[r] = r < rows ? i8w::ld4(x + static_cast<size_t>(row0 + r) * a.d + k)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] += (v[r].x + v[r].y) + (v[r].z + v[r].w);
      ss[r] = fmaf(v[r].x, v[r].x,
                   fmaf(v[r].y, v[r].y,
                        fmaf(v[r].z, v[r].z, fmaf(v[r].w, v[r].w, ss[r]))));
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    s[r] = warp_sum(s[r]);
    ss[r] = warp_sum(ss[r]);
    if (lane == 0) {
      red[0][warp][r] = s[r];
      red[1][warp][r] = ss[r];
    }
  }
  sm90::named_sync(kConsumerBar, kConsumers);
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float su = 0.f, sq = 0.f;
    for (int w = 0; w < kConsumers / 32; ++w) {
      su += red[0][w][r];
      sq += red[1][w][r];
    }
    const float mean = su / a.d;
    stats[r] = make_float2(
        mean, 1.f / sqrtf(fmaxf(sq / a.d - mean * mean, 0.f) + a.eps));
  }
  sm90::named_sync(kConsumerBar, kConsumers);
}

// The resident pieces of the split starting at chunk c0 for the row tile
// at row0, from every consumer thread (zeros past d and past the m rows),
// K permuted (perm_col) into 64-k boxes of 8 P rows of 128 bytes, swizzled
// as the TMA writes a 128-byte box. B12: four consecutive k of a row a
// step, the loads of eight steps issued at once (one round trip at the
// prior's widths). LN (B13): a thread takes four consecutive k of all
// rows, loads their gamma, beta and tm once and x (and prev) four rows at
// a time; LayerNorm, LN(x) written for this range if `write_xn`, the
// shift, then the pieces.
template <typename XT, bool LN>
__device__ __forceinline__ void build(const Args& a, uint8_t* res, int row0,
                                      int rows, int c0, bool write_xn,
                                      const float2* stats) {
  constexpr int P = i8w::Pieces<XT>::P, ABOX = act_box_bytes(P);
  const XT* x = static_cast<const XT*>(a.x);
  const int kbase = c0 * kChunk, quads = a.split_chunks * kChunk / 4;
  // the pieces of activations k .. k + 3 (local kl) of row r: k, k + 1 at
  // columns c, c + 1; k + 2, k + 3 at c + 8, c + 9 (the row's next 16-byte
  // chunk)
  auto put = [&](int r, int kl, const float (&v)[4]) {
    __nv_bfloat16 pc[4][P];
#pragma unroll
    for (int i = 0; i < 4; ++i) i8w::split_pieces<P>(v[i], pc[i]);
    const int c = i8w::perm_col(kl), cc = c % 64;
    uint8_t* box = res + (c / 64) * ABOX;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int row = p * kRows + r;
      *reinterpret_cast<__nv_bfloat162*>(
          box + sm90::swz<128>(row, cc / 8) + (cc % 8) * 2) =
          __halves2bfloat162(pc[0][p], pc[1][p]);
      *reinterpret_cast<__nv_bfloat162*>(
          box + sm90::swz<128>(row, cc / 8 + 1) + (cc % 8) * 2) =
          __halves2bfloat162(pc[2][p], pc[3][p]);
    }
  };
  if constexpr (!LN) {
    constexpr int kBatch = 8;
    const int total = kRows * quads;
    for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * kConsumers) {
      float4 xv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kConsumers, r = e / quads;
        const int k = kbase + (e % quads) * 4;
        xv[j] = e < total && r < rows && k < a.d
                    ? i8w::ld4(x + static_cast<size_t>(row0 + r) * a.d + k)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kConsumers;
        if (e >= total) break;
        const float v[4] = {xv[j].x, xv[j].y, xv[j].z, xv[j].w};
        put(e / quads, (e % quads) * 4, v);
      }
    }
  } else {
    constexpr int kRowStep = 4;
    const bool shift = a.tm != nullptr;
    for (int kq = threadIdx.x; kq < quads; kq += kConsumers) {
      const int kl = kq * 4, k = kbase + kl;
      const bool in = k < a.d;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 g = in ? i8w::ld4(a.gamma + k) : zero;
      const float4 bt = in ? i8w::ld4(a.beta + k) : zero;
      const float4 t = in && shift ? i8w::ld4(a.tm + k) : zero;
#pragma unroll
      for (int h = 0; h < kRows; h += kRowStep) {
        float4 xv[kRowStep], pv[kRowStep];
#pragma unroll
        for (int j = 0; j < kRowStep; ++j) {
          const bool live = in && h + j < rows;
          const size_t i = static_cast<size_t>(row0 + h + j) * a.d + k;
          xv[j] = live ? i8w::ld4(x + i) : zero;
          pv[j] = live && shift ? i8w::ld4_any(a.prev, a.prev_dtype, i)
                                : zero;
        }
#pragma unroll
        for (int j = 0; j < kRowStep; ++j) {
          const int r = h + j;
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (in && r < rows) {
            const float2 st = stats[r];
            v[0] = i8w::ln_one<XT>(xv[j].x, g.x, bt.x, st.x, st.y);
            v[1] = i8w::ln_one<XT>(xv[j].y, g.y, bt.y, st.x, st.y);
            v[2] = i8w::ln_one<XT>(xv[j].z, g.z, bt.z, st.x, st.y);
            v[3] = i8w::ln_one<XT>(xv[j].w, g.w, bt.w, st.x, st.y);
            if (write_xn)
              i8w::st4(static_cast<XT*>(a.xn) +
                           static_cast<size_t>(row0 + r) * a.d + k,
                       make_float4(v[0], v[1], v[2], v[3]));
            if (shift) {
              v[0] = i8w::mix_one<XT>(v[0], t.x, pv[j].x);
              v[1] = i8w::mix_one<XT>(v[1], t.y, pv[j].y);
              v[2] = i8w::mix_one<XT>(v[2], t.z, pv[j].z);
              v[3] = i8w::mix_one<XT>(v[3], t.w, pv[j].w);
            }
          }
          put(r, kl, v);
        }
      }
    }
  }
}

// The epilogue warp of consumer warpgroup `wg`: for each of the block's
// units (units [u0, u1)) whose tile exists, the tile's fp32 sums from the
// warpgroup's slot; with splits, its partial written, the tile's split
// count taken, and the last split to finish sums the splits' partials in
// split order from zero; then scale, bias, activation, the residual and
// one rounding, stored. Lane l owns channels 2l and 2l + 1 of the tile, so
// a row's 64 channels are one coalesced run. The consumers never wait on
// device memory for this.
template <typename XT>
__device__ __forceinline__ void epilogue(const Args& a, int u0, int u1,
                                         int wg, int tiles,
                                         const float* slots,
                                         uint64_t (*slot_full)[2],
                                         uint64_t (*slot_free)[2]) {
  const int lane = threadIdx.x % 32;
  int handed = 0;
  for (int u = u0; u < u1; ++u) {
    const Unit un = unit_at(a, u);
    const int tile = un.g * kWgs + wg;
    if (tile >= tiles) continue;
    const int row0 = un.r * kRows, rows = min(kRows, a.m - row0);
    const int c0 = tile * kTileN + 2 * lane;
    const bool live[2] = {c0 < a.n, c0 + 1 < a.n};
    float sc[2], bi[2];  // asked for before the wait
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[j] = live[j] ? a.scale[c0 + j] : 0.f;
      bi[j] = live[j] ? i8w::load_any(a.bias, a.bias_dtype, c0 + j) : 0.f;
    }
    const int k = handed & 1;
    sm90::mbar_wait(&slot_full[wg][k], (handed >> 1) & 1);
    const float* slot = slots + (wg * 2 + k) * kSlotFloats;
    float v[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      v[r][0] = slot[r * kTileN + 2 * lane];
      v[r][1] = slot[r * kTileN + 2 * lane + 1];
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&slot_free[wg][k]);
    ++handed;
    if (a.splits > 1) {
      float* part =
          a.part + static_cast<size_t>(un.r * a.splits + un.s) * kRows * a.n;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (live[j]) part[static_cast<size_t>(r) * a.n + c0 + j] = v[r][j];
      // the warp's partial, then (lane 0, cumulative over the warp's
      // writes) the fence and the count
      __syncwarp();
      unsigned is_last = 0;
      if (lane == 0) {
        __threadfence();
        unsigned* count = &a.sync[un.r * tiles + tile];
        is_last = atomicAdd(count, 1u) == static_cast<unsigned>(a.splits - 1);
        if (is_last) atomicExch(count, 0u);  // zero for the next launch
        __threadfence();
      }
      if (!__shfl_sync(0xffffffffu, is_last, 0)) continue;
      // the splits' partials in split order from zero, two splits' loads
      // in flight at a time
      const float* tp =
          a.part + static_cast<size_t>(un.r * a.splits) * kRows * a.n;
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r][0] = v[r][1] = 0.f;
      for (int sp0 = 0; sp0 < a.splits; sp0 += 2) {
        float p[2][kRows][2];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              p[t][r][j] =
                  sp0 + t < a.splits && live[j]
                      ? __ldcg(&tp[(static_cast<size_t>(sp0 + t) * kRows + r) *
                                       a.n +
                                   c0 + j])
                      : 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t)
          if (sp0 + t < a.splits)
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              v[r][0] = __fadd_rn(v[r][0], p[t][r][0]);
              v[r][1] = __fadd_rn(v[r][1], p[t][r][1]);
            }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!live[j] || r >= rows) continue;
        const size_t o = static_cast<size_t>(row0 + r) * a.n + c0 + j;
        float y = __fmul_rn(v[r][j], sc[j]);
        if (a.bias != nullptr) y = __fadd_rn(y, bi[j]);
        y = apply_act(y, a.act);
        if (a.residual != nullptr) y = __fadd_rn(y, a.residual[o]);
        static_cast<XT*>(a.out)[o] = i8w::from_f32<XT>(y);
      }
  }
}

// The kernel: `tw` maps W_q (n, d) in (192, 128) boxes. Every block takes
// units [u0, u1) of the plan's a.units.
template <typename XT, bool LN>
__device__ __forceinline__ void gemm_body(const CUtensorMap* tw,
                                          const Args& a) {
  constexpr int P = i8w::Pieces<XT>::P;
  constexpr int ABOX = act_box_bytes(P);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ __align__(8) uint64_t slot_full[kWgs][2], slot_free[kWgs][2];
  __shared__ float red[2][kConsumers / 32][kRows];
  __shared__ float2 stats[kRows];
  uint8_t* res = sm90::align_1024(smem_raw);
  uint8_t* ring_base = res + res_bytes(a.split_chunks, P);
  float* slots = reinterpret_cast<float*>(ring_base + a.stages * kWBytes);
  const sm90::Ring ring{a.stages};
  int u0, u1;  // this block's units (max_units)
  const int streams = a.units / a.groups;
  const int grid = static_cast<int>(gridDim.x), b = blockIdx.x;
  if (grid >= streams) {
    const int t = b % streams, i = b / streams;
    const int nb = (grid - 1 - t) / streams + 1;
    u0 = t * a.groups + i * a.groups / nb;
    u1 = t * a.groups + (i + 1) * a.groups / nb;
  } else {
    u0 = static_cast<int>(1LL * b * a.units / grid);
    u1 = static_cast<int>(1LL * (b + 1) * a.units / grid);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWgs);  // one arrival per warpgroup
    }
    for (int w = 0; w < kWgs; ++w)
      for (int k = 0; k < 2; ++k) {
        sm90::mbar_init(&slot_full[w][k], 128);  // every consumer thread
        sm90::mbar_init(&slot_free[w][k], 1);    // the epilogue warp
      }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int tiles = cdiv(a.n, kTileN);
  if (threadIdx.x >= kEpilogue) {
    epilogue<XT>(a, u0, u1, (threadIdx.x - kEpilogue) / 32, tiles, slots,
                 slot_full, slot_free);
    return;
  }
  if (threadIdx.x >= kConsumers) {
    // producer warp: lane 0 streams the weights of every stage in order;
    // after kHeadStages the warp waits for the consumers' first pieces
    const bool issuer = threadIdx.x == kProducer;
    const uint64_t policy = i8w::evict_first();
    int it = 0;
    for (int u = u0; u < u1; ++u) {
      const Unit un = unit_at(a, u);
      for (int c = un.c0; c < un.c1; ++c, ++it) {
        if (it == kHeadStages) {
          __syncwarp();  // bar.sync wants the warp converged
          sm90::named_sync(kStartBar, kEpilogue);
        }
        if (!issuer) continue;
        const int s = ring.stage(it);
        sm90::mbar_wait(&empty[s], ring.parity(it) ^ 1u);
        sm90::mbar_expect_tx(&full[s], kWBytes);
        i8w::tma_load_hint(ring_base + s * kWBytes, tw, &full[s],
                           c * kChunk, un.n0, policy);
      }
    }
    if (it <= kHeadStages) {
      __syncwarp();
      sm90::named_sync(kStartBar, kEpilogue);
    }
    return;
  }

  // three consumer warpgroups, 64 channels each
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const int frow = wg * kTileN + warp * 16 + lane / 4;  // row in the box
  int it = 0, handed = 0;

  // the products of one unit's n stages into sum, B from the resident
  // pieces of the unit's split
  auto run_unit = [&](int n, float (&sum)[4]) {
    i8w::run_stages<P>(
        n, it, ring, full, empty, frow, q, leader,
        [&](int i) { return ring_base + ring.stage(i) * kWBytes; },
        [&](int, int j) { return res + 2 * j * ABOX; }, sum);
    it += n;
  };

  int cur_r = -1, cur_s = -1;
  for (int u = u0; u < u1; ++u) {
    const Unit un = unit_at(a, u);
    const int row0 = un.r * kRows, rows = min(kRows, a.m - row0);
    if (un.r != cur_r || un.s != cur_s) {
      // every warpgroup's products on the old pieces are done
      sm90::named_sync(kConsumerBar, kConsumers);
      if constexpr (LN) {
        if (un.r != cur_r) row_stats<XT>(a, row0, rows, red, stats);
      }
      build<XT, LN>(a, res, row0, rows, un.c0, LN && un.g == 0, stats);
      sm90::fence_async_cta();  // the pieces, visible to the wgmmas
      sm90::named_sync(kConsumerBar, kConsumers);
      if (u == u0) sm90::named_arrive(kStartBar, kEpilogue);
      cur_r = un.r;
      cur_s = un.s;
    }
    // sum[2c + e]: channel n0 + frow + 8c, activation row 2q + e
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    run_unit(un.c1 - un.c0, sum);
    // hand the tile's sums to the epilogue warp (the last group's missing
    // tiles have none)
    if (un.g * kWgs + wg >= tiles) continue;
    const int k = handed & 1;
    sm90::mbar_wait(&slot_free[wg][k], ((handed >> 1) & 1) ^ 1);
    float* slot = slots + (wg * 2 + k) * kSlotFloats;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      slot[(2 * q + i % 2) * kTileN + warp * 16 + lane / 4 + 8 * (i / 2)] =
          sum[i];
    sm90::mbar_arrive(&slot_full[wg][k]);
    ++handed;
  }
}

// Allow `Kernel` the dynamic shared memory of the largest plan (kSmemLimit)
// on the current device, once a device rather than at every launch.
template <auto Kernel>
int allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return 0;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  done.fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

// Launch `Kernel` (a __global__ wrapper of gemm_body) for the plan of an
// (m, d) x (n, d) product: fills the plan's fields of `a` and maps W_q.
// With more than one split, a.part must hold `part_cap` bytes and a.sync
// `sync_cap` words, zero, and the plan's partials and counts must fit.
template <auto Kernel>
int launch(int pieces, const void* w_q, Args a, long long part_cap,
           long long sync_cap, cudaStream_t stream) {
  Plan p;
  if (!make_plan(a.m, a.d, a.n, pieces, sm_count(), &p) ||
      (p.splits > 1 &&
       (a.part == nullptr || a.sync == nullptr || part_cap < p.part_bytes ||
        sync_cap < p.sync_words)))
    return ETK_BAD_ARGS;
  a.groups = p.groups;
  a.splits = p.splits;
  a.split_chunks = p.split_chunks;
  a.stages = p.stages;
  a.units = p.row_tiles * p.groups * p.splits;
  CUtensorMap tw;
  if (i8w::tensor_map_i8(&tw, w_q, a.n, a.d, kGroupN)) return ETK_TMAP_FAILED;
  if (const int err = allow_smem<Kernel>()) return err;
  auto* kernel = Kernel;
  kernel<<<p.grid, kThreads, p.smem, stream>>>(tw, a);
  return static_cast<int>(cudaGetLastError());
}

// the plan as the C entries return it: grid, row tiles, groups, splits,
// chunks a split, stages, shared memory, partial bytes, sync words
inline int plan_entry(int m, int d, int n, int pieces, int* out) {
  Plan p;
  if (!make_plan(m, d, n, pieces, sm_count(), &p)) return ETK_BAD_ARGS;
  const int v[9] = {p.grid,  p.row_tiles, p.groups, p.splits, p.split_chunks,
                    p.stages, p.smem,     p.part_bytes, p.sync_words};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

}  // namespace i8g

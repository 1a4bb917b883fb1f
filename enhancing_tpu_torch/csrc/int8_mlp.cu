// The whole pre-norm MLP of a decode step as one launch, int8 weights:
//   out = residual + b1 + (act(LN(x) @ W0_q^T * s0 + b0) @ W1_q^T) * s1
//
// Replaces enhancing_tpu/ops/int8.py::_int8_mlp_flush_kernel (entered
// through _int8_mlp_pallas). Numerics as there: LN(x) rounded to x's
// dtype; the hidden in fp32 after s0, b0 and the activation, then rounded
// to x's dtype before the second product; s1 scales the fp32 sum over the
// whole hidden axis (it is linear in the sum), and residual + b1, merged
// in fp32 first, is added at the flush; one rounding to x's dtype. The
// products are the exact fp32 products of int8_wgmma.cuh (three bf16
// pieces of each fp32 activation, one of a bf16 one); only the order of
// the sums differs, and it is fixed, so a result does not change from run
// to run.
//
// Bound on the H100: bytes: W0_q (24576 x 6144) and W1_q (6144 x 24576),
// 302 MB a layer for 4.8 GFLOP at batch 8 (90.1 us of bytes).
//
// Design. The TPU kernel walks the hidden axis in order and carries one
// accumulator across its grid steps; on the card the sum over the hidden
// axis crosses blocks. One cooperative launch of one block an SM (128 at
// the prior's widths): 3 consumer warpgroups and a producer warp. Per tile
// of 8 rows:
//   A. every block writes its share of LN(x)'s pieces into an
//      L2-resident workspace, in the permuted, wgmma-ready layout, after
//      the LayerNorm statistics of the rows it touches (the same sums in
//      the same order in every block);
//   B. a block takes 192 hidden channels (a 64-channel tile a warpgroup:
//      384 tiles = 128 blocks x 3 at h = 24576) over the whole of K = d,
//      and writes the hidden's pieces, rounded to x's dtype, into a second
//      workspace;
//   C. a block takes 192 output channels over one of `splits` ranges of
//      the hidden axis (96 tiles x 4 splits = 128 x 3); each warpgroup
//      writes its fp32 partial, and the last of a tile's splits to finish
//      (an atomic count) sums them in split order and flushes.
// A grid-wide barrier over an atomic count (int8_wgmma.cuh) separates A
// from B and B from C; the grid is co-resident, which the cooperative
// launch guarantees. The producer streams every stage's weight box (192
// channels x 128 k, one TMA, evicted first from L2 so that the workspace
// stays there) and activation boxes (24 or 8 piece rows x 2 x 64 k)
// through one 6-stage ring, and runs ahead through the barriers:
// the weights of a phase's first stages load while the grid waits, and
// only their activation boxes wait for the barrier. Each activation chunk
// is staged once for the block's three warpgroups (~38 MB of L2 reads a
// phase at the prior's widths).
#include <algorithm>

#include "int8_wgmma.cuh"

namespace {

using i8w::kChunk;
using i8w::kRows;
using i8w::kTileN;

constexpr int kWgs = 3;  // consumer warpgroups
constexpr int kConsumers = kWgs * 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kGroupN = kWgs * kTileN;     // channels a block unit
constexpr int kWBytes = kGroupN * kChunk;  // weight bytes a stage
constexpr int kMaxStages = 6;
constexpr int kConsumerBar = 4;  // named barrier of all consumers (1-3: a
                                 // warpgroup's)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// an activation box: 8 rows x P pieces of 64 bf16 (one 128-byte row)
__host__ __device__ constexpr int act_box_bytes(int pieces) {
  return kRows * pieces * 128;
}
__host__ __device__ constexpr int stage_bytes(int pieces) {
  return kWBytes + 2 * act_box_bytes(pieces);
}

// The launch for a (d, h) MLP with P-piece activations on `sms` SMs
// (ops/int8.py::int8_mlp_plan mirrors it): grid, phase B units, phase C
// units, splits of the hidden axis and 128-wide k chunks a split, ring
// stages, dynamic shared memory, workspace bytes (LN(x) and hidden pieces,
// the splits' partials), 32-bit words of the persistent sync buffer (the
// barrier's two, a count per output tile).
struct Plan {
  int grid, groups_b, groups_c, splits, split_chunks, stages, smem, ws_bytes,
      sync_words;
};

Plan make_plan(int d, int h, int pieces, int sms) {
  Plan p;
  const int tiles_c = cdiv(d, kTileN), groups_c0 = cdiv(tiles_c, kWgs);
  const int chunks_c = cdiv(h, kChunk);
  p.groups_b = cdiv(cdiv(h, kTileN), kWgs);
  const int want = std::max(1, std::min(sms / groups_c0, chunks_c));
  p.split_chunks = cdiv(chunks_c, want);
  p.splits = cdiv(chunks_c, p.split_chunks);
  p.groups_c = groups_c0 * p.splits;
  p.grid = std::max(1, std::min(sms, std::max(p.groups_b, p.groups_c)));
  const int sb = stage_bytes(pieces);
  p.stages = std::min(kMaxStages, sm90::kSmemLimit / sb);
  p.smem = p.stages * sb + 1024;
  const long long ln = 2LL * kRows * pieces * d, hid = 2LL * kRows * pieces * h;
  const long long part = p.splits > 1 ? 4LL * p.splits * kRows * d : 0;
  p.ws_bytes = static_cast<int>(ln + hid + part);
  p.sync_words = 2 + tiles_c;
  return p;
}

struct MlpArgs {
  const void* x;
  const float* gamma;
  const float* beta;
  const float* s0;
  const void* b0;
  const float* s1;
  const void* b1;
  int bias_dtype;
  const float* residual;  // (m, d) fp32
  void* out;
  __nv_bfloat16* ln_ws;   // (8 P, d): LN(x)'s pieces, K permuted
  __nv_bfloat16* hid_ws;  // (8 P, h): the hidden's pieces, K permuted
  float* part;            // (splits, 8, d): phase C partials
  unsigned* sync;         // barrier count, generation, a count per tile
  int m, d, h, act;
  float eps;
  int groups_b, groups_c, splits, split_chunks, stages;
};

// a block's unit of a phase: its first channel, its 128-wide k chunks
// [c0, c1), its split of the hidden axis
struct Unit {
  int n0, c0, c1, split;
};

__device__ __forceinline__ Unit unit_b(const MlpArgs& a, int g) {
  return Unit{g * kGroupN, 0, cdiv(a.d, kChunk), 0};
}

__device__ __forceinline__ Unit unit_c(const MlpArgs& a, int g) {
  const int groups_c0 = a.groups_c / a.splits, split = g / groups_c0;
  const int c0 = split * a.split_chunks;
  return Unit{(g % groups_c0) * kGroupN, c0,
              min(c0 + a.split_chunks, cdiv(a.h, kChunk)), split};
}

template <typename XT>
__global__ void __launch_bounds__(kThreads, 1)
    int8_mlp_kernel(const __grid_constant__ CUtensorMap tw0,
                    const __grid_constant__ CUtensorMap tw1,
                    const __grid_constant__ CUtensorMap tln,
                    const __grid_constant__ CUtensorMap thid,
                    const MlpArgs a) {
  constexpr int P = i8w::Pieces<XT>::P;
  constexpr int ABOX = act_box_bytes(P), SB = stage_bytes(P);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ float red[2][kConsumers / 32][kRows];
  __shared__ float2 stats[kRows];
  __shared__ int last[kWgs];
  __shared__ unsigned gen0_s;
  uint8_t* smem = sm90::align_1024(smem_raw);
  const sm90::Ring ring{a.stages};
  const int row_tiles = cdiv(a.m, kRows);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWgs);  // one arrival per warpgroup
    }
    sm90::fence_mbar_init();
    // no block can complete a barrier before this one arrives, so this is
    // the launch's starting generation
    gen0_s = i8w::ld_acquire(&a.sync[1]);
  }
  __syncthreads();
  const unsigned gen0 = gen0_s;

  if (threadIdx.x >= kConsumers) {
    // producer: one thread drives the ring
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    const uint64_t policy = i8w::evict_first();
    auto issue_w = [&](int i, const CUtensorMap* tw, const Unit& u, int c) {
      const int s = ring.stage(i);
      sm90::mbar_wait(&empty[s], ring.parity(i) ^ 1u);
      sm90::mbar_expect_tx(&full[s], SB);
      i8w::tma_load_hint(smem + s * SB, tw, &full[s], c * kChunk, u.n0,
                         policy);
    };
    auto issue_act = [&](int i, const CUtensorMap* ta, int c) {
      const int s = ring.stage(i);
      uint8_t* at = smem + s * SB + kWBytes;
      sm90::tma_load(at, ta, &full[s], c * kChunk, 0);
      sm90::tma_load(at + ABOX, ta, &full[s], c * kChunk + 64, 0);
    };
    // one phase's stages: the weights of the first `stages` of them, then,
    // once barrier k has made the phase's activations readable, their
    // activation boxes, then the rest
    auto phase = [&](bool c_phase, int k) {
      const CUtensorMap* tw = c_phase ? &tw1 : &tw0;
      const CUtensorMap* ta = c_phase ? &thid : &tln;
      const int groups = c_phase ? a.groups_c : a.groups_b;
      int j = 0;
      for (int g = blockIdx.x; g < groups && j < a.stages; g += gridDim.x) {
        const Unit u = c_phase ? unit_c(a, g) : unit_b(a, g);
        for (int c = u.c0; c < u.c1 && j < a.stages; ++c, ++j)
          issue_w(it + j, tw, u, c);
      }
      if (j == 0) return;
      i8w::grid_wait(a.sync, gen0, k);
      i8w::fence_async_global();
      j = 0;
      for (int g = blockIdx.x; g < groups; g += gridDim.x) {
        const Unit u = c_phase ? unit_c(a, g) : unit_b(a, g);
        for (int c = u.c0; c < u.c1; ++c, ++j) {
          if (j >= a.stages) issue_w(it + j, tw, u, c);
          issue_act(it + j, ta, c);
        }
      }
      it += j;
    };
    for (int t = 0; t < row_tiles; ++t) {
      phase(false, 2 * t + 1);
      phase(true, 2 * t + 2);
    }
    return;
  }

  // three consumer warpgroups, 64 channels each
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const int frow = wg * kTileN + warp * 16 + lane / 4;  // row in the box
  const XT* x = static_cast<const XT*>(a.x);
  int it = 0;

  // every consumer thread: after this block's writes, until barrier k has
  // passed for the whole grid
  auto grid_sync = [&](int k) {
    __threadfence();
    i8w::fence_async_global();
    sm90::named_sync(kConsumerBar, kConsumers);
    if (threadIdx.x == 0) {
      i8w::grid_arrive(a.sync, gridDim.x);
      i8w::grid_wait(a.sync, gen0, k);
    }
    sm90::named_sync(kConsumerBar, kConsumers);
  };

  // phase A: this block's share of LN(x)'s pieces, a contiguous run of
  // quads (four consecutive k) of the tile's 8 x d elements, four k a
  // thread, and the statistics of the rows that run touches (one row a
  // block at the prior's widths)
  auto ln_phase = [&](int row0, int rows) {
    const int d = a.d, quads = d / 4, total = kRows * quads;
    const int per = cdiv(total, gridDim.x);
    const int e0 = min(blockIdx.x * per, total), e1 = min(e0 + per, total);
    const int r_lo = e0 / quads, r_hi = (e1 - 1) / quads;
    float s[kRows], ss[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = 0.f;
      ss[r] = 0.f;
      if (r < rows && r >= r_lo && r <= r_hi) {
        const XT* xr = x + static_cast<size_t>(row0 + r) * d;
        for (int k = 4 * threadIdx.x; k < d; k += 4 * kConsumers) {
          const float4 v = i8w::ld4(xr + k);
          s[r] += (v.x + v.y) + (v.z + v.w);
          ss[r] = fmaf(v.x, v.x,
                       fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss[r]))));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = warp_sum(s[r]);
      ss[r] = warp_sum(ss[r]);
      if (lane == 0) {
        red[0][threadIdx.x / 32][r] = s[r];
        red[1][threadIdx.x / 32][r] = ss[r];
      }
    }
    sm90::named_sync(kConsumerBar, kConsumers);
    if (threadIdx.x < kRows && threadIdx.x >= r_lo && threadIdx.x <= r_hi) {
      const int r = threadIdx.x;
      float su = 0.f, sq = 0.f;
      for (int w = 0; w < kConsumers / 32; ++w) {
        su += red[0][w][r];
        sq += red[1][w][r];
      }
      const float mean = su / d;
      stats[r] = make_float2(
          mean, 1.f / sqrtf(fmaxf(sq / d - mean * mean, 0.f) + a.eps));
    }
    sm90::named_sync(kConsumerBar, kConsumers);
    for (int e = e0 + threadIdx.x; e < e1; e += kConsumers) {
      const int r = e / quads, k = (e % quads) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};  // rows past m stage zeros
      if (r < rows) {
        const float4 xv = i8w::ld4(x + static_cast<size_t>(row0 + r) * d + k);
        const float4 g = i8w::ld4(a.gamma + k), b = i8w::ld4(a.beta + k);
        const float2 st = stats[r];
        v[0] = i8w::ln_one<XT>(xv.x, g.x, b.x, st.x, st.y);
        v[1] = i8w::ln_one<XT>(xv.y, g.y, b.y, st.x, st.y);
        v[2] = i8w::ln_one<XT>(xv.z, g.z, b.z, st.x, st.y);
        v[3] = i8w::ln_one<XT>(xv.w, g.w, b.w, st.x, st.y);
      }
      __nv_bfloat16 pc[4][P];
#pragma unroll
      for (int i = 0; i < 4; ++i) i8w::split_pieces<P>(v[i], pc[i]);
      // k, k + 1 are staged at columns c, c + 1; k + 2, k + 3 at c + 8, c + 9
      const int c = i8w::perm_col(k);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        __nv_bfloat16* row = a.ln_ws + static_cast<size_t>(p * kRows + r) * d;
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __halves2bfloat162(pc[0][p], pc[1][p]);
        *reinterpret_cast<__nv_bfloat162*>(row + c + 8) =
            __halves2bfloat162(pc[2][p], pc[3][p]);
      }
    }
  };

  // the products of one unit of n stages into sum (the ring stage holds
  // the weight box, then the two activation boxes)
  auto run_unit = [&](int n, float (&sum)[4]) {
    i8w::run_stages<P>(
        n, it, ring, full, empty, frow, q, leader,
        [&](int i) { return smem + ring.stage(i) * SB; },
        [&](int i, int) { return smem + ring.stage(i) * SB + kWBytes; }, sum);
    it += n;
  };

  // sum[2c + e]: channel ch0 + 8c, activation row 2q + e
  const int ch_off = wg * kTileN + warp * 16 + lane / 4;
  for (int t = 0; t < row_tiles; ++t) {
    const int row0 = t * kRows, rows = min(kRows, a.m - row0);
    ln_phase(row0, rows);
    grid_sync(2 * t + 1);

    // B: the hidden, act(sum * s0 + b0) rounded to x's dtype, as pieces
    for (int g = blockIdx.x; g < a.groups_b; g += gridDim.x) {
      const Unit u = unit_b(a, g);
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
      run_unit(u.c1 - u.c0, sum);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = u.n0 + ch_off + 8 * (i / 2), r = 2 * q + i % 2;
        if (j >= a.h) continue;
        float v = apply_act(
            __fadd_rn(__fmul_rn(sum[i], a.s0[j]),
                      i8w::load_any(a.b0, a.bias_dtype, j)),
            a.act);
        v = r < rows ? i8w::round_to<XT>(v) : 0.f;
        __nv_bfloat16 pc[P];
        i8w::split_pieces<P>(v, pc);
#pragma unroll
        for (int p = 0; p < P; ++p)
          a.hid_ws[static_cast<size_t>(p * kRows + r) * a.h +
                   i8w::perm_col(j)] = pc[p];
      }
    }
    grid_sync(2 * t + 2);

    // C: the output channels over a split of the hidden axis; the last
    // split of a tile to finish sums the partials in split order and
    // flushes
    for (int g = blockIdx.x; g < a.groups_c; g += gridDim.x) {
      const Unit u = unit_c(a, g);
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
      run_unit(u.c1 - u.c0, sum);
      if (a.splits > 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = u.n0 + ch_off + 8 * (i / 2), r = 2 * q + i % 2;
          if (c < a.d)
            a.part[(static_cast<size_t>(u.split) * kRows + r) * a.d + c] =
                sum[i];
        }
        __threadfence();
        sm90::named_sync(1 + wg, 128);
        if (leader) {
          unsigned* count = &a.sync[2 + u.n0 / kTileN + wg];
          const bool is_last =
              atomicAdd(count, 1u) == static_cast<unsigned>(a.splits - 1);
          if (is_last) atomicExch(count, 0u);  // ready for the next tile
          __threadfence();
          last[wg] = is_last;
        }
        sm90::named_sync(1 + wg, 128);
        if (!last[wg]) continue;
        __threadfence();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = u.n0 + ch_off + 8 * (i / 2), r = 2 * q + i % 2;
          if (c >= a.d) continue;
          float total = 0.f;
          for (int sp = 0; sp < a.splits; ++sp)
            total = __fadd_rn(
                total,
                __ldcg(&a.part[(static_cast<size_t>(sp) * kRows + r) * a.d +
                               c]));
          sum[i] = total;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = u.n0 + ch_off + 8 * (i / 2), r = 2 * q + i % 2;
        if (c >= a.d || r >= rows) continue;
        const size_t o = static_cast<size_t>(row0 + r) * a.d + c;
        const float res =
            __fadd_rn(a.residual[o], i8w::load_any(a.b1, a.bias_dtype, c));
        static_cast<XT*>(a.out)[o] =
            i8w::from_f32<XT>(__fadd_rn(__fmul_rn(sum[i], a.s1[c]), res));
      }
    }
  }
}

bool bad_shape(int m, int d, int h) {
  return m <= 0 || d <= 0 || h <= 0 || d % 16 || h % 16;
}

}  // namespace

// ws: int8_mlp_plan's workspace bytes; sync: its persistent words, zero
// when first made; residual fp32 (m, d); out (m, d) in x's dtype
ETK_API int etk_int8_mlp(const void* x, const void* gamma, const void* beta,
                         const void* w0_q, const void* s0, const void* b0,
                         const void* w1_q, const void* s1, const void* b1,
                         const void* residual, void* out, void* ws,
                         void* sync, int m, int d, int h, int act, float eps,
                         int bias_dtype, int x_dtype, void* stream) {
  if (bad_shape(m, d, h) || act < ACT_NONE || act > ACT_GELU ||
      residual == nullptr || ws == nullptr || sync == nullptr ||
      (x_dtype != ETK_F32 && x_dtype != ETK_BF16) || sm_count() <= 0)
    return ETK_BAD_ARGS;
  const int pieces = x_dtype == ETK_F32 ? 3 : 1;
  const Plan p = make_plan(d, h, pieces, sm_count());
  MlpArgs a{};
  a.x = x;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.s0 = static_cast<const float*>(s0);
  a.b0 = b0;
  a.s1 = static_cast<const float*>(s1);
  a.b1 = b1;
  a.bias_dtype = bias_dtype;
  a.residual = static_cast<const float*>(residual);
  a.out = out;
  a.ln_ws = static_cast<__nv_bfloat16*>(ws);
  a.hid_ws = a.ln_ws + static_cast<size_t>(kRows) * pieces * d;
  a.part = reinterpret_cast<float*>(a.hid_ws +
                                    static_cast<size_t>(kRows) * pieces * h);
  a.sync = static_cast<unsigned*>(sync);
  a.m = m;
  a.d = d;
  a.h = h;
  a.act = act;
  a.eps = eps;
  a.groups_b = p.groups_b;
  a.groups_c = p.groups_c;
  a.splits = p.splits;
  a.split_chunks = p.split_chunks;
  a.stages = p.stages;
  CUtensorMap tw0, tw1, tln, thid;
  if (i8w::tensor_map_i8(&tw0, w0_q, h, d, kGroupN) ||
      i8w::tensor_map_i8(&tw1, w1_q, d, h, kGroupN) ||
      sm90::tensor_map(&tln, a.ln_ws, kRows * pieces, d, d, kRows * pieces) ||
      sm90::tensor_map(&thid, a.hid_ws, kRows * pieces, h, h, kRows * pieces))
    return ETK_TMAP_FAILED;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == ETK_F32)
    return i8w::launch_cooperative(int8_mlp_kernel<float>, p.grid, kThreads,
                                   p.smem, s, tw0, tw1, tln, thid, a);
  return i8w::launch_cooperative(int8_mlp_kernel<__nv_bfloat16>, p.grid,
                                 kThreads, p.smem, s, tw0, tw1, tln, thid, a);
}

// the launch for a (d, h) MLP of P-piece activations (3: fp32 x, 1: bf16)
// on this device, as ops.int8.int8_mlp_plan mirrors it: grid, phase B
// units, phase C units, splits, k chunks a split, stages, bytes of dynamic
// shared memory, workspace bytes, sync words
ETK_API int etk_int8_mlp_plan(int m, int d, int h, int pieces, int* out) {
  if (bad_shape(m, d, h) || (pieces != 1 && pieces != 3) || sm_count() <= 0)
    return ETK_BAD_ARGS;
  const Plan p = make_plan(d, h, pieces, sm_count());
  const int v[9] = {p.grid,   p.groups_b, p.groups_c, p.splits,
                    p.split_chunks, p.stages, p.smem, p.ws_bytes,
                    p.sync_words};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

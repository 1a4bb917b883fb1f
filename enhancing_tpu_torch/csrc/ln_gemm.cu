// Fused LayerNorm -> GEMM: y = act(LN(x) @ W^T + b).
//
// Replaces enhancing_tpu/ops/ln_gemm.py::_ln_gemm_kernel (LN1 -> to_qkv and
// LN2 -> fc1 + tanh in every ViT block). Numerics as there: fp32 row
// statistics with the fast variance max(E[x^2] - mean^2, 0); the
// normalised row is rounded to the compute dtype before the product;
// fp32 accumulation; then fp32 bias, fp32 activation, one rounding.
// W is (n, d) with d contiguous: torch's Linear layout, which is the
// K-major B operand that wgmma wants.
//
// Bound on the H100: tensor-core operations. At the main path's shapes
// (M = B * 1024, d = 768, n = 2304 or 3072) it does 2*M*d*n flops against
// ~2*(M*d + M*n) bytes, hundreds of flops per byte, above the ridge.
// Design (bf16), on the Hopper core of sm90.cuh: a pre-pass writes each
// row's fp32 mean and rstd (one read of x, ~60 us at batch 128; computing
// them in every output tile would read the x block again from L2 for each
// of the 9-12 column tiles). The GEMM is persistent, one block an SM
// walking 128 x BN output tiles (BN 256, or 128 when 256-wide tiles would
// not fill the SMs), the tiles in flight adjacent in one row block. A
// producer warpgroup (one thread issuing, its registers given to the
// consumers) streams 64-wide k slices of the raw x tile and of the W tile
// through a TMA ring, running ahead into the next tile. Two consumer
// warpgroups of 64 rows each load their x slice from shared memory into
// mma.sync-layout A fragments (ldmatrix), normalise them in registers with
// their rows' statistics and the slice's gamma and beta, round to bf16 and
// issue register-A wgmma against the W tile, one k tile in flight while
// the next is normalised. The normalised activation never reaches shared
// or device memory. The epilogue adds the bias and applies the activation
// in fp32, rounds once into a swizzled shared-memory tile and TMA-stores
// it, asynchronously, while the next tile's products start. fp32 inputs
// run ln_gemm_f32.cu, on the same design with exact bf16 pieces.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"
#include "vec.cuh"

namespace {

// ---- bf16: row statistics, then wgmma ----------------------------------

constexpr int BM = 128;
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kXBytes = BM * sm90::kTileK * 2;

// the tile widths: kWideN, or 128 when kWideN-wide tiles would not fill
// the SMs. 256 rather than 192 (4 ring stages instead of 3): the wider
// tile reads the x block 9 times for n = 2304 instead of 12, and the L2
// traffic, not the ring's depth, sets the pace (192 was 13% slower on the
// H100)
constexpr int kWideN = 256;

__host__ __device__ constexpr int stage_bytes(int bn) {
  return kXBytes + bn * sm90::kTileK * 2;
}
__host__ __device__ constexpr int out_bytes(int bn) { return 64 * bn * 2; }
// as many ring stages as fit beside the output staging of 64 x BN bf16
// per consumer warpgroup, at most 8: 3 at BN 256, 6 at BN 128
__host__ __device__ constexpr int stages(int bn) {
  return (sm90::kSmemLimit - 2 * out_bytes(bn)) / stage_bytes(bn) > 8
             ? 8
             : (sm90::kSmemLimit - 2 * out_bytes(bn)) / stage_bytes(bn);
}
__host__ __device__ constexpr int smem_bytes(int bn) {
  return stages(bn) * stage_bytes(bn) + 2 * out_bytes(bn) + 1024;
}

// bf16 bits to fp32, the low and the high half of a packed pair
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// A consumer thread's accumulators + bias, activation ACT, rounded to bf16
// into its warpgroup's staging: 64 x BN as BN / 64 swizzled (64, 64)
// tiles, the TMA store's layout. The accumulator of n8 block j holds
// (row r, cols 2q, 2q + 1) and (row r + 8, the same), q = lane % 4.
template <int ACT, int BN>
__device__ __forceinline__ void stage_out(const float (&acc)[BN / 2],
                                          uint8_t* st, int r,
                                          const float* __restrict__ bias,
                                          int col0, int n) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + j * 8 + (lane % 4) * 2;
    const float b0 = bias && col < n ? bias[col] : 0.f;
    const float b1 = bias && col < n ? bias[col + 1] : 0.f;
    uint8_t* tile = st + (j / 8) * 8192 + (lane % 4) * 4;
    *reinterpret_cast<uint32_t*>(tile + sm90::swz<128>(r, j % 8)) =
        pack_bf16x2(apply_act(acc[4 * j] + b0, ACT),
                    apply_act(acc[4 * j + 1] + b1, ACT));
    *reinterpret_cast<uint32_t*>(tile + sm90::swz<128>(r + 8, j % 8)) =
        pack_bf16x2(apply_act(acc[4 * j + 2] + b0, ACT),
                    apply_act(acc[4 * j + 3] + b1, ACT));
  }
}

// Persistent: one block an SM walks the output tiles tile = blockIdx.x +
// i * gridDim.x, so the tiles in flight share row blocks; the producer
// runs ahead into the next tile while the consumers finish this one.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    ln_gemm_kernel(const __grid_constant__ CUtensorMap tmap_x,
                   const __grid_constant__ CUtensorMap tmap_w,
                   const __grid_constant__ CUtensorMap tmap_out,
                   const float* __restrict__ stats,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const float* __restrict__ bias, int m, int d, int n,
                   int act, int tiles_n, int tiles) {
  constexpr int S = stages(BN), SB = stage_bytes(BN);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* staging = smem + S * SB;  // two warpgroups' output tiles
  const int ktiles = (d + sm90::kTileK - 1) / sm90::kTileK;
  const sm90::Ring ring{S};

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: one thread drives the TMA ring
    sm90::regs_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = (tile / tiles_n) * BM, col0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = ring.stage(it);
          sm90::mbar_wait(&empty[s], ring.parity(it) ^ 1u);
          uint8_t* st = smem + s * SB;
          sm90::mbar_expect_tx(&full[s], SB);
          sm90::tma_load(st, &tmap_x, &full[s], kt * sm90::kTileK, row0);
          sm90::tma_load(st + kXBytes, &tmap_w, &full[s], kt * sm90::kTileK,
                         col0);
        }
      }
    }
  } else {
    // two consumer warpgroups, 64 rows each
    sm90::regs_alloc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    const int r_wg = warp * 16 + lane / 4;  // row in the warpgroup's 64
    // ldmatrix: lanes 0-15 address rows 0-15 of the warp's 16 at the k16
    // slice's first 8 columns, lanes 16-31 at its second 8
    const int lrow = wg * 64 + warp * 16 + lane % 16, lchunk = lane / 16;
    uint8_t* my_out = staging + wg * out_bytes(BN);
    float acc[BN / 2];
    uint32_t frag[2][4][4];  // A fragments of two k tiles: one in flight
    int it = 0;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / tiles_n) * BM, col0 = (tile % tiles_n) * BN;
      const int ra = row0 + wg * 64 + r_wg, rb = ra + 8;
      // (mean, rstd) of rows a and b; rows past m read as (0, 0)
      const float2 sa = ra < m ? make_float2(stats[ra], stats[m + ra])
                               : make_float2(0.f, 0.f);
      const float2 sb = rb < m ? make_float2(stats[rb], stats[m + rb])
                               : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

      auto step = [&](int kt, auto set_c) {
        constexpr int SET = decltype(set_c)::value;
        const int s = ring.stage(it + kt);
        sm90::mbar_wait(&full[s], ring.parity(it + kt));
        const uint8_t* xs = smem + s * SB;
        const uint64_t wdesc = sm90::smem_desc(xs + kXBytes);
        const int k0 = kt * sm90::kTileK;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (k0 + ks * 16 >= d) break;  // d % 32: half of the last tile
          uint32_t r[4];
          ldmatrix_x4(r, xs + sm90::swz<128>(lrow, ks * 2 + lchunk));
          const int c = k0 + ks * 16 + (lane % 4) * 2;
          const float2 g0 = *reinterpret_cast<const float2*>(gamma + c);
          const float2 g1 = *reinterpret_cast<const float2*>(gamma + c + 8);
          const float2 b0 = *reinterpret_cast<const float2*>(beta + c);
          const float2 b1 = *reinterpret_cast<const float2*>(beta + c + 8);
          // r[0]: row a, columns c, c+1; r[1]: row b; r[2], r[3]: c+8, c+9
          frag[SET][ks][0] = pack_bf16x2(
              (bf16_lo(r[0]) - sa.x) * (sa.y * g0.x) + b0.x,
              (bf16_hi(r[0]) - sa.x) * (sa.y * g0.y) + b0.y);
          frag[SET][ks][1] = pack_bf16x2(
              (bf16_lo(r[1]) - sb.x) * (sb.y * g0.x) + b0.x,
              (bf16_hi(r[1]) - sb.x) * (sb.y * g0.y) + b0.y);
          frag[SET][ks][2] = pack_bf16x2(
              (bf16_lo(r[2]) - sa.x) * (sa.y * g1.x) + b1.x,
              (bf16_hi(r[2]) - sa.x) * (sa.y * g1.y) + b1.y);
          frag[SET][ks][3] = pack_bf16x2(
              (bf16_lo(r[3]) - sb.x) * (sb.y * g1.x) + b1.x,
              (bf16_hi(r[3]) - sb.x) * (sb.y * g1.y) + b1.y);
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (k0 + ks * 16 >= d) break;
          sm90::Wgmma<BN>::rs(acc, frag[SET][ks], sm90::desc_k(wdesc, ks));
        }
        sm90::wgmma_commit();
        // the previous k tile's products are done: its fragments may be
        // rewritten and its stage refilled
        sm90::wgmma_wait<1>();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) sm90::hold(frag[SET ^ 1][ks]);
        if (kt > 0 && leader) sm90::mbar_arrive(&empty[ring.stage(it + kt - 1)]);
      };
      for (int kt = 0; kt < ktiles; kt += 2) {
        step(kt, std::integral_constant<int, 0>{});
        if (kt + 1 < ktiles) step(kt + 1, std::integral_constant<int, 1>{});
      }
      sm90::wgmma_wait<0>();
      sm90::hold(acc);
      it += ktiles;
      if (leader) sm90::mbar_arrive(&empty[ring.stage(it - 1)]);

      // epilogue: once this warpgroup's previous TMA store has read the
      // staging, bias + activation in fp32, one rounding, into the staging;
      // then one thread stores it (the matrix clips the ragged edges)
      if (leader) sm90::bulk_wait_read();
      sm90::named_sync(1 + wg, 128);
      switch (act) {
        case ACT_TANH:
          stage_out<ACT_TANH, BN>(acc, my_out, r_wg, bias, col0, n);
          break;
        case ACT_SQRELU:
          stage_out<ACT_SQRELU, BN>(acc, my_out, r_wg, bias, col0, n);
          break;
        case ACT_GELU:
          stage_out<ACT_GELU, BN>(acc, my_out, r_wg, bias, col0, n);
          break;
        default:
          stage_out<ACT_NONE, BN>(acc, my_out, r_wg, bias, col0, n);
      }
      sm90::fence_async_cta();
      sm90::named_sync(1 + wg, 128);
      if (leader) {
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          sm90::tma_store(&tmap_out, my_out + q * 8192, col0 + q * 64,
                          row0 + wg * 64);
        sm90::bulk_commit();
      }
    }
    if (leader) sm90::bulk_wait();
  }
}

// The tile width for an (m, n) product: kWideN unless such tiles would
// leave SMs idle (ops/ln_gemm.py::ln_gemm_plan mirrors it).
int tile_n(int m, int n, int sms) {
  const long long rows = (m + BM - 1) / BM;
  return rows * ((n + kWideN - 1) / kWideN) >= sms ? kWideN : 128;
}

long long tile_count(int m, int n, int bn) {
  return static_cast<long long>((m + BM - 1) / BM) * ((n + bn - 1) / bn);
}

template <int BN>
int launch_bf16(const void* x, const float* gamma, const float* beta,
                const void* w, const float* bias, void* out, float* stats,
                int m, int d, int n, int act, float eps, int sms,
                cudaStream_t s) {
  CUtensorMap tx, tw, to;
  if (sm90::tensor_map(&tx, x, m, d, d, BM) ||
      sm90::tensor_map(&tw, w, n, d, d, BN) ||
      sm90::tensor_map(&to, out, m, n, n, 64))
    return ETK_TMAP_FAILED;
  const long long tiles = tile_count(m, n, BN);
  if (tiles > 2147483647LL) return ETK_BAD_ARGS;
  ln_gemm_stats_kernel<<<(m + 7) / 8, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), stats, m, d, eps);
  return static_cast<int>(sm90::launch_cluster(
      ln_gemm_kernel<BN>, tiles < sms ? tiles : sms, 1, kThreads,
      smem_bytes(BN), s, tx, tw, to, static_cast<const float*>(stats),
      gamma, beta, bias, m, d, n, act, (n + BN - 1) / BN,
      static_cast<int>(tiles)));
}

}  // namespace

// x, w: bf16 (m, d), (n, d); gamma, beta (d,) and bias (n,) fp32; out
// (m, n) bf16; stats: a 2 * m fp32 workspace for the row statistics. fp32
// x runs ln_gemm_f32.cu (etk_ln_gemm_f32).
ETK_API int etk_ln_gemm(const void* x, const void* gamma, const void* beta,
                        const void* w, const void* bias, void* out,
                        void* stats, int m, int d, int n, int act, float eps,
                        int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || act < ACT_NONE || act > ACT_GELU ||
      dtype != ETK_BF16 || d % 32 != 0 || n % 8 != 0 || stats == nullptr)
    return ETK_BAD_ARGS;
  auto g = static_cast<const float*>(gamma);
  auto b = static_cast<const float*>(beta);
  auto bi = static_cast<const float*>(bias);
  auto st = static_cast<float*>(stats);
  const int sms = sm_count();
  return tile_n(m, n, sms) == kWideN
             ? launch_bf16<kWideN>(x, g, b, w, bi, out, st, m, d, n, act, eps,
                                   sms, s)
             : launch_bf16<128>(x, g, b, w, bi, out, st, m, d, n, act, eps,
                                sms, s);
}

// the bf16 path's plan for an (m, n) product on this device: tile rows,
// tile columns, stages, dynamic shared memory, grid
ETK_API int etk_ln_gemm_plan(int m, int n, int* plan) {
  const int sms = sm_count();
  const int bn = tile_n(m, n, sms);
  const long long tiles = tile_count(m, n, bn);
  plan[0] = BM;
  plan[1] = bn;
  plan[2] = stages(bn);
  plan[3] = smem_bytes(bn);
  plan[4] = static_cast<int>(tiles < sms ? tiles : sms);
  return 0;
}

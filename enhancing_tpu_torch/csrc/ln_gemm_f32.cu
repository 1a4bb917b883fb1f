// Fused LayerNorm -> GEMM in fp32: y = act(LN(x) @ W^T + b), on Hopper's
// bf16 tensor cores with exact products.
//
// Replaces, for fp32 x, enhancing_tpu/ops/ln_gemm.py::_ln_gemm_kernel
// (entered through _ln_gemm_pallas), which ln_gemm.cu replaces in bf16:
// LN1 -> to_qkv and LN2 -> fc1 + act of every block of an fp32 tower, the
// frozen fp32 tokenizer under the prior's training step. Numerics as
// there: fp32 row statistics with the fast variance max(E[x^2] - mean^2,
// 0), the fp32 affine (no rounding: the compute dtype is fp32), fp32
// products summed in fp32, fp32 bias and activation. W is fp32, or bf16
// read as stored (a bf16 weight under fp32 x, which the JAX wrapper widens
// exactly). Only the order of the sums differs from JAX, and it is fixed.
//
// Every product is exact: each fp32 weight is split once a call into three
// bf16 pieces (f32_pieces.cuh's split pass; a bf16 weight is its own one
// piece), each normalised activation is split in registers into three, and
// the fp32 product is the cross terms of the pieces whose orders sum to at
// most 2 (sm90.cuh, "exact products": six with fp32 W, three with bf16 W)
// on bf16 wgmma, hi*hi in one fp32 accumulator and the small terms in
// another, folded once with a round-to-nearest add.
//
// Bound on the H100: tensor-core operations. At ViT-VQGAN-Base's qkv at
// batch 8 (M = 8192, d = 768, n = 2304) the six products are 174 GFLOP,
// 0.176 ms at 989 TFLOP/s (fp32 FMAs: 0.433 ms at 67), against 33 MB of
// fp32 x, W and output (0.010 ms).
//
// Design: ln_gemm.cu's persistent bf16 kernel. A pre-pass writes each
// row's fp32 mean and rstd. One block an SM walks 128 x 128 output tiles
// (adjacent tiles share a row block); a producer warpgroup (one thread
// issuing) streams 32-wide k slices of the raw fp32 x tile (a box of 128
// rows of 128 bytes) and of the W pieces (boxes of 128 rows of 64 bytes)
// through a TMA ring of 5 stages (8 with bf16 W) that runs ahead into the
// next tile. Two consumer warpgroups of 64 rows each read their x slice
// from shared memory in the A fragment layout, normalise it in fp32
// registers with the rows' statistics, gamma and beta, split it into the
// register-A fragments of its three bf16 pieces and issue the slice's
// wgmmas against the W pieces (N = 128), the next slice's fragments built
// while they run. Two fp32 accumulators of 64 x 128 take 128 registers a
// thread, so tiles are 128 wide and the output is stored from registers
// (fp32 bias and activation first), with no staging in shared memory.
#include <type_traits>

#include "common.cuh"
#include "f32_pieces.cuh"
#include "sm90.cuh"
#include "vec.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kXBox = kBM * kBK * 4;  // fp32 x slice: 128 rows of 128 bytes
constexpr int kWBox = kBN * kBK * 2;  // one W piece: 128 rows of 64 bytes
constexpr int kMaxStages = 8;

// a ring stage: the x slice and the slice of each of the WP W pieces
__host__ __device__ constexpr int stage_bytes(int wp) {
  return kXBox + wp * kWBox;
}
// as many stages as fit (1 KB of alignment slack), at most 8: 5 with fp32
// W (three pieces), 8 with bf16
__host__ __device__ constexpr int stages(int wp) {
  return (sm90::kSmemLimit - 1024) / stage_bytes(wp) > kMaxStages
             ? kMaxStages
             : (sm90::kSmemLimit - 1024) / stage_bytes(wp);
}
__host__ __device__ constexpr int smem_bytes(int wp) {
  return stages(wp) * stage_bytes(wp) + 1024;
}

// acc (64 x 128) += A (registers) * B^T, B one 128 x 16 slice of a W piece
__device__ __forceinline__ void product(float (&acc)[64],
                                        const uint32_t (&a)[4],
                                        const uint8_t* w_piece, int ks) {
  sm90::Wgmma<kBN>::rs(acc, a, sm90::desc_k(sm90::smem_desc<64>(w_piece), ks));
}

// one output element pair of rows `row` (< m checked here) and columns
// col, col + 1: + bias, the activation, stored
__device__ __forceinline__ void store_pair(float* __restrict__ out,
                                           const float* __restrict__ bias,
                                           int row, int col, int m, int n,
                                           int act, float v0, float v1) {
  if (row >= m || col >= n) return;
  float* o = out + static_cast<size_t>(row) * n + col;
  const float y0 = apply_act(v0 + (bias ? bias[col] : 0.f), act);
  if (col + 1 >= n) {
    o[0] = y0;
    return;
  }
  const float y1 = apply_act(v1 + (bias ? bias[col + 1] : 0.f), act);
  if (n % 2 == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
  } else {
    o[0] = y0;
    o[1] = y1;
  }
}

// Persistent: one block an SM walks the output tiles tile = blockIdx.x +
// i * gridDim.x; WP W pieces (3: fp32 W, 1: bf16 W), in `tmap_w` as (WP,
// n, d) bf16.
template <int WP>
__global__ void __launch_bounds__(kThreads, 1)
    ln_gemm_f32_kernel(const __grid_constant__ CUtensorMap tmap_x,
                       const __grid_constant__ CUtensorMap tmap_w,
                       const float* __restrict__ stats,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int m, int d, int n, int act,
                       int tiles_n, int tiles) {
  constexpr int S = stages(WP), SB = stage_bytes(WP);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  uint8_t* smem = sm90::align_1024(smem_raw);
  const int ktiles = (d + kBK - 1) / kBK;
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
        const int row0 = (tile / tiles_n) * kBM, col0 = (tile % tiles_n) * kBN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = ring.stage(it);
          sm90::mbar_wait(&empty[s], ring.parity(it) ^ 1u);
          uint8_t* st = smem + s * SB;
          sm90::mbar_expect_tx(&full[s], SB);
          sm90::tma_load(st, &tmap_x, &full[s], kt * kBK, row0);
#pragma unroll
          for (int p = 0; p < WP; ++p)
            sm90::tma_load_3d(st + kXBox + p * kWBox, &tmap_w, &full[s],
                              kt * kBK, col0, p);
        }
      }
    }
    return;
  }

  // two consumer warpgroups, 64 rows each
  sm90::regs_alloc<232>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const int r_wg = warp * 16 + lane / 4;  // row in the warpgroup's 64
  const int lrow = wg * 64 + r_wg;        // row a in the tile; b = a + 8
  float big[kBN / 2], small[kBN / 2];
  // the pieces' A fragments of two stages (one in flight), two k16 slices
  // a stage
  uint32_t frag[2][2][3][4];
  int it = 0;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (tile / tiles_n) * kBM, col0 = (tile % tiles_n) * kBN;
    const int ra = row0 + lrow, rb = ra + 8;
    // (mean, rstd) of rows a and b; rows past m read as (0, 0)
    const float2 sa = ra < m ? make_float2(stats[ra], stats[m + ra])
                             : make_float2(0.f, 0.f);
    const float2 sb = rb < m ? make_float2(stats[rb], stats[m + rb])
                             : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) big[i] = small[i] = 0.f;

    auto step = [&](int kt, auto set_c) {
      constexpr int SET = decltype(set_c)::value;
      const int s = ring.stage(it + kt);
      sm90::mbar_wait(&full[s], ring.parity(it + kt));
      const uint8_t* xs = smem + s * SB;
      const uint8_t* ws = xs + kXBox;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        // columns c, c + 1 and c + 8, c + 9 of the slice (d % 16 == 0: a
        // k16 slice lies in x or past it, and past it is 0)
        const int c = kt * kBK + ks * 16 + 2 * q;
        float v[4][2] = {};  // (a, c), (b, c), (a, c + 8), (b, c + 8)
        if (c < d) {
          const float2 g0 = *reinterpret_cast<const float2*>(gamma + c);
          const float2 g1 = *reinterpret_cast<const float2*>(gamma + c + 8);
          const float2 b0 = *reinterpret_cast<const float2*>(beta + c);
          const float2 b1 = *reinterpret_cast<const float2*>(beta + c + 8);
          const int chunk = ks * 4 + q / 2, off = (q % 2) * 8;
          const float2 xa0 = *reinterpret_cast<const float2*>(
              xs + sm90::swz<128>(lrow, chunk) + off);
          const float2 xb0 = *reinterpret_cast<const float2*>(
              xs + sm90::swz<128>(lrow + 8, chunk) + off);
          const float2 xa1 = *reinterpret_cast<const float2*>(
              xs + sm90::swz<128>(lrow, chunk + 2) + off);
          const float2 xb1 = *reinterpret_cast<const float2*>(
              xs + sm90::swz<128>(lrow + 8, chunk + 2) + off);
          v[0][0] = (xa0.x - sa.x) * (sa.y * g0.x) + b0.x;
          v[0][1] = (xa0.y - sa.x) * (sa.y * g0.y) + b0.y;
          v[1][0] = (xb0.x - sb.x) * (sb.y * g0.x) + b0.x;
          v[1][1] = (xb0.y - sb.x) * (sb.y * g0.y) + b0.y;
          v[2][0] = (xa1.x - sa.x) * (sa.y * g1.x) + b1.x;
          v[2][1] = (xa1.y - sa.x) * (sa.y * g1.y) + b1.y;
          v[3][0] = (xb1.x - sb.x) * (sb.y * g1.x) + b1.x;
          v[3][1] = (xb1.y - sb.x) * (sb.y * g1.y) + b1.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float lo[3], hi[3];
          sm90::bf16_pieces(v[e][0], lo);
          sm90::bf16_pieces(v[e][1], hi);
#pragma unroll
          for (int p = 0; p < 3; ++p)
            frag[SET][ks][p][e] = pack_bf16x2(lo[p], hi[p]);
        }
      }
      // every fragment written before the fence, none between it and the
      // products (C7513)
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
        for (int p = 0; p < 3; ++p) sm90::hold(frag[SET][ks][p]);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const uint32_t (&f)[3][4] = frag[SET][ks];
        if constexpr (WP == 3) {
          product(big, f[0], ws, ks);
#pragma unroll
          for (int i = 0; i < 5; ++i)
            product(small, f[sm90::small_a(i)],
                    ws + sm90::small_b(i) * kWBox, ks);
        } else {
          product(big, f[0], ws, ks);
          product(small, f[1], ws, ks);
          product(small, f[2], ws, ks);
        }
      }
      sm90::wgmma_commit();
      // the previous stage's products are done: its fragments may be
      // rewritten and its stage refilled
      sm90::wgmma_wait<1>();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
        for (int p = 0; p < 3; ++p) sm90::hold(frag[SET ^ 1][ks][p]);
      if (kt > 0 && leader) sm90::mbar_arrive(&empty[ring.stage(it + kt - 1)]);
    };
    for (int kt = 0; kt < ktiles; kt += 2) {
      step(kt, std::integral_constant<int, 0>{});
      if (kt + 1 < ktiles) step(kt + 1, std::integral_constant<int, 1>{});
    }
    sm90::wgmma_wait<0>();
    sm90::hold(big);
    sm90::hold(small);
    it += ktiles;
    if (leader) sm90::mbar_arrive(&empty[ring.stage(it - 1)]);

    // the small terms folded into hi*hi once, then + bias and the
    // activation in fp32, stored from registers: n8 block j holds columns
    // col0 + 8j + 2q (+ 1) of rows a and b
    fold(big, big, small);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col0 + 8 * j + 2 * q;
      store_pair(out, bias, ra, col, m, n, act, big[4 * j], big[4 * j + 1]);
      store_pair(out, bias, rb, col, m, n, act, big[4 * j + 2],
                 big[4 * j + 3]);
    }
  }
}

long long tile_count(int m, int n) {
  return static_cast<long long>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
}

template <int WP>
int launch(const void* x, const float* gamma, const float* beta,
           const void* w_pieces, const float* bias, float* out, float* stats,
           int m, int d, int n, int act, float eps, cudaStream_t s) {
  CUtensorMap tx, tw;
  if (sm90::tensor_map_128b(&tx, x, m, d, 4, kBM) ||
      sm90::tensor_map_3d(&tw, w_pieces, WP, n, d, d,
                          static_cast<long long>(n) * d, kBN, kBK))
    return ETK_TMAP_FAILED;
  const long long tiles = tile_count(m, n);
  if (tiles > 2147483647LL) return ETK_BAD_ARGS;
  const int sms = sm_count();
  ln_gemm_stats_kernel<<<(m + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(x), stats, m, d, eps);
  return static_cast<int>(sm90::launch_cluster(
      ln_gemm_f32_kernel<WP>, tiles < sms ? tiles : sms, 1, kThreads,
      smem_bytes(WP), s, tx, tw, static_cast<const float*>(stats), gamma,
      beta, bias, out, m, d, n, act, (n + kBN - 1) / kBN,
      static_cast<int>(tiles)));
}

}  // namespace

// x fp32 (m, d); w (n, d) fp32 (w_dtype ETK_F32) or bf16 (ETK_BF16);
// gamma, beta (d,) and bias (n,) fp32; out fp32 (m, n); all contiguous and
// 16-byte aligned, d % 16 == 0. stats: a 2 * m fp32 workspace for the row
// statistics; pieces: bf16 scratch of 3 n d elements for fp32 W's pieces
// (unused with bf16 W). Two launches (bf16 W) or three (fp32 W: the split
// pass first).
ETK_API int etk_ln_gemm_f32(const void* x, const void* gamma,
                            const void* beta, const void* w, const void* bias,
                            void* out, void* stats, void* pieces, int m,
                            int d, int n, int act, float eps, int w_dtype,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || d <= 0 || d % 16 != 0 || act < ACT_NONE ||
      act > ACT_GELU || stats == nullptr ||
      (w_dtype != ETK_F32 && w_dtype != ETK_BF16) ||
      (w_dtype == ETK_F32 && pieces == nullptr))
    return ETK_BAD_ARGS;
  auto g = static_cast<const float*>(gamma);
  auto b = static_cast<const float*>(beta);
  auto bi = static_cast<const float*>(bias);
  auto st = static_cast<float*>(stats);
  auto o = static_cast<float*>(out);
  if (w_dtype == ETK_BF16)
    return launch<1>(x, g, b, w, bi, o, st, m, d, n, act, eps, s);
  SplitArgs sa{};
  sa.set(0, w, static_cast<__nv_bfloat16*>(pieces), Strides{0, 0, d}, 1, n,
         1, d);
  const int rc = launch_split(sa, 1, s);
  if (rc) return rc;
  return launch<3>(x, g, b, pieces, bi, o, st, m, d, n, act, eps, s);
}

// the plan of an (m, d) x (n, d) product with w_pieces W pieces (3: fp32
// W, 1: bf16 W) on this device: tile rows, tile columns, k a stage,
// stages, dynamic shared memory, grid (ops/ln_gemm.py::ln_gemm_f32_plan
// mirrors it)
ETK_API int etk_ln_gemm_f32_plan(int m, int d, int n, int w_pieces,
                                 int* plan) {
  if (m <= 0 || n <= 0 || d <= 0 || d % 16 != 0 ||
      (w_pieces != 1 && w_pieces != 3))
    return ETK_BAD_ARGS;
  const int sms = sm_count();
  const long long tiles = tile_count(m, n);
  const bool three = w_pieces == 3;
  plan[0] = kBM;
  plan[1] = kBN;
  plan[2] = kBK;
  plan[3] = three ? stages(3) : stages(1);
  plan[4] = three ? smem_bytes(3) : smem_bytes(1);
  plan[5] = static_cast<int>(tiles < sms ? tiles : sms);
  return 0;
}

// Nearest codebook row: idx[i] = argmin_j (|e_j|^2 - 2 z_i . e_j).
//
// Replaces enhancing_tpu/ops/vq.py::_vq_kernel (entered through
// _nearest_pallas). The |z|^2 term is dropped (constant per row), scores
// are fp32, ties go to the lowest index, and the (M, n) score matrix never
// exists: each warpgroup keeps a running (min, index) pair per query row
// while codebook tiles pass through shared memory.
//
// Every product is exact on Hopper's bf16 tensor cores: the codebook is
// split once a call into three bf16 pieces (hi + mid + lo is each fp32
// value exactly; sm90.cuh, "exact products") by a split pass that also
// writes |e_j|^2 in fp32, and each query row is split the same way into
// shared memory; z . e is the six cross terms of the pieces whose orders
// sum to at most 2, hi*hi in one fp32 accumulator and the five small
// terms in another, folded once with a round-to-nearest add, so the score
// is the fp32 product to within the terms below 2^-24 of it.
//
// Bound on the H100: tensor-core operations. At batch 128 (M = 131 072
// rows, n = 8192 codes, D = 32) the 2 M n D flops are 68.7 GFLOP, six bf16
// products of them 0.417 ms at 989 TFLOP/s (fp32 FMAs: 1.026 ms at 67),
// against 17 MB of z, codebook and indices (0.005 ms).
//
// Design: a producer warpgroup (one thread issuing) streams the codebook's
// pieces in tiles of 128 codes (three TMA boxes of 128 rows of D bf16,
// 64- or 128-byte swizzle) and their |e|^2 (a bulk copy) through a ring
// of stages. Two consumer warpgroups own 64 or 128 rows each (one or two
// m64 row tiles, RT), split their rows of z into pieces once, into
// shared memory as K-major wgmma A operands, and for every stage and row
// tile issue twelve shared-memory wgmmas (m64 n128 k16: hi*hi and the five
// small terms, D / 16 slices each), wait, and scan the accumulators in
// registers: s = |e|^2 - 2 (hi*hi + small) with a strict '<' over
// increasing code index. One warpgroup's scan overlaps the other's
// products. After the last stage the four lanes that share a row reduce
// their pairs lexicographically (value, then index), which keeps the
// lowest index among equal minima. Codes past n are padding the split
// pass writes as zero pieces with |e|^2 = +inf, so they never win; D = 16
// runs as 32 with zero columns. RT is 2 at D <= 32 when that still gives
// every SM a block (the codebook's L2 traffic halves), else 1.
#include <climits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NP = sm90::kPieces;
constexpr int kCodes = 128;  // codes a ring stage: the products' N
constexpr int kRows = 64;    // rows of one row tile: the products' M
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kMaxStages = 4;

// D padded to the products' K (a multiple of 32: one 64-byte swizzle row)
__host__ __device__ constexpr int padded(int d) { return d < 32 ? 32 : d; }

template <int DP>
struct Geo {
  static constexpr int RB = DP * 2;         // bytes a row: 64 or 128
  static constexpr int KS = DP / 16;        // k16 slices
  static constexpr int ZTILE = kRows * RB;  // one piece of a row tile
  static constexpr int ETILE = kCodes * RB;  // one piece of a stage
  // the bytes a stage loads (three pieces, then |e|^2), and its room in
  // the ring (each stage's pieces start on a 1024-byte swizzle atom)
  static constexpr int LOAD = NP * ETILE + kCodes * 4;
  static constexpr int STAGE = (LOAD + 1023) / 1024 * 1024;
};

template <int DP, int RT>
__host__ __device__ constexpr int z_bytes() {
  return 2 * RT * NP * Geo<DP>::ZTILE;
}
// as many stages as fit (1 KB of alignment slack), at most 4 (measured
// faster than 7 at batch 128, and two 64-row tiles consume a stage)
template <int DP, int RT>
__host__ __device__ constexpr int stages() {
  return (sm90::kSmemLimit - z_bytes<DP, RT>() - 1024) / Geo<DP>::STAGE >
                 kMaxStages
             ? kMaxStages
             : (sm90::kSmemLimit - z_bytes<DP, RT>() - 1024) / Geo<DP>::STAGE;
}
template <int DP, int RT>
__host__ __device__ constexpr int smem_bytes() {
  return z_bytes<DP, RT>() + stages<DP, RT>() * Geo<DP>::STAGE + 1024;
}

// The split pass: codebook (n, d) fp32 -> pieces (3, n_pad, dp) bf16, zero
// past d and past n, and |e|^2 (n_pad) fp32, +inf past n; one thread a
// code, squares added in column order.
__global__ void __launch_bounds__(256)
    vq_split_kernel(const float* __restrict__ cb,
                    __nv_bfloat16* __restrict__ pieces,
                    float* __restrict__ esq, int n, int n_pad, int d,
                    int dp) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_pad) return;
  const size_t plane = static_cast<size_t>(n_pad) * dp;
  float sum = 0.f;
  for (int c = 0; c < dp; c += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n && c < d)
      v = *reinterpret_cast<const float4*>(cb + static_cast<size_t>(row) * d +
                                           c);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t w[NP][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float lo[3], hi[3];
      sm90::bf16_pieces(x[2 * j], lo);
      sm90::bf16_pieces(x[2 * j + 1], hi);
#pragma unroll
      for (int p = 0; p < NP; ++p) w[p][j] = pack_bf16x2(lo[p], hi[p]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sum = __fadd_rn(sum, __fmul_rn(x[e], x[e]));
#pragma unroll
    for (int p = 0; p < NP; ++p)
      *reinterpret_cast<uint2*>(pieces + p * plane +
                                static_cast<size_t>(row) * dp + c) =
          make_uint2(w[p][0], w[p][1]);
  }
  esq[row] = row < n ? sum : INFINITY;
}

// acc (64 x 128) = or += A * B^T over k16 slice ks: A a row tile's piece,
// B a stage's piece, both K-major in shared memory
template <int DP>
__device__ __forceinline__ void product(float (&acc)[64], const uint8_t* a,
                                        const uint8_t* b, int ks,
                                        int accumulate) {
  constexpr int RB = Geo<DP>::RB;
  sm90::Wgmma<kCodes>::ss(acc, sm90::desc_k(sm90::smem_desc<RB>(a), ks),
                          sm90::desc_k(sm90::smem_desc<RB>(b), ks),
                          accumulate);
}

// (v, i) becomes the lower of itself and (vo, io): value, then index
__device__ __forceinline__ void lower(float& v, int& i, float vo, int io) {
  if (vo < v || (vo == v && io < i)) {
    v = vo;
    i = io;
  }
}

template <int DP, int RT>
__global__ void __launch_bounds__(kThreads, 1)
    vq_nearest_kernel(const __grid_constant__ CUtensorMap tmap_e,
                      const float* __restrict__ esq,
                      const float* __restrict__ z, int* __restrict__ idx,
                      int m, int d, int tiles) {
  using G = Geo<DP>;
  constexpr int S = stages<DP, RT>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* ring_mem = smem + z_bytes<DP, RT>();
  const sm90::Ring ring{S};

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers / 32);  // one arrival a warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: one thread drives the TMA ring
    sm90::regs_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      for (int t = 0; t < tiles; ++t) {
        const int s = ring.stage(t);
        sm90::mbar_wait(&empty[s], ring.parity(t) ^ 1u);
        uint8_t* st = ring_mem + s * G::STAGE;
        sm90::mbar_expect_tx(&full[s], G::LOAD);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          sm90::tma_load_3d(st + p * G::ETILE, &tmap_e, &full[s], 0,
                            t * kCodes, p);
        sm90::bulk_load(st + NP * G::ETILE,
                        esq + static_cast<size_t>(t) * kCodes, kCodes * 4,
                        &full[s]);
      }
    }
    return;
  }

  // two consumer warpgroups, RT row tiles of 64 rows each
  sm90::regs_alloc<232>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * 2 + wg) * RT * kRows;
  uint8_t* zw = smem + wg * RT * NP * G::ZTILE;

  // this warpgroup's rows of z as three pieces, each row tile a K-major
  // wgmma A operand (16-byte chunks swizzled as a TMA box of RB-byte rows)
  constexpr int CH = DP / 8;
  for (int i = tid; i < RT * kRows * CH; i += 128) {
    const int rt = i / (kRows * CH), r = (i / CH) % kRows, ch = i % CH;
    const long long row = row0 + rt * kRows + r;
    float v[8] = {};
    if (row < m && ch * 8 < d) {
      const float4* src = reinterpret_cast<const float4*>(z + row * d) + ch * 2;
      const float4 a = src[0], b = src[1];
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    }
    uint32_t w[NP][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lo[3], hi[3];
      sm90::bf16_pieces(v[2 * e], lo);
      sm90::bf16_pieces(v[2 * e + 1], hi);
#pragma unroll
      for (int p = 0; p < NP; ++p) w[p][e] = pack_bf16x2(lo[p], hi[p]);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
      *reinterpret_cast<uint4*>(zw + (rt * NP + p) * G::ZTILE +
                                sm90::swz<G::RB>(r, ch)) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  }
  sm90::fence_async_cta();
  sm90::named_sync(1 + wg, 128);

  // best[rt][h]: the least score of the thread's row r + 8 h of row tile
  // rt so far, at code index at[rt][h]
  float best[RT][2];
  int at[RT][2];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[rt][h] = INFINITY;
      at[rt][h] = INT_MAX;
    }
  float big[64], small[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) big[i] = small[i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int s = ring.stage(t);
    sm90::mbar_wait(&full[s], ring.parity(t));
    const uint8_t* st = ring_mem + s * G::STAGE;
    const float* es = reinterpret_cast<const float*>(st + NP * G::ETILE);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      const uint8_t* za = zw + rt * NP * G::ZTILE;
      sm90::hold(big);
      sm90::hold(small);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < G::KS; ++ks) {
        product<DP>(big, za, st, ks, ks > 0);
#pragma unroll
        for (int i = 0; i < 5; ++i)
          product<DP>(small, za + sm90::small_a(i) * G::ZTILE,
                      st + sm90::small_b(i) * G::ETILE, ks, ks > 0 || i > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::hold(big);
      sm90::hold(small);
      // n8 block j holds codes 8 j + 2 q (+ 1) of rows r and r + 8: each
      // row's codes scanned in increasing order
      const int c0 = t * kCodes + 2 * q;
#pragma unroll
      for (int j = 0; j < kCodes / 8; ++j) {
        const float2 e = *reinterpret_cast<const float2*>(es + 8 * j + 2 * q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 4 * j + 2 * h;
          const float s0 =
              __fmaf_rn(-2.f, __fadd_rn(small[k], big[k]), e.x);
          const float s1 =
              __fmaf_rn(-2.f, __fadd_rn(small[k + 1], big[k + 1]), e.y);
          if (s0 < best[rt][h]) {
            best[rt][h] = s0;
            at[rt][h] = c0 + 8 * j;
          }
          if (s1 < best[rt][h]) {
            best[rt][h] = s1;
            at[rt][h] = c0 + 8 * j + 1;
          }
        }
      }
    }
    // this warp has read the stage (the products completed at its wait)
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // the four lanes of a row hold its codes 2 q, 2 q + 1 mod 8
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best[rt][h];
      int i = at[rt][h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        lower(v, i, __shfl_xor_sync(0xffffffffu, v, o),
              __shfl_xor_sync(0xffffffffu, i, o));
      const long long row = row0 + rt * kRows + warp * 16 + lane / 4 + 8 * h;
      if (q == 0 && row < m) idx[row] = i == INT_MAX ? 0 : i;
    }
}

int pad_codes(int n) { return (n + kCodes - 1) / kCodes * kCodes; }

// row tiles a warpgroup: two at D <= 32 when that still gives every SM a
// block (at D = 64 two tiles' stages leave two in the ring, and ptxas
// spills)
int row_tiles(int m, int dp) {
  const long long blocks2 = (static_cast<long long>(m) + 4 * kRows - 1) /
                            (4 * kRows);
  return dp == 32 && blocks2 >= (sm_count() > 0 ? sm_count() : 132) ? 2 : 1;
}

template <int DP, int RT>
int launch(const void* z, const __nv_bfloat16* pieces, const float* esq,
           void* idx, int m, int d, int n_pad, cudaStream_t s) {
  CUtensorMap tmap;
  if (sm90::tensor_map_3d(&tmap, pieces, NP, n_pad, DP, DP,
                          static_cast<long long>(n_pad) * DP, kCodes, DP))
    return ETK_TMAP_FAILED;
  const long long rows = 2LL * RT * kRows;
  return static_cast<int>(sm90::launch_cluster(
      vq_nearest_kernel<DP, RT>, (m + rows - 1) / rows, 1, kThreads,
      smem_bytes<DP, RT>(), s, tmap, esq, static_cast<const float*>(z),
      static_cast<int*>(idx), m, d, n_pad / kCodes));
}


}  // namespace

// z (m, d) and codebook (n, d) fp32, contiguous and 16-byte aligned, d in
// {16, 32, 64}; idx (m,) int32. scratch: bf16 pieces (3, n_pad, max(d,
// 32)) then fp32 |e|^2 (n_pad), n_pad = n rounded up to 128 (vq.py's
// vq_scratch_bytes). Two launches: the split pass, then the search.
ETK_API int etk_vq_nearest(const void* z, const void* codebook,
                           void* scratch, void* idx, int m, int n, int d,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || scratch == nullptr || (d != 16 && d != 32 && d != 64))
    return ETK_BAD_ARGS;
  const int n_pad = pad_codes(n), dp = padded(d);
  auto pieces = static_cast<__nv_bfloat16*>(scratch);
  auto esq = reinterpret_cast<float*>(pieces + static_cast<size_t>(NP) *
                                                   n_pad * dp);
  vq_split_kernel<<<(n_pad + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(codebook), pieces, esq, n, n_pad, d, dp);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  if (dp == 64) return launch<64, 1>(z, pieces, esq, idx, m, d, n_pad, s);
  return row_tiles(m, dp) == 2
             ? launch<32, 2>(z, pieces, esq, idx, m, d, n_pad, s)
             : launch<32, 1>(z, pieces, esq, idx, m, d, n_pad, s);
}

// the plan of a search of m rows over n codes of d on this device: padded
// d, row tiles a warpgroup, stages, dynamic shared memory, grid, codebook
// tiles (ops/vq.py::vq_plan mirrors it)
ETK_API int etk_vq_plan(int m, int n, int d, int* plan) {
  if (m <= 0 || n <= 0 || (d != 16 && d != 32 && d != 64)) return ETK_BAD_ARGS;
  const int dp = padded(d), rt = row_tiles(m, dp);
  plan[0] = dp;
  plan[1] = rt;
  plan[2] = dp == 64 ? stages<64, 1>()
                     : (rt == 2 ? stages<32, 2>() : stages<32, 1>());
  plan[3] = dp == 64 ? smem_bytes<64, 1>()
                     : (rt == 2 ? smem_bytes<32, 2>() : smem_bytes<32, 1>());
  plan[4] = static_cast<int>((static_cast<long long>(m) + 2 * rt * kRows - 1) /
                             (2 * rt * kRows));
  plan[5] = pad_codes(n) / kCodes;
  return 0;
}

// Single-pass LayerNorm: y = (x - mean) * (rstd * gamma) + beta.
//
// Replaces enhancing_tpu/ops/ln_gemm.py::_ln_kernel (the final LayerNorm of
// each ViT stack, and LN2 of every block on the fused serving path).
// Numerics as there: fp32 statistics with the fast variance
// max(E[x^2] - mean^2, 0), eps added inside rsqrt, fp32 affine, one
// rounding to the output dtype.
//
// Bound on the H100: bytes. It does ~8 flops per element against 4 bytes
// moved (bf16 in and out), far below the ~295 flop/byte ridge, so the
// floor is 2 * M * d * sizeof(T) over 3.35 TB/s (0.120 ms at the main
// path's 131072 x 768 bf16). The design moves those bytes and little else:
// - a persistent grid (three blocks an SM where they fit) in which each
//   block walks one contiguous run of row tiles (8 rows, or more for
//   narrow rows: at least 8 KB a tile);
// - a producer warp brings each tile into shared memory with one bulk
//   copy (cp.async.bulk) through a 2-4 stage mbarrier ring, so ~100 KB of
//   rows are in flight per SM while the consumers work, and the ragged
//   last tile is a shorter copy;
// - eight consumer warps own a row each: one pass over the staged row for
//   the two sums (warp shuffles), a second for the affine, which leaves as
//   16-byte streaming stores (L2 need not keep them) while the next tiles
//   land;
// - gamma and beta are staged once per block, fp32, as 16-byte vectors in
//   the order the lanes read them (no reloads per element, no bank
//   conflicts); no register holds a whole row, so the kernel takes any d
//   up to 2048 at a few dozen registers a thread.
#include "common.cuh"
#include "sm90.cuh"
#include "vec.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kMaxD = 2048;
constexpr int kMaxStages = 4;
constexpr int kBlocksPerSm = 3;
constexpr int kTileTarget = 8192;   // bytes a tile at least (<= 8 rows a warp)
constexpr int kRingBudget = 98304;  // bytes of ring a block, at most

// The launch for an (m, d) LayerNorm of itemsize-byte elements on `sms`
// SMs (ops/ln_gemm.py::layernorm_plan mirrors it): rows a tile, ring
// stages, dynamic shared memory, grid.
struct Plan {
  int rows, stages, smem, grid;
};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

Plan make_plan(int m, int d, int itemsize, int sms) {
  const int row_bytes = d * itemsize;
  const int per_warp =
      clampi(kTileTarget / (kConsumerWarps * row_bytes), 1, 8);
  Plan p;
  p.rows = kConsumerWarps * per_warp;
  const int tile_bytes = p.rows * row_bytes;
  p.stages = clampi(kRingBudget / tile_bytes, 2, kMaxStages);
  p.smem = p.stages * tile_bytes + 2 * d * 4;  // the ring, gamma and beta
  // blocks that fit an SM's 228 KB of shared memory (1 KB reserved a
  // block, and the barriers), at most kBlocksPerSm
  const int per_sm = clampi(233472 / (p.smem + 2048), 1, kBlocksPerSm);
  const int tiles = (m + p.rows - 1) / p.rows;
  const long long cap = static_cast<long long>(sms) * per_sm;
  p.grid = static_cast<int>(tiles < cap ? tiles : cap);
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ out,
                     int m, int d, float eps, int rows_per_tile, int stages) {
  constexpr int V = Vec<T>::N;
  constexpr int P = V / 4;  // float4 planes of a vector's gamma (and beta)
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const int nvec = d / V;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int tile_bytes = rows_per_tile * row_bytes;
  // gamma then beta, plane p of vector v at [p * nvec + v]
  float4* gb = reinterpret_cast<float4*>(smem + stages * tile_bytes);
  const int tiles = (m + rows_per_tile - 1) / rows_per_tile;
  const int t0 = static_cast<int>(static_cast<long long>(tiles) * blockIdx.x /
                                  gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(tiles) *
                                  (blockIdx.x + 1) / gridDim.x);
  const sm90::Ring ring{stages};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_mbar_init();
  }
  if (warp < kConsumerWarps) {
    float* gbf = reinterpret_cast<float*>(gb);
    for (int c = threadIdx.x; c < d; c += kConsumerWarps * 32) {
      const int v = c / V, p = (c % V) / 4, j = c % 4;
      gbf[(p * nvec + v) * 4 + j] = gamma[c];
      gbf[((P + p) * nvec + v) * 4 + j] = beta[c];
    }
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one bulk copy a tile (the rows are contiguous)
    if (lane == 0) {
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int s = ring.stage(i);
        sm90::mbar_wait(&empty[s], ring.parity(i) ^ 1u);
        const int rows = min(rows_per_tile, m - t * rows_per_tile);
        sm90::mbar_expect_tx(&full[s], rows * row_bytes);
        sm90::bulk_load(smem + s * tile_bytes,
                        x + static_cast<size_t>(t) * rows_per_tile * d,
                        rows * row_bytes, &full[s]);
      }
    }
    return;
  }

  for (int t = t0, i = 0; t < t1; ++t, ++i) {
    const int s = ring.stage(i);
    sm90::mbar_wait(&full[s], ring.parity(i));
    const int rows = min(rows_per_tile, m - t * rows_per_tile);
    const T* tile = reinterpret_cast<const T*>(smem + s * tile_bytes);
    for (int r = warp; r < rows; r += kConsumerWarps) {
      const T* xr = tile + r * d;
      float sum = 0.f, sq = 0.f;
#pragma unroll 4
      for (int v = lane; v < nvec; v += 32) {
        float a[V];
        Vec<T>::load(xr + v * V, a);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sum += a[j];
          sq += a[j] * a[j];
        }
      }
      sum = warp_sum(sum);
      sq = warp_sum(sq);
      const float mean = sum / d;
      const float var = fmaxf(sq / d - mean * mean, 0.f);
      const float rstd = rsqrtf(var + eps);
      T* orow = out + (static_cast<size_t>(t) * rows_per_tile + r) * d;
#pragma unroll 2
      for (int v = lane; v < nvec; v += 32) {
        float a[V], y[V];
        Vec<T>::load(xr + v * V, a);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float4 g = gb[p * nvec + v], b = gb[(P + p) * nvec + v];
          y[4 * p] = (a[4 * p] - mean) * (rstd * g.x) + b.x;
          y[4 * p + 1] = (a[4 * p + 1] - mean) * (rstd * g.y) + b.y;
          y[4 * p + 2] = (a[4 * p + 2] - mean) * (rstd * g.z) + b.z;
          y[4 * p + 3] = (a[4 * p + 3] - mean) * (rstd * g.w) + b.w;
        }
        Vec<T>::store(orow + v * V, y);
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out,
           int m, int d, float eps, cudaStream_t stream) {
  if (m <= 0 || d <= 0 || d % Vec<T>::N != 0 || d > kMaxD ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return ETK_BAD_ARGS;
  const int sms = sm_count();
  if (sms <= 0) return ETK_BAD_ARGS;
  const Plan p = make_plan(m, d, sizeof(T), sms);
  return static_cast<int>(sm90::launch_cluster(
      layernorm_kernel<T>, p.grid, 1, kThreads, p.smem, stream,
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), m, d, eps,
      p.rows, p.stages));
}

}  // namespace

ETK_API int etk_layernorm(const void* x, const void* gamma, const void* beta,
                          void* out, int m, int d, float eps, int dtype,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ETK_BF16)
    return launch<__nv_bfloat16>(x, gamma, beta, out, m, d, eps, s);
  if (dtype == ETK_F32) return launch<float>(x, gamma, beta, out, m, d, eps, s);
  return ETK_BAD_ARGS;
}

// the launch for an (m, d) LayerNorm of itemsize-byte elements on this
// device, as ops.ln_gemm.layernorm_plan mirrors it: rows a tile, ring
// stages, bytes of dynamic shared memory, grid
ETK_API int etk_layernorm_plan(int m, int d, int itemsize, int* out) {
  if (m <= 0 || d <= 0 || d > kMaxD || (itemsize != 2 && itemsize != 4) ||
      d % (16 / itemsize) != 0 || sm_count() <= 0)
    return ETK_BAD_ARGS;
  const Plan p = make_plan(m, d, itemsize, sm_count());
  out[0] = p.rows;
  out[1] = p.stages;
  out[2] = p.smem;
  out[3] = p.grid;
  return 0;
}

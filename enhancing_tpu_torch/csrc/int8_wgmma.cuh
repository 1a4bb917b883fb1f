// Int8-weight products of the decode step's few rows on Hopper's tensor
// cores, with every product exact in fp32: the core of the one-launch int8
// decode MLP (B14, int8_mlp.cu), kept apart so that the int8 GEMM (B12)
// and the int8 LN GEMM (B13) can move onto it.
//
//   y[r, n] = sum_k a[r, k] * W[n, k]   for a tile of 8 activation rows r
//
// Why the tensor cores can compute the fp32 products of the JAX function:
// - every int8 weight is exact in bf16 (8 significant bits);
// - every fp32 activation a is the exact sum of three bf16 pieces, hi =
//   bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid) (split_pieces);
//   a bf16 activation is its own single piece;
// - a weight times a piece has at most 16 significant bits, exact in fp32,
//   so wgmma with fp32 accumulators forms the same products as fp32 FMAs
//   and only the order of the sum differs.
// The weights are the A operand (64 output channels a warpgroup, the
// wgmma's M), the pieces the B operand: N = 8 rows x P pieces (24 for
// fp32 activations, 8 for bf16), K-major in shared memory.
//
// Bound on the H100: bytes (the weights). The design spends few
// instructions a weight:
// - the TMA brings a (channels, 128 k) int8 box, swizzled in 128-byte rows,
//   and each thread reads its A fragment rows as one 32-bit word per k16
//   slice (bank-conflict free under the swizzle);
// - a sum over K has no order, so K is permuted alike in the weights and in
//   the staged pieces: within each 16-wide k group the thread of fragment
//   column pair q reads the 4 consecutive bytes 4q..4q+3, which are the
//   fragment's columns 2q, 2q+1, 2q+8, 2q+9 (perm_col);
// - four int8 become two bf16 pairs with one XOR, four byte permutes and
//   four fp32 subtractions (the byte in the mantissa of 2^23, then 2^23 +
//   128 subtracted: exact) and two byte permutes that keep the upper
//   halves, which hold the bf16 exactly (widen4): ~2.75 instructions a
//   weight;
// - each stage's wgmmas start a fresh fp32 accumulator, which is added into
//   the running sum with round-to-nearest fp32 adds, so the tensor cores'
//   own accumulation spans 128 k at most.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"
#include "vec.cuh"

namespace i8w {

constexpr int kRows = 8;     // activation rows a tile
constexpr int kTileN = 64;   // output channels a warpgroup (wgmma M)
constexpr int kChunk = 128;  // k a stage: one 128-byte row of int8
constexpr int kSlices = kChunk / 16;

// bf16 pieces of an activation of type XT
template <typename XT>
struct Pieces;
template <>
struct Pieces<float> {
  static constexpr int P = 3;
};
template <>
struct Pieces<__nv_bfloat16> {
  static constexpr int P = 1;
};

using cvt::from_f32;
using cvt::ld4;
using cvt::ld4_any;
using cvt::ln_one;
using cvt::load_any;
using cvt::mix_one;
using cvt::round_to;
using cvt::st4;

// a = pieces[0] + pieces[1] + ... exactly (fp32 a, P = 3), each piece the
// bf16 nearest to what the earlier ones leave
template <int P>
__device__ __forceinline__ void split_pieces(float a,
                                             __nv_bfloat16 (&pieces)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pieces[p] = __float2bfloat16_rn(a);
    a = __fsub_rn(a, __bfloat162float(pieces[p]));
  }
}

// The column at which activation k is staged: within its 16-wide group,
// physical j = 4q + 2h + e goes to fragment column 8h + 2q + e.
__host__ __device__ __forceinline__ int perm_col(int k) {
  const int j = k & 15;
  return (k & ~15) | ((j & 2) << 2) | ((j >> 2) << 1) | (j & 1);
}

// int8 bytes 0-3 of w as two bf16 pairs: lo = (byte 0, byte 1), hi =
// (byte 2, byte 3), the lower element in the lower half
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128, unsigned
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x00004B00u, 0x5440u | i)) -
        8388736.f);  // (2^23 + b + 128) - (2^23 + 128) = b, exact
  lo = __byte_perm(f[0], f[1], 0x7632u);
  hi = __byte_perm(f[2], f[3], 0x7632u);
}

// A fragments (mma.sync m16n8k16 layout) of k16 slice ks of a 128-byte-row
// int8 tile that the TMA wrote with 128-byte swizzle, for the fragment rows
// row and row + 8 (row = 16 * warp + lane / 4; both share row % 8) and
// column pair q = lane % 4
__device__ __forceinline__ void load_frag(const uint8_t* tile, int row, int ks,
                                          int q, uint32_t (&a)[4]) {
  const uint32_t wa = *reinterpret_cast<const uint32_t*>(
      tile + sm90::swz<128>(row, ks) + 4 * q);
  const uint32_t wb = *reinterpret_cast<const uint32_t*>(
      tile + sm90::swz<128>(row + 8, ks) + 4 * q);
  widen4(wa, a[0], a[2]);
  widen4(wb, a[1], a[3]);
}

// Add the per-stage accumulator (N = 8P: column 8p + r is piece p of row
// r) into the running sums of this thread's two channels (rows g, g + 8 of
// the warp's 16) and two activation rows (2q, 2q + 1): sum[2c + e] is
// channel c, row 2q + e. The pieces add smallest first.
template <int P>
__device__ __forceinline__ void fold(const float (&acc)[4 * P],
                                     float (&sum)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t = acc[4 * (P - 1) + i];
#pragma unroll
    for (int p = P - 2; p >= 0; --p) t = __fadd_rn(t, acc[4 * p + i]);
    sum[i] = __fadd_rn(sum[i], t);
  }
}

// The products of n ring stages (positions it .. it + n - 1) for one
// consumer warpgroup, added into sum (fold): the k16 slices of a stage as
// one wgmma group on a fresh accumulator; the next stage's fragments are
// widened while the group runs, and the accumulator is read only once the
// group is done (a read while a group is in flight makes ptxas serialise
// the wgmmas, C7514). w_tile(i): the weight box of position i (this
// warpgroup's fragment rows are frow, frow + 8); b_box(i, j): the first
// of the two 64-k activation boxes of stage j (position i), the second
// one box on. Waits on full[] and arrives (leader) on empty[] of each
// position.
template <int P, typename WTile, typename BBox>
__device__ __forceinline__ void run_stages(int n, int it,
                                           const sm90::Ring& ring,
                                           uint64_t* full, uint64_t* empty,
                                           int frow, int q, bool leader,
                                           const WTile& w_tile,
                                           const BBox& b_box,
                                           float (&sum)[4]) {
  constexpr int N = kRows * P, ABOX = kRows * P * 128;
  float acc[4 * P];
  uint32_t frag[2][kSlices][4];
  auto widen = [&](int j, auto set_c) {
    constexpr int SET = decltype(set_c)::value;
    const int i = it + j;
    sm90::mbar_wait(&full[ring.stage(i)], ring.parity(i));
    const uint8_t* st = w_tile(i);
#pragma unroll
    for (int ks = 0; ks < kSlices; ++ks)
      load_frag(st, frow, ks, q, frag[SET][ks]);
  };
  auto step = [&](int j, auto set_c) {
    constexpr int SET = decltype(set_c)::value;
    const int i = it + j;
#pragma unroll
    for (int ks = 0; ks < kSlices; ++ks) sm90::hold(frag[SET][ks]);
    sm90::hold(acc);
    sm90::wgmma_fence();
    const uint8_t* at = b_box(i, j);
#pragma unroll
    for (int ks = 0; ks < kSlices; ++ks)
      sm90::Wgmma<N>::rs(
          acc, frag[SET][ks],
          sm90::desc_k(sm90::smem_desc(at + (ks / 4) * ABOX), ks % 4),
          ks > 0);
    sm90::wgmma_commit();
    if (j + 1 < n) widen(j + 1, std::integral_constant<int, SET ^ 1>{});
    sm90::wgmma_wait<0>();
    sm90::hold(acc);
#pragma unroll
    for (int ks = 0; ks < kSlices; ++ks) sm90::hold(frag[SET][ks]);
    fold<P>(acc, sum);
    if (leader) sm90::mbar_arrive(&empty[ring.stage(i)]);
  };
  widen(0, std::integral_constant<int, 0>{});
  int j = 0;
  for (; j + 1 < n; j += 2) {
    step(j, std::integral_constant<int, 0>{});
    step(j + 1, std::integral_constant<int, 1>{});
  }
  if (j < n) step(j, std::integral_constant<int, 0>{});
}

// an L2 policy that evicts first what it loads: the weights, read once,
// then pass through L2 without pushing out the activation workspace
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// sm90::tma_load with an L2 cache policy
__device__ __forceinline__ void tma_load_hint(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int c0, int r0,
                                              uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(r0), "l"(policy)
      : "memory");
}

// ---- host: int8 tensor maps, the cooperative launch -------------------------

// Tensor map of a row-major int8 (rows, cols) matrix, read in (box_rows,
// 128) tiles with 128-byte swizzle; reads outside the matrix fill zeros.
// Returns 0 or ETK_TMAP_FAILED.
inline int tensor_map_i8(CUtensorMap* map, const void* ptr, long long rows,
                         long long cols, int box_rows) {
  sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return ETK_TMAP_FAILED;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  cuuint32_t box[2] = {kChunk, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t unit[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                      const_cast<void*>(ptr), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ETK_TMAP_FAILED;
}

// A cooperative launch of `grid` blocks of `threads` with `smem` bytes of
// dynamic shared memory: refused (ETK_BAD_ARGS) unless every block is
// resident at once, which the grid barriers below rely on.
template <typename... Params, typename... Args>
int launch_cooperative(void (*kernel)(Params...), int grid, int threads,
                       int smem, cudaStream_t stream, Args&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm <= 0 || grid > per_sm * sm_count()) return ETK_BAD_ARGS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// ---- device: a grid-wide barrier one role of the block can wait on ---------
//
// sync[0] counts the blocks arrived, sync[1] is the generation: the last
// block to arrive resets the count and advances the generation, so both
// words are ready for the next barrier and the next launch (they start at
// zero once, when the buffer is made). Barrier k of a launch has passed
// once the generation is k past the one read at the launch's start. Unlike
// cooperative_groups' grid sync, a producer warp can wait for a barrier
// that only the consumer threads of its block arrive at.

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// generic-proxy writes to global memory, ordered before async-proxy (TMA)
// accesses to it
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// one arrival for the block (one thread, after the block's writes)
__device__ __forceinline__ void grid_arrive(unsigned* sync, unsigned blocks) {
  __threadfence();
  if (atomicAdd(&sync[0], 1u) == blocks - 1) {
    atomicExch(&sync[0], 0u);
    __threadfence();
    atomicAdd(&sync[1], 1u);
  }
}

// wait until barrier k of this launch (generation gen0 at its start) has
// passed
__device__ __forceinline__ void grid_wait(const unsigned* sync, unsigned gen0,
                                          int k) {
  while (static_cast<int>(ld_acquire(&sync[1]) - gen0) < k) __nanosleep(64);
  __threadfence();
}

}  // namespace i8w

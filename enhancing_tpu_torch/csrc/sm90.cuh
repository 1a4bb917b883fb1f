// Hopper (sm_90a) building blocks shared by the bf16 LN -> GEMM (B1,
// ln_gemm.cu), the fused FFN (B16, ffn.cu), attention -> projection (B15,
// attn_proj.cu), the attention backward (B5, attention_bwd.cu), the
// attention forwards (B2, B8, B17-B19, attention_bnhd.cu), their fp32
// counterparts on exact bf16 pieces (attention_f32.cu), the fp32 B15 and
// B16 on the same pieces (attn_proj_f32.cu, ffn_f32.cu) and the decode
// attention (B9, decode_attention.cu), and under int8_wgmma.cuh the int8
// decode MLP (B14, int8_mlp.cu), in raw PTX:
//
// - TMA: bf16 tensor maps encoded on the host (cuTensorMapEncodeTiled,
//   looked up through the CUDA runtime, so the library links no libcuda),
//   passed to the kernel as __grid_constant__ parameters; tile loads and
//   bulk copies that complete on an mbarrier, TMA stores.
// - A ring of stages, each with a "full" mbarrier (one producer arrival
//   plus the TMA transaction bytes) and an "empty" one (one arrival per
//   consumer warpgroup).
// - wgmma.mma_async m64nNk16, bf16 in, fp32 accumulators: SS (A and B in
//   shared memory) and RS (A from registers in mma.sync's m16n8k16
//   fragment layout, B in shared memory), with fence / commit / wait.
//   A shared-memory operand is a tile whose rows are 64 bf16 (128 bytes,
//   swizzled by the TMA in 8-row, 1024-byte atoms) or 32 bf16 (64 bytes,
//   8-row, 512-byte atoms). K-major (the reduced dimension along the row):
//   the descriptor steps 32 bytes per k16. MN-major, B only (the row is
//   the output's N; wgmma's transpose-B bit): one row per k, so the
//   descriptor steps 16 rows per k16; the kernels run one product per
//   row-wide box, so N never spans two swizzle atoms. The accumulator of
//   one product converts in registers to the bf16 A fragments of the next
//   (frag_from_acc), or of its three exact bf16 pieces (frag_pieces,
//   stage_pieces), so that fp32 products run on the bf16 tensor cores.
// - Tensor maps over the lane slices of a row-strided (B, N, cols) buffer:
//   3-D, so that boxes clip at each batch's N; and 4-D over (lanes, heads,
//   rows, batches) with a stride per axis, for attention operands laid out
//   (B, N, H, D), (B, H, N, D) or as lane slices of a packed qkv buffer.
// - Warp specialisation: setmaxnreg moves registers from the producer
//   warpgroup to the consumer warpgroups, within what the block was
//   launched with; each kernel branches once, at the top; named barriers
//   (bar.sync, bar.arrive) hand data between warpgroups.
// - Thread-block clusters: rank, barrier, arrivals on a peer's mbarrier,
//   bulk copies into and loads from a peer's shared memory (distributed
//   shared memory; vector loads of a peer's shared memory), for B16 (and
//   its fp32 form), B9 and fp32 B15; a launch helper.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver library linked

#include <utility>

#include "common.cuh"

// a tensor map could not be encoded (C entry return code)
constexpr int ETK_TMAP_FAILED = -2;

namespace sm90 {

// bytes of shared memory a block may use (H100: 227 KB) less 1 KB that the
// kernels keep to align their tiles to the 1024-byte swizzle atom and 1 KB
// for their static barriers
constexpr int kSmemLimit = 232448 - 2048;
// one swizzle-128B row: 64 bf16
constexpr int kTileK = 64;

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of bf16 (batches, rows, cols) with rows `ld` elements apart
// and batches `batch_ld` apart, read or written in (box_rows, box_cols)
// tiles with the swizzle of box_cols * 2 bytes (64 or 128); boxes clip at
// every edge (loads fill zeros, stores drop). Returns 0 or ETK_TMAP_FAILED.
inline int tensor_map_3d(CUtensorMap* map, const void* ptr, long long batches,
                         long long rows, long long cols, long long ld,
                         long long batch_ld, int box_rows, int box_cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || (box_cols != 32 && box_cols != 64))
    return ETK_TMAP_FAILED;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(batches)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                           static_cast<cuuint64_t>(batch_ld) * 2};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                       static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t unit[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(ptr), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ETK_TMAP_FAILED;
}

// Tensor map of a bf16 (batches, rows, heads, lanes) tensor, lanes
// contiguous, heads `head_ld`, rows `row_ld` and batches `batch_ld`
// elements apart (in any order of size), read or written in (1, box_rows,
// 1, box_lanes) tiles with the swizzle of box_lanes * 2 bytes (64 or 128);
// the map's dims run (lanes, heads, rows, batches). Boxes clip at every
// edge (loads fill zeros, stores drop). An axis of extent 1 is never
// stepped, so its stride, which may be 0, is replaced by `lanes` (the
// encoder wants every stride a nonzero multiple of 16 bytes). Returns 0 or
// ETK_TMAP_FAILED.
inline int tensor_map_4d(CUtensorMap* map, const void* ptr, long long batches,
                         long long rows, long long heads, long long lanes,
                         long long head_ld, long long row_ld,
                         long long batch_ld, int box_rows, int box_lanes) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || (box_lanes != 32 && box_lanes != 64))
    return ETK_TMAP_FAILED;
  auto stride = [&](long long extent, long long ld) {
    return static_cast<cuuint64_t>(extent == 1 ? lanes : ld) * 2;
  };
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(lanes),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(batches)};
  cuuint64_t strides[3] = {stride(heads, head_ld), stride(rows, row_ld),
                           stride(batches, batch_ld)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box_lanes), 1,
                       static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      box_lanes == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ETK_TMAP_FAILED;
}

// Tensor map of a row-major bf16 (rows, cols) matrix, rows `ld` elements
// apart, read in (box_rows, 64) tiles with 128-byte swizzle; reads outside
// the matrix fill zeros. Returns 0 or ETK_TMAP_FAILED.
inline int tensor_map(CUtensorMap* map, const void* ptr, long long rows,
                      long long cols, long long ld, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ETK_TMAP_FAILED;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  cuuint32_t box[2] = {kTileK, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t unit[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<void*>(ptr), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ETK_TMAP_FAILED;
}

// Tensor map of a row-major (rows, cols) matrix of `elem_bytes`-byte
// elements (1: int8, 2: bf16, 4: fp32), rows `cols` elements apart, read
// in boxes of `box_rows` rows of 128 bytes (128 / elem_bytes elements)
// with 128-byte swizzle; reads outside the matrix fill zeros. Returns 0 or
// ETK_TMAP_FAILED.
inline int tensor_map_128b(CUtensorMap* map, const void* ptr, long long rows,
                           long long cols, int elem_bytes, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr ||
      (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4))
    return ETK_TMAP_FAILED;
  const CUtensorMapDataType type =
      elem_bytes == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                       static_cast<cuuint32_t>(box_rows)};
  cuuint32_t unit[2] = {1, 1};
  CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides,
                      box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ETK_TMAP_FAILED;
}

// launch `kernel` on `grid` blocks of `threads` in clusters of `cluster`
// (1-8) along x, with `smem` bytes of dynamic shared memory
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), long long grid,
                           int cluster, int threads, int smem,
                           cudaStream_t stream, Args&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---- device: shared memory, mbarriers, TMA ------------------------------

// the first 1024-byte boundary at or after p (dynamic shared memory is
// requested with 1 KB to spare)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// after the barriers of a block are initialised, before any use
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the (box_rows, 64) tile at column c0, row r0 of `map` into dst
// (1024-byte aligned), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(r0)
      : "memory");
}

// TMA: the (box_rows, 64) tile at src (1024-byte aligned) to column c0,
// row r0 of `map`, clipped to the matrix; in this thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(r0)
      : "memory");
}

// TMA over a 3-D map: the (1, box_rows, box_cols) tile at (batch, row r0,
// column c0) into dst (aligned to its swizzle atom), completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int r0,
                                            int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(r0), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int r0,
                                             int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(r0), "r"(batch)
      : "memory");
}

// TMA over a 4-D map (tensor_map_4d): the (1, box_rows, 1, box_lanes) tile
// at (batch, row r0, head, lane c0) into dst (aligned to its swizzle atom),
// completing on `bar`; and the store of such a tile, in this thread's bulk
// group
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int head,
                                            int r0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(head), "r"(r0), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int head, int r0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(head), "r"(r0), "r"(batch)
      : "memory");
}

// bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) of
// global memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Ring position of the i-th tile a role walks through: stage and the parity
// of its pass over the ring.
struct Ring {
  int stages;
  __device__ __forceinline__ int stage(int i) const { return i % stages; }
  __device__ __forceinline__ uint32_t parity(int i) const {
    return static_cast<uint32_t>(i / stages) & 1u;
  }
};

// bar.sync on named barrier `id` (1-15; 0 is __syncthreads) for `count`
// threads, a multiple of 32
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// bar.arrive on named barrier `id`: counts this thread toward `count`
// without waiting; its earlier memory accesses are performed for the
// threads that bar.sync on the barrier
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- device: wgmma ------------------------------------------------------

// shared-memory descriptor of a tile of RB-byte rows (128: 128-byte
// swizzle; 64: 64-byte swizzle) starting at p (aligned to the 8-row atom,
// or stepped from such a start by 32 bytes per k16 along a K-major row, or
// by whole atoms): leading offset unused (N never spans two atoms), 8 rows
// between 8-row groups
template <int RB = 128>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  static_assert(RB == 128 || RB == 64, "128- or 64-byte rows");
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * RB >> 4) << 32) |
         ((RB == 128 ? 1ull : 2ull) << 62);
}

// the byte offset of 16-byte chunk `chunk` of row `row` in a tile of
// RB-byte rows swizzled as the TMA writes it: the chunk index XOR address
// bits 7.. (row % 8 for 128-byte rows, (row / 2) % 4 for 64-byte rows)
template <int RB>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  static_assert(RB == 128 || RB == 64, "128- or 64-byte rows");
  const int phase = RB == 128 ? row & 7 : (row >> 1) & 3;
  return static_cast<uint32_t>(row * RB + ((chunk ^ phase) << 4));
}

// The bf16 A fragment (mma.sync m16n8k16 layout) of k16 slice kk of a
// product whose fp32 accumulator `acc` is the A operand's rows: n8 block j
// of the accumulator holds (row r, cols 2q, 2q + 1) and (row r + 8, the
// same), which is the A fragment's layout over two n8 blocks.
template <int R>
__device__ __forceinline__ void frag_from_acc(uint32_t (&a)[4],
                                              const float (&acc)[R], int kk) {
  a[0] = pack_bf16x2(acc[8 * kk], acc[8 * kk + 1]);
  a[1] = pack_bf16x2(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = pack_bf16x2(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = pack_bf16x2(acc[8 * kk + 6], acc[8 * kk + 7]);
}

// ---- exact products of fp32 values on bf16 tensor cores ---------------------
//
// Every fp32 value a is the exact sum of three bf16 pieces: hi = bf16(a),
// mid = bf16(a - hi), lo = bf16(a - hi - mid) (each difference is exact in
// fp32, and 8 + 8 + 8 significant bits cover a's 24). A product of two
// bf16 pieces has at most 16 significant bits, so wgmma forms it exactly
// in fp32; a * b is then the six cross terms hi*hi, hi*mid, mid*hi,
// hi*lo, lo*hi and mid*mid (what is left, mid*lo, lo*mid and lo*lo, is
// 2^-24 of a * b and below). The fp32 kernels (attention_f32.cu,
// attn_proj_f32.cu, ffn_f32.cu) sum hi*hi in one accumulator and the five
// small terms in another, folded smallest
// first with a round-to-nearest add (the tensor cores' own adds are not
// round-to-nearest). Small cross term i multiplies A piece small_a(i) by
// B piece small_b(i).
constexpr int kPieces = 3;
__host__ __device__ constexpr int small_a(int i) {
  return i == 1 || i == 4 ? 1 : i == 3 ? 2 : 0;  // hi mid hi lo mid
}
__host__ __device__ constexpr int small_b(int i) {
  return i == 0 || i == 4 ? 1 : i == 2 ? 2 : 0;  // mid hi lo hi mid
}

// the three pieces of a as fp32 values, each exactly a bf16
__device__ __forceinline__ void bf16_pieces(float a, float (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = __bfloat162float(__float2bfloat16_rn(a));
    a = __fsub_rn(a, p[i]);
  }
}

// frag_from_acc for each piece: f[p] is the bf16 A fragment of piece p of
// k16 slice kk of the fp32 accumulator acc
template <int R>
__device__ __forceinline__ void frag_pieces(uint32_t (&f)[3][4],
                                            const float (&acc)[R], int kk) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float x[3], y[3];
    bf16_pieces(acc[8 * kk + 2 * e], x);
    bf16_pieces(acc[8 * kk + 2 * e + 1], y);
#pragma unroll
    for (int p = 0; p < 3; ++p) f[p][e] = pack_bf16x2(x[p], y[p]);
  }
}

// The pieces of a consumer thread's fp32 accumulator of 64 rows x 2R
// columns (n8 block j: rows r, r + 8, columns 8j + 2q, + 1), written into
// three swizzled boxes of 128-byte rows `piece_bytes` apart, as a
// shared-memory wgmma reads its K-major A operand (the columns are K)
template <int R>
__device__ __forceinline__ void stage_pieces(uint8_t* box, int piece_bytes,
                                             const float (&acc)[R], int r,
                                             int q) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x[3], y[3];
      bf16_pieces(acc[4 * j + 2 * hh], x);
      bf16_pieces(acc[4 * j + 2 * hh + 1], y);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint32_t*>(box + p * piece_bytes +
                                     swz<128>(r + 8 * hh, j) + 4 * q) =
            pack_bf16x2(x[p], y[p]);
    }
}

// the descriptor of the k16 slice `ks` of a tile (32 bytes a slice)
__device__ __forceinline__ uint64_t desc_k(uint64_t desc, int ks) {
  return desc + static_cast<uint64_t>(2 * ks);
}
// the descriptor of the k16 slice `ks` of an MN-major tile of RB-byte
// rows (16 rows a slice)
template <int RB>
__device__ __forceinline__ uint64_t desc_mn(uint64_t desc, int ks) {
  return desc + static_cast<uint64_t>(ks * RB);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep registers that an in-flight wgmma reads or writes live, and
// unmoved, up to this point (the compiler does not know that the
// instruction works asynchronously): its accumulators and, for a
// register-A product, its A fragments, after the wait that completes it;
// and before wgmma_fence, so that every write to them (a zero fill, a
// rescale, the packing of fragments) lands before the fence, as the fence
// requires, and not between it and the product.
template <int R>
__device__ __forceinline__ void hold(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void hold(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// register budgets of the two roles
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- device: clusters ---------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// split cluster barrier: every thread of every block of the cluster
// arrives (release), then waits (acquire), alternately
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the address in block `rank`'s shared memory of local address `a`
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
// the fp32 at cluster address `a` (a peer's shared memory, peer_addr)
__device__ __forceinline__ float ld_peer(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
// the 16 bytes at cluster address `a` (16-byte aligned; this block's or a
// peer's shared memory, peer_addr)
__device__ __forceinline__ uint4 ld_peer_v4(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
// mbar_wait with acquire at cluster scope: the writes that peers released
// with their arrivals (mbar_arrive_all) are visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// one arrival on the barrier `bar` of every block of a cluster of `n`
__device__ __forceinline__ void mbar_arrive_all(uint64_t* bar, int n) {
  const uint32_t a = smem_addr(bar);
  for (int p = 0; p < n; ++p)
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
            peer_addr(a, p))
        : "memory");
}
// bulk copy of `bytes` from this block's shared memory to cluster address
// `dst` (a peer's), completing on the peer's barrier at cluster address
// `bar`
__device__ __forceinline__ void bulk_copy_peer(uint32_t dst, const void* src,
                                               int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// close this thread's bulk group (copies, TMA stores)
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until this thread's committed bulk operations have read their
// shared-memory sources, or have completed
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to this block's shared memory, made visible to the
// async proxy (wgmma, bulk copies) that reads them next
__device__ __forceinline__ void fence_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}


// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, both operands K-major,
// accumulating (scale-d 1). One wrapper per width N that a kernel uses;
// the operand lists are written out, since an asm template is a literal.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  // d (64 x 8, fp32) = A (64 x 16, registers, mma.sync's fragment layout)
  // * B (8 x 16)^T, B K-major in shared memory, + d unless accumulate is 0
  __device__ __forceinline__ static void rs(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<24> {
  // d (64 x 24, fp32) = A (64 x 16, registers, mma.sync's fragment layout)
  // * B (24 x 16)^T, B K-major in shared memory, + d unless accumulate is 0
  __device__ __forceinline__ static void rs(float (&d)[12],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<32> {
  // d (64 x 32, fp32) += A (64 x 16) * B (32 x 16)^T, A and B in shared
  // memory; with accumulate 0, d = A * B^T (d's old values are not read)
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d (64 x 32, fp32) += A (64 x 16, registers, mma.sync's fragment layout)
  // * B; B in shared memory, K-major (TB 0: B is 32 x 16) or MN-major (TB
  // 1: B is 16 x 32, rows of 32)
  template <int TB = 0>
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
          "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64, fp32) += A (64 x 16) * B, A and B in shared memory, B
  // K-major (TB 0: B is 64 x 16) or MN-major (TB 1: B is 16 x 64, rows of
  // 64); with accumulate 0, d = A * B (d's old values are not read)
  template <int TB = 0>
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
  }
  // d (64 x 64, fp32) += A (64 x 16, registers, mma.sync's fragment layout)
  // * B; B in shared memory, K-major (TB 0: B is 64 x 16) or MN-major (TB
  // 1: B is 16 x 64, rows of 64)
  template <int TB = 0>
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
          "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128, fp32) += A (64 x 16) * B (128 x 16)^T, A and B in shared
  // memory; with accumulate 0, d = A * B^T (d's old values are not read)
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // the same with A (64 x 16) from registers, in mma.sync's fragment layout
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<160> {
  // d (64 x 160, fp32) += A (64 x 16) * B (160 x 16)^T, A and B in shared memory
  __device__ __forceinline__ static void ss(float (&d)[80], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  // d (64 x 192, fp32) += A (64 x 16) * B (192 x 16)^T, A and B in shared memory
  __device__ __forceinline__ static void ss(float (&d)[96], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // d (64 x 256, fp32) += A (64 x 16) * B (256 x 16)^T, A and B in shared memory
  __device__ __forceinline__ static void ss(float (&d)[128], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
  // the same with A (64 x 16) from registers, in mma.sync's fragment layout
  __device__ __forceinline__ static void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

}  // namespace sm90

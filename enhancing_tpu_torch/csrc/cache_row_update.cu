// In-place write of the new token's row into a stacked KV cache:
// cache[l, b, cur[b], :] = news[l, b, 0, :] for every (layer l, batch row b).
//
// Replaces enhancing_tpu/ops/cache.py::_row_write_kernel (entered through
// _cache_row_update_pallas). The TPU kernel read-modify-writes an aligned
// (8, C) tile because Mosaic forbids a one-row block, and exists to pin the
// cache's layout inside XLA's while loop; both are means of the TPU. Here
// only the rows move: nothing else of the cache is read or written.
//
// Bound on the H100: bytes, each row read once from `news` and written
// once into the cache, 2 * L * B * C * itemsize: 4.72 MB at the GPT
// prior's (24, 8, 1032, 6144) bf16 stack (1.41 us at 3.35 TB/s), 1.18 MB
// at the RQ prior's (24, 8, 1032, 1536) (0.35 us). At these sizes a call
// is latency-bound: a launch alone takes ~1.04 us as a CUDA-graph node,
// and the copy adds one read latency. So every load of a thread is issued
// before its first store: a block of 128 threads a (batch row, layer)
// copies its row in rounds of up to kBatch 16-byte vectors a thread, all
// loaded into registers, then all stored; one read latency a round, and
// rows of up to 16 KB take one round. 1-D bulk copies (cp.async.bulk)
// through a shared-memory ring, one block an SM, were measured slower on
// the card at every stack: the copy engine's load and the store's read of
// shared memory add latency to a few KB a block (PERF.md).
//
// cur is a scalar (the lockstep sampler, passed by value) or a per-row
// int32 vector on the device (ragged batches), read once a block; a row
// whose position lies outside [0, ctx) is not written. Rows of any
// multiple of 16 bytes (bf16, fp32, int8) are taken.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 8;  // 16-byte vectors a thread loads before storing

__global__ void __launch_bounds__(kThreads)
    row_write_kernel(uint4* __restrict__ cache, const uint4* __restrict__ news,
                     const int* __restrict__ cur_vec, int cur_scalar, int b,
                     int ctx, int vecs) {
  const int row = blockIdx.x, l = blockIdx.y;
  const int cur = cur_vec != nullptr ? cur_vec[row] : cur_scalar;
  if (cur < 0 || cur >= ctx) return;
  const size_t lb = static_cast<size_t>(l) * b + row;
  const uint4* src = news + lb * vecs;
  uint4* dst = cache + (lb * ctx + cur) * vecs;
  for (int base = threadIdx.x; base < vecs; base += kBatch * kThreads) {
    uint4 r[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int v = base + k * kThreads;
      if (v < vecs) r[k] = src[v];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int v = base + k * kThreads;
      if (v < vecs) dst[v] = r[k];
    }
  }
}

}  // namespace

ETK_API int etk_cache_row_update(void* cache, const void* news,
                                 const void* cur_vec, int cur_scalar, int l,
                                 int b, int ctx, int row_bytes, void* stream) {
  if (l <= 0 || b <= 0 || ctx <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      l > 65535)
    return ETK_BAD_ARGS;
  dim3 grid(b, l);
  row_write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), static_cast<const uint4*>(news),
      static_cast<const int*>(cur_vec), cur_scalar, b, ctx, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

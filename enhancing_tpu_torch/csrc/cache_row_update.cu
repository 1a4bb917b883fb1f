// In-place write of the new token's row into a stacked KV cache:
// cache[l, b, cur[b], :] = news[l, b, 0, :] for every (layer l, batch row b).
//
// Replaces enhancing_tpu/ops/cache.py::_row_write_kernel (entered through
// _cache_row_update_pallas). The TPU kernel read-modify-writes an aligned
// (8, C) tile because Mosaic forbids a one-row block, and exists to pin the
// cache's layout inside XLA's while loop; both are means of the TPU. Here a
// block of 128 threads copies one row of C elements as 16-byte vectors
// straight to its place: nothing else of the cache is read or written.
//
// Bound on the H100: bytes, 2 * L * B * C * itemsize (2.4 MB at the GPT
// prior's (24, 8, 1032, 6144) bf16 stack), a few microseconds at 3.35 TB/s:
// the launch's fixed cost dominates. cur is a scalar (the lockstep sampler,
// passed by value) or a per-row int32 vector on the device (ragged batches);
// a row whose position lies outside [0, ctx) is not written.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

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
  for (int v = threadIdx.x; v < vecs; v += kThreads) dst[v] = src[v];
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

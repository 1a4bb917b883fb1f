// The 1-D bulk-copy design of the KV-cache row write (B10), kept beside the
// shipped kernel (cache_row_update.cu) as its measured alternative: no
// wrapper of the package launches it; ab_cache_row_update.py --bulk times
// it against the shipped kernel on the same inputs and checks it bit for
// bit. It was slower at every stack and setting tried (PERF.md).
//
// Rows move as 1-D bulk copies (cp.async.bulk): global -> shared, completing
// on an mbarrier, and shared -> global in the issuing thread's bulk group.
// One elected thread a block issues every copy. Rows are cut into pieces of
// at most `chunk` bytes; the grid (`blocks_per_sm` blocks an SM, or 0 for a
// block a piece) walks the pieces with a grid stride, and each block streams
// its pieces through a ring of `stages` shared-memory buffers so that the
// load of a later piece overlaps the store of this one: the store of piece
// i is issued once its load has landed, and the buffer that store i - 1
// read is refilled with piece i + stages - 1 once at most one store (i's)
// is still reading shared memory.
//
// The shipped kernel's contract: bit-exact, cur a scalar or a (B,) vector
// (read once a piece), rows whose position lies outside [0, ctx) not
// written, rows of any multiple of 16 bytes.
#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 48 * 1024;  // no opt-in to more dynamic smem

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// of this block's shared memory to global memory, in this thread's bulk
// group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}
// wait until at most one committed bulk group still reads shared memory
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
__device__ __forceinline__ bool elect_one() {
  uint32_t pred = 0;
  asm volatile(
      "{\n.reg .pred p;\nelect.sync _|p, 0xffffffff;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(pred));
  return pred != 0;
}

struct Pieces {
  uint8_t* cache;
  const uint8_t* news;
  const int* cur_vec;
  int cur_scalar, b, ctx, row_bytes, chunk, per_row, total;

  __device__ int cur(int p) const {
    const int row = p / per_row;
    return cur_vec != nullptr ? cur_vec[row % b] : cur_scalar;
  }
  __device__ bool live(int p) const {
    const int c = cur(p);
    return c >= 0 && c < ctx;
  }
  // the next live piece of this block after p (or `total`)
  __device__ int next(int p) const {
    for (p += gridDim.x; p < total && !live(p); p += gridDim.x) {
    }
    return p;
  }
  __device__ int bytes(int p) const {
    return min(chunk, row_bytes - (p % per_row) * chunk);
  }
  __device__ const uint8_t* src(int p) const {
    const size_t row = p / per_row;
    return news + row * row_bytes + (p % per_row) * chunk;
  }
  __device__ uint8_t* dst(int p) const {
    const size_t row = p / per_row;
    return cache + (row * ctx + cur(p)) * row_bytes + (p % per_row) * chunk;
  }
};

__global__ void __launch_bounds__(32)
    row_write_bulk_kernel(Pieces pc, int stages) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[kMaxStages];
  if (!elect_one()) return;
  for (int s = 0; s < stages; ++s) sm90::mbar_init(&full[s], 1);
  sm90::fence_mbar_init();
  auto load = [&](int p, int i) {
    const int s = i % stages;
    sm90::mbar_expect_tx(&full[s], pc.bytes(p));
    sm90::bulk_load(ring + s * pc.chunk, pc.src(p), pc.bytes(p), &full[s]);
  };
  const int first = blockIdx.x < pc.total && pc.live(blockIdx.x)
                        ? static_cast<int>(blockIdx.x)
                        : pc.next(blockIdx.x);
  int pl = first, nl = 0;  // the next piece to load, loads issued
  for (; nl < stages - 1 && pl < pc.total; ++nl, pl = pc.next(pl))
    load(pl, nl);
  int i = 0;
  for (int p = first; p < pc.total; p = pc.next(p), ++i) {
    const int s = i % stages;
    sm90::mbar_wait(&full[s], static_cast<uint32_t>(i / stages) & 1u);
    bulk_store(pc.dst(p), ring + s * pc.chunk, pc.bytes(p));
    sm90::bulk_commit();
    if (pl < pc.total) {
      bulk_wait_read_all_but_one();  // store i - 1 has read its buffer
      load(pl, nl);
      ++nl;
      pl = pc.next(pl);
    }
  }
  sm90::bulk_wait_read();
}

}  // namespace

ETK_API int etk_cache_row_update_bulk(void* cache, const void* news,
                                      const void* cur_vec, int cur_scalar,
                                      int l, int b, int ctx, int row_bytes,
                                      int chunk, int stages,
                                      int blocks_per_sm, void* stream) {
  if (l <= 0 || b <= 0 || ctx <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      chunk <= 0 || chunk % 16 || stages < 2 || stages > kMaxStages ||
      stages * chunk > kMaxSmem || blocks_per_sm < 0)
    return ETK_BAD_ARGS;
  const int per_row = (row_bytes + chunk - 1) / chunk;
  const long long total = static_cast<long long>(l) * b * per_row;
  if (total > (1LL << 30)) return ETK_BAD_ARGS;
  Pieces pc{static_cast<uint8_t*>(cache),
            static_cast<const uint8_t*>(news),
            static_cast<const int*>(cur_vec),
            cur_scalar,
            b,
            ctx,
            row_bytes,
            chunk,
            per_row,
            static_cast<int>(total)};
  const int grid =
      blocks_per_sm == 0
          ? pc.total
          : static_cast<int>(std::min<long long>(
                total, static_cast<long long>(blocks_per_sm) * sm_count()));
  if (grid <= 0) return ETK_BAD_ARGS;
  row_write_bulk_kernel<<<grid, 32, stages * chunk,
                          static_cast<cudaStream_t>(stream)>>>(pc, stages);
  return static_cast<int>(cudaGetLastError());
}

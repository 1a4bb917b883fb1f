// FIR filter of NHWC images with up = down = 1 (the StyleGAN blur):
// out[b, i, j, c] = sum_{a, e} taps[a][e] * X[b, i + a - py0, j + e - px0, c]
// with X zero outside the image, so a positive pad zero-extends and a
// negative pad crops. The output is (B, H + py0 + py1 - kh + 1,
// W + px0 + px1 - kw + 1, C). The taps arrive pre-flipped, so this is
// true convolution with the caller's kernel. The same kernel computes the
// op's VJP: the gradient of x is this filter on the output's gradient with
// the unflipped taps and the pads (kw - 1 - px0, kw - 1 - px1, kh - 1 -
// py0, kh - 1 - py1) (ops/upfirdn2d.py::fir_vjp_pad).
//
// Replaces enhancing_tpu/ops/upfirdn2d.py::_fir_kernel as entered through
// _upfirdn2d_pallas_fir. Numerics as there: the window is widened to fp32,
// each tap's term is rounded (tap * x) and added to the sum, the taps in
// row-major order skipping zero taps, and the sum is rounded once to the
// output dtype (fp32 or bf16).
//
// Bound on the H100: bytes. A 4 x 4 blur does 32 flops per element against
// one read and one write. Design: rows stream. A block owns a strip of
// output columns, a group of up to 32 16-byte channel vectors (512 bytes)
// and a chunk of output rows, and walks down the rows: a producer warp
// keeps a ring of input-row slabs in flight, each one TMA box of (strip +
// kw - 1 columns, the group's channels) from a 4-D tensor map over (C, W,
// H, B) at signed start coordinates, so the zero padding is the TMA's
// out-of-bounds fill and a negative pad is a start offset. Each input row
// is read from device memory once per strip (and its kw - 1 halo columns
// by the neighbouring strip). A consumer thread owns one output column's
// channel vector and keeps the kh outputs that an input row feeds in
// registers, a ring of partial sums: input row u adds tap row a to output
// u - a, so every output receives its tap rows in order, and the output
// whose last tap row arrived is rounded and stored with one 16-byte store.
// The taps ride in the kernel's parameters, a kernel with no zero tap
// tests none; kh is a template parameter (the sums' ring is registers), kw
// a bound of 8. The rows are cut into chunks so that the blocks fill the
// card as one wave (the occupancy query). At the discriminator's largest
// blur the kernel moves its bytes at 82% of the rate of a contiguous copy
// of the same bytes on the card.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int MAX_TAPS = 8;
constexpr int kMaxVecs = 32;         // channel vectors a column of a block
constexpr int kMaxConsumers = 256;   // threads that compute
constexpr int kStages = 4;           // input-row slabs in flight
constexpr int kChunkRows = 32;       // the least rows of a row chunk
constexpr int kMaxThreads = kMaxConsumers + 32;

struct Taps {
  float v[MAX_TAPS * MAX_TAPS];  // row-major kh x kw, pre-flipped
};

// a block's share of the output, chosen on the host (fir_plan; mirrored by
// ops/upfirdn2d.py::fir_plan)
struct Geom {
  int vb;         // channel vectors a column (the box's inner extent)
  int sw;         // output columns a strip
  int strips;     // strips across the output's width
  int rows;       // output rows a chunk
  int chunks;     // chunks down the output's height
  int cgroups;    // groups across the channels
  int consumers;  // computing threads: sw * vb rounded up to a warp
  int box;        // bytes of one input-row slab (the TMA box)
  int slab;       // its room in the ring, 128-byte aligned
};

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void widen(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void widen(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 narrow(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 narrow(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

// SKIP: some tap is zero, so each term tests its tap (the blur's taps are
// all nonzero and test none)
template <typename T, int KH, bool SKIP>
__global__ void __launch_bounds__(kMaxThreads)
    fir_kernel(const __grid_constant__ CUtensorMap tmap, T* __restrict__ out,
               Taps taps, int kw, int c, int ho, int wo, int py0, int px0,
               Geom g) {
  constexpr int N = Vec16<T>::N;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* smem = smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  const int strip = blockIdx.x % g.strips, chunk = blockIdx.x / g.strips;
  const int j0 = strip * g.sw, o0 = chunk * g.rows, cv0 = blockIdx.y * g.vb;
  const int b = blockIdx.z;
  const int rows = min(g.rows, ho - o0);
  const int steps = rows + KH - 1;  // input rows this block reads
  const sm90::Ring ring{kStages};

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], g.consumers / 32);  // one arrival a warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.x) >= g.consumers) {
    // producer warp: input row o0 - py0 + u of the strip's columns j0 -
    // px0 .. (zeros outside the image) into stage u % kStages
    if (static_cast<int>(threadIdx.x) == g.consumers) {
      for (int u = 0; u < steps; ++u) {
        const int s = ring.stage(u);
        sm90::mbar_wait(&empty[s], ring.parity(u) ^ 1u);
        sm90::mbar_expect_tx(&full[s], g.box);
        sm90::tma_load_4d(smem + s * g.slab, &tmap, &full[s], cv0 * N,
                          j0 - px0, o0 - py0 + u, b);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int col = threadIdx.x / g.vb, cv = threadIdx.x % g.vb;
  const bool active = col < g.sw && j0 + col < wo && (cv0 + cv) * N < c;
  T* dst = out + ((static_cast<size_t>(b) * ho + o0) * wo + j0 + col) * c +
           (cv0 + cv) * N;
  const size_t row_stride = static_cast<size_t>(wo) * c;
  // acc[(u - a) % KH]: output u - a's partial sum (rows relative to o0)
  float acc[KH][N];
#pragma unroll
  for (int k = 0; k < KH; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[k][i] = 0.f;

  for (int u0 = 0; u0 < steps; u0 += KH) {
#pragma unroll
    for (int k = 0; k < KH; ++k) {
      const int u = u0 + k;
      if (u >= steps) break;
      const int s = ring.stage(u);
      sm90::mbar_wait(&full[s], ring.parity(u));
      // output u's first tap row arrives with input row u
#pragma unroll
      for (int i = 0; i < N; ++i) acc[k][i] = 0.f;
      if (active) {
        const uint4* x = reinterpret_cast<const uint4*>(smem + s * g.slab) +
                         col * g.vb + cv;
#pragma unroll
        for (int e = 0; e < MAX_TAPS; ++e) {
          if (e >= kw) break;
          float v[N];
          widen(x[e * g.vb], v);
#pragma unroll
          for (int a = 0; a < KH; ++a) {
            const float tap = taps.v[a * MAX_TAPS + e];
            if (SKIP && tap == 0.f) continue;
            float(&o)[N] = acc[(k - a + KH) % KH];
#pragma unroll
            for (int i = 0; i < N; ++i)
              o[i] = __fadd_rn(o[i], __fmul_rn(tap, v[i]));
          }
        }
      }
      // this warp has read the slab
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
      // output u - (KH - 1) received its last tap row
      const int done = u - (KH - 1);
      if (active && done >= 0 && done < rows)
        *reinterpret_cast<uint4*>(dst + done * row_stride) =
            narrow(acc[(k + 1) % KH]);
    }
  }
}

// A block's share of a (b, ho, wo, c) output of n-element vectors and
// kw-wide taps: up to kMaxVecs channel vectors a column (512 bytes, whole
// pixels of up to 128 fp32 channels, measured 2% faster than 128-byte
// groups for all their halo columns), strips of up to kMaxConsumers / vb
// columns (a box extent is at most 256), the rows not yet split
// (chunk_rows splits them).
Geom fir_geom(int b, int c, int ho, int wo, int kw, int n) {
  Geom g{};
  const int vecs = c / n;
  g.vb = vecs < kMaxVecs ? vecs : kMaxVecs;
  g.cgroups = (vecs + g.vb - 1) / g.vb;
  int most = kMaxConsumers / g.vb;
  if (most > 256 - (kw - 1)) most = 256 - (kw - 1);
  g.strips = (wo + most - 1) / most;
  g.sw = (wo + g.strips - 1) / g.strips;
  g.consumers = (g.sw * g.vb + 31) / 32 * 32;
  g.rows = ho;
  g.chunks = 1;
  g.box = (g.sw + kw - 1) * g.vb * 16;
  g.slab = (g.box + 127) / 128 * 128;
  return g;
}

int smem_bytes(const Geom& g) { return kStages * g.slab + 128; }

// Split the rows into chunks of at least kChunkRows rows, as many as keep
// the blocks within the card's `slots` (blocks resident at once): one wave
// whose blocks stream their rows and end together. Each chunk reads its
// kh - 1 halo rows again.
void chunk_rows(Geom& g, int b, int ho, long long slots) {
  const long long blocks = static_cast<long long>(g.strips) * g.cgroups * b;
  long long chunks = slots / blocks;
  const long long most = ho / kChunkRows;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  g.rows = static_cast<int>((ho + chunks - 1) / chunks);
  g.chunks = (ho + g.rows - 1) / g.rows;
}

// the kernel for taps of kh rows, testing each tap for zero or not
template <typename T>
using Kernel = void (*)(CUtensorMap, T*, Taps, int, int, int, int, int, int,
                        Geom);

template <typename T, bool SKIP>
Kernel<T> kernel_of(int kh) {
  switch (kh) {
    case 1: return fir_kernel<T, 1, SKIP>;
    case 2: return fir_kernel<T, 2, SKIP>;
    case 3: return fir_kernel<T, 3, SKIP>;
    case 4: return fir_kernel<T, 4, SKIP>;
    case 5: return fir_kernel<T, 5, SKIP>;
    case 6: return fir_kernel<T, 6, SKIP>;
    case 7: return fir_kernel<T, 7, SKIP>;
    case 8: return fir_kernel<T, 8, SKIP>;
    default: return nullptr;
  }
}

// The whole plan of `kernel`: geometry, the blocks of it that fit an SM
// at once (the occupancy query; 0 if it fails), chunks
template <typename T>
Geom fir_plan(Kernel<T> kernel, int b, int c, int ho, int wo, int kw,
              int* per_sm) {
  Geom g = fir_geom(b, c, ho, wo, kw, Vec16<T>::N);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, kernel, g.consumers + 32, smem_bytes(g)) != cudaSuccess)
    *per_sm = 0;
  chunk_rows(g, b, ho,
             static_cast<long long>(*per_sm) *
                 (sm_count() > 0 ? sm_count() : 132));
  return g;
}

// the 4-D map of x (B, H, W, C): dims (C, W, H, B), boxes of (vb vectors,
// sw + kw - 1 columns, 1, 1), no swizzle; reads outside fill zeros
int fir_map(CUtensorMap* map, const void* x, int es, int b, int h, int w,
            int c, const Geom& g, int kw) {
  sm90::EncodeTiled encode = sm90::encode_tiled();
  // the encoder needs a current context on the calling thread, and the
  // backward runs on autograd's thread, where none may be current yet
  // (PyTorch switches devices there only when they differ): make the
  // current device's primary context current
  int dev = 0;
  if (encode == nullptr || cudaGetDevice(&dev) != cudaSuccess ||
      cudaSetDevice(dev) != cudaSuccess)
    return ETK_TMAP_FAILED;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                        static_cast<cuuint64_t>(w),
                        static_cast<cuuint64_t>(h),
                        static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(c) * es;
  cuuint64_t strides[3] = {row, row * w, row * w * h};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(g.vb * 16 / es),
                       static_cast<cuuint32_t>(g.sw + kw - 1), 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = encode(map,
                      es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      4, const_cast<void*>(x), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ETK_TMAP_FAILED;
}

template <typename T>
int launch(const void* x, void* out, const Taps& taps, int b, int h, int w,
           int c, int kh, int kw, int py0, int py1, int px0, int px1,
           cudaStream_t s) {
  const int ho = h + py0 + py1 - kh + 1, wo = w + px0 + px1 - kw + 1;
  if (c % Vec16<T>::N || ho <= 0 || wo <= 0) return ETK_BAD_ARGS;
  bool skip = false;
  for (int a = 0; a < kh; ++a)
    for (int e = 0; e < kw; ++e) skip |= taps.v[a * MAX_TAPS + e] == 0.f;
  const Kernel<T> kernel =
      skip ? kernel_of<T, true>(kh) : kernel_of<T, false>(kh);
  if (kernel == nullptr) return ETK_BAD_ARGS;
  int per_sm = 0;
  const Geom g = fir_plan<T>(kernel, b, c, ho, wo, kw, &per_sm);
  if (per_sm == 0 ||
      static_cast<long long>(g.strips) * g.chunks > 0x7fffffffLL ||
      g.cgroups > 65535 || b > 65535)
    return ETK_BAD_ARGS;
  CUtensorMap map;
  if (fir_map(&map, x, sizeof(T), b, h, w, c, g, kw)) return ETK_TMAP_FAILED;
  dim3 grid(g.strips * g.chunks, g.cgroups, b);
  kernel<<<grid, g.consumers + 32, smem_bytes(g), s>>>(
      map, static_cast<T*>(out), taps, kw, c, ho, wo, py0, px0, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// taps: kh * kw fp32 values, row-major, pre-flipped; kh, kw in [1, 8]. x
// and out contiguous and 16-byte aligned, C a multiple of 16 bytes.
ETK_API int etk_fir(const void* x, void* out, const float* taps, int b, int h,
                    int w, int c, int kh, int kw, int py0, int py1, int px0,
                    int px1, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || kh < 1 || kw < 1 ||
      kh > MAX_TAPS || kw > MAX_TAPS)
    return ETK_BAD_ARGS;
  Taps t{};
  for (int a = 0; a < kh; ++a)
    for (int e = 0; e < kw; ++e) t.v[a * MAX_TAPS + e] = taps[a * kw + e];
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ETK_F32)
    return launch<float>(x, out, t, b, h, w, c, kh, kw, py0, py1, px0, px1, s);
  if (dtype == ETK_BF16)
    return launch<__nv_bfloat16>(x, out, t, b, h, w, c, kh, kw, py0, py1, px0,
                                 px1, s);
  return ETK_BAD_ARGS;
}

// the plan of a blur with a (b, ho, wo, c) output and taps of kh x kw, none
// zero, on this device: channel vectors a column, columns a strip, strips,
// rows a chunk, chunks, channel groups, computing threads, box bytes,
// dynamic shared memory, blocks an SM (ops/upfirdn2d.py::fir_plan mirrors
// it, given the last)
ETK_API int etk_fir_plan(int b, int c, int ho, int wo, int kh, int kw,
                         int dtype, int* plan) {
  const int n = dtype == ETK_F32 ? 4 : dtype == ETK_BF16 ? 8 : 0;
  if (n == 0 || b <= 0 || c <= 0 || c % n || ho <= 0 || wo <= 0 || kh < 1 ||
      kh > MAX_TAPS || kw < 1 || kw > MAX_TAPS)
    return ETK_BAD_ARGS;
  int per_sm = 0;
  const Geom g =
      dtype == ETK_F32
          ? fir_plan<float>(kernel_of<float, false>(kh), b, c, ho, wo, kw,
                            &per_sm)
          : fir_plan<__nv_bfloat16>(kernel_of<__nv_bfloat16, false>(kh), b,
                                    c, ho, wo, kw, &per_sm);
  const int v[10] = {g.vb,      g.sw,        g.strips, g.rows,
                     g.chunks,  g.cgroups,   g.consumers, g.box,
                     smem_bytes(g), per_sm};
  for (int i = 0; i < 10; ++i) plan[i] = v[i];
  return 0;
}

// FIR filter of NHWC images with up = down = 1 (the StyleGAN blur):
// out[b, i, j, c] = sum_{a, e} taps[a][e] * X[b, i + a - py0, j + e - px0, c]
// with X zero outside the image, so a positive pad zero-extends and a
// negative pad crops. The output is (B, H + py0 + py1 - kh + 1,
// W + px0 + px1 - kw + 1, C). The taps arrive pre-flipped, so this is
// true convolution with the caller's kernel.
//
// Replaces enhancing_tpu/ops/upfirdn2d.py::_fir_kernel as entered through
// _upfirdn2d_pallas_fir. Numerics as there: the window is widened to fp32,
// the taps accumulate in row-major order skipping zero taps, and the sum
// is rounded once to the output dtype (fp32 or bf16).
//
// Bound on the H100: bytes. A 4 x 4 blur does 32 flops per element against
// one read and one write. Design: channels are the contiguous axis, so a
// thread owns one 16-byte channel vector (4 fp32 or 8 bf16) of 4 output
// pixels; a block of 256 threads covers an 8 x 16 output tile times 8
// channel vectors and first stages its input window (tile plus the kh - 1,
// kw - 1 halo, zero outside the image) in shared memory with 16-byte
// loads, so each input vector is read from device memory about 1.6 times
// (the halo) and the kh * kw tap reads hit shared memory. The taps ride in
// the kernel's parameters. The TPU kernel's whole-image VMEM panel and its
// 512 KB budget are means of the TPU and are not reproduced: every image
// size goes through this kernel.
#include "common.cuh"

namespace {

constexpr int TH = 8, TW = 16, CV = 8, kThreads = 256, PIX = 4;
constexpr int MAX_TAPS = 8;

struct Taps {
  float v[MAX_TAPS * MAX_TAPS];  // row-major kh x kw, pre-flipped
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fir_kernel(const T* __restrict__ x, T* __restrict__ out, Taps taps, int h,
               int w, int c, int ho, int wo, int kh, int kw, int py0,
               int px0, int tiles_w) {
  constexpr int N = Vec16<T>::N;
  extern __shared__ __align__(16) uint4 window[];  // [wh][ww][CV]
  const int wh = TH + kh - 1, ww = TW + kw - 1;
  const int i0 = (blockIdx.x / tiles_w) * TH, j0 = (blockIdx.x % tiles_w) * TW;
  const int cv0 = blockIdx.y * CV, b = blockIdx.z;
  const int vecs = c / N;
  const T* xb = x + static_cast<size_t>(b) * h * w * c;

  // stage the window: input rows i0 - py0 .., columns j0 - px0 ..
  for (int idx = threadIdx.x; idx < wh * ww * CV; idx += kThreads) {
    const int cv = idx % CV, col = (idx / CV) % ww, row = idx / (CV * ww);
    const int r = i0 + row - py0, s = j0 + col - px0;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r >= 0 && r < h && s >= 0 && s < w && cv0 + cv < vecs)
      raw = *reinterpret_cast<const uint4*>(
          xb + (static_cast<size_t>(r) * w + s) * c + (cv0 + cv) * N);
    window[idx] = raw;
  }
  __syncthreads();

  const int cv = threadIdx.x % CV;
  if (cv0 + cv >= vecs) return;
  for (int p = 0; p < PIX; ++p) {
    const int pix = (threadIdx.x / CV) * PIX + p;  // 0 .. TH * TW - 1
    const int oi = pix / TW, oj = pix % TW;
    if (i0 + oi >= ho || j0 + oj >= wo) continue;
    float acc[N];
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = 0.f;
    for (int a = 0; a < kh; ++a) {
      for (int e2 = 0; e2 < kw; ++e2) {
        const float tap = taps.v[a * MAX_TAPS + e2];
        if (tap == 0.f) continue;
        float v[N];
        widen(window[((oi + a) * ww + oj + e2) * CV + cv], v);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] += tap * v[e];
      }
    }
    *reinterpret_cast<uint4*>(
        out + ((static_cast<size_t>(b) * ho + i0 + oi) * wo + j0 + oj) * c +
        (cv0 + cv) * N) = narrow(acc);
  }
}

template <typename T>
int launch(const void* x, void* out, const Taps& taps, int b, int h, int w,
           int c, int kh, int kw, int py0, int py1, int px0, int px1,
           cudaStream_t stream) {
  constexpr int N = Vec16<T>::N;
  const int ho = h + py0 + py1 - kh + 1, wo = w + px0 + px1 - kw + 1;
  if (c % N || ho <= 0 || wo <= 0) return ETK_BAD_ARGS;
  const int tiles_h = (ho + TH - 1) / TH, tiles_w = (wo + TW - 1) / TW;
  const int bytes = (TH + kh - 1) * (TW + kw - 1) * CV * 16;
  dim3 grid(tiles_h * tiles_w, (c / N + CV - 1) / CV, b);
  if (grid.x > 0x7fffffffu || grid.y > 65535 || grid.z > 65535)
    return ETK_BAD_ARGS;
  fir_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), taps, h, w, c, ho, wo,
      kh, kw, py0, px0, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// taps: kh * kw fp32 values, row-major, pre-flipped; kh, kw in [1, 8].
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

// 16-byte vector loads and stores of bf16 or fp32 rows, widened to fp32,
// and (namespace cvt) the element conversions, 4-wide loads, LayerNorm and
// token shift of one element that the decode-step kernels share.
#pragma once

#include "common.cuh"

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[N]) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  // a streaming store (__stcs): L2 need not keep what it writes
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[N]) {
    uint4 raw;
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = pack_bf16x2(v[2 * i], v[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    float4 raw = *reinterpret_cast<const float4*>(p);
    v[0] = raw.x;
    v[1] = raw.y;
    v[2] = raw.z;
    v[3] = raw.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[N]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

namespace cvt {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision, kept as fp32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// an element of an fp32 or bf16 vector chosen at run time (biases, the
// shift state), widened to fp32; a null pointer reads 0
__device__ __forceinline__ float load_any(const void* p, int dtype,
                                          size_t i) {
  if (p == nullptr) return 0.f;
  return dtype == ETK_BF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// four consecutive elements, 16-byte (fp32) or 8-byte (bf16) aligned,
// through the read-only cache, widened to fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ld4_any(const void* p, int dtype,
                                          size_t i) {
  return dtype == ETK_BF16
             ? ld4(static_cast<const __nv_bfloat16*>(p) + i)
             : ld4(static_cast<const float*>(p) + i);
}
// four values already rounded to T's precision, stored as T
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  u.x = pack_bf16x2(v.x, v.y);
  u.y = pack_bf16x2(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// LN(x) of one element, as flax computes it (fp32 statistics, the fast
// variance), rounded to T's precision
template <typename T>
__device__ __forceinline__ float ln_one(float v, float g, float b,
                                        float mean, float rstd) {
  return round_to<T>(
      __fadd_rn(__fmul_rn(__fsub_rn(v, mean), __fmul_rn(rstd, g)), b));
}

// the token shift xn * tm + prev * (1 - tm), each step in T's precision
template <typename T>
__device__ __forceinline__ float mix_one(float xr, float t, float p) {
  const float tmx = round_to<T>(t);
  const float a = round_to<T>(__fmul_rn(xr, tmx));
  const float one_m = round_to<T>(__fsub_rn(1.f, tmx));
  const float b = round_to<T>(__fmul_rn(round_to<T>(p), one_m));
  return round_to<T>(__fadd_rn(a, b));
}

}  // namespace cvt

// Fused bias + leaky ReLU with gain (StyleGAN's FusedLeakyReLU):
// y = scale * (t >= 0 ? t : slope * t) with t = x + bias[c], bias over the
// last (channel) axis of an (M, C) row-major tensor.
//
// Replaces enhancing_tpu/ops/fused_act.py::_kernel as entered through
// _fused_pallas2d. Numerics as there: the bias is cast to x's dtype and
// added in x's dtype, the predicate is taken in fp32, and with bf16 x
// every step rounds to bf16 as JAX's weakly typed scalars make it: the
// wrapper passes slope and scale already rounded to bf16, and t,
// slope * t and scale * (...) each round once; with fp32 x everything is
// fp32.
//
// Bound on the H100: bytes, one read and one write per element. Design:
// one elementwise pass, one 16-byte vector (4 fp32 or 8 bf16 channels) per
// thread and iteration over a grid-stride loop; the channel of a vector
// follows from its offset, as C is a multiple of the vector width.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float act_f32(float t, float slope, float scale) {
  return scale * (t >= 0.f ? t : slope * t);
}

__device__ __forceinline__ float act_bf16(float xv, float bias, float slope,
                                          float scale) {
  const float t = round_bf16(xv + round_bf16(bias));
  return scale * (t >= 0.f ? t : round_bf16(slope * t));  // rounded on store
}

__global__ void __launch_bounds__(kThreads)
    fused_act_f32_kernel(const float4* __restrict__ x,
                         const float* __restrict__ bias, float4* __restrict__ y,
                         size_t vecs, int c, float slope, float scale) {
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < vecs; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const int c0 = static_cast<int>((i * 4) % c);
    const float4 v = x[i];
    const float4 bb = *reinterpret_cast<const float4*>(bias + c0);
    y[i] = make_float4(act_f32(v.x + bb.x, slope, scale),
                       act_f32(v.y + bb.y, slope, scale),
                       act_f32(v.z + bb.z, slope, scale),
                       act_f32(v.w + bb.w, slope, scale));
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_act_bf16_kernel(const uint4* __restrict__ x,
                          const float* __restrict__ bias, uint4* __restrict__ y,
                          size_t vecs, int c, float slope, float scale) {
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < vecs; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const int c0 = static_cast<int>((i * 8) % c);
    const uint4 raw = x[i];
    const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 out;
    uint32_t* ho = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(hx[k]);
      ho[k] = pack_bf16x2(
          act_bf16(f.x, bias[c0 + 2 * k], slope, scale),
          act_bf16(f.y, bias[c0 + 2 * k + 1], slope, scale));
    }
    y[i] = out;
  }
}

}  // namespace

ETK_API int etk_fused_act(const void* x, const void* bias, void* y, long long m,
                          int c, float slope, float scale, int dtype,
                          void* stream) {
  const int vec = dtype == ETK_F32 ? 4 : dtype == ETK_BF16 ? 8 : 0;
  if (vec == 0 || m <= 0 || c <= 0 || c % vec) return ETK_BAD_ARGS;
  const size_t vecs = static_cast<size_t>(m) * c / vec;
  const size_t want = (vecs + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ETK_F32)
    fused_act_f32_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const float*>(bias),
        static_cast<float4*>(y), vecs, c, slope, scale);
  else
    fused_act_bf16_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const float*>(bias),
        static_cast<uint4*>(y), vecs, c, slope, scale);
  return static_cast<int>(cudaGetLastError());
}

// Helpers shared by the kernels of this directory: dtype codes, the SM
// count, bf16 packing, warp reductions, activations and the sm_80+
// tensor-core instructions (ldmatrix, mma.sync m16n8k16 bf16 with fp32
// accumulation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#define ETK_API extern "C" __attribute__((visibility("default")))

// dtype codes passed by the Python wrappers
constexpr int ETK_F32 = 0;
constexpr int ETK_BF16 = 1;
constexpr int ETK_INT8 = 2;  // weights and the int8 KV cache

// activation codes of fused_ln_gemm
constexpr int ACT_NONE = 0;
constexpr int ACT_TANH = 1;
constexpr int ACT_SQRELU = 2;
constexpr int ACT_GELU = 3;

// return code for arguments a kernel does not take
constexpr int ETK_BAD_ARGS = -1;

// SMs of the current card (0 if the query fails), asked once
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 0;
  }
  return count;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fp32 activation, as ops/ln_gemm.py::_act applies it to the fp32 product;
// gelu is the tanh approximation (jax.nn.gelu's default)
__device__ __forceinline__ float apply_act(float h, int act) {
  switch (act) {
    case ACT_TANH:
      return tanhf(h);
    case ACT_SQRELU: {
      float r = fmaxf(h, 0.f);
      return r * r;
    }
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
    }
    default:
      return h;
  }
}

// key col of m exists and query row may see it under mask mode 'none'
// (causal false) or 'prefix_causal' (col <= row, or both < cond_len)
__device__ __forceinline__ bool visible(int row, int col, int m, bool causal,
                                        int cond_len) {
  return col < m &&
         (!causal || col <= row || (row < cond_len && col < cond_len));
}

// e^(x - m) given ml2 = m log2(e): 2^(x log2(e) - ml2) by one fused
// multiply-add and the hardware's base-2 exponential (ex2.approx, relative
// error ~2^-22), an fp32 exponential as flash attention takes it; x = -inf
// gives 0. With c = scale log2(e) and ml2 = m c, e^(scale (x - m)).
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp_shifted(float x, float ml2,
                                             float c = kLog2e) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(fmaf(x, c, -ml2)));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the row address of
// matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b on a 16x8x16 tile: a row-major (16 x k16), b "col" (k16 x 8,
// stored n-major with k contiguous), fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous global -> shared copy; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

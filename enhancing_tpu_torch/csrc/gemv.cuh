// Weight-streaming products for the decode step's few rows: the shared
// core of the int8 GEMM (int8_gemm.cu), the int8 LN + token-shift GEMM
// (int8_ln_gemm.cu), the bf16 LN + token-shift GEMM (ln_shift_gemm.cu) and
// the one-launch int8 MLP (int8_mlp.cu).
//
//   y[r, n] = epilogue(sum_k a[r, k] * W[n, k])   for up to 8 rows r
//
// W is (N, K) with K contiguous (torch's Linear layout), int8, bf16 or
// fp32; the activations a are fp32 values (an fp32 input, or a bf16 one
// widened exactly), so every product is an fp32 product of the numbers
// the JAX function multiplies, summed in fp32 on CUDA cores.
//
// Bound on the H100 at 8 rows: bytes. Each weight byte is read once and
// feeds 8 FMAs (one per row), about 70 fp32 operations per byte against
// the ~20 that 67 TFLOP/s over 3.35 TB/s allow, so the inner loop is
// written to spend few instructions a weight:
// - a warp owns CH output channels; each lane loads 16 bytes of each
//   channel's row per pass (512 k for int8), coalesced along K, and the
//   whole chunk's weights are in flight before the block stages its
//   activations;
// - the block stages 8 rows x 1024 k of activations in shared memory, as
//   fp32, permuted so that the 16 weights a lane holds meet 16 activations
//   that the warp reads as consecutive float4s (no bank conflicts), and
//   each activation read feeds CH channels;
// - int8 -> fp32 is one byte permute and one add per weight (the byte
//   placed in the mantissa of 2^23, then 2^23 + 128 subtracted), bf16 ->
//   fp32 a shift or a mask;
// - the 8 x CH sums are reduced across the warp once, at the end.
// A block of 8 warps owns 8 * CH channels and loops over K in chunks,
// staging each with all of a thread's loads in flight at once. With a
// LayerNorm in front, the rows are normalised once into an fp32 workspace
// by a cooperative launch (gemv_ln_kernel), not by every block.
// wgmma, TMA and split-K are left for later work.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace gemv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // activation rows per block
constexpr int kPass = 512;               // k per warp pass: 32 lanes x 16
constexpr int kChunk = 1024;             // k staged in shared memory
constexpr int kPasses = kChunk / kPass;
constexpr int kStageFloats = kRows * kChunk;

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

// ---- weight vectors: 16 weights per lane per pass -------------------------

template <typename WT>
struct W;

template <>
struct W<int8_t> {
  static constexpr int EPV = 16;  // elements per 16-byte vector
  static constexpr int NV = 1;    // vectors per lane per pass
  // weights 4 * j .. 4 * j + 3 of the lane's 16, as fp32
  __device__ __forceinline__ static void group(const uint4 (&raw)[NV], int j,
                                               float (&f)[4]) {
    const uint32_t u = (&raw[0].x)[j] ^ 0x80808080u;  // b + 128, unsigned
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(u, 0x00004B00u, 0x5440u | i)) -
             8388736.f;  // (2^23 + b + 128) - (2^23 + 128)
  }
};

template <>
struct W<__nv_bfloat16> {
  static constexpr int EPV = 8;
  static constexpr int NV = 2;
  __device__ __forceinline__ static void group(const uint4 (&raw)[NV], int j,
                                               float (&f)[4]) {
    const uint32_t* w = &raw[j / 2].x + (j % 2) * 2;
    f[0] = __uint_as_float(w[0] << 16);
    f[1] = __uint_as_float(w[0] & 0xffff0000u);
    f[2] = __uint_as_float(w[1] << 16);
    f[3] = __uint_as_float(w[1] & 0xffff0000u);
  }
};

template <>
struct W<float> {
  static constexpr int EPV = 4;
  static constexpr int NV = 4;
  __device__ __forceinline__ static void group(const uint4 (&raw)[NV], int j,
                                               float (&f)[4]) {
    f[0] = __uint_as_float(raw[j].x);
    f[1] = __uint_as_float(raw[j].y);
    f[2] = __uint_as_float(raw[j].z);
    f[3] = __uint_as_float(raw[j].w);
  }
};

// Position in the staged chunk of activation (row r, k offset kk): the
// lane that holds weight k of a pass keeps it in slot s, and slots 4j..4j+3
// of all 32 lanes are one run of 32 float4s.
template <typename WT>
__device__ __forceinline__ int stage_index(int r, int kk) {
  constexpr int EPV = W<WT>::EPV;
  const int pass = kk / kPass, kl = kk % kPass;
  const int v = kl / (32 * EPV), rem = kl % (32 * EPV);
  const int lane = rem / EPV, s = v * EPV + rem % EPV;
  return (((r * kPasses + pass) * 4 + s / 4) * 32 + lane) * 4 + s % 4;
}

// One block's product for channels [n0, n0 + kWarps * CH) of W (n x d)
// against the activation rows that `src(r, k)` gives, four values
// k .. k + 3 at a time (0 past the rows),
// then `epi(r, channel, sum)` for every row r < kRows and channel < n.
// Every thread of the block must call it (it synchronises the block).
template <typename WT, int CH, typename Src, typename Epi>
__device__ __forceinline__ void gemv_unit(const WT* __restrict__ w, int n0,
                                          int n, int d, float* xs,
                                          const Src& src, const Epi& epi) {
  constexpr int EPV = W<WT>::EPV, NV = W<WT>::NV;
  static_assert(kRows * CH <= 32, "one lane per (row, channel) sum");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const WT* rows[CH];
  bool valid[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int ch = n0 + warp * CH + c;
    valid[c] = ch < n;
    rows[c] = w + static_cast<size_t>(valid[c] ? ch : 0) * d;
  }
  float acc[kRows][CH];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    // this chunk's weights in flight while the activations are staged
    uint4 raw[kPasses][CH][NV];
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int k = k0 + p * kPass + v * 32 * EPV + lane * EPV;
          raw[p][c][v] = (valid[c] && k < d)
                             ? __ldg(reinterpret_cast<const uint4*>(
                                   rows[c] + k))
                             : make_uint4(0, 0, 0, 0);
        }
    // the chunk's activations, four consecutive k a thread (they land in
    // one float4 of the staged layout), all loads of a thread in flight
    // together
    constexpr int kVecs = kStageFloats / 4 / kThreads;
    float4 staged[kVecs];
#pragma unroll
    for (int it = 0; it < kVecs; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (kChunk / 4), k = k0 + (i % (kChunk / 4)) * 4;
      staged[it] = k < d ? src(r, k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // the previous chunk's products are done
#pragma unroll
    for (int it = 0; it < kVecs; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (kChunk / 4), kk = (i % (kChunk / 4)) * 4;
      *reinterpret_cast<float4*>(&xs[stage_index<WT>(r, kk)]) = staged[it];
    }
    __syncthreads();
    const float4* xv4 = reinterpret_cast<const float4*>(xs);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if (k0 + p * kPass >= d) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float wf[CH][4];
#pragma unroll
        for (int c = 0; c < CH; ++c) W<WT>::group(raw[p][c], j, wf[c]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 xv = xv4[((r * kPasses + p) * 4 + j) * 32 + lane];
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            float a = acc[r][c];
            a = fmaf(xv.x, wf[c][0], a);
            a = fmaf(xv.y, wf[c][1], a);
            a = fmaf(xv.z, wf[c][2], a);
            a = fmaf(xv.w, wf[c][3], a);
            acc[r][c] = a;
          }
        }
      }
    }
  }

  float mine = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float t = warp_sum(acc[r][c]);
      if (lane == r * CH + c) mine = t;
    }
  if (lane < kRows * CH) {
    const int r = lane / CH, c = lane % CH;
    if (valid[c]) epi(r, n0 + warp * CH + c, mine);
  }
}

// ---- activation sources ------------------------------------------------------

// rows [row0, row0 + 8) of an (m, d) fp32 or bf16 tensor
template <typename XT>
struct RowsSrc {
  const XT* x;
  int row0, m, d;
  __device__ __forceinline__ float4 operator()(int r, int k) const {
    const int row = row0 + r;
    return row < m ? ld4(x + static_cast<size_t>(row) * d + k)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// fp32 workspace rows, `rows` of them valid, written earlier in the same
// kernel (plain loads: the read-only cache is not coherent with them)
struct WsSrc {
  const float* ws;
  int rows, stride;
  __device__ __forceinline__ float4 operator()(int r, int k) const {
    return r < rows ? *reinterpret_cast<const float4*>(
                          ws + static_cast<size_t>(r) * stride + k)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// LN(x) of one element, as flax computes it (the statistics in fp32, the
// fast variance), rounded to x's dtype
template <typename XT>
__device__ __forceinline__ float ln_one(float v, float g, float b,
                                        float mean, float rstd) {
  return round_to<XT>(
      __fadd_rn(__fmul_rn(__fsub_rn(v, mean), __fmul_rn(rstd, g)), b));
}

// the token shift xn * tm + prev * (1 - tm), each step in x's dtype
template <typename XT>
__device__ __forceinline__ float mix_one(float xr, float t, float p) {
  const float tmx = round_to<XT>(t);
  const float a = round_to<XT>(__fmul_rn(xr, tmx));
  const float one_m = round_to<XT>(__fsub_rn(1.f, tmx));
  const float b = round_to<XT>(__fmul_rn(round_to<XT>(p), one_m));
  return round_to<XT>(__fadd_rn(a, b));
}

// One block normalises row `row` of x (m, d): LN(x) rounded to x's dtype
// into xn (if not null, x's dtype), and the product's input (LN(x), or
// with tm its token shift against prev) into the fp32 row ws_row.
// `red`: 2 * kWarps floats of shared memory. Every thread must call it.
template <typename XT>
__device__ __forceinline__ void ln_row(const XT* __restrict__ x,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       const float* __restrict__ tm,
                                       const void* prev, int prev_dtype,
                                       XT* xn, float* ws_row, int row, int d,
                                       float eps, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const XT* xr = x + static_cast<size_t>(row) * d;
  float s = 0.f, ss = 0.f;
#pragma unroll 2
  for (int k = threadIdx.x * 4; k < d; k += kThreads * 4) {
    const float4 v = ld4(xr + k);
    s += (v.x + v.y) + (v.z + v.w);
    ss = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss))));
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    red[warp] = s;
    red[kWarps + warp] = ss;
  }
  __syncthreads();
  s = 0.f;
  ss = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    s += red[w];
    ss += red[kWarps + w];
  }
  const float mean = s / d;
  const float rstd = 1.f / sqrtf(fmaxf(ss / d - mean * mean, 0.f) + eps);
  for (int k = threadIdx.x * 4; k < d; k += kThreads * 4) {
    const size_t i = static_cast<size_t>(row) * d + k;
    const float4 v = ld4(xr + k), g = ld4(gamma + k), b = ld4(beta + k);
    float4 o = make_float4(ln_one<XT>(v.x, g.x, b.x, mean, rstd),
                           ln_one<XT>(v.y, g.y, b.y, mean, rstd),
                           ln_one<XT>(v.z, g.z, b.z, mean, rstd),
                           ln_one<XT>(v.w, g.w, b.w, mean, rstd));
    if (xn != nullptr) st4(xn + i, o);
    if (tm != nullptr) {
      const float4 t = ld4(tm + k), p = ld4_any(prev, prev_dtype, i);
      o = make_float4(mix_one<XT>(o.x, t.x, p.x), mix_one<XT>(o.y, t.y, p.y),
                      mix_one<XT>(o.z, t.z, p.z), mix_one<XT>(o.w, t.w, p.w));
    }
    *reinterpret_cast<float4*>(ws_row + k) = o;
  }
  __syncthreads();  // red is reused by the block's next row
}

// ---- the epilogue of a product --------------------------------------------------

// out[row, ch] = act(sum * scale[ch] + bias[ch]) + residual[row, ch],
// rounded once to out's dtype; scale, bias and residual optional
template <typename OT>
struct OutEpi {
  OT* out;
  const float* scale;
  const void* bias;
  int bias_dtype;
  const float* residual;  // fp32 (m, n)
  int act, row0, m, n;
  __device__ __forceinline__ void operator()(int r, int ch, float v) const {
    const int row = row0 + r;
    if (row >= m) return;
    if (scale != nullptr) v = __fmul_rn(v, scale[ch]);
    if (bias != nullptr) v = __fadd_rn(v, load_any(bias, bias_dtype, ch));
    v = apply_act(v, act);
    const size_t i = static_cast<size_t>(row) * n + ch;
    if (residual != nullptr) v = __fadd_rn(v, residual[i]);
    out[i] = from_f32<OT>(v);
  }
};

// ---- the GEMM, and the cooperative LN (-> shift) -> GEMM ---------------------

struct GemvArgs {
  const void* x;       // (m, d) fp32 or bf16
  const float* gamma;  // LayerNorm (the LN kernel)
  const float* beta;
  const float* tm;     // time_mix (d,), null: no shift
  const void* prev;    // shift state (m, d)
  int prev_dtype;
  const void* w;       // (n, d)
  const float* scale;  // (n,) or null
  const void* bias;    // (n,) or null
  int bias_dtype;
  const float* residual;  // (m, n) fp32 or null
  void* out;           // (m, n), x's dtype
  void* xn;            // (m, d) LN(x), x's dtype (the LN kernel)
  float* ws;           // kRows * d fp32 (the LN kernel)
  int m, d, n, act;
  float eps;
};

template <typename WT>
struct Channels {
  static constexpr int CH = sizeof(WT) == 4 ? 2 : 4;  // registers
};

// y = epilogue(x @ W^T): a block a unit of channels, a row tile a grid row
template <typename WT, typename XT>
__global__ void __launch_bounds__(kThreads, 2) gemv_kernel(GemvArgs a) {
  constexpr int CH = Channels<WT>::CH;
  __shared__ __align__(16) float xs[kStageFloats];
  const int row0 = blockIdx.y * kRows;
  const OutEpi<XT> epi{static_cast<XT*>(a.out), a.scale, a.bias,
                       a.bias_dtype, a.residual, a.act, row0, a.m, a.n};
  gemv_unit<WT, CH>(static_cast<const WT*>(a.w), blockIdx.x * kWarps * CH,
                    a.n, a.d, xs,
                    RowsSrc<XT>{static_cast<const XT*>(a.x), row0, a.m, a.d},
                    epi);
}

// LN (-> shift) -> GEMM as one cooperative launch, per tile of 8 rows:
// the blocks of the first rows normalise one row each into the fp32
// workspace (and write LN(x) once); a grid-wide barrier; every block then
// takes units of channels, staging the workspace's rows. The rows are
// normalised once, not once per block.
template <typename WT, typename XT>
__global__ void __launch_bounds__(kThreads, 2) gemv_ln_kernel(GemvArgs a) {
  constexpr int CH = Channels<WT>::CH;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ __align__(16) float xs[kStageFloats];
  __shared__ float red[2 * kWarps];
  const int units = (a.n + kWarps * CH - 1) / (kWarps * CH);
  for (int row0 = 0; row0 < a.m; row0 += kRows) {
    const int rows = min(kRows, a.m - row0);
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      ln_row(static_cast<const XT*>(a.x), a.gamma, a.beta, a.tm, a.prev,
             a.prev_dtype, static_cast<XT*>(a.xn),
             a.ws + static_cast<size_t>(r) * a.d, row0 + r, a.d, a.eps, red);
    grid.sync();
    const OutEpi<XT> epi{static_cast<XT*>(a.out), a.scale, a.bias,
                         a.bias_dtype, a.residual, a.act, row0, a.m, a.n};
    for (int u = blockIdx.x; u < units; u += gridDim.x)
      gemv_unit<WT, CH>(static_cast<const WT*>(a.w), u * kWarps * CH, a.n,
                        a.d, xs, WsSrc{a.ws, rows, a.d}, epi);
    grid.sync();  // the next tile's rows overwrite the workspace
  }
}

// checks shared by the entry points: -1 for what the kernels do not take
__host__ __forceinline__ bool bad_shape(int m, int d, int n, int act) {
  return m <= 0 || d <= 0 || n <= 0 || d % 16 != 0 || act < ACT_NONE ||
         act > ACT_GELU || (m + kRows - 1) / kRows > 65535;
}

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

// a cooperative launch of as many blocks as fit on the card at once
template <typename Args>
int launch_cooperative(void (*kernel)(Args), Args args, cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (per_sm <= 0 || sms <= 0) return ETK_BAD_ARGS;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(per_sm * sms), dim3(kThreads),
                                    params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT, typename XT, bool WITH_LN>
int launch(const GemvArgs& a, cudaStream_t stream) {
  if constexpr (WITH_LN) {
    return launch_cooperative(gemv_ln_kernel<WT, XT>, a, stream);
  } else {
    constexpr int per_block = kWarps * Channels<WT>::CH;
    dim3 grid((a.n + per_block - 1) / per_block, (a.m + kRows - 1) / kRows);
    gemv_kernel<WT, XT><<<grid, kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

// x's dtype code -> the kernel for weights WT
template <typename WT, bool WITH_LN>
int launch_x(const GemvArgs& a, int x_dtype, cudaStream_t stream) {
  if (x_dtype == ETK_F32) return launch<WT, float, WITH_LN>(a, stream);
  if (x_dtype == ETK_BF16)
    return launch<WT, __nv_bfloat16, WITH_LN>(a, stream);
  return ETK_BAD_ARGS;
}

}  // namespace gemv

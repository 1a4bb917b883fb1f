// One-token attention against one layer of a stacked KV cache, with the
// current token's key and value folded in as one extra softmax term:
//
//   out[b, h] = softmax([q . k_j for j < cur[b]] ++ [q . k_new]) [v_j ++ v_new]
//
// per (batch row b, head h), q pre-scaled. q, k_new, v_new and out are
// (B, H*D); the caches are (L, B, ctx, H*D) and `layer` selects the layer
// inside the kernel: the stack is neither sliced nor copied.
//
// Replaces enhancing_tpu/ops/attention.py::_decode_kernel (entered through
// _decode_pallas). What it keeps: only rows < cur[b] of the selected layer
// are read, cur is per row (a scalar is passed by value), the new token is
// the extra softmax term, and the softmax is fp32. The TPU kernel's means
// (q masked per head to score all heads in one MXU product, block sizes
// picked against a 16 MB VMEM limit, index maps that clamp dead chunks) are
// not reproduced.
//
// Types: q (and out) fp32 or bf16; the cache bf16, fp32 or int8. With an
// int8 cache, per-row fp32 scales k_scale, v_scale (L, B, ctx) ride beside
// it, k_new and v_new are in q's dtype, and, as the TPU kernel does, the
// scores of a chunk are multiplied by their keys' scales and the softmax
// weights by their values' scales before the sum with V (exact in the
// scale factorization); otherwise k_new and v_new are in the cache's dtype.
//
// Bound on the H100: bytes. Each cached key and value is read once, 2 * D
// * itemsize bytes per position per head for 4 * D flops: far below the
// card's ~295 flops per byte, so the work is done on CUDA cores in fp32.
// Design (split over keys, as flash-decoding does): at batch 8 there are
// only B * H = 128 (row, head) pairs for 132 SMs, so the keys are split
// into chunks of 32 and every (chunk, head, row) is a block of 128 threads.
// A block stages its chunk's K and V rows in shared memory with cp.async
// (each row 16-byte vectors, coalesced), scores them (warp w sums every
// fourth vector of the row for the 32 keys of its lanes; the four partial
// sums meet in shared memory), takes the chunk's max m and sum l of
// exp(s - m) in fp32 and writes m, l and the unnormalised sum of
// exp(s - m) v to an fp32 workspace. A second kernel, one block per (head,
// row), scores the new token, rescales each chunk's partial by exp(m_c -
// M) against the overall max M and writes the normalised output. Chunks
// past cur[b] return before loading anything.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // keys per block

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16(x);
}

// valid cache rows of batch row b, clamped to [0, ctx]
__device__ __forceinline__ int row_len(const int* cur_vec, int cur_scalar,
                                       int b, int ctx) {
  const int cur = cur_vec != nullptr ? cur_vec[b] : cur_scalar;
  return min(max(cur, 0), ctx);
}

// Shared memory of the split kernel: K and V chunks (rows padded by 16
// bytes, so the lanes of a warp, one key each, hit distinct banks), q in
// fp32, the four partial scores of each key, and the chunk's weights.
__host__ __device__ constexpr int row_pitch(int d, int itemsize) {
  return d * itemsize + 16;
}

__host__ __device__ constexpr int split_smem_bytes(int d, int itemsize) {
  return 2 * kChunk * row_pitch(d, itemsize) + d * 4 + 4 * kChunk * 4 +
         kChunk * 4;
}

template <typename Q, typename T>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const Q* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ cur_vec, int cur_scalar,
                        int layer, int b_total, int ctx, int heads, int d,
                        int n_splits, float* __restrict__ ws_o,
                        float* __restrict__ ws_ml) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int cur = row_len(cur_vec, cur_scalar, b, ctx);
  const int k0 = split * kChunk;
  if (k0 >= cur) return;
  const int nk = min(kChunk, cur - k0);
  const int hd = heads * d;
  const int vpr = d / EPV;  // 16-byte vectors per head row
  const int pitch = row_pitch(d, sizeof(T));

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vs = smem + kChunk * pitch;
  float* qs = reinterpret_cast<float*>(smem + 2 * kChunk * pitch);
  float* part = qs + d;           // [4][kChunk]
  float* weight = part + 4 * kChunk;  // [kChunk]

  const size_t row0 =
      (static_cast<size_t>(layer) * b_total + b) * ctx + k0;  // cache row
  const T* kb = kc + row0 * hd + static_cast<size_t>(h) * d;
  const T* vb = vc + row0 * hd + static_cast<size_t>(h) * d;
  for (int i = threadIdx.x; i < nk * vpr; i += kThreads) {
    const int r = i / vpr, c = i % vpr;
    const size_t off = static_cast<size_t>(r) * hd + c * EPV;
    cp_async_16(ks + r * pitch + c * 16, kb + off, 16);
    cp_async_16(vs + r * pitch + c * 16, vb + off, 16);
  }
  cp_async_commit();
  const Q* qb = q + static_cast<size_t>(b) * hd + static_cast<size_t>(h) * d;
  for (int i = threadIdx.x; i < d; i += kThreads) qs[i] = to_f32(qb[i]);
  cp_async_wait<0>();
  __syncthreads();

  // scores: lane = key, warp w sums vectors w, w + 4, ... of its key's row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < nk) {
    float acc = 0.f;
    const unsigned char* krow = ks + lane * pitch;
    for (int c = warp; c < vpr; c += kThreads / 32) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 16);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < EPV; ++e) acc += qs[c * EPV + e] * to_f32(vals[e]);
    }
    part[warp * kChunk + lane] = acc;
  }
  __syncthreads();

  // the chunk's max and sum of exp(s - m), fp32, in warp 0
  if (warp == 0) {
    float s = -INFINITY;
    if (lane < nk) {
      s = part[lane] + part[kChunk + lane] + part[2 * kChunk + lane] +
          part[3 * kChunk + lane];
      if (k_scale != nullptr) s *= k_scale[row0 + lane];  // int8 keys
    }
    float m = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e = lane < nk ? expf(s - m) : 0.f;
    // int8 values: the weights carry their rows' scales into the sum
    weight[lane] = (v_scale != nullptr && lane < nk) ? e * v_scale[row0 + lane]
                                                     : e;
    const float l = warp_sum(e);
    if (lane == 0) {
      const size_t slot =
          (static_cast<size_t>(b) * heads + h) * n_splits + split;
      ws_ml[2 * slot] = m;
      ws_ml[2 * slot + 1] = l;
    }
  }
  __syncthreads();

  // unnormalised sum of e_j v_j over the chunk's keys, fp32
  const size_t slot = (static_cast<size_t>(b) * heads + h) * n_splits + split;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < nk; ++j)
      acc += weight[j] * to_f32(reinterpret_cast<const T*>(vs + j * pitch)[c]);
    ws_o[slot * d + c] = acc;
  }
}

template <typename Q, typename N>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const Q* __restrict__ q, const N* __restrict__ kn,
                          const N* __restrict__ vn,
                          const int* __restrict__ cur_vec, int cur_scalar,
                          int ctx, int heads, int d, int n_splits,
                          const float* __restrict__ ws_o,
                          const float* __restrict__ ws_ml,
                          Q* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int cur = row_len(cur_vec, cur_scalar, b, ctx);
  const int ns = min((cur + kChunk - 1) / kChunk, n_splits);
  const size_t base = static_cast<size_t>(b) * heads * d +
                      static_cast<size_t>(h) * d;

  // the new token's score, q . k_new in fp32
  __shared__ float red[kThreads / 32];
  float acc = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads)
    acc += to_f32(q[base + c]) * to_f32(kn[base + c]);
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = acc;
  __syncthreads();
  float s_self = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s_self += red[w];

  const size_t slot0 = (static_cast<size_t>(b) * heads + h) * n_splits;
  float mx = s_self;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, ws_ml[2 * (slot0 + s)]);
  const float e_self = expf(s_self - mx);
  float denom = e_self;
  for (int s = 0; s < ns; ++s)
    denom += ws_ml[2 * (slot0 + s) + 1] * expf(ws_ml[2 * (slot0 + s)] - mx);
  const float inv = 1.f / denom;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float o = e_self * to_f32(vn[base + c]);
    for (int s = 0; s < ns; ++s)
      o += ws_o[(slot0 + s) * d + c] * expf(ws_ml[2 * (slot0 + s)] - mx);
    out[base + c] = from_f32<Q>(o * inv);
  }
}

// N, the dtype of k_new and v_new: q's beside an int8 cache, else the
// cache's
template <typename Q, typename T>
struct NewType {
  using type = T;
};
template <typename Q>
struct NewType<Q, int8_t> {
  using type = Q;
};

template <typename Q, typename T>
int launch(const void* q, const void* kc, const void* vc, const void* kn,
           const void* vn, const float* ks, const float* vs,
           const void* cur_vec, int cur_scalar, int layer, int b, int ctx,
           int heads, int d, int n_splits, void* ws, void* out,
           cudaStream_t stream) {
  using N = typename NewType<Q, T>::type;
  constexpr bool kInt8 = sizeof(T) == 1;
  if ((d * static_cast<int>(sizeof(T))) % 16) return ETK_BAD_ARGS;
  if (kInt8 != (ks != nullptr) || kInt8 != (vs != nullptr))
    return ETK_BAD_ARGS;  // scales go with an int8 cache and only with it
  const int bytes = split_smem_bytes(d, sizeof(T));
  if (bytes > 227 * 1024) return ETK_BAD_ARGS;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<Q, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* ws_o = static_cast<float*>(ws);
  float* ws_ml = ws_o + static_cast<size_t>(b) * heads * n_splits * d;
  const int* cv = static_cast<const int*>(cur_vec);
  decode_split_kernel<Q, T><<<dim3(n_splits, heads, b), kThreads, bytes,
                              stream>>>(
      static_cast<const Q*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), ks, vs, cv, cur_scalar, layer, b, ctx, heads,
      d, n_splits, ws_o, ws_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<Q, N><<<dim3(heads, b), kThreads, 0, stream>>>(
      static_cast<const Q*>(q), static_cast<const N*>(kn),
      static_cast<const N*>(vn), cv, cur_scalar, ctx, heads, d, n_splits, ws_o,
      ws_ml, static_cast<Q*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ws: b * heads * n_splits * (d + 2) floats; n_splits * 32 must cover
// every row's cur (the wrapper sizes it). (q dtype, cache dtype): (bf16,
// bf16), (f32, f32), (f32, bf16), (f32, int8), (bf16, int8); k_scale and
// v_scale (L, B, ctx) fp32 with an int8 cache, null otherwise.
ETK_API int etk_decode_attention(const void* q, const void* kc, const void* vc,
                                 const void* kn, const void* vn,
                                 const void* cur_vec, int cur_scalar,
                                 int layer, int b, int ctx, int heads, int d,
                                 int n_splits, void* ws, void* out,
                                 const void* k_scale, const void* v_scale,
                                 int q_dtype, int cache_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || ctx <= 0 || heads <= 0 || d <= 0 || layer < 0 ||
      n_splits <= 0 || n_splits > 2147483647 / kChunk || heads > 65535 ||
      b > 65535)
    return ETK_BAD_ARGS;
  if (cur_vec == nullptr &&
      (cur_scalar < 0 || cur_scalar > ctx || cur_scalar > n_splits * kChunk))
    return ETK_BAD_ARGS;
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
#define ETK_DECODE(Q, T)                                                    \
  return launch<Q, T>(q, kc, vc, kn, vn, ks, vs, cur_vec, cur_scalar, layer, \
                      b, ctx, heads, d, n_splits, ws, out, s)
  if (q_dtype == ETK_BF16 && cache_dtype == ETK_BF16)
    ETK_DECODE(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == ETK_F32 && cache_dtype == ETK_F32) ETK_DECODE(float, float);
  if (q_dtype == ETK_F32 && cache_dtype == ETK_BF16)
    ETK_DECODE(float, __nv_bfloat16);
  if (q_dtype == ETK_F32 && cache_dtype == ETK_INT8) ETK_DECODE(float, int8_t);
  if (q_dtype == ETK_BF16 && cache_dtype == ETK_INT8)
    ETK_DECODE(__nv_bfloat16, int8_t);
#undef ETK_DECODE
  return ETK_BAD_ARGS;
}

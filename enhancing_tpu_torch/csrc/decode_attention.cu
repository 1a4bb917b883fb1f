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
// scores are multiplied by their keys' scales and the softmax weights by
// their values' scales before the sum with V (exact in the scale
// factorization); otherwise k_new and v_new are in the cache's dtype.
//
// Bound on the H100: bytes. Each cached key and value is read once, 2 * D
// * itemsize bytes per position per head for 4 * D flops: far below the
// card's ~295 flops per byte, so the work is done on CUDA cores in fp32
// (one query row gives a tensor core nothing to reuse). At the prior's
// batch 8 there are only B * H = 128 (row, head) pairs for 132 SMs, so
// each pair's keys are cut into kSplits = 16 contiguous splits of
// ceil(cur / 16) keys (flash-decoding), whatever cur is: the grid is the
// same from cur_len 1 to ctx and serves a ragged batch with no block that
// exits at once. A pair is one thread-block cluster of kCluster = 2
// blocks of kWarps = 8 warps, one split a warp; the 256 blocks of the
// prior's step (72 KiB of shared memory each) are resident together. On
// the H100 this beat 4 x 4 warps by 15% and 1 x 16 by 8% at cur_len 512,
// and two or four ring stages a warp, or stages twice as long, ran slower
// (PERF.md). Each warp streams its keys through its own ring of kStages = 3
// stages: lane 0 posts a stage's bytes on its mbarrier and issues one bulk
// copy (cp.async.bulk) per key row of K and of V, so two stages are in
// flight while one is scored. A stage holds 4 / itemsize keys (bf16 2,
// int8 4), 8 * D bytes. Each lane owns 4 lanes of the head per 128 (3 at D
// = 384, the same for every dtype): q sits in its registers in fp32, a
// key's score is the lanes' partial dots summed across the warp by
// shuffles, the running max and sum of exp(s - m) (expf: the work is
// bytes-bound) are updated once a stage and P V accumulates in fp32 in the
// lane's registers; an int8 cache's row scales are loaded a stage ahead,
// out of the scores' dependency chain. At the end each
// warp leaves (m, l, O) in its block's shared memory; after a cluster
// barrier, rank r merges the 16 partials and the new token for its half
// of the lanes, reading the peers' shared memory (distributed shared
// memory), and writes the output; a second cluster barrier keeps every
// block's partials alive until its peers are done. One launch, no
// device-memory workspace.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kWarps = 8, kCluster = 2, kSplits = kWarps * kCluster;
constexpr int kStages = 3;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 4 * 32 * 4;  // 4 lanes a chunk, 4 chunks a lane

template <typename T>
__host__ __device__ constexpr int keys_per_stage() {
  return 4 / static_cast<int>(sizeof(T));
}

// bytes of dynamic shared memory: every warp's ring of K and V rows (8 D
// bytes a stage), which at the end holds the warp's partial O and (m, l)
__host__ __device__ constexpr int decode_smem_bytes(int d, int itemsize) {
  return kWarps * kStages * 2 * (4 / itemsize) * d * itemsize;
}

// 4 consecutive elements of a row as fp32
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16), x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16), x[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// valid cache rows of batch row b, clamped to [0, ctx]
__device__ __forceinline__ int row_len(const int* cur_vec, int cur_scalar,
                                       int b, int ctx) {
  const int cur = cur_vec != nullptr ? cur_vec[b] : cur_scalar;
  return min(max(cur, 0), ctx);
}

struct DecodeArgs {
  const int* cur_vec;
  const float* k_scale;  // (L, B, ctx) with an int8 cache, else null
  const float* v_scale;
  int cur_scalar, layer, b, ctx, heads, d;
};

// Q: q and out; T: the cache; N: k_new and v_new; J: 128-lane groups of
// the head (4 lanes a lane each)
template <typename Q, typename T, typename N, int J>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const Q* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const N* __restrict__ kn,
                  const N* __restrict__ vn, Q* __restrict__ out,
                  DecodeArgs a) {
  constexpr int KPS = keys_per_stage<T>();
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kWarps][kStages];
  // the merge weights of the splits and the new token, 1 / denom, and the
  // new token's score
  __shared__ float wts[kSplits + 3];

  const int d = a.d, hd = a.heads * a.d, rowbytes = d * sizeof(T);
  const int pair = blockIdx.x / kCluster;
  const int rank = static_cast<int>(sm90::cluster_rank());
  const int h = pair % a.heads, b = pair / a.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cur = row_len(a.cur_vec, a.cur_scalar, b, a.ctx);
  const int per = (cur + kSplits - 1) / kSplits;
  const int k0 = min(cur, (rank * kWarps + warp) * per);
  const int k1 = min(cur, k0 + per);
  const int n_stages = (k1 - k0 + KPS - 1) / KPS;

  const int stage_bytes = 2 * KPS * rowbytes;
  const int ring_bytes = kStages * stage_bytes;
  uint8_t* ring = smem + warp * ring_bytes;
  // after the warp's last stage its ring holds its partial O (d floats),
  // then m and l
  float* part = reinterpret_cast<float*>(ring);

  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w)
      for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[w][s], 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // this (layer, batch row)'s rows of head h
  const size_t row0 = (static_cast<size_t>(a.layer) * a.b + b) * a.ctx;
  const T* kbase = kc + row0 * hd + static_cast<size_t>(h) * d;
  const T* vbase = vc + row0 * hd + static_cast<size_t>(h) * d;
  // stage st of this warp's keys, by the whole warp: lane 0 posts the
  // bytes, then lane j < nk copies key j's K row and lane KPS + j its V row
  auto issue = [&](int st) {
    const int key = k0 + st * KPS, nk = min(KPS, k1 - key);
    uint8_t* dst = ring + (st % kStages) * stage_bytes;
    uint64_t* bar = &full[warp][st % kStages];
    if (lane == 0) sm90::mbar_expect_tx(bar, 2 * nk * rowbytes);
    __syncwarp();
    const int j = lane % KPS;
    if (lane < 2 * KPS && j < nk)
      sm90::bulk_load(dst + lane * rowbytes,
                      (lane < KPS ? kbase : vbase) +
                          static_cast<size_t>(key + j) * hd,
                      rowbytes, bar);
  };
  for (int st = 0; st < min(kStages, n_stages); ++st) issue(st);

  // lane's lanes of the head: 4 at c = 4 (lane + 32 j), j < J
  const size_t base = static_cast<size_t>(b) * hd + static_cast<size_t>(h) * d;
  float qv[J][4], o[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = 4 * (lane + 32 * j);
    if (c < d) load4(q + base + c, qv[j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;
  // int8: the keys' and values' row scales of the next stage, loaded a
  // stage ahead (lane kk < KPS holds key kk's) so that their latency is
  // not in the chain of the scores
  float ksc = 0.f, vsc = 0.f;
  auto load_scales = [&](int st) {
    const int key = k0 + st * KPS + lane;
    if (kInt8 && st < n_stages && lane < KPS && key < k1) {
      ksc = a.k_scale[row0 + key];
      vsc = a.v_scale[row0 + key];
    }
  };
  load_scales(0);

  for (int st = 0; st < n_stages; ++st) {
    const float ksc_st = ksc, vsc_st = vsc;
    load_scales(st + 1);
    sm90::mbar_wait(&full[warp][st % kStages], (st / kStages) & 1);
    const uint8_t* ks = ring + (st % kStages) * stage_bytes;
    const uint8_t* vs = ks + KPS * rowbytes;
    const int key = k0 + st * KPS, nk = min(KPS, k1 - key);
    float s[KPS];
#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) {
      float acc = 0.f;
      if (kk < nk) {
        const T* krow = reinterpret_cast<const T*>(ks + kk * rowbytes);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = 4 * (lane + 32 * j);
          if (c < d) {
            float x[4];
            load4(krow + c, x);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc = fmaf(qv[j][e], x[e], acc);
          }
        }
      }
      s[kk] = acc;
    }
#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) {
      s[kk] = warp_sum(s[kk]);
      if (kInt8) s[kk] *= __shfl_sync(0xffffffffu, ksc_st, kk);
      if (kk >= nk) s[kk] = -INFINITY;
    }
    float m_new = m_run;
#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) m_new = fmaxf(m_new, s[kk]);
    // m_new is finite: the stage holds a key
    const float alpha = expf(m_run - m_new);
    float p[KPS], psum = 0.f;
#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) {
      p[kk] = expf(s[kk] - m_new);
      psum += p[kk];
      // int8 values: the weights carry their rows' scales into the sum
      if (kInt8) p[kk] *= __shfl_sync(0xffffffffu, vsc_st, kk);
    }
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha;
#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) {
      if (kk < nk) {
        const T* vrow = reinterpret_cast<const T*>(vs + kk * rowbytes);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = 4 * (lane + 32 * j);
          if (c < d) {
            float x[4];
            load4(vrow + c, x);
#pragma unroll
            for (int e = 0; e < 4; ++e) o[j][e] = fmaf(p[kk], x[e], o[j][e]);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the stage before it refills
    if (st + kStages < n_stages) issue(st + kStages);
  }

  // this warp's partial (every stage it issued has landed and been read,
  // so its ring is free); warp 0 also scores the new token
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = 4 * (lane + 32 * j);
    if (c < d)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[c + e] = o[j][e];
  }
  if (lane == 0) {
    part[d] = m_run;
    part[d + 1] = l_run;
  }
  if (warp == 0) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = 4 * (lane + 32 * j);
      if (c < d) {
        float x[4];
        load4(kn + base + c, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc = fmaf(qv[j][e], x[e], acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) wts[kSplits + 2] = acc;
  }
  sm90::cluster_arrive();
  sm90::cluster_wait();

  // the merge: weights of the 16 partials and the new token
  if (warp == 0) {
    float mi = -INFINITY, li = 0.f;
    if (lane < kSplits) {
      // split i is warp i % kWarps of cluster rank i / kWarps
      const uint32_t ml_addr =
          smem_addr(smem + (lane % kWarps) * ring_bytes) + 4 * d;
      mi = sm90::ld_peer(sm90::peer_addr(ml_addr, lane / kWarps));
      li = sm90::ld_peer(sm90::peer_addr(ml_addr + 4, lane / kWarps));
    }
    const float s_self = wts[kSplits + 2];
    const float mx = fmaxf(warp_max(mi), s_self);
    const float e = expf(mi - mx), e_self = expf(s_self - mx);
    const float denom = warp_sum(li * e) + e_self;
    if (lane < kSplits) wts[lane] = e;
    if (lane == 0) {
      wts[kSplits] = e_self;
      wts[kSplits + 1] = 1.f / denom;
    }
  }
  __syncthreads();
  // rank r writes lanes [r * LS, (r + 1) * LS): (e_self v_new + sum_i e_i
  // O_i) / denom
  const int ls = (d + kCluster - 1) / kCluster;
  const int t = threadIdx.x, c = rank * ls + t;
  if (t < ls && c < d) {
    float acc = wts[kSplits] * to_f32(vn[base + c]);
    const uint32_t local = smem_addr(smem) + 4 * c;
#pragma unroll
    for (int i = 0; i < kSplits; ++i)
      acc = fmaf(wts[i],
                 sm90::ld_peer(sm90::peer_addr(
                     local + (i % kWarps) * ring_bytes, i / kWarps)),
                 acc);
    out[base + c] = from_f32<Q>(acc * wts[kSplits + 1]);
  }
  // no block leaves while a peer may still read its partials
  sm90::cluster_arrive();
  sm90::cluster_wait();
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

template <typename Q, typename T, int J>
int launch_j(const void* q, const void* kc, const void* vc, const void* kn,
             const void* vn, void* out, const DecodeArgs& a,
             cudaStream_t stream) {
  using N = typename NewType<Q, T>::type;
  const long long grid = static_cast<long long>(kCluster) * a.heads * a.b;
  return static_cast<int>(sm90::launch_cluster(
      decode_kernel<Q, T, N, J>, grid, kCluster, kThreads,
      decode_smem_bytes(a.d, sizeof(T)), stream, static_cast<const Q*>(q),
      static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const N*>(kn), static_cast<const N*>(vn),
      static_cast<Q*>(out), a));
}

template <typename Q, typename T>
int launch(const void* q, const void* kc, const void* vc, const void* kn,
           const void* vn, void* out, const DecodeArgs& a,
           cudaStream_t stream) {
  constexpr bool kInt8 = sizeof(T) == 1;
  if ((a.d * static_cast<int>(sizeof(T))) % 16 || a.d % 4 ||
      a.d > kMaxHeadDim)
    return ETK_BAD_ARGS;
  if (kInt8 != (a.k_scale != nullptr) || kInt8 != (a.v_scale != nullptr))
    return ETK_BAD_ARGS;  // scales go with an int8 cache and only with it
  switch ((a.d + 127) / 128) {
    case 1:
      return launch_j<Q, T, 1>(q, kc, vc, kn, vn, out, a, stream);
    case 2:
      return launch_j<Q, T, 2>(q, kc, vc, kn, vn, out, a, stream);
    case 3:
      return launch_j<Q, T, 3>(q, kc, vc, kn, vn, out, a, stream);
    default:
      return launch_j<Q, T, 4>(q, kc, vc, kn, vn, out, a, stream);
  }
}

}  // namespace

// (q dtype, cache dtype): (bf16, bf16), (f32, f32), (f32, bf16), (f32,
// int8), (bf16, int8); k_scale and v_scale (L, B, ctx) fp32 with an int8
// cache, null otherwise. cur_vec: (B,) int32 per-row lengths (clamped to
// [0, ctx]), or null and cur_scalar in [0, ctx]. Head dims: a multiple of
// 4, up to 512, with 16-byte head rows.
ETK_API int etk_decode_attention(const void* q, const void* kc, const void* vc,
                                 const void* kn, const void* vn,
                                 const void* cur_vec, int cur_scalar,
                                 int layer, int b, int ctx, int heads, int d,
                                 void* out, const void* k_scale,
                                 const void* v_scale, int q_dtype,
                                 int cache_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || ctx <= 0 || heads <= 0 || d <= 0 || layer < 0 ||
      static_cast<long long>(kCluster) * heads * b > 2147483647LL)
    return ETK_BAD_ARGS;
  if (cur_vec == nullptr && (cur_scalar < 0 || cur_scalar > ctx))
    return ETK_BAD_ARGS;
  const DecodeArgs a{static_cast<const int*>(cur_vec),
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale),
                     cur_scalar, layer, b, ctx, heads, d};
#define ETK_DECODE(Q, T) return launch<Q, T>(q, kc, vc, kn, vn, out, a, s)
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

// The split plan for head dim d and a cache of `itemsize`-byte elements,
// as ops.attention.decode_plan mirrors it: out = cluster blocks, warps a
// block (one split each), keys a ring stage, ring stages, bytes of
// dynamic shared memory.
ETK_API int etk_decode_plan(int d, int itemsize, int* out) {
  if (itemsize != 1 && itemsize != 2 && itemsize != 4) return ETK_BAD_ARGS;
  out[0] = kCluster;
  out[1] = kWarps;
  out[2] = 4 / itemsize;
  out[3] = kStages;
  out[4] = decode_smem_bytes(d, itemsize);
  return 0;
}

// fp32 operands as exact bf16 pieces, and the flash-attention tile code on
// them, shared by the fp32 kernels: the attention forwards and backward
// (attention_f32.cu), attention -> projection -> residual
// (attn_proj_f32.cu) and the fused FFN (ffn_f32.cu).
//
// - The split pass (f32_split_kernel, launch_split): up to four fp32
//   tensors, each of its own shape and strides, written as three bf16
//   pieces whose sum is the value exactly (sm90.cuh, "exact products"),
//   piece p of a (b, rows, heads, d) tensor at p * (b rows heads d) of its
//   contiguous bf16 scratch. An activation, a weight (out, in) (b = 1,
//   rows = out, heads = 1, d = in) or a q, k or v of attention.
// - Tensor maps over the pieces: 4-D (lanes, heads, rows, 3 b) for
//   attention operands (piece_map), 3-D (cols, rows, 3) for matrices
//   (piece_map_3d); boxes clip at each piece's edge.
// - The tile geometry of a head dim (Geo), the key tiles a row block may
//   see, the online softmax of a 64-key tile, the fold of the small terms'
//   accumulator into the large one's, the mask.
// - Products' A operands handed between warpgroups (and between the blocks
//   of a cluster) as register fragments: each thread stores the fragments
//   of its own rows (frag_pieces) as 16-byte words in an order of its own
//   (frag_slot), so that the thread of the same index in any warpgroup
//   loads them back with one vector load per piece, from its own block's
//   shared memory or a peer's (sm90::ld_peer_v4), and hands them to a
//   register-A wgmma.
//
// Everything is in an anonymous namespace: each source that includes this
// header has its own split kernel.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;
constexpr int NP = sm90::kPieces;
constexpr int KT = 64;  // keys a tile, rows of a box

// element strides of one tensor: between batches, heads and rows
struct Strides {
  int batch, head, row;
};

__device__ __forceinline__ long long offset(const Strides& s, int b, int h,
                                            int row) {
  return static_cast<long long>(b) * s.batch +
         static_cast<long long>(h) * s.head +
         static_cast<long long>(row) * s.row;
}

// ---- the split pass ----------------------------------------------------------

// Up to four fp32 (b, rows, heads, d) tensors, each of its own shape, read
// through its strides and multiplied by mul (one fp32 rounding; 1 leaves it
// exact), into three contiguous bf16 pieces each: piece p at dst + p * (b
// rows heads d). d is a multiple of 4, every row 16-byte aligned.
struct SplitArgs {
  const float* src[4];
  __nv_bfloat16* dst[4];
  Strides st[4];
  int b[4], rows[4], heads[4], d[4];
  float mul[4];

  void set(int i, const void* from, __nv_bfloat16* to, Strides s, int nb,
           int nrows, int nheads, int nd, float scale = 1.f) {
    src[i] = static_cast<const float*>(from);
    dst[i] = to;
    st[i] = s;
    b[i] = nb;
    rows[i] = nrows;
    heads[i] = nheads;
    d[i] = nd;
    mul[i] = scale;
  }
  // elements of tensor i (and of each of its pieces)
  __host__ __device__ long long elems(int i) const {
    return static_cast<long long>(b[i]) * rows[i] * heads[i] * d[i];
  }
};

// elements of the three pieces of a (b, rows, heads, d) tensor
long long piece_elems(int b, int rows, int heads, int d) {
  return static_cast<long long>(NP) * b * rows * heads * d;
}

__global__ void __launch_bounds__(256) f32_split_kernel(SplitArgs a) {
  const int t = blockIdx.y, d4 = a.d[t] / 4, rows = a.rows[t];
  const int heads = a.heads[t];
  const long long per = a.elems(t) / 4;
  const long long plane = per * 4;
  const float* src = a.src[t];
  __nv_bfloat16* dst = a.dst[t];
  const Strides st = a.st[t];
  const float mul = a.mul[t];
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < per; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % d4) * 4;
    long long r = i / d4;
    const int h = static_cast<int>(r % heads);
    r /= heads;
    const int row = static_cast<int>(r % rows), bb = static_cast<int>(r / rows);
    const float4 v =
        *reinterpret_cast<const float4*>(src + offset(st, bb, h, row) + c);
    const float x[4] = {__fmul_rn(v.x, mul), __fmul_rn(v.y, mul),
                        __fmul_rn(v.z, mul), __fmul_rn(v.w, mul)};
    uint32_t w[NP][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float lo[3], hi[3];
      sm90::bf16_pieces(x[2 * j], lo);
      sm90::bf16_pieces(x[2 * j + 1], hi);
#pragma unroll
      for (int p = 0; p < NP; ++p) w[p][j] = pack_bf16x2(lo[p], hi[p]);
    }
    __nv_bfloat16* out = dst + i * 4;  // (b, row, h, c) is i * 4 contiguous
#pragma unroll
    for (int p = 0; p < NP; ++p)
      *reinterpret_cast<uint2*>(out + p * plane) = make_uint2(w[p][0], w[p][1]);
  }
}

// the split pass over the first `count` tensors of a: one launch
int launch_split(const SplitArgs& a, int count, cudaStream_t stream) {
  long long most = 0;
  for (int i = 0; i < count; ++i) most = a.elems(i) > most ? a.elems(i) : most;
  long long blocks = (most / 4 + 255) / 256;
  const long long cap = 8LL * (sm_count() > 0 ? sm_count() : 132);
  if (blocks > cap) blocks = cap;
  f32_split_kernel<<<dim3(static_cast<unsigned>(blocks), count), 256, 0,
                     stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the 4-D map of a piece tensor (3 B, rows, heads, d): boxes of (box
// lanes, 1, box rows, 1); piece p of batch b is batch p B + b
int piece_map(CUtensorMap* map, const void* ptr, int b, int rows, int heads,
              int d, int box_rows, int box_lanes) {
  const long long hd = static_cast<long long>(heads) * d;
  return sm90::tensor_map_4d(map, ptr, NP * static_cast<long long>(b), rows,
                             heads, d, d, hd, rows * hd, box_rows, box_lanes);
}

// the 3-D map of the pieces (3, rows, cols) of a row-major matrix: boxes of
// (1, box rows, 64) with 128-byte swizzle, clipped at each piece's edges
int piece_map_3d(CUtensorMap* map, const void* ptr, int rows, int cols,
                 int box_rows) {
  return sm90::tensor_map_3d(map, ptr, NP, rows, cols, cols,
                             static_cast<long long>(rows) * cols, box_rows,
                             sm90::kTileK);
}

// ---- tiles -------------------------------------------------------------------

// a tile's geometry at head-dim tile D: boxes of BOXC lanes (rows of RB
// bytes, 64- or 128-byte swizzle) and `rows` rows, NBOX of them across D
template <int D>
struct Geo {
  static constexpr int BOXC = D == 32 ? 32 : 64;
  static constexpr int RB = BOXC * 2;
  static constexpr int NBOX = D / BOXC;
  static constexpr int KS = BOXC / 16;  // k16 slices a box
  // bytes of one piece of a (rows, D) tile, and of its three pieces
  __host__ __device__ static constexpr int tile(int rows) {
    return rows * D * 2;
  }
  __host__ __device__ static constexpr int ptile(int rows) {
    return NP * tile(rows);
  }
};

__host__ __device__ constexpr int fit_stages(int fixed, int stage, int most) {
  return (sm90::kSmemLimit - fixed - 1024) / stage < most
             ? (sm90::kSmemLimit - fixed - 1024) / stage
             : most;
}

// the key tiles that rows r0 .. r0 + rows - 1 (those < n) may see
__device__ __forceinline__ int key_tiles(int r0, int rows, int n, int m,
                                         bool causal, int cond_len) {
  if (r0 >= n) return 0;
  int t = (m + KT - 1) / KT;
  if (causal) {
    const int last_row = min(r0 + rows, n) - 1;
    const int last_col = max(last_row, r0 < cond_len ? cond_len - 1 : 0);
    t = min(t, last_col / KT + 1);
  }
  return t;
}

// the online softmax of one 64-key tile of S (an m64n64 accumulator, rows
// r and r + 8 of the thread): row max and this thread's partial sums
// updated, s replaced by e^(c2 (s - m)), alpha the rescale of O
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             float (&row_max)[2],
                                             float (&row_sum)[2],
                                             float (&alpha)[2], float c2) {
  float ml2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx[j % 4] =
          fmaxf(mx[j % 4], fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    float tmax = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(row_max[hh], tmax);
    // a row with nothing visible yet keeps exp(-inf - -inf) out
    ml2[hh] = (m_new == -INFINITY ? 0.f : m_new) * c2;
    alpha[hh] = exp_shifted(row_max[hh], ml2[hh], c2);
    row_max[hh] = m_new;
  }
  float part[2][4] = {};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i / 2) % 2;
    s[i] = exp_shifted(s[i], ml2[hh], c2);
    part[hh][(i / 4) % 4] += s[i];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    row_sum[hh] = row_sum[hh] * alpha[hh] +
                  ((part[hh][0] + part[hh][1]) + (part[hh][2] + part[hh][3]));
}

// the full row sums l of a thread's rows r and r + 8 (its partial sums
// added over the four threads of each row), as 1 / l
__device__ __forceinline__ void inv_row_sums(const float (&row_sum)[2],
                                             float (&inv)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = row_sum[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hh] = 1.f / l;
  }
}

// big + small, element by element, rounded to nearest
template <int R>
__device__ __forceinline__ void fold(float (&s)[R], const float (&big)[R],
                                     const float (&small)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = __fadd_rn(small[i], big[i]);
}

// mask the accumulator s of rows row_a, row_a + 8 and columns col0 + 8j +
// 2q (+ 1): invisible entries become -inf
template <int R>
__device__ __forceinline__ void mask_tile(float (&s)[R], int row_a, int col0,
                                          int q, int m, bool causal,
                                          int cond_len) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row_a + ((i / 2) % 2) * 8;
    const int col = col0 + (i / 4) * 8 + 2 * q + i % 2;
    if (!visible(row, col, m, causal, cond_len)) s[i] = -INFINITY;
  }
}

// ---- register fragments handed over through shared memory --------------------

// bytes of the fragments of one k16 slice of a 64-row operand: three
// pieces, 16 bytes a thread of the warpgroup
constexpr int kFragSlice = NP * 128 * 16;

// the 16-byte word of piece p of thread `tid` (0-127) in one k16 slice's
// block of fragments
__host__ __device__ constexpr int frag_slot(int p, int tid) {
  return p * 2048 + tid * 16;
}

// a thread's fragments of the three pieces of k16 slice kk of the fp32
// accumulator acc, stored at `base` (its slice's block of fragments)
template <int R>
__device__ __forceinline__ void store_frags(uint8_t* base, const float (&acc)[R],
                                            int kk, int tid) {
  uint32_t f[NP][4];
  sm90::frag_pieces(f, acc, kk);
#pragma unroll
  for (int p = 0; p < NP; ++p)
    *reinterpret_cast<uint4*>(base + frag_slot(p, tid)) =
        make_uint4(f[p][0], f[p][1], f[p][2], f[p][3]);
}

// the three pieces' fragments of one k16 slice, loaded by thread tid from
// the cluster address `slice` (a block of fragments in its own or a peer's
// shared memory)
__device__ __forceinline__ void load_frags(uint32_t (&f)[NP][4],
                                           uint32_t slice, int tid) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const uint4 v = sm90::ld_peer_v4(slice + frag_slot(p, tid));
    f[p][0] = v.x;
    f[p][1] = v.y;
    f[p][2] = v.z;
    f[p][3] = v.w;
  }
}

}  // namespace

// The attention forwards: out[b, i, h] = softmax(s_i) V per head, s_i =
// q_i . K^T, on bf16 q (B, N, H, D), k and v (B, M, H, D), each read in
// place through its own batch, head and row strides.
//
// Replaces five TPU kernels of enhancing_tpu/ops/attention.py, one forward
// for all of them:
// - _attn_kernel_packed as entered through _attention_packed_qkv_call (B2:
//   the ViT blocks' attention on the fused (B, N, 3*H*D) qkv buffer, whose
//   q, k and v are its lane slices at offsets 0, H*D and 2*H*D;
//   etk_attention_qkv) and through _attention_packed_call (B8: the GPT
//   prior's attention, reached by multihead_attention_bnhd, at head dims
//   up to the prior's 384; etk_attention_bnhd);
// - _attn_kernel (B17, _attention_pallas: (B, H, N, D) tensors, M may
//   differ from N) and _attn_kernel_bnhd (B18, _attention_pallas_bnhd:
//   (B, N, H, D) tensors), which put the scale on the fp32 scores
//   (kScoreScale: attn_fwd_kernel takes the row max of the raw scores and
//   forms e^(scale (s - m)) by one FMA in the exponent, the same max since
//   rounding is monotonic); the TPU kernels' whole-row softmax normalises
//   P before rounding it to bf16, these round the unnormalised P against
//   the running row max and divide at the end, as B2 and B8 do;
// - _attn_kernel_packed_gridchunk (B19): prefix-causal on pre-scaled packed
//   q, k, v, whose point, key tiles past a block's last visible column
//   neither loaded nor computed, both kernels here keep. Its block_q and
//   k_chunk are TPU means and are not reproduced.
// Numerics: q is scaled in bf16 (the scale rounded to bf16, then q * scale
// rounded; the TPU wrapper scales q in its dtype before the call) unless
// kScoreScale, QK^T accumulates in fp32, the softmax is fp32 and online over
// key tiles, P is rounded to bf16 against the running row max before PV,
// and the fp32 output is multiplied by 1 / l and rounded once. Mask modes
// 'none' and 'prefix_causal' (col <= row, or both < cond_len); rows past N
// and keys past M are masked, so any N and M work, N = 1 included.
// attn_fwd_kernel's key tiles are 128 wide, attn_bnhd_kernel's (and the
// mma.sync kernels' before it) 64: the running max that P is rounded
// against moves every 128 keys instead of 64, which moves an output by at
// most about one bf16 step of P (2^-8 relative) times |V|, within phase
// 3's limits; tests/test_torch_attention_fwd.py holds this recurrence to
// the plain version and to the JAX kernel with 128-key chunks.
//
// Bound on the H100: tensor-core operations, 4 * B * H * N * M * D flops
// (about half with the causal mask) against 2 * (N + M) * B * H * D * 2
// bytes. Every block reads all of its (batch, head)'s K and V, from L2
// after the first block: at batch 128, H 12, N 1024, D 64 that is N / 64
// blocks x 256 KiB x 1536 heads, ~6.4 GB a call with 64-row blocks, which
// at the ~5.3 TB/s L2 rate measured on B1 (PERF.md) is three times the
// operations bound; and at D = 64 the softmax's exponentials (16 a clock
// an SM) take as long as the products.
//
// attn_fwd_kernel (D = 32, 64, 128), on the Hopper core of sm90.cuh: a
// block owns 192 query rows of one (batch, head), which cuts that L2
// traffic to a third. One producer warp issues TMA: the q tile once, then
// 128-key K and V tiles into a ring of 4 stages (2 at D = 128, 64 KiB a
// stage); three consumer warpgroups take 64 rows each and read the same
// ring (its `empty` barrier takes one arrival from each), so K and V are
// loaded once for 192 rows with no cluster wait (PR 7 found multicast
// across blocks slower: every stage waits for both). 512 threads leave 128
// registers a thread (setmaxnreg 160 / 24 between the roles), and ptxas
// spills ~110 bytes a thread at D = 64 and ~250 at D = 128; two warpgroups
// with 168 registers and no spill ran slower on the H100 at every head dim
// (B2 1.21 against 1.14 ms, PERF.md). Per key tile, the flash tile of
// attn_proj.cu: S = q K^T by shared-memory wgmma (m64n128), the online
// softmax in fp32 with the exponential as one FMA and ex2, P into register
// A fragments (frag_from_acc), O += P V register-A against V read
// MN-major, one product per 64-lane box. Each tile's two products are
// waited on before the next step; on the H100, 128-key tiles beat 64-key
// ones (B2 1.20 against 1.41 ms), while issuing the next tile's S with
// this tile's P V (1.22 against 1.21) or warpgroups taking turns at the
// tensor cores (1.51) did not pay (PERF.md). The addressing lives in 4-D
// tensor maps over (lanes, heads, rows, batches) with a stride per axis:
// boxes clip at each batch's N or M (loads fill zeros, stores drop rows
// past N). The output, times 1 / l and rounded, goes through the
// warpgroup's q boxes to TMA stores. Under prefix_causal each warpgroup
// skips the key tiles past its own last visible column and masks only the
// tiles that cross its diagonal, and the producer loads none past the
// block's last column.
//
// attn_bnhd_kernel (D = 384 only): the earlier mma.sync forward, kept for
// the prior's head dim until its Hopper redesign (ROADMAP.md queue B: at
// 64 rows a q tile, two K and two V stages of a 128-lane slab take 176
// KiB, and a 128-row tile does not fit beside the barriers). A 64 x 384
// fp32 accumulator would be 192 registers a thread, so the output's head
// dim is cut into 128-lane slabs along the grid's y axis and each block
// recomputes S for its slab (at D = 384 three slabs, twice the operations
// of one pass); the scaled q tile sits in shared memory and each k-step
// loads its fragment with ldmatrix; K and V arrive by cp.async into two
// stages. Shared memory: q 64 x 392, two stages of K 64 x 392 and of V
// 64 x 136 bf16, 181 KB, one block per SM.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;

// element strides of one tensor: between batches, heads and rows
struct Strides {
  int batch, head, row;
};

// ---- attn_fwd_kernel: D = 32, 64, 128 ------------------------------------

// keys a tile; consumer warpgroups of 64 rows each, so 192 query rows a
// block; a producer warpgroup beside them
constexpr int FKV = 128, kWgRows = 64, NWG = 3, FQ = NWG * kWgRows;
constexpr int kConsumers = NWG * 128, kFwdThreads = kConsumers + 128;

// tiles at head dim D: boxes of BOXC lanes (rows of RB bytes, 64- or
// 128-byte swizzle) and 64 rows, NBOX of them across the lanes; a key tile
// is FKV / 64 such boxes down each lane box, which the swizzle lays out as
// one box of FKV rows
template <int D>
struct Geo {
  static constexpr int BOXC = D == 32 ? 32 : 64;
  static constexpr int RB = BOXC * 2;
  static constexpr int NBOX = D / BOXC;
  static constexpr int KS = BOXC / 16;      // k16 slices a box
  static constexpr int BOX = kWgRows * RB;  // bytes of a (64, BOXC) box
  static constexpr int TILE = NBOX * BOX;   // bytes of a (64, D) tile
  static constexpr int KBOX = FKV * RB;     // bytes of a (FKV, BOXC) box
  static constexpr int KTILE = NBOX * KBOX;  // bytes of a (FKV, D) tile
  // ring stages: as many as fit beside the q tiles, at most 4 (2 at D =
  // 128)
  static constexpr int FIT =
      (sm90::kSmemLimit - NWG * TILE - 1024) / (2 * KTILE);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // the q tiles of the warpgroups, the ring (K and V a stage), alignment
  static constexpr int SMEM = NWG * TILE + STAGES * 2 * KTILE + 1024;
};

struct FwdArgs {
  int n, m, mask_mode, cond_len;
  float scale;
};

template <int D, bool kScoreScale>
__global__ void __launch_bounds__(kFwdThreads, 1)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap tmap_q,
                    const __grid_constant__ CUtensorMap tmap_k,
                    const __grid_constant__ CUtensorMap tmap_v,
                    const __grid_constant__ CUtensorMap tmap_o, FwdArgs a) {
  using G = Geo<D>;
  constexpr int RB = G::RB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qbar, full[G::STAGES], empty[G::STAGES];
  uint8_t* smem = sm90::align_1024(smem_raw);
  // per warpgroup, NBOX boxes of (64, BOXC): its q rows, then its output
  uint8_t* qs = smem;
  uint8_t* ring_mem = smem + NWG * G::TILE;  // a stage: K tile, V tile
  const sm90::Ring ring{G::STAGES};

  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const int n = a.n, m = a.m;
  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  // the key tiles that rows r0 .. r0 + rows - 1 (those < n) may see
  auto tiles_for = [&](int r0, int rows) {
    if (r0 >= n) return 0;
    int t = (m + FKV - 1) / FKV;
    if (causal) {
      const int last_row = min(r0 + rows, n) - 1;
      const int last_col = max(last_row, r0 < a.cond_len ? a.cond_len - 1 : 0);
      t = min(t, last_col / FKV + 1);
    }
    return t;
  };
  const int kv_tiles = tiles_for(q0, FQ);

  if (threadIdx.x == 0) {
    sm90::mbar_init(&qbar, 1);
    for (int s = 0; s < G::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NWG);  // one arrival per warpgroup
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: the q tile once, then the block's key tiles
    sm90::regs_dealloc<24>();
    if (threadIdx.x != kConsumers) return;
    sm90::mbar_expect_tx(&qbar, NWG * G::TILE);
#pragma unroll
    for (int w = 0; w < NWG; ++w)
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx)
        sm90::tma_load_4d(qs + (w * G::NBOX + bx) * G::BOX, &tmap_q, &qbar,
                          bx * G::BOXC, h, q0 + w * kWgRows, b);
    for (int t = 0; t < kv_tiles; ++t) {
      const int s = ring.stage(t);
      sm90::mbar_wait(&empty[s], ring.parity(t) ^ 1u);
      uint8_t* st = ring_mem + s * 2 * G::KTILE;
      sm90::mbar_expect_tx(&full[s], 2 * G::KTILE);
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
        for (int kb = 0; kb < FKV / 64; ++kb) {
          const int off = bx * G::KBOX + kb * G::BOX, key = t * FKV + kb * 64;
          sm90::tma_load_4d(st + off, &tmap_k, &full[s], bx * G::BOXC, h,
                            key, b);
          sm90::tma_load_4d(st + G::KTILE + off, &tmap_v, &full[s],
                            bx * G::BOXC, h, key, b);
        }
    }
    return;
  }

  sm90::regs_alloc<160>();
  const int w = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int r = warp * 16 + lane / 4;  // rows r and r + 8 of the warpgroup
  const int wq0 = q0 + w * kWgRows, row_a = wq0 + r;
  const bool leader = threadIdx.x % 128 == 0;
  const int my_tiles = tiles_for(wq0, kWgRows);
  uint8_t* qw = qs + w * G::TILE;
  sm90::mbar_wait(&qbar, 0);
  if (!kScoreScale) {
    // this warpgroup's q rows scaled in bf16 in place, 8 values a 16-byte
    // chunk (the swizzle moves whole chunks)
#pragma unroll
    for (int i = 0; i < G::TILE / 16 / 128; ++i) {
      uint4* p = reinterpret_cast<uint4*>(qw) + threadIdx.x % 128 + 128 * i;
      uint4 u = *p;
      uint32_t* e = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j)  // the low and high bf16 of each pair
        e[j] = pack_bf16x2(__uint_as_float(e[j] << 16) * a.scale,
                           __uint_as_float(e[j] & 0xffff0000u) * a.scale);
      *p = u;
    }
    sm90::fence_async_cta();
    sm90::named_sync(2 + w, 128);
  }

  float o[G::NBOX][G::BOXC / 2];
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
    for (int i = 0; i < G::BOXC / 2; ++i) o[bx][i] = 0.f;
  // the row max of the raw scores and this thread's partial row sums; the
  // exponent of e^(scale s - scale m) is s c2 - m c2 by one FMA, c2 =
  // scale log2(e) (kScoreScale) or log2(e) (q already scaled)
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  const float c2 = kScoreScale ? a.scale * kLog2e : kLog2e;

  for (int t = 0; t < kv_tiles; ++t) {
    const int s_i = ring.stage(t);
    sm90::mbar_wait(&full[s_i], ring.parity(t));
    if (t < my_tiles) {
      const uint8_t* st = ring_mem + s_i * 2 * G::KTILE;
      // S = q K^T, the first k16 slice without accumulating (no zero fill)
      float s[FKV / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) {
        const uint64_t qd = sm90::smem_desc<RB>(qw + bx * G::BOX);
        const uint64_t kd = sm90::smem_desc<RB>(st + bx * G::KBOX);
#pragma unroll
        for (int ks = 0; ks < G::KS; ++ks)
          sm90::Wgmma<FKV>::ss(s, sm90::desc_k(qd, ks), sm90::desc_k(kd, ks),
                               bx > 0 || ks > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::hold(s);

      // a tile needs the mask where it passes m or, causal, where one of
      // its keys lies past this warpgroup's first row
      if ((t + 1) * FKV > m || (causal && (t + 1) * FKV - 1 > wq0)) {
#pragma unroll
        for (int i = 0; i < FKV / 2; ++i) {
          const int row = row_a + ((i / 2) % 2) * 8;
          const int col = t * FKV + (i / 4) * 8 + 2 * q + i % 2;
          if (!visible(row, col, m, causal, a.cond_len)) s[i] = -INFINITY;
        }
      }
      // the online softmax; maxima and sums over four partials a row, so
      // that no chain of dependent instructions runs the tile's length
      float alpha[2], ml2[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < FKV / 8; ++j)
          mx[j % 4] = fmaxf(mx[j % 4], fmaxf(s[4 * j + 2 * hh],
                                             s[4 * j + 2 * hh + 1]));
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
      for (int i = 0; i < FKV / 2; ++i) {
        const int hh = (i / 2) % 2;
        s[i] = exp_shifted(s[i], ml2[hh], c2);
        part[hh][(i / 4) % 4] += s[i];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        row_sum[hh] = row_sum[hh] * alpha[hh] + ((part[hh][0] + part[hh][1]) +
                                                 (part[hh][2] + part[hh][3]));
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
        for (int i = 0; i < G::BOXC / 2; ++i) o[bx][i] *= alpha[(i / 2) % 2];
      uint32_t pf[FKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < FKV / 16; ++kk) sm90::frag_from_acc(pf[kk], s, kk);
      // the rescaled O and the P fragments are written before the fence
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) sm90::hold(o[bx]);
#pragma unroll
      for (int kk = 0; kk < FKV / 16; ++kk) sm90::hold(pf[kk]);
      sm90::wgmma_fence();
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) {
        const uint64_t vd =
            sm90::smem_desc<RB>(st + G::KTILE + bx * G::KBOX);
#pragma unroll
        for (int kk = 0; kk < FKV / 16; ++kk)
          sm90::Wgmma<G::BOXC>::template rs<1>(o[bx], pf[kk],
                                               sm90::desc_mn<RB>(vd, kk));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) sm90::hold(o[bx]);
      // the P fragments stay live until the products that read them are
      // done: else the next tile's values may take their registers
#pragma unroll
      for (int kk = 0; kk < FKV / 16; ++kk) sm90::hold(pf[kk]);
    }
    if (leader) sm90::mbar_arrive(&empty[s_i]);
  }

  // the output, times 1 / l and rounded to bf16, into this warpgroup's q
  // boxes (its products are done), then TMA stores that drop rows past n
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = row_sum[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hh] = 1.f / l;
  }
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
    for (int j = 0; j < G::BOXC / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(qw + bx * G::BOX +
                                     sm90::swz<RB>(r + 8 * hh, j) + 4 * q) =
            pack_bf16x2(o[bx][4 * j + 2 * hh] * inv[hh],
                        o[bx][4 * j + 2 * hh + 1] * inv[hh]);
  sm90::fence_async_cta();
  sm90::named_sync(2 + w, 128);
  if (leader && wq0 < n) {
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx)
      sm90::tma_store_4d(&tmap_o, qw + bx * G::BOX, bx * G::BOXC, h, wq0, b);
    sm90::bulk_commit();
    sm90::bulk_wait();
  }
}

// the map of one operand with `rows` rows: (lanes, heads, rows, batches),
// boxes of (BOXC, 1, 64, 1)
template <int D>
int fwd_map(CUtensorMap* map, const void* ptr, const Strides& st, int b,
            int rows, int heads) {
  return sm90::tensor_map_4d(map, ptr, b, rows, heads, D, st.head, st.row,
                             st.batch, kWgRows, Geo<D>::BOXC);
}

// ptrs and st: q, k, v, out
template <int D, bool kScoreScale>
int launch_fwd(const void* const* ptrs, const Strides* st, int b, int n,
               int m, int heads, const FwdArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (fwd_map<D>(&tq, ptrs[0], st[0], b, n, heads) ||
      fwd_map<D>(&tk, ptrs[1], st[1], b, m, heads) ||
      fwd_map<D>(&tv, ptrs[2], st[2], b, m, heads) ||
      fwd_map<D>(&to, ptrs[3], st[3], b, n, heads))
    return ETK_TMAP_FAILED;
  constexpr int smem = Geo<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<D, kScoreScale>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + FQ - 1) / FQ, heads, b);
  attn_fwd_kernel<D, kScoreScale><<<grid, kFwdThreads, smem, stream>>>(
      tq, tk, tv, to, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kScoreScale>
int launch_fwd_d(int head_dim, const void* const* ptrs, const Strides* st,
                 int b, int n, int m, int heads, const FwdArgs& a,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_fwd<32, kScoreScale>(ptrs, st, b, n, m, heads, a, stream);
    case 64:
      return launch_fwd<64, kScoreScale>(ptrs, st, b, n, m, heads, a, stream);
    case 128:
      return launch_fwd<128, kScoreScale>(ptrs, st, b, n, m, heads, a,
                                          stream);
    default:
      return ETK_BAD_ARGS;
  }
}

// ---- attn_bnhd_kernel: D = 384 ---------------------------------------------

constexpr int BQ = 64, BKV = 64, kThreads = 128;

// output lanes per block: the whole head up to 128, else 128-lane slabs
template <int D>
__host__ __device__ constexpr int slab() {
  return D <= 128 ? D : 128;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return ((BQ + 2 * BKV) * (D + 8) + 2 * BKV * (slab<D>() + 8)) * 2;
}

template <int D, bool kScoreScale>
__global__ void __launch_bounds__(kThreads)
    attn_bnhd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, Strides qs_, Strides ks_,
                     Strides vs_, Strides os_, int n, int m, int heads,
                     float scale, int mask_mode, int cond_len) {
  constexpr int DS = slab<D>();
  constexpr int SLABS = D / DS;
  constexpr int LD = D + 8, LDS = DS + 8;  // padded rows: conflict-free ldmatrix
  constexpr int VPR = D / 8, VPRS = DS / 8;  // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto qs = reinterpret_cast<__nv_bfloat16(*)[LD]>(smem_raw);
  auto ks = reinterpret_cast<__nv_bfloat16(*)[BKV][LD]>(smem_raw + BQ * LD * 2);
  auto vs = reinterpret_cast<__nv_bfloat16(*)[BKV][LDS]>(
      smem_raw + (BQ + 2 * BKV) * LD * 2);

  const int q0 = blockIdx.x * BQ, b = blockIdx.z;
  const int h = blockIdx.y / SLABS, sl = blockIdx.y % SLABS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * qs_.batch +
                            static_cast<size_t>(h) * qs_.head;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * ks_.batch +
                            static_cast<size_t>(h) * ks_.head;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * vs_.batch +
                            static_cast<size_t>(h) * vs_.head + sl * DS;
  const int q_stride = qs_.row, k_stride = ks_.row, v_stride = vs_.row;

  const bool causal = mask_mode == MASK_PREFIX_CAUSAL;
  int kv_tiles = (m + BKV - 1) / BKV;
  if (causal) {
    const int last_row = min(q0 + BQ, n) - 1;
    const int last_col = max(last_row, q0 < cond_len ? cond_len - 1 : 0);
    kv_tiles = min(kv_tiles, last_col / BKV + 1);
  }

  auto load_kv = [&](int t, int stage) {
    for (int i = threadIdx.x; i < BKV * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const int key = t * BKV + r;
      const size_t off = static_cast<size_t>(key < m ? key : 0) * k_stride + c;
      cp_async_16(&ks[stage][r][c], kb + off, key < m ? 16 : 0);
    }
    for (int i = threadIdx.x; i < BKV * VPRS; i += kThreads) {
      const int r = i / VPRS, c = (i % VPRS) * 8;
      const int key = t * BKV + r;
      const size_t off = static_cast<size_t>(key < m ? key : 0) * v_stride + c;
      cp_async_16(&vs[stage][r][c], vb + off, key < m ? 16 : 0);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // q tile, scaled in bf16 on its way to shared memory (or as it is, when
  // the scale goes on the scores)
  for (int i = threadIdx.x; i < BQ * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < n)
      raw = *reinterpret_cast<const uint4*>(
          qb + static_cast<size_t>(q0 + r) * q_stride + c);
    if (!kScoreScale) {
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(p[e]);
        p[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(&qs[r][c]) = raw;
  }

  float o[DS / 8][4];
#pragma unroll
  for (int i = 0; i < DS / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this lane's partial sums
  const int row_a = q0 + warp * 16 + lane / 4;  // rows row_a and row_a + 8

  for (int t = 0; t < kv_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < kv_tiles) {
      load_kv(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and, at t = 0, the q tile) is in place

    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t qf[4];
      ldmatrix_x4(qf, &qs[warp * 16 + lane % 16][kd * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int nj = 0; nj < BKV / 16; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, &ks[stage][nj * 16 + lane % 8 + (lane / 16) * 8]
                          [kd * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16_16816(s[2 * nj], qf, r[0], r[1]);
        mma_bf16_16816(s[2 * nj + 1], qf, r[2], r[3]);
      }
    }

    // scale (kScoreScale), mask, then the online softmax update in fp32
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + (e / 2) * 8;
        const int col = t * BKV + ni * 8 + (lane % 4) * 2 + (e % 2);
        if (kScoreScale) s[ni][e] *= scale;
        bool ok = col < m;
        if (causal) ok = ok && (col <= row || (row < cond_len && col < cond_len));
        if (!ok) s[ni][e] = -INFINITY;
        tile_max[e / 2] = fmaxf(tile_max[e / 2], s[ni][e]);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tile_max[hh] = fmaxf(tile_max[hh],
                           __shfl_xor_sync(0xffffffffu, tile_max[hh], 1));
      tile_max[hh] = fmaxf(tile_max[hh],
                           __shfl_xor_sync(0xffffffffu, tile_max[hh], 2));
      const float m_new = fmaxf(row_max[hh], tile_max[hh]);
      // a row with nothing visible yet (a padded row past N, whose every
      // column is masked) keeps exp() of -inf - -inf out of the sums
      m_use[hh] = m_new == -INFINITY ? 0.f : m_new;
      alpha[hh] = expf(row_max[hh] - m_use[hh]);
      row_max[hh] = m_new;
      row_sum[hh] *= alpha[hh];
    }
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ni][e] = expf(s[ni][e] - m_use[e / 2]);
        row_sum[e / 2] += s[ni][e];
      }
    }
#pragma unroll
    for (int i = 0; i < DS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e / 2];

    // O += P V on this block's slab, P (bf16) straight from the S
    // accumulators
#pragma unroll
    for (int kj = 0; kj < BKV / 16; ++kj) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kj][0], s[2 * kj][1]);
      pa[1] = pack_bf16x2(s[2 * kj][2], s[2 * kj][3]);
      pa[2] = pack_bf16x2(s[2 * kj + 1][0], s[2 * kj + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kj + 1][2], s[2 * kj + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DS / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &vs[stage][kj * 16 + lane % 8 + ((lane / 8) % 2) * 8]
                                [dp * 16 + (lane / 16) * 8]);
        mma_bf16_16816(o[2 * dp], pa, r[0], r[1]);
        mma_bf16_16816(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
  }

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = row_sum[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hh] = 1.f / l;
  }
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * os_.batch +
                      static_cast<size_t>(h) * os_.head + sl * DS;
  const int o_stride = os_.row;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_a + hh * 8;
    if (row >= n) continue;
#pragma unroll
    for (int dn = 0; dn < DS / 8; ++dn) {
      const int col = dn * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row) * o_stride +
                                   col) =
          pack_bf16x2(o[dn][2 * hh] * inv[hh], o[dn][2 * hh + 1] * inv[hh]);
    }
  }
}

template <bool kScoreScale>
int launch_384(const void* const* ptrs, const Strides* st, int b, int n,
               int m, int heads, float scale, int mask_mode, int cond_len,
               cudaStream_t stream) {
  constexpr int D = 384;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bnhd_kernel<D, kScoreScale>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BQ - 1) / BQ, heads * (D / slab<D>()), b);
  attn_bnhd_kernel<D, kScoreScale><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(ptrs[0]),
      static_cast<const __nv_bfloat16*>(ptrs[1]),
      static_cast<const __nv_bfloat16*>(ptrs[2]),
      static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[3])), st[0], st[1],
      st[2], st[3], n, m, heads, scale, mask_mode, cond_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: bf16 (B, N, H, D); k, v: bf16 (B, M, H, D); each addressed as
// base + b * batch + h * head + row * row_stride + lane, its three strides
// in elements (multiples of 8; 0 only on an axis of size 1) at
// strides[3 * i .. 3 * i + 2] for q, k, v, out; every base 16-byte
// aligned. score_scale: 1 puts the scale on the fp32 scores, 0 scales q in
// bf16. D 32, 64 and 128 run attn_fwd_kernel, D 384 attn_bnhd_kernel.
ETK_API int etk_attention_bnhd(const void* q, const void* k, const void* v,
                               void* out, const int* strides, int b, int n,
                               int m, int heads, int head_dim, float scale,
                               int score_scale, int mask_mode, int cond_len,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool wide = head_dim == 384;
  if (b <= 0 || n <= 0 || m <= 0 || heads <= 0 || b > 65535 ||
      heads > (wide ? 65535 / 3 : 65535) ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    const int rows = i == 1 || i == 2 ? m : n;
    if (st[i].batch < 0 || st[i].head < 0 || st[i].row < 0 ||
        st[i].batch % 8 || st[i].head % 8 || st[i].row % 8 ||
        (!wide && ((st[i].batch == 0 && b > 1) ||
                   (st[i].head == 0 && heads > 1) ||
                   (st[i].row == 0 && rows > 1))))
      return ETK_BAD_ARGS;
  }
  const void* ptrs[4] = {q, k, v, out};
  if (wide)
    return score_scale ? launch_384<true>(ptrs, st, b, n, m, heads, scale,
                                          mask_mode, cond_len, s)
                       : launch_384<false>(ptrs, st, b, n, m, heads, scale,
                                           mask_mode, cond_len, s);
  const FwdArgs a{n, m, mask_mode, cond_len, scale};
  return score_scale
             ? launch_fwd_d<true>(head_dim, ptrs, st, b, n, m, heads, a, s)
             : launch_fwd_d<false>(head_dim, ptrs, st, b, n, m, heads, a, s);
}

// Self-attention of the fused (B, N, 3*H*D) qkv buffer into a contiguous
// (B, N, H*D) out: q, k and v are its lane slices at element offsets 0,
// H*D and 2*H*D (head stride D, row stride 3*H*D, batch stride N*3*H*D),
// the scale on q in bf16; the maps and kernel of etk_attention_bnhd, so the
// two entries give the same output bit for bit on those slices.
ETK_API int etk_attention_qkv(const void* qkv, void* out, int b, int n,
                              int heads, int head_dim, float scale,
                              int mask_mode, int cond_len, void* stream) {
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535 ||
      3LL * n * heads * head_dim >= (1LL << 31) ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  const int hd = heads * head_dim;
  const Strides in{n * 3 * hd, head_dim, 3 * hd};
  const Strides st[4] = {in, in, in, Strides{n * hd, head_dim, hd}};
  const auto* base = static_cast<const __nv_bfloat16*>(qkv);
  const void* ptrs[4] = {base, base + hd, base + 2 * hd, out};
  const FwdArgs a{n, n, mask_mode, cond_len, scale};
  return launch_fwd_d<false>(head_dim, ptrs, st, b, n, n, heads, a,
                             static_cast<cudaStream_t>(stream));
}

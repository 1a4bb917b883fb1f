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
//   up to 128 and the prior's 384; etk_attention_bnhd);
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
// attn_fwd_kernel's key tiles are 128 wide, attn_wide_kernel's 64: the
// running max that P is rounded against moves every 128 (64) keys, which
// moves an output by at most about one bf16 step of P (2^-8 relative)
// times |V|, within phase 3's limits; tests/test_torch_attention_fwd.py
// holds both recurrences to the plain version and to the JAX kernel with
// 128- and 64-key chunks.
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
// attn_fwd_kernel (tiles of D = 32, 64, 128 lanes; a head dim between them,
// a multiple of 8 such as ViT-VQGAN-Large's 80, runs on the next tile: its
// maps' lane extent is the head dim, so the boxes past it load zeros, which
// add nothing to S, and the stores drop the lanes of O past it; no copy
// pads the operands), on the Hopper core of sm90.cuh: a
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
// attn_wide_kernel (D = 384, the GPT prior's heads; B8 and, scale on the
// scores, B17/B18): bound by the same operations, 4 D flops a visible
// (query, key) pair. A 64 x 384 fp32 O is 192 registers a thread, more
// than one warpgroup holds beside S, and attn_fwd_kernel's tiles (three
// 64-row q tiles, 128-key K and V tiles of 96 KiB each) do not fit in
// shared memory at this width. So the work is cut by role, not by output
// slab (the mma.sync kernel it replaces recomputed S once per 128-lane
// slab, twice the useful operations): a block owns 64 query rows; an S
// warpgroup forms S = q K^T once per 64-key tile (six 64-lane K boxes,
// 24 k16 steps of one m64n64 shared-memory wgmma into 32 registers), runs
// the online softmax and writes P, rounded to bf16 as register-A
// fragments (16 bytes a thread and k16 slice, no swizzle), and each row's
// rescale factor into one of two slots; three O warpgroups own 128 lanes
// of O each (64 registers) and add P V by register-A wgmma against V read
// MN-major, one product per 64-lane box, while the S warpgroup already
// forms the next tile's S. Named barriers hand the slots over (bar.arrive
// by the writer, bar.sync by the reader); a producer warp streams K and V
// as (64 keys, 64 lanes) TMA boxes through one ring of 20 8-KiB stages
// (about 1.7 key tiles in flight beside the 48 KiB q tile and 16 KiB of
// P), each stage freed by the four warps that read it. setmaxnreg gives
// the producer 24 registers, S 96 and O 120. At the end the O warpgroups
// scale by 1 / l (from the S warpgroup) and store through the q tile's
// boxes by TMA. Under prefix_causal the block skips the key tiles past
// its last visible column and starts with the last q tiles, which see the
// most keys.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;

// element strides of one tensor: between batches, heads and rows
struct Strides {
  int batch, head, row;
};

// ---- attn_fwd_kernel: tiles of D = 32, 64, 128 ---------------------------

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

// the map of one operand with `rows` rows and head dim d: (lanes, heads,
// rows, batches), boxes of (box lanes, 1, 64, 1). The lane extent is the
// head dim, so a box that runs past it (a head dim between the tiles)
// loads zeros there and its store drops those lanes.
int fwd_map(CUtensorMap* map, const void* ptr, const Strides& st, int b,
            int rows, int heads, int d, int box_lanes) {
  return sm90::tensor_map_4d(map, ptr, b, rows, heads, d, st.head, st.row,
                             st.batch, kWgRows, box_lanes);
}

// ptrs and st: q, k, v, out; D the tile (32, 64 or 128), head_dim the
// lanes of a head (a multiple of 8 up to D)
template <int D, bool kScoreScale>
int launch_fwd(const void* const* ptrs, const Strides* st, int b, int n,
               int m, int heads, int head_dim, const FwdArgs& a,
               cudaStream_t stream) {
  constexpr int BL = Geo<D>::BOXC;
  CUtensorMap tq, tk, tv, to;
  if (fwd_map(&tq, ptrs[0], st[0], b, n, heads, head_dim, BL) ||
      fwd_map(&tk, ptrs[1], st[1], b, m, heads, head_dim, BL) ||
      fwd_map(&tv, ptrs[2], st[2], b, m, heads, head_dim, BL) ||
      fwd_map(&to, ptrs[3], st[3], b, n, heads, head_dim, BL))
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

// ---- attn_wide_kernel: D = 384 ---------------------------------------------

// The prior's heads of 384 lanes, six 64-lane boxes; 64 query rows a block
// and key tiles of 64, each a (64, 64) bf16 box of 8 KiB per lane box.
// Roles, one warpgroup each: S (scores, softmax, P), three O warpgroups
// (WOBOX lane boxes, 128 lanes, of the output each) and a producer.
constexpr int WD = 384, WBOXES = WD / 64, WKV = 64, WBOX = 64 * 128;
constexpr int WTILE = WBOXES * WBOX;
constexpr int WO = 3, WOBOX = WBOXES / WO;
constexpr int kWideThreads = (2 + WO) * 128;
constexpr int kRoleThreads = (1 + WO) * 128;  // S and O
// named barriers: 1 the S warpgroup's q scaling, 2-4 each O warpgroup's
// epilogue, 5-6 P slot filled, 7-8 P slot read, 9 the row sums written
constexpr int BAR_PFULL = 5, BAR_PEMPTY = 7, BAR_LSUM = 9;
// P: two slots of the (64, 64) bf16 tile as the A fragments of a
// register-A wgmma, 16 bytes a thread and k16 slice; beside them each
// slot's rescale factors and the final 1 / l, one float a row
constexpr int WPSLOT = 4 * 128 * 16;
constexpr int WFIXED = WTILE + 2 * WPSLOT + 3 * 64 * 4;
// the ring: as many 8 KiB K / V boxes as fit beside q and P (20)
constexpr int WRING = (sm90::kSmemLimit - WFIXED) / WBOX;
constexpr int WSMEM = WFIXED + WRING * WBOX + 1024;
static_assert(WRING >= 2 * WBOXES, "a K and a V tile in flight");
// registers a thread (setmaxnreg): the launch gives 65536 / threads (96),
// and what the roles take back can only come out of what the block was
// given: the producer drops to 24, S keeps 96, O takes 120
constexpr int WBASE = 65536 / kWideThreads / 8 * 8, WO_REGS = 120;
static_assert(24 + WBASE + WO * WO_REGS <= (2 + WO) * WBASE,
              "register budget");

template <bool kScoreScale>
__global__ void __launch_bounds__(kWideThreads, 1)
    attn_wide_kernel(const __grid_constant__ CUtensorMap tmap_q,
                     const __grid_constant__ CUtensorMap tmap_k,
                     const __grid_constant__ CUtensorMap tmap_v,
                     const __grid_constant__ CUtensorMap tmap_o, FwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qbar, full[WRING], empty[WRING];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* qs = smem;  // the q tile's six boxes, at the end the output's
  uint8_t* ring = smem + WTILE;
  uint4* pslot = reinterpret_cast<uint4*>(ring + WRING * WBOX);
  float* alpha_s = reinterpret_cast<float*>(pslot + 2 * 4 * 128);  // [2][64]
  float* linv_s = alpha_s + 2 * 64;                                // [64]
  const sm90::Ring rp{WRING};

  const int n = a.n, m = a.m;
  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  // under the causal mask the last q tiles see the most keys: start them
  // first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * 64;
  const int h = blockIdx.y, b = blockIdx.z;
  int kv_tiles = (m + WKV - 1) / WKV;
  if (causal) {
    const int last_row = min(q0 + 64, n) - 1;
    const int last_col = max(last_row, q0 < a.cond_len ? a.cond_len - 1 : 0);
    kv_tiles = min(kv_tiles, last_col / WKV + 1);
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(&qbar, 1);
    for (int s = 0; s < WRING; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == WO + 1) {
    // producer: the q tile, then per key tile six K boxes and six V boxes,
    // box i of the block in ring stage i % RING
    sm90::regs_dealloc<24>();
    if (tid != 0) return;
    sm90::mbar_expect_tx(&qbar, WTILE);
#pragma unroll
    for (int bx = 0; bx < WBOXES; ++bx)
      sm90::tma_load_4d(qs + bx * WBOX, &tmap_q, &qbar, bx * 64, h, q0, b);
    int i = 0;
    for (int t = 0; t < kv_tiles; ++t)
      for (int j = 0; j < 2 * WBOXES; ++j, ++i) {
        const int s = rp.stage(i);
        sm90::mbar_wait(&empty[s], rp.parity(i) ^ 1u);
        sm90::mbar_expect_tx(&full[s], WBOX);
        sm90::tma_load_4d(ring + s * WBOX, j < WBOXES ? &tmap_k : &tmap_v,
                          &full[s], (j % WBOXES) * 64, h, t * WKV, b);
      }
    return;
  }

  const int warp = tid / 32, lane = tid % 32, qd = lane % 4;
  const int r = warp * 16 + lane / 4;  // rows r and r + 8 of the tile
  if (wg == 0) {
    // S warpgroup: S = q K^T by shared-memory wgmma, the online softmax,
    // P and each row's rescale factor into a slot for the O warpgroups
    sm90::mbar_wait(&qbar, 0);
    if (!kScoreScale) {
      // q scaled in bf16 in place, 8 values a 16-byte chunk
#pragma unroll 4
      for (int i = 0; i < WTILE / 16 / 128; ++i) {
        uint4* p = reinterpret_cast<uint4*>(qs) + tid + 128 * i;
        uint4 u = *p;
        uint32_t* e = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          e[j] = pack_bf16x2(__uint_as_float(e[j] << 16) * a.scale,
                             __uint_as_float(e[j] & 0xffff0000u) * a.scale);
        *p = u;
      }
      sm90::fence_async_cta();
      sm90::named_sync(1, 128);
    }
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};
    const float c2 = kScoreScale ? a.scale * kLog2e : kLog2e;
    const int row_a = q0 + r;
    for (int t = 0; t < kv_tiles; ++t) {
      const int i0 = t * 2 * WBOXES;  // the tile's first K box
#pragma unroll
      for (int bx = 0; bx < WBOXES; ++bx)
        sm90::mbar_wait(&full[rp.stage(i0 + bx)], rp.parity(i0 + bx));
      float s[WKV / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int bx = 0; bx < WBOXES; ++bx) {
        const uint64_t qdsc = sm90::smem_desc<128>(qs + bx * WBOX);
        const uint64_t kdsc =
            sm90::smem_desc<128>(ring + rp.stage(i0 + bx) * WBOX);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::Wgmma<64>::ss(s, sm90::desc_k(qdsc, ks),
                              sm90::desc_k(kdsc, ks), bx > 0 || ks > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::hold(s);
      if (lane == 0)
#pragma unroll
        for (int bx = 0; bx < WBOXES; ++bx)
          sm90::mbar_arrive(&empty[rp.stage(i0 + bx)]);

      if ((t + 1) * WKV > m || (causal && (t + 1) * WKV - 1 > q0)) {
#pragma unroll
        for (int i = 0; i < WKV / 2; ++i) {
          const int row = row_a + ((i / 2) % 2) * 8;
          const int col = t * WKV + (i / 4) * 8 + 2 * qd + i % 2;
          if (!visible(row, col, m, causal, a.cond_len)) s[i] = -INFINITY;
        }
      }
      float alpha[2], ml2[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < WKV / 8; ++j)
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
      for (int i = 0; i < WKV / 2; ++i) {
        const int hh = (i / 2) % 2;
        s[i] = exp_shifted(s[i], ml2[hh], c2);
        part[hh][(i / 4) % 4] += s[i];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        row_sum[hh] = row_sum[hh] * alpha[hh] + ((part[hh][0] + part[hh][1]) +
                                                 (part[hh][2] + part[hh][3]));
      // P, rounded to bf16, into slot t % 2 once the O warpgroups have read
      // tile t - 2 from it
      const int slot = t & 1;
      if (t >= 2) sm90::named_sync(BAR_PEMPTY + slot, kRoleThreads);
      uint4* ps = pslot + slot * 4 * 128;
#pragma unroll
      for (int kk = 0; kk < WKV / 16; ++kk) {
        uint32_t f[4];
        sm90::frag_from_acc(f, s, kk);
        ps[kk * 128 + tid] = make_uint4(f[0], f[1], f[2], f[3]);
      }
      if (qd == 0) {
        alpha_s[slot * 64 + r] = alpha[0];
        alpha_s[slot * 64 + r + 8] = alpha[1];
      }
      sm90::named_arrive(BAR_PFULL + slot, kRoleThreads);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = row_sum[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (qd == 0) linv_s[r + 8 * hh] = 1.f / l;
    }
    sm90::named_arrive(BAR_LSUM, kRoleThreads);
    return;
  }

  // O warpgroup o: lanes [o * OBOX * 64, (o + 1) * OBOX * 64) of the output;
  // per key tile O = alpha O + P V, P from the slot as register A
  // fragments against V read MN-major, one product per 64-lane box
  sm90::regs_alloc<WO_REGS>();
  const int o = wg - 1;
  float acc[WOBOX][32];
#pragma unroll
  for (int j = 0; j < WOBOX; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  for (int t = 0; t < kv_tiles; ++t) {
    const int slot = t & 1;
    sm90::named_sync(BAR_PFULL + slot, kRoleThreads);
    const uint4* ps = pslot + slot * 4 * 128;
    uint32_t pf[WKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < WKV / 16; ++kk) {
      const uint4 u = ps[kk * 128 + tid];
      pf[kk][0] = u.x;
      pf[kk][1] = u.y;
      pf[kk][2] = u.z;
      pf[kk][3] = u.w;
    }
    const float al[2] = {alpha_s[slot * 64 + r], alpha_s[slot * 64 + r + 8]};
    // the S warpgroup waits for this only where it refills the slot
    if (t + 2 < kv_tiles)
      sm90::named_arrive(BAR_PEMPTY + slot, kRoleThreads);
    const int i0 = t * 2 * WBOXES + WBOXES + o * WOBOX;  // its V boxes
#pragma unroll
    for (int j = 0; j < WOBOX; ++j)
      sm90::mbar_wait(&full[rp.stage(i0 + j)], rp.parity(i0 + j));
#pragma unroll
    for (int j = 0; j < WOBOX; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] *= al[(i / 2) % 2];
    // the rescaled O and the P fragments are written before the fence
#pragma unroll
    for (int j = 0; j < WOBOX; ++j) sm90::hold(acc[j]);
#pragma unroll
    for (int kk = 0; kk < WKV / 16; ++kk) sm90::hold(pf[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < WOBOX; ++j) {
      const uint64_t vd = sm90::smem_desc<128>(ring + rp.stage(i0 + j) * WBOX);
#pragma unroll
      for (int kk = 0; kk < WKV / 16; ++kk)
        sm90::Wgmma<64>::template rs<1>(acc[j], pf[kk],
                                        sm90::desc_mn<128>(vd, kk));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < WOBOX; ++j) sm90::hold(acc[j]);
#pragma unroll
    for (int kk = 0; kk < WKV / 16; ++kk) sm90::hold(pf[kk]);
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < WOBOX; ++j)
        sm90::mbar_arrive(&empty[rp.stage(i0 + j)]);
  }

  // the output, times 1 / l and rounded to bf16, into this warpgroup's
  // boxes of the q tile (the S warpgroup's last product read q before it
  // filled the last slot), then TMA stores that drop rows past n
  sm90::named_sync(BAR_LSUM, kRoleThreads);
  const float inv[2] = {linv_s[r], linv_s[r + 8]};
#pragma unroll
  for (int j = 0; j < WOBOX; ++j)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(qs + (o * WOBOX + j) * WBOX +
                                     sm90::swz<128>(r + 8 * hh, jj) + 4 * qd) =
            pack_bf16x2(acc[j][4 * jj + 2 * hh] * inv[hh],
                        acc[j][4 * jj + 2 * hh + 1] * inv[hh]);
  sm90::fence_async_cta();
  sm90::named_sync(2 + o, 128);
  if (tid == 0 && q0 < n) {
#pragma unroll
    for (int j = 0; j < WOBOX; ++j)
      sm90::tma_store_4d(&tmap_o, qs + (o * WOBOX + j) * WBOX,
                         (o * WOBOX + j) * 64, h, q0, b);
    sm90::bulk_commit();
    sm90::bulk_wait();
  }
}

template <bool kScoreScale>
int launch_wide(const void* const* ptrs, const Strides* st, int b, int n,
                int m, int heads, const FwdArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (fwd_map(&tq, ptrs[0], st[0], b, n, heads, WD, 64) ||
      fwd_map(&tk, ptrs[1], st[1], b, m, heads, WD, 64) ||
      fwd_map(&tv, ptrs[2], st[2], b, m, heads, WD, 64) ||
      fwd_map(&to, ptrs[3], st[3], b, n, heads, WD, 64))
    return ETK_TMAP_FAILED;
  cudaError_t err = cudaFuncSetAttribute(
      attn_wide_kernel<kScoreScale>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + 63) / 64, heads, b);
  attn_wide_kernel<kScoreScale><<<grid, kWideThreads, WSMEM, stream>>>(
      tq, tk, tv, to, a);
  return static_cast<int>(cudaGetLastError());
}

// the tile of a head dim: a multiple of 8 up to 128 runs on the next of
// attn_fwd_kernel's tiles (32, 64, 128), 384 on attn_wide_kernel; 0 for a
// head dim neither takes (ops.attention.attention_route mirrors it)
__host__ __device__ constexpr int fwd_tile(int head_dim) {
  return head_dim == WD                                   ? WD
         : head_dim <= 0 || head_dim % 8 || head_dim > 128 ? 0
         : head_dim <= 32                                  ? 32
         : head_dim <= 64                                  ? 64
                                                           : 128;
}

template <bool kScoreScale>
int launch_fwd_d(int head_dim, const void* const* ptrs, const Strides* st,
                 int b, int n, int m, int heads, const FwdArgs& a,
                 cudaStream_t stream) {
  switch (fwd_tile(head_dim)) {
    case 32:
      return launch_fwd<32, kScoreScale>(ptrs, st, b, n, m, heads, head_dim,
                                         a, stream);
    case 64:
      return launch_fwd<64, kScoreScale>(ptrs, st, b, n, m, heads, head_dim,
                                         a, stream);
    case 128:
      return launch_fwd<128, kScoreScale>(ptrs, st, b, n, m, heads, head_dim,
                                          a, stream);
    case WD:
      return launch_wide<kScoreScale>(ptrs, st, b, n, m, heads, a, stream);
    default:
      return ETK_BAD_ARGS;
  }
}

}  // namespace

// q, out: bf16 (B, N, H, D); k, v: bf16 (B, M, H, D); each addressed as
// base + b * batch + h * head + row * row_stride + lane, its three strides
// in elements (multiples of 8; 0 only on an axis of size 1) at
// strides[3 * i .. 3 * i + 2] for q, k, v, out; every base 16-byte
// aligned. score_scale: 1 puts the scale on the fp32 scores, 0 scales q in
// bf16. A multiple of 8 up to 128 runs attn_fwd_kernel on the next tile
// of 32, 64 or 128 lanes, D 384 attn_wide_kernel.
ETK_API int etk_attention_bnhd(const void* q, const void* k, const void* v,
                               void* out, const int* strides, int b, int n,
                               int m, int heads, int head_dim, float scale,
                               int score_scale, int mask_mode, int cond_len,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || m <= 0 || heads <= 0 || b > 65535 ||
      heads > 65535 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    const int rows = i == 1 || i == 2 ? m : n;
    if (st[i].batch < 0 || st[i].head < 0 || st[i].row < 0 ||
        st[i].batch % 8 || st[i].head % 8 || st[i].row % 8 ||
        (st[i].batch == 0 && b > 1) || (st[i].head == 0 && heads > 1) ||
        (st[i].row == 0 && rows > 1))
      return ETK_BAD_ARGS;
  }
  const void* ptrs[4] = {q, k, v, out};
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

// Backward of the prior's attention at head dim 384: dq, dk and dv from q
// (already scaled), k, v and dO, each (B, N, H*384) bf16 or fp32 with rows
// read in place at lane offset h*384 (a row stride per tensor; batches are
// N rows apart). Outputs in the inputs' dtype, (B, N, H*384).
//
// Replaces enhancing_tpu/ops/attention.py::_attn_bwd_kernel with
// heads_per_slab == 1 and a slab of 384 lanes, as _attention_packed_bwd_call
// enters it for the GPT prior (16 heads of 384). Numerics as there and as
// csrc/attention_bwd.cu states them for D <= 128: scores, softmax, dP =
// dO V^T and every accumulator in fp32; P = e / sum(e) with the exact row
// max; delta = rowsum(P * dP) in fp32. bf16: dS = P * (dP - delta) is
// rounded to bf16 before the dq and dk products, P before dv; dk and dv
// sum in fp32 over every query and are rounded once. fp32: nothing is
// rounded; every product runs on the bf16 tensor cores as the six products
// of exact bf16 pieces (sm90.cuh, "exact products"; no TF32): the split
// pass of f32_pieces.cuh writes q, k, v and dO once as three pieces each
// into a (3 B, N, H, D) bf16 scratch, and P and dS are split as they are
// handed over. S and dP sum hi*hi and the small five in two accumulators
// folded once; dq, dk and dv add the six terms to their running
// accumulators, as attention_f32.cu's backward does. Masks 'none' and
// 'prefix_causal' (col <= row, or both < cond_len); rows and keys past N
// are masked, so any N works. Neither S nor P (nor dP or dS) reaches
// device memory; nothing is summed with atomics, so two calls give the
// same bits.
//
// Bound on the H100 (B 4, H 16, N 1025, causal): tensor-core operations,
// the function's five products of 2 D a visible (query, key) pair, 0.1307
// ms at 989 TFLOP/s; fp32 six bf16 products each, 0.7840 ms. The kernels
// compute ten (S and dP in each of the rows kernel's two sweeps; S, dP and
// dk in a dk block; S and dv in a dv block) on m64n64 shared-memory
// wgmmas, which read 4 KiB of operands a k16 step: shared memory's 128
// bytes a clock, as much as the tensor cores' rate. fp32 streams every
// operand's pieces from L2 for each tile (below), so L2 bounds it.
//
// Design: the roles and rings of sm90.cuh, as attention_bnhd.cu's and
// attention_f32.cu's wide forwards run them. A block owns a fixed 64-row
// tile (queries in the rows kernel, keys in the cols kernel) of one
// (batch, head) and walks the other side's 64-row tiles. 640 threads:
//   - a producer warp streams 64-lane boxes (each box's P pieces one ring
//     stage) by TMA through an mbarrier ring;
//   - a score warpgroup forms the 64 x 64 tiles S = F T^T and dP over the
//     384 lanes with shared-memory wgmma, box by box (a commit group per
//     box: the previous box's stages go back while the next box's products
//     run), F the fixed side (q, dO in the rows kernel; K, V in the cols
//     kernel: S^T and dP^T), T the streamed side; it takes the softmax and
//     writes dS (or P) into the slot as a K-major A operand;
//   - three accumulating warpgroups own 128 lanes each of the (64, 384)
//     output, dq += dS K, dk += dS^T q or dv += P^T dO by shared-memory
//     wgmma, the B box read MN-major; named barriers hand the slot over
//     (their products are short beside the score warpgroup's, so one slot
//     serves).
// rows kernel: sweep 1 carries the online row max, sum and sum of e * dP
// (m, 1 / l and delta into a (3, B, H, N_pad) fp32 workspace), sweep 2
// recomputes S and dP and hands dS to the dq warpgroups. cols kernel:
// blocks 2j and 2j + 1 own key tile j, one for dk (S, dP, dS^T) and one
// for dv (S, P^T): dk and dv of 64 keys are 192 KiB of fp32 accumulator,
// more than a block's registers beside the score tiles, so S is formed
// twice there. Every product is a compile-time run of wgmmas: no runtime
// loop around them, no accumulator read while they run.
//
// What this does about csrc/attention_bwd_wide.cu's first design (mma.sync
// fed by cp.async, PR 15): (1) every product is wgmma (HGMMA), none
// mma.sync; (2) copies run ahead of the products through the ring, and the
// consumers wait only on mbarriers; (3) fp32 operands are split into
// pieces once, by the split pass, not at every fragment load, and S and dP
// keep hi*hi apart from the small five; (4) the products are ten of 2 N^2 D
// where the function needs five (nine before): the accumulators, not the
// products, set the layout.
//
// Budget (D = 384; a (64, 64) box is 8 KiB a piece; registers by
// setmaxnreg from the launch's 96 a thread):
//              fixed side (F)        slot    ring               score  acc
//   bf16 (P 1) resident, 2 x 48 KiB  8 KiB   14 x 8 KiB          144   3 x 104
//                                            (dv block: 20)
//   fp32 (P 3) streamed each tile    24 KiB  8 x 24 KiB          144   3 x 104
// Accumulators: dq, dk or dv of 64 rows x 384 lanes (96 KiB fp32) as two
// m64n64 tiles in each of three warpgroups, 64 registers a thread; S and dP
// 64 x 64, 32 a thread each (fp32 forms S's two accumulators after dP is
// folded: 96 live). A 64-row tile at D = 384 is 48 KiB in bf16 and 144 KiB
// as three pieces: fp32 streams the fixed side's boxes again for every
// tile; bf16 keeps it resident and holds the S phase's streamed boxes (K
// in the rows kernel, q in a dk block) in the ring until the accumulating
// warpgroups have read them, so each of its streamed boxes is read from L2
// once a tile (fp32 reads the accumulate product's B boxes twice). A dv
// block has no dP: its ring also takes dP's F tile. Under prefix_causal,
// key tiles no row of a block sees are skipped (rows), and query tiles that
// see none of a block's keys (cols); both grids run their heaviest blocks
// first, and only the tiles that cross the diagonal or N are masked. D is
// a template parameter (a multiple of 192: 64-lane boxes split evenly over
// the three accumulating warpgroups); the entry instantiates 384.
#include "common.cuh"
#include "f32_pieces.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// roles by warpgroup: 0 scores, 1..NACC accumulate, NACC + 1 the producer
constexpr int NACC = 3;
constexpr int kThreads = (NACC + 2) * 128;
constexpr int kRoleThreads = (NACC + 1) * 128;  // score and accumulate
// named barriers: the slot filled, the slot read, the cols statistics
constexpr int BAR_FULL = 1, BAR_EMPTY = 2, BAR_STAT = 3;
// registers a thread (setmaxnreg): the launch gives 65536 / threads (96);
// the producer drops to 24, the score warpgroup takes 144, each
// accumulating warpgroup 104
constexpr int BASE_REGS = 65536 / kThreads / 8 * 8, SCORE_REGS = 144,
              ACC_REGS = 104;
static_assert(24 + SCORE_REGS + NACC * ACC_REGS <= (NACC + 2) * BASE_REGS,
              "register budget");

// the kinds of block: the rows kernel's (dq), the cols kernel's dk and dv
constexpr int MODE_ROWS = 0, MODE_DK = 1, MODE_DV = 2;

template <int D, int P>
struct Wide {
  static constexpr int NBOX = D / 64;       // 64-lane boxes across a head
  static constexpr int ABOX = NBOX / NACC;  // boxes an accumulating WG owns
  static constexpr int BOX = 64 * 128;      // one piece of a (64, 64) box
  static constexpr int STAGE = P * BOX;     // a ring stage: a box's pieces
  static constexpr bool RESIDENT = P == 1;  // the fixed side stays
  static constexpr int PER = RESIDENT ? 1 : 2;  // stages a score box
  static constexpr int FIXED = RESIDENT ? NBOX * BOX : 0;  // one F tile
  static constexpr int SLOT = STAGE;
  static constexpr int STATS = 2 * 3 * 64 * 4;  // two tiles' m, 1 / l, delta
  // layout: S's F tile, the slot, dP's F tile, the ring, the statistics; a
  // dv block (no dP) runs its ring from dP's F tile on
  static constexpr int RING =
      (sm90::kSmemLimit - 2 * FIXED - SLOT - STATS) / STAGE;
  static constexpr int RING_DV = RING + FIXED / STAGE;
  static constexpr int SMEM = 2 * FIXED + SLOT + RING * STAGE + STATS + 1024;
  static_assert(D % 64 == 0 && NBOX % NACC == 0,
                "64-lane boxes split evenly over the accumulating WGs");
  static_assert(RING >= 2 * PER + 1, "ring");
  static_assert(SMEM <= sm90::kSmemLimit, "shared memory of a block");
};

struct WideArgs {
  void *dq, *dk, *dv;
  float* stats;  // row max, 1 / row sum, delta: each (B, H, n_pad)
  long long ld_dq, ld_dk, ld_dv;
  int n, n_pad, heads, mask_mode, cond_len;
};

// One score tile over the D lanes: out = F T^T, box by box. F box bx is
// resident at fixed + bx BOX (P == 1) or streamed at ring position i0 +
// bx PER, T box bx at i0 + bx PER + PER - 1. Each box's products are one
// commit group; once the next box's are issued and the box's own are done,
// its stages go back to the producer: F when streamed, T when release_t.
// P == 3: hi*hi into big and the small five into small, folded once.
template <int D, int P>
__device__ __forceinline__ void score_tile(float (&out)[32],
                                           const uint8_t* fixed,
                                           const uint8_t* ring,
                                           uint64_t* full, uint64_t* empty,
                                           const sm90::Ring& rp, int i0,
                                           bool release_t, int lane) {
  using G = Wide<D, P>;
  auto release = [&](int bx) {
    if (lane != 0) return;
    const int i_f = i0 + bx * G::PER;
    if (!G::RESIDENT) sm90::mbar_arrive(&empty[rp.stage(i_f)]);
    if (release_t) sm90::mbar_arrive(&empty[rp.stage(i_f + G::PER - 1)]);
  };
  float big[32], small[P > 1 ? 32 : 1];
  sm90::wgmma_fence();
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx) {
    const int i_f = i0 + bx * G::PER, i_t = i_f + G::PER - 1;
    if (!G::RESIDENT) sm90::mbar_wait(&full[rp.stage(i_f)], rp.parity(i_f));
    sm90::mbar_wait(&full[rp.stage(i_t)], rp.parity(i_t));
    const uint8_t* f =
        G::RESIDENT ? fixed + bx * G::BOX : ring + rp.stage(i_f) * G::STAGE;
    const uint8_t* t = ring + rp.stage(i_t) * G::STAGE;
    uint64_t fd[P], td[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      fd[p] = sm90::smem_desc<128>(f + p * G::BOX);
      td[p] = sm90::smem_desc<128>(t + p * G::BOX);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bool acc = bx > 0 || ks > 0;
      sm90::Wgmma<64>::ss(big, sm90::desc_k(fd[0], ks),
                          sm90::desc_k(td[0], ks), acc);
      if constexpr (P > 1) {
#pragma unroll
        for (int i = 0; i < 5; ++i)
          sm90::Wgmma<64>::ss(small,
                              sm90::desc_k(fd[sm90::small_a(i)], ks),
                              sm90::desc_k(td[sm90::small_b(i)], ks),
                              acc || i > 0);
      }
    }
    sm90::wgmma_commit();
    if (bx > 0) {
      sm90::wgmma_wait<1>();  // the previous box's products are done
      release(bx - 1);
    }
  }
  sm90::wgmma_wait<0>();
  sm90::hold(big);
  if constexpr (P > 1) sm90::hold(small);
  release(G::NBOX - 1);
  if constexpr (P > 1) {
    fold(out, big, small);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) out[i] = big[i];
  }
  sm90::hold(out);  // formed here, not inside the next tile's products
}

// a 64 x 64 fp32 tile (this thread's rows r, r + 8, columns 8j + 2q, + 1)
// as the K-major A operand of the accumulate product: rounded to bf16 (P
// == 1) or as its three pieces (sm90::stage_pieces), in swizzled 128-byte
// rows
template <int P>
__device__ __forceinline__ void stage_slot(uint8_t* slot, const float (&x)[32],
                                           int r, int q) {
  if constexpr (P > 1) {
    sm90::stage_pieces(slot, 64 * 128, x, r, q);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(slot + sm90::swz<128>(r + 8 * hh, j) +
                                     4 * q) =
            pack_bf16x2(x[4 * j + 2 * hh], x[4 * j + 2 * hh + 1]);
  }
}

// mask_tile for a transposed score tile S^T (this thread's keys key_a,
// key_a + 8; queries q0 + 8j + 2q (+ 1)): entries whose query is past n or
// does not see the key become -inf
__device__ __forceinline__ void mask_tile_t(float (&s)[32], int key_a,
                                            int q0, int q, int n,
                                            bool causal, int cond_len) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = key_a + ((i / 2) % 2) * 8;
    const int query = q0 + (i / 4) * 8 + 2 * q + i % 2;
    if (query >= n || !visible(query, key, n, causal, cond_len))
      s[i] = -INFINITY;
  }
}

// an accumulating warpgroup's (64, ABOX 64) tile at rows row_a, row_a + 8
// (those < n) and lanes lane0 + 64 j + 8 jj + 2q (+ 1) of out (row r at out
// + r ld): fp32 pairs (P == 3) or bf16 pairs rounded once (P == 1)
template <int P, int ABOX>
__device__ __forceinline__ void store_tile(void* out, long long ld,
                                           const float (&acc)[ABOX][32],
                                           int row_a, int lane0, int q,
                                           int n) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_a + 8 * hh;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < ABOX; ++j)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const long long at = row * ld + lane0 + 64 * j + 8 * jj + 2 * q;
        const float x = acc[j][4 * jj + 2 * hh];
        const float y = acc[j][4 * jj + 2 * hh + 1];
        if constexpr (P == 1)
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + at) =
              pack_bf16x2(x, y);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
              make_float2(x, y);
      }
  }
}

// The rows kernel (COLS false: statistics and dq) and the cols kernel (COLS
// true: dk in even blocks, dv in odd ones). Ring positions: every role walks
// the same tiles and counts each tile's boxes alike: the dP phase (F, T
// pairs: dO, V rows; V, dO cols), the S phase (q, K rows; K, q cols), then
// the accumulate phase's B boxes (K rows, q dk, dO dv) unless they are the
// S phase's T boxes held over (bf16 rows and dk).
template <int D, int P, bool COLS>
__device__ __forceinline__ void wide_body(const CUtensorMap* mq,
                                          const CUtensorMap* mk,
                                          const CUtensorMap* mv,
                                          const CUtensorMap* mdo,
                                          const WideArgs& a) {
  using G = Wide<D, P>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[G::RING_DV], empty[G::RING_DV],
      fixbar;
  const int n = a.n, h = blockIdx.y, b = blockIdx.z, nb = gridDim.z;
  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  const int mode = COLS ? 1 + (blockIdx.x & 1) : MODE_ROWS;
  const bool with_dp = mode != MODE_DV;
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* fixed_s = smem;                  // S's F tile (bf16)
  uint8_t* slot = fixed_s + G::FIXED;       // dS or P, handed over
  uint8_t* fixed_d = slot + G::SLOT;        // dP's F tile (bf16)
  uint8_t* ring = with_dp ? fixed_d + G::FIXED : fixed_d;
  float* sstat =
      reinterpret_cast<float*>(fixed_d + G::FIXED + G::RING * G::STAGE);
  const int stages = with_dp ? G::RING : G::RING_DV;
  const sm90::Ring rp{stages};
  // the fixed tile; under the causal mask the last query tiles and the
  // first key tiles see the most, so they start first
  const int ft = COLS ? blockIdx.x / 2
                      : (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  const int f0 = ft * 64;
  int t_begin = 0, t_end;
  if (COLS) {
    // query tiles before the key tile see its keys only inside the prefix
    t_begin = causal && f0 >= a.cond_len ? ft : 0;
    t_end = (n + 63) / 64;
  } else {
    // rows past n keep the keys they may see: their statistics stay
    // finite, and the cols kernel masks them
    t_end = key_tiles(f0, 64, n, n, causal, a.cond_len);
  }
  const int ntiles = t_end - t_begin, nsweeps = COLS ? 1 : 2;
  // the tiles in the order every role walks them: fp32 cols blocks from
  // the last query tile down, so that the blocks of a (batch, head) read
  // the same tile at about the same time (their pieces outgrow L2)
  auto tile_at = [&](int tt) {
    return COLS && !G::RESIDENT ? t_end - 1 - (tt - t_begin) : tt;
  };
  auto acc_on = [&](int sweep) { return COLS || sweep == 1; };
  auto held = [&](int sweep) {
    return G::RESIDENT && acc_on(sweep) && mode != MODE_DV;
  };
  constexpr int NSB = G::NBOX * G::PER;  // stages of a score phase
  auto tile_boxes = [&](int sweep) {
    return (with_dp ? NSB : 0) + NSB +
           (acc_on(sweep) && !held(sweep) ? G::NBOX : 0);
  };
  const size_t stat_row =
      (static_cast<size_t>(b) * a.heads + h) * static_cast<size_t>(a.n_pad);
  const size_t plane = static_cast<size_t>(nb) * a.heads * a.n_pad;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&fixbar, 1);
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);  // the warps of the stage's last reader
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == NACC + 1) {
    // producer: the fixed side once (bf16), then tile by tile
    sm90::regs_dealloc<24>();
    if (tid != 0) return;
    const CUtensorMap* s_f = COLS ? mk : mq;
    const CUtensorMap* s_t = COLS ? mq : mk;
    const CUtensorMap* d_f = COLS ? mv : mdo;
    const CUtensorMap* d_t = COLS ? mdo : mv;
    const CUtensorMap* acc_b =
        mode == MODE_ROWS ? mk : mode == MODE_DK ? mq : mdo;
    if constexpr (G::RESIDENT) {
      sm90::mbar_expect_tx(&fixbar, (with_dp ? 2 : 1) * G::NBOX * G::BOX);
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) {
        sm90::tma_load_4d(fixed_s + bx * G::BOX, s_f, &fixbar, bx * 64, h,
                          f0, b);
        if (with_dp)
          sm90::tma_load_4d(fixed_d + bx * G::BOX, d_f, &fixbar, bx * 64, h,
                            f0, b);
      }
    }
    int i = 0;
    auto load = [&](const CUtensorMap* map, int row0, int bx) {
      const int s = rp.stage(i);
      sm90::mbar_wait(&empty[s], rp.parity(i) ^ 1u);
      sm90::mbar_expect_tx(&full[s], G::STAGE);
#pragma unroll
      for (int p = 0; p < P; ++p)
        sm90::tma_load_4d(ring + s * G::STAGE + p * G::BOX, map, &full[s],
                          bx * 64, h, row0, p * nb + b);
      ++i;
    };
    for (int sweep = 0; sweep < nsweeps; ++sweep)
      for (int tt = t_begin; tt < t_end; ++tt) {
        const int t = tile_at(tt);
        if (with_dp)
          for (int bx = 0; bx < G::NBOX; ++bx) {
            if (!G::RESIDENT) load(d_f, f0, bx);
            load(d_t, t * 64, bx);
          }
        for (int bx = 0; bx < G::NBOX; ++bx) {
          if (!G::RESIDENT) load(s_f, f0, bx);
          load(s_t, t * 64, bx);
        }
        if (acc_on(sweep) && !held(sweep))
          for (int bx = 0; bx < G::NBOX; ++bx) load(acc_b, t * 64, bx);
      }
    return;
  }

  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  const int r = warp * 16 + lane / 4;  // rows r and r + 8 of a tile
  if (wg == 0) {
    // score warpgroup
    sm90::regs_alloc<SCORE_REGS>();
    if constexpr (G::RESIDENT) sm90::mbar_wait(&fixbar, 0);
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f}, row_edp[2] = {0.f, 0.f};  // partial
    float ml2[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
    int i = 0, k = 0;
    for (int sweep = 0; sweep < nsweeps; ++sweep) {
      if (!COLS && sweep == 1) {
        // m, 1 / l and delta of this thread's rows, into the workspace
        // (every row of the block: the cols kernel reads whole tiles)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          ml2[hh] = row_max[hh] * kLog2e;
          float l = row_sum[hh], g = row_edp[hh];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          g += __shfl_xor_sync(0xffffffffu, g, 1);
          g += __shfl_xor_sync(0xffffffffu, g, 2);
          inv[hh] = 1.f / l;
          delta[hh] = g * inv[hh];
          if (q == 0) {
            const size_t at = stat_row + f0 + r + 8 * hh;
            a.stats[at] = row_max[hh];
            a.stats[plane + at] = inv[hh];
            a.stats[2 * plane + at] = delta[hh];
          }
        }
      }
      for (int tt = t_begin; tt < t_end; ++tt) {
        const int t = tile_at(tt);
        const bool accumulate = acc_on(sweep), hold_t = held(sweep);
        // cols: this query tile's statistics, loaded now, staged after the
        // products
        float2 st = make_float2(0.f, 0.f);
        if (COLS && tid < 96)
          st = *reinterpret_cast<const float2*>(
              a.stats + (tid / 32) * plane + stat_row + t * 64 +
              2 * (tid % 32));
        float s[32], dp[32];
        if (with_dp) {
          score_tile<D, P>(dp, fixed_d, ring, full, empty, rp, i, true,
                           lane);
          i += NSB;
        }
        score_tile<D, P>(s, fixed_s, ring, full, empty, rp, i, !hold_t,
                         lane);
        i += NSB;
        // the accumulate phase's B boxes, when streamed, are read by the
        // accumulating warpgroups, and waited on here too before the slot
        // is handed over (below): a wait on a stage whose previous phase
        // has not completed would pass on that phase's parity, so every
        // later wait of either role on these stages must find them loaded
        const int i_acc = i;
        if (accumulate && !hold_t) i += G::NBOX;
        if constexpr (COLS) {
          float* stt = sstat + (t & 1) * 192;
          if (tid < 96)
            *reinterpret_cast<float2*>(stt + (tid / 32) * 64 +
                                       2 * (tid % 32)) = st;
          sm90::named_sync(BAR_STAT, 128);
          // S^T: rows are keys f0 + r (+ 8), columns queries t 64 + 8j +
          // 2q (+ 1). Only a ragged tile and, under the causal mask, one
          // whose first query comes before the block's last key hold
          // masked entries: -inf, so that P and dS are 0 there
          if ((t + 1) * 64 > n || (causal && t * 64 < f0 + 64))
            mask_tile_t(s, f0 + r, t * 64, q, n, causal, a.cond_len);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 mc =
                *reinterpret_cast<const float2*>(stt + 8 * j + 2 * q);
            const float2 ic =
                *reinterpret_cast<const float2*>(stt + 64 + 8 * j + 2 * q);
            const float2 dc =
                *reinterpret_cast<const float2*>(stt + 128 + 8 * j + 2 * q);
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const int e = e4 % 2, idx = 4 * j + e4;
              const float p = exp_shifted(s[idx], (e ? mc.y : mc.x) * kLog2e) *
                              (e ? ic.y : ic.x);
              s[idx] = with_dp ? p * (dp[idx] - (e ? dc.y : dc.x)) : p;
            }
          }
        } else {
          // only a ragged tile and, under the causal mask, one whose last
          // key comes after the block's first row hold masked entries
          if ((t + 1) * 64 > n || (causal && t * 64 + 63 > f0))
            mask_tile(s, f0 + r, t * 64, q, n, causal, a.cond_len);
          if (!accumulate) {
            // sweep 1: online m, l and sum(e * dP)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float tmax = -INFINITY;
#pragma unroll
              for (int j = 0; j < 8; ++j)
                tmax = fmaxf(tmax,
                             fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
              tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
              tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
              const float m_new = fmaxf(row_max[hh], tmax);
              const float m2 = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
              const float alpha = exp_shifted(row_max[hh], m2);
              row_max[hh] = m_new;
              float l = row_sum[hh] * alpha, g = row_edp[hh] * alpha;
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float ex = exp_shifted(s[4 * j + 2 * hh + e], m2);
                  l += ex;
                  g = fmaf(ex, dp[4 * j + 2 * hh + e], g);
                }
              row_sum[hh] = l;
              row_edp[hh] = g;
            }
            continue;
          }
          // sweep 2: dS
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int hh = (e / 2) % 2;
            const float p = exp_shifted(s[e], ml2[hh]) * inv[hh];
            s[e] = p * (dp[e] - delta[hh]);
          }
        }
        if (!hold_t)
#pragma unroll
          for (int bx = 0; bx < G::NBOX; ++bx)
            sm90::mbar_wait(&full[rp.stage(i_acc + bx)], rp.parity(i_acc + bx));
        // dS (or P) into the slot once the accumulating warpgroups have
        // read tile k - 1 from it (their products are short beside this
        // warpgroup's: one slot is enough)
        if (k >= 1) sm90::named_sync(BAR_EMPTY, kRoleThreads);
        stage_slot<P>(slot, s, r, q);
        sm90::fence_async_cta();  // the accumulating wgmmas read it
        sm90::named_arrive(BAR_FULL, kRoleThreads);
        ++k;
      }
    }
    return;
  }

  // accumulating warpgroup w: lanes [w ABOX 64, (w + 1) ABOX 64) of the
  // output; per tile acc += slot B, the slot's pieces K-major against the B
  // boxes read MN-major, one product per term, box and k16 slice
  sm90::regs_alloc<ACC_REGS>();
  const int w = wg - 1;
  float acc[G::ABOX][32];
#pragma unroll
  for (int j = 0; j < G::ABOX; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  int i = 0, k = 0;
  for (int sweep = 0; sweep < nsweeps; ++sweep)
    for (int tt = t_begin; tt < t_end; ++tt) {
      const int boxes = tile_boxes(sweep);
      if (!acc_on(sweep)) {
        i += boxes;
        continue;
      }
      int ib[G::ABOX];
#pragma unroll
      for (int j = 0; j < G::ABOX; ++j) {
        const int bb = w * G::ABOX + j;
        ib[j] = held(sweep) ? i + (with_dp ? NSB : 0) + bb * G::PER +
                                  G::PER - 1
                            : i + boxes - G::NBOX + bb;
      }
      sm90::named_sync(BAR_FULL, kRoleThreads);
#pragma unroll
      for (int j = 0; j < G::ABOX; ++j)
        sm90::mbar_wait(&full[rp.stage(ib[j])], rp.parity(ib[j]));
#pragma unroll
      for (int j = 0; j < G::ABOX; ++j) sm90::hold(acc[j]);
      uint64_t sd[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        sd[p] = sm90::smem_desc<128>(slot + p * G::BOX);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < G::ABOX; ++j) {
        uint64_t bd[P];
#pragma unroll
        for (int p = 0; p < P; ++p)
          bd[p] = sm90::smem_desc<128>(ring + rp.stage(ib[j]) * G::STAGE +
                                       p * G::BOX);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (P > 1) {
#pragma unroll
            for (int e = 0; e < 5; ++e)
              sm90::Wgmma<64>::ss<1>(
                  acc[j], sm90::desc_k(sd[sm90::small_a(e)], kk),
                  sm90::desc_mn<128>(bd[sm90::small_b(e)], kk));
          }
          sm90::Wgmma<64>::ss<1>(acc[j], sm90::desc_k(sd[0], kk),
                                 sm90::desc_mn<128>(bd[0], kk));
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < G::ABOX; ++j) sm90::hold(acc[j]);
      if (lane == 0)
#pragma unroll
        for (int j = 0; j < G::ABOX; ++j)
          sm90::mbar_arrive(&empty[rp.stage(ib[j])]);
      // the score warpgroup waits for this only where it refills the slot
      if (k + 1 < ntiles) sm90::named_arrive(BAR_EMPTY, kRoleThreads);
      ++k;
      i += boxes;
    }

  void* out = mode == MODE_ROWS ? a.dq : mode == MODE_DK ? a.dk : a.dv;
  const long long ld =
      mode == MODE_ROWS ? a.ld_dq : mode == MODE_DK ? a.ld_dk : a.ld_dv;
  const long long base = (static_cast<long long>(b) * n) * ld + h * D;
  void* at = P == 1 ? static_cast<void*>(static_cast<bf16*>(out) + base)
                    : static_cast<void*>(static_cast<float*>(out) + base);
  store_tile<P, G::ABOX>(at, ld, acc, f0 + r, w * G::ABOX * 64, q, n);
}

template <int D, int P>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_wide_rows_kernel(const __grid_constant__ CUtensorMap tmap_q,
                              const __grid_constant__ CUtensorMap tmap_k,
                              const __grid_constant__ CUtensorMap tmap_v,
                              const __grid_constant__ CUtensorMap tmap_do,
                              WideArgs a) {
  wide_body<D, P, false>(&tmap_q, &tmap_k, &tmap_v, &tmap_do, a);
}

template <int D, int P>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_wide_cols_kernel(const __grid_constant__ CUtensorMap tmap_q,
                              const __grid_constant__ CUtensorMap tmap_k,
                              const __grid_constant__ CUtensorMap tmap_v,
                              const __grid_constant__ CUtensorMap tmap_do,
                              WideArgs a) {
  wide_body<D, P, true>(&tmap_q, &tmap_k, &tmap_v, &tmap_do, a);
}

// the rows kernel, then the cols kernel (2 blocks a key tile), on the maps
// of q, k, v and dO (bf16 tensors, or the fp32 operands' pieces)
template <int D, int P>
int launch(const CUtensorMap (&m)[4], const WideArgs& a, int b,
           cudaStream_t stream) {
  constexpr int smem = Wide<D, P>::SMEM;
  auto rows = attn_bwd_wide_rows_kernel<D, P>;
  auto cols = attn_bwd_wide_cols_kernel<D, P>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      cols, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.n + 63) / 64;
  rows<<<dim3(tiles, a.heads, b), kThreads, smem, stream>>>(m[0], m[1], m[2],
                                                            m[3], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cols<<<dim3(2 * tiles, a.heads, b), kThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stats: 3 * b * heads * n_pad fp32 scratch, n_pad = n rounded up to 128.
// pieces (fp32 only): bf16 scratch of 12 * b * n * heads * 384 elements
// (q's, k's, v's and dO's three pieces). dtype ETK_BF16 or ETK_F32. Row
// strides are in elements, each row start 16-byte aligned; batches are n
// rows apart. Launches: (fp32: the split pass,) the rows kernel, the cols
// kernel.
ETK_API int etk_attention_bwd_wide(const void* q, const void* k,
                                   const void* v, const void* dout, void* dq,
                                   void* dk, void* dv, void* stats,
                                   void* pieces, int ld_q, int ld_k, int ld_v,
                                   int ld_do, int ld_dq, int ld_dk, int ld_dv,
                                   int b, int n, int heads, int dtype,
                                   int mask_mode, int cond_len, void* stream) {
  constexpr int D = 384;
  if (dtype != ETK_BF16 && dtype != ETK_F32) return ETK_BAD_ARGS;
  const bool f32 = dtype == ETK_F32;
  const int vec = f32 ? 4 : 8;  // elements of 16 bytes
  const int lds[7] = {ld_q, ld_k, ld_v, ld_do, ld_dq, ld_dk, ld_dv};
  for (int ld : lds)
    if (ld < heads * D || ld % vec) return ETK_BAD_ARGS;
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535 ||
      (f32 && pieces == nullptr) ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  auto s = static_cast<cudaStream_t>(stream);
  const void* src[4] = {q, k, v, dout};
  const int ld_in[4] = {ld_q, ld_k, ld_v, ld_do};
  CUtensorMap maps[4];
  if (f32) {
    SplitArgs sa{};
    auto* base = static_cast<__nv_bfloat16*>(pieces);
    const long long per = piece_elems(b, n, heads, D);
    for (int i = 0; i < 4; ++i)
      sa.set(i, src[i], base + i * per, Strides{n * ld_in[i], D, ld_in[i]},
             b, n, heads, D);
    const int rc = launch_split(sa, 4, s);
    if (rc) return rc;
    for (int i = 0; i < 4; ++i)
      if (piece_map(&maps[i], sa.dst[i], b, n, heads, D, 64, 64))
        return ETK_TMAP_FAILED;
  } else {
    for (int i = 0; i < 4; ++i)
      if (sm90::tensor_map_4d(&maps[i], src[i], b, n, heads, D, D, ld_in[i],
                              static_cast<long long>(n) * ld_in[i], 64, 64))
        return ETK_TMAP_FAILED;
  }
  const WideArgs a{dq,    dk,    dv, static_cast<float*>(stats),
                   ld_dq, ld_dk, ld_dv, n, (n + 127) / 128 * 128,
                   heads, mask_mode, cond_len};
  return f32 ? launch<D, 3>(maps, a, b, s) : launch<D, 1>(maps, a, b, s);
}

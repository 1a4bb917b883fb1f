// fp32 attention, forward and backward, on Hopper's bf16 tensor cores with
// exact products: the fp32 blocks that the TPU kernels take beside the bf16
// ones of attention_bnhd.cu and attention_bwd.cu.
//
// Replaces, for fp32 q, k and v, the TPU kernels of
// enhancing_tpu/ops/attention.py that those two files replace in bf16:
// - _attn_kernel_packed as entered through _attention_packed_qkv_call (B2,
//   the ViT blocks' self-attention on the fused qkv buffer) and through
//   _attention_packed_call (B8, the GPT prior's prefill, D up to 128 and
//   the prior's 384); _attn_kernel (B17) and _attn_kernel_bnhd (B18), the
//   scale on the scores; _attn_kernel_packed_gridchunk (B19, unit scale):
//   attn_f32_fwd_kernel (head dims up to 128) and attn_f32_wide_kernel
//   (384), entry etk_attention_f32;
// - _attn_kernel_packed's backward _attn_bwd_kernel as entered through
//   _attention_packed_bwd_call (B5): attn_f32_bwd_rows_kernel and
//   attn_f32_bwd_cols_kernel, entry etk_attention_bwd_f32, D up to 128.
//
// Numerics: the TPU kernels' fp32 function. Every product is exact: a
// split pass (f32_split_kernel, f32_pieces.cuh, shared with the fp32
// fusions attn_proj_f32.cu and ffn_f32.cu) writes each fp32 operand as
// three bf16
// pieces whose sum is the value exactly (sm90.cuh, "exact products"), and
// each product of the function is the six cross terms of the pieces on
// bf16 wgmma, hi*hi in one fp32 accumulator and the five small terms in
// another, folded with a round-to-nearest add. P and dS, formed in fp32
// registers, are split into pieces the same way. The sums run in another
// order than fp32 FMAs (and the tensor cores' adds inside a product
// truncate), so the outputs differ from the plain version by fp32
// rounding, not by bf16 or TF32 rounding (a single TF32 pass misses the
// fp32 limits). q is scaled in fp32 in the split pass (one rounding, as
// the plain version's q * scale) unless the scale goes on the scores
// (B17, B18: e^(scale (s - m)) by one FMA in the exponent). The forward's
// softmax is online over 64-key tiles with O and l rescaled whenever the
// row max moves; O is multiplied by 1 / l at the end and stored in fp32.
// The backward recomputes P from the rows' max and sum, as
// attention_bwd.cu does: a rows kernel takes m, l and delta = rowsum(P *
// dP) in one online sweep and dq = dS K in a second; a cols kernel takes
// dk = dS^T q and dv = P^T dO over every query tile. Nothing is summed
// with atomics: two calls give the same bits. Mask modes 'none' and
// 'prefix_causal' (col <= row, or both < cond_len); rows past N and keys
// past M are masked, so any N and M work.
//
// Bound on the H100: six bf16 products for each fp32 one, 4 D flops a
// visible (query, key) pair forward and 10 backward (the function's five
// products; the kernels compute nine) at 989 / 6 = 165 TFLOP/s, against
// the fp32 operands' bytes. The split pass reads each operand once and
// writes 1.5x its bytes; the pieces are read through L2 by every block of
// a (batch, head).
//
// Design. The pieces are (3 B, rows, H, D) bf16 tensors, piece p of batch
// b at batch index p B + b, so one 4-D tensor map per operand
// (sm90::tensor_map_4d, lanes past the head dim filled with zeros) feeds
// every box, as the bf16 kernels' maps do. Head dims that are multiples of
// 8 up to 128 run on the next tile of 32, 64 or 128 lanes (a head dim
// between them, as ViT-VQGAN-Large's 80, loads zeros past its lanes, which
// add nothing to any product, and the fp32 stores skip them).
// - attn_fwd (D <= 128): two consumer warpgroups of 64 query rows and a
//   producer warp; the q tile's three pieces stay in shared memory, the 64-
//   key K and V tiles (three pieces each) stream through one TMA ring, K and
//   V in stages of their own, read by both warpgroups. Per key tile: S = q
//   K^T by shared-memory wgmma (6 x D / 16 products of m64n64k16), the
//   online softmax in fp32, P split into register-A fragments of its three
//   pieces, O += P V by register-A wgmma against V read MN-major.
// - attn_wide (D = 384, the GPT prior's heads): a 64-row q tile in three
//   pieces is 147 KB, so q cannot stay beside K and V. Roles by warpgroup,
//   as attention_bnhd.cu's attn_wide_kernel: an S warpgroup streams q's
//   and K's 64-lane boxes (three pieces each) through the ring, forms S
//   once per 64-key tile, runs the softmax and writes P's three pieces
//   into a shared-memory slot (swizzled as wgmma's A operand) and the
//   rows' rescale factors beside it; three O warpgroups own 128 lanes of O
//   each and add P V by shared-memory wgmma against V read MN-major; named
//   barriers hand the two slots over.
// - the backward (D <= 128): attention_bwd.cu's rows and cols kernels with
//   the products on pieces. At D = 128 a block has one consumer warpgroup
//   (64 rows or keys: q and dO, or K and V, in three pieces fill 96 KB),
//   else two; the cols kernel streams 32-query tiles, which keeps its dk and
//   dv accumulators and the pieces of P^T and dS^T in registers.
#include "common.cuh"
#include "f32_pieces.cuh"
#include "sm90.cuh"

namespace {

// A thread's (rows, lanes) accumulator, times scale per row, stored as fp32
// pairs at out + row * ld + lane for rows < n and lanes < d: n8 block j of
// box bx holds rows row_a, row_a + 8 and lanes bx BOXC + 8j + 2q (+ 1)
template <int BOXC, int NBOX>
__device__ __forceinline__ void store_f32(float* out, long long ld,
                                          const float (&acc)[NBOX][BOXC / 2],
                                          int row_a, int q, int n, int d,
                                          const float (&scale)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_a + 8 * hh;
    if (row >= n) continue;
    float* o = out + row * ld;
#pragma unroll
    for (int bx = 0; bx < NBOX; ++bx)
#pragma unroll
      for (int j = 0; j < BOXC / 8; ++j) {
        const int lane = bx * BOXC + 8 * j + 2 * q;
        if (lane < d)
          *reinterpret_cast<float2*>(o + lane) =
              make_float2(acc[bx][4 * j + 2 * hh] * scale[hh],
                          acc[bx][4 * j + 2 * hh + 1] * scale[hh]);
      }
  }
}

// ---- forward, D <= 128 ---------------------------------------------------------

constexpr int FWG = 2, FQ = FWG * 64;  // consumer warpgroups, rows a block
constexpr int kFwdThreads = (FWG + 1) * 128;

template <int D>
struct FwdGeo {
  using G = Geo<D>;
  static constexpr int QBYTES = FWG * G::ptile(64);  // q's pieces, per WG
  static constexpr int STAGE = G::ptile(KT);         // a K or a V tile
  static constexpr int STAGES = fit_stages(QBYTES, STAGE, 6);
  static constexpr int SMEM = QBYTES + STAGES * STAGE + 1024;
  static_assert(STAGES >= 2, "a K and a V tile in flight");
  static_assert(SMEM <= sm90::kSmemLimit, "shared memory of a block");
};

struct FwdArgs {
  int n, m, d, mask_mode, cond_len;
  float scale;
  Strides so;  // out: fp32 (B, N, H, D), the strides of its batches, heads
               // and rows
};

template <int D, bool kScoreScale>
__global__ void __launch_bounds__(kFwdThreads, 1)
    attn_f32_fwd_kernel(const __grid_constant__ CUtensorMap tmap_q,
                        const __grid_constant__ CUtensorMap tmap_k,
                        const __grid_constant__ CUtensorMap tmap_v,
                        float* __restrict__ out, FwdArgs a) {
  using G = Geo<D>;
  using F = FwdGeo<D>;
  constexpr int RB = G::RB, BOX = 64 * RB, PT = G::ptile(64);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qbar, full[F::STAGES], empty[F::STAGES];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* qs = smem;  // per warpgroup: piece p, box bx at (p NBOX + bx) BOX
  uint8_t* ring_mem = smem + F::QBYTES;
  const sm90::Ring ring{F::STAGES};

  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.z, n = a.n, m = a.m;
  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  const int kv_tiles = key_tiles(q0, FQ, n, m, causal, a.cond_len);

  if (threadIdx.x == 0) {
    sm90::mbar_init(&qbar, 1);
    for (int s = 0; s < F::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], FWG);  // one arrival per warpgroup
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= FWG * 128) {
    // producer: q's pieces once, then K_t, V_t in stages of their own
    sm90::regs_dealloc<40>();
    if (threadIdx.x != FWG * 128) return;
    sm90::mbar_expect_tx(&qbar, F::QBYTES);
#pragma unroll
    for (int w = 0; w < FWG; ++w)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int bx = 0; bx < G::NBOX; ++bx)
          sm90::tma_load_4d(qs + w * PT + (p * G::NBOX + bx) * BOX, &tmap_q,
                            &qbar, bx * G::BOXC, h, q0 + w * 64, p * nb + b);
    for (int i = 0; i < 2 * kv_tiles; ++i) {
      const int s = ring.stage(i), t = i / 2;
      sm90::mbar_wait(&empty[s], ring.parity(i) ^ 1u);
      uint8_t* st = ring_mem + s * F::STAGE;
      sm90::mbar_expect_tx(&full[s], F::STAGE);
      const CUtensorMap* map = i % 2 ? &tmap_v : &tmap_k;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int bx = 0; bx < G::NBOX; ++bx)
          sm90::tma_load_4d(st + (p * G::NBOX + bx) * BOX, map, &full[s],
                            bx * G::BOXC, h, t * KT, p * nb + b);
    }
    return;
  }

  sm90::regs_alloc<232>();
  const int w = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int wq0 = q0 + w * 64, row_a = wq0 + warp * 16 + lane / 4;
  const bool leader = threadIdx.x % 128 == 0;
  const int my_tiles = key_tiles(wq0, 64, n, m, causal, a.cond_len);
  const uint8_t* qw = qs + w * PT;
  sm90::mbar_wait(&qbar, 0);

  float o[G::NBOX][G::BOXC / 2];
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
    for (int i = 0; i < G::BOXC / 2; ++i) o[bx][i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
  const float c2 = kScoreScale ? a.scale * kLog2e : kLog2e;

  for (int t = 0; t < kv_tiles; ++t) {
    const int sk = ring.stage(2 * t), sv = ring.stage(2 * t + 1);
    sm90::mbar_wait(&full[sk], ring.parity(2 * t));
    float s[32];
    if (t < my_tiles) {
      // S = q K^T: hi*hi into sb, the five small terms into ss
      const uint8_t* kt = ring_mem + sk * F::STAGE;
      float sb[32], ss[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) {
        uint64_t qd[NP], kd[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          qd[p] = sm90::smem_desc<RB>(qw + (p * G::NBOX + bx) * BOX);
          kd[p] = sm90::smem_desc<RB>(kt + (p * G::NBOX + bx) * BOX);
        }
#pragma unroll
        for (int ks = 0; ks < G::KS; ++ks) {
          const bool acc = bx > 0 || ks > 0;
          sm90::Wgmma<64>::ss(sb, sm90::desc_k(qd[0], ks),
                              sm90::desc_k(kd[0], ks), acc);
#pragma unroll
          for (int i = 0; i < 5; ++i)
            sm90::Wgmma<64>::ss(ss, sm90::desc_k(qd[sm90::small_a(i)], ks),
                                sm90::desc_k(kd[sm90::small_b(i)], ks),
                                acc || i > 0);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::hold(sb);
      sm90::hold(ss);
      fold(s, sb, ss);
    }
    if (leader) sm90::mbar_arrive(&empty[sk]);
    sm90::mbar_wait(&full[sv], ring.parity(2 * t + 1));
    if (t < my_tiles) {
      // a tile needs the mask where it passes m or, causal, where one of
      // its keys lies past this warpgroup's first row
      if ((t + 1) * KT > m || (causal && (t + 1) * KT - 1 > wq0))
        mask_tile(s, row_a, t * KT, q, m, causal, a.cond_len);
      float alpha[2];
      softmax_tile(s, row_max, row_sum, alpha, c2);
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
        for (int i = 0; i < G::BOXC / 2; ++i) o[bx][i] *= alpha[(i / 2) % 2];
      uint32_t pf[KT / 16][NP][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) sm90::frag_pieces(pf[kk], s, kk);
      // O += P V: the rescaled O and the fragments are written before the
      // fence, and stay live until the products that read them are done
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) sm90::hold(o[bx]);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p) sm90::hold(pf[kk][p]);
      const uint8_t* vt = ring_mem + sv * F::STAGE;
      sm90::wgmma_fence();
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) {
        uint64_t vd[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          vd[p] = sm90::smem_desc<RB>(vt + (p * G::NBOX + bx) * BOX);
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < 5; ++i)
            sm90::Wgmma<G::BOXC>::template rs<1>(
                o[bx], pf[kk][sm90::small_a(i)],
                sm90::desc_mn<RB>(vd[sm90::small_b(i)], kk));
          sm90::Wgmma<G::BOXC>::template rs<1>(o[bx], pf[kk][0],
                                               sm90::desc_mn<RB>(vd[0], kk));
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) sm90::hold(o[bx]);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p) sm90::hold(pf[kk][p]);
    }
    if (leader) sm90::mbar_arrive(&empty[sv]);
  }

  float inv[2];
  inv_row_sums(row_sum, inv);
  if (wq0 < n)
    store_f32<G::BOXC, G::NBOX>(out + offset(a.so, b, h, 0), a.so.row, o,
                                row_a, q, n, a.d, inv);
}

// ---- forward, D = 384 ------------------------------------------------------------

constexpr int WD = 384, WBOXES = WD / 64, WO = 3, WOBOX = WBOXES / WO;
constexpr int WBOX = 64 * 128;       // one piece of a (64, 64) box
constexpr int WSTAGE = NP * WBOX;    // its three pieces: a ring stage
constexpr int WTILE = 3 * WBOXES;    // stages a key tile: q, K, then V boxes
constexpr int kWideThreads = (2 + WO) * 128;
constexpr int kRoleThreads = (1 + WO) * 128;  // S and O
// named barriers: 5-6 P slot filled, 7-8 P slot read, 9 the row sums
constexpr int BAR_PFULL = 5, BAR_PEMPTY = 7, BAR_LSUM = 9;
// two slots of P's three pieces, each a (64, 64) K-major A operand; beside
// them each slot's rescale factors and the final 1 / l, a float a row
constexpr int WFIXED = 2 * WSTAGE + 3 * 64 * 4;
constexpr int WRING = fit_stages(WFIXED, WSTAGE, 8);
constexpr int WSMEM = WRING * WSTAGE + WFIXED + 1024;
static_assert(WRING >= 4, "a q and a K box in flight beside the next two");
static_assert(WSMEM <= sm90::kSmemLimit, "shared memory of a block");
// A parity wait on a ring stage passes at once while the stage's previous
// phase is still incomplete, so no role may wait on a stage whose previous
// load it has not seen complete. An O warpgroup waits only on its own V
// boxes: with WBOXES <= WRING <= 2 WBOXES a V box's previous load is a q or
// K box of the same key tile, which the S warpgroup has waited on before it
// hands that tile's P over. The S warpgroup waits on every stage in order,
// the V boxes of each tile too (before that handover, while no O warpgroup
// can free them).
static_assert(WRING >= WBOXES && WRING <= 2 * WBOXES,
              "a V box's previous load is a q or K box of its key tile");
// registers a thread (setmaxnreg): the launch gives 65536 / threads (96);
// the producer drops to 24, S takes 144, each O warpgroup 104
constexpr int WBASE = 65536 / kWideThreads / 8 * 8, WS_REGS = 144,
              WO_REGS = 104;
static_assert(24 + WS_REGS + WO * WO_REGS <= (2 + WO) * WBASE,
              "register budget");

template <bool kScoreScale>
__global__ void __launch_bounds__(kWideThreads, 1)
    attn_f32_wide_kernel(const __grid_constant__ CUtensorMap tmap_q,
                         const __grid_constant__ CUtensorMap tmap_k,
                         const __grid_constant__ CUtensorMap tmap_v,
                         float* __restrict__ out, FwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[WRING], empty[WRING];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* ring = smem;
  uint8_t* pslot = smem + WRING * WSTAGE;  // two slots of WSTAGE bytes
  float* alpha_s = reinterpret_cast<float*>(pslot + 2 * WSTAGE);  // [2][64]
  float* linv_s = alpha_s + 2 * 64;                                // [64]
  const sm90::Ring rp{WRING};

  const int n = a.n, m = a.m, nb = gridDim.z;
  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  // under the causal mask the last q tiles see the most keys: start them
  // first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * 64;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_tiles = key_tiles(q0, 64, n, m, causal, a.cond_len);

  if (threadIdx.x == 0) {
    for (int s = 0; s < WRING; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);  // one arrival per reading warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == WO + 1) {
    // producer: per key tile q box 0, K box 0, ..., q box 5, K box 5, then
    // V boxes 0-5, each box's three pieces one ring stage
    sm90::regs_dealloc<24>();
    if (tid != 0) return;
    int i = 0;
    for (int t = 0; t < kv_tiles; ++t)
      for (int j = 0; j < WTILE; ++j, ++i) {
        const int s = rp.stage(i);
        sm90::mbar_wait(&empty[s], rp.parity(i) ^ 1u);
        sm90::mbar_expect_tx(&full[s], WSTAGE);
        const bool qk = j < 2 * WBOXES, is_q = qk && j % 2 == 0;
        const CUtensorMap* map = is_q ? &tmap_q : qk ? &tmap_k : &tmap_v;
        const int box = qk ? j / 2 : j - 2 * WBOXES;
        const int row = is_q ? q0 : t * KT;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          sm90::tma_load_4d(ring + s * WSTAGE + p * WBOX, map, &full[s],
                            box * 64, h, row, p * nb + b);
      }
    return;
  }

  const int warp = tid / 32, lane = tid % 32, qd = lane % 4;
  const int r = warp * 16 + lane / 4;  // rows r and r + 8 of the tile
  if (wg == 0) {
    // S warpgroup: S = q K^T box by box (a commit group each, so that a
    // box's stages go back to the producer while the next box's products
    // run), the online softmax, P's pieces and the rescale into a slot
    sm90::regs_alloc<WS_REGS>();
    float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
    const float c2 = kScoreScale ? a.scale * kLog2e : kLog2e;
    for (int t = 0; t < kv_tiles; ++t) {
      const int i0 = t * WTILE;
      float sb[32], ss[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int bx = 0; bx < WBOXES; ++bx) {
        const int iq = i0 + 2 * bx, ik = iq + 1;
        sm90::mbar_wait(&full[rp.stage(iq)], rp.parity(iq));
        sm90::mbar_wait(&full[rp.stage(ik)], rp.parity(ik));
        uint64_t qdsc[NP], kdsc[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          qdsc[p] = sm90::smem_desc<128>(ring + rp.stage(iq) * WSTAGE +
                                         p * WBOX);
          kdsc[p] = sm90::smem_desc<128>(ring + rp.stage(ik) * WSTAGE +
                                         p * WBOX);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const bool acc = bx > 0 || ks > 0;
          sm90::Wgmma<64>::ss(sb, sm90::desc_k(qdsc[0], ks),
                              sm90::desc_k(kdsc[0], ks), acc);
#pragma unroll
          for (int i = 0; i < 5; ++i)
            sm90::Wgmma<64>::ss(ss, sm90::desc_k(qdsc[sm90::small_a(i)], ks),
                                sm90::desc_k(kdsc[sm90::small_b(i)], ks),
                                acc || i > 0);
        }
        sm90::wgmma_commit();
        if (bx > 0) {
          sm90::wgmma_wait<1>();  // the previous box's products are done
          if (lane == 0) {
            sm90::mbar_arrive(&empty[rp.stage(iq - 2)]);
            sm90::mbar_arrive(&empty[rp.stage(ik - 2)]);
          }
        }
      }
      sm90::wgmma_wait<0>();
      sm90::hold(sb);
      sm90::hold(ss);
      if (lane == 0) {
        sm90::mbar_arrive(&empty[rp.stage(i0 + 2 * WBOXES - 2)]);
        sm90::mbar_arrive(&empty[rp.stage(i0 + 2 * WBOXES - 1)]);
      }
      float s[32];
      fold(s, sb, ss);
      if ((t + 1) * KT > m || (causal && (t + 1) * KT - 1 > q0))
        mask_tile(s, q0 + r, t * KT, qd, m, causal, a.cond_len);
      float alpha[2];
      softmax_tile(s, row_max, row_sum, alpha, c2);
      // P's pieces into slot t % 2 once the O warpgroups have read tile
      // t - 2 from it
      const int slot = t & 1;
      if (t >= 2) sm90::named_sync(BAR_PEMPTY + slot, kRoleThreads);
      sm90::stage_pieces(pslot + slot * WSTAGE, WBOX, s, r, qd);
      if (qd == 0) {
        alpha_s[slot * 64 + r] = alpha[0];
        alpha_s[slot * 64 + r + 8] = alpha[1];
      }
      // this tile's V boxes have landed before the O warpgroups may free
      // them: the next tile's q and K boxes reuse their stages, and a wait
      // there must not pass on a V load still in flight
#pragma unroll
      for (int j = 0; j < WBOXES; ++j) {
        const int iv = i0 + 2 * WBOXES + j;
        sm90::mbar_wait(&full[rp.stage(iv)], rp.parity(iv));
      }
      sm90::fence_async_cta();  // the O warpgroups' wgmma reads P
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

  // O warpgroup o: lanes [o WOBOX 64, (o + 1) WOBOX 64) of the output; per
  // key tile O = alpha O + P V, P's pieces from the slot (shared-memory A)
  // against V read MN-major, one product per term and 64-lane box
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
    const float al[2] = {alpha_s[slot * 64 + r], alpha_s[slot * 64 + r + 8]};
    const int i0 = t * WTILE + 2 * WBOXES + o * WOBOX;  // its V boxes
#pragma unroll
    for (int j = 0; j < WOBOX; ++j)
      sm90::mbar_wait(&full[rp.stage(i0 + j)], rp.parity(i0 + j));
#pragma unroll
    for (int j = 0; j < WOBOX; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] *= al[(i / 2) % 2];
#pragma unroll
    for (int j = 0; j < WOBOX; ++j) sm90::hold(acc[j]);
    uint64_t pd[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p)
      pd[p] = sm90::smem_desc<128>(pslot + slot * WSTAGE + p * WBOX);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < WOBOX; ++j) {
      uint64_t vd[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        vd[p] = sm90::smem_desc<128>(ring + rp.stage(i0 + j) * WSTAGE +
                                     p * WBOX);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 5; ++i)
          sm90::Wgmma<64>::ss<1>(acc[j],
                                 sm90::desc_k(pd[sm90::small_a(i)], kk),
                                 sm90::desc_mn<128>(vd[sm90::small_b(i)], kk));
        sm90::Wgmma<64>::ss<1>(acc[j], sm90::desc_k(pd[0], kk),
                               sm90::desc_mn<128>(vd[0], kk));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < WOBOX; ++j) sm90::hold(acc[j]);
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < WOBOX; ++j)
        sm90::mbar_arrive(&empty[rp.stage(i0 + j)]);
    // the S warpgroup waits for this only where it refills the slot
    if (t + 2 < kv_tiles) sm90::named_arrive(BAR_PEMPTY + slot, kRoleThreads);
  }

  sm90::named_sync(BAR_LSUM, kRoleThreads);
  const float inv[2] = {linv_s[r], linv_s[r + 8]};
  if (q0 < n)
    store_f32<64, WOBOX>(out + offset(a.so, b, h, 0) + o * WOBOX * 64,
                         a.so.row, acc, q0 + r, qd, n, WD - o * WOBOX * 64,
                         inv);
}

// ---- backward (D <= 128) -----------------------------------------------------

// consumer warpgroups a block (64 rows or keys each), query rows a cols
// tile
template <int D>
struct BwdGeo {
  using G = Geo<D>;
  static constexpr int NWG = D == 128 ? 1 : 2;
  static constexpr int ROWS = NWG * 64;
  static constexpr int QT = 32;
  static constexpr int THREADS = (NWG + 1) * 128;
  // rows: q and dO in pieces, then K or V tiles of 64 keys
  static constexpr int ROWS_FIXED = 2 * NWG * G::ptile(64);
  static constexpr int ROWS_STAGE = G::ptile(KT);
  static constexpr int ROWS_STAGES = fit_stages(ROWS_FIXED, ROWS_STAGE, 6);
  static constexpr int ROWS_SMEM = ROWS_FIXED + ROWS_STAGES * ROWS_STAGE + 1024;
  // cols: K and V in pieces, then q, dO and 3 x QT statistics a stage
  static constexpr int COLS_FIXED = ROWS_FIXED;
  static constexpr int COLS_STAGE = 2 * G::ptile(QT) + 1024;
  static constexpr int COLS_STAGES = fit_stages(COLS_FIXED, COLS_STAGE, 6);
  static constexpr int COLS_SMEM = COLS_FIXED + COLS_STAGES * COLS_STAGE + 1024;
  static_assert(ROWS_STAGES >= 2 && COLS_STAGES >= 2, "ring");
  static_assert(ROWS_SMEM <= sm90::kSmemLimit &&
                    COLS_SMEM <= sm90::kSmemLimit,
                "shared memory of a block");
};

struct BwdArgs {
  float *dq, *dk, *dv, *stats;  // stats: row max, 1 / row sum, delta
  long long ld_dq, ld_dk, ld_dv;
  int n, n_pad, heads, d, mask_mode, cond_len;
};

// S = A B^T over D, six terms: hi*hi into big, the small five into small,
// both started afresh; a and b hold each piece's descriptor per box
template <int N, int NBOX, int KS, int R>
__device__ __forceinline__ void piece_product(float (&big)[R],
                                              float (&small)[R],
                                              const uint64_t (&a)[NBOX][NP],
                                              const uint64_t (&b)[NBOX][NP]) {
#pragma unroll
  for (int bx = 0; bx < NBOX; ++bx)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const bool acc = bx > 0 || ks > 0;
      sm90::Wgmma<N>::ss(big, sm90::desc_k(a[bx][0], ks),
                         sm90::desc_k(b[bx][0], ks), acc);
#pragma unroll
      for (int i = 0; i < 5; ++i)
        sm90::Wgmma<N>::ss(small, sm90::desc_k(a[bx][sm90::small_a(i)], ks),
                           sm90::desc_k(b[bx][sm90::small_b(i)], ks),
                           acc || i > 0);
    }
}

// acc[bx] += F B: F the register-A pieces of KK k16 slices, B's pieces
// MN-major (16 rows a slice), one product per term and box
template <int BOXC, int RB, int NBOX, int KK>
__device__ __forceinline__ void piece_product_rs(
    float (&acc)[NBOX][BOXC / 2], const uint32_t (&f)[KK][NP][4],
    const uint64_t (&b)[NBOX][NP]) {
#pragma unroll
  for (int bx = 0; bx < NBOX; ++bx)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int i = 0; i < 5; ++i)
        sm90::Wgmma<BOXC>::template rs<1>(
            acc[bx], f[kk][sm90::small_a(i)],
            sm90::desc_mn<RB>(b[bx][sm90::small_b(i)], kk));
      sm90::Wgmma<BOXC>::template rs<1>(acc[bx], f[kk][0],
                                        sm90::desc_mn<RB>(b[bx][0], kk));
    }
}

// 1. rows: statistics and dq. Ring positions: sweep s, key tile t: K at
// 2 (s T + t), V at 2 (s T + t) + 1.
template <int D>
__global__ void __launch_bounds__(BwdGeo<D>::THREADS, 1)
    attn_f32_bwd_rows_kernel(const __grid_constant__ CUtensorMap tmap_q,
                             const __grid_constant__ CUtensorMap tmap_do,
                             const __grid_constant__ CUtensorMap tmap_k,
                             const __grid_constant__ CUtensorMap tmap_v,
                             BwdArgs a) {
  using G = Geo<D>;
  using B = BwdGeo<D>;
  constexpr int RB = G::RB, BOX = 64 * RB, PT = G::ptile(64);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qbar, full[B::ROWS_STAGES],
      empty[B::ROWS_STAGES];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* qs = smem;                    // per warpgroup: q's pieces
  uint8_t* dos = smem + B::NWG * PT;     // dO's
  uint8_t* ring_mem = smem + B::ROWS_FIXED;
  const sm90::Ring ring{B::ROWS_STAGES};

  const int q0 = blockIdx.x * B::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.z, n = a.n;
  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  // rows past n keep the keys they may see: their statistics stay finite,
  // and the cols kernel masks them
  int kv_tiles = (n + KT - 1) / KT;
  if (causal) {
    const int last_row = min(q0 + B::ROWS, n) - 1;
    const int last_col = max(last_row, q0 < a.cond_len ? a.cond_len - 1 : 0);
    kv_tiles = min(kv_tiles, last_col / KT + 1);
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(&qbar, 1);
    for (int s = 0; s < B::ROWS_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], B::NWG);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= B::NWG * 128) {
    // producer: q and dO once, then K_t, V_t over the key tiles twice
    if constexpr (B::NWG > 1) sm90::regs_dealloc<40>();
    if (threadIdx.x != B::NWG * 128) return;
    sm90::mbar_expect_tx(&qbar, B::ROWS_FIXED);
#pragma unroll
    for (int w = 0; w < B::NWG; ++w)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int bx = 0; bx < G::NBOX; ++bx) {
          const int off = w * PT + (p * G::NBOX + bx) * BOX;
          sm90::tma_load_4d(qs + off, &tmap_q, &qbar, bx * G::BOXC, h,
                            q0 + w * 64, p * nb + b);
          sm90::tma_load_4d(dos + off, &tmap_do, &qbar, bx * G::BOXC, h,
                            q0 + w * 64, p * nb + b);
        }
    for (int i = 0; i < 4 * kv_tiles; ++i) {
      const int s = ring.stage(i), t = (i / 2) % kv_tiles;
      sm90::mbar_wait(&empty[s], ring.parity(i) ^ 1u);
      uint8_t* st = ring_mem + s * B::ROWS_STAGE;
      sm90::mbar_expect_tx(&full[s], B::ROWS_STAGE);
      const CUtensorMap* map = i % 2 ? &tmap_v : &tmap_k;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int bx = 0; bx < G::NBOX; ++bx)
          sm90::tma_load_4d(st + (p * G::NBOX + bx) * BOX, map, &full[s],
                            bx * G::BOXC, h, t * KT, p * nb + b);
    }
    return;
  }

  // two consumer warpgroups take the producer's registers; one keeps what
  // the launch gives (setmaxnreg cannot hand out more than that)
  if constexpr (B::NWG > 1) sm90::regs_alloc<232>();
  const int w = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int row_a = q0 + w * 64 + warp * 16 + lane / 4;  // and row_a + 8
  const bool leader = threadIdx.x % 128 == 0;
  uint64_t qd[G::NBOX][NP], dd[G::NBOX][NP];
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int off = w * PT + (p * G::NBOX + bx) * BOX;
      qd[bx][p] = sm90::smem_desc<RB>(qs + off);
      dd[bx][p] = sm90::smem_desc<RB>(dos + off);
    }
  sm90::mbar_wait(&qbar, 0);

  // S = q K^T and dP = dO V^T of the tile at ring position i (K) and i + 1
  // (V), folded into s and dp
  auto scores = [&](int i, float (&s)[32], float (&dp)[32]) {
    const int sk = ring.stage(i), sv = ring.stage(i + 1);
    sm90::mbar_wait(&full[sk], ring.parity(i));
    sm90::mbar_wait(&full[sv], ring.parity(i + 1));
    uint64_t kd[G::NBOX][NP], vd[G::NBOX][NP];
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int off = (p * G::NBOX + bx) * BOX;
        kd[bx][p] = sm90::smem_desc<RB>(ring_mem + sk * B::ROWS_STAGE + off);
        vd[bx][p] = sm90::smem_desc<RB>(ring_mem + sv * B::ROWS_STAGE + off);
      }
    float sb[32], ss[32], db[32], ds[32];
    sm90::wgmma_fence();
    piece_product<64, G::NBOX, G::KS>(sb, ss, qd, kd);
    piece_product<64, G::NBOX, G::KS>(db, ds, dd, vd);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::hold(sb);
    sm90::hold(ss);
    sm90::hold(db);
    sm90::hold(ds);
    fold(s, sb, ss);
    fold(dp, db, ds);
  };
  auto mask = [&](float (&s)[32], int t) {
    if (causal || (t + 1) * KT > n)
      mask_tile(s, row_a, t * KT, q, n, causal, a.cond_len);
  };

  // sweep 1: online m, l and sum(e * dP)
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f}, row_edp[2] = {0.f, 0.f};  // partial
  for (int t = 0; t < kv_tiles; ++t) {
    float s[32], dp[32];
    scores(2 * t, s, dp);
    if (leader) {
      sm90::mbar_arrive(&empty[ring.stage(2 * t)]);
      sm90::mbar_arrive(&empty[ring.stage(2 * t + 1)]);
    }
    mask(s, t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(row_max[hh], tmax);
      const float ml2 = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
      const float alpha = exp_shifted(row_max[hh], ml2);
      row_max[hh] = m_new;
      float l = row_sum[hh] * alpha, g = row_edp[hh] * alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = exp_shifted(s[4 * j + 2 * hh + e], ml2);
          l += ex;
          g = fmaf(ex, dp[4 * j + 2 * hh + e], g);
        }
      row_sum[hh] = l;
      row_edp[hh] = g;
    }
  }
  float inv[2], delta[2], ml2[2];
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
  }

  // sweep 2: dS and dq += dS K (K MN-major)
  float dq[G::NBOX][G::BOXC / 2];
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
    for (int i = 0; i < G::BOXC / 2; ++i) dq[bx][i] = 0.f;
  for (int t = 0; t < kv_tiles; ++t) {
    const int i = 2 * (kv_tiles + t);
    float s[32], dp[32];
    scores(i, s, dp);
    mask(s, t);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e / 2) % 2;
      const float p = exp_shifted(s[e], ml2[hh]) * inv[hh];
      s[e] = p * (dp[e] - delta[hh]);
    }
    uint32_t df[KT / 16][NP][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) sm90::frag_pieces(df[kk], s, kk);
    uint64_t kd[G::NBOX][NP];
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        kd[bx][p] = sm90::smem_desc<RB>(ring_mem +
                                        ring.stage(i) * B::ROWS_STAGE +
                                        (p * G::NBOX + bx) * BOX);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p) sm90::hold(df[kk][p]);
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) sm90::hold(dq[bx]);
    sm90::wgmma_fence();
    piece_product_rs<G::BOXC, RB, G::NBOX, KT / 16>(dq, df, kd);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) sm90::hold(dq[bx]);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p) sm90::hold(df[kk][p]);  // read until done
    if (leader) {
      sm90::mbar_arrive(&empty[ring.stage(i)]);
      sm90::mbar_arrive(&empty[ring.stage(i + 1)]);
    }
  }

  // the statistics of every row of the block, padding rows included (the
  // cols kernel reads whole tiles), and dq
  const size_t stat_row =
      (static_cast<size_t>(b) * a.heads + h) * static_cast<size_t>(a.n_pad);
  const size_t plane = static_cast<size_t>(nb) * a.heads * a.n_pad;
  if (q == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t i = stat_row + row_a + 8 * hh;
      a.stats[i] = row_max[hh];
      a.stats[plane + i] = inv[hh];
      a.stats[2 * plane + i] = delta[hh];
    }
  }
  const float one[2] = {1.f, 1.f};
  store_f32<G::BOXC, G::NBOX>(
      a.dq + static_cast<long long>(b) * n * a.ld_dq + h * a.d, a.ld_dq, dq,
      row_a, q, n, a.d, one);
}

// 2. cols: dk and dv. A block owns ROWS keys; K and V come once in pieces,
// the q and dO tiles (32 queries) and their statistics stream by.
template <int D>
__global__ void __launch_bounds__(BwdGeo<D>::THREADS, 1)
    attn_f32_bwd_cols_kernel(const __grid_constant__ CUtensorMap tmap_k,
                             const __grid_constant__ CUtensorMap tmap_v,
                             const __grid_constant__ CUtensorMap tmap_q,
                             const __grid_constant__ CUtensorMap tmap_do,
                             BwdArgs a) {
  using G = Geo<D>;
  using B = BwdGeo<D>;
  constexpr int RB = G::RB, BOX = 64 * RB, PT = G::ptile(64);
  constexpr int QT = B::QT, QBOX = QT * RB, QPT = G::ptile(QT);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kvbar, full[B::COLS_STAGES],
      empty[B::COLS_STAGES];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* ks = smem;                  // per warpgroup: K's pieces
  uint8_t* vs = smem + B::NWG * PT;    // V's
  uint8_t* ring_mem = smem + B::COLS_FIXED;
  const sm90::Ring ring{B::COLS_STAGES};

  const int k0 = blockIdx.x * B::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.z, n = a.n;
  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  // query rows before k0 see these keys only inside the prefix
  const int t_first = (causal && k0 >= a.cond_len) ? k0 / QT : 0;
  const int t_end = (n + QT - 1) / QT;
  const size_t stat_row =
      (static_cast<size_t>(b) * a.heads + h) * static_cast<size_t>(a.n_pad);
  const size_t plane = static_cast<size_t>(nb) * a.heads * a.n_pad;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&kvbar, 1);
    for (int s = 0; s < B::COLS_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], B::NWG);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= B::NWG * 128) {
    // producer: K and V once, then q, dO and statistics tile by tile
    if constexpr (B::NWG > 1) sm90::regs_dealloc<40>();
    if (threadIdx.x != B::NWG * 128) return;
    sm90::mbar_expect_tx(&kvbar, B::COLS_FIXED);
#pragma unroll
    for (int w = 0; w < B::NWG; ++w)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int bx = 0; bx < G::NBOX; ++bx) {
          const int off = w * PT + (p * G::NBOX + bx) * BOX;
          sm90::tma_load_4d(ks + off, &tmap_k, &kvbar, bx * G::BOXC, h,
                            k0 + w * 64, p * nb + b);
          sm90::tma_load_4d(vs + off, &tmap_v, &kvbar, bx * G::BOXC, h,
                            k0 + w * 64, p * nb + b);
        }
    for (int t = t_first, it = 0; t < t_end; ++t, ++it) {
      const int s = ring.stage(it);
      sm90::mbar_wait(&empty[s], ring.parity(it) ^ 1u);
      uint8_t* st = ring_mem + s * B::COLS_STAGE;
      sm90::mbar_expect_tx(&full[s], 2 * QPT + 3 * QT * 4);
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int bx = 0; bx < G::NBOX; ++bx) {
          const int off = (p * G::NBOX + bx) * QBOX;
          sm90::tma_load_4d(st + off, &tmap_q, &full[s], bx * G::BOXC, h,
                            t * QT, p * nb + b);
          sm90::tma_load_4d(st + QPT + off, &tmap_do, &full[s], bx * G::BOXC,
                            h, t * QT, p * nb + b);
        }
      for (int p = 0; p < 3; ++p)
        sm90::bulk_load(st + 2 * QPT + p * QT * 4,
                        a.stats + p * plane + stat_row + t * QT, QT * 4,
                        &full[s]);
    }
    return;
  }

  if constexpr (B::NWG > 1) sm90::regs_alloc<232>();
  const int w = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int key_a = k0 + w * 64 + warp * 16 + lane / 4;  // and key_a + 8
  const bool leader = threadIdx.x % 128 == 0;
  uint64_t kd[G::NBOX][NP], vd[G::NBOX][NP];
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int off = w * PT + (p * G::NBOX + bx) * BOX;
      kd[bx][p] = sm90::smem_desc<RB>(ks + off);
      vd[bx][p] = sm90::smem_desc<RB>(vs + off);
    }
  float dk[G::NBOX][G::BOXC / 2], dv[G::NBOX][G::BOXC / 2];
#pragma unroll
  for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
    for (int i = 0; i < G::BOXC / 2; ++i) dk[bx][i] = dv[bx][i] = 0.f;
  sm90::mbar_wait(&kvbar, 0);

  for (int t = t_first, it = 0; t < t_end; ++t, ++it) {
    const int s_i = ring.stage(it);
    sm90::mbar_wait(&full[s_i], ring.parity(it));
    const uint8_t* st = ring_mem + s_i * B::COLS_STAGE;
    const float* stat = reinterpret_cast<const float*>(st + 2 * QPT);
    uint64_t qd[G::NBOX][NP], dd[G::NBOX][NP];
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int off = (p * G::NBOX + bx) * QBOX;
        qd[bx][p] = sm90::smem_desc<RB>(st + off);
        dd[bx][p] = sm90::smem_desc<RB>(st + QPT + off);
      }

    // S^T = K q^T and dP^T = V dO^T: this warpgroup's 64 keys x QT queries
    float s[QT / 2], dp[QT / 2];
    {
      float sb[QT / 2], ss[QT / 2], db[QT / 2], ds[QT / 2];
      sm90::wgmma_fence();
      piece_product<QT, G::NBOX, G::KS>(sb, ss, kd, qd);
      piece_product<QT, G::NBOX, G::KS>(db, ds, vd, dd);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::hold(sb);
      sm90::hold(ss);
      sm90::hold(db);
      sm90::hold(ds);
      fold(s, sb, ss);
      fold(dp, db, ds);
    }

    // P^T and dS^T in place. This thread's columns are 8j + 2q and + 1:
    // their statistics, two at a time; masked entries (only on a causal or
    // ragged tile) are exactly 0
    const bool edge = causal || (t + 1) * QT > n || k0 + B::ROWS > n;
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      const float2 mc = *reinterpret_cast<const float2*>(stat + 8 * j + 2 * q);
      const float2 ic =
          *reinterpret_cast<const float2*>(stat + QT + 8 * j + 2 * q);
      const float2 dc =
          *reinterpret_cast<const float2*>(stat + 2 * QT + 8 * j + 2 * q);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int i = 4 * j + e4, e = i % 2;
        const float ml2 = (e ? mc.y : mc.x) * kLog2e;
        float p = exp_shifted(s[i], ml2) * (e ? ic.y : ic.x);
        float ds = p * (dp[i] - (e ? dc.y : dc.x));
        if (edge) {
          const int key = key_a + ((i / 2) % 2) * 8;
          const int query = t * QT + 8 * j + 2 * q + e;
          if (query >= n || !visible(query, key, n, causal, a.cond_len))
            p = ds = 0.f;
        }
        s[i] = p;
        dp[i] = ds;
      }
    }
    uint32_t pf[QT / 16][NP][4], df[QT / 16][NP][4];
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      sm90::frag_pieces(pf[kk], s, kk);
      sm90::frag_pieces(df[kk], dp, kk);
    }
    // dv += P^T dO and dk += dS^T q, dO and q MN-major
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        sm90::hold(pf[kk][p]);
        sm90::hold(df[kk][p]);
      }
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      sm90::hold(dv[bx]);
      sm90::hold(dk[bx]);
    }
    sm90::wgmma_fence();
    piece_product_rs<G::BOXC, RB, G::NBOX, QT / 16>(dv, pf, dd);
    piece_product_rs<G::BOXC, RB, G::NBOX, QT / 16>(dk, df, qd);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int bx = 0; bx < G::NBOX; ++bx) {
      sm90::hold(dv[bx]);
      sm90::hold(dk[bx]);
    }
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p) {  // read until done
        sm90::hold(pf[kk][p]);
        sm90::hold(df[kk][p]);
      }
    if (leader) sm90::mbar_arrive(&empty[s_i]);
  }

  const float one[2] = {1.f, 1.f};
  const long long base = static_cast<long long>(b) * n;
  store_f32<G::BOXC, G::NBOX>(a.dk + base * a.ld_dk + h * a.d, a.ld_dk, dk,
                              key_a, q, n, a.d, one);
  store_f32<G::BOXC, G::NBOX>(a.dv + base * a.ld_dv + h * a.d, a.ld_dv, dv,
                              key_a, q, n, a.d, one);
}

// ---- host ------------------------------------------------------------------------

// the tile of a head dim: a multiple of 8 up to 128 runs on the next of 32,
// 64 and 128 lanes, 384 on attn_f32_wide_kernel (forward only); 0 for a
// head dim no kernel takes (ops.attention.attention_route mirrors it)
__host__ __device__ constexpr int f32_tile(int head_dim, bool backward) {
  return head_dim == WD && !backward                      ? WD
         : head_dim <= 0 || head_dim % 8 || head_dim > 128 ? 0
         : head_dim <= 32                                  ? 32
         : head_dim <= 64                                  ? 64
                                                           : 128;
}

template <int D, bool kScoreScale>
int launch_fwd(const CUtensorMap* maps, float* out, int b, int n, int heads,
               const FwdArgs& a, cudaStream_t stream) {
  constexpr int smem = FwdGeo<D>::SMEM;
  auto kernel = attn_f32_fwd_kernel<D, kScoreScale>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + FQ - 1) / FQ, heads, b);
  kernel<<<grid, kFwdThreads, smem, stream>>>(maps[0], maps[1], maps[2], out,
                                              a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kScoreScale>
int launch_wide(const CUtensorMap* maps, float* out, int b, int n, int heads,
                const FwdArgs& a, cudaStream_t stream) {
  auto kernel = attn_f32_wide_kernel<kScoreScale>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + 63) / 64, heads, b);
  kernel<<<grid, kWideThreads, WSMEM, stream>>>(maps[0], maps[1], maps[2],
                                                out, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kScoreScale>
int launch_fwd_tile(int tile, const CUtensorMap* maps, float* out, int b,
                    int n, int heads, const FwdArgs& a, cudaStream_t s) {
  switch (tile) {
    case 32:
      return launch_fwd<32, kScoreScale>(maps, out, b, n, heads, a, s);
    case 64:
      return launch_fwd<64, kScoreScale>(maps, out, b, n, heads, a, s);
    case 128:
      return launch_fwd<128, kScoreScale>(maps, out, b, n, heads, a, s);
    default:
      return launch_wide<kScoreScale>(maps, out, b, n, heads, a, s);
  }
}

template <int D>
int launch_bwd(const void* const* pieces, BwdArgs a, int b,
               cudaStream_t stream) {
  using G = Geo<D>;
  using B = BwdGeo<D>;
  const int n = a.n, heads = a.heads, d = a.d;
  auto map = [&](CUtensorMap* m, const void* ptr, int rows) {
    return piece_map(m, ptr, b, n, heads, d, rows, G::BOXC);
  };
  // pieces: q, k, v, dO
  CUtensorMap tq, tdo, tk, tv, tqc, tdoc;
  if (map(&tq, pieces[0], 64) || map(&tdo, pieces[3], 64) ||
      map(&tk, pieces[1], 64) || map(&tv, pieces[2], 64) ||
      map(&tqc, pieces[0], B::QT) || map(&tdoc, pieces[3], B::QT))
    return ETK_TMAP_FAILED;
  cudaError_t err = cudaFuncSetAttribute(
      attn_f32_bwd_rows_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, B::ROWS_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_f32_bwd_cols_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             B::COLS_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + B::ROWS - 1) / B::ROWS, heads, b);
  attn_f32_bwd_rows_kernel<D><<<grid, B::THREADS, B::ROWS_SMEM, stream>>>(
      tq, tdo, tk, tv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_f32_bwd_cols_kernel<D><<<grid, B::THREADS, B::COLS_SMEM, stream>>>(
      tk, tv, tqc, tdoc, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: fp32 (B, N, H, D); k, v: fp32 (B, M, H, D); each addressed as
// base + b * batch + h * head + row * row_stride + lane, its three strides
// in elements (multiples of 8; 0 only on an axis of size 1) at
// strides[3 * i .. 3 * i + 2] for q, k, v, out; every base 16-byte
// aligned. pieces: bf16 scratch of 3 * B * (N + 2 M) * H * D elements, 16-
// byte aligned (q's pieces, then k's, then v's). score_scale: 1 puts the
// scale on the fp32 scores, 0 scales q in fp32. Head dims: multiples of 8
// up to 128, and 384. Two launches: the split pass, then the attention.
ETK_API int etk_attention_f32(const void* q, const void* k, const void* v,
                              void* out, const int* strides, void* pieces,
                              int b, int n, int m, int heads, int head_dim,
                              float scale, int score_scale, int mask_mode,
                              int cond_len, void* stream) {
  const int tile = f32_tile(head_dim, false);
  if (b <= 0 || n <= 0 || m <= 0 || heads <= 0 || b > 65535 ||
      heads > 65535 || tile == 0 ||
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
  auto* pq = static_cast<__nv_bfloat16*>(pieces);
  __nv_bfloat16* pk = pq + piece_elems(b, n, heads, head_dim);
  __nv_bfloat16* pv = pk + piece_elems(b, m, heads, head_dim);
  SplitArgs sa{};
  const void* src[3] = {q, k, v};
  __nv_bfloat16* dst[3] = {pq, pk, pv};
  for (int i = 0; i < 3; ++i)
    sa.set(i, src[i], dst[i], st[i], b, i == 0 ? n : m, heads, head_dim,
           i == 0 && !score_scale ? scale : 1.f);
  auto s = static_cast<cudaStream_t>(stream);
  int rc = launch_split(sa, 3, s);
  if (rc) return rc;
  const int box = tile == 32 ? 32 : 64;
  CUtensorMap maps[3];
  if (piece_map(&maps[0], pq, b, n, heads, head_dim, 64, box) ||
      piece_map(&maps[1], pk, b, m, heads, head_dim, 64, box) ||
      piece_map(&maps[2], pv, b, m, heads, head_dim, 64, box))
    return ETK_TMAP_FAILED;
  const FwdArgs a{n, m, head_dim, mask_mode, cond_len, scale, st[3]};
  float* o = static_cast<float*>(out);
  return score_scale
             ? launch_fwd_tile<true>(tile, maps, o, b, n, heads, a, s)
             : launch_fwd_tile<false>(tile, maps, o, b, n, heads, a, s);
}

// The backward of etk_attention_f32 with q already scaled, on fp32 (B, N,
// H*D) q, k, v and dO with rows ld_* elements apart (multiples of 8,
// 16-byte aligned rows; batches n rows apart), into dq, dk and dv likewise.
// stats: 3 * b * heads * n_pad fp32 scratch, n_pad = n rounded up to 128;
// pieces: bf16 scratch of 12 * B * N * H * D elements (q's, k's, v's and
// dO's three pieces). Head dims: multiples of 8 up to 128. Three launches:
// the split pass, the rows kernel, the cols kernel.
ETK_API int etk_attention_bwd_f32(const void* q, const void* k, const void* v,
                                  const void* dout, void* dq, void* dk,
                                  void* dv, void* stats, void* pieces,
                                  int ld_q, int ld_k, int ld_v, int ld_do,
                                  int ld_dq, int ld_dk, int ld_dv, int b,
                                  int n, int heads, int head_dim,
                                  int mask_mode, int cond_len, void* stream) {
  const int hd = heads * head_dim;
  const int lds[7] = {ld_q, ld_k, ld_v, ld_do, ld_dq, ld_dk, ld_dv};
  for (int ld : lds)
    if (ld < hd || ld % 8) return ETK_BAD_ARGS;
  const int tile = f32_tile(head_dim, true);
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535 ||
      tile == 0 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  SplitArgs sa{};
  const void* src[4] = {q, k, v, dout};
  const int ld_in[4] = {ld_q, ld_k, ld_v, ld_do};
  const void* pc[4];
  auto* base = static_cast<__nv_bfloat16*>(pieces);
  const long long per = piece_elems(b, n, heads, head_dim);
  for (int i = 0; i < 4; ++i) {
    sa.set(i, src[i], base + i * per,
           Strides{n * ld_in[i], head_dim, ld_in[i]}, b, n, heads, head_dim);
    pc[i] = sa.dst[i];
  }
  auto s = static_cast<cudaStream_t>(stream);
  int rc = launch_split(sa, 4, s);
  if (rc) return rc;
  const BwdArgs a{static_cast<float*>(dq), static_cast<float*>(dk),
                  static_cast<float*>(dv), static_cast<float*>(stats),
                  ld_dq, ld_dk, ld_dv, n, (n + 127) / 128 * 128, heads,
                  head_dim, mask_mode, cond_len};
  switch (tile) {
    case 32:
      return launch_bwd<32>(pc, a, b, s);
    case 64:
      return launch_bwd<64>(pc, a, b, s);
    default:
      return launch_bwd<128>(pc, a, b, s);
  }
}

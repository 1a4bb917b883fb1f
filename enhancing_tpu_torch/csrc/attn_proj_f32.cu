// fp32 attention -> output projection -> bias -> residual in one kernel
// launch (after the split pass), on Hopper's bf16 tensor cores with exact
// products: out[b, i] = residual[b, i] + concat_h(softmax(q_ih . K_h^T)
// V_h) Wp^T + bp.
//
// Replaces, for fp32 operands, enhancing_tpu/ops/attention.py::
// _attn_proj_kernel as entered through _attention_proj_packed_call (B15:
// the ViT block's attention when ENHANCING_TPU_ATTN_PROJ is set; inference
// only), which attn_proj.cu replaces in bf16. q, k and v are read through
// their strides as (B, N, H*D) row-strided views (the lane slices of the
// fused qkv buffer); Wp is (HO, H*D), torch's Linear layout.
//
// Numerics: the TPU kernel's fp32 function. q is scaled in fp32 (one
// rounding, in the split pass), S = q K^T, the online softmax and O = P V
// in fp32, each head's output multiplied by 1 / l (its cast to q's dtype
// is no rounding in fp32), the projection summed in fp32, then + bp and +
// the residual in fp32. Every product is exact: the split pass
// (f32_pieces.cuh) writes q, k, v and Wp as three bf16 pieces each, and
// each product is the six cross terms of the pieces on bf16 wgmma, hi*hi
// in one fp32 accumulator and the five small terms in another, folded
// with one round-to-nearest add (attention_f32.cu's forward, whose tile
// code this kernel runs); P and the heads' outputs are split in
// registers. The sums run in another order than the plain version's, so
// the outputs differ from it by fp32 rounding. Mask modes 'none' and
// 'prefix_causal'; rows past N and keys past M are masked.
//
// Bound on the H100: six bf16 products for each fp32 one, 4 B H N M D
// flops of attention and 2 B N (H*D) HO of projection at 989 / 6 = 165
// TFLOP/s, against the fp32 operands' bytes.
//
// Design. The projection of a 64-row tile needs every head's output of
// those rows, and its two fp32 accumulators of (64, HO) do not fit one SM's
// registers (393 KB at ViT-Base); the heads' outputs in three bf16 pieces,
// (64, H*D) x 6 bytes, do not fit one block's shared memory either (295 KB
// at Base). So a thread-block cluster of C blocks shares one 64-row query
// tile of one batch row. Each block has W consumer warpgroups (two at head
// dims up to 64, one at 128) and a producer warp; the cluster's C W
// warpgroups split the heads (warpgroup g takes heads g, g + C W, ...) and
// then the output columns (64-column chunks g, g + C W, ...).
// - Attention, per head: q's tile (three pieces) by TMA into the
//   warpgroup's q buffer, 64-key K and V tiles (three pieces each) through
//   the warpgroup's own TMA ring; S by shared-memory wgmma, the online
//   softmax in fp32, P split into register-A fragments, O += P V against V
//   read MN-major (attention_f32.cu's attn_f32_fwd_kernel, one warpgroup a
//   tile). The head's output O / l is then split in registers into the
//   register-A fragments of its k16 slices (its three pieces), and each
//   thread stores its own fragments, 16 bytes a piece, into the block's
//   shared memory: 64 D 6 bytes a head, which never reach device memory.
// - A cluster barrier: every head of the tile is done.
// - Projection, per 64-column chunk of the output: the warpgroup walks H*D
//   in 64-lane steps; Wp's (64, 64) boxes (three pieces) come through its
//   ring, and each thread loads the fragments of its rows for the step's
//   four k16 slices straight from the shared memory of the block that
//   computed the head (distributed shared memory: ld.shared::cluster, the
//   thread of the same index in the owning warpgroup stored them), then six
//   register-A wgmmas a slice. The fold, + bp, + the residual in fp32 and
//   the fp32 store go from registers to device memory.
// - A cluster barrier: no block exits while a peer may read its fragments.
// The host picks C as the smallest cluster whose blocks hold their heads'
// fragments beside the q tiles and rings of at least two stages
// (proj_plan; ops/attention.py::attn_proj_f32_plan mirrors it). The
// producer feeds the warpgroups' rings in turns, every attention item of
// both before any projection item (a warpgroup projects only after the
// cluster barrier).
#include "common.cuh"
#include "f32_pieces.cuh"
#include "sm90.cuh"

namespace {

constexpr int kMaxStages = 4, kMaxCluster = 8;
constexpr int kWBox = 64 * 128;       // one piece of a (64, 64) box of Wp
constexpr int kWItem = NP * kWBox;    // its three pieces: a ring stage

// consumer warpgroups a block at head dim D: two up to 64 (each with its
// own q buffer and ring), one at 128
__host__ __device__ constexpr int proj_wgs(int d) { return d <= 64 ? 2 : 1; }
// bytes of a (64, D) tile in three pieces: a q tile, a K or V tile of 64
// keys, one head's output as fragments
__host__ __device__ constexpr int proj_tile(int d) { return NP * 64 * d * 2; }
// bytes of a ring stage: a K or V tile, or a Wp box
__host__ __device__ constexpr int proj_stage(int d) {
  return proj_tile(d) > kWItem ? proj_tile(d) : kWItem;
}

struct Plan {
  int cluster, heads_per_wg, stages, smem;  // 0s where the shape is refused
};

// For H heads of D (32, 64 or 128) and HO output columns (a multiple of
// 64; H*D a multiple of 64): the smallest cluster C of at most 8 blocks
// whose blocks hold the fragments of their warpgroups' heads (ceil(H / C W)
// each) beside the q tiles and rings of at least 2 stages; as many stages
// as then fit, at most 4.
Plan proj_plan(int heads, int d, int ho) {
  Plan p{0, 0, 0, 0};
  if ((d != 32 && d != 64 && d != 128) || heads <= 0 || ho <= 0 || ho % 64 ||
      heads * d % 64)
    return p;
  const int w = proj_wgs(d), tile = proj_tile(d), stage = proj_stage(d);
  for (int c = 1; c <= kMaxCluster; ++c) {
    const int hw = (heads + c * w - 1) / (c * w);
    const int fixed = w * tile * (1 + hw) + 1024;
    const int stages = (sm90::kSmemLimit - fixed) / (w * stage);
    if (stages >= 2) {
      p.cluster = c;
      p.heads_per_wg = hw;
      p.stages = stages < kMaxStages ? stages : kMaxStages;
      p.smem = fixed + w * p.stages * stage;
      return p;
    }
  }
  return p;
}

struct Args {
  const float* bp;   // (HO,)
  const float* res;  // (B, N, HO)
  float* out;        // (B, N, HO)
  int batch, n, m, heads, ho, mask_mode, cond_len, stages;
};

template <int D>
__global__ void __launch_bounds__((proj_wgs(D) + 1) * 128, 1)
    attn_proj_f32_kernel(const __grid_constant__ CUtensorMap tmap_q,
                         const __grid_constant__ CUtensorMap tmap_k,
                         const __grid_constant__ CUtensorMap tmap_v,
                         const __grid_constant__ CUtensorMap tmap_w, Args a) {
  using G = Geo<D>;
  constexpr int W = proj_wgs(D), RB = G::RB, BOX = 64 * RB;
  constexpr int TILE = proj_tile(D), STAGE = proj_stage(D);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[W][kMaxStages], empty[W][kMaxStages];
  // per warpgroup: its head's q tile has arrived / has been read
  __shared__ __align__(8) uint64_t qfull[W], qempty[W];
  uint8_t* smem = sm90::align_1024(smem_raw);
  const int stages = a.stages;
  const sm90::Ring ring{stages};
  // warpgroup w's q buffer at w TILE, its ring after the q buffers; then
  // the fragments of the block's heads' outputs, one TILE a head (local
  // head j = i W + w: warpgroup w's i-th head)
  auto q_buf = [&](int w) { return smem + w * TILE; };
  auto stage_mem = [&](int w, int s) {
    return smem + W * TILE + (w * stages + s) * STAGE;
  };
  uint8_t* frags = smem + W * (TILE + stages * STAGE);

  const int C = static_cast<int>(sm90::cluster_size());
  const int rank = static_cast<int>(sm90::cluster_rank());
  const int qtiles = (a.n + 63) / 64, unit = blockIdx.x / C;
  const int b = unit / qtiles, q0 = (unit % qtiles) * 64;
  const int n = a.n, m = a.m, heads = a.heads, ho = a.ho;
  const bool causal = a.mask_mode == MASK_PREFIX_CAUSAL;
  const int kv_tiles = key_tiles(q0, 64, n, m, causal, a.cond_len);
  const int gw = C * W;  // warpgroups of the cluster
  const int kchunks = heads * D / 64, cchunks = ho / 64;
  // items g, g + gw, ... of `total`: warpgroup g's heads or column chunks
  auto share = [&](int g, int total) {
    return g < total ? (total - g + gw - 1) / gw : 0;
  };

  if (threadIdx.x == 0) {
    for (int w = 0; w < W; ++w) {
      sm90::mbar_init(&qfull[w], 1);
      sm90::mbar_init(&qempty[w], 1);
      for (int s = 0; s < stages; ++s) {
        sm90::mbar_init(&full[w][s], 1);
        sm90::mbar_init(&empty[w][s], 1);
      }
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= W * 128) {
    sm90::regs_dealloc<40>();
    if (threadIdx.x == W * 128) {
      int it[W] = {};
      auto slot = [&](int w, int bytes) {
        const int s = ring.stage(it[w]);
        sm90::mbar_wait(&empty[w][s], ring.parity(it[w]) ^ 1u);
        sm90::mbar_expect_tx(&full[w][s], bytes);
        ++it[w];
        return s;
      };
      // attention: per head its q tile, then K_t and V_t; the warpgroups'
      // items in turns
      const int per_head = 1 + 2 * kv_tiles;
      int most = 0;
      for (int w = 0; w < W; ++w)
        most = max(most, share(rank * W + w, heads) * per_head);
      for (int i = 0; i < most; ++i)
        for (int w = 0; w < W; ++w) {
          const int g = rank * W + w;
          if (i >= share(g, heads) * per_head) continue;
          const int hi = i / per_head, j = i % per_head, h = g + hi * gw;
          if (j == 0) {
            sm90::mbar_wait(&qempty[w], (static_cast<uint32_t>(hi) & 1u) ^ 1u);
            sm90::mbar_expect_tx(&qfull[w], TILE);
#pragma unroll
            for (int p = 0; p < NP; ++p)
#pragma unroll
              for (int bx = 0; bx < G::NBOX; ++bx)
                sm90::tma_load_4d(q_buf(w) + (p * G::NBOX + bx) * BOX, &tmap_q,
                                  &qfull[w], bx * G::BOXC, h, q0,
                                  p * a.batch + b);
          } else {
            const int s = slot(w, TILE), t = (j - 1) / 2;
            const CUtensorMap* map = (j - 1) % 2 ? &tmap_v : &tmap_k;
#pragma unroll
            for (int p = 0; p < NP; ++p)
#pragma unroll
              for (int bx = 0; bx < G::NBOX; ++bx)
                sm90::tma_load_4d(stage_mem(w, s) + (p * G::NBOX + bx) * BOX,
                                  map, &full[w][s], bx * G::BOXC, h, t * KT,
                                  p * a.batch + b);
          }
        }
      // no peer reads what this thread writes: arrive now, so that the
      // Wp boxes stream while the cluster finishes its heads
      sm90::cluster_arrive();
      most = 0;
      for (int w = 0; w < W; ++w)
        most = max(most, share(rank * W + w, cchunks) * kchunks);
      for (int i = 0; i < most; ++i)
        for (int w = 0; w < W; ++w) {
          const int g = rank * W + w;
          if (i >= share(g, cchunks) * kchunks) continue;
          const int cc = g + (i / kchunks) * gw, kc = i % kchunks;
          const int s = slot(w, kWItem);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            sm90::tma_load_3d(stage_mem(w, s) + p * kWBox, &tmap_w,
                              &full[w][s], kc * 64, cc * 64, p);
        }
      sm90::cluster_wait();
    } else {
      sm90::cluster_arrive();
      sm90::cluster_wait();
    }
  } else {
    sm90::regs_alloc<232>();
    const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, q = lane % 4;
    const int r = warp * 16 + lane / 4;  // rows r and r + 8 of the tile
    const int row_a = q0 + r;
    const bool leader = tid == 0;
    const int g = rank * W + w;
    const uint8_t* qw = q_buf(w);
    int it = 0;

    for (int hi = 0; hi < share(g, heads); ++hi) {
      sm90::mbar_wait(&qfull[w], static_cast<uint32_t>(hi) & 1u);
      float o[G::NBOX][G::BOXC / 2];
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx)
#pragma unroll
        for (int i = 0; i < G::BOXC / 2; ++i) o[bx][i] = 0.f;
      float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};

      for (int t = 0; t < kv_tiles; ++t, it += 2) {
        const int sk = ring.stage(it), sv = ring.stage(it + 1);
        sm90::mbar_wait(&full[w][sk], ring.parity(it));
        // S = q K^T: hi*hi into sb, the five small terms into ss
        const uint8_t* kt = stage_mem(w, sk);
        float s[32], sb[32], ss[32];
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
        if (leader) sm90::mbar_arrive(&empty[w][sk]);
        sm90::mbar_wait(&full[w][sv], ring.parity(it + 1));
        // a tile needs the mask where it passes m or, causal, where one of
        // its keys lies past the tile's first row
        if ((t + 1) * KT > m || (causal && (t + 1) * KT - 1 > q0))
          mask_tile(s, row_a, t * KT, q, m, causal, a.cond_len);
        float alpha[2];
        softmax_tile(s, row_max, row_sum, alpha, kLog2e);
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
        const uint8_t* vt = stage_mem(w, sv);
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
            sm90::Wgmma<G::BOXC>::template rs<1>(
                o[bx], pf[kk][0], sm90::desc_mn<RB>(vd[0], kk));
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
        if (leader) sm90::mbar_arrive(&empty[w][sv]);
      }
      if (leader) sm90::mbar_arrive(&qempty[w]);  // its S are done

      // the head's output O / l as the fragments of its k16 slices
      float inv[2];
      inv_row_sums(row_sum, inv);
      uint8_t* hf = frags + (hi * W + w) * TILE;
#pragma unroll
      for (int bx = 0; bx < G::NBOX; ++bx) {
        float y[G::BOXC / 2];
#pragma unroll
        for (int i = 0; i < G::BOXC / 2; ++i) y[i] = o[bx][i] * inv[(i / 2) % 2];
#pragma unroll
        for (int kk = 0; kk < G::KS; ++kk)
          store_frags(hf + (bx * G::KS + kk) * kFragSlice, y, kk, tid);
      }
    }

    sm90::cluster_arrive();  // this block's heads, for the cluster
    sm90::cluster_wait();    // every head of the tile

    // projection: column chunks g, g + gw, ... of 64, H*D in 64-lane steps
    const uint32_t frag_base = smem_addr(frags);
    for (int ci = 0; ci < share(g, cchunks); ++ci) {
      const int cc = g + ci * gw;
      float big[32], small[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) big[i] = small[i] = 0.f;
      for (int kc = 0; kc < kchunks; ++kc, ++it) {
        const int s = ring.stage(it);
        sm90::mbar_wait(&full[w][s], ring.parity(it));
        // the step's k16 slices: lanes kc 64 + 16 kk of head h, from the
        // block whose warpgroup h % gw computed it
        uint32_t f[4][NP][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int lane0 = kc * 64 + kk * 16, h = lane0 / D;
          const int og = h % gw, slice = (lane0 % D) / 16;
          const int local = (h / gw) * W + og % W;
          load_frags(f[kk],
                     sm90::peer_addr(frag_base + (local * (D / 16) + slice) *
                                                     kFragSlice,
                                     og / W),
                     tid);
        }
        uint64_t wd[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wd[p] = sm90::smem_desc<128>(stage_mem(w, s) + p * kWBox);
        sm90::hold(big);
        sm90::hold(small);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p) sm90::hold(f[kk][p]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::Wgmma<64>::rs(big, f[kk][0], sm90::desc_k(wd[0], kk));
#pragma unroll
          for (int i = 0; i < 5; ++i)
            sm90::Wgmma<64>::rs(small, f[kk][sm90::small_a(i)],
                                sm90::desc_k(wd[sm90::small_b(i)], kk));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::hold(big);
        sm90::hold(small);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p) sm90::hold(f[kk][p]);
        if (leader) sm90::mbar_arrive(&empty[w][s]);
      }
      // + bp + residual in fp32, stored from registers
      float acc[32];
      fold(acc, big, small);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row_a + 8 * hh;
        if (row >= n) continue;
        const long long at = (static_cast<long long>(b) * n + row) * ho;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cc * 64 + 8 * j + 2 * q;
          const float2 bias = *reinterpret_cast<const float2*>(a.bp + col);
          const float2 res =
              *reinterpret_cast<const float2*>(a.res + at + col);
          *reinterpret_cast<float2*>(a.out + at + col) =
              make_float2((acc[4 * j + 2 * hh] + bias.x) + res.x,
                          (acc[4 * j + 2 * hh + 1] + bias.y) + res.y);
        }
      }
    }
  }
  // no block exits while a peer may still read its fragments
  sm90::cluster_arrive();
  sm90::cluster_wait();
}

template <int D>
int launch(const Plan& plan, const CUtensorMap* maps, const Args& a,
           long long blocks, cudaStream_t stream) {
  return static_cast<int>(sm90::launch_cluster(
      attn_proj_f32_kernel<D>, blocks, plan.cluster, (proj_wgs(D) + 1) * 128,
      plan.smem, stream, maps[0], maps[1], maps[2], maps[3], a));
}

}  // namespace

// q: fp32 (B, N, H*D) rows q_row elements apart; k, v: fp32 (B, M, H*D)
// rows k_row, v_row apart (multiples of 4; batches N or M rows apart; every
// start 16-byte aligned); wp: fp32 (HO, H*D); bp: fp32 (HO,); res, out:
// fp32 (B, N, HO) contiguous. pieces: bf16 scratch of 3 (B (N + 2 M) + HO)
// H*D elements, 16-byte aligned (q's pieces, k's, v's, then Wp's). Head
// dims 32, 64 and 128, at the shapes attn_proj_f32_plan takes. Two
// launches: the split pass, then the fused kernel.
ETK_API int etk_attn_proj_f32(const void* q, const void* k, const void* v,
                              const void* wp, const void* bp, const void* res,
                              void* out, void* pieces, int q_row, int k_row,
                              int v_row, int b, int n, int m, int heads,
                              int head_dim, int ho, float scale,
                              int mask_mode, int cond_len, void* stream) {
  const int hd = heads * head_dim;
  const Plan plan = proj_plan(heads, head_dim, ho);
  if (plan.cluster == 0 || b <= 0 || n <= 0 || m <= 0 || q_row < hd ||
      k_row < hd || v_row < hd || q_row % 4 || k_row % 4 || v_row % 4 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  const long long blocks =
      static_cast<long long>(b) * ((n + 63) / 64) * plan.cluster;
  if (blocks > 2147483647LL) return ETK_BAD_ARGS;
  auto* pq = static_cast<__nv_bfloat16*>(pieces);
  __nv_bfloat16* pk = pq + piece_elems(b, n, heads, head_dim);
  __nv_bfloat16* pv = pk + piece_elems(b, m, heads, head_dim);
  __nv_bfloat16* pw = pv + piece_elems(b, m, heads, head_dim);
  SplitArgs sa{};
  sa.set(0, q, pq, Strides{n * q_row, head_dim, q_row}, b, n, heads, head_dim,
         scale);
  sa.set(1, k, pk, Strides{m * k_row, head_dim, k_row}, b, m, heads,
         head_dim);
  sa.set(2, v, pv, Strides{m * v_row, head_dim, v_row}, b, m, heads,
         head_dim);
  sa.set(3, wp, pw, Strides{0, 0, hd}, 1, ho, 1, hd);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = launch_split(sa, 4, s);
  if (rc) return rc;
  const int box = head_dim == 32 ? 32 : 64;
  CUtensorMap maps[4];
  if (piece_map(&maps[0], pq, b, n, heads, head_dim, 64, box) ||
      piece_map(&maps[1], pk, b, m, heads, head_dim, 64, box) ||
      piece_map(&maps[2], pv, b, m, heads, head_dim, 64, box) ||
      piece_map_3d(&maps[3], pw, ho, hd, 64))
    return ETK_TMAP_FAILED;
  const Args a{static_cast<const float*>(bp), static_cast<const float*>(res),
               static_cast<float*>(out), b, n, m, heads, ho, mask_mode,
               cond_len, plan.stages};
  switch (head_dim) {
    case 32:
      return launch<32>(plan, maps, a, blocks, s);
    case 64:
      return launch<64>(plan, maps, a, blocks, s);
    default:
      return launch<128>(plan, maps, a, blocks, s);
  }
}

// the plan for H heads of D and HO output columns: blocks a cluster, heads
// a warpgroup, ring stages per warpgroup, dynamic shared memory, consumer
// warpgroups a block (0s where the shape is not taken)
ETK_API int etk_attn_proj_f32_plan(int heads, int head_dim, int ho,
                                   int* plan) {
  const Plan p = proj_plan(heads, head_dim, ho);
  plan[0] = p.cluster;
  plan[1] = p.heads_per_wg;
  plan[2] = p.stages;
  plan[3] = p.smem;
  plan[4] = p.cluster ? proj_wgs(head_dim) : 0;
  return 0;
}

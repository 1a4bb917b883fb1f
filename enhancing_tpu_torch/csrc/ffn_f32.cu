// fp32 fused position-wise FFN in one kernel launch (after the split
// pass), on Hopper's bf16 tensor cores with exact products: out = act(x
// W1^T + b1) W2^T + b2, the hidden never in device memory.
//
// Replaces, for fp32 x and weights, enhancing_tpu/ops/ffn.py::_ffn_kernel
// as entered through _ffn_pallas (B16: the ViT block's FFN with
// ffn_impl='fused'), which ffn.cu replaces in bf16; the JAX package runs
// it in fp32 where the two weights take at most 12 MiB (ViT-VQGAN-Small's
// 512 x 2048, Large's 512-wide encoder). W1 is (h, d) and W2 (d, h),
// torch's Linear layout.
//
// Numerics: the TPU kernel's fp32 function. The hidden is an fp32 product
// plus the fp32 bias, the activation (tanh, squared ReLU or
// tanh-approximated GELU) runs in fp32 (its cast to x's dtype is no
// rounding in fp32), the W2 products sum in fp32 over the whole hidden dim,
// then + b2 in fp32. Every product is exact: the split pass
// (f32_pieces.cuh) writes x, W1 and W2 as three bf16 pieces each, the
// hidden is split in registers, and each product is the six cross terms of
// the pieces on bf16 wgmma, hi*hi in one fp32 accumulator and the five
// small terms in another, folded with one round-to-nearest add. The sums
// run in another order than the plain version's, so the outputs differ
// from it by fp32 rounding.
//
// Bound on the H100: six bf16 products for each fp32 one, 4 m d h flops
// at 989 / 6 = 165 TFLOP/s, against the fp32 bytes of x, the weights and
// the output.
//
// Design: ffn.cu's cluster, on 64-row blocks of one consumer warpgroup (a
// 128-row tile's x in three pieces is 48 KB a 64-lane step, and two fp32
// accumulators of the output slab take 128 registers a thread). A cluster
// of C blocks shares one 64-row block; block j owns the output columns [j
// DS, (j + 1) DS), DS = 128 (the last slab may run past d: those columns
// come from zero-filled W2 rows and are not stored). The hidden is walked
// in groups of C chunks of 64: block j computes chunk j of each group, S =
// x W1[chunk]^T over K = d by shared-memory wgmma (six products a k16
// slice), folds it, adds b1 and applies the activation in fp32, splits the
// result in registers into the register-A fragments of its three pieces
// and stores each thread's own fragments, 16 bytes a piece, into the
// group's buffer in its shared memory. Then every thread arrives on every
// block's "ready" barrier (release at cluster scope); once its own has
// completed, each thread loads the fragments of its rows of each chunk of
// the group straight from the shared memory of the block that computed it
// (distributed shared memory: the thread of the same index there stored
// them) and adds H[chunk] W2[own slab, chunk]^T by register-A wgmma, six
// products a k16 slice; then it arrives on every block's "freed" barrier,
// which a block waits on before it fills that buffer again. Two buffers:
// a group's first product runs before the previous group's second one, so
// the exchange overlaps the products. A producer warpgroup streams
// x and W1 tiles, then the group's W2 slabs, through one TMA ring in the
// order the consumers use them. The host picks C = ceil(d / 128) (ffn_plan,
// mirrored by ops/ffn.py::ffn_f32_plan).
#include "common.cuh"
#include "f32_pieces.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 64, HC = 64, kMaxStages = 4, kMaxCluster = 8;
constexpr int kBuffers = 2;  // hidden buffers: groups g and g + 1
constexpr int kThreads = 256;  // one consumer warpgroup, one producer
constexpr int kBox = 64 * 128;    // one piece of a (64, 64) box
constexpr int kTile = NP * kBox;  // its three pieces; also a chunk's
                                  // fragments (4 k16 slices)

struct Plan {
  int cluster, slab, stages, smem;  // 0s where d is not taken
};

// a ring stage: an x tile and a W1 tile, or a W2 slab's box (DS, 64)
__host__ __device__ constexpr int stage_bytes(int slab) {
  return 2 * kTile > NP * slab * 128 ? 2 * kTile : NP * slab * 128;
}

// C = ceil(d / 128) blocks of 128-column slabs (one of 64 at d = 64), at
// most 8; as many ring stages as shared memory holds beside the two hidden
// buffers, at most 4
Plan ffn_plan(int d) {
  Plan p{0, 0, 0, 0};
  const int c = (d + 127) / 128;
  if (d <= 0 || d % 64 || c > kMaxCluster) return p;
  p.cluster = c;
  p.slab = d <= 64 ? 64 : 128;
  const int sb = stage_bytes(p.slab);
  const int stages = (sm90::kSmemLimit - 1024 - kBuffers * kTile) / sb;
  p.stages = stages < kMaxStages ? stages : kMaxStages;
  p.smem = kBuffers * kTile + p.stages * sb + 1024;
  return p;
}

// acc (64 x DS) += A (registers) * B^T, B (DS x 16) K-major in shared memory
template <int DS>
__device__ __forceinline__ void rs_slab(float (&acc)[DS / 2],
                                        const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DS == 64)
    sm90::Wgmma<64>::rs(acc, a, b);
  else
    sm90::Wgmma<128>::rs(acc, a, b);
}

template <int DS>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_f32_kernel(const __grid_constant__ CUtensorMap tmap_x,
                   const __grid_constant__ CUtensorMap tmap_w1,
                   const __grid_constant__ CUtensorMap tmap_w2,
                   const float* __restrict__ b1, const float* __restrict__ b2,
                   float* __restrict__ out, int m, int d, int h, int act,
                   int stages) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  // per hidden buffer: ready, every block's chunk of the buffer's group is
  // in the blocks' buffers; freed, every block has read this block's chunk
  // of it (each: one arrival per consumer thread of every block)
  __shared__ __align__(8) uint64_t ready[2], freed[2];
  uint8_t* smem = sm90::align_1024(smem_raw);
  constexpr int SB = stage_bytes(DS);
  constexpr int kW2Box = DS * 128;  // one piece of a (DS, 64) box of W2
  const int C = static_cast<int>(sm90::cluster_size());
  const int rank = static_cast<int>(sm90::cluster_rank());
  const int row0 = (blockIdx.x / C) * BM, col0 = rank * DS;
  const int chunks = h / HC, groups = (chunks + C - 1) / C;
  const int ktiles = d / 64;
  // group g's chunk of this block, as fragments, in buffer g % 2
  uint8_t* ring_mem = smem + kBuffers * kTile;
  const sm90::Ring ring{stages};
  auto buffer = [&](int g) { return smem + (g % kBuffers) * kTile; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    for (int i = 0; i < kBuffers; ++i) {
      sm90::mbar_init(&ready[i], C * 128);
      sm90::mbar_init(&freed[i], C * 128);
    }
    sm90::fence_mbar_init();
  }
  // no peer arrives on a barrier before it is initialised
  sm90::cluster_arrive();
  sm90::cluster_wait();

  if (threadIdx.x >= 128) {
    // producer warpgroup: one thread streams the tiles in the consumers'
    // order: the x and W1 tiles of a group's first product (if the block
    // has a chunk), the W2 boxes of a group's second; the first product of
    // group g + 1 comes before the second of group g
    sm90::regs_dealloc<40>();
    if (threadIdx.x == 128) {
      int it = 0;
      auto stage = [&](int bytes) {
        const int s = ring.stage(it);
        sm90::mbar_wait(&empty[s], ring.parity(it) ^ 1u);
        sm90::mbar_expect_tx(&full[s], bytes);
        ++it;
        return s;
      };
      auto first = [&](int g) {
        const int own = g * C + rank;
        if (own >= chunks) return;
        for (int kt = 0; kt < ktiles; ++kt) {
          const int s = stage(2 * kTile);
          uint8_t* st = ring_mem + s * SB;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            sm90::tma_load_3d(st + p * kBox, &tmap_x, &full[s], kt * 64, row0,
                              p);
            sm90::tma_load_3d(st + kTile + p * kBox, &tmap_w1, &full[s],
                              kt * 64, own * HC, p);
          }
        }
      };
      for (int g = 0; g <= groups; ++g) {
        if (g < groups) first(g);
        if (g == 0) continue;
        const int pieces = min(C, chunks - (g - 1) * C);
        for (int pc = 0; pc < pieces; ++pc) {
          const int s = stage(NP * kW2Box);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            sm90::tma_load_3d(ring_mem + s * SB + p * kW2Box, &tmap_w2,
                              &full[s], ((g - 1) * C + pc) * HC, col0, p);
        }
      }
    }
  } else {
    sm90::regs_alloc<232>();
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int q = lane % 4, r = warp * 16 + lane / 4;  // rows r, r + 8
    const bool leader = tid == 0;
    float big[DS / 2], small[DS / 2];
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) big[i] = small[i] = 0.f;
    int it = 0;

    // group g's chunk of this block: act(x W1[chunk]^T + b1) into its
    // buffer as fragments; then one arrival on every block's ready
    auto first = [&](int g) {
      const int own = g * C + rank, bi = g % kBuffers;
      float hid[32], ss[32];  // hid: the hi*hi terms, then the hidden
      if (own < chunks) {
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = ring.stage(it);
          sm90::mbar_wait(&full[s], ring.parity(it));
          const uint8_t* st = ring_mem + s * SB;
          uint64_t xd[NP], wd[NP];
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            xd[p] = sm90::smem_desc<128>(st + p * kBox);
            wd[p] = sm90::smem_desc<128>(st + kTile + p * kBox);
          }
          sm90::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const bool acc = kt > 0 || ks > 0;
            sm90::Wgmma<64>::ss(hid, sm90::desc_k(xd[0], ks),
                                sm90::desc_k(wd[0], ks), acc);
#pragma unroll
            for (int i = 0; i < 5; ++i)
              sm90::Wgmma<64>::ss(ss, sm90::desc_k(xd[sm90::small_a(i)], ks),
                                  sm90::desc_k(wd[sm90::small_b(i)], ks),
                                  acc || i > 0);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::hold(hid);
          sm90::hold(ss);
          if (leader) sm90::mbar_arrive(&empty[s]);
        }
        fold(hid, hid, ss);
        // + b1 and the activation in fp32: n8 block j holds hidden columns
        // own HC + 8j + 2q (+ 1) of rows r and r + 8
#pragma unroll
        for (int j = 0; j < HC / 8; ++j) {
          const float2 bias = *reinterpret_cast<const float2*>(
              b1 + own * HC + 8 * j + 2 * q);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            hid[4 * j + 2 * hh] = apply_act(hid[4 * j + 2 * hh] + bias.x, act);
            hid[4 * j + 2 * hh + 1] =
                apply_act(hid[4 * j + 2 * hh + 1] + bias.y, act);
          }
        }
      }
      // the buffer is free once every block has read its previous group;
      // waited on by every block, with or without a chunk, so that no
      // arrival below reaches a peer's ready before its previous phase
      if (g >= kBuffers)
        sm90::mbar_wait_cluster(&freed[bi],
                                static_cast<uint32_t>(g / kBuffers - 1) & 1u);
      if (own < chunks) {
#pragma unroll
        for (int kk = 0; kk < HC / 16; ++kk)
          store_frags(buffer(g) + kk * kFragSlice, hid, kk, tid);
      }
      sm90::mbar_arrive_all(&ready[bi], C);
    };

    // acc += H[group g] W2[own slab, group g]^T, one chunk a ring stage;
    // then one arrival on every block's freed
    auto second = [&](int g) {
      const int bi = g % kBuffers, pieces = min(C, chunks - g * C);
      sm90::mbar_wait_cluster(&ready[bi],
                              static_cast<uint32_t>(g / kBuffers) & 1u);
      const uint32_t base = smem_addr(buffer(g));
      for (int pc = 0; pc < pieces; ++pc, ++it) {
        const int s = ring.stage(it);
        sm90::mbar_wait(&full[s], ring.parity(it));
        uint32_t f[HC / 16][NP][4];
#pragma unroll
        for (int kk = 0; kk < HC / 16; ++kk)
          load_frags(f[kk], sm90::peer_addr(base + kk * kFragSlice, pc), tid);
        uint64_t wd[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wd[p] = sm90::smem_desc<128>(ring_mem + s * SB + p * kW2Box);
        sm90::hold(big);
        sm90::hold(small);
#pragma unroll
        for (int kk = 0; kk < HC / 16; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p) sm90::hold(f[kk][p]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HC / 16; ++kk) {
          rs_slab<DS>(big, f[kk][0], sm90::desc_k(wd[0], kk));
#pragma unroll
          for (int i = 0; i < 5; ++i)
            rs_slab<DS>(small, f[kk][sm90::small_a(i)],
                   sm90::desc_k(wd[sm90::small_b(i)], kk));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::hold(big);
        sm90::hold(small);
#pragma unroll
        for (int kk = 0; kk < HC / 16; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p) sm90::hold(f[kk][p]);
        if (leader) sm90::mbar_arrive(&empty[s]);
      }
      sm90::mbar_arrive_all(&freed[bi], C);
    };

    // group g's first product before group g - 1's second: the exchange
    // of a group overlaps the next group's products
    for (int g = 0; g <= groups; ++g) {
      if (g < groups) first(g);
      if (g > 0) second(g - 1);
    }

    // fold, + b2 in fp32, stored from registers: rows < m, columns < d
    float acc[DS / 2];
    fold(acc, big, small);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + r + 8 * hh;
      if (row >= m) continue;
      float* o = out + static_cast<long long>(row) * d;
#pragma unroll
      for (int j = 0; j < DS / 8; ++j) {
        const int col = col0 + 8 * j + 2 * q;
        if (col >= d) continue;
        const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
        *reinterpret_cast<float2*>(o + col) =
            make_float2(acc[4 * j + 2 * hh] + bias.x,
                        acc[4 * j + 2 * hh + 1] + bias.y);
      }
    }
  }
  // no block exits while a peer may still read its buffers or arrive on
  // its barriers
  sm90::cluster_arrive();
  sm90::cluster_wait();
}

template <int DS>
int launch(const Plan& plan, const CUtensorMap* maps, const float* b1,
           const float* b2, float* out, int m, int d, int h, int act,
           long long blocks, cudaStream_t stream) {
  return static_cast<int>(sm90::launch_cluster(
      ffn_f32_kernel<DS>, blocks, plan.cluster, kThreads, plan.smem, stream,
      maps[0], maps[1], maps[2], b1, b2, out, m, d, h, act, plan.stages));
}

}  // namespace

// x, out: fp32 (m, d); w1: fp32 (h, d); w2: fp32 (d, h); b1 (h,), b2 (d,)
// fp32; all contiguous and 16-byte aligned; d and h multiples of 64, d at
// most 1024. pieces: bf16 scratch of 3 (m d + 2 d h) elements, 16-byte
// aligned (x's pieces, W1's, then W2's). Two launches: the split pass,
// then the fused kernel.
ETK_API int etk_ffn_f32(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out,
                        void* pieces, int m, int d, int h, int act,
                        void* stream) {
  const Plan plan = ffn_plan(d);
  if (plan.cluster == 0 || plan.stages < 2 || m <= 0 || h <= 0 || h % 64 ||
      act < ACT_NONE || act > ACT_GELU)
    return ETK_BAD_ARGS;
  const long long blocks =
      static_cast<long long>((m + BM - 1) / BM) * plan.cluster;
  if (blocks > 2147483647LL) return ETK_BAD_ARGS;
  auto* px = static_cast<__nv_bfloat16*>(pieces);
  __nv_bfloat16* pw1 = px + piece_elems(1, m, 1, d);
  __nv_bfloat16* pw2 = pw1 + piece_elems(1, h, 1, d);
  SplitArgs sa{};
  sa.set(0, x, px, Strides{0, 0, d}, 1, m, 1, d);
  sa.set(1, w1, pw1, Strides{0, 0, d}, 1, h, 1, d);
  sa.set(2, w2, pw2, Strides{0, 0, h}, 1, d, 1, h);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = launch_split(sa, 3, s);
  if (rc) return rc;
  CUtensorMap maps[3];
  if (piece_map_3d(&maps[0], px, m, d, BM) ||
      piece_map_3d(&maps[1], pw1, h, d, HC) ||
      piece_map_3d(&maps[2], pw2, d, h, plan.slab))
    return ETK_TMAP_FAILED;
  auto f1 = static_cast<const float*>(b1);
  auto f2 = static_cast<const float*>(b2);
  auto o = static_cast<float*>(out);
  return plan.slab == 64
             ? launch<64>(plan, maps, f1, f2, o, m, d, h, act, blocks, s)
             : launch<128>(plan, maps, f1, f2, o, m, d, h, act, blocks, s);
}

// the plan for width d: cluster size, slab width, chunk width, stages,
// dynamic shared memory (0s where d is not taken)
ETK_API int etk_ffn_f32_plan(int d, int* plan) {
  const Plan p = ffn_plan(d);
  plan[0] = p.cluster;
  plan[1] = p.slab;
  plan[2] = p.cluster ? HC : 0;
  plan[3] = p.stages;
  plan[4] = p.smem;
  return 0;
}

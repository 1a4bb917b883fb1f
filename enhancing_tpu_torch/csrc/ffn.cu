// Fused position-wise FFN: out = act(x W1^T + b1) W2^T + b2, the hidden
// never in device memory.
//
// Replaces enhancing_tpu/ops/ffn.py::_ffn_kernel as entered through
// _ffn_pallas (B16: the ViT block's FFN with ffn_impl='fused'). W1 is
// (h, d) and W2 (d, h), torch's Linear layout. Numerics as there: the
// hidden is an fp32 product plus the fp32 bias, the activation (tanh,
// squared ReLU or tanh-approximated GELU) runs in fp32, and the hidden is
// rounded to bf16 before W2; the W2 products sum in fp32 over the whole
// hidden dim, then + b2 in fp32 and one rounding.
//
// Bound on the H100: tensor-core operations, 4 * M * d * h flops against
// (2 * M * d + 2 * d * h) * 2 bytes. The (128, d) fp32 accumulator of a
// row block does not fit one block's registers at d = 768-1280, and
// recomputing the hidden per output slab doubles the operations. Design,
// on the Hopper core of sm90.cuh: a thread-block cluster of C blocks
// shares one 128-row block; block j owns the output columns [j DS,
// (j + 1) DS) (the last block's slab may run past d: those columns are
// computed from zero-filled W2 rows and not stored), held as fp32
// accumulators by two consumer warpgroups of 64 rows. The hidden is walked
// in groups of C chunks of 64: block j computes chunk j of the group,
// act(x W1[chunk]^T + b1) by shared-memory wgmma over K = d, rounds it to
// bf16 into its own slot of the group buffer and bulk-copies the slot into
// the same slot of every other block (distributed shared memory, completing
// on the receiver's mbarrier); each block then adds the group's
// H W2[group, own slab]^T to its accumulators. So the hidden is computed
// once: 4 M d h flops. A producer warpgroup streams x and W1 tiles, then
// the group's W2 tiles, through one TMA ring in the order the consumers
// use them. A block whose chunk lies past h (a short last group) skips the
// first GEMM and sends nothing. The host picks C and DS from d (ffn_plan,
// mirrored by ops/ffn.py::ffn_plan). Tried and taken out: multicasting
// the x tiles to the cluster (a stage then waits for the consumers of
// every block, and the ring ran dry: 2.6x slower on the H100). Later
// work: a double-buffered group buffer, so that one group's exchange
// overlaps the next group's first GEMM.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 128, HC = 64, kMaxStages = 8;
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kXBytes = BM * sm90::kTileK * 2;   // x tile (128, 64)
constexpr int kW1Bytes = HC * sm90::kTileK * 2;  // W1 tile (64, 64)
constexpr int kSlotBytes = BM * HC * 2;          // one hidden chunk (128, 64)

struct Plan {
  int cluster, slab, buffers, stages, smem;
};

__host__ __device__ constexpr int stage_bytes(int slab) {
  return kXBytes + kW1Bytes > slab * sm90::kTileK * 2
             ? kXBytes + kW1Bytes
             : slab * sm90::kTileK * 2;
}

// C in {1, 2, 4, 8} and the slab width DS in {64, 128, 160, 192, 256} with
// C * DS >= d and the fewest padded columns, then the smallest C; two group
// buffers of C hidden slots if 4 ring stages fit beside them, else one; as
// many ring stages as shared memory then holds, at most 8
Plan ffn_plan(int d) {
  const int slabs[] = {64, 128, 160, 192, 256};
  Plan best{0, 0, 0, 0, 0};
  int waste = 1 << 30;
  for (int c = 1; c <= 8; c *= 2) {
    for (int ds : slabs) {
      if (c * ds < d || c * ds - d >= waste) continue;
      waste = c * ds - d;
      best.cluster = c;
      best.slab = ds;
    }
  }
  if (best.cluster == 0) return best;
  const int sb = stage_bytes(best.slab);
  best.buffers =
      (sm90::kSmemLimit - 2 * best.cluster * kSlotBytes) / sb >= 4 ? 2 : 1;
  const int hbytes = best.buffers * best.cluster * kSlotBytes;
  const int stages = (sm90::kSmemLimit - hbytes) / sb;
  best.stages = stages > kMaxStages ? kMaxStages : stages;
  best.smem = hbytes + best.stages * sb + 1024;
  return best;
}

// the chunks of group g that block `rank` receives from the others
__device__ __forceinline__ int incoming(int g, int C, int rank, int chunks) {
  const int pieces = min(C, chunks - g * C);
  return pieces - (g * C + rank < chunks ? 1 : 0);
}

template <int DS>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_kernel(const __grid_constant__ CUtensorMap tmap_x,
               const __grid_constant__ CUtensorMap tmap_w1,
               const __grid_constant__ CUtensorMap tmap_w2,
               const float* __restrict__ b1, const float* __restrict__ b2,
               __nv_bfloat16* __restrict__ out, int m, int d, int h, int act,
               int buffers, int stages) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  // per group buffer: hfull, its group's chunks from the peers have
  // arrived; hempty, every block has read its previous group's chunks (one
  // arrival per block)
  __shared__ __align__(8) uint64_t hfull[2], hempty[2];
  uint8_t* smem = sm90::align_1024(smem_raw);
  constexpr int SB = stage_bytes(DS);
  constexpr int kW2Bytes = DS * sm90::kTileK * 2;
  const int C = static_cast<int>(sm90::cluster_size());
  const int rank = static_cast<int>(sm90::cluster_rank());
  const int row0 = (blockIdx.x / C) * BM, col0 = rank * DS;
  const int chunks = h / HC, groups = (chunks + C - 1) / C;
  const int ktiles = d / sm90::kTileK;
  // group g uses buffer g % buffers: C slots of (128, 64) bf16, swizzled;
  // with two, the next group's first GEMM runs while this group's chunks
  // travel
  uint8_t* ring_mem = smem + buffers * C * kSlotBytes;
  const bool ahead = buffers == 2;
  const sm90::Ring ring{stages};
  auto slot = [&](int g, int j) {
    return smem + ((g % buffers) * C + j) * kSlotBytes;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(&hfull[b], 1);
      sm90::mbar_init(&hempty[b], C);
    }
    sm90::fence_mbar_init();
    // announce each buffer's first group's incoming chunks before any can
    // arrive
    for (int g = 0; g < buffers && g < groups; ++g)
      sm90::mbar_expect_tx(&hfull[g], incoming(g, C, rank, chunks) * kSlotBytes);
  }
  sm90::cluster_arrive();
  sm90::cluster_wait();

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: one thread streams the tiles in the consumers'
    // order: the x and W1 tiles of a group's first GEMM (if the block has a
    // chunk), the W2 tiles of a group's second; with two buffers the first
    // GEMM of group g + 1 comes before the second of group g
    sm90::regs_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      int it = 0;
      auto first = [&](int g) {
        const int own = g * C + rank;
        if (own >= chunks) return;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = ring.stage(it);
          sm90::mbar_wait(&empty[s], ring.parity(it) ^ 1u);
          uint8_t* st = ring_mem + s * SB;
          sm90::mbar_expect_tx(&full[s], kXBytes + kW1Bytes);
          sm90::tma_load(st, &tmap_x, &full[s], kt * sm90::kTileK, row0);
          sm90::tma_load(st + kXBytes, &tmap_w1, &full[s], kt * sm90::kTileK,
                         own * HC);
        }
      };
      first(0);
      for (int g = 0; g < groups; ++g) {
        if (ahead && g + 1 < groups) first(g + 1);
        const int pieces = min(C, chunks - g * C);
        for (int p = 0; p < pieces; ++p, ++it) {
          const int s = ring.stage(it);
          sm90::mbar_wait(&empty[s], ring.parity(it) ^ 1u);
          sm90::mbar_expect_tx(&full[s], kW2Bytes);
          sm90::tma_load(ring_mem + s * SB, &tmap_w2, &full[s],
                         (g * C + p) * HC, col0);
        }
        if (!ahead && g + 1 < groups) first(g + 1);
      }
    }
  } else {
    sm90::regs_alloc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int r_lo = wg * 64 + warp * 16 + lane / 4;  // and r_lo + 8
    const bool releaser = threadIdx.x % 128 == 0;
    float acc[DS / 2];
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) acc[i] = 0.f;
    float sacc[HC / 2];
    int it = 0;

    // S = x W1[group g's chunk of this block]^T over K = d
    auto first = [&](int g) {
      if (g * C + rank >= chunks) return;
#pragma unroll
      for (int i = 0; i < HC / 2; ++i) sacc[i] = 0.f;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = ring.stage(it);
        sm90::mbar_wait(&full[s], ring.parity(it));
        const uint8_t* xs = ring_mem + s * SB;
        const uint64_t adesc = sm90::smem_desc(xs + wg * 64 * 128);
        const uint64_t bdesc = sm90::smem_desc(xs + kXBytes);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::Wgmma<HC>::ss(sacc, sm90::desc_k(adesc, ks),
                              sm90::desc_k(bdesc, ks));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (kt > 0 && releaser) sm90::mbar_arrive(&empty[ring.stage(it - 1)]);
      }
      sm90::wgmma_wait<0>();
      sm90::hold(sacc);
      if (releaser) sm90::mbar_arrive(&empty[ring.stage(it - 1)]);
    };

    first(0);
    for (int g = 0; g < groups; ++g) {
      const int own = g * C + rank;
      const int pieces = min(C, chunks - g * C);
      const int b = g % buffers;
      // the hidden chunk, bf16(act(S + b1)), into this block's own slot,
      // once the copies out of it of the buffer's previous group have read
      // it (this block's products of that group are done)
      if (threadIdx.x == 0) sm90::bulk_wait_read();
      sm90::named_sync(1, kConsumers);
      uint8_t* mine = slot(g, rank);
      if (own < chunks) {
        // the accumulator of n8 block j holds (row a, cols 2q, 2q + 1) and
        // (row a + 8, the same), q = lane % 4
#pragma unroll
        for (int j = 0; j < HC / 8; ++j) {
          const int hc = own * HC + j * 8 + (lane % 4) * 2;
          const float bb0 = b1[hc], bb1 = b1[hc + 1];
          *reinterpret_cast<uint32_t*>(mine + sm90::swz<128>(r_lo, j) +
                                       (lane % 4) * 4) =
              pack_bf16x2(apply_act(sacc[4 * j] + bb0, act),
                          apply_act(sacc[4 * j + 1] + bb1, act));
          *reinterpret_cast<uint32_t*>(mine + sm90::swz<128>(r_lo + 8, j) +
                                       (lane % 4) * 4) =
              pack_bf16x2(apply_act(sacc[4 * j + 2] + bb0, act),
                          apply_act(sacc[4 * j + 3] + bb1, act));
        }
        sm90::fence_async_cta();  // for the bulk copies and this block's wgmma
      }
      sm90::named_sync(1, kConsumers);
      if (threadIdx.x == 0 && own < chunks) {
        // every block has read the buffer's previous group
        if (g >= buffers)
          sm90::mbar_wait(&hempty[b], static_cast<uint32_t>(g / buffers - 1) & 1u);
        const uint32_t dst = smem_addr(mine), bar = smem_addr(&hfull[b]);
        for (int p = 0; p < C; ++p) {
          if (p == rank) continue;
          sm90::bulk_copy_peer(sm90::peer_addr(dst, p), mine, kSlotBytes,
                               sm90::peer_addr(bar, p));
        }
        sm90::bulk_commit();
      }
      if (ahead && g + 1 < groups) first(g + 1);
      sm90::mbar_wait(&hfull[b], static_cast<uint32_t>(g / buffers) & 1u);

      // acc += H[group] W2[group, own slab]^T, one 64-wide piece a tile
      for (int p = 0; p < pieces; ++p, ++it) {
        const int s = ring.stage(it);
        sm90::mbar_wait(&full[s], ring.parity(it));
        const uint64_t adesc = sm90::smem_desc(slot(g, p) + wg * 64 * 128);
        const uint64_t bdesc = sm90::smem_desc(ring_mem + s * SB);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::Wgmma<DS>::ss(acc, sm90::desc_k(adesc, ks),
                              sm90::desc_k(bdesc, ks));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (p > 0 && releaser) sm90::mbar_arrive(&empty[ring.stage(it - 1)]);
      }
      sm90::wgmma_wait<0>();
      sm90::hold(acc);
      if (releaser) sm90::mbar_arrive(&empty[ring.stage(it - 1)]);
      // this block has read the group's slots (both warpgroups)
      sm90::named_sync(1, kConsumers);
      if (threadIdx.x == 0 && g + buffers < groups) {
        // announce the buffer's next group's incoming chunks, then free
        // the buffer: no peer sends before every block has done both
        sm90::mbar_expect_tx(
            &hfull[b], incoming(g + buffers, C, rank, chunks) * kSlotBytes);
        sm90::mbar_arrive_all(&hempty[b], C);
      }
      if (!ahead && g + 1 < groups) first(g + 1);
    }

    // flush: once the last copies out of this block's slots have read
    // them, the group buffers and the ring stage the fp32 accumulators
    // (rows padded by 8 floats); each warpgroup writes its 64 rows + b2 in
    // fp32, one rounding, 8 columns (16 bytes of output) a thread a step,
    // columns < d
    if (threadIdx.x == 0) sm90::bulk_wait_read();
    sm90::named_sync(1, kConsumers);
    constexpr int LD = DS + 8, CHUNKS = DS / 8;
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < DS / 8; ++j) {
      const int c = j * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(cs + r_lo * LD + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(cs + (r_lo + 8) * LD + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    sm90::named_sync(2 + wg, 128);
    for (int i = threadIdx.x % 128; i < 64 * CHUNKS; i += 128) {
      const int r = wg * 64 + i / CHUNKS, c = (i % CHUNKS) * 8;
      const int row = row0 + r, col = col0 + c;
      if (row >= m || col >= d) continue;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = cs[r * LD + c + e] + b2[col + e];
      uint4 packed;
      packed.x = pack_bf16x2(v[0], v[1]);
      packed.y = pack_bf16x2(v[2], v[3]);
      packed.z = pack_bf16x2(v[4], v[5]);
      packed.w = pack_bf16x2(v[6], v[7]);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * d + col) =
          packed;
    }
  }
  // no block exits while a peer may still signal or write to it
  sm90::cluster_arrive();
  sm90::cluster_wait();
}

template <int DS>
int launch(const Plan& plan, const void* x, const void* w1, const float* b1,
           const void* w2, const float* b2, void* out, int m, int d, int h,
           int act, cudaStream_t stream) {
  CUtensorMap tx, tw1, tw2;
  if (sm90::tensor_map(&tx, x, m, d, d, BM) ||
      sm90::tensor_map(&tw1, w1, h, d, d, HC) ||
      sm90::tensor_map(&tw2, w2, d, h, h, DS))
    return ETK_TMAP_FAILED;
  const long long blocks =
      static_cast<long long>((m + BM - 1) / BM) * plan.cluster;
  if (blocks > 2147483647LL) return ETK_BAD_ARGS;
  return static_cast<int>(sm90::launch_cluster(
      ffn_kernel<DS>, blocks, plan.cluster, kThreads, plan.smem, stream, tx,
      tw1, tw2, b1, b2, static_cast<__nv_bfloat16*>(out), m, d, h, act,
      plan.buffers, plan.stages));
}

}  // namespace

// x, out: bf16 (m, d); w1: bf16 (h, d); w2: bf16 (d, h); b1 (h,), b2 (d,)
// fp32; all contiguous; d and h multiples of 64, d at most 2048.
ETK_API int etk_ffn(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, int m, int d,
                    int h, int act, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || d <= 0 || h <= 0 || d % 64 || h % 64 || act < ACT_NONE ||
      act > ACT_GELU)
    return ETK_BAD_ARGS;
  const Plan plan = ffn_plan(d);
  if (plan.cluster == 0 || plan.stages < 2) return ETK_BAD_ARGS;
  auto f1 = static_cast<const float*>(b1);
  auto f2 = static_cast<const float*>(b2);
  switch (plan.slab) {
    case 64:
      return launch<64>(plan, x, w1, f1, w2, f2, out, m, d, h, act, s);
    case 128:
      return launch<128>(plan, x, w1, f1, w2, f2, out, m, d, h, act, s);
    case 160:
      return launch<160>(plan, x, w1, f1, w2, f2, out, m, d, h, act, s);
    case 192:
      return launch<192>(plan, x, w1, f1, w2, f2, out, m, d, h, act, s);
    default:
      return launch<256>(plan, x, w1, f1, w2, f2, out, m, d, h, act, s);
  }
}

// the plan for width d: cluster size, slab width, chunk width, group
// buffers, stages, dynamic shared memory (0s where d is not taken)
ETK_API int etk_ffn_plan(int d, int* plan) {
  const Plan p = ffn_plan(d);
  plan[0] = p.cluster;
  plan[1] = p.slab;
  plan[2] = HC;
  plan[3] = p.buffers;
  plan[4] = p.stages;
  plan[5] = p.smem;
  return 0;
}

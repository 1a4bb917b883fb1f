// Attention -> output projection -> bias -> residual in one kernel:
// out[b, i] = residual[b, i] + concat_h(softmax(q_ih . K_h^T) V_h) Wp^T + bp.
//
// Replaces enhancing_tpu/ops/attention.py::_attn_proj_kernel as entered
// through _attention_proj_packed_call (B15: the ViT block's attention when
// ENHANCING_TPU_ATTN_PROJ is set; inference only). q, k and v are read in
// place as (B, N, H*D) row-strided views (the lane slices of the fused qkv
// buffer); Wp is (HO, H*D), torch's Linear layout. Numerics as there: q is
// scaled in bf16 (the scale rounded to bf16, then q * scale rounded; the
// TPU wrapper scales q in its dtype before the call), QK^T and the softmax
// in fp32, P rounded to bf16 before PV, each head's output multiplied by
// 1 / l and rounded to bf16 (the kernel casts the attention tile to the
// compute dtype before the projection); the projection accumulates in
// fp32, then bp and the residual are added in fp32 and the sum is rounded
// once. Mask modes 'none' and 'prefix_causal'; rows past N and keys past
// M are masked.
//
// Bound on the H100: tensor-core operations, 4 * B * H * N * M * D for the
// attention plus 2 * B * N * HD * HO for the projection, against
// (4 * B * N * HD + 2 * B * N * HO) * 2 bytes. The projection of a row
// block needs every head's output of those rows, and its fp32 accumulator
// (64 x HO) does not fit the registers at once. Design, on the Hopper core
// of sm90.cuh: a block owns 64 query rows of one batch row. Two consumer
// warpgroups split the heads (warpgroup w takes heads w, w + 2, ...); each
// head is a wgmma flash tile: q by TMA into one of the warpgroup's two q
// tiles (the next head's arrives during this one) and scaled there in
// bf16, S = q K^T from shared memory, the online softmax in fp32 (the
// exponential as one FMA and ex2, common.cuh), P rounded to bf16 in
// registers and O += P V register-A against the V tile read MN-major.
// Each head's output, times 1 / l and rounded, goes into its (64, 64)
// swizzled box of a (64, H*D) tile in shared memory (96 KiB at ViT-Base,
// 128 KiB at H*D = 1024), which never reaches device memory. Then the
// warpgroups split the output into 128-column chunks (w takes chunks w,
// w + 2, ...): a shared-memory wgmma of the tile against Wp tiles, + bp and
// the residual tile in fp32, one rounding in place in the residual's
// stage, TMA store. A producer warp feeds each warpgroup its q tiles and
// its own TMA ring (K and V; Wp; residual tiles, 16 KiB a stage) in the
// order it consumes them: every attention tile of both rings before any
// projection tile, since a warpgroup projects only once both have written
// their heads. Each tile's two products are waited on before the next
// step: issuing the next tile's S before this tile's softmax, or with its
// P V, made ptxas serialise the wgmmas (C7515, C7518) and ran slower on
// the H100, as did two blocks in a cluster sharing K, V and Wp by
// multicast (each stage then waits for both blocks), and warpgroups taking
// turns at the tensor cores (PERF.md §6).
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int D = 64, BM = 64, BKV = 64, CW = 128, kMaxStages = 4;
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kStageBytes = 16384;  // K + V tiles, a Wp tile or a residual
constexpr int kBoxBytes = BM * D * 2;  // one (64, 64) bf16 box
constexpr int MASK_NONE = 0, MASK_PREFIX_CAUSAL = 1;

struct Plan {
  int stages, smem;  // ring stages per warpgroup, dynamic shared memory
};

// as many stages per ring as fit beside the (64, hd) tile and the four q
// tiles (two per warpgroup), at most 4; a plan of fewer than 2 is refused
Plan attn_proj_plan(int hd) {
  const int fixed = BM * hd * 2 + 4 * kBoxBytes;
  const int stages = (sm90::kSmemLimit - fixed) / (2 * kStageBytes);
  Plan p;
  p.stages = stages > kMaxStages ? kMaxStages : stages;
  p.smem = fixed + 2 * p.stages * kStageBytes + 1024;
  return p;
}

__global__ void __launch_bounds__(kThreads, 1)
    attn_proj_kernel(const __grid_constant__ CUtensorMap tmap_q,
                     const __grid_constant__ CUtensorMap tmap_k,
                     const __grid_constant__ CUtensorMap tmap_v,
                     const __grid_constant__ CUtensorMap tmap_w,
                     const __grid_constant__ CUtensorMap tmap_res,
                     const __grid_constant__ CUtensorMap tmap_out,
                     const float* __restrict__ bp, int n, int m, int heads,
                     int ho, float scale, int mask_mode, int cond_len,
                     int stages) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[2][kMaxStages], empty[2][kMaxStages];
  // per warpgroup: its head's q tile has arrived / has been read
  __shared__ __align__(8) uint64_t qfull[2][2], qempty[2][2];
  uint8_t* smem = sm90::align_1024(smem_raw);
  const int hd = heads * D, ktiles = hd / 64;
  uint8_t* otile = smem;  // ktiles boxes of (64, 64)
  // two (64, 64) q tiles per warpgroup: the next head's arrives while
  // this head runs
  uint8_t* qbuf = smem + ktiles * kBoxBytes;
  uint8_t* rings = qbuf + 4 * kBoxBytes;
  const sm90::Ring ring{stages};
  auto stage_mem = [&](int w, int s) {
    return rings + (w * stages + s) * kStageBytes;
  };

  const int q0 = blockIdx.x * BM, b = blockIdx.y;
  const bool causal = mask_mode == MASK_PREFIX_CAUSAL;
  int kv_tiles = (m + BKV - 1) / BKV;
  if (causal) {
    const int last_row = min(q0 + BM, n) - 1;
    const int last_col = max(last_row, q0 < cond_len ? cond_len - 1 : 0);
    kv_tiles = min(kv_tiles, last_col / BKV + 1);
  }
  const int chunks = (ho + CW - 1) / CW;
  // items of warpgroup w's ring: per head q (into its q tile), then
  // kv_tiles K + V; per chunk ktiles Wp tiles, then the residual
  auto att_items = [&](int w) { return (heads - w + 1) / 2 * (1 + kv_tiles); };
  auto proj_items = [&](int w) { return (chunks - w + 1) / 2 * (ktiles + 1); };

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w)
      for (int j = 0; j < 2; ++j) {
        sm90::mbar_init(&qfull[w][j], 1);
        sm90::mbar_init(&qempty[w][j], 1);
      }
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < stages; ++s) {
        sm90::mbar_init(&full[w][s], 1);
        sm90::mbar_init(&empty[w][s], 1);
      }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    sm90::regs_dealloc<40>();
    if (threadIdx.x != kConsumers) return;
    int it[2] = {0, 0};
    auto slot = [&](int w, uint32_t bytes) {
      const int s = ring.stage(it[w]);
      sm90::mbar_wait(&empty[w][s], ring.parity(it[w]) ^ 1u);
      sm90::mbar_expect_tx(&full[w][s], bytes);
      ++it[w];
      return s;
    };
    const int a0 = att_items(0), a1 = att_items(1);
    for (int i = 0; i < (a0 > a1 ? a0 : a1); ++i) {
      for (int w = 0; w < 2; ++w) {
        if (i >= (w ? a1 : a0)) continue;
        const int h = w + 2 * (i / (1 + kv_tiles)), t = i % (1 + kv_tiles);
        if (t == 0) {
          const uint32_t hi = static_cast<uint32_t>(i / (1 + kv_tiles));
          const int j = hi & 1u;
          sm90::mbar_wait(&qempty[w][j], ((hi >> 1) & 1u) ^ 1u);
          sm90::mbar_expect_tx(&qfull[w][j], kBoxBytes);
          sm90::tma_load_3d(qbuf + (2 * w + j) * kBoxBytes, &tmap_q,
                            &qfull[w][j], h * D, q0, b);
        } else {
          const int s = slot(w, 2 * kBoxBytes);
          sm90::tma_load_3d(stage_mem(w, s), &tmap_k, &full[w][s], h * D,
                            (t - 1) * BKV, b);
          sm90::tma_load_3d(stage_mem(w, s) + kBoxBytes, &tmap_v, &full[w][s],
                            h * D, (t - 1) * BKV, b);
        }
      }
    }
    const int p0 = proj_items(0), p1 = proj_items(1);
    for (int i = 0; i < (p0 > p1 ? p0 : p1); ++i) {
      for (int w = 0; w < 2; ++w) {
        if (i >= (w ? p1 : p0)) continue;
        const int c = w + 2 * (i / (ktiles + 1)), kt = i % (ktiles + 1);
        if (kt < ktiles) {
          const int s = slot(w, kStageBytes);
          sm90::tma_load(stage_mem(w, s), &tmap_w, &full[w][s], kt * 64,
                         c * CW);
        } else {
          const bool two = c * CW + 64 < ho;
          const int s = slot(w, (two ? 2 : 1) * kBoxBytes);
          sm90::tma_load_3d(stage_mem(w, s), &tmap_res, &full[w][s], c * CW,
                            q0, b);
          if (two)
            sm90::tma_load_3d(stage_mem(w, s) + kBoxBytes, &tmap_res,
                              &full[w][s], c * CW + 64, q0, b);
        }
      }
    }
    return;
  }

  sm90::regs_alloc<232>();
  const int w = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int r = warp * 16 + lane / 4;  // rows r and r + 8 of the block
  const bool leader = threadIdx.x % 128 == 0;
  int it = 0;
  auto wait_full = [&]() {
    const int s = ring.stage(it);
    sm90::mbar_wait(&full[w][s], ring.parity(it));
    return stage_mem(w, s);
  };
  auto release = [&]() {
    if (leader) sm90::mbar_arrive(&empty[w][ring.stage(it)]);
    ++it;
  };

  // ---- attention: heads w, w + 2, ... ----
  for (int h = w, hi = 0; h < heads; h += 2, ++hi) {
    // q scaled in bf16 in place, 8 values a 16-byte chunk
    uint8_t* qs = qbuf + (2 * w + (hi & 1)) * kBoxBytes;
    const uint64_t qdesc = sm90::smem_desc<128>(qs);
    sm90::mbar_wait(&qfull[w][hi & 1], static_cast<uint32_t>(hi >> 1) & 1u);
#pragma unroll
    for (int i = 0; i < kBoxBytes / 16 / 128; ++i) {
      uint4* p = reinterpret_cast<uint4*>(qs) + threadIdx.x % 128 + 128 * i;
      uint4 u = *p;
      uint32_t* e = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j)  // the low and high bf16 of each pair
        e[j] = pack_bf16x2(__uint_as_float(e[j] << 16) * scale,
                           __uint_as_float(e[j] & 0xffff0000u) * scale);
      *p = u;
    }
    sm90::fence_async_cta();
    sm90::named_sync(2 + w, 128);
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};  // this thread's partial sums

    for (int t = 0; t < kv_tiles; ++t) {
      const uint8_t* kv = wait_full();
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      const uint64_t kdesc = sm90::smem_desc<128>(kv);
      sm90::hold(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<64>::ss(s, sm90::desc_k(qdesc, kk),
                            sm90::desc_k(kdesc, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::hold(s);

      if (causal || (t + 1) * BKV > m) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = q0 + r + ((i / 2) % 2) * 8;
          const int col = t * BKV + (i / 4) * 8 + 2 * q + i % 2;
          if (!visible(row, col, m, causal, cond_len)) s[i] = -INFINITY;
        }
      }
      float alpha[2], ml2[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(row_max[hh], tmax);
        // a row with nothing visible yet keeps exp(-inf - -inf) out
        ml2[hh] = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
        alpha[hh] = exp_shifted(row_max[hh], ml2[hh]);
        row_max[hh] = m_new;
        row_sum[hh] *= alpha[hh];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i / 2) % 2;
        s[i] = exp_shifted(s[i], ml2[hh]);
        row_sum[hh] += s[i];
        o[i] *= alpha[hh];
      }
      uint32_t pf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::frag_from_acc(pf[kk], s, kk);
      const uint64_t vdesc = sm90::smem_desc<128>(kv + kBoxBytes);
      // the rescaled O and the P fragments are written before the fence
      sm90::hold(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::hold(pf[kk]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<64>::rs<1>(o, pf[kk], sm90::desc_mn<128>(vdesc, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::hold(o);
      // the P fragments stay live until the products that read them are
      // done: else the next tile's values may take their registers
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::hold(pf[kk]);
      release();
    }

    if (leader) sm90::mbar_arrive(&qempty[w][hi & 1]);  // its S are done

    // the head's output, rounded to bf16, into its box of the tile
    uint8_t* box = otile + h * kBoxBytes;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = row_sum[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(box + sm90::swz<128>(r + 8 * hh, j) +
                                     4 * q) =
            pack_bf16x2(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    }
  }
  sm90::fence_async_cta();          // the tile, for wgmma
  sm90::named_sync(1, kConsumers);  // every head of both warpgroups

  // ---- projection: chunks w, w + 2, ... of 128 output columns ----
  for (int c = w; c < chunks; c += 2) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const uint8_t* ws = wait_full();
      const uint64_t adesc = sm90::smem_desc<128>(otile + kt * kBoxBytes);
      const uint64_t bdesc = sm90::smem_desc<128>(ws);
      sm90::hold(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        sm90::Wgmma<CW>::ss(acc, sm90::desc_k(adesc, ks),
                            sm90::desc_k(bdesc, ks));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      // the previous Wp tile's products are done
      if (kt > 0) {
        if (leader) sm90::mbar_arrive(&empty[w][ring.stage(it - 1)]);
      }
      ++it;
    }
    sm90::wgmma_wait<0>();
    sm90::hold(acc);
    if (leader) sm90::mbar_arrive(&empty[w][ring.stage(it - 1)]);

    // + bp + residual in fp32, one rounding, in place in the residual's
    // stage; then one TMA store per 64-column box
    uint8_t* rs = wait_full();
#pragma unroll
    for (int j = 0; j < CW / 8; ++j) {
      const int col = c * CW + 8 * j + 2 * q;
      const float b0 = col < ho ? bp[col] : 0.f;
      const float b1 = col < ho ? bp[col + 1] : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t* p = reinterpret_cast<uint32_t*>(
            rs + (j / 8) * kBoxBytes + sm90::swz<128>(r + 8 * hh, j % 8) +
            4 * q);
        const float2 res = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p));
        *p = pack_bf16x2(acc[4 * j + 2 * hh] + b0 + res.x,
                         acc[4 * j + 2 * hh + 1] + b1 + res.y);
      }
    }
    sm90::fence_async_cta();
    sm90::named_sync(2 + w, 128);
    if (leader) {
      sm90::tma_store_3d(&tmap_out, rs, c * CW, q0, b);
      if (c * CW + 64 < ho)
        sm90::tma_store_3d(&tmap_out, rs + kBoxBytes, c * CW + 64, q0, b);
      sm90::bulk_commit();
      sm90::bulk_wait_read();  // the stage is read before it is refilled
    }
    release();
  }
  if (leader) sm90::bulk_wait();
}

}  // namespace

// q: bf16 (B, N, H*64) rows q_row elements apart; k, v: bf16 (B, M, H*64)
// rows k_row, v_row apart (multiples of 8; batches N or M rows apart; every
// start 16-byte aligned); wp: bf16 (HO, H*64); bp: fp32 (HO,); res, out:
// bf16 (B, N, HO) contiguous.
ETK_API int etk_attn_proj(const void* q, const void* k, const void* v,
                          const void* wp, const void* bp, const void* res,
                          void* out, int q_row, int k_row, int v_row, int b,
                          int n, int m, int heads, int head_dim, int ho,
                          float scale, int mask_mode, int cond_len,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int hd = heads * head_dim;
  if (b <= 0 || n <= 0 || m <= 0 || heads <= 0 || ho <= 0 || b > 65535 ||
      head_dim != D || ho % 64 || q_row < hd || k_row < hd || v_row < hd ||
      q_row % 8 || k_row % 8 || v_row % 8 ||
      (mask_mode != MASK_NONE && mask_mode != MASK_PREFIX_CAUSAL))
    return ETK_BAD_ARGS;
  const Plan plan = attn_proj_plan(hd);
  if (plan.stages < 2) return ETK_BAD_ARGS;
  CUtensorMap tq, tk, tv, tw, tres, tout;
  const long long nl = n, ml = m;
  if (sm90::tensor_map_3d(&tq, q, b, n, hd, q_row, nl * q_row, BM, 64) ||
      sm90::tensor_map_3d(&tk, k, b, m, hd, k_row, ml * k_row, BKV, 64) ||
      sm90::tensor_map_3d(&tv, v, b, m, hd, v_row, ml * v_row, BKV, 64) ||
      sm90::tensor_map(&tw, wp, ho, hd, hd, CW) ||
      sm90::tensor_map_3d(&tres, res, b, n, ho, ho, nl * ho, BM, 64) ||
      sm90::tensor_map_3d(&tout, out, b, n, ho, ho, nl * ho, BM, 64))
    return ETK_TMAP_FAILED;
  cudaError_t err = cudaFuncSetAttribute(
      attn_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BM - 1) / BM, b);
  attn_proj_kernel<<<grid, kThreads, plan.smem, s>>>(
      tq, tk, tv, tw, tres, tout, static_cast<const float*>(bp), n, m, heads,
      ho, scale, mask_mode, cond_len, plan.stages);
  return static_cast<int>(cudaGetLastError());
}

// the plan for H*D = hd: rows a block, output columns a chunk, ring stages
// per warpgroup, dynamic shared memory (stages < 2: hd is not taken)
ETK_API int etk_attn_proj_plan(int hd, int* plan) {
  const Plan p = attn_proj_plan(hd);
  plan[0] = BM;
  plan[1] = CW;
  plan[2] = p.stages;
  plan[3] = p.smem;
  return 0;
}

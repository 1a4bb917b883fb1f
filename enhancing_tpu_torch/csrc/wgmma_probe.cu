// One lone wgmma product per operand layout that the attention kernels use
// and the GEMM kernels do not, for a card test to hold against
// torch.matmul before any kernel relies on it: a wrong descriptor offset
// gives plausible but wrong numbers, not a fault.
//
// a: bf16 (64, K) row-major, read straight into A fragments (RS) or by TMA
// (SS); b: bf16 row-major, by TMA; c: fp32 (64, N) row-major.
//   mode 0: c = a (64 x 64) * b (64 x 64): B MN-major, 128-byte rows (P V)
//   mode 1: c = a (64 x 64) * b (64 x 32): B MN-major, 64-byte rows (D 32)
//   mode 2: c = a (64 x 32) * b (64 x 32)^T: SS, both K-major, 64-byte rows
//   mode 3: c = a (64 x 64) * b (64 x 64)^T: RS, B K-major, 128-byte rows
#include "common.cuh"
#include "sm90.cuh"

namespace {

__global__ void __launch_bounds__(128)
    wgmma_probe_kernel(const __grid_constant__ CUtensorMap tmap_a,
                       const __grid_constant__ CUtensorMap tmap_b,
                       const __nv_bfloat16* __restrict__ a,
                       float* __restrict__ c, int mode) {
  __shared__ __align__(1024) uint8_t as[8192];
  __shared__ __align__(1024) uint8_t bs[8192];
  __shared__ __align__(8) uint64_t bar;
  const int k = mode == 2 ? 32 : 64, n = mode == 1 ? 32 : 64;
  const int rb_b = mode == 0 || mode == 3 ? 128 : 64;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int bytes = 64 * rb_b + (mode == 2 ? 64 * 64 : 0);
    sm90::mbar_expect_tx(&bar, bytes);
    sm90::tma_load_3d(bs, &tmap_b, &bar, 0, 0, 0);
    if (mode == 2) sm90::tma_load_3d(as, &tmap_a, &bar, 0, 0, 0);
  }
  sm90::mbar_wait(&bar, 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 4, q = lane % 4;
  uint32_t fr[4][4];
  if (mode != 2) {
    auto at = [&](int row, int col) {
      return *reinterpret_cast<const uint32_t*>(a + row * k + col);
    };
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fr[kk][0] = at(r, 16 * kk + 2 * q);
      fr[kk][1] = at(r + 8, 16 * kk + 2 * q);
      fr[kk][2] = at(r, 16 * kk + 8 + 2 * q);
      fr[kk][3] = at(r + 8, 16 * kk + 8 + 2 * q);
    }
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float acc32[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc32[i] = 0.f;
  sm90::hold(acc);
  sm90::hold(acc32);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::hold(fr[kk]);
  sm90::wgmma_fence();
  if (mode == 0) {
    const uint64_t d = sm90::smem_desc<128>(bs);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::Wgmma<64>::rs<1>(acc, fr[kk], sm90::desc_mn<128>(d, kk));
  } else if (mode == 1) {
    const uint64_t d = sm90::smem_desc<64>(bs);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::Wgmma<32>::rs<1>(acc32, fr[kk], sm90::desc_mn<64>(d, kk));
  } else if (mode == 2) {
    const uint64_t da = sm90::smem_desc<64>(as), db = sm90::smem_desc<64>(bs);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      sm90::Wgmma<64>::ss(acc, sm90::desc_k(da, kk), sm90::desc_k(db, kk));
  } else {
    const uint64_t d = sm90::smem_desc<128>(bs);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::Wgmma<64>::rs<0>(acc, fr[kk], sm90::desc_k(d, kk));
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::hold(acc);
  sm90::hold(acc32);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::hold(fr[kk]);
  auto put = [&](int j, float v0, float v1, float v2, float v3) {
    const int col = 8 * j + 2 * q;
    c[r * n + col] = v0;
    c[r * n + col + 1] = v1;
    c[(r + 8) * n + col] = v2;
    c[(r + 8) * n + col + 1] = v3;
  };
  if (n == 32) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      put(j, acc32[4 * j], acc32[4 * j + 1], acc32[4 * j + 2],
          acc32[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      put(j, acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace

ETK_API int etk_wgmma_probe(const void* a, const void* b, void* c, int mode,
                            void* stream) {
  if (mode < 0 || mode > 3) return ETK_BAD_ARGS;
  // b's rows: k (MN-major) or n (K-major); its row width in elements
  const int b_cols = mode == 1 || mode == 2 ? 32 : 64;
  CUtensorMap ta, tb;
  if (sm90::tensor_map_3d(&tb, b, 1, 64, b_cols, b_cols, 64 * b_cols, 64,
                          b_cols) ||
      sm90::tensor_map_3d(&ta, a, 1, 64, mode == 2 ? 32 : 64,
                          mode == 2 ? 32 : 64, 64 * 64, 64,
                          mode == 2 ? 32 : 64))
    return ETK_TMAP_FAILED;
  wgmma_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<const __nv_bfloat16*>(a), static_cast<float*>(c),
      mode);
  return static_cast<int>(cudaGetLastError());
}

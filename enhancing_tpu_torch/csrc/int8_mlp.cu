// The whole pre-norm MLP of a decode step as one launch, int8 weights:
//   out = residual + b1 + (act(LN(x) @ W0_q^T * s0 + b0) @ W1_q^T) * s1
//
// Replaces enhancing_tpu/ops/int8.py::_int8_mlp_flush_kernel (entered
// through _int8_mlp_pallas). Numerics as there: LN(x) rounded to x's
// dtype; the hidden in fp32 after s0, b0 and the activation, then rounded
// to x's dtype before the second product; s1 scales the fp32 sum over the
// whole hidden axis (it is linear in the sum), and residual + b1, merged
// in fp32 first, is added at the flush; one rounding to x's dtype.
//
// Bound on the H100: bytes: W0_q (24576 x 6144) and W1_q (6144 x 24576),
// 302 MB a layer for 4.8 GFLOP at batch 8 (90.1 us of bytes, 72 us of fp32
// operations at 67 TFLOP/s).
//
// Design. The TPU kernel walks the hidden axis in order and carries one
// accumulator across its grid steps; on the card blocks run in parallel,
// so the sum over the hidden axis crosses blocks. Here a cooperative
// (persistent) grid, as many blocks as fit on the card at once, runs three
// phases per tile of 8 rows, separated by grid-wide barriers:
//   A. the blocks of the first rows normalise one row each into an fp32
//      workspace (values rounded to x's dtype; gemv.cuh's ln_row);
//   B. units of 32 hidden channels (gemv.cuh) compute the hidden for the
//      8 rows and write it, rounded to x's dtype, into a second workspace
//      (8 x 24576 fp32, 786 KB, L2-resident);
//   C. units of 32 output channels read the whole hidden against their W1
//      rows and flush.
// Each weight byte is read once; the sums are in a fixed order, so the
// result does not change from run to run.
#include "gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using gemv::kRows;
using gemv::kThreads;
using gemv::kWarps;

struct MlpArgs {
  const void* x;
  const float* gamma;
  const float* beta;
  const int8_t* w0;  // (h, d)
  const float* s0;
  const void* b0;
  const int8_t* w1;  // (d, h)
  const float* s1;
  const void* b1;
  int bias_dtype;
  const float* residual;  // (m, d) fp32
  void* out;
  float* ws;  // kRows * d + kRows * h floats
  int m, d, h, act;
  float eps;
};

// the hidden, act(sum * s0 + b0) rounded to XT, into the workspace
template <typename XT>
struct HiddenEpi {
  float* hid;
  const float* s0;
  const void* b0;
  int bias_dtype, act, rows, h;
  __device__ __forceinline__ void operator()(int r, int j, float v) const {
    if (r >= rows) return;
    v = __fadd_rn(__fmul_rn(v, s0[j]), gemv::load_any(b0, bias_dtype, j));
    hid[static_cast<size_t>(r) * h + j] =
        gemv::round_to<XT>(apply_act(v, act));
  }
};

// out = sum * s1 + (residual + b1)
template <typename XT>
struct FlushEpi {
  XT* out;
  const float* s1;
  const void* b1;
  const float* residual;
  int bias_dtype, row0, m, d;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    const int row = row0 + r;
    if (row >= m) return;
    const size_t i = static_cast<size_t>(row) * d + c;
    const float res =
        __fadd_rn(residual[i], gemv::load_any(b1, bias_dtype, c));
    out[i] = gemv::from_f32<XT>(__fadd_rn(__fmul_rn(v, s1[c]), res));
  }
};

// channels a warp: 32 hidden or output channels a unit (each staged
// activation read then feeds four channels)
constexpr int kHiddenCh = 4;
constexpr int kOutCh = 4;

template <typename XT>
__global__ void __launch_bounds__(kThreads, 2) mlp_kernel(MlpArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) float xs[gemv::kStageFloats];
  __shared__ float red[2 * kWarps];
  const XT* x = static_cast<const XT*>(a.x);
  float* xn_ws = a.ws;
  float* hid = a.ws + static_cast<size_t>(kRows) * a.d;
  const int hidden_units = (a.h + kWarps * kHiddenCh - 1) / (kWarps * kHiddenCh);
  const int out_units = (a.d + kWarps * kOutCh - 1) / (kWarps * kOutCh);

  for (int row0 = 0; row0 < a.m; row0 += kRows) {
    const int rows = min(kRows, a.m - row0);
    // A: LN of the tile's rows, one block a row
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      gemv::ln_row(x, a.gamma, a.beta, nullptr, nullptr, 0,
                   static_cast<XT*>(nullptr),
                   xn_ws + static_cast<size_t>(r) * a.d, row0 + r, a.d, a.eps,
                   red);
    grid.sync();

    // B: the hidden
    const gemv::WsSrc xn_src{xn_ws, rows, a.d};
    const HiddenEpi<XT> hid_epi{hid, a.s0, a.b0, a.bias_dtype, a.act, rows,
                                a.h};
    for (int u = blockIdx.x; u < hidden_units; u += gridDim.x)
      gemv::gemv_unit<int8_t, kHiddenCh>(a.w0, u * kWarps * kHiddenCh, a.h,
                                         a.d, xs, xn_src, hid_epi);
    grid.sync();

    // C: the output channels over the whole hidden, and the flush
    const gemv::WsSrc hid_src{hid, rows, a.h};
    const FlushEpi<XT> out_epi{static_cast<XT*>(a.out), a.s1, a.b1,
                               a.residual, a.bias_dtype, row0, a.m, a.d};
    for (int u = blockIdx.x; u < out_units; u += gridDim.x)
      gemv::gemv_unit<int8_t, kOutCh>(a.w1, u * kWarps * kOutCh, a.d, a.h,
                                      xs, hid_src, out_epi);
    // the next tile's phase A writes only xn_ws, which phase C does not
    // read; its phase B writes hid after the barrier that follows A
  }
}

}  // namespace

// ws: 8 * (d + h) fp32; residual fp32 (m, d); out (m, d) in x's dtype
ETK_API int etk_int8_mlp(const void* x, const void* gamma, const void* beta,
                         const void* w0_q, const void* s0, const void* b0,
                         const void* w1_q, const void* s1, const void* b1,
                         const void* residual, void* out, void* ws, int m,
                         int d, int h, int act, float eps, int bias_dtype,
                         int x_dtype, void* stream) {
  if (m <= 0 || d <= 0 || h <= 0 || d % 16 || h % 16 || act < ACT_NONE ||
      act > ACT_GELU || residual == nullptr)
    return ETK_BAD_ARGS;
  MlpArgs a{x,
            static_cast<const float*>(gamma),
            static_cast<const float*>(beta),
            static_cast<const int8_t*>(w0_q),
            static_cast<const float*>(s0),
            b0,
            static_cast<const int8_t*>(w1_q),
            static_cast<const float*>(s1),
            b1,
            bias_dtype,
            static_cast<const float*>(residual),
            out,
            static_cast<float*>(ws),
            m,
            d,
            h,
            act,
            eps};
  auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == ETK_F32)
    return gemv::launch_cooperative(mlp_kernel<float>, a, s);
  if (x_dtype == ETK_BF16)
    return gemv::launch_cooperative(mlp_kernel<__nv_bfloat16>, a, s);
  return ETK_BAD_ARGS;
}

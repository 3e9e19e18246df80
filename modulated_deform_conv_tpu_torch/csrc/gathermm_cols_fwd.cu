// gathermm_cols_fwd: the deformable columns (2D) of the unfused path.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/gathermm.py::
// _fwd_kernel (:523).  That kernel writes the columns (B, dg, K, P, Cg) as a
// product with the structured-sparse corner matrix A = prod_d F_d over the
// input chunks inside data-dependent [lo, hi) bounds, because the TPU has a
// matrix unit and no fast gather; the grouped GEMM runs outside it, as an
// XLA einsum.  The JAX package takes this path where its fused kernel does
// not fit (`_fuse_ok`): a channel slab straddles conv groups, or the fused
// backward's VMEM footprint would pass 80 MB.
//
// What bounds it on the H100: the columns it writes, C * K * B * P values
// (231 MB in fp32 at BASELINE config 5's c4 layer, B=32), against reads of
// x, offset and mask (about a tenth of that): ~0.08 ms at 3.35 TB/s.
//
// What the design does about that: a direct gather.  One thread per (batch,
// deformable group, tap, position) builds the tap's corner weights once
// (the gate, the in-image checks and the mask folded in, deform_tile.cuh)
// and blends up to 32 channels of its slab from them.  The columns are laid
// out (C * K, B * P), row c * K + k, column b * P + p (the CUDA original's
// deformable_im2col layout): neighbouring threads take neighbouring
// positions, so the stores coalesce, their corner reads fall on nearby
// pixels, and each conv group's rows are one contiguous GEMM operand.
// fp32 columns, bf16 in "bfloat16" (the GEMM's operand type).
#include "deform_bwd.cuh"

namespace {

using namespace mdc;

template <typename T>
__global__ void __launch_bounds__(kColThreads) cols_kernel(const float* __restrict__ x,
                                                           const float* __restrict__ offset,
                                                           const float* __restrict__ mask, T* __restrict__ cols,
                                                           Geo g) {
  const int K = g.kh * g.kw, P = g.OH * g.OW, HW = g.H * g.W, Cdg = g.C / g.dg;
  const size_t e = static_cast<size_t>(blockIdx.x) * kColThreads + threadIdx.x;
  if (e >= static_cast<size_t>(g.B) * g.dg * K * P) return;
  const int p = e % P, k = (e / P) % K, d = (e / (static_cast<size_t>(P) * K)) % g.dg;
  const int b = e / (static_cast<size_t>(P) * K * g.dg);
  const TapWeights t = weights_at(g, offset, mask, b, d, k, p);
  const int i0 = t.y0 * g.W + t.x0;
  const int c0 = d * Cdg + blockIdx.y * kColChans, c1 = min((d + 1) * Cdg, c0 + kColChans);
  const size_t BP = static_cast<size_t>(g.B) * P;
  const float* xb = x + static_cast<size_t>(b) * g.C * HW;
  T* out = cols + static_cast<size_t>(k) * BP + static_cast<size_t>(b) * P + p;
#pragma unroll 4
  for (int c = c0; c < c1; ++c)
    out[static_cast<size_t>(c) * K * BP] = to_elem<T>(blend(xb + static_cast<size_t>(c) * HW, i0, g.W, t.w));
}

}  // namespace

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or
// null: float32, contiguous, on the current device.  cols (C*K, B*OH*OW):
// float32, or bfloat16 when precision is "bfloat16".  Returns
// cudaGetLastError().
extern "C" int gathermm_cols_fwd(const float* x, const float* offset, const float* mask, void* cols, int B, int C,
                                 int H, int W, int OH, int OW, int dg, int kh, int kw, int sh, int sw, int ph, int pw,
                                 int dh, int dw, int precision, void* stream) {
  using namespace mdc;
  const Geo g{B, C, H, W, 0, OH, OW, 1, dg, kh, kw, sh, sw, ph, pw, dh, dw, 0, 0, 0, 0, 0, precision};
  const size_t n = static_cast<size_t>(B) * dg * kh * kw * OH * OW;
  const dim3 grid(static_cast<unsigned>((n + kColThreads - 1) / kColThreads), (C / dg + kColChans - 1) / kColChans);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (precision == kBFloat16)
    cols_kernel<<<grid, kColThreads, 0, s>>>(x, offset, mask, static_cast<__nv_bfloat16*>(cols), g);
  else
    cols_kernel<<<grid, kColThreads, 0, s>>>(x, offset, mask, static_cast<float*>(cols), g);
  return static_cast<int>(cudaGetLastError());
}

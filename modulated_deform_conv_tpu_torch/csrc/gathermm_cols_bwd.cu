// gathermm_cols_bwd: the VJP of the deformable columns (2D), the unfused
// path's backward gather.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/gathermm.py::
// _bwd_kernel (:623).  Given gcols, the cotangent of the columns (the GEMM's
// gradient, computed outside), that kernel rebuilds the corner matrix A of
// each (tile, tap group) over the input chunks inside data-dependent bounds
// and computes grad_x = A gcols and the correlation M = x gcols^T, reduced
// against dA/dpos (grad_offset) and A (grad_mask).
//
// What bounds it on the H100: the bytes of gcols (231 MB in fp32 at BASELINE
// config 5's c4 layer, B=32) read, x, offset and mask read, and grad_x,
// grad_offset and grad_mask written: ~0.09 ms at 3.35 TB/s.
//
// What the design does about that: the gather pull and the correlation of
// the fused backward (deform_bwd.cuh), reading gcols through the columns
// path's layout (CKBP: (C * K, B * P), row c * K + k, float32 or bf16):
//   1. ranges_kernel: per (batch, deformable group, 64-position output tile)
//      the range [lo, hi) of flat input pixels its kept corners touch;
//   2. gather_gx_kernel: grad_x as a pull, a block owning 64 input pixels x
//      32 channels and applying the corner hits of the output tiles whose
//      range overlaps them in a fixed order;
//   3. goff_kernel: one owner per (batch, group, tap, position) sums the
//      correlation over the slab's channels in order; the mask stays apart,
//      so grad_mask is exact where the mask is 0.
// No float atomics, so two runs give the same bits.
#include "deform_bwd.cuh"

namespace {

using namespace mdc;

template <typename T>
cudaError_t run(const Geo& g, const float* x, const float* offset, const float* mask, const T* gcols, int2* ranges,
                float* gx, float* goff, float* gmask, cudaStream_t s) {
  const CKBP<T> lay{g.kh * g.kw, g.B, g.OH * g.OW};
  cudaError_t err = cudaSuccess;
  if (gx && (err = launch_gather_gx(g, offset, mask, gcols, ranges, gx, lay, s)) != cudaSuccess) return err;
  if (goff || gmask) err = launch_goff(g, x, offset, mask, gcols, goff, gmask, lay, s);
  return err;
}

}  // namespace

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or
// null: float32, contiguous, on the current device.  gcols (C*K, B*OH*OW):
// float32, or bfloat16 when precision is "bfloat16".  Scratch: ranges (B,
// dg, ceil(OH*OW/64)) int2.  Outputs, each null when not wanted: gx like x,
// goff like offset, gmask like mask.  Returns the first CUDA error of the
// launches, or 0.
extern "C" int gathermm_cols_bwd(const float* x, const float* offset, const float* mask, const void* gcols,
                                 int* ranges, float* gx, float* goff, float* gmask, int B, int C, int H, int W,
                                 int OH, int OW, int dg, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                                 int dw, int precision, void* stream) {
  using namespace mdc;
  const Geo g{B, C, H, W, 0, OH, OW, 1, dg, kh, kw, sh, sw, ph, pw, dh, dw, 0, 0, 0, 0, 0, precision};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* rg = reinterpret_cast<int2*>(ranges);
  if (precision == kBFloat16)
    return static_cast<int>(
        run(g, x, offset, mask, static_cast<const __nv_bfloat16*>(gcols), rg, gx, goff, gmask, s));
  return static_cast<int>(run(g, x, offset, mask, static_cast<const float*>(gcols), rg, gx, goff, gmask, s));
}

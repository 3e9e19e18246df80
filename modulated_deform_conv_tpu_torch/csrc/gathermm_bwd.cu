// gathermm_bwd: general-offset DCN backward (2D), any stride and dilation.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/gathermm.py::
// _bwd_fused_kernel (:1292).  That kernel rebuilds the structured-sparse
// corner matrix A = prod_d F_d of each (tile, tap group) from the factor rows
// of `_prep`, visits only the input chunks inside the data-dependent [lo, hi)
// bounds, and in one body computes gcols = W2^T gout, grad_x += A gcols,
// the correlation M = x gcols^T reduced against dA/dpos (grad_offset) and A
// (grad_mask), and grad_weight += gout cols^T with the columns recomputed.
//
// What bounds it on the H100: the bytes x, offset, mask, W and gout in and
// grad_x, grad_offset, grad_mask and grad_W out (100 MB in f32 at the
// bench's config 2), against the two GEMMs (gcols and grad_W, 14.8 GFLOP
// there): ~30 us at 3.35 TB/s, ~30 us at the 495 TFLOP/s TF32 rate.  With
// the plain FP32 FMAs used here the 67 TFLOP/s FP32 rate bounds it (~220
// us), and gcols goes through device memory once (231 MB there).
//
// What the design does about that, in five kernels on one stream (the shared
// ones in deform_bwd.cuh):
//   1. gcols_kernel: gcols = W2^T gout, tiled FP32 GEMM, channels innermost;
//   2. ranges_kernel: per (batch, deformable group, 64-position output tile)
//      the range [lo, hi) of flat input pixels its kept corners touch: the
//      counterpart of `_prep`'s `bnd`;
//   3. gather_gx_kernel: grad_x is a scatter with unbounded reach, so it is turned
//      into a pull: a block owns 64 consecutive input pixels x 32 channels,
//      walks the output tiles whose range overlaps its pixels in order, and
//      applies their corner hits in a fixed order (deform_bwd.cuh);
//   4. goff_kernel: one owner per (batch, group, tap, position) sums the
//      correlation over the slab's channels in order;
//   5. gw_kernel + fold_kernel: grad_W in fixed splits of the (batch,
//      position) axis, columns rebuilt from x in shared memory, folded in
//      order.
// No float atomics anywhere, so two runs give the same bits.  Tensor cores
// and a fused single pass are later work.
#include "deform_bwd.cuh"

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or null,
// wk (groups, O/groups, K, C/groups), gout (B, O, OH, OW): float32,
// contiguous, on the current device.  Scratch, allocated by the caller:
// gcols (B, K, OH*OW, C), ranges (B, dg, ceil(OH*OW/64)) int2, part (splits,
// groups, C/groups*K, O/groups).  Outputs, each null when not wanted:
// gx like x, goff like offset, gmask like mask, gwt (groups, C/groups*K,
// O/groups).  Returns the first CUDA error of the launches, or 0.
extern "C" int gathermm_bwd(const float* x, const float* offset, const float* mask, const float* wk,
                            const float* gout, float* gcols, int* ranges, float* part, float* gx, float* goff,
                            float* gmask, float* gwt, int B, int C, int H, int W, int O, int OH, int OW,
                            int groups, int dg, int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw,
                            int splits, int precision, void* stream) {
  using namespace mdc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, C, H, W, O, OH, OW, groups, dg, kh, kw, sh, sw, ph, pw, dh, dw, 0, 0, 0, 0, 0, precision};
  cudaError_t err = cudaSuccess;
  if (gx || goff || gmask) {
    if ((err = launch_gcols(g, wk, gout, gcols, s)) != cudaSuccess) return static_cast<int>(err);
  }
  const KPC lay{kh * kw, OH * OW, C};
  if (gx) {
    err = launch_gather_gx(g, offset, mask, gcols, reinterpret_cast<int2*>(ranges), gx, lay, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (goff || gmask) {
    if ((err = launch_goff(g, x, offset, mask, gcols, goff, gmask, lay, s)) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (gwt) err = launch_gw(g, x, offset, mask, gout, part, gwt, splits, s);
  return static_cast<int>(err);
}

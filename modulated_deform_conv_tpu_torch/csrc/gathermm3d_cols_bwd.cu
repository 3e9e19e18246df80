// gathermm3d_cols_bwd: the VJP of the deformable columns (3D), the unfused
// path's backward gather.
//
// Replaces the 3D (flat and planar) mode of the TPU kernel
// modulated_deform_conv_tpu/ops/pallas/gathermm.py::_bwd_kernel (:623):
// given gcols, grad_x = A gcols and the correlation M = x gcols^T reduced
// against dA/dpos (grad_offset) and A (grad_mask).
//
// What bounds it on the H100: the bytes of gcols (226 MB in fp32 at BASELINE
// config 3's size) read, x, offset and mask read, and the three gradients
// written: ~0.08 ms at 3.35 TB/s.
//
// What the design does about that: the 3D fused backward's pull and
// correlation (deform_bwd3d.cuh), reading gcols through the columns path's
// layout (CKBP: (C * K, B * P), row c * K + k, float32 or bf16), over the
// whole batch at once:
//   1. boxes3_kernel: per (batch, deformable group, 4 x 4 x 4 output brick)
//      the box of input voxels its kept corners touch;
//   2. gather_gx3_kernel: grad_x as a pull, a block owning a 4 x 4 x 4
//      input brick x 32 channels and applying, in a fixed order, the corner
//      hits of the output bricks whose box meets it;
//   3. goff3_kernel: one owner per (batch, group, tap, position) sums the
//      correlation over the slab's channels in order, the mask kept apart.
// No float atomics, so two runs give the same bits.
#include "deform_bwd3d.cuh"

namespace {

using namespace mdc;

template <typename T>
cudaError_t run(const Geo3& g, const float* x, const float* offset, const float* mask, const T* gcols, int* boxes,
                float* gx, float* goff, float* gmask, cudaStream_t s) {
  const CKBP<T> lay{taps3(g), g.B, out_size3(g)};
  cudaError_t err = cudaSuccess;
  if (gx && (err = launch_gather_gx3(g, offset, mask, gcols, boxes, gx, lay, s)) != cudaSuccess) return err;
  if (goff || gmask) err = launch_goff3(g, x, offset, mask, gcols, goff, gmask, lay, s);
  return err;
}

}  // namespace

// x (B, C, D, H, W), offset (B, dg*3*K, OD, OH, OW), mask (B, dg*K, OD, OH,
// OW) or null: float32, contiguous, on the current device.  gcols (C*K,
// B*OD*OH*OW): float32, or bfloat16 when precision is "bfloat16".  Scratch:
// boxes (B, dg, output bricks, 6) int.  Outputs, each null when not wanted:
// gx like x, goff like offset, gmask like mask.  Returns the first CUDA error
// of the launches, or 0.
extern "C" int gathermm3d_cols_bwd(const float* x, const float* offset, const float* mask, const void* gcols,
                                   int* boxes, float* gx, float* goff, float* gmask, int B, int C, int D, int H,
                                   int W, int OD, int OH, int OW, int dg, int kd, int kh, int kw, int sd, int sh,
                                   int sw, int pd, int ph, int pw, int dd, int dh, int dw, int precision,
                                   void* stream) {
  using namespace mdc;
  const Geo3 g{B,  C,  D,  H,  W,  0,  OD, OH, OW, 1, dg, kd, kh, kw, sd, sh,
               sw, pd, ph, pw, dd, dh, dw, 0,  0,  0,  0, 0,  0,  0,  precision};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (precision == kBFloat16)
    return static_cast<int>(
        run(g, x, offset, mask, static_cast<const __nv_bfloat16*>(gcols), boxes, gx, goff, gmask, s));
  return static_cast<int>(run(g, x, offset, mask, static_cast<const float*>(gcols), boxes, gx, goff, gmask, s));
}

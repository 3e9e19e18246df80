// shiftblend3d_bwd: bounded-offset DCN backward (3D, stride 1, output size
// == input size).
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/shiftblend.py::
// _bwd_kernel_loop (:1126), the loop path's backward, and the 3D use of
// _bwd_kernel (:970).  Those keep the x and grad_x planes resident in VMEM,
// compute gcols = W2^T gout and add gout cols^T into grad_weight (the loop
// path recomputes the masked columns when none were saved), scatter grad_x
// into the resident plane one static shift at a time and build the offset
// and mask gradients from the correlation rows sum_c gcol x(p + s).
//
// The bounded contract is the forward's (shiftblend3d_fwd.cu): a dropped
// corner carries no value and no gradient, in grad_x, grad_offset, grad_mask
// and grad_W alike.
//
// What bounds it on the H100: the two products (gcols and grad_W, 928 GFLOP
// at BASELINE config 4, B=4: ~1.9 ms at the 495 TFLOP/s TF32 rate); the
// bytes (x, offset, mask, W and gout in, the four gradients out, ~1.3 GB
// there) take ~0.4 ms.  This split into kernels keeps gcols (fp32, 7.25 GB
// for the whole batch there) in device memory: written once and read by the
// pull and the correlation, at least 21.7 GB, ~6.5 ms at 3.35 TB/s, the
// floor of this design.
//
// What the design does about that (deform_bwd3d.cuh, run_bwd3d, shared
// with the gather's backward, gathermm3d_bwd.cu): the 2D backward's
// tensor-core kernels carried over to the volume.  x goes
// channels-last once a call; gcols and grad_W run on mma.sync in the mode's
// arithmetic; the corner weights of every (tap, position) are built once per
// block into tables; the static bound gives grad_x a per-tap reach of (win
// + 3)^3 output positions around each 4 x 4 x 4 input brick, pulled in a
// fixed order, so no atomics and no data-dependent bounds are needed.
// gcols and the gradients read from it run in batch chunks (b_step) that
// bound its size and do not change the bits.
//
// The lead mode (the TPU kernel's `lead`): on a sharded leading-dim block
// the output grid is OD x H x W, the gate, the window and the kept corners
// are the whole input's (Geo3's placement), and the pull covers every plane
// of the block, its halo planes included, each brick's candidates moved
// back by the block's shift.
#include "deform_bwd3d.cuh"

// x (B, C, D, H, W), offset (B, dg*3*K, OD, OH, OW), mask (B, dg*K, OD, OH,
// OW) or null, gout (B, O, OD, OH, OW): of the activations' type (io 0:
// float32, io 1: bfloat16), contiguous, on the current device; wk (groups,
// O/groups, K, C/groups): float32.  (lo, win) per axis is the
// bounded-offset window.  gz0 .. orx: the tap gate per axis and the block's
// placement (Geo3): (-1, D), (-1, H), (-1, W) and zeros but on a sharded
// block.  Scratch, allocated by the caller: gcols (b_step, K, OD*OH*OW, C);
// xt (B, D*H*W, C); part (splits, groups, C/groups*K, O/groups).  Outputs,
// each null when not wanted: gx like x, goff like offset, gmask like mask,
// gwt (groups, C/groups*K, O/groups).  Needs what shiftblend3d_fwd needs.
// Returns the first CUDA error of the launches, or 0.
extern "C" int shiftblend3d_bwd(const void* x, const void* offset, const void* mask, const float* wk,
                                const void* gout, float* gcols, float* xt, float* part, void* gx, void* goff,
                                void* gmask, float* gwt, int B, int C, int D, int H, int W, int O, int OD, int OH,
                                int OW, int groups, int dg, int kd, int kh, int kw, int pd, int ph, int pw, int dd,
                                int dh, int dw, int lo_z, int win_z, int lo_y, int win_y, int lo_x, int win_x,
                                int b_step, int splits, int precision, int io, float gz0, float gz1, float gy0,
                                float gy1, float gx0, float gx1, float shz, float orz, float shy, float ory,
                                float shx, float orx, void* stream) {
  using namespace mdc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo3 g{B, C,  D,  H,  W,  O,  OD, OH, OW, groups, dg,    kd,   kh,    kw,   1,     1,
               1, pd, ph, pw, dd, dh, dw, 1,  lo_z, win_z,  lo_y, win_y, lo_x, win_x, precision,
               gz0, gz1, gy0, gy1, gx0, gx1, shz, orz, shy, ory, shx, orx};
  return with_io(io, [&](auto t) {
    using T = typename decltype(t)::type;
    const T *xi = static_cast<const T*>(x), *oi = static_cast<const T*>(offset), *mi = static_cast<const T*>(mask),
            *go = static_cast<const T*>(gout);
    T *gxo = static_cast<T*>(gx), *goo = static_cast<T*>(goff), *gmo = static_cast<T*>(gmask);
    const auto pull = [&](const Geo3& gc, const T* off_c, const T* mask_c, const float* gcols_c, T* gx_c) {
      return launch_shift_pull3(gc, off_c, mask_c, gcols_c, gx_c, s);
    };
    switch (precision) {
      case kFloat32:
        return static_cast<int>(run_bwd3d<kFloat32>(g, xi, oi, mi, wk, go, gcols, xt, part, gxo, goo, gmo, gwt,
                                                    b_step, splits, s, pull));
      case kTensorFloat32:
        return static_cast<int>(run_bwd3d<kTensorFloat32>(g, xi, oi, mi, wk, go, gcols, xt, part, gxo, goo, gmo,
                                                          gwt, b_step, splits, s, pull));
      default:
        return static_cast<int>(run_bwd3d<kBFloat16>(g, xi, oi, mi, wk, go, gcols, xt, part, gxo, goo, gmo, gwt,
                                                     b_step, splits, s, pull));
    }
  });
}

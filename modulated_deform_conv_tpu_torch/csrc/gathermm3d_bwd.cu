// gathermm3d_bwd: general-offset DCN backward (3D), any stride and dilation.
//
// Replaces the 3D (planar and flat) mode of the TPU kernel
// modulated_deform_conv_tpu/ops/pallas/gathermm.py::_bwd_fused_kernel
// (:1292).  That kernel rebuilds the corner matrix A = F_z F_y F_x of each
// (tile, tap group), visits only the input chunks inside data-dependent
// bounds (planar mode: a lead-plane range x an in-plane chunk range,
// gathermm.py:217-228), and computes gcols = W2^T gout, grad_x += A gcols,
// the correlation M = x gcols^T against dA/dpos (grad_offset) and A
// (grad_mask), and grad_weight += gout cols^T.
//
// What bounds it on the H100: the two products (gcols and grad_W, 14.5
// GFLOP at BASELINE config 3: ~0.029 ms at the 495 TFLOP/s TF32 rate); the
// bytes (x, offset, mask, W and gout in, the four gradients out, ~45 MB
// there) take ~0.014 ms.  In this split into kernels gcols (fp32, 226 MB at
// config 3) goes through device memory, written once and read by the pull
// and the correlation.
//
// What the design does about that (deform_bwd3d.cuh, run_bwd3d, the
// bounded pair's backward with another pull): x channels-last once a call;
// gcols and grad_W on mma.sync in the mode's arithmetic; the correlation
// with lanes over channels.  grad_x is a scatter with unbounded reach,
// turned into a pull: boxes3_kernel keeps, per (batch, deformable group, 4
// x 4 x 4 output brick), the box of input voxels its kept corners touch and
// the box of each tap's -- the Hopper counterpart of the TPU's planar and
// flat chunk bounds, which have no counterpart block by block -- and
// gather_pull3_kernel, a block per 4 x 4 x 4 input brick x 64 channels,
// compacts in order the output bricks whose box meets it, then their taps
// whose box meets it, evaluates those (tap, position) candidates once per
// block, keeps the ones landing next to the brick in a table and applies
// them warp by warp in table order (at offsets in [-2, 2] about 27 bricks x
// 27 taps x 64 positions are evaluated; near-zero offsets leave fewer taps
// per brick).  No float atomics anywhere, so two runs give the same bits.
#include "deform_bwd3d.cuh"

// x (B, C, D, H, W), offset (B, dg*3*K, OD, OH, OW), mask (B, dg*K, OD, OH,
// OW) or null, gout (B, O, OD, OH, OW): of the activations' type (io 0:
// float32, io 1: bfloat16), contiguous, on the current device; wk (groups,
// O/groups, K, C/groups): float32.  Scratch, allocated by the
// caller: gcols (b_step, K, OD*OH*OW, C); xt (B, D*H*W, C); boxes (b_step,
// dg, output bricks, 1 + K, 6) int; part (splits, groups, C/groups*K,
// O/groups).
// Outputs, each null when not wanted: gx like x, goff like offset, gmask
// like mask, gwt (groups, C/groups*K, O/groups).  Returns the first CUDA
// error of the launches, or 0.
// gz0 .. orx: the tap gate per axis and the block's placement (Geo3): (-1,
// D), (-1, H), (-1, W) and zeros but on a sharded block.
extern "C" int gathermm3d_bwd(const void* x, const void* offset, const void* mask, const float* wk,
                              const void* gout, float* gcols, float* xt, int* boxes, float* part, void* gx,
                              void* goff, void* gmask, float* gwt, int B, int C, int D, int H, int W, int O, int OD,
                              int OH, int OW, int groups, int dg, int kd, int kh, int kw, int sd, int sh, int sw,
                              int pd, int ph, int pw, int dd, int dh, int dw, int b_step, int splits, int precision,
                              int io, float gz0, float gz1, float gy0, float gy1, float gx0, float gx1, float shz,
                              float orz, float shy, float ory, float shx, float orx, void* stream) {
  using namespace mdc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo3 g{B,  C,  D,  H,  W,  O,  OD, OH, OW, groups, dg, kd, kh, kw, sd, sh,
               sw, pd, ph, pw, dd, dh, dw, 0,  0,  0,      0,  0,  0,  0,  precision,
               gz0, gz1, gy0, gy1, gx0, gx1, shz, orz, shy, ory, shx, orx};
  return with_io(io, [&](auto t) {
    using T = typename decltype(t)::type;
    const T *xi = static_cast<const T*>(x), *oi = static_cast<const T*>(offset), *mi = static_cast<const T*>(mask),
            *go = static_cast<const T*>(gout);
    T *gxo = static_cast<T*>(gx), *goo = static_cast<T*>(goff), *gmo = static_cast<T*>(gmask);
    const auto pull = [&](const Geo3& gc, const T* off_c, const T* mask_c, const float* gcols_c, T* gx_c) {
      return launch_gather_pull3(gc, off_c, mask_c, gcols_c, boxes, gx_c, s);
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

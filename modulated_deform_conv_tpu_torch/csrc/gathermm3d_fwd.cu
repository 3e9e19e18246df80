// gathermm3d_fwd: general-offset DCN forward (3D), gather + grouped GEMM
// fused.
//
// Replaces the 3D (planar and flat) mode of the TPU kernel
// modulated_deform_conv_tpu/ops/pallas/gathermm.py::_fwd_fused_kernel
// (:1162).  There the trilinear gather is a product with A = F_z F_y F_x
// over the input chunks inside data-dependent bounds (planar mode: a lead-
// plane range x an in-plane chunk range per tile), fused with out += W2 cols,
// because the TPU has a matrix unit and no fast gather.
//
// What bounds it on the H100: one forward moves x, offset, mask and out once
// and does 2 * B * P * O * C/g * K FLOPs (27 MB and 7.25 GFLOP at BASELINE
// config 3: ~0.015 ms at the 495 TFLOP/s TF32 rate).  The gather itself is
// latency-bound: the eight corners of an unbounded offset can land anywhere
// in the volume.
//
// What the design does about that (deform_fwd.cuh, the kernel the 2D
// forwards and shiftblend3d_fwd run, unwindowed, with 8 corners a tap): x
// channels-last once a call, so a trilinear corner is a row of consecutive
// channels, read 16 bytes at a time where 4 channels share a conv group and
// a deformable group (4 bytes otherwise); a block owns 64 or 128 positions
// flattened over (batch, volume) and up to 256 output channels of one conv
// group, so each column is built once; the products run on mma.sync in the
// mode's arithmetic; the corner table holds a few taps of the current
// stages, so any tap count fits (5 x 5 x 5 included).  A Hopper gather reads
// the eight corners directly, so the TPU's chunk bounds (flat or planar)
// have no counterpart in the forward.  Where the contraction is split (few
// positions), the parts are folded in order: no float atomics.
#include "deform_fwd.cuh"

// x (B, C, D, H, W), offset (B, dg*3*K, OD, OH, OW), mask (B, dg*K, OD, OH,
// OW) or null, out (B, O, OD, OH, OW): of the activations' type (io 0:
// float32, io 1: bfloat16), contiguous, on the current device; wf (groups,
// K, C/groups, O/groups) and bias (O) or null: float32.  Scratch,
// allocated by the caller: xt (B, D*H*W, C); part (splits, B, O, OD, OH,
// OW), unused when splits is 1.  Returns the first CUDA error of the
// launches, or 0.
// gz0 .. orx: the tap gate per axis and the block's placement (Geo3): (-1,
// D), (-1, H), (-1, W) and zeros but on a sharded block.
extern "C" int gathermm3d_fwd(const void* x, const void* offset, const void* mask, const float* wf,
                              const float* bias, void* out, float* xt, float* part, int B, int C, int D, int H,
                              int W, int O, int OD, int OH, int OW, int groups, int dg, int kd, int kh, int kw,
                              int sd, int sh, int sw, int pd, int ph, int pw, int dd, int dh, int dw, int splits,
                              int precision, int io, float gz0, float gz1, float gy0, float gy1, float gx0, float gx1,
                              float shz, float orz, float shy, float ory, float shx, float orx, void* stream) {
  using namespace mdc;
  const Geo3 g{B,  C,  D,  H,  W,  O,  OD, OH, OW, groups, dg, kd, kh, kw, sd, sh,
               sw, pd, ph, pw, dd, dh, dw, 0,  0,  0,      0,  0,  0,  0,  precision,
               gz0, gz1, gy0, gy1, gx0, gx1, shz, orz, shy, ory, shx, orx};
  return with_io(io, [&](auto t) {
    using T = typename decltype(t)::type;
    return static_cast<int>(run_fwd(g, static_cast<const T*>(x), static_cast<const T*>(offset),
                                    static_cast<const T*>(mask), wf, bias, static_cast<T*>(out), xt, part, splits,
                                    nullptr, static_cast<cudaStream_t>(stream)));
  });
}

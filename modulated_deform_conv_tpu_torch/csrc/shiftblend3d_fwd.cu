// shiftblend3d_fwd: bounded-offset DCN forward (3D, stride 1, output size ==
// input size), gather + grouped GEMM fused.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/shiftblend.py::
// _fwd_kernel_loop (:719), the loop path for 3D windows of more than 640
// (tap, window) pairs, and the 3D use of _fwd_kernel_cols (:627).  Both keep
// the x plane resident in VMEM and blend static shifts of it (the loop path
// rolls the leading window axis into a fori_loop), then fuse out = W2 cols;
// the lead-chunked mode splits a volume too large for VMEM along its leading
// axis.  All three compute the same function, which this kernel computes in
// one launch for the whole volume.
//
// The bounded contract is the 2D kernel's (shiftblend_fwd.cu), per axis:
// with (lo, W) = _axis_window(b), corner c of a tap on axis d is kept only if
// lo <= floor(pos_d) - anchor_d + c <= lo + W - 1.
//
// What bounds it on the H100: x, offset, mask and out once (0.81 GB at
// BASELINE config 4, B=4: ~0.24 ms at 3.35 TB/s) against 2 * B * P * O *
// C/g * K FLOPs (464 GFLOP there: ~0.94 ms at the 495 TFLOP/s TF32 rate).
//
// What the design does about that (deform_fwd.cuh, the kernel the 2D
// forwards run, with 8 corners a tap): x channels-last once a call, so a
// trilinear corner is a row of consecutive channels, read 16 bytes at a
// time; a block owns 64 positions flattened over (batch, volume) and up to
// 256 output channels of one conv group (two tiles of 64 at config 4), so
// each column is built once; the products run on mma.sync in the mode's
// arithmetic; the corner table holds a few taps of the current stages, not
// a whole slab, so any tap count fits (5 x 5 x 5 included).  The TPU's
// rolled leading axis, lead chunking and 128-lane plane rule exist only for
// VMEM and have no counterpart here.  Where the contraction is split (few
// positions), the parts are folded in order: no float atomics.
// Eligibility (Python side) gives C/dg % 8 == 0 and dg % groups == 0, so a
// channel quad never straddles a slab or a conv group.
//
// The lead mode (the TPU kernel's `lead`, shiftblend.py:1478, which the
// sharding layer enters for a leading-dim split): on a sharded block of OD
// output planes plus halo planes of each neighbour the output grid is OD x
// H x W, and the gate, the window and the kept corners are the whole
// input's (Geo3's placement), as in shiftblend_fwd.cu.
#include "deform_fwd.cuh"

// x (B, C, D, H, W), offset (B, dg*3*K, OD, OH, OW), mask (B, dg*K, OD, OH,
// OW) or null, out (B, O, OD, OH, OW): of the activations' type (io 0:
// float32, io 1: bfloat16), contiguous, on the current device; wf (groups,
// K, C/groups, O/groups) and bias (O) or null: float32.  (lo, win) per
// axis is the bounded-offset window.  gz0 .. orx: the tap gate per axis and
// the block's placement (Geo3): (-1, D), (-1, H), (-1, W) and zeros but on a
// sharded block.  Scratch, allocated by the caller: xt (B, D*H*W, C); part
// (splits, B, O, OD, OH, OW), unused when splits is 1.  Needs stride 1,
// (OH, OW) == (H, W), and OD == D with 2*pad == dilation*(k-1), or a
// lead-mode block, and dg % groups == 0.
// Returns the first CUDA error of the launches, or 0.
extern "C" int shiftblend3d_fwd(const void* x, const void* offset, const void* mask, const float* wf,
                                const float* bias, void* out, float* xt, float* part, int B, int C, int D, int H,
                                int W, int O, int OD, int OH, int OW, int groups, int dg, int kd, int kh, int kw,
                                int pd, int ph, int pw, int dd, int dh, int dw, int lo_z, int win_z, int lo_y,
                                int win_y, int lo_x, int win_x, int splits, int precision, int io, float gz0, float gz1,
                                float gy0, float gy1, float gx0, float gx1, float shz, float orz, float shy,
                                float ory, float shx, float orx, void* stream) {
  using namespace mdc;
  const Geo3 g{B, C,  D,  H,  W,  O,  OD, OH, OW, groups, dg,    kd,   kh,    kw,   1,     1,
               1, pd, ph, pw, dd, dh, dw, 1,  lo_z, win_z,  lo_y, win_y, lo_x, win_x, precision,
               gz0, gz1, gy0, gy1, gx0, gx1, shz, orz, shy, ory, shx, orx};
  return with_io(io, [&](auto t) {
    using T = typename decltype(t)::type;
    return static_cast<int>(run_fwd(g, static_cast<const T*>(x), static_cast<const T*>(offset),
                                    static_cast<const T*>(mask), wf, bias, static_cast<T*>(out), xt, part, splits,
                                    nullptr, static_cast<cudaStream_t>(stream)));
  });
}

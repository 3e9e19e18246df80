// gathermm_fwd: general-offset DCN forward (2D), gather + grouped GEMM fused.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/gathermm.py::
// _fwd_fused_kernel (:1162).  That kernel expresses the bilinear gather as a
// product with a structured-sparse matrix A = prod_d F_d, visits only the
// input chunks inside data-dependent [lo, hi) bounds and fuses out += W2 cols
// per tap group, because the TPU has a matrix unit and no fast gather.
//
// What bounds it on the H100: one forward moves x, offset, mask and out once
// (62.8 MB in f32 at the bench's config 2) and does 2 * B * P * O * C/g * K
// FLOPs (7.40 GFLOP there): ~19 us at 3.35 TB/s, ~15 us at the 495 TFLOP/s
// TF32 rate.  What it cannot avoid besides: the corner gathers, four
// corners of every column value through L1/L2 (925 MB at config 2), since
// the reach of an unbounded offset is the whole plane.
//
// What the design does about that (deform_fwd.cuh, the xt path): the
// product on mma.sync in the mode's arithmetic (TF32; 3xTF32 summed per
// stage in fp32 for "float32"; bf16 for "bfloat16"), the weights staged by
// cp.async two stages deep; x copied channels-last once, so that a thread
// reads 4 consecutive channels of a corner in 16 bytes; the corner table
// built once per block for up to 9 taps; the columns of a position tile
// built once for up to 256 output channels of the group (rebuild factor 1
// at config 2 and DCNResNet-50's c3 / c4 layers, 2 at its c5 layers and at
// config 5 c3, where O/groups is 512); 128 positions a block where 64
// output channels hold the group (config 2), so that a stage's weights
// serve twice the columns; the positions tiled over the flattened (batch,
// position) axis, so that a 7 x 7 plane fills its tiles; the contraction
// split into a shape-fixed number of parts, folded in order, where the
// grid would leave SMs idle.  No float atomics.
#include "deform_fwd.cuh"

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or null,
// out (B, O, OH, OW): of the activations' type (io 0: float32, io 1:
// bfloat16), contiguous, on the current device; wf (groups, K, C/groups,
// O/groups) and bias (O) or null: float32.  Scratch, allocated by the
// caller: xt (B, H*W, C); part (splits, B, O, OH, OW), unused when splits
// is 1.  Returns the first CUDA error of the launches, or 0.
// gy0 .. orx: the tap gate per axis and the block's placement (Geo): (-1, H),
// (-1, W) and zeros but on a sharded block.
extern "C" int gathermm_fwd(const void* x, const void* offset, const void* mask, const float* wf,
                            const float* bias, void* out, float* xt, float* part, int B, int C, int H, int W,
                            int O, int OH, int OW, int groups, int dg, int kh, int kw, int sh, int sw, int ph,
                            int pw, int dh, int dw, int splits, int precision, int io, float gy0, float gy1,
                            float gx0, float gx1, float shy, float ory, float shx, float orx, void* stream) {
  using namespace mdc;
  const Geo g{B, C, H, W, O, OH, OW, groups, dg, kh, kw, sh, sw, ph, pw, dh, dw, 0, 0, 0, 0, 0, precision,
              gy0, gy1, gx0, gx1, shy, ory, shx, orx};
  return with_io(io, [&](auto t) {
    using T = typename decltype(t)::type;
    return static_cast<int>(run_fwd(g, static_cast<const T*>(x), static_cast<const T*>(offset),
                                    static_cast<const T*>(mask), wf, bias, static_cast<T*>(out), xt, part, splits,
                                    nullptr, static_cast<cudaStream_t>(stream)));
  });
}

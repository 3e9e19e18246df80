// shiftblend_fwd: bounded-offset DCN forward (2D, stride 1, output size ==
// input size), gather + grouped GEMM fused.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/shiftblend.py::
// _fwd_kernel_cols (:627).  With |offset| <= b, every corner a tap can reach
// lies in a static window around its anchor, so the TPU kernel keeps the whole
// x plane in VMEM and blends static lane shifts of it (no gathers at all),
// then fuses out = W2 cols per deformable-group slab.
//
// The bounded contract drops corners PER AXIS: with (lo, W) = _axis_window(b),
// corner c of a tap on axis d is kept only if
//     lo <= floor(pos_d) - anchor_d + c <= lo + W - 1,
// and for an integer b the window is 2b+1 rows (the top row carries weight 0
// except in the derivative).  So at b = 2 an offset of 2.5 keeps the low
// corner with weight 0.5 and drops the high one, and an offset of 5 drops the
// tap.  This kernel and its plain version reproduce that exactly.
//
// What bounds it on the H100: the same bytes and FLOPs as gathermm_fwd (62.8
// MB, 7.40 GFLOP at the bench's config 2): ~19 us at 3.35 TB/s, ~15 us at
// the 495 TFLOP/s TF32 rate.
//
// What the design does about that (deform_fwd.cuh, the halo path): the
// static bound makes the input a tile needs known before the offsets are
// read, so a block owns an 8 x 8 tile of output positions and stages the
// (8 + 2 Ry) x (8 + 2 Rx) halo of x channels-last with cp.async, 32, 16 or 8
// channels of one deformable group a chunk (the widest whose two buffers
// fit beside the operand tiles), the next chunk's copy in flight while the
// current chunk's taps are built and multiplied: the Hopper counterpart of
// the resident plane and the static shifts.  Every corner is then four
// 16-byte reads of shared memory in rows of consecutive channels, through a
// corner table built once per chunk for up to 9 taps; the product runs on
// mma.sync in the mode's arithmetic as gathermm_fwd's, for up to 256 output
// channels of the group a block (rebuild factor 1 at config 2).  Where the
// caller's route rule asks for it (ops/cuda/shiftblend.py::halo_route: the
// halo paid on the H100 at 56 x 56 and not on planes of 32 x 32 or less),
// or where two 8-channel halo buffers do not fit, the block reads the
// corners from channels-last x in device memory instead (gathermm_fwd's
// path with the window applied), so no configuration is refused for its
// halo.
// Eligibility (Python side) gives C/dg % 8 == 0 and dg % groups == 0, so a
// chunk never straddles a slab or a conv group.
//
// The lead mode (the TPU kernel's `lead`, shiftblend.py:1478): on a sharded
// leading-dim block (the shard's OH output rows plus halo rows of each
// neighbour, zeros past the image) the output grid is OH x W, the tap gate is
// the whole input's border, and a position is taken in the whole input's
// coordinates (Geo's placement), so the window stays around the tap's anchor
// there and only kept corners inside the whole input's image count.  The
// halo tile is then centred halo - pad rows below its output tile
// (reach_shift).
#include "deform_fwd.cuh"

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or
// null, out (B, O, OH, OW): of the activations' type (io 0: float32, io 1:
// bfloat16), contiguous, on the current device; wf (groups, K, C/groups,
// O/groups) and bias (O) or null: float32.  (lo, win) per axis is
// the bounded-offset window; R per axis the halo reach dil*(k-1)/2 +
// max(-lo, lo+win-1); halo 1 to stage the halo tile where it fits, 0 for the
// xt path.  gy0 .. orx: the tap gate per axis and the block's placement
// (Geo): (-1, H), (-1, W) and zeros but on a sharded block.  Scratch,
// allocated by the caller: xt (B, H*W, C); part (splits, B, O, OH, OW),
// unused when splits is 1.  Needs stride 1, OW == W, and OH == H with
// 2*pad == dilation*(k-1), or a lead-mode block (pad 0 on H, dilation*(k-1)
// even), C/dg % 8 == 0, dg % groups == 0.  Returns the first CUDA error of
// the launches, or 0.
extern "C" int shiftblend_fwd(const void* x, const void* offset, const void* mask, const float* wf,
                              const float* bias, void* out, float* xt, float* part, int B, int C, int H, int W,
                              int O, int OH, int OW, int groups, int dg, int kh, int kw, int ph, int pw, int dh,
                              int dw, int lo_y, int win_y, int lo_x, int win_x, int Ry, int Rx, int halo,
                              int splits, int precision, int io, float gy0, float gy1, float gx0, float gx1, float shy,
                              float ory, float shx, float orx, void* stream) {
  using namespace mdc;
  const Geo g{B, C, H, W, O, OH, OW, groups, dg, kh, kw, 1, 1, ph, pw, dh, dw, 1, lo_y, win_y, lo_x, win_x, precision,
              gy0, gy1, gx0, gx1, shy, ory, shx, orx};
  const Halo h{Ry, Rx, 8, reach_shift(shy, ory, ph, kh, dh), reach_shift(shx, orx, pw, kw, dw)};
  return with_io(io, [&](auto t) {
    using T = typename decltype(t)::type;
    return static_cast<int>(run_fwd(g, static_cast<const T*>(x), static_cast<const T*>(offset),
                                    static_cast<const T*>(mask), wf, bias, static_cast<T*>(out), xt, part, splits,
                                    halo ? &h : nullptr, static_cast<cudaStream_t>(stream)));
  });
}

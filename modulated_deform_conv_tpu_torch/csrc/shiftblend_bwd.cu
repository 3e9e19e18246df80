// shiftblend_bwd: bounded-offset DCN backward (2D, stride 1, output size ==
// input size).
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/shiftblend.py::
// _bwd_kernel (:970), the unrolled path's backward.  That kernel keeps the x
// plane and a grad_x plane resident in VMEM; it computes gcols = W2^T gout
// and adds gout cols^T into grad_weight, then sweep 1 scatters grad_x into
// the resident plane one static shift at a time, and sweep 2 builds the
// offset and mask gradients from the correlation rows sum_c gcol x(p + s).
//
// The bounded contract is the forward's (shiftblend_fwd.cu): with (lo, W)
// per axis from _axis_window(b), corner c of a tap is kept only if
// lo <= floor(pos) - anchor + c <= lo + W - 1.  A dropped corner carries no
// value and no gradient, in grad_x, grad_offset, grad_mask and grad_W alike.
//
// What bounds it on the H100: the same bytes and operations as gathermm_bwd
// (100 MB and 14.8 GFLOP at the bench's config 2: ~30 us either way), and
// the same unavoidable traffic of this split into kernels: gcols written
// once (231 MB in fp32 there) and read back by the pull and
// the correlation, and the corner gathers.
//
// What the design does about that: the tensor-core kernels of
// deform_bwd.cuh with the window on (products on mma.sync, x channels-last,
// corner weights once per block), and a pull with a static reach: every
// (tap, output position) whose kept corners can land in an 8 x 8 input tile
// lies in the (8 + 2R) x (8 + 2R) halo around it, R = pad + the window's
// farthest row: the forward's halo tile, read the other way.  A pull block
// owns such a tile x 64 channels and takes the taps and the halo positions
// as candidates in a fixed order, so no atomics and no data-dependent bounds
// are needed.  Two runs give the same bits.
//
// The lead mode (the TPU kernel's `lead`): on a sharded leading-dim block
// the output grid is OH x W, the gate and the window are the whole input's
// (Geo's placement, as shiftblend_fwd.cu), and the pull covers every row of
// the block, its halo rows included, each tile's candidates moved back by
// the block's reach shift; the sharding layer's exchange sends the halo
// rows' gradient back to their owners.
#include "deform_bwd.cuh"

namespace {

using namespace mdc;

template <int Prec, typename T>
int run(const Geo& g, const T* x, const T* offset, const T* mask, const float* wk, const T* gout, float* gcols,
        float* xt, float* part, T* gx, T* goff, T* gmask, float* gwt, int Ry, int Rx, int splits, cudaStream_t s) {
  auto pull = [&](const float* gc) {
    shift_pull_kernel<T><<<pull_grid(g), kPullT, 0, s>>>(offset, mask, gc, gx, Ry, Rx, g);
    return cudaGetLastError();
  };
  return static_cast<int>(run_bwd2d<Prec>(g, x, offset, mask, wk, gout, gcols, xt, part, gx, goff, gmask, gwt,
                                          splits, s, pull));
}

}  // namespace

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or
// null, gout (B, O, OH, OW): of the activations' type (io 0: float32, io
// 1: bfloat16), contiguous, on the current device; wk (groups, O/groups,
// K, C/groups): float32.  (lo, win) per axis is the
// bounded-offset window; R per axis the halo reach dil*(k-1)/2 + max(-lo,
// lo+win-1).  gy0 .. orx: the tap gate per axis and the block's placement
// (Geo): (-1, H), (-1, W) and zeros but on a sharded block.  Scratch,
// allocated by the caller: gcols (B, K, OH*OW, C); xt (B, H*W, C); part
// (splits, groups, C/groups*K, O/groups).  Outputs, each null when not
// wanted: gx like x, goff like offset, gmask like mask, gwt (groups,
// C/groups*K, O/groups).  Needs what shiftblend_fwd needs.  Returns the
// first CUDA error of the launches, or 0.
extern "C" int shiftblend_bwd(const void* x, const void* offset, const void* mask, const float* wk,
                              const void* gout, float* gcols, float* xt, float* part, void* gx, void* goff,
                              void* gmask, float* gwt, int B, int C, int H, int W, int O, int OH, int OW,
                              int groups, int dg, int kh, int kw, int ph, int pw, int dh, int dw, int lo_y,
                              int win_y, int lo_x, int win_x, int Ry, int Rx, int splits, int precision, int io,
                              float gy0, float gy1, float gx0, float gx1, float shy, float ory, float shx, float orx,
                              void* stream) {
  using namespace mdc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, C, H, W, O, OH, OW, groups, dg, kh, kw, 1, 1, ph, pw, dh, dw, 1, lo_y, win_y, lo_x, win_x, precision,
              gy0, gy1, gx0, gx1, shy, ory, shx, orx};
  return with_io(io, [&](auto t) {
    using T = typename decltype(t)::type;
    const T *xi = static_cast<const T*>(x), *oi = static_cast<const T*>(offset), *mi = static_cast<const T*>(mask),
            *go = static_cast<const T*>(gout);
    T *gxo = static_cast<T*>(gx), *goo = static_cast<T*>(goff), *gmo = static_cast<T*>(gmask);
    switch (precision) {
      case kFloat32:
        return run<kFloat32>(g, xi, oi, mi, wk, go, gcols, xt, part, gxo, goo, gmo, gwt, Ry, Rx, splits, s);
      case kTensorFloat32:
        return run<kTensorFloat32>(g, xi, oi, mi, wk, go, gcols, xt, part, gxo, goo, gmo, gwt, Ry, Rx, splits, s);
      default:
        return run<kBFloat16>(g, xi, oi, mi, wk, go, gcols, xt, part, gxo, goo, gmo, gwt, Ry, Rx, splits, s);
    }
  });
}

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
// bench's config 2), against the two products (gcols and grad_W, 14.8
// GFLOP there): ~30 us at 3.35 TB/s, ~30 us at the 495 TFLOP/s TF32 rate.
// What it cannot avoid besides, in this split into kernels: gcols through
// device memory (231 MB in fp32 there) and read back by the
// pull (about four times, mostly from L2) and the correlation; the corner
// gathers of the column rebuild and the correlation.
//
// What the design does about that (deform_bwd.cuh, the tensor-core section):
// both products on mma.sync in the mode's arithmetic with cp.async-staged
// operands; x copied channels-last once, so that every corner read is a row
// of consecutive channels; corner weights evaluated once per block into
// shared tables.  grad_x is a scatter with
// unbounded reach, so it is turned into a pull: boxes_kernel writes, per
// (batch, deformable group, 4 x 4 output tile), the 2D box of input pixels
// its kept corners touch (the counterpart of `_prep`'s `bnd`), and a pull
// block of 8 x 8 input pixels x 64 channels takes as candidates the taps
// and positions of the tiles whose box meets it, in order.  No float
// atomics anywhere, so two runs give the same bits.
#include "deform_bwd.cuh"

namespace {

using namespace mdc;

template <int Prec, typename T>
int run(const Geo& g, const T* x, const T* offset, const T* mask, const float* wk, const T* gout, float* gcols,
        float* xt, int* boxes, float* part, T* gx, T* goff, T* gmask, float* gwt, int splits, cudaStream_t s) {
  auto pull = [&](const float* gc) {
    const int NT = ((g.OH + kBoxTile - 1) / kBoxTile) * ((g.OW + kBoxTile - 1) / kBoxTile);
    const int warps = g.B * g.dg * NT;
    int4* bx = reinterpret_cast<int4*>(boxes);
    boxes_kernel<T><<<(warps + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(offset, mask, bx, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gather_pull_kernel<T><<<pull_grid(g), kPullT, 0, s>>>(offset, mask, gc, bx, gx, g);
    return cudaGetLastError();
  };
  return static_cast<int>(run_bwd2d<Prec>(g, x, offset, mask, wk, gout, gcols, xt, part, gx, goff, gmask, gwt,
                                          splits, s, pull));
}

}  // namespace

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or null,
// gout (B, O, OH, OW): of the activations' type (io 0: float32, io 1:
// bfloat16), contiguous, on the current device; wk (groups, O/groups, K,
// C/groups): float32.  Scratch, allocated by the caller:
// gcols (B, K, OH*OW, C); xt (B, H*W, C);
// boxes (B, dg, ceil(OH/4)*ceil(OW/4), 4) int32; part (splits, groups,
// C/groups*K, O/groups).  Outputs, each null when not wanted: gx like x,
// goff like offset, gmask like mask, gwt (groups, C/groups*K, O/groups).
// Returns the first CUDA error of the launches, or 0.
// gy0 .. orx: the tap gate per axis and the block's placement (Geo): (-1, H),
// (-1, W) and zeros but on a sharded block.
extern "C" int gathermm_bwd(const void* x, const void* offset, const void* mask, const float* wk,
                            const void* gout, float* gcols, float* xt, int* boxes, float* part, void* gx,
                            void* goff, void* gmask, float* gwt, int B, int C, int H, int W, int O, int OH,
                            int OW, int groups, int dg, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                            int dw, int splits, int precision, int io, float gy0, float gy1, float gx0, float gx1,
                            float shy, float ory, float shx, float orx, void* stream) {
  using namespace mdc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, C, H, W, O, OH, OW, groups, dg, kh, kw, sh, sw, ph, pw, dh, dw, 0, 0, 0, 0, 0, precision,
              gy0, gy1, gx0, gx1, shy, ory, shx, orx};
  return with_io(io, [&](auto t) {
    using T = typename decltype(t)::type;
    const T *xi = static_cast<const T*>(x), *oi = static_cast<const T*>(offset), *mi = static_cast<const T*>(mask),
            *go = static_cast<const T*>(gout);
    T *gxo = static_cast<T*>(gx), *goo = static_cast<T*>(goff), *gmo = static_cast<T*>(gmask);
    switch (precision) {
      case kFloat32:
        return run<kFloat32>(g, xi, oi, mi, wk, go, gcols, xt, boxes, part, gxo, goo, gmo, gwt, splits, s);
      case kTensorFloat32:
        return run<kTensorFloat32>(g, xi, oi, mi, wk, go, gcols, xt, boxes, part, gxo, goo, gmo, gwt, splits, s);
      default:
        return run<kBFloat16>(g, xi, oi, mi, wk, go, gcols, xt, boxes, part, gxo, goo, gmo, gwt, splits, s);
    }
  });
}

// gathermm_cols_fwd: the deformable columns (2D) of the unfused path.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/gathermm.py::
// _fwd_kernel (:523).  That kernel writes the columns (B, dg, K, P, Cg) as a
// product with the structured-sparse corner matrix A = prod_d F_d over the
// input chunks inside data-dependent [lo, hi) bounds, because the TPU has a
// matrix unit and no fast gather; the grouped GEMM runs outside it, as an
// XLA einsum.  The JAX package takes this path where its fused kernel does
// not fit (`_fuse_ok`): a channel slab straddles conv groups, or the fused
// backward's VMEM footprint would pass 80 MB.
//
// What bounds it on the H100: the columns it writes, C * K * B * P values
// (231 MB in fp32 at BASELINE config 5's c4 layer, B=32), against reads of
// x, offset and mask (about a tenth of that): ~0.08 ms at 3.35 TB/s.
//
// What the design does about that (deform_cols_fwd.cuh): a direct gather
// with weights built once per block and reused over its channels.  On
// planes that fit in shared memory (the plane route: config 5's c3-c5) a
// block stages the rows its corners reach, once for all its (tap, position)
// items, so x is read from L2 about once per block rather than once per
// tap and corner, and writes each columns row as a contiguous run of
// 16-byte stores; larger planes take the gather route from x.
#include "deform_cols_fwd.cuh"

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or
// null: float32 (io 0) or bfloat16 (io 1), contiguous, on the current device.  cols (C*K, B*OH*OW):
// float32, or bfloat16 when precision is "bfloat16".  plane .. smem: the
// route and its plan (gathermm.cols_fwd_plan).  Returns cudaGetLastError().
// gy0 .. orx: the tap gate per axis and the block's placement (Geo): (-1, H),
// (-1, W) and zeros but on a sharded block.
extern "C" int gathermm_cols_fwd(const void* x, const void* offset, const void* mask, void* cols, int B, int C,
                                 int H, int W, int OH, int OW, int dg, int kh, int kw, int sh, int sw, int ph,
                                 int pw, int dh, int dw, int plane, int gt, int tiles, int nbm, int splits, int cps,
                                 int cc, int slot, int smem, int precision, int io, float gy0, float gy1, float gx0,
                                 float gx1, float shy, float ory, float shx, float orx, void* stream) {
  using namespace mdc;
  const Geo g{B, C, H, W, 0, OH, OW, 1, dg, kh, kw, sh, sw, ph, pw, dh, dw, 0, 0, 0, 0, 0, precision,
              gy0, gy1, gx0, gx1, shy, ory, shx, orx};
  const ColPlan pl{plane, gt, tiles, nbm, splits, cps, cc, slot, smem};
  return with_io(io, [&](auto t) {
    using TX = typename decltype(t)::type;
    return launch_cols_fwd(static_cast<const TX*>(x), static_cast<const TX*>(offset), static_cast<const TX*>(mask),
                           cols, g, pl, static_cast<cudaStream_t>(stream));
  });
}

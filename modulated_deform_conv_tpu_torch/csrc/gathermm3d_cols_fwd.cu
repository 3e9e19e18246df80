// gathermm3d_cols_fwd: the deformable columns (3D) of the unfused path.
//
// Replaces the 3D (flat and planar) mode of the TPU kernel
// modulated_deform_conv_tpu/ops/pallas/gathermm.py::_fwd_kernel (:523).
// Planar mode (:550-586) bounds each output tile's sweep by a lead-plane
// range x an in-plane chunk range, so that the dense corner-matrix product
// visits fewer input chunks; a direct gather reads only the eight corners of
// each tap and needs no such mode.
//
// What bounds it on the H100: the columns it writes, C * K * B * P values
// (226 MB in fp32 at BASELINE config 3's size, B=2, 64 channels, 16 x 32 x
// 32, 27 taps): ~0.07 ms at 3.35 TB/s.
//
// What the design does about that: gathermm_cols_fwd.cu's two routes with
// the trilinear corner rules of deform_tile3d.cuh (deform_cols_fwd.cuh).
// On volumes that fit in shared memory (the plane route: the 3D columns
// case) a block owns whole output rows of one plane over every tap and
// stages the planes x rows box its corners reach, about as many x values as
// it writes columns a channel; a block whose box passes its slot, and larger
// volumes (the gather route), read the corners from x.
#include "deform_cols_fwd.cuh"

// x (B, C, D, H, W), offset (B, dg*3*K, OD, OH, OW), mask (B, dg*K, OD, OH,
// OW) or null: float32 (io 0) or bfloat16 (io 1), contiguous, on the current device.  cols (C*K,
// B*OD*OH*OW): float32, or bfloat16 when precision is "bfloat16".  plane ..
// smem: the route and its plan (gathermm.cols_fwd_plan).  Returns
// cudaGetLastError().
// gz0 .. orx: the tap gate per axis and the block's placement (Geo3): (-1,
// D), (-1, H), (-1, W) and zeros but on a sharded block.
extern "C" int gathermm3d_cols_fwd(const void* x, const void* offset, const void* mask, void* cols, int B, int C,
                                   int D, int H, int W, int OD, int OH, int OW, int dg, int kd, int kh, int kw,
                                   int sd, int sh, int sw, int pd, int ph, int pw, int dd, int dh, int dw,
                                   int plane, int gt, int tiles, int nbm, int splits, int cps, int cc, int slot,
                                   int smem, int precision, int io, float gz0, float gz1, float gy0, float gy1, float gx0,
                                   float gx1, float shz, float orz, float shy, float ory, float shx, float orx,
                                   void* stream) {
  using namespace mdc;
  const Geo3 g{B,  C,  D,  H,  W,  0,  OD, OH, OW, 1, dg, kd, kh, kw, sd, sh,
               sw, pd, ph, pw, dd, dh, dw, 0,  0,  0,  0, 0,  0,  0,  precision,
               gz0, gz1, gy0, gy1, gx0, gx1, shz, orz, shy, ory, shx, orx};
  const ColPlan pl{plane, gt, tiles, nbm, splits, cps, cc, slot, smem};
  return with_io(io, [&](auto t) {
    using TX = typename decltype(t)::type;
    return launch_cols_fwd(static_cast<const TX*>(x), static_cast<const TX*>(offset), static_cast<const TX*>(mask),
                           cols, g, pl, static_cast<cudaStream_t>(stream));
  });
}

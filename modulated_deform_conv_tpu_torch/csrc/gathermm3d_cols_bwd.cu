// gathermm3d_cols_bwd: the VJP of the deformable columns (3D), the unfused
// path's backward gather.
//
// Replaces the 3D (flat and planar) mode of the TPU kernel
// modulated_deform_conv_tpu/ops/pallas/gathermm.py::_bwd_kernel (:623):
// given gcols, grad_x = A gcols and the correlation M = x gcols^T reduced
// against dA/dpos (grad_offset) and A (grad_mask).
//
// What bounds it on the H100: the bytes of gcols (226 MB in fp32 at BASELINE
// config 3's size) read, x, offset and mask read, and the three gradients
// written: ~0.08 ms at 3.35 TB/s.
//
// What the design does about that: the 2D kernel's design (deform_cols_bwd.cuh)
// with trilinear corners and input bricks of tz x ty x tx voxels: the
// candidates binned once per (sample, deformable group) into the tables of
// the bricks their corners fall in, so that no block evaluates a candidate
// that does not land in its brick; a block per brick x 32 channels gathers
// the tabled candidates' gcols values along the layout's contiguous axis
// and serves the pull and the correlation of the candidates it owns from
// them; the channel chunks' partial correlations are folded in order.
// No float atomics, so two runs give the same bits.
#include <algorithm>

#include "deform_cols_bwd.cuh"

// x (B, C, D, H, W), offset (B, dg*3*K, OD, OH, OW), mask (B, dg*K, OD, OH,
// OW) or null: float32 (io 0) or bfloat16 (io 1), contiguous, on the current device.  gcols (C*K,
// B*OD*OH*OW): float32, or bfloat16 when precision is "bfloat16".  Input
// bricks of tz x ty x tx voxels.  Scratch (ops/cuda/gathermm.py::
// cols_bwd_plan): cnt, tcount, tstart, pool, csr (null when grad_x is not
// wanted) and part (null when neither grad_offset nor grad_mask is
// wanted).  Outputs, each null when not wanted: gx like x, goff like
// offset, gmask like mask.  Returns the first CUDA error of the launches, or
// 0.
// gz0 .. orx: the tap gate per axis and the block's placement (Geo3): (-1,
// D), (-1, H), (-1, W) and zeros but on a sharded block.
extern "C" int gathermm3d_cols_bwd(const void* x, const void* offset, const void* mask, const void* gcols,
                                   int* cnt, int* tcount, long long* tstart, void* pool, void* csr, float* part,
                                   void* gx, void* goff, void* gmask, int B, int C, int D, int H, int W, int OD,
                                   int OH, int OW, int dg, int kd, int kh, int kw, int sd, int sh, int sw, int pd,
                                   int ph, int pw, int dd, int dh, int dw, int tz, int ty, int tx, int precision, int io,
                                   float gz0, float gz1, float gy0, float gy1, float gx0, float gx1, float shz,
                              float orz, float shy, float ory, float shx, float orx, void* stream) {
  using namespace mdc;
  const Geo3 g{B,  C,  D,  H,  W,  0,  OD, OH, OW, 1, dg, kd, kh, kw, sd, sh,
               sw, pd, ph, pw, dd, dh, dw, 0,  0,  0,  0, 0,  0,  0,  precision,
               gz0, gz1, gy0, gy1, gx0, gx1, shz, orz, shy, ory, shx, orx};
  const ColTiles tl{tz, ty, tx, (D + tz - 1) / tz, (H + ty - 1) / ty, (W + tx - 1) / tx,
                    std::min(tz + 1, D), std::min(ty + 1, H), std::min(tx + 1, W)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ColEntry<Geo3>* pl = static_cast<ColEntry<Geo3>*>(pool);
  unsigned short* cs = static_cast<unsigned short*>(csr);
  return with_io(io, [&](auto t) {
    using TX = typename decltype(t)::type;
    const TX *xi = static_cast<const TX*>(x), *oi = static_cast<const TX*>(offset), *mi = static_cast<const TX*>(mask);
    TX *gxo = static_cast<TX*>(gx), *goo = static_cast<TX*>(goff), *gmo = static_cast<TX*>(gmask);
    if (precision == kBFloat16)
      return static_cast<int>(run_cols_bwd(g, tl, xi, oi, mi, static_cast<const __nv_bfloat16*>(gcols), cnt, tcount,
                                           tstart, pl, cs, part, gxo, goo, gmo, s));
    return static_cast<int>(run_cols_bwd(g, tl, xi, oi, mi, static_cast<const float*>(gcols), cnt, tcount, tstart,
                                         pl, cs, part, gxo, goo, gmo, s));
  });
}

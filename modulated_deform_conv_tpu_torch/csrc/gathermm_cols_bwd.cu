// gathermm_cols_bwd: the VJP of the deformable columns (2D), the unfused
// path's backward gather.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/gathermm.py::
// _bwd_kernel (:623).  Given gcols, the cotangent of the columns (the GEMM's
// gradient, computed outside), that kernel rebuilds the corner matrix A of
// each (tile, tap group) over the input chunks inside data-dependent bounds
// and computes grad_x = A gcols and the correlation M = x gcols^T, reduced
// against dA/dpos (grad_offset) and A (grad_mask).
//
// What bounds it on the H100: the bytes of gcols (231 MB in fp32 at BASELINE
// config 5's c4 layer, B=32) read, x, offset and mask read, and grad_x,
// grad_offset and grad_mask written: ~0.09 ms at 3.35 TB/s.
//
// What the design does about that (deform_cols_bwd.cuh): the (tap,
// position) candidates are binned once per (sample, deformable group) into
// tables of the input tiles their corners fall in (the whole plane is one
// tile up to 256 pixels: BASELINE config 5's c4 and c5 planes); a block per
// tile x 32 channels gathers the tabled candidates' gcols values along the
// layout's contiguous axis into shared memory and serves both the pull
// (grad_x, each pixel x channel summed by one owner in table order) and the
// correlation of the candidates the tile owns, against x staged once a
// block; the channel chunks' partial correlations are folded in order.
// No float atomics, so two runs give the same bits.
#include <algorithm>

#include "deform_cols_bwd.cuh"

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or
// null: float32 (io 0) or bfloat16 (io 1), contiguous, on the current device.  gcols (C*K, B*OH*OW):
// float32, or bfloat16 when precision is "bfloat16".  Input tiles of ty x tx
// pixels.  Scratch (ops/cuda/gathermm.py::cols_bwd_plan): cnt, tcount,
// tstart, pool, csr (null when grad_x is not wanted) and part (null when
// neither grad_offset nor grad_mask is wanted).  Outputs, each null when
// not wanted: gx like x, goff like offset, gmask like mask.  Returns the
// first CUDA error of the launches, or 0.
// gy0 .. orx: the tap gate per axis and the block's placement (Geo): (-1, H),
// (-1, W) and zeros but on a sharded block.
extern "C" int gathermm_cols_bwd(const void* x, const void* offset, const void* mask, const void* gcols,
                                 int* cnt, int* tcount, long long* tstart, void* pool, void* csr, float* part,
                                 void* gx, void* goff, void* gmask, int B, int C, int H, int W, int OH, int OW,
                                 int dg, int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw, int ty,
                                 int tx, int precision, int io, float gy0, float gy1, float gx0, float gx1, float shy,
                                 float ory, float shx, float orx, void* stream) {
  using namespace mdc;
  const Geo g{B, C, H, W, 0, OH, OW, 1, dg, kh, kw, sh, sw, ph, pw, dh, dw, 0, 0, 0, 0, 0, precision,
              gy0, gy1, gx0, gx1, shy, ory, shx, orx};
  const ColTiles tl{1, ty, tx, 1, (H + ty - 1) / ty, (W + tx - 1) / tx, 1, std::min(ty + 1, H), std::min(tx + 1, W)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ColEntry<Geo>* pl = static_cast<ColEntry<Geo>*>(pool);
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

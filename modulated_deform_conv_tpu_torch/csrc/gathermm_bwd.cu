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
// bench's config 2), against the two GEMMs (gcols and grad_W, 14.8 GFLOP
// there): ~30 us at 3.35 TB/s, ~30 us at the 495 TFLOP/s TF32 rate.  With
// the plain FP32 FMAs used here the 67 TFLOP/s FP32 rate bounds it (~220
// us), and gcols goes through device memory once (231 MB there).
//
// What the design does about that, in five kernels on one stream (the shared
// ones in deform_bwd.cuh):
//   1. gcols_kernel: gcols = W2^T gout, tiled FP32 GEMM, channels innermost;
//   2. ranges_kernel: per (batch, deformable group, 64-position output tile)
//      the range [lo, hi) of flat input pixels its kept corners touch: the
//      counterpart of `_prep`'s `bnd`;
//   3. gx_kernel: grad_x is a scatter with unbounded reach, so it is turned
//      into a pull: a block owns 64 consecutive input pixels x 32 channels,
//      walks the output tiles whose range overlaps its pixels in order, and
//      applies their corner hits in a fixed order (deform_bwd.cuh);
//   4. goff_kernel: one owner per (batch, group, tap, position) sums the
//      correlation over the slab's channels in order;
//   5. gw_kernel + fold_kernel: grad_W in fixed splits of the (batch,
//      position) axis, columns rebuilt from x in shared memory, folded in
//      order.
// No float atomics anywhere, so two runs give the same bits.  Tensor cores
// and a fused single pass are later work.
#include "deform_bwd.cuh"

namespace {

using namespace mdc;

// One warp per (b, d, output tile): min / max flat index of the kept corners
// (with a nonzero mask-folded weight) of every tap and position of the tile.
__global__ void __launch_bounds__(kThreads) ranges_kernel(const float* __restrict__ offset,
                                                          const float* __restrict__ mask,
                                                          int2* __restrict__ ranges, Geo g) {
  const int K = g.kh * g.kw, P = g.OH * g.OW, NT = (P + kTP - 1) / kTP;
  const int wid = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (wid >= g.B * g.dg * NT) return;
  const int t = wid % NT, d = (wid / NT) % g.dg, b = wid / (NT * g.dg);
  int lo = 0x7fffffff, hi = 0;
  for (int e = lane; e < K * kTP; e += 32) {
    const int k = e / kTP, p = t * kTP + e % kTP;
    if (p >= P) continue;
    const TapWeights tw = weights_at(g, offset, mask, b, d, k, p);
    const float w[4] = {tw.w.x, tw.w.y, tw.w.z, tw.w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (w[i] == 0.f) continue;
      const int q = (tw.y0 + (i >> 1)) * g.W + tw.x0 + (i & 1);
      lo = min(lo, q);
      hi = max(hi, q + 1);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) ranges[wid] = make_int2(lo, hi);
}

// grad_x of 64 consecutive flat input pixels x 32 channels of one
// (b, deformable group), pulled from the output tiles whose corner range
// overlaps them, tile by tile and tap by tap in order.
__global__ void __launch_bounds__(kPullThreads) gx_kernel(const float* __restrict__ offset,
                                                          const float* __restrict__ mask,
                                                          const float* __restrict__ gcols,
                                                          const int2* __restrict__ ranges,
                                                          float* __restrict__ gx, Geo g) {
  __shared__ PullSmem sm;
  const int K = g.kh * g.kw, P = g.OH * g.OW, HW = g.H * g.W, NT = (P + kTP - 1) / kTP;
  const int Cdg = g.C / g.dg, cchunks = (Cdg + kCW - 1) / kCW;
  const int q0 = blockIdx.x * kQT, q1 = min(HW, q0 + kQT);
  const int d = blockIdx.y / cchunks, c0 = d * Cdg + (blockIdx.y % cchunks) * kCW;
  const int cw = min(kCW, (d + 1) * Cdg - c0);
  const int b = blockIdx.z;
  const float* gcol = gcols + static_cast<size_t>(b) * K * P * g.C + c0;
  const int2* rg = ranges + (static_cast<size_t>(b) * g.dg + d) * NT;
  pull_clear(sm);
  for (int t = 0; t < NT; ++t) {
    const int2 r = rg[t];
    if (!(r.x < q1 && r.y > q0)) continue;  // uniform across the block
    for (int e0 = 0; e0 < K * kTP; e0 += kPullThreads) {
      const int e = e0 + threadIdx.x;
      const int k = e / kTP, p = t * kTP + e % kTP;
      int n = 0, pix[4];
      float w[4];
      if (e < K * kTP && p < P) {
        const TapWeights tw = weights_at(g, offset, mask, b, d, k, p);
        const float wv[4] = {tw.w.x, tw.w.y, tw.w.z, tw.w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = (tw.y0 + (i >> 1)) * g.W + tw.x0 + (i & 1);
          if (wv[i] != 0.f && q >= q0 && q < q1) {
            pix[n] = q - q0;
            w[n] = wv[i];
            ++n;
          }
        }
      }
      pull_hits(sm, n, pix, w, k * P + p, gcol, g.C, cw);
    }
  }
  for (int e = threadIdx.x; e < kQT * kCW; e += kPullThreads) {
    const int cl = e / kQT, pix = e % kQT;
    if (cl < cw && q0 + pix < q1)
      gx[(static_cast<size_t>(b) * g.C + c0 + cl) * HW + q0 + pix] = pull_result(sm, pix, cl);
  }
}

}  // namespace

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or null,
// wk (groups, O/groups, K, C/groups), gout (B, O, OH, OW): float32,
// contiguous, on the current device.  Scratch, allocated by the caller:
// gcols (B, K, OH*OW, C), ranges (B, dg, ceil(OH*OW/64)) int2, part (splits,
// groups, C/groups*K, O/groups).  Outputs, each null when not wanted:
// gx like x, goff like offset, gmask like mask, gwt (groups, C/groups*K,
// O/groups).  Returns the first CUDA error of the launches, or 0.
extern "C" int gathermm_bwd(const float* x, const float* offset, const float* mask, const float* wk,
                            const float* gout, float* gcols, int* ranges, float* part, float* gx, float* goff,
                            float* gmask, float* gwt, int B, int C, int H, int W, int O, int OH, int OW,
                            int groups, int dg, int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw,
                            int splits, int precision, void* stream) {
  using namespace mdc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, C, H, W, O, OH, OW, groups, dg, kh, kw, sh, sw, ph, pw, dh, dw, 0, 0, 0, 0, 0, precision};
  cudaError_t err = cudaSuccess;
  if (gx || goff || gmask) {
    if ((err = launch_gcols(g, wk, gout, gcols, s)) != cudaSuccess) return static_cast<int>(err);
  }
  if (gx) {
    const int NT = (OH * OW + kTP - 1) / kTP, warps = B * dg * NT;
    int2* rg = reinterpret_cast<int2*>(ranges);
    ranges_kernel<<<(warps + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(offset, mask, rg, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int Cdg = C / dg;
    const dim3 grid((H * W + kQT - 1) / kQT, dg * ((Cdg + kCW - 1) / kCW), B);
    gx_kernel<<<grid, kPullThreads, 0, s>>>(offset, mask, gcols, rg, gx, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (goff || gmask) {
    if ((err = launch_goff(g, x, offset, mask, gcols, goff, gmask, s)) != cudaSuccess) return static_cast<int>(err);
  }
  if (gwt) err = launch_gw(g, x, offset, mask, gout, part, gwt, splits, s);
  return static_cast<int>(err);
}

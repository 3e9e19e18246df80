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
// (100 MB and 14.8 GFLOP at the bench's config 2: ~30 us either way; ~220 us
// at the 67 TFLOP/s FP32 FMA rate used here).
//
// What the design does about that: the static bound turns grad_x into a
// pull with a static reach.  Every (tap, output position) whose kept corners
// can land in an 8 x 8 input tile lies in the (8 + 2R) x (8 + 2R) halo
// around it, R = pad + the window's farthest row: the forward's halo tile,
// read the other way.  A block owns such a tile x 32 channels and walks the
// taps and the halo positions in a fixed order, applying the corner hits in
// order (deform_bwd.cuh), so no atomics and no data-dependent bounds are
// needed.  gcols, grad_offset / grad_mask and grad_W are the shared kernels
// of deform_bwd.cuh with the window on.  Two runs give the same bits.
#include "deform_bwd.cuh"

namespace {

using namespace mdc;

constexpr int kTH = 8, kTW = 8;  // input tile: kTH x kTW == kQT pixels

__global__ void __launch_bounds__(kPullThreads) gx_kernel(const float* __restrict__ offset,
                                                          const float* __restrict__ mask,
                                                          const float* __restrict__ gcols,
                                                          float* __restrict__ gx, int Ry, int Rx, Geo g) {
  __shared__ PullSmem sm;
  const int K = g.kh * g.kw, P = g.H * g.W;
  const int Cdg = g.C / g.dg, cchunks = (Cdg + kCW - 1) / kCW;
  const int tiles_x = (g.W + kTW - 1) / kTW;
  const int ty0 = (blockIdx.x / tiles_x) * kTH, tx0 = (blockIdx.x % tiles_x) * kTW;
  const int d = blockIdx.y / cchunks, c0 = d * Cdg + (blockIdx.y % cchunks) * kCW;
  const int cw = min(kCW, (d + 1) * Cdg - c0);
  const int b = blockIdx.z;
  const int HS = kTH + 2 * Ry, WS = kTW + 2 * Rx;  // halo of output positions
  const float* gcol = gcols + static_cast<size_t>(b) * K * P * g.C + c0;
  pull_clear(sm);
  const int n_cand = K * HS * WS;
  for (int e0 = 0; e0 < n_cand; e0 += kPullThreads) {
    const int e = e0 + threadIdx.x;
    const int k = e / (HS * WS), rem = e % (HS * WS);
    const int oy = ty0 - Ry + rem / WS, ox = tx0 - Rx + rem % WS;
    int n = 0, pix[4];
    float w[4];
    const int p = oy * g.W + ox;
    if (e < n_cand && oy >= 0 && oy < g.H && ox >= 0 && ox < g.W) {
      const TapWeights tw = weights_at(g, offset, mask, b, d, k, p);
      const float wv[4] = {tw.w.x, tw.w.y, tw.w.z, tw.w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = tw.y0 + (i >> 1) - ty0, x = tw.x0 + (i & 1) - tx0;
        if (wv[i] != 0.f && y >= 0 && y < kTH && x >= 0 && x < kTW) {
          pix[n] = y * kTW + x;
          w[n] = wv[i];
          ++n;
        }
      }
    }
    pull_hits(sm, n, pix, w, k * P + p, gcol, KPC{K, P, g.C}, cw);
  }
  for (int e = threadIdx.x; e < kQT * kCW; e += kPullThreads) {
    const int cl = e / kQT, pix = e % kQT;
    const int y = ty0 + pix / kTW, x = tx0 + pix % kTW;
    if (cl < cw && y < g.H && x < g.W)
      gx[(static_cast<size_t>(b) * g.C + c0 + cl) * P + y * g.W + x] = pull_result(sm, pix, cl);
  }
}

}  // namespace

// x (B, C, H, W), offset (B, dg*2*K, H, W), mask (B, dg*K, H, W) or null,
// wk (groups, O/groups, K, C/groups), gout (B, O, H, W): float32, contiguous,
// on the current device.  (lo, win) per axis is the bounded-offset window;
// R per axis the halo reach pad + max(-lo, lo+win-1).  Scratch, allocated by
// the caller: gcols (B, K, H*W, C), part (splits, groups, C/groups*K,
// O/groups).  Outputs, each null when not wanted: gx like x, goff like
// offset, gmask like mask, gwt (groups, C/groups*K, O/groups).  Needs
// stride 1 and 2*pad == dilation*(k-1).  Returns the first CUDA error of the
// launches, or 0.
extern "C" int shiftblend_bwd(const float* x, const float* offset, const float* mask, const float* wk,
                              const float* gout, float* gcols, float* part, float* gx, float* goff, float* gmask,
                              float* gwt, int B, int C, int H, int W, int O, int groups, int dg, int kh, int kw,
                              int ph, int pw, int dh, int dw, int lo_y, int win_y, int lo_x, int win_x, int Ry,
                              int Rx, int splits, int precision, void* stream) {
  using namespace mdc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, C, H, W, O, H, W, groups, dg, kh, kw, 1, 1, ph, pw, dh, dw, 1, lo_y, win_y, lo_x, win_x,
              precision};
  cudaError_t err = cudaSuccess;
  if (gx || goff || gmask) {
    if ((err = launch_gcols(g, wk, gout, gcols, s)) != cudaSuccess) return static_cast<int>(err);
  }
  if (gx) {
    const int Cdg = C / dg;
    const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), dg * ((Cdg + kCW - 1) / kCW), B);
    gx_kernel<<<grid, kPullThreads, 0, s>>>(offset, mask, gcols, gx, Ry, Rx, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (goff || gmask) {
    if ((err = launch_goff(g, x, offset, mask, gcols, goff, gmask, KPC{kh * kw, H * W, C}, s)) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (gwt) err = launch_gw(g, x, offset, mask, gout, part, gwt, splits, s);
  return static_cast<int>(err);
}

// shiftblend3d_bwd: bounded-offset DCN backward (3D, stride 1, output size
// == input size).
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/shiftblend.py::
// _bwd_kernel_loop (:1126), the loop path's backward, and the 3D use of
// _bwd_kernel (:970).  Those keep the x and grad_x planes resident in VMEM,
// compute gcols = W2^T gout and add gout cols^T into grad_weight (the loop
// path recomputes the masked columns when none were saved), scatter grad_x
// into the resident plane one static shift at a time and build the offset
// and mask gradients from the correlation rows sum_c gcol x(p + s).
//
// The bounded contract is the forward's (shiftblend3d_fwd.cu): a dropped
// corner carries no value and no gradient, in grad_x, grad_offset, grad_mask
// and grad_W alike.
//
// What bounds it on the H100: the two products (gcols and grad_W, 928 GFLOP
// at BASELINE config 4: ~1.9 ms at the 495 TFLOP/s TF32 rate, ~13.9 ms at
// the 67 TFLOP/s FP32 FMA rate used here); the bytes (x, offset, mask, W and
// gout in, the four gradients out, ~1.3 GB there) take ~0.4 ms.  gcols goes
// through device memory, 7.25 GB for the whole batch there.
//
// What the design does about that: the static bound gives grad_x a static
// reach.  Every (tap, output position) whose kept corners can land in a
// 4 x 4 x 4 input brick lies in the (4 + 2Rz) x (4 + 2Ry) x (4 + 2Rx) halo
// around it, the forward's halo brick read the other way (1,000 positions x
// 27 taps at R = 3).  A block owns such a brick x 32 channels and walks the
// taps and halo positions in a fixed order, applying up to 8 corner hits per
// candidate in order (deform_bwd3d.cuh), so no atomics and no data-dependent
// bounds are needed.  gcols, grad_offset / grad_mask and grad_W are the
// shared 3D kernels, with the window on; gcols and the gradients read from
// it run in batch chunks (b_step) that bound its size.  Two runs give the
// same bits.
#include "deform_bwd3d.cuh"

namespace {

using namespace mdc;

__global__ void __launch_bounds__(kPullThreads) gx3_kernel(const float* __restrict__ offset,
                                                           const float* __restrict__ mask,
                                                           const float* __restrict__ gcols, float* __restrict__ gx,
                                                           int Rz, int Ry, int Rx, Geo3 g) {
  __shared__ PullSmem3 sm;
  const int K = taps3(g), HW = g.H * g.W, P = g.D * HW;
  const int Cdg = g.C / g.dg, cchunks = (Cdg + kCW - 1) / kCW;
  const int nbx = bricks(g.W), nby = bricks(g.H);
  const int bz0 = blockIdx.x / (nbx * nby) * kBrick, by0 = blockIdx.x / nbx % nby * kBrick,
            bx0 = blockIdx.x % nbx * kBrick;
  const int d = blockIdx.y / cchunks, c0 = d * Cdg + (blockIdx.y % cchunks) * kCW;
  const int cw = min(kCW, (d + 1) * Cdg - c0);
  const int b = blockIdx.z;
  const int HS = kBrick + 2 * Ry, WS = kBrick + 2 * Rx;  // halo of output positions
  const int halo = (kBrick + 2 * Rz) * HS * WS;
  const float* gcol = gcols + static_cast<size_t>(b) * K * P * g.C + c0;
  pull3_clear(sm);
  const int n_cand = K * halo;
  for (int e0 = 0; e0 < n_cand; e0 += kPullThreads) {
    const int e = e0 + threadIdx.x;
    const int k = e / halo, rem = e % halo;
    const int oz = bz0 - Rz + rem / (HS * WS), oy = by0 - Ry + rem / WS % HS, ox = bx0 - Rx + rem % WS;
    const int p = oz * HW + oy * g.W + ox;
    int n = 0, pix[kHits3];
    float w[kHits3];
    if (e < n_cand && oz >= 0 && oz < g.D && oy >= 0 && oy < g.H && ox >= 0 && ox < g.W)
      n = brick_hits(weights3_at(g, offset, mask, b, d, k, p), bz0, by0, bx0, pix, w);
    pull3_hits(sm, n, pix, w, k * P + p, gcol, KPC{K, P, g.C}, cw);
  }
  pull3_store(sm, gx, g, b, c0, cw, bz0, by0, bx0);
}

}  // namespace

// x (B, C, D, H, W), offset (B, dg*3*K, D, H, W), mask (B, dg*K, D, H, W) or
// null, wk (groups, O/groups, K, C/groups), gout (B, O, D, H, W): float32,
// contiguous, on the current device.  (lo, win) per axis is the
// bounded-offset window; R per axis the halo reach pad + max(-lo, lo+win-1).
// Scratch, allocated by the caller: gcols (b_step, K, D*H*W, C), part
// (splits, groups, C/groups*K, O/groups).  Outputs, each null when not
// wanted: gx like x, goff like offset, gmask like mask, gwt (groups,
// C/groups*K, O/groups).  Needs stride 1 and 2*pad == dilation*(k-1).
// Returns the first CUDA error of the launches, or 0.
extern "C" int shiftblend3d_bwd(const float* x, const float* offset, const float* mask, const float* wk,
                                const float* gout, float* gcols, float* part, float* gx, float* goff, float* gmask,
                                float* gwt, int B, int C, int D, int H, int W, int O, int groups, int dg, int kd,
                                int kh, int kw, int pd, int ph, int pw, int dd, int dh, int dw, int lo_z, int win_z,
                                int lo_y, int win_y, int lo_x, int win_x, int Rz, int Ry, int Rx, int b_step,
                                int splits, int precision, void* stream) {
  using namespace mdc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo3 g{B,  C,  D,  H,  W,  O,  D,  H,    W,     groups, dg,    kd,   kh,    kw, 1, 1,
               1,  pd, ph, pw, dd, dh, dw, 1, lo_z, win_z, lo_y,   win_y, lo_x, win_x, precision};
  const auto pull = [&](const Geo3& gc, const float* off_c, const float* mask_c, const float* gcols_c,
                        float* gx_c) {
    const int Cdg = C / dg;
    const dim3 grid(bricks(D) * bricks(H) * bricks(W), dg * ((Cdg + kCW - 1) / kCW), gc.B);
    gx3_kernel<<<grid, kPullThreads, 0, s>>>(off_c, mask_c, gcols_c, gx_c, Rz, Ry, Rx, gc);
    return cudaGetLastError();
  };
  return static_cast<int>(backward3(g, x, offset, mask, wk, gout, gcols, part, gx, goff, gmask, gwt, b_step,
                                    splits, s, pull));
}

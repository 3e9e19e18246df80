// gathermm3d_bwd: general-offset DCN backward (3D), any stride and dilation.
//
// Replaces the 3D (planar and flat) mode of the TPU kernel
// modulated_deform_conv_tpu/ops/pallas/gathermm.py::_bwd_fused_kernel
// (:1292).  That kernel rebuilds the corner matrix A = F_z F_y F_x of each
// (tile, tap group), visits only the input chunks inside data-dependent
// bounds (planar mode: a lead-plane range x an in-plane chunk range,
// gathermm.py:217-228), and computes gcols = W2^T gout, grad_x += A gcols,
// the correlation M = x gcols^T against dA/dpos (grad_offset) and A
// (grad_mask), and grad_weight += gout cols^T.
//
// What bounds it on the H100: the two products (gcols and grad_W, 14.5
// GFLOP at BASELINE config 3: ~0.029 ms at the 495 TFLOP/s TF32 rate, ~0.22
// ms at the 67 TFLOP/s FP32 FMA rate used here); the bytes (x, offset,
// mask, W and gout in, the four gradients out, ~45 MB there) take ~0.014 ms.
//
// What the design does about that: the 2D pair's five steps
// (gathermm_bwd.cu) with the 3D pieces of deform_bwd3d.cuh.  grad_x is a
// scatter with unbounded reach, turned into a pull: boxes3_kernel keeps, per
// (batch, deformable group, 4 x 4 x 4 output brick), the box [z_lo, z_hi] x
// [y_lo, y_hi] x [x_lo, x_hi] of input voxels its kept corners touch -- the
// Hopper counterpart of the TPU's planar bound table, one step tighter (a
// flat [lo, hi) range would span whole planes, about 7 x 1,024 voxels at
// config 3).  A pull block owns a 4 x 4 x 4 input brick x 32 channels and
// walks, in order, the output bricks whose box meets it: about 27 bricks x
// 27 taps x 64 positions at offsets in [-2, 2].  No float atomics anywhere,
// so two runs give the same bits.
#include "deform_bwd3d.cuh"

namespace {

using namespace mdc;

constexpr int kBoxInts = 6;  // z_lo, z_hi, y_lo, y_hi, x_lo, x_hi (inclusive)

// The first position of brick t of a volume ny x nx bricks per plane.
__device__ __forceinline__ void brick_origin(int t, int ny, int nx, int& z0, int& y0, int& x0) {
  z0 = t / (nx * ny) * kBrick;
  y0 = t / nx % ny * kBrick;
  x0 = t % nx * kBrick;
}

// One warp per (b, d, output brick): the box of the input voxels that the
// kept corners (nonzero mask-folded weight) of its taps and positions touch;
// an empty box has hi < lo.
__global__ void __launch_bounds__(kThreads) boxes3_kernel(const float* __restrict__ offset,
                                                          const float* __restrict__ mask, int* __restrict__ boxes,
                                                          Geo3 g) {
  const int K = taps3(g), OHW = g.OH * g.OW;
  const int nz = bricks(g.OD), ny = bricks(g.OH), nx = bricks(g.OW), NT = nz * ny * nx;
  const int wid = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (wid >= g.B * g.dg * NT) return;
  const int t = wid % NT, d = (wid / NT) % g.dg, b = wid / (NT * g.dg);
  int tz0, ty0, tx0;
  brick_origin(t, ny, nx, tz0, ty0, tx0);
  int lo[3] = {0x7fffffff, 0x7fffffff, 0x7fffffff}, hi[3] = {-1, -1, -1};
  for (int e = lane; e < K * kTP; e += 32) {
    const int k = e / kTP, q = e % kTP;
    const int oz = tz0 + q / 16, oy = ty0 + q / 4 % 4, ox = tx0 + q % 4;
    if (oz >= g.OD || oy >= g.OH || ox >= g.OW) continue;
    const TapWeights3 tw = weights3_at(g, offset, mask, b, d, k, oz * OHW + oy * g.OW + ox);
    const float w[8] = {tw.lo.x, tw.lo.y, tw.lo.z, tw.lo.w, tw.hi.x, tw.hi.y, tw.hi.z, tw.hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (w[i] == 0.f) continue;
      const int c[3] = {tw.z0 + (i >> 2), tw.y0 + ((i >> 1) & 1), tw.x0 + (i & 1)};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = min(lo[a], c[a]);
        hi[a] = max(hi[a], c[a]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo[a] = min(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], o));
      hi[a] = max(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], o));
    }
  }
  if (lane == 0) {
    int* bx = boxes + static_cast<size_t>(wid) * kBoxInts;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      bx[2 * a] = lo[a];
      bx[2 * a + 1] = hi[a];
    }
  }
}

// grad_x of one 4 x 4 x 4 input brick x 32 channels of one (b, deformable
// group), pulled from the output bricks whose box meets it, brick by brick
// and tap by tap in order.
__global__ void __launch_bounds__(kPullThreads) gx3_kernel(const float* __restrict__ offset,
                                                           const float* __restrict__ mask,
                                                           const float* __restrict__ gcols,
                                                           const int* __restrict__ boxes, float* __restrict__ gx,
                                                           Geo3 g) {
  __shared__ PullSmem3 sm;
  const int K = taps3(g), P = out_size3(g), OHW = g.OH * g.OW;
  const int nz = bricks(g.OD), ny = bricks(g.OH), nx = bricks(g.OW), NT = nz * ny * nx;
  const int Cdg = g.C / g.dg, cchunks = (Cdg + kCW - 1) / kCW;
  int bz0, by0, bx0;
  brick_origin(blockIdx.x, bricks(g.H), bricks(g.W), bz0, by0, bx0);
  const int d = blockIdx.y / cchunks, c0 = d * Cdg + (blockIdx.y % cchunks) * kCW;
  const int cw = min(kCW, (d + 1) * Cdg - c0);
  const int b = blockIdx.z;
  const float* gcol = gcols + static_cast<size_t>(b) * K * P * g.C + c0;
  const int* bxs = boxes + (static_cast<size_t>(b) * g.dg + d) * NT * kBoxInts;
  pull3_clear(sm);
  for (int t = 0; t < NT; ++t) {
    const int* bx = bxs + static_cast<size_t>(t) * kBoxInts;
    if (!(bx[0] <= bz0 + kBrick - 1 && bx[1] >= bz0 && bx[2] <= by0 + kBrick - 1 && bx[3] >= by0 &&
          bx[4] <= bx0 + kBrick - 1 && bx[5] >= bx0))
      continue;  // uniform across the block
    int tz0, ty0, tx0;
    brick_origin(t, ny, nx, tz0, ty0, tx0);
    for (int e0 = 0; e0 < K * kTP; e0 += kPullThreads) {
      const int e = e0 + threadIdx.x;
      const int k = e / kTP, q = e % kTP;
      const int oz = tz0 + q / 16, oy = ty0 + q / 4 % 4, ox = tx0 + q % 4;
      const int p = oz * OHW + oy * g.OW + ox;
      int n = 0, pix[kHits3];
      float w[kHits3];
      if (e < K * kTP && oz < g.OD && oy < g.OH && ox < g.OW)
        n = brick_hits(weights3_at(g, offset, mask, b, d, k, p), bz0, by0, bx0, pix, w);
      pull3_hits(sm, n, pix, w, k * P + p, gcol, g.C, cw);
    }
  }
  pull3_store(sm, gx, g, b, c0, cw, bz0, by0, bx0);
}

}  // namespace

// x (B, C, D, H, W), offset (B, dg*3*K, OD, OH, OW), mask (B, dg*K, OD, OH,
// OW) or null, wk (groups, O/groups, K, C/groups), gout (B, O, OD, OH, OW):
// float32, contiguous, on the current device.  Scratch, allocated by the
// caller: gcols (b_step, K, OD*OH*OW, C), boxes (b_step, dg, output bricks,
// 6) int, part (splits, groups, C/groups*K, O/groups).  Outputs, each null
// when not wanted: gx like x, goff like offset, gmask like mask, gwt
// (groups, C/groups*K, O/groups).  Returns the first CUDA error of the
// launches, or 0.
extern "C" int gathermm3d_bwd(const float* x, const float* offset, const float* mask, const float* wk,
                              const float* gout, float* gcols, int* boxes, float* part, float* gx, float* goff,
                              float* gmask, float* gwt, int B, int C, int D, int H, int W, int O, int OD, int OH,
                              int OW, int groups, int dg, int kd, int kh, int kw, int sd, int sh, int sw, int pd,
                              int ph, int pw, int dd, int dh, int dw, int b_step, int splits, int precision,
                              void* stream) {
  using namespace mdc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo3 g{B,  C,  D,  H,  W,  O,  OD, OH, OW, groups, dg, kd, kh, kw, sd, sh,
               sw, pd, ph, pw, dd, dh, dw, 0,  0,  0,      0,  0,  0,  0,  precision};
  const auto pull = [&](const Geo3& gc, const float* off_c, const float* mask_c, const float* gcols_c,
                        float* gx_c) {
    const int NT = bricks(OD) * bricks(OH) * bricks(OW), warps = gc.B * dg * NT;
    boxes3_kernel<<<(warps + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(off_c, mask_c, boxes, gc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int Cdg = C / dg;
    const dim3 grid(bricks(D) * bricks(H) * bricks(W), dg * ((Cdg + kCW - 1) / kCW), gc.B);
    gx3_kernel<<<grid, kPullThreads, 0, s>>>(off_c, mask_c, gcols_c, boxes, gx_c, gc);
    return cudaGetLastError();
  };
  return static_cast<int>(backward3(g, x, offset, mask, wk, gout, gcols, part, gx, goff, gmask, gwt, b_step,
                                    splits, s, pull));
}

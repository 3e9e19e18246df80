// shiftblend3d_fwd: bounded-offset DCN forward (3D, stride 1, output size ==
// input size), gather + grouped GEMM fused.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/shiftblend.py::
// _fwd_kernel_loop (:719), the loop path for 3D windows of more than 640
// (tap, window) pairs, and the 3D use of _fwd_kernel_cols (:627).  Both keep
// the x plane resident in VMEM and blend static shifts of it (the loop path
// rolls the leading window axis into a fori_loop), then fuse out = W2 cols;
// the lead-chunked mode splits a volume too large for VMEM along its leading
// axis.  All three compute the same function, which this kernel computes in
// one launch for the whole volume.
//
// The bounded contract is the 2D kernel's (shiftblend_fwd.cu), per axis:
// with (lo, W) = _axis_window(b), corner c of a tap on axis d is kept only if
// lo <= floor(pos_d) - anchor_d + c <= lo + W - 1.
//
// What bounds it on the H100: x, offset, mask and out once (0.81 GB at
// BASELINE config 4, ~0.24 ms at 3.35 TB/s) against 2 * B * P * O * C/g * K
// FLOPs (464 GFLOP there: ~0.94 ms at the 495 TFLOP/s TF32 rate, ~6.9 ms at
// the 67 TFLOP/s FP32 FMA rate used here).
//
// What the design does about that: the static bound means the input a tile
// needs is known before the offsets are read.  A block owns a 4 x 4 x 4
// brick of output positions x 64 output channels and stages, per 4-channel
// chunk, the halo-extended (4 + 2Rz) x (4 + 2Ry) x (4 + 2Rx) brick of x in
// shared memory, R = pad + the window's farthest row per axis: the Hopper
// counterpart of the resident plane and its static shifts.  A cube is the
// smallest halo for 64 positions (10^3 floats a channel at R = 3, against
// 7 x 14 x 14 for a 1 x 8 x 8 tile).  Shared memory at a 3 x 3 x 3 kernel
// and bound 2: 108 column and weight rows (57 KB), the corner table (27 taps
// x 64 positions x 9 words, 62 KB) and the halo chunk (16 KB), 135 KB: one
// block of 256 threads per SM.  The GEMM part is deform_tile.cuh's.
// Eligibility (Python side) gives C/dg % 8 == 0 and dg % groups == 0, so a
// chunk never straddles a slab or a conv group.
#include "deform_tile3d.cuh"

namespace {

using namespace mdc;

constexpr int kChunk = 4;  // input channels staged per step

__global__ void __launch_bounds__(kThreads) shiftblend3d_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ offset, const float* __restrict__ mask,
    const float* __restrict__ wt, const float* __restrict__ bias, float* __restrict__ out, Geo3 g, int Rz, int Ry,
    int Rx, int rows_cap) {
  extern __shared__ __align__(16) float smem[];
  const int K = taps3(g), HW = g.H * g.W, P = g.D * HW;
  const int Cgc = g.C / g.groups, Og = g.O / g.groups, Cdg = g.C / g.dg;
  const int o_tiles = (Og + kTO - 1) / kTO;
  const int nbx = bricks(g.W), nby = bricks(g.H);
  const int tz0 = blockIdx.x / (nbx * nby) * kBrick, ty0 = blockIdx.x / nbx % nby * kBrick,
            tx0 = blockIdx.x % nbx * kBrick;
  const int gi = blockIdx.y / o_tiles;
  const int o0 = (blockIdx.y % o_tiles) * kTO;
  const int b = blockIdx.z;
  const int DS = kBrick + 2 * Rz, HS = kBrick + 2 * Ry, WS = kBrick + 2 * Rx;  // halo brick
  const int z_org = tz0 - Rz, y_org = ty0 - Ry, x_org = tx0 - Rx;              // its corner in the volume
  const int halo = DS * HS * WS;

  float* colsS = smem;                                                // [rows_cap][kTP]
  float* wS = colsS + rows_cap * kTP;                                 // [rows_cap][kWStride]
  float4* twl = reinterpret_cast<float4*>(wS + rows_cap * kWStride);  // [K][kTP]
  float4* twh = twl + K * kTP;                                        // [K][kTP]
  int* tb = reinterpret_cast<int*>(twh + K * kTP);                    // [K][kTP]
  float* xs = reinterpret_cast<float*>(tb + K * kTP);                 // [kChunk][halo]

  const float* xb = x + static_cast<size_t>(b) * g.C * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[4][4] = {};

  const int spg = g.dg / g.groups;  // deformable-group slabs per conv group
  for (int d = gi * spg; d < (gi + 1) * spg; ++d) {
    __syncthreads();
    for (int e = threadIdx.x; e < K * kTP; e += kThreads) {
      const int k = e / kTP, q = e % kTP;
      const int oz = tz0 + q / 16, oy = ty0 + q / 4 % 4, ox = tx0 + q % 4;
      TapWeights3 t{0, 0, 0, make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
      if (oz < g.D && oy < g.H && ox < g.W) t = weights3_at(g, offset, mask, b, d, k, oz * HW + oy * g.W + ox);
      twl[e] = t.lo;
      twh[e] = t.hi;
      tb[e] = ((t.z0 - z_org) * HS + (t.y0 - y_org)) * WS + (t.x0 - x_org);
    }
    for (int c0 = d * Cdg; c0 < (d + 1) * Cdg; c0 += kChunk) {
      __syncthreads();  // table written; previous chunk done with xs/colsS/wS
      for (int e = threadIdx.x; e < kChunk * halo; e += kThreads) {
        const int cl = e / halo, rem = e % halo;
        const int gz = z_org + rem / (HS * WS), gy = y_org + rem / WS % HS, gx = x_org + rem % WS;
        xs[e] = gz >= 0 && gz < g.D && gy >= 0 && gy < g.H && gx >= 0 && gx < g.W
                    ? xb[static_cast<size_t>(c0 + cl) * P + gz * HW + gy * g.W + gx]
                    : 0.f;
      }
      __syncthreads();
      // Rows of this chunk are cl * K + k; weights rows continue the group's.
      const int R = kChunk * K;
      const float* wt_chunk = wt + (static_cast<size_t>(gi) * Cgc * K + static_cast<size_t>(c0 - gi * Cgc) * K) * Og;
      for (int r0 = 0; r0 < R; r0 += rows_cap) {
        const int rows = min(rows_cap, R - r0);
        if (r0 > 0) __syncthreads();  // previous GEMM done with colsS/wS
        for (int r = warp; r < rows; r += kThreads / 32) {
          const int rr = r0 + r;
          const int k = rr % K;
          const float* xc = xs + (rr / K) * halo;
          for (int p = lane; p < kTP; p += 32) {
            const int e = k * kTP + p;
            colsS[r * kTP + p] = operand(blend3(xc, tb[e], WS, HS * WS, twl[e], twh[e]), g.precision);
          }
        }
        load_weights(wS, wt_chunk + static_cast<size_t>(r0) * Og, rows, Og, o0, g.precision);
        __syncthreads();
        tile_fma(colsS, wS, rows, acc);
      }
    }
  }

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + ty * 4 + i;
    if (o >= Og) continue;
    const int oc = gi * Og + o;
    const float bv = bias ? bias[oc] : 0.f;
    float* oplane = out + (static_cast<size_t>(b) * g.O + oc) * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = tx * 4 + j;
      const int oz = tz0 + q / 16, oy = ty0 + q / 4 % 4, ox = tx0 + q % 4;
      if (oz < g.D && oy < g.H && ox < g.W) oplane[oz * HW + oy * g.W + ox] = acc[i][j] + bv;
    }
  }
}

}  // namespace

// x (B, C, D, H, W), offset (B, dg*3*K, D, H, W), mask (B, dg*K, D, H, W) or
// null, wt (groups, C/groups*K, O/groups), bias (O) or null, out (B, O, D,
// H, W): all float32, contiguous, on the current device.  (lo, win) per axis
// is the bounded-offset window; R per axis the halo reach pad + max(-lo,
// lo+win-1).  Needs stride 1, 2*pad == dilation*(k-1), C/dg % 4 == 0 and
// dg % groups == 0.  Returns cudaGetLastError().
extern "C" int shiftblend3d_fwd(const float* x, const float* offset, const float* mask, const float* wt,
                                const float* bias, float* out, int B, int C, int D, int H, int W, int O, int groups,
                                int dg, int kd, int kh, int kw, int pd, int ph, int pw, int dd, int dh, int dw,
                                int lo_z, int win_z, int lo_y, int win_y, int lo_x, int win_x, int Rz, int Ry, int Rx,
                                int precision, void* stream) {
  using namespace mdc;
  const Geo3 g{B,  C,  D,  H,  W,  O,  D,  H,    W,     groups, dg,    kd,   kh,    kw, 1, 1,
               1,  pd, ph, pw, dd, dh, dw, 1, lo_z, win_z, lo_y,   win_y, lo_x, win_x, precision};
  const int K = taps3(g);
  const int rows_cap = kChunk * K < kRows ? kChunk * K : kRows;
  const size_t halo = static_cast<size_t>(kChunk) * (kBrick + 2 * Rz) * (kBrick + 2 * Ry) * (kBrick + 2 * Rx);
  const size_t smem = smem3_floats(rows_cap, K, halo) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(shiftblend3d_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Og = O / groups;
  const dim3 grid(bricks(D) * bricks(H) * bricks(W), groups * ((Og + kTO - 1) / kTO), B);
  shiftblend3d_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, offset, mask, wt, bias, out, g, Rz, Ry, Rx, rows_cap);
  return static_cast<int>(cudaGetLastError());
}

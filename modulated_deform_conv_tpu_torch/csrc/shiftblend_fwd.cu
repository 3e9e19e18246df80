// shiftblend_fwd: bounded-offset DCN forward (2D, stride 1, output size ==
// input size), gather + grouped GEMM fused.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/shiftblend.py::
// _fwd_kernel_cols (:627).  With |offset| <= b, every corner a tap can reach
// lies in a static window around its anchor, so the TPU kernel keeps the whole
// x plane in VMEM and blends static lane shifts of it (no gathers at all),
// then fuses out = W2 cols per deformable-group slab.
//
// The bounded contract drops corners PER AXIS: with (lo, W) = _axis_window(b),
// corner c of a tap on axis d is kept only if
//     lo <= floor(pos_d) - anchor_d + c <= lo + W - 1,
// and for an integer b the window is 2b+1 rows (the top row carries weight 0
// except in the derivative).  So at b = 2 an offset of 2.5 keeps the low
// corner with weight 0.5 and drops the high one, and an offset of 5 drops the
// tap.  This kernel and its plain version reproduce that exactly.
//
// What bounds it on the H100: the same bytes and FLOPs as gathermm_fwd (62.8
// MB, 7.40 GFLOP at the bench's config 2): the bytes at TF32 (~19 us), the
// 67 TFLOP/s FP32 FMA rate with the plain FMAs used here (~110 us).
//
// What the design does about that: the static bound means the input a tile
// needs is known before the offsets are read, so a block owns an 8 x 8 tile
// of output positions and stages, per 8-channel chunk, a halo-extended
// (8 + 2R) x (8 + 2R) x tile in shared memory, R = pad + max reach of the
// window: the Hopper counterpart of the resident plane and the static shifts.
// Every corner is then read from shared memory through the corner table, and
// x is read from device memory once per tile and chunk, in rows.  The GEMM
// part is gathermm_fwd's (deform_tile.cuh).  Eligibility (Python side) gives
// C/dg % 8 == 0 and dg % groups == 0, so a chunk never straddles a slab or a
// conv group.
#include "deform_tile.cuh"

namespace {

using namespace mdc;

constexpr int kTH = 8, kTW = 8;  // output tile: kTH x kTW == kTP positions
constexpr int kChunk = 8;        // input channels staged per step

__global__ void __launch_bounds__(kThreads) shiftblend_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, const float* __restrict__ wt,
    const float* __restrict__ bias, float* __restrict__ out, int C, int H,
    int W, int O, int groups, int dg, int kh, int kw, int ph, int pw, int dh,
    int dw, int lo_y, int win_y, int lo_x, int win_x, int Ry, int Rx,
    int rows_cap, int precision) {
  extern __shared__ __align__(16) float smem[];
  const int K = kh * kw, P = H * W;
  const int Cgc = C / groups, Og = O / groups, Cdg = C / dg;
  const int o_tiles = (Og + kTO - 1) / kTO;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int ty0 = (blockIdx.x / tiles_x) * kTH, tx0 = (blockIdx.x % tiles_x) * kTW;
  const int gi = blockIdx.y / o_tiles;
  const int o0 = (blockIdx.y % o_tiles) * kTO;
  const int b = blockIdx.z;
  const int HS = kTH + 2 * Ry, WS = kTW + 2 * Rx;  // halo tile
  const int y_org = ty0 - Ry, x_org = tx0 - Rx;     // its top-left in the image

  float* colsS = smem;                                              // [rows_cap][kTP]
  float* wS = colsS + rows_cap * kTP;                               // [rows_cap][kWStride]
  float4* tw = reinterpret_cast<float4*>(wS + rows_cap * kWStride);  // [K][kTP]
  int* tb = reinterpret_cast<int*>(tw + K * kTP);                   // [K][kTP]
  float* xs = reinterpret_cast<float*>(tb + K * kTP);               // [kChunk][HS*WS]

  const float* xb = x + static_cast<size_t>(b) * C * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[4][4] = {};

  const int spg = dg / groups;  // deformable-group slabs per conv group
  for (int d = gi * spg; d < (gi + 1) * spg; ++d) {
    __syncthreads();
    for (int e = threadIdx.x; e < K * kTP; e += kThreads) {
      const int k = e / kTP, p = e % kTP;
      const int oy = ty0 + p / kTW, ox = tx0 + p % kTW;
      TapWeights t{0, 0, make_float4(0.f, 0.f, 0.f, 0.f)};
      if (oy < H && ox < W) {
        const int ky = k / kw, kx = k % kw;
        const int q = oy * W + ox;
        const size_t oidx = (static_cast<size_t>(b) * dg * 2 * K + static_cast<size_t>(d) * 2 * K + 2 * k) * P + q;
        const float m = mask ? mask[(static_cast<size_t>(b) * dg * K + static_cast<size_t>(d) * K + k) * P + q] : 1.f;
        t = tap_weights(oy - ph + ky * dh, ox - pw + kx * dw, offset[oidx], offset[oidx + P], m, H, W, true, lo_y,
                        win_y, lo_x, win_x);
      }
      tw[e] = t.w;
      tb[e] = (t.y0 - y_org) * WS + (t.x0 - x_org);
    }
    for (int c0 = d * Cdg; c0 < (d + 1) * Cdg; c0 += kChunk) {
      __syncthreads();  // table written; previous chunk done with xs/colsS/wS
      for (int e = threadIdx.x; e < kChunk * HS * WS; e += kThreads) {
        const int cl = e / (HS * WS), rem = e % (HS * WS);
        const int gy = y_org + rem / WS, gx = x_org + rem % WS;
        xs[e] = gy >= 0 && gy < H && gx >= 0 && gx < W
                    ? xb[static_cast<size_t>(c0 + cl) * P + gy * W + gx] : 0.f;
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
          const float* xc = xs + (rr / K) * HS * WS;
          for (int p = lane; p < kTP; p += 32)
            colsS[r * kTP + p] = operand(blend(xc, tb[k * kTP + p], WS, tw[k * kTP + p]), precision);
        }
        load_weights(wS, wt_chunk + static_cast<size_t>(r0) * Og, rows, Og, o0, precision);
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
    float* oplane = out + (static_cast<size_t>(b) * O + oc) * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx * 4 + j;
      const int oy = ty0 + p / kTW, ox = tx0 + p % kTW;
      if (oy < H && ox < W) oplane[oy * W + ox] = acc[i][j] + bv;
    }
  }
}

}  // namespace

// x (B, C, H, W), offset (B, dg*2*K, H, W), mask (B, dg*K, H, W) or null,
// wt (groups, C/groups*K, O/groups), bias (O) or null, out (B, O, H, W): all
// float32, contiguous, on the current device.  (lo, win) per axis is the
// bounded-offset window; R per axis the halo reach pad + max(-lo, lo+win-1).
// Needs stride 1, 2*pad == dilation*(k-1), C/dg % 8 == 0, dg % groups == 0.
// Returns cudaGetLastError().
extern "C" int shiftblend_fwd(const float* x, const float* offset,
                              const float* mask, const float* wt,
                              const float* bias, float* out, int B, int C,
                              int H, int W, int O, int groups, int dg, int kh,
                              int kw, int ph, int pw, int dh, int dw, int lo_y,
                              int win_y, int lo_x, int win_x, int Ry, int Rx,
                              int precision, void* stream) {
  using namespace mdc;
  const int K = kh * kw;
  const int rows_cap = kChunk * K < kRows ? kChunk * K : kRows;
  const size_t halo = static_cast<size_t>(kChunk) * (kTH + 2 * Ry) * (kTW + 2 * Rx);
  const size_t smem = smem_floats(rows_cap, K, halo) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      shiftblend_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Og = O / groups;
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), groups * ((Og + kTO - 1) / kTO), B);
  shiftblend_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, offset, mask, wt, bias, out, C, H, W, O, groups, dg, kh, kw, ph, pw,
      dh, dw, lo_y, win_y, lo_x, win_x, Ry, Rx, rows_cap, precision);
  return static_cast<int>(cudaGetLastError());
}

// Pieces shared by the two forward kernels (gathermm_fwd.cu, shiftblend_fwd.cu).
//
// Both kernels have one shape.  A block owns a tile of kTP output positions x
// kTO output channels of ONE conv group.  It walks the input channels of that
// group in deformable-group slabs: per slab it builds a corner table in shared
// memory (for every (tap, position) of the tile the flat index of the low
// corner and the four corner weights, with the tap gate, the in-image checks
// and the mask folded in), then, chunk by chunk, it fills a
// (rows = channel x tap, kTP) column tile from that table and multiplies it
// against the matching (rows, kTO) weight slab with fp32 accumulation in
// registers.  The sum over the slabs of a group happens in that loop, so no
// partial result ever goes to device memory; bias is added in fp32 at the end.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mdc {

constexpr int kTP = 64;            // output positions per block
constexpr int kTO = 64;            // output channels per block (one conv group)
constexpr int kWStride = kTO + 4;  // padded weight-tile row: spreads banks, keeps 16-byte rows
constexpr int kRows = 128;         // most (channel, tap) rows staged per step
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr size_t kMaxSmem = 227 * 1024;

// Precision modes, as the Python wrappers number them.
enum Precision : int { kFloat32 = 0, kTensorFloat32 = 1, kBFloat16 = 2 };

// GEMM operand as the mode sees it: "bfloat16" rounds columns and weights to
// bf16 (their products are exact in fp32); the other two modes keep fp32.
__device__ __forceinline__ float operand(float v, int precision) {
  return precision == kBFloat16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Corner weights of one tap at one output position.
//   pos = base + off per axis, in fp32 like the reference;
//   the whole tap is zero unless -1 < pos < S on both axes;
//   a corner outside the image contributes zero;
//   with `windowed`, the bounded-offset contract also drops, per axis, the
//   corner c unless lo <= floor(pos) - base + c <= lo + win - 1.
// w[2*cy + cx] weighs corner (y0 + cy, x0 + cx); the mask is folded in.
struct TapWeights {
  int y0, x0;
  float4 w;
};

__device__ __forceinline__ TapWeights tap_weights(
    int base_y, int base_x, float off_y, float off_x, float m, int H, int W,
    bool windowed, int lo_y, int win_y, int lo_x, int win_x) {
  TapWeights t;
  t.y0 = 0;
  t.x0 = 0;
  t.w = make_float4(0.f, 0.f, 0.f, 0.f);
  const float py = static_cast<float>(base_y) + off_y;
  const float px = static_cast<float>(base_x) + off_x;
  if (!(py > -1.f && py < static_cast<float>(H) && px > -1.f &&
        px < static_cast<float>(W)))
    return t;
  const float fy = floorf(py), fx = floorf(px);
  const float ry = py - fy, rx = px - fx;
  t.y0 = static_cast<int>(fy);
  t.x0 = static_cast<int>(fx);
  bool ky[2], kx[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    ky[c] = t.y0 + c >= 0 && t.y0 + c <= H - 1;
    kx[c] = t.x0 + c >= 0 && t.x0 + c <= W - 1;
    if (windowed) {
      const float rel_y = fy - static_cast<float>(base_y) + c;
      const float rel_x = fx - static_cast<float>(base_x) + c;
      ky[c] = ky[c] && rel_y >= lo_y && rel_y <= lo_y + win_y - 1;
      kx[c] = kx[c] && rel_x >= lo_x && rel_x <= lo_x + win_x - 1;
    }
  }
  const float wy[2] = {1.f - ry, ry};
  const float wx[2] = {1.f - rx, rx};
  t.w.x = ky[0] && kx[0] ? wy[0] * wx[0] * m : 0.f;
  t.w.y = ky[0] && kx[1] ? wy[0] * wx[1] * m : 0.f;
  t.w.z = ky[1] && kx[0] ? wy[1] * wx[0] * m : 0.f;
  t.w.w = ky[1] && kx[1] ? wy[1] * wx[1] * m : 0.f;
  return t;
}

// One column value: the four weighted corners around src[i0], with row
// pitch `pitch`.  A corner with weight 0 is not read, so its address may lie
// outside the source.
__device__ __forceinline__ float blend(const float* __restrict__ src, int i0,
                                       int pitch, float4 w) {
  float v = 0.f;
  if (w.x != 0.f) v += w.x * src[i0];
  if (w.y != 0.f) v += w.y * src[i0 + 1];
  if (w.z != 0.f) v += w.z * src[i0 + pitch];
  if (w.w != 0.f) v += w.w * src[i0 + pitch + 1];
  return v;
}

// Stage `rows` rows of the weight slab: wS[r][o] = wt_rows[r * Og + o0 + o],
// zero past the group's Og output channels.  wt_rows points at the first
// row, in the (groups, C/groups * K, Og) layout the wrappers prepare.
__device__ __forceinline__ void load_weights(float* __restrict__ wS,
                                             const float* __restrict__ wt_rows,
                                             int rows, int Og, int o0,
                                             int precision) {
  for (int e = threadIdx.x; e < rows * kTO; e += kThreads) {
    const int r = e / kTO, o = e % kTO;
    const float v = o0 + o < Og ? wt_rows[static_cast<size_t>(r) * Og + o0 + o] : 0.f;
    wS[r * kWStride + o] = operand(v, precision);
  }
}

// acc[i][j] += sum_r wS[r][ty*4 + i] * colsS[r][tx*4 + j].
__device__ __forceinline__ void tile_fma(const float* __restrict__ colsS,
                                         const float* __restrict__ wS, int rows,
                                         float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* cp = colsS + tx * 4;
  const float* wp = wS + ty * 4;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(wp + r * kWStride);
    const float4 b = *reinterpret_cast<const float4*>(cp + r * kTP);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Shared memory of one block, in floats: column tile, weight tile, corner
// table (float4 weights + int index per (tap, position)), then `extra`.
__host__ __device__ inline size_t smem_floats(int rows_cap, int K, size_t extra) {
  return static_cast<size_t>(rows_cap) * kTP + static_cast<size_t>(rows_cap) * kWStride +
         static_cast<size_t>(K) * kTP * 5 + extra;
}

}  // namespace mdc

// Corner rules and constants shared by the kernels.
//
// The corner rules (tap_corners, tap_weights, weights_at, tap_grad) are the
// function every 2D kernel computes; `blend` applies them to one column
// value (the column kernels).  The products run on tensor cores
// (deform_mma.cuh).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mdc {

constexpr int kTP = 64;        // output positions of a tile (a 4 x 4 x 4 brick in 3D)
constexpr int kThreads = 256;  // threads of the corner-box and per-position correlation kernels
constexpr size_t kMaxSmem = 227 * 1024;

// Precision modes, as the Python wrappers number them.
enum Precision : int { kFloat32 = 0, kTensorFloat32 = 1, kBFloat16 = 2 };

// The activations' type (x, offset, mask, grad_out, out and the gradients of
// the first three): float (io 0, lib.IO_CODES) or __nv_bfloat16 (io 1), as
// the JAX kernels read their inputs in their own dtype.  Every load
// converts to fp32 at once (exact); every sum and scratch buffer stays fp32;
// a result is rounded to T (round to nearest even) only where it is stored.
__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T to_elem(float v);
template <>
__device__ __forceinline__ float to_elem<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_elem<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The C entries' dispatch on io: f(IoType<T>{}) with T float or bf16.
template <typename T>
struct IoType {
  using type = T;
};
template <class F>
inline auto with_io(int io, F&& f) {
  return io ? f(IoType<__nv_bfloat16>{}) : f(IoType<float>{});
}

// GEMM operand as the mode sees it: "bfloat16" rounds columns and weights to
// bf16 (their products are exact in fp32); the other two modes keep fp32.
__device__ __forceinline__ float operand(float v, int precision) {
  return precision == kBFloat16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Geometry of one call, passed by value to every kernel.  (gy0, gy1) and
// (gx0, gx1) are the tap gate per axis: (-1, H) and (-1, W), or, for a
// sharded block, the global image border in the block's coordinates, with
// -1 <= lo < hi <= S per axis (the host checks it).  shy / ory (shx / orx)
// place a sharded block in the whole input: a tap's position is taken in
// the whole input's coordinates, (base + sh) + off, rounded as the
// unsharded op rounds it; the gate is compared there (the host passes it
// moved by the origin), and only the integer low corner moves to the
// block's, floor - or; 0 and 0 for a whole input.
struct Geo {
  int B, C, H, W, O, OH, OW, groups, dg, kh, kw, sh, sw, ph, pw, dh, dw;
  int windowed, lo_y, win_y, lo_x, win_x;
  int precision;
  float gy0, gy1, gx0, gx1;
  float shy, ory, shx, orx;
};

// The shift, in rows of the block, from an output row to the centre of the
// rows its taps' kept corners can reach under the bounded contract (a tap's
// reach spans dil * (k - 1) rows, 2 * pad == dil * (k - 1) on the whole
// input): (sh - or) - pad + dil * (k - 1) / 2, 0 on a whole input.  The
// shift-blend halo tile and its pull are centred by it.
__host__ __device__ inline int reach_shift(float sh, float origin, int pad, int k, int dil) {
  return static_cast<int>(sh - origin) - pad + dil * (k - 1) / 2;
}

// The four bilinear corners of one tap at one output position.
//   pos = base + off per axis, in fp32 like the reference (on a sharded
//   block in the whole input's coordinates: Geo);
//   the whole tap is closed unless g0 < pos < g1 on both axes (the gate,
//   Geo's (gy0, gy1) and (gx0, gx1));
//   a corner outside the image (the block) is dropped;
//   with `windowed`, a corner is kept only inside the gate (on a sharded
//   block: inside the whole input's image, as the shift-blend op checks its
//   corners; the gate lies inside the block, and on a whole input its
//   (-1, S) keeps what the image keeps), and the bounded-offset contract
//   drops, per axis, the corner c unless lo <= floor(pos) - anchor + c <=
//   lo + win - 1, the anchor base + sh taken in the whole input.
// keep bit 2*cy + cx says whether corner (y0 + cy, x0 + cx) is kept.
struct TapCorners {
  int y0, x0;
  float ry, rx;  // pos - floor(pos) per axis
  int keep;      // 0 when the gate is closed
};

__device__ __forceinline__ TapCorners tap_corners(const Geo& g, int base_y,
                                                  int base_x, float off_y,
                                                  float off_x) {
  TapCorners t{0, 0, 0.f, 0.f, 0};
  const float py = (static_cast<float>(base_y) + g.shy) + off_y;
  const float px = (static_cast<float>(base_x) + g.shx) + off_x;
  if (!(py > g.gy0 && py < g.gy1 && px > g.gx0 && px < g.gx1)) return t;
  const float fy = floorf(py), fx = floorf(px);
  t.ry = py - fy;
  t.rx = px - fx;
  t.y0 = static_cast<int>(fy - g.ory);
  t.x0 = static_cast<int>(fx - g.orx);
  bool ky[2], kx[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (g.windowed) {
      const float rel_y = fy - (static_cast<float>(base_y) + g.shy) + c;
      const float rel_x = fx - (static_cast<float>(base_x) + g.shx) + c;
      ky[c] = fy + c > g.gy0 && fy + c < g.gy1 && rel_y >= g.lo_y && rel_y <= g.lo_y + g.win_y - 1;
      kx[c] = fx + c > g.gx0 && fx + c < g.gx1 && rel_x >= g.lo_x && rel_x <= g.lo_x + g.win_x - 1;
    } else {
      ky[c] = t.y0 + c >= 0 && t.y0 + c <= g.H - 1;
      kx[c] = t.x0 + c >= 0 && t.x0 + c <= g.W - 1;
    }
  }
  t.keep = (ky[0] && kx[0]) | (ky[0] && kx[1]) << 1 | (ky[1] && kx[0]) << 2 |
           (ky[1] && kx[1]) << 3;
  return t;
}

// Corner weights of one tap at one output position: w[2*cy + cx] weighs
// corner (y0 + cy, x0 + cx), zero where the corner is dropped; the mask is
// folded in.  keep: the kept corners, as tap_corners gives them.
struct TapWeights {
  int y0, x0;
  float4 w;
  int keep;
};

__device__ __forceinline__ TapWeights tap_weights(const Geo& g, int base_y,
                                                  int base_x, float off_y,
                                                  float off_x, float m) {
  const TapCorners c = tap_corners(g, base_y, base_x, off_y, off_x);
  const float wy0 = 1.f - c.ry, wx0 = 1.f - c.rx;
  TapWeights t;
  t.y0 = c.y0;
  t.x0 = c.x0;
  t.w.x = c.keep & 1 ? wy0 * wx0 * m : 0.f;
  t.w.y = c.keep & 2 ? wy0 * c.rx * m : 0.f;
  t.w.z = c.keep & 4 ? c.ry * wx0 * m : 0.f;
  t.w.w = c.keep & 8 ? c.ry * c.rx * m : 0.f;
  t.keep = c.keep;
  return t;
}

template <typename T>
__device__ __forceinline__ float mask_at(const Geo& g, const T* __restrict__ mask, int b, int d, int k, int p) {
  const int K = g.kh * g.kw, P = g.OH * g.OW;
  return mask ? as_float(mask[(static_cast<size_t>(b) * g.dg * K + static_cast<size_t>(d) * K + k) * P + p]) : 1.f;
}

// Mask-folded corner weights of tap k at output position p (tap_weights).
template <typename T>
__device__ __forceinline__ TapWeights weights_at(const Geo& g, const T* __restrict__ offset,
                                                 const T* __restrict__ mask, int b, int d, int k, int p) {
  const int K = g.kh * g.kw, P = g.OH * g.OW;
  const int oy = p / g.OW, ox = p % g.OW, ky = k / g.kw, kx = k % g.kw;
  const size_t oidx = (static_cast<size_t>(b) * g.dg * 2 * K + static_cast<size_t>(d) * 2 * K + 2 * k) * P + p;
  return tap_weights(g, oy * g.sh - g.ph + ky * g.dh, ox * g.sw - g.pw + kx * g.dw, as_float(offset[oidx]),
                     as_float(offset[oidx + P]), mask_at(g, mask, b, d, k, p));
}

// The corner weights without the mask, and their derivatives with respect
// to the sampling position, per axis and per corner.  The gate carries no
// derivative, and a dropped corner (outside the image, or outside the
// window) is zero in value and in derivative.  Since ry = pos - floor(pos)
// and floor is locally constant from the right, d(ry)/d(pos) = 1 holds at
// an integer position too: the derivative there is the exact
// right-derivative.  The mask stays out, so that
// grad_mask = sum_c gcol * (unmasked sampled value) is exact where it is 0.
struct TapGrad {
  int y0, x0, keep;
  float4 w, dy, dx;
};

__device__ __forceinline__ TapGrad tap_grad(const Geo& g, int base_y,
                                            int base_x, float off_y,
                                            float off_x) {
  const TapCorners c = tap_corners(g, base_y, base_x, off_y, off_x);
  const float wy[2] = {1.f - c.ry, c.ry}, dwy[2] = {-1.f, 1.f};
  const float wx[2] = {1.f - c.rx, c.rx}, dwx[2] = {-1.f, 1.f};
  float w[4], dy[4], dx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool k = c.keep >> i & 1;
    const int cy = i >> 1, cx = i & 1;
    w[i] = k ? wy[cy] * wx[cx] : 0.f;
    dy[i] = k ? dwy[cy] * wx[cx] : 0.f;
    dx[i] = k ? wy[cy] * dwx[cx] : 0.f;
  }
  return TapGrad{c.y0, c.x0, c.keep, make_float4(w[0], w[1], w[2], w[3]),
                 make_float4(dy[0], dy[1], dy[2], dy[3]),
                 make_float4(dx[0], dx[1], dx[2], dx[3])};
}

// One column value: the four weighted corners around src[i0], with row
// pitch `pitch`.  A corner with weight 0 is not read, so its address may lie
// outside the source.
template <typename T>
__device__ __forceinline__ float blend(const T* __restrict__ src, int i0, int pitch, float4 w) {
  float v = 0.f;
  if (w.x != 0.f) v += w.x * as_float(src[i0]);
  if (w.y != 0.f) v += w.y * as_float(src[i0 + 1]);
  if (w.z != 0.f) v += w.z * as_float(src[i0 + pitch]);
  if (w.w != 0.f) v += w.w * as_float(src[i0 + pitch + 1]);
  return v;
}

}  // namespace mdc

// The 3D corner rules: trilinear counterparts of deform_tile.cuh's
// tap_corners / tap_weights / tap_grad / blend, used by the 3D kernels
// (shiftblend3d_*.cu, gathermm3d_*.cu) and by the tensor-core kernels that
// are written once for both ranks (deform_fwd.cuh, gw_mma_kernel).
#pragma once

#include <type_traits>

#include "deform_tile.cuh"

namespace mdc {

// Geometry of one 3D call, passed by value to every 3D kernel.  Axis order
// is (z, y, x) = the input's (D, H, W); (lo, win) per axis is the
// bounded-offset window when `windowed`; (g*0, g*1) per axis is the tap
// gate and sh* / or* the block's placement, as Geo's.
struct Geo3 {
  int B, C, D, H, W, O, OD, OH, OW, groups, dg;
  int kd, kh, kw, sd, sh, sw, pd, ph, pw, dd, dh, dw;
  int windowed, lo_z, win_z, lo_y, win_y, lo_x, win_x;
  int precision;
  float gz0, gz1, gy0, gy1, gx0, gx1;
  float shz, orz, shy, ory, shx, orx;
};

__host__ __device__ inline int taps3(const Geo3& g) { return g.kd * g.kh * g.kw; }
__host__ __device__ inline int out_size3(const Geo3& g) { return g.OD * g.OH * g.OW; }

// The eight trilinear corners of one tap at one output position.
//   pos = base + off per axis, in fp32 like the reference;
//   the whole tap is closed unless g0 < pos < g1 on all three axes (the
//   gate, Geo3's);
//   a corner outside the volume (the block) is dropped;
//   with `windowed`, the bounded-offset contract also drops, per axis, the
//   corner c unless lo <= floor(pos) - anchor + c <= lo + win - 1 and the
//   corner lies inside the gate, as tap_corners (deform_tile.cuh) keeps
//   them.
// keep bit 4*cz + 2*cy + cx says whether corner (z0+cz, y0+cy, x0+cx) is kept.
struct TapCorners3 {
  int z0, y0, x0;
  float rz, ry, rx;  // pos - floor(pos) per axis
  int keep;          // 0 when the gate is closed
};

// Is corner c of an axis kept: its index i0 + c in the volume (i0 the low
// corner's, in the block's coordinates), or with `windowed` floor(pos) + c
// inside the gate (g0, g1), which lies inside the block, and its place
// floor(pos) - (base + sh) + c in the window, both in the whole input's
// coordinates.
__device__ __forceinline__ bool axis_keeps(float fl, int i0, int base, float sh, int c, int S, bool windowed,
                                           int lo, int win, float g0, float g1) {
  if (windowed) {
    const float rel = fl - (static_cast<float>(base) + sh) + c;
    return fl + c > g0 && fl + c < g1 && rel >= lo && rel <= lo + win - 1;
  }
  return i0 + c >= 0 && i0 + c <= S - 1;
}

__device__ __forceinline__ TapCorners3 tap_corners3(const Geo3& g, int bz, int by, int bx, float off_z, float off_y,
                                                    float off_x) {
  TapCorners3 t{0, 0, 0, 0.f, 0.f, 0.f, 0};
  const float pz = (static_cast<float>(bz) + g.shz) + off_z;
  const float py = (static_cast<float>(by) + g.shy) + off_y;
  const float px = (static_cast<float>(bx) + g.shx) + off_x;
  if (!(pz > g.gz0 && pz < g.gz1 && py > g.gy0 && py < g.gy1 && px > g.gx0 && px < g.gx1)) return t;
  const float fz = floorf(pz), fy = floorf(py), fx = floorf(px);
  t.rz = pz - fz;
  t.ry = py - fy;
  t.rx = px - fx;
  t.z0 = static_cast<int>(fz - g.orz);
  t.y0 = static_cast<int>(fy - g.ory);
  t.x0 = static_cast<int>(fx - g.orx);
  const bool w = g.windowed != 0;
  bool kz[2], ky[2], kx[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    kz[c] = axis_keeps(fz, t.z0, bz, g.shz, c, g.D, w, g.lo_z, g.win_z, g.gz0, g.gz1);
    ky[c] = axis_keeps(fy, t.y0, by, g.shy, c, g.H, w, g.lo_y, g.win_y, g.gy0, g.gy1);
    kx[c] = axis_keeps(fx, t.x0, bx, g.shx, c, g.W, w, g.lo_x, g.win_x, g.gx0, g.gx1);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) t.keep |= (kz[i >> 2] && ky[(i >> 1) & 1] && kx[i & 1]) << i;
  return t;
}

// Offset and mask of tap k at output position p (flat over OD x OH x OW) of
// deformable group d, and the tap's sampling base.  Offset channels are
// d * 3K + 3k + axis, axis 0 = z.
struct TapAt3 {
  int bz, by, bx;
  float oz, oy, ox, m;
};

// The sampling base of tap k at output position p, per axis.
__device__ __forceinline__ void tap_base3(const Geo3& g, int k, int p, int& bz, int& by, int& bx) {
  const int ozp = p / (g.OH * g.OW), oyp = (p / g.OW) % g.OH, oxp = p % g.OW;
  const int kz = k / (g.kh * g.kw), ky = (k / g.kw) % g.kh, kx = k % g.kw;
  bz = ozp * g.sd - g.pd + kz * g.dd;
  by = oyp * g.sh - g.ph + ky * g.dh;
  bx = oxp * g.sw - g.pw + kx * g.dw;
}

template <typename T>
__device__ __forceinline__ TapAt3 tap_at3(const Geo3& g, const T* __restrict__ offset, const T* __restrict__ mask,
                                          int b, int d, int k, int p) {
  const int K = taps3(g), P = out_size3(g);
  const size_t oidx = (static_cast<size_t>(b) * g.dg * 3 * K + static_cast<size_t>(d) * 3 * K + 3 * k) * P + p;
  TapAt3 t;
  tap_base3(g, k, p, t.bz, t.by, t.bx);
  t.oz = as_float(offset[oidx]);
  t.oy = as_float(offset[oidx + P]);
  t.ox = as_float(offset[oidx + 2 * static_cast<size_t>(P)]);
  t.m = mask ? as_float(mask[(static_cast<size_t>(b) * g.dg * K + static_cast<size_t>(d) * K + k) * P + p]) : 1.f;
  return t;
}

// Corner weights of one tap at one output position, the mask folded in:
// lo weighs the four corners of plane z0 ((y0, x0), (y0, x0+1), (y0+1, x0),
// (y0+1, x0+1)), hi those of plane z0 + 1; zero where the corner is dropped.
// keep: the kept corners, as tap_corners3 gives them.
struct TapWeights3 {
  int z0, y0, x0;
  float4 lo, hi;
  int keep;
};

// From the tap's base, offsets and mask (tap_at3's fields).
__device__ __forceinline__ TapWeights3 tap_weights3(const Geo3& g, int bz, int by, int bx, float oz, float oy,
                                                    float ox, float m) {
  const TapCorners3 c = tap_corners3(g, bz, by, bx, oz, oy, ox);
  const float wz[2] = {1.f - c.rz, c.rz}, wy[2] = {1.f - c.ry, c.ry}, wx[2] = {1.f - c.rx, c.rx};
  float w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = c.keep >> i & 1 ? wz[i >> 2] * wy[(i >> 1) & 1] * wx[i & 1] * m : 0.f;
  return TapWeights3{c.z0, c.y0, c.x0, make_float4(w[0], w[1], w[2], w[3]), make_float4(w[4], w[5], w[6], w[7]),
                     c.keep};
}

template <typename T>
__device__ __forceinline__ TapWeights3 weights3_at(const Geo3& g, const T* __restrict__ offset,
                                                   const T* __restrict__ mask, int b, int d, int k, int p) {
  const TapAt3 a = tap_at3(g, offset, mask, b, d, k, p);
  return tap_weights3(g, a.bz, a.by, a.bx, a.oz, a.oy, a.ox, a.m);
}

// The corner weights without the mask, and their derivatives with respect
// to the sampling position per axis, as tap_grad in 2D: the gate carries no
// derivative, a dropped corner is zero in value and derivative, and at an
// integer position the derivative is the exact right-derivative.  m is the
// tap's mask (1 without one), kept apart so that grad_mask is exact at 0.
struct TapGrad3 {
  int z0, y0, x0, keep;
  float m;
  float w[8], dz[8], dy[8], dx[8];
};

template <typename T>
__device__ __forceinline__ TapGrad3 grad3_at(const Geo3& g, const T* __restrict__ offset,
                                             const T* __restrict__ mask, int b, int d, int k, int p) {
  const TapAt3 a = tap_at3(g, offset, mask, b, d, k, p);
  const TapCorners3 c = tap_corners3(g, a.bz, a.by, a.bx, a.oz, a.oy, a.ox);
  const float wz[2] = {1.f - c.rz, c.rz}, wy[2] = {1.f - c.ry, c.ry}, wx[2] = {1.f - c.rx, c.rx};
  const float dw[2] = {-1.f, 1.f};
  TapGrad3 t;
  t.z0 = c.z0;
  t.y0 = c.y0;
  t.x0 = c.x0;
  t.keep = c.keep;
  t.m = a.m;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool kept = c.keep >> i & 1;
    const int cz = i >> 2, cy = (i >> 1) & 1, cx = i & 1;
    t.w[i] = kept ? wz[cz] * wy[cy] * wx[cx] : 0.f;
    t.dz[i] = kept ? dw[cz] * wy[cy] * wx[cx] : 0.f;
    t.dy[i] = kept ? wz[cz] * dw[cy] * wx[cx] : 0.f;
    t.dx[i] = kept ? wz[cz] * wy[cy] * dw[cx] : 0.f;
  }
  return t;
}

// Flat offset of corner i from the low corner, for row pitch py and plane
// pitch pz.
__device__ __forceinline__ int corner_step3(int i, int py, int pz) {
  return (i >> 2) * pz + ((i >> 1) & 1) * py + (i & 1);
}

// One column value: the eight weighted corners around src[i0].  A corner
// with weight 0 is not read, so its address may lie outside the source.
template <typename T>
__device__ __forceinline__ float blend3(const T* __restrict__ src, int i0, int py, int pz, float4 lo, float4 hi) {
  float v = 0.f;
  if (lo.x != 0.f) v += lo.x * as_float(src[i0]);
  if (lo.y != 0.f) v += lo.y * as_float(src[i0 + 1]);
  if (lo.z != 0.f) v += lo.z * as_float(src[i0 + py]);
  if (lo.w != 0.f) v += lo.w * as_float(src[i0 + py + 1]);
  if (hi.x != 0.f) v += hi.x * as_float(src[i0 + pz]);
  if (hi.y != 0.f) v += hi.y * as_float(src[i0 + pz + 1]);
  if (hi.z != 0.f) v += hi.z * as_float(src[i0 + pz + py]);
  if (hi.w != 0.f) v += hi.w * as_float(src[i0 + pz + py + 1]);
  return v;
}

// A 4 x 4 x 4 brick of positions: the 3D kernels' tile of kTP positions.
constexpr int kBrick = 4;

__host__ __device__ inline int bricks(int n) { return (n + kBrick - 1) / kBrick; }

// ---- either rank -------------------------------------------------------------
//
// For the kernels written once for 2D and 3D (deform_fwd.cuh, gw_mma_kernel):
// taps, output and input positions a sample, and the corner weights of a
// tap: one float4 in 2D (corners (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1,
// x0+1)), two in 3D (those of planes z0 and z0 + 1).
template <class G>
constexpr bool kIs3D = std::is_same<G, Geo3>::value;
template <class G>
constexpr int kPlanes = kIs3D<G> ? 2 : 1;

__host__ __device__ inline int taps(const Geo& g) { return g.kh * g.kw; }
__host__ __device__ inline int taps(const Geo3& g) { return taps3(g); }
__host__ __device__ inline int out_positions(const Geo& g) { return g.OH * g.OW; }
__host__ __device__ inline int out_positions(const Geo3& g) { return out_size3(g); }
__host__ __device__ inline int in_positions(const Geo& g) { return g.H * g.W; }
__host__ __device__ inline int in_positions(const Geo3& g) { return g.D * g.H * g.W; }

// Mask-folded corner weights of tap k at output position p of sample b,
// deformable group d, and the low corner's row in x channels-last, (B *
// input positions, C).
template <class G>
struct CornerRow {
  float4 w[kPlanes<G>];
  int row;
};

template <typename T>
__device__ __forceinline__ CornerRow<Geo> corner_row(const Geo& g, const T* __restrict__ offset,
                                                     const T* __restrict__ mask, int b, int d, int k, int p) {
  const TapWeights t = weights_at(g, offset, mask, b, d, k, p);
  return CornerRow<Geo>{{t.w}, b * in_positions(g) + t.y0 * g.W + t.x0};
}

template <typename T>
__device__ __forceinline__ CornerRow<Geo3> corner_row(const Geo3& g, const T* __restrict__ offset,
                                                      const T* __restrict__ mask, int b, int d, int k, int p) {
  const TapWeights3 t = weights3_at(g, offset, mask, b, d, k, p);
  return CornerRow<Geo3>{{t.lo, t.hi}, b * in_positions(g) + (t.z0 * g.H + t.y0) * g.W + t.x0};
}

}  // namespace mdc

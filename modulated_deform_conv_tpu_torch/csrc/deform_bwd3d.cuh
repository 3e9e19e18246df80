// The 3D backward kernels.  They compute what the 2D ones compute
// (deform_bwd.cuh), with the trilinear corner rules of deform_tile3d.cuh:
// both fused pairs' backwards (gathermm3d_bwd.cu, shiftblend3d_bwd.cu) run
// the tensor-core kernels of run_bwd3d, each with its own grad_x pull: the
// gather's is driven by the corner boxes of the output bricks
// (boxes3_kernel + gather_pull3_kernel), the bounded pair's by each tap's
// static reach (shift_pull3_kernel).  The columns path's 3D backward is in
// deform_cols_bwd.cuh.
//
// Determinism as in 2D: no float atomics; every output element has one
// owner that sums in a fixed order, and grad_weight is summed in shape-only
// splits folded in order.  gcols (B, K, P, C) is the largest buffer (7.25 GB
// for all of BASELINE config 4), so gcols, grad_x and grad_offset / grad_mask
// run over batch chunks of `b_step` samples, which only bounds the buffer:
// each of those outputs belongs to one sample.  grad_weight sums over the
// whole batch in one pass and does not read gcols.
#pragma once

#include "deform_bwd.cuh"
#include "deform_tile3d.cuh"

namespace mdc {

// The flattened 2D geometry under which deform_bwd.cuh's gcols_mma_kernel
// computes the 3D gcols: it reads only the batch, channels, groups, output
// channels, taps (kh * kw) and positions (OH * OW), so any stride, padding
// and dilation pass through it unchanged.
inline Geo flat_geo(const Geo3& g) {
  return Geo{g.B, g.C, 1,   1,   g.O, out_size3(g), 1,   g.groups, g.dg, taps3(g), 1, 1, 1, 0, 0, 1, 1,
             0,   0,   0,   0,   0,   g.precision,  -1.f, 1.f,      -1.f, static_cast<float>(out_size3(g)),
             0.f, 0.f, 0.f, 0.f};
}

// ---- the gather's corner boxes ------------------------------------------------

constexpr int kBoxInts = 6;  // z_lo, z_hi, y_lo, y_hi, x_lo, x_hi (inclusive)

// The first position of brick t of a volume ny x nx bricks per plane.
__device__ __forceinline__ void brick_origin(int t, int ny, int nx, int& z0, int& y0, int& x0) {
  z0 = t / (nx * ny) * kBrick;
  y0 = t / nx % ny * kBrick;
  x0 = t % nx * kBrick;
}

// A box's min / max per axis over the warp's lanes.
__device__ __forceinline__ void warp_box(int (&lo)[3], int (&hi)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo[a] = min(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], o));
      hi[a] = max(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], o));
    }
  }
}

__device__ __forceinline__ void store_box(int* __restrict__ bx, const int (&lo)[3], const int (&hi)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bx[2 * a] = lo[a];
    bx[2 * a + 1] = hi[a];
  }
}

// One warp per (b, d, output brick): the box of the input voxels that the
// kept corners (nonzero mask-folded weight) of its taps and positions touch,
// then the box of each tap's corners alone (1 + K boxes a brick); an empty
// box has hi < lo.
template <typename T>
__global__ void __launch_bounds__(kThreads) boxes3_kernel(const T* __restrict__ offset, const T* __restrict__ mask,
                                                          int* __restrict__ boxes, Geo3 g) {
  const int K = taps3(g), OHW = g.OH * g.OW;
  const int nz = bricks(g.OD), ny = bricks(g.OH), nx = bricks(g.OW), NT = nz * ny * nx;
  const int wid = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (wid >= g.B * g.dg * NT) return;
  const int t = wid % NT, d = (wid / NT) % g.dg, b = wid / (NT * g.dg);
  int tz0, ty0, tx0;
  brick_origin(t, ny, nx, tz0, ty0, tx0);
  int* bx = boxes + static_cast<size_t>(wid) * (K + 1) * kBoxInts;
  int lo[3] = {0x7fffffff, 0x7fffffff, 0x7fffffff}, hi[3] = {-1, -1, -1};
  for (int k = 0; k < K; ++k) {
    int tlo[3] = {0x7fffffff, 0x7fffffff, 0x7fffffff}, thi[3] = {-1, -1, -1};
    for (int q = lane; q < kTP; q += 32) {
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
          tlo[a] = min(tlo[a], c[a]);
          thi[a] = max(thi[a], c[a]);
        }
      }
    }
    warp_box(tlo, thi);
    if (lane == 0) store_box(bx + (1 + k) * kBoxInts, tlo, thi);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = min(lo[a], tlo[a]);
      hi[a] = max(hi[a], thi[a]);
    }
  }
  warp_box(lo, hi);
  if (lane == 0) store_box(bx, lo, hi);
}

// Whether box bx meets the 4 x 4 x 4 input brick at (z0, y0, x0).
__device__ __forceinline__ bool box_meets(const int* __restrict__ bx, int z0, int y0, int x0) {
  return bx[0] <= z0 + kBrick - 1 && bx[1] >= z0 && bx[2] <= y0 + kBrick - 1 && bx[3] >= y0 &&
         bx[4] <= x0 + kBrick - 1 && bx[5] >= x0;
}

// ---- the 3D backward on tensor cores (gathermm3d_bwd.cu, shiftblend3d_bwd.cu)
//
// The 3D counterpart of deform_bwd.cuh's run_bwd2d, per batch chunk of
// b_step samples where gcols is involved:
//   x_cl_kernel       x channels-last, xt (B, D*H*W, C), once per call;
//   gcols_mma_kernel  gcols (b_step, K, P, C) = W2^T gout on mma.sync, over
//                     the flattened volume (flat_geo);
//   a pull            grad_x per 4 x 4 x 4 input brick x 64 channels: the
//                     candidates (tap, output position) are evaluated once
//                     per block into a table, then each warp applies the
//                     hits on its own two pixel rows in table order, lanes
//                     over channels (shift_pull3_kernel: each tap's static
//                     reach; gather_pull3_kernel: the output bricks whose
//                     corner box meets the brick);
//   corr3_kernel      grad_offset / grad_mask: per 64 positions of one (b,
//                     d, k) the corner derivatives built once, then a warp
//                     per two positions with lanes over channels of xt and
//                     gcols and a fixed-order butterfly;
//   gw_mma_kernel     grad_W partials on mma.sync (launch_gw_mma, 8 corners
//                     a tap), then fold_kernel.
// gcols_mma_kernel, corr3_kernel and gw_mma_kernel take any 3D geometry:
// their corners come from tap_base3 (stride, padding and dilation per axis)
// and tap_corners3 (the bounded window only where `windowed`), their
// positions from out_size3, and their corner rows from the input's (D, H,
// W), so the gather's unwindowed geometry runs through them as the bounded
// pair's does.
// No float atomics: every output element has one owner that sums in a
// fixed order, and the batch chunks only bound gcols.

// The pull's block: 64 pixels of the brick x kPullC channels, a table of
// kCand candidates (corner weights of both planes, gcols row, low corner
// relative to the brick), and each warp's staged hits.  In dynamic shared
// memory (48 KB).
struct Pull3Block {
  float acc[kPullPix][kPullC + 1];
  float4 cw[2][kCand];
  int ck[kCand];
  int czyx[kCand];  // the low corner from the brick's origin, ((z + 16) * 64 + y + 16) * 64 + x + 16, clamped
  int2 hk[kPullT / 32][kStage];    // a warp's hits: gcols row, x of the first pixel
  float4 hw[kPullT / 32][kStage];  // their weights: row a at x and x + 1, row b at x and x + 1
};

__device__ __forceinline__ int pull3_rel(int v) { return min(max(v, -16), 47) + 16; }

// Apply a warp's ns staged hits to its two rows (pixels pa + x, pa + 4 + x).
__device__ __forceinline__ void pull3_apply(Pull3Block& sm, int ns, int pa, const float* __restrict__ gcol, int C,
                                            int cw) {
  constexpr int kU = 8;  // hits a warp has in flight
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lo = lane < cw, hi = lane + 32 < cw;
  for (int j0 = 0; j0 < ns; j0 += kU) {
    int2 h[kU];
    float v0[kU], v1[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      h[u] = j0 + u < ns ? sm.hk[warp][j0 + u] : make_int2(-1, 0);
      v0[u] = v1[u] = 0.f;
      if (h[u].x >= 0) {
        const float* r = gcol + static_cast<size_t>(h[u].x) * C;
        if (lo) v0[u] = r[lane];
        if (hi) v1[u] = r[lane + 32];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (h[u].x < 0) continue;
      const float4 w = sm.hw[warp][j0 + u];
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (wv[i] == 0.f) continue;
        float* a = sm.acc[pa + (i >> 1) * kBrick + h[u].y + (i & 1)];
        a[lane] = fmaf(wv[i], v0[u], a[lane]);
        a[lane + 32] = fmaf(wv[i], v1[u], a[lane + 32]);
      }
    }
  }
}

// Scan table entries [0, n) for the candidates with a corner in this
// warp's rows (brick plane w / 2, rows 2 (w % 2) and 2 (w % 2) + 1), staging
// and applying them in table order.
__device__ __forceinline__ void pull3_scan(Pull3Block& sm, int n, const float* __restrict__ gcol, int C, int cw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int zw = warp >> 1, ya = 2 * (warp & 1), pa = (zw * kBrick + ya) * kBrick;
  int ns = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    bool has = false;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    int rx = 0;
    if (i < n) {
      const int q = sm.czyx[i], rz = q / 4096 - 16, ry = q / 64 % 64 - 16;
      rx = q % 64 - 16;
      const float4 pw = rz == zw ? sm.cw[0][i] : rz + 1 == zw ? sm.cw[1][i] : make_float4(0.f, 0.f, 0.f, 0.f);
      w.x = ry == ya ? pw.x : ry + 1 == ya ? pw.z : 0.f;
      w.y = ry == ya ? pw.y : ry + 1 == ya ? pw.w : 0.f;
      w.z = ry == ya + 1 ? pw.x : ry == ya ? pw.z : 0.f;
      w.w = ry == ya + 1 ? pw.y : ry == ya ? pw.w : 0.f;
      if (rx < 0 || rx > kBrick - 1) w.x = w.z = 0.f;
      if (rx < -1 || rx > kBrick - 2) w.y = w.w = 0.f;
      has = w.x != 0.f || w.y != 0.f || w.z != 0.f || w.w != 0.f;
    }
    const unsigned m = __ballot_sync(0xffffffffu, has);
    if (has) {
      const int slot = ns + __popc(m & ((1u << lane) - 1));
      sm.hk[warp][slot] = make_int2(sm.ck[i], rx);
      sm.hw[warp][slot] = w;
    }
    ns += __popc(m);
    if (ns > kStage - 32) {
      __syncwarp();
      pull3_apply(sm, ns, pa, gcol, C, cw);
      ns = 0;
      __syncwarp();
    }
  }
  __syncwarp();
  pull3_apply(sm, ns, pa, gcol, C, cw);
}

// Block (input brick, (deformable group, channel chunk), batch) of a pull
// grid: the brick's origin, the group, its first channel and width.
struct Pull3Coords {
  int bz0, by0, bx0, d, c0, cw, b;
};

__device__ __forceinline__ Pull3Coords pull3_coords(const Geo3& g) {
  const int Cdg = g.C / g.dg, cchunks = (Cdg + kPullC - 1) / kPullC;
  Pull3Coords pc;
  brick_origin(blockIdx.x, bricks(g.H), bricks(g.W), pc.bz0, pc.by0, pc.bx0);
  pc.d = blockIdx.y / cchunks;
  pc.c0 = pc.d * Cdg + blockIdx.y % cchunks * kPullC;
  pc.cw = min(kPullC, (pc.d + 1) * Cdg - pc.c0);
  pc.b = blockIdx.z;
  return pc;
}

inline dim3 pull3_grid(const Geo3& g) {
  const int Cdg = g.C / g.dg;
  return dim3(bricks(g.D) * bricks(g.H) * bricks(g.W), g.dg * ((Cdg + kPullC - 1) / kPullC), g.B);
}

__device__ __forceinline__ void pull3_zero(Pull3Block& sm) {
  for (int e = threadIdx.x; e < kPullPix * (kPullC + 1); e += kPullT) (&sm.acc[0][0])[e] = 0.f;
}

// Store the brick's grad_x (after the last scan and a barrier).
template <typename T>
__device__ __forceinline__ void pull3_write(const Pull3Block& sm, T* __restrict__ gx, const Geo3& g,
                                            const Pull3Coords& pc) {
  const int HW = g.H * g.W;
  const size_t S = static_cast<size_t>(g.D) * HW;
  for (int e = threadIdx.x; e < kPullPix * pc.cw; e += kPullT) {
    const int c = e / kPullPix, pix = e % kPullPix;
    const int z = pc.bz0 + pix / 16, y = pc.by0 + pix / 4 % 4, x = pc.bx0 + pix % 4;
    if (z < g.D && y < g.H && x < g.W)
      gx[(static_cast<size_t>(pc.b) * g.C + pc.c0 + c) * S + z * HW + y * g.W + x] = to_elem<T>(sm.acc[pix][c]);
  }
}

// grad_x of one 4 x 4 x 4 input brick x 64 channels of one (b, deformable
// group).  The bounded contract keeps a tap's corners within rows [lo, lo +
// win - 1] of its anchor per axis, so the (tap, output position) pairs
// whose corners can land in the brick are, per tap, a box of (win + 3)
// positions per axis (8^3 = 512 at bound 2), moved back on a sharded block
// by the block's shift (sh - or: its output rows sit halo - pad rows below
// the input rows they reach); the candidates are those,
// tap-major, evaluated kCand at a time into a table, which every warp scans
// for its rows (pull3_scan).
template <typename T>
__global__ void __launch_bounds__(kPullT) shift_pull3_kernel(const T* __restrict__ offset, const T* __restrict__ mask,
                                                            const float* __restrict__ gcols, T* __restrict__ gx,
                                                            Geo3 g) {
  extern __shared__ __align__(16) float dyn[];
  Pull3Block& sm = *reinterpret_cast<Pull3Block*>(dyn);
  const Pull3Coords pc = pull3_coords(g);
  const int K = taps3(g), P = out_size3(g);
  const int Lz = g.win_z + kBrick - 1, Ly = g.win_y + kBrick - 1, Lx = g.win_x + kBrick - 1;
  const int n_cand = K * Lz * Ly * Lx;
  const int sz = static_cast<int>(g.shz - g.orz), sy = static_cast<int>(g.shy - g.ory),
            sx = static_cast<int>(g.shx - g.orx);
  const float* gcol = gcols + static_cast<size_t>(pc.b) * K * P * g.C + pc.c0;
  pull3_zero(sm);
  for (int e0 = 0; e0 < n_cand; e0 += kCand) {
    for (int e = threadIdx.x; e < kCand; e += kPullT) {
      const int c = e0 + e, k = c / (Lz * Ly * Lx), rem = c % (Lz * Ly * Lx);
      const int kz = k / (g.kh * g.kw), ky = k / g.kw % g.kh, kx = k % g.kw;
      // Output rows o whose corners o + anchor + shift + [lo, lo + win - 1]
      // meet the brick's rows [i0, i0 + 3].
      const int oz = pc.bz0 - (kz * g.dd - g.pd) - sz - (g.lo_z + g.win_z - 1) + rem / (Ly * Lx);
      const int oy = pc.by0 - (ky * g.dh - g.ph) - sy - (g.lo_y + g.win_y - 1) + rem / Lx % Ly;
      const int ox = pc.bx0 - (kx * g.dw - g.pw) - sx - (g.lo_x + g.win_x - 1) + rem % Lx;
      TapWeights3 t{0, 0, 0, make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
      if (c < n_cand && oz >= 0 && oz < g.OD && oy >= 0 && oy < g.OH && ox >= 0 && ox < g.OW)
        t = weights3_at(g, offset, mask, pc.b, pc.d, k, (oz * g.OH + oy) * g.OW + ox);
      sm.cw[0][e] = t.lo;
      sm.cw[1][e] = t.hi;
      sm.ck[e] = k * P + (oz * g.OH + oy) * g.OW + ox;
      sm.czyx[e] = (pull3_rel(t.z0 - pc.bz0) * 64 + pull3_rel(t.y0 - pc.by0)) * 64 + pull3_rel(t.x0 - pc.bx0);
    }
    __syncthreads();
    pull3_scan(sm, min(kCand, n_cand - e0), gcol, g.C, pc.cw);
    __syncthreads();  // the next table overwrites this one
  }
  pull3_write(sm, gx, g, pc);
}

// The block's threads with `on`, numbered in thread order: returns this
// thread's number and sets n to their count.  Every thread of the block
// calls it; ws (one int a warp) may be written again only after the
// caller's next barrier.
__device__ __forceinline__ int pull3_rank(int* ws, bool on, int& n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, on);
  if (lane == 0) ws[warp] = __popc(m);
  __syncthreads();
  int pos = 0;
  n = 0;
#pragma unroll
  for (int i = 0; i < kPullT / 32; ++i) {
    const int s = ws[i];
    if (i < warp) pos += s;
    n += s;
  }
  return pos + __popc(m & ((1u << lane) - 1));
}

// The gather's pull block: the shift pull's table and staging, the output
// bricks of one round, their (brick, tap) pairs of one round, and the
// warps' counts.
struct GatherPull3Block {
  Pull3Block tab;
  int bricks[kPullT];
  int pairs[kPullT];
  int ws[kPullT / 32];
};

// grad_x of one 4 x 4 x 4 input brick x 64 channels of one (b, deformable
// group) for unbounded offsets, from the corner boxes of boxes3_kernel:
// the output bricks whose box meets the input brick are
// compacted in order, kPullT boxes at a time, one thread a box; then their
// (brick, tap) pairs whose tap box meets it, likewise; then the pairs'
// (tap, position) candidates are evaluated kPullT at a time, and those with
// a kept corner within one voxel of the brick on every axis are appended in
// order to the table.  When the table holds more than kCand - kPullT the
// warps scan it for their rows (pull3_scan) and it starts again.  The
// table fills with what lands near the brick, whatever the reach: a far
// offset only makes its brick and tap a candidate of more blocks.
template <typename T>
__global__ void __launch_bounds__(kPullT) gather_pull3_kernel(const T* __restrict__ offset, const T* __restrict__ mask,
                                                             const float* __restrict__ gcols,
                                                             const int* __restrict__ boxes, T* __restrict__ gx,
                                                             Geo3 g) {
  extern __shared__ __align__(16) float dyn[];
  GatherPull3Block& sm = *reinterpret_cast<GatherPull3Block*>(dyn);
  Pull3Block& tab = sm.tab;
  const Pull3Coords pc = pull3_coords(g);
  const int K = taps3(g), P = out_size3(g), nb = K + 1;
  const int ny = bricks(g.OH), nx = bricks(g.OW), NT = bricks(g.OD) * ny * nx;
  const float* gcol = gcols + static_cast<size_t>(pc.b) * K * P * g.C + pc.c0;
  const int* bxs = boxes + (static_cast<size_t>(pc.b) * g.dg + pc.d) * NT * nb * kBoxInts;
  pull3_zero(tab);
  int n_tab = 0;  // entries in the table, the same in every thread
  for (int t0 = 0; t0 < NT; t0 += kPullT) {
    const int t = t0 + threadIdx.x;
    const bool on = t < NT && box_meets(bxs + static_cast<size_t>(t) * nb * kBoxInts, pc.bz0, pc.by0, pc.bx0);
    int n_on;
    const int slot = pull3_rank(sm.ws, on, n_on);
    if (on) sm.bricks[slot] = t;
    __syncthreads();
    for (int i0 = 0; i0 < n_on * K; i0 += kPullT) {
      const int i = i0 + threadIdx.x;
      int pair = 0;
      bool hit = false;
      if (i < n_on * K) {
        const int tb = sm.bricks[i / K], k = i % K;
        pair = tb * K + k;
        hit = box_meets(bxs + (static_cast<size_t>(tb) * nb + 1 + k) * kBoxInts, pc.bz0, pc.by0, pc.bx0);
      }
      int n_pairs;
      const int at_pair = pull3_rank(sm.ws, hit, n_pairs);
      if (hit) sm.pairs[at_pair] = pair;
      __syncthreads();
      const int n_cand = n_pairs * kTP;
      for (int e0 = 0; e0 < n_cand; e0 += kPullT) {
        const int c = e0 + threadIdx.x;
        TapWeights3 w{0, 0, 0, make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
        int row = 0;
        bool keep = false;
        if (c < n_cand) {
          const int pr = sm.pairs[c / kTP], k = pr % K, q = c % kTP;
          int tz0, ty0, tx0;
          brick_origin(pr / K, ny, nx, tz0, ty0, tx0);
          const int oz = tz0 + q / 16, oy = ty0 + q / 4 % 4, ox = tx0 + q % 4;
          if (oz < g.OD && oy < g.OH && ox < g.OW) {
            const int p = (oz * g.OH + oy) * g.OW + ox;
            row = k * P + p;
            w = weights3_at(g, offset, mask, pc.b, pc.d, k, p);
            const int rz = w.z0 - pc.bz0, ry = w.y0 - pc.by0, rx = w.x0 - pc.bx0;
            keep = rz >= -1 && rz < kBrick && ry >= -1 && ry < kBrick && rx >= -1 && rx < kBrick &&
                   (w.lo.x != 0.f || w.lo.y != 0.f || w.lo.z != 0.f || w.lo.w != 0.f || w.hi.x != 0.f ||
                    w.hi.y != 0.f || w.hi.z != 0.f || w.hi.w != 0.f);
          }
        }
        int n_keep;
        const int at = n_tab + pull3_rank(sm.ws, keep, n_keep);
        if (keep) {
          tab.cw[0][at] = w.lo;
          tab.cw[1][at] = w.hi;
          tab.ck[at] = row;
          tab.czyx[at] = ((w.z0 - pc.bz0 + 16) * 64 + w.y0 - pc.by0 + 16) * 64 + w.x0 - pc.bx0 + 16;
        }
        n_tab += n_keep;
        __syncthreads();
        if (n_tab > kCand - kPullT) {
          pull3_scan(tab, n_tab, gcol, g.C, pc.cw);
          __syncthreads();  // the next entries overwrite these
          n_tab = 0;
        }
      }
    }
  }
  pull3_scan(tab, n_tab, gcol, g.C, pc.cw);
  __syncthreads();
  pull3_write(tab, gx, g, pc);
}

// The pulls' launches over the gc.B samples of a chunk, for run_bwd3d.
template <typename T>
inline cudaError_t launch_shift_pull3(const Geo3& gc, const T* offset, const T* mask, const float* gcols, T* gx,
                                      cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(shift_pull3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(Pull3Block)));
  if (err != cudaSuccess) return err;
  shift_pull3_kernel<T><<<pull3_grid(gc), kPullT, sizeof(Pull3Block), s>>>(offset, mask, gcols, gx, gc);
  return cudaGetLastError();
}

// boxes (gc.B, dg, output bricks, 1 + K, 6) int scratch.
template <typename T>
inline cudaError_t launch_gather_pull3(const Geo3& gc, const T* offset, const T* mask, const float* gcols,
                                       int* boxes, T* gx, cudaStream_t s) {
  const int warps = gc.B * gc.dg * bricks(gc.OD) * bricks(gc.OH) * bricks(gc.OW);
  boxes3_kernel<T><<<(warps + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(offset, mask, boxes, gc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(gather_pull3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(sizeof(GatherPull3Block)))) != cudaSuccess)
    return err;
  gather_pull3_kernel<T><<<pull3_grid(gc), kPullT, sizeof(GatherPull3Block), s>>>(offset, mask, gcols, boxes, gx,
                                                                                 gc);
  return cudaGetLastError();
}

// The correlation of 64 consecutive positions of one (b, deformable group
// d, tap k): their corner derivatives (grad3_at) are built once into
// shared memory; then warp w takes positions w, w + 8, ..., two at a time
// so that their loads are in flight together, lane l sums gcol * x over
// channels l, l + 32, ... of the slab for each kept corner, and
// warp_sum_spread sums the lanes' sixteen values in a fixed order.  gcol
// and the corners of xt are rows of consecutive channels.
template <typename T>
__global__ void __launch_bounds__(256, 2) corr3_kernel(const float* __restrict__ xt, const T* __restrict__ offset,
                                                      const T* __restrict__ mask, const float* __restrict__ gcols,
                                                      T* __restrict__ goff, T* __restrict__ gmask, Geo3 g) {
  constexpr int kU = 2;              // positions a warp sums at once
  constexpr int kL = 32 / (8 * kU);  // lanes that end up holding each sum
  __shared__ TapGrad3 tg[kTP];
  const int K = taps3(g), P = out_size3(g), Cdg = g.C / g.dg;
  const size_t S = static_cast<size_t>(g.D) * g.H * g.W;
  const int p0 = blockIdx.x * kTP, k = blockIdx.y % K, d = blockIdx.y / K, b = blockIdx.z;
  if (threadIdx.x < kTP) {
    TapGrad3 t{};
    if (p0 + threadIdx.x < P) t = grad3_at(g, offset, mask, b, d, k, p0 + threadIdx.x);
    tg[threadIdx.x] = t;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* gp = gcols + (static_cast<size_t>(b) * K + k) * P * g.C + static_cast<size_t>(d) * Cdg;
  const float* xb = xt + static_cast<size_t>(b) * S * g.C + static_cast<size_t>(d) * Cdg;
  int step[8];  // corner j from the low corner, in elements of xt
#pragma unroll
  for (int j = 0; j < 8; ++j) step[j] = ((j >> 2) * g.H * g.W + (j >> 1 & 1) * g.W + (j & 1)) * g.C;
  for (int i0 = warp; i0 < kTP; i0 += 8 * kU) {
    int keep[kU], go[kU], xo[kU];  // gcol's row and the low corner's, in elements from gp and xb
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const TapGrad3& t = tg[i0 + 8 * u];
      keep[u] = t.keep;
      go[u] = min(p0 + i0 + 8 * u, P - 1) * g.C;
      xo[u] = t.keep ? ((t.z0 * g.H + t.y0) * g.W + t.x0) * g.C : 0;
    }
    float s[kU * 8] = {};
    for (int c = lane; c < Cdg; c += 32) {
      float gv[kU], xv[kU][8];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float* xc = xb + xo[u] + c;
        gv[u] = keep[u] ? gp[go[u] + c] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[u][j] = keep[u] >> j & 1 ? xc[step[j]] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[8 * u + j] = fmaf(gv[u], xv[u][j], s[8 * u + j]);
    }
    // Value 8 u + j, the sum of corner j of position u, ends in lanes
    // (8 u + j) kL ...; lane 8 u kL gathers its position's eight.
    const float sum = warp_sum_spread<kU * 8>(s);
    float Sc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) Sc[j] = __shfl_sync(0xffffffffu, sum, (lane & ~(8 * kL - 1)) + j * kL);
    const int u = lane / (8 * kL), i = i0 + 8 * u, p = p0 + i;
    if (lane % (8 * kL) == 0 && p < P) {
      const TapGrad3& t = tg[i];
      if (goff) {
        float gz = 0.f, gy = 0.f, gxv = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          gz += t.dz[j] * Sc[j];
          gy += t.dy[j] * Sc[j];
          gxv += t.dx[j] * Sc[j];
        }
        const size_t oidx = (static_cast<size_t>(b) * g.dg * 3 * K + static_cast<size_t>(d) * 3 * K + 3 * k) * P + p;
        goff[oidx] = to_elem<T>(t.m * gz);
        goff[oidx + P] = to_elem<T>(t.m * gy);
        goff[oidx + 2 * static_cast<size_t>(P)] = to_elem<T>(t.m * gxv);
      }
      if (gmask) {
        float gm = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) gm += t.w[j] * Sc[j];
        gmask[(static_cast<size_t>(b) * g.dg * K + static_cast<size_t>(d) * K + k) * P + p] = to_elem<T>(gm);
      }
    }
  }
}

// The 3D backward's launches.  pull(geometry of the chunk, its offset,
// mask, gcols, grad_x) launches grad_x's pull for a batch chunk.  gcols
// (b_step, K, P, C), xt (B, D*H*W, C) and part (splits, groups, C/groups*K,
// O/groups) are the caller's fp32 scratch, wk and gwt fp32; x, offset, mask,
// gout and gx, goff, gmask are of the activations' type T; outputs not
// wanted are null.
template <int Prec, typename T, class Pull>
inline cudaError_t run_bwd3d(const Geo3& g, const T* x, const T* offset, const T* mask, const float* wk,
                             const T* gout, float* gcols, float* xt, float* part, T* gx, T* goff, T* gmask,
                             float* gwt, int b_step, int splits, cudaStream_t s, Pull pull) {
  const int K = taps3(g), P = out_size3(g), rows = g.C / g.groups * K;
  const int S = g.D * g.H * g.W;
  cudaError_t err;
  if (goff || gmask || gwt) {
    x_cl_kernel<T><<<dim3((S + 31) / 32, (g.C + 31) / 32, g.B), 256, 0, s>>>(x, xt, g.C, S);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  for (int b0 = 0; (gx || goff || gmask) && b0 < g.B; b0 += b_step) {
    Geo3 gc = g;
    gc.B = min(b_step, g.B - b0);
    const T* off_c = offset + static_cast<size_t>(b0) * g.dg * 3 * K * P;
    const T* mask_c = mask ? mask + static_cast<size_t>(b0) * g.dg * K * P : nullptr;
    const dim3 grid((P + kMT - 1) / kMT, (rows + kMT - 1) / kMT, gc.B * g.groups);
    gcols_mma_kernel<Prec, T><<<grid, kMmaThreads, 0, s>>>(wk, gout + static_cast<size_t>(b0) * g.O * P, gcols,
                                                           flat_geo(gc));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (gx && (err = pull(gc, off_c, mask_c, gcols, gx + static_cast<size_t>(b0) * g.C * S)) != cudaSuccess)
      return err;
    if (goff || gmask) {
      corr3_kernel<T><<<dim3((P + kTP - 1) / kTP, K * g.dg, gc.B), 256, 0, s>>>(
          xt + static_cast<size_t>(b0) * S * g.C, off_c, mask_c, gcols,
          goff ? goff + static_cast<size_t>(b0) * g.dg * 3 * K * P : nullptr,
          gmask ? gmask + static_cast<size_t>(b0) * g.dg * K * P : nullptr, gc);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  if (gwt && (err = launch_gw_mma<Prec>(g, xt, offset, mask, gout, part, gwt, splits, s)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

}  // namespace mdc

// Pieces shared by the 3D backward kernels (gathermm3d_bwd.cu,
// shiftblend3d_bwd.cu, gathermm3d_cols_bwd.cu).  They compute what the 2D
// ones compute (deform_bwd.cuh), with the trilinear corner rules of
// deform_tile3d.cuh:
//
//   gcols   = W2^T gout                        (deform_bwd.cuh's gcols_kernel
//                                               over the flattened volume)
//   grad_x  = A gcols                          (a pull on 4 x 4 x 4 input
//                                               bricks: shift-blend's own,
//                                               gather_gx3_kernel)
//   grad_offset, grad_mask from S[corner] = sum_c gcol x
//                                              (goff3_kernel)
//   grad_weight = gout cols^T, cols rebuilt from x
//                                              (gw3_kernel + fold_kernel)
//
// gathermm3d_cols_bwd.cu is given gcols (layout CKBP) and computes the
// middle two.  Determinism as in 2D: no float atomics; every output element has one
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

// The flattened 2D geometry under which deform_bwd.cuh's gcols_kernel
// computes the 3D gcols: it reads only the batch, channels, groups, taps
// (kh * kw) and positions (OH * OW).
inline Geo flat_geo(const Geo3& g) {
  return Geo{g.B, g.C, 1, 1, g.O, out_size3(g), 1, g.groups, g.dg, taps3(g), 1, 1, 1, 0, 0, 1, 1,
             0,   0,   0, 0, 0,   g.precision};
}

// ---- grad_x by pulling, with up to 8 hits a candidate ----------------------
//
// As deform_bwd.cuh's pull: a block owns kQT = 64 input pixels (a 4 x 4 x 4
// brick) x kCW channels, walks a candidate list of (tap, output position) in
// a fixed order, appends the hits in thread order and applies them warp by
// warp to per-warp accumulator copies, summed in order at the end.
constexpr int kHits3 = 8;

struct PullSmem3 {
  float acc[kPullWarps][kQT][kCWP];
  Hit hits[kPullThreads * kHits3];
  int warp_total[kPullWarps];
};

__device__ __forceinline__ void pull3_clear(PullSmem3& sm) {
  float* a = &sm.acc[0][0][0];
  for (int e = threadIdx.x; e < kPullWarps * kQT * kCWP; e += kPullThreads) a[e] = 0.f;
  __syncthreads();
}

template <class L>
__device__ __forceinline__ void pull3_hits(PullSmem3& sm, int n, const int (&pix)[kHits3],
                                           const float (&w)[kHits3], int kp, const typename L::T* __restrict__ gcol,
                                           const L& lay, int cw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) sm.warp_total[warp] = v;
  __syncthreads();
  int pos = v - n, total = 0;
#pragma unroll
  for (int i = 0; i < kPullWarps; ++i) {
    if (i < warp) pos += sm.warp_total[i];
    total += sm.warp_total[i];
  }
  for (int i = 0; i < n; ++i) sm.hits[pos + i] = Hit{pix[i], kp, w[i]};
  __syncthreads();
  if (lane < cw) {
    float* acc = &sm.acc[warp][0][lane];
    for (int h = warp; h < total; h += kPullWarps) {
      const Hit hh = sm.hits[h];
      acc[hh.pix * kCWP] = fmaf(hh.w, as_float(gcol[lay.at(hh.kp, lane)]), acc[hh.pix * kCWP]);
    }
  }
  __syncthreads();  // the list is rebuilt by the next chunk
}

// The corners of one tap that land in the input brick at (bz0, by0, bx0)
// with a nonzero weight: their pixels within the brick and their weights.
__device__ __forceinline__ int brick_hits(const TapWeights3& t, int bz0, int by0, int bx0, int (&pix)[kHits3],
                                          float (&w)[kHits3]) {
  const float wv[8] = {t.lo.x, t.lo.y, t.lo.z, t.lo.w, t.hi.x, t.hi.y, t.hi.z, t.hi.w};
  int n = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int z = t.z0 + (i >> 2) - bz0, y = t.y0 + ((i >> 1) & 1) - by0, x = t.x0 + (i & 1) - bx0;
    if (wv[i] != 0.f && z >= 0 && z < kBrick && y >= 0 && y < kBrick && x >= 0 && x < kBrick) {
      pix[n] = (z * kBrick + y) * kBrick + x;
      w[n] = wv[i];
      ++n;
    }
  }
  return n;
}

// Write the brick's accumulated grad_x: pixel pix of the brick at (bz0,
// by0, bx0), channel c0 + cl, summed over the warps' copies in order.
__device__ __forceinline__ void pull3_store(const PullSmem3& sm, float* __restrict__ gx, const Geo3& g, int b,
                                            int c0, int cw, int bz0, int by0, int bx0) {
  const int HW = g.H * g.W;
  for (int e = threadIdx.x; e < kQT * kCW; e += kPullThreads) {
    const int cl = e / kQT, pix = e % kQT;
    const int z = bz0 + pix / 16, y = by0 + pix / 4 % 4, x = bx0 + pix % 4;
    if (cl >= cw || z >= g.D || y >= g.H || x >= g.W) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kPullWarps; ++w) s += sm.acc[w][pix][cl];
    gx[(static_cast<size_t>(b) * g.C + c0 + cl) * g.D * HW + z * HW + y * g.W + x] = s;
  }
}

// ---- the gather's grad_x pull (gathermm3d_bwd.cu, gathermm3d_cols_bwd.cu) --

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
template <class L>
__global__ void __launch_bounds__(kPullThreads) gather_gx3_kernel(const float* __restrict__ offset,
                                                                  const float* __restrict__ mask,
                                                                  const typename L::T* __restrict__ gcols,
                                                                  const int* __restrict__ boxes,
                                                                  float* __restrict__ gx, Geo3 g, L lay) {
  __shared__ PullSmem3 sm;
  const int K = taps3(g), P = out_size3(g), OHW = g.OH * g.OW;
  const int nz = bricks(g.OD), ny = bricks(g.OH), nx = bricks(g.OW), NT = nz * ny * nx;
  const int Cdg = g.C / g.dg, cchunks = (Cdg + kCW - 1) / kCW;
  int bz0, by0, bx0;
  brick_origin(blockIdx.x, bricks(g.H), bricks(g.W), bz0, by0, bx0);
  const int d = blockIdx.y / cchunks, c0 = d * Cdg + (blockIdx.y % cchunks) * kCW;
  const int cw = min(kCW, (d + 1) * Cdg - c0);
  const int b = blockIdx.z;
  const typename L::T* gcol = gcols + lay.base(b, c0);
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
      pull3_hits(sm, n, pix, w, lay.hit(k, p), gcol, lay, cw);
    }
  }
  pull3_store(sm, gx, g, b, c0, cw, bz0, by0, bx0);
}

// grad_x by the gather's pull over the gc.B samples of a chunk: boxes
// (gc.B, dg, output bricks, 6) int scratch.
template <class L>
inline cudaError_t launch_gather_gx3(const Geo3& gc, const float* offset, const float* mask,
                                     const typename L::T* gcols, int* boxes, float* gx, L lay, cudaStream_t s) {
  const int NT = bricks(gc.OD) * bricks(gc.OH) * bricks(gc.OW), warps = gc.B * gc.dg * NT;
  boxes3_kernel<<<(warps + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(offset, mask, boxes, gc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int Cdg = gc.C / gc.dg;
  const dim3 grid(bricks(gc.D) * bricks(gc.H) * bricks(gc.W), gc.dg * ((Cdg + kCW - 1) / kCW), gc.B);
  gather_gx3_kernel<L><<<grid, kPullThreads, 0, s>>>(offset, mask, gcols, boxes, gx, gc, lay);
  return cudaGetLastError();
}

// ---- grad_offset and grad_mask ---------------------------------------------

// One thread per (b, deformable group, tap, position): S[corner] = sum_c
// gcol[c] x[c, corner] over the slab's channels in order, then grad_offset
// = mask * sum dA/dpos S per axis and grad_mask = sum A S.
template <class L>
__global__ void __launch_bounds__(kThreads) goff3_kernel(const float* __restrict__ x,
                                                         const float* __restrict__ offset,
                                                         const float* __restrict__ mask,
                                                         const typename L::T* __restrict__ gcols,
                                                         float* __restrict__ goff, float* __restrict__ gmask, Geo3 g,
                                                         L lay) {
  const int K = taps3(g), P = out_size3(g), Cdg = g.C / g.dg, HW = g.H * g.W;
  const size_t S = static_cast<size_t>(g.D) * HW;
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<size_t>(g.B) * g.dg * K * P) return;
  const int p = e % P, k = (e / P) % K, d = (e / (static_cast<size_t>(P) * K)) % g.dg;
  const int b = e / (static_cast<size_t>(P) * K * g.dg);
  const TapGrad3 t = grad3_at(g, offset, mask, b, d, k, p);
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (t.keep) {
    const typename L::T* gp = gcols + lay.base(b, d * Cdg);
    const int h = lay.hit(k, p);
    const float* xp = x + (static_cast<size_t>(b) * g.C + static_cast<size_t>(d) * Cdg) * S;
    const int i0 = t.z0 * HW + t.y0 * g.W + t.x0;
    for (int c = 0; c < Cdg; ++c) {
      const float gv = as_float(gp[lay.at(h, c)]);
      const float* xc = xp + static_cast<size_t>(c) * S;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (t.keep >> i & 1) s[i] = fmaf(gv, xc[i0 + corner_step3(i, g.W, HW)], s[i]);
    }
  }
  if (goff) {
    float gz = 0.f, gy = 0.f, gxv = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gz += t.dz[i] * s[i];
      gy += t.dy[i] * s[i];
      gxv += t.dx[i] * s[i];
    }
    const size_t oidx = (static_cast<size_t>(b) * g.dg * 3 * K + static_cast<size_t>(d) * 3 * K + 3 * k) * P + p;
    goff[oidx] = t.m * gz;
    goff[oidx + P] = t.m * gy;
    goff[oidx + 2 * static_cast<size_t>(P)] = t.m * gxv;
  }
  if (gmask) {
    float gm = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) gm += t.w[i] * s[i];
    gmask[(static_cast<size_t>(b) * g.dg * K + static_cast<size_t>(d) * K + k) * P + p] = gm;
  }
}

template <class L>
inline cudaError_t launch_goff3(const Geo3& gc, const float* x, const float* offset, const float* mask,
                                const typename L::T* gcols, float* goff, float* gmask, L lay, cudaStream_t s) {
  const size_t n = static_cast<size_t>(gc.B) * gc.dg * taps3(gc) * out_size3(gc);
  goff3_kernel<L><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(x, offset, mask, gcols,
                                                                                          goff, gmask, gc, lay);
  return cudaGetLastError();
}

// ---- grad_weight -------------------------------------------------------------

constexpr int kTC = 64;  // channels (rows of one tap) per gw3 block

// Channel tile j of conv group gi: the group's channels cut at deformable-
// slab boundaries, each piece cut into runs of at most kTC.  Sets *c0 to
// its first channel and returns its width, or 0 past the last tile.
__host__ __device__ inline int channel_tile(int gi, int j, int Cgc, int Cdg, int* c0) {
  int c = gi * Cgc;
  const int end = c + Cgc;
  while (c < end) {
    const int slab_end = (c / Cdg + 1) * Cdg;
    const int piece_end = slab_end < end ? slab_end : end;
    const int n = (piece_end - c + kTC - 1) / kTC;
    if (j < n) {
      *c0 = c + j * kTC;
      return piece_end - *c0 < kTC ? piece_end - *c0 : kTC;
    }
    j -= n;
    c = piece_end;
  }
  return 0;
}

// Partial grad_weight of one split of the flattened (batch, position) axis
// for one tap k and one channel tile (all of one deformable slab):
// part[split][gi][row][o] = sum_n cols[n][row] gout[n][o], row = (c - gi *
// C/groups) * K + k.  The block's rows share the tap and the slab, so the
// corner weights of each n are built once per block (the 2D gw_kernel
// builds them per row) and its 64 rows blend their own channels.
__global__ void __launch_bounds__(kThreads) gw3_kernel(const float* __restrict__ x,
                                                       const float* __restrict__ offset,
                                                       const float* __restrict__ mask,
                                                       const float* __restrict__ gout, float* __restrict__ part,
                                                       int chunk, Geo3 g) {
  __shared__ __align__(16) float colsT[kNC * kWStride];  // [n][row]
  __shared__ __align__(16) float goutT[kNC * kWStride];  // [n][o]
  __shared__ float4 twl[kNC], twh[kNC];
  __shared__ int tb[kNC], tbat[kNC];
  const int K = taps3(g), P = out_size3(g), HW = g.H * g.W;
  const size_t S = static_cast<size_t>(g.D) * HW;
  const int Cgc = g.C / g.groups, Og = g.O / g.groups, Cdg = g.C / g.dg;
  const int o_tiles = (Og + kTO - 1) / kTO;
  const int o0 = (blockIdx.x % o_tiles) * kTO;
  const int gi = blockIdx.y / K, k = blockIdx.y % K, split = blockIdx.z;
  int c0 = 0;
  const int cw = channel_tile(gi, blockIdx.x / o_tiles, Cgc, Cdg, &c0);
  if (cw == 0) return;  // uniform across the block
  const int d = c0 / Cdg;
  const int total = g.B * P;
  const int n_begin = split * chunk, n_end = min(total, n_begin + chunk);
  float acc[4][4] = {};
  for (int n0 = n_begin; n0 < n_end; n0 += kNC) {
    const int nn = min(kNC, n_end - n0);
    __syncthreads();  // previous step done with the table, colsT and goutT
    if (threadIdx.x < kNC) {
      TapWeights3 t{0, 0, 0, make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
      int b = 0;
      if (threadIdx.x < nn) {
        const int n = n0 + threadIdx.x;
        b = n / P;
        t = weights3_at(g, offset, mask, b, d, k, n % P);
      }
      twl[threadIdx.x] = t.lo;
      twh[threadIdx.x] = t.hi;
      tb[threadIdx.x] = t.z0 * HW + t.y0 * g.W + t.x0;
      tbat[threadIdx.x] = b;
    }
    __syncthreads();
    // A warp stages one row (or one output channel) at 32 consecutive
    // positions, so that its loads of x and gout coalesce.
    for (int e = threadIdx.x; e < kNC * kTO; e += kThreads) {
      const int r = e / kNC, n = e % kNC;
      float v = 0.f;
      if (n < nn && r < cw)
        v = blend3(x + (static_cast<size_t>(tbat[n]) * g.C + c0 + r) * S, tb[n], g.W, HW, twl[n], twh[n]);
      colsT[n * kWStride + r] = operand(v, g.precision);
    }
    for (int e = threadIdx.x; e < kNC * kTO; e += kThreads) {
      const int o = e / kNC, n = e % kNC;
      float v = 0.f;
      if (n < nn && o0 + o < Og) {
        const int b = (n0 + n) / P, p = (n0 + n) % P;
        v = gout[(static_cast<size_t>(b) * g.O + static_cast<size_t>(gi) * Og + o0 + o) * P + p];
      }
      goutT[n * kWStride + o] = operand(v, g.precision);
    }
    __syncthreads();
    tile_fma<kWStride, kWStride>(goutT, colsT, nn, acc);
  }
  float* pg = part + (static_cast<size_t>(split) * g.groups + gi) * Cgc * K * Og;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= cw) continue;
    const size_t row = static_cast<size_t>(c0 + r - gi * Cgc) * K + k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < Og) pg[row * Og + o] = acc[i][j];
    }
  }
}

// ---- the whole backward --------------------------------------------------------

// gcols, then (each when wanted) grad_x through `pull(geometry of the chunk,
// offset, mask, gcols, gx)` and grad_offset / grad_mask, per batch chunk of
// b_step samples; then grad_weight over the whole batch in `splits` splits
// and the fold.  Pointers are the whole batch's; outputs null when not
// wanted.  Returns the first CUDA error, or cudaSuccess.
template <typename Pull>
inline cudaError_t backward3(const Geo3& g, const float* x, const float* offset, const float* mask,
                             const float* wk, const float* gout, float* gcols, float* part, float* gx, float* goff,
                             float* gmask, float* gwt, int b_step, int splits, cudaStream_t s, Pull pull) {
  const int K = taps3(g), P = out_size3(g);
  const size_t S = static_cast<size_t>(g.D) * g.H * g.W;
  cudaError_t err = cudaSuccess;
  if (gx || goff || gmask) {
    for (int b0 = 0; b0 < g.B; b0 += b_step) {
      Geo3 gc = g;
      gc.B = b_step < g.B - b0 ? b_step : g.B - b0;
      const float* off_c = offset + static_cast<size_t>(b0) * g.dg * 3 * K * P;
      const float* mask_c = mask ? mask + static_cast<size_t>(b0) * g.dg * K * P : nullptr;
      if ((err = launch_gcols(flat_geo(gc), wk, gout + static_cast<size_t>(b0) * g.O * P, gcols, s)) != cudaSuccess)
        return err;
      if (gx && (err = pull(gc, off_c, mask_c, gcols, gx + static_cast<size_t>(b0) * g.C * S)) != cudaSuccess)
        return err;
      if ((goff || gmask) &&
          (err = launch_goff3(gc, x + static_cast<size_t>(b0) * g.C * S, off_c, mask_c, gcols,
                              goff ? goff + static_cast<size_t>(b0) * g.dg * 3 * K * P : nullptr,
                              gmask ? gmask + static_cast<size_t>(b0) * g.dg * K * P : nullptr, KPC{K, P, g.C},
                              s)) != cudaSuccess)
        return err;
    }
  }
  if (gwt) {
    const int Cgc = g.C / g.groups, Og = g.O / g.groups, Cdg = g.C / g.dg;
    int tiles = 0, c0 = 0;
    for (int gi = 0; gi < g.groups; ++gi) {
      int j = 0;
      while (channel_tile(gi, j, Cgc, Cdg, &c0) > 0) ++j;
      tiles = j > tiles ? j : tiles;
    }
    const int total = g.B * P, chunk = (total + splits - 1) / splits;
    const dim3 grid(tiles * ((Og + kTO - 1) / kTO), g.groups * K, splits);
    gw3_kernel<<<grid, kThreads, 0, s>>>(x, offset, mask, gout, part, chunk, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int n = g.groups * Cgc * K * Og;
    fold_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, gwt, n, splits, g.precision);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace mdc

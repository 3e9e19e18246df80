// Pieces shared by the 2D backward kernels (gathermm_bwd.cu,
// shiftblend_bwd.cu, gathermm_cols_bwd.cu).  The first two compute, for
// out = W2 cols + bias with cols[c, k, p] = mask * sum_corners w * x[c,
// corner]:
//
//   gcols   = W2^T gout                        (gcols_kernel, a tiled GEMM)
//   grad_x  = A gcols, A the mask-folded corner matrix
//                                              (a pull kernel: shift-blend's
//                                               own, gather_gx_kernel)
//   grad_offset, grad_mask from the correlation S[corner] = sum_c gcol x
//   against dA/dpos and A                      (goff_kernel)
//   grad_weight = gout cols^T, cols recomputed from x (never saved)
//                                              (gw_kernel + fold_kernel)
//
// gathermm_cols_bwd.cu is given gcols and computes the middle two.  The
// pull and goff kernels read gcols through a layout (KPC, CKBP below).
//
// Determinism: there is no float atomic anywhere.  Every output element has
// one owner thread that sums in a fixed order; grad_weight is summed in
// fixed-size splits of the (batch, position) axis, and the splits are folded
// in order.  The split count depends on the shapes only.
#pragma once

#include "deform_tile.cuh"

namespace mdc {

// Geometry of one call, passed by value to every kernel.
struct Geo {
  int B, C, H, W, O, OH, OW, groups, dg, kh, kw, sh, sw, ph, pw, dh, dw;
  int windowed, lo_y, win_y, lo_x, win_x;
  int precision;
};

constexpr int kNC = 32;  // contraction indices staged per GEMM step

// ---- gcols layouts ------------------------------------------------------------
//
// gcols element (sample b, channel c, tap k, position p) of a layout:
// `hit(k, p)` is the int a pull's hit list keeps for a (tap, position)
// candidate, `base(b, c0)` the offset of sample b's channel c0, and `at(h,
// c)` the offset of channel c0 + c of candidate h from that base.
//   KPC:  (B, K, P, C), channels innermost: the fused backward's gcols;
//   CKBP: (C * K, B * P), row c * K + k: the columns path's, float32 or bf16.
struct KPC {
  using T = float;
  int K, P, C;
  __device__ int hit(int k, int p) const { return k * P + p; }
  __device__ size_t base(int b, int c0) const { return static_cast<size_t>(b) * K * P * C + c0; }
  __device__ size_t at(int h, int c) const { return static_cast<size_t>(h) * C + c; }
};

template <typename Elem>
struct CKBP {
  using T = Elem;
  int K, B, P;
  __device__ int hit(int k, int p) const { return k * B * P + p; }
  __device__ size_t base(int b, int c0) const {
    return static_cast<size_t>(c0) * K * B * P + static_cast<size_t>(b) * P;
  }
  __device__ size_t at(int h, int c) const { return static_cast<size_t>(c) * K * B * P + h; }
};

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

// The column kernels (gathermm{,3d}_cols_fwd.cu): threads a block, and
// channels of one slab that one thread blends from its tap's corner weights.
constexpr int kColThreads = 256;
constexpr int kColChans = 32;

__device__ __forceinline__ float mask_at(const Geo& g, const float* __restrict__ mask, int b, int d, int k, int p) {
  const int K = g.kh * g.kw, P = g.OH * g.OW;
  return mask ? mask[(static_cast<size_t>(b) * g.dg * K + static_cast<size_t>(d) * K + k) * P + p] : 1.f;
}

// Mask-folded corner weights of tap k at output position p (tap_weights).
__device__ __forceinline__ TapWeights weights_at(const Geo& g, const float* __restrict__ offset,
                                                 const float* __restrict__ mask, int b, int d, int k, int p) {
  const int K = g.kh * g.kw, P = g.OH * g.OW;
  const int oy = p / g.OW, ox = p % g.OW, ky = k / g.kw, kx = k % g.kw;
  const size_t oidx = (static_cast<size_t>(b) * g.dg * 2 * K + static_cast<size_t>(d) * 2 * K + 2 * k) * P + p;
  return tap_weights(oy * g.sh - g.ph + ky * g.dh, ox * g.sw - g.pw + kx * g.dw, offset[oidx], offset[oidx + P],
                     mask_at(g, mask, b, d, k, p), g.H, g.W, g.windowed, g.lo_y, g.win_y, g.lo_x, g.win_x);
}

// gcols[b][k][p][c] = sum_o W[o, c, k] gout[b, o, p] over the conv group of
// channel c; "bfloat16" rounds both operands and the result.  The rows of
// this GEMM are tap-major, r = k * C/groups + c, so that a block's 64 rows
// are (mostly) consecutive channels of one tap and its stores to the
// channels-innermost gcols are contiguous.  A block owns 64 rows x kTP
// positions of one (batch, conv group).  wk is (groups, O/groups, K,
// C/groups): the weight with the rows contiguous per output channel.
__global__ void __launch_bounds__(kThreads) gcols_kernel(const float* __restrict__ wk,
                                                         const float* __restrict__ gout,
                                                         float* __restrict__ gcols, Geo g) {
  __shared__ __align__(16) float aS[kNC * kTO];       // [o][row]
  __shared__ __align__(16) float bS[kNC * kWStride];  // [o][p]
  const int K = g.kh * g.kw, P = g.OH * g.OW;
  const int Cgc = g.C / g.groups, Og = g.O / g.groups, rows = Cgc * K;
  const int p0 = blockIdx.x * kTP, r0 = blockIdx.y * kTO;
  const int b = blockIdx.z / g.groups, gi = blockIdx.z % g.groups;
  const float* wg = wk + static_cast<size_t>(gi) * Og * rows;
  const float* gb = gout + (static_cast<size_t>(b) * g.O + static_cast<size_t>(gi) * Og) * P;
  float acc[4][4] = {};
  for (int o0 = 0; o0 < Og; o0 += kNC) {
    const int n = min(kNC, Og - o0);
    __syncthreads();  // previous step done with aS / bS
    for (int e = threadIdx.x; e < kNC * kTO; e += kThreads) {
      const int o = e / kTO, r = e % kTO;
      const float v = o < n && r0 + r < rows ? wg[static_cast<size_t>(o0 + o) * rows + r0 + r] : 0.f;
      aS[o * kTO + r] = operand(v, g.precision);
    }
    for (int e = threadIdx.x; e < kNC * kTP; e += kThreads) {
      const int o = e / kTP, p = e % kTP;
      const float v = o < n && p0 + p < P ? gb[static_cast<size_t>(o0 + o) * P + p0 + p] : 0.f;
      bS[o * kWStride + p] = operand(v, g.precision);
    }
    __syncthreads();
    tile_fma(aS, bS, n, acc);  // acc[i][j]: position ty*4 + i, row tx*4 + j
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tx * 4 + j;
      if (r < rows)
        gcols[((static_cast<size_t>(b) * K + r / Cgc) * P + p) * g.C + gi * Cgc + r % Cgc] =
            operand(acc[i][j], g.precision);
    }
  }
}

// One thread per (b, deformable group, tap, position): the correlation
// S[corner] = sum_c gcol[c] x[c, corner] over the slab's channels in order,
// then grad_offset = mask * sum dA/dpos S per axis and grad_mask = sum A S.
template <class L>
__global__ void __launch_bounds__(kThreads) goff_kernel(const float* __restrict__ x,
                                                        const float* __restrict__ offset,
                                                        const float* __restrict__ mask,
                                                        const typename L::T* __restrict__ gcols,
                                                        float* __restrict__ goff, float* __restrict__ gmask,
                                                        Geo g, L lay) {
  const int K = g.kh * g.kw, P = g.OH * g.OW, Cdg = g.C / g.dg, HW = g.H * g.W;
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<size_t>(g.B) * g.dg * K * P) return;
  const int p = e % P, k = (e / P) % K, d = (e / (static_cast<size_t>(P) * K)) % g.dg;
  const int b = e / (static_cast<size_t>(P) * K * g.dg);
  const int oy = p / g.OW, ox = p % g.OW, ky = k / g.kw, kx = k % g.kw;
  const size_t oidx = (static_cast<size_t>(b) * g.dg * 2 * K + static_cast<size_t>(d) * 2 * K + 2 * k) * P + p;
  const TapGrad t = tap_grad(oy * g.sh - g.ph + ky * g.dh, ox * g.sw - g.pw + kx * g.dw, offset[oidx],
                             offset[oidx + P], g.H, g.W, g.windowed, g.lo_y, g.win_y, g.lo_x, g.win_x);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (t.keep) {
    const typename L::T* gp = gcols + lay.base(b, d * Cdg);
    const int h = lay.hit(k, p);
    const float* xp = x + (static_cast<size_t>(b) * g.C + static_cast<size_t>(d) * Cdg) * HW;
    const int i0 = t.y0 * g.W + t.x0;
    const int idx[4] = {i0, i0 + 1, i0 + g.W, i0 + g.W + 1};
    for (int c = 0; c < Cdg; ++c) {
      const float gv = as_float(gp[lay.at(h, c)]);
      const float* xc = xp + static_cast<size_t>(c) * HW;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (t.keep >> i & 1) s[i] = fmaf(gv, xc[idx[i]], s[i]);
    }
  }
  const float m = mask_at(g, mask, b, d, k, p);
  if (goff) {
    goff[oidx] = m * (t.dy.x * s[0] + t.dy.y * s[1] + t.dy.z * s[2] + t.dy.w * s[3]);
    goff[oidx + P] = m * (t.dx.x * s[0] + t.dx.y * s[1] + t.dx.z * s[2] + t.dx.w * s[3]);
  }
  if (gmask)
    gmask[(static_cast<size_t>(b) * g.dg * K + static_cast<size_t>(d) * K + k) * P + p] =
        t.w.x * s[0] + t.w.y * s[1] + t.w.z * s[2] + t.w.w * s[3];
}

// Partial grad_weight of one split of the flattened (batch, position) axis:
// part[split][gi][row][o] = sum_n cols[n][row] gout[n][o] over n in
// [split * chunk, (split + 1) * chunk).  A block owns 64 (channel, tap) rows
// x kTO output channels of one conv group and rebuilds the columns it needs
// from x through the corner rules, as the forward does.
__global__ void __launch_bounds__(kThreads) gw_kernel(const float* __restrict__ x,
                                                      const float* __restrict__ offset,
                                                      const float* __restrict__ mask,
                                                      const float* __restrict__ gout, float* __restrict__ part,
                                                      int chunk, Geo g) {
  __shared__ __align__(16) float colsT[kNC * kWStride];  // [n][row]
  __shared__ __align__(16) float goutT[kNC * kWStride];  // [n][o]
  const int K = g.kh * g.kw, P = g.OH * g.OW, HW = g.H * g.W;
  const int Cgc = g.C / g.groups, Og = g.O / g.groups, Cdg = g.C / g.dg, rows = Cgc * K;
  const int o_tiles = (Og + kTO - 1) / kTO;
  const int r0 = (blockIdx.x / o_tiles) * kTO, o0 = (blockIdx.x % o_tiles) * kTO;
  const int gi = blockIdx.y, split = blockIdx.z;
  const int total = g.B * P;
  const int n_begin = split * chunk, n_end = min(total, n_begin + chunk);
  float acc[4][4] = {};
  for (int n0 = n_begin; n0 < n_end; n0 += kNC) {
    const int nn = min(kNC, n_end - n0);
    __syncthreads();  // previous step done with colsT / goutT
    // A warp stages one row (or one output channel) at 32 consecutive
    // positions, so that its loads of offset, mask, x and gout coalesce.
    for (int e = threadIdx.x; e < kNC * kTO; e += kThreads) {
      const int r = e / kNC, n = e % kNC;
      float v = 0.f;
      if (n < nn && r0 + r < rows) {
        const int b = (n0 + n) / P, p = (n0 + n) % P;
        const int c = gi * Cgc + (r0 + r) / K, k = (r0 + r) % K;
        const TapWeights t = weights_at(g, offset, mask, b, c / Cdg, k, p);
        v = blend(x + (static_cast<size_t>(b) * g.C + c) * HW, t.y0 * g.W + t.x0, g.W, t.w);
      }
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
  float* pg = part + (static_cast<size_t>(split) * g.groups + gi) * rows * Og;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < Og) pg[static_cast<size_t>(r) * Og + o] = acc[i][j];
    }
  }
}

// gwt[e] = sum over splits, in order, of part[split][e]; "bfloat16" rounds
// the sum like the other products of that mode.
__global__ void fold_kernel(const float* __restrict__ part, float* __restrict__ gwt, int n, int splits,
                            int precision) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[static_cast<size_t>(i) * n + e];
  gwt[e] = operand(s, precision);
}

// ---- grad_x by pulling (all three .cu files) -----------------------------------
//
// A pull block owns kQT input pixels x kCW channels of one (batch,
// deformable group).  It walks a candidate list of (tap, output position)
// pairs in a fixed order, kPullThreads at a time: each thread takes one
// candidate, finds which of its corners land in the block's pixels (up to 4
// "hits"), and the block appends the hits in thread order to a list in
// shared memory.  Warp w then applies hits w, w + 4, ... to its own
// accumulator copy, each lane one channel: acc[w][pixel][lane] +=
// weight * gcol.  At the end the four copies are summed in order.  So every
// grad_x element has a fixed summation order, with no atomics.
constexpr int kQT = 64;          // input pixels per pull block
constexpr int kCW = 32;          // channels per pull block: one per lane
constexpr int kCWP = kCW + 1;    // padded accumulator row: the write-out walks pixels
constexpr int kPullThreads = 128;
constexpr int kPullWarps = kPullThreads / 32;

struct Hit {
  int pix;    // pixel within the block's tile
  int kp;     // the candidate's (tap, position) as its layout's hit(k, p)
  float w;    // mask-folded corner weight
};

struct PullSmem {
  float acc[kPullWarps][kQT][kCWP];
  Hit hits[kPullThreads * 4];
  int warp_total[kPullWarps];
};

// Append this thread's n hits (in thread order across the block) and apply
// the whole list.  Every thread of the block calls it once per chunk.
// gcol points at gcols + lay.base(b, c0); cw channels of the chunk are real.
template <class L>
__device__ __forceinline__ void pull_hits(PullSmem& sm, int n, const int (&pix)[4], const float (&w)[4], int kp,
                                          const typename L::T* __restrict__ gcol, const L& lay, int cw) {
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

__device__ __forceinline__ void pull_clear(PullSmem& sm) {
  float* a = &sm.acc[0][0][0];
  for (int e = threadIdx.x; e < kPullWarps * kQT * kCWP; e += kPullThreads) a[e] = 0.f;
  __syncthreads();
}

// Sum of the warps' copies, in order, for pixel `pix` and channel `lane`.
__device__ __forceinline__ float pull_result(const PullSmem& sm, int pix, int lane) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kPullWarps; ++w) s += sm.acc[w][pix][lane];
  return s;
}

// ---- the gather's grad_x pull (gathermm_bwd.cu, gathermm_cols_bwd.cu) ------

// One warp per (b, d, output tile): min / max flat index of the kept corners
// (with a nonzero mask-folded weight) of every tap and position of the tile.
__global__ void __launch_bounds__(kThreads) ranges_kernel(const float* __restrict__ offset,
                                                          const float* __restrict__ mask,
                                                          int2* __restrict__ ranges, Geo g) {
  const int K = g.kh * g.kw, P = g.OH * g.OW, NT = (P + kTP - 1) / kTP;
  const int wid = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (wid >= g.B * g.dg * NT) return;
  const int t = wid % NT, d = (wid / NT) % g.dg, b = wid / (NT * g.dg);
  int lo = 0x7fffffff, hi = 0;
  for (int e = lane; e < K * kTP; e += 32) {
    const int k = e / kTP, p = t * kTP + e % kTP;
    if (p >= P) continue;
    const TapWeights tw = weights_at(g, offset, mask, b, d, k, p);
    const float w[4] = {tw.w.x, tw.w.y, tw.w.z, tw.w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (w[i] == 0.f) continue;
      const int q = (tw.y0 + (i >> 1)) * g.W + tw.x0 + (i & 1);
      lo = min(lo, q);
      hi = max(hi, q + 1);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) ranges[wid] = make_int2(lo, hi);
}

// grad_x of 64 consecutive flat input pixels x 32 channels of one
// (b, deformable group), pulled from the output tiles whose corner range
// overlaps them, tile by tile and tap by tap in order.
template <class L>
__global__ void __launch_bounds__(kPullThreads) gather_gx_kernel(const float* __restrict__ offset,
                                                                 const float* __restrict__ mask,
                                                                 const typename L::T* __restrict__ gcols,
                                                                 const int2* __restrict__ ranges,
                                                                 float* __restrict__ gx, Geo g, L lay) {
  __shared__ PullSmem sm;
  const int K = g.kh * g.kw, P = g.OH * g.OW, HW = g.H * g.W, NT = (P + kTP - 1) / kTP;
  const int Cdg = g.C / g.dg, cchunks = (Cdg + kCW - 1) / kCW;
  const int q0 = blockIdx.x * kQT, q1 = min(HW, q0 + kQT);
  const int d = blockIdx.y / cchunks, c0 = d * Cdg + (blockIdx.y % cchunks) * kCW;
  const int cw = min(kCW, (d + 1) * Cdg - c0);
  const int b = blockIdx.z;
  const typename L::T* gcol = gcols + lay.base(b, c0);
  const int2* rg = ranges + (static_cast<size_t>(b) * g.dg + d) * NT;
  pull_clear(sm);
  for (int t = 0; t < NT; ++t) {
    const int2 r = rg[t];
    if (!(r.x < q1 && r.y > q0)) continue;  // uniform across the block
    for (int e0 = 0; e0 < K * kTP; e0 += kPullThreads) {
      const int e = e0 + threadIdx.x;
      const int k = e / kTP, p = t * kTP + e % kTP;
      int n = 0, pix[4];
      float w[4];
      if (e < K * kTP && p < P) {
        const TapWeights tw = weights_at(g, offset, mask, b, d, k, p);
        const float wv[4] = {tw.w.x, tw.w.y, tw.w.z, tw.w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = (tw.y0 + (i >> 1)) * g.W + tw.x0 + (i & 1);
          if (wv[i] != 0.f && q >= q0 && q < q1) {
            pix[n] = q - q0;
            w[n] = wv[i];
            ++n;
          }
        }
      }
      pull_hits(sm, n, pix, w, lay.hit(k, p), gcol, lay, cw);
    }
  }
  for (int e = threadIdx.x; e < kQT * kCW; e += kPullThreads) {
    const int cl = e / kQT, pix = e % kQT;
    if (cl < cw && q0 + pix < q1)
      gx[(static_cast<size_t>(b) * g.C + c0 + cl) * HW + q0 + pix] = pull_result(sm, pix, cl);
  }
}

// ---- host-side launches of the shared kernels -------------------------------

inline cudaError_t launch_gcols(const Geo& g, const float* wk, const float* gout, float* gcols, cudaStream_t s) {
  const int rows = g.C / g.groups * g.kh * g.kw;
  const dim3 grid((g.OH * g.OW + kTP - 1) / kTP, (rows + kTO - 1) / kTO, g.B * g.groups);
  gcols_kernel<<<grid, kThreads, 0, s>>>(wk, gout, gcols, g);
  return cudaGetLastError();
}

template <class L>
inline cudaError_t launch_goff(const Geo& g, const float* x, const float* offset, const float* mask,
                               const typename L::T* gcols, float* goff, float* gmask, L lay, cudaStream_t s) {
  const size_t n = static_cast<size_t>(g.B) * g.dg * g.kh * g.kw * g.OH * g.OW;
  goff_kernel<L><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(x, offset, mask, gcols,
                                                                                         goff, gmask, g, lay);
  return cudaGetLastError();
}

// grad_x by the gather's pull: ranges (B, dg, ceil(P / 64)) int2 scratch.
template <class L>
inline cudaError_t launch_gather_gx(const Geo& g, const float* offset, const float* mask,
                                    const typename L::T* gcols, int2* ranges, float* gx, L lay, cudaStream_t s) {
  const int NT = (g.OH * g.OW + kTP - 1) / kTP, warps = g.B * g.dg * NT;
  ranges_kernel<<<(warps + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(offset, mask, ranges, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int Cdg = g.C / g.dg;
  const dim3 grid((g.H * g.W + kQT - 1) / kQT, g.dg * ((Cdg + kCW - 1) / kCW), g.B);
  gather_gx_kernel<L><<<grid, kPullThreads, 0, s>>>(offset, mask, gcols, ranges, gx, g, lay);
  return cudaGetLastError();
}

// `splits` partials of the (batch, position) axis, each `chunk` long, then
// the fold.  The Python wrapper picks `splits` from the shapes and sizes
// `part` as (splits, groups, C/groups * K, O/groups).
inline cudaError_t launch_gw(const Geo& g, const float* x, const float* offset, const float* mask,
                             const float* gout, float* part, float* gwt, int splits, cudaStream_t s) {
  const int rows = g.C / g.groups * g.kh * g.kw, Og = g.O / g.groups;
  const int total = g.B * g.OH * g.OW, chunk = (total + splits - 1) / splits;
  const dim3 grid(((rows + kTO - 1) / kTO) * ((Og + kTO - 1) / kTO), g.groups, splits);
  gw_kernel<<<grid, kThreads, 0, s>>>(x, offset, mask, gout, part, chunk, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = g.groups * rows * Og;
  fold_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, gwt, n, splits, g.precision);
  return cudaGetLastError();
}

}  // namespace mdc

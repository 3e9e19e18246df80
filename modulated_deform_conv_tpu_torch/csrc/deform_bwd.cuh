// Pieces shared by the backward kernels.  For out = W2 cols + bias with
// cols[c, k, p] = mask * sum_corners w * x[c, corner] they compute
//
//   gcols   = W2^T gout
//   grad_x  = A gcols, A the mask-folded corner matrix (a pull)
//   grad_offset, grad_mask from the correlation S[corner] = sum_c gcol x
//   against dA/dpos and A
//   grad_weight = gout cols^T, cols recomputed from x (never saved)
//
// for the 2D fused backward (gathermm_bwd.cu, shiftblend_bwd.cu) on
// tensor-core kernels: gcols_mma_kernel, gw_mma_kernel
// + fold_kernel, corr_kernel and a pull per block of 8 x 8 input pixels x 64
// channels (gather_pull_kernel, shift_pull_kernel).  The 3D fused
// backwards (deform_bwd3d.cuh's run_bwd3d) run gcols_mma_kernel and
// gw_mma_kernel too, beside their own pulls and correlation; the columns
// path's backward (deform_cols_bwd.cuh) reads gcols through CKBP.
//
// Determinism: there is no float atomic anywhere.  Every output element has
// one owner that sums in a fixed order; grad_weight is summed in fixed-size
// splits of the (batch, position) axis, and the splits are folded in order.
// The split count depends on the shapes only.
#pragma once

#include <type_traits>

#include "deform_mma.cuh"
#include "deform_tile3d.cuh"

namespace mdc {

// ---- the columns' layout -------------------------------------------------------
//
// CKBP: gcols (C * K, B * P), row c * K + k, float32 or bf16: element
// (sample b, channel c0 + c, tap k, position p) lies at base(b, c0) +
// at(hit(k, p), c).
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

// ---- the 2D fused backward on tensor cores (gathermm_bwd.cu, shiftblend_bwd.cu)
//
// Five kernels on one stream, each reading what the earlier ones wrote:
//   x_cl_kernel      x channels-last, xt (B, H*W, C), once per call, so that
//                    every corner read below is a row of consecutive channels;
//   gcols_mma_kernel gcols (B, K, P, C) = W2^T gout on mma.sync, in the
//                    mode's arithmetic, stored fp32;
//   a pull           grad_x per 8 x 8 input pixels x 64 channels: the
//                    candidates' corner weights are evaluated once per block
//                    into a table, then each warp applies the hits on its
//                    own row of pixels in table order, lanes over channels;
//   corr_kernel      grad_offset / grad_mask: per 64 positions of one (b, d,
//                    k) the corner derivatives built once, then a warp per
//                    two positions with lanes over channels and a
//                    fixed-order butterfly;
//   gw_mma_kernel    grad_W partials on mma.sync, the columns rebuilt from xt
//                    through a corner table built once per block and step,
//                    then fold_kernel.
// The products stage their operands K-major in shared memory with cp.async,
// two stages deep.

// gcols[b][k][p][c] = sum_o W[o, c, k] gout[b, o, p] over the conv group of
// channel c.  A block owns 64 rows (tap-major, r = k * C/groups + c) x 64
// positions of one (batch, conv group) and runs the product over O/groups
// in stages of 32; the tile goes out through shared memory, so that each
// position's channels are stored as one contiguous run.  gcols is fp32 in
// every mode ("bfloat16" rounds each value to bf16): stored as bf16 it
// would halve its bytes, but the pull's 2-byte loads made the backward
// slower on the H100.  wk is (groups, O/groups, K, C/groups); gout is of
// the activations' type T and is staged in T by cp.async (a bf16 tile takes
// half its fp32 tile's bytes), widened as the product reads it.
template <int Prec, typename T>
__global__ void __launch_bounds__(kMmaThreads, 4) gcols_mma_kernel(const float* __restrict__ wk,
                                                               const T* __restrict__ gout,
                                                               float* __restrict__ gcols, Geo g) {
  __shared__ __align__(16) float sm[2][2][kMK * kMS];  // [stage][W or gout][o][row or position]
  const int K = g.kh * g.kw, P = g.OH * g.OW;
  const int Cgc = g.C / g.groups, Og = g.O / g.groups, rows = Cgc * K;
  const int p0 = blockIdx.x * kMT, r0 = blockIdx.y * kMT;
  const int b = blockIdx.z / g.groups, gi = blockIdx.z % g.groups;
  const float* wg = wk + static_cast<size_t>(gi) * Og * rows;
  const T* gb = gout + (static_cast<size_t>(b) * g.O + static_cast<size_t>(gi) * Og) * P;
  // 16 bytes a copy where every row starts 16-byte aligned (4 weights; 4
  // fp32 or 8 bf16 gout values), else one value a copy (a bf16 value by a
  // plain 2-byte copy).
  constexpr int kGV = 16 / sizeof(T);
  const bool wide = rows % 4 == 0 && P % kGV == 0 && reinterpret_cast<size_t>(wk) % 16 == 0 &&
                    reinterpret_cast<size_t>(gout) % 16 == 0;
  auto gtile = [&](int s) { return reinterpret_cast<T*>(&sm[s][1][0]); };
  auto load = [&](int s, int o0) {
    T* gt = gtile(s);
    if (wide) {
      for (int e = threadIdx.x; e < kMK * kMT / 4; e += kMmaThreads) {
        const int o = e / (kMT / 4), m = e % (kMT / 4) * 4;
        const bool wok = o0 + o < Og && r0 + m < rows;
        cp_async16(&sm[s][0][o * kMS + m], wok ? wg + static_cast<size_t>(o0 + o) * rows + r0 + m : wg, wok);
      }
      for (int e = threadIdx.x; e < kMK * kMT / kGV; e += kMmaThreads) {
        const int o = e / (kMT / kGV), m = e % (kMT / kGV) * kGV;
        const bool gok = o0 + o < Og && p0 + m < P;
        cp_async16(gt + o * kMS + m, gok ? gb + static_cast<size_t>(o0 + o) * P + p0 + m : gb, gok);
      }
    } else {
      for (int e = threadIdx.x; e < kMK * kMT; e += kMmaThreads) {
        const int o = e / kMT, m = e % kMT;
        const bool wok = o0 + o < Og && r0 + m < rows, gok = o0 + o < Og && p0 + m < P;
        cp_async4(&sm[s][0][o * kMS + m], wok ? wg + static_cast<size_t>(o0 + o) * rows + r0 + m : wg, wok);
        const T* src = gok ? gb + static_cast<size_t>(o0 + o) * P + p0 + m : gb;
        if constexpr (sizeof(T) == 4)
          cp_async4(gt + o * kMS + m, src, gok);
        else
          gt[o * kMS + m] = gok ? *src : to_elem<T>(0.f);
      }
    }
    cp_async_commit();
  };
  const int warp = threadIdx.x >> 5, wm = (warp & 1) * 32, wn = (warp >> 1) * 16;
  float acc[2][2][4] = {};
  const int steps = (Og + kMK - 1) / kMK;
  load(0, 0);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      load((st + 1) & 1, (st + 1) * kMK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_stage<Prec>(sm[st & 1][0], gtile(st & 1), wm, wn, acc);
    __syncthreads();  // the stage is reloaded two steps on
  }
  float* cS = &sm[0][0][0];  // [position][row], rows of kMT + 4
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) cS[acc_col(wn, j, v) * (kMT + 4) + acc_row(wm, i, v)] = acc[i][j][v];
  __syncthreads();
  const int r = threadIdx.x % kMT;  // every thread stores one row
  if (r0 + r >= rows) return;
  float* dst = gcols + (static_cast<size_t>(b) * K + (r0 + r) / Cgc) * P * g.C + gi * Cgc + (r0 + r) % Cgc;
  for (int pl = threadIdx.x / kMT; pl < kMT && p0 + pl < P; pl += kMmaThreads / kMT)
    dst[static_cast<size_t>(p0 + pl) * g.C] = operand(cS[pl * (kMT + 4) + r], Prec);
}

// Partial grad_weight of one split of the flattened (batch, position) axis
// n: part[split][gi][c * K + k][o] = sum_n cols[n][c, k] gout[n][o] over
// the split.  A block owns one tap k x 64 channels x 64 output channels of
// one conv group.  Every `tsteps` stages of 32 positions it builds the
// corner table of their positions for every deformable group its channels
// span (at most nd_max; tsteps = max(1, 8 / nd_max); in dynamic shared
// memory); each stage rebuilds its columns from xt, a warp reading
// consecutive channels of a corner, while cp.async brings gout; the product
// runs on the previous stage meanwhile (bf16 gout through registers: one
// value a copy is too narrow for cp.async).  G is the rank's geometry: Geo,
// or Geo3 (8 corners a tap); T the activations' type (offset, mask, gout).
template <int Prec, class G, typename T>
__global__ void __launch_bounds__(kMmaThreads, kIs3D<G> ? 2 : 3) gw_mma_kernel(
    const float* __restrict__ xt, const T* __restrict__ offset, const T* __restrict__ mask,
    const T* __restrict__ gout, float* __restrict__ part, int chunk, int tsteps, G g) {
  extern __shared__ __align__(16) float dyn[];
  constexpr bool k3D = kIs3D<G>;
  float* sA = dyn;                                              // [stage][n][channel]
  float* sB = dyn + 2 * kMK * kMS;                              // [stage][n][o]
  float4* tw = reinterpret_cast<float4*>(dyn + 4 * kMK * kMS);  // [plane][d - d0][n - n_table]: corner weights
  const int K = taps(g), P = out_positions(g);
  const int Cgc = g.C / g.groups, Og = g.O / g.groups, Cdg = g.C / g.dg;
  const int c_tiles = (Cgc + kMT - 1) / kMT, o_tiles = (Og + kMT - 1) / kMT;
  const int ot = blockIdx.x % o_tiles, ct = blockIdx.x / o_tiles % c_tiles, k = blockIdx.x / (o_tiles * c_tiles);
  const int gi = blockIdx.y, split = blockIdx.z;
  const int c0 = ct * kMT, cw = min(kMT, Cgc - c0), gc0 = gi * Cgc + c0, o0 = ot * kMT;
  const int d0 = gc0 / Cdg, nd = (gc0 + cw - 1) / Cdg - d0 + 1;
  const int tn = tsteps * kMK, n_tab = nd * tn;           // positions a table spans; its entries
  int* tq = reinterpret_cast<int*>(tw + kPlanes<G> * n_tab);  // [d - d0][n - n_table]: low corner's row in xt
  const int n_begin = split * chunk, n_end = min(g.B * P, n_begin + chunk);
  const int steps = n_end > n_begin ? (n_end - n_begin + kMK - 1) / kMK : 0;

  auto table = [&](int n0) {
    for (int e = threadIdx.x; e < n_tab; e += kMmaThreads) {
      const int n = n0 + e % tn;
      CornerRow<G> t{};
      if (n < n_end) t = corner_row(g, offset, mask, n / P, d0 + e / tn, k, n % P);
#pragma unroll
      for (int j = 0; j < kPlanes<G>; ++j) tw[j * n_tab + e] = t.w[j];
      tq[e] = t.row;
    }
  };
  // Lane l brings gout at position n0 + l for output channels warp, warp + 8,
  // ...: by cp.async in fp32; in bf16 into registers, widened into stage s
  // by put_gout after the product and the next stage's build.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr bool kRegs = !std::is_same<T, float>::value;
  constexpr int kNO = kMT / (kMmaThreads / 32);  // output channels a thread brings
  T greg[kRegs ? kNO : 1];
  auto load_gout = [&](int s, int n0) {
    float* dst = sB + s * kMK * kMS + lane * kMS;
    const int n = n0 + lane;
    const T* src = gout + (static_cast<size_t>(n / P) * g.O + static_cast<size_t>(gi) * Og + o0) * P + n % P;
#pragma unroll
    for (int i = 0; i < kNO; ++i) {
      const int o = warp + i * (kMmaThreads / 32);
      const bool ok = n < n_end && o0 + o < Og;
      if constexpr (kRegs)
        greg[i] = ok ? src[static_cast<size_t>(o) * P] : __ushort_as_bfloat16(0);
      else
        cp_async4(dst + o, ok ? src + static_cast<size_t>(o) * P : gout, ok);
    }
    cp_async_commit();
  };
  auto put_gout = [&](int s) {
    if constexpr (kRegs) {
      float* dst = sB + s * kMK * kMS + lane * kMS;
#pragma unroll
      for (int i = 0; i < kNO; ++i) dst[warp + i * (kMmaThreads / 32)] = as_float(greg[i]);
    }
  };
  // Each thread rebuilds one channel r at kPer positions (half of them at a
  // time in 3D), or, where 4 consecutive channels share a conv group and a
  // deformable group (vec), channels r4 .. r4 + 3 at kPer / 4 positions
  // with 16-byte loads and stores; all the corner loads of a pass are
  // issued before its first blend.  Corner j (of 4, or 8 in 3D) is xt's
  // row + (j & 1) + W (j >> 1 & 1) + H W (j >> 2), weighed by plane j >> 2's
  // component j & 3.
  constexpr int kPer = kMK * kMT / kMmaThreads, kCorners = 4 * kPlanes<G>;
  const bool vec = Cgc % 4 == 0 && Cdg % 4 == 0;
  const int r = threadIdx.x % kMT, gc = gc0 + r, dt = (gc / Cdg - d0) * tn;
  const int r4 = threadIdx.x % (kMT / 4) * 4, dt4 = ((gc0 + r4) / Cdg - d0) * tn;
  const size_t row = static_cast<size_t>(g.W) * g.C;
  size_t step[kCorners];
#pragma unroll
  for (int j = 0; j < kCorners; ++j) {
    step[j] = (j & 1) * static_cast<size_t>(g.C) + (j >> 1 & 1) * row;
    if constexpr (k3D) step[j] += (j >> 2) * static_cast<size_t>(g.H) * row;
  }
  auto comp = [](const float4& w, int i) { return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w; };
  auto build_vec = [&](float* dst, int n0, int n_table) {
    constexpr int kPer4 = kPer / 4, kStep = kMmaThreads / (kMT / 4);
    float4 v[kPer4][kCorners];
#pragma unroll
    for (int u = 0; u < kPer4; ++u) {
      const int n = n0 + threadIdx.x / (kMT / 4) + u * kStep;
      float4 w[kPlanes<G>];
      const float* src = xt;
#pragma unroll
      for (int j = 0; j < kPlanes<G>; ++j) w[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r4 < cw && n < n_end) {
        const int te = dt4 + n - n_table;
#pragma unroll
        for (int j = 0; j < kPlanes<G>; ++j) w[j] = tw[j * n_tab + te];
        src = xt + static_cast<size_t>(tq[te]) * g.C + gc0 + r4;
      }
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kCorners; ++j)
        v[u][j] = comp(w[j >> 2], j & 3) != 0.f ? *reinterpret_cast<const float4*>(src + step[j]) : z;
    }
#pragma unroll
    for (int u = 0; u < kPer4; ++u) {
      const int nl = threadIdx.x / (kMT / 4) + u * kStep, n = n0 + nl;
      float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r4 < cw && n < n_end) {
        const float4 w = tw[dt4 + n - n_table];
        out.x = w.x * v[u][0].x + w.y * v[u][1].x + w.z * v[u][2].x + w.w * v[u][3].x;
        out.y = w.x * v[u][0].y + w.y * v[u][1].y + w.z * v[u][2].y + w.w * v[u][3].y;
        out.z = w.x * v[u][0].z + w.y * v[u][1].z + w.z * v[u][2].z + w.w * v[u][3].z;
        out.w = w.x * v[u][0].w + w.y * v[u][1].w + w.z * v[u][2].w + w.w * v[u][3].w;
        if constexpr (k3D) {
          const float4 h = tw[n_tab + dt4 + n - n_table];
          out.x += h.x * v[u][4].x + h.y * v[u][5].x + h.z * v[u][6].x + h.w * v[u][7].x;
          out.y += h.x * v[u][4].y + h.y * v[u][5].y + h.z * v[u][6].y + h.w * v[u][7].y;
          out.z += h.x * v[u][4].z + h.y * v[u][5].z + h.z * v[u][6].z + h.w * v[u][7].z;
          out.w += h.x * v[u][4].w + h.y * v[u][5].w + h.z * v[u][6].w + h.w * v[u][7].w;
        }
      }
      *reinterpret_cast<float4*>(dst + nl * kMS + r4) = out;
    }
  };
  auto build = [&](int s, int n0, int n_table) {
    float* dst = sA + s * kMK * kMS;
    if (vec) {
      build_vec(dst, n0, n_table);
      return;
    }
    if constexpr (k3D) {
      constexpr int kPass = kPer / 2;
#pragma unroll
      for (int u0 = 0; u0 < kPer; u0 += kPass) {
        float v[kPass][kCorners];
        float4 w[kPass][2];
#pragma unroll
        for (int u = 0; u < kPass; ++u) {
          const int nl = threadIdx.x / kMT + (u0 + u) * (kMmaThreads / kMT), n = n0 + nl;
          w[u][0] = w[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
          const float* src = xt;
          if (r < cw && n < n_end) {
            const int te = dt + n - n_table;
            w[u][0] = tw[te];
            w[u][1] = tw[n_tab + te];
            src = xt + static_cast<size_t>(tq[te]) * g.C + gc;
          }
#pragma unroll
          for (int j = 0; j < kCorners; ++j) v[u][j] = comp(w[u][j >> 2], j & 3) != 0.f ? src[step[j]] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kPass; ++u) {
          float out = 0.f;
#pragma unroll
          for (int j = 0; j < kCorners; ++j) out += comp(w[u][j >> 2], j & 3) * v[u][j];
          dst[(threadIdx.x / kMT + (u0 + u) * (kMmaThreads / kMT)) * kMS + r] = out;
        }
      }
      return;
    }
    float v[kPer][4];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int nl = threadIdx.x / kMT + u * (kMmaThreads / kMT), n = n0 + nl;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* src = xt;
      if (r < cw && n < n_end) {
        const int te = dt + n - n_table;
        w = tw[te];
        src = xt + static_cast<size_t>(tq[te]) * g.C + gc;
      }
      v[u][0] = w.x != 0.f ? src[0] : 0.f;
      v[u][1] = w.y != 0.f ? src[g.C] : 0.f;
      v[u][2] = w.z != 0.f ? src[row] : 0.f;
      v[u][3] = w.w != 0.f ? src[row + g.C] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int nl = threadIdx.x / kMT + u * (kMmaThreads / kMT), n = n0 + nl;
      float out = 0.f;
      if (r < cw && n < n_end) {
        const float4 w = tw[dt + n - n_table];
        out = w.x * v[u][0];
        out += w.y * v[u][1];
        out += w.z * v[u][2];
        out += w.w * v[u][3];
      }
      dst[nl * kMS + r] = out;
    }
  };

  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 16;
  float acc[2][2][4] = {};
  int n_table = n_begin;
  if (steps > 0) {
    table(n_table);
    load_gout(0, n_begin);
    put_gout(0);
    __syncthreads();
    build(0, n_begin, n_table);
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int st = 0; st < steps; ++st) {
    const int cur = st & 1, n_next = n_begin + (st + 1) * kMK;
    const bool more = st + 1 < steps;
    if (more) {
      load_gout(cur ^ 1, n_next);
      if ((st + 1) % tsteps == 0) table(n_table = n_next);  // the last table's stages are built
    }
    mma_stage<Prec>(sA + cur * kMK * kMS, sB + cur * kMK * kMS, wm, wn, acc);
    __syncthreads();  // the table is complete; the other stage is free
    if (more) build(cur ^ 1, n_next, n_table);
    if (more) put_gout(cur ^ 1);  // after the build, so that the loads had the product and the build
    cp_async_wait<0>();
    __syncthreads();
  }
  float* pg = part + (static_cast<size_t>(split) * g.groups + gi) * Cgc * K * Og;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = acc_row(wm, i, v), o = o0 + acc_col(wn, j, v);
        if (r < cw && o < Og) pg[(static_cast<size_t>(c0 + r) * K + k) * Og + o] = acc[i][j][v];
      }
}

// The correlation of 64 consecutive positions of one (b, deformable group
// d, tap k): their corner derivatives are built once into shared memory;
// then warp w takes positions w, w + 8, ..., two at a time so that their
// loads are in flight together, lane l sums gcol * x over channels l,
// l + 32, ... of the slab for each kept corner, and warp_sum_spread sums the
// lanes' eight values in a fixed order.  gcol and the corners of xt are rows
// of consecutive channels.
// Sums each of v[0..N) over the warp's 32 lanes (N a power of two <= 32), in
// a fixed order, with N - 1 + log2(32 / N) shuffles: each step halves the
// values a lane keeps and sends the other half to its partner.  Afterwards
// lane l holds the sum of value l / (32 / N).
template <int N>
__device__ __forceinline__ float warp_sum_spread(float (&v)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = N / 2, o = 16; h >= 1; h >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h], keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
#pragma unroll
  for (int o = 16 / N; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return v[0];
}

template <typename T>
__global__ void __launch_bounds__(256, 4) corr_kernel(const float* __restrict__ xt, const T* __restrict__ offset,
                                                     const T* __restrict__ mask, const float* __restrict__ gcols,
                                                     T* __restrict__ goff, T* __restrict__ gmask, Geo g) {
  constexpr int kU = 2;             // positions a warp sums at once
  constexpr int kL = 32 / (4 * kU);  // lanes that end up holding each sum
  __shared__ TapGrad tg[kTP];
  __shared__ float tm[kTP];
  const int K = g.kh * g.kw, P = g.OH * g.OW, HW = g.H * g.W, Cdg = g.C / g.dg;
  const int p0 = blockIdx.x * kTP, k = blockIdx.y % K, d = blockIdx.y / K, b = blockIdx.z;
  if (threadIdx.x < kTP) {
    const int p = p0 + threadIdx.x, oy = p / g.OW, ox = p % g.OW, ky = k / g.kw, kx = k % g.kw;
    const size_t oidx = (static_cast<size_t>(b) * g.dg * 2 * K + static_cast<size_t>(d) * 2 * K + 2 * k) * P + p;
    TapGrad t{};
    if (p < P)
      t = tap_grad(g, oy * g.sh - g.ph + ky * g.dh, ox * g.sw - g.pw + kx * g.dw, as_float(offset[oidx]),
                   as_float(offset[oidx + P]));
    tg[threadIdx.x] = t;
    tm[threadIdx.x] = p < P ? mask_at(g, mask, b, d, k, p) : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* gp = gcols + (static_cast<size_t>(b) * K + k) * P * g.C + static_cast<size_t>(d) * Cdg;
  const float* xb = xt + static_cast<size_t>(b) * HW * g.C + static_cast<size_t>(d) * Cdg;
  const int wc = g.W * g.C;
  for (int i0 = warp; i0 < kTP; i0 += 8 * kU) {
    int keep[kU], go[kU], xo[kU];  // gcol's row and the low corner's, in elements from gp and xb
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const TapGrad& t = tg[i0 + 8 * u];
      keep[u] = t.keep;
      go[u] = min(p0 + i0 + 8 * u, P - 1) * g.C;
      xo[u] = t.keep ? (t.y0 * g.W + t.x0) * g.C : 0;
    }
    float s[kU * 4] = {};
    for (int c = lane; c < Cdg; c += 32) {
      float gv[kU], xv[kU][4];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float* xc = xb + xo[u] + c;
        gv[u] = keep[u] ? gp[go[u] + c] : 0.f;
        xv[u][0] = keep[u] & 1 ? xc[0] : 0.f;
        xv[u][1] = keep[u] & 2 ? xc[g.C] : 0.f;
        xv[u][2] = keep[u] & 4 ? xc[wc] : 0.f;
        xv[u][3] = keep[u] & 8 ? xc[wc + g.C] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[4 * u + j] = fmaf(gv[u], xv[u][j], s[4 * u + j]);
    }
    // Value 4 u + j, the sum of corner j of position u, ends in lanes
    // (4 u + j) kL ...; lane 4 u kL gathers its position's four.
    const float sum = warp_sum_spread<kU * 4>(s);
    float S[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) S[j] = __shfl_sync(0xffffffffu, sum, (lane & ~(4 * kL - 1)) + j * kL);
    const int u = lane / (4 * kL), i = i0 + 8 * u, p = p0 + i;
    if (lane % (4 * kL) == 0 && p < P) {
      const TapGrad& t = tg[i];
      const size_t oidx = (static_cast<size_t>(b) * g.dg * 2 * K + static_cast<size_t>(d) * 2 * K + 2 * k) * P + p;
      if (goff) {
        goff[oidx] = to_elem<T>(tm[i] * (t.dy.x * S[0] + t.dy.y * S[1] + t.dy.z * S[2] + t.dy.w * S[3]));
        goff[oidx + P] = to_elem<T>(tm[i] * (t.dx.x * S[0] + t.dx.y * S[1] + t.dx.z * S[2] + t.dx.w * S[3]));
      }
      if (gmask)
        gmask[(static_cast<size_t>(b) * g.dg * K + static_cast<size_t>(d) * K + k) * P + p] =
            to_elem<T>(t.w.x * S[0] + t.w.y * S[1] + t.w.z * S[2] + t.w.w * S[3]);
    }
  }
}

// ---- the 2D pulls ----------------------------------------------------------
//
// A pull block owns an 8 x 8 tile of input pixels x 64 channels of one
// (batch, deformable group), and warp w owns row w of the tile.  The block
// walks its candidates (tap, output position) in a fixed order, kCand at a
// time: it evaluates each candidate's corner weights once into a table in
// shared memory; then every warp scans the table in order for the
// candidates with a corner in its row, stages them in a small buffer of its
// own, and applies them kU at a time so that their gcols loads are in flight
// together: lane l adds weight * gcol to channels l and l + 32 of the one or
// two pixels the candidate's corners hit in the row.  Every grad_x element
// is thus summed in candidate order, with no atomics and no barrier inside
// the scan.
constexpr int kPullT = 256;   // threads of a pull block: one warp a tile row
constexpr int kPullC = 64;    // channels of a pull block: two a lane
constexpr int kPullPix = 64;  // input pixels of a pull block: 8 x 8
constexpr int kCand = 512;    // candidates a table holds
constexpr int kStage = 64;    // hits a warp stages
constexpr int kBoxTile = 4;   // the gather's output tiles: 4 x 4 positions

struct PullBlock {
  float acc[kPullPix][kPullC + 1];
  float4 cw[kCand];  // the candidates' mask-folded corner weights
  int ck[kCand];     // their gcols row: tap * P + position
  int cyx[kCand];    // their low corner from the tile's origin, (y + 16) * 64 + x + 16, clamped
  int4 stage[kPullT / 32][kStage];  // a warp's hits: gcols row, column, weights at x and x + 1
  int warp_sum[kPullT / 32];
  int list[kPullT];  // the gather's output tiles of one round
};

__device__ __forceinline__ void pull_zero(PullBlock& sm) {
  for (int e = threadIdx.x; e < kPullPix * (kPullC + 1); e += kPullT) (&sm.acc[0][0])[e] = 0.f;
}

// Table entry e: candidate (k, p), or none (zero weights) when !valid.
template <typename T>
__device__ __forceinline__ void pull_entry(PullBlock& sm, int e, bool valid, const Geo& g, const T* __restrict__ offset,
                                           const T* __restrict__ mask, int b, int d, int k, int p, int ty0, int tx0) {
  float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
  int yx = 0;
  if (valid) {
    const TapWeights tw = weights_at(g, offset, mask, b, d, k, p);
    w = tw.w;
    yx = (min(max(tw.y0 - ty0, -16), 47) + 16) * 64 + min(max(tw.x0 - tx0, -16), 47) + 16;
  }
  sm.cw[e] = w;
  sm.ck[e] = k * g.OH * g.OW + p;
  sm.cyx[e] = yx;
}

// Apply a warp's ns staged hits to its row.
__device__ __forceinline__ void pull_stage_apply(PullBlock& sm, const int4* st, int ns,
                                                 const float* __restrict__ gcol, int C, int cw) {
  constexpr int kU = 8;  // hits a warp has in flight
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const bool lo = lane < cw, hi = lane + 32 < cw;
  for (int j0 = 0; j0 < ns; j0 += kU) {
    int4 h[kU];
    float v0[kU], v1[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      h[u] = j0 + u < ns ? st[j0 + u] : make_int4(-1, 0, 0, 0);
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
      const float wa = __int_as_float(h[u].z), wb = __int_as_float(h[u].w);
      if (wa != 0.f) {
        float* a = sm.acc[row * 8 + h[u].y];
        a[lane] = fmaf(wa, v0[u], a[lane]);
        a[lane + 32] = fmaf(wa, v1[u], a[lane + 32]);
      }
      if (wb != 0.f) {
        float* a = sm.acc[row * 8 + h[u].y + 1];
        a[lane] = fmaf(wb, v0[u], a[lane]);
        a[lane + 32] = fmaf(wb, v1[u], a[lane + 32]);
      }
    }
  }
}

// Scan table entries [0, n) for the warp's row, staging and applying its
// hits in order.
__device__ __forceinline__ void pull_scan(PullBlock& sm, int n, const float* __restrict__ gcol, int C, int cw) {
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  int4* st = sm.stage[row];
  int ns = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    bool has = false;
    int4 hit = make_int4(0, 0, 0, 0);
    if (i < n) {
      const int ry = sm.cyx[i] / 64 - 16, rx = sm.cyx[i] % 64 - 16;
      const float4 w = sm.cw[i];
      float wa = ry == row ? w.x : ry + 1 == row ? w.z : 0.f;
      float wb = ry == row ? w.y : ry + 1 == row ? w.w : 0.f;
      if (rx < 0 || rx > 7) wa = 0.f;
      if (rx < -1 || rx > 6) wb = 0.f;
      has = wa != 0.f || wb != 0.f;
      hit = make_int4(sm.ck[i], rx, __float_as_int(wa), __float_as_int(wb));
    }
    const unsigned m = __ballot_sync(0xffffffffu, has);
    if (has) st[ns + __popc(m & ((1u << lane) - 1))] = hit;
    ns += __popc(m);
    if (ns > kStage - 32) {
      __syncwarp();
      pull_stage_apply(sm, st, ns, gcol, C, cw);
      ns = 0;
      __syncwarp();
    }
  }
  __syncwarp();
  pull_stage_apply(sm, st, ns, gcol, C, cw);
}

// Store the tile's grad_x (after the last scan and a barrier).
template <typename T>
__device__ __forceinline__ void pull_store(const PullBlock& sm, const Geo& g, int b, int c0, int cw, int ty0, int tx0,
                                           T* __restrict__ gx) {
  const size_t HW = static_cast<size_t>(g.H) * g.W;
  for (int e = threadIdx.x; e < kPullPix * cw; e += kPullT) {
    const int c = e / kPullPix, pix = e % kPullPix, y = ty0 + pix / 8, x = tx0 + pix % 8;
    if (y < g.H && x < g.W) gx[(static_cast<size_t>(b) * g.C + c0 + c) * HW + y * g.W + x] = to_elem<T>(sm.acc[pix][c]);
  }
}

// Block (tile, (deformable group, channel chunk), batch) of a pull grid.
struct PullCoords {
  int ty0, tx0, d, c0, cw, b;
};

__device__ __forceinline__ PullCoords pull_coords(const Geo& g) {
  const int Cdg = g.C / g.dg, cchunks = (Cdg + kPullC - 1) / kPullC, tiles_x = (g.W + 7) / 8;
  PullCoords pc;
  pc.ty0 = blockIdx.x / tiles_x * 8;
  pc.tx0 = blockIdx.x % tiles_x * 8;
  pc.d = blockIdx.y / cchunks;
  pc.c0 = pc.d * Cdg + blockIdx.y % cchunks * kPullC;
  pc.cw = min(kPullC, (pc.d + 1) * Cdg - pc.c0);
  pc.b = blockIdx.z;
  return pc;
}

inline dim3 pull_grid(const Geo& g) {
  const int Cdg = g.C / g.dg;
  return dim3(((g.H + 7) / 8) * ((g.W + 7) / 8), g.dg * ((Cdg + kPullC - 1) / kPullC), g.B);
}

// The bounded pull: every (tap, position) whose kept corners can land in the
// tile lies in the (8 + 2 Ry) x (8 + 2 Rx) halo around it (the static reach
// of the bounded-offset contract), moved back by the reach shift (Halo:
// the output rows of a sharded leading-dim block sit halo - pad rows below
// the input rows they reach); the candidates are those, tap-major.  The
// grid covers every pixel of the input, a block's halo rows included.
template <typename T>
__global__ void __launch_bounds__(kPullT) shift_pull_kernel(const T* __restrict__ offset, const T* __restrict__ mask,
                                                           const float* __restrict__ gcols, T* __restrict__ gx,
                                                           int Ry, int Rx, Geo g) {
  __shared__ PullBlock sm;
  const PullCoords pc = pull_coords(g);
  const int K = g.kh * g.kw, HS = 8 + 2 * Ry, WS = 8 + 2 * Rx, n_cand = K * HS * WS;
  const int ay = reach_shift(g.shy, g.ory, g.ph, g.kh, g.dh), ax = reach_shift(g.shx, g.orx, g.pw, g.kw, g.dw);
  const float* gcol = gcols + static_cast<size_t>(pc.b) * K * g.OH * g.OW * g.C + pc.c0;
  pull_zero(sm);
  for (int e0 = 0; e0 < n_cand; e0 += kCand) {
    for (int e = threadIdx.x; e < kCand; e += kPullT) {
      const int c = e0 + e, k = c / (HS * WS), rem = c % (HS * WS);
      const int oy = pc.ty0 - ay - Ry + rem / WS, ox = pc.tx0 - ax - Rx + rem % WS;
      pull_entry(sm, e, c < n_cand && oy >= 0 && oy < g.OH && ox >= 0 && ox < g.OW, g, offset, mask, pc.b, pc.d,
                 k, oy * g.OW + ox, pc.ty0, pc.tx0);
    }
    __syncthreads();
    pull_scan(sm, min(kCand, n_cand - e0), gcol, g.C, pc.cw);
    __syncthreads();  // the next table overwrites this one
  }
  pull_store(sm, g, pc.b, pc.c0, pc.cw, pc.ty0, pc.tx0, gx);
}

// The gather's corner boxes: one warp per (b, d, 4 x 4 output tile) writes
// [y_lo, y_hi) x [x_lo, x_hi), the input rows and columns its kept corners
// with a nonzero weight touch (empty: y_lo > y_hi).
template <typename T>
__global__ void __launch_bounds__(kThreads) boxes_kernel(const T* __restrict__ offset, const T* __restrict__ mask,
                                                         int4* __restrict__ boxes, Geo g) {
  const int K = g.kh * g.kw, NTX = (g.OW + kBoxTile - 1) / kBoxTile;
  const int NT = NTX * ((g.OH + kBoxTile - 1) / kBoxTile);
  const int wid = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (wid >= g.B * g.dg * NT) return;
  const int t = wid % NT, d = (wid / NT) % g.dg, b = wid / (NT * g.dg);
  int ylo = 0x7fffffff, yhi = -0x7fffffff, xlo = 0x7fffffff, xhi = -0x7fffffff;
  for (int e = lane; e < K * kBoxTile * kBoxTile; e += 32) {
    const int k = e / (kBoxTile * kBoxTile), j = e % (kBoxTile * kBoxTile);
    const int oy = t / NTX * kBoxTile + j / kBoxTile, ox = t % NTX * kBoxTile + j % kBoxTile;
    if (oy >= g.OH || ox >= g.OW) continue;
    const TapWeights tw = weights_at(g, offset, mask, b, d, k, oy * g.OW + ox);
    const float w[4] = {tw.w.x, tw.w.y, tw.w.z, tw.w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (w[i] == 0.f) continue;
      ylo = min(ylo, tw.y0 + (i >> 1));
      yhi = max(yhi, tw.y0 + (i >> 1) + 1);
      xlo = min(xlo, tw.x0 + (i & 1));
      xhi = max(xhi, tw.x0 + (i & 1) + 1);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ylo = min(ylo, __shfl_xor_sync(0xffffffffu, ylo, o));
    yhi = max(yhi, __shfl_xor_sync(0xffffffffu, yhi, o));
    xlo = min(xlo, __shfl_xor_sync(0xffffffffu, xlo, o));
    xhi = max(xhi, __shfl_xor_sync(0xffffffffu, xhi, o));
  }
  if (lane == 0) boxes[wid] = make_int4(ylo, yhi, xlo, xhi);
}

// The gather's pull: the candidates are the (tap, position) pairs of the
// 4 x 4 output tiles whose corner box meets the block's 8 x 8 input tile,
// tile by tile, then tap by tap.  The tiles are taken 256 at a time: one
// thread tests one box, and the tiles that meet are compacted in order.
template <typename T>
__global__ void __launch_bounds__(kPullT) gather_pull_kernel(const T* __restrict__ offset, const T* __restrict__ mask,
                                                            const float* __restrict__ gcols,
                                                            const int4* __restrict__ boxes, T* __restrict__ gx,
                                                            Geo g) {
  __shared__ PullBlock sm;
  const PullCoords pc = pull_coords(g);
  const int K = g.kh * g.kw, NTX = (g.OW + kBoxTile - 1) / kBoxTile;
  const int NT = NTX * ((g.OH + kBoxTile - 1) / kBoxTile), per_tile = K * kBoxTile * kBoxTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* gcol = gcols + static_cast<size_t>(pc.b) * K * g.OH * g.OW * g.C + pc.c0;
  const int4* bx = boxes + (static_cast<size_t>(pc.b) * g.dg + pc.d) * NT;
  pull_zero(sm);
  for (int t0 = 0; t0 < NT; t0 += kPullT) {
    bool on = false;
    if (t0 + threadIdx.x < NT) {
      const int4 r = bx[t0 + threadIdx.x];
      on = r.x < pc.ty0 + 8 && r.y > pc.ty0 && r.z < pc.tx0 + 8 && r.w > pc.tx0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, on);
    if (lane == 0) sm.warp_sum[warp] = __popc(m);
    __syncthreads();
    int pos = 0, n_on = 0;
#pragma unroll
    for (int i = 0; i < kPullT / 32; ++i) {
      const int s = sm.warp_sum[i];
      if (i < warp) pos += s;
      n_on += s;
    }
    if (on) sm.list[pos + __popc(m & ((1u << lane) - 1))] = t0 + threadIdx.x;
    __syncthreads();
    const int n_cand = n_on * per_tile;
    for (int e0 = 0; e0 < n_cand; e0 += kCand) {
      for (int e = threadIdx.x; e < kCand; e += kPullT) {
        const int c = e0 + e, t = sm.list[min(c, n_cand - 1) / per_tile];
        const int k = c % per_tile / (kBoxTile * kBoxTile), j = c % (kBoxTile * kBoxTile);
        const int oy = t / NTX * kBoxTile + j / kBoxTile, ox = t % NTX * kBoxTile + j % kBoxTile;
        pull_entry(sm, e, c < n_cand && oy < g.OH && ox < g.OW, g, offset, mask, pc.b, pc.d, k, oy * g.OW + ox,
                   pc.ty0, pc.tx0);
      }
      __syncthreads();
      pull_scan(sm, min(kCand, n_cand - e0), gcol, g.C, pc.cw);
      __syncthreads();  // the next table, or the next round's tile list, overwrites this one
    }
  }
  pull_store(sm, g, pc.b, pc.c0, pc.cw, pc.ty0, pc.tx0, gx);
}

// grad_W: gw_mma_kernel's partials over `splits` shape-only splits of the
// (batch, position) axis, folded in order into gwt.  xt (B, positions, C)
// holds x channels-last, part (splits, groups, C/groups*K, O/groups).
template <int Prec, class G, typename T>
inline cudaError_t launch_gw_mma(const G& g, const float* xt, const T* offset, const T* mask, const T* gout,
                                 float* part, float* gwt, int splits, cudaStream_t s) {
  const int K = taps(g), Cgc = g.C / g.groups, Og = g.O / g.groups, Cdg = g.C / g.dg;
  // The most deformable groups the 64 channels of one block span.
  int nd_max = 1;
  for (int gi = 0; gi < g.groups; ++gi)
    for (int c0 = 0; c0 < Cgc; c0 += kMT) {
      const int gc0 = gi * Cgc + c0, gc1 = gc0 + min(kMT, Cgc - c0) - 1;
      nd_max = max(nd_max, gc1 / Cdg - gc0 / Cdg + 1);
    }
  const int tsteps = max(1, 8 / nd_max);
  const size_t smem = sizeof(float) * 4 * kMK * kMS +
                      (kPlanes<G> * sizeof(float4) + sizeof(int)) * nd_max * tsteps * kMK;
  cudaError_t err = cudaFuncSetAttribute(gw_mma_kernel<Prec, G, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int total = g.B * out_positions(g), chunk = (total + splits - 1) / splits;
  const dim3 grid(K * ((Cgc + kMT - 1) / kMT) * ((Og + kMT - 1) / kMT), g.groups, splits);
  gw_mma_kernel<Prec, G, T><<<grid, kMmaThreads, smem, s>>>(xt, offset, mask, gout, part, chunk, tsteps, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = g.groups * Cgc * K * Og;
  fold_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, gwt, n, splits, g.precision);
  return cudaGetLastError();
}

// The 2D fused backward's launches.  pull(gcols) launches grad_x's pull.
// gcols (B, K, P, C), xt (B, H*W, C) and part (splits, groups, C/groups*K,
// O/groups) are the caller's fp32 scratch, wk and gwt fp32; x, offset,
// mask, gout and gx, goff, gmask are of the activations' type T; outputs
// not wanted are null.
template <int Prec, typename T, class Pull>
inline cudaError_t run_bwd2d(const Geo& g, const T* x, const T* offset, const T* mask, const float* wk,
                             const T* gout, float* gcols, float* xt, float* part, T* gx, T* goff, T* gmask,
                             float* gwt, int splits, cudaStream_t s, Pull pull) {
  const int K = g.kh * g.kw, P = g.OH * g.OW, HW = g.H * g.W, rows = g.C / g.groups * K;
  cudaError_t err;
  if (goff || gmask || gwt) {
    x_cl_kernel<T><<<dim3((HW + 31) / 32, (g.C + 31) / 32, g.B), 256, 0, s>>>(x, xt, g.C, HW);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (gx || goff || gmask) {
    const dim3 grid((P + kMT - 1) / kMT, (rows + kMT - 1) / kMT, g.B * g.groups);
    gcols_mma_kernel<Prec, T><<<grid, kMmaThreads, 0, s>>>(wk, gout, gcols, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (gx && (err = pull(gcols)) != cudaSuccess) return err;
  if (goff || gmask) {
    corr_kernel<T><<<dim3((P + kTP - 1) / kTP, K * g.dg, g.B), 256, 0, s>>>(xt, offset, mask, gcols, goff, gmask,
                                                                          g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (gwt && (err = launch_gw_mma<Prec>(g, xt, offset, mask, gout, part, gwt, splits, s)) != cudaSuccess)
    return err;
  return cudaSuccess;
}


}  // namespace mdc

// The forward on tensor cores, 2D (gathermm_fwd.cu, shiftblend_fwd.cu) and
// 3D (gathermm3d_fwd.cu, shiftblend3d_fwd.cu):
//
//   out = W2 cols + bias,  cols[(c, k), n] = sum_corners w * x[c, corner]
//
// with the mask and the tap gate folded into the corner weights w
// (tap_weights, tap_weights3; `windowed` adds the bounded contract's
// per-axis window), 4 corners a tap in 2D and 8 in 3D.  Three kernels on
// one stream:
//   x_cl_kernel     x channels-last, xt (B, positions, C), once per call, so
//                   that every corner is a row of consecutive channels;
//   fwd_mma_kernel  a block owns 64 output positions (128 on the xt path
//                   where one output tile holds the group) x up to OT * 64
//                   output channels of one conv group and runs the
//                   contraction over the group's (channel, tap) rows in
//                   stages of 32 rows: the next stage's weights come by
//                   cp.async while the tensor cores (mma_stage) multiply
//                   the current stage, then the block builds the next
//                   stage's columns in shared memory from a corner table
//                   that holds up to kFwdTaps taps x the deformable groups
//                   a stage spans;
//   fold_out_kernel where the contraction is split over blocks, the parts
//                   summed in order, plus the bias.
//
// Two sources for the corners, one kernel template:
//   xt    (gathermm_fwd, both 3D forwards, and shiftblend_fwd where its
//         route rule or the halo's size says so):
//         the positions are consecutive on the flattened (b, p) axis, the
//         rows run channel chunk by channel chunk (32 channels), tap by tap
//         within a chunk; a thread reads 4 consecutive channels of a
//         corner, 16 bytes, straight from xt (one channel, 4 bytes, where
//         4 channels do not share a conv group and a deformable group);
//   halo  (shiftblend_fwd, 2D only): the positions are an 8 x 8 tile of one
//         sample's output grid;
//         the bounded contract keeps every kept corner inside the tile's
//         (8 + 2 Ry) x (8 + 2 Rx) halo, centred `reach_shift` rows and
//         columns from the tile (0 on a whole input, halo - pad rows on a
//         sharded leading-dim block), so the halo of `ch` channels is
//         staged with cp.async, channels innermost, before the offsets are
//         read, one chunk of channels ahead of the chunk in use, in two
//         buffers.
//
// The rebuild factor (how many blocks build the same column values) is
// ceil(O/groups / (OT * 64)) with OT = 1, 2, 4 for O/groups <= 64, <= 128,
// above: 1 up to 256 output channels a group, 2 at 512.
//
// Determinism: each output element has one owner.  Where the grid has too
// few blocks for the card, the stages are split into a number of parts
// fixed by the shapes (the caller's `splits`), each part's sum goes to
// `part`, and fold_out_kernel adds them in order.  No float atomics.
#pragma once

#include "deform_mma.cuh"
#include "deform_tile3d.cuh"

namespace mdc {

constexpr int kFwdTaps = 9;  // taps a corner table spans (a 3x3 kernel's)
constexpr int kHaloTile = 8;  // the halo path's tile: 8 x 8 output positions

// The halo path's staging: reach beyond the tile per axis, channels a
// chunk (two buffers: the next chunk's copy overlaps the current chunk),
// and the shift from the output tile to the centre of its reach in x per
// axis (reach_shift).
struct Halo {
  int ry, rx, ch, ay, ax;
};

// Output tiles of 64 a block holds for O/groups output channels.
inline int fwd_tiles(int Og) { return Og <= kMT ? 1 : Og <= 2 * kMT ? 2 : 4; }

// Halves of 64 positions a block owns: two on the xt path where the block
// holds one output tile (the weights and the corner table then serve 128
// positions), else one.
__host__ __device__ constexpr int fwd_halves(int OT, bool halo) { return !halo && OT == 1 ? 2 : 1; }

// The layout of a block's dynamic shared memory, in floats: two stages of
// OT weight tiles and of NH column tiles (32 x kMS each), the corner table
// (tt taps x nd deformable groups x NH * 64 positions: `planes` float4s of
// weights each, then int corner indices), and the halo buffers (pixels x
// (ch + 4) floats).
struct FwdSmem {
  int tt, nd;
  size_t halo_floats;
  int planes = 1;
  size_t floats(int OT, int NH) const {
    return static_cast<size_t>(2) * (OT + NH) * kMK * kMS +
           static_cast<size_t>(tt) * nd * NH * kMT * (4 * planes + 1) + halo_floats;
  }
};

// The four corners (16 bytes each) of a column quad at src with weights wt
// (one plane of them in 3D), into registers v##0 .. v##3; a corner of
// weight 0 is not read.
#define MDC_GATHER(src, wt, v)                                                                   \
  do {                                                                                           \
    v##0 = (wt).x != 0.f ? *reinterpret_cast<const float4*>(src) : z;                            \
    v##1 = (wt).y != 0.f ? *reinterpret_cast<const float4*>((src) + dx) : z;                     \
    v##2 = (wt).z != 0.f ? *reinterpret_cast<const float4*>((src) + dy) : z;                     \
    v##3 = (wt).w != 0.f ? *reinterpret_cast<const float4*>((src) + dy + dx) : z;                \
  } while (0)
// Channel f (x, y, z or w) of the quad's blend of them.
#define MDC_BLEND(wt, v, f) \
  ((wt).x * (v##0).f + (wt).y * (v##1).f + (wt).z * (v##2).f + (wt).w * (v##3).f)
// Store a quad's four blended rows r(x) .. r(w) into column buffer buf, rows
// 4 (lq + 4 u) .. + 3 at position nl, each thread's 4 stores rotated by lq
// so that a warp's hit 32 banks.
#define MDC_STORE(buf, u, r)                                                                     \
  do {                                                                                           \
    const float r_[4] = {r(x), r(y), r(z), r(w)};                                                \
    float* row_ = sB + (buf) * kA + 4 * (lq + 4 * (u)) * kMS + nl;                               \
    _Pragma("unroll") for (int j_ = 0; j_ < 4; ++j_) {                                           \
      const int jj_ = (j_ + lq) & 3;                                                             \
      row_[jj_ * kMS] = jj_ == 0 ? r_[0] : jj_ == 1 ? r_[1] : jj_ == 2 ? r_[2] : r_[3];          \
    }                                                                                            \
  } while (0)

// fwd_mma_kernel's 3D build from 4-byte reads, for channels that do not
// come four to a conv group and a deformable group: the stage's rows lq + 4
// u (u < 8), channels c0 + row of the conv group whose first channel is
// gc0, at one position, each the blend of its 8 corners (plane z0's from
// the low corner, plane z0 + 1's dz floats on); te0 + (gc0 + c) / Cdg * np
// is channel c's corner table entry.  Out of line: inlined into the kernel,
// it cost the vector build registers and spills, and shiftblend3d_fwd took
// 3% longer at BASELINE config 4 on an H100 (chip_smoke.py).
__device__ __noinline__ void build_scalar3(float* __restrict__ dst, const float* __restrict__ xb,
                                           const float4* __restrict__ tw, const int* __restrict__ tq, int n_tab,
                                           int te0, int np, int lq, int c0, int Cgc, int gc0, int Cdg, int C, int dy,
                                           int dz) {
  for (int u = 0; u < 8; ++u) {
    const int rr = lq + 4 * u, c = c0 + rr;
    const float* src = xb;
    float4 wl = make_float4(0.f, 0.f, 0.f, 0.f), wh = wl;
    if (c < Cgc) {
      const int te = te0 + (gc0 + c) / Cdg * np;
      wl = tw[te];
      wh = tw[n_tab + te];
      src = xb + static_cast<ptrdiff_t>(tq[te]) * C + rr;
    }
    const float v0 = wl.x != 0.f ? src[0] : 0.f, v1 = wl.y != 0.f ? src[C] : 0.f;
    const float v2 = wl.z != 0.f ? src[dy] : 0.f, v3 = wl.w != 0.f ? src[dy + C] : 0.f;
    const float v4 = wh.x != 0.f ? src[dz] : 0.f, v5 = wh.y != 0.f ? src[dz + C] : 0.f;
    const float v6 = wh.z != 0.f ? src[dz + dy] : 0.f, v7 = wh.w != 0.f ? src[dz + dy + C] : 0.f;
    dst[rr * kMS] = wl.x * v0 + wl.y * v1 + wl.z * v2 + wl.w * v3 + wh.x * v4 + wh.y * v5 + wh.z * v6 + wh.w * v7;
  }
}

// G is the rank's geometry: Geo (2D) or Geo3 (3D, xt route only); T the
// activations' type (offset, mask and out; xt and the halo are fp32).
template <typename T, int Prec, int OT, bool kHalo, class G>
__global__ void __launch_bounds__(kMmaThreads, 2) fwd_mma_kernel(
    const float* __restrict__ xt, const T* __restrict__ offset, const T* __restrict__ mask,
    const float* __restrict__ wf, const float* __restrict__ bias, T* __restrict__ out,
    float* __restrict__ part, int cw_log2, int tt, int nd_tab, Halo h, G g) {
  extern __shared__ __align__(16) float dyn[];
  constexpr int kA = kMK * kMS;  // one operand tile of a stage
  constexpr int NH = fwd_halves(OT, kHalo), kNP = NH * kMT;  // the block's positions
  constexpr bool k3D = kIs3D<G>;
  static_assert(!(k3D && kHalo), "the halo route is 2D only");
  const int n_tab = tt * nd_tab * kNP;  // corner table entries
  float* sA = dyn;                // [stage][ot][row][o]
  float* sB = dyn + 2 * OT * kA;  // [stage][half][row][n]
  float4* tw = reinterpret_cast<float4*>(sB + 2 * NH * kA);  // [plane][k - wk][d - wd][n]: corner weights
  int* tq = reinterpret_cast<int*>(tw + kPlanes<G> * n_tab);  // the low corner: xt row, or halo pixel
  float* halo = reinterpret_cast<float*>(tq + n_tab);         // [buf][pixel][channel], rows of ch + 4
  const int K = taps(g), P = out_positions(g), HW = in_positions(g);
  const int Cgc = g.C / g.groups, Og = g.O / g.groups, Cdg = g.C / g.dg;
  const int o_tiles = (Og + OT * kMT - 1) / (OT * kMT);
  const int gi = blockIdx.y / o_tiles, o0 = blockIdx.y % o_tiles * OT * kMT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The block's positions: n0 + nl on the flattened (b, p) axis, or the
  // 8 x 8 tile at (ty0, tx0) of sample bh.
  int n0 = 0, bh = 0, ty0 = 0, tx0 = 0;
  if constexpr (kHalo) {
    const int tiles_x = (g.OW + kHaloTile - 1) / kHaloTile, tiles = tiles_x * ((g.OH + kHaloTile - 1) / kHaloTile);
    bh = blockIdx.x / tiles;
    ty0 = blockIdx.x % tiles / tiles_x * kHaloTile;
    tx0 = blockIdx.x % tiles % tiles_x * kHaloTile;
  } else {
    n0 = blockIdx.x * kNP;
  }
  auto where = [&](int nl, int& b, int& p) {
    if constexpr (kHalo) {
      const int y = ty0 + nl / kHaloTile, x = tx0 + nl % kHaloTile;
      b = bh;
      p = y * g.OW + x;
      return y < g.OH && x < g.OW;
    }
    const int n = n0 + nl;
    b = n / P;
    p = n % P;
    return n < g.B * P;
  };
  const int HS = kHaloTile + 2 * h.ry, WS = kHaloTile + 2 * h.rx, chp = h.ch + 4;

  // Stages: the group's channels in chunks of cw = 2^cw_log2, each chunk's
  // K * cw rows tap-major in stages of 32 rows.  Row rr of stage j of chunk
  // t is tap k0 + (rr >> cw_log2) and channel c0 + (rr & (cw - 1)) of the
  // group, k0 = 32 j / cw, c0 = t cw.  The loop walks the stages with
  // running indices; nothing below divides by a runtime value per stage.
  const int cw = 1 << cw_log2, cmask = cw - 1;
  const int nst = (K * cw + kMK - 1) / kMK;
  const int n_stages = (Cgc + cw - 1) / cw * nst;
  const int per = (n_stages + gridDim.z - 1) / gridDim.z;
  const int s_begin = min(n_stages, static_cast<int>(blockIdx.z) * per), s_end = min(n_stages, s_begin + per);
  struct Stage {
    int t, j, k0, c0;
  };
  auto stage_at = [&](int t, int j) { return Stage{t, j, (j * kMK) >> cw_log2, t << cw_log2}; };
  auto next = [&](const Stage& st) { return st.j + 1 == nst ? stage_at(st.t + 1, 0) : stage_at(st.t, st.j + 1); };

  // Weights of a stage into buffer buf: row rr, outputs o0 .. o0 + OT * 64.
  const bool wide = Og % 4 == 0 && reinterpret_cast<size_t>(wf) % 16 == 0;
  auto load_w = [&](int buf, const Stage& st) {
    float* dst = sA + buf * OT * kA;
    const float* base = wf + ((static_cast<size_t>(gi) * K + st.k0) * Cgc + st.c0) * Og + o0;
    auto one = [&](int rr, int m, bool wide_copy) {
      const int rk = rr >> cw_log2, rc = rr & cmask;
      const bool ok = st.k0 + rk < K && st.c0 + rc < Cgc && o0 + m < Og;
      const float* src = ok ? base + (static_cast<size_t>(rk) * Cgc + rc) * Og + m : wf;
      float* d = dst + m / kMT * kA + rr * kMS + m % kMT;
      if (wide_copy)
        cp_async16(d, src, ok);
      else
        cp_async4(d, src, ok);
    };
    if (wide) {
      constexpr int kPerRow = OT * kMT / 4;
#pragma unroll
      for (int e = threadIdx.x; e < kMK * kPerRow; e += kMmaThreads) one(e / kPerRow, e % kPerRow * 4, true);
    } else {
      constexpr int kPerRow = OT * kMT;
      for (int e = threadIdx.x; e < kMK * kPerRow; e += kMmaThreads) one(e / kPerRow, e % kPerRow, false);
    }
  };

  // The halo of chunk t into buffer t % 2; zeros outside the image (the
  // block).
  auto load_halo = [&](int t) {
    float* dst = halo + static_cast<size_t>(t & 1) * HS * WS * chp;
    const int quads = h.ch / 4;
    const float* src0 = xt + static_cast<size_t>(bh) * HW * g.C + gi * Cgc + t * h.ch;
    for (int e = threadIdx.x; e < HS * WS * quads; e += kMmaThreads) {
      const int pix = e / quads, q = e % quads;
      const int y = ty0 + h.ay - h.ry + pix / WS, x = tx0 + h.ax - h.rx + pix % WS;
      const bool ok = y >= 0 && y < g.H && x >= 0 && x < g.W;
      cp_async16(dst + pix * chp + 4 * q, ok ? src0 + static_cast<size_t>(y * g.W + x) * g.C + 4 * q : xt, ok);
    }
  };

  // The corner table spans taps [wk, wk + tt) and deformable groups [wd,
  // wd + nd_tab); a stage whose taps or groups leave it rebuilds it.  The
  // deformable groups of a chunk (dr0 .. dr1, and those of this thread's
  // two channel quads) are found once per chunk.
  int wk = -K - kMK, wd = 0, t_dg = -1, dr0 = 0, dr1 = 0, dq[2] = {0, 0};
  const int nl = warp * 8 + (lane & 7), lq = lane >> 3;
  auto ensure_table = [&](const Stage& st) {
    if (st.t != t_dg) {
      t_dg = st.t;
      const int a = gi * Cgc + st.c0;
      dr0 = a / Cdg;
      dr1 = (min(gi * Cgc + Cgc, a + cw) - 1) / Cdg;
      dq[0] = (a + 4 * lq) / Cdg;
      dq[1] = (a + 4 * lq + 16) / Cdg;
    }
    const int k1 = min(K, st.k0 + (kMK >> cw_log2));
    if (st.k0 >= wk && k1 <= wk + tt && dr0 >= wd && dr1 < wd + nd_tab) return false;
    wk = st.k0;
    wd = dr0;
    // Four entries a thread at a time, their offsets (ND a tap, offset
    // channels d * ND * K + ND * k + axis) and masks read before any is
    // used, so that the reads are in flight together.
    constexpr int kU = 4, ND = k3D ? 3 : 2;
    for (int e0 = threadIdx.x; e0 < n_tab; e0 += kU * kMmaThreads) {
      float o[kU][ND], m[kU];
      int b[kU], p[kU], k[kU];
      bool ok[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * kMmaThreads, d = wd + e / kNP % nd_tab;
        k[u] = wk + e / (nd_tab * kNP);
        ok[u] = e < n_tab && k[u] < K && d < g.dg && where(e % kNP, b[u], p[u]);
#pragma unroll
        for (int a = 0; a < ND; ++a) o[u][a] = 0.f;
        m[u] = 1.f;
        if (ok[u]) {
          const size_t oidx = ((static_cast<size_t>(b[u]) * g.dg + d) * ND * K + ND * k[u]) * P + p[u];
#pragma unroll
          for (int a = 0; a < ND; ++a) o[u][a] = as_float(offset[oidx + static_cast<size_t>(a) * P]);
          if (mask) m[u] = as_float(mask[((static_cast<size_t>(b[u]) * g.dg + d) * K + k[u]) * P + p[u]]);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * kMmaThreads;
        if (e >= n_tab) break;
        if constexpr (k3D) {
          TapWeights3 tap{0, 0, 0, make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
          if (ok[u]) {
            int bz, by, bx;
            tap_base3(g, k[u], p[u], bz, by, bx);
            tap = tap_weights3(g, bz, by, bx, o[u][0], o[u][1], o[u][2], m[u]);
          }
          tw[e] = tap.lo;
          tw[n_tab + e] = tap.hi;
          tq[e] = ok[u] ? b[u] * HW + (tap.z0 * g.H + tap.y0) * g.W + tap.x0 : 0;
        } else {
          TapWeights tap{0, 0, make_float4(0.f, 0.f, 0.f, 0.f)};
          if (ok[u]) {
            const int ky = k[u] / g.kw, kx = k[u] % g.kw, oyp = p[u] / g.OW, oxp = p[u] % g.OW;
            tap = tap_weights(g, oyp * g.sh - g.ph + ky * g.dh, oxp * g.sw - g.pw + kx * g.dw, o[u][0], o[u][1],
                              m[u]);
          }
          tw[e] = tap.w;
          tq[e] = !ok[u] ? 0
                  : kHalo ? (tap.y0 - ty0 - h.ay + h.ry) * WS + tap.x0 - tx0 - h.ax + h.rx
                          : b[u] * HW + tap.y0 * g.W + tap.x0;
        }
      }
    }
    return true;
  };

  // Columns of a stage.  Thread (warp w, lane l) owns position nl = 8 w +
  // l % 8 of each half of the block's positions.  With 4 channels of one
  // deformable group a quad (vec), it reads the 4 corners (8 in 3D) of
  // quads l / 8 and l / 8 + 4 of the stage's rows, 16 bytes each, into
  // registers (MDC_GATHER), then blends them and stores each quad's 4 rows
  // rotated by l / 8, so that a warp's stores hit 32 banks (MDC_STORE);
  // otherwise (build_scalar) it blends rows l / 8 + 4 u, u < 8, from 4-byte
  // reads.  A corner of weight 0 is never read: its address may lie
  // outside x.
  const bool vec = Cgc % 4 == 0 && Cdg % 4 == 0;
  const int dx = kHalo ? chp : g.C, dy = kHalo ? WS * chp : g.W * g.C;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  // The corner rows of quad u of a stage at position nl of half hh: its
  // table entry's weights (wh: plane z0 + 1's, 3D) and first corner's
  // address (weights 0 for a row past the taps or the channels).
  auto corner = [&](const Stage& st, int u, int hh, float4& w, float4& wh) -> const float* {
    const int rr = 4 * (lq + 4 * u), rk = rr >> cw_log2, rc = rr & cmask, k = st.k0 + rk;
    w = wh = z;
    if (k >= K || st.c0 + rc >= Cgc) return xt;
    const int te = ((k - wk) * nd_tab + (kHalo ? 0 : dq[u] - wd)) * kNP + hh * kMT + nl;
    w = tw[te];
    if constexpr (k3D) wh = tw[n_tab + te];
    if constexpr (kHalo) return halo + static_cast<size_t>(st.t & 1) * HS * WS * chp + tq[te] * chp + rc;
    return xt + gi * Cgc + st.c0 + static_cast<ptrdiff_t>(tq[te]) * g.C + rc;
  };
  // Only the xt path comes here (the halo's chunks are whole quads): rows
  // l / 8 + 4 u, four at a time (in 3D, build_scalar3).
  auto build_scalar = [&](int buf, int hh, const Stage& st) {
    float* dst = sB + buf * kA;
    const float* xb = xt + gi * Cgc + st.c0;
    if constexpr (k3D) {
      build_scalar3(dst + nl, xb, tw, tq, n_tab, ((st.k0 - wk) * nd_tab - wd) * kNP + hh * kMT + nl, kNP, lq,
                    st.c0, Cgc, gi * Cgc, Cdg, g.C, g.W * g.C, g.H * g.W * g.C);
      return;
    }
#pragma unroll
    for (int u0 = 0; u0 < 8; u0 += 4) {
      float v[4][4], w[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rr = lq + 4 * (u0 + u), c = st.c0 + rr;
        const float* src = xt;
        float4 a = z;
        if (c < Cgc) {
          const int te = ((st.k0 - wk) * nd_tab + (gi * Cgc + c) / Cdg - wd) * kNP + hh * kMT + nl;
          a = tw[te];
          src = xb + static_cast<ptrdiff_t>(tq[te]) * g.C + rr;
        }
        w[u][0] = a.x, w[u][1] = a.y, w[u][2] = a.z, w[u][3] = a.w;
        v[u][0] = a.x != 0.f ? src[0] : 0.f;
        v[u][1] = a.y != 0.f ? src[dx] : 0.f;
        v[u][2] = a.z != 0.f ? src[dy] : 0.f;
        v[u][3] = a.w != 0.f ? src[dy + dx] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        dst[(lq + 4 * (u0 + u)) * kMS + nl] =
            w[u][0] * v[u][0] + w[u][1] * v[u][1] + w[u][2] * v[u][2] + w[u][3] * v[u][3];
    }
  };

  // One barrier a stage.  Iteration s issues stage s + 1's weights (and,
  // at a chunk's start, a halo) as one cp.async group, rebuilds the table
  // if stage s + 1 leaves it (then a barrier), runs stage s's product, then
  // builds stage s + 1's columns into the buffer that stage s - 1's product
  // released at the previous barrier.
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 16;
  const int t_last = s_end > s_begin ? (s_end - 1) / nst : 0;
  float acc[NH][OT][2][2][4] = {};
  auto build = [&](int stage_buf, const Stage& st) {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const int buf = stage_buf * NH + hh;
      if constexpr (k3D) {
        if (vec) {
          // A quad's 8 corners: plane z0's into a, plane z0 + 1's into b.
          const int dz = g.H * g.W * g.C;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float4 wl, wh, a0, a1, a2, a3, b0, b1, b2, b3;
            const float* p = corner(st, u, hh, wl, wh);
            MDC_GATHER(p, wl, a);
            MDC_GATHER(p + dz, wh, b);
#define MDC_R(f) (MDC_BLEND(wl, a, f) + MDC_BLEND(wh, b, f))
            MDC_STORE(buf, u, MDC_R);
#undef MDC_R
          }
        } else {
          build_scalar(buf, hh, st);
        }
      } else if (vec) {
        float4 w0, w1, unused, a0, a1, a2, a3, b0, b1, b2, b3;
        const float* p0 = corner(st, 0, hh, w0, unused);
        const float* p1 = corner(st, 1, hh, w1, unused);
        MDC_GATHER(p0, w0, a);
        MDC_GATHER(p1, w1, b);
#define MDC_R0(f) MDC_BLEND(w0, a, f)
#define MDC_R1(f) MDC_BLEND(w1, b, f)
        MDC_STORE(buf, 0, MDC_R0);
        MDC_STORE(buf, 1, MDC_R1);
#undef MDC_R0
#undef MDC_R1
      } else {
        build_scalar(buf, hh, st);
      }
    }
  };
  Stage cur_st = stage_at(s_begin / nst, s_begin % nst);
  if (s_begin < s_end) {
    load_w(0, cur_st);
    if constexpr (kHalo) {
      load_halo(cur_st.t);
      if (cur_st.t + 1 <= t_last) load_halo(cur_st.t + 1);
    }
    cp_async_commit();
    ensure_table(cur_st);
    cp_async_wait<0>();
    __syncthreads();
    build(0, cur_st);
    __syncthreads();
  }
  for (int s = s_begin; s < s_end; ++s) {
    const int cur = (s - s_begin) & 1;
    const bool more = s + 1 < s_end;
    const Stage nx = next(cur_st);
    if (more) {
      load_w(cur ^ 1, nx);
      // Stage s + 1 starts chunk nx.t: chunk nx.t + 1's halo goes to the
      // buffer that chunk nx.t - 1's last build released.
      if (kHalo && nx.j == 0 && nx.t + 1 <= t_last) load_halo(nx.t + 1);
      cp_async_commit();
      if (ensure_table(nx)) __syncthreads();
    }
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int ot = 0; ot < OT; ++ot)
        mma_stage<Prec>(sA + (cur * OT + ot) * kA, sB + (cur * NH + hh) * kA, wm, wn, acc[hh][ot]);
    if (more) build(cur ^ 1, nx);
    cp_async_wait<0>();
    __syncthreads();
    cur_st = nx;
  }

  // The tile through shared memory, [o][n] with rows of kNP + 4, so that a
  // warp stores consecutive positions of one output channel.
  __syncthreads();
  float* cS = dyn;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            cS[(ot * kMT + acc_row(wm, i, v)) * (kNP + 4) + hh * kMT + acc_col(wn, j, v)] = acc[hh][ot][i][j][v];
  __syncthreads();
  for (int ol = warp; ol < OT * kMT && o0 + ol < Og; ol += kMmaThreads / 32) {
    const int oc = gi * Og + o0 + ol;
    const float bv = part == nullptr && bias != nullptr ? bias[oc] : 0.f;
    for (int n = lane; n < kNP; n += 32) {
      int b, p;
      if (!where(n, b, p)) continue;
      const float v = cS[ol * (kNP + 4) + n] + bv;
      if (part)
        part[((static_cast<size_t>(blockIdx.z) * g.B + b) * g.O + oc) * P + p] = v;
      else
        out[(static_cast<size_t>(b) * g.O + oc) * P + p] = to_elem<T>(v);
    }
  }
}

#undef MDC_STORE
#undef MDC_BLEND
#undef MDC_GATHER

// out[e] = sum of the splits' parts in order, plus the bias, in fp32, then
// rounded to out's type.
template <typename T>
__global__ void __launch_bounds__(256) fold_out_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                                                       T* __restrict__ out, size_t n, int splits, int O, int P) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < splits; ++i) s += part[i * n + e];
    out[e] = to_elem<T>(s + (bias ? bias[e / P % O] : 0.f));
  }
}

template <int Prec, int OT, bool kHalo, class G, typename T>
inline cudaError_t launch_fwd_mma(const G& g, const float* xt, const T* offset, const T* mask, const float* wf,
                                  const float* bias, T* out, float* part, int splits, int cw, const FwdSmem& sm,
                                  const Halo& h, cudaStream_t s) {
  int cw_log2 = 0;
  while ((1 << cw_log2) < cw) ++cw_log2;
  constexpr int NH = fwd_halves(OT, kHalo);
  const size_t smem = sm.floats(OT, NH) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = fwd_mma_kernel<T, Prec, OT, kHalo, G>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int Og = g.O / g.groups;
  const int blocks = kHalo ? g.B * ((g.OH + kHaloTile - 1) / kHaloTile) * ((g.OW + kHaloTile - 1) / kHaloTile)
                           : (g.B * out_positions(g) + NH * kMT - 1) / (NH * kMT);
  const dim3 grid(blocks, g.groups * ((Og + OT * kMT - 1) / (OT * kMT)), splits);
  kern<<<grid, kMmaThreads, smem, s>>>(xt, offset, mask, wf, bias, out, splits > 1 ? part : nullptr, cw_log2,
                                       sm.tt, sm.nd, h, g);
  return cudaGetLastError();
}

template <int Prec, bool kHalo, class G, typename T>
inline cudaError_t launch_fwd_ot(const G& g, const float* xt, const T* offset, const T* mask, const float* wf,
                                 const float* bias, T* out, float* part, int splits, int cw, const FwdSmem& sm,
                                 const Halo& h, cudaStream_t s) {
  switch (fwd_tiles(g.O / g.groups)) {
    case 1: return launch_fwd_mma<Prec, 1, kHalo>(g, xt, offset, mask, wf, bias, out, part, splits, cw, sm, h, s);
    case 2: return launch_fwd_mma<Prec, 2, kHalo>(g, xt, offset, mask, wf, bias, out, part, splits, cw, sm, h, s);
    default: return launch_fwd_mma<Prec, 4, kHalo>(g, xt, offset, mask, wf, bias, out, part, splits, cw, sm, h, s);
  }
}

template <bool kHalo, class G, typename T>
inline cudaError_t launch_fwd(const G& g, const float* xt, const T* offset, const T* mask, const float* wf,
                              const float* bias, T* out, float* part, int splits, int cw, const FwdSmem& sm,
                              const Halo& h, cudaStream_t s) {
  switch (g.precision) {
    case kFloat32:
      return launch_fwd_ot<kFloat32, kHalo>(g, xt, offset, mask, wf, bias, out, part, splits, cw, sm, h, s);
    case kTensorFloat32:
      return launch_fwd_ot<kTensorFloat32, kHalo>(g, xt, offset, mask, wf, bias, out, part, splits, cw, sm, h, s);
    default:
      return launch_fwd_ot<kBFloat16, kHalo>(g, xt, offset, mask, wf, bias, out, part, splits, cw, sm, h, s);
  }
}

// The most deformable groups that a chunk of cw channels of one conv group
// spans.
template <class G>
inline int chunk_groups(const G& g, int cw) {
  const int Cgc = g.C / g.groups, Cdg = g.C / g.dg;
  int nd = 1;
  for (int gi = 0; gi < g.groups; ++gi)
    for (int c0 = 0; c0 < Cgc; c0 += cw) {
      const int a = gi * Cgc + c0, z = gi * Cgc + min(Cgc, c0 + cw) - 1;
      nd = max(nd, z / Cdg - a / Cdg + 1);
    }
  return nd;
}

// The forward: xt (B, positions, C) and part (splits, B, O, output
// positions; unused when splits == 1) are the caller's fp32 scratch, wf the
// weight as (groups, K, C/groups, O/groups) and bias, both fp32; x, offset,
// mask and out are of the activations' type T.  With `halo` (shiftblend_fwd,
// windowed geometry and the halo's reach given) the halo path runs where
// two buffers of its narrowest chunk fit in shared memory, the xt path
// elsewhere.  3D takes the xt path.
template <class G, typename T>
inline cudaError_t run_fwd(const G& g, const T* x, const T* offset, const T* mask, const float* wf,
                           const float* bias, T* out, float* xt, float* part, int splits, const Halo* halo,
                           cudaStream_t s) {
  const int HW = in_positions(g), K = taps(g), OT = fwd_tiles(g.O / g.groups);
  x_cl_kernel<T><<<dim3((HW + 31) / 32, (g.C + 31) / 32, g.B), 256, 0, s>>>(x, xt, g.C, HW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bool done = false;
  if constexpr (!kIs3D<G>) {
    if (halo) {
      // The widest chunk (32, 16 or 8 channels of one deformable group)
      // whose two buffers leave room for two blocks an SM, else for one.
      const size_t pix = static_cast<size_t>(kHaloTile + 2 * halo->ry) * (kHaloTile + 2 * halo->rx);
      const int Cdg = g.C / g.dg;
      Halo h = *halo;
      FwdSmem sm{min(K, kFwdTaps), 1, 0};
      bool fits = false;
      for (size_t budget = kMaxSmem / 2; budget <= kMaxSmem && !fits; budget *= 2)
        for (int ch = 32; ch >= 8 && !fits; ch /= 2) {
          if (Cdg % ch) continue;
          sm.halo_floats = 2 * pix * (ch + 4);
          h.ch = ch;
          fits = sm.floats(OT, 1) * sizeof(float) <= budget;
        }
      if (fits) {
        if ((err = launch_fwd<true>(g, xt, offset, mask, wf, bias, out, part, splits, h.ch, sm, h, s)) !=
            cudaSuccess)
          return err;
        done = true;
      }
    }
  }
  if (!done) {
    const int nd = chunk_groups(g, kMK);
    const FwdSmem sm{max(1, min(K, kFwdTaps / nd)), nd, 0, kPlanes<G>};
    if ((err = launch_fwd<false>(g, xt, offset, mask, wf, bias, out, part, splits, kMK, sm, Halo{0, 0, 8, 0, 0}, s)) !=
        cudaSuccess)
      return err;
  }
  if (splits > 1) {
    const size_t n = static_cast<size_t>(g.B) * g.O * out_positions(g);
    const size_t blocks = (n + 255) / 256;
    fold_out_kernel<T><<<static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, s>>>(
        part, bias, out, n, splits, g.O, out_positions(g));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace mdc

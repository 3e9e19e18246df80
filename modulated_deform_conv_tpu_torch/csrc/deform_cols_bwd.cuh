// The columns path's backward gather, both ranks (gathermm_cols_bwd.cu,
// gathermm3d_cols_bwd.cu).  Given gcols, the cotangent of the columns in
// their layout CKBP ((C * K, B * P), row c * K + k: for a fixed channel, tap
// and sample the positions are contiguous), it computes
//
//   grad_x = A gcols, A the mask-folded corner matrix (a pull)
//   S[corner] = sum_c gcol x[corner], the correlation, and from it
//   grad_offset = mask * sum dA/dpos S per axis, grad_mask = sum A S
//
// in seven launches on one stream:
//   col_count_kernel   bins every (tap, position) candidate of every (b, d)
//                      into the input tiles its kept corners fall in: one
//                      warp per run of kColCB candidates counts, per tile,
//                      the candidates it sends there (int atomics: the
//                      counts do not depend on their order);
//   col_scan_*_kernel  turn the counts into each run's place in each tile's
//                      table (exclusive scans, rows then tiles);
//   col_fill_kernel    writes each tile's table: its candidates in
//                      candidate order (tap, then position), each with its
//                      gcols column, its low corner from the tile's origin,
//                      its kept corners and its mask-folded weights.  A warp
//                      places its run's entries in order; only that warp
//                      touches the run's cursors;
//   col_index_kernel   lists, once per tile and piece of kColCap entries,
//                      the piece's hits (corners in the tile with a nonzero
//                      weight) by pixel;
//   col_pull_kernel    a block per (input tile, (deformable group, 32
//                      channels), sample) walks its tile's table piece by
//                      piece: it gathers the next piece's gcols values of
//                      its channels into shared memory (lanes over
//                      consecutive positions, so the reads run along gcols'
//                      contiguous axis) while thread (pixel, channel group)
//                      adds its pixel's hits of this piece, in list order,
//                      to its registers (grad_x: each pixel x channel has
//                      one owner), and two threads an entry sum gcol x over
//                      the block's channels for the entries the tile owns
//                      (their first kept corner lies in the tile), x staged
//                      once a block for the tile and one more row, column
//                      and plane: partial S per channel chunk, from the
//                      gcols values staged for the pull;
//   col_fold_kernel    sums the partials of each (b, d, tap, position) in
//                      chunk order and applies the corner derivatives; the
//                      mask stays apart, so grad_mask is exact where it is 0.
// Each candidate with an open gate is owned by exactly one tile, so every
// partial S is written once.  No float atomics: every output element has one
// owner that sums in a fixed order, so two runs give the same bits.
#pragma once

#include <type_traits>

#include "deform_bwd.cuh"

namespace mdc {

constexpr int kColBT = 256;   // threads of the table, pull and fold blocks: 8 warps
constexpr int kColCB = 256;   // candidates a warp bins (count and fill)
constexpr int kColCc = 32;    // channels a pull block: one a lane
constexpr int kColCap = 128;  // table entries a pull piece
constexpr int kColIdxSplit = 8;  // blocks that list a tile's pieces, every 8th piece each

// The input tiles: tz x ty x tx pixels (tz = 1 in 2D), nz x ny x nx of
// them; xz x xy x xx the x a pull block stages for its correlation: the
// tile and one more plane, row and column, cut to the input (xz = 1 in 2D).
struct ColTiles {
  int tz, ty, tx, nz, ny, nx, xz, xy, xx;
};

__host__ __device__ inline int in_depth(const Geo&) { return 1; }
__host__ __device__ inline int in_depth(const Geo3& g) { return g.D; }

// A candidate: tap k at output position p of (b, d).  Corner i (of 4, or 8
// in 3D) is (z0 + (i >> 2), y0 + (i >> 1 & 1), x0 + (i & 1)), kept where bit
// i of keep is set (keep is 0 when the gate is closed), weighed by component
// i & 3 of w[i >> 2] with the mask folded in (zero where not kept).
template <class G>
struct Cand {
  int z0, y0, x0, keep;
  float4 w[kPlanes<G>];
};

template <typename TX>
__device__ __forceinline__ Cand<Geo> cand_at(const Geo& g, const TX* __restrict__ offset, const TX* __restrict__ mask,
                                             int b, int d, int k, int p) {
  const TapWeights t = weights_at(g, offset, mask, b, d, k, p);
  return Cand<Geo>{0, t.y0, t.x0, t.keep, {t.w}};
}

template <typename TX>
__device__ __forceinline__ Cand<Geo3> cand_at(const Geo3& g, const TX* __restrict__ offset,
                                              const TX* __restrict__ mask, int b, int d, int k, int p) {
  const TapWeights3 t = weights3_at(g, offset, mask, b, d, k, p);
  return Cand<Geo3>{t.z0, t.y0, t.x0, t.keep, {t.lo, t.hi}};
}

__device__ __forceinline__ float comp4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ int tile_of(const ColTiles& tl, int z, int y, int x) {
  return ((z / tl.tz) * tl.ny + y / tl.ty) * tl.nx + x / tl.tx;
}

// The tiles a candidate goes to, each once: first its owner, the tile of
// its first kept corner (per axis max(low corner, 0), always kept when the
// gate is open), then the tiles of its kept corners with a nonzero weight.
// Returns their count (0 when the gate is closed).
template <class G>
__device__ __forceinline__ int cand_tiles(const ColTiles& tl, const Cand<G>& c, int (&t)[4 * kPlanes<G>]) {
  if (!c.keep) return 0;
  int n = 1;
  t[0] = tile_of(tl, max(c.z0, 0), max(c.y0, 0), max(c.x0, 0));
#pragma unroll
  for (int i = 0; i < 4 * kPlanes<G>; ++i) {
    if (comp4(c.w[i >> 2], i & 3) == 0.f) continue;
    const int u = tile_of(tl, c.z0 + (i >> 2), c.y0 + (i >> 1 & 1), c.x0 + (i & 1));
    bool seen = false;
    for (int j = 0; j < n; ++j) seen = seen || t[j] == u;
    if (!seen) t[n++] = u;
  }
  return n;
}

// One table entry: gcols column h = lay.hit(tap, position); the low corner
// from the tile's origin, ((z + 1) << 20 | (y + 1) << 10 | (x + 1)); the kept
// corners | owned << 8; the mask-folded weights.  32 bytes in 2D, 48 in 3D.
template <class G>
struct ColEntry {
  int h, rel, meta, pad;
  float4 w[kPlanes<G>];
};

// ---- the table -----------------------------------------------------------------

// cnt[bd][t][run] += the candidates of run `run` that go to tile t.  A warp
// per run of kColCB candidates of one (b, d) (blockIdx.y = b * dg + d).
template <class G, typename TX>
__global__ void __launch_bounds__(kColBT) col_count_kernel(const TX* __restrict__ offset, const TX* __restrict__ mask,
                                                          int* __restrict__ cnt, G g, ColTiles tl, int runs) {
  const int run = blockIdx.x * (kColBT / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (run >= runs) return;
  const int K = taps(g), P = out_positions(g), NT = tl.nz * tl.ny * tl.nx, bd = blockIdx.y;
  const int b = bd / g.dg, d = bd % g.dg;
  int* col = cnt + static_cast<size_t>(bd) * NT * runs + run;
  const int i = run * kColCB + lane, i1 = min(K * P, (run + 1) * kColCB);
  for (int e = i; e < i1; e += 32) {
    int t[4 * kPlanes<G>];
    const int n = cand_tiles(tl, cand_at(g, offset, mask, b, d, e / P, e % P), t);
    for (int j = 0; j < n; ++j) atomicAdd(col + static_cast<size_t>(t[j]) * runs, 1);
  }
}

// Exclusive sum of v over the block's kColBT threads, in thread order, and
// the total.  Every thread calls it; ws holds one int a warp.
__device__ __forceinline__ int col_block_scan(int v, int* ws, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += u;
  }
  if (lane == 31) ws[warp] = s;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kColBT / 32; ++w) {
    if (w < warp) before += ws[w];
    total += ws[w];
  }
  __syncthreads();  // ws is written again by the next call
  return before + s - v;
}

// Row (bd, t) of cnt turned into its exclusive sums over the runs, in place;
// tcount[bd][t] = the row's total.  A block per row.
__global__ void __launch_bounds__(kColBT) col_scan_rows_kernel(int* __restrict__ cnt, int* __restrict__ tcount,
                                                              int runs) {
  __shared__ int ws[kColBT / 32];
  int* row = cnt + static_cast<size_t>(blockIdx.x) * runs;
  int carry = 0;
  for (int r0 = 0; r0 < runs; r0 += kColBT) {
    const int r = r0 + threadIdx.x;
    const int v = r < runs ? row[r] : 0;
    int total;
    const int ex = col_block_scan(v, ws, total);
    if (r < runs) row[r] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) tcount[blockIdx.x] = carry;
}

// tstart[bd][t] = the first entry of tile t of (b, d) in the pool: the
// tiles of (b, d) lie one after another from bd * pool_bd, each starting on
// a whole piece of kColCap entries.  A block per bd.
__global__ void __launch_bounds__(kColBT) col_scan_tiles_kernel(const int* __restrict__ tcount,
                                                               long long* __restrict__ tstart, int NT,
                                                               long long pool_bd) {
  __shared__ int ws[kColBT / 32];
  const size_t row = static_cast<size_t>(blockIdx.x) * NT;
  long long carry = static_cast<long long>(blockIdx.x) * pool_bd;
  for (int t0 = 0; t0 < NT; t0 += kColBT) {
    const int t = t0 + threadIdx.x;
    const int v = t < NT ? (tcount[row + t] + kColCap - 1) / kColCap * kColCap : 0;
    int total;
    const int ex = col_block_scan(v, ws, total);
    if (t < NT) tstart[row + t] = carry + ex;
    carry += total;
  }
}

// The tables: each candidate's entry in each of its tiles, at tstart[tile] +
// cur[bd][tile][run] (the row sums of col_scan_rows_kernel, advanced here as
// the run's entries are placed).  A warp per run: its candidates 32 at a
// time, their (candidate, tile) items listed in candidate order in shared
// memory, then placed 32 at a time: the lanes with the same tile
// (__match_any_sync) take consecutive places from the tile's cursor, in
// lane order.  Only this warp moves the run's cursors, so the places
// depend on nothing but the data.
template <class G, typename TX>
__global__ void __launch_bounds__(kColBT) col_fill_kernel(const TX* __restrict__ offset, const TX* __restrict__ mask,
                                                         int* __restrict__ cur,
                                                         const long long* __restrict__ tstart,
                                                         ColEntry<G>* __restrict__ pool, G g, ColTiles tl, int runs) {
  constexpr int kItems = 4 * kPlanes<G>;
  __shared__ Cand<G> cands[kColBT / 32][32];
  __shared__ int item_tile[kColBT / 32][32 * kItems];
  __shared__ int item_lane[kColBT / 32][32 * kItems];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int run = blockIdx.x * (kColBT / 32) + warp;
  if (run >= runs) return;
  const int K = taps(g), P = out_positions(g), NT = tl.nz * tl.ny * tl.nx, bd = blockIdx.y;
  const int b = bd / g.dg, d = bd % g.dg, BP = g.B * P;
  int* col = cur + static_cast<size_t>(bd) * NT * runs + run;
  const long long* ts = tstart + static_cast<size_t>(bd) * NT;
  const int i0 = run * kColCB, i1 = min(K * P, (run + 1) * kColCB);
  for (int e0 = i0; e0 < i1; e0 += 32) {
    const int e = e0 + lane;
    int t[kItems], n = 0;
    if (e < i1) {
      const Cand<G> c = cand_at(g, offset, mask, b, d, e / P, e % P);
      cands[warp][lane] = c;
      n = cand_tiles(tl, c, t);
    }
    int s = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    const int total = __shfl_sync(0xffffffffu, s, 31);
    for (int j = 0; j < n; ++j) {
      item_tile[warp][s - n + j] = t[j];
      item_lane[warp][s - n + j] = lane;
    }
    __syncwarp();
    for (int m0 = 0; m0 < total; m0 += 32) {
      const int m = m0 + lane;
      const int key = m < total ? item_tile[warp][m] : -1;
      const unsigned same = __match_any_sync(0xffffffffu, key);
      const int leader = __ffs(same) - 1;
      int base = 0;
      if (key >= 0 && lane == leader) base = atomicAdd(col + static_cast<size_t>(key) * runs, __popc(same));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (key >= 0) {
        const int src = item_lane[warp][m];
        const Cand<G>& c = cands[warp][src];
        const int tz0 = key / (tl.ny * tl.nx) * tl.tz, ty0 = key / tl.nx % tl.ny * tl.ty, tx0 = key % tl.nx * tl.tx;
        const int own = tile_of(tl, max(c.z0, 0), max(c.y0, 0), max(c.x0, 0)) == key;
        const int k = (e0 + src) / P, p = (e0 + src) % P;
        ColEntry<G> en;
        en.h = k * BP + p;
        en.rel = (c.z0 - tz0 + 1) << 20 | (c.y0 - ty0 + 1) << 10 | (c.x0 - tx0 + 1);
        en.meta = c.keep | own << 8;
        en.pad = 0;
#pragma unroll
        for (int j = 0; j < kPlanes<G>; ++j) en.w[j] = c.w[j];
        pool[ts[key] + base + __popc(same & ((1u << lane) - 1))] = en;
      }
    }
    __syncwarp();  // the lists and candidates are rewritten by the next 32
  }
}

// ---- the pull and the correlation ---------------------------------------------

// Element (row r, channel c) of a staged [row][channel] tile of kColCc
// channels: 16-byte chunks swizzled by the row, so that 16-byte reads of
// eight rows hit all 32 banks.
__device__ __forceinline__ int col_swz(int r, int c) { return r * kColCc + (((c >> 2) ^ (r & 7)) << 2 | (c & 3)); }

// ---- the pixel lists: the table's hits, once per tile --------------------------
//
// Piece j of a tile (its entries start + j kColCap ..., start a multiple of
// kColCap) has a record of `rec` u16 at csr + (start / kColCap + j) rec:
// [0, tq]: each pixel's first hit in the list (the last one the total),
// then from col_head(tq) the list: slot << 3 | corner for each corner of the
// piece's entries that lies in the tile with a nonzero weight, by pixel,
// and for one pixel in (warp, lane) order of the thread that found it.
__host__ __device__ inline int col_head(int tq) { return (tq + 1 + 7) / 8 * 8; }

template <class G>
__global__ void __launch_bounds__(kColBT) col_index_kernel(const ColEntry<G>* __restrict__ pool,
                                                          const long long* __restrict__ tstart,
                                                          const int* __restrict__ tcount,
                                                          unsigned short* __restrict__ csr, ColTiles tl, int rec) {
  constexpr int kHalf = 2 * kPlanes<G>;  // corners a thread takes of its entry
  __shared__ unsigned bits[kColBT / 32][kColBT];
  __shared__ int first[kColBT];
  __shared__ int ws[kColBT / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NT = tl.nz * tl.ny * tl.nx, t = blockIdx.x, bd = blockIdx.y;
  const long long start = tstart[static_cast<size_t>(bd) * NT + t];
  const int n = tcount[static_cast<size_t>(bd) * NT + t], pieces = (n + kColCap - 1) / kColCap;
  const int tq = tl.tz * tl.ty * tl.tx, head = col_head(tq);
  for (int e = threadIdx.x; e < (kColBT / 32) * kColBT; e += kColBT) (&bits[0][0])[e] = 0u;
  __syncthreads();
  for (int j = blockIdx.z; j < pieces; j += gridDim.z) {
    const int m = min(kColCap, n - j * kColCap);
    const int e = threadIdx.x % kColCap, half = threadIdx.x / kColCap;
    int hq[kHalf], rank[kHalf];
    if (e < m) {
      const ColEntry<G>& E = pool[start + static_cast<long long>(j) * kColCap + e];
      const int rz = (E.rel >> 20) - 1, ry = (E.rel >> 10 & 1023) - 1, rx = (E.rel & 1023) - 1;
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj) {
        const int c = half * kHalf + jj, z = rz + (c >> 2), y = ry + (c >> 1 & 1), xc = rx + (c & 1);
        hq[jj] = -1;
        if (comp4(E.w[c >> 2], c & 3) != 0.f && z >= 0 && z < tl.tz && y >= 0 && y < tl.ty && xc >= 0 &&
            xc < tl.tx) {
          hq[jj] = (z * tl.ty + y) * tl.tx + xc;
          atomicOr(&bits[warp][hq[jj]], 1u << lane);
        }
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj) hq[jj] = -1;
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) rank[jj] = hq[jj] >= 0 ? __popc(bits[warp][hq[jj]] & ((1u << lane) - 1)) : 0;
    __syncthreads();  // every warp's marks are in
    int v = 0;
    if (threadIdx.x < tq)
      for (int w = 0; w < kColBT / 32; ++w) v += __popc(bits[w][threadIdx.x]);
    int s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    if (lane == 31) ws[warp] = s;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += ws[w];
    unsigned short* r = csr + (start / kColCap + j) * rec;
    if (threadIdx.x < tq) {
      first[threadIdx.x] = before + s - v;
      r[threadIdx.x] = static_cast<unsigned short>(before + s - v);
      if (threadIdx.x == tq - 1) r[tq] = static_cast<unsigned short>(before + s);
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      if (hq[jj] < 0) continue;
      int pos = first[hq[jj]] + rank[jj];
      for (int w = 0; w < warp; ++w) pos += __popc(bits[w][hq[jj]]);
      r[head + pos] = static_cast<unsigned short>(e << 3 | (half * kHalf + jj));
    }
    __syncthreads();  // every read of the marks is done
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj)
      if (hq[jj] >= 0) bits[warp][hq[jj]] = 0u;
    __syncthreads();
  }
}

// ---- the pull and the correlation ---------------------------------------------

// The pull block's shared memory, in floats from its start: x of the tile
// and one more row, column and plane (only where the correlation is
// wanted), two pieces of staged gcols, three of entries and of pixel-list
// records.  The pipeline: while piece i is applied, the gcols values of
// piece i + 1 and the entries and lists of piece i + 2 are on their way.
struct ColSmem {
  int xs, gs, ent, rc, total;
};

template <class G>
__host__ __device__ inline ColSmem col_smem(const ColTiles& tl, bool corr, int rec) {
  ColSmem s;
  s.xs = 0;
  s.gs = s.xs + (corr ? tl.xz * tl.xy * tl.xx * kColCc : 0);
  s.ent = s.gs + 2 * kColCap * kColCc;
  s.rc = s.ent + 3 * kColCap * static_cast<int>(sizeof(ColEntry<G>) / 4);
  s.total = s.rc + 3 * rec / 2;
  return s;
}

// grad_x and the partial correlation of one input tile x kColCc channels of
// one (b, d) (grid: tile, d * chunks + chunk, b), from the tile's table
// (tstart[bd][t], tcount[bd][t] entries in the pool) and its pixel lists
// (csr, null when grad_x is not wanted).  gx or part may be null.
// part[bd][chunk][k * P + p][corner] is written for the entries the tile
// owns.  Per piece of kColCap entries, once the gcols values of its slots
// are in (brought a piece ahead, by cp.async for fp32, through registers
// for bf16), with one barrier a piece:
//   - every owned entry's corner sums over the block's channels, two
//     threads an entry (half the channels each, added in a fixed order);
//   - thread (pixel, channel group) adds its pixel's hits, in list order,
//     to its registers: each pixel x channel has one owner.
// Three blocks an SM in 2D (80 registers; config 5's blocks take 53-73 KB
// of shared memory), two in 3D.  T: gcols' type (the mode's); TX: x's and
// grad_x's (x staged as fp32: stage1).
template <class G, class T, typename TX>
__global__ void __launch_bounds__(kColBT, kIs3D<G> ? 2 : 3) col_pull_kernel(
    const TX* __restrict__ x, const T* __restrict__ gcols, const ColEntry<G>* __restrict__ pool,
    const unsigned short* __restrict__ csr, const long long* __restrict__ tstart, const int* __restrict__ tcount,
    TX* __restrict__ gx, float* __restrict__ part, G g, ColTiles tl, int chunks, int rec) {
  extern __shared__ __align__(16) float dyn[];
  constexpr int kNC = 4 * kPlanes<G>, kEntF = static_cast<int>(sizeof(ColEntry<G>) / 4);
  constexpr bool kAsync = std::is_same<T, float>::value;  // bf16 gcols go through registers
  const bool corr = part != nullptr;
  const ColSmem L = col_smem<G>(tl, corr, rec);
  float* xs = dyn + L.xs;
  float* gsb = dyn + L.gs;
  ColEntry<G>* ent = reinterpret_cast<ColEntry<G>*>(dyn + L.ent);
  unsigned short* rcb = reinterpret_cast<unsigned short*>(dyn + L.rc);
  const int K = taps(g), P = out_positions(g), BP = g.B * P, D = in_depth(g), HW = g.H * g.W;
  const int NT = tl.nz * tl.ny * tl.nx, t = blockIdx.x, b = blockIdx.z;
  const int Cdg = g.C / g.dg, d = blockIdx.y / chunks, chunk = blockIdx.y % chunks;
  const int c0 = d * Cdg + chunk * kColCc, cw = min(kColCc, (d + 1) * Cdg - c0);
  const int bd = b * g.dg + d;
  const int oz = t / (tl.ny * tl.nx) * tl.tz, oy = t / tl.nx % tl.ny * tl.ty, ox = t % tl.nx * tl.tx;
  const int tq = tl.tz * tl.ty * tl.tx, head = col_head(tq);
  const int xy = tl.xy, xx = tl.xx, xq = tl.xz * xy * xx;
  const long long start = tstart[static_cast<size_t>(bd) * NT + t];
  const int n = tcount[static_cast<size_t>(bd) * NT + t], pieces = (n + kColCap - 1) / kColCap;
  const CKBP<T> lay{K, g.B, P};
  const T* gcol = gcols + lay.base(b, c0);
  // Thread (pixel my_q, channel group my_g) of `groups` groups of nc
  // channels; more groups where the tile has fewer pixels.
  int groups = 1;
  while (groups < 8 && 2 * groups * tq <= kColBT) groups *= 2;
  const int nc = kColCc / groups, my_q = threadIdx.x % tq, my_g = threadIdx.x / tq;
  const bool applier = gx && my_g < groups;
  float acc[kColCc];
#pragma unroll
  for (int c = 0; c < kColCc; ++c) acc[c] = 0.f;

  auto load_piece = [&](int piece) {
    if (piece >= pieces) return;
    const int m = min(kColCap, n - piece * kColCap) * kEntF / 4;
    const float* src = reinterpret_cast<const float*>(pool + start + static_cast<long long>(piece) * kColCap);
    float* dst = reinterpret_cast<float*>(ent + piece % 3 * kColCap);
    for (int e = threadIdx.x; e < m; e += kColBT) cp_async16(dst + 4 * e, src + 4 * e, true);
    if (gx) {
      const float* rsrc = reinterpret_cast<const float*>(csr + (start / kColCap + piece) * rec);
      float* rdst = reinterpret_cast<float*>(rcb + piece % 3 * rec);
      for (int e = threadIdx.x; e < rec / 8; e += kColBT) cp_async16(rdst + 4 * e, rsrc + 4 * e, true);
    }
  };
  load_piece(0);
  load_piece(1);
  if (corr) {
    // x of the tile and one more row, column and plane, zero outside x and
    // past the chunk's channels (after the pieces' copies, so that bf16 x's
    // loads through registers overlap them).
    const TX* xb = x + (static_cast<size_t>(b) * g.C + c0) * D * HW;
    for (int e = threadIdx.x; e < kColCc * xq; e += kColBT) {
      const int c = e / xq, q = e % xq;
      const int z = oz + q / (xy * xx), y = oy + q / xx % xy, xc = ox + q % xx;
      const bool in = c < cw && z < D && y < g.H && xc < g.W;
      stage1(xs + col_swz(q, c),
             in ? xb + static_cast<size_t>(c) * D * HW + (static_cast<size_t>(z) * g.H + y) * g.W + xc : xb, in);
    }
  }
  cp_async_commit();
  // The gcols values of a piece: thread e takes slot e % kColCap and
  // channels e / kColCap, + 2, ...; lanes over consecutive slots read
  // consecutive positions of a gcols row.
  constexpr int kPerThread = kColCap * kColCc / kColBT, kCStep = kColBT / kColCap;
  const int my_slot = threadIdx.x % kColCap, my_c = threadIdx.x / kColCap;
  float gv[kAsync ? 1 : kPerThread];
  auto gather = [&](int piece) {
    const int m = piece < pieces ? min(kColCap, n - piece * kColCap) : 0;
    const int h = my_slot < m ? ent[piece % 3 * kColCap + my_slot].h : 0;
    float* dst = gsb + piece % 2 * kColCap * kColCc;
    const T* src = gcol + lay.at(h, my_c);
    const size_t step = static_cast<size_t>(kCStep) * K * g.B * P;
    float* drow = dst + my_slot * kColCc;
    const int s7 = my_slot & 7;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u, src += step) {
      const int c = my_c + u * kCStep;
      const bool ok = my_slot < m && c < cw;
      if constexpr (kAsync)
        cp_async4(drow + ((((c >> 2) ^ s7) << 2) | (c & 3)), reinterpret_cast<const float*>(ok ? src : gcol), ok);
      else
        gv[u] = ok ? as_float(*src) : 0.f;
    }
  };
  auto put = [&](int piece) {
    if constexpr (!kAsync) {
      float* dst = gsb + piece % 2 * kColCap * kColCc;
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) dst[col_swz(my_slot, my_c + u * kCStep)] = gv[u];
    }
  };
  cp_async_wait<0>();
  __syncthreads();
  gather(0);
  cp_async_commit();
  put(0);
  for (int i = 0; i < pieces; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // piece i's values and piece i + 1's entries and list are in; piece i - 1 is done with
    load_piece(i + 2);
    gather(i + 1);
    cp_async_commit();
    const ColEntry<G>* en = ent + i % 3 * kColCap;
    const float* gs = gsb + i % 2 * kColCap * kColCc;
    const int m = min(kColCap, n - i * kColCap);
    if (corr) {
      // The owned entries' corner sums: thread 2 e + h takes channels
      // 16 h .. 16 h + 15 of entry e.
      const int e = threadIdx.x >> 1, h = threadIdx.x & 1;
      float S[kNC];
#pragma unroll
      for (int j = 0; j < kNC; ++j) S[j] = 0.f;
      const bool own = e < m && en[e].meta >> 8;
      if (own) {
        const int keep = en[e].meta & 255, rel = en[e].rel;
        const int rz = (rel >> 20) - 1, ry = (rel >> 10 & 1023) - 1, rx = (rel & 1023) - 1;
#pragma unroll 1  // unrolled, its loads take the registers three 2D blocks an SM need
        for (int c4 = 4 * h; c4 < 4 * h + 4; ++c4) {
          const float4 gv4 = *reinterpret_cast<const float4*>(gs + col_swz(e, 4 * c4));
#pragma unroll
          for (int j = 0; j < kNC; ++j) {
            if (!(keep >> j & 1)) continue;
            const int q = ((rz + (j >> 2)) * xy + ry + (j >> 1 & 1)) * xx + rx + (j & 1);
            const float4 xv = *reinterpret_cast<const float4*>(xs + col_swz(q, 4 * c4));
            S[j] = fmaf(gv4.x, xv.x, S[j]);
            S[j] = fmaf(gv4.y, xv.y, S[j]);
            S[j] = fmaf(gv4.z, xv.z, S[j]);
            S[j] = fmaf(gv4.w, xv.w, S[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNC; ++j) S[j] += __shfl_xor_sync(0xffffffffu, S[j], 1);
      if (own && h == 0) {
        const int k = en[e].h / BP, p = en[e].h % BP;
        float4* dst = reinterpret_cast<float4*>(
            part + ((static_cast<size_t>(bd) * chunks + chunk) * K * P + static_cast<size_t>(k) * P + p) * kNC);
#pragma unroll
        for (int j = 0; j < kPlanes<G>; ++j)
          dst[j] = make_float4(S[4 * j], S[4 * j + 1], S[4 * j + 2], S[4 * j + 3]);
      }
    }
    if (applier) {
      // Each owner adds its pixel's hits in list order.
      const unsigned short* r = rcb + i % 3 * rec;
      const int h1 = r[my_q + 1];
      for (int hh = r[my_q]; hh < h1; ++hh) {
        const int code = r[head + hh], slot = code >> 3, c = code & 7;
        const float w = comp4(en[slot].w[c >> 2], c & 3);
        const float* row = gs + slot * kColCc;
#pragma unroll
        for (int u = 0; u < kColCc / 4; ++u) {
          if (4 * u >= nc) break;
          const float4 v = *reinterpret_cast<const float4*>(row + (((my_g * nc / 4 + u) ^ (slot & 7)) << 2));
          acc[4 * u] = fmaf(w, v.x, acc[4 * u]);
          acc[4 * u + 1] = fmaf(w, v.y, acc[4 * u + 1]);
          acc[4 * u + 2] = fmaf(w, v.z, acc[4 * u + 2]);
          acc[4 * u + 3] = fmaf(w, v.w, acc[4 * u + 3]);
        }
      }
    }
    put(i + 1);
  }
  if (!applier) return;
  const int pz = oz + my_q / (tl.ty * tl.tx), py = oy + my_q / tl.tx % tl.ty, px = ox + my_q % tl.tx;
  if (pz >= D || py >= g.H || px >= g.W) return;
  TX* dst = gx + (static_cast<size_t>(b) * g.C + c0 + my_g * nc) * D * HW +
            (static_cast<size_t>(pz) * g.H + py) * g.W + px;
#pragma unroll
  for (int c = 0; c < kColCc; ++c)
    if (c < nc && my_g * nc + c < cw) dst[static_cast<size_t>(c) * D * HW] = to_elem<TX>(acc[c]);
}

// ---- the fold ------------------------------------------------------------------

// One thread per (b, d, tap, position): S = the chunks' partial sums in
// order, then grad_offset and grad_mask; zero where the gate is closed (no
// tile owns such a candidate, and its partials are never written).
template <typename TX>
__device__ __forceinline__ void col_fold_one(const Geo& g, const TX* __restrict__ offset, const TX* __restrict__ mask,
                                             const float* __restrict__ part, TX* __restrict__ goff,
                                             TX* __restrict__ gmask, int chunks, int b, int d, int k, int p) {
  const int K = g.kh * g.kw, P = g.OH * g.OW;
  const int oy = p / g.OW, ox = p % g.OW, ky = k / g.kw, kx = k % g.kw;
  const size_t oidx = (static_cast<size_t>(b) * g.dg * 2 * K + static_cast<size_t>(d) * 2 * K + 2 * k) * P + p;
  const TapGrad t = tap_grad(g, oy * g.sh - g.ph + ky * g.dh, ox * g.sw - g.pw + kx * g.dw, as_float(offset[oidx]),
                             as_float(offset[oidx + P]));
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t.keep) {
    const float4* src = reinterpret_cast<const float4*>(part) +
                        (static_cast<size_t>(b) * g.dg + d) * chunks * K * P + static_cast<size_t>(k) * P + p;
    for (int c = 0; c < chunks; ++c) {
      const float4 v = src[static_cast<size_t>(c) * K * P];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  const float m = mask_at(g, mask, b, d, k, p);
  if (goff) {
    goff[oidx] = to_elem<TX>(m * (t.dy.x * s.x + t.dy.y * s.y + t.dy.z * s.z + t.dy.w * s.w));
    goff[oidx + P] = to_elem<TX>(m * (t.dx.x * s.x + t.dx.y * s.y + t.dx.z * s.z + t.dx.w * s.w));
  }
  if (gmask)
    gmask[(static_cast<size_t>(b) * g.dg * K + static_cast<size_t>(d) * K + k) * P + p] =
        to_elem<TX>(t.w.x * s.x + t.w.y * s.y + t.w.z * s.z + t.w.w * s.w);
}

template <typename TX>
__device__ __forceinline__ void col_fold_one(const Geo3& g, const TX* __restrict__ offset,
                                             const TX* __restrict__ mask, const float* __restrict__ part,
                                             TX* __restrict__ goff, TX* __restrict__ gmask, int chunks, int b, int d,
                                             int k, int p) {
  const int K = taps3(g), P = out_size3(g);
  const TapGrad3 t = grad3_at(g, offset, mask, b, d, k, p);
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (t.keep) {
    const float4* src = reinterpret_cast<const float4*>(part) +
                        ((static_cast<size_t>(b) * g.dg + d) * chunks * K * P + static_cast<size_t>(k) * P + p) * 2;
    for (int c = 0; c < chunks; ++c) {
      const float4 lo = src[static_cast<size_t>(c) * K * P * 2], hi = src[static_cast<size_t>(c) * K * P * 2 + 1];
      s[0] += lo.x;
      s[1] += lo.y;
      s[2] += lo.z;
      s[3] += lo.w;
      s[4] += hi.x;
      s[5] += hi.y;
      s[6] += hi.z;
      s[7] += hi.w;
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
    goff[oidx] = to_elem<TX>(t.m * gz);
    goff[oidx + P] = to_elem<TX>(t.m * gy);
    goff[oidx + 2 * static_cast<size_t>(P)] = to_elem<TX>(t.m * gxv);
  }
  if (gmask) {
    float gm = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) gm += t.w[i] * s[i];
    gmask[(static_cast<size_t>(b) * g.dg * K + static_cast<size_t>(d) * K + k) * P + p] = to_elem<TX>(gm);
  }
}

template <class G, typename TX>
__global__ void __launch_bounds__(kColBT) col_fold_kernel(const TX* __restrict__ offset, const TX* __restrict__ mask,
                                                         const float* __restrict__ part, TX* __restrict__ goff,
                                                         TX* __restrict__ gmask, G g, int chunks) {
  const int K = taps(g), P = out_positions(g);
  const size_t e = static_cast<size_t>(blockIdx.x) * kColBT + threadIdx.x;
  if (e >= static_cast<size_t>(g.B) * g.dg * K * P) return;
  const int p = e % P, k = e / P % K, d = e / (static_cast<size_t>(P) * K) % g.dg;
  const int b = e / (static_cast<size_t>(P) * K * g.dg);
  col_fold_one(g, offset, mask, part, goff, gmask, chunks, b, d, k, p);
}

// ---- the launches --------------------------------------------------------------
//
// Scratch, allocated by the caller (ops/cuda/gathermm.py::cols_bwd_plan):
// cnt (B * dg, tiles, runs) int; tcount (B * dg, tiles) int; tstart (B * dg,
// tiles) int64; pool (B * dg * pool_bd) entries, pool_bd = corners * K * P
// rounded up to whole pieces, + tiles * kColCap; csr (B * dg * pool_bd /
// kColCap records of col_rec u16), null when grad_x is not wanted; part (B
// * dg, chunks, K * P, corners) float, null when neither grad_offset nor
// grad_mask is wanted.
template <class G>
__host__ __device__ inline int col_rec(const ColTiles& tl) {
  return col_head(tl.tz * tl.ty * tl.tx) + kColCap * 4 * kPlanes<G>;
}

// x, offset, mask and gx, goff, gmask are of one type TX, fp32 or bf16;
// gcols is of the mode's type T.
template <class G, class T, typename TX>
inline cudaError_t run_cols_bwd(const G& g, const ColTiles& tl, const TX* x, const TX* offset, const TX* mask,
                                const T* gcols, int* cnt, int* tcount, long long* tstart, ColEntry<G>* pool,
                                unsigned short* csr, float* part, TX* gx, TX* goff, TX* gmask, cudaStream_t s) {
  const int K = taps(g), P = out_positions(g), NT = tl.nz * tl.ny * tl.nx, BD = g.B * g.dg;
  const int runs = (K * P + kColCB - 1) / kColCB, chunks = (g.C / g.dg + kColCc - 1) / kColCc;
  const long long pool_bd = ((static_cast<long long>(4 * kPlanes<G>) * K * P + kColCap - 1) / kColCap + NT) * kColCap;
  const int rec = col_rec<G>(tl);
  if (!goff && !gmask) part = nullptr;
  if (!gx) csr = nullptr;
  if (!gx && !part) return cudaSuccess;
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * static_cast<size_t>(BD) * NT * runs, s);
  if (err != cudaSuccess) return err;
  const dim3 bins((runs + kColBT / 32 - 1) / (kColBT / 32), BD);
  col_count_kernel<G, TX><<<bins, kColBT, 0, s>>>(offset, mask, cnt, g, tl, runs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  col_scan_rows_kernel<<<BD * NT, kColBT, 0, s>>>(cnt, tcount, runs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  col_scan_tiles_kernel<<<BD, kColBT, 0, s>>>(tcount, tstart, NT, pool_bd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  col_fill_kernel<G, TX><<<bins, kColBT, 0, s>>>(offset, mask, cnt, tstart, pool, g, tl, runs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (gx) {
    col_index_kernel<G><<<dim3(NT, BD, kColIdxSplit), kColBT, 0, s>>>(pool, tstart, tcount, csr, tl, rec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(col_smem<G>(tl, part != nullptr, rec).total);
  if ((err = cudaFuncSetAttribute(col_pull_kernel<G, T, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  col_pull_kernel<G, T, TX><<<dim3(NT, g.dg * chunks, g.B), kColBT, smem, s>>>(x, gcols, pool, csr, tstart, tcount,
                                                                              gx, part, g, tl, chunks, rec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (part) {
    const size_t n = static_cast<size_t>(BD) * K * P;
    col_fold_kernel<G, TX><<<static_cast<unsigned>((n + kColBT - 1) / kColBT), kColBT, 0, s>>>(offset, mask, part,
                                                                                              goff, gmask, g, chunks);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace mdc

// The column forward of both ranks (gathermm_cols_fwd.cu,
// gathermm3d_cols_fwd.cu): the deformable columns (C * K, B * P), row
// c * K + k, column b * P + p (the CUDA original's deformable_im2col
// layout), fp32, bf16 in "bfloat16".  Two routes, which the host picks from
// the shapes alone (gathermm.cols_fwd_plan):
//
// The plane route (cols_plane_kernel), where one (sample, channel) plane or
// volume fits in shared memory.  A block owns a tile of `gt` column groups
// (4 gt consecutive columns of the B * P, of up to nbm samples) over every
// tap, one deformable group and a split of its channels; tiles run fastest
// in the grid, so the blocks in flight write neighbouring runs of the same
// rows.  A thread holds one item, a tap at 4 consecutive columns: it builds
// their corner weights once (deform_tile{,3d}.cuh: the gate, the in-image
// checks and the mask folded in) and keeps them in registers for every
// channel of the split.  The block takes the box of rows (2D) or planes x
// rows (3D) that its kept corners reach, full width: a contiguous run of x
// per plane and sample, staged by cp.async in x's own type (the widest
// copy of 16, 8 or 4 bytes that x's planes keep aligned; a bf16 plane of
// odd size value by value, plain 2-byte copies) for `cc` channels at a
// time in two buffers, so
// each x value crosses to the SM about once per block.  Every value blends
// its corners from shared memory in the order `blend` / `blend3` read them,
// so the columns have the bits of the gather route, and the thread stores
// its four at once (a float4, or 4 bf16, where B * P % 4 == 0; element by
// element at a ragged end): each row c * K + k is written as one
// contiguous run of the tile's columns.  A block whose box passes its slot
// (far offsets) reads its corners from x instead.
//
// The gather route (cols_gather_kernel), for larger planes: one thread per
// (sample, deformable group, tap, position) builds its weights once and
// blends every channel of its group from x.
//
// Every value has one owner; no atomics touch a float.
#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>

#include "deform_bwd.cuh"

namespace mdc {

constexpr int kColThreads = 256;  // threads of a column block

// The host's plan (gathermm.cols_fwd_plan).
struct ColPlan {
  int plane;   // 1: the plane route; 0: the gather route
  int gt;      // column groups a tile
  int tiles;   // tiles of the B * P columns
  int nbm;     // samples a tile's columns may belong to
  int splits;  // channel splits of a deformable group
  int cps;     // channels a split
  int cc;      // channels a stage
  int slot;    // floats a staged (channel, sample) holds
  int smem;    // dynamic shared memory of a block (bytes)
};

// The kept corners' reach: planes [zlo, zhi] (0 in 2D) and rows [ylo, yhi].
struct ColBox {
  int zlo, zhi, ylo, yhi;
};

__device__ __forceinline__ void box_take(ColBox& b, int z, int y) {
  b.zlo = min(b.zlo, z);
  b.zhi = max(b.zhi, z);
  b.ylo = min(b.ylo, y);
  b.yhi = max(b.yhi, y);
}

// One (tap, position): its corner weights, its low corner (plane z0 in
// 3D), and that corner's index i0 in the source it blends from (place).
template <class G>
struct ColPos;
template <>
struct ColPos<Geo> {
  float4 w;
  int y0, x0, i0;
};
template <>
struct ColPos<Geo3> {
  float4 lo, hi;
  int z0, y0, x0, i0;
};

__device__ __forceinline__ ColPos<Geo> col_pos(const Geo&, const TapWeights& t, ColBox& box) {
  if (t.keep & 3) box_take(box, 0, t.y0);
  if (t.keep & 12) box_take(box, 0, t.y0 + 1);
  return ColPos<Geo>{t.w, t.y0, t.x0, 0};
}

__device__ __forceinline__ ColPos<Geo3> col_pos(const Geo3&, const TapWeights3& t, ColBox& box) {
  // keep bit 4 cz + 2 cy + cx: 0x0F the low plane, 0x33 the low row.
  for (int cz = 0; cz < 2; ++cz)
    for (int cy = 0; cy < 2; ++cy)
      if (t.keep & (0x3 << (4 * cz + 2 * cy))) box_take(box, t.z0 + cz, t.y0 + cy);
  return ColPos<Geo3>{t.lo, t.hi, t.z0, t.y0, t.x0, 0};
}

// i0 for a source that holds plane zlo, row ylo of the box `shift` values
// in, rows py and planes pz apart (x itself: 0, 0, W, H * W, 0).
__device__ __forceinline__ void place(ColPos<Geo>& c, int, int ylo, int py, int, int shift) {
  c.i0 = (c.y0 - ylo) * py + c.x0 + shift;
}
__device__ __forceinline__ void place(ColPos<Geo3>& c, int zlo, int ylo, int py, int pz, int shift) {
  c.i0 = (c.z0 - zlo) * pz + (c.y0 - ylo) * py + c.x0 + shift;
}

template <typename TX>
__device__ __forceinline__ TapWeights tap_weights_at(const Geo& g, const TX* __restrict__ offset,
                                                     const TX* __restrict__ mask, int b, int d, int k, int p) {
  return weights_at(g, offset, mask, b, d, k, p);
}
template <typename TX>
__device__ __forceinline__ TapWeights3 tap_weights_at(const Geo3& g, const TX* __restrict__ offset,
                                                      const TX* __restrict__ mask, int b, int d, int k, int p) {
  return weights3_at(g, offset, mask, b, d, k, p);
}

// Columns out[0 .. 3] of one row: one 16-byte (fp32) or 8-byte (bf16)
// store where all four are the row's (`valid` bits) and `vec` says the rows
// keep that alignment, else one store per valid column.
template <typename T>
__device__ __forceinline__ void store4(T* out, const float (&v)[4], int valid, bool vec) {
  if (vec && valid == 15) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<uint2*>(out) = make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (valid >> c & 1) out[c] = to_elem<T>(v[c]);
}

// One column value from src (x, or its box staged in shared memory, of
// x's type), rows py and planes pz apart.
template <typename TX>
__device__ __forceinline__ float col_value(const TX* src, const ColPos<Geo>& c, int py, int) {
  return blend(src, c.i0, py, c.w);
}
template <typename TX>
__device__ __forceinline__ float col_value(const TX* src, const ColPos<Geo3>& c, int py, int pz) {
  return blend3(src, c.i0, py, pz, c.lo, c.hi);
}

// T: the columns' type (the mode's); TX: x's, offset's and mask's.
template <class G, typename T, typename TX>
__global__ void __launch_bounds__(kColThreads, kIs3D<G> ? 3 : 4)
    cols_plane_kernel(const TX* __restrict__ x, const TX* __restrict__ offset, const TX* __restrict__ mask,
                      T* __restrict__ cols, G g, ColPlan pl) {
  extern __shared__ __align__(16) float sx_raw[];
  TX* sx = reinterpret_cast<TX*>(sx_raw);
  // Values a staged (channel, sample) slot holds: the plan's pl.slot fp32
  // values, in the same bytes twice as many bf16 ones.
  const int slot = pl.slot * static_cast<int>(4 / sizeof(TX));
  __shared__ int sbox[4];
  const int K = taps(g), P = out_positions(g), S = in_positions(g), HW = g.H * g.W, Cdg = g.C / g.dg;
  const int BP = g.B * P;
  // Tiles fastest: the blocks in flight write neighbouring runs of the
  // same rows, along B * P.
  const int tile = blockIdx.x, split = blockIdx.y, d = blockIdx.z;
  const int j0 = tile * pl.gt, GT = min(pl.gt, (BP + 3) / 4 - j0), I = K * GT, t = threadIdx.x;
  const int c0 = d * Cdg + split * pl.cps, c1 = min((d + 1) * Cdg, c0 + pl.cps);
  if (GT <= 0 || c0 >= c1) return;
  // The samples b0 .. b0 + nb - 1 that the tile's columns belong to.
  const int b0 = 4 * j0 / P, nb = (min(BP, 4 * (j0 + GT)) - 1) / P - b0 + 1;
  // A thread holds one item (k, j): tap k at columns q0 .. q0 + 3 (group
  // j0 + j), I <= kColThreads; with fewer items than threads, threads t,
  // t + I, ... share an item and take every nlane-th channel.
  const int nlane = kColThreads / I, clane = t / I, i = t % I;
  const int j = i % GT, k = i / GT, q0 = 4 * (j0 + j);
  ColPos<G> pos[4] = {};
  int valid = 0, db[4] = {};  // valid: bit c for column q0 + c; db: its sample less b0
  ColBox box{INT_MAX, INT_MIN, INT_MAX, INT_MIN};
  if (clane < nlane) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = q0 + c, b = q / P;
      if (q >= BP) break;
      valid |= 1 << c;
      db[c] = b - b0;
      pos[c] = col_pos(g, tap_weights_at(g, offset, mask, b, d, k, q - b * P), box);
    }
  }
  if (t < 4) sbox[t] = t & 1 ? INT_MIN : INT_MAX;
  __syncthreads();
  {
    const int zlo = __reduce_min_sync(~0u, box.zlo), zhi = __reduce_max_sync(~0u, box.zhi);
    const int ylo = __reduce_min_sync(~0u, box.ylo), yhi = __reduce_max_sync(~0u, box.yhi);
    if ((t & 31) == 0) {
      atomicMin(&sbox[0], zlo);
      atomicMax(&sbox[1], zhi);
      atomicMin(&sbox[2], ylo);
      atomicMax(&sbox[3], yhi);
    }
  }
  __syncthreads();
  box = ColBox{sbox[0], sbox[1], sbox[2], sbox[3]};
  const bool any = box.zlo <= box.zhi;
  const int ny = any ? box.yhi - box.ylo + 1 : 0, nz = any ? box.zhi - box.zlo + 1 : 0;
  const int run = ny * g.W;  // floats of one plane's rows in the box
  const size_t KBP = static_cast<size_t>(K) * BP;
  const bool vec = BP % 4 == 0;

  // The item's four values for channels cb + clane, cb + clane + nlane,
  // ... below cb + cn, column c's from src_of(channel - cb, c) with planes
  // pz apart.
  auto emit = [&](auto src_of, int cb, int cn, int pz) {
    if (!valid) return;
    T* row = cols + (static_cast<size_t>(cb) * K + k) * BP + q0;
#pragma unroll 1
    for (int cl = clane; cl < cn; cl += nlane) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = col_value(src_of(cl, c), pos[c], g.W, pz);
      store4(row + cl * KBP, v, valid, vec);
    }
  };

  // Each plane's run of the box is staged from the aligned value below it
  // by copies of w values, the widest of 16, 8 or 4 bytes that x, S and H *
  // W keep aligned (the runs then all start `shift` values past one; w = 1
  // for a bf16 plane of odd size), planes pz values apart; a staged channel
  // holds one slot per sample.
  auto aligned = [&](int bytes) {
    const int v = bytes / static_cast<int>(sizeof(TX));
    return S % v == 0 && HW % v == 0 && reinterpret_cast<uintptr_t>(x) % bytes == 0;
  };
  const int w = static_cast<int>((aligned(16) ? 16 : aligned(8) ? 8 : aligned(4) ? 4 : sizeof(TX)) / sizeof(TX));
  const int first = any ? box.zlo * HW + box.ylo * g.W : 0;
  const int shift = first & (w - 1);
  const int pz = (shift + run + w - 1) & ~(w - 1);
  if (nb > pl.nbm || static_cast<long long>(nz) * pz > slot) {  // far offsets: the corners from x
    const TX* xb = x + (static_cast<size_t>(b0) * g.C + c0) * S;
    const size_t CS = static_cast<size_t>(g.C) * S;
#pragma unroll
    for (int c = 0; c < 4; ++c) place(pos[c], 0, 0, g.W, HW, 0);
    emit([&](int cl, int c) { return xb + static_cast<size_t>(cl) * S + db[c] * CS; }, c0, c1 - c0, HW);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) place(pos[c], box.zlo, box.ylo, g.W, pz, shift + db[c] * slot);

  // Stage chunk ch (cc channels x nb samples) of the box into buffer ch & 1.
  const int len = pz / w;                                           // copies a plane
  const int nch = (c1 - c0 + pl.cc - 1) / pl.cc, chs = nb * slot;  // values a staged channel
  auto stage = [&](int ch) {
    if (len == 0) return;
    const int cb = c0 + ch * pl.cc, cn = min(pl.cc, c1 - cb);
    TX* dst = sx + (ch & 1) * pl.cc * pl.nbm * slot;
    const TX* src = x + (static_cast<size_t>(b0) * g.C + cb) * S + (first - shift);
    int r = t, z = 0, s = 0, c = 0;  // copy r of plane z of sample s, channel c
    for (;;) {
      while (r >= len) {
        r -= len;
        if (++z == nz) {
          z = 0;
          if (++s == nb) {
            s = 0;
            ++c;
          }
        }
      }
      if (c >= cn) break;
      TX* to = dst + c * chs + s * slot + z * pz;
      const TX* from = src + (static_cast<size_t>(s) * g.C + c) * S + static_cast<size_t>(z) * HW;
      const int bytes = w * static_cast<int>(sizeof(TX));
      if (bytes == 16)
        cp_async16(to + w * r, from + w * r, true);
      else if (bytes == 8)
        cp_async8(to + w * r, from + w * r, true);
      else if (bytes == 4)
        cp_async4(to + w * r, from + w * r, true);
      else
        to[r] = from[r];
      r += kColThreads;
    }
  };
  stage(0);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage(ch + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const TX* buf = sx + (ch & 1) * pl.cc * pl.nbm * slot;
    const int cb = c0 + ch * pl.cc;
    emit([&](int cl, int) { return buf + cl * chs; }, cb, min(pl.cc, c1 - cb), pz);
    __syncthreads();
  }
}

template <class G, typename T, typename TX>
__global__ void __launch_bounds__(kColThreads)
    cols_gather_kernel(const TX* __restrict__ x, const TX* __restrict__ offset, const TX* __restrict__ mask,
                       T* __restrict__ cols, G g) {
  const int K = taps(g), P = out_positions(g), S = in_positions(g), Cdg = g.C / g.dg;
  const size_t e = static_cast<size_t>(blockIdx.x) * kColThreads + threadIdx.x;
  if (e >= static_cast<size_t>(g.B) * g.dg * K * P) return;
  const int p = e % P, k = (e / P) % K, d = (e / (static_cast<size_t>(P) * K)) % g.dg;
  const int b = e / (static_cast<size_t>(P) * K * g.dg);
  ColBox box{0, 0, 0, 0};
  ColPos<G> c = col_pos(g, tap_weights_at(g, offset, mask, b, d, k, p), box);
  place(c, 0, 0, g.W, g.H * g.W, 0);
  const size_t BP = static_cast<size_t>(g.B) * P;
  const TX* xb = x + static_cast<size_t>(b) * g.C * S;
  T* out = cols + static_cast<size_t>(k) * BP + static_cast<size_t>(b) * P + p;
#pragma unroll 4
  for (int ch = d * Cdg; ch < (d + 1) * Cdg; ++ch)
    out[static_cast<size_t>(ch) * K * BP] = to_elem<T>(col_value(xb + static_cast<size_t>(ch) * S, c, g.W, g.H * g.W));
}

template <class G, typename T, typename TX>
int launch_cols_fwd_as(const TX* x, const TX* offset, const TX* mask, void* cols, const G& g, const ColPlan& pl,
                       cudaStream_t s) {
  T* out = static_cast<T*>(cols);
  if (pl.plane) {
    auto kern = cols_plane_kernel<G, T, TX>;
    if (pl.smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(pl.tiles, pl.splits, g.dg);
    kern<<<grid, kColThreads, pl.smem, s>>>(x, offset, mask, out, g, pl);
  } else {
    const size_t n = static_cast<size_t>(g.B) * g.dg * taps(g) * out_positions(g);
    cols_gather_kernel<G, T, TX><<<static_cast<unsigned>((n + kColThreads - 1) / kColThreads), kColThreads, 0, s>>>(
        x, offset, mask, out, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the route `pl` names on stream s; returns cudaGetLastError().  x,
// offset and mask are of one type TX, fp32 or bf16; the columns' type is the
// mode's.
template <class G, typename TX>
int launch_cols_fwd(const TX* x, const TX* offset, const TX* mask, void* cols, const G& g, const ColPlan& pl,
                    cudaStream_t s) {
  if (g.precision == kBFloat16) return launch_cols_fwd_as<G, __nv_bfloat16>(x, offset, mask, cols, g, pl, s);
  return launch_cols_fwd_as<G, float>(x, offset, mask, cols, g, pl, s);
}

}  // namespace mdc

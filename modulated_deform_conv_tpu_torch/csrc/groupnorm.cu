// groupnorm: GroupNorm with its epilogue, y = act(GN(x) * gamma + beta
// [+ identity]) with act ReLU or none, forward and its whole gradient
// backward, one launch each way a layer (and one small launch for the
// parameters' gradients).
//
// Not a port of a TPU kernel: the JAX backbone's GroupNorm, ReLU and
// residual add are separate flax ops that XLA fuses inside the jitted step.
// torch runs each as its own pass over the activation: native_group_norm's
// moments and apply, the ReLU and the add forward; the internal gradients,
// the fused parameters, gamma / beta, the dx apply, the ReLU's threshold
// backward and the add's accumulation backward.  The work is a few
// operations a value and is bound by memory, so this file reads every input
// once and writes every output once:
//
//   forward   reads x (and identity), writes y; saves mean and rstd
//   backward  reads dy, y (ReLU only) and x, writes dx (and d_identity)
//
// Design.  A group (n, g) is L = C/G * S contiguous values of NCHW(T)
// memory.  It is split over a thread-block cluster of k blocks (the plan's
// k, at most the portable cluster size of 8, which the launch enforces),
// each taking a slice of `slice` consecutive values, which it
// keeps in shared memory between the reduction and the apply.  The blocks
// exchange their partial sums through distributed shared memory:
//
// * forward: each block takes its slice's moments exactly (the sum, then
//   the squares about its own mean, from shared memory), and every block
//   merges the cluster's (count, mean, M2) in rank order (Chan et al.).
// * backward: dz = dy * [y > 0] (where the forward had a ReLU), and each
//   block sums dz * (x - mean) and dz per channel of its slice: the slice
//   is cut into segments of at most kSeg values inside one channel, a warp
//   a segment, then each channel's segments in order; the cluster's sums
//   are added in rank order.  From the group's sums every block forms
//   dx = rstd gamma_c dz - rstd / L S1 - rstd^3 / L (x - mean) S2, with
//   S1 = sum_c gamma_c sum dz and S2 = sum_c gamma_c sum dz (x - mean).
//   Rank 0 writes the (n, c) partials of dgamma and dbeta, and a second
//   launch adds them over n in order.
//
// Where a slice does not fit the shared memory the caller grants (`chunk`
// values a pass, the wrapper's plan from the shapes), the block takes it in
// passes of `chunk` values for the sums and reads its inputs again for the
// apply (from L2 where they fit): the same arithmetic, another route.
//
// Every sum is taken in a fixed order and no float atomics are used, so a
// launch gives the same bits every time.  Values are read and written in
// their type T (float or bfloat16) and everything is computed in float.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 4;      // registers for four blocks an SM
                                     // (the plan reads it: groupnorm_card)
constexpr int kUnroll = 4;           // 4-value vectors a thread has in flight
constexpr int kSeg = 256;            // values a backward segment sums

// The shape and the plan, shared by both directions.
struct Shape {
  int C, G, S, Cg, L;  // L = Cg * S values a group
  int k;               // blocks a group (the cluster)
  int slice;           // values a block
  int chunk;           // values a block keeps in shared memory at once
  int segs;            // the most backward segments a pass makes
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

// Four consecutive values: 16 bytes of float, or 8 of bfloat16.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

// torch's ReLU keeps a NaN; its backward passes the gradient where the
// output is not <= 0.
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }
__device__ __forceinline__ float relu_grad(float dy, float y) {
  return y <= 0.f ? 0.f : dy;
}

// Lane 0 gets the warp's sum, in the same order on every run.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v, the same in every thread and on every run.  Every
// thread calls it; `red` holds kWarps floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s merge of two parts' count, mean and sum of squared
// deviations.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n, d = b.mean - a.mean, wb = b.n / n;
  return {n, a.mean + d * wb, a.m2 + b.m2 + d * d * a.n * wb};
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// The values a block keeps in shared memory: its slice, or a pass of it.
__host__ __device__ inline int held(const Shape& sh) {
  return sh.chunk < sh.slice ? sh.chunk : sh.slice;
}

// Channel bookkeeping of a run of values of a group: the channel of value e
// and e's place in it; `next` steps one value on.
struct Chan {
  int c, r;
  __device__ Chan(int e, int S) : c(e / S), r(e - (e / S) * S) {}
  __device__ void next(int S) {
    if (++r == S) {
      ++c;
      r = 0;
    }
  }
};

// ---------------------------------------------------------------- forward

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta,
                  const T* __restrict__ identity, T* __restrict__ y,
                  float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, const Shape sh,
                  const int with_relu, const float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(blockIdx.x % sh.k);
  const long long gid = blockIdx.x / sh.k;
  const int g = static_cast<int>(gid % sh.G);
  const long long base = gid * sh.L;
  const int lo = min(sh.L, rank * sh.slice), hi = min(sh.L, lo + sh.slice);
  const bool on_chip = sh.chunk >= sh.slice;
  T* buf = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(held(sh) * sizeof(T)));
  float* part = red + kWarps;  // this block's moments, read by the cluster
  float* tot = part + 4;       // the group's mean and rstd
  float* scale = tot + 4;      // per channel of the group
  float* shift = scale + sh.Cg;
  const T* xg = x + base;
  // The group's gamma and beta, read while the moments are taken.
  for (int c = threadIdx.x; c < sh.Cg; c += kThreads) {
    scale[c] = gamma[g * sh.Cg + c];
    shift[c] = beta[g * sh.Cg + c];
  }

  // The slice's moments, a pass at a time: the values into shared memory
  // and their sum, then the squares about the pass's mean.
  Moments mo = {0.f, 0.f, 0.f};
  for (int c0 = lo; c0 < hi; c0 += sh.chunk) {
    const int n = min(hi - c0, sh.chunk);
    float s = 0.f;
    if (kVec) {
      for (int i0 = threadIdx.x * 4; i0 < n; i0 += kThreads * 4 * kUnroll) {
        float v[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads * 4;
          if (i < n) load4(xg + c0 + i, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads * 4;
          if (i < n) {
            store4(buf + i, v[u]);
            s += (v[u][0] + v[u][1]) + (v[u][2] + v[u][3]);
          }
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const T v = xg[c0 + i];
        buf[i] = v;
        s += to_f(v);
      }
    }
    const float m = block_sum(s, red) / static_cast<float>(n);
    float q = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float d = to_f(buf[i]) - m;
      q += d * d;
    }
    mo = merge(mo, Moments{static_cast<float>(n), m, block_sum(q, red)});
  }

  // The group's moments: the cluster's, merged in rank order.
  if (threadIdx.x == 0) {
    part[0] = mo.n;
    part[1] = mo.mean;
    part[2] = mo.m2;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    Moments all = {0.f, 0.f, 0.f};
    for (int r = 0; r < sh.k; ++r) {
      const float* o = cluster.map_shared_rank(part, r);
      all = merge(all, Moments{o[0], o[1], o[2]});
    }
    tot[0] = all.mean;
    tot[1] = rsqrtf(all.m2 / static_cast<float>(sh.L) + eps);
    if (rank == 0) {
      mean_out[gid] = tot[0];
      rstd_out[gid] = tot[1];
    }
  }
  // No block leaves or reuses `part` while another may still read it; the
  // barrier also shows `tot` to the block.
  cluster.sync();
  const float mu = tot[0], rs = tot[1];
  for (int c = threadIdx.x; c < sh.Cg; c += kThreads) {
    const float a = rs * scale[c];  // this thread's own reads above
    shift[c] -= mu * a;
    scale[c] = a;
  }
  __syncthreads();

  const T* idg = identity ? identity + base : nullptr;
  T* yg = y + base;
  for (int c0 = lo; c0 < hi; c0 += sh.chunk) {
    const int n = min(hi - c0, sh.chunk);
    if (kVec) {
      for (int i0 = threadIdx.x * 4; i0 < n; i0 += kThreads * 4 * kUnroll) {
        float v[kUnroll][4], r[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads * 4;
          if (i < n) {
            load4(on_chip ? buf + i : xg + c0 + i, v[u]);
            if (idg) load4(idg + c0 + i, r[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads * 4;
          if (i < n) {
            Chan ch(c0 + i, sh.S);
            float o[4];
#pragma unroll
            for (int j = 0; j < 4; ++j, ch.next(sh.S)) {
              float t = v[u][j] * scale[ch.c] + shift[ch.c];
              if (idg) t += r[u][j];
              o[j] = with_relu ? relu(t) : t;
            }
            store4(yg + c0 + i, o);
          }
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int e = c0 + i, c = e / sh.S;
        float t = to_f(on_chip ? buf[i] : xg[e]) * scale[c] + shift[c];
        if (idg) t += to_f(idg[e]);
        yg[e] = from_f<T>(with_relu ? relu(t) : t);
      }
    }
  }
}

// --------------------------------------------------------------- backward

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gn_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const T* __restrict__ y, const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const float* __restrict__ gamma, T* __restrict__ dx,
                  T* __restrict__ did, float* __restrict__ part,
                  const Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(blockIdx.x % sh.k);
  const long long gid = blockIdx.x / sh.k;
  const int g = static_cast<int>(gid % sh.G);
  const long long nidx = gid / sh.G;
  const long long base = gid * sh.L;
  const int lo = min(sh.L, rank * sh.slice), hi = min(sh.L, lo + sh.slice);
  const bool on_chip = sh.chunk >= sh.slice;
  const int S = sh.S, Cg = sh.Cg;
  const size_t vals = align16(held(sh) * sizeof(T));
  T* bz = reinterpret_cast<T*>(smem);         // dz
  T* bx = reinterpret_cast<T*>(smem + vals);  // x
  float* segs = reinterpret_cast<float*>(smem + 2 * vals);  // 2 a segment
  float* acc = segs + 2 * sh.segs;  // per channel: sum dz (x - mean), sum dz
  float* tot = acc + 2 * Cg;        // the same, the cluster's
  float* gam = tot + 2 * Cg;        // the group's gamma
  float* coef = gam + Cg;           // the group's two scalars
  const T* dyg = dy + base;
  const T* yg = y ? y + base : nullptr;
  const T* xg = x + base;
  T* didg = did ? did + base : nullptr;
  const float mu = mean[gid], rs = rstd[gid];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int c = threadIdx.x; c < 2 * Cg; c += kThreads) acc[c] = 0.f;
  for (int c = threadIdx.x; c < Cg; c += kThreads) gam[c] = gamma[g * Cg + c];
  __syncthreads();
  for (int c0 = lo; c0 < hi; c0 += sh.chunk) {
    const int n = min(hi - c0, sh.chunk);
    // dz and x into shared memory; d_identity = dz.
    if (kVec) {
      for (int i0 = threadIdx.x * 4; i0 < n; i0 += kThreads * 4 * kUnroll) {
        float z[kUnroll][4], v[kUnroll][4], w[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads * 4;
          if (i < n) {
            load4(dyg + c0 + i, z[u]);
            load4(xg + c0 + i, v[u]);
            if (yg) load4(yg + c0 + i, w[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads * 4;
          if (i < n) {
            if (yg) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                z[u][j] = relu_grad(z[u][j], w[u][j]);
            }
            store4(bz + i, z[u]);
            store4(bx + i, v[u]);
            if (didg) store4(didg + c0 + i, z[u]);
          }
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int e = c0 + i;
        const float z =
            yg ? relu_grad(to_f(dyg[e]), to_f(yg[e])) : to_f(dyg[e]);
        bz[i] = from_f<T>(z);
        bx[i] = xg[e];
        if (didg) didg[e] = from_f<T>(z);
      }
    }
    __syncthreads();
    // Segments: the pass cut at channel borders and every kSeg values of a
    // channel; a warp sums a segment, then a thread a channel's segments.
    const int cf = c0 / S, cl = (c0 + n - 1) / S;
    const int nfirst = (min(c0 + n, (cf + 1) * S) - c0 + kSeg - 1) / kSeg;
    const int nfull = (S + kSeg - 1) / kSeg;
    const int nseg = cl == cf ? nfirst
                              : nfirst + (cl - cf - 1) * nfull +
                                    (c0 + n - cl * S + kSeg - 1) / kSeg;
    for (int sg = warp; sg < nseg; sg += kWarps) {
      int c = cf, sub = sg;
      if (sg >= nfirst) {
        c = cf + 1 + (sg - nfirst) / nfull;
        sub = (sg - nfirst) % nfull;
      }
      const int s0 = max(c0, c * S) + sub * kSeg;
      const int s1 = min(min(c0 + n, (c + 1) * S), s0 + kSeg);
      float sx = 0.f, sz = 0.f;
      for (int e = s0 + lane; e < s1; e += 32) {
        const float zv = to_f(bz[e - c0]);
        sx += zv * (to_f(bx[e - c0]) - mu);
        sz += zv;
      }
      sx = warp_sum(sx);
      sz = warp_sum(sz);
      if (lane == 0) {
        segs[2 * sg] = sx;
        segs[2 * sg + 1] = sz;
      }
    }
    __syncthreads();
    for (int c = cf + threadIdx.x; c <= cl; c += kThreads) {
      const int first = c == cf ? 0 : nfirst + (c - cf - 1) * nfull;
      const int len = min(c0 + n, (c + 1) * S) - max(c0, c * S);
      float sx = 0.f, sz = 0.f;
      for (int j = first; j < first + (len + kSeg - 1) / kSeg; ++j) {
        sx += segs[2 * j];
        sz += segs[2 * j + 1];
      }
      acc[c] += sx;
      acc[Cg + c] += sz;
    }
    __syncthreads();
  }

  // The group's sums: the cluster's, added in rank order.
  cluster.sync();
  for (int c = threadIdx.x; c < 2 * Cg; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < sh.k; ++r) s += cluster.map_shared_rank(acc, r)[c];
    tot[c] = s;
  }
  cluster.sync();
  if (warp == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < Cg; c += 32) {
      const float gm = gam[c];
      s1 += gm * tot[Cg + c];
      s2 += gm * tot[c];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      coef[0] = -rs * s1 / static_cast<float>(sh.L);
      coef[1] = -rs * rs * rs * s2 / static_cast<float>(sh.L);
    }
  }
  // The (n, c) partials of dgamma and dbeta; `acc` now holds rstd gamma_c
  // (no block reads it any more).
  for (int c = threadIdx.x; c < Cg; c += kThreads) {
    if (rank == 0) {
      part[(2 * nidx) * sh.C + g * Cg + c] = rs * tot[c];
      part[(2 * nidx + 1) * sh.C + g * Cg + c] = tot[Cg + c];
    }
    acc[c] = rs * gam[c];
  }
  __syncthreads();
  const float c1 = coef[0], c2 = coef[1];

  T* dxg = dx + base;
  for (int c0 = lo; c0 < hi; c0 += sh.chunk) {
    const int n = min(hi - c0, sh.chunk);
    if (kVec) {
      for (int i0 = threadIdx.x * 4; i0 < n; i0 += kThreads * 4 * kUnroll) {
        float z[kUnroll][4], v[kUnroll][4], w[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads * 4;
          if (i < n) {
            if (on_chip) {
              load4(bz + i, z[u]);
              load4(bx + i, v[u]);
            } else {
              load4(dyg + c0 + i, z[u]);
              load4(xg + c0 + i, v[u]);
              if (yg) load4(yg + c0 + i, w[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads * 4;
          if (i < n) {
            Chan ch(c0 + i, S);
            float o[4];
#pragma unroll
            for (int j = 0; j < 4; ++j, ch.next(S)) {
              const float zv = !on_chip && yg ? relu_grad(z[u][j], w[u][j])
                                              : z[u][j];
              o[j] = acc[ch.c] * zv + c2 * (v[u][j] - mu) + c1;
            }
            store4(dxg + c0 + i, o);
          }
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int e = c0 + i;
        float zv, xv;
        if (on_chip) {
          zv = to_f(bz[i]);
          xv = to_f(bx[i]);
        } else {
          zv = yg ? relu_grad(to_f(dyg[e]), to_f(yg[e])) : to_f(dyg[e]);
          xv = to_f(xg[e]);
        }
        dxg[e] = from_f<T>(acc[e / S] * zv + c2 * (xv - mu) + c1);
      }
    }
  }
}

// dgamma and dbeta: the (n, c) partials added over n in order.
__global__ void gn_param_grad_kernel(const float* __restrict__ part,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int N,
                                     int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sg = 0.f, sb = 0.f;
  for (int n = 0; n < N; ++n) {
    sg += part[(2LL * n) * C + c];
    sb += part[(2LL * n + 1) * C + c];
  }
  dgamma[c] = sg;
  dbeta[c] = sb;
}

// ------------------------------------------------------------------ host

template <typename... Params, typename... Args>
int launch_k(void (*kernel)(Params...), long long blocks, int threads, int k,
             size_t shared, cudaStream_t stream, Args... args) {
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = k > 0 ? 1 : 0;  // k = 0: no cluster
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

bool aligned(const void* p, size_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

// Checks the plan and fills the shape; false where the launch cannot be.
bool make_shape(Shape& sh, int N, int C, int S, int G, int k, int slice,
                int chunk) {
  if (N < 1 || C < 1 || S < 1 || G < 1 || C % G) return false;
  if (k < 1) return false;
  const long long L = static_cast<long long>(C / G) * S;
  if (L > 0x7fffffffLL || slice < 1 || chunk < 1 ||
      static_cast<long long>(slice) * k < L)
    return false;
  sh.C = C;
  sh.G = G;
  sh.S = S;
  sh.Cg = C / G;
  sh.L = static_cast<int>(L);
  sh.k = k;
  sh.slice = slice;
  sh.chunk = chunk;
  // Segments of a pass of n values: at most n / kSeg + 1 beyond one a
  // channel it touches.
  const int n = held(sh);
  const int channels = n / S + 2 < sh.Cg ? n / S + 2 : sh.Cg;
  sh.segs = n / kSeg + 1 + channels;
  return true;
}

template <typename T>
bool vec_ok(const Shape& sh, std::initializer_list<const void*> ptrs) {
  if (sh.L % 4 || sh.slice % 4 || sh.chunk % 4) return false;
  for (const void* p : ptrs)
    if (p && !aligned(p, 4 * sizeof(T))) return false;
  return true;
}

template <typename T>
int fwd(const void* x, const float* gamma, const float* beta,
        const void* identity, void* y, float* mean, float* rstd, int N,
        const Shape& sh, int relu, float eps, cudaStream_t stream) {
  const size_t shared = align16(held(sh) * sizeof(T)) +
                        sizeof(float) * (kWarps + 8 + 2 * sh.Cg);
  const long long blocks = static_cast<long long>(N) * sh.G * sh.k;
  const T* xt = static_cast<const T*>(x);
  const T* it = static_cast<const T*>(identity);
  T* yt = static_cast<T*>(y);
  if (vec_ok<T>(sh, {x, identity, y}))
    return launch_k(gn_fwd_kernel<T, true>, blocks, kThreads, sh.k, shared,
                    stream, xt, gamma, beta, it, yt, mean, rstd, sh, relu,
                    eps);
  return launch_k(gn_fwd_kernel<T, false>, blocks, kThreads, sh.k, shared,
                  stream, xt, gamma, beta, it, yt, mean, rstd, sh, relu, eps);
}

template <typename T>
int bwd(const void* dy, const void* x, const void* y, const float* mean,
        const float* rstd, const float* gamma, void* dx, void* did,
        float* part, float* dgamma, float* dbeta, int N, const Shape& sh,
        cudaStream_t stream) {
  const size_t shared = 2 * align16(held(sh) * sizeof(T)) +
                        sizeof(float) * (2 * sh.segs + 5 * sh.Cg + 4);
  const long long blocks = static_cast<long long>(N) * sh.G * sh.k;
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* dxt = static_cast<T*>(dx);
  T* didt = static_cast<T*>(did);
  const int err =
      vec_ok<T>(sh, {dy, x, y, dx, did})
          ? launch_k(gn_bwd_kernel<T, true>, blocks, kThreads, sh.k, shared,
                     stream, dyt, xt, yt, mean, rstd, gamma, dxt, didt, part,
                     sh)
          : launch_k(gn_bwd_kernel<T, false>, blocks, kThreads, sh.k, shared,
                     stream, dyt, xt, yt, mean, rstd, gamma, dxt, didt, part,
                     sh);
  if (err) return err;
  return launch_k(gn_param_grad_kernel, (sh.C + kThreads - 1) / kThreads,
                  kThreads, 0, 0, stream, static_cast<const float*>(part),
                  dgamma, dbeta, N, sh.C);
}

}  // namespace

// The plan's limits on device `device` (ops/cuda/groupnorm.py::Card):
// out[0] its SMs, out[1] the blocks an SM the kernels are compiled for,
// out[2] its shared memory an SM.  Returns cudaGetLastError().
extern "C" int groupnorm_card(int device, int* out) {
  cudaError_t e = cudaDeviceGetAttribute(&out[0],
                                         cudaDevAttrMultiProcessorCount,
                                         device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &out[2], cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  out[1] = kBlocksPerSM;
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// x, identity (or null), y: (N, C, S...) contiguous, of type io (0 float32,
// 1 bfloat16; lib.IO_CODES); gamma, beta: C float32; mean, rstd: N * G
// float32 out.  k, slice, chunk: the plan (ops/cuda/groupnorm.py::plan).
// Returns cudaGetLastError(), or cudaErrorInvalidValue on a bad shape or
// plan.
extern "C" int groupnorm_fwd(const void* x, const void* gamma,
                             const void* beta, const void* identity, void* y,
                             void* mean, void* rstd, int N, int C, int S,
                             int G, int relu, int io, int k, int slice,
                             int chunk, float eps, void* stream) {
  Shape sh;
  if ((io != 0 && io != 1) || !make_shape(sh, N, C, S, G, k, slice, chunk))
    return cudaErrorInvalidValue;
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* mn = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return io == 0 ? fwd<float>(x, gm, bt, identity, y, mn, rs, N, sh, relu,
                              eps, s)
                 : fwd<__nv_bfloat16>(x, gm, bt, identity, y, mn, rs, N, sh,
                                      relu, eps, s);
}

// dy, x, y (null without a ReLU), dx, did (null without an identity): (N,
// C, S...) contiguous of type io; mean, rstd: the forward's; gamma: C
// float32; part: 2 N C float32 scratch; dgamma, dbeta: C float32 out.
extern "C" int groupnorm_bwd(const void* dy, const void* x, const void* y,
                             const void* mean, const void* rstd,
                             const void* gamma, void* dx, void* did,
                             void* part, void* dgamma, void* dbeta, int N,
                             int C, int S, int G, int io, int k, int slice,
                             int chunk, void* stream) {
  Shape sh;
  if ((io != 0 && io != 1) || !make_shape(sh, N, C, S, G, k, slice, chunk))
    return cudaErrorInvalidValue;
  const float* mn = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* gm = static_cast<const float*>(gamma);
  float* pt = static_cast<float*>(part);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return io == 0 ? bwd<float>(dy, x, y, mn, rs, gm, dx, did, pt, dg, db, N,
                              sh, s)
                 : bwd<__nv_bfloat16>(dy, x, y, mn, rs, gm, dx, did, pt, dg,
                                      db, N, sh, s);
}

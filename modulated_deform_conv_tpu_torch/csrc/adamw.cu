// adamw: the trainer's AdamW update, every leaf of one type in one launch.
//
// Not a port of a TPU kernel: the JAX trainer updates with optax's adamw,
// which XLA fuses into its step.  torch.optim.AdamW's capturable path makes
// about a dozen foreach passes over the leaves instead (decay, lerp, mul,
// addcmul, the bias corrections, sqrt into a new buffer, div, add, div,
// addcdiv).  The update does a few operations a value and is bound by
// memory: p, g, m and v read once and p, m and v written once, 7 x 4 bytes
// a float32 value (DCNResNet-50: 26.4 M values, 0.74 GB, 0.22 ms at 3.35
// TB/s).  So this kernel makes that one pass and nothing else:
//
// * The leaves come as a table passed by value (kernel parameters, no
//   device copy): each leaf's p, g, m, v and step addresses and its length.
//   The leaf is cut into tiles of kThreads * kUnroll 16-byte vectors; block
//   b takes tile b and finds its leaf by a binary search of the tiles'
//   prefix.  A tile whose four tensors are 16-byte aligned and that lies
//   inside the leaf moves 16 bytes a load and a store; a leaf's last tile,
//   or a misaligned leaf, goes one value a thread at a time.
// * The arithmetic follows torch.optim.AdamW in float32 whatever the
//   leaf's type (float32 or bfloat16, p, g, m and v of one type), each
//   value rounded once on its store:
//     t = step + 1, c1 = 1 - b1^t, c2 = 1 - b2^t
//       (as -expm1(t log b): 1 - b^t from a float b loses 1 - b's low
//       digits, 1.3e-5 of 1 - 0.999; the caller rounds log b from double)
//     p *= 1 - lr * wd
//     m = b1 m + (1 - b1) g
//     v = b2 v + (1 - b2) g^2
//     p -= lr / c1 * m / (sqrt(v) / sqrt(c2) + eps)
//   Nothing is allocated; sqrt(v) never leaves a register.
// * The step count stays on the device (each leaf's 0-dim float32 tensor),
//   so the update can be captured in a CUDA graph.  Every block reads its
//   leaf's count before it arrives at `done`; the last block to arrive
//   adds 1 to every count of the launch and puts `done` back to 0.  So
//   every read sees the count of before the step and uses it plus one, and
//   the count ends the launch one higher: the order torch keeps (count
//   first, then the update) with one launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// Kernel parameters may take 32,764 bytes since CUDA 12.1, 4,096 before.
#if CUDART_VERSION >= 12010
constexpr int kMaxLeaves = 384;
#else
constexpr int kMaxLeaves = 48;
#endif

struct Table {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  float* step[kMaxLeaves];
  long long n[kMaxLeaves];
  int first[kMaxLeaves];  // the leaf's first tile
  int leaves;
  float lr, b1, omb1, b2, omb2, log_b1, log_b2, eps, decay;
};

struct Coef {
  float decay, b1, omb1, b2, omb2, step_size, sqrt_c2, eps;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch does
}

template <typename T>
__device__ __forceinline__ void update(T& p, T g, T& m, T& v,
                                       const Coef& c) {
  const float gf = to_f(g);
  const float mf = c.b1 * to_f(m) + c.omb1 * gf;
  const float vf = c.b2 * to_f(v) + c.omb2 * gf * gf;
  const float denom = sqrtf(vf) / c.sqrt_c2 + c.eps;
  p = from_f<T>(to_f(p) * c.decay - c.step_size * mf / denom);
  m = from_f<T>(mf);
  v = from_f<T>(vf);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const Table tab, unsigned int* done) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kTile = kThreads * kUnroll * kVec;
  __shared__ int s_leaf;
  __shared__ Coef s_coef;
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    int lo = 0, hi = tab.leaves - 1;  // the leaf whose tiles hold this one
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab.first[mid] <= static_cast<int>(blockIdx.x)) lo = mid;
      else hi = mid - 1;
    }
    const float t = *tab.step[lo] + 1.f;
    const float c1 = -expm1f(t * tab.log_b1), c2 = -expm1f(t * tab.log_b2);
    s_leaf = lo;
    s_coef = Coef{tab.decay, tab.b1,      tab.omb1,  tab.b2,
                  tab.omb2,  tab.lr / c1, sqrtf(c2), tab.eps};
  }
  __syncthreads();
  const int leaf = s_leaf;
  const Coef c = s_coef;
  const long long n = tab.n[leaf];
  const long long base =
      static_cast<long long>(blockIdx.x - tab.first[leaf]) * kTile;
  T* p = static_cast<T*>(tab.p[leaf]);
  const T* g = static_cast<const T*>(tab.g[leaf]);
  T* m = static_cast<T*>(tab.m[leaf]);
  T* v = static_cast<T*>(tab.v[leaf]);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) &
       15) == 0;
  if (aligned && base + kTile <= n) {
    // All loads of the tile first, then the arithmetic and the stores.
    uint4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + static_cast<long long>(k * kThreads +
                                                        threadIdx.x) * kVec;
      rp[k] = *reinterpret_cast<const uint4*>(p + i);
      rg[k] = *reinterpret_cast<const uint4*>(g + i);
      rm[k] = *reinterpret_cast<const uint4*>(m + i);
      rv[k] = *reinterpret_cast<const uint4*>(v + i);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      T* ep = reinterpret_cast<T*>(&rp[k]);
      const T* eg = reinterpret_cast<const T*>(&rg[k]);
      T* em = reinterpret_cast<T*>(&rm[k]);
      T* ev = reinterpret_cast<T*>(&rv[k]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) update(ep[j], eg[j], em[j], ev[j], c);
      const long long i = base + static_cast<long long>(k * kThreads +
                                                        threadIdx.x) * kVec;
      *reinterpret_cast<uint4*>(p + i) = rp[k];
      *reinterpret_cast<uint4*>(m + i) = rm[k];
      *reinterpret_cast<uint4*>(v + i) = rv[k];
    }
  } else {
    const long long end = base + kTile < n ? base + kTile : n;
    for (long long i = base + threadIdx.x; i < end; i += kThreads) {
      T pi = p[i], mi = m[i], vi = v[i];
      update(pi, g[i], mi, vi, c);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
  }
  // Thread 0 read the count before this barrier; the last block to arrive
  // counts the step.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int i = threadIdx.x; i < tab.leaves; i += kThreads)
      *tab.step[i] += 1.f;
    if (threadIdx.x == 0) *done = 0;
  }
}

template <typename T>
int launch(Table& tab, const long long* table, unsigned int* done,
           cudaStream_t stream) {
  constexpr long long kTile = kThreads * kUnroll * (16 / sizeof(T));
  long long tiles = 0;
  for (int i = 0; i < tab.leaves; ++i) {
    const long long* row = table + 6 * i;
    if (row[5] < 0) return cudaErrorInvalidValue;
    tab.p[i] = reinterpret_cast<void*>(row[0]);
    tab.g[i] = reinterpret_cast<const void*>(row[1]);
    tab.m[i] = reinterpret_cast<void*>(row[2]);
    tab.v[i] = reinterpret_cast<void*>(row[3]);
    tab.step[i] = reinterpret_cast<float*>(row[4]);
    tab.n[i] = row[5];
    tab.first[i] = static_cast<int>(tiles);
    // An empty leaf takes one idle tile, so every leaf owns a tile.
    tiles += row[5] > 0 ? (row[5] + kTile - 1) / kTile : 1;
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  adamw_kernel<T><<<static_cast<unsigned int>(tiles), kThreads, 0, stream>>>(
      tab, done);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most leaves one launch takes.
extern "C" int adamw_max_leaves() { return kMaxLeaves; }

// table: `leaves` rows of 6 int64 on the host (the addresses of p, g, m, v
// and step, then the length); io: 0 float32, 1 bfloat16 (lib.IO_CODES);
// done: one uint32 on the device, 0 between launches; omb1, omb2: 1 - b1
// and 1 - b2, log_b1 and log_b2 the logarithms of b1 and b2, as the caller
// rounds them from double; decay: 1 - lr * wd.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue on a bad table.
extern "C" int adamw(const long long* table, void* done, int leaves, int io,
                     float lr, float b1, float omb1, float b2, float omb2,
                     float log_b1, float log_b2, float eps, float decay,
                     void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves || (io != 0 && io != 1))
    return cudaErrorInvalidValue;
  Table tab = {};
  tab.leaves = leaves;
  tab.lr = lr;
  tab.b1 = b1;
  tab.omb1 = omb1;
  tab.b2 = b2;
  tab.omb2 = omb2;
  tab.log_b1 = log_b1;
  tab.log_b2 = log_b2;
  tab.eps = eps;
  tab.decay = decay;
  unsigned int* counter = static_cast<unsigned int*>(done);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return io == 0 ? launch<float>(tab, table, counter, s)
                 : launch<__nv_bfloat16>(tab, table, counter, s);
}

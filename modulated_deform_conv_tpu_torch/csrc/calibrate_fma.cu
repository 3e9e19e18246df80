// calibrate_fma: the card's FP32 FMA rate, for calibrate.py.
//
// Not a port of a TPU kernel: a measurement.  Eager PyTorch cannot reach
// the FP32 FMA peak (each elementwise op is a kernel bound by memory), so
// every thread runs kChains independent chains of fmaf in registers, long
// enough that the one store a thread makes is negligible, and writes their
// sum so that no chain is dead code.  FLOPs: 2 * kChains * iters * blocks *
// kThreads.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

__global__ void __launch_bounds__(kThreads) fma_kernel(float* out, int iters) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  float a[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) a[j] = 1e-3f * static_cast<float>((t + j) & 1023);
  const float b = 0.999999f, c = 1e-7f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) a[j] = fmaf(a[j], b, c);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += a[j];
  out[t] = s;
}

}  // namespace

// out: blocks * 256 floats on the current device.  Returns
// cudaGetLastError().
extern "C" int calibrate_fma(float* out, int blocks, int iters, void* stream) {
  fma_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

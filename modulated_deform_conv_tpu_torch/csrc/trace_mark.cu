// trace_mark: the marks of the program's device spans (utils/profiling.py).
//
// Not a port of a TPU kernel: a measurement.  A mark is one thread that
// stores the GPU's %globaltimer (ns) into ring[(*ctr % rows) * width +
// slot]; the mark that closes a captured step's root span also advances
// *ctr, so each replay of a CUDA graph fills the next row of its ring.
// Kernels of one stream run in order, so the counter needs no atomics.
// Bound by the launch itself (a few microseconds a node): the kernel
// reads one word and writes one or two.
#include <cuda_runtime.h>

namespace mdc {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void trace_mark_kernel(unsigned long long* ring,
                                  unsigned long long* ctr, int slot, int rows,
                                  int width, int advance) {
  const unsigned long long t = global_ns();
  const unsigned long long c = *ctr;
  ring[(c % rows) * width + slot] = t;
  if (advance) *ctr = c + 1;
}

// The first n distinct timer values one thread reads back to back, within
// `spins` reads: their differences show the timer's resolution.
__global__ void trace_clock_steps_kernel(unsigned long long* out, int n,
                                         long long spins) {
  unsigned long long last = global_ns();
  out[0] = last;
  int k = 1;
  for (long long i = 0; i < spins && k < n; ++i) {
    const unsigned long long t = global_ns();
    if (t != last) {
      out[k++] = t;
      last = t;
    }
  }
}

}  // namespace mdc

// ring: rows * width int64 on the device; ctr: one int64 on the device.
// Returns cudaGetLastError().
extern "C" int trace_mark(void* ring, void* ctr, int slot, int rows, int width,
                          int advance, void* stream) {
  mdc::trace_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring),
      static_cast<unsigned long long*>(ctr), slot, rows, width, advance);
  return static_cast<int>(cudaGetLastError());
}

// out: n int64 on the device, zeroed by the caller.
extern "C" int trace_clock_steps(void* out, int n, long long spins,
                                 void* stream) {
  mdc::trace_clock_steps_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out), n, spins);
  return static_cast<int>(cudaGetLastError());
}

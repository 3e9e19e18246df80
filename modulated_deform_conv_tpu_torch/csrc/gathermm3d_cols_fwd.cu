// gathermm3d_cols_fwd: the deformable columns (3D) of the unfused path.
//
// Replaces the 3D (flat and planar) mode of the TPU kernel
// modulated_deform_conv_tpu/ops/pallas/gathermm.py::_fwd_kernel (:523).
// Planar mode (:550-586) bounds each output tile's sweep by a lead-plane
// range x an in-plane chunk range, so that the dense corner-matrix product
// visits fewer input chunks; a direct gather reads only the eight corners of
// each tap and needs no such mode.
//
// What bounds it on the H100: the columns it writes, C * K * B * P values
// (226 MB in fp32 at BASELINE config 3's size, B=2, 64 channels, 16 x 32 x
// 32, 27 taps): ~0.07 ms at 3.35 TB/s.
//
// What the design does about that: gathermm_cols_fwd.cu's design with the
// trilinear corner rules of deform_tile3d.cuh.  One thread per (batch,
// deformable group, tap, position) builds the tap's eight corner weights
// once and blends up to 32 channels of its slab from them into the columns
// (C * K, B * P), row c * K + k, column b * P + p; fp32, bf16 in
// "bfloat16".
#include "deform_bwd3d.cuh"

namespace {

using namespace mdc;

template <typename T>
__global__ void __launch_bounds__(kColThreads) cols3_kernel(const float* __restrict__ x,
                                                            const float* __restrict__ offset,
                                                            const float* __restrict__ mask, T* __restrict__ cols,
                                                            Geo3 g) {
  const int K = taps3(g), P = out_size3(g), HW = g.H * g.W, Cdg = g.C / g.dg;
  const size_t S = static_cast<size_t>(g.D) * HW;
  const size_t e = static_cast<size_t>(blockIdx.x) * kColThreads + threadIdx.x;
  if (e >= static_cast<size_t>(g.B) * g.dg * K * P) return;
  const int p = e % P, k = (e / P) % K, d = (e / (static_cast<size_t>(P) * K)) % g.dg;
  const int b = e / (static_cast<size_t>(P) * K * g.dg);
  const TapWeights3 t = weights3_at(g, offset, mask, b, d, k, p);
  const int i0 = t.z0 * HW + t.y0 * g.W + t.x0;
  const int c0 = d * Cdg + blockIdx.y * kColChans, c1 = min((d + 1) * Cdg, c0 + kColChans);
  const size_t BP = static_cast<size_t>(g.B) * P;
  const float* xb = x + static_cast<size_t>(b) * g.C * S;
  T* out = cols + static_cast<size_t>(k) * BP + static_cast<size_t>(b) * P + p;
#pragma unroll 4
  for (int c = c0; c < c1; ++c)
    out[static_cast<size_t>(c) * K * BP] = to_elem<T>(blend3(xb + static_cast<size_t>(c) * S, i0, g.W, HW, t.lo, t.hi));
}

}  // namespace

// x (B, C, D, H, W), offset (B, dg*3*K, OD, OH, OW), mask (B, dg*K, OD, OH,
// OW) or null: float32, contiguous, on the current device.  cols (C*K,
// B*OD*OH*OW): float32, or bfloat16 when precision is "bfloat16".  Returns
// cudaGetLastError().
extern "C" int gathermm3d_cols_fwd(const float* x, const float* offset, const float* mask, void* cols, int B,
                                   int C, int D, int H, int W, int OD, int OH, int OW, int dg, int kd, int kh, int kw,
                                   int sd, int sh, int sw, int pd, int ph, int pw, int dd, int dh, int dw,
                                   int precision, void* stream) {
  using namespace mdc;
  const Geo3 g{B,  C,  D,  H,  W,  0,  OD, OH, OW, 1, dg, kd, kh, kw, sd, sh,
               sw, pd, ph, pw, dd, dh, dw, 0,  0,  0,  0, 0,  0,  0,  precision};
  const size_t n = static_cast<size_t>(B) * dg * taps3(g) * out_size3(g);
  const dim3 grid(static_cast<unsigned>((n + kColThreads - 1) / kColThreads), (C / dg + kColChans - 1) / kColChans);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (precision == kBFloat16)
    cols3_kernel<<<grid, kColThreads, 0, s>>>(x, offset, mask, static_cast<__nv_bfloat16*>(cols), g);
  else
    cols3_kernel<<<grid, kColThreads, 0, s>>>(x, offset, mask, static_cast<float*>(cols), g);
  return static_cast<int>(cudaGetLastError());
}

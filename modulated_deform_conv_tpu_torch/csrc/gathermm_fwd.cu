// gathermm_fwd: general-offset DCN forward (2D), gather + grouped GEMM fused.
//
// Replaces the TPU kernel modulated_deform_conv_tpu/ops/pallas/gathermm.py::
// _fwd_fused_kernel (:1162).  That kernel expresses the bilinear gather as a
// product with a structured-sparse matrix A = prod_d F_d, visits only the
// input chunks inside data-dependent [lo, hi) bounds and fuses out += W2 cols
// per tap group, because the TPU has a matrix unit and no fast gather.
//
// What bounds it on the H100: one forward moves x, offset, mask and out once
// (62.8 MB in f32 at the bench's config 2) and does 2 * B * P * O * C/g * K
// FLOPs (7.40 GFLOP there).  At 3.35 TB/s and 495 TFLOP/s TF32 the bytes bound
// it (~19 us); with the plain FP32 FMAs this kernel uses, the 67 TFLOP/s FP32
// rate bounds it (~110 us).  The gather itself is latency-bound: corners of an
// unbounded offset can land anywhere in the plane.
//
// What the design does about that: the corner table (index + 4 weights per
// tap and position, gate and mask folded) is built once per block and
// deformable-group slab, so each column value costs 4 cached loads and 4 FMAs;
// corners are read through L1/L2 straight from device memory (the reach is
// unbounded, so nothing is staged).  The columns never leave shared memory:
// each (channel, tap) chunk is multiplied into register accumulators at once,
// and the slabs of a conv group sum in that loop, with no partials in device
// memory.  Tensor cores (mma/wgmma) and pipelined loads are later work.
#include "deform_tile.cuh"

namespace {

using namespace mdc;

__global__ void __launch_bounds__(kThreads) gathermm_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, const float* __restrict__ wt,
    const float* __restrict__ bias, float* __restrict__ out, int C, int H,
    int W, int O, int OH, int OW, int groups, int dg, int kh, int kw, int sh,
    int sw, int ph, int pw, int dh, int dw, int precision) {
  extern __shared__ __align__(16) float smem[];
  const int K = kh * kw, P = OH * OW;
  const int Cgc = C / groups, Og = O / groups, Cdg = C / dg;
  const int o_tiles = (Og + kTO - 1) / kTO;
  const int p0 = blockIdx.x * kTP;
  const int gi = blockIdx.y / o_tiles;
  const int o0 = (blockIdx.y % o_tiles) * kTO;
  const int b = blockIdx.z;

  float* colsS = smem;                                          // [kRows][kTP]
  float* wS = colsS + kRows * kTP;                              // [kRows][kWStride]
  float4* tw = reinterpret_cast<float4*>(wS + kRows * kWStride);  // [K][kTP]
  int* tb = reinterpret_cast<int*>(tw + K * kTP);               // [K][kTP]

  const float* xb = x + static_cast<size_t>(b) * C * H * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[4][4] = {};

  const int c_begin = gi * Cgc, c_end = c_begin + Cgc;
  for (int c_seg = c_begin; c_seg < c_end;) {
    // Channels [c_seg, c_seg_end) share deformable group d (and conv group gi).
    const int d = c_seg / Cdg;
    const int c_seg_end = min(c_end, (d + 1) * Cdg);
    __syncthreads();
    for (int e = threadIdx.x; e < K * kTP; e += kThreads) {
      const int k = e / kTP, p = p0 + e % kTP;
      TapWeights t{0, 0, make_float4(0.f, 0.f, 0.f, 0.f)};
      if (p < P) {
        const int oy = p / OW, ox = p % OW;
        const int ky = k / kw, kx = k % kw;
        const size_t oidx = (static_cast<size_t>(b) * dg * 2 * K + static_cast<size_t>(d) * 2 * K + 2 * k) * P + p;
        const float m = mask ? mask[(static_cast<size_t>(b) * dg * K + static_cast<size_t>(d) * K + k) * P + p] : 1.f;
        t = tap_weights(oy * sh - ph + ky * dh, ox * sw - pw + kx * dw, offset[oidx], offset[oidx + P], m, H, W,
                        false, 0, 0, 0, 0);
      }
      tw[e] = t.w;
      tb[e] = t.y0 * W + t.x0;
    }
    // Rows of this slab are (c - c_seg) * K + k, chunked by kRows.
    const int R = (c_seg_end - c_seg) * K;
    const float* wt_seg = wt + (static_cast<size_t>(gi) * Cgc * K + static_cast<size_t>(c_seg - c_begin) * K) * Og;
    for (int r0 = 0; r0 < R; r0 += kRows) {
      const int rows = min(kRows, R - r0);
      __syncthreads();  // table written; previous chunk's GEMM done with colsS/wS
      for (int r = warp; r < rows; r += kThreads / 32) {
        const int rr = r0 + r;
        const int k = rr % K;
        const float* xc = xb + static_cast<size_t>(c_seg + rr / K) * H * W;
        for (int p = lane; p < kTP; p += 32)
          colsS[r * kTP + p] = operand(blend(xc, tb[k * kTP + p], W, tw[k * kTP + p]), precision);
      }
      load_weights(wS, wt_seg + static_cast<size_t>(r0) * Og, rows, Og, o0, precision);
      __syncthreads();
      tile_fma(colsS, wS, rows, acc);
    }
    c_seg = c_seg_end;
  }

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + ty * 4 + i;
    if (o >= Og) continue;
    const int oc = gi * Og + o;
    const float bv = bias ? bias[oc] : 0.f;
    float* orow = out + (static_cast<size_t>(b) * O + oc) * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (p < P) orow[p] = acc[i][j] + bv;
    }
  }
}

}  // namespace

// x (B, C, H, W), offset (B, dg*2*K, OH, OW), mask (B, dg*K, OH, OW) or null,
// wt (groups, C/groups*K, O/groups), bias (O) or null, out (B, O, OH, OW):
// all float32, contiguous, on the current device.  Returns cudaGetLastError().
extern "C" int gathermm_fwd(const float* x, const float* offset,
                            const float* mask, const float* wt,
                            const float* bias, float* out, int B, int C, int H,
                            int W, int O, int OH, int OW, int groups, int dg,
                            int kh, int kw, int sh, int sw, int ph, int pw,
                            int dh, int dw, int precision, void* stream) {
  using namespace mdc;
  const int K = kh * kw;
  const size_t smem = smem_floats(kRows, K, 0) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gathermm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Og = O / groups;
  const dim3 grid((OH * OW + kTP - 1) / kTP, groups * ((Og + kTO - 1) / kTO), B);
  gathermm_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, offset, mask, wt, bias, out, C, H, W, O, OH, OW, groups, dg, kh, kw,
      sh, sw, ph, pw, dh, dw, precision);
  return static_cast<int>(cudaGetLastError());
}

// gathermm3d_fwd: general-offset DCN forward (3D), gather + grouped GEMM
// fused.
//
// Replaces the 3D (planar and flat) mode of the TPU kernel
// modulated_deform_conv_tpu/ops/pallas/gathermm.py::_fwd_fused_kernel
// (:1162).  There the trilinear gather is a product with A = F_z F_y F_x
// over the input chunks inside data-dependent bounds (planar mode: a lead-
// plane range x an in-plane chunk range per tile), fused with out += W2 cols,
// because the TPU has a matrix unit and no fast gather.
//
// What bounds it on the H100: one forward moves x, offset, mask and out once
// and does 2 * B * P * O * C/g * K FLOPs (27 MB and 7.25 GFLOP at BASELINE
// config 3: ~0.015 ms at the 495 TFLOP/s TF32 rate; ~0.11 ms at the 67
// TFLOP/s FP32 FMA rate used here).  The gather itself is latency-bound:
// the eight corners of an unbounded offset can land anywhere in the volume.
//
// What the design does about that: the 2D kernel's shape (gathermm_fwd.cu)
// with the trilinear corner rules of deform_tile3d.cuh.  A block owns 64
// consecutive output positions x 64 output channels of one conv group; per
// deformable-group slab it builds a corner table in shared memory (the low
// corner's flat index and the eight mask-folded weights per (tap,
// position)), so each column value costs 8 cached loads and 8 FMAs; the
// columns never leave shared memory and the slabs of a group sum in
// registers.  A Hopper gather reads the eight corners directly, so the TPU's
// chunk bounds (flat or planar) have no counterpart in the forward.
#include "deform_tile3d.cuh"

namespace {

using namespace mdc;

__global__ void __launch_bounds__(kThreads) gathermm3d_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ offset, const float* __restrict__ mask,
    const float* __restrict__ wt, const float* __restrict__ bias, float* __restrict__ out, Geo3 g) {
  extern __shared__ __align__(16) float smem[];
  const int K = taps3(g), P = out_size3(g), HW = g.H * g.W, S = g.D * HW;
  const int Cgc = g.C / g.groups, Og = g.O / g.groups, Cdg = g.C / g.dg;
  const int o_tiles = (Og + kTO - 1) / kTO;
  const int p0 = blockIdx.x * kTP;
  const int gi = blockIdx.y / o_tiles;
  const int o0 = (blockIdx.y % o_tiles) * kTO;
  const int b = blockIdx.z;

  float* colsS = smem;                                              // [kRows][kTP]
  float* wS = colsS + kRows * kTP;                                  // [kRows][kWStride]
  float4* twl = reinterpret_cast<float4*>(wS + kRows * kWStride);  // [K][kTP]
  float4* twh = twl + K * kTP;                                      // [K][kTP]
  int* tb = reinterpret_cast<int*>(twh + K * kTP);                  // [K][kTP]

  const float* xb = x + static_cast<size_t>(b) * g.C * S;
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
      TapWeights3 t{0, 0, 0, make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
      if (p < P) t = weights3_at(g, offset, mask, b, d, k, p);
      twl[e] = t.lo;
      twh[e] = t.hi;
      tb[e] = t.z0 * HW + t.y0 * g.W + t.x0;
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
        const float* xc = xb + static_cast<size_t>(c_seg + rr / K) * S;
        for (int p = lane; p < kTP; p += 32) {
          const int e = k * kTP + p;
          colsS[r * kTP + p] = operand(blend3(xc, tb[e], g.W, HW, twl[e], twh[e]), g.precision);
        }
      }
      load_weights(wS, wt_seg + static_cast<size_t>(r0) * Og, rows, Og, o0, g.precision);
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
    float* orow = out + (static_cast<size_t>(b) * g.O + oc) * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (p < P) orow[p] = acc[i][j] + bv;
    }
  }
}

}  // namespace

// x (B, C, D, H, W), offset (B, dg*3*K, OD, OH, OW), mask (B, dg*K, OD, OH,
// OW) or null, wt (groups, C/groups*K, O/groups), bias (O) or null, out (B,
// O, OD, OH, OW): all float32, contiguous, on the current device.  Returns
// cudaGetLastError().
extern "C" int gathermm3d_fwd(const float* x, const float* offset, const float* mask, const float* wt,
                              const float* bias, float* out, int B, int C, int D, int H, int W, int O, int OD,
                              int OH, int OW, int groups, int dg, int kd, int kh, int kw, int sd, int sh, int sw,
                              int pd, int ph, int pw, int dd, int dh, int dw, int precision, void* stream) {
  using namespace mdc;
  const Geo3 g{B,  C,  D,  H,  W,  O,  OD, OH, OW, groups, dg, kd, kh, kw, sd, sh,
               sw, pd, ph, pw, dd, dh, dw, 0,  0,  0,      0,  0,  0,  0,  precision};
  const size_t smem = smem3_floats(kRows, taps3(g)) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gathermm3d_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Og = O / groups;
  const dim3 grid((out_size3(g) + kTP - 1) / kTP, groups * ((Og + kTO - 1) / kTO), B);
  gathermm3d_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, offset, mask, wt, bias,
                                                                                    out, g);
  return static_cast<int>(cudaGetLastError());
}

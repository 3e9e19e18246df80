// The tensor-core pieces shared by the forwards of deform_fwd.cuh and the
// backwards of deform_bwd.cuh / deform_bwd3d.cuh (both ranks): cp.async
// copies into shared memory,
// mma.sync products over K-major operand tiles in the mode's arithmetic,
// and the channels-last copy of x that both directions read corners from.
#pragma once

#include <cstdint>

#include "deform_tile.cuh"

namespace mdc {

constexpr int kMT = 64;           // a product block's tile: 64 x 64 outputs
constexpr int kMS = kMT + 8;      // K-major tile row: fragment reads hit 32 banks
constexpr int kMK = 32;           // contraction indices a stage
constexpr int kMmaThreads = 256;  // 8 warps, 2 (rows) x 4 (columns), 32 x 16 outputs each

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 8 : 0) : "memory");
}
// 16 bytes, or zeros when !valid.  The row tails are whole: the 64-wide tiles
// start on multiples of 4 and rows % 4 == 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// One value of an activation into shared memory as fp32, zero where !valid
// (src is then not read): by cp.async for fp32, through a register for
// bf16, which cp.async cannot convert (a plain store, so it needs only the
// barrier that the cp.async wait precedes).
__device__ __forceinline__ void stage1(float* dst, const float* src, bool valid) { cp_async4(dst, src, valid); }
__device__ __forceinline__ void stage1(float* dst, const __nv_bfloat16* src, bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] (the warp's 16 x 8 tile i, j at rows wm + 16 i, columns wn +
// 8 j) += A B over one stage, A and B K-major in shared memory: As[k * kMS +
// row], Bs[k * kMS + column].  Prec is the mode: "tensorfloat32" rounds
// both operands to TF32; "bfloat16" rounds both operands to bf16; "float32"
// runs 3xTF32 (each operand split into a TF32 big part and a TF32
// remainder; small * big + big * small + big * big) into a sum of its own
// for the stage, added to acc with an fp32 add: the tensor cores'
// accumulation does not round to nearest, and over thousands of stages its
// error would pass what FP32 FMAs give.  fp32 accumulation in every mode.
// B's tile holds fp32, or bf16 (TB; gcols_mma_kernel's bf16 gout), each
// value widened exactly as it is read.
template <int Prec, typename TB>
__device__ __forceinline__ void mma_stage_into(const float* __restrict__ As, const TB* __restrict__ Bs, int wm,
                                               int wn, float (&acc)[2][2][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  if constexpr (Prec == kBFloat16) {
#pragma unroll
    for (int k0 = 0; k0 < kMK; k0 += 16) {
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = As + (k0 + 2 * tq) * kMS + wm + 16 * i + gq;
        a[i][0] = bf16x2(p[0], p[kMS]);
        a[i][1] = bf16x2(p[8], p[kMS + 8]);
        a[i][2] = bf16x2(p[8 * kMS], p[9 * kMS]);
        a[i][3] = bf16x2(p[8 * kMS + 8], p[9 * kMS + 8]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const TB* p = Bs + (k0 + 2 * tq) * kMS + wn + 8 * j + gq;
        b[j][0] = bf16x2(as_float(p[0]), as_float(p[kMS]));
        b[j][1] = bf16x2(as_float(p[8 * kMS]), as_float(p[9 * kMS]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < kMK; k0 += 8) {
      float af[2][4], bf[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = As + (k0 + tq) * kMS + wm + 16 * i + gq;
        af[i][0] = p[0];
        af[i][1] = p[8];
        af[i][2] = p[4 * kMS];
        af[i][3] = p[4 * kMS + 8];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const TB* p = Bs + (k0 + tq) * kMS + wn + 8 * j + gq;
        bf[j][0] = as_float(p[0]);
        bf[j][1] = as_float(p[4 * kMS]);
      }
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) a[i][v] = to_tf32(af[i][v]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 2; ++v) b[j][v] = to_tf32(bf[j][v]);
      if constexpr (Prec == kFloat32) {
        uint32_t as[2][4], bs[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) as[i][v] = to_tf32(af[i][v] - __uint_as_float(a[i][v]));
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 2; ++v) bs[j][v] = to_tf32(bf[j][v] - __uint_as_float(b[j][v]));
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_tf32(acc[i][j], as[i], b[j]);
            mma_tf32(acc[i][j], a[i], bs[j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_tf32(acc[i][j], a[i], b[j]);
    }
  }
}

template <int Prec, typename TB>
__device__ __forceinline__ void mma_stage(const float* __restrict__ As, const TB* __restrict__ Bs, int wm, int wn,
                                          float (&acc)[2][2][4]) {
  if constexpr (Prec == kFloat32) {
    float part[2][2][4] = {};
    mma_stage_into<Prec>(As, Bs, wm, wn, part);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] += part[i][j][v];
  } else {
    mma_stage_into<Prec>(As, Bs, wm, wn, acc);
  }
}

// The row and column, within the block's 64 x 64 tile, of accumulator v of
// the warp's tile (i, j).
__device__ __forceinline__ int acc_row(int wm, int i, int v) {
  return wm + 16 * i + ((threadIdx.x & 31) >> 2) + 8 * (v >> 1);
}
__device__ __forceinline__ int acc_col(int wn, int j, int v) { return wn + 8 * j + 2 * (threadIdx.x & 3) + (v & 1); }

// xt[b][q][c] = x[b][c][q], a 32 x 32 tile at a time through shared memory.
// x is read in its own type T; xt is fp32 in both (an exact copy), so that
// every reader of xt (the forward's 16-byte column builds, the correlations,
// gw_mma_kernel) is the same code for fp32 and bf16 x.
template <typename T>
__global__ void __launch_bounds__(256) x_cl_kernel(const T* __restrict__ x, float* __restrict__ xt, int C, int HW) {
  __shared__ float t[32][33];
  const int q0 = blockIdx.x * 32, c0 = blockIdx.y * 32, b = blockIdx.z;
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  for (int i = row; i < 32; i += 8)
    if (c0 + i < C && q0 + lane < HW) t[i][lane] = as_float(x[(static_cast<size_t>(b) * C + c0 + i) * HW + q0 + lane]);
  __syncthreads();
  for (int i = row; i < 32; i += 8)
    if (q0 + i < HW && c0 + lane < C) xt[(static_cast<size_t>(b) * HW + q0 + i) * C + c0 + lane] = t[lane][i];
}

}  // namespace mdc

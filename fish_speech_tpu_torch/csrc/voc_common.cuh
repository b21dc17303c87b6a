// What the vocoder kernels (voc_fused.cu, bf16; voc_fused_i8.cu, int8)
// share: bf16 conversions, the snake through the TPU kernel's polynomial,
// 8-value packing, the 3-D bulk tensor copy and the tensor maps it reads
// (encoded through the driver entry point, so nothing links libcuda), the
// wgmma fences and the passes' ring depth.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float b2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 f2b(float x) { return __float2bfloat16(x); }

// x + sin^2(alpha x) / (alpha + eps) with alpha_pi = alpha / pi, through
// the TPU kernel's polynomial. trunc(y), which the plain twin (snake_poly)
// takes by an int conversion, is round-to-nearest by the 1.5 * 2^23 shift
// (exact for |y| < 2^22) stepped toward zero, on the FP32 pipe: the same
// value, bit for bit; (int) conversion above
__device__ __forceinline__ float snake8_one(float x, float alpha_pi,
                                            float inv) {
  const float y = alpha_pi * x;
  float r = (y + 12582912.f) - 12582912.f;
  r = y >= 0.f ? (r > y ? r - 1.f : r) : (r < y ? r + 1.f : r);
  if (fabsf(y) >= 4194304.f) r = (float)(int)y;
  const float t = y - r;
  const float v = t * t;
  float s2 = 0.45029592f;
  s2 = -3.38355759f + v * s2;
  s2 = 12.78106835f + v * s2;
  s2 = -29.93828299f + v * s2;
  s2 = 42.68612315f + v * s2;
  s2 = -32.46507037f + v * s2;
  s2 = 9.86943246f + v * s2;
  s2 = v * s2;
  return x + s2 * inv;
}

// 8 values: bf16 rounding (two an instruction), packing, unpacking
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return u;
}

__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __low2float(h[j]);
    v[2 * j + 1] = __high2float(h[j]);
  }
}

__device__ __forceinline__ void prm8(const float* a, int j, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(a + j);
  const float4 hi = *reinterpret_cast<const float4*>(a + j + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the most stages (up to st) of `stage` bytes with which two CTAs still fit
// on an SM (the passes' rings; ops/voc_fused.py::_ring_smem mirrors it)
constexpr int wg_stages(int stage, int st) {
  return st > 2 && 2 * (st * stage + 1024 + 2048) > 227 * 1024
             ? wg_stages(stage, st - 1)
             : st;
}

PFN_cuTensorMapEncodeTiled_v12000 g_encode = nullptr;

// a 3-D tensor map (inner, rows, outer) of `elem`-byte elements (2: bf16,
// 1: int8 as bytes), box (bk, box_rows, 1), the swizzle of the box's row
// of bk * elem bytes (32, 64 or 128), zeros outside
cudaError_t make_map(CUtensorMap* m, const void* base, int elem, int inner,
                     int rows, int outer, int box_rows, int bk) {
  if (!g_encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    g_encode = (PFN_cuTensorMapEncodeTiled_v12000)fn;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * elem,
                                 (cuuint64_t)rows * inner * elem};
  const int row_bytes = bk * elem;
  const cuuint32_t box[3] = {(cuuint32_t)bk, (cuuint32_t)box_rows, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  const CUresult r = g_encode(
      m, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      3, const_cast<void*>(base), dims, strides, box, es,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

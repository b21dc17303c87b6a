// What the decode-attention kernels that split a row's key range over CTAs
// share (decode_attention_head.cu, decode_attention.cu): the asynchronous
// copies that stage a tile of keys, the element loads, the output store and
// the combine pass over the splits' partial softmax results.
//
// The partials are f32 scratch laid out (B, Hkv, n_split, G, D) for the
// unnormalised accumulators, then (B, Hkv, n_split, G) for the running max
// m and for the sum l; a split with no key writes m = -inf, l = 0, acc = 0.
// The combine kernel has one CTA per (query head, kv head, row) and sums in
// split order (no atomics: the result does not depend on which CTA ran
// first): M = max m_i, out = sum acc_i e^(m_i - M) / max(sum l_i e^(m_i - M),
// 1e-20).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int COMBINE_NT = 128;   // combine threads; thread d owns column d
// the combine keeps 2 * n_split floats in (default-limit) shared memory
constexpr int COMBINE_MAX_SPLIT = 6 * 1024;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// asynchronous copies into shared memory: 16 bytes bypassing L1 (rows),
// 4 bytes (a scale: a tile's scales need not be 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four consecutive cache elements as floats
__device__ __forceinline__ void load4(const int8_t* p, float* f) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  f[0] = __low2float(a); f[1] = __high2float(a);
  f[2] = __low2float(b); f[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void store_out(void* out, size_t i, float o,
                                          int q_f32) {
  if (q_f32)
    reinterpret_cast<float*>(out)[i] = o;
  else
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(o);
}

// One CTA per (query head, kv head, row); thread d owns column d. The
// splits' m and l go to shared memory with one load each, then their
// weights e^(m_i - M); the sums run in split order: deterministic.
__global__ void __launch_bounds__(COMBINE_NT) split_combine_kernel(
    const float* __restrict__ part, void* __restrict__ out, int B, int Hkv,
    int G, int n_split, int q_f32) {
  constexpr int D = COMBINE_NT;
  extern __shared__ float cs[];   // m then weights, and l: n_split each
  __shared__ float mx_s;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const size_t row = (size_t)b * Hkv + h;
  const size_t n_part = (size_t)B * Hkv * n_split * G;
  const size_t e0 = row * n_split * G + g;     // split i: entry e0 + i * G
  float* ws = cs;
  float* ls = cs + n_split;
  for (int i = tid; i < n_split; i += COMBINE_NT) {
    ws[i] = part[n_part * D + e0 + (size_t)i * G];
    ls[i] = part[n_part * (D + 1) + e0 + (size_t)i * G];
  }
  __syncthreads();
  if (tid < 32) {
    float mx = -INFINITY;
    for (int i = tid; i < n_split; i += 32) mx = fmaxf(mx, ws[i]);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (tid == 0) mx_s = mx;
  }
  __syncthreads();
  const float mx = mx_s;
  for (int i = tid; i < n_split; i += COMBINE_NT) {
    // an empty split (m = -inf) weighs 0; so does every split of an empty
    // row, where mx = -inf too and e^(m - mx) would be NaN
    const float m = ws[i];
    ws[i] = m == -INFINITY ? 0.f : expf(m - mx);
  }
  __syncthreads();
  const float* acc = part + e0 * D + tid;
  float num = 0.f, den = 0.f;
#pragma unroll 16
  for (int i = 0; i < n_split; ++i) {
    num += acc[(size_t)i * G * D] * ws[i];
    den += ls[i] * ws[i];
  }
  store_out(out, (row * G + g) * D + tid, num / fmaxf(den, 1e-20f), q_f32);
}

// the combine of a split launch, on the same stream; a no-op for n_split 1
inline cudaError_t launch_combine(const float* part, void* out, int B,
                                  int Hkv, int G, int n_split, int q_f32,
                                  cudaStream_t st) {
  if (n_split == 1) return cudaSuccess;
  split_combine_kernel<<<dim3(G, Hkv, B), COMBINE_NT,
                         2 * sizeof(float) * n_split, st>>>(
      part, out, B, Hkv, G, n_split, q_f32);
  return cudaGetLastError();
}

// The end of split c of (kv head, row) `row`, thread `tid` holding column
// tid of the G accumulators: the output itself when n_split is 1
// (acc / max(l, 1e-20)), else the partials. m_s and l_s: the split's
// running max and sum per query head, in shared memory.
template <int G>
__device__ __forceinline__ void store_split(
    const float* acc, const float* m_s, const float* l_s, void* out,
    float* part, size_t row, int c, int n_split, int B, int Hkv, int tid,
    int q_f32) {
  constexpr int D = COMBINE_NT;
  if (n_split == 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      store_out(out, (row * G + g) * D + tid, acc[g] / fmaxf(l_s[g], 1e-20f),
                q_f32);
    return;
  }
  const size_t n_part = (size_t)B * Hkv * n_split * G;
  const size_t pi = (row * n_split + c) * G;
#pragma unroll
  for (int g = 0; g < G; ++g) part[(pi + g) * D + tid] = acc[g];
  if (tid < G) {
    part[n_part * D + pi + tid] = m_s[tid];
    part[n_part * (D + 1) + pi + tid] = l_s[tid];
  }
}

// The end of a split with no key: an output of 0 when n_split is 1, else
// the partials acc = 0, m = -inf, l = 0.
template <int G>
__device__ __forceinline__ void store_empty(void* out, float* part,
                                            size_t row, int c, int n_split,
                                            int B, int Hkv, int tid,
                                            int q_f32) {
  constexpr int D = COMBINE_NT;
  const size_t n_part = (size_t)B * Hkv * n_split * G;
  const size_t pi = (row * n_split + c) * G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (n_split == 1)
      store_out(out, (row * G + g) * D + tid, 0.f, q_f32);
    else
      part[(pi + g) * D + tid] = 0.f;
  }
  if (n_split > 1 && tid < G) {
    part[n_part * D + pi + tid] = -INFINITY;
    part[n_part * (D + 1) + pi + tid] = 0.f;
  }
}

}  // namespace

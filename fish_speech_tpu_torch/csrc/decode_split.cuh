// What the decode-attention kernels that split a row's key range over CTAs
// share (decode_attention_head.cu, decode_attention.cu): the asynchronous
// copies that stage a tile of keys, the element loads, the output store and
// the combine of the chunks' partial softmax results.
//
// A row's keys fall in chunks of CHUNK = 128 positions (JAX's
// pallas_attn_chunk): chunk c takes [c * CHUNK, (c + 1) * CHUNK) within the
// row's [start, length). Each chunk is one softmax at its own maximum m
// (the value weights rounded there), and the chunks' (m, sum l,
// unnormalised accumulator acc) are folded in ascending c by fold_chunk:
//   M' = max(M, m), num = num e^(M - M') + acc e^(m - M'),
//   den = den e^(M - M') + l e^(m - M'), M = M',
// starting from M = -inf, num = den = 0 and skipping a chunk with no key
// (m = -inf); out = num / max(den, 1e-20). With one chunk that is
// acc / max(l, 1e-20). The chunks depend on the key positions alone, so a
// row's f32 sums are the same at every batch size and on every card.
//
// Which CTA does which chunk may depend on the batch and does not change
// the arithmetic (-fmad=false: no contraction either):
// - whole rows (the rows alone fill the card): one CTA a (kv head, row)
//   walks its chunks in order and folds each as it ends;
// - split (small batches): one CTA a chunk (and a group of the query
//   heads: heads are independent), writing its (acc, m, l) to f32 scratch
//   laid out (B, Hkv, n_split, G, D) for acc, then (B, Hkv, n_split, G) for
//   m and for l (a chunk with no key writes m = -inf, l = 0, acc = 0);
//   split_combine_kernel, one CTA per (query head, kv head, row), then folds
//   them in chunk order (no atomics), its exponentials taken for all chunks
//   at once, since fold_chunk's running max is a prefix max.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int COMBINE_NT = 128;   // combine threads; thread d owns column d
constexpr int CHUNK = 128;        // keys a chunk (a multiple of every tile)

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
// wait until at most `pending` (0-3) copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 3)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (pending == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A CTA's walk over its tiles: chunk c's keys [lo(c), hi(c)) within the
// row's [rlo, rhi), in tiles of TP from lo(c); chunks with no key are
// skipped. A tile is (chunk, first key); chunk == c_end past the last.
struct TileWalk {
  int rlo, rhi, c_end;
  __device__ int lo(int c) const { return max(rlo, c * CHUNK); }
  __device__ int hi(int c) const { return min(rhi, (c + 1) * CHUNK); }
  // the first tile of chunk c or of the next chunk with a key
  __device__ int2 first(int c) const {
    for (; c < c_end; ++c)
      if (lo(c) < hi(c)) return make_int2(c, lo(c));
    return make_int2(c_end, 0);
  }
  __device__ int2 next(int2 u, int tp) const {
    return u.y + tp < hi(u.x) ? make_int2(u.x, u.y + tp) : first(u.x + 1);
  }
};

// the opt-in to `bytes` of dynamic shared memory (static and dynamic past
// 48 KB together need it), once per kernel
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
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

// fold chunk (m, l, acc) into the running (M, num, den) of one query head
// and column (see the top of this file)
__device__ __forceinline__ void fold_chunk(float& M, float& num, float& den,
                                           float m, float l, float acc) {
  if (m == -INFINITY) return;
  const float mn = fmaxf(M, m);
  const float a = expf(M - mn);      // 0 while nothing is folded (M = -inf)
  const float w = expf(m - mn);
  num = num * a + acc * w;
  den = den * a + l * w;
  M = mn;
}

// One CTA per (query head, kv head, row). fold_chunk's running max before
// chunk i is the max of m_0 .. m_(i-1), so its two factors a_i =
// e^(M - M') and w_i = e^(m_i - M') are computed for every chunk at once
// (shared memory); thread d then folds column d in chunk order with the
// same roundings as fold_chunk: num = num a_i + acc_i w_i, den likewise,
// a chunk with m_i = -inf taken as a_i = 1, w_i = 0.
__global__ void __launch_bounds__(COMBINE_NT) split_combine_kernel(
    const float* __restrict__ part, void* __restrict__ out, int B, int Hkv,
    int G, int n_split, int q_f32) {
  constexpr int D = COMBINE_NT;
  extern __shared__ float cs[];      // m, l, a, w: n_split each
  float* ms = cs;
  float* ls = cs + n_split;
  float* as = cs + 2 * n_split;
  float* ws = cs + 3 * n_split;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const size_t row = (size_t)b * Hkv + h;
  const size_t n_part = (size_t)B * Hkv * n_split * G;
  const size_t e0 = row * n_split * G + g;     // chunk i: entry e0 + i * G
  for (int i = tid; i < n_split; i += COMBINE_NT) {
    ms[i] = part[n_part * D + e0 + (size_t)i * G];
    ls[i] = part[n_part * (D + 1) + e0 + (size_t)i * G];
  }
  __syncthreads();
  for (int i = tid; i < n_split; i += COMBINE_NT) {
    float M = -INFINITY;
    for (int j = 0; j < i; ++j) M = fmaxf(M, ms[j]);
    const float mn = fmaxf(M, ms[i]);
    // a skipped chunk (acc = 0, l = 0) becomes num * 1 + 0 * 0: the same
    // bits as no step, with no branch to hold the loads back
    const bool skip = ms[i] == -INFINITY;
    as[i] = skip ? 1.f : expf(M - mn);   // 0 while nothing is folded
    ws[i] = skip ? 0.f : expf(ms[i] - mn);
  }
  __syncthreads();
  const float* acc = part + e0 * D + tid;
  float num = 0.f, den = 0.f;
#pragma unroll 16
  for (int i = 0; i < n_split; ++i) {
    const float x = acc[(size_t)i * G * D];
    num = num * as[i] + x * ws[i];
    den = den * as[i] + ls[i] * ws[i];
  }
  store_out(out, (row * G + g) * D + tid, num / fmaxf(den, 1e-20f), q_f32);
}

// the combine of a split launch, on the same stream (not for whole rows);
// its four floats a chunk stay within the default 48 KB
constexpr int COMBINE_MAX_SPLIT = 48 * 1024 / (4 * sizeof(float));
inline cudaError_t launch_combine(const float* part, void* out, int B,
                                  int Hkv, int G, int n_split, int q_f32,
                                  cudaStream_t st) {
  if (n_split > COMBINE_MAX_SPLIT) return cudaErrorInvalidValue;
  split_combine_kernel<<<dim3(G, Hkv, B), COMBINE_NT,
                         4 * sizeof(float) * n_split, st>>>(
      part, out, B, Hkv, G, n_split, q_f32);
  return cudaGetLastError();
}

// The end of chunk c of (kv head, row) `row` for query heads g0 .. g0 + GS
// - 1 of G, thread `tid` < D holding column tid of their accumulators acc
// and every head's chunk max m and sum l. Whole rows fold the chunk into
// (M, num, den) (per head, in registers; an empty chunk is skipped by the
// caller); a split writes the partials.
template <int GS>
__device__ __forceinline__ void end_chunk(
    const float* acc, const float* m, const float* l, bool whole, float* M,
    float* num, float* den, float* part, size_t row, int c, int n_split,
    int B, int Hkv, int G, int g0, int tid) {
  constexpr int D = COMBINE_NT;
  if (whole) {
#pragma unroll
    for (int g = 0; g < GS; ++g)
      fold_chunk(M[g], num[g], den[g], m[g], l[g], acc[g]);
    return;
  }
  const size_t n_part = (size_t)B * Hkv * n_split * G;
  const size_t pi = (row * n_split + c) * G + g0;
#pragma unroll
  for (int g = 0; g < GS; ++g) {
    part[(pi + g) * D + tid] = acc[g];
    if (tid == g) {
      part[n_part * D + pi + g] = m[g];
      part[n_part * (D + 1) + pi + g] = l[g];
    }
  }
}

// The partials of a split's chunk with no key: acc = 0, m = -inf, l = 0.
template <int GS>
__device__ __forceinline__ void store_empty(float* part, size_t row, int c,
                                            int n_split, int B, int Hkv,
                                            int G, int g0, int tid) {
  constexpr int D = COMBINE_NT;
  const size_t n_part = (size_t)B * Hkv * n_split * G;
  const size_t pi = (row * n_split + c) * G + g0;
#pragma unroll
  for (int g = 0; g < GS; ++g) part[(pi + g) * D + tid] = 0.f;
  if (tid < GS) {
    part[n_part * D + pi + tid] = -INFINITY;
    part[n_part * (D + 1) + pi + tid] = 0.f;
  }
}

// The output of whole rows: num / max(den, 1e-20) per head (0 for a row
// with no key)
template <int GS>
__device__ __forceinline__ void store_whole(const float* num,
                                            const float* den, void* out,
                                            size_t row, int G, int g0,
                                            int tid, int q_f32) {
  constexpr int D = COMBINE_NT;
#pragma unroll
  for (int g = 0; g < GS; ++g)
    store_out(out, (row * G + g0 + g) * D + tid, num[g] / fmaxf(den[g], 1e-20f),
              q_f32);
}

}  // namespace

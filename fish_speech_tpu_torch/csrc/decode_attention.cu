// Single-query GQA decode attention over one layer of the position-major
// KV cache, int8 or bf16, read in place.
//
// Replaces: fish_speech_tpu/ops/attention.py::pallas_decode_attention_stream
// (kernel body _decode_attn_stream_kernel) with pos_major=True: on an int8
// cache (with or without int8_scores) as decode_attention_stream, on a bf16
// cache as decode_attention_stream_bf16. The cache element type is a
// template parameter of one kernel.
//
// What bounds it on the H100: bytes. Each filled key position is read once
// per (row, kv head): 128 B of int8 k, 128 B of int8 v and two f32 scales,
// against 2 x 4 x 128 multiply-adds. At the serving shape (B=256, S=384,
// 8 kv heads) one launch moves ~200 MB, ~60 us at 3.35 TB/s; the arithmetic
// is ~100x below the int8 tensor-core roof.
//
// Design (simple first): one CTA of 128 threads per (kv head, row). The CTA
// walks only the filled range [start, length) in tiles of 128 positions:
// the tile's k and v rows are staged in shared memory with 16-byte
// coalesced loads, each thread scores one position against the G query
// heads with __dp4a on the int8 query (quantized per query head once per
// CTA, as the TPU kernel does), and an online softmax keeps (max, sum) per
// head; thread d then accumulates output column d over the tile. A grid
// over (Hkv, B) replaces the TPU kernel's single-grid-step cursor. The
// probability times the value scale is rounded to bf16 before the value
// product, as the TPU kernel does. Not yet done: splitting one row's key
// range over several CTAs, which a small batch needs to fill the card.
//
// On a bf16 cache (decode_attention_stream_bf16) the same CTA shape stages
// 256-byte k and v rows; the score is the bf16 query times the bf16 key with
// f32 sums, times 1/sqrt(D); p is rounded to bf16 before the value product
// (f32 sums), and there are no scales. Bound by bytes as well: at B=1,
// S=2048 a launch reads 2 x 2048 x 8 x 128 x 2 B = 8.4 MB, 2.5 us at
// 3.35 TB/s. Its staged tiles (66 KB) take dynamic shared memory.
//
// decode_attention_stream_fold (FOLD = true) replaces
// fish_speech_tpu/ops/attention.py::pallas_decode_attention_stream_fold:
// the same attention, after the decode step's cache write. The CTA of (kv
// head h, row b) quantizes the new bf16 k and v rows of (b, h) (scale
// max|x| / 127 clamped at 1e-8, round half to even), writes the int8 rows at
// `write_pos` of `layer` and their scales into the flat scale caches, and
// attends over [start, length) including that row. Each (kv head, row) CTA
// owns its row's write, so no CTA waits on another; the new row is patched
// into the staged tile from shared memory (and its scales into the score
// and probability scaling), so the tile loop never depends on reading its
// own write back from device memory. The
// tile loop is decode_attention_stream's, so the output is bit-identical to
// writing the row first and launching that kernel. Unlike the TPU kernel, which returns the scales
// for the caller to write (their offset is not 128-lane aligned), this one
// writes them itself. The extra bytes are the 2 x Hkv x D bf16 inputs and
// the int8 rows and scales written: ~0.15% of a B=1, S=2048 launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int NT = 128;        // threads == positions per tile
constexpr int D = 128;         // head dim

// staged bytes per k row (padded by one word: conflict-free 4-byte reads of
// a row per thread) and per v row
template <typename T>
__host__ __device__ constexpr int kp_bytes() { return D * (int)sizeof(T) + 4; }
template <typename T>
__host__ __device__ constexpr int v_bytes() { return D * (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr size_t tile_smem() {
  return (size_t)NT * (kp_bytes<T>() + v_bytes<T>());
}

// T: int8_t (scales ks/vs) or bf16 (no scales). k, v, ks, vs are not
// __restrict__: with FOLD the kernel writes them too
template <typename T, int G, bool FOLD>
__global__ void __launch_bounds__(NT) decode_attn_kernel(
    const bf16* __restrict__ q,            // (B, Hkv, G, D)
    const T* k,                            // (L, S, B, Hkv, D)
    const T* v,
    const float* ks,                       // (L, B, S*Hkv), int8 only
    const float* vs,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    bf16* __restrict__ out,                // (B, Hkv, G, D)
    const bf16* __restrict__ nk,           // FOLD: (B, Hkv, D) new rows
    const bf16* __restrict__ nv,
    int S, int B, int Hkv, int layer, int wpos, float scale,
    int int8_scores) {
  constexpr bool I8 = std::is_same<T, int8_t>::value;
  constexpr int KPB = kp_bytes<T>(), VB = v_bytes<T>();
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int NW = NT / 32;

  // the staged k and v tiles: static for int8 (33 KB), dynamic for bf16
  // (66 KB, above the static limit)
  __shared__ __align__(16) unsigned char static_tiles[I8 ? tile_smem<T>()
                                                         : 16];
  extern __shared__ __align__(16) unsigned char dynamic_tiles[];
  unsigned char* sk = I8 ? static_tiles : dynamic_tiles;  // NT rows of KPB
  unsigned char* sv = sk + NT * KPB;                      // NT rows of VB
  __shared__ float sp[G][NT];
  __shared__ float qf[G][D];
  __shared__ __align__(16) int8_t qi[G][D];
  __shared__ float qmul[G];
  __shared__ float red[G][NW];
  __shared__ float m_s[G], l_s[G], corr_s[G];
  __shared__ __align__(16) int8_t nk8[D];   // FOLD: the new int8 rows
  __shared__ __align__(16) int8_t nv8[D];
  __shared__ float nred[2][NW], nsc[2];

  const size_t row = (size_t)b * Hkv + h;
  for (int i = tid; i < G * D; i += NT)
    qf[i / D][i % D] = __bfloat162float(q[row * G * D + i]);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if (I8) {
    // query quantization: one warp per query head
    for (int g = warp; g < G; g += NW) {
      float amax = 0.f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(qf[g][d]));
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float qsc = fmaxf(amax / 127.f, 1e-8f);
      for (int d = lane; d < D; d += 32)
        qi[g][d] = (int8_t)rintf(qf[g][d] / qsc);
      if (lane == 0) qmul[g] = int8_scores ? qsc * scale : scale;
    }
    __syncthreads();
  }

  const int length = lengths[b], start = starts[b];
  const size_t pos_stride = (size_t)B * Hkv * D;        // elements
  const T* kbase = k + (size_t)layer * S * pos_stride + row * D;
  const T* vbase = v + (size_t)layer * S * pos_stride + row * D;
  const float* ksrow = I8 ? ks + ((size_t)layer * B + b) * ((size_t)S * Hkv) + h
                          : nullptr;
  const float* vsrow = I8 ? vs + ((size_t)layer * B + b) * ((size_t)S * Hkv) + h
                          : nullptr;

  if constexpr (FOLD) {
    // quantize the new rows (thread tid owns column tid) and write them
    const float kx = __bfloat162float(nk[row * D + tid]);
    const float vx = __bfloat162float(nv[row * D + tid]);
    float ka = fabsf(kx), va = fabsf(vx);
    for (int o = 16; o > 0; o >>= 1) {
      ka = fmaxf(ka, __shfl_xor_sync(0xffffffffu, ka, o));
      va = fmaxf(va, __shfl_xor_sync(0xffffffffu, va, o));
    }
    if (lane == 0) {
      nred[0][warp] = ka;
      nred[1][warp] = va;
    }
    __syncthreads();
    if (tid < 2) {
      float m = nred[tid][0];
      for (int w = 1; w < NW; ++w) m = fmaxf(m, nred[tid][w]);
      nsc[tid] = fmaxf(m / 127.f, 1e-8f);
    }
    __syncthreads();
    const int8_t k8 = (int8_t)rintf(kx / nsc[0]);
    const int8_t v8 = (int8_t)rintf(vx / nsc[1]);
    nk8[tid] = k8;
    nv8[tid] = v8;
    const_cast<T*>(kbase)[(size_t)wpos * pos_stride + tid] = k8;
    const_cast<T*>(vbase)[(size_t)wpos * pos_stride + tid] = v8;
    if (tid == 0) {
      const_cast<float*>(ksrow)[(size_t)wpos * Hkv] = nsc[0];
      const_cast<float*>(vsrow)[(size_t)wpos * Hkv] = nsc[1];
    }
    __syncthreads();
  }

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  constexpr int PARTS = VB / 16;                      // 16-byte loads a row
  for (int t0 = start; t0 < length; t0 += NT) {
    const int n = min(NT, length - t0);
    for (int c = tid; c < n * PARTS; c += NT) {
      const int p = c / PARTS, part = c % PARTS;
      const int4 kk = *reinterpret_cast<const int4*>(
          reinterpret_cast<const unsigned char*>(kbase + (size_t)(t0 + p) *
                                                              pos_stride) +
          part * 16);
      int* dst = reinterpret_cast<int*>(sk + p * KPB + part * 16);
      dst[0] = kk.x; dst[1] = kk.y; dst[2] = kk.z; dst[3] = kk.w;
      *reinterpret_cast<int4*>(sv + p * VB + part * 16) =
          *reinterpret_cast<const int4*>(
              reinterpret_cast<const unsigned char*>(
                  vbase + (size_t)(t0 + p) * pos_stride) + part * 16);
    }
    __syncthreads();
    if (FOLD && wpos >= t0 && wpos < t0 + n) {
      // the staged copy of the new row may predate this CTA's write of it
      reinterpret_cast<int8_t*>(sk)[(wpos - t0) * KPB + tid] = nk8[tid];
      reinterpret_cast<int8_t*>(sv)[(wpos - t0) * VB + tid] = nv8[tid];
      __syncthreads();
    }

    float s[G];
    if (tid < n) {
      if constexpr (I8) {
        const float ksc = (FOLD && t0 + tid == wpos)
                              ? nsc[0] : ksrow[(size_t)(t0 + tid) * Hkv];
        const int8_t* krow = reinterpret_cast<const int8_t*>(sk + tid * KPB);
        if (int8_scores) {
          int dot[G];
#pragma unroll
          for (int g = 0; g < G; ++g) dot[g] = 0;
          const int* kr = reinterpret_cast<const int*>(krow);
#pragma unroll 8
          for (int w = 0; w < D / 4; ++w) {
            const int kw = kr[w];
#pragma unroll
            for (int g = 0; g < G; ++g)
              dot[g] = __dp4a(kw, reinterpret_cast<const int*>(qi[g])[w],
                              dot[g]);
          }
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] = (float)dot[g] * qmul[g] * ksc;
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] = 0.f;
          for (int d = 0; d < D; ++d) {
            const float kd = (float)krow[d];
#pragma unroll
            for (int g = 0; g < G; ++g) s[g] += qf[g][d] * kd;
          }
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] = s[g] * qmul[g] * ksc;
        }
      } else {
        // bf16 query (qf holds it exactly) times bf16 key, f32 sums
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = 0.f;
        const __nv_bfloat162* kr =
            reinterpret_cast<const __nv_bfloat162*>(sk + tid * KPB);
#pragma unroll 4
        for (int w = 0; w < D / 2; ++w) {
          const float2 kd = __bfloat1622float2(kr[w]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            s[g] += qf[g][2 * w] * kd.x;
            s[g] += qf[g][2 * w + 1] * kd.y;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = s[g] * scale;
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = -INFINITY;
    }
    // tile max per head
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m = s[g];
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) red[g][warp] = m;
    }
    __syncthreads();
    if (tid < G) {
      float m = red[tid][0];
      for (int w = 1; w < NW; ++w) m = fmaxf(m, red[tid][w]);
      const float m_new = fmaxf(m_s[tid], m);
      corr_s[tid] = expf(m_s[tid] - m_new);
      m_s[tid] = m_new;
    }
    __syncthreads();
    // the value weight: p * v_scale (int8) or p (bf16), rounded to bf16
    float vsc = 1.f;
    if constexpr (I8)
      vsc = tid >= n ? 0.f
            : (FOLD && t0 + tid == wpos) ? nsc[1]
                                         : vsrow[(size_t)(t0 + tid) * Hkv];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = tid < n ? expf(s[g] - m_s[g]) : 0.f;
      sp[g][tid] = __bfloat162float(__float2bfloat16(I8 ? p * vsc : p));
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) red[g][warp] = sum;
    }
    __syncthreads();
    if (tid < G) {
      float sum = 0.f;
      for (int w = 0; w < NW; ++w) sum += red[tid][w];
      l_s[tid] = l_s[tid] * corr_s[tid] + sum;
    }
    // value product: thread tid owns output column tid (D == NT)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= corr_s[g];
    const T* svt = reinterpret_cast<const T*>(sv);
    for (int p = 0; p < n; ++p) {
      float vv;
      if constexpr (I8) vv = (float)svt[p * D + tid];
      else vv = __bfloat162float(svt[p * D + tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += sp[g][p] * vv;
    }
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    out[(row * G + g) * D + tid] =
        __float2bfloat16(acc[g] / fmaxf(l_s[g], 1e-20f));
}

template <typename T, int G, bool FOLD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* lengths,
                   const void* starts, void* out, const void* nk,
                   const void* nv, int S, int B, int Hkv, int layer, int wpos,
                   float scale, int int8_scores, cudaStream_t stream) {
  auto kern = decode_attn_kernel<T, G, FOLD>;
  constexpr size_t smem = sizeof(T) == 1 ? 0 : tile_smem<T>();
  if (smem > 0) {
    // above the default limit: raised once per process
    static const cudaError_t raised = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (raised != cudaSuccess) return raised;
  }
  dim3 grid(Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      (const bf16*)q, (const T*)k, (const T*)v, (const float*)ks,
      (const float*)vs, (const int*)lengths, (const int*)starts, (bf16*)out,
      (const bf16*)nk, (const bf16*)nv, S, B, Hkv, layer, wpos, scale,
      int8_scores);
  return cudaGetLastError();
}

template <typename T, bool FOLD>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* lengths, const void* starts,
             void* out, const void* nk, const void* nv, int S, int B,
             int Hkv, int G, int Dh, int layer, int wpos, float scale,
             int int8_scores, void* stream) {
  if (Dh != D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (G) {
    case 1: return (int)launch<T, 1, FOLD>(q, k, v, ks, vs, lengths, starts,
                                           out, nk, nv, S, B, Hkv, layer,
                                           wpos, scale, int8_scores, st);
    case 2: return (int)launch<T, 2, FOLD>(q, k, v, ks, vs, lengths, starts,
                                           out, nk, nv, S, B, Hkv, layer,
                                           wpos, scale, int8_scores, st);
    case 4: return (int)launch<T, 4, FOLD>(q, k, v, ks, vs, lengths, starts,
                                           out, nk, nv, S, B, Hkv, layer,
                                           wpos, scale, int8_scores, st);
    case 8: return (int)launch<T, 8, FOLD>(q, k, v, ks, vs, lengths, starts,
                                           out, nk, nv, S, B, Hkv, layer,
                                           wpos, scale, int8_scores, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_stream(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* lengths, const void* starts, void* out,
    int L, int S, int B, int Hkv, int G, int Dh, int layer, float scale,
    int int8_scores, void* stream) {
  (void)L;
  return dispatch<int8_t, false>(q, k, v, ks, vs, lengths, starts, out,
                                 nullptr, nullptr, S, B, Hkv, G, Dh, layer,
                                 -1, scale, int8_scores, stream);
}

// k, v, ks, vs are updated in place at write_pos of layer
extern "C" int decode_attention_stream_fold(
    const void* q, void* k, void* v, void* ks, void* vs, const void* lengths,
    const void* starts, void* out, const void* new_k, const void* new_v,
    int L, int S, int B, int Hkv, int G, int Dh, int layer, int write_pos,
    float scale, int int8_scores, void* stream) {
  (void)L;
  if (write_pos < 0 || write_pos >= S) return (int)cudaErrorInvalidValue;
  return dispatch<int8_t, true>(q, k, v, ks, vs, lengths, starts, out, new_k,
                                new_v, S, B, Hkv, G, Dh, layer, write_pos,
                                scale, int8_scores, stream);
}

// the bf16 cache: (L, S, B, Hkv, D) k and v, no scales
extern "C" int decode_attention_stream_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* starts, void* out, int L, int S, int B, int Hkv, int G,
    int Dh, int layer, float scale, void* stream) {
  (void)L;
  return dispatch<bf16, false>(q, k, v, nullptr, nullptr, lengths, starts,
                               out, nullptr, nullptr, S, B, Hkv, G, Dh, layer,
                               -1, scale, 0, stream);
}

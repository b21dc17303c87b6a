// Single-query GQA decode attention over the head-major KV cache
// (L, B, Hkv, S, D): int8 values with (L, B, Hkv, S) f32 scales, bf16, or
// (for the per-layer entries) f32. One layer's cache (B, Hkv, S, D) is the
// case L = 1, layer = 0.
//
// Replaces, one extern "C" entry each (fish_speech_tpu/ops/attention.py):
//   decode_attention_stream_head   pallas_decode_attention_stream with
//                                  pos_major=False (kernel body
//                                  _decode_attn_stream_kernel)
//   decode_attention_blocks        pallas_decode_attention_blocks
//                                  (_decode_attn_blocks_kernel)
//   decode_attention_stacked_rows  pallas_decode_attention_stacked_rows
//                                  (_decode_attn_stacked_rows_kernel)
//   decode_attention               pallas_decode_attention
//                                  (_decode_attn_kernel)
//   decode_attention_stacked       pallas_decode_attention_stacked
//                                  (_decode_attn_stacked_kernel)
//   decode_attention_chunked       pallas_decode_attention_chunked
//                                  (_decode_attn_chunked_kernel)
// The entries share one kernel, templated on the cache type and on the
// numeric variant, because the TPU kernels round at different places:
//   BLOCKS (stream, blocks): int8 cache with int8 scores: q quantized per
//     query head (max|q|/127 clamped at 1e-8, round half to even), score =
//     int32(qi . k8) * (qs * scale) * ks; int8 cache without: score =
//     f32(bf16(q) . k8) * scale * ks; bf16 cache: f32(bf16(q) . k) * scale.
//     The value weight is bf16(p * vs) against int8 v (bf16(p) against a
//     bf16 v); the softmax sum takes p before the value scale.
//   ROWS (stacked_rows): dequantize first, k^ = bf16(k8 * ks) and
//     v^ = bf16(v8 * vs); score = f32(bf16(q) . k^) * scale; value weight
//     bf16(p) against v^. A bf16 cache goes as in BLOCKS.
//   F32 (dense, stacked, chunked): q, k, v in f32; an int8 cache folds its
//     scales unrounded: score = (q . k8) * scale * ks, weight p * vs.
// Every entry divides by max(l, 1e-20); the dense TPU kernel divides by l,
// which is the same number wherever a row has a key (l >= 1 there).
// `rows` and `chunk` of the TPU entries group the work and place the online
// softmax's rescaling; they never change which keys count. This kernel
// takes neither: it walks each row in tiles of its own size (TP positions).
// An empty row (start >= length) gives 0 here; the TPU entries disagree
// there (the dense one averages v over all S).
//
// What bounds it on the H100: bytes. Each filled key position is read once
// per (row, kv head): 2 x 128 B of int8 k and v and two f32 scales, or
// 2 x 256 B of bf16, against 2 x G x 128 multiply-adds of each. At the
// engine's batch 1 and S = 2048 an int8 layer is ~4.3 MB, ~1.3 us at
// 3.35 TB/s. A CTA walks its keys in tiles, and each tile costs a copy's
// latency plus three barriers and the softmax step's shuffles whatever its
// bytes: with one CTA per (kv head, row), batch 1 gave 8 CTAs on 132 SMs,
// each walking 64 tiles in series, and that walk set the time.
//
// Design. The grid is (n_split, Hkv, B): split c of a row takes the keys
// [c * chunk, (c + 1) * chunk) within [start, length), so at batch 1 each
// of ~256 CTAs walks two tiles (the wrapper picks n_split and chunk from
// the shapes and the SM count, ops/attention.py::head_split). A split
// keeps the online softmax's running max m, sum l and unnormalised
// accumulator for its keys and writes them, in f32, to scratch laid out
// (B, Hkv, n_split, G, D) for the accumulators, then (B, Hkv, n_split, G)
// for m and for l; a split with no key writes m = -inf, l = 0, acc = 0. A
// second kernel of one CTA per (query head, kv head, row), launched from
// the same entry on the same stream (split_combine_kernel, decode_split.cuh,
// shared with the position-major kernel), combines them in split order (no
// atomics: the result does not depend on which CTA ran first):
// M = max m_i, out = sum acc_i e^(m_i - M) / max(sum l_i e^(m_i - M), 1e-20).
// With n_split = 1 (large batches fill the card) the first kernel writes
// the output itself and the second is not launched. The value weights are
// rounded where the TPU kernels round them, at the split's running maximum;
// the combine rescales them in f32, as the online softmax rescales its
// accumulator.
//
// Inside a CTA of 128 threads the tile's k and v rows (one contiguous block
// of the (row, kv head) stripe) and its scales are copied into shared
// memory with cp.async, double-buffered: the next tile's copy is issued as
// soon as the current one has landed and overlaps the current tile's work,
// and three barriers a tile remain. Each warp scores positions with its
// lanes over D (four elements a lane: __dp4a on the int8 query for int8
// scores), reduced by shuffles; one warp per query head then takes the
// tile's max and sum with one lane per position and writes the value
// weights; thread d accumulates output column d. Tiles are 32 positions
// (16 for an f32 cache, so that two buffers fit static shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decode_split.cuh"

namespace {

constexpr int NT = 128;        // threads; thread d owns output column d
constexpr int D = 128;         // head dim
constexpr int NW = NT / 32;
constexpr int CHUNK_ALIGN = 32;  // a split's keys: a multiple of every TP

enum Variant { BLOCKS = 0, ROWS = 1, F32 = 2 };
enum CacheKind { KIND_INT8 = 0, KIND_BF16 = 1, KIND_F32 = 2 };

// key positions per tile, at most one per lane; two tiles of k and v stay
// within the 48 KB of static shared memory
template <typename CT>
struct Tile {
  static constexpr int P = sizeof(CT) == 4 ? 16 : 32;
};

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename CT, int V, int G>
__global__ void __launch_bounds__(NT) head_attn_kernel(
    const void* __restrict__ q,            // (B, Hkv, G, D) bf16 or f32
    const CT* __restrict__ k,              // (L, B, Hkv, S, D)
    const CT* __restrict__ v,
    const float* __restrict__ ks,          // (L, B, Hkv, S), int8 only
    const float* __restrict__ vs,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    void* __restrict__ out,                // (B, Hkv, G, D) as q
    float* __restrict__ part,              // partials, n_split > 1 only
    int S, int B, int Hkv, int layer, int chunk, float scale,
    int int8_scores, int q_f32) {
  constexpr bool I8 = std::is_same<CT, int8_t>::value;
  constexpr int TP = Tile<CT>::P;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool use_i8 = I8 && V == BLOCKS && int8_scores;
  const size_t row = (size_t)b * Hkv + h;

  // the query (thread tid loads column tid of each head), read alongside
  // the row's range
  float qg[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t i = (row * G + g) * D + tid;
    qg[g] = q_f32 ? reinterpret_cast<const float*>(q)[i]
                  : __bfloat162float(
                        reinterpret_cast<const __nv_bfloat16*>(q)[i]);
  }
  // this split's keys
  const int lo = max(starts[b], c * chunk);
  const int hi = min(min(lengths[b], S), (c + 1) * chunk);
  if (lo >= hi) {
    store_empty<G>(out, part, row, c, n_split, B, Hkv, tid, q_f32);
    return;
  }

  __shared__ __align__(16) CT sk[2][TP * D];
  __shared__ __align__(16) CT sv[2][TP * D];
  __shared__ float ksc[2][TP], vsc[2][TP];
  __shared__ float qf[G][D];
  __shared__ float ss[G][TP];          // scores, then value weights
  __shared__ float qsc[G];
  __shared__ float m_s[G], l_s[G], corr_s[G];

  const size_t stripe = (((size_t)layer * B + b) * Hkv + h) * (size_t)S;
  const CT* kb = k + stripe * D;
  const CT* vb = v + stripe * D;
  constexpr int CH = D * (int)sizeof(CT) / 16;     // 16-byte chunks a row

  // issue the copies of the tile at t0 into buffer `buf`, as one group
  auto stage = [&](int t0, int buf) {
    const int n = min(TP, hi - t0);
    const int4* ksrc = reinterpret_cast<const int4*>(kb + (size_t)t0 * D);
    const int4* vsrc = reinterpret_cast<const int4*>(vb + (size_t)t0 * D);
    for (int i = tid; i < n * CH; i += NT) {
      cp_async16(reinterpret_cast<int4*>(sk[buf]) + i, ksrc + i);
      cp_async16(reinterpret_cast<int4*>(sv[buf]) + i, vsrc + i);
    }
    if (I8 && tid < n) {
      cp_async4(&ksc[buf][tid], ks + stripe + t0 + tid);
      cp_async4(&vsc[buf][tid], vs + stripe + t0 + tid);
    }
    cp_async_commit();
  };
  stage(lo, 0);          // the first tile's copy overlaps the query's setup

#pragma unroll
  for (int g = 0; g < G; ++g) qf[g][tid] = qg[g];
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if (use_i8) {
    // query scale per head: one warp per query head
    for (int g = warp; g < G; g += NW) {
      float amax = 0.f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(qf[g][d]));
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) qsc[g] = fmaxf(amax / 127.f, 1e-8f);
    }
    __syncthreads();
  }
  // this lane's four query elements (d = 4 lane .. 4 lane + 3) per head
  float qv[G][4];
  int qw[G];
  float qmul[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    qw[g] = 0;
    qmul[g] = use_i8 ? qsc[g] * scale : scale;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = qf[g][4 * lane + j];
      qv[g][j] = V == F32 ? x : bf16r(x);
      if (use_i8) {
        const int qi = (int)rintf(x / qsc[g]);
        qw[g] |= (qi & 0xff) << (8 * j);
      }
    }
  }

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  for (int t0 = lo, it = 0; t0 < hi; t0 += TP, ++it) {
    const int n = min(TP, hi - t0), buf = it & 1;
    const CT* tk = sk[buf];
    const CT* tv = sv[buf];
    const float* tks = ksc[buf];
    const float* tvs = vsc[buf];
    cp_async_wait_all();
    // the tile is visible to every thread, and every thread is done with
    // the previous tile: its buffer, ss and corr_s may be written again
    __syncthreads();
    if (t0 + TP < hi) stage(t0 + TP, buf ^ 1);

    // scores: each warp takes positions, its lanes split D
    for (int p = warp; p < n; p += NW) {
      const CT* kr = tk + p * D + 4 * lane;
      float s[G];
      if (use_i8) {
        const int kw = *reinterpret_cast<const int*>(kr);
        int dot[G];
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] = __dp4a(kw, qw[g], 0);
#pragma unroll
        for (int g = 0; g < G; ++g)
          for (int o = 16; o > 0; o >>= 1)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = (float)dot[g] * qmul[g] * tks[p];
      } else {
        float kf[4];
        load4(kr, kf);
        if (I8 && V == ROWS) {
#pragma unroll
          for (int j = 0; j < 4; ++j) kf[j] = bf16r(kf[j] * tks[p]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[g] = qv[g][0] * kf[0] + qv[g][1] * kf[1] + qv[g][2] * kf[2]
                 + qv[g][3] * kf[3];
#pragma unroll
        for (int g = 0; g < G; ++g)
          for (int o = 16; o > 0; o >>= 1)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s[g] = s[g] * scale;
          if (I8 && V != ROWS) s[g] = s[g] * tks[p];
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) ss[g][p] = s[g];
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, one lane per position
    for (int g = warp; g < G; g += NW) {
      const bool ok = lane < n;
      const float s = ok ? ss[g][lane] : -INFINITY;
      const float m_old = m_s[g];
      float m = s;
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float m_new = fmaxf(m_old, m);
      const float p = ok ? expf(s - m_new) : 0.f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      float w = 0.f;
      if (ok) {
        if (V == F32)
          w = I8 ? p * tvs[lane] : p;
        else if (V == BLOCKS && I8)
          w = bf16r(p * tvs[lane]);
        else
          w = bf16r(p);
        ss[g][lane] = w;
      }
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // value product: thread tid owns output column tid (D == NT)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= corr_s[g];
    for (int p = 0; p < n; ++p) {
      float vv = to_f(tv[p * D + tid]);
      if (I8 && V == ROWS) vv = bf16r(vv * tvs[p]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += ss[g][p] * vv;
    }
  }
  // l_s and m_s were last written before the last tile's third barrier
  store_split<G>(acc, m_s, l_s, out, part, row, c, n_split, B, Hkv, tid,
                 q_f32);
}

template <typename CT, int V>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, const void* starts,
           void* out, void* part, int S, int B, int Hkv, int G, int layer,
           int n_split, int chunk, float scale, int int8_scores, int q_f32,
           cudaStream_t st) {
  dim3 grid(n_split, Hkv, B);
#define HEAD_ATTN_LAUNCH(GG)                                               \
  head_attn_kernel<CT, V, GG><<<grid, NT, 0, st>>>(                        \
      q, (const CT*)k, (const CT*)v, (const float*)ks, (const float*)vs,   \
      (const int*)lengths, (const int*)starts, out, (float*)part, S, B,    \
      Hkv, layer, chunk, scale, int8_scores, q_f32)
  switch (G) {
    case 1: HEAD_ATTN_LAUNCH(1); break;
    case 2: HEAD_ATTN_LAUNCH(2); break;
    case 4: HEAD_ATTN_LAUNCH(4); break;
    case 8: HEAD_ATTN_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef HEAD_ATTN_LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine((const float*)part, out, B, Hkv, G, n_split,
                             q_f32, st);
}

template <int V>
int entry(const void* q, const void* k, const void* v, const void* ks,
          const void* vs, const void* lengths, const void* starts, void* out,
          void* part, int L, int S, int B, int Hkv, int G, int Dh, int layer,
          int n_split, int chunk, float scale, int int8_scores,
          int cache_kind, int q_f32, void* stream) {
  if (Dh != D || layer < 0 || layer >= L || n_split < 1 || chunk < 1
      || (long long)n_split * chunk < S)
    return (int)cudaErrorInvalidValue;
  if (n_split > 1 && (part == nullptr || chunk % CHUNK_ALIGN != 0
                      || n_split > COMBINE_MAX_SPLIT))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cache_kind) {
    case KIND_INT8:
      if (ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
      return launch<int8_t, V>(q, k, v, ks, vs, lengths, starts, out, part,
                               S, B, Hkv, G, layer, n_split, chunk, scale,
                               int8_scores, q_f32, st);
    case KIND_BF16:
      return launch<__nv_bfloat16, V>(q, k, v, nullptr, nullptr, lengths,
                                      starts, out, part, S, B, Hkv, G, layer,
                                      n_split, chunk, scale, 0, q_f32, st);
    case KIND_F32:
      if constexpr (V == F32)
        return launch<float, V>(q, k, v, nullptr, nullptr, lengths, starts,
                                out, part, S, B, Hkv, G, layer, n_split,
                                chunk, scale, 0, q_f32, st);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All six: q k v ks vs lengths starts out part | L S B Hkv G D layer
// n_split chunk | scale | int8_scores cache_kind (0 int8, 1 bf16, 2 f32)
// q_f32 | stream. ks and vs are null for a bf16 or f32 cache; part (f32
// scratch of B * Hkv * n_split * G * (D + 2)) is null when n_split is 1.
#define HEAD_ATTN_ENTRY(NAME, V)                                           \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* ks, const void* vs, const void* lengths,  \
                      const void* starts, void* out, void* part, int L,     \
                      int S, int B, int Hkv, int G, int Dh, int layer,      \
                      int n_split, int chunk, float scale, int int8_scores, \
                      int cache_kind, int q_f32, void* stream) {            \
    return entry<V>(q, k, v, ks, vs, lengths, starts, out, part, L, S, B,   \
                    Hkv, G, Dh, layer, n_split, chunk, scale, int8_scores,  \
                    cache_kind, q_f32, stream);                             \
  }

HEAD_ATTN_ENTRY(decode_attention_stream_head, BLOCKS)
HEAD_ATTN_ENTRY(decode_attention_blocks, BLOCKS)
HEAD_ATTN_ENTRY(decode_attention_stacked_rows, ROWS)
HEAD_ATTN_ENTRY(decode_attention, F32)
HEAD_ATTN_ENTRY(decode_attention_stacked, F32)
HEAD_ATTN_ENTRY(decode_attention_chunked, F32)

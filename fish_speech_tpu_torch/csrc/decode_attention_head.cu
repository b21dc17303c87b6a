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
// Design. A row's keys fall in chunks of CHUNK = 128 positions, and the
// chunks fix the row's f32 sums whatever the batch (decode_split.cuh: each
// chunk one softmax at its own maximum, the chunks folded in order by
// fold_chunk). The wrapper maps them onto CTAs
// (ops/attention.py::cta_plan): where the rows alone fill the card, one
// CTA a (kv head, row) walks its chunks and folds each as it ends (grid
// (1, Hkv, B)); at small batches one CTA a chunk and a group of GS of the
// G query heads (grid (n_split, Hkv * G / GS, B); the heads are
// independent, so the group changes no sum) writes its partials to f32
// scratch, and split_combine_kernel folds them. At batch 1 and S = 2048
// that is 16 chunks x 8 kv heads x 2 head groups, 256 CTAs.
// The value weights are rounded where the TPU kernels round them, at the
// chunk's running maximum; the fold rescales them in f32, as the online
// softmax rescales its accumulator.
//
// Inside a CTA of 256 threads a chunk is one tile: its k and v rows (one
// contiguous block of the (row, kv head) stripe) and its scales are copied
// into dynamic shared memory with cp.async in two groups of 64 positions, and
// each half is scored as soon as it lands. A whole-row CTA holds WHOLE_BUFS
// tiles: with one, the next chunk's copy is issued when the chunk is done
// with the tile; with two, at the chunk's start, into the other tile. Each
// warp scores positions with its lanes over D (four elements a lane: __dp4a
// on the int8 query for int8 scores), reduced by shuffles. The softmax takes
// a warp per (query head, half of the chunk): each half's max, then at the
// larger of the two the value weights and each half's sum. Thread (half, d)
// accumulates output column d over its half's positions, and the second
// half's sums are added to the first's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decode_split.cuh"

namespace {

constexpr int NT = 256;        // threads; thread d < D owns output column d
constexpr int D = 128;         // head dim
constexpr int NW = NT / 32;

enum Variant { BLOCKS = 0, ROWS = 1, F32 = 2 };
enum CacheKind { KIND_INT8 = 0, KIND_BF16 = 1, KIND_F32 = 2 };

// key positions per tile: a tile is a chunk, one online-softmax step
constexpr int TP = CHUNK;
constexpr int HALF = TP / 2;             // positions a copy group

// tiles of a whole-row CTA (a split CTA takes one chunk, one tile)
constexpr int WHOLE_BUFS = 1;

// dynamic shared memory: each of nb tiles' k rows, then its v rows
template <typename CT>
constexpr size_t head_smem(int nb) {
  return nb * 2 * TP * D * sizeof(CT);
}

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename CT, int V, int GS>
__global__ void __launch_bounds__(NT) head_attn_kernel(
    const void* __restrict__ q,            // (B, Hkv, G, D) bf16 or f32
    const CT* __restrict__ k,              // (L, B, Hkv, S, D)
    const CT* __restrict__ v,
    const float* __restrict__ ks,          // (L, B, Hkv, S), int8 only
    const float* __restrict__ vs,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    void* __restrict__ out,                // (B, Hkv, G, D) as q
    float* __restrict__ part,              // partials, split only
    int S, int B, int Hkv, int G, int layer, int n_split, int whole,
    float scale, int int8_scores, int q_f32) {
  constexpr bool I8 = std::is_same<CT, int8_t>::value;
  const int hs = G / GS;                 // head groups a kv head
  const int h = blockIdx.y / hs, g0 = (blockIdx.y % hs) * GS, b = blockIdx.z;
  const int c_begin = whole ? 0 : blockIdx.x;
  const int c_end = whole ? n_split : c_begin + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the value product: thread tid takes column d of the chunk's half ph
  const int d = tid & (D - 1), ph = tid / D;
  const bool use_i8 = I8 && V == BLOCKS && int8_scores;
  const size_t row = (size_t)b * Hkv + h;

  // the query (thread tid < D loads column tid of each head), read
  // alongside the row's range
  float qg[GS];
#pragma unroll
  for (int g = 0; g < GS; ++g) {
    const size_t i = (row * G + g0 + g) * D + d;
    qg[g] = q_f32 ? reinterpret_cast<const float*>(q)[i]
                  : __bfloat162float(
                        reinterpret_cast<const __nv_bfloat16*>(q)[i]);
  }
  const TileWalk walk{starts[b], min(lengths[b], S), c_end};
  const int nb = whole ? WHOLE_BUFS : 1;   // tiles

  // tile i: its k rows at tiles + 2 i TP D, then its v rows
  extern __shared__ __align__(16) unsigned char dsm[];
  CT* const tiles = reinterpret_cast<CT*>(dsm);
  __shared__ float ksc[WHOLE_BUFS][TP], vsc[WHOLE_BUFS][TP];
  __shared__ float qf[GS][D];
  __shared__ float ss[GS][TP];         // scores, then value weights
  __shared__ float qsc[GS];
  __shared__ float mh[GS][2], sh[GS][2];   // each half's max, then sum
  __shared__ float xs[GS][D];          // the second half's value sums

  const size_t stripe = (((size_t)layer * B + b) * Hkv + h) * (size_t)S;
  const CT* kb = k + stripe * D;
  const CT* vb = v + stripe * D;
  constexpr int CH = D * (int)sizeof(CT) / 16;     // 16-byte chunks a row

  // issue the copies of tile u (the keys of chunk u.x from u.y) into tile
  // buffer `buf` as two groups: the first HALF positions, then the rest
  auto stage = [&](int2 u, int buf) {
    const int t0 = u.y, n = min(TP, walk.hi(u.x) - t0);
    CT* const sk = tiles + buf * 2 * TP * D;
    CT* const sv = sk + TP * D;
    const int4* ksrc = reinterpret_cast<const int4*>(kb + (size_t)t0 * D);
    const int4* vsrc = reinterpret_cast<const int4*>(vb + (size_t)t0 * D);
    for (int half = 0; half < 2; ++half) {
      const int p0 = half * HALF, p1 = min(n, p0 + HALF);
      for (int i = tid + p0 * CH; i < p1 * CH; i += NT) {
        cp_async16(reinterpret_cast<int4*>(sk) + i, ksrc + i);
        cp_async16(reinterpret_cast<int4*>(sv) + i, vsrc + i);
      }
      if (I8 && tid >= p0 && tid < p1) {
        cp_async4(&ksc[buf][tid], ks + stripe + t0 + tid);
        cp_async4(&vsc[buf][tid], vs + stripe + t0 + tid);
      }
      cp_async_commit();
    }
  };
  // the first chunk's copy overlaps the query's setup
  int2 cur = walk.first(c_begin);
  if (cur.x < c_end) stage(cur, 0);

  if (ph == 0) {
#pragma unroll
    for (int g = 0; g < GS; ++g) qf[g][d] = qg[g];
  }
  __syncthreads();
  if (use_i8) {
    // query scale per head: one warp per query head
    for (int g = warp; g < GS; g += NW) {
      float amax = 0.f;
      for (int e = lane; e < D; e += 32) amax = fmaxf(amax, fabsf(qf[g][e]));
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) qsc[g] = fmaxf(amax / 127.f, 1e-8f);
    }
    __syncthreads();
  }
  // this lane's four query elements (4 lane .. 4 lane + 3) per head
  float qv[GS][4];
  int qw[GS];
  float qmul[GS];
#pragma unroll
  for (int g = 0; g < GS; ++g) {
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

  // whole rows: the fold of the chunks so far, per head (column d)
  float fm[GS], fnum[GS], fden[GS];
#pragma unroll
  for (int g = 0; g < GS; ++g) {
    fm[g] = -INFINITY;
    fnum[g] = 0.f;
    fden[g] = 0.f;
  }
  if (!whole && cur.x != c_begin && ph == 0)   // a split with no key
    store_empty<GS>(part, row, c_begin, n_split, B, Hkv, G, g0, d);

  int buf = 0;                           // the chunk's tile
  while (cur.x < c_end) {
    const int c = cur.x, t0 = cur.y, n = min(TP, walk.hi(c) - t0);
    const CT* const sk = tiles + buf * 2 * TP * D;
    const CT* const sv = sk + TP * D;
    // two tiles: the next chunk's copy goes out now, into the other tile,
    // which every thread was done with at the previous chunk's end
    const int2 nxt = walk.next(cur, TP);
    const bool ahead = nb == 2 && nxt.x < c_end;
    if (ahead) stage(nxt, buf ^ 1);

    // scores, a half of the tile at a time as its copy lands: each warp
    // takes positions, its lanes split D
    for (int half = 0; half < 2; ++half) {
      cp_async_wait((ahead ? 2 : 0) + 1 - half);
      // the half is visible to every thread, and every thread is done with
      // the previous chunk
      __syncthreads();
      const int p_end = min(n, (half + 1) * HALF);
      for (int p = half * HALF + warp; p < p_end; p += NW) {
        const CT* kr = sk + p * D + 4 * lane;
        float s[GS];
        if (use_i8) {
          const int kw = *reinterpret_cast<const int*>(kr);
          int dot[GS];
#pragma unroll
          for (int g = 0; g < GS; ++g) dot[g] = __dp4a(kw, qw[g], 0);
#pragma unroll
          for (int g = 0; g < GS; ++g)
            for (int o = 16; o > 0; o >>= 1)
              dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
#pragma unroll
          for (int g = 0; g < GS; ++g)
            s[g] = (float)dot[g] * qmul[g] * ksc[buf][p];
        } else {
          float kf[4];
          load4(kr, kf);
          if (I8 && V == ROWS) {
#pragma unroll
            for (int j = 0; j < 4; ++j) kf[j] = bf16r(kf[j] * ksc[buf][p]);
          }
#pragma unroll
          for (int g = 0; g < GS; ++g)
            s[g] = qv[g][0] * kf[0] + qv[g][1] * kf[1] + qv[g][2] * kf[2]
                   + qv[g][3] * kf[3];
#pragma unroll
          for (int g = 0; g < GS; ++g)
            for (int o = 16; o > 0; o >>= 1)
              s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
#pragma unroll
          for (int g = 0; g < GS; ++g) {
            s[g] = s[g] * scale;
            if (I8 && V != ROWS) s[g] = s[g] * ksc[buf][p];
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int g = 0; g < GS; ++g) ss[g][p] = s[g];
        }
      }
    }
    __syncthreads();

    // the chunk's softmax, a warp per (query head, half of the chunk), two
    // positions a lane: each half's max, then the value weights and each
    // half's sum at the chunk's max m = max of the two
    constexpr int PL = HALF / 32;
    for (int task = warp; task < 2 * GS; task += NW) {
      const int g = task >> 1, hf = task & 1;
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int p = hf * HALF + lane + 32 * i;
        m = fmaxf(m, p < n ? ss[g][p] : -INFINITY);
      }
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) mh[g][hf] = m;
    }
    __syncthreads();
    for (int task = warp; task < 2 * GS; task += NW) {
      const int g = task >> 1, hf = task & 1;
      const float m = fmaxf(mh[g][0], mh[g][1]);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int p = hf * HALF + lane + 32 * i;
        if (p < n) {
          const float pr = expf(ss[g][p] - m);
          sum += pr;
          float w;
          if (V == F32)
            w = I8 ? pr * vsc[buf][p] : pr;
          else if (V == BLOCKS && I8)
            w = bf16r(pr * vsc[buf][p]);
          else
            w = bf16r(pr);
          ss[g][p] = w;
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) sh[g][hf] = sum;
    }
    __syncthreads();

    // value product: thread tid owns column d of the positions of half ph;
    // the second half's sums go through shared memory and are added to
    // the first's
    float acc[GS];
#pragma unroll
    for (int g = 0; g < GS; ++g) acc[g] = 0.f;
    const int p_end = min(n, (ph + 1) * HALF);
    for (int p = ph * HALF; p < p_end; ++p) {
      float vv = to_f(sv[p * D + d]);
      if (I8 && V == ROWS) vv = bf16r(vv * vsc[buf][p]);
#pragma unroll
      for (int g = 0; g < GS; ++g) acc[g] += ss[g][p] * vv;
    }
    if (ph == 1) {
#pragma unroll
      for (int g = 0; g < GS; ++g) xs[g][d] = acc[g];
    }
    __syncthreads();
    if (ph == 0) {
      float m[GS], l[GS];
#pragma unroll
      for (int g = 0; g < GS; ++g) {
        acc[g] += xs[g][d];
        m[g] = fmaxf(mh[g][0], mh[g][1]);
        l[g] = sh[g][0] + sh[g][1];
      }
      end_chunk<GS>(acc, m, l, whole, fm, fnum, fden, part, row, c, n_split,
                    B, Hkv, G, g0, d);
    }
    // every thread has read the sums and the maxima before the next chunk's
    // copy and softmax write them
    __syncthreads();
    cur = nxt;
    if (ahead)
      buf ^= 1;
    else if (cur.x < c_end)
      stage(cur, buf);
  }
  if (whole && ph == 0)
    store_whole<GS>(fnum, fden, out, row, G, g0, d, q_f32);
}

template <typename CT, int V>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, const void* starts,
           void* out, void* part, int S, int B, int Hkv, int G, int layer,
           int n_split, int whole, int hs, float scale, int int8_scores,
           int q_f32, cudaStream_t st) {
  const dim3 grid(whole ? 1 : n_split, Hkv * hs, B);
#define HEAD_ATTN_LAUNCH(GS)                                               \
  {                                                                        \
    static const cudaError_t allowed =                                     \
        allow_smem(head_attn_kernel<CT, V, GS>, head_smem<CT>(WHOLE_BUFS)); \
    if (allowed != cudaSuccess) return (int)allowed;                       \
    head_attn_kernel<CT, V, GS>                                            \
        <<<grid, NT, head_smem<CT>(whole ? WHOLE_BUFS : 1), st>>>(         \
        q, (const CT*)k, (const CT*)v, (const float*)ks, (const float*)vs, \
        (const int*)lengths, (const int*)starts, out, (float*)part, S, B,  \
        Hkv, G, layer, n_split, whole, scale, int8_scores, q_f32);         \
  }
  switch (G / hs) {
    case 1: HEAD_ATTN_LAUNCH(1); break;
    case 2: HEAD_ATTN_LAUNCH(2); break;
    case 4: HEAD_ATTN_LAUNCH(4); break;
    case 8: HEAD_ATTN_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef HEAD_ATTN_LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || whole) return (int)err;
  return (int)launch_combine((const float*)part, out, B, Hkv, G, n_split,
                             q_f32, st);
}

template <int V>
int entry(const void* q, const void* k, const void* v, const void* ks,
          const void* vs, const void* lengths, const void* starts, void* out,
          void* part, int L, int S, int B, int Hkv, int G, int Dh, int layer,
          int n_split, int whole, int hs, float scale, int int8_scores,
          int cache_kind, int q_f32, void* stream) {
  if (Dh != D || layer < 0 || layer >= L || S < 1
      || n_split != (S + CHUNK - 1) / CHUNK || hs < 1 || G % hs != 0
      || (whole && hs != 1) || (!whole && (n_split < 2 || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cache_kind) {
    case KIND_INT8:
      if (ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
      return launch<int8_t, V>(q, k, v, ks, vs, lengths, starts, out, part,
                               S, B, Hkv, G, layer, n_split, whole, hs,
                               scale, int8_scores, q_f32, st);
    case KIND_BF16:
      return launch<__nv_bfloat16, V>(q, k, v, nullptr, nullptr, lengths,
                                      starts, out, part, S, B, Hkv, G, layer,
                                      n_split, whole, hs, scale, 0, q_f32,
                                      st);
    case KIND_F32:
      if constexpr (V == F32)
        return launch<float, V>(q, k, v, nullptr, nullptr, lengths, starts,
                                out, part, S, B, Hkv, G, layer, n_split,
                                whole, hs, scale, 0, q_f32, st);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All six: q k v ks vs lengths starts out part | L S B Hkv G D layer
// n_split whole hs | scale | int8_scores cache_kind (0 int8, 1 bf16, 2 f32)
// q_f32 | stream. n_split = ceil(S / 128), the chunks; whole: one CTA a
// (kv head, row) (hs 1), else one a chunk and a group of G / hs query
// heads. ks and vs are null for a bf16 or f32 cache; part (f32 scratch of
// B * Hkv * n_split * G * (D + 2)) is null for whole rows.
#define HEAD_ATTN_ENTRY(NAME, V)                                           \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* ks, const void* vs, const void* lengths,  \
                      const void* starts, void* out, void* part, int L,     \
                      int S, int B, int Hkv, int G, int Dh, int layer,      \
                      int n_split, int whole, int hs, float scale,          \
                      int int8_scores, int cache_kind, int q_f32,           \
                      void* stream) {                                       \
    return entry<V>(q, k, v, ks, vs, lengths, starts, out, part, L, S, B,   \
                    Hkv, G, Dh, layer, n_split, whole, hs, scale,           \
                    int8_scores, cache_kind, q_f32, stream);                \
  }

HEAD_ATTN_ENTRY(decode_attention_stream_head, BLOCKS)
HEAD_ATTN_ENTRY(decode_attention_blocks, BLOCKS)
HEAD_ATTN_ENTRY(decode_attention_stacked_rows, ROWS)
HEAD_ATTN_ENTRY(decode_attention, F32)
HEAD_ATTN_ENTRY(decode_attention_stacked, F32)
HEAD_ATTN_ENTRY(decode_attention_chunked, F32)

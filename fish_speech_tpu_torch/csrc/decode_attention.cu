// Single-query GQA decode attention over one layer of the position-major
// KV cache (L, S, B, Hkv, D): int8 with flat (L, B, S*Hkv) f32 scales
// (element [l, b, s*Hkv + h]), or bf16 with none, read in place.
//
// Replaces (fish_speech_tpu/ops/attention.py, kernel body
// _decode_attn_stream_kernel):
//   decode_attention_stream        pallas_decode_attention_stream with
//                                  pos_major=True on an int8 cache, with or
//                                  without int8_scores
//   decode_attention_stream_bf16   the same on a bf16 cache
//   decode_attention_stream_fold   pallas_decode_attention_stream_fold: the
//                                  decode step's cache write, then the
//                                  attention (below)
// Numerics, as the TPU kernel's: with int8 scores q is quantized per query
// head (max|q|/127 clamped at 1e-8, round half to even) and score =
// int32(qi . k8) * (qs * scale) * ks; an int8 cache without them: score =
// f32(bf16(q) . k8) * scale * ks; bf16: f32(q . k) * scale. The value
// weight is bf16(p * vs) against int8 v, bf16(p) against bf16 v; the
// softmax sum takes p before the value scale; out = acc / max(l, 1e-20).
// A row with no key (start >= length) gives 0.
//
// What bounds it on the H100: bytes. Each filled key position is read once
// per (row, kv head): 2 x 128 B of int8 k and v and two f32 scales, or
// 2 x 256 B of bf16, against 2 x G x 128 multiply-adds of each. At the
// engine's batch 1 and S = 2048 an int8 layer is ~4.3 MB (1.3 us at
// 3.35 TB/s), a bf16 one 8.4 MB (2.5 us); at the bench's B = 256, S = 384
// an int8 layer is ~150 MB. The first design, one CTA per (kv head, row),
// was 8 CTAs on 132 SMs at batch 1, each walking its 2048 keys tile after
// tile: per-tile latency, not bytes, set its time.
//
// Design. A row's keys fall in chunks of CHUNK = 128 positions, and the
// chunks fix the row's f32 sums whatever the batch (decode_split.cuh: each
// chunk one softmax at its own maximum, the chunks folded in order by
// fold_chunk; the rule of the head-major kernel). The wrapper maps
// them onto CTAs (ops/attention.py::cta_plan): where the rows alone fill
// the card (the bench's B = 256), one CTA a (kv head, row) walks its
// chunks and folds each as it ends, and no scratch is written; at small
// batches one CTA a chunk and a group of GS of the G query heads writes
// its partials to f32 scratch and split_combine_kernel folds them: at
// B = 1, S = 2048, 16 chunks x 8 kv heads x the head groups. The scoring
// layout (below) is chosen by G, not GS, so the group changes no sum. The
// value weights are rounded at the chunk's running max.
//
// Inside a CTA of 256 threads a chunk is one tile of TP = 128 positions,
// copied into dynamic shared memory with cp.async in two groups of 64, each
// half scored as soon as it lands. A whole-row CTA holds WHOLE_BUFS tiles:
// with one, the next chunk's copy is issued when the chunk is done with the
// tile; with two, at the chunk's start, into the other tile. A position's k
// or v row of one kv head is 128 B (int8) or 256 B (bf16) at a stride of
// B*Hkv*D elements, copied in 16-byte cp.async.cg pieces; its scales sit Hkv
// floats apart and take 4-byte cp.async.ca. Scoring: a position's G dot
// products are split over R lanes of E elements (8 lanes of 16, or 16 lanes
// of 8 where G = 8 would hold 128 query floats a lane), the query held in
// registers (packed int8 words for __dp4a with int8 scores, floats otherwise)
// and the R partial sums reduced by shuffles; 256 / R positions are scored at
// once. The softmax takes a warp per (query head, half of the chunk): each
// half's max, then at the larger of the two the value weights and each half's
// sum. The value product: warp w takes positions w, w + 8, ..., each lane
// four output columns, so one 4-element v load and one weight load feed 4
// multiply-adds a query head; the warps' sums are added in warp order at the
// end of a chunk. Seven barriers a chunk.
//
// The fold (FOLD): the CTA of chunk write_pos / 128 of each (row, kv
// head) quantizes the new bf16 k and v rows (scale max|x| / 127 clamped at
// 1e-8, round half to even), writes the int8 rows at write_pos of `layer`
// and their scales into the flat scale caches (even when none of its keys
// lie in [start, length)), and patches them into its staged tile and its
// score and value scaling, so the tile loop never depends on reading its
// own write back from device memory (every head group of that chunk
// patches, the first writes). No other chunk reads write_pos, so no CTA
// waits on another; the tile loop is decode_attention_stream's, so the
// output is bit-identical to writing the rows first and launching that
// entry. Unlike the TPU kernel, which returns the scales for the caller to
// write (their offset is not 128-lane aligned), this one writes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decode_split.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int NT = 256;        // threads; thread d < D owns column d at the end
constexpr int D = 128;         // head dim
constexpr int NW = NT / 32;
static_assert(D == COMBINE_NT, "the combine takes one thread a column");

// key positions per tile: a tile is a chunk, one softmax step
constexpr int TP = CHUNK;
constexpr int HALF = TP / 2;   // positions a copy group, and a softmax warp

// tiles of a whole-row CTA (a split CTA takes one chunk, one tile)
constexpr int WHOLE_BUFS = 1;

// dynamic shared memory: each of nb tiles' k rows and v rows, then the
// warps' sums (NW, GS, D) f32
template <typename T, int GS>
constexpr size_t pos_smem(int nb) {
  return nb * 2 * TP * D * sizeof(T) + NW * GS * D * sizeof(float);
}

// The scoring layout: a position's dot products are split over R lanes of
// E elements. Lane j reads them as NL loads of CB bytes, load i at byte
// (j + i R) CB of the row, so each load instruction of a position's R lanes
// reads contiguous bytes of one row (no shared-memory bank conflicts).
// E16: 16 elements a lane (int8 scores, or G <= 4 query heads of a kv
// head); else 8, where G = 8 would hold 128 query floats a lane
template <typename T, bool E16, bool QI8>
struct Lanes {
  static constexpr int E = (QI8 || E16) ? 16 : 8;      // elements a lane
  static constexpr int R = D / E;                      // lanes a position
  static constexpr int BYTES = E * (int)sizeof(T);
  static constexpr int CB = BYTES < 16 ? BYTES : 16;   // bytes a load
  static constexpr int NL = BYTES / CB;                // loads a lane
  static constexpr int EL = CB / (int)sizeof(T);       // elements a load
  static constexpr int NGRP = NT / R;                  // positions at once
};

// CB bytes of shared memory as 32-bit words
template <int CB>
__device__ __forceinline__ void lds_words(const unsigned char* p,
                                          uint32_t* w) {
  if constexpr (CB == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    static_assert(CB == 8, "8- or 16-byte loads");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  }
}

// the cache elements of one word as floats: 4 int8 or 2 bf16
__device__ __forceinline__ void word_to_f(uint32_t w, int8_t, float* f) {
  f[0] = (float)(int8_t)w;
  f[1] = (float)(int8_t)(w >> 8);
  f[2] = (float)(int8_t)(w >> 16);
  f[3] = (float)(int8_t)(w >> 24);
}
__device__ __forceinline__ void word_to_f(uint32_t w, bf16, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// T: int8_t (scales ks/vs) or bf16 (none). GS query heads a CTA, E16 the
// scoring layout of G (Lanes). QI8: int8 scores (int8 cache only). k, v,
// ks, vs are not __restrict__: with FOLD the kernel writes them
template <typename T, int GS, bool E16, bool QI8, bool FOLD>
__global__ void __launch_bounds__(NT) pos_attn_kernel(
    const bf16* __restrict__ q,            // (B, Hkv, G, D)
    const T* k,                            // (L, S, B, Hkv, D)
    const T* v,
    const float* ks,                       // (L, B, S*Hkv), int8 only
    const float* vs,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    bf16* __restrict__ out,                // (B, Hkv, G, D)
    float* __restrict__ part,              // partials, split only
    const bf16* __restrict__ nk,           // FOLD: (B, Hkv, D) new rows
    const bf16* __restrict__ nv,
    int S, int B, int Hkv, int G, int layer, int n_split, int whole,
    int wpos, float scale) {
  constexpr bool I8 = std::is_same<T, int8_t>::value;
  static_assert(I8 || !(QI8 || FOLD), "int8 scores and the fold: int8 only");
  constexpr int RB = D * (int)sizeof(T);          // bytes a row
  constexpr int CH = RB / 16;                     // 16-byte pieces a row
  constexpr int EW = 4 / (int)sizeof(T);          // elements a word
  using LY = Lanes<T, E16, QI8>;
  constexpr int R = LY::R, NL = LY::NL, EL = LY::EL, CB = LY::CB;
  const int hs = G / GS;                 // head groups a kv head
  const int h = blockIdx.y / hs, hg = blockIdx.y % hs, g0 = hg * GS;
  const int b = blockIdx.z;
  const int c_begin = whole ? 0 : blockIdx.x;
  const int c_end = whole ? n_split : c_begin + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool col_thread = tid < D;       // owns column tid at the end
  const size_t row = (size_t)b * Hkv + h;

  // the query (thread tid < D loads column tid of each head), read
  // alongside the row's range
  float qg[GS];
#pragma unroll
  for (int g = 0; g < GS; ++g)
    qg[g] = col_thread ? __bfloat162float(q[(row * G + g0 + g) * D + tid])
                       : 0.f;
  const TileWalk walk{starts[b], min(lengths[b], S), c_end};
  const int nb = whole ? WHOLE_BUFS : 1;   // tiles

  // the tiles: TP k rows, then TP v rows, each; then the warps' sums
  extern __shared__ __align__(16) unsigned char dsm[];
  unsigned char* const tiles = dsm;
  float* red = reinterpret_cast<float*>(dsm + nb * 2 * TP * RB);
  __shared__ float ksc[WHOLE_BUFS][I8 ? TP : 1];
  __shared__ float vsc[WHOLE_BUFS][I8 ? TP : 1];
  __shared__ float qf[GS][D];
  __shared__ float ss[GS][TP];         // scores, then value weights
  __shared__ float qsc[GS];
  __shared__ float mh[GS][2], sh[GS][2];   // each half's max, then sum
  __shared__ int8_t nk8[FOLD ? D : 1], nv8[FOLD ? D : 1];  // the new rows
  __shared__ float nred[2][NW], nsc[2];                    // and scales

  const size_t pos_stride = (size_t)B * Hkv * D;          // elements
  const T* kb = k + (size_t)layer * S * pos_stride + row * D;
  const T* vb = v + (size_t)layer * S * pos_stride + row * D;
  // the scale of position t: srow + t * Hkv
  const size_t srow = ((size_t)layer * B + b) * ((size_t)S * Hkv) + h;

  // issue the copies of tile u (the keys of chunk u.x from u.y) into tile
  // buffer `buf` as two groups: the first HALF positions, then the rest
  auto stage = [&](int2 u, int buf) {
    const int t0 = u.y, n = min(TP, walk.hi(u.x) - t0);
    unsigned char* dk = tiles + buf * 2 * TP * RB;
    unsigned char* dv = dk + TP * RB;
    for (int half = 0; half < 2; ++half) {
      const int p0 = half * HALF, p1 = min(n, p0 + HALF);
      for (int i = tid + p0 * CH; i < p1 * CH; i += NT) {
        const int p = i / CH, piece = (i % CH) * 16;
        const size_t off = (size_t)(t0 + p) * pos_stride;
        cp_async16(dk + p * RB + piece,
                   reinterpret_cast<const unsigned char*>(kb + off) + piece);
        cp_async16(dv + p * RB + piece,
                   reinterpret_cast<const unsigned char*>(vb + off) + piece);
      }
      if (I8 && tid >= p0 && tid < p1) {
        cp_async4(&ksc[buf][tid], ks + srow + (size_t)(t0 + tid) * Hkv);
        cp_async4(&vsc[buf][tid], vs + srow + (size_t)(t0 + tid) * Hkv);
      }
      cp_async_commit();
    }
  };
  // the first chunk's copy overlaps the fold and the query's setup
  int2 cur = walk.first(c_begin);
  if (cur.x < c_end) stage(cur, 0);

  // FOLD: this CTA's chunks hold write_pos
  const bool owner = FOLD && wpos / CHUNK >= c_begin && wpos / CHUNK < c_end;
  if constexpr (FOLD) {
    if (owner) {
      // quantize the new rows (thread tid < D owns column tid); the first
      // head group writes them and their scales
      const float kx = col_thread ? __bfloat162float(nk[row * D + tid]) : 0.f;
      const float vx = col_thread ? __bfloat162float(nv[row * D + tid]) : 0.f;
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
        for (int w = 1; w < D / 32; ++w) m = fmaxf(m, nred[tid][w]);
        nsc[tid] = fmaxf(m / 127.f, 1e-8f);
      }
      __syncthreads();
      if (col_thread) {
        const int8_t k8 = (int8_t)rintf(kx / nsc[0]);
        const int8_t v8 = (int8_t)rintf(vx / nsc[1]);
        nk8[tid] = k8;
        nv8[tid] = v8;
        if (hg == 0) {
          const_cast<T*>(kb)[(size_t)wpos * pos_stride + tid] = k8;
          const_cast<T*>(vb)[(size_t)wpos * pos_stride + tid] = v8;
          if (tid == 0) {
            const_cast<float*>(ks)[srow + (size_t)wpos * Hkv] = nsc[0];
            const_cast<float*>(vs)[srow + (size_t)wpos * Hkv] = nsc[1];
          }
        }
      }
    }
  }

  if (col_thread) {
#pragma unroll
    for (int g = 0; g < GS; ++g) qf[g][tid] = qg[g];
  }
  __syncthreads();
  if (QI8) {
    // query scale per head: one warp per query head
    for (int g = warp; g < GS; g += NW) {
      float amax = 0.f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(qf[g][d]));
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) qsc[g] = fmaxf(amax / 127.f, 1e-8f);
    }
    __syncthreads();
  }
  // this lane's query elements: load i, element e is column
  // (j + i R) EL + e; packed int8 words (int8 scores) or floats
  const int grp = tid / R, j = tid % R;
  float qv[GS][QI8 ? 1 : LY::E];
  int qw[GS][QI8 ? LY::E / 4 : 1];
  float qmul[GS];
#pragma unroll
  for (int g = 0; g < GS; ++g) {
    qmul[g] = QI8 ? qsc[g] * scale : scale;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        const float x = qf[g][(j + i * R) * EL + e];
        const int at = i * EL + e;
        if constexpr (QI8) {
          if (e % 4 == 0) qw[g][at / 4] = 0;
          const int qi = (int)rintf(x / qsc[g]);
          qw[g][at / 4] |= (qi & 0xff) << (8 * (e % 4));
        } else {
          qv[g][at] = x;
        }
      }
    }
  }

  // whole rows: the fold of the chunks so far, per head (column tid)
  float fm[GS], fnum[GS], fden[GS];
#pragma unroll
  for (int g = 0; g < GS; ++g) {
    fm[g] = -INFINITY;
    fnum[g] = 0.f;
    fden[g] = 0.f;
  }
  if (!whole && cur.x != c_begin && col_thread)   // a split with no key
    store_empty<GS>(part, row, c_begin, n_split, B, Hkv, G, g0, tid);

  int buf = 0;                           // the chunk's tile
  while (cur.x < c_end) {
    const int c = cur.x, t0 = cur.y, n = min(TP, walk.hi(c) - t0);
    unsigned char* const tk = tiles + buf * 2 * TP * RB;
    const unsigned char* tv = tk + TP * RB;
    // two tiles: the next chunk's copy goes out now, into the other tile,
    // which every thread was done with at the previous chunk's end
    int2 nxt = make_int2(c_end, 0);
    bool ahead = false;
    if (nb == 2) {
      nxt = walk.next(cur, TP);
      ahead = nxt.x < c_end;
      if (ahead) stage(nxt, buf ^ 1);
    }

    // scores, a half of the tile at a time as its copy lands: R lanes a
    // position, NGRP positions at once (a trip count the whole CTA shares;
    // rows past the half's end are scored and dropped)
    for (int half = 0; half < 2; ++half) {
      cp_async_wait((ahead ? 2 : 0) + 1 - half);
      // the half is visible to every thread, and every thread is done with
      // the previous chunk
      __syncthreads();
      if constexpr (FOLD) {
        // only the owner's chunk holds write_pos; its staged copy may
        // predate the write
        if (owner && wpos >= t0 + half * HALF && wpos < t0 + n
            && wpos < t0 + (half + 1) * HALF) {
          const int p = wpos - t0;
          if (col_thread) {
            reinterpret_cast<int8_t*>(tk)[p * RB + tid] = nk8[tid];
            reinterpret_cast<int8_t*>(tk + TP * RB)[p * RB + tid] =
                nv8[tid];
          }
          if (tid == 0) {
            ksc[buf][p] = nsc[0];
            vsc[buf][p] = nsc[1];
          }
          __syncthreads();
        }
      }
      const int p_end = min(n, (half + 1) * HALF);
      for (int base = half * HALF; base < p_end; base += LY::NGRP) {
        const int p = base + grp;
        const unsigned char* kr = tk + p * RB;
        float s[GS];
        if constexpr (QI8) {
          uint32_t w[4];
          lds_words<16>(kr + j * 16, w);
          int dot[GS];
#pragma unroll
          for (int g = 0; g < GS; ++g) {
            dot[g] = 0;
#pragma unroll
            for (int x = 0; x < 4; ++x) dot[g] = __dp4a((int)w[x], qw[g][x],
                                                        dot[g]);
          }
#pragma unroll
          for (int o = R / 2; o > 0; o >>= 1)
#pragma unroll
            for (int g = 0; g < GS; ++g)
              dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
#pragma unroll
          for (int g = 0; g < GS; ++g)
            s[g] = (float)dot[g] * qmul[g] * ksc[buf][p];
        } else {
#pragma unroll
          for (int g = 0; g < GS; ++g) s[g] = 0.f;
#pragma unroll
          for (int i = 0; i < NL; ++i) {
            uint32_t w[CB / 4];
            lds_words<CB>(kr + (j + i * R) * CB, w);
            float kf[EL];
#pragma unroll
            for (int x = 0; x < CB / 4; ++x)
              word_to_f(w[x], T(), kf + x * EW);
#pragma unroll
            for (int e = 0; e < EL; ++e)
#pragma unroll
              for (int g = 0; g < GS; ++g) s[g] += qv[g][i * EL + e] * kf[e];
          }
#pragma unroll
          for (int o = R / 2; o > 0; o >>= 1)
#pragma unroll
            for (int g = 0; g < GS; ++g)
              s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
#pragma unroll
          for (int g = 0; g < GS; ++g) {
            s[g] = s[g] * scale;
            if (I8) s[g] = s[g] * ksc[buf][p];
          }
        }
        if (j == 0 && p < p_end) {
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
          ss[g][p] = bf16r(I8 ? pr * vsc[buf][p] : pr);
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) sh[g][hf] = sum;
    }
    __syncthreads();

    // value product: warp w takes positions w, w + NW, ...; lane l the
    // columns 4 l .. 4 l + 3
    float acc[GS][4];
#pragma unroll
    for (int g = 0; g < GS; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
    for (int p = warp; p < n; p += NW) {
      float vf[4];
      load4(reinterpret_cast<const T*>(tv + p * RB) + 4 * lane, vf);
#pragma unroll
      for (int g = 0; g < GS; ++g) {
        const float w = ss[g][p];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] += w * vf[e];
      }
    }

    // chunk c ends: the warps' sums (NW, GS, D), added in warp order
#pragma unroll
    for (int g = 0; g < GS; ++g)
      *reinterpret_cast<float4*>(&red[(warp * GS + g) * D + 4 * lane]) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    __syncthreads();
    if (col_thread) {
      float col[GS], m[GS], l[GS];
#pragma unroll
      for (int g = 0; g < GS; ++g) {
        col[g] = red[g * D + tid];
#pragma unroll
        for (int w = 1; w < NW; ++w) col[g] += red[(w * GS + g) * D + tid];
        m[g] = fmaxf(mh[g][0], mh[g][1]);
        l[g] = sh[g][0] + sh[g][1];
      }
      end_chunk<GS>(col, m, l, whole, fm, fnum, fden, part, row, c, n_split,
                    B, Hkv, G, g0, tid);
    }
    // every thread has read the sums and the maxima before the next chunk's
    // copy and softmax write them
    __syncthreads();
    if (ahead) {
      cur = nxt;
      buf ^= 1;
    } else {
      cur = walk.next(cur, TP);
      if (cur.x < c_end) stage(cur, buf);
    }
  }
  if (whole && col_thread)
    store_whole<GS>(fnum, fden, out, row, G, g0, tid, 0);
}

template <typename T, int GS, bool E16, bool QI8, bool FOLD>
cudaError_t launch_g(dim3 grid, cudaStream_t st, const void* q, const void* k,
              const void* v, const void* ks, const void* vs,
              const void* lengths, const void* starts, void* out, void* part,
              const void* nk, const void* nv, int S, int B, int Hkv, int G,
              int layer, int n_split, int whole, int wpos, float scale) {
  static const cudaError_t allowed = allow_smem(
      pos_attn_kernel<T, GS, E16, QI8, FOLD>, pos_smem<T, GS>(WHOLE_BUFS));
  if (allowed != cudaSuccess) return allowed;
  const size_t smem = pos_smem<T, GS>(whole ? WHOLE_BUFS : 1);
  pos_attn_kernel<T, GS, E16, QI8, FOLD><<<grid, NT, smem, st>>>(
      (const bf16*)q, (const T*)k, (const T*)v, (const float*)ks,
      (const float*)vs, (const int*)lengths, (const int*)starts, (bf16*)out,
      (float*)part, (const bf16*)nk, (const bf16*)nv, S, B, Hkv, G, layer,
      n_split, whole, wpos, scale);
  return cudaGetLastError();
}

template <typename T, bool QI8, bool FOLD>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* lengths, const void* starts,
             void* out, void* part, const void* nk, const void* nv, int L,
             int S, int B, int Hkv, int G, int Dh, int layer, int wpos,
             int n_split, int whole, int hs, float scale, void* stream) {
  if (Dh != D || layer < 0 || layer >= L || S < 1
      || n_split != (S + CHUNK - 1) / CHUNK || hs < 1 || G % hs != 0
      || (whole && hs != 1) || (!whole && (n_split < 2 || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (std::is_same<T, int8_t>::value && (ks == nullptr || vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (FOLD && (wpos < 0 || wpos >= S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(whole ? 1 : n_split, Hkv * hs, B);
  // the scoring layout is G's; the CTA takes G / hs of its heads
#define POS_ATTN_LAUNCH(GS, E16)                                            \
  err = launch_g<T, GS, E16, QI8, FOLD>(grid, st, q, k, v, ks, vs, lengths, \
                                        starts, out, part, nk, nv, S, B,    \
                                        Hkv, G, layer, n_split, whole,      \
                                        wpos, scale)
  const int gs = G / hs;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (G <= 4 || QI8) {
    switch (gs) {
      case 1: POS_ATTN_LAUNCH(1, true); break;
      case 2: POS_ATTN_LAUNCH(2, true); break;
      case 4: POS_ATTN_LAUNCH(4, true); break;
      case 8: POS_ATTN_LAUNCH(8, true); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (gs) {
      case 1: POS_ATTN_LAUNCH(1, false); break;
      case 2: POS_ATTN_LAUNCH(2, false); break;
      case 4: POS_ATTN_LAUNCH(4, false); break;
      case 8: POS_ATTN_LAUNCH(8, false); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef POS_ATTN_LAUNCH
  if (err != cudaSuccess || whole) return (int)err;
  return (int)launch_combine((const float*)part, out, B, Hkv, G, n_split, 0,
                             st);
}

}  // namespace

// q k v ks vs lengths starts out part | L S B Hkv G D layer n_split whole
// hs | scale | int8_scores | stream. n_split = ceil(S / 128), the chunks;
// whole: one CTA a (kv head, row) (hs 1), else one a chunk and a group of
// G / hs query heads. part: f32 scratch of B * Hkv * n_split * G * (D + 2),
// null for whole rows.
extern "C" int decode_attention_stream(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* lengths, const void* starts, void* out,
    void* part, int L, int S, int B, int Hkv, int G, int Dh, int layer,
    int n_split, int whole, int hs, float scale, int int8_scores,
    void* stream) {
  if (int8_scores)
    return dispatch<int8_t, true, false>(
        q, k, v, ks, vs, lengths, starts, out, part, nullptr, nullptr, L, S,
        B, Hkv, G, Dh, layer, -1, n_split, whole, hs, scale, stream);
  return dispatch<int8_t, false, false>(
      q, k, v, ks, vs, lengths, starts, out, part, nullptr, nullptr, L, S, B,
      Hkv, G, Dh, layer, -1, n_split, whole, hs, scale, stream);
}

// as decode_attention_stream, after writing new_k / new_v (B, Hkv, D) bf16
// quantized at write_pos of layer: k, v, ks, vs are updated in place
extern "C" int decode_attention_stream_fold(
    const void* q, void* k, void* v, void* ks, void* vs, const void* lengths,
    const void* starts, void* out, void* part, const void* new_k,
    const void* new_v, int L, int S, int B, int Hkv, int G, int Dh,
    int layer, int write_pos, int n_split, int whole, int hs, float scale,
    int int8_scores, void* stream) {
  if (int8_scores)
    return dispatch<int8_t, true, true>(
        q, k, v, ks, vs, lengths, starts, out, part, new_k, new_v, L, S, B,
        Hkv, G, Dh, layer, write_pos, n_split, whole, hs, scale, stream);
  return dispatch<int8_t, false, true>(
      q, k, v, ks, vs, lengths, starts, out, part, new_k, new_v, L, S, B,
      Hkv, G, Dh, layer, write_pos, n_split, whole, hs, scale, stream);
}

// the bf16 cache: (L, S, B, Hkv, D) k and v, no scales
extern "C" int decode_attention_stream_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* starts, void* out, void* part, int L, int S, int B, int Hkv,
    int G, int Dh, int layer, int n_split, int whole, int hs, float scale,
    void* stream) {
  return dispatch<bf16, false, false>(
      q, k, v, nullptr, nullptr, lengths, starts, out, part, nullptr,
      nullptr, L, S, B, Hkv, G, Dh, layer, -1, n_split, whole, hs, scale,
      stream);
}

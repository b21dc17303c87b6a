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
// Design. The grid is (n_split, Hkv, B): split c of a row takes the keys
// [c * chunk, (c + 1) * chunk) within [start, length). The wrapper picks
// n_split and chunk from the shapes and the SM count
// (ops/attention.py::head_split, the rule of the head-major kernel): 32
// splits of 64 keys at B = 1, S = 2048, so ~256 CTAs of one or two tiles;
// one split at B = 256, where the rows fill the card and the kernel writes
// the output itself. With n_split > 1 a split writes its running max, sum
// and unnormalised accumulators to f32 scratch, and split_combine_kernel
// (decode_split.cuh, shared with the head-major kernel) combines them in
// split order. The value weights are rounded at the split's running max.
//
// Inside a CTA of 128 threads, tiles of TP positions (64 on an int8 cache,
// 32 on bf16: two buffers of k and v rows fit static shared memory) are
// copied with double-buffered cp.async: a position's k or v row of one kv
// head is 128 B (int8) or 256 B (bf16) at a stride of B * Hkv * D
// elements, copied in 16-byte cp.async.cg pieces; its scales sit Hkv floats
// apart and take 4-byte cp.async.ca. The next tile's copy is issued as soon
// as the current one has landed. Scoring: a position's G dot products are
// split over R lanes of E elements (8 lanes of 16, or 16 lanes of 8 where
// G = 8 would hold 128 query floats a lane), the query held in registers
// (packed int8 words for __dp4a with int8 scores, floats otherwise) and the
// R partial sums reduced by shuffles; 128 / R positions are scored at once.
// One warp per query head then takes the tile's max and sum (the online
// softmax) and writes the value weights. The value product: warp w takes
// positions w, w + 4, ..., each lane four output columns, so one 4-element
// v load and one weight load feed 4 multiply-adds a query head; the warps'
// sums are added in warp order at the end. Three barriers a tile.
//
// The fold (FOLD): the CTA of split write_pos / chunk of each (row, kv
// head) quantizes the new bf16 k and v rows (scale max|x| / 127 clamped at
// 1e-8, round half to even), writes the int8 rows at write_pos of `layer`
// and their scales into the flat scale caches (even when none of its keys
// lie in [start, length)), and patches them into its staged tile and its
// score and value scaling, so the tile loop never depends on reading its
// own write back from device memory. No other split reads write_pos, so no
// CTA waits on another; the tile loop is decode_attention_stream's, so the
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
constexpr int NT = 128;        // threads; thread d owns column d at the end
constexpr int D = 128;         // head dim
constexpr int NW = NT / 32;
static_assert(D == COMBINE_NT, "the combine takes one thread a column");

// key positions per tile: two buffers of k and v rows, 32 KB
template <typename T>
struct PosTile {
  static constexpr int P = sizeof(T) == 1 ? 64 : 32;
};

// The scoring layout: a position's dot products are split over R lanes of
// E elements. Lane j reads them as NL loads of CB bytes, load i at byte
// (j + i R) CB of the row, so each load instruction of a position's R lanes
// reads contiguous bytes of one row (no shared-memory bank conflicts).
template <typename T, int G, bool QI8>
struct Lanes {
  static constexpr int E = (QI8 || G <= 4) ? 16 : 8;   // elements a lane
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

// T: int8_t (scales ks/vs) or bf16 (none). QI8: int8 scores (int8 cache
// only). k, v, ks, vs are not __restrict__: with FOLD the kernel writes them
template <typename T, int G, bool QI8, bool FOLD>
__global__ void __launch_bounds__(NT) pos_attn_kernel(
    const bf16* __restrict__ q,            // (B, Hkv, G, D)
    const T* k,                            // (L, S, B, Hkv, D)
    const T* v,
    const float* ks,                       // (L, B, S*Hkv), int8 only
    const float* vs,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    bf16* __restrict__ out,                // (B, Hkv, G, D)
    float* __restrict__ part,              // partials, n_split > 1 only
    const bf16* __restrict__ nk,           // FOLD: (B, Hkv, D) new rows
    const bf16* __restrict__ nv,
    int S, int B, int Hkv, int layer, int chunk, int wpos, float scale) {
  constexpr bool I8 = std::is_same<T, int8_t>::value;
  static_assert(I8 || !(QI8 || FOLD), "int8 scores and the fold: int8 only");
  constexpr int TP = PosTile<T>::P;
  constexpr int RB = D * (int)sizeof(T);          // bytes a row
  constexpr int CH = RB / 16;                     // 16-byte pieces a row
  constexpr int EW = 4 / (int)sizeof(T);          // elements a word
  using LY = Lanes<T, G, QI8>;
  constexpr int R = LY::R, NL = LY::NL, EL = LY::EL, CB = LY::CB;
  static_assert(NW * G * D * 4 <= 2 * 2 * TP * RB,
                "the warps' sums fit the tile buffers");
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * Hkv + h;

  // the query (thread tid loads column tid of each head), read alongside
  // the row's range
  float qg[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    qg[g] = __bfloat162float(q[(row * G + g) * D + tid]);
  // this split's keys
  const int lo = max(starts[b], c * chunk);
  const int hi = min(min(lengths[b], S), (c + 1) * chunk);

  // per buffer: TP k rows, then TP v rows
  __shared__ __align__(16) unsigned char tiles[2][2 * TP * RB];
  __shared__ float ksc[2][I8 ? TP : 1], vsc[2][I8 ? TP : 1];
  __shared__ float qf[G][D];
  __shared__ float ss[G][TP];          // scores, then value weights
  __shared__ float qsc[G];
  __shared__ float m_s[G], l_s[G], corr_s[G];
  __shared__ int8_t nk8[FOLD ? D : 1], nv8[FOLD ? D : 1];  // the new rows
  __shared__ float nred[2][NW], nsc[2];                    // and scales

  const size_t pos_stride = (size_t)B * Hkv * D;          // elements
  const T* kb = k + (size_t)layer * S * pos_stride + row * D;
  const T* vb = v + (size_t)layer * S * pos_stride + row * D;
  // the scale of position t: srow + t * Hkv
  const size_t srow = ((size_t)layer * B + b) * ((size_t)S * Hkv) + h;

  // issue the copies of the tile at t0 into buffer `buf`, as one group
  auto stage = [&](int t0, int buf) {
    const int n = min(TP, hi - t0);
    unsigned char* dk = tiles[buf];
    unsigned char* dv = tiles[buf] + TP * RB;
    for (int i = tid; i < n * CH; i += NT) {
      const int p = i / CH, piece = (i % CH) * 16;
      const size_t off = (size_t)(t0 + p) * pos_stride;
      cp_async16(dk + p * RB + piece,
                 reinterpret_cast<const unsigned char*>(kb + off) + piece);
      cp_async16(dv + p * RB + piece,
                 reinterpret_cast<const unsigned char*>(vb + off) + piece);
    }
    if (I8 && tid < n) {
      cp_async4(&ksc[buf][tid], ks + srow + (size_t)(t0 + tid) * Hkv);
      cp_async4(&vsc[buf][tid], vs + srow + (size_t)(t0 + tid) * Hkv);
    }
    cp_async_commit();
  };
  // the first tile's copy overlaps the fold and the query's setup
  if (lo < hi) stage(lo, 0);

  if constexpr (FOLD) {
    if (c == wpos / chunk) {
      // this split owns write_pos: quantize the new rows (thread tid owns
      // column tid) and write them and their scales
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
      const_cast<T*>(kb)[(size_t)wpos * pos_stride + tid] = k8;
      const_cast<T*>(vb)[(size_t)wpos * pos_stride + tid] = v8;
      if (tid == 0) {
        const_cast<float*>(ks)[srow + (size_t)wpos * Hkv] = nsc[0];
        const_cast<float*>(vs)[srow + (size_t)wpos * Hkv] = nsc[1];
      }
    }
  }
  if (lo >= hi) {
    store_empty<G>(out, part, row, c, n_split, B, Hkv, tid, 0);
    return;
  }

#pragma unroll
  for (int g = 0; g < G; ++g) qf[g][tid] = qg[g];
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if (QI8) {
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
  // this lane's query elements: load i, element e is column
  // (j + i R) EL + e; packed int8 words (int8 scores) or floats
  const int grp = tid / R, j = tid % R;
  float qv[G][QI8 ? 1 : LY::E];
  int qw[G][QI8 ? LY::E / 4 : 1];
  float qmul[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
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

  // warp w's partial sums of columns 4 lane .. 4 lane + 3
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;

  for (int t0 = lo, it = 0; t0 < hi; t0 += TP, ++it) {
    const int n = min(TP, hi - t0), buf = it & 1;
    const unsigned char* tk = tiles[buf];
    const unsigned char* tv = tiles[buf] + TP * RB;
    const float* tks = ksc[buf];
    const float* tvs = vsc[buf];
    cp_async_wait_all();
    // the tile is visible to every thread, and every thread is done with
    // the previous tile: its buffer, ss and corr_s may be written again
    __syncthreads();
    if (t0 + TP < hi) stage(t0 + TP, buf ^ 1);
    if constexpr (FOLD) {
      // only the owner's range holds write_pos; its staged copy may
      // predate this CTA's write
      if (wpos >= t0 && wpos < t0 + n) {
        const int p = wpos - t0;
        reinterpret_cast<int8_t*>(tiles[buf])[p * RB + tid] = nk8[tid];
        reinterpret_cast<int8_t*>(tiles[buf] + TP * RB)[p * RB + tid] =
            nv8[tid];
        if (tid == 0) {
          ksc[buf][p] = nsc[0];
          vsc[buf][p] = nsc[1];
        }
        __syncthreads();
      }
    }

    // scores: R lanes a position, NGRP positions at once (a trip count the
    // whole CTA shares; rows past n are scored and dropped)
    for (int base = 0; base < n; base += LY::NGRP) {
      const int p = base + grp;
      const unsigned char* kr = tk + p * RB;
      float s[G];
      if constexpr (QI8) {
        uint32_t w[4];
        lds_words<16>(kr + j * 16, w);
        int dot[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          dot[g] = 0;
#pragma unroll
          for (int x = 0; x < 4; ++x) dot[g] = __dp4a((int)w[x], qw[g][x],
                                                      dot[g]);
        }
#pragma unroll
        for (int o = R / 2; o > 0; o >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = (float)dot[g] * qmul[g] * tks[p];
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          uint32_t w[CB / 4];
          lds_words<CB>(kr + (j + i * R) * CB, w);
          float kf[EL];
#pragma unroll
          for (int x = 0; x < CB / 4; ++x) word_to_f(w[x], T(), kf + x * EW);
#pragma unroll
          for (int e = 0; e < EL; ++e)
#pragma unroll
            for (int g = 0; g < G; ++g) s[g] += qv[g][i * EL + e] * kf[e];
        }
#pragma unroll
        for (int o = R / 2; o > 0; o >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s[g] = s[g] * scale;
          if (I8) s[g] = s[g] * tks[p];
        }
      }
      if (j == 0 && p < n) {
#pragma unroll
        for (int g = 0; g < G; ++g) ss[g][p] = s[g];
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, TP / 32 positions a lane
    constexpr int PL = TP / 32;
    for (int g = warp; g < G; g += NW) {
      float sc[PL];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int p = lane + 32 * i;
        sc[i] = p < n ? ss[g][p] : -INFINITY;
        m = fmaxf(m, sc[i]);
      }
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int p = lane + 32 * i;
        if (p < n) {
          const float pr = expf(sc[i] - m_new);
          sum += pr;
          ss[g][p] = bf16r(I8 ? pr * tvs[p] : pr);
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // value product: warp w takes positions w, w + NW, ...; lane l the
    // columns 4 l .. 4 l + 3
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= corr_s[g];
    for (int p = warp; p < n; p += NW) {
      float vf[4];
      load4(reinterpret_cast<const T*>(tv + p * RB) + 4 * lane, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float w = ss[g][p];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] += w * vf[e];
      }
    }
  }
  // every warp is done with the tiles and no copy is in flight: the warps'
  // sums go through the tile buffers, (NW, G, D), added in warp order
  __syncthreads();
  float* red = reinterpret_cast<float*>(&tiles[0][0]);
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<float4*>(&red[(warp * G + g) * D + 4 * lane]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  float col[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    col[g] = red[g * D + tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) col[g] += red[(w * G + g) * D + tid];
  }
  // l_s and m_s were last written before the last tile's third barrier
  store_split<G>(col, m_s, l_s, out, part, row, c, n_split, B, Hkv, tid, 0);
}

template <typename T, int G, bool QI8, bool FOLD>
void launch_g(dim3 grid, cudaStream_t st, const void* q, const void* k,
              const void* v, const void* ks, const void* vs,
              const void* lengths, const void* starts, void* out, void* part,
              const void* nk, const void* nv, int S, int B, int Hkv,
              int layer, int chunk, int wpos, float scale) {
  pos_attn_kernel<T, G, QI8, FOLD><<<grid, NT, 0, st>>>(
      (const bf16*)q, (const T*)k, (const T*)v, (const float*)ks,
      (const float*)vs, (const int*)lengths, (const int*)starts, (bf16*)out,
      (float*)part, (const bf16*)nk, (const bf16*)nv, S, B, Hkv, layer,
      chunk, wpos, scale);
}

template <typename T, bool QI8, bool FOLD>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* lengths, const void* starts,
             void* out, void* part, const void* nk, const void* nv, int L,
             int S, int B, int Hkv, int G, int Dh, int layer, int wpos,
             int n_split, int chunk, float scale, void* stream) {
  if (Dh != D || layer < 0 || layer >= L || n_split < 1 || chunk < 1
      || (long long)n_split * chunk < S)
    return (int)cudaErrorInvalidValue;
  if (n_split > 1 && (part == nullptr || n_split > COMBINE_MAX_SPLIT))
    return (int)cudaErrorInvalidValue;
  if (std::is_same<T, int8_t>::value && (ks == nullptr || vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (FOLD && (wpos < 0 || wpos >= S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(n_split, Hkv, B);
#define POS_ATTN_LAUNCH(GG)                                                 \
  launch_g<T, GG, QI8, FOLD>(grid, st, q, k, v, ks, vs, lengths, starts,    \
                             out, part, nk, nv, S, B, Hkv, layer, chunk,    \
                             wpos, scale)
  switch (G) {
    case 1: POS_ATTN_LAUNCH(1); break;
    case 2: POS_ATTN_LAUNCH(2); break;
    case 4: POS_ATTN_LAUNCH(4); break;
    case 8: POS_ATTN_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef POS_ATTN_LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine((const float*)part, out, B, Hkv, G, n_split, 0,
                             st);
}

}  // namespace

// q k v ks vs lengths starts out part | L S B Hkv G D layer n_split chunk |
// scale | int8_scores | stream. part: f32 scratch of
// B * Hkv * n_split * G * (D + 2), null when n_split is 1.
extern "C" int decode_attention_stream(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* lengths, const void* starts, void* out,
    void* part, int L, int S, int B, int Hkv, int G, int Dh, int layer,
    int n_split, int chunk, float scale, int int8_scores, void* stream) {
  if (int8_scores)
    return dispatch<int8_t, true, false>(
        q, k, v, ks, vs, lengths, starts, out, part, nullptr, nullptr, L, S,
        B, Hkv, G, Dh, layer, -1, n_split, chunk, scale, stream);
  return dispatch<int8_t, false, false>(
      q, k, v, ks, vs, lengths, starts, out, part, nullptr, nullptr, L, S, B,
      Hkv, G, Dh, layer, -1, n_split, chunk, scale, stream);
}

// as decode_attention_stream, after writing new_k / new_v (B, Hkv, D) bf16
// quantized at write_pos of layer: k, v, ks, vs are updated in place
extern "C" int decode_attention_stream_fold(
    const void* q, void* k, void* v, void* ks, void* vs, const void* lengths,
    const void* starts, void* out, void* part, const void* new_k,
    const void* new_v, int L, int S, int B, int Hkv, int G, int Dh,
    int layer, int write_pos, int n_split, int chunk, float scale,
    int int8_scores, void* stream) {
  if (int8_scores)
    return dispatch<int8_t, true, true>(
        q, k, v, ks, vs, lengths, starts, out, part, new_k, new_v, L, S, B,
        Hkv, G, Dh, layer, write_pos, n_split, chunk, scale, stream);
  return dispatch<int8_t, false, true>(
      q, k, v, ks, vs, lengths, starts, out, part, new_k, new_v, L, S, B,
      Hkv, G, Dh, layer, write_pos, n_split, chunk, scale, stream);
}

// the bf16 cache: (L, S, B, Hkv, D) k and v, no scales
extern "C" int decode_attention_stream_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* starts, void* out, void* part, int L, int S, int B, int Hkv,
    int G, int Dh, int layer, int n_split, int chunk, float scale,
    void* stream) {
  return dispatch<bf16, false, false>(
      q, k, v, nullptr, nullptr, lengths, starts, out, part, nullptr,
      nullptr, L, S, B, Hkv, G, Dh, layer, -1, n_split, chunk, scale, stream);
}

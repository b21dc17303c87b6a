// One whole fast-head sweep (all layers, one codebook position) with W8A8
// products and the int8 position-major fast KV cache, as ONE persistent
// cooperative launch.
//
// Replaces: fish_speech_tpu/ops/fast_fused.py::fused_fast_sweep (kernel
// body _fast_sweep_kernel, one pallas_call over grid (L, 7)).
//
// What bounds it on the H100: bytes at small batch. A sweep streams 13
// int8 (dim, dim) weight tiles per layer, 13 x 1024^2 x 28 = 381.7 MB at
// S2-Pro width (~114 us at 3.35 TB/s), against 2 x B x 381.7 M int8
// operations: the two balance near B = 256, where the products need the
// int8 tensor cores.
//
// Design. The TPU kernel walks the layers in order inside one grid; here
// a grid of exactly the co-resident CTAs (SM count x occupancy, launched
// cooperatively, so all of them run at once) walks the layers together
// and crosses a grid-wide barrier (cooperative_groups grid sync) between
// dependent phases. The kernel has three instances (B = 1, B <= 8, B > 8),
// each with its own register allocation: at B = 1 the products hold one
// accumulator row, not eight, and nothing spills.
//
// B <= 8 (the main path, batch 1): four phases and four barriers a layer at
// B = 1; five above it (the rows' attention, a CTA a row, crosses one more).
//   (a) every CTA recomputes RMSNorm + int8 quantization of all B rows
//       (2 KB each, from L2) into shared memory; the 3*dim q/k/v columns
//       are spread over all warps of the grid (one warp a column, 16-byte
//       loads, two columns in flight).
//   (b) every CTA recomputes the row's attention (RoPE, k/v quantization,
//       positions [0, pos], the cached ones staged in shared memory) and
//       the output's quantization; CTA 0 writes the cache row. The dim wo
//       columns are shared among CTAs (c, c + grid, ...), each column's K
//       split over warps of its CTA; int32 partials are summed exactly,
//       then the f32 epilogue adds the residual.
//   (c) the ffn norm as (a); a warp owns gate column n and up column n (two
//       pairs in flight) and writes h2 = bf16(bf16(silu(g)) * u); each CTA
//       folds its row maxima into hmax (atomicMax on the bits of a
//       non-negative float: exact, in any order). CTA 0 zeroes hmax in (a),
//       two barriers before the first fold and one after the last read.
//   (d) h2's rows quantized with those maxima (one pass of 16-byte loads),
//       then w2 as wo, its three K segments converted to f32 and added in
//       order.
// A row that every CTA reads (x, q/k/v, h2, one head of the RoPE row) is
// first copied to shared memory with 16-byte loads: read element by
// element, the whole grid's requests queue on the row's few L2 lines.
// B > 8: row phases (norms, attention, h2's quantization; a CTA a row) and
// tiled products with mma.sync m16n8k32 s8 (64 x 64 tiles, K in steps of
// 64 through a 4-stage cp.async ring), eight barriers a layer.
//
// Numerics are those of the plain twin and of the earlier multi-launch
// kernel: bf16 where the TPU kernel rounds, per-row int8 with
// fmaxf(amax, 1e-8)/127, exact int32 sums (so the tensor-core and __dp4a
// products agree bit for bit), w2's segments summed in f32 in segment
// order, the attention's per-head sums in the same order as before
// (butterfly within 32 lanes, then the head's warps in order), -fmad=false.
//
// Data written by one CTA and read by another after a barrier is read
// with ld.global.cg (L2), never through the non-coherent L1 path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_DIM = 1024, MAX_POS = 16, MAX_HEADS = 32;
constexpr int SMALL_B = 8;        // up to this many rows: the weight stream
constexpr int MAX_ITEMS = 64;     // split-K (column, segment, part) a pass
constexpr int N_TILES = 13;
constexpr int TM = 64, TN = 64, TK = 64, TLD = TK + 16;   // mma tiles
constexpr int NST = 4;                                    // cp.async stages
constexpr int LANES = MAX_DIM / THREADS;                  // row lanes a thread

struct Args {
  const bf16* x_in;   // (B, dim) the sweep's input
  bf16* x;            // (B, dim) the residual stream, the sweep's output
  const int8_t* w;    // (L, 13, dim, dim)
  const float* s;     // (L, 13, dim)
  const bf16* norms;  // (L, 2, dim)
  const bf16* freqs;  // (>= K, head_dim / 2, 2) RoPE (cos, sin) by position
  int8_t* ck;         // (L, K, B, dim)
  int8_t* cv;
  bf16* cks;          // (L, K, B)
  bf16* cvs;
  int8_t* x8;         // scratch (B, 3*dim)
  float* xs;          // scratch (B)
  bf16* buf;          // scratch (B, 3*dim)
  float* hmax;        // scratch (B) row maxima of h2 at B <= SMALL_B
  unsigned long long* trace;  // null, or (2 * barriers + 2, grid) times
  int B, dim, L, K, pos, n_head;
  int ks_wo, ks_w2;   // B <= 8: K parts a segment of wo / w2 over warps
  float eps;
};

struct SmemSmall {
  float xs[SMALL_B];                  // the rows' scales
  float pm[WARPS * SMALL_B];          // warps' partial row maxima
  int8_t x8[SMALL_B * 3 * MAX_DIM];   // the rows' int8 activations
  int part[MAX_ITEMS * SMALL_B];      // split-K int32 partials
  __align__(16) bf16 xrow[SMALL_B * MAX_DIM];   // the rows, to normalize
};

// the attention phase: a row's cached positions before `pos`, staged with
// 16-byte loads in one round trip (the first members keep SmemSmall's
// scales and the attention outputs of B <= 8 rows clear)
struct CacheStage {
  float keep[SMALL_B + WARPS * SMALL_B];
  int8_t a8[SMALL_B * MAX_DIM];
  int8_t k[MAX_POS][MAX_DIM];
  int8_t v[MAX_POS][MAX_DIM];
  float ks[MAX_POS];
  float vs[MAX_POS];
};

struct SmemTile {
  int8_t a[NST][TM * TLD];
  int8_t b[NST][2][TN * TLD];         // [stage][gate, up]
};

union SmemBig {
  SmemSmall s;
  CacheStage c;
  SmemTile t;
};

struct SmemAttn {
  float hs[MAX_POS][MAX_DIM / 32];    // per (position, 32-lane group) sums
  float e[MAX_POS][MAX_HEADS];        // scores, then exp(score - max)
  float wt[MAX_POS][MAX_HEADS];       // bf16(p * v scale) a (position, head)
  float mx[MAX_HEADS];                // a head's largest score
  float inv[MAX_HEADS];               // 1 / its softmax denominator
  float red[32];
  // a row every CTA reads (x, q/k/v, h2), and one head's RoPE cos and sin
  __align__(16) bf16 row[3 * MAX_DIM];
  __align__(16) float rope[2 * MAX_DIM];
};

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// a bf16 another CTA wrote in this launch: read at L2
__device__ __forceinline__ float ld_bf(const bf16* p) {
  return __bfloat162float(__ldcg(p));
}

// n bf16 (n % 8 == 0, 16-byte aligned) another CTA wrote in this launch,
// copied to shared memory with 16-byte L2 loads. Every CTA of the grid
// reads the same row at once: one request a thread for eight elements keeps
// the row's few L2 lines from queueing the whole grid's element loads.
__device__ void stage_bf(const bf16* src, int n, bf16* dst) {
  for (int i = threadIdx.x; i < n / 8; i += THREADS)
    reinterpret_cast<int4*>(dst)[i] =
        __ldcg(reinterpret_cast<const int4*>(src) + i);
  __syncthreads();
}

// sum / max over the CTA (THREADS threads); red: 32 floats
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < WARPS; ++w) t += red[w];
  return t;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < WARPS; ++w) t = fmaxf(t, red[w]);
  return t;
}

// two maxima over the CTA in one round of barriers
__device__ float2 block_max2(float u, float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    u = fmaxf(u, __shfl_xor_sync(0xffffffffu, u, o));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  __syncthreads();
  if (lane == 0) {
    red[warp] = u;
    red[WARPS + warp] = v;
  }
  __syncthreads();
  float tu = red[0], tv = red[WARPS];
  for (int w = 1; w < WARPS; ++w) {
    tu = fmaxf(tu, red[w]);
    tv = fmaxf(tv, red[WARPS + w]);
  }
  return make_float2(tu, tv);
}

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}


// The grid-wide barrier n of the sweep. With a trace, each CTA's thread 0
// records the global timer (ns) when its CTA arrives and when it leaves:
// rows 1 + 2n and 2 + 2n of the trace (row 0: the start, the last row: the
// end).
__device__ __forceinline__ void barrier(cg::grid_group& grid, const Args& a,
                                        int& n) {
  if (a.trace) {
    __syncthreads();
    if (threadIdx.x == 0)
      a.trace[(size_t)(1 + 2 * n) * gridDim.x + blockIdx.x] = gtime();
  }
  grid.sync();
  if (a.trace && threadIdx.x == 0)
    a.trace[(size_t)(2 + 2 * n) * gridDim.x + blockIdx.x] = gtime();
  ++n;
}

__device__ __forceinline__ int dp4a16(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

__device__ __forceinline__ int warp_sum(int a) {
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* g,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(g), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// y = bf16(bf16(x * rsqrt(mean(x^2) + eps)) * w); out8 = round(y / sc),
// *out_s = sc, by the whole CTA: the earlier rms_quant_kernel's
// arithmetic and sum order (it ran on 256 threads as well)
__device__ void rms_quant_block(const bf16* xr, const bf16* w, int dim,
                                float eps, int8_t* out8, float* out_s,
                                SmemAttn& sa) {
  float* red = sa.red;
  float y[LANES], wv[LANES];
#pragma unroll
  for (int c = 0; c < LANES; ++c) {
    const int i = threadIdx.x + c * THREADS;
    wv[c] = i < dim ? __bfloat162float(w[i]) : 0.f;
  }
  stage_bf(xr, dim, sa.row);
#pragma unroll
  for (int c = 0; c < LANES; ++c) {
    const int i = threadIdx.x + c * THREADS;
    y[c] = i < dim ? __bfloat162float(sa.row[i]) : 0.f;
  }
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < LANES; ++c) ss += y[c] * y[c];
  ss = block_sum(ss, red);
  const float r = 1.f / sqrtf(ss / (float)dim + eps);
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < LANES; ++c) {
    const int i = threadIdx.x + c * THREADS;
    if (i < dim) {
      y[c] = bf(bf(y[c] * r) * wv[c]);
      amax = fmaxf(amax, fabsf(y[c]));
    }
  }
  amax = block_max(amax, red);
  const float sc = fmaxf(amax, 1e-8f) / 127.f;
#pragma unroll
  for (int c = 0; c < LANES; ++c) {
    const int i = threadIdx.x + c * THREADS;
    if (i < dim) out8[i] = (int8_t)rintf(y[c] / sc);
  }
  if (threadIdx.x == 0) *out_s = sc;
}

// The same, by one warp, on a row in shared memory: the sum of squares in
// the order of the earlier rms_quant_kernel's 256 threads (thread t's sum
// over x[t + 256c], each 32-thread butterfly, the 8 warp totals in order),
// its 8 butterflies interleaved, so that no CTA-wide barrier is needed
__device__ void rms_quant_row(const bf16* xr, const bf16* w, int dim,
                              float eps, int8_t* out8, float* out_s) {
  constexpr int V = THREADS / 32;
  const int lane = threadIdx.x & 31;
  float x[V][LANES], part[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int c = 0; c < LANES; ++c) {
      const int i = 32 * v + lane + THREADS * c;
      x[v][c] = i < dim ? __bfloat162float(xr[i]) : 0.f;
    }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    part[v] = 0.f;
#pragma unroll
    for (int c = 0; c < LANES; ++c) part[v] += x[v][c] * x[v][c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int v = 0; v < V; ++v)
      part[v] += __shfl_xor_sync(0xffffffffu, part[v], o);
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) ss += part[v];
  const float r = 1.f / sqrtf(ss / (float)dim + eps);
  float amax = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int c = 0; c < LANES; ++c) {
      const int i = 32 * v + lane + THREADS * c;
      if (i < dim) {
        x[v][c] = bf(bf(x[v][c] * r) * __bfloat162float(w[i]));
        amax = fmaxf(amax, fabsf(x[v][c]));
      }
    }
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = fmaxf(amax, 1e-8f) / 127.f;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int c = 0; c < LANES; ++c) {
      const int i = 32 * v + lane + THREADS * c;
      if (i < dim) out8[i] = (int8_t)rintf(x[v][c] / sc);
    }
  if (lane == 0) *out_s = sc;
}

// rows [0, B) (B <= 8) normalized and quantized in every CTA: one row by
// the whole CTA; several staged in shared memory (16-byte loads, all in
// flight) and then normalized by a warp each
__device__ void rms_quant_rows(const Args& a, const bf16* x, const bf16* w,
                               int8_t* out8, float* out_s, bf16* stage,
                               SmemAttn& sa) {
  const int warp = threadIdx.x >> 5;
  if (a.B == 1) {
    rms_quant_block(x, w, a.dim, a.eps, out8, out_s, sa);
    return;
  }
  stage_bf(x, a.B * a.dim, stage);
  if (warp < a.B)
    rms_quant_row(stage + warp * a.dim, w, a.dim, a.eps, out8 + warp * a.dim,
                  out_s + warp);
}

// h2's rows [0, B) (B <= 8, in buf) quantized into out8 (B, 3*dim) with
// the row maxima the grid folded into hmax, sc = fmaxf(amax, 1e-8) / 127:
// one pass of independent 16-byte loads, 8 values each
__device__ void quant_h2_rows(const Args& a, int8_t* out8, float* out_s) {
  const int per = 3 * a.dim / 8;
  for (int i = threadIdx.x; i < a.B * per; i += THREADS) {
    const float sc = fmaxf(__ldcg(a.hmax + i / per), 1e-8f) / 127.f;
    const int4 raw = __ldcg(reinterpret_cast<const int4*>(a.buf) + i);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
    unsigned q[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      q[j >> 2] |= (unsigned)(uint8_t)(int8_t)rintf(__bfloat162float(h[j]) /
                                                    sc)
                   << (8 * (j & 3));
    reinterpret_cast<uint2*>(out8)[i] = make_uint2(q[0], q[1]);
  }
  if (threadIdx.x < a.B)
    out_s[threadIdx.x] = fmaxf(__ldcg(a.hmax + threadIdx.x), 1e-8f) / 127.f;
}

// out8 = round(h / sc) over a bf16 row of n <= 3 * MAX_DIM values (staged
// first), sc = fmaxf(amax over the row, 1e-8) / 127
__device__ void quant_row(const bf16* hr, int n, int8_t* out8, float* out_s,
                          SmemAttn& sa) {
  float v[3 * LANES];
  float amax = 0.f;
  stage_bf(hr, n, sa.row);
#pragma unroll
  for (int c = 0; c < 3 * LANES; ++c) {
    const int i = threadIdx.x + c * THREADS;
    v[c] = i < n ? __bfloat162float(sa.row[i]) : 0.f;
    amax = fmaxf(amax, fabsf(v[c]));
  }
  const float sc = fmaxf(block_max(amax, sa.red), 1e-8f) / 127.f;
#pragma unroll
  for (int c = 0; c < 3 * LANES; ++c) {
    const int i = threadIdx.x + c * THREADS;
    if (i < n) out8[i] = (int8_t)rintf(v[c] / sc);
  }
  if (threadIdx.x == 0) *out_s = sc;
}

// Row b of layer l: RoPE on q and k, int8 k and v (written to the cache at
// `pos` when write), attention over [0, pos], the output quantized.
// Lanes: the row's 32-lane groups are the earlier kernel's warps; thread t
// holds lanes 32g + i + 8m (g = t / 8, i = t % 8, m < 4) of group g, so a
// group's xor-butterfly sum takes its first two levels (i with i + 16, then
// i with i + 8) inside the thread and the last three over 8 threads: the
// same sums in the same order, with 3 shuffles a position instead of 20.
// The positions before `pos` are staged in shared memory first
// (cp.async); position `pos` is the CTA's own. The positions' sums are
// independent and run side by side (unrolled to MAX_POS).
__device__ void attn_row(const Args& a, int l, int b, const bf16* row,
                         bool write, int8_t* out8, float* out_s,
                         CacheStage& cs, SmemAttn& sa) {
  const int dim = a.dim, pos = a.pos, B = a.B;
  const int g = threadIdx.x >> 3, i8 = threadIdx.x & 7;
  const bool on = 32 * g < dim;          // the thread's group is in the row
  const int hd = dim / a.n_head, wph = hd / 32;
  const size_t lk = (size_t)l * a.K;
  const int chunks = dim / 16;
  for (int i = threadIdx.x; i < pos * chunks; i += THREADS) {
    const int p = i / chunks, c = i % chunks * 16;
    const size_t at = ((lk + p) * B + b) * dim + c;
    cp_async16(&cs.k[p][c], a.ck + at, 16);
    cp_async16(&cs.v[p][c], a.cv + at, 16);
  }
  cp_commit();
  if (threadIdx.x < pos) {
    cs.ks[threadIdx.x] = __bfloat162float(a.cks[(lk + threadIdx.x) * B + b]);
    cs.vs[threadIdx.x] = __bfloat162float(a.cvs[(lk + threadIdx.x) * B + b]);
  }
  // a head's cos and sin at `pos` (the same for every head), lanes 2i and
  // 2i + 1 from the table's pair i, read 16 bytes (4 pairs) a load; then
  // the row's q/k/v
  const bf16* frow = a.freqs + (size_t)pos * hd;
  for (int i = threadIdx.x; i < hd / 8; i += THREADS) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(frow) + i);
    const bf16* f = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lane = 8 * i + 2 * j;
      sa.rope[lane] = sa.rope[lane + 1] = __bfloat162float(f[2 * j]);
      sa.rope[hd + lane] = sa.rope[hd + lane + 1] =
          __bfloat162float(f[2 * j + 1]);
    }
  }
  stage_bf(row, 3 * dim, sa.row);
  const float* rc = sa.rope;              // cos at [0, hd), sin at [hd, 2hd)
  const bf16* qkv = sa.row;
  float q[LANES], kr[LANES], vv[LANES];
  float kmax = 0.f, vmax = 0.f;
#pragma unroll
  for (int m = 0; m < LANES; ++m) {
    const int j = 32 * g + i8 + 8 * m;
    const float qv = on ? __bfloat162float(qkv[j]) : 0.f;
    const float kv = on ? __bfloat162float(qkv[dim + j]) : 0.f;
    vv[m] = on ? __bfloat162float(qkv[2 * dim + j]) : 0.f;
    // lane j ^ 1 is thread t ^ 1
    const float qp = __shfl_xor_sync(0xffffffffu, qv, 1);
    const float kp = __shfl_xor_sync(0xffffffffu, kv, 1);
    const bool even = (j & 1) == 0;
    const int jr = j % hd;
    q[m] = kr[m] = 0.f;
    if (on) {
      q[m] = bf(qv * rc[jr] + (even ? -qp : qp) * rc[hd + jr]);
      kr[m] = bf(kv * rc[jr] + (even ? -kp : kp) * rc[hd + jr]);
    }
    kmax = fmaxf(kmax, fabsf(kr[m]));
    vmax = fmaxf(vmax, fabsf(vv[m]));
  }
  cp_wait<0>();     // the staged rows, visible after block_max2's barriers
  const float2 kvmax = block_max2(kmax, vmax, sa.red);
  const float ksc = fmaxf(kvmax.x / 127.f, 1e-8f);
  const float vsc = fmaxf(kvmax.y / 127.f, 1e-8f);
  float k8[LANES], v8[LANES];
#pragma unroll
  for (int m = 0; m < LANES; ++m) {
    const int j = 32 * g + i8 + 8 * m;
    k8[m] = rintf(kr[m] / ksc);
    v8[m] = rintf(vv[m] / vsc);
    if (write && on) {
      const size_t here = ((lk + pos) * B + b) * dim + j;
      a.ck[here] = (int8_t)k8[m];
      a.cv[here] = (int8_t)v8[m];
    }
  }
  if (write && threadIdx.x == 0) {
    a.cks[(lk + pos) * B + b] = __float2bfloat16(ksc);
    a.cvs[(lk + pos) * B + b] = __float2bfloat16(vsc);
  }
  // scores: s[p, h] = sum_{lanes of h} bf16(q * k8) * ksc * scale
  float sum[MAX_POS];
#pragma unroll
  for (int p = 0; p < MAX_POS; ++p) {
    sum[p] = 0.f;
    if (p <= pos) {
      float prod[LANES];
#pragma unroll
      for (int m = 0; m < LANES; ++m) {
        const int j = 32 * g + i8 + 8 * m;
        const float kk = p < pos ? (float)cs.k[p][on ? j : 0] : k8[m];
        prod[m] = bf(q[m] * kk);
      }
      sum[p] = (prod[0] + prod[2]) + (prod[1] + prod[3]);
    }
  }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
#pragma unroll
    for (int p = 0; p < MAX_POS; ++p)
      if (p <= pos) sum[p] += __shfl_xor_sync(0xffffffffu, sum[p], o);
  if (i8 == 0 && on) {
#pragma unroll
    for (int p = 0; p < MAX_POS; ++p)
      if (p <= pos) sa.hs[p][g] = sum[p];
  }
  __syncthreads();
  // softmax over the positions of each head: every (position, head) in
  // parallel, a head's maximum and denominator in position order; then the
  // value weights bf16(p * v scale) a (position, head)
  const int nh = a.n_head, np = (pos + 1) * nh;
  const float scale = 1.f / sqrtf((float)hd);
  for (int i = threadIdx.x; i < np; i += THREADS) {
    const int p = i / nh, h = i % nh;
    float t = 0.f;
    for (int w = 0; w < wph; ++w) t += sa.hs[p][h * wph + w];
    sa.e[p][h] = t * (p < pos ? cs.ks[p] : bf(ksc)) * scale;
  }
  __syncthreads();
  if (threadIdx.x < nh) {
    float m = -INFINITY;
    for (int p = 0; p <= pos; ++p) m = fmaxf(m, sa.e[p][threadIdx.x]);
    sa.mx[threadIdx.x] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += THREADS) {
    const int p = i / nh, h = i % nh;
    sa.e[p][h] = expf(sa.e[p][h] - sa.mx[h]);
  }
  __syncthreads();
  if (threadIdx.x < nh) {
    float den = 0.f;
    for (int p = 0; p <= pos; ++p) den += sa.e[p][threadIdx.x];
    sa.inv[threadIdx.x] = 1.f / den;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += THREADS) {
    const int p = i / nh, h = i % nh;
    sa.wt[p][h] = bf(sa.e[p][h] * sa.inv[h] * (p < pos ? cs.vs[p] : bf(vsc)));
  }
  __syncthreads();
  const int h = on ? 32 * g / hd : 0;      // the thread's lanes' head
  float out[LANES], omax = 0.f;
#pragma unroll
  for (int m = 0; m < LANES; ++m) out[m] = 0.f;
#pragma unroll
  for (int p = 0; p < MAX_POS; ++p) {
    if (p <= pos) {
      const float wt = sa.wt[p][h];
#pragma unroll
      for (int m = 0; m < LANES; ++m) {
        const int j = 32 * g + i8 + 8 * m;
        const float vq = p < pos ? (float)cs.v[p][on ? j : 0] : v8[m];
        out[m] += bf(wt * vq);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < LANES; ++m) {
    out[m] = bf(out[m]);
    if (on) omax = fmaxf(omax, fabsf(out[m]));
  }
  const float osc = fmaxf(block_max(omax, sa.red), 1e-8f) / 127.f;
  if (on) {
#pragma unroll
    for (int m = 0; m < LANES; ++m)
      out8[32 * g + i8 + 8 * m] = (int8_t)rintf(out[m] / osc);
  }
  if (threadIdx.x == 0) *out_s = osc;
}

// lane's 16-byte chunks of a weight row of kk <= 1024 bytes
__device__ __forceinline__ void load_row(const int8_t* wr, int kk, int lane,
                                         int4 (&v)[2]) {
  const int4 z = make_int4(0, 0, 0, 0);
  v[0] = lane * 16 < kk ? __ldg(reinterpret_cast<const int4*>(wr + lane * 16))
                        : z;
  v[1] = 512 + lane * 16 < kk
             ? __ldg(reinterpret_cast<const int4*>(wr + 512 + lane * 16)) : z;
}

// acc[m] = the warp's exact int32 dot of the row chunks with x8 row m
// (m < B <= MB: the kernel instance's rows, 1 at batch 1)
template <int MB>
__device__ __forceinline__ void dot_rows(const int4 (&v)[2],
                                         const int8_t* x8, int ldx, int kk,
                                         int B, int lane, int (&acc)[MB]) {
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int k = c * 512 + lane * 16;
    if (k < kk) {
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (m < B)
          acc[m] = dp4a16(v[c], *reinterpret_cast<const int4*>(
                                    x8 + m * ldx + k), acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < MB; ++m)
    if (m < B) acc[m] = warp_sum(acc[m]);
}

// q/k/v: one warp a column (warp gw of the grid's W takes columns gw,
// gw + W, ...), two columns in flight; out (B, 3*dim) = bf16(f32(acc) *
// xs * ws)
template <int MB>
__device__ void qkv_stream(const Args& a, const int8_t* wl, const float* sl,
                           const SmemSmall& sm) {
  const int dim = a.dim, N = 3 * dim, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = gridDim.x * WARPS, gw = blockIdx.x * WARPS + warp;
  int4 v[2][2];
  float ws[2];
  auto load = [&](int k) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int n = gw + (k + t) * W;
      ws[t] = 0.f;
      if (n < N) {
        load_row(wl + (size_t)n * dim, dim, lane, v[t]);
        ws[t] = sl[n];
      }
    }
  };
  for (int k = 0; gw + k * W < N; k += 2) {
    load(k);
    int acc[MB];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int n = gw + (k + t) * W;
      if (n >= N) break;
      dot_rows<MB>(v[t], sm.x8, dim, dim, B, lane, acc);
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (m < B && lane == m)
          a.buf[(size_t)m * N + n] =
              __float2bfloat16(bf((0.f + (float)acc[m]) * sm.xs[m] * ws[t]));
    }
  }
}

// w1/w3: a warp owns gate column n and up column n (n < 3*dim, dealt as
// q/k/v's), two pairs in flight, and writes h2 = bf16(bf16(silu(g)) * u)
// into buf (B, 3*dim); the warps' row maxima go to sm.pm, the CTA's are
// folded into a.hmax
template <int MB>
__device__ void gate_up_stream(const Args& a, const int8_t* wl,
                               const float* sl, SmemSmall& sm) {
  const int dim = a.dim, N = 3 * dim, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = gridDim.x * WARPS, gw = blockIdx.x * WARPS + warp;
  int4 vg[2][2], vu[2][2];
  float wg[2], wu[2];
  auto load = [&](int k) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int n = gw + (k + t) * W;
      wg[t] = wu[t] = 0.f;
      if (n < N) {
        load_row(wl + (size_t)(4 * dim + n) * dim, dim, lane, vg[t]);
        load_row(wl + (size_t)(7 * dim + n) * dim, dim, lane, vu[t]);
        wg[t] = sl[4 * dim + n];
        wu[t] = sl[7 * dim + n];
      }
    }
  };
  float amax[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) amax[m] = 0.f;
  for (int k = 0; gw + k * W < N; k += 2) {
    load(k);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int n = gw + (k + t) * W;
      if (n >= N) break;
      int ag[MB], au[MB];
      dot_rows<MB>(vg[t], sm.x8, dim, dim, B, lane, ag);
      dot_rows<MB>(vu[t], sm.x8, dim, dim, B, lane, au);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (m < B) {
          const float g = bf((0.f + (float)ag[m]) * sm.xs[m] * wg[t]);
          const float u = bf((0.f + (float)au[m]) * sm.xs[m] * wu[t]);
          const float sg = bf(g * (1.f / (1.f + expf(-g))));
          const float h = bf(sg * u);
          amax[m] = fmaxf(amax[m], fabsf(h));
          if (lane == m) a.buf[(size_t)m * N + n] = __float2bfloat16(h);
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MB; ++m) sm.pm[warp * SMALL_B + m] = amax[m];
  }
  __syncthreads();
  if (threadIdx.x < MB && threadIdx.x < B) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w)
      t = fmaxf(t, sm.pm[w * SMALL_B + threadIdx.x]);
    // t >= +0: its bits order as the floats do
    atomicMax(reinterpret_cast<int*>(a.hmax) + threadIdx.x, __float_as_int(t));
  }
}

// wo (nseg 1) / w2 (nseg 3, its column tiles one after another from wt),
// dim output columns: this CTA's columns are n = blockIdx.x + grid * j;
// each column's nseg segments of kseg bytes are split into ks equal parts,
// one warp a (column, segment, part) item, two items in flight; the int32
// partials are summed exactly, each segment's sum converted to f32 and
// added in segment order; then x[m, n] = bf16(res[m, n] + bf16(acc * xs *
// ws)).
template <int MB>
__device__ void splitk_stream(const Args& a, const int8_t* wt, int nseg,
                              int ks, const float* ws, const bf16* res,
                              int ldx, SmemSmall& sm) {
  const int dim = a.dim, B = a.B, kseg = dim;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = blockIdx.x < dim
      ? (dim - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int per_col = nseg * ks, plen = kseg / ks;
  const int cols_pass = MAX_ITEMS / per_col > 0 ? MAX_ITEMS / per_col : 1;
  for (int c0 = 0; c0 < ncol; c0 += cols_pass) {
    const int nc = ncol - c0 < cols_pass ? ncol - c0 : cols_pass;
    const int items = nc * per_col;
    // the epilogue's residual and channel scale, loaded ahead
    const int e0 = threadIdx.x;
    float r0 = 0.f, w0 = 0.f;
    if (e0 < nc * B) {
      const int n = blockIdx.x + gridDim.x * (c0 + e0 / B);
      r0 = ld_bf(res + (size_t)(e0 % B) * dim + n);
      w0 = ws[n];
    }
    auto src = [&](int it, int& k0) {
      const int n = blockIdx.x + gridDim.x * (c0 + it / per_col);
      const int r = it % per_col, seg = r / ks, part = r % ks;
      k0 = seg * kseg + part * plen;
      return wt + ((size_t)seg * dim + n) * dim + part * plen;
    };
    for (int it = warp; it < items; it += 2 * WARPS) {
      const int it2 = it + WARPS;          // a second item in flight
      int k0 = 0, k1 = 0;
      int4 v0[2], v1[2];
      load_row(src(it, k0), plen, lane, v0);
      if (it2 < items) load_row(src(it2, k1), plen, lane, v1);
      int acc[MB];
      dot_rows<MB>(v0, sm.x8 + k0, ldx, plen, B, lane, acc);
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (lane == m && m < B) sm.part[it * SMALL_B + m] = acc[m];
      if (it2 < items) {
        dot_rows<MB>(v1, sm.x8 + k1, ldx, plen, B, lane, acc);
#pragma unroll
        for (int m = 0; m < MB; ++m)
          if (lane == m && m < B) sm.part[it2 * SMALL_B + m] = acc[m];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nc * B; e += THREADS) {
      const int ci = e / B, m = e % B;
      const int n = blockIdx.x + gridDim.x * (c0 + ci);
      float accf = 0.f;
      for (int seg = 0; seg < nseg; ++seg) {
        int t = 0;
        for (int part = 0; part < ks; ++part)
          t += sm.part[(ci * per_col + seg * ks + part) * SMALL_B + m];
        accf += (float)t;
      }
      const bool ahead = e == e0;
      const float y = bf(accf * sm.xs[m] * (ahead ? w0 : ws[n]));
      a.x[(size_t)m * dim + n] = __float2bfloat16(
          (ahead ? r0 : ld_bf(res + (size_t)m * dim + n)) + y);
    }
    __syncthreads();
  }
}

// One layer at B <= 8
template <int MB>
__device__ void small_layer(const Args& a, int l, const int8_t* wl,
                            const float* sl, const bf16* nl, SmemBig& sb,
                            SmemAttn& sa, cg::grid_group& grid, bool last,
                            int& nb) {
  SmemSmall& sm = sb.s;
  CacheStage& cs = sb.c;
  const int dim = a.dim, B = a.B;
  const bf16* xr = l == 0 ? a.x_in : a.x;
  // (a)
  if (blockIdx.x == 0 && threadIdx.x < B) a.hmax[threadIdx.x] = 0.f;
  rms_quant_rows(a, xr, nl, sm.x8, sm.xs, sm.xrow, sa);
  __syncthreads();
  qkv_stream<MB>(a, wl, sl, sm);
  barrier(grid, a, nb);
  // (b) at B = 1 every CTA recomputes the row's attention; at B > 1 CTA m
  // computes row m's, and the outputs cross one more barrier
  if (B == 1) {
    attn_row(a, l, 0, a.buf, blockIdx.x == 0, sm.x8, &sm.xs[0], cs, sa);
  } else {
    if (blockIdx.x < B)
      attn_row(a, l, blockIdx.x, a.buf + (size_t)blockIdx.x * 3 * dim, true,
               a.x8 + blockIdx.x * dim, a.xs + blockIdx.x, cs, sa);
    barrier(grid, a, nb);
    for (int i = threadIdx.x; i < B * dim / 16; i += THREADS)
      reinterpret_cast<int4*>(sm.x8)[i] =
          __ldcg(reinterpret_cast<const int4*>(a.x8) + i);
    if (threadIdx.x < B) sm.xs[threadIdx.x] = __ldcg(a.xs + threadIdx.x);
  }
  __syncthreads();
  const size_t tile = (size_t)dim * dim;
  splitk_stream<MB>(a, wl + 3 * tile, 1, a.ks_wo, sl + 3 * dim, xr, dim, sm);
  barrier(grid, a, nb);
  // (c)
  rms_quant_rows(a, a.x, nl + dim, sm.x8, sm.xs, sm.xrow, sa);
  __syncthreads();
  gate_up_stream<MB>(a, wl, sl, sm);
  barrier(grid, a, nb);
  // (d)
  quant_h2_rows(a, sm.x8, sm.xs);
  __syncthreads();
  splitk_stream<MB>(a, wl + 10 * tile, 3, a.ks_w2, sl + 10 * dim, a.x,
                    3 * dim, sm);
  if (!last) barrier(grid, a, nb);
}

// ---------------------------------------------------------------------------
// B > 8: int8 tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int lds32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// out = A (M, nseg*kseg) int8 x W^T, W's segment s at w + s * dim^2 with
// rows of kseg bytes; f32 epilogue with the row scales as and channel
// scales ws. GATE: the gate and up products (w, w2 = up weights, one
// segment) and out = h2; else out = bf16(y) (res null) or bf16(res + y).
struct Gemm {
  const int8_t* a;
  int lda;
  const float* as;
  const int8_t* w;
  const int8_t* w2;
  const float* ws;
  const float* ws2;
  int nseg, kseg, M, N;
  const bf16* res;
  bf16* out;
  int ldo;
  size_t seg_stride;
};

template <bool GATE>
__device__ void gemm_tile(const Gemm& g, int m0, int n0, SmemTile& st) {
  constexpr int NMAT = GATE ? 2 : 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;       // 2 x 4 warps, 32 x 16 each
  const int lr = tid >> 2, lc = (tid & 3) * 16;  // loader: row, byte
  const int nks = g.kseg / TK, nk = g.nseg * nks;
  const int am = m0 + lr < g.M ? m0 + lr : g.M - 1;
  const int8_t* arow = g.a + (size_t)am * g.lda + lc;
  const int abytes = m0 + lr < g.M ? 16 : 0;     // rows past M read zeros
  const size_t wrow = (size_t)(n0 + lr) * g.kseg + lc;

  auto load = [&](int kt, int s) {
    const int seg = kt / nks, k0 = (kt % nks) * TK;
    cp_async16(&st.a[s][lr * TLD + lc], arow + seg * g.kseg + k0, abytes);
    cp_async16(&st.b[s][0][lr * TLD + lc],
               g.w + seg * g.seg_stride + wrow + k0, 16);
    if (GATE) cp_async16(&st.b[s][1][lr * TLD + lc], g.w2 + wrow + k0, 16);
    cp_commit();
  };

  int acc[NMAT][2][2][4];
  float accf[NMAT][2][2][4];
#pragma unroll
  for (int t = 0; t < NMAT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[t][i][j][r] = 0;
          accf[t][i][j][r] = 0.f;
        }
  // NST - 1 stages in flight ahead of the one being multiplied
#pragma unroll
  for (int k = 0; k < NST - 1; ++k) {
    if (k < nk)
      load(k, k);
    else
      cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<NST - 2>();
    __syncthreads();      // stage kt landed; stage kt - 1's slot is free
    if (kt + NST - 1 < nk)
      load(kt + NST - 1, (kt + NST - 1) % NST);
    else
      cp_commit();
    const int slot = kt % NST;
    const int8_t* A = st.a[slot];
#pragma unroll
    for (int kk = 0; kk < TK; kk += 32) {
      int af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r0 = A + (wm * 32 + i * 16 + gq) * TLD + kk + tq * 4;
        af[i][0] = lds32(r0);
        af[i][1] = lds32(r0 + 8 * TLD);
        af[i][2] = lds32(r0 + 16);
        af[i][3] = lds32(r0 + 8 * TLD + 16);
      }
#pragma unroll
      for (int t = 0; t < NMAT; ++t) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int8_t* c0 =
              st.b[slot][t] + (wn * 16 + j * 8 + gq) * TLD + kk + tq * 4;
          const int b0 = lds32(c0), b1 = lds32(c0 + 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_s8(acc[t][i][j], af[i], b0, b1);
        }
      }
    }
    if ((kt + 1) % nks == 0) {     // a segment's exact int32 -> f32
#pragma unroll
      for (int t = 0; t < NMAT; ++t)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              accf[t][i][j][r] += (float)acc[t][i][j][r];
              acc[t][i][j][r] = 0;
            }
    }
  }
  __syncthreads();        // every warp is done with the stages
  // The epilogue's operands, all loaded before the first store: out may
  // alias res (w2 adds into x in place), so a load after a store could not
  // be hoisted above it and each output would wait an L2 round trip.
  float xs[2][2], wn0[2][2], wn1[2][2], rv[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + gq + 8 * h;
      xs[i][h] = m < g.M ? __ldcg(g.as + m) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + wn * 16 + j * 8 + tq * 2 + c;
      wn0[j][c] = g.ws[n];
      wn1[j][c] = GATE ? g.ws2[n] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 32 + i * 16 + gq + (r >= 2 ? 8 : 0);
        const int n = n0 + wn * 16 + j * 8 + tq * 2 + (r & 1);
        rv[i][j][r] = !GATE && g.res && m < g.M
                          ? ld_bf(g.res + (size_t)m * g.ldo + n) : 0.f;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 32 + i * 16 + gq + (r >= 2 ? 8 : 0);
        const int n = n0 + wn * 16 + j * 8 + tq * 2 + (r & 1);
        if (m >= g.M) continue;
        const float x = xs[i][r >> 1];
        const float y = bf(accf[0][i][j][r] * x * wn0[j][r & 1]);
        bf16* o = g.out + (size_t)m * g.ldo + n;
        if (GATE) {
          const float u = bf(accf[NMAT - 1][i][j][r] * x * wn1[j][r & 1]);
          const float sg = bf(y * (1.f / (1.f + expf(-y))));
          *o = __float2bfloat16(bf(sg * u));
        } else if (g.res) {
          *o = __float2bfloat16(rv[i][j][r] + y);
        } else {
          *o = __float2bfloat16(y);
        }
      }
}

// tiles over the CTAs, tile t to CTA t % grid, the row tile fastest
template <bool GATE>
__device__ void gemm_tiles(const Gemm& g, SmemTile& st) {
  const int mt = (g.M + TM - 1) / TM, n_tiles = mt * (g.N / TN);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
    gemm_tile<GATE>(g, (t % mt) * TM, (t / mt) * TN, st);
}

__device__ void tiled_layer(const Args& a, int l, const int8_t* wl,
                            const float* sl, const bf16* nl, SmemBig& sb,
                            SmemAttn& sa, cg::grid_group& grid, bool last,
                            int& nb) {
  SmemTile& st = sb.t;
  CacheStage& cs = sb.c;
  const int dim = a.dim, B = a.B;
  const size_t tile = (size_t)dim * dim;
  const bf16* xr = l == 0 ? a.x_in : a.x;
  Gemm g;
  g.a = a.x8;
  g.lda = dim;
  g.as = a.xs;
  g.w2 = nullptr;
  g.ws2 = nullptr;
  g.nseg = 1;
  g.kseg = dim;
  g.M = B;
  g.seg_stride = tile;
  for (int m = blockIdx.x; m < B; m += gridDim.x)
    rms_quant_block(xr + (size_t)m * dim, nl, dim, a.eps, a.x8 + m * dim,
                    a.xs + m, sa);
  barrier(grid, a, nb);
  g.w = wl;
  g.ws = sl;
  g.N = 3 * dim;
  g.res = nullptr;
  g.out = a.buf;
  g.ldo = 3 * dim;
  gemm_tiles<false>(g, st);
  barrier(grid, a, nb);
  for (int m = blockIdx.x; m < B; m += gridDim.x)
    attn_row(a, l, m, a.buf + (size_t)m * 3 * dim, true, a.x8 + m * dim,
             a.xs + m, cs, sa);
  barrier(grid, a, nb);
  g.w = wl + 3 * tile;
  g.ws = sl + 3 * dim;
  g.N = dim;
  g.res = xr;
  g.out = a.x;
  g.ldo = dim;
  gemm_tiles<false>(g, st);
  barrier(grid, a, nb);
  for (int m = blockIdx.x; m < B; m += gridDim.x)
    rms_quant_block(a.x + (size_t)m * dim, nl + dim, dim, a.eps,
                    a.x8 + m * dim, a.xs + m, sa);
  barrier(grid, a, nb);
  g.w = wl + 4 * tile;
  g.w2 = wl + 7 * tile;
  g.ws = sl + 4 * dim;
  g.ws2 = sl + 7 * dim;
  g.N = 3 * dim;
  g.res = nullptr;
  g.out = a.buf;
  g.ldo = 3 * dim;
  gemm_tiles<true>(g, st);
  barrier(grid, a, nb);
  for (int m = blockIdx.x; m < B; m += gridDim.x)
    quant_row(a.buf + (size_t)m * 3 * dim, 3 * dim, a.x8 + m * 3 * dim,
              a.xs + m, sa);
  barrier(grid, a, nb);
  g.a = a.x8;
  g.lda = 3 * dim;
  g.w = wl + 10 * tile;
  g.w2 = nullptr;
  g.ws = sl + 10 * dim;
  g.ws2 = nullptr;
  g.nseg = 3;
  g.N = dim;
  g.res = a.x;
  g.out = a.x;
  g.ldo = dim;
  gemm_tiles<false>(g, st);
  if (!last) barrier(grid, a, nb);
}

// The kernel's three instances, each with its own register allocation:
// ONE_ROW (B = 1, the main path), ROWS (2 <= B <= 8), TILED (B > 8).
enum Path { ONE_ROW, ROWS, TILED, N_PATHS };

template <int P>
__global__ void __launch_bounds__(THREADS, 2) sweep_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  SmemBig& sb = *reinterpret_cast<SmemBig*>(smem);
  __shared__ SmemAttn sa;
  cg::grid_group grid = cg::this_grid();
  if (a.trace && threadIdx.x == 0) a.trace[blockIdx.x] = gtime();
  int nb = 0;
  const size_t layer = (size_t)N_TILES * a.dim * a.dim;
  for (int l = 0; l < a.L; ++l) {
    const int8_t* wl = a.w + l * layer;
    const float* sl = a.s + (size_t)l * N_TILES * a.dim;
    const bf16* nl = a.norms + (size_t)l * 2 * a.dim;
    const bool last = l + 1 == a.L;
    if constexpr (P == TILED)
      tiled_layer(a, l, wl, sl, nl, sb, sa, grid, last, nb);
    else
      small_layer<P == ONE_ROW ? 1 : SMALL_B>(a, l, wl, sl, nl, sb, sa, grid,
                                              last, nb);
  }
  if (a.trace) {
    __syncthreads();
    if (threadIdx.x == 0)
      a.trace[(size_t)(1 + 2 * nb) * gridDim.x + blockIdx.x] = gtime();
  }
}

void (*const KERNELS[N_PATHS])(Args) = {
    sweep_kernel<ONE_ROW>, sweep_kernel<ROWS>, sweep_kernel<TILED>};

constexpr int MAX_DEVICES = 64;
int g_resident[MAX_DEVICES];   // co-resident CTAs a device, 0: not yet known

// the fewest co-resident CTAs an SM over the instances
int resident(int* n_sm, int* per_sm) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *per_sm = 1 << 30;
  for (int p = 0; p < N_PATHS; ++p) {
    int k = 0;
    e = cudaFuncSetAttribute(KERNELS[p],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(SmemBig));
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, KERNELS[p], THREADS,
                                                      sizeof(SmemBig));
    if (e != cudaSuccess) return (int)e;
    if (k < *per_sm) *per_sm = k;
  }
  if (*n_sm * *per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (dev < MAX_DEVICES) g_resident[dev] = *n_sm * *per_sm;
  return 0;
}

}  // namespace

// The card's SM count and the sweep kernel's co-resident CTAs an SM (its
// cooperative grid is their product).
extern "C" int fast_sweep_grid(int* n_sm, int* per_sm) {
  return resident(n_sm, per_sm);
}

// The threads of a sweep CTA, which fix the order of its sums (the plain
// twin's THREADS in ops/fast_fused.py must equal it). No launch.
extern "C" int fast_sweep_threads() { return THREADS; }

// x_in: (B, dim) bf16; x_out: (B, dim) bf16, the result; w (L, 13, dim,
// dim) int8; s (L, 13, dim) f32; norms (L, 2, dim) bf16; freqs (>= K,
// head_dim / 2, 2) bf16, 16-byte aligned; cache ck/cv (L, K, B, dim) int8,
// cks/cvs (L, K, B) bf16. Scratch: x8 (B, 3*dim) int8, xs (B) f32, buf (B,
// 3*dim) bf16, hmax (B) f32.
// trace: null, or u64 (2 * barriers + 2, grid), the barrier times (ns).
// grid: at most the co-resident CTAs (fast_sweep_grid); ks_wo, ks_w2: the
// K parts a segment of wo / w2 at B <= 8. One cooperative launch.
extern "C" int fast_sweep(void* x_in, void* x_out, const void* w,
                          const void* s, const void* norms, const void* freqs,
                          void* ck, void* cv, void* cks, void* cvs, void* x8,
                          void* xs, void* buf, void* hmax, void* trace,
                          int B, int dim, int L, int K, int pos, int n_head,
                          int grid, int ks_wo, int ks_w2, float eps,
                          void* stream) {
  if (B < 1 || L < 1 || dim % 64 || dim > MAX_DIM || n_head < 1 ||
      dim % n_head || (dim / n_head) % 32 || pos < 0 || pos >= MAX_POS ||
      pos >= K || grid < 1 || ks_wo < 1 || ks_wo > WARPS || ks_w2 < 1 ||
      ks_w2 > WARPS || dim % (16 * ks_wo) || dim % (16 * ks_w2) ||
      (uintptr_t)freqs % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_resident[dev]) {
    int n_sm = 0, per_sm = 0;
    const int r = resident(&n_sm, &per_sm);
    if (r) return r;
  }
  // a larger grid could not be co-resident: its barrier would never clear
  if (grid > g_resident[dev]) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args a;
  a.x_in = (const bf16*)x_in;
  a.x = (bf16*)x_out;
  a.w = (const int8_t*)w;
  a.s = (const float*)s;
  a.norms = (const bf16*)norms;
  a.freqs = (const bf16*)freqs;
  a.ck = (int8_t*)ck;
  a.cv = (int8_t*)cv;
  a.cks = (bf16*)cks;
  a.cvs = (bf16*)cvs;
  a.x8 = (int8_t*)x8;
  a.xs = (float*)xs;
  a.buf = (bf16*)buf;
  a.hmax = (float*)hmax;
  a.trace = (unsigned long long*)trace;
  a.ks_wo = ks_wo;
  a.ks_w2 = ks_w2;
  a.B = B;
  a.dim = dim;
  a.L = L;
  a.K = K;
  a.pos = pos;
  a.n_head = n_head;
  a.eps = eps;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = sizeof(SmemBig);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int path = B == 1 ? ONE_ROW : B <= SMALL_B ? ROWS : TILED;
  e = cudaLaunchKernelEx(&cfg, KERNELS[path], a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Vocoder residual-unit stacks and decoder blocks with int8 weights (the
// VOC_QUANT vocoder) on int8 tensor cores (mma.sync m16n8k32 s8).
//
// Replaces, for int8 packs (pack_res_stack quant=True):
//   fish_speech_tpu/ops/voc_fused.py::fused_res_stack (kernel body
//     _res_stack_kernel, _run_units' int8 branch) -> voc_res_stack_i8 (one
//     unit per call, as the 768-channel decoder block runs it);
//   fish_speech_tpu/ops/voc_fused.py::fused_block (kernel body
//     _block_kernel, its int8 transposed conv) -> voc_block_i8.
//
// The function. Weights are int8 per output channel. Each snake output is
// quantized with ONE scale per TPU-kernel tile: m = max(max|s|, 1e-12)
// over every row of the tile (its halo rows included), codes
// trunc(s * (127/m) +- 0.5); products sum in int32 and are rescaled as
// f32(acc) * (colscale * (m * (1/127))) + bias. A tile is tt output rows
// plus `halo` rows of left context, and every tile recomputes its halo with
// its own scales, so the same global row holds different values in two
// tiles: the state is kept per tile, never per global row. The transposed
// conv's input slab ((halo+tt)/stride + 1 rows) is quantized as one tile as
// well. The build passes -fmad=false, so the snake polynomial, the
// quantization's s*k + 0.5 and the rescale round as the plain PyTorch twin's
// separate operations do, and the int8 codes and int32 sums can be equal.
//
// What bounds them on the H100: operations. A unit at C channels costs
// 2 x 8 x C^2 int8 operations per row of a tile (its halo rows included);
// for 128 frames the four decoder blocks need ~0.8 TOP, ~0.4 ms at the
// 1979 TOP/s int8 roof, and move well under 1 GB.
//
// Design (simple first). A tile's bf16 state (halo+tt rows x C, 400-480 KB
// at S2-Pro widths) does not fit one CTA's shared memory, and each scale is
// a reduction over the whole tile between two products. So the state lives
// in a tile-expanded scratch (B * n_tiles, halo+tt, C) in device memory and
// each unit is three launches over 16-row chunks of every tile:
//   snake_amax: the tile's max |snake(state)|, combined across CTAs with
//     atomicMax on the float's bits (the values are >= 0);
//   conv7: quantize the snake, the dilated k7 conv as int8 x int8 -> int32
//     (mma.sync, weights read as (out, in) rows from L2), rescale, bias,
//     second snake into an f32 scratch, and its tile max;
//   conv1: quantize that, the 1x1 conv, rescale, bias, residual into the
//     bf16 state in place.
// Chunks are aligned to the tile's end; rows that the unit drops (the first
// 6*d of the valid rows) are neither written nor counted in a max. The
// block first builds the state with the transposed conv (slab max, then two
// phase products per 16-row chunk of the slab), the res stack by copying
// the tile windows of x; last, the tile's tt rows go out through the tail
// snake, or through the final k7 conv (C -> 1) and tanh. Not yet done: one
// cluster of CTAs per tile sharing its state in distributed shared memory,
// wgmma, weights staged in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int NTHR = 256, NWARP = NTHR / 32;
constexpr int ROWS = 16;            // rows of a chunk (the mma's M)
constexpr int PAD = 16;             // bytes of padding of an int8 smem row
constexpr int SMEM_LIMIT = 227 * 1024;
// f32(1/127) as Python and JAX round it (from the double quotient)
#define INV127 ((float)(1.0 / 127.0))

__device__ __forceinline__ float b2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 f2b(float x) { return __float2bfloat16(x); }

// x + sin^2(alpha x) / (alpha + eps) with alpha_pi = alpha / pi
__device__ __forceinline__ float snake(float x, float alpha_pi, float inv) {
  const float y = alpha_pi * x;
  const float t = y - (float)(int)y;
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

// the tile scale's code: round half away from zero (the cast truncates)
__device__ __forceinline__ int8_t quant8(float s, float k) {
  return (int8_t)(int)(s * k + (s >= 0.f ? 0.5f : -0.5f));
}

__device__ __forceinline__ float tile_m(const float* amax, int tile) {
  return fmaxf(amax[tile], 1e-12f);
}

// max over the CTA of v >= 0, folded into *dst (every thread must call)
__device__ void block_max_to(float* dst, float v) {
  __shared__ float red[NWARP];
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < NWARP; ++w) m = fmaxf(m, red[w]);
    atomicMax(reinterpret_cast<int*>(dst), __float_as_int(m));
  }
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c (16 x 8, s32) += a (16 x 32, s8, row) * b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc (16 x N) = sum over taps t of A_t (16 x K) @ Bt[t]^T, A_t the 16 rows
// of the int8 smem tile A starting at row t * shift (row stride lda bytes),
// Bt (taps, N, K) int8 in device memory; epi(row, col, acc) per element.
// Warps take 8-column tiles in turn. N % 8 == 0, K % 32 == 0.
template <typename Epi>
__device__ void gemm16(const int8_t* A, int lda, int shift,
                       const int8_t* __restrict__ Bt, int taps, int N, int K,
                       Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  for (int nt = warp; nt < N / 8; nt += NWARP) {
    int c[4] = {0, 0, 0, 0};
    for (int tap = 0; tap < taps; ++tap) {
      const int8_t* a = A + tap * shift * lda;
      const int8_t* bn = Bt + ((size_t)tap * N + nt * 8 + g) * K;
      for (int k0 = 0; k0 < K; k0 += 32) {
        mma_s8(c, ld32(a + g * lda + k0 + t4),
               ld32(a + (g + 8) * lda + k0 + t4),
               ld32(a + g * lda + k0 + 16 + t4),
               ld32(a + (g + 8) * lda + k0 + 16 + t4), ld32(bn + k0 + t4),
               ld32(bn + k0 + 16 + t4));
      }
    }
    const int col = nt * 8 + (lane & 3) * 2;
    epi(g, col, c[0]);
    epi(g, col + 1, c[1]);
    epi(g + 8, col, c[2]);
    epi(g + 8, col + 1, c[3]);
  }
}

// ------------------------------------------------------------- the state

// st[tile] = the tile's window of x: rows [j*tt - halo, j*tt + tt), zero
// before the sequence start (the res stack's input)
__global__ void __launch_bounds__(NTHR) gather_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ st, int T, int C,
    int n_tiles, int tt, int halo) {
  const int tile = blockIdx.y, b = tile / n_tiles, j = tile % n_tiles;
  const int R = halo + tt, r0 = blockIdx.x * ROWS;
  for (int e = threadIdx.x; e < ROWS * C; e += NTHR) {
    const int r = r0 + e / C, c = e % C;
    if (r >= R) break;
    const int g = j * tt - halo + r;
    st[((size_t)tile * R + r) * C + c] =
        g >= 0 ? x[((size_t)b * T + g) * C + c] : f2b(0.f);
  }
}

// the block's transposed-conv input slab of each tile: input rows
// [j*tt_in - lead, j*tt_in - lead + n_slab), lead = halo/stride + 1, zero
// before the sequence start; its max |x|
__global__ void __launch_bounds__(NTHR) slab_amax_kernel(
    const bf16* __restrict__ x, int T_in, int C_in, int n_tiles, int tt_in,
    int lead, int n_slab, float* amax) {
  const int tile = blockIdx.y, b = tile / n_tiles, j = tile % n_tiles;
  const int i0 = blockIdx.x * ROWS;
  float m = 0.f;
  for (int e = threadIdx.x; e < ROWS * C_in; e += NTHR) {
    const int i = i0 + e / C_in, c = e % C_in;
    const int g = j * tt_in - lead + i;
    if (i < n_slab && g >= 0 && g < T_in)
      m = fmaxf(m, fabsf(b2f(x[((size_t)b * T_in + g) * C_in + c])));
  }
  block_max_to(amax + tile, m);
}

// state row r = rr*stride + p, channel c (column cc = p*C + c of the phase
// products) = x[rr + 1 of the slab] @ pw0 + x[rr] @ pw1, rescaled, + bias;
// zero for rows before the sequence start
__global__ void __launch_bounds__(NTHR) tconv_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ st,
    const int8_t* __restrict__ pwt, const float* __restrict__ pb,
    const float* __restrict__ amax, int T_in, int C_in, int C, int s,
    int n_tiles, int tt, int halo) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* A = reinterpret_cast<int8_t*>(smem);
  const int lda = C_in + PAD;
  const int tile = blockIdx.y, b = tile / n_tiles, j = tile % n_tiles;
  const int R = halo + tt, n_in = R / s, tt_in = tt / s, lead = halo / s + 1;
  const int rr0 = blockIdx.x * ROWS;
  const float m = tile_m(amax, tile), k = 127.f / m;
  for (int e = threadIdx.x; e < (ROWS + 1) * C_in; e += NTHR) {
    const int i = e / C_in, c = e % C_in;
    const int g = j * tt_in - lead + rr0 + i;
    int8_t q = 0;
    if (rr0 + i <= n_in && g >= 0 && g < T_in)
      q = quant8(b2f(x[((size_t)b * T_in + g) * C_in + c]), k);
    A[i * lda + c] = q;
  }
  __syncthreads();
  const float msc = m * INV127;
  const int sC = s * C;
  bf16* out = st + (size_t)tile * R * C;
  // tap 0: slab rows rr + 1 with pw0; tap 1: rows rr with pw1
  gemm16(A + lda, lda, -1, pwt, 2, sC, C_in, [&](int rr, int cc, int acc) {
    const int row = rr0 + rr;
    if (row >= n_in) return;
    const float val = (float)acc * (pb[sC + cc] * msc) + pb[cc];
    const int r = row * s + cc / C, c = cc % C;
    out[(size_t)r * C + c] = f2b(j * tt + r - halo >= 0 ? val : 0.f);
  });
}

// ------------------------------------------------------------- one unit

// max |snake(state)| over the valid rows [v, R) of each tile
__global__ void __launch_bounds__(NTHR) snake_amax_kernel(
    const bf16* __restrict__ st, int R, int C, int v,
    const float* __restrict__ vec, float* amax) {
  const int tile = blockIdx.y, r0 = v + blockIdx.x * ROWS;
  const bf16* base = st + (size_t)tile * R * C;
  float m = 0.f;
  for (int e = threadIdx.x; e < ROWS * C; e += NTHR) {
    const int r = r0 + e / C, c = e % C;
    if (r < R)
      m = fmaxf(m, fabsf(snake(b2f(base[(size_t)r * C + c]), vec[c],
                               vec[C + c])));
  }
  block_max_to(amax + tile, m);
}

// rows [v + 6d, R): s2 = snake2(f32(q7 conv) * (s7 * m1/127) + b1) into the
// f32 scratch, and its tile max into m2
__global__ void __launch_bounds__(NTHR) conv7_kernel(
    const bf16* __restrict__ st, float* __restrict__ s2, int R, int C, int v,
    int d, const int8_t* __restrict__ w7t, const float* __restrict__ vec,
    const float* __restrict__ m1, float* m2) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* A = reinterpret_cast<int8_t*>(smem);
  const int lda = C + PAD, rf = 6 * d;
  const int tile = blockIdx.y, r0 = R - ROWS * (blockIdx.x + 1);
  const bf16* base = st + (size_t)tile * R * C;
  const float m = tile_m(m1, tile), k = 127.f / m;
  for (int e = threadIdx.x; e < (ROWS + rf) * C; e += NTHR) {
    const int i = e / C, c = e % C, r = r0 - rf + i;
    int8_t q = 0;
    if (r >= v)
      q = quant8(snake(b2f(base[(size_t)r * C + c]), vec[c], vec[C + c]), k);
    A[i * lda + c] = q;
  }
  __syncthreads();
  const float msc = m * INV127;
  float* s2b = s2 + (size_t)tile * R * C;
  float lmax = 0.f;
  gemm16(A, lda, d, w7t, 7, C, C, [&](int rr, int c, int acc) {
    const int r = r0 + rr;
    if (r < v + rf) return;
    const float val = (float)acc * (vec[6 * C + c] * msc) + vec[4 * C + c];
    const float sv = snake(val, vec[2 * C + c], vec[3 * C + c]);
    s2b[(size_t)r * C + c] = sv;
    lmax = fmaxf(lmax, fabsf(sv));
  });
  block_max_to(m2 + tile, lmax);
}

// rows [v, R) (v: after this unit): state += f32(q1 conv) * (s1 * m2/127)
// + b2, rounded to bf16
__global__ void __launch_bounds__(NTHR) conv1_kernel(
    bf16* __restrict__ st, const float* __restrict__ s2, int R, int C, int v,
    const int8_t* __restrict__ w1t, const float* __restrict__ vec,
    const float* __restrict__ m2) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* A = reinterpret_cast<int8_t*>(smem);
  const int lda = C + PAD;
  const int tile = blockIdx.y, r0 = R - ROWS * (blockIdx.x + 1);
  const float* s2b = s2 + (size_t)tile * R * C;
  bf16* base = st + (size_t)tile * R * C;
  const float m = tile_m(m2, tile), k = 127.f / m;
  for (int e = threadIdx.x; e < ROWS * C; e += NTHR) {
    const int i = e / C, c = e % C, r = r0 + i;
    A[i * lda + c] = r >= v ? quant8(s2b[(size_t)r * C + c], k) : 0;
  }
  __syncthreads();
  const float msc = m * INV127;
  gemm16(A, lda, 0, w1t, 1, C, C, [&](int rr, int c, int acc) {
    const int r = r0 + rr;
    if (r < v) return;
    const float y = (float)acc * (vec[7 * C + c] * msc) + vec[5 * C + c];
    bf16* p = base + (size_t)r * C + c;
    *p = f2b(b2f(*p) + y);
  });
}

// ------------------------------------------------------------- the output

// y[b, j*tt + rr] = the tile's row halo + rr, through the tail snake
__global__ void __launch_bounds__(NTHR) out_kernel(
    const bf16* __restrict__ st, bf16* __restrict__ y, int C, int n_tiles,
    int tt, int halo, const float* __restrict__ tail) {
  const int tile = blockIdx.y, b = tile / n_tiles, j = tile % n_tiles;
  const int R = halo + tt, rr0 = blockIdx.x * ROWS;
  const size_t T = (size_t)n_tiles * tt;
  for (int e = threadIdx.x; e < ROWS * C; e += NTHR) {
    const int rr = rr0 + e / C, c = e % C;
    if (rr >= tt) break;
    bf16 o = st[((size_t)tile * R + halo + rr) * C + c];
    if (tail) o = f2b(snake(b2f(o), tail[c], tail[C + c]));
    y[((size_t)b * T + (size_t)j * tt + rr) * C + c] = o;
  }
}

// the decoder-final k7 conv (C -> 1) and tanh over the tile's rows
// [halo - 6, R) through the tail snake; one warp per output row
__global__ void __launch_bounds__(NTHR) final_kernel(
    const bf16* __restrict__ st, bf16* __restrict__ wave, int C,
    int n_tiles, int tt, int halo, const float* __restrict__ tail,
    const float* __restrict__ fw) {
  const int tile = blockIdx.y, b = tile / n_tiles, j = tile % n_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rr = blockIdx.x * NWARP + warp;
  if (rr >= tt) return;
  const int R = halo + tt, r = halo + rr;
  const bf16* base = st + (size_t)tile * R * C;
  float acc = 0.f;
  for (int c = lane; c < C; c += 32)
    for (int i = 0; i < 7; ++i) {
      float xv = b2f(base[(size_t)(r - 6 + i) * C + c]);
      if (tail) xv = b2f(f2b(snake(xv, tail[c], tail[C + c])));
      acc += xv * fw[i * C + c];
    }
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0)
    wave[(size_t)b * n_tiles * tt + (size_t)j * tt + rr] =
        f2b(tanhf(acc + fw[7 * C]));
}

// ------------------------------------------------------------- launches

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

size_t conv7_smem(int C, int d) { return (size_t)(ROWS + 6 * d) * (C + PAD); }

// the unit u (dilation d) on rows [v, R) of every tile; amax holds its two
// tile maxima (m1, m2), zeroed by the caller
cudaError_t run_unit(bf16* st, float* s2, int n, int R, int C, int v, int d,
                     const int8_t* w7t, const int8_t* w1t, const float* vec,
                     float* amax, cudaStream_t stream) {
  const int rf = 6 * d;
  snake_amax_kernel<<<dim3(cdiv(R - v, ROWS), n), NTHR, 0, stream>>>(
      st, R, C, v, vec, amax);
  const size_t smem = conv7_smem(C, d);
  // the shared-memory limit is raised only when a call needs more than
  // any call before it
  static size_t raised = 48 * 1024;
  if (smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    raised = smem;
  }
  conv7_kernel<<<dim3(cdiv(R - v - rf, ROWS), n), NTHR, smem, stream>>>(
      st, s2, R, C, v, d, w7t, vec, amax, amax + n);
  conv1_kernel<<<dim3(cdiv(R - v - rf, ROWS), n), NTHR,
                 (size_t)ROWS * (C + PAD), stream>>>(
      st, s2, R, C, v + rf, w1t, vec, amax + n);
  return cudaGetLastError();
}

}  // namespace

// One residual unit (dilation d) of an int8 pack over x (B, T, C) bf16 ->
// y, in the TPU kernel's tiles of tt rows with halo rows of left context.
// w7t (7, C, C) and w1t (C, C) are the weights as (out, in); vec (8, C);
// tail (2, C) or null. Scratch: st (B*T/tt, halo+tt, C) bf16, s2 the same
// in f32, amax (2, B*T/tt) f32 zeroed.
extern "C" int voc_res_stack_i8(const void* x, void* y, const void* w7t,
                                const void* w1t, const void* vec,
                                const void* tail, void* st, void* s2,
                                void* amax, int B, int T, int C, int d,
                                int tt, int halo, int has_tail,
                                void* stream) {
  if (B < 1 || tt < 1 || T % tt || C % 32 || d < 1 || halo < 6 * d ||
      conv7_smem(C, d) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = T / tt, n = B * n_tiles, R = halo + tt;
  gather_kernel<<<dim3(cdiv(R, ROWS), n), NTHR, 0, s>>>(
      (const bf16*)x, (bf16*)st, T, C, n_tiles, tt, halo);
  cudaError_t err = run_unit((bf16*)st, (float*)s2, n, R, C, 0, d,
                             (const int8_t*)w7t, (const int8_t*)w1t,
                             (const float*)vec, (float*)amax, s);
  if (err != cudaSuccess) return (int)err;
  out_kernel<<<dim3(cdiv(tt, ROWS), n), NTHR, 0, s>>>(
      (const bf16*)st, (bf16*)y, C, n_tiles, tt, halo,
      has_tail ? (const float*)tail : nullptr);
  return (int)cudaGetLastError();
}

// One decoder block of an int8 pack: x (B, T_in, C_in) bf16 -> y (B,
// T_in*stride, C), or with final != 0 the (B, T_in*stride) waveform through
// fw (8, C). pwt (2, stride*C, C_in) are the phase weights as (out, in), pb
// (2, stride*C) the bias and the phase scales / 127; w7t (3, 7, C, C), w1t
// (3, C, C), vec (3, 8, C). Scratch as voc_res_stack_i8, amax (7, B*T/tt).
extern "C" int voc_block_i8(const void* x, void* y, const void* pwt,
                            const void* pb, const void* w7t, const void* w1t,
                            const void* vec, const void* tail, const void* fw,
                            void* st, void* s2, void* amax, int B, int T_in,
                            int C_in, int C, int stride, int d0, int d1,
                            int d2, int tt, int halo, int final_conv,
                            void* stream) {
  const int dil[3] = {d0, d1, d2};
  const int T = T_in * stride;
  int rf = 0;
  for (int u = 0; u < 3; ++u) rf += 6 * dil[u];
  if (B < 1 || stride < 1 || tt < 1 || T % tt || tt % stride ||
      halo % stride || C % 32 || C_in % 32 || halo < rf + (final_conv ? 6 : 0))
    return (int)cudaErrorInvalidValue;
  for (int u = 0; u < 3; ++u)
    if (dil[u] < 1 || conv7_smem(C, dil[u]) > SMEM_LIMIT)
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = T / tt, n = B * n_tiles, R = halo + tt;
  const int n_in = R / stride;
  float* am = (float*)amax;
  slab_amax_kernel<<<dim3(cdiv(n_in + 1, ROWS), n), NTHR, 0, s>>>(
      (const bf16*)x, T_in, C_in, n_tiles, tt / stride, halo / stride + 1,
      n_in + 1, am);
  tconv_kernel<<<dim3(cdiv(n_in, ROWS), n), NTHR,
                 (size_t)(ROWS + 1) * (C_in + PAD), s>>>(
      (const bf16*)x, (bf16*)st, (const int8_t*)pwt, (const float*)pb, am,
      T_in, C_in, C, stride, n_tiles, tt, halo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int v = 0;
  for (int u = 0; u < 3; ++u) {
    err = run_unit((bf16*)st, (float*)s2, n, R, C, v, dil[u],
                   (const int8_t*)w7t + (size_t)u * 7 * C * C,
                   (const int8_t*)w1t + (size_t)u * C * C,
                   (const float*)vec + (size_t)u * 8 * C, am + (1 + 2 * u) * n,
                   s);
    if (err != cudaSuccess) return (int)err;
    v += 6 * dil[u];
  }
  const float* tl = tail ? (const float*)tail : nullptr;
  if (final_conv)
    final_kernel<<<dim3(cdiv(tt, NWARP), n), NTHR, 0, s>>>(
        (const bf16*)st, (bf16*)y, C, n_tiles, tt, halo, tl,
        (const float*)fw);
  else
    out_kernel<<<dim3(cdiv(tt, ROWS), n), NTHR, 0, s>>>(
        (const bf16*)st, (bf16*)y, C, n_tiles, tt, halo, tl);
  return (int)cudaGetLastError();
}

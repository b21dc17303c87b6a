// Vocoder residual-unit stacks on bf16 tensor cores (nvcuda::wmma).
//
// Replaces:
//   fish_speech_tpu/ops/voc_fused.py::fused_res_stack (kernel body
//     _res_stack_kernel) -> voc_res_stack below (one unit per call, as the
//     768-channel decoder block runs it);
//   fish_speech_tpu/ops/voc_fused.py::fused_block (kernel body
//     _block_kernel, shared _run_units) -> voc_block below.
//
// What bounds them on the H100: operations. A residual unit at C channels
// costs 2 x 8 x C^2 flops per time row against ~4 x C bytes of activation
// traffic; for 128 frames the four decoder blocks need ~0.7 TFLOP, ~0.7 ms
// at the 989 TFLOP/s bf16 roof, and move well under 1 GB.
//
// Design (simple first). A unit is snake -> causal k7 conv (dilation d) ->
// snake -> 1x1 conv -> residual. Each conv is a GEMM on 16-row chunks:
// the A operand (snake of the state) sits in shared memory, the weights
// are read as wmma B fragments straight from global memory (L2-resident),
// and the accumulators go through a per-warp f32 scratch tile for the bias,
// the second snake and the residual add.
//   voc_res_stack: one CTA per (16-row chunk, batch row), input and
//     residual read from global memory; the k7 conv's left context of 6d
//     rows is re-read per chunk (zero before the sequence start).
//   voc_block: one CTA per (time tile, batch row) holds the block's state
//     for the tile plus a left halo of 6*(1+3+9) rows (plus 6 for the final
//     k7 conv, rounded up to 16) in shared memory: the transposed conv
//     (k = 2*stride) is computed into it as two phase GEMMs, the three
//     units update it in place (chunks walked from the bottom up, so a
//     chunk never reads a row already updated), then the next block's
//     entry snake (tail) and, on the last block, the final k7 conv and tanh
//     write the output. Rows before the sequence start model zero padding
//     after the transposed conv, as in the TPU kernel.
// Snake uses the TPU kernel's degree-7 polynomial for sin^2 with alpha/pi
// premultiplied, so both agree to f32 rounding. Not yet done: wgmma, TMA
// and weight reuse across chunks from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;
constexpr int NTHR = 256, NWARP = NTHR / 32;
constexpr int SMEM_LIMIT = 227 * 1024;

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

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// s2c (16 x C) = bf16(snake(b1 + sum_i sbuf[i*d : i*d+16) @ w7[i], a2))
__device__ void conv7_snake(const bf16* sbuf, const bf16* __restrict__ w7,
                            int d, int C, const float* __restrict__ vec,
                            bf16* s2c, float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sw = scratch + warp * 256;
  const float* a2 = vec + 2 * C;
  const float* ia2 = vec + 3 * C;
  const float* b1 = vec + 4 * C;
  for (int nt = warp; nt < C / 16; nt += NWARP) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int i = 0; i < 7; ++i) {
      const bf16* arow = sbuf + (size_t)i * d * C;
      const bf16* wi = w7 + (size_t)i * C * C + nt * 16;
      for (int kt = 0; kt < C / 16; ++kt) {
        FragA a;
        FragB bm;
        wmma::load_matrix_sync(a, arow + kt * 16, C);
        wmma::load_matrix_sync(bm, wi + (size_t)kt * 16 * C, C);
        wmma::mma_sync(acc, a, bm, acc);
      }
    }
    wmma::store_matrix_sync(sw, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = nt * 16 + (e & 15);
      s2c[r * C + c] = f2b(snake(sw[e] + b1[c], a2[c], ia2[c]));
    }
    __syncwarp();
  }
}

// y (16 x C) = s2c @ w1 + b2, handed to epi(row, channel, y)
template <typename Epi>
__device__ void conv1x1(const bf16* s2c, const bf16* __restrict__ w1, int C,
                        const float* __restrict__ vec, float* scratch,
                        Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sw = scratch + warp * 256;
  const float* b2 = vec + 5 * C;
  for (int nt = warp; nt < C / 16; nt += NWARP) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kt = 0; kt < C / 16; ++kt) {
      FragA a;
      FragB bm;
      wmma::load_matrix_sync(a, s2c + kt * 16, C);
      wmma::load_matrix_sync(bm, w1 + (size_t)kt * 16 * C + nt * 16, C);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(sw, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = nt * 16 + (e & 15);
      epi(r, c, sw[e] + b2[c]);
    }
    __syncwarp();
  }
}

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// ---------------------------------------------------------------- res stack

__global__ void __launch_bounds__(NTHR) res_unit_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ y,
    const bf16* __restrict__ w7, const bf16* __restrict__ w1,
    const float* __restrict__ vec, const float* __restrict__ tail, int T,
    int C, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows_in = 16 + 6 * d;
  bf16* sbuf = (bf16*)smem;
  bf16* s2c = (bf16*)(smem + align128((size_t)rows_in * C * 2));
  float* scratch = (float*)((unsigned char*)s2c + align128((size_t)16 * C * 2));
  const int b = blockIdx.y, r0 = blockIdx.x * 16;
  const bf16* xb = x + (size_t)b * T * C;
  bf16* yb = y + (size_t)b * T * C;
  for (int e = threadIdx.x; e < rows_in * C; e += NTHR) {
    const int i = e / C, c = e % C;
    const int g = r0 - 6 * d + i;
    const float v = (g >= 0 && g < T) ? b2f(xb[(size_t)g * C + c]) : 0.f;
    sbuf[e] = f2b(snake(v, vec[c], vec[C + c]));
  }
  __syncthreads();
  conv7_snake(sbuf, w7, d, C, vec, s2c, scratch);
  __syncthreads();
  conv1x1(s2c, w1, C, vec, scratch, [&](int r, int c, float v) {
    const int g = r0 + r;
    if (g >= T) return;
    float o = b2f(f2b(b2f(xb[(size_t)g * C + c]) + v));
    if (tail) o = b2f(f2b(snake(o, tail[c], tail[C + c])));
    yb[(size_t)g * C + c] = f2b(o);
  });
}

size_t res_unit_smem(int C, int d) {
  return align128((size_t)(16 + 6 * d) * C * 2) +
         align128((size_t)16 * C * 2) + NWARP * 256 * 4;
}

// -------------------------------------------------------------------- block

struct BlockArgs {
  const bf16* x;       // (B, T_in, C_in), entry snake already applied
  bf16* y;             // (B, T, C), or the (B, T) waveform when final
  const bf16* pw;      // (2, C_in, stride*C)  lag-0, lag-1 phase weights
  const float* pb;     // (stride*C) tconv bias tiled per phase
  const bf16* w7;      // (U, 7, C, C)
  const bf16* w1;      // (U, C, C)
  const float* vec;    // (U, 6, C)
  const float* tail;   // (2, C) or null
  const float* fw;     // (8, C): 7 final-conv taps + bias row, or null
  int T_in, C_in, C, stride, n_units, d0, d1, d2, halo, R, TT;
};

size_t block_smem(int R, int C, int C_in, int stride, int dmax) {
  const size_t sb = (size_t)(16 + 6 * dmax) * C * 2;
  const size_t xin = (size_t)(R / stride + 1) * C_in * 2;
  return align128((size_t)R * C * 2) + align128(sb > xin ? sb : xin) +
         align128((size_t)16 * C * 2) + NWARP * 256 * 4;
}

__global__ void __launch_bounds__(NTHR) block_kernel(BlockArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, C_in = a.C_in, s = a.stride, R = a.R, halo = a.halo;
  const int dmax = max(a.d0, max(a.d1, a.d2));
  const int T = a.T_in * s;
  bf16* cur = (bf16*)smem;
  bf16* sbuf = (bf16*)(smem + align128((size_t)R * C * 2));
  const size_t sb = (size_t)(16 + 6 * dmax) * C * 2;
  const size_t xin_b = (size_t)(R / s + 1) * C_in * 2;
  bf16* s2c = (bf16*)((unsigned char*)sbuf + align128(sb > xin_b ? sb : xin_b));
  float* scratch = (float*)((unsigned char*)s2c + align128((size_t)16 * C * 2));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * a.TT;

  // transposed conv into cur: output row t*s + p = x[t] @ pw0[:, p] +
  // x[t-1] @ pw1[:, p] + bias, zero before the sequence start
  const int n_in = R / s;
  const int t_lo = (t0 - halo) / s;           // exact: s | halo, s | t0
  bf16* xin = sbuf;
  const bf16* xb = a.x + (size_t)b * a.T_in * C_in;
  for (int e = threadIdx.x; e < (n_in + 1) * C_in; e += NTHR) {
    const int i = e / C_in, c = e % C_in;
    const int t = t_lo - 1 + i;
    xin[e] = (t >= 0 && t < a.T_in) ? xb[(size_t)t * C_in + c] : f2b(0.f);
  }
  __syncthreads();
  {
    const int sC = s * C, ntn = sC / 16, ntiles = (n_in / 16) * ntn;
    float* sw = scratch + warp * 256;
    for (int ti = warp; ti < ntiles; ti += NWARP) {
      const int mt = ti / ntn, nt = ti % ntn;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kt = 0; kt < C_in / 16; ++kt) {
        FragA x0, x1;
        FragB w0, w1;
        wmma::load_matrix_sync(x0, xin + (size_t)(1 + 16 * mt) * C_in + kt * 16,
                               C_in);
        wmma::load_matrix_sync(w0, a.pw + (size_t)kt * 16 * sC + nt * 16, sC);
        wmma::mma_sync(acc, x0, w0, acc);
        wmma::load_matrix_sync(x1, xin + (size_t)(16 * mt) * C_in + kt * 16,
                               C_in);
        wmma::load_matrix_sync(
            w1, a.pw + (size_t)C_in * sC + (size_t)kt * 16 * sC + nt * 16, sC);
        wmma::mma_sync(acc, x1, w1, acc);
      }
      wmma::store_matrix_sync(sw, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int rr = 16 * mt + (e >> 4), cc = nt * 16 + (e & 15);
        const int r = rr * s + cc / C, c = cc % C;
        const bool real = t0 - halo + r >= 0;
        cur[(size_t)r * C + c] = f2b(real ? sw[e] + a.pb[cc] : 0.f);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // residual units, in place; rows [v, R) are valid before each unit
  int v = 0;
  const int dil[3] = {a.d0, a.d1, a.d2};
  for (int u = 0; u < a.n_units; ++u) {
    const int d = dil[u], rf = 6 * d;
    const bf16* w7u = a.w7 + (size_t)u * 7 * C * C;
    const bf16* w1u = a.w1 + (size_t)u * C * C;
    const float* vu = a.vec + (size_t)u * 6 * C;
    for (int r0 = R - 16; r0 + 16 > v + rf; r0 -= 16) {
      for (int e = threadIdx.x; e < (16 + rf) * C; e += NTHR) {
        const int i = e / C, c = e % C;
        const int src = r0 - rf + i;
        const float xv = src >= 0 ? b2f(cur[(size_t)src * C + c]) : 0.f;
        sbuf[e] = f2b(snake(xv, vu[c], vu[C + c]));
      }
      __syncthreads();
      conv7_snake(sbuf, w7u, d, C, vu, s2c, scratch);
      __syncthreads();
      conv1x1(s2c, w1u, C, vu, scratch, [&](int r, int c, float y) {
        bf16* p = cur + (size_t)(r0 + r) * C + c;
        *p = f2b(b2f(*p) + y);
      });
      __syncthreads();
    }
    v += rf;
  }

  if (a.fw == nullptr) {
    bf16* yb = a.y + (size_t)b * T * C;
    for (int e = threadIdx.x; e < a.TT * C; e += NTHR) {
      const int rr = e / C, c = e % C;
      const int g = t0 + rr;
      if (g >= T) continue;
      float o = b2f(cur[(size_t)(halo + rr) * C + c]);
      if (a.tail) o = b2f(f2b(snake(o, a.tail[c], a.tail[C + c])));
      yb[(size_t)g * C + c] = f2b(o);
    }
    return;
  }
  // decoder-final: tail snake on rows [halo - 6, R), then k7 conv (C -> 1)
  // and tanh, one warp per output row
  if (a.tail) {
    for (int e = threadIdx.x; e < (R - halo + 6) * C; e += NTHR) {
      const int r = halo - 6 + e / C, c = e % C;
      bf16* p = cur + (size_t)r * C + c;
      *p = f2b(snake(b2f(*p), a.tail[c], a.tail[C + c]));
    }
    __syncthreads();
  }
  bf16* wave = a.y + (size_t)b * T;
  for (int rr = warp; rr < a.TT; rr += NWARP) {
    const int g = t0 + rr;
    if (g >= T) break;
    const int r = halo + rr;
    float acc = 0.f;
    for (int c = lane; c < C; c += 32)
      for (int i = 0; i < 7; ++i)
        acc += b2f(cur[(size_t)(r - 6 + i) * C + c]) * a.fw[i * C + c];
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) wave[g] = f2b(tanhf(acc + a.fw[7 * C]));
  }
}

}  // namespace

// One residual unit (dilation d) over x (B, T, C) bf16 -> y, with the
// optional tail snake (2, C) [alpha/pi, 1/(alpha+eps)].
extern "C" int voc_res_stack(const void* x, void* y, const void* w7,
                             const void* w1, const void* vec,
                             const void* tail, int B, int T, int C,
                             int n_units, int d0, int d1, int d2,
                             int has_tail, void* stream) {
  (void)d1;
  (void)d2;
  if (n_units != 1 || C % 16 || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = res_unit_smem(C, d0);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      res_unit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + 15) / 16, B);
  res_unit_kernel<<<grid, NTHR, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)y, (const bf16*)w7, (const bf16*)w1,
      (const float*)vec, has_tail ? (const float*)tail : nullptr, T, C, d0);
  return (int)cudaGetLastError();
}

// One decoder block: x (B, T_in, C_in) -> y (B, T_in*stride, C), or with
// final != 0 the (B, T_in*stride) waveform through fw (8, C).
extern "C" int voc_block(const void* x, void* y, const void* pw,
                         const void* pb, const void* w7, const void* w1,
                         const void* vec, const void* tail, const void* fw,
                         int B, int T_in, int C_in, int C, int stride,
                         int d0, int d1, int d2, int final_conv,
                         void* stream) {
  if (C % 16 || C_in % 16 || stride < 1 || 16 % stride || B < 1 ||
      T_in < 1)
    return (int)cudaErrorInvalidValue;
  BlockArgs a;
  a.x = (const bf16*)x;
  a.y = (bf16*)y;
  a.pw = (const bf16*)pw;
  a.pb = (const float*)pb;
  a.w7 = (const bf16*)w7;
  a.w1 = (const bf16*)w1;
  a.vec = (const float*)vec;
  a.tail = (const float*)tail;
  a.fw = final_conv ? (const float*)fw : nullptr;
  a.T_in = T_in;
  a.C_in = C_in;
  a.C = C;
  a.stride = stride;
  a.n_units = 3;
  a.d0 = d0;
  a.d1 = d1;
  a.d2 = d2;
  const int dmax = d0 > d1 ? (d0 > d2 ? d0 : d2) : (d1 > d2 ? d1 : d2);
  const int rf = 6 * (d0 + d1 + d2) + (final_conv ? 6 : 0);
  a.halo = (rf + 15) / 16 * 16;
  const int step = 16 * stride;
  int R = (1024 / step) * step;
  while (R - a.halo >= 16 && block_smem(R, C, C_in, stride, dmax) > SMEM_LIMIT)
    R -= step;
  if (R - a.halo < 16) return (int)cudaErrorInvalidValue;
  a.R = R;
  a.TT = R - a.halo;
  const size_t smem = block_smem(R, C, C_in, stride, dmax);
  cudaError_t err = cudaFuncSetAttribute(
      block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int T = T_in * stride;
  dim3 grid((T + a.TT - 1) / a.TT, B);
  block_kernel<<<grid, NTHR, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

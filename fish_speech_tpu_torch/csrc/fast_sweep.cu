// One whole fast-head sweep (all layers, one codebook position) with W8A8
// products and the int8 position-major fast KV cache.
//
// Replaces: fish_speech_tpu/ops/fast_fused.py::fused_fast_sweep (kernel
// body _fast_sweep_kernel).
//
// What bounds it on the H100: bytes at small batch. A sweep streams 13
// int8 (dim, dim) weight tiles per layer, 13 x 1024^2 x 28 = 381.7 MB at
// S2-Pro width (~114 us at 3.35 TB/s), against 2 x B x 381.7 M int8
// operations: the two balance near B = 256, so at the serving batch the
// int8 product rate matters as much as the bytes.
//
// Design (simple first): the TPU kernel runs the layers in order inside
// one grid; Hopper's blocks run in no order, so the host function below
// makes a short sequence of launches per layer on one stream:
//   rms_quant   RMSNorm + per-row int8 quantization (one CTA per row)
//   gemm_w8a8   tiled int8 x int8 -> int32 product (__dp4a, 32x32 tiles,
//               K in steps of 64 through shared memory), f32 rescale by
//               the row and channel scales, and an epilogue that stores
//               bf16 or adds into the residual stream; for batches of at
//               most 8 rows gemv_w8a8 instead (one warp per output column,
//               so the weight stream is spread over N / 8 CTAs)
//   fast_attn   RoPE, int8 quantization and cache write of k and v at
//               `pos`, attention over positions [0, pos], and the int8
//               quantization of the attention output (one CTA per row,
//               one thread per lane)
//   gate_quant  SiLU(gate) * up and its int8 quantization over 3*dim
// Every product the TPU kernel computes in its body is in these kernels;
// none goes to a library. The roundings follow the TPU kernel (bf16 where
// it rounds to bf16, f32 accumulation elsewhere).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// sum / max over the whole block (blockDim.x a multiple of 32, <= 1024)
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
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
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) t = fmaxf(t, red[w]);
  return t;
}

constexpr int RQ_THREADS = 256;
constexpr int MAX_DIM = 1024;

// y = bf16(bf16(x * rsqrt(mean(x^2) + eps)) * w); x8 = round(y / ys)
__global__ void __launch_bounds__(RQ_THREADS) rms_quant_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    int8_t* __restrict__ x8, float* __restrict__ xs, int dim, float eps) {
  __shared__ float red[32];
  __shared__ float y[MAX_DIM];
  const int row = blockIdx.x;
  const bf16* xr = x + (size_t)row * dim;
  float ss = 0.f;
  for (int i = threadIdx.x; i < dim; i += blockDim.x) {
    const float v = __bfloat162float(xr[i]);
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float r = 1.f / sqrtf(ss / (float)dim + eps);
  float amax = 0.f;
  for (int i = threadIdx.x; i < dim; i += blockDim.x) {
    const float v = bf(bf(__bfloat162float(xr[i]) * r) *
                       __bfloat162float(w[i]));
    y[i] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = block_max(amax, red);
  const float sc = fmaxf(amax, 1e-8f) / 127.f;
  for (int i = threadIdx.x; i < dim; i += blockDim.x)
    x8[(size_t)row * dim + i] = (int8_t)rintf(y[i] / sc);
  if (threadIdx.x == 0) xs[row] = sc;
}

constexpr int BM = 32, BN = 32, BK = 64, G_THREADS = 128;
constexpr int LDS = BK / 4 + 4;  // ints per shared row (16-byte aligned)

// out[m, n] = sum_seg f32(sum_k x8[m, seg*Kseg + k] * W_seg[n, k]) * xs[m]
//             * ws[n]; W_seg = w + seg * seg_stride, rows of Kseg bytes.
// mode 0: out[m*ldo + n] = bf16(y); mode 1: out[m*ldo + n] += bf16(y)
__global__ void __launch_bounds__(G_THREADS) gemm_w8a8_kernel(
    const int8_t* __restrict__ x8, int ldx, const float* __restrict__ xs,
    const int8_t* __restrict__ w, long long seg_stride, int nseg, int kseg,
    const float* __restrict__ ws, int M, int N, int mode,
    bf16* __restrict__ out, int ldo) {
  __shared__ __align__(16) int xs_s[BM][LDS];
  __shared__ __align__(16) int ws_s[BN][LDS];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tr = tid / 8, tc = tid % 8;
  const int lr = tid / 4, part = tid % 4;   // loader: row, 16-byte part
  float accf[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int seg = 0; seg < nseg; ++seg) {
    int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    const int8_t* wseg = w + seg * seg_stride;
    for (int k0 = 0; k0 < kseg; k0 += BK) {
      const int m = m0 + lr;
      int4 xv = make_int4(0, 0, 0, 0);
      if (m < M)
        xv = *reinterpret_cast<const int4*>(
            x8 + (size_t)m * ldx + seg * kseg + k0 + part * 16);
      *reinterpret_cast<int4*>(&xs_s[lr][part * 4]) = xv;
      *reinterpret_cast<int4*>(&ws_s[lr][part * 4]) =
          *reinterpret_cast<const int4*>(
              wseg + (size_t)(n0 + lr) * kseg + k0 + part * 16);
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < BK / 4; ++kw) {
        const int a0 = xs_s[tr][kw], a1 = xs_s[tr + 16][kw];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int bw = ws_s[tc + 8 * j][kw];
          acc[0][j] = __dp4a(a0, bw, acc[0][j]);
          acc[1][j] = __dp4a(a1, bw, acc[1][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) accf[i][j] += (float)acc[i][j];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + tr + 16 * i;
    if (m >= M) continue;
    const float xsc = xs[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc + 8 * j;
      const float y = bf(accf[i][j] * xsc * ws[n]);
      bf16* o = out + (size_t)m * ldo + n;
      *o = __float2bfloat16(mode == 0 ? y : __bfloat162float(*o) + y);
    }
  }
}

// Per row (one CTA, one thread per lane j, blockDim == dim):
// RoPE on q, k; int8 k, v written at `pos`; attention over [0, pos];
// the output row quantized for the wo product.
__global__ void __launch_bounds__(MAX_DIM) fast_attn_kernel(
    const bf16* __restrict__ qkv,       // (B, 3*dim) pre-RoPE
    const float* __restrict__ rope,     // (2, dim) cos, sin
    int8_t* __restrict__ ck, int8_t* __restrict__ cv,     // (K, B, dim)
    bf16* __restrict__ cks, bf16* __restrict__ cvs,       // (K, B)
    int B, int dim, int n_head, int pos,
    int8_t* __restrict__ a8, float* __restrict__ as) {
  __shared__ float red[32];
  __shared__ float hs[16][32];        // per (position, warp) partial scores
  const int b = blockIdx.x, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const int hd = dim / n_head, wph = hd / 32;     // warps per head
  const int h = j / hd;
  const float scale = 1.f / sqrtf((float)hd);
  const bf16* row = qkv + (size_t)b * 3 * dim;
  const float c = rope[j], s = rope[dim + j];
  const float qv = __bfloat162float(row[j]);
  const float kv = __bfloat162float(row[dim + j]);
  const float vv = __bfloat162float(row[2 * dim + j]);
  const float qp = __shfl_xor_sync(0xffffffffu, qv, 1);
  const float kp = __shfl_xor_sync(0xffffffffu, kv, 1);
  const bool even = (j & 1) == 0;
  const float q = bf(qv * c + (even ? -qp : qp) * s);
  const float kr = bf(kv * c + (even ? -kp : kp) * s);

  const float ksc = fmaxf(block_max(fabsf(kr), red) / 127.f, 1e-8f);
  const float vsc = fmaxf(block_max(fabsf(vv), red) / 127.f, 1e-8f);
  const int8_t k8 = (int8_t)rintf(kr / ksc);
  const int8_t v8 = (int8_t)rintf(vv / vsc);
  const size_t here = ((size_t)pos * B + b) * dim + j;
  ck[here] = k8;
  cv[here] = v8;
  if (j == 0) {
    cks[(size_t)pos * B + b] = __float2bfloat16(ksc);
    cvs[(size_t)pos * B + b] = __float2bfloat16(vsc);
  }
  __syncthreads();     // the cache row is visible to the reads below

  // scores: s[p, h] = sum_{lanes of h} bf16(q * k8) * ksc * scale
  for (int p = 0; p <= pos; ++p) {
    const float kk = (float)ck[((size_t)p * B + b) * dim + j];
    float prod = bf(q * kk);
    for (int o = 16; o > 0; o >>= 1)
      prod += __shfl_xor_sync(0xffffffffu, prod, o);
    if (lane == 0) hs[p][warp] = prod;
  }
  __syncthreads();
  float sc[16];
  float m = -INFINITY;
  for (int p = 0; p <= pos; ++p) {
    float t = 0.f;
    for (int w = 0; w < wph; ++w) t += hs[p][h * wph + w];
    t = t * __bfloat162float(cks[(size_t)p * B + b]) * scale;
    sc[p] = t;
    m = fmaxf(m, t);
  }
  float den = 0.f;
  for (int p = 0; p <= pos; ++p) {
    sc[p] = expf(sc[p] - m);
    den += sc[p];
  }
  const float inv = 1.f / den;
  float out = 0.f;
  for (int p = 0; p <= pos; ++p) {
    const float wt =
        bf(sc[p] * inv * __bfloat162float(cvs[(size_t)p * B + b]));
    out += bf(wt * (float)cv[((size_t)p * B + b) * dim + j]);
  }
  const float ob = bf(out);
  const float osc = fmaxf(block_max(fabsf(ob), red), 1e-8f) / 127.f;
  a8[(size_t)b * dim + j] = (int8_t)rintf(ob / osc);
  if (j == 0) as[b] = osc;
}

// h2 = bf16(bf16(silu(g)) * u) over 3*dim, quantized per row
__global__ void __launch_bounds__(1024) gate_quant_kernel(
    const bf16* __restrict__ gu, int dim3, int8_t* __restrict__ h8,
    float* __restrict__ hs) {
  __shared__ float red[32];
  __shared__ float h2[3 * MAX_DIM];
  const int b = blockIdx.x;
  const bf16* g = gu + (size_t)b * 2 * dim3;
  float amax = 0.f;
  for (int i = threadIdx.x; i < dim3; i += blockDim.x) {
    const float gv = __bfloat162float(g[i]);
    const float sg = bf(gv * (1.f / (1.f + expf(-gv))));
    const float v = bf(sg * __bfloat162float(g[dim3 + i]));
    h2[i] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = block_max(amax, red);
  const float sc = fmaxf(amax, 1e-8f) / 127.f;
  for (int i = threadIdx.x; i < dim3; i += blockDim.x)
    h8[(size_t)b * dim3 + i] = (int8_t)rintf(h2[i] / sc);
  if (threadIdx.x == 0) hs[b] = sc;
}

constexpr int GV_WARPS = 8, GV_MAX_M = 8;

// gemm_w8a8_kernel's contract for M <= GV_MAX_M rows, where its 32-column
// tiles would leave the card nearly idle (N / 32 CTAs): one warp per output
// column streams that weight row once with 16-byte loads against the M
// activation rows staged in shared memory. The int32 sums are exact, so the
// result is bit-identical to the tiled kernel's.
__global__ void __launch_bounds__(GV_WARPS * 32) gemv_w8a8_kernel(
    const int8_t* __restrict__ x8, int ldx, const float* __restrict__ xs,
    const int8_t* __restrict__ w, long long seg_stride, int nseg, int kseg,
    const float* __restrict__ ws, int M, int N, int mode,
    bf16* __restrict__ out, int ldo) {
  extern __shared__ __align__(16) int8_t xsm[];   // (M, nseg * kseg)
  const int K = nseg * kseg;
  for (int i = threadIdx.x * 16; i < M * K; i += blockDim.x * 16)
    *reinterpret_cast<int4*>(xsm + i) = *reinterpret_cast<const int4*>(
        x8 + (size_t)(i / K) * ldx + i % K);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GV_WARPS + warp;
  if (n >= N) return;
  float accf[GV_MAX_M];
#pragma unroll
  for (int m = 0; m < GV_MAX_M; ++m) accf[m] = 0.f;
  for (int seg = 0; seg < nseg; ++seg) {
    const int8_t* wrow = w + seg * seg_stride + (size_t)n * kseg;
    int acc[GV_MAX_M];
#pragma unroll
    for (int m = 0; m < GV_MAX_M; ++m) acc[m] = 0;
    for (int k = lane * 16; k < kseg; k += 32 * 16) {
      const int4 wv = *reinterpret_cast<const int4*>(wrow + k);
#pragma unroll
      for (int m = 0; m < GV_MAX_M; ++m) {
        if (m < M) {
          const int4 xv = *reinterpret_cast<const int4*>(
              xsm + (size_t)m * K + seg * kseg + k);
          acc[m] = __dp4a(wv.x, xv.x, acc[m]);
          acc[m] = __dp4a(wv.y, xv.y, acc[m]);
          acc[m] = __dp4a(wv.z, xv.z, acc[m]);
          acc[m] = __dp4a(wv.w, xv.w, acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < GV_MAX_M; ++m) {
      int a = acc[m];
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      accf[m] += (float)a;
    }
  }
  if (lane != 0) return;
#pragma unroll
  for (int m = 0; m < GV_MAX_M; ++m) {
    if (m < M) {
      const float y = bf(accf[m] * xs[m] * ws[n]);
      bf16* o = out + (size_t)m * ldo + n;
      *o = __float2bfloat16(mode == 0 ? y : __bfloat162float(*o) + y);
    }
  }
}

void gemm(const int8_t* x8, int ldx, const float* xs, const int8_t* w,
          long long seg_stride, int nseg, int kseg, const float* ws, int M,
          int N, int mode, bf16* out, int ldo, cudaStream_t st) {
  if (M <= GV_MAX_M) {
    gemv_w8a8_kernel<<<(N + GV_WARPS - 1) / GV_WARPS, GV_WARPS * 32,
                       (size_t)M * nseg * kseg, st>>>(
        x8, ldx, xs, w, seg_stride, nseg, kseg, ws, M, N, mode, out, ldo);
    return;
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_w8a8_kernel<<<grid, G_THREADS, 0, st>>>(x8, ldx, xs, w, seg_stride,
                                               nseg, kseg, ws, M, N, mode,
                                               out, ldo);
}

}  // namespace

// x: (B, dim) bf16 residual stream, updated in place; w (L, 13, dim, dim)
// int8; s (L, 13, dim) f32; norms (L, 2, dim) bf16; rope (2, dim) f32;
// cache ck/cv (L, K, B, dim) int8, cks/cvs (L, K, B) bf16. Scratch: x8
// (B, 3*dim) int8, xs (B) f32, buf (B, 6*dim) bf16.
extern "C" int fast_sweep(void* x, const void* w, const void* s,
                          const void* norms, const void* rope, void* ck,
                          void* cv, void* cks, void* cvs, void* x8, void* xs,
                          void* buf, int B, int dim, int L, int K, int pos,
                          int n_head, float eps, void* stream) {
  if (dim % 64 || dim > MAX_DIM || (dim / n_head) % 32 || pos >= 16 ||
      pos >= K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* xb = (bf16*)x;
  int8_t* a8 = (int8_t*)x8;
  float* as = (float*)xs;
  bf16* bb = (bf16*)buf;
  const size_t tile = (size_t)dim * dim;
  for (int l = 0; l < L; ++l) {
    const int8_t* wl = (const int8_t*)w + (size_t)l * 13 * tile;
    const float* sl = (const float*)s + (size_t)l * 13 * dim;
    const bf16* nl = (const bf16*)norms + (size_t)l * 2 * dim;
    const size_t cl = (size_t)l * K * B;
    rms_quant_kernel<<<B, RQ_THREADS, 0, st>>>(xb, nl, a8, as, dim, eps);
    gemm(a8, dim, as, wl, 0, 1, dim, sl, B, 3 * dim, 0, bb, 3 * dim, st);
    fast_attn_kernel<<<B, dim, 0, st>>>(
        bb, (const float*)rope, (int8_t*)ck + cl * dim,
        (int8_t*)cv + cl * dim, (bf16*)cks + cl, (bf16*)cvs + cl, B, dim,
        n_head, pos, a8, as);
    gemm(a8, dim, as, wl + 3 * tile, 0, 1, dim, sl + 3 * dim, B, dim, 1, xb,
         dim, st);
    rms_quant_kernel<<<B, RQ_THREADS, 0, st>>>(xb, nl + dim, a8, as, dim,
                                               eps);
    gemm(a8, dim, as, wl + 4 * tile, 0, 1, dim, sl + 4 * dim, B, 6 * dim, 0,
         bb, 6 * dim, st);
    gate_quant_kernel<<<B, 1024, 0, st>>>(bb, 3 * dim, a8, as);
    gemm(a8, 3 * dim, as, wl + 10 * tile, (long long)tile, 3, dim,
         sl + 10 * dim, B, dim, 1, xb, dim, st);
  }
  return (int)cudaGetLastError();
}

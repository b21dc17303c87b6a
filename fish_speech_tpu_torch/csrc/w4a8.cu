// W4A8 products: int8 activations x nibble-packed int4 groupwise weights.
//
// Replaces: fish_speech_tpu/ops/w4a8.py::w4a8_matmul (kernel body
// _w4a8_kernel) and ::w4a8_matmul_pc (kernel body _w4a8_pc_kernel).
//
// Layout: x8 (M, K) int8; q4 (N, K/2) int8, split-half packed (byte j holds
// k = j in its low nibble and k = j + K/2 in its high nibble); gs (N, G) f32
// scales per (output channel, group of gsz = K/G inputs); out (M, N) f32,
// before the activation scale.
//   w4a8_matmul:    out[m, n] = sum over g = 0..G-1, in that order, in f32,
//                   of float(dot_g) * gs[n, g], dot_g the exact int32 dot of
//                   group g;
//   w4a8_matmul_pc: w8 = (q * r16[n, g] + 128) >> 8 with
//                   r16 = rint(256 * (gs / cs) * 127/8), cs = max_g gs, then
//                   out[m, n] = float(int32 dot over K) * (cs * 8/127).
// Built with -fmad=false, the f32 steps round exactly as the plain PyTorch
// versions in ops/w4a8.py do, so both kernels equal them bit for bit.
//
// What bounds them on the H100: bytes at decode batch (M = 1): the packed
// weights and the scales are read once, e.g. w1 of S2-Pro (N 9728, K 2560)
// is 12.45 MB + 0.78 MB, 3.9 us at 3.35 TB/s, against 2 x 24.9 M int8
// operations. Prefill (M = a few hundred) is bound by operations.
//
// Design (simple first):
//   gemv (M <= 8): one warp per output column, 8 columns per CTA. Each lane
//     loads 16 packed bytes (32 int4 values) with one 16-byte load, and the
//     two 16-byte activation slices they pair with (k = j and k = j + K/2),
//     sign-extends the nibbles four at a time (__vsub4) and runs __dp4a. A
//     group of gsz inputs spans gsz/16 lanes of one half: those lanes' int32
//     partials are reduced exactly by shuffles, kept per group in shared
//     memory, and summed in group order at the end. pc instead requantizes
//     each nibble to int8 before the dot and reduces one int32 over K.
//   gemm (M > 8): 32x32 output tiles of 128 threads, as fast_sweep.cu's
//     gemm_w8a8: the group loop stages 64 inputs at a time, unpacked to int8
//     in shared memory (only the half the group lies in), __dp4a inner
//     product, the int32 group dot scaled into the f32 sum after each group.
//     The packed bytes are read once per half (twice in all, the second
//     time mostly from L2).
// Not yet done: int8 tensor-core products (mma.sync / wgmma), TMA staging,
// split-K for the columns of a batch-1 product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int GV_WARPS = 8, GV_MAX_M = 8;
constexpr int BM = 32, BN = 32, BK = 64, T_THREADS = 128;
constexpr int LDS = BK / 4 + 4;     // ints per shared row (16-byte aligned)
constexpr float S8_MUL = (float)(8.0 / 127.0);

// the four low / high nibbles of w, sign-extended into four int8 lanes
__device__ __forceinline__ int lo_nibbles(int w) {
  return (int)__vsub4(((unsigned)w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ int hi_nibbles(int w) {
  return (int)__vsub4((((unsigned)w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                      0x08080808u);
}

__device__ __forceinline__ int pc_r16(float g, float cs) {
  return (int)rintf((256.f * (g / cs)) * 15.875f);
}

// four int8 lanes v -> (v * r + 128) >> 8 each, again as four int8 lanes
__device__ __forceinline__ int requant4(int v, int r) {
  int out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = (int)((unsigned)v << (24 - 8 * i)) >> 24;
    out |= (((e * r + 128) >> 8) & 0xFF) << (8 * i);
  }
  return out;
}

__device__ __forceinline__ int dp4a4(const int4& a, const int (&w)[4],
                                     int acc) {
  acc = __dp4a(a.x, w[0], acc);
  acc = __dp4a(a.y, w[1], acc);
  acc = __dp4a(a.z, w[2], acc);
  return __dp4a(a.w, w[3], acc);
}

__device__ __forceinline__ float column_cs(const float* grow, int G,
                                           int lane) {
  float mx = 0.f;
  for (int g = lane; g < G; g += 32) mx = fmaxf(mx, grow[g]);
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  return fmaxf(mx, 1e-12f);
}

// Dynamic shared memory (grouped only): GV_WARPS * M * G int32 group dots.
template <bool PC>
__global__ void __launch_bounds__(GV_WARPS * 32) w4a8_gemv_kernel(
    const int8_t* __restrict__ x8, const int8_t* __restrict__ q4,
    const float* __restrict__ gs, float* __restrict__ out, int M, int N,
    int K, int G) {
  extern __shared__ int sdot[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GV_WARPS + warp;
  if (n >= N) return;          // no block-wide barrier below
  const int KH = K / 2, gsz = K / G, seg = gsz / 16, half = G / 2;
  const int8_t* wrow = q4 + (size_t)n * KH;
  const float* grow = gs + (size_t)n * G;
  int* dots = sdot + warp * M * G;
  const float cs = PC ? column_cs(grow, G, lane) : 0.f;
  int acc[GV_MAX_M];
#pragma unroll
  for (int m = 0; m < GV_MAX_M; ++m) acc[m] = 0;

  for (int base = 0; base < KH; base += 32 * 16) {
    const int j = base + lane * 16;
    const bool active = j < KH;
    const int glo = active ? j / gsz : 0;
    int lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
    if (active) {
      const int4 wv = *reinterpret_cast<const int4*>(wrow + j);
      const int ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = lo_nibbles(ws[i]);
        hi[i] = hi_nibbles(ws[i]);
      }
      if (PC) {
        const int rlo = pc_r16(grow[glo], cs), rhi = pc_r16(grow[glo + half],
                                                            cs);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = requant4(lo[i], rlo);
          hi[i] = requant4(hi[i], rhi);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < GV_MAX_M; ++m) {
      if (m < M) {
        int dlo = 0, dhi = 0;
        if (active) {
          const int8_t* xr = x8 + (size_t)m * K;
          dlo = dp4a4(*reinterpret_cast<const int4*>(xr + j), lo, 0);
          dhi = dp4a4(*reinterpret_cast<const int4*>(xr + KH + j), hi, 0);
        }
        if (PC) {
          acc[m] += dlo + dhi;
        } else {
          for (int o = seg >> 1; o > 0; o >>= 1) {
            dlo += __shfl_xor_sync(0xffffffffu, dlo, o);
            dhi += __shfl_xor_sync(0xffffffffu, dhi, o);
          }
          if (active && lane % seg == 0) {
            dots[m * G + glo] = dlo;
            dots[m * G + glo + half] = dhi;
          }
        }
      }
    }
  }

  if (PC) {
    const float s8 = cs * S8_MUL;
#pragma unroll
    for (int m = 0; m < GV_MAX_M; ++m) {
      if (m < M) {
        int a = acc[m];
        for (int o = 16; o > 0; o >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0) out[(size_t)m * N + n] = (float)a * s8;
      }
    }
    return;
  }
  __syncwarp();
  if (lane < M) {
    float a = 0.f;
    for (int g = 0; g < G; ++g) a = a + (float)dots[lane * G + g] * grow[g];
    out[(size_t)lane * N + n] = a;
  }
}

template <bool PC>
__global__ void __launch_bounds__(T_THREADS) w4a8_gemm_kernel(
    const int8_t* __restrict__ x8, const int8_t* __restrict__ q4,
    const float* __restrict__ gs, float* __restrict__ out, int M, int N,
    int K, int G) {
  __shared__ __align__(16) int xs_s[BM][LDS];
  __shared__ __align__(16) int ws_s[BN][LDS];
  __shared__ float cs_s[BN];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tr = tid / 8, tc = tid % 8;     // outputs: rows tr, tr + 16;
                                            // columns tc + 8j
  const int lr = tid / 4, part = tid % 4;   // loader: row, 16-byte part
  const int KH = K / 2, gsz = K / G, half = G / 2;
  if (PC) {
    if (tid < BN) {
      float mx = 0.f;
      if (n0 + tid < N)
        for (int g = 0; g < G; ++g)
          mx = fmaxf(mx, gs[(size_t)(n0 + tid) * G + g]);
      cs_s[tid] = fmaxf(mx, 1e-12f);
    }
    __syncthreads();
  }
  const bool wrow_ok = n0 + lr < N, xrow_ok = m0 + lr < M;
  float accf[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  int acci[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int g = 0; g < G; ++g) {
    const bool high = g >= half;
    const int pbase = (high ? g - half : g) * gsz;   // packed byte offset
    int r = 0;
    if (PC && wrow_ok) r = pc_r16(gs[(size_t)(n0 + lr) * G + g], cs_s[lr]);
    int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    for (int k0 = 0; k0 < gsz; k0 += BK) {
      int4 xv = make_int4(0, 0, 0, 0);
      if (xrow_ok)
        xv = *reinterpret_cast<const int4*>(
            x8 + (size_t)(m0 + lr) * K + g * gsz + k0 + part * 16);
      *reinterpret_cast<int4*>(&xs_s[lr][part * 4]) = xv;
      // 16 packed bytes -> the 16 int8 values of this group's half
      int wv[4] = {0, 0, 0, 0};
      if (wrow_ok) {
        const int4 pv = *reinterpret_cast<const int4*>(
            q4 + (size_t)(n0 + lr) * KH + pbase + k0 + part * 16);
        const int ps[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wv[i] = high ? hi_nibbles(ps[i]) : lo_nibbles(ps[i]);
          if (PC) wv[i] = requant4(wv[i], r);
        }
      }
      *reinterpret_cast<int4*>(&ws_s[lr][part * 4]) =
          make_int4(wv[0], wv[1], wv[2], wv[3]);
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
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc + 8 * j;
      const float gsc = (!PC && n < N) ? gs[(size_t)n * G + g] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (PC)
          acci[i][j] += acc[i][j];
        else
          accf[i][j] = accf[i][j] + (float)acc[i][j] * gsc;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + tr + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 8 * j;
      if (n0 + c >= N) continue;
      out[(size_t)m * N + n0 + c] =
          PC ? (float)acci[i][j] * (cs_s[c] * S8_MUL) : accf[i][j];
    }
  }
}

template <bool PC>
int launch(const void* x8, const void* q4, const void* gs, void* out, int M,
           int N, int K, int G, void* stream) {
  if (M < 1 || N < 1 || K % 2 || G < 2 || G % 2 || K % G)
    return (int)cudaErrorInvalidValue;
  const int gsz = K / G;
  if (gsz % BK || gsz > 512 || (gsz & (gsz - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* x = (const int8_t*)x8;
  const int8_t* w = (const int8_t*)q4;
  const float* s = (const float*)gs;
  float* o = (float*)out;
  if (M <= GV_MAX_M) {
    const size_t smem = PC ? 0 : (size_t)GV_WARPS * M * G * sizeof(int);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    w4a8_gemv_kernel<PC><<<(N + GV_WARPS - 1) / GV_WARPS, GV_WARPS * 32, smem,
                           st>>>(x, w, s, o, M, N, K, G);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    w4a8_gemm_kernel<PC><<<grid, T_THREADS, 0, st>>>(x, w, s, o, M, N, K, G);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int w4a8_matmul(const void* x8, const void* q4, const void* gs,
                           void* out, int M, int N, int K, int G,
                           void* stream) {
  return launch<false>(x8, q4, gs, out, M, N, K, G, stream);
}

extern "C" int w4a8_matmul_pc(const void* x8, const void* q4, const void* gs,
                              void* out, int M, int N, int K, int G,
                              void* stream) {
  return launch<true>(x8, q4, gs, out, M, N, K, G, stream);
}

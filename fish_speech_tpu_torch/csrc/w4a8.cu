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
// operations. A prefill of 256 rows is bound by bytes too at the tensor
// cores' int8 rate (one S2-Pro layer: 91 MB, 0.0272 ms, against 51.7 G
// operations, 0.0261 ms), far below what __dp4a's ~118 TOP/s allow.
//
// Design:
//   gemv (M <= 8): one warp per output column, 8 columns per CTA. Each lane
//     loads 16 packed bytes (32 int4 values) with one 16-byte load, and the
//     two 16-byte activation slices they pair with (k = j and k = j + K/2),
//     sign-extends the nibbles four at a time (__vsub4) and runs __dp4a. A
//     group of gsz inputs spans gsz/16 lanes of one half: those lanes' int32
//     partials are reduced exactly by shuffles, kept per group in shared
//     memory, and summed in group order at the end. pc instead requantizes
//     each nibble to int8 before the dot and reduces one int32 over K.
//   tiles (M > 8): int8 tensor cores (mma.sync m16n8k32), BM x BN output
//     tiles (64 x 64 with 8 warps, two CTAs an SM; 128 x 128 with 16 warps;
//     the wrapper's w4a8_plan picks one from the shapes and the SM count). A
//     step takes 128 values of k (grouped: 128 packed bytes of one half;
//     pc: 64 packed bytes, both halves) of BN columns and the x columns they
//     pair with into a ring of four cp.async stages, two steps ahead (rows
//     past M and N are never copied: zeroed once). The CTA unpacks a step's
//     bytes once into an int8 tile in shared memory (two tiles, so that step
//     s + 1 is unpacked while step s multiplies: one barrier a step), and
//     the warps load their fragments from it with ldmatrix.
//     grouped: the low half (groups 0..G/2-1), then the high half of the
//       same packed bytes (the second read mostly from L2: the row tiles of
//       a column tile are launched next to each other); the stages carry
//       the columns' scales of the step's groups, and each group's exact
//       int32 fragment is scaled into the f32 sum as the group ends, in
//       group order. K cannot be split without changing that order.
//     pc: both nibbles of a packed byte in one step (k = j and j + K/2,
//       against x columns j and K/2 + j), requantized with the column's
//       r16 of each group (computed once per CTA into shared memory), one
//       int32 over the CTA's K; w4a8_plan may split the packed K at group
//       boundaries over CTAs, whose exact int32 partials add atomically
//       into the zeroed output, then a second kernel scales them (one
//       launch of the C entry, two device kernels and a memset).
//     What limits them (PERF.md, PR 10): shared-memory traffic (cp.async,
//     the unpacked tile, ldmatrix) and instructions a step, not the tensor
//     cores.
// Not yet done: wgmma and TMA; split-K for the columns of a batch-1 product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int GV_WARPS = 8, GV_MAX_M = 8;
constexpr int KW = 128;             // k values a step of the tiles takes
constexpr int NST = 4;              // cp.async stages of the tiles
constexpr int MAX_G = 160;          // groups a row, at most
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

// ---------------------------------------------------------------------------
// M > 8: int8 tensor-core tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* g,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(g), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* g,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(g), "r"(bytes));
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 16-byte matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; register i holds matrix i's row lane / 4,
// bytes 4 (lane % 4) .. + 3: the int8 mma fragment layout
__device__ __forceinline__ void ldsm4(int (&r)[4], const int8_t* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// the four nibbles of the bytes of w at bit `shift` (0 low, 4 high) as
// q + 8 in 0..15, one a byte lane
__device__ __forceinline__ unsigned nibbles_u(unsigned w, int shift) {
  return ((w >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// q + 8 in four byte lanes -> the signed nibbles q as four int8 lanes
__device__ __forceinline__ int signed_nibbles(unsigned u) {
  return (int)((u + 0x78787878u) ^ 0x80808080u);
}

// q + 8 in four byte lanes -> (q * r + 128) >> 8 as four int8 lanes, two
// 16-bit lanes a 32-bit product: (q + 8) * r + 32896 - 8 r = q * r + 128 +
// 32768 lies in [384, 61344] for 0 <= r <= 4064 (r16 of non-negative
// scales), so no lane carries and byte 1 of each lane is w8 + 128.
// dd = (32896 - 8 r) in both 16-bit lanes.
__device__ __forceinline__ int requant_u(unsigned u, unsigned r,
                                         unsigned dd) {
  const unsigned e = (u & 0x00FF00FFu) * r + dd;
  const unsigned o = ((u >> 8) & 0x00FF00FFu) * r + dd;
  return (int)(__byte_perm(e, o, 0x7351) ^ 0x80808080u);
}

__device__ __forceinline__ unsigned requant_dd(int r) {
  const unsigned d = 32896u - 8u * (unsigned)r;
  return d | (d << 16);
}

// out[c] = mul * cs of columns n + c, c < C, by one warp (1e-12 past N):
// every lane's loads of the C columns in flight at once
template <int C>
__device__ __forceinline__ void tile_cs(const float* gs, int n, int N, int G,
                                        int lane, float* out, float mul) {
  float mx[C];
#pragma unroll
  for (int c = 0; c < C; ++c) mx[c] = 0.f;
  for (int g = lane; g < G; g += 32)
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (n + c < N) mx[c] = fmaxf(mx[c], __ldg(gs + (size_t)(n + c) * G + g));
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int o = 16; o > 0; o >>= 1)
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], o));
    if (lane == 0) out[c] = fmaxf(mx[c], 1e-12f) * mul;
  }
}

// Tile geometry: warps 4 x (BN / 32), each 32 columns by BM / 4 rows (one
// CTA of 16 warps an SM at 128 x 128, two of 8 at 64 x 64). A step
// multiplies KW = 128 values of k: grouped, 128 packed bytes of one half;
// pc, 64 packed bytes, both halves. Each stage holds the step's x columns
// and packed bytes, and (grouped) the scales gs[n, g] of its two 64-wide k
// blocks; pc keeps r16 of every (group of its K part, column) instead.
template <int BM, int BN, bool PC>
struct Tile {
  static constexpr int WARPS_N = BN / 32, WARPS = 4 * WARPS_N;
  static constexpr int THREADS = WARPS * 32, MIN_CTAS = 512 / THREADS;
  static constexpr int WM = BM / 4, MI = WM / 16, NJ = 4;
  static constexpr int KS = PC ? KW / 2 : KW;   // packed bytes a step
  static constexpr int LDX = KW + 16, LDP = KS + 16, LDW = KW + 16;
  static constexpr int X_AT = 0, P_AT = BM * LDX, S_AT = P_AT + BN * LDP;
  static constexpr int STAGE = S_AT + (PC ? 0 : 2 * BN * 4);
  static constexpr int W_AT = NST * STAGE, C_AT = W_AT + 2 * BN * LDW;
  static constexpr int R_AT = C_AT + BN * 4;
  static constexpr int SMEM = R_AT + (PC ? MAX_G * BN * 2 : 0);
  // 16-byte chunks a thread copies (x, packed) or unpacks a step
  static constexpr int XCH = BM * (KW / 16) / THREADS;
  static constexpr int PCH = BN * (KS / 16) / THREADS;
  static_assert(XCH * THREADS == BM * (KW / 16), "x chunks");
  static_assert(PCH * THREADS == BN * (KS / 16), "packed chunks");
};

// x8 (M, K) x unpack(q4 (N, K/2)).T on the tile (blockIdx.x * BM,
// blockIdx.y * BN), over the packed bytes [z * part, z * part + part) of
// K part z = blockIdx.z (pc; grouped: part = K/2). split: add the int32
// sums atomically into out, read as int32 and zeroed by the caller.
template <int BM, int BN, bool PC>
__global__ void __launch_bounds__(Tile<BM, BN, PC>::THREADS,
                                  Tile<BM, BN, PC>::MIN_CTAS)
    w4a8_tile_kernel(const int8_t* __restrict__ x8,
                     const int8_t* __restrict__ q4,
                     const float* __restrict__ gs, float* __restrict__ out,
                     int M, int N, int K, int G, int part, int split) {
  using T = Tile<BM, BN, PC>;
  constexpr int KS = T::KS;
  extern __shared__ __align__(16) int8_t smem[];
  float* cs_s = reinterpret_cast<float*>(smem + T::C_AT);
  int16_t* r16_s = reinterpret_cast<int16_t*>(smem + T::R_AT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KH = K / 2, gsz = K / G, half = G / 2, gsh = __ffs(gsz) - 1;
  const int j0 = blockIdx.z * part, j1 = min(j0 + part, KH);
  const int nslab = (j1 - j0 + KS - 1) / KS;
  const int nstep = PC ? nslab : 2 * nslab;   // grouped: low, then high
  // pc: the part's low groups g0 .. g0 + ng - 1 (and each + G/2)
  const int g0 = j0 >> gsh, ng = ((j1 - 1) >> gsh) - g0 + 1;

  // step s: pass (grouped: 0 low, 1 high), first packed byte j, packed
  // bytes kb (pc: always 64; grouped: 64 or 128)
  auto step = [&](int s, int& pass, int& j, int& kb) {
    pass = !PC && s >= nslab;
    j = j0 + (s - pass * nslab) * KS;
    kb = min(KS, j1 - j);
  };

  // rows past M or N are never copied: zeros in every stage, once
  {
    const int xr = max(0, min(BM, M - m0)), pr = max(0, min(BN, N - n0));
    const int xn = (BM - xr) * (T::LDX / 16), pn = (BN - pr) * (T::LDP / 16);
    for (int e = tid; e < NST * (xn + pn); e += T::THREADS) {
      const int sidx = e / (xn + pn), f = e % (xn + pn);
      int8_t* st = smem + sidx * T::STAGE;
      int4* p = reinterpret_cast<int4*>(
          f < xn ? st + T::X_AT + xr * T::LDX + 16 * f
                 : st + T::P_AT + pr * T::LDP + 16 * (f - xn));
      *p = make_int4(0, 0, 0, 0);
    }
  }
  // this thread's copies, the same every step but for the offset j
  // (grouped: + K/2 in the high pass); null where the row is past M or N
  const int8_t* xsrc[T::XCH];
  int xdst[T::XCH], xlim[T::XCH];
#pragma unroll
  for (int i = 0; i < T::XCH; ++i) {
    const int c = tid + i * T::THREADS;
    const int r = c / (KW / 16), cc = c % (KW / 16), q = cc / 4;
    xsrc[i] = m0 + r < M ? x8 + (size_t)(m0 + r) * K +
                               (PC ? q * KH : 64 * q) + (cc % 4) * 16
                         : nullptr;
    xdst[i] = T::X_AT + r * T::LDX + cc * 16;
    xlim[i] = PC ? 0 : 64 * q;     // grouped: k block q is past kb
  }
  const int8_t* psrc[T::PCH];
  int pdst[T::PCH], plim[T::PCH];
#pragma unroll
  for (int i = 0; i < T::PCH; ++i) {
    const int c = tid + i * T::THREADS;
    const int r = c / (KS / 16), o = (c % (KS / 16)) * 16;
    psrc[i] = n0 + r < N ? q4 + (size_t)(n0 + r) * KH + o : nullptr;
    pdst[i] = T::P_AT + r * T::LDP + o;
    plim[i] = o;
  }
  // grouped: the scale of k block q = tid / BN of column tid % BN
  const float* ssrc = !PC && tid < 2 * BN && n0 + tid % BN < N
                          ? gs + (size_t)(n0 + tid % BN) * G : nullptr;

  auto load = [&](int s) {
    int pass, j, kb;
    step(s, pass, j, kb);
    int8_t* st = smem + (s % NST) * T::STAGE;
    const int xo = pass * KH + j;
#pragma unroll
    for (int i = 0; i < T::XCH; ++i)
      if (xsrc[i]) {
        const bool ok = xlim[i] < kb;
        cp_async16(st + xdst[i], ok ? xsrc[i] + xo : x8, ok ? 16 : 0);
      }
#pragma unroll
    for (int i = 0; i < T::PCH; ++i)
      if (psrc[i]) {
        const bool ok = plim[i] < kb;
        cp_async16(st + pdst[i], ok ? psrc[i] + j : q4, ok ? 16 : 0);
      }
    if (!PC && tid < 2 * BN) {
      const int q = tid / BN;
      const bool ok = ssrc && 64 * q < kb;
      const int g = pass * half + ((j + 64 * q) >> gsh);
      cp_async4(st + T::S_AT + tid * 4, ok ? ssrc + g : gs, ok ? 4 : 0);
    }
  };

  // step s's packed bytes -> int8 weights in tile s % 2 (pc: the low
  // nibbles at k 0..63, the high ones at 64..127)
  auto unpack = [&](int s) {
    int pass, j, kb;
    step(s, pass, j, kb);
    const int8_t* st = smem + (s % NST) * T::STAGE;
    int8_t* wt = smem + T::W_AT + (s % 2) * BN * T::LDW;
    const int lg = (j >> gsh) - g0;
#pragma unroll
    for (int i = 0; i < T::PCH; ++i) {
      const int c = tid + i * T::THREADS;
      const int r = c / (KS / 16), o = (c % (KS / 16)) * 16;
      const int4 v = *reinterpret_cast<const int4*>(st + pdst[i]);
      const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z,
                             (unsigned)v.w};
      int lo[4], hi[4];
      if (PC) {
        const int rl = r16_s[lg * BN + r], rh = r16_s[(ng + lg) * BN + r];
        const unsigned dl = requant_dd(rl), dh = requant_dd(rh);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[e] = requant_u(nibbles_u(w[e], 0), (unsigned)rl, dl);
          hi[e] = requant_u(nibbles_u(w[e], 4), (unsigned)rh, dh);
        }
        *reinterpret_cast<int4*>(wt + r * T::LDW + KS + o) =
            make_int4(hi[0], hi[1], hi[2], hi[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lo[e] = signed_nibbles(nibbles_u(w[e], 4 * pass));
      }
      *reinterpret_cast<int4*>(wt + r * T::LDW + o) =
          make_int4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  int acc[T::MI][T::NJ][4];
  float accf[PC ? 1 : T::MI][T::NJ][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int jj = 0; jj < T::NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][jj][e] = 0;
        if (!PC) accf[PC ? 0 : i][jj][e] = 0.f;
      }
  const int wrow = wm * T::WM, wcol = wn * 32;
  // whether the warp's rows hold one below M (rows past M multiply zeros)
  const bool live = m0 + wrow < M;
  // ldmatrix rows: A (x) rows 0-15 at k + 0 / 16; B (weights) two n8
  // tiles at k + 0 / 16
  const int a_off = (wrow + (lane & 15)) * T::LDX + 16 * (lane >> 4);
  const int b_off =
      (wcol + (lane & 7) + 8 * (lane >> 4)) * T::LDW + 16 * ((lane >> 3) & 1);

  // NST - 2 stages in flight beyond the one being unpacked
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nstep) load(s);
    cp_commit();
  }
  if (PC) {  // while they land: cs (8 columns a warp), then r16 of the
             // part's groups, (group, column) from a thread each
    tile_cs<BN / T::WARPS>(gs, n0 + warp * (BN / T::WARPS), N, G, lane,
                           cs_s + warp * (BN / T::WARPS), 1.f);
    __syncthreads();
    for (int e = tid; e < 2 * ng * BN; e += T::THREADS) {
      const int r = e / (2 * ng), lg = e % (2 * ng);
      const int g = lg < ng ? g0 + lg : g0 + lg - ng + half;
      r16_s[lg * BN + r] = (int16_t)(
          n0 + r < N ? pc_r16(gs[(size_t)(n0 + r) * G + g], cs_s[r]) : 0);
    }
  }
  cp_wait<NST - 2>();
  __syncthreads();        // step 0 landed; cs_s, r16_s written
  unpack(0);
  for (int s = 0; s < nstep; ++s) {
    cp_wait<NST - 3>();
    __syncthreads();      // step s unpacked, step s + 1 landed; step s - 1's
                          // stage and weight tile are free
    if (s + NST - 1 < nstep) load(s + NST - 1);
    cp_commit();
    int pass, j, kb;
    step(s, pass, j, kb);
    const int8_t* xs = smem + (s % NST) * T::STAGE + T::X_AT;
    const float* sc =
        reinterpret_cast<const float*>(smem + (s % NST) * T::STAGE + T::S_AT);
    const int8_t* wt = smem + T::W_AT + (s % 2) * BN * T::LDW;
    // k values past kb (grouped: a 64-byte last step) are zeros in x
    if (live) {
#pragma unroll
      for (int kk = 0; kk < KW; kk += 32) {
        int b[T::NJ / 2][4], a[T::MI][4];
#pragma unroll
        for (int jp = 0; jp < T::NJ / 2; ++jp)
          ldsm4(b[jp], wt + b_off + jp * 16 * T::LDW + kk);
#pragma unroll
        for (int i = 0; i < T::MI; ++i)
          ldsm4(a[i], xs + a_off + i * 16 * T::LDX + kk);
#pragma unroll
        for (int i = 0; i < T::MI; ++i)
#pragma unroll
          for (int jj = 0; jj < T::NJ; ++jj)
            mma_s8(acc[i][jj], a[i], b[jj / 2][2 * (jj % 2)],
                   b[jj / 2][2 * (jj % 2) + 1]);
        // grouped: k block q = kk / 64 ends its group -> into f32
        if (!PC && kk % 64 == 32 && kk < kb &&
            ((j + kk + 32) & (gsz - 1)) == 0) {
          const float* sq = sc + (kk / 64) * BN + wcol + tq * 2;
#pragma unroll
          for (int jj = 0; jj < T::NJ; ++jj)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float gsc = sq[jj * 8 + c];
#pragma unroll
              for (int i = 0; i < T::MI; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  accf[PC ? 0 : i][jj][2 * h + c] =
                      accf[PC ? 0 : i][jj][2 * h + c] +
                      (float)acc[i][jj][2 * h + c] * gsc;
                  acc[i][jj][2 * h + c] = 0;
                }
            }
        }
      }
    }
    if (s + 1 < nstep) unpack(s + 1);
  }

#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int jj = 0; jj < T::NJ; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = m0 + wrow + i * 16 + gq + 8 * h;
          const int cl = wcol + jj * 8 + tq * 2 + c, n = n0 + cl;
          if (m >= M || n >= N) continue;
          const int e = 2 * h + c;
          if (!PC)
            out[(size_t)m * N + n] = accf[PC ? 0 : i][jj][e];
          else if (split)
            atomicAdd(reinterpret_cast<int*>(out) + (size_t)m * N + n,
                      acc[i][jj][e]);
          else
            out[(size_t)m * N + n] =
                (float)acc[i][jj][e] * (cs_s[cl] * S8_MUL);
        }
}

// pc after a K split: out's exact int32 sums -> float(sum) * cs * 8/127
__global__ void __launch_bounds__(256) w4a8_pc_scale_kernel(
    const float* __restrict__ gs, float* __restrict__ out, int M, int N,
    int G) {
  __shared__ float s8[64];
  const int n0 = blockIdx.x * 64, m0 = blockIdx.y * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  tile_cs<8>(gs, n0 + warp * 8, N, G, lane, s8 + warp * 8, S8_MUL);
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 64; e += 256) {
    const int m = m0 + e / 64, n = n0 + e % 64;
    if (m >= M || n >= N) continue;
    const size_t at = (size_t)m * N + n;
    out[at] = (float)reinterpret_cast<const int*>(out)[at] * s8[e % 64];
  }
}

template <int BM, int BN, bool PC>
int launch_tiles(const int8_t* x, const int8_t* w, const float* s, float* o,
                 int M, int N, int K, int G, int n_split, int part,
                 cudaStream_t st) {
  using T = Tile<BM, BN, PC>;
  auto kernel = w4a8_tile_kernel<BM, BN, PC>;
  // per call: the attribute holds for the current device only
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int split = n_split > 1;
  if (split) {
    const cudaError_t e =
        cudaMemsetAsync(o, 0, (size_t)M * N * sizeof(float), st);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, n_split);
  kernel<<<grid, T::THREADS, T::SMEM, st>>>(x, w, s, o, M, N, K, G, part,
                                            split);
  if (split) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    w4a8_pc_scale_kernel<<<dim3((N + 63) / 64, (M + 63) / 64), 256, 0, st>>>(
        s, o, M, N, G);
  }
  return (int)cudaGetLastError();
}

// tile 0: the weight stream (M <= 8); 1: 64 x 64 tiles; 2: 128 x 128.
// n_split K parts of `part` packed bytes each (pc only; grouped: 1, K/2),
// at whole groups and whole steps, covering K/2 once.
template <bool PC>
int launch(const void* x8, const void* q4, const void* gs, void* out, int M,
           int N, int K, int G, int tile, int n_split, int part,
           void* stream) {
  if (M < 1 || N < 1 || K % 2 || G < 2 || G % 2 || K % G)
    return (int)cudaErrorInvalidValue;
  const int gsz = K / G, KH = K / 2;
  if (gsz % 64 || gsz > 512 || (gsz & (gsz - 1)))
    return (int)cudaErrorInvalidValue;
  if ((M <= GV_MAX_M) != (tile == 0) || tile < 0 || tile > 2 || G > MAX_G ||
      n_split < 1 || part < 1 || (long long)(n_split - 1) * part >= KH ||
      (long long)n_split * part < KH || (!PC && n_split != 1) ||
      (n_split > 1 && part % gsz))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* x = (const int8_t*)x8;
  const int8_t* w = (const int8_t*)q4;
  const float* s = (const float*)gs;
  float* o = (float*)out;
  if (tile == 0) {
    const size_t smem = PC ? 0 : (size_t)GV_WARPS * M * G * sizeof(int);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    w4a8_gemv_kernel<PC><<<(N + GV_WARPS - 1) / GV_WARPS, GV_WARPS * 32, smem,
                           st>>>(x, w, s, o, M, N, K, G);
    return (int)cudaGetLastError();
  }
  if (tile == 1)
    return launch_tiles<64, 64, PC>(x, w, s, o, M, N, K, G, n_split, part,
                                    st);
  return launch_tiles<128, 128, PC>(x, w, s, o, M, N, K, G, n_split, part,
                                    st);
}

}  // namespace

extern "C" int w4a8_matmul(const void* x8, const void* q4, const void* gs,
                           void* out, int M, int N, int K, int G, int tile,
                           int n_split, int part, void* stream) {
  return launch<false>(x8, q4, gs, out, M, N, K, G, tile, n_split, part,
                       stream);
}

extern "C" int w4a8_matmul_pc(const void* x8, const void* q4, const void* gs,
                              void* out, int M, int N, int K, int G, int tile,
                              int n_split, int part, void* stream) {
  return launch<true>(x8, q4, gs, out, M, N, K, G, tile, n_split, part,
                      stream);
}

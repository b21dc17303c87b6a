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
//   stream (M <= 8): the card must read every packed byte once, so the
//     kernel keeps the weight stream in flight and does little per byte.
//     A CTA owns SB_N = 32 output columns and one K part of the packed
//     bytes [z * part, z * part + part) (whole groups; w4a8_plan in
//     ops/w4a8.py picks the part from the shapes and the SM count). The
//     n_split CTAs of a column tile form one thread-block cluster along K
//     (at most 8, cudaLaunchKernelEx with a cluster dimension), so a call
//     is one device kernel: no memset, no atomics, no global scratch,
//     deterministic, and capturable in a CUDA graph.
//     One producer warp streams the part's rows into a ring of SB_STAGES
//     stages of SB_K packed bytes a row with cp.async.bulk (one copy a
//     column row, a lane a row; completion on an mbarrier a stage, freed
//     by the consumers' arrivals on another), after copying x's M rows
//     once into shared memory, only the columns the part pairs with (k = j
//     and k = K/2 + j). Rows sit SB_LDW = SB_K + 64 bytes apart, so that
//     rows 2p and 2p + 1 fall on different banks in a quarter-warp's
//     16-byte loads.
//     Two consumer warps, 16 columns each, multiply with int8 mma.sync
//     m16n8k32 with the operands swapped: 16 weight columns as A, the
//     <= 8 rows of x as B (rows past M are zeros), int32 sums exact. A
//     lane's 16-byte load of a column row holds 16 values of each half;
//     the same load of x's row holds their partners, and the dot is the
//     same under any order of k shared by A and B, so a lane's first 8
//     bytes feed one mma and its next 8 the other: no shuffle, no
//     ldmatrix.
//     grouped: a nibble q is taken as the byte 16 q (it is put in the
//       byte's high half: one or two logic ops a word), so the sums are
//       16 times the exact dot. At each group end the warp writes
//       float(dot) * gs[n, g] for its (m, group, column) into the shared
//       memory of the CTA that finishes that (m, column) (distributed
//       shared memory; each CTA of the cluster finishes a share of the
//       tile's outputs). After one cluster barrier each CTA adds its
//       outputs' products in group order g = 0 .. G - 1, as the plain
//       twin does.
//     pc: the nibbles are requantized to int8 with the column's r16 of the
//       group (computed per CTA into shared memory from cs = max_g gs),
//       one int32 over the part, written the same way; the finishing CTA
//       adds the parts' int32 sums and scales by cs * 8/127.
//     What limits it (PERF.md, PR 13): 2.36-2.68 us of a call is the
//     launch of its grid (a copy that returns at once), and the consumers'
//     work is not hidden behind the stream: without it a product at M = 1
//     takes 1.4-4.6 us less.
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
// Not yet done: wgmma and TMA for the tiles.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_M_STREAM = 8;     // rows the stream takes (M <= 8)
constexpr int SB_N = 32;            // columns a stream CTA
constexpr int SB_WARPS = SB_N / 16; // its consumer warps, 16 columns each
constexpr int SB_THREADS = 32 * (SB_WARPS + 1);   // and the producer warp
constexpr int SB_K = 256;           // packed bytes of a row a stage
constexpr int SB_LDW = SB_K + 64;   // a stage row's pitch in shared memory
constexpr int SB_STAGES = 3;        // ring stages, at most
constexpr int MAX_CLUSTER = 8;      // CTAs a cluster: the portable limit
constexpr int SB_SMEM_MAX = 225 * 1024;   // dynamic shared memory a CTA
constexpr int KW = 128;             // k values a step of the tiles takes
constexpr int NST = 4;              // cp.async stages of the tiles
constexpr int MAX_G = 160;          // groups a row, at most
constexpr float S8_MUL = (float)(8.0 / 127.0);

__device__ __forceinline__ int pc_r16(float g, float cs) {
  return (int)rintf((256.f * (g / cs)) * 15.875f);
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

// ---------------------------------------------------------------------------
// M <= 8: the weight stream, one cluster of K parts a column tile
// ---------------------------------------------------------------------------

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this CTA's shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the consumer warps only (the producer warp is not waited for)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * SB_WARPS) : "memory");
}

// the four low / high nibbles q of w as 16 q, one a byte (signed int8:
// the nibble in a byte's high half, zeros below)
__device__ __forceinline__ int lo_x16(int w) {
  return (int)(((unsigned)w << 4) & 0xF0F0F0F0u);
}

__device__ __forceinline__ int hi_x16(int w) {
  return (int)((unsigned)w & 0xF0F0F0F0u);
}

// the nibbles q of w at bit `shift` (0 low, 4 high) requantized, (q * r +
// 128) >> 8 as four int8 lanes: requant_u on the bytes' even and odd
// nibbles taken straight from w (dd = requant_dd(r))
__device__ __forceinline__ int rq8(int w, int shift, int r, unsigned dd) {
  const unsigned e = ((((unsigned)w >> shift) & 0x000F000Fu) ^ 0x00080008u) *
                         (unsigned)r + dd;
  const unsigned o =
      ((((unsigned)w >> (shift + 8)) & 0x000F000Fu) ^ 0x00080008u) *
          (unsigned)r + dd;
  return (int)(__byte_perm(e, o, 0x7351) ^ 0x80808080u);
}

// the split arrival and wait of the cluster's barrier (all threads)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Dynamic shared memory of a stream CTA (byte offsets). part: the packed
// bytes of the largest K part, gpp = part / gsz its groups in each half;
// per: the (m, column) outputs a CTA of the cluster finishes.
// ops/w4a8.py::stream_smem mirrors `total`.
struct StreamLayout {
  int stages, ldx, per, xs, tab, aux, total;
};

__host__ __device__ inline StreamLayout stream_layout(int M, int G, int part,
                                                      int gpp, int n_split,
                                                      bool pc) {
  StreamLayout L;
  const int need = (part + SB_K - 1) / SB_K;
  L.stages = need < SB_STAGES ? need : SB_STAGES;
  // x's rows: [low part | high part | 64], a pitch of 64 mod 128 bytes
  L.ldx = 2 * part + 64;
  L.per = (M * SB_N + n_split - 1) / n_split;
  L.xs = L.stages * SB_N * SB_LDW;
  // the sums this CTA finishes, written by every CTA of the cluster:
  // grouped float(dot) * gs (G, per) f32; pc the parts' dots (n_split,
  // per) int32
  L.tab = L.xs + M * L.ldx;
  L.aux = L.tab + 4 * L.per * (pc ? n_split : G);
  // grouped: gs of the part's groups (2 gpp, SB_N) f32; pc: r16 of them
  // (2 gpp, SB_N) int32, cs (SB_N) f32, then the tile's gs (SB_N, G) f32
  L.total = L.aux + 4 * SB_N * (pc ? 2 * gpp + 1 + G : 2 * gpp);
  return L;
}

// x8 (M, K) x unpack(q4 (N, K/2)).T for columns n0 = blockIdx.y * SB_N
// .. + SB_N - 1 over the K part z = the CTA's rank in its cluster of
// n_split = gridDim.x CTAs: packed bytes [z * part, z * part + part) (the
// last part may be shorter), groups [z * gpp, ...) and the same + G/2.
// The CTA of rank r finishes the tile's outputs e = m * SB_N + column in
// [r * per, r * per + per): every CTA writes its sums for them into that
// CTA's shared memory (distributed shared memory), then one cluster
// barrier, then each finishes from its own.
template <bool PC>
__global__ void __launch_bounds__(SB_THREADS) w4a8_stream_kernel(
    const int8_t* __restrict__ x8, const int8_t* __restrict__ q4,
    const float* __restrict__ gs, float* __restrict__ out, int M, int N,
    int K, int G, int part) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ __align__(8) uint64_t full[SB_STAGES], empty[SB_STAGES], xbar;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int z = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int KH = K / 2, gsz = K / G, GH = G / 2, gsh = __ffs(gsz) - 1;
  const int gpp = part >> gsh, g0 = z * gpp;
  const int ng = min(gpp, GH - g0);      // this part's groups, each half
  const int pz = ng << gsh, a0 = g0 << gsh;
  const int n0 = blockIdx.y * SB_N, rows = min(SB_N, N - n0);
  const int nst = (pz + SB_K - 1) / SB_K;
  const StreamLayout L = stream_layout(M, G, part, gpp, n_split, PC);
  const int per = L.per;
  int8_t* ring = smem;
  int8_t* xs = smem + L.xs;
  float* tabf = reinterpret_cast<float*>(smem + L.tab);
  int* tabi = reinterpret_cast<int*>(smem + L.tab);
  float* gsp = reinterpret_cast<float*>(smem + L.aux);
  int* r16s = reinterpret_cast<int*>(smem + L.aux);
  float* cs_s = reinterpret_cast<float*>(smem + L.aux + 8 * gpp * SB_N);
  float* gsf = cs_s + SB_N;

  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], SB_WARPS);
    }
    mbar_init(&xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this CTA has started: the others may write into its shared memory
  // once they have waited for the barrier's phase
  cluster_arrive();
  __syncthreads();

  if (warp == SB_WARPS) {
    // producer: x's rows once, then the ring, a lane a column row
    if (lane == 0) mbar_expect_tx(&xbar, 2 * M * pz);
    __syncwarp();
    if (lane < M) {
      const int8_t* xr = x8 + (size_t)lane * K + a0;
      bulk_load(xs + lane * L.ldx, xr, pz, &xbar);
      bulk_load(xs + lane * L.ldx + part, xr + KH, pz, &xbar);
    }
    const int8_t* wr = q4 + (size_t)(n0 + lane) * KH + a0;
    for (int st = 0, s = 0, ph = 0; st < nst; ++st) {
      // stage s is free once the consumers have taken its last fill
      if (st >= L.stages) mbar_wait(&empty[s], ph ^ 1);
      const int nb = min(SB_K, pz - st * SB_K);
      if (lane == 0) mbar_expect_tx(&full[s], nb * rows);
      __syncwarp();
      if (lane < rows)
        bulk_load(ring + (s * SB_N + lane) * SB_LDW, wr + st * SB_K, nb,
                  &full[s]);
      if (++s == L.stages) {
        s = 0;
        ph ^= 1;
      }
    }
    cluster_wait();
  } else {
    // consumers: warp cw takes columns cw * 16 .. + 15; lane (gq, tq)
    // holds A rows gq, gq + 8 and x's row m = gq (B column gq)
    const int gq = lane >> 2, tq = lane & 3, crow = warp * 16 + gq;
    // while the copies land, the scales, all copies in flight at once:
    // grouped those of the part's groups; pc the tile's rows, then cs and
    // r16 from them
    if (PC) {
      for (int e = tid; e < rows * G; e += 32 * SB_WARPS)
        cp_async4(gsf + e, gs + (size_t)n0 * G + e, 4);
    } else {
      for (int e = tid; e < 2 * ng * SB_N; e += 32 * SB_WARPS) {
        const int r = e % SB_N, h = e / SB_N >= ng, gl = e / SB_N - h * ng;
        float* at = gsp + (h * gpp + gl) * SB_N + r;
        if (r < rows)
          cp_async4(at, gs + (size_t)(n0 + r) * G + h * GH + g0 + gl, 4);
        else
          *at = 0.f;
      }
    }
    cp_commit();
    cp_wait<0>();
    consumers_sync();
    if (PC) {
      // cs of column tid / 2, two lanes a column
      const int c = tid >> 1;
      float mx = 0.f;
      if (c < rows)
        for (int g = tid & 1; g < G; g += 2) mx = fmaxf(mx, gsf[c * G + g]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      if ((tid & 1) == 0) cs_s[c] = fmaxf(mx, 1e-12f);
      consumers_sync();
      for (int e = tid; e < 2 * ng * SB_N; e += 32 * SB_WARPS) {
        const int r = e % SB_N, h = e / SB_N >= ng, gl = e / SB_N - h * ng;
        r16s[(h * gpp + gl) * SB_N + r] =
            r < rows ? pc_r16(gsf[r * G + h * GH + g0 + gl], cs_s[r]) : 0;
      }
      consumers_sync();
    }
    mbar_wait(&xbar, 0);
    cluster_wait();     // every CTA of the cluster has started

    const bool live = gq < M;
    const int8_t* xrow = xs + gq * L.ldx + tq * 16;
    const int8_t* wrow = ring + crow * SB_LDW + tq * 16;
    // four independent int32 sums (low / high half, first / second mma of
    // a chunk), so that consecutive mma do not wait for each other
    int la[4] = {0, 0, 0, 0}, lb[4] = {0, 0, 0, 0};
    int ha[4] = {0, 0, 0, 0}, hb[4] = {0, 0, 0, 0};
    int rl0 = 0, rl8 = 0, rh0 = 0, rh8 = 0;   // pc: r16 of rows gq, gq + 8
    unsigned dl0 = 0, dl8 = 0, dh0 = 0, dh8 = 0;
    // accumulator e holds output (m, nl) = (2 tq + e % 2, crow + 8 (e / 2)):
    // where its sums go, in the shared memory of the CTA that finishes it
    float* dst[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * tq + (e & 1), nl = crow + 8 * (e >> 1);
      const int o = m * SB_N + nl, r = o / per;
      dst[e] = m < M && nl < rows
                   ? cluster.map_shared_rank(tabf, r) + o - r * per
                   : nullptr;
    }

    // the 64-byte chunk at byte c of a stage (ws), packed byte j of the part
    auto chunk = [&](const int8_t* ws, int c, int j) {
      const int gl = j >> gsh;
      const int4 w0 = *reinterpret_cast<const int4*>(ws + c);
      const int4 w8 = *reinterpret_cast<const int4*>(ws + 8 * SB_LDW + c);
      int4 xl = make_int4(0, 0, 0, 0), xh = make_int4(0, 0, 0, 0);
      if (live) {
        xl = *reinterpret_cast<const int4*>(xrow + j);
        xh = *reinterpret_cast<const int4*>(xrow + part + j);
      }
      if (PC) {
        if ((j & (gsz - 1)) == 0) {
          rl0 = r16s[gl * SB_N + crow];
          rl8 = r16s[gl * SB_N + crow + 8];
          rh0 = r16s[(gpp + gl) * SB_N + crow];
          rh8 = r16s[(gpp + gl) * SB_N + crow + 8];
          dl0 = requant_dd(rl0);
          dl8 = requant_dd(rl8);
          dh0 = requant_dd(rh0);
          dh8 = requant_dd(rh8);
        }
        const int a0l[4] = {rq8(w0.x, 0, rl0, dl0), rq8(w8.x, 0, rl8, dl8),
                            rq8(w0.y, 0, rl0, dl0), rq8(w8.y, 0, rl8, dl8)};
        mma_s8(la, a0l, xl.x, xl.y);
        const int a1l[4] = {rq8(w0.z, 0, rl0, dl0), rq8(w8.z, 0, rl8, dl8),
                            rq8(w0.w, 0, rl0, dl0), rq8(w8.w, 0, rl8, dl8)};
        mma_s8(lb, a1l, xl.z, xl.w);
        const int a0h[4] = {rq8(w0.x, 4, rh0, dh0), rq8(w8.x, 4, rh8, dh8),
                            rq8(w0.y, 4, rh0, dh0), rq8(w8.y, 4, rh8, dh8)};
        mma_s8(ha, a0h, xh.x, xh.y);
        const int a1h[4] = {rq8(w0.z, 4, rh0, dh0), rq8(w8.z, 4, rh8, dh8),
                            rq8(w0.w, 4, rh0, dh0), rq8(w8.w, 4, rh8, dh8)};
        mma_s8(hb, a1h, xh.z, xh.w);
        return;
      }
      const int a0l[4] = {lo_x16(w0.x), lo_x16(w8.x), lo_x16(w0.y),
                          lo_x16(w8.y)};
      mma_s8(la, a0l, xl.x, xl.y);
      const int a1l[4] = {lo_x16(w0.z), lo_x16(w8.z), lo_x16(w0.w),
                          lo_x16(w8.w)};
      mma_s8(lb, a1l, xl.z, xl.w);
      const int a0h[4] = {hi_x16(w0.x), hi_x16(w8.x), hi_x16(w0.y),
                          hi_x16(w8.y)};
      mma_s8(ha, a0h, xh.x, xh.y);
      const int a1h[4] = {hi_x16(w0.z), hi_x16(w8.z), hi_x16(w0.w),
                          hi_x16(w8.w)};
      mma_s8(hb, a1h, xh.z, xh.w);
      if (((j + 64) & (gsz - 1)) == 0) {
        // group gl (and GH + gl) ends: its exact dot is the sums / 16;
        // float(dot) * gs into the finishing CTA's shared memory
        const int at = (g0 + gl) * per, ah = at + GH * per;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (dst[e]) {
            const int nl = crow + 8 * (e >> 1);
            dst[e][at] = (float)((la[e] + lb[e]) >> 4) * gsp[gl * SB_N + nl];
            dst[e][ah] =
                (float)((ha[e] + hb[e]) >> 4) * gsp[(gpp + gl) * SB_N + nl];
          }
          la[e] = lb[e] = ha[e] = hb[e] = 0;
        }
      }
    };

    for (int st = 0, s = 0, ph = 0; st < nst; ++st) {
      mbar_wait(&full[s], ph);
      const int8_t* ws = wrow + s * SB_N * SB_LDW;
      const int nb = min(SB_K, pz - st * SB_K);
      if (nb == SB_K) {
#pragma unroll
        for (int c = 0; c < SB_K; c += 64) chunk(ws, c, st * SB_K + c);
      } else {
        for (int c = 0; c < nb; c += 64) chunk(ws, c, st * SB_K + c);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == L.stages) {
        s = 0;
        ph ^= 1;
      }
    }
    if (PC) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (dst[e])
          reinterpret_cast<int*>(dst[e])[z * per] =
              la[e] + lb[e] + ha[e] + hb[e];
    }
  }

  // every CTA's sums are in place: each finishes its outputs from its own
  // shared memory
  cluster.sync();
  const int cnt = min(per, M * SB_N - z * per);
  for (int i = tid; i < cnt; i += SB_THREADS) {
    const int o = z * per + i, m = o / SB_N, nl = o % SB_N;
    if (nl >= rows) continue;
    float v;
    if (PC) {
      int sum = 0;
      for (int r = 0; r < n_split; ++r) sum += tabi[r * per + i];
      v = (float)sum * (cs_s[nl] * S8_MUL);
    } else {
      // g = 0 .. G - 1 in order, as the plain twin adds them
      v = 0.f;
      for (int g = 0; g < G; ++g) v = v + tabf[g * per + i];
    }
    out[(size_t)m * N + n0 + nl] = v;
  }
}

template <bool PC>
int launch_stream(const int8_t* x, const int8_t* w, const float* s, float* o,
                  int M, int N, int K, int G, int n_split, int part,
                  cudaStream_t st) {
  const int tiles = (N + SB_N - 1) / SB_N;
  const StreamLayout L =
      stream_layout(M, G, part, part / (K / G), n_split, PC);
  if (n_split > MAX_CLUSTER || tiles > 65535 || L.total > SB_SMEM_MAX ||
      (uintptr_t)x % 16 || (uintptr_t)w % 16)
    return (int)cudaErrorInvalidValue;
  auto kernel = w4a8_stream_kernel<PC>;
  // per call: the attribute holds for the current device only
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, tiles);
  cfg.blockDim = dim3(SB_THREADS);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, w, s, o, M, N, K, G, part);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// tile 0: the weight stream (M <= 8), a cluster of n_split CTAs along K;
// 1: 64 x 64 tiles; 2: 128 x 128. n_split K parts of `part` packed bytes
// each (the tiles: pc only, grouped 1, K/2), at whole groups, covering
// K/2 once.
template <bool PC>
int launch(const void* x8, const void* q4, const void* gs, void* out, int M,
           int N, int K, int G, int tile, int n_split, int part,
           void* stream) {
  if (M < 1 || N < 1 || K % 2 || G < 2 || G % 2 || K % G)
    return (int)cudaErrorInvalidValue;
  const int gsz = K / G, KH = K / 2;
  if (gsz % 64 || gsz > 512 || (gsz & (gsz - 1)))
    return (int)cudaErrorInvalidValue;
  if ((M <= MAX_M_STREAM) != (tile == 0) || tile < 0 || tile > 2 ||
      G > MAX_G || n_split < 1 || part < 1 ||
      (long long)(n_split - 1) * part >= KH ||
      (long long)n_split * part < KH || (!PC && tile && n_split != 1) ||
      ((n_split > 1 || !tile) && part % gsz))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* x = (const int8_t*)x8;
  const int8_t* w = (const int8_t*)q4;
  const float* s = (const float*)gs;
  float* o = (float*)out;
  if (tile == 0)
    return launch_stream<PC>(x, w, s, o, M, N, K, G, n_split, part, st);
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

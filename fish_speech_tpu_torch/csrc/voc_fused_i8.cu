// Vocoder residual-unit stacks and decoder blocks with int8 weights (the
// VOC_QUANT vocoder) as whole-sequence int8 GEMM passes over the TPU
// kernel's per-tile state: wgmma s8 fed by TMA.
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
// separate operations do, and the int8 codes and int32 sums are equal.
//
// What bounds them on the H100. Operations: a unit at C channels costs
// 2 x 8 x C^2 int8 operations per row of a tile (its halo rows included);
// at 128 frames blocks 1-3 need ~0.73 TOP, 0.37 ms at the 1979 TOP/s int8
// roof, block 0's three calls 0.06 ms. Bytes, the design's own floor: a
// tile's scale is a max over the whole tile between two products, so the
// passes meet in device memory. Per unit and state element, the two
// quantize passes read the bf16 state and the f32 s2 and write codes
// (2 + 1 + 4 + 1 bytes), the k7 pass reads codes and writes s2 (1 + 4),
// the 1x1 pass reads codes and reads and writes the state (1 + 2 + 2):
// ~18 bytes. At 128 frames the tiles of blocks 1-3 hold 68M state elements,
// ~3.7 GB over their nine units, ~1.1 ms at 3.35 TB/s: above the
// operations bound, so the passes aim at the memory rate.
//
// Design. The state lives in a tile-expanded scratch st (n = B * n_tiles
// tiles, R = halo + tt rows, C) bf16; q (int8 codes) and s2 (f32) have the
// same shape. Unit u (dilation d; rows [v, R) of a tile are its input,
// v = 6 * the earlier units' dilations) runs as four device kernels:
//   quantize: q = codes of snake1(st) over rows [v, R), with the tile's m1
//     taken by the kernel before (8 channels a thread, 16-byte loads);
//   k7 pass: s2 = snake2(f32(sum_i q[r - 6d + i*d] @ w7[i]) * scale + b1)
//     over rows [v + 6d, R) in f32, and the tile's max |s2| (m2);
//   quantize: q = codes of s2 with m2, over the same rows;
//   1x1 pass: st = bf16(st + f32(q @ w1) * scale + b2) in place; with a
//     next unit, the tile's max |snake1_next(st)| over the rows written,
//     which is the next unit's m1.
// Tile maxima fold across CTAs with atomicMax on the float's bits (values
// >= 0; the max does not depend on the order). Every pass is one kernel,
// i8_pass_kernel<BM, BN>: BM x BN output tiles over the rows of one tile
// (grid z), the operand a 3-D tensor map (K bytes, rows, tiles), so a box
// that overhangs a tile's last row arrives as zeros and never reads the
// next tile; K in steps of 128 bytes (128-byte swizzle), else 64 or 32
// (block 3's C = 96); a ring of stages one producer warp fills with TMA,
// full / empty mbarriers (mbarrier.cuh); wgmma m64nBNk32 s32.s8.s8 from
// K-major descriptors of A and W^T (transposed at pack time), int32 sums in
// registers. Tap i of the k7 conv is the box at row r0 - 6d + i*d of the
// same tile: no im2col. A weight tile serves BM rows; tiles come from
// ops/voc_fused.py::voc_i8_plan by id. The epilogue stages the sums in
// shared memory and gives each thread 8 consecutive columns (16-byte
// loads and stores), in three modes: TCONV (the block's transposed conv
// as two phase taps over the quantized slab; writes state row rr*stride +
// col/C, zero before the sequence start, and unit 0's m1), K7 and RES.
// The block: slab max, slab quantize, TCONV, the three units, then the
// tile's tt rows out through the tail snake, or through the final k7 conv
// (C -> 1) and tanh. The res stack: gather (the tile windows of x and
// their m1), one unit, out.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "voc_common.cuh"

namespace {

constexpr int NTHR = 256, NWARP = NTHR / 32;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int MAX_ST = 8;           // ring stages, at most
// f32(1/127) as Python and JAX round it (from the double quotient)
#define INV127 ((float)(1.0 / 127.0))

// the tile scale's code: round half away from zero (the cast truncates)
__device__ __forceinline__ int8_t quant8(float s, float k) {
  return (int8_t)(int)(s * k + (s >= 0.f ? 0.5f : -0.5f));
}

__device__ __forceinline__ float tile_m(const float* amax, int tile) {
  return fmaxf(amax[tile], 1e-12f);
}

__device__ __forceinline__ void atomic_max_pos(float* dst, float v) {
  if (v > 0.f) atomicMax(reinterpret_cast<int*>(dst), __float_as_int(v));
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
    atomic_max_pos(dst, m);
  }
}

// ------------------------------------------------------ elementwise kernels

// st[tile] = the tile's window of x: rows [j*tt - halo, j*tt + tt), zero
// before the sequence start (the res stack's input), and the tile's
// max |snake1(st)| into m1; 8 channels a thread
__global__ void __launch_bounds__(NTHR) gather_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ st, int T, int C,
    int n_tiles, int tt, int halo, const float* __restrict__ vec,
    float* m1) {
  const int tile = blockIdx.y, b = tile / n_tiles, j = tile % n_tiles;
  const int R = halo + tt, c8n = C / 8;
  const int e = blockIdx.x * NTHR + threadIdx.x;
  float m = 0.f;
  if (e < R * c8n) {
    const int r = e / c8n, c = e % c8n * 8, g = j * tt - halo + r;
    const uint4 u = g >= 0 ? *reinterpret_cast<const uint4*>(
                                 x + ((size_t)b * T + g) * C + c)
                           : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(st + ((size_t)tile * R + r) * C + c) = u;
    float v[8], a[8], s[8];
    unpack8(u, v);
    prm8(vec, c, a);
    prm8(vec + C, c, s);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      m = fmaxf(m, fabsf(snake8_one(v[k], a[k], s[k])));
  }
  block_max_to(m1 + tile, m);
}

// the block's transposed-conv input slab of each tile: input rows
// [j*tt_in - lead, j*tt_in - lead + n_slab), lead = halo/stride + 1, zero
// before the sequence start; its max |x| (8 channels a thread)
__global__ void __launch_bounds__(NTHR) slab_amax_kernel(
    const bf16* __restrict__ x, int T_in, int C_in, int n_tiles, int tt_in,
    int lead, int n_slab, float* amax) {
  const int tile = blockIdx.y, b = tile / n_tiles, j = tile % n_tiles;
  const int c8n = C_in / 8, e = blockIdx.x * NTHR + threadIdx.x;
  float m = 0.f;
  const int g = j * tt_in - lead + e / c8n;
  if (e < n_slab * c8n && g >= 0) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(
                x + ((size_t)b * T_in + g) * C_in + e % c8n * 8),
            v);
#pragma unroll
    for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(v[k]));
  }
  block_max_to(amax + tile, m);
}

// what a quantize pass reads: the slab rows of x, snake1 of the state, s2
enum QuantSrc { Q_SLAB = 0, Q_SNAKE = 1, Q_S2 = 2 };

struct Quant {
  int src;
  const void* x;        // SLAB: (B, T_in, C) bf16; SNAKE: st; S2: s2
  int8_t* q;            // (n, R, C) codes
  const float* m;       // (n) the tile scales
  const float* sa;      // SNAKE: alpha/pi, then 1/(alpha+eps) at sa + C
  int R, C, v;          // rows [v, R) of each tile
  int n_tiles, T_in, tt_in, lead;   // SLAB: input row j*tt_in - lead + r
};

// q[tile, r] = codes of the source row with the tile's scale; 8 channels a
// thread (16- or 32-byte loads, an 8-byte store)
__global__ void __launch_bounds__(NTHR) quant_kernel(const Quant p) {
  const int tile = blockIdx.y, c8n = p.C / 8;
  const int e = blockIdx.x * NTHR + threadIdx.x;
  if (e >= (p.R - p.v) * c8n) return;
  const int r = p.v + e / c8n, c = e % c8n * 8;
  const size_t at = ((size_t)tile * p.R + r) * p.C + c;
  float v[8];
  if (p.src == Q_S2) {
    prm8(static_cast<const float*>(p.x) + at, 0, v);
  } else if (p.src == Q_SNAKE) {
    unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.x) +
                                            at),
            v);
    float a[8], s[8];
    prm8(p.sa, c, a);
    prm8(p.sa + p.C, c, s);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = snake8_one(v[k], a[k], s[k]);
  } else {
    const int b = tile / p.n_tiles, j = tile % p.n_tiles;
    const int g = j * p.tt_in - p.lead + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (g >= 0)
      u = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.x) +
                                          ((size_t)b * p.T_in + g) * p.C + c);
    unpack8(u, v);
  }
  const float k = 127.f / tile_m(p.m, tile);
  uint2 out;
  int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = quant8(v[i], k);
  *reinterpret_cast<uint2*>(p.q + at) = out;
}

// ------------------------------------------------------------ the GEMM pass

enum PassMode { TCONV = 0, K7 = 1, RES = 2 };

struct Pass {
  const int8_t* a;      // A: (n, a_rows, K) codes
  int a_rows, K;
  int n_taps, off0, tap_step;   // tap i reads A row r + off0 + i * tap_step
  const int8_t* wt;     // W^T: (n_taps, N, K)
  int N, m_lo, m_hi;    // output rows [m_lo, m_hi) of each tile, columns N
  int mode;
  const float* scale;   // (N) the weights' scales / 127
  const float* bias;    // (N)
  const float* m_in;    // (n) the codes' tile scales
  float* m_out;         // (n) the tile max this pass takes, or null
  const float* sa;      // the snake of that max (TCONV: unit 0's snake1,
  const float* si;      //   by channel; K7: snake2; RES: the next snake1)
  bf16* st;             // (n, R, C) the state
  float* s2;            // (n, R, C)
  int C, R, halo, tt, stride, n_tiles;
  int bk, stages;       // K step in bytes (32, 64, 128), ring stages
};

__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n96(int (&d)[48], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 32) wgmma_s8_n32(d, da, db);
  else if constexpr (BN == 96) wgmma_s8_n96(d, da, db);
  else wgmma_s8_n128(d, da, db);
}

// the 8 columns [n, n + 8) of output row r, their f32 values v = f32(acc)
// * scale + bias, through the pass's mode (RES: `old` holds the residual);
// returns the contribution to the tile max (0 without m_out)
__device__ __forceinline__ float epilogue8(const Pass& p, int tile, int r,
                                           int n, float (&v)[8],
                                           const float* sa, const float* si,
                                           uint4 old) {
  float m = 0.f;
  if (p.mode == TCONV) {
    const int sr = r * p.stride + n / p.C, c = n % p.C;
    const int j = tile % p.n_tiles;
    if (j * p.tt + sr - p.halo < 0) {    // before the sequence start
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.f;
    }
    const uint4 u = pack8(v);
    *reinterpret_cast<uint4*>(p.st + ((size_t)tile * p.R + sr) * p.C + c) = u;
    if (p.m_out) {
      unpack8(u, v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        m = fmaxf(m, fabsf(snake8_one(v[k], sa[k], si[k])));
    }
  } else if (p.mode == K7) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = snake8_one(v[k], sa[k], si[k]);
      m = fmaxf(m, fabsf(v[k]));
    }
    float4* o = reinterpret_cast<float4*>(
        p.s2 + ((size_t)tile * p.R + r) * p.C + n);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4* at = reinterpret_cast<uint4*>(p.st + ((size_t)tile * p.R + r) *
                                                    p.C + n);
    float o[8];
    unpack8(old, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = o[k] + v[k];
    const uint4 u = pack8(v);
    *at = u;
    if (p.m_out) {
      unpack8(u, v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        m = fmaxf(m, fabsf(snake8_one(v[k], sa[k], si[k])));
    }
  }
  return m;
}

template <int BM, int BN>
struct I8Shape {
  static constexpr int WGS = BM / 64;
  static constexpr int CONS = WGS * 128;
  static constexpr int THREADS = CONS + 32;
  static constexpr int LDO = BN + 8;     // ints a row of the staged sums
  static constexpr int OUT = BM * LDO * 4;
};

template <int BM, int BN>
__global__ void __launch_bounds__(I8Shape<BM, BN>::THREADS)
    i8_pass_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, const Pass p) {
  using S = I8Shape<BM, BN>;
  constexpr int CONS = S::CONS, LDO = S::LDO;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) &
                                         ~(uintptr_t)1023);
  __shared__ __align__(8) uint64_t full[MAX_ST], empty[MAX_ST];
  __shared__ __align__(16) float c_scale[BN], c_bias[BN], c_sa[BN], c_si[BN];
  const int tid = threadIdx.x;
  const int r0 = p.m_lo + blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tile = blockIdx.z;
  const int bk = p.bk, ST = p.stages, stage = (BM + BN) * bk;
  const int kt = p.K / bk, nsteps = p.n_taps * kt;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= CONS) {                       // the producer warp
    if (tid == CONS) {
      for (int step = 0; step < nsteps; ++step) {
        const int s = step % ST;
        if (step >= ST) mbar_wait(&empty[s], (step / ST - 1) & 1);
        mbar_expect_tx(&full[s], stage);
        const int tap = step / kt, kc = (step % kt) * bk;
        unsigned char* st = smem + s * stage;
        tma_load3(st, &ta, kc, r0 + p.off0 + tap * p.tap_step, tile,
                  &full[s]);
        tma_load3(st + BM * bk, &tb, kc, n0, tap, &full[s]);
      }
    }
    return;
  }
  // the tile's per-column constants: the rescale (the weights' scale times
  // the codes' m / 127, in the twin's order), the bias, the snake
  const float msc = tile_m(p.m_in, tile) * INV127;
  for (int j = tid; j < BN; j += CONS) {
    const int n = n0 + j, c = p.mode == TCONV ? n % p.C : n;
    c_scale[j] = p.scale[n] * msc;
    c_bias[j] = p.bias[n];
    c_sa[j] = p.sa ? p.sa[c] : 0.f;
    c_si[j] = p.sa ? p.si[c] : 0.f;
  }
  // K-major rows of bk bytes in the swizzle of that width (8-row atoms of
  // 8 * bk bytes): LBO 1 (unused), SBO 8 * bk bytes, layout B128, B64, B32
  const uint64_t desc_hi = (1ull << 16) | ((uint64_t)(bk / 2) << 32) |
                           ((uint64_t)(bk == 128 ? 1 : bk == 64 ? 2 : 3)
                            << 62);
  const int g = tid / 128;
  int d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;
  for (int step = 0; step < nsteps; ++step) {
    const int s = step % ST;
    mbar_wait(&full[s], (step / ST) & 1);
    const unsigned char* st = smem + s * stage;
    const uint64_t da =
        desc_hi | ((smem_u32(st + g * 64 * bk) & 0x3FFFF) >> 4);
    const uint64_t db = desc_hi | ((smem_u32(st + BM * bk) & 0x3FFFF) >> 4);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // 32 bytes a k32: +2 in the descriptor
      if (kk * 32 < bk) wgmma_s8<BN>(d, da + 2 * kk, db + 2 * kk);
    wg_commit();
    wg_wait<1>();                 // the step before has left its stage
    if (step > 0 && tid % 128 == 0) mbar_arrive(&empty[(step - 1) % ST]);
  }
  wg_wait<0>();
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONS));   // the ring is free

  int* out = reinterpret_cast<int*>(smem);
  const int w = (tid % 128) / 32, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g * 64 + w * 16 + h * 8 + (lane >> 2);
      *reinterpret_cast<int2*>(out + row * LDO + j * 8 + 2 * (lane & 3)) =
          make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  // RES: the residuals of this thread's chunks, all loads in flight at once
  // where BN < 128, else each just before its chunk (preloading them raised
  // the 128-column tiles from 90 to 109 registers a thread, and their
  // passes ran 40% slower on the H100)
  constexpr int CH = BN / 8, ITEMS = BM * CH / CONS;
  constexpr int PRE = BN < 128 ? ITEMS : 1;
  static_assert(BM * CH % CONS == 0, "whole chunks a thread");
  auto residual = [&](int it) {
    const int e = tid + it * CONS, row = e / CH, c8 = e % CH * 8;
    return p.mode == RES && r0 + row < p.m_hi
               ? *reinterpret_cast<const uint4*>(
                     p.st + ((size_t)tile * p.R + r0 + row) * p.C + n0 + c8)
               : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 old[PRE];
#pragma unroll
  for (int it = 0; it < PRE && PRE > 1; ++it) old[it] = residual(it);
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONS));
  float lmax = 0.f;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = tid + it * CONS, row = e / CH, c8 = e % CH * 8;
    if (r0 + row >= p.m_hi) continue;
    if (PRE == 1) old[0] = residual(it);
    const int4 lo = *reinterpret_cast<const int4*>(out + row * LDO + c8);
    const int4 hi = *reinterpret_cast<const int4*>(out + row * LDO + c8 + 4);
    const int acc[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float v[8], sc[8], bi[8], sa[8], si[8];
    prm8(c_scale, c8, sc);
    prm8(c_bias, c8, bi);
    prm8(c_sa, c8, sa);
    prm8(c_si, c8, si);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = (float)acc[k] * sc[k] + bi[k];
    lmax = fmaxf(lmax, epilogue8(p, tile, r0 + row, n0 + c8, v, sa, si,
                                 old[PRE > 1 ? it : 0]));
  }
  if (p.m_out) {
    for (int o = 16; o > 0; o >>= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
    if (lane == 0) atomic_max_pos(p.m_out + tile, lmax);
  }
}

template <int BM, int BN>
cudaError_t launch_i8(Pass p, int n, cudaStream_t stream) {
  using S = I8Shape<BM, BN>;
  p.bk = p.K % 128 == 0 ? 128 : p.K % 64 == 0 ? 64 : 32;
  const int stage = (BM + BN) * p.bk;
  p.stages = wg_stages(stage, MAX_ST);
  const int smem = 1024 + (p.stages * stage > S::OUT ? p.stages * stage
                                                     : S::OUT);
  CUtensorMap ta, tb;
  cudaError_t e = make_map(&ta, p.a, 1, p.K, p.a_rows, n, BM, p.bk);
  if (e == cudaSuccess)
    e = make_map(&tb, p.wt, 1, p.K, p.N, p.n_taps, BN, p.bk);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(i8_pass_kernel<BM, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.m_hi - p.m_lo + BM - 1) / BM, p.N / BN, n);
  i8_pass_kernel<BM, BN><<<grid, S::THREADS, smem, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

// (BM, BN) of the tile ids the wrapper's plan hands over (I8_TILES in
// ops/voc_fused.py)
constexpr int N_I8_TILES = 3;
constexpr int I8_TILE_BN[N_I8_TILES] = {32, 96, 128};

cudaError_t run_pass(int tile, const Pass& p, int n, cudaStream_t stream) {
  if (tile < 0 || tile >= N_I8_TILES || p.N % I8_TILE_BN[tile] ||
      p.K % 32 || p.m_hi <= p.m_lo)
    return cudaErrorInvalidValue;
  switch (tile) {
    case 0: return launch_i8<64, 32>(p, n, stream);
    case 1: return launch_i8<128, 96>(p, n, stream);
    default: return launch_i8<128, 128>(p, n, stream);
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// codes of rows [v, R) of every tile of the source into q
cudaError_t quantize(Quant qp, int n, cudaStream_t stream) {
  quant_kernel<<<dim3(cdiv((qp.R - qp.v) * (qp.C / 8), NTHR), n), NTHR, 0,
                 stream>>>(qp);
  return cudaGetLastError();
}

// the unit (dilation d) on rows [v, R) of every tile: m (2, n) holds its
// m1, taken by the kernel before, and receives m2; m_next (n) receives
// the next unit's m1 (null: no next unit, vec_next unread)
cudaError_t run_unit(bf16* st, int8_t* q, float* s2, int n, int R, int C,
                     int v, int d, const int8_t* w7t, const int8_t* w1t,
                     const float* vec, const float* vec_next, float* m,
                     float* m_next, const int* tiles, cudaStream_t stream) {
  const int rf = 6 * d;
  Quant qp = {};
  qp.src = Q_SNAKE;
  qp.x = st;
  qp.q = q;
  qp.m = m;
  qp.sa = vec;
  qp.R = R;
  qp.C = C;
  qp.v = v;
  cudaError_t e = quantize(qp, n, stream);
  if (e != cudaSuccess) return e;
  Pass p = {};
  p.a = q;
  p.a_rows = R;
  p.K = C;
  p.n_taps = 7;
  p.off0 = -rf;
  p.tap_step = d;
  p.wt = w7t;
  p.N = C;
  p.m_lo = v + rf;
  p.m_hi = R;
  p.mode = K7;
  p.scale = vec + 6 * C;
  p.bias = vec + 4 * C;
  p.m_in = m;
  p.m_out = m + n;
  p.sa = vec + 2 * C;
  p.si = vec + 3 * C;
  p.st = st;
  p.s2 = s2;
  p.C = C;
  p.R = R;
  e = run_pass(tiles[0], p, n, stream);
  if (e != cudaSuccess) return e;
  qp.src = Q_S2;
  qp.x = s2;
  qp.m = m + n;
  qp.v = v + rf;
  e = quantize(qp, n, stream);
  if (e != cudaSuccess) return e;
  p.n_taps = 1;
  p.off0 = 0;
  p.tap_step = 0;
  p.wt = w1t;
  p.mode = RES;
  p.scale = vec + 7 * C;
  p.bias = vec + 5 * C;
  p.m_in = m + n;
  p.m_out = m_next;
  p.sa = m_next ? vec_next : nullptr;
  p.si = m_next ? vec_next + C : nullptr;
  return run_pass(tiles[1], p, n, stream);
}

// ------------------------------------------------------------- the output

// y[b, j*tt + rr] = the tile's row halo + rr, through the tail snake; 8
// channels a thread
__global__ void __launch_bounds__(NTHR) out_kernel(
    const bf16* __restrict__ st, bf16* __restrict__ y, int C, int n_tiles,
    int tt, int halo, const float* __restrict__ tail) {
  const int tile = blockIdx.y, b = tile / n_tiles, j = tile % n_tiles;
  const int c8n = C / 8, e = blockIdx.x * NTHR + threadIdx.x;
  if (e >= tt * c8n) return;
  const int rr = e / c8n, c = e % c8n * 8;
  uint4 u = *reinterpret_cast<const uint4*>(
      st + ((size_t)tile * (halo + tt) + halo + rr) * C + c);
  if (tail) {
    float v[8], a[8], s[8];
    unpack8(u, v);
    prm8(tail, c, a);
    prm8(tail + C, c, s);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = snake8_one(v[k], a[k], s[k]);
    u = pack8(v);
  }
  *reinterpret_cast<uint4*>(
      y + ((size_t)b * n_tiles * tt + (size_t)j * tt + rr) * C + c) = u;
}

// the decoder-final k7 conv (C -> 1) and tanh: wave[t] from the tile's
// rows [halo - 6 + t, halo + t] through the tail snake, rounded to bf16. A
// CTA stages its FC_ROWS + 6 rows, each snaked once (8 channels a thread),
// and the taps in shared memory, then a warp a row: lanes over the
// channels, a butterfly over the lanes (the f32 sum in another order than
// the plain twin's: within one int8 step of it)
constexpr int FC_ROWS = 128;

size_t final_smem(int C) {
  return (size_t)(FC_ROWS + 6) * C * 2 + (size_t)8 * C * 4;
}

__global__ void __launch_bounds__(NTHR) final_kernel(
    const bf16* __restrict__ st, bf16* __restrict__ wave, int C,
    int n_tiles, int tt, int halo, const float* __restrict__ tail,
    const float* __restrict__ fw) {
  extern __shared__ __align__(16) unsigned char fc_smem[];
  float* taps = reinterpret_cast<float*>(fc_smem);            // (8, C)
  bf16* rows = reinterpret_cast<bf16*>(taps + 8 * C);          // (n, C)
  const int tile = blockIdx.y, b = tile / n_tiles, j = tile % n_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * FC_ROWS, n_out = min(FC_ROWS, tt - t0);
  const int c8n = C / 8;
  const bf16* src = st + ((size_t)tile * (halo + tt) + halo - 6 + t0) * C;
  for (int i = threadIdx.x; i < (n_out + 6) * c8n; i += NTHR) {
    uint4 u = reinterpret_cast<const uint4*>(src)[i];
    if (tail) {
      const int c = i % c8n * 8;
      float v[8], a[8], s[8];
      unpack8(u, v);
      prm8(tail, c, a);
      prm8(tail + C, c, s);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = snake8_one(v[k], a[k], s[k]);
      u = pack8(v);
    }
    reinterpret_cast<uint4*>(rows)[i] = u;
  }
  for (int i = threadIdx.x; i < 8 * C; i += NTHR) taps[i] = fw[i];
  __syncthreads();
  for (int rr = warp; rr < n_out; rr += NWARP) {
    float acc = 0.f;
    for (int c = lane; c < C; c += 32)
      for (int i = 0; i < 7; ++i)
        acc += b2f(rows[(rr + i) * C + c]) * taps[i * C + c];
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0)
      wave[(size_t)b * n_tiles * tt + (size_t)j * tt + t0 + rr] =
          f2b(tanhf(acc + taps[7 * C]));
  }
}

}  // namespace

// One residual unit (dilation d) of an int8 pack over x (B, T, C) bf16 ->
// y, in the TPU kernel's tiles of tt rows with halo rows of left context.
// w7t (7, C, C) and w1t (C, C) are the weights as (out, in); vec (8, C);
// tail (2, C) or null. Scratch: st (n = B*T/tt, halo+tt, C) bf16, q the
// same in int8, s2 in f32, amax (2, n) f32; tiles: the k7 and 1x1 passes'
// tile ids (ops/voc_fused.py::voc_i8_plan). A memset, gather, the unit's
// four kernels and out, in stream order.
extern "C" int voc_res_stack_i8(const void* x, void* y, const void* w7t,
                                const void* w1t, const void* vec,
                                const void* tail, void* st, void* q,
                                void* s2, void* amax, const int* tiles,
                                int B, int T, int C, int d, int tt, int halo,
                                int has_tail, void* stream) {
  if (B < 1 || tt < 1 || T % tt || C % 32 || d < 1 || halo < 6 * d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = T / tt, n = B * n_tiles, R = halo + tt;
  float* am = (float*)amax;
  const float* v = (const float*)vec;
  cudaError_t err = cudaMemsetAsync(am, 0, sizeof(float) * 2 * n, s);
  if (err != cudaSuccess) return (int)err;
  gather_kernel<<<dim3(cdiv(R * (C / 8), NTHR), n), NTHR, 0, s>>>(
      (const bf16*)x, (bf16*)st, T, C, n_tiles, tt, halo, v, am);
  err = run_unit((bf16*)st, (int8_t*)q, (float*)s2, n, R, C, 0, d,
                 (const int8_t*)w7t, (const int8_t*)w1t, v, nullptr, am,
                 nullptr, tiles, s);
  if (err != cudaSuccess) return (int)err;
  out_kernel<<<dim3(cdiv(tt * (C / 8), NTHR), n), NTHR, 0, s>>>(
      (const bf16*)st, (bf16*)y, C, n_tiles, tt, halo,
      has_tail ? (const float*)tail : nullptr);
  return (int)cudaGetLastError();
}

// One decoder block of an int8 pack: x (B, T_in, C_in) bf16 -> y (B,
// T_in*stride, C), or with final != 0 the (B, T_in*stride) waveform through
// fw (8, C). pwt (2, stride*C, C_in) are the phase weights as (out, in), pb
// (2, stride*C) the bias and the phase scales / 127; w7t (3, 7, C, C), w1t
// (3, C, C), vec (3, 8, C). Scratch as voc_res_stack_i8, with q holding
// the larger of a tile's state and its slab ((halo+tt)/stride + 1 rows of
// C_in) a tile and amax (7, n); tiles: 7 tile ids (tconv, then k7 and 1x1
// of each unit). A memset, the slab max and quantize, the tconv pass, each
// unit's four kernels and out (or the final conv), in stream order.
extern "C" int voc_block_i8(const void* x, void* y, const void* pwt,
                            const void* pb, const void* w7t, const void* w1t,
                            const void* vec, const void* tail, const void* fw,
                            void* st, void* q, void* s2, void* amax,
                            const int* tiles, int B, int T_in, int C_in,
                            int C, int stride, int d0, int d1, int d2, int tt,
                            int halo, int final_conv, void* stream) {
  const int dil[3] = {d0, d1, d2};
  const int T = T_in * stride;
  int rf = 0;
  for (int u = 0; u < 3; ++u) rf += 6 * dil[u];
  if (B < 1 || stride < 1 || tt < 1 || T % tt || tt % stride ||
      halo % stride || C % 32 || C_in % 32 || d0 < 1 || d1 < 1 || d2 < 1 ||
      halo < rf + (final_conv ? 6 : 0) || (final_conv && !fw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = T / tt, n = B * n_tiles, R = halo + tt;
  const int n_in = R / stride, tt_in = tt / stride, lead = halo / stride + 1;
  float* am = (float*)amax;
  const float* v = (const float*)vec;             // (3, 8, C)
  cudaError_t err = cudaMemsetAsync(am, 0, sizeof(float) * 7 * n, s);
  if (err != cudaSuccess) return (int)err;
  slab_amax_kernel<<<dim3(cdiv((n_in + 1) * (C_in / 8), NTHR), n), NTHR, 0,
                     s>>>(
      (const bf16*)x, T_in, C_in, n_tiles, tt_in, lead, n_in + 1, am);
  Quant qp = {};
  qp.src = Q_SLAB;
  qp.x = x;
  qp.q = (int8_t*)q;
  qp.m = am;
  qp.R = n_in + 1;
  qp.C = C_in;
  qp.n_tiles = n_tiles;
  qp.T_in = T_in;
  qp.tt_in = tt_in;
  qp.lead = lead;
  err = quantize(qp, n, s);
  if (err != cudaSuccess) return (int)err;
  // the transposed conv: tap 0 reads slab rows rr + 1 with pw0, tap 1 rows
  // rr with pw1
  Pass p = {};
  p.a = (const int8_t*)q;
  p.a_rows = n_in + 1;
  p.K = C_in;
  p.n_taps = 2;
  p.off0 = 1;
  p.tap_step = -1;
  p.wt = (const int8_t*)pwt;
  p.N = stride * C;
  p.m_lo = 0;
  p.m_hi = n_in;
  p.mode = TCONV;
  p.scale = (const float*)pb + stride * C;
  p.bias = (const float*)pb;
  p.m_in = am;
  p.m_out = am + n;
  p.sa = v;
  p.si = v + C;
  p.st = (bf16*)st;
  p.C = C;
  p.R = R;
  p.halo = halo;
  p.tt = tt;
  p.stride = stride;
  p.n_tiles = n_tiles;
  err = run_pass(tiles[0], p, n, s);
  if (err != cudaSuccess) return (int)err;
  int lo = 0;
  for (int u = 0; u < 3; ++u) {
    err = run_unit((bf16*)st, (int8_t*)q, (float*)s2, n, R, C, lo, dil[u],
                   (const int8_t*)w7t + (size_t)u * 7 * C * C,
                   (const int8_t*)w1t + (size_t)u * C * C,
                   v + (size_t)u * 8 * C,
                   u < 2 ? v + (size_t)(u + 1) * 8 * C : nullptr,
                   am + (1 + 2 * u) * n, u < 2 ? am + (3 + 2 * u) * n : nullptr,
                   tiles + 1 + 2 * u, s);
    if (err != cudaSuccess) return (int)err;
    lo += 6 * dil[u];
  }
  const float* tl = tail ? (const float*)tail : nullptr;
  if (final_conv) {
    const size_t smem = final_smem(C);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(final_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    final_kernel<<<dim3(cdiv(tt, FC_ROWS), n), NTHR, smem, s>>>(
        (const bf16*)st, (bf16*)y, C, n_tiles, tt, halo, tl,
        (const float*)fw);
  } else {
    out_kernel<<<dim3(cdiv(tt * (C / 8), NTHR), n), NTHR, 0, s>>>(
        (const bf16*)st, (bf16*)y, C, n_tiles, tt, halo, tl);
  }
  return (int)cudaGetLastError();
}

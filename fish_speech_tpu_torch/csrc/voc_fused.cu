// Vocoder residual-unit stacks and decoder blocks on bf16 tensor cores.
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
// at the 989 TFLOP/s bf16 roof. The whole-sequence passes add a second
// floor, their scratch traffic: each unit writes and reads s2 and the
// state, ~25-50 MB a pass at F = 128 (see the block section).
//
// Both run as whole-sequence GEMM passes on wgmma fed by TMA (the block
// section): voc_block seven a block, voc_res_stack two a unit after an
// elementwise entry snake (the res-stack section at the end). Rows before
// the sequence start model zero padding (after the block's transposed
// conv; before a unit's input), as in the TPU kernel.
// Snake uses the TPU kernel's degree-7 polynomial for sin^2 with alpha/pi
// premultiplied, so both agree to f32 rounding.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "voc_common.cuh"

namespace {

constexpr int NTHR = 256, NWARP = NTHR / 32;
constexpr int SMEM_LIMIT = 227 * 1024;

// -------------------------------------------------------------------- block
//
// A decoder block as whole-sequence passes over scratch the wrapper owns:
// the state x, its entry snake sn (the next k7 conv's operand) and the
// second snake s2 (the 1x1 conv's operand), each (B, R, C) bf16 with
// R = H + T rows, H = 6 * sum(d) (+ 6 with the final conv) rows of left
// context first. Rows are absolute: unit u (dilation d) computes rows
// [v + 6d, R), where v = 6 * (the earlier units' dilations), from rows
// [v, R) of sn, so no pass recomputes a halo. The passes, in stream order:
//   memsets: rows [0, H) of x and sn (the zeros before the sequence
//     start; snake(0) = 0), once;
//   tconv: x[H + t*s + p] = bf16(x_in[t] @ pw0[:, p] + x_in[t-1] @ pw1[:, p]
//     + pb), sn = bf16(snake_u0(x)): a GEMM of T_in rows, s*C columns and
//     2 taps of C_in;
//   per unit, k7: s2[r] = bf16(snake2(b1 + sum_i sn[r - 6d + i*d] @ w7[i]))
//     (7 taps of C, no im2col: tap i reads sn shifted by i*d rows), then
//     1x1: x[r] = bf16(x[r] + s2[r] @ w1 + b2) in place (a thread reads and
//     writes its own elements: no race), and sn = bf16(snake1 of the next
//     unit (x)); the last unit writes bf16(tail(x)) to y, or, with the final
//     conv, back to x rows [H - 6, R);
//   final: wave[t] = tanh(sum_{i<7} x[H - 6 + t + i] . fw[i] + bias).
// So each snake runs once an element a unit, in the epilogue that makes
// its input. The k7 and 1x1 convs are two passes, not one: a fused unit
// would hold a row tile's k7 sums over all C columns, and W1, in one CTA:
// at C = 384 that leaves block 1 at F = 16 with fewer CTAs than SMs, and
// at C = 192 one CTA an SM (192-column tiles, tried, ran slower than two
// CTAs of 96 columns). Split, each pass tiles its rows and columns
// (ops/voc_fused.py::voc_block_plan picks a tile a pass from the shapes
// and the SM count), at the price of writing and reading s2 once a unit.
//
// Every GEMM pass is one kernel, wg_pass_kernel: BM x BN output tiles (BM
// = 64 a consumer warpgroup, 64 or 128; BN 32-128), K in steps of 64
// (128-byte swizzle) or, where 64 does not divide K, 32 (64-byte swizzle)
// through a ring of stages that one producer warp fills with TMA (rows
// outside the tensor, before the sequence start or past its end, arrive
// as zeros: the tconv's x[t - 1] at t = 0), full / empty mbarriers between
// the producer and the consumers, wgmma m64nBNk16 from shared-memory
// descriptors of the K-major A tile and the K-major W^T tile (the weights
// transposed at pack time), f32 sums in registers. A weight tile serves BM
// rows. The epilogue stages the sums in shared memory and gives each
// thread 8 consecutive columns: 16-byte loads and stores, the tile's
// bias and snake constants from shared memory, bf16 rounding two values
// an instruction, and the snake's truncation on the FP32 pipe
// (snake8_one): the conversion pipe, a quarter of the FP32 rate, limited
// the epilogue.
// (A first version on mma.sync m16n8k16 with ldmatrix and a cp.async
// ring, 8 warps, was 1.3-1.8x slower on blocks 1-2; PERF.md.)

enum PassMode { TCONV = 0, K7 = 1, RES = 2 };

struct Pass {
  const bf16* a;       // A: (B, a_rows, K)
  int a_rows, K;
  int n_taps, off0, tap_step;   // tap i reads A row r + off0 + i * tap_step
  const bf16* wt;      // W^T: (n_taps, N, K)
  int N, m_lo, m_hi;   // output rows [m_lo, m_hi), columns [0, N)
  int mode;
  const float* bias;   // (N)
  const float* sa;     // snake constants (alpha/pi, 1/(alpha+eps)) by
  const float* si;     //   channel; RES: the next unit's, or null
  const float* tail;   // RES, last unit: (2, C) or null
  bf16* x;             // (B, R, C) state (RES: the residual)
  bf16* sn;            // (B, R, C) its entry snake
  bf16* s2;            // (B, R, C)
  bf16* y;             // RES, last unit: (B, T, C) output, or null (final)
  int C, R, H, T, stride;
};

// the tile's per-column constants in shared memory: bias, then the snake's
// alpha/pi and 1/(alpha+eps) (TCONV: unit 0's, by channel n % C; K7: the
// second snake's; RES: the next unit's or the tail's)
struct TilePrm {
  float bias[128], sa[128], si[128];
};

__device__ __forceinline__ void load_prm(const Pass& p, int n0, int bn,
                                         int tid, int threads, TilePrm& t) {
  const float* sa = p.sa ? p.sa : p.tail;
  const float* si = p.sa ? p.si : (p.tail ? p.tail + p.C : nullptr);
  for (int j = tid; j < bn; j += threads) {
    const int n = n0 + j, c = p.mode == TCONV ? n % p.C : n;
    t.bias[j] = p.bias[n];
    t.sa[j] = sa ? sa[c] : 0.f;
    t.si[j] = sa ? si[c] : 0.f;
  }
}

// where the epilogue of output row r, columns [n, n + 8), batch row b
// reads the residual (RES)
__device__ __forceinline__ const bf16* res_at(const Pass& p, int b, int r,
                                              int n) {
  return p.x + ((size_t)b * p.R + r) * p.C + n;
}

// the epilogue of output row r, tile columns [j, j + 8) (column n = n0 +
// j, j % 8 == 0), batch row b: v holds the f32 sums, old (RES) the
// residual at res_at
__device__ __forceinline__ void pass_epilogue8(const Pass& p,
                                               const TilePrm& t, int b, int r,
                                               int n, int j, float (&v)[8],
                                               uint4 old) {
  float bias[8], sa[8], si[8];
  prm8(t.bias, j, bias);
  prm8(t.sa, j, sa);
  prm8(t.si, j, si);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = v[k] + bias[k];
  size_t at = ((size_t)b * p.R + r) * p.C + n;
  bf16* xo = p.x;                // where the state goes
  bf16* so = p.sn;               // where its snake goes (null: none)
  if (p.mode == TCONV) {
    at = ((size_t)b * p.R + p.H + (size_t)r * p.stride + n / p.C) * p.C +
         n % p.C;
  } else if (p.mode == K7) {
    xo = nullptr;
    so = p.s2;
  } else {
    float o[8];
    unpack8(old, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = o[k] + v[k];
    if (!p.sa) {                 // the last unit: tail, then y or x
      so = nullptr;
      if (p.tail) {
        unpack8(pack8(v), v);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = snake8_one(v[k], sa[k], si[k]);
      }
      if (p.y) {
        xo = p.y;
        at = ((size_t)b * p.T + r - p.H) * p.C + n;
      }
    }
  }
  if (xo) {
    const uint4 u = pack8(v);
    *reinterpret_cast<uint4*>(xo + at) = u;
    unpack8(u, v);
  }
  if (so) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = snake8_one(v[k], sa[k], si[k]);
    *reinterpret_cast<uint4*>(so + at) = pack8(v);
  }
}

// the epilogue of a BM x BN tile whose f32 sums are in shared memory
// (rows of BN + 8), by `threads` threads from thread `tid`: each takes
// ITEMS chunks of 8 columns, loads their residuals (RES) all at once, then
// computes and stores them
template <int BM, int BN, int THREADS>
__device__ __forceinline__ void tile_epilogue(const Pass& p, const TilePrm& t,
                                              const float* out, int tid,
                                              int r0, int n0, int b) {
  constexpr int LDO = BN + 8, CH = BN / 8, ITEMS = BM * CH / THREADS;
  static_assert(BM * CH % THREADS == 0, "whole chunks a thread");
  uint4 old[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = tid + it * THREADS, row = e / CH, c8 = e % CH * 8;
    old[it] = make_uint4(0u, 0u, 0u, 0u);
    if (p.mode == RES && r0 + row < p.m_hi)
      old[it] = *reinterpret_cast<const uint4*>(
          res_at(p, b, r0 + row, n0 + c8));
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = tid + it * THREADS, row = e / CH, c8 = e % CH * 8;
    if (r0 + row >= p.m_hi) continue;
    float v[8];
    prm8(out + row * LDO, c8, v);
    pass_epilogue8(p, t, b, r0 + row, n0 + c8, c8, v, old[it]);
  }
}

// a K-major tile of BK-wide bf16 rows (2 * BK bytes) in the swizzle of
// that width (8-row atoms of 16 * BK bytes): start address, LBO 1
// (unused), SBO 16 * BK bytes, layout B128 (BK = 64) or B64 (BK = 32)
template <int BK>
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)BK << 32) | ((BK == 64 ? 1ull : 2ull) << 62);
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 32) wgmma_n32(d, da, db);
  else if constexpr (BN == 64) wgmma_n64(d, da, db);
  else if constexpr (BN == 96) wgmma_n96(d, da, db);
  else wgmma_n128(d, da, db);
}

template <int BM, int BN, int BK>
struct WgShape {
  static constexpr int WGS = BM / 64;
  static constexpr int THREADS = WGS * 128 + 32;
  static constexpr int STAGE = (BM + BN) * BK * 2;   // A then W^T, bytes
  static constexpr int ST = wg_stages(STAGE, 8);
  static constexpr int OUT = BM * (BN + 8) * 4;
  static constexpr int SMEM =
      1024 + (ST * STAGE > OUT ? ST * STAGE : OUT);
};

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(WgShape<BM, BN, BK>::THREADS)
    wg_pass_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, const Pass p) {
  using S = WgShape<BM, BN, BK>;
  constexpr int ST = S::ST, CONS = S::WGS * 128;
  static_assert(BN <= 128 && BN % 32 == 0, "TilePrm holds 128 columns");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) &
                                         ~(uintptr_t)1023);
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  __shared__ __align__(16) TilePrm prm;
  const int tid = threadIdx.x;
  const int r0 = p.m_lo + blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int kt = (p.K + BK - 1) / BK, nsteps = p.n_taps * kt;
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
        mbar_expect_tx(&full[s], S::STAGE);
        const int tap = step / kt, kc = (step % kt) * BK;
        unsigned char* st = smem + s * S::STAGE;
        tma_load3(st, &ta, kc, r0 + p.off0 + tap * p.tap_step, b, &full[s]);
        tma_load3(st + BM * BK * 2, &tb, kc, n0, tap, &full[s]);
      }
    }
    return;
  }
  const int g = tid / 128;
  load_prm(p, n0, BN, tid, CONS, prm);
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  for (int step = 0; step < nsteps; ++step) {
    const int s = step % ST;
    mbar_wait(&full[s], (step / ST) & 1);
    const unsigned char* st = smem + s * S::STAGE;
    const uint64_t da = wg_desc<BK>(st + g * 64 * BK * 2);
    const uint64_t db = wg_desc<BK>(st + BM * BK * 2);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)   // 32 bytes a k16: +2 in the desc
      wgmma_bn<BN>(d, da + 2 * kk, db + 2 * kk);
    wg_commit();
    wg_wait<1>();                 // the step before has left its stage
    if (step > 0 && tid % 128 == 0) mbar_arrive(&empty[(step - 1) % ST]);
  }
  wg_wait<0>();
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONS));   // the ring is free

  float* out = reinterpret_cast<float*>(smem);
  constexpr int LDO = BN + 8;
  const int w = (tid % 128) / 32, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g * 64 + w * 16 + h * 8 + (lane >> 2);
      *reinterpret_cast<float2*>(out + row * LDO + j * 8 + 2 * (lane & 3)) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONS));
  tile_epilogue<BM, BN, CONS>(p, prm, out, tid, r0, n0, b);
}

// the decoder-final conv (C -> 1, 7 taps) and tanh after the tail snake:
// wave[t] from x rows [H - 6 + t, H + t]. A CTA stages its FC_ROWS + 6 rows
// and the taps in shared memory (16-byte loads, each row read once), then
// a warp a row: lanes over the channels, a butterfly over the lanes.
constexpr int FC_ROWS = 128;

size_t final_conv_smem(int C) {
  return (size_t)(FC_ROWS + 6) * C * 2 + (size_t)8 * C * 4;
}

__global__ void __launch_bounds__(NTHR) final_conv_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ wave,
    const float* __restrict__ fw, int T, int R, int H, int C) {
  extern __shared__ __align__(16) unsigned char fc_smem[];
  float* taps = reinterpret_cast<float*>(fc_smem);            // (8, C)
  bf16* rows = reinterpret_cast<bf16*>(taps + 8 * C);          // (n, C)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * FC_ROWS, b = blockIdx.y;
  const int n_out = min(FC_ROWS, T - t0), n = n_out + 6;
  const uint4* src = reinterpret_cast<const uint4*>(
      x + ((size_t)b * R + H - 6 + t0) * C);
  for (int i = threadIdx.x; i < n * C / 8; i += NTHR)
    reinterpret_cast<uint4*>(rows)[i] = src[i];
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
      wave[(size_t)b * T + t0 + rr] = f2b(tanhf(acc + taps[7 * C]));
  }
}

// K in steps of 64 (128-byte swizzle) where 64 divides it, else of 32
// (64-byte swizzle)
template <int BM, int BN, int BK>
cudaError_t launch_wg_k(const Pass& p, int B, cudaStream_t st) {
  using S = WgShape<BM, BN, BK>;
  CUtensorMap ta, tb;
  cudaError_t e = make_map(&ta, p.a, 2, p.K, p.a_rows, B, BM, BK);
  if (e == cudaSuccess) e = make_map(&tb, p.wt, 2, p.K, p.N, p.n_taps, BN, BK);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wg_pass_kernel<BM, BN, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((p.m_hi - p.m_lo + BM - 1) / BM, p.N / BN, B);
  wg_pass_kernel<BM, BN, BK><<<grid, S::THREADS, S::SMEM, st>>>(ta, tb, p);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_wg(const Pass& p, int B, cudaStream_t st) {
  return p.K % 64 ? launch_wg_k<BM, BN, 32>(p, B, st)
                  : launch_wg_k<BM, BN, 64>(p, B, st);
}

// BN of the tile ids the wrapper's plan hands over (TILE_SHAPES in
// ops/voc_fused.py: ids 0-3 have BM = 64, 4-7 BM = 128)
constexpr int N_TILE_SHAPES = 8;
constexpr int TILE_BN[N_TILE_SHAPES] = {32, 64, 96, 128, 32, 64, 96, 128};

cudaError_t run_pass(int tile, const Pass& p, int B, cudaStream_t st) {
  if (tile < 0 || tile >= N_TILE_SHAPES || p.N % TILE_BN[tile] ||
      p.K % 32 || p.m_hi <= p.m_lo)
    return cudaErrorInvalidValue;
  switch (tile) {
    case 0: return launch_wg<64, 32>(p, B, st);
    case 1: return launch_wg<64, 64>(p, B, st);
    case 2: return launch_wg<64, 96>(p, B, st);
    case 3: return launch_wg<64, 128>(p, B, st);
    case 4: return launch_wg<128, 32>(p, B, st);
    case 5: return launch_wg<128, 64>(p, B, st);
    case 6: return launch_wg<128, 96>(p, B, st);
    default: return launch_wg<128, 128>(p, B, st);
  }
}

// ---------------------------------------------------------------- res stack
//
// One residual unit (dilation d) over x (B, T, C) as three device kernels,
// each over the whole sequence, in stream order, with two (B, T, C) bf16
// scratch buffers the wrapper owns:
//   entry snake: sn = bf16(snake1(x)), 8 channels a thread (16-byte loads
//     and stores, snake8_one);
//   k7: s2[r] = bf16(snake2(b1 + sum_i sn[r - 6d + i*d] @ w7[i])), a K7
//     pass over sn's rows [0, T): its tensor map fills the rows before the
//     sequence start with zeros, which are snake1's value there (snake(0)
//     = 0), so sn needs no halo rows and no memset, and T may be shorter
//     than the 6d rows of left context;
//   1x1: y[r] = bf16(x[r] + s2[r] @ w1 + b2), then the tail snake when one
//     is given, a RES pass as a block's last unit (no next snake) whose
//     residual is x itself (R = T, H = 0) and whose result goes to y: the
//     caller's x is read, never written.
// A weight tile serves a BM-row tile of the whole sequence, and no pass
// recomputes a halo. Tiles come from ops/voc_fused.py::voc_res_plan (C a
// multiple of 32, as run_pass takes).

__global__ void __launch_bounds__(NTHR) snake_entry_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ sn,
    const float* __restrict__ alpha_pi, const float* __restrict__ inv,
    size_t n8, int C) {
  const size_t i = (size_t)blockIdx.x * NTHR + threadIdx.x;
  if (i >= n8) return;
  const int c = (int)(i * 8 % C);
  float v[8], a[8], s[8];
  unpack8(reinterpret_cast<const uint4*>(x)[i], v);
  prm8(alpha_pi, c, a);
  prm8(inv, c, s);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = snake8_one(v[k], a[k], s[k]);
  reinterpret_cast<uint4*>(sn)[i] = pack8(v);
}

}  // namespace

// One residual unit (dilation d) over x (B, T, C) bf16 -> y, with the
// optional tail snake (2, C) [alpha/pi, 1/(alpha+eps)]. Weights transposed,
// K-major: w7t (7, C, C) [i, out, in], w1t (C, C) [out, in]; vec (6, C)
// [alpha1/pi, 1/(alpha1+eps), alpha2/pi, 1/(alpha2+eps), b1, b2]. Scratch
// sn, s2: (B, T, C) bf16 each; tile_k7, tile_1x1: tile ids from
// ops/voc_fused.py::voc_res_plan. The entry snake, then two GEMM passes,
// in stream order.
extern "C" int voc_res_stack(const void* x, void* y, const void* w7t,
                             const void* w1t, const void* vec,
                             const void* tail, void* sn, void* s2,
                             int tile_k7, int tile_1x1, int B, int T, int C,
                             int d, int has_tail, void* stream) {
  if (C % 32 || B < 1 || T < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* v = (const float*)vec;
  const size_t n8 = (size_t)B * T * C / 8;
  snake_entry_kernel<<<(unsigned)((n8 + NTHR - 1) / NTHR), NTHR, 0, st>>>(
      (const bf16*)x, (bf16*)sn, v, v + C, n8, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Pass p = {};
  p.s2 = (bf16*)s2;
  p.C = C;
  p.R = T;
  p.H = 0;
  p.T = T;
  p.a = (const bf16*)sn;
  p.a_rows = T;
  p.K = C;
  p.n_taps = 7;
  p.off0 = -6 * d;
  p.tap_step = d;
  p.wt = (const bf16*)w7t;
  p.N = C;
  p.m_lo = 0;
  p.m_hi = T;
  p.mode = K7;
  p.bias = v + 4 * C;
  p.sa = v + 2 * C;
  p.si = v + 3 * C;
  e = run_pass(tile_k7, p, B, st);
  if (e != cudaSuccess) return (int)e;
  p.a = (const bf16*)s2;
  p.n_taps = 1;
  p.off0 = 0;
  p.tap_step = 0;
  p.wt = (const bf16*)w1t;
  p.mode = RES;
  p.bias = v + 5 * C;
  p.sa = nullptr;
  p.si = nullptr;
  p.tail = has_tail ? (const float*)tail : nullptr;
  p.x = (bf16*)x;             // the residual, read only (p.y is set)
  p.y = (bf16*)y;
  return (int)run_pass(tile_1x1, p, B, st);
}

// One decoder block: x (B, T_in, C_in) -> y (B, T_in*stride, C), or with
// final != 0 the (B, T_in*stride) waveform through fw (8, C). Weights
// transposed, K-major: pwt (2, stride*C, C_in), w7t (3, 7, C, C) [u, i, out,
// in], w1t (3, C, C) [u, out, in]. Scratch xs, sn, s2: (B, H + T, C) bf16
// each (H = 6 * (d0 + d1 + d2), + 6 when final); tiles: 7 tile ids (tconv,
// then k7 and 1x1 of each unit), from ops/voc_fused.py::voc_block_plan.
// Two memsets, seven GEMM passes and, when final, the final conv, in
// stream order.
extern "C" int voc_block(const void* x, void* y, const void* pwt,
                         const void* pb, const void* w7t, const void* w1t,
                         const void* vec, const void* tail, const void* fw,
                         void* xs, void* sn, void* s2, const int* tiles,
                         int B, int T_in, int C_in, int C, int stride,
                         int d0, int d1, int d2, int final_conv,
                         void* stream) {
  if (C % 32 || C_in % 32 || stride < 1 || B < 1 || T_in < 1 || d0 < 1 ||
      d1 < 1 || d2 < 1 || (final_conv && !fw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int T = T_in * stride, H = 6 * (d0 + d1 + d2) + (final_conv ? 6 : 0);
  const int R = H + T;
  const size_t pitch = (size_t)R * C * 2;
  cudaError_t e = cudaMemset2DAsync(xs, pitch, 0, (size_t)H * C * 2, B, st);
  if (e == cudaSuccess)
    e = cudaMemset2DAsync(sn, pitch, 0, (size_t)H * C * 2, B, st);
  if (e != cudaSuccess) return (int)e;
  const float* v = (const float*)vec;       // (3, 6, C)
  Pass p = {};
  p.x = (bf16*)xs;
  p.sn = (bf16*)sn;
  p.s2 = (bf16*)s2;
  p.C = C;
  p.R = R;
  p.H = H;
  p.T = T;
  p.stride = stride;
  // tconv: 2 taps over x_in rows t and t - 1
  p.a = (const bf16*)x;
  p.a_rows = T_in;
  p.K = C_in;
  p.n_taps = 2;
  p.off0 = 0;
  p.tap_step = -1;
  p.wt = (const bf16*)pwt;
  p.N = stride * C;
  p.m_lo = 0;
  p.m_hi = T_in;
  p.mode = TCONV;
  p.bias = (const float*)pb;
  p.sa = v;
  p.si = v + C;
  e = run_pass(tiles[0], p, B, st);
  if (e != cudaSuccess) return (int)e;
  const int dil[3] = {d0, d1, d2};
  int lo = 0;
  for (int u = 0; u < 3; ++u) {
    const float* vu = v + (size_t)u * 6 * C;
    lo += 6 * dil[u];
    p.a = (const bf16*)sn;
    p.a_rows = R;
    p.K = C;
    p.n_taps = 7;
    p.off0 = -6 * dil[u];
    p.tap_step = dil[u];
    p.wt = (const bf16*)w7t + (size_t)u * 7 * C * C;
    p.N = C;
    p.m_lo = lo;
    p.m_hi = R;
    p.mode = K7;
    p.bias = vu + 4 * C;
    p.sa = vu + 2 * C;
    p.si = vu + 3 * C;
    e = run_pass(tiles[1 + 2 * u], p, B, st);
    if (e != cudaSuccess) return (int)e;
    p.a = (const bf16*)s2;
    p.n_taps = 1;
    p.off0 = 0;
    p.tap_step = 0;
    p.wt = (const bf16*)w1t + (size_t)u * C * C;
    p.mode = RES;
    p.bias = vu + 5 * C;
    p.sa = u < 2 ? vu + 6 * C : nullptr;
    p.si = u < 2 ? vu + 7 * C : nullptr;
    p.tail = u == 2 ? (const float*)tail : nullptr;
    p.y = u == 2 && !final_conv ? (bf16*)y : nullptr;
    e = run_pass(tiles[2 + 2 * u], p, B, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (final_conv) {
    const size_t smem = final_conv_smem(C);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(final_conv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((T + FC_ROWS - 1) / FC_ROWS, B);
    final_conv_kernel<<<grid, NTHR, smem, st>>>((const bf16*)xs, (bf16*)y,
                                                (const float*)fw, T, R, H, C);
    return (int)cudaGetLastError();
  }
  return 0;
}

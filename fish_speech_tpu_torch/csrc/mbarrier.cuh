// The mbarrier operations the kernels fed by asynchronous bulk copies
// share (voc_fused.cu, w4a8.cu): a generic pointer as a shared-memory
// address, an mbarrier's init, arrival, arrival with the bytes its phase
// expects, and a wait on a phase's parity that traps (a launch error, not a
// hang) when the phase never completes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

// until the phase of parity `parity` has completed; traps (a launch
// error, not a hang) if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  for (unsigned i = 0;; ++i) {
    unsigned ok;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (ok) return;
    if (i > (1u << 26)) __trap();
  }
}

}  // namespace

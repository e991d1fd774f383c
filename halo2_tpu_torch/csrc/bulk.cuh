// One copy of a constant table from device memory into a block's shared
// memory by Hopper's 1-D bulk copy (cp.async.bulk, the Tensor Memory
// Accelerator's non-tensor form): thread 0 arms an mbarrier with the byte
// count and issues the copy, every thread waits on the barrier's phase 0.
// The threads spend no registers or loads on the copy.  poseidon.cu stages
// its constant table this way (scripts/table_variants.cu also stages
// jac_fixed_base's window table so, a variant that was not kept).
#pragma once

#include <cstdint>

namespace h2t {

// Every thread of the block calls it, before any thread leaves the kernel.
// dst and src 16-byte aligned, bytes a multiple of 16 (below 2^20).
__device__ __forceinline__ void bulk_stage(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(s), "l"(src), "r"(bytes), "r"(b)
                 : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

}  // namespace h2t

// Staging device memory into shared memory by cp.async, shared by ans0.cu
// (the ANS0 decode's payload ring) and huffman.cu (the Huffman decode's
// payload segments).  A copy is issued by one thread, lands without holding
// a register, and is waited for by the thread that issued it (its commit
// groups are its own), so whoever reads the bytes of another thread's copy
// waits after a __syncwarp or __syncthreads that follows that thread's wait.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// cp.async of the 16 bytes at pos of a row (both 16-byte aligned) into
// shared memory, zero-filled past len (no byte read at or past it)
__device__ __forceinline__ void stage16(uint8_t* smem, const uint8_t* row, uint32_t pos,
                                        uint32_t len) {
  const uint32_t n = pos < len ? min(len - pos, 16u) : 0u;
  const uint8_t* src = row + (n ? pos : 0u);
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace

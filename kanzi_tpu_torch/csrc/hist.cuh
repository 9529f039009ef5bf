// Per-chunk byte histogram, shared by ans0.cu (hist_norm, before the
// normalisation) and huffman.cu (huffman_hist).
//
// Replaces the histogram half of kanzi_tpu/ops/ans_pallas.py _hist16 (:278,
// an XLA nibble one-hot einsum on the MXU).  One CTA of kHistThreads threads
// counts one 16 KiB row.  Bound on this card: the 16 KiB read per chunk
// (DRAM bytes) and, for skewed chunks, shared-memory atomic contention on one
// bin.  Design: 16-byte loads and one private 256-bin histogram per warp
// (8 KiB), so that contention stays inside a warp.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kHistChunk = 16384;

// Counts the bytes of ``row`` (kHistChunk bytes, 16-byte aligned) and returns
// the count of byte value threadIdx.x.  ``wh`` is the CTA's per-warp
// histograms in shared memory.  Every thread of the CTA must call it.
__device__ __forceinline__ int chunk_hist(const uint8_t* __restrict__ row,
                                          int (*wh)[256]) {
  const int k = threadIdx.x;
  const int w = k >> 5;
#pragma unroll
  for (int i = 0; i < kHistThreads / 32; ++i) wh[i][k] = 0;
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(row);
  for (int i = k; i < kHistChunk / 16; i += kHistThreads) {
    const uint4 v = src[i];
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) atomicAdd(&wh[w][(words[j] >> (8 * b)) & 255], 1);
    }
  }
  __syncthreads();
  int h = 0;
#pragma unroll
  for (int i = 0; i < kHistThreads / 32; ++i) h += wh[i][k];
  return h;
}

}  // namespace

// Per-chunk byte histogram, shared by ans0.cu (hist_norm, before the
// normalisation) and huffman.cu (huffman_hist).
//
// Replaces the histogram half of kanzi_tpu/ops/ans_pallas.py _hist16 (:278,
// an XLA nibble one-hot einsum on the MXU).  One CTA of kHistThreads threads
// counts one 16 KiB row.  Bound on this card: the 16 KiB read per chunk
// (DRAM bytes; 1.3 us for a 4 MiB block at 3.35 TB/s), and in practice the
// shared-memory atomics, one a byte.  Design:
//   - A thread issues all four of its 16-byte loads before anything else
//     (the SASS shows the four before the first ATOMS), so that a CTA
//     waits for one load latency, not four in series behind the atomics
//     between them; the loads land while the CTA zeroes its histograms.
//   - One private 256-bin histogram per warp (8 KiB a CTA), so that the
//     contention of a skewed chunk stays inside a warp.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6), on the card
// alone at 256 chunks: huffman_hist 0.0042-0.0043 ms, as with one load
// before the atomics (0.0043 in the same call), so the other warps hid the
// loads' latency already and the shared atomics set the time above the
// launch floor (an empty kernel, 0.0021).  256 chunks of one byte value
// take 0.0032-0.0033: all lanes of a warp on one bin cost less than the
// corpus's mix of bins.  512 threads a chunk (two loads a thread, 16
// histograms) measured no faster: 0.0044.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kHistChunk = 16384;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistLoads = kHistChunk / 16 / kHistThreads;   // 16-byte loads a thread

// Counts the bytes of ``row`` (kHistChunk bytes, 16-byte aligned) and returns
// the count of byte value threadIdx.x (0 for threads from 256 on).  ``wh``
// is the CTA's per-warp histograms in shared memory, 16-byte aligned.
// Every thread of the CTA must call it.
__device__ __forceinline__ int chunk_hist(const uint8_t* __restrict__ row,
                                          int (*wh)[256]) {
  const int k = threadIdx.x;
  const int w = k >> 5;
  const uint4* src = reinterpret_cast<const uint4*>(row);
  uint4 v[kHistLoads];
#pragma unroll
  for (int i = 0; i < kHistLoads; ++i) v[i] = __ldg(src + k + kHistThreads * i);
  int4* flat = reinterpret_cast<int4*>(&wh[0][0]);
#pragma unroll
  for (int i = 0; i < kHistWarps * 256 / 4 / kHistThreads; ++i) {
    flat[k + kHistThreads * i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kHistLoads; ++i) {
    const uint32_t words[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) atomicAdd(&wh[w][(words[j] >> (8 * b)) & 255], 1);
    }
  }
  __syncthreads();
  int h = 0;
  if (k < 256) {
#pragma unroll
    for (int i = 0; i < kHistWarps; ++i) h += wh[i][k];
  }
  return h;
}

}  // namespace

// Block-wide prefix sums and the stable partition of one tile of flagged
// 16-bit words, shared by ans0.cu (ans0_compact: the partition for widths
// that are no multiple of 16, the block scan of its tiled path; the scans
// of hist_norm), ans1.cu (ans1_compact) and huffman.cu (the warp scan of
// huffman_encode).
//
// The partition replaces the body that kanzi_tpu/ops/ans_pallas.py
// _compact_kernel (:480) and _compact2_kernel (:487) share, _compact_body
// (:494: MXU prefix sums, binary-search gathers and 0/1 placement matmuls).
// Each of the CTA's NT threads takes a run of ceil(c / NT) consecutive
// positions, counts its flags, a block-wide exclusive prefix sum gives its
// output offset, and it writes its flagged words in order; the positions
// from the tile's count on are zeroed, as on the TPU.  Bound on this card:
// DRAM bytes; one pass, no intermediate array.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive prefix sum over the block in thread order (blockDim.x == NT, a
// multiple of 32); *total gets the sum.  smem holds NT / 32 + 1 ints.
template <int NT>
__device__ int block_excl_scan(int v, int* smem, int* total) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int x = warp_incl_scan(v);
  if (lane == 31) smem[w] = x;
  __syncthreads();
  if (w == 0) {
    const int t = lane < kWarps ? smem[lane] : 0;
    const int s = warp_incl_scan(t);
    if (lane < kWarps) smem[lane] = s - t;
    if (lane == kWarps - 1) smem[kWarps] = s;
  }
  __syncthreads();
  const int res = x - v + smem[w];
  *total = smem[kWarps];
  __syncthreads();  // smem may be reused by the next call
  return res;
}

// Stable partition of one tile of c positions into out[0, c).  word(i) is
// position i's word (0..65535) where it is flagged, and -1 where it is not.
// Every thread of the CTA must call it.  Returns the tile's count of flagged
// words; *mine gets the calling thread's own count, whose run starts at
// position threadIdx.x * ceil(c / NT).
template <int NT, class Word>
__device__ int compact_tile(const Word& word, int c, int16_t* __restrict__ out,
                            int* smem, int* mine) {
  const int per = (c + NT - 1) / NT;
  const int lo = min(static_cast<int>(threadIdx.x) * per, c);
  const int hi = min(lo + per, c);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += word(i) >= 0;
  int total;
  int off = block_excl_scan<NT>(cnt, smem, &total);
  for (int i = lo; i < hi; ++i) {
    const int w = word(i);
    if (w >= 0) out[off++] = static_cast<int16_t>(static_cast<uint16_t>(w));
  }
  for (int i = total + threadIdx.x; i < c; i += NT) out[i] = 0;
  *mine = cnt;
  return total;
}

}  // namespace

// Block-wide prefix sums and the stable partition of flagged 16-bit words,
// shared by ans0.cu (ans0_compact; the block scan), ans1.cu (ans1_compact)
// and huffman.cu (the warp scan of huffman_encode).
//
// Both bodies replace the one that kanzi_tpu/ops/ans_pallas.py
// _compact_kernel (:480) and _compact2_kernel (:487) share, _compact_body
// (:494: MXU prefix sums, binary-search gathers and 0/1 placement matmuls).
// Bound on this card: DRAM bytes; one pass, no intermediate array.
//   - compact_staged, the tiled body: ans0_compact at widths that are a
//     multiple of 16 (its count carried from tile to tile) and ans1_compact
//     at every width (one tile a CTA, nothing carried).  Each thread takes a
//     run of 32 consecutive positions of a tile, read once by 16-byte loads
//     issued together by the kernel's loader; its offset comes from a block
//     scan of the runs' counts; it writes its kept words into a staging row
//     in shared memory, and after one barrier the CTA stores the row by
//     16-byte stores, zeros past the count.  Measured on an H100 80GB HBM3
//     at 700 W (PERF.md section 6), on the card alone at a 4 MiB block:
//     ans0_compact 0.0076 ms, 1.2 x its bound, against 0.0240 for
//     compact_tile at 1,024 threads a row; ans1_compact 0.0095, 1.25 x its
//     bound, against 0.0253 for compact_tile at 1,024 threads a tile.
//   - compact_tile, the scalar body: ans0_compact at widths that are no
//     multiple of 16 (rows not 16-byte aligned).  Each of the CTA's NT
//     threads takes a run of ceil(c / NT) positions, counts its flags, takes
//     its offset from the block scan, and writes its words one by one; the
//     positions from the tile's count on are zeroed, as on the TPU.

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

// ---------------------------------------------------------------------------
// the tiled body
// ---------------------------------------------------------------------------

constexpr int kRunLen = 32;                  // positions a thread a tile

// a thread's run of kRunLen consecutive positions, as its loader gives it
struct Run {
  uint32_t mask;                             // bit k: position k is flagged
  uint32_t w[kRunLen / 2];                   // position k's word: bits 16 (k & 1) of w[k / 2]
};

template <int NT>
struct StagedSmem {
  alignas(16) int16_t stage[NT * kRunLen + 16];   // 7 carried words, a tile, 8 zeros
  int red[NT / 32 + 1];
};

// The stable partition of a row of c positions into out[0, c) (16-byte
// aligned, c a multiple of 8), in tiles of NT * kRunLen positions.
// load(lo) returns the Run of positions lo .. lo + 31, all unflagged past
// the row's end.  With kCarry, a tile stores only whole groups of 8 words
// and the fewer than 8 left over move to the staging row's start and go
// out with the next tile, so every store stays 16-byte aligned; the last
// tile stores the rest, then zeros to the row's end.  Without it the row is
// one tile (c <= NT * kRunLen).  Every thread of the CTA must call it.
// Returns the row's count of flagged words; *mine gets the calling
// thread's own count in the last tile.
template <int NT, bool kCarry, class Load>
__device__ int compact_staged(const Load& load, int c, int16_t* __restrict__ out,
                              StagedSmem<NT>& sh, int* mine) {
  constexpr int kTile = NT * kRunLen;
  const int tid = threadIdx.x;
  int head = 0;       // carried words at stage[0, head)
  int done = 0;       // words stored, a multiple of 8
  for (int s = 0;; s += kTile) {
    const Run r = load(s + tid * kRunLen);
    const int cnt = __popc(r.mask);
    int total;
    int off = head + block_excl_scan<NT>(cnt, sh.red, &total);
#pragma unroll
    for (int k = 0; k < kRunLen; ++k) {
      if ((r.mask >> k) & 1u) {
        sh.stage[off++] = static_cast<int16_t>(r.w[k >> 1] >> (16 * (k & 1)));
      }
    }
    const int avail = head + total;
    const bool last = !kCarry || s + kTile >= c;
    if (last && tid < 8) sh.stage[avail + tid] = 0;
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(out + done);
    const uint4* st = reinterpret_cast<const uint4*>(sh.stage);
    if (last) {
      for (int q = tid; q < (c - done) / 8; q += NT) {
        dst[q] = 8 * q < avail ? st[q] : make_uint4(0u, 0u, 0u, 0u);
      }
      *mine = cnt;
      return done + avail;
    }
    const int full = avail & ~7;
    for (int q = tid; q < full / 8; q += NT) dst[q] = st[q];
    __syncthreads();
    // the leftover words to the start; full >= 8 keeps source and target apart
    if (full && tid < avail - full) sh.stage[tid] = sh.stage[full + tid];
    head = avail - full;
    done += full;
  }
}

// ---------------------------------------------------------------------------
// the scalar body
// ---------------------------------------------------------------------------

// Stable partition of one tile of c positions into out[0, c).  word(i) is
// position i's word (0..65535) where it is flagged, and -1 where it is not.
// Every thread of the CTA must call it.  Returns the tile's count of flagged
// words.
template <int NT, class Word>
__device__ int compact_tile(const Word& word, int c, int16_t* __restrict__ out, int* smem) {
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
  return total;
}

}  // namespace

// Canonical Huffman entropy stage for Hopper (sm_90a): three kernels.
//
// Wire semantics are those of kanzi_tpu/entropy/huffman.py: 16 KiB chunks,
// each cut into four quarter-streams of 4,096 symbols, every stream the
// MSB-first concatenation of its symbols' canonical codes (at most 12 bits
// on a valid stream).  Every kernel is bit-exact with its plain PyTorch
// version in kanzi_tpu_torch/ops/huffman_cuda.py, on every input.
//
// Each launcher is a plain C function over raw device pointers and the CUDA
// stream; it launches on that stream, does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "hist.cuh"
#include "stage.cuh"

namespace {

constexpr int kChunk = kHistChunk;
constexpr int kStream = kChunk / 4;          // symbols per quarter-stream
constexpr int kMaxLen = 12;                  // MAX_SYMBOL_SIZE
constexpr int kWin = 1 << kMaxLen;           // 4096 12-bit windows
constexpr int kSegBytes = 26 * 256;          // a stream's payload segment (6,656 B)

// ---------------------------------------------------------------------------
// kernel 1: per-chunk byte histogram
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _hist16 (:278) as the Huffman encoder
// calls it (entropy/huffman.py:330): plain counts, no normalisation.  One CTA
// of 256 threads per chunk; the counting is chunk_hist (hist.cuh), the same
// code as ans0's hist_norm.

__global__ void __launch_bounds__(kHistThreads)
huffman_hist_kernel(const uint8_t* __restrict__ chunks, int32_t* __restrict__ hist) {
  __shared__ int wh[kHistThreads / 32][256];
  const size_t row = blockIdx.x;
  const int h = chunk_hist(chunks + row * kChunk, wh);
  hist[row * 256 + threadIdx.x] = h;
}

// ---------------------------------------------------------------------------
// kernel 2: code lookup + MSB-first 16-bit packing
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/huffman_pallas.py _hscan_fused_kernel (:37) and the
// stable partition that follows it, ans_pallas.py _compact_kernel (:480,
// called at huffman_pallas.py:145).  One thread per (chunk, stream): 4
// threads per chunk, 32 chunks per 128-thread CTA, each chunk's 256
// len << 12 | code entries in shared memory (16 KiB per CTA).  A thread walks
// its 4,096 bytes with 16-byte loads (the next one in flight while the
// current one is coded), shifts each code into a 32-bit accumulator and
// stores a 16-bit word whenever 16 bits are ready, eight words per 16-byte
// store.  Its words land in order, so the TPU's compaction has nothing left
// to do; the row is zero-filled past its last word.  Bound on this card: the
// serial dependence of each stream (a 4 MiB block gives only 1,024 threads),
// not bytes.  A code is masked to its length, so every table entry gives a
// defined result: the plain version packs the same bits.

constexpr int kEncChunksPerCta = 32;
constexpr int kEncThreads = 4 * kEncChunksPerCta;

__global__ void __launch_bounds__(kEncThreads)
huffman_encode_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ tbl,
                      int16_t* __restrict__ words, int32_t* __restrict__ n_words,
                      int32_t* __restrict__ acc_out, int32_t* __restrict__ nbits_out, int n) {
  __shared__ uint16_t t[kEncChunksPerCta][256];
  const size_t base = static_cast<size_t>(blockIdx.x) * kEncChunksPerCta;
  // tbl row r holds symbol 2k in the low half of word k, 2k+1 in the high half
  for (int i = threadIdx.x; i < kEncChunksPerCta * 128; i += kEncThreads) {
    const size_t r = base + (i >> 7);
    const uint32_t w = r < static_cast<size_t>(n) ? static_cast<uint32_t>(tbl[r * 128 + (i & 127)]) : 0u;
    t[i >> 7][2 * (i & 127)] = static_cast<uint16_t>(w & 0xFFFFu);
    t[i >> 7][2 * (i & 127) + 1] = static_cast<uint16_t>(w >> 16);
  }
  __syncthreads();
  const int local = threadIdx.x >> 2;
  const int u = threadIdx.x & 3;
  const size_t row = base + local;
  if (row >= static_cast<size_t>(n)) return;
  const size_t srow = row * 4 + u;
  const uint4* src = reinterpret_cast<const uint4*>(chunks + row * kChunk + u * kStream);
  uint4* dst = reinterpret_cast<uint4*>(words + srow * kStream);
  const uint16_t* tb = t[local];
  uint32_t acc = 0;
  uint32_t nb = 0;
  int nw = 0;
  uint64_t s0 = 0, s1 = 0;        // words nw & ~7 .. nw & ~7 + 7, little-endian
  uint4 cur = src[0];
  for (int i = 0; i < kStream / 16; ++i) {
    const uint4 nxt = src[i + 1 < kStream / 16 ? i + 1 : i];
    const uint32_t wd[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t e = tb[(wd[j] >> (8 * b)) & 255];
        const uint32_t ln = e >> 12;
        const uint32_t code = e & 0xFFFu & ((1u << ln) - 1u);
        acc = (acc << ln) | code;
        nb += ln;
        if (nb >= 16) {
          nb -= 16;
          const uint64_t word = (acc >> nb) & 0xFFFFu;
          acc &= (1u << nb) - 1u;
          const int k = nw & 7;
          if (k < 4) s0 |= word << (16 * k);
          else s1 |= word << (16 * (k - 4));
          ++nw;
          if ((nw & 7) == 0) {
            dst[(nw >> 3) - 1] = make_uint4(static_cast<uint32_t>(s0), static_cast<uint32_t>(s0 >> 32),
                                            static_cast<uint32_t>(s1), static_cast<uint32_t>(s1 >> 32));
            s0 = s1 = 0;
          }
        }
      }
    }
    cur = nxt;
  }
  int k = nw >> 3;
  if (nw & 7) {
    dst[k++] = make_uint4(static_cast<uint32_t>(s0), static_cast<uint32_t>(s0 >> 32),
                          static_cast<uint32_t>(s1), static_cast<uint32_t>(s1 >> 32));
  }
  for (; k < kStream / 8; ++k) dst[k] = make_uint4(0u, 0u, 0u, 0u);
  n_words[srow] = nw;
  acc_out[srow] = static_cast<int32_t>(acc);
  nbits_out[srow] = static_cast<int32_t>(nb);
}

// ---------------------------------------------------------------------------
// kernel 3: canonical decode, rank -> symbol included
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/huffman_decode_pallas.py _decode_kernel (:50) and the
// rank -> symbol ans_pallas.py _lookup_kernel (:47) that follows it
// (huffman_decode_pallas.py:240).  A chunk's four streams of 4,096 steps
// each are serial chains, and a step is a table lookup of the 12-bit window
// at the stream's bit position, which then advances by the code length.
// Bound on this card: the latency of one step, 4,096 times over, with the
// work beside the chain issued by the same warp; the 1,024 streams of a
// 4 MiB block run side by side, so only a shorter step (and a short start)
// makes a launch faster.  What the design does about it:
//   - A warp a chunk (a CTA of 32 threads, its 35,200 B of shared memory
//     static).  The 32 lanes first issue the cp.async copies of the
//     chunk's four 6,656-byte payload segments into shared memory, each
//     with 16 zero bytes behind it (zero fill past the segment: the refill
//     and its next word read ahead of the window, and must read zeros
//     there, never the next stream's bytes), then build the chunk's tables
//     of every 12-bit window, its length L and its symbol (4 KiB each),
//     while the copies land, from the canonical arithmetic of the TPU
//     kernel:
//       L   = 1 + #{l in 1..12 : boundary[l] <= v}
//       sym = perm[(adj[L] - 8192 + (v >> (12 - L))) & 255] & 255   for L <= 12
//     which is the host decoder's own table shape (entropy/huffman.py:
//     432-445), so symbols come out directly and no rank pass is needed.  A
//     window past the last code (L = 13, only on an incomplete code)
//     decodes to symbol 0 and advances 13 bits, in the plain version too;
//     the glue then sees the bit count mismatch.  Then lanes 0-3 decode the
//     four streams.
//   - A short chain: a stream's unread bits sit MSB-aligned in two 32-bit
//     registers, at least 13 of them at a step's start, so the window is
//     valid before any refill.  The refill (with at most 32 bits left, the
//     next big-endian word, held in a register, goes right below them; the
//     word after it is read from shared memory at the step's start, its
//     address known from the word count) is selects beside the lookup, not
//     behind it.  A step's chain is the window's shift, the length's load
//     and the buffer's funnel shift: no branch, no mask and no other load
//     behind the lookup; the symbol's load is beside it.
//   - Each lane packs its 16 symbols of 16 steps into four words and writes
//     them with one 16-byte store.
// Measured beside it (PERF.md section 6): two chunks a CTA with one
// len | symbol << 8 table, slower; the staged words byte-swapped once, a
// word pointer in place of the count, no faster.
// 4,096 steps of at most 13 bits read at most 53,248 bits, the segment's
// length, so the window never reaches past it; `used` is each stream's
// final bit position.

constexpr int kDecBlock = 16;                     // steps a 16-byte store
constexpr int kSegStaged = kSegBytes + 16;        // a segment and its zero tail
constexpr int kSegLines = kSegStaged / 16;

// a chunk's shared memory (35,200 B)
struct DecodeSmem {
  alignas(16) uint8_t seg[4][kSegStaged];
  uint8_t len[kWin];                              // L by window
  uint8_t sym[kWin];                              // symbol by window
  int32_t adj[16];
  uint8_t perm[256];
};

__device__ __forceinline__ uint32_t be32(const uint32_t* w, int i) {
  return __byte_perm(w[i], 0u, 0x0123u);
}

__global__ void __launch_bounds__(32)
huffman_decode_kernel(const uint8_t* __restrict__ pay, const int32_t* __restrict__ bnd,
                      const int32_t* __restrict__ adj, const int32_t* __restrict__ perm,
                      uint8_t* __restrict__ syms, int32_t* __restrict__ used) {
  __shared__ DecodeSmem sh;
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  const uint8_t* src = pay + row * (4 * kSegBytes);
  for (int q = lane; q < 4 * kSegLines; q += 32) {
    const int j = q / kSegLines;
    const uint32_t pos = 16u * static_cast<uint32_t>(q - j * kSegLines);
    stage16(sh.seg[j] + pos, src + j * kSegBytes, pos, kSegBytes);
  }
  stage_commit();

  if (lane < 13) sh.adj[lane] = adj[row * 128 + lane];
  for (int k = lane; k < 256; k += 32) sh.perm[k] = static_cast<uint8_t>(perm[row * 256 + k]);
  uint32_t b[kMaxLen];
#pragma unroll
  for (int l = 0; l < kMaxLen; ++l) {
    b[l] = (static_cast<uint32_t>(bnd[row * 128 + (l >> 1)]) >> (16 * (l & 1))) & 0xFFFFu;
  }
  __syncwarp();
  for (int v = lane; v < kWin; v += 32) {
    int L = 1;
#pragma unroll
    for (int l = 0; l < kMaxLen; ++l) L += b[l] <= static_cast<uint32_t>(v) ? 1 : 0;
    uint32_t sym = 0;
    if (L <= kMaxLen) {
      // modulo 2^32, so any adj (a corrupt header's too) gives a defined rank
      const uint32_t rank = static_cast<uint32_t>(sh.adj[L]) - 8192u +
                            static_cast<uint32_t>(v >> (kMaxLen - L));
      sym = sh.perm[rank & 255u];
    }
    sh.len[v] = static_cast<uint8_t>(L);
    sh.sym[v] = static_cast<uint8_t>(sym);
  }
  stage_wait<0>();
  __syncwarp();
  if (lane >= 4) return;

  const int j = lane;
  const uint32_t* seg = reinterpret_cast<const uint32_t*>(sh.seg[j]);
  uint4* dst = reinterpret_cast<uint4*>(syms + row * kChunk + j * kStream);
  // the unread bits, MSB-aligned in hi:lo; at least 13 of them at a step's start
  uint32_t hi = be32(seg, 0), lo = be32(seg, 1);
  uint32_t have = 64;
  int wi = 2;           // the word after the buffer's bits
  uint32_t nw = be32(seg, 2);
  uint32_t pos = 0;     // bits consumed
  for (int t0 = 0; t0 < kStream; t0 += kDecBlock) {
    uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int s = 0; s < kDecBlock; ++s) {
      const uint32_t v = hi >> (32 - kMaxLen);   // the window is valid before the refill
      const uint32_t L = sh.len[v];
      // the refill, while the lookup is in flight: with at most 32 bits
      // left, nw goes right below them (have >= 13, so both shifts are
      // under 32; __funnelshift_rc clamps have = 32 to a 0)
      const uint32_t nx = be32(seg, wi + 1);
      const bool need = have <= 32;
      hi = need ? hi | __funnelshift_rc(nw, 0u, have) : hi;
      lo = need ? nw << ((32 - have) & 31) : lo;
      have += need ? 32 : 0;
      wi += need ? 1 : 0;
      nw = need ? nx : nw;
      hi = __funnelshift_l(lo, hi, L);
      lo = __funnelshift_l(0u, lo, L);
      have -= L;
      pos += L;
      out[s >> 2] |= static_cast<uint32_t>(sh.sym[v]) << (8 * (s & 3));
    }
    dst[t0 / kDecBlock] = make_uint4(out[0], out[1], out[2], out[3]);
  }
  used[row * 4 + j] = static_cast<int32_t>(pos);
}

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

int kz_huffman_hist(const void* chunks, void* hist, int n, void* stream) {
  if (n > 0) {
    huffman_hist_kernel<<<n, kHistThreads, 0, as_stream(stream)>>>(
        static_cast<const uint8_t*>(chunks), static_cast<int32_t*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}

int kz_huffman_encode(const void* chunks, const void* tbl, void* words, void* n_words,
                      void* acc, void* nbits, int n, void* stream) {
  if (n > 0) {
    const int grid = (n + kEncChunksPerCta - 1) / kEncChunksPerCta;
    huffman_encode_kernel<<<grid, kEncThreads, 0, as_stream(stream)>>>(
        static_cast<const uint8_t*>(chunks), static_cast<const int32_t*>(tbl),
        static_cast<int16_t*>(words), static_cast<int32_t*>(n_words),
        static_cast<int32_t*>(acc), static_cast<int32_t*>(nbits), n);
  }
  return static_cast<int>(cudaGetLastError());
}

int kz_huffman_decode(const void* pay, const void* bnd, const void* adj, const void* perm,
                      void* syms, void* used, int n, void* stream) {
  if (n > 0) {
    huffman_decode_kernel<<<n, 32, 0, as_stream(stream)>>>(
        static_cast<const uint8_t*>(pay), static_cast<const int32_t*>(bnd),
        static_cast<const int32_t*>(adj), static_cast<const int32_t*>(perm),
        static_cast<uint8_t*>(syms), static_cast<int32_t*>(used));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

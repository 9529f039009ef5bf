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

namespace {

constexpr int kChunk = kHistChunk;
constexpr int kStream = kChunk / 4;          // symbols per quarter-stream
constexpr int kMaxLen = 12;                  // MAX_SYMBOL_SIZE
constexpr int kWin = 1 << kMaxLen;           // 4096 12-bit windows
constexpr int kSegBytes = 26 * 256;          // a stream's payload segment (6,656 B)
constexpr int kSegWords = kSegBytes / 4;

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
// (huffman_decode_pallas.py:240).  A 32-thread CTA decodes 8 chunks, one
// thread per (chunk, stream).  The CTA first builds, per chunk, the
// 4,096-entry len << 8 | symbol table of every 12-bit window in shared memory
// (8 KiB per chunk, 64 KiB per CTA of the 227 KiB) from the canonical
// arithmetic of the TPU kernel:
//   L   = 1 + #{l in 1..12 : boundary[l] <= v}
//   sym = perm[(adj[L] - 8192 + (v >> (12 - L))) & 255] & 255   for L <= 12
// which is the host decoder's own table shape (entropy/huffman.py:432-445),
// so symbols come out directly and no rank pass is needed.  A window past the
// last code (L = 13, only on an incomplete code) decodes to symbol 0 and
// advances 13 bits, in the plain version too; the glue then sees the bit
// count mismatch.  Each thread keeps a 64-bit bit buffer refilled with
// aligned big-endian 32-bit loads from its stream's 6,656-byte segment
// (words past the segment read as 0: the last codes of a valid stream rely on
// that zero padding) and writes its symbols four to a 32-bit store.  Bound on
// this card: the serial dependence of a stream's 4,096 steps (a shared-memory
// lookup, then shifts); a 4 MiB block gives 1,024 threads.

constexpr int kDecChunksPerCta = 8;
constexpr int kDecThreads = 4 * kDecChunksPerCta;
constexpr size_t kDecSmem = kDecChunksPerCta * (kWin * sizeof(uint16_t) + 256 + 16 * sizeof(int32_t));

__global__ void __launch_bounds__(kDecThreads)
huffman_decode_kernel(const uint8_t* __restrict__ pay, const int32_t* __restrict__ bnd,
                      const int32_t* __restrict__ adj, const int32_t* __restrict__ perm,
                      uint8_t* __restrict__ syms, int32_t* __restrict__ used, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* lut = reinterpret_cast<uint16_t*>(smem);                          // [8][4096]
  int32_t* adj_s = reinterpret_cast<int32_t*>(lut + kDecChunksPerCta * kWin);  // [8][16]
  uint8_t* perm_s = reinterpret_cast<uint8_t*>(adj_s + kDecChunksPerCta * 16); // [8][256]
  const int first = static_cast<int>(blockIdx.x) * kDecChunksPerCta;
  const size_t base = static_cast<size_t>(first);
  const int lane = threadIdx.x;
  const int nloc = min(kDecChunksPerCta, n - first);   // chunks of this CTA

  for (int c = 0; c < nloc; ++c) {
    const size_t row = base + c;
    if (lane < 13) adj_s[c * 16 + lane] = adj[row * 128 + lane];
    for (int k = lane; k < 256; k += kDecThreads) perm_s[c * 256 + k] = static_cast<uint8_t>(perm[row * 256 + k]);
  }
  __syncwarp();
  for (int c = 0; c < nloc; ++c) {
    const size_t row = base + c;
    uint32_t b[kMaxLen];
#pragma unroll
    for (int l = 0; l < kMaxLen; ++l) {
      b[l] = (static_cast<uint32_t>(bnd[row * 128 + (l >> 1)]) >> (16 * (l & 1))) & 0xFFFFu;
    }
    for (int v = lane; v < kWin; v += kDecThreads) {
      int L = 1;
#pragma unroll
      for (int l = 0; l < kMaxLen; ++l) L += b[l] <= static_cast<uint32_t>(v) ? 1 : 0;
      uint32_t sym = 0;
      if (L <= kMaxLen) {
        // modulo 2^32, so any adj (a corrupt header's too) gives a defined rank
        const uint32_t rank = static_cast<uint32_t>(adj_s[c * 16 + L]) - 8192u +
                              static_cast<uint32_t>(v >> (kMaxLen - L));
        sym = perm_s[c * 256 + (rank & 255u)];
      }
      lut[c * kWin + v] = static_cast<uint16_t>((L << 8) | sym);
    }
  }
  __syncwarp();

  const int local = lane >> 2;
  const int j = lane & 3;
  if (local >= nloc) return;
  const size_t row = base + local;
  const uint32_t* seg = reinterpret_cast<const uint32_t*>(pay + row * (4 * kSegBytes) + j * kSegBytes);
  uint32_t* dst = reinterpret_cast<uint32_t*>(syms + row * kChunk + j * kStream);
  const uint16_t* tb = lut + local * kWin;
  uint64_t buf = 0;     // unread bits, MSB-aligned
  int have = 0;         // valid bits in buf
  int wi = 0;           // next 32-bit word of the segment
  uint32_t pos = 0;     // bits consumed
  uint32_t out4 = 0;
  for (int t = 0; t < kStream; ++t) {
    if (have < kMaxLen + 1) {
      const uint32_t w = wi < kSegWords ? __byte_perm(seg[wi], 0u, 0x0123u) : 0u;
      buf |= static_cast<uint64_t>(w) << (32 - have);
      have += 32;
      ++wi;
    }
    const uint32_t e = tb[buf >> (64 - kMaxLen)];
    const uint32_t L = e >> 8;
    buf <<= L;
    have -= static_cast<int>(L);
    pos += L;
    out4 |= (e & 255u) << (8 * (t & 3));
    if ((t & 3) == 3) {
      dst[t >> 2] = out4;
      out4 = 0;
    }
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
    cudaError_t err = cudaFuncSetAttribute(huffman_decode_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kDecSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (n + kDecChunksPerCta - 1) / kDecChunksPerCta;
    huffman_decode_kernel<<<grid, kDecThreads, kDecSmem, as_stream(stream)>>>(
        static_cast<const uint8_t*>(pay), static_cast<const int32_t*>(bnd),
        static_cast<const int32_t*>(adj), static_cast<const int32_t*>(perm),
        static_cast<uint8_t*>(syms), static_cast<int32_t*>(used), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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

#include "compact.cuh"
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
// of kHistThreads threads per chunk; the counting is chunk_hist (hist.cuh),
// the same code as ans0's hist_norm, whose bound and design are described
// there.

__global__ void __launch_bounds__(kHistThreads)
huffman_hist_kernel(const uint8_t* __restrict__ chunks, int32_t* __restrict__ hist) {
  __shared__ __align__(16) int wh[kHistWarps][256];
  const size_t row = blockIdx.x;
  const int h = chunk_hist(chunks + row * kChunk, wh);
  if (threadIdx.x < 256) hist[row * 256 + threadIdx.x] = h;
}

// ---------------------------------------------------------------------------
// kernel 2: code lookup + MSB-first 16-bit packing
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/huffman_pallas.py _hscan_fused_kernel (:37) and the
// stable partition that follows it, ans_pallas.py _compact_kernel (:480,
// called at huffman_pallas.py:145).  The TPU kernel ran each stream's chain
// of shifts in lock-step over 128 chunks in lanes; here no chain is left.
// A code's bit position in its stream is the sum of the lengths before it,
// so a stream is cut into 128 runs of 32 symbols that are packed side by
// side once their offsets are known.  Bound on this card: bytes, 4 MiB in
// and 8 MiB out a 4 MiB block (0.0038 ms at 3.35 TB/s); the work a symbol
// is two shared-table lookups and a few integer operations.  The design:
//   - A CTA of 512 threads a chunk, four warps a stream, thread l of
//     stream j on its symbols [32 l, 32 l + 32): 256 CTAs a block, about
//     two an SM.  A thread's 32 bytes are two 16-byte loads, issued first
//     and held in registers for both passes.  The chunk's 256 entries go
//     into shared memory as len << 16 | code masked to len, so any table
//     entry gives a defined result (the plain version packs the same bits).
//   - Pass 1: a thread sums its 32 lengths; an exclusive scan over the
//     warp (warp_incl_scan, compact.cuh) and the totals of the stream's
//     warps before it give its bit offset o, and the four warps' totals
//     the stream's T.
//   - Pass 2: a thread shifts its codes into a 64-bit buffer that starts
//     with o & 31 zero bits and writes each 32 bits it completes into the
//     stream's row in shared memory (4,096 words as 2,048 32-bit pairs,
//     word 2k the low half: the MSB-first bits 32k .. 32k + 31 swapped
//     halfwise).  A pair whose bits are all the run's own is stored; the
//     pair the run starts in (when o & 31 != 0) and the pair it ends in can
//     hold other runs' bits and are ORed in with atomicOr on the zeroed
//     row, which is order-free, so the result is deterministic.
//     T <= 4,096 x 15 bits = 3,840 words, so a row never overflows.
//   - After one barrier the CTA stores the four rows with coalesced 16-byte
//     stores, each word from n_words = T >> 4 on zeroed; acc is the word at
//     n_words shifted down to its nbits = T & 15 bits.
// Measured beside it (PERF.md section 6), on the card alone: a warp a
// stream (32 runs of 128 symbols), 0.0166 ms a block; two warps, 0.0113;
// four, 0.0098, kept: more warps an SM hide the lookups' latency.

constexpr int kEncWarps = 4;                  // warps a stream
constexpr int kEncRuns = 32 * kEncWarps;      // runs a stream, a thread each
constexpr int kEncThreads = 4 * kEncRuns;
constexpr int kRun = kStream / kEncRuns;      // symbols a run
constexpr int kRowPairs = kStream / 2;        // a row's 4,096 words as 32-bit pairs

// a chunk's shared memory (33.1 KiB)
struct EncodeSmem {
  alignas(16) uint32_t row[4][kRowPairs];
  uint32_t ent[256];                          // len << 16 | masked code
  uint32_t warp_bits[4 * kEncWarps];          // the bits of each warp's runs
  uint32_t total[4];                          // T of each stream
};

// MSB-first bits 32p .. 32p + 31 of a stream as pair p of its row
__device__ __forceinline__ uint32_t as_pair(uint32_t bits) { return __byte_perm(bits, 0u, 0x1032u); }

__global__ void __launch_bounds__(kEncThreads)
huffman_encode_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ tbl,
                      int16_t* __restrict__ words, int32_t* __restrict__ n_words,
                      int32_t* __restrict__ acc_out, int32_t* __restrict__ nbits_out) {
  __shared__ EncodeSmem sh;
  const int tid = threadIdx.x;
  const int j = tid / kEncRuns;               // the stream
  const int l = tid % kEncRuns;               // the run
  const size_t chunk = blockIdx.x;
  const uint4* src =
      reinterpret_cast<const uint4*>(chunks + chunk * kChunk + j * kStream + l * kRun);
  uint4 b[kRun / 16];
#pragma unroll
  for (int i = 0; i < kRun / 16; ++i) b[i] = __ldg(src + i);
  // tbl word k holds symbol 2k in its low half, 2k + 1 in its high half
  if (tid < 128) {
    const uint32_t tw = static_cast<uint32_t>(tbl[chunk * 128 + tid]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t e = (tw >> (16 * h)) & 0xFFFFu;
      const uint32_t ln = e >> 12;
      sh.ent[2 * tid + h] = ln << 16 | (e & 0xFFFu & ((1u << ln) - 1u));
    }
  }
  uint4* zr = reinterpret_cast<uint4*>(&sh.row[0][0]);
  for (int q = tid; q < kRowPairs; q += kEncThreads) zr[q] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < kRun / 16; ++i) {
    const uint32_t wd[4] = {b[i].x, b[i].y, b[i].z, b[i].w};
#pragma unroll
    for (int k = 0; k < 16; ++k) bits += sh.ent[(wd[k >> 2] >> (8 * (k & 3))) & 255u] >> 16;
  }
  const uint32_t incl = static_cast<uint32_t>(warp_incl_scan(static_cast<int>(bits)));
  if ((tid & 31) == 31) sh.warp_bits[tid >> 5] = incl;
  __syncthreads();
  uint32_t o = incl - bits;                   // the run's bit offset in its stream
#pragma unroll
  for (int w = 0; w < kEncWarps - 1; ++w) o += w < (l >> 5) ? sh.warp_bits[j * kEncWarps + w] : 0u;
  if (tid < 4) {
    uint32_t t = 0;
#pragma unroll
    for (int w = 0; w < kEncWarps; ++w) t += sh.warp_bits[tid * kEncWarps + w];
    sh.total[tid] = t;
  }

  uint32_t* row = sh.row[j];
  const uint32_t p0 = o >> 5;
  const bool lead = (o & 31u) != 0;           // pair p0 also holds earlier runs' bits
  uint32_t p = p0;
  uint32_t nb = o & 31u;                      // bits of pair p in the buffer
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < kRun / 16; ++i) {
    const uint32_t wd[4] = {b[i].x, b[i].y, b[i].z, b[i].w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t e = sh.ent[(wd[k >> 2] >> (8 * (k & 3))) & 255u];
      const uint32_t ln = e >> 16;
      acc = (acc << ln) | (e & 0xFFFFu);
      nb += ln;
      if (nb >= 32) {
        nb -= 32;
        const uint32_t v = as_pair(static_cast<uint32_t>(acc >> nb));
        if (lead && p == p0) atomicOr(row + p, v);
        else row[p] = v;
        ++p;
      }
    }
  }
  if (nb) atomicOr(row + p, as_pair(static_cast<uint32_t>(acc << (32 - nb))));
  __syncthreads();

  // store the rows: thread t takes the 16-byte pieces t, t + kEncThreads, ...
  const uint4* rows = reinterpret_cast<const uint4*>(&sh.row[0][0]);
  for (int q = tid; q < 4 * kRowPairs / 4; q += kEncThreads) {
    const int r = q / (kRowPairs / 4);
    const int qi = q % (kRowPairs / 4);
    const int nw = static_cast<int>(sh.total[r] >> 4);
    const uint4 v = rows[q];
    uint32_t c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int keep = nw - (8 * qi + 2 * h);   // words of the pair below n_words
      c[h] = keep >= 2 ? c[h] : (keep == 1 ? c[h] & 0xFFFFu : 0u);
    }
    reinterpret_cast<uint4*>(words + (chunk * 4 + r) * kStream)[qi] =
        make_uint4(c[0], c[1], c[2], c[3]);
  }
  if (tid < 4) {
    const uint32_t t = sh.total[tid];
    const uint32_t nw = t >> 4, nbits = t & 15u;
    const uint32_t w = (sh.row[tid][nw >> 1] >> (16 * (nw & 1))) & 0xFFFFu;
    const size_t srow = chunk * 4 + tid;
    n_words[srow] = static_cast<int32_t>(nw);
    acc_out[srow] = static_cast<int32_t>(nbits ? w >> (16 - nbits) : 0u);
    nbits_out[srow] = static_cast<int32_t>(nbits);
  }
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
    huffman_encode_kernel<<<n, kEncThreads, 0, as_stream(stream)>>>(
        static_cast<const uint8_t*>(chunks), static_cast<const int32_t*>(tbl),
        static_cast<int16_t*>(words), static_cast<int32_t*>(n_words),
        static_cast<int32_t*>(acc), static_cast<int32_t*>(nbits));
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

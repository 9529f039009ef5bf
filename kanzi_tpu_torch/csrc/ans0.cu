// Order-0 rANS (ANS0) entropy stage for Hopper (sm_90a): four kernels.
//
// Wire semantics are those of kanzi_tpu/entropy/ans.py: 16 KiB chunks, four
// interleaved 32-bit states, logRange 12 (scale 4096), ANS_TOP = 1 << 15,
// 16-bit renormalisation words.  Every kernel is bit-exact with its plain
// PyTorch version in kanzi_tpu_torch/ops/ans_cuda.py.
//
// Each launcher is a plain C function over raw device pointers and the CUDA
// stream; it launches on that stream, does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "compact.cuh"
#include "hist.cuh"

namespace {

constexpr int kChunk = kHistChunk;
constexpr int kLogRange = 12;
constexpr uint32_t kScale = 1u << kLogRange;
constexpr uint32_t kAnsTop = 1u << 15;

// ---------------------------------------------------------------------------
// block-wide helpers (blockDim.x == NT, a multiple of 32); the prefix sum,
// block_excl_scan, is in compact.cuh
// ---------------------------------------------------------------------------

template <int NT>
__device__ int block_max(int v, int* smem) {
  constexpr int kWarps = NT / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = smem[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = max(r, smem[i]);
  __syncthreads();
  return r;
}

template <int NT>
__device__ int block_min(int v, int* smem) {
  return -block_max<NT>(-v, smem);
}

// ---------------------------------------------------------------------------
// kernel 1: per-chunk histogram + exact frequency normalisation
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _hist16 (:278, an XLA nibble one-hot
// einsum) and _norm_kernel (:342, the VMEM port of _normalize_freqs_jax :290).
// One CTA of 256 threads per full 16 KiB chunk; thread k owns symbol k.
// The histogram is chunk_hist (hist.cuh, shared with huffman_hist); bound on
// this card and its design are described there.  Then the normalisation as
// block scans/reductions over the 256 threads: the first-max tie rule
// (lowest index) and exactly five bounded error-spreading rounds in symbol
// order, never a loop until done.  Valid only for rows that sum to 2^14; the
// tail chunk stays on the host.

__global__ void __launch_bounds__(kHistThreads)
hist_norm_kernel(const uint8_t* __restrict__ chunks, int32_t* __restrict__ freq) {
  __shared__ int wh[kHistThreads / 32][256];
  __shared__ int red[kHistThreads / 32 + 1];
  const int k = threadIdx.x;
  const size_t row = blockIdx.x;
  const int h = chunk_hist(chunks + row * kChunk, wh);

  const bool nz = h > 0;
  int scaled = 0;
  if (nz) {
    const int sf = h * static_cast<int>(kScale);  // <= 2^26
    scaled = sf <= kChunk ? 1 : (sf + (kChunk >> 1)) >> 14;
  }
  int asize, sum_scaled;
  block_excl_scan<kHistThreads>(nz ? 1 : 0, red, &asize);
  block_excl_scan<kHistThreads>(scaled, red, &sum_scaled);
  const int mval = block_max<kHistThreads>(scaled, red);
  const int imax = block_min<kHistThreads>(scaled == mval ? k : 4096, red);
  const bool is_max = k == imax;

  int f = scaled;
  const bool single = asize == 1;
  if (single) f = nz ? static_cast<int>(kScale) : 0;
  const bool active = !single && sum_scaled != static_cast<int>(kScale);
  const int delta = sum_scaled - static_cast<int>(kScale);
  const int err_thr = mval >> 4;
  const bool small = active && abs(delta) <= err_thr;
  if (small && is_max) f -= delta;
  const bool big = active && !small;
  const bool neg = big && delta < 0;
  const bool pos = big && delta > 0;
  if (big && is_max) f += neg ? err_thr : (pos ? -err_thr : 0);
  int d = neg ? delta + err_thr : (pos ? delta - err_thr : 0);
  const int inc = d > 0 ? -1 : 1;
  d = abs(d);
  bool live = big;
  for (int round = 0; round < 5; ++round) {
    const bool elig = nz && f > 2 && live;
    int tot;
    const int cnt = block_excl_scan<kHistThreads>(elig ? 1 : 0, red, &tot) + (elig ? 1 : 0);
    if (elig && cnt <= d) f += inc;
    const int nadj = min(tot, d);  // the first d eligible symbols moved
    d -= nadj;
    live = live && d > 0 && nadj > 0;
  }
  if (big && is_max) f = max(f - d, 1);
  freq[row * 256 + k] = f;
}

// ---------------------------------------------------------------------------
// kernel 2: the rANS encode scan
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _scan_sub_fused_kernel (:156).  The
// four state chains of a chunk are independent (state u encodes the bytes b
// with b % 4 == 3 - u, walking backward), so one thread runs one chain: 4
// threads per chunk, 32 chunks per 128-thread CTA, the chunk's packed
// f | cum << 12 table in shared memory (32 KiB per CTA).  Bound on this card:
// the serial dependence of each chain (a divide per byte), not bytes: a chunk
// gives only four threads.  Design: exact uint32 `/` and `%`, no f32 quotient
// (the TPU's f32 trick existed only because it has no integer divide).  Each
// emission word and flag is stored at its byte's own position, which is wire
// order, so kernel 3 needs no relayout.

constexpr int kScanChunksPerCta = 32;
constexpr int kScanThreads = 4 * kScanChunksPerCta;

__global__ void __launch_bounds__(kScanThreads)
encode_scan_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ tables,
                   int16_t* __restrict__ words, uint8_t* __restrict__ flags,
                   int32_t* __restrict__ states, int n, int c) {
  __shared__ uint32_t tbl[kScanChunksPerCta][256];
  const size_t base = static_cast<size_t>(blockIdx.x) * kScanChunksPerCta;
  for (int i = threadIdx.x; i < kScanChunksPerCta * 256; i += kScanThreads) {
    const size_t r = base + (i >> 8);
    tbl[i >> 8][i & 255] = r < static_cast<size_t>(n) ? static_cast<uint32_t>(tables[r * 256 + (i & 255)]) : 1u;
  }
  __syncthreads();
  const int local = threadIdx.x >> 2;
  const int u = threadIdx.x & 3;
  const size_t row = base + local;
  if (row >= static_cast<size_t>(n)) return;
  const uint8_t* src = chunks + row * c;
  int16_t* wv = words + row * c;
  uint8_t* wf = flags + row * c;
  const uint32_t* t = tbl[local];
  uint32_t st = kAnsTop;
  for (int s = u; s < c; s += 4) {
    const int b = c - 1 - s;
    const uint32_t lk = t[src[b]];
    const uint32_t f = lk & (kScale - 1);
    const uint32_t cm = lk >> kLogRange;
    const bool em = (st >> (31 - kLogRange)) >= f;  // st >= f << 19
    const uint32_t val = st & 0xFFFFu;
    if (em) st >>= 16;
    const uint32_t q = st / f;
    st = (q << kLogRange) + (st - q * f) + cm;
    wv[b] = em ? static_cast<int16_t>(static_cast<uint16_t>(val)) : int16_t(0);
    wf[b] = em ? 1 : 0;
  }
  states[row * 4 + u] = static_cast<int32_t>(st);
}

// ---------------------------------------------------------------------------
// kernel 3: payload compaction (stable partition of the flagged words)
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _compact2_kernel (:487).  One CTA of
// 1024 threads per chunk runs compact_tile (compact.cuh, shared with
// ans1_compact) over the chunk's words and flags: 16 consecutive positions a
// thread for a 16 KiB chunk.  Bound on this card: DRAM bytes (3 bytes read
// and 2 written per position).

constexpr int kCompactThreads = 1024;

__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const int16_t* __restrict__ words, const uint8_t* __restrict__ flags,
               int16_t* __restrict__ payload, int32_t* __restrict__ n_emit, int c) {
  __shared__ int red[kCompactThreads / 32 + 1];
  const size_t row = blockIdx.x;
  const int16_t* wv = words + row * c;
  const uint8_t* wf = flags + row * c;
  int mine;
  const int total = compact_tile<kCompactThreads>(
      [&](int i) { return wf[i] != 0 ? static_cast<int>(static_cast<uint16_t>(wv[i])) : -1; },
      c, payload + row * c, red, &mine);
  if (threadIdx.x == 0) n_emit[row] = total;
}

// ---------------------------------------------------------------------------
// kernel 4: the rANS decode, slot -> symbol included
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _decode_kernel (:661) and the
// rank -> symbol _lookup_kernel (:47) that follows it (:864).  A 32-thread
// CTA decodes 8 chunks, 4 threads per chunk, one per state.  Per chunk the
// CTA builds in shared memory the 4096-slot slot -> symbol table and a
// 256-entry freq | cum << 13 table (5 KiB per chunk, 40 KiB per CTA): the
// reference decoder's own shape (kanzi_tpu/entropy/ans.py:380-383) in place
// of the TPU's bucket words, so symbols come out directly and no rank pass
// is needed.  Slot s maps to the first symbol whose uncapped bound
// cum + freq exceeds s, the searchsorted rule of ops/ans.py.
// Each of the 4096 steps: the four states update, then the refills, lane 3
// consuming first: a warp ballot gives each lane the count of needing lanes
// above it.  Payload reads are bounded by the row's real length (a byte past
// it reads as 0), so a corrupt stream gives a consumed-count mismatch and
// never an out-of-bounds read.  Bound on this card: the serial dependence of
// a chunk's steps (shared-memory lookups, then a dependent global read).

constexpr int kDecChunksPerCta = 8;
constexpr int kDecThreads = 4 * kDecChunksPerCta;

__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const uint8_t* __restrict__ payload, long long pitch,
              const int32_t* __restrict__ lengths, const int32_t* __restrict__ states,
              const int32_t* __restrict__ freq, const int32_t* __restrict__ cum,
              uint8_t* __restrict__ out, int32_t* __restrict__ consumed, int n) {
  __shared__ uint8_t lut[kDecChunksPerCta][kScale];
  __shared__ uint32_t tbl[kDecChunksPerCta][256];
  const int local = threadIdx.x >> 2;
  const int j = threadIdx.x & 3;
  const size_t row = static_cast<size_t>(blockIdx.x) * kDecChunksPerCta + local;
  const bool active = row < static_cast<size_t>(n);

  for (int k = j; k < 256; k += 4) {
    uint32_t e = 0;
    if (active) {
      const uint32_t fr = static_cast<uint32_t>(freq[row * 256 + k]) & 0x1FFFu;
      const uint32_t cm = static_cast<uint32_t>(cum[row * 256 + k]) & 0x1FFFu;
      e = fr | (cm << 13);
    }
    tbl[local][k] = e;
  }
  __syncwarp();
  // slots [bound[k-1], bound[k]) -> k; slots past the last bound -> 255
  uint32_t prev = 0;
  for (int k = 0; k < 256; ++k) {
    const uint32_t e = tbl[local][k];
    uint32_t hi = min((e & 0x1FFFu) + (e >> 13), kScale);
    hi = max(hi, prev);
    for (uint32_t s = prev + j; s < hi; s += 4) lut[local][s] = static_cast<uint8_t>(k);
    prev = hi;
  }
  for (uint32_t s = prev + j; s < kScale; s += 4) lut[local][s] = 255;
  __syncwarp();

  uint32_t st = active ? static_cast<uint32_t>(states[row * 4 + j]) : 0u;
  const uint32_t len = active ? static_cast<uint32_t>(lengths[row]) : 0u;
  const uint8_t* pay = payload + (active ? row : 0) * pitch;
  uint8_t* dst = out + (active ? row : 0) * kChunk;
  const int group = threadIdx.x & 28;
  uint32_t ptr = 0;
  for (int t = 0; t < kChunk / 4; ++t) {
    const uint32_t slot = st & (kScale - 1);
    const uint32_t sym = lut[local][slot];
    const uint32_t e = tbl[local][sym];
    const uint32_t f = min(e & 0x1FFFu, kScale - 1);
    st = f * (st >> kLogRange) + slot - (e >> 13);
    const bool need = st < kAnsTop;
    const unsigned g = (__ballot_sync(kFull, need) >> group) & 0xFu;
    if (need) {
      const uint32_t p = ptr + 2u * __popc(g >> (j + 1));
      const uint32_t b0 = p < len ? pay[p] : 0u;
      const uint32_t b1 = p + 1 < len ? pay[p + 1] : 0u;
      st = (st << 16) | (b0 << 8) | b1;
    }
    ptr += 2u * __popc(g);
    if (active) dst[4 * t + 3 - j] = static_cast<uint8_t>(sym);
  }
  if (active && j == 0) consumed[row] = static_cast<int32_t>(ptr);
}

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

int kz_ans0_hist_norm(const void* chunks, void* freq, int n, void* stream) {
  if (n > 0) {
    hist_norm_kernel<<<n, kHistThreads, 0, as_stream(stream)>>>(
        static_cast<const uint8_t*>(chunks), static_cast<int32_t*>(freq));
  }
  return static_cast<int>(cudaGetLastError());
}

int kz_ans0_encode_scan(const void* chunks, const void* tables, void* words, void* flags,
                        void* states, int n, int c, void* stream) {
  if (n > 0) {
    const int grid = (n + kScanChunksPerCta - 1) / kScanChunksPerCta;
    encode_scan_kernel<<<grid, kScanThreads, 0, as_stream(stream)>>>(
        static_cast<const uint8_t*>(chunks), static_cast<const int32_t*>(tables),
        static_cast<int16_t*>(words), static_cast<uint8_t*>(flags),
        static_cast<int32_t*>(states), n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

int kz_ans0_compact(const void* words, const void* flags, void* payload, void* n_emit,
                    int n, int c, void* stream) {
  if (n > 0) {
    compact_kernel<<<n, kCompactThreads, 0, as_stream(stream)>>>(
        static_cast<const int16_t*>(words), static_cast<const uint8_t*>(flags),
        static_cast<int16_t*>(payload), static_cast<int32_t*>(n_emit), c);
  }
  return static_cast<int>(cudaGetLastError());
}

int kz_ans0_decode(const void* payload, long long pitch, const void* lengths,
                   const void* states, const void* freq, const void* cum, void* out,
                   void* consumed, int n, void* stream) {
  if (n > 0) {
    const int grid = (n + kDecChunksPerCta - 1) / kDecChunksPerCta;
    decode_kernel<<<grid, kDecThreads, 0, as_stream(stream)>>>(
        static_cast<const uint8_t*>(payload), pitch, static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(states), static_cast<const int32_t*>(freq),
        static_cast<const int32_t*>(cum), static_cast<uint8_t*>(out),
        static_cast<int32_t*>(consumed), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Order-1 rANS (ANS1) encode stage for Hopper (sm_90a): three kernels.
//
// Wire semantics are those of kanzi_tpu/entropy/ans.py, order 1: 4 MiB
// chunks, four 32-bit states (state k walks quarter k backward), logRange 11
// (scale 2048), ANS_TOP = 1 << 15, 16-bit renormalisation words, the
// context of a byte the byte before it (0 at each quarter start).  Every
// kernel is bit-exact with its plain PyTorch version in
// kanzi_tpu_torch/ops/ans1_cuda.py.
//
// Each launcher is a plain C function over raw device pointers and the CUDA
// stream; it launches on that stream, does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "compact.cuh"

namespace {

constexpr uint32_t kAnsTop = 1u << 15;

// ---------------------------------------------------------------------------
// kernel 1: the order-1 table lookup
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _lookup1_kernel (:885), an MXU one-hot
// contraction over the high 9 index bits and an elementwise one-hot over the
// low 7, and the context computation before it (:948-951).  Here a plain
// gather: one thread codes 4 positions, reading one u32 of symbols and the
// byte before them (the context; 0 at a quarter start, which falls on a
// multiple of 4 since C / 4 does), and writes the four packed entries with
// one 16-byte store.  The chunk's 256 KiB table does not fit in shared
// memory, so it is read through L2 (__ldg).  Bound on this card: DRAM
// bytes, 1 read and 4 written per position, plus the table once per chunk.

constexpr int kLookupThreads = 256;

__global__ void __launch_bounds__(kLookupThreads)
lookup1_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ packed,
               int32_t* __restrict__ out, int n, int c) {
  const long long groups = static_cast<long long>(c >> 2);
  const long long g = static_cast<long long>(blockIdx.x) * kLookupThreads + threadIdx.x;
  if (g >= n * groups) return;
  const long long row = g / groups;
  const int p0 = static_cast<int>(g - row * groups) << 2;
  const uint8_t* src = chunks + row * c;
  const int32_t* tbl = packed + row * 65536;
  const uint32_t syms = reinterpret_cast<const uint32_t*>(src)[p0 >> 2];
  uint32_t ctx = p0 % (c >> 2) == 0 ? 0u : src[p0 - 1];
  int32_t v[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t s = (syms >> (8 * b)) & 255u;
    v[b] = __ldg(tbl + ((ctx << 8) | s));
    ctx = s;
  }
  reinterpret_cast<int4*>(out + row * c)[p0 >> 2] = make_int4(v[0], v[1], v[2], v[3]);
}

// ---------------------------------------------------------------------------
// kernel 2: the rANS state scan
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _scan_kernel (:80), which steps all
// 128-lane rows in lockstep and keeps the states in VMEM across its
// sequential grid.  The lanes are independent chains, so one thread runs one
// lane's whole chain of `steps` steps, with exact uint32 `/` (the TPU's f32
// quotient and correction existed only because it has no integer divide).
// Two layouts:
//   step-major (chunked == 0): _scan's contract, lane l's entry of step t at
//     t * lanes + l, its word at the same place (the tests' padded lanes);
//   chunked (chunked == 1): the main path's, lk the lookup's (N, C) output
//     in byte order, lane l = 4n + k walking quarter k of chunk n backward
//     (entry n*C + k*q + q-1-t, q = steps) and storing its word straight at
//     its forward wire position n*C + 4*(q-1-t) + 3-k, so no relayout pass
//     follows: the compaction reads the scan's output as it is.
// Only the real lanes run (4 per chunk, not the TPU's 128-lane padding).
// Bound on this card: the serial dependence of each chain (a divide per
// step), not bytes: a 4 MiB chunk gives four threads.  The entries do not
// depend on the state, so they are read kAhead steps ahead of the chain,
// one group in registers while the group before it is coded.

constexpr int kScanThreads = 128;
constexpr int kAhead = 16;

// One step of a lane's chain on entry e = f | cm << lr: the emitted word
// (flag << 16 | val, 0 where nothing was emitted) goes to *word.
__device__ __forceinline__ uint32_t ans_step(uint32_t st, uint32_t e, int lr, uint32_t* word) {
  const uint32_t f = e & ((1u << lr) - 1u);
  const uint32_t cm = e >> lr;
  const bool em = (st >> (31 - lr)) >= f;   // st >= f << (31 - lr)
  *word = em ? (0x10000u | (st & 0xFFFFu)) : 0u;
  if (em) st >>= 16;
  const uint32_t q = st / f;
  return (q << lr) + (st - q * f) + cm;
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int32_t* __restrict__ lk, int32_t* __restrict__ emit,
            int32_t* __restrict__ states, int lanes, int steps, int lr, int chunked) {
  const int l = static_cast<int>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (l >= lanes) return;
  long long in0, out0, din, dout;  // lane l's entry / word of step t: x0 + t * dx
  if (chunked) {
    const long long q = steps;
    const long long base = static_cast<long long>(l >> 2) * 4 * q;
    const int k = l & 3;
    in0 = base + k * q + q - 1;
    din = -1;
    out0 = base + 4 * (q - 1) + 3 - k;
    dout = -4;
  } else {
    in0 = out0 = l;
    din = dout = lanes;
  }
  uint32_t st = kAnsTop;
  uint32_t cur[kAhead], nxt[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) cur[i] = i < steps ? static_cast<uint32_t>(lk[in0 + i * din]) : 1u;
  for (int t0 = 0; t0 < steps; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const long long t = t0 + kAhead + i;
      nxt[i] = t < steps ? static_cast<uint32_t>(lk[in0 + t * din]) : 1u;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (t0 + i < steps) {
        uint32_t word;
        st = ans_step(st, cur[i], lr, &word);
        emit[out0 + static_cast<long long>(t0 + i) * dout] = static_cast<int32_t>(word);
      }
      cur[i] = nxt[i];
    }
  }
  states[l] = static_cast<int32_t>(st);
}

// The chain alone, to measure its floor: one thread runs `steps` (a multiple
// of kAhead) of scan_kernel's steps over kAhead entries held in registers,
// with no load and no store inside the timed loop, and counts the SM cycles
// with clock64.  The empty asm makes each entry opaque at every step, so the
// compiler cannot hoist the divide's work on f out of the loop.  Not on any
// codec path; chip_smoke.py calls it beside ans1_scan.
__global__ void scan_chain_kernel(const int32_t* __restrict__ lk, int32_t* __restrict__ out,
                                  long long* __restrict__ cycles, int steps, int lr) {
  uint32_t ent[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) ent[i] = static_cast<uint32_t>(lk[i]);
  uint32_t st = kAnsTop, acc = 0;
  const long long c0 = clock64();
  for (int t0 = 0; t0 < steps; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      uint32_t e = ent[i], word;
      asm volatile("" : "+r"(e));
      st = ans_step(st, e, lr, &word);
      acc ^= word;
    }
  }
  const long long c1 = clock64();
  out[0] = static_cast<int32_t>(st);
  out[1] = static_cast<int32_t>(acc);
  cycles[0] = c1 - c0;
}

// ---------------------------------------------------------------------------
// kernel 3: per-tile compaction of the packed words
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _compact_kernel (:480) in its
// standalone use (ANS1, :970).  One CTA of 1024 threads per tile of nb * 128
// packed flag << 16 | val words runs compact_tile (compact.cuh, shared with
// ans0_compact); then the per-128-word block counts of the contract: each
// thread's run (nb / 8 words, or 1) lies inside one block, so a shared
// atomic per thread sums them.  Bound on this card: DRAM bytes, 4 read and 2
// written per position.

constexpr int kCompactThreads = 1024;

__global__ void __launch_bounds__(kCompactThreads)
compact1_kernel(const int32_t* __restrict__ e, int16_t* __restrict__ payload,
                int32_t* __restrict__ counts, int nb) {
  __shared__ int red[kCompactThreads / 32 + 1];
  __shared__ int bcnt[128];
  const int c = nb * 128;
  const size_t tile = blockIdx.x;
  const int32_t* src = e + tile * c;
  if (threadIdx.x < nb) bcnt[threadIdx.x] = 0;  // seen after compact_tile's barriers
  int mine;
  compact_tile<kCompactThreads>(
      [&](int i) {
        const uint32_t w = static_cast<uint32_t>(src[i]);
        return (w >> 16) != 0 ? static_cast<int>(w & 0xFFFFu) : -1;
      },
      c, payload + tile * c, red, &mine);
  const int per = (c + kCompactThreads - 1) / kCompactThreads;
  if (mine) atomicAdd(&bcnt[(threadIdx.x * per) >> 7], mine);
  __syncthreads();
  if (threadIdx.x < nb) counts[tile * nb + threadIdx.x] = bcnt[threadIdx.x];
}

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

int kz_ans1_lookup(const void* chunks, const void* packed, void* out, int n, int c,
                   void* stream) {
  if (n > 0 && c > 0) {
    const long long groups = static_cast<long long>(n) * (c >> 2);
    const int grid = static_cast<int>((groups + kLookupThreads - 1) / kLookupThreads);
    lookup1_kernel<<<grid, kLookupThreads, 0, as_stream(stream)>>>(
        static_cast<const uint8_t*>(chunks), static_cast<const int32_t*>(packed),
        static_cast<int32_t*>(out), n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

int kz_ans1_scan(const void* lk, void* emit, void* states, int lanes, int steps, int lr,
                 int chunked, void* stream) {
  if (lanes > 0 && steps > 0) {
    const int grid = (lanes + kScanThreads - 1) / kScanThreads;
    scan_kernel<<<grid, kScanThreads, 0, as_stream(stream)>>>(
        static_cast<const int32_t*>(lk), static_cast<int32_t*>(emit),
        static_cast<int32_t*>(states), lanes, steps, lr, chunked);
  }
  return static_cast<int>(cudaGetLastError());
}

int kz_ans1_scan_chain(const void* lk, void* out, void* cycles, int steps, int lr,
                       void* stream) {
  scan_chain_kernel<<<1, 1, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(lk), static_cast<int32_t*>(out),
      static_cast<long long*>(cycles), steps, lr);
  return static_cast<int>(cudaGetLastError());
}

int kz_ans1_compact(const void* e, void* payload, void* counts, int m, int nb, void* stream) {
  if (m > 0) {
    compact1_kernel<<<m, kCompactThreads, 0, as_stream(stream)>>>(
        static_cast<const int32_t*>(e), static_cast<int16_t*>(payload),
        static_cast<int32_t*>(counts), nb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Order-1 rANS (ANS1) encode stage for Hopper (sm_90a): two kernels, and
// three measurements beside them on no codec path.
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
#include "rans.cuh"

namespace {

constexpr uint32_t kAnsTop = 1u << 15;

// ---------------------------------------------------------------------------
// kernel 1: the order-1 lookup and the state scan, fused
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _scan_kernel (:80), which steps all
// 128-lane rows in lockstep with an f32 quotient and a correction and keeps
// the states in VMEM across its sequential grid, and _lookup1_kernel (:885),
// an MXU one-hot contraction that writes each position's packed entry to
// device memory for the scan to read back.  One CTA a chunk; its 4 real
// lanes (not the TPU's 128-lane padding) each walk one quarter backward and
// store the word of step t straight at its forward wire position
// n*C + 4*(q-1-t) + 3-k (the four lanes are neighbours in a warp, so a
// step's stores fill one 16-byte segment), so no relayout pass follows and
// the compaction reads the output as it is.
//
// Bound on this card: the latency of each lane's serial chain, not bytes (a
// 4 MiB chunk gives four chains).  A warp issues its instructions in order,
// so whatever one thread does beside its chain waits behind the chain's
// stalls; so the work is split between two warps:
//   - warp 1, lanes 0-3, the producers: lane k reads quarter k's bytes
//     backward in aligned 16-byte loads, kAheadVec groups of 16 steps ahead
//     (the vector below the quarter's start reads as zeros: its first
//     byte's context is 0); gathers each step's entry packed[n][ctx << 8 |
//     sym] through L2 (the chunk's 256 KiB table) one group ahead; and
//     writes the step's operands (step_operands from a 2^lr-entry shared
//     table, which the CTA builds at its start with exact 64-bit division,
//     and 2 cm) into its lane's ring of kRing steps in shared memory;
//   - warp 0, lanes 0-3, the chains: one 16-byte shared load a step, the
//     step, one store.
// Each lane pair hands over groups through two counts in shared memory,
// each written after a block fence (without the fences the card reorders
// the counts and the ring's reads and writes, and the output goes wrong).
// The producer publishes every kPublish groups, and the chain polls only
// when it has used the groups it last saw published: a fence waits for the
// thread's memory operations in flight, so each one costs.

constexpr int kGroup = 16;                  // steps a group: one 16-byte vector
constexpr int kRingGroups = 8;              // groups of operands a lane's ring holds
constexpr int kRing = kRingGroups * kGroup;
constexpr int kPublish = 4;                 // groups a producer publishes at once
constexpr int kAheadVec = 4;                // byte vectors ahead, in groups
constexpr int kScanThreads = 64;            // warp 0: chains; warp 1: producers

// Group j's 16 table entries: step 16j + i codes byte 15 - i of v, its
// context the byte below it (lo's top byte below byte 0).
__device__ __forceinline__ void gather_entries(const int32_t* __restrict__ tbl, uint4 v,
                                               uint4 lo, uint32_t* ent) {
  const uint32_t w[5] = {lo.w, v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < kGroup; ++b) {
    const uint32_t word = w[1 + (b >> 2)];
    const int at = b & 3;
    // (ctx << 8) | sym: sym byte `at` of word, ctx the byte before it
    const uint32_t idx = at ? __byte_perm(word, 0u, at | (at - 1) << 4 | 0x4400)
                            : __byte_perm(word, w[b >> 2], 0x4470) & 0xFFFFu;
    ent[kGroup - 1 - b] = static_cast<uint32_t>(__ldg(tbl + idx));
  }
}

__device__ __forceinline__ int poll(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void publish(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ packed,
            int32_t* __restrict__ emit, int32_t* __restrict__ states, int c, int lr) {
  extern __shared__ uint4 smem[];
  uint4* ops = smem;                                          // by f (entry 0 unused)
  uint4* ring = smem + (1 << lr);                             // 4 lanes x kRing steps
  int* counts = reinterpret_cast<int*>(ring + 4 * kRing);     // produced[4], consumed[4]
  for (int f = 1 + threadIdx.x; f < (1 << lr); f += kScanThreads) ops[f] = step_operands(f, lr);
  if (threadIdx.x < 8) counts[threadIdx.x] = 0;
  __syncthreads();
  const int k = threadIdx.x & 31;
  if (k >= 4) return;
  const long long chunk = blockIdx.x;
  const int q = c >> 2;
  const int groups = q / kGroup;
  uint4* mine = ring + k * kRing;
  int* produced = counts + k;
  int* consumed = counts + 4 + k;
  if (threadIdx.x >= 32) {
    const uint4* vec =
        reinterpret_cast<const uint4*>(chunks + chunk * c + static_cast<long long>(k) * q);
    const int32_t* tbl = packed + chunk * 65536;
    const uint32_t fmask = (1u << lr) - 1u;
    // group j codes vector groups - 1 - j; below the quarter, zeros
    auto load = [&](int j) {
      return j < groups ? __ldg(vec + (groups - 1 - j)) : make_uint4(0u, 0u, 0u, 0u);
    };
    uint4 v[kAheadVec];   // at group j: the vectors of groups j + 1 .. j + kAheadVec
#pragma unroll
    for (int i = 0; i < kAheadVec; ++i) v[i] = load(1 + i);
    uint32_t ent[kGroup];
    gather_entries(tbl, load(0), v[0], ent);
#pragma unroll 1
    for (int j = 0; j < groups; ++j) {
      uint4 s[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        s[i] = ops[ent[i] & fmask];
        s[i].z |= (ent[i] >> lr) << 6;
      }
      gather_entries(tbl, v[0], v[1], ent);   // group j + 1
#pragma unroll
      for (int i = 0; i + 1 < kAheadVec; ++i) v[i] = v[i + 1];
      v[kAheadVec - 1] = load(j + 1 + kAheadVec);
      while (j - poll(consumed) >= kRingGroups) {
      }
      __threadfence_block();
      uint4* slot = mine + (j % kRingGroups) * kGroup;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) slot[i] = s[i];
      if (j % kPublish == kPublish - 1 || j == groups - 1) {
        __threadfence_block();
        publish(produced, j + 1);
      }
    }
  } else {
    int32_t* out = emit + chunk * c + 4LL * (q - 1) + 3 - k;   // step t at out - 4t
    uint32_t st2 = kAnsTop << 1;
    int avail = 0;   // groups seen produced
#pragma unroll 1
    for (int j = 0; j < groups; ++j) {
      if (j >= avail) {
        while ((avail = poll(produced)) <= j) {
        }
        __threadfence_block();
      }
      const uint4* slot = mine + (j % kRingGroups) * kGroup;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        uint32_t word;
        st2 = ans_step(st2, slot[i], &word);
        out[-4 * i] = static_cast<int32_t>(word);
      }
      out -= 4 * kGroup;
      __threadfence_block();
      publish(consumed, j + 1);
    }
    states[chunk * 4 + k] = static_cast<int32_t>(st2 >> 1);
  }
}

// The chain alone, to measure its floor: one thread runs `steps` (a multiple
// of kGroup) of rans.cuh's steps at logRange lr (11: scan_kernel's; 12:
// ans0.cu encode_scan_kernel's) over the kGroup entries of lk, their
// operands computed before the loop and held in registers, with no load or
// store inside the timed loop, and counts the SM cycles with clock64.  The
// empty asm makes each step's operands opaque, so the compiler cannot carry
// work on them across steps.  Not on any codec path; chip_smoke.py calls it
// beside ans1_scan and ans0_encode_scan.
__global__ void scan_chain_kernel(const int32_t* __restrict__ lk, int32_t* __restrict__ out,
                                  long long* __restrict__ cycles, int steps, int lr) {
  uint4 s[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const uint32_t e = static_cast<uint32_t>(lk[i]);
    s[i] = step_operands(e & ((1u << lr) - 1u), lr);
    s[i].z |= (e >> lr) << 6;
  }
  uint32_t st2 = kAnsTop << 1, acc = 0;
  const long long c0 = clock64();
  for (int t0 = 0; t0 < steps; t0 += kGroup) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      asm volatile("" : "+r"(s[i].x), "+r"(s[i].y), "+r"(s[i].z), "+r"(s[i].w));
      uint32_t word;
      st2 = ans_step(st2, s[i], &word);
      acc ^= word;
    }
  }
  const long long c1 = clock64();
  out[0] = static_cast<int32_t>(st2 >> 1);
  out[1] = static_cast<int32_t>(acc);
  cycles[0] = c1 - c0;
}

// The reciprocal of rans.cuh against exact division, exhaustively: for every
// f in [1, 2^lr) and every x < 2^31 (every state), umulhi(2x, m) >> l must equal
// x / f.  x / f comes from one exact division at the start of each thread's
// run of kCheckRun values, then counts up: q and r step as x does.
// counts[0] += the mismatches, counts[1] += the pairs compared.  Not on any
// codec path; chip_smoke.py runs it for lr = 11 (~4.4e12 pairs), this
// file's range, and lr = 12 (~8.8e12), ans0.cu's.
constexpr int kCheckThreads = 256;
constexpr int kCheckRun = 1 << 16;

__global__ void __launch_bounds__(kCheckThreads)
recip_check_kernel(unsigned long long* __restrict__ counts) {
  const uint32_t f = blockIdx.y + 1;
  const uint32_t x0 = (blockIdx.x * kCheckThreads + threadIdx.x) * static_cast<uint32_t>(kCheckRun);
  const Recip r = recip(f);
  uint32_t miss = 0, q = x0 / f, rem = x0 % f;
#pragma unroll 4
  for (uint32_t x = x0; x < x0 + kCheckRun; ++x) {
    miss += (__umulhi(x << 1, r.m) >> r.l) != q;
    if (++rem == f) {
      rem = 0;
      ++q;
    }
  }
  unsigned long long bad = miss, pairs = kCheckRun;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bad += __shfl_down_sync(0xFFFFFFFFu, bad, o);
    pairs += __shfl_down_sync(0xFFFFFFFFu, pairs, o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(counts, bad);
    atomicAdd(counts + 1, pairs);
  }
}

// An empty kernel: the floor of chip_smoke.py's card-alone times, which
// count the gap between two queued launches as well as a kernel's run.  Not
// on any codec path.
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// kernel 2: per-tile compaction of the packed words
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _compact_kernel (:480) in its
// standalone use (ANS1, :970): each tile of nb * 128 packed flag << 16 | val
// words (nb a power of two <= 128; the encode runs nb = 128, 256 tiles a
// 4 MiB chunk) is stably partitioned, with zeros after its words, and the
// flagged words of each 128-word block are counted.  Bound on this card:
// DRAM bytes, 4 read and 2 written a position (16 MiB read and 8 MiB +
// 128 KiB written a chunk, 0.0076 ms at 3.35 TB/s).  The design: one CTA a
// tile runs compact.cuh's tiled body, compact_staged, with nothing carried
// (each tile's output starts at its own 16-byte aligned front).
//   - A thread's loader reads its 32 consecutive words once, as eight
//     16-byte loads issued together; a word is flagged where w >> 16 != 0.
//   - The CTA has c / 32 threads, at least 32: 512 at nb = 128, 32 for
//     nb <= 8 (the threads past the tile's end load nothing).
//   - A 128-word block is the runs of four neighbouring lanes, so its count
//     is two __shfl_xor_sync of the runs' counts, stored by the first of
//     the four: no shared atomic.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6): 0.0095-0.0096
// ms a chunk on the card alone, 1.25 x its bound, against 0.0253-0.0256
// for compact.cuh's scalar body at 1,024 threads a tile in the same call.

template <int NT>
__global__ void __launch_bounds__(NT)
compact1_kernel(const int32_t* __restrict__ e, int16_t* __restrict__ payload,
                int32_t* __restrict__ counts, int nb) {
  __shared__ StagedSmem<NT> sh;
  const int c = nb * 128;
  const size_t tile = blockIdx.x;
  const int32_t* src = e + tile * c;
  auto load = [&](int lo) {
    Run r;
    r.mask = 0;
    if (lo >= c) {
#pragma unroll
      for (int i = 0; i < kRunLen / 2; ++i) r.w[i] = 0;
      return r;
    }
    uint4 v[kRunLen / 4];
#pragma unroll
    for (int i = 0; i < kRunLen / 4; ++i) v[i] = __ldg(reinterpret_cast<const uint4*>(src + lo) + i);
#pragma unroll
    for (int i = 0; i < kRunLen / 4; ++i) {
      const uint32_t x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) r.mask |= static_cast<uint32_t>((x[j] >> 16) != 0) << (4 * i + j);
      r.w[2 * i] = __byte_perm(x[0], x[1], 0x5410);
      r.w[2 * i + 1] = __byte_perm(x[2], x[3], 0x5410);
    }
    return r;
  };
  int mine;
  compact_staged<NT, false>(load, c, payload + tile * c, sh, &mine);
  // the block of 128 words of lanes 4 b .. 4 b + 3
  mine += __shfl_xor_sync(kFull, mine, 1);
  mine += __shfl_xor_sync(kFull, mine, 2);
  const int tid = threadIdx.x;
  if ((tid & 3) == 0 && tid * kRunLen < c) counts[tile * nb + tid / 4] = mine;
}

template <int NT>
void launch_compact1(const void* e, void* payload, void* counts, int m, int nb,
                     cudaStream_t stream) {
  compact1_kernel<NT><<<m, NT, 0, stream>>>(static_cast<const int32_t*>(e),
                                            static_cast<int16_t*>(payload),
                                            static_cast<int32_t*>(counts), nb);
}

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

int kz_ans1_scan(const void* chunks, const void* packed, void* emit, void* states, int n,
                 int c, int lr, void* stream) {
  if (n > 0 && c > 0) {
    const size_t smem = (sizeof(uint4) << lr) + 4 * kRing * sizeof(uint4) + 8 * sizeof(int);
    scan_kernel<<<n, kScanThreads, smem, as_stream(stream)>>>(
        static_cast<const uint8_t*>(chunks), static_cast<const int32_t*>(packed),
        static_cast<int32_t*>(emit), static_cast<int32_t*>(states), c, lr);
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

int kz_ans1_recip_check(void* counts, int lr, void* stream) {
  const dim3 grid((1u << 31) / kCheckRun / kCheckThreads, (1u << lr) - 1u);
  recip_check_kernel<<<grid, kCheckThreads, 0, as_stream(stream)>>>(
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

int kz_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, as_stream(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int kz_ans1_compact(const void* e, void* payload, void* counts, int m, int nb, void* stream) {
  if (m > 0) {
    // c / 32 threads, at least a warp
    const cudaStream_t s = as_stream(stream);
    switch (nb) {
      case 128: launch_compact1<512>(e, payload, counts, m, nb, s); break;
      case 64: launch_compact1<256>(e, payload, counts, m, nb, s); break;
      case 32: launch_compact1<128>(e, payload, counts, m, nb, s); break;
      case 16: launch_compact1<64>(e, payload, counts, m, nb, s); break;
      case 8: case 4: case 2: case 1: launch_compact1<32>(e, payload, counts, m, nb, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

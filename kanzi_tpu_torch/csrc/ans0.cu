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
#include "rans.cuh"
#include "stage.cuh"

namespace {

constexpr int kChunk = kHistChunk;
constexpr int kLogRange = 12;
constexpr uint32_t kScale = 1u << kLogRange;
constexpr uint32_t kAnsTop = 1u << 15;

// ---------------------------------------------------------------------------
// kernel 1: per-chunk histogram + exact frequency normalisation
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _hist16 (:278, an XLA nibble one-hot
// einsum) and _norm_kernel (:342, the VMEM port of _normalize_freqs_jax :290).
// One CTA of kHistThreads threads per full 16 KiB chunk.  The histogram is
// chunk_hist (hist.cuh, shared with huffman_hist); bound on this card and its
// design are described there.  Then one warp normalises the 256 counts and
// the other warps exit: lane l holds bins [8 l, 8 l + 8) in registers, so
// index order is lane order, then register order.  The symbol count, the
// scaled sum, the max and the first index of the max are warp reductions
// (__reduce_*_sync); each of the exactly five bounded error-spreading
// rounds moves the first d eligible symbols in index order, their ranks a
// warp scan of the lanes' counts plus the rank inside the lane.  No block
// barrier follows the counting but the one that hands the counts to the
// warp.  Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6), on
// the card alone at 256 chunks: 0.0049-0.0050 ms, of which the counting
// (huffman_hist's time) is 0.0042-0.0043 and the launch floor (an empty
// kernel) 0.0021; the normalisation by block scans over 256 threads that
// this warp replaced took 0.0065-0.0066 in the same call.  Valid only for
// rows that sum to 2^14; the tail chunk stays on the host.

constexpr int kNormPer = 256 / 32;           // bins a lane

// The normalisation of the counts hs[0, 256) (shared memory, 16-byte
// aligned) into out[0, 256), by the 32 lanes of one warp: the first-max
// tie rule (lowest index) and exactly five rounds in symbol order, never a
// loop until done.
__device__ __forceinline__ void norm_warp(const int* hs, int32_t* __restrict__ out) {
  const int l = threadIdx.x & 31;
  const int base = kNormPer * l;
  const int4 lo = reinterpret_cast<const int4*>(hs)[2 * l];
  const int4 hi = reinterpret_cast<const int4*>(hs)[2 * l + 1];
  const int h[kNormPer] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int f[kNormPer];
  uint32_t nz = 0;
  int sum = 0, mx = 0;
#pragma unroll
  for (int i = 0; i < kNormPer; ++i) {
    const int sf = h[i] * static_cast<int>(kScale);  // <= 2^26
    f[i] = h[i] == 0 ? 0 : (sf <= kChunk ? 1 : (sf + (kChunk >> 1)) >> 14);
    nz |= static_cast<uint32_t>(h[i] > 0) << i;
    sum += f[i];
    mx = max(mx, f[i]);
  }
  const int asize = __reduce_add_sync(kFull, __popc(nz));
  const int sum_scaled = __reduce_add_sync(kFull, sum);
  const int mval = __reduce_max_sync(kFull, mx);
  int first = 256;
#pragma unroll
  for (int i = kNormPer - 1; i >= 0; --i) first = f[i] == mval ? base + i : first;
  const int imax = __reduce_min_sync(kFull, first);

  const bool single = asize == 1;
  if (single) {
#pragma unroll
    for (int i = 0; i < kNormPer; ++i) f[i] = (nz >> i) & 1u ? static_cast<int>(kScale) : 0;
  }
  const bool active = !single && sum_scaled != static_cast<int>(kScale);
  const int delta = sum_scaled - static_cast<int>(kScale);
  const int err_thr = mval >> 4;
  const bool small = active && abs(delta) <= err_thr;
  const bool big = active && !small;
  // the max's first move: all of a small delta, or err_thr toward it
  const int first_move = small ? -delta : (big ? (delta < 0 ? err_thr : -err_thr) : 0);
#pragma unroll
  for (int i = 0; i < kNormPer; ++i) f[i] += base + i == imax ? first_move : 0;
  int d = big ? (delta < 0 ? delta + err_thr : delta - err_thr) : 0;
  const int inc = d > 0 ? -1 : 1;
  d = abs(d);
  bool live = big;
  for (int round = 0; round < 5 && live; ++round) {   // live is the same in every lane
    uint32_t el = 0;
#pragma unroll
    for (int i = 0; i < kNormPer; ++i) el |= static_cast<uint32_t>(((nz >> i) & 1u) && f[i] > 2) << i;
    const int cnt = __popc(el);
    const int incl = warp_incl_scan(cnt);
    const int tot = __shfl_sync(kFull, incl, 31);
    int rank = incl - cnt;                   // eligible symbols in the lanes before
#pragma unroll
    for (int i = 0; i < kNormPer; ++i) {
      const bool e = (el >> i) & 1u;
      rank += e;
      f[i] += e && rank <= d ? inc : 0;      // the first d eligible symbols move
    }
    const int nadj = min(tot, d);
    d -= nadj;
    live = d > 0 && nadj > 0;
  }
  if (big) {
#pragma unroll
    for (int i = 0; i < kNormPer; ++i) f[i] = base + i == imax ? max(f[i] - d, 1) : f[i];
  }
  int4* dst = reinterpret_cast<int4*>(out + base);
  dst[0] = make_int4(f[0], f[1], f[2], f[3]);
  dst[1] = make_int4(f[4], f[5], f[6], f[7]);
}

__global__ void __launch_bounds__(kHistThreads)
hist_norm_kernel(const uint8_t* __restrict__ chunks, int32_t* __restrict__ freq) {
  __shared__ __align__(16) int wh[kHistWarps][256];
  __shared__ __align__(16) int hs[256];
  const int k = threadIdx.x;
  const size_t row = blockIdx.x;
  const int h = chunk_hist(chunks + row * kChunk, wh);
  if (k < 256) hs[k] = h;
  __syncthreads();
  if (k >= 32) return;
  norm_warp(hs, freq + row * 256);
}

// ---------------------------------------------------------------------------
// kernel 2: the rANS encode scan
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _scan_sub_fused_kernel (:156).  The
// four state chains of a chunk are independent (state u encodes the bytes b
// with b % 4 == 3 - u, walking backward).  Bound on this card: one chain's
// c / 4 steps, each a few dependent integer operations (the chain alone,
// ans1.cu scan_chain_kernel, measures ~34 cycles a step), with the loads
// and stores beside it issued by the same warp; the chunks of a launch run
// side by side, so only a shorter step (and a short start) makes a launch
// faster.  What the design does about it:
//   - A warp a chunk (a CTA of 32 threads, its shared memory static).  The
//     32 lanes stage the row (up to 16 KiB; a wider row is read where it
//     lies) by cp.async while they build the chunk's 256 step operands
//     (rans.cuh step_operands at logRange 12, 2 cm packed above l), one
//     exact 64-bit divide each; then lanes 0-3 run the four chains.  A
//     symbol with f = 0 is absent from its chunk (in every table the
//     encoder makes), so its entry gets no divide, and is never read.
//   - The step of rans.cuh on the doubled state st2 = 2 st: its test
//     st2 >= f << 20 is ANS0's renormalisation test st >= f << 19, and the
//     divide is umulhi, a shift and a multiply-add, exact for every state
//     below 2^31, which every table with f + cum <= 4096 keeps (a
//     normalised one does).  The state is written back as st2 >> 1.
//   - Operands off the chain: each step's byte and its 16-byte operand
//     entry are read from shared memory two groups of 16 steps ahead, into
//     two register sets taken in turn, so no step waits on a load.
//   - Each emission word and flag is stored at its byte's own position,
//     which is wire order, so kernel 3 needs no relayout; the four lanes'
//     stores of a step are neighbours.
// Measured beside it (PERF.md section 6): two chunks a CTA reading the
// bytes as words, and operands one group ahead, no faster; two states a
// lane, slower.

constexpr int kScanGroup = 16;               // steps a group
constexpr int kScanStaged = kChunk;          // rows up to this width are staged

// a chunk's shared memory (20.1 KiB)
struct ScanSmem {
  uint4 ops[256];                            // step operands by symbol
  uint8_t ahead[128];                        // read, unused, by the last groups' lookahead
  alignas(16) uint32_t row[kScanStaged / 4];
};

// The chain of a lane: its steps t, their bytes at rb[-4 t] (in shared
// memory if kStaged, else in device memory), its words and flags at
// wv[-4 t], wf[-4 t].  Returns the final state.
template <bool kStaged>
__device__ __forceinline__ uint32_t scan_chain(const uint4* ops, const uint8_t* rb,
                                               int16_t* wv, uint8_t* wf, int steps) {
  uint32_t st2 = kAnsTop << 1;
  auto step = [&](int t, uint4 s) {
    bool em;
    const uint32_t val = st2 >> 1;
    st2 = ans_step_em(st2, s, &em);
    wv[-4 * t] = static_cast<int16_t>(em ? val : 0u);
    wf[-4 * t] = em ? 1 : 0;
  };
  const int head = steps % kScanGroup;
  for (int t = 0; t < head; ++t) step(t, ops[rb[-4 * t]]);
  rb -= 4 * head;
  wv -= 4 * head;
  wf -= 4 * head;
  const int groups = steps / kScanGroup;
  // the byte of step i of the group g groups on; past the row's start,
  // any byte (staged: the struct's `ahead` bytes)
  auto byte = [&](int g, int i) -> uint32_t {
    if (kStaged) return rb[-4 * (kScanGroup * g + i)];
    return g < groups ? __ldg(rb - 4 * (kScanGroup * g + i)) : 0u;
  };
  uint4 sa[kScanGroup], sb[kScanGroup];
#pragma unroll
  for (int i = 0; i < kScanGroup; ++i) {
    sa[i] = ops[byte(0, i)];
    sb[i] = ops[byte(1, i)];
  }
#pragma unroll 1
  for (int g = 0; g < groups; g += 2) {
#pragma unroll
    for (int i = 0; i < kScanGroup; ++i) {
      step(i, sa[i]);
      sa[i] = ops[byte(2, i)];
    }
    rb -= 4 * kScanGroup;
    wv -= 4 * kScanGroup;
    wf -= 4 * kScanGroup;
    if (g + 1 == groups) break;
#pragma unroll
    for (int i = 0; i < kScanGroup; ++i) {
      step(i, sb[i]);
      sb[i] = ops[byte(2, i)];
    }
    rb -= 4 * kScanGroup;
    wv -= 4 * kScanGroup;
    wf -= 4 * kScanGroup;
  }
  return st2 >> 1;
}

__global__ void __launch_bounds__(32)
encode_scan_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ tables,
                   int16_t* __restrict__ words, uint8_t* __restrict__ flags,
                   int32_t* __restrict__ states, int c) {
  __shared__ ScanSmem sh;
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  const uint8_t* rp = chunks + row * c;
  const bool staged = c <= kScanStaged;
  if (staged && (c & 15) == 0) {
    for (int q = lane; q < c / 16; q += 32) {
      stage16(reinterpret_cast<uint8_t*>(sh.row) + 16 * q, rp, 16u * q, static_cast<uint32_t>(c));
    }
  } else if (staged) {
    for (int q = lane; q < c / 4; q += 32) sh.row[q] = reinterpret_cast<const uint32_t*>(rp)[q];
  }
  stage_commit();
  for (int k = lane; k < 256; k += 32) {
    const uint32_t lk = static_cast<uint32_t>(tables[row * 256 + k]);
    const uint32_t f = lk & (kScale - 1);
    uint4 s = f ? step_operands(f, kLogRange) : make_uint4(0u, 0u, 0u, 0u);
    s.z |= (lk >> kLogRange) << 6;
    sh.ops[k] = s;
  }
  stage_wait<0>();
  __syncwarp();
  if (lane >= 4) return;
  // lane u's step t codes byte c - 1 - 4 t - u, and stores its word and
  // flag at that position
  const int u = lane;
  const int at = c - 1 - u;
  int16_t* wv = words + row * c + at;
  uint8_t* wf = flags + row * c + at;
  const uint8_t* srow = reinterpret_cast<const uint8_t*>(sh.row);
  states[row * 4 + u] = static_cast<int32_t>(
      staged ? scan_chain<true>(sh.ops, srow + at, wv, wf, c >> 2)
             : scan_chain<false>(sh.ops, rp + at, wv, wf, c >> 2));
}

// ---------------------------------------------------------------------------
// kernel 3: payload compaction (stable partition of the flagged words)
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _compact2_kernel (:487), which the TPU
// ran as MXU prefix sums and 0/1 placement matmuls.  Bound on this card:
// bytes, 3 read and 2 written a position (20 MiB a 4 MiB block, 0.0063 ms
// at 3.35 TB/s).  The design: a CTA of 512 threads a row runs compact.cuh's
// tiled body, compact_staged, over tiles of 16,384 positions, its count
// carried from tile to tile.  A thread's loader reads its 32 flags and 32
// words once, as 2 + 4 16-byte loads issued together, and turns the flags
// into a bit mask four at a time (__vcmpne4, then one multiply gathers the
// four bits).  A width that is no multiple of 16 (rows not 16-byte
// aligned), or 0, takes compact.cuh's scalar body, compact_tile, in the
// same kernel.  Measured on an H100 80GB HBM3 at 700 W (PERF.md section
// 6): 0.0076 ms a block on the card alone, 1.2 x its DRAM bound, against
// 0.0240 for compact_tile at 1,024 threads a row.  Sharing the body with
// ans1_compact costs nothing: a copy of its own, testing the flags byte by
// byte, took 0.0077 in the same call.

constexpr int kCompactThreads = 512;

// bit i of the result: byte i of x is not 0
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const int16_t* __restrict__ words, const uint8_t* __restrict__ flags,
               int16_t* __restrict__ payload, int32_t* __restrict__ n_emit, int c) {
  __shared__ StagedSmem<kCompactThreads> sh;
  const size_t row = blockIdx.x;
  const int16_t* wv = words + row * c;
  const uint8_t* wf = flags + row * c;
  int16_t* out = payload + row * c;
  if ((c & 15) || c == 0) {
    const int total = compact_tile<kCompactThreads>(
        [&](int i) { return wf[i] != 0 ? static_cast<int>(static_cast<uint16_t>(wv[i])) : -1; },
        c, out, sh.red);
    if (threadIdx.x == 0) n_emit[row] = total;
    return;
  }
  auto load = [&](int lo) {
    Run r;
    uint4 f[2], w[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // c is a multiple of 16, so a group of 16 positions is wholly in or out
      const bool in = lo + 16 * h < c;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      f[h] = in ? __ldg(reinterpret_cast<const uint4*>(wf + lo) + h) : z;
      w[2 * h] = in ? __ldg(reinterpret_cast<const uint4*>(wv + lo) + 2 * h) : z;
      w[2 * h + 1] = in ? __ldg(reinterpret_cast<const uint4*>(wv + lo) + 2 * h + 1) : z;
    }
    const uint32_t fw[8] = {f[0].x, f[0].y, f[0].z, f[0].w, f[1].x, f[1].y, f[1].z, f[1].w};
    r.mask = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.mask |= nonzero_bytes(fw[j]) << (4 * j);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      r.w[4 * h] = w[h].x;
      r.w[4 * h + 1] = w[h].y;
      r.w[4 * h + 2] = w[h].z;
      r.w[4 * h + 3] = w[h].w;
    }
    return r;
  };
  int mine;
  const int total = compact_staged<kCompactThreads, true>(load, c, out, sh, &mine);
  if (threadIdx.x == 0) n_emit[row] = total;
}

// ---------------------------------------------------------------------------
// kernel 4: the rANS decode, slot -> symbol included
// ---------------------------------------------------------------------------
//
// Replaces kanzi_tpu/ops/ans_pallas.py _decode_kernel (:661) and the
// rank -> symbol _lookup_kernel (:47) that follows it (:864).  A warp decodes
// one chunk: its 32 lanes build the chunk's table and stage the start of its
// payload, then lanes 0-3 run the four states.  A CTA holds two chunks, one
// warp each, so a block's 256 chunks are 128 CTAs, fewer than the card's 132
// SMs.  Bound on this card: the latency of one step
// of a chunk's serial chain, 4,096 times over; the chunks of a launch run
// side by side, so only a shorter step makes a launch faster.  What the
// design does about it:
//   - A table indexed by the slot alone (32 KiB of a chunk's 35): ent[slot]
//     holds (f | sym << 24, slot - cum) as 8 bytes, so a state's update is
//     one 64-bit shared load, a mask and a multiply-add,
//     st = f (st >> 12) + (slot - cum) mod 2^32, with no second lookup
//     behind the first, and the symbol comes with it.  Slot s belongs to the
//     first symbol whose uncapped bound cum + freq (running max) exceeds s,
//     255 past the last bound; f = min(freq & 0x1FFF, 4095),
//     cum = cum & 0x1FFF: the searchsorted rule of decode_ref, which a
//     corrupt table (bounds not monotone, a sum over 4,096, f = 0) keeps
//     too.  A warp max-scan gives the bounds, then each lane walks the slots
//     lane, lane + 32, ...
//   - The payload staged ahead of the chain: a 1 KiB ring in shared memory,
//     four quarters of 256 B, filled by cp.async 16-byte copies with zero
//     fill, so a byte at or past the row's length reads as 0 and no copy
//     reads past the pitch (a multiple of 16; the wrapper pads).  When the
//     read pointer has entered quarter q, quarter q + 3 is copied into the
//     slot of quarter q - 1 and quarter q + 2's copy, issued a quarter (at
//     least 32 steps) earlier, is waited for.  The pointer is checked once
//     a block of 16 steps (at most 144 bytes read), so the 16 steps unroll
//     into one branch-free stretch.
//   - A step's refills read no memory after the ballot: the ring's 16 bytes
//     from ptr & ~7 (two 8-byte loads, issued at the end of the step before)
//     are aligned by funnel shifts to the four words a step can take, and
//     the ballot's count picks a lane's word with a select and a
//     __byte_perm that also swaps its bytes and shifts the state.  The
//     ballot orders the refills, lane 3 first (the wire).  The ballot and
//     popcount sit on the chain, yet one lane running all four states
//     without them measured no faster (PERF.md section 6), and four chunks a
//     CTA measured slower, so four lanes a chunk and two chunks a CTA stay.
//   - Each lane packs its symbols of 4 steps into a word of a 128-byte
//     buffer in shared memory; every 16 steps each lane gathers 16 of the
//     chunk's 64 new bytes with byte permutes and writes them at once.

constexpr int kDecWarps = 2;                 // chunks a CTA, one warp each
constexpr int kDecLanes = 4;                 // one per state
constexpr unsigned kDecMask = 0xFu;
constexpr uint32_t kRingBytes = 1024;        // payload ring, four quarters
constexpr uint32_t kQuarter = kRingBytes / 4;
constexpr int kDecBlock = 16;                // steps between ring checks and stores

// one chunk's shared memory (35 KiB)
struct DecodeSmem {
  uint2 ent[kScale];                         // (f | sym << 24, slot - cum) by slot
  uint32_t bnd[256];                         // running-max bounds
  uint32_t fc[256];                          // f | cum << 13
  alignas(16) uint8_t ring[kRingBytes];
  alignas(16) uint8_t obuf[128];             // decoded bytes, two blocks of 4 x 16
};

__global__ void __launch_bounds__(32 * kDecWarps)
decode_kernel(const uint8_t* __restrict__ payload, long long pitch,
              const int32_t* __restrict__ lengths, const int32_t* __restrict__ states,
              const int32_t* __restrict__ freq, const int32_t* __restrict__ cum,
              uint8_t* __restrict__ out, int32_t* __restrict__ consumed, int n) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  DecodeSmem& sh = reinterpret_cast<DecodeSmem*>(dec_smem)[threadIdx.x >> 5];
  uint2* ent = sh.ent;
  uint32_t* bnd = sh.bnd;
  uint32_t* fc = sh.fc;
  uint8_t* ring = sh.ring;
  uint8_t* obuf = sh.obuf;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kDecWarps + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(n)) return;
  const uint8_t* pay = payload + row * pitch;
  const int32_t l = lengths[row];
  const uint32_t len = l <= 0 ? 0u : static_cast<uint32_t>(min(static_cast<long long>(l), pitch));
  for (uint32_t q = lane; q < kRingBytes / 16; q += 32) {
    stage16(ring + 16 * q, pay, 16 * q, len);
  }
  stage_commit();

  // lane owns symbols 8 lane .. 8 lane + 7; bounds by a warp max-scan
  uint32_t b[8];
  uint32_t run = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 8 * lane + i;
    const uint32_t fr = static_cast<uint32_t>(freq[row * 256 + k]) & 0x1FFFu;
    const uint32_t cm = static_cast<uint32_t>(cum[row * 256 + k]) & 0x1FFFu;
    fc[k] = min(fr, kScale - 1) | (cm << 13);
    run = max(run, cm + fr);
    b[i] = run;
  }
  uint32_t incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = max(incl, v);
  }
  uint32_t excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) bnd[8 * lane + i] = max(b[i], excl);
  __syncwarp();
  int k = 0;
  for (uint32_t s = lane; s < kScale; s += 32) {
    while (k < 255 && bnd[k] <= s) ++k;
    const uint32_t e = fc[k];
    ent[s] = make_uint2((e & 0x1FFFu) | (static_cast<uint32_t>(k) << 24), s - (e >> 13));
  }
  stage_wait<0>();
  __syncwarp();
  if (lane >= kDecLanes) return;

  const int j = lane;
  const unsigned above = (0xEu << j) & kDecMask;       // lanes j+1..3
  uint32_t st = static_cast<uint32_t>(states[row * 4 + j]);
  uint8_t* dst = out + row * kChunk;
  const uint2* window = reinterpret_cast<const uint2*>(ring);   // the ring as 8-byte words
  uint32_t ptr = 0;                                     // payload bytes read
  uint32_t quarter = 0;
  uint2 q0 = window[0];                                 // the ring's 16 bytes from ptr & ~7
  uint2 q1 = window[1];
  for (int t0 = 0; t0 < kChunk / 4; t0 += kDecBlock) {
    // a block of 16 steps reads less than 16 * 8 + 16 bytes from ptr & ~7
    // on: the quarters of ptr and the next one, both landed
    if (ptr / kQuarter != quarter) {                    // the same in the chunk's lanes
      quarter = ptr / kQuarter;
      __syncwarp(kDecMask);                             // quarter - 1 is read no more
      const uint32_t base = (quarter + 3) * kQuarter;  // into the slot of quarter - 1
#pragma unroll
      for (uint32_t i = 0; i < kQuarter / 16 / kDecLanes; ++i) {
        const uint32_t pos = base + 16 * (j + kDecLanes * i);
        stage16(ring + (pos & (kRingBytes - 1)), pay, pos, len);
      }
      stage_commit();
      stage_wait<1>();                                  // quarter + 2 has landed
      __syncwarp(kDecMask);
    }
    uint8_t* ob = obuf + ((t0 / kDecBlock) & 1) * 64;
    uint32_t acc = 0;
#pragma unroll
    for (int s = 0; s < kDecBlock; ++s) {
      const uint2 e = ent[st & (kScale - 1)];
      // lo, hi: the ring's bytes ptr .. ptr + 7 (the four words a step can
      // take), from the window read at the end of the step before
      const uint32_t sh = (ptr & 2) * 8;
      const bool up = ptr & 4;
      const uint32_t lo = __funnelshift_r(up ? q0.y : q0.x, up ? q1.x : q0.y, sh);
      const uint32_t hi = __funnelshift_r(up ? q1.x : q0.y, up ? q1.y : q1.x, sh);
      st = (e.x & 0xFFFu) * (st >> kLogRange) + e.y;
      const bool need = st < kAnsTop;
      const unsigned g = __ballot_sync(kDecMask, need);
      const unsigned c = __popc(g & above);             // refills before this lane's
      // (st << 16) | the big-endian word at ptr + 2c
      const uint32_t refill = __byte_perm(st, (c & 2) ? hi : lo, (c & 1) ? 0x1067 : 0x1045);
      st = need ? refill : st;
      ptr += 2u * __popc(g);
      q0 = window[(ptr >> 3) & (kRingBytes / 8 - 1)];
      q1 = window[((ptr >> 3) + 1) & (kRingBytes / 8 - 1)];
      // lane j's symbols of 4 steps in one word: ob holds a row of 16 a lane
      acc |= (e.x >> 24) << (8 * (s & 3));
      if ((s & 3) == 3) {
        *reinterpret_cast<uint32_t*>(ob + 16 * j + (s & ~3)) = acc;
        acc = 0;
      }
    }
    __syncwarp(kDecMask);
    // output bytes 16 j .. 16 j + 15 of the block: steps 4 j .. 4 j + 3,
    // lane 3's byte first in each
    const uint32_t r3 = *reinterpret_cast<const uint32_t*>(ob + 48 + 4 * j);
    const uint32_t r2 = *reinterpret_cast<const uint32_t*>(ob + 32 + 4 * j);
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(ob + 16 + 4 * j);
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(ob + 4 * j);
    const uint32_t a_lo = __byte_perm(r3, r2, 0x5140), a_hi = __byte_perm(r3, r2, 0x7362);
    const uint32_t b_lo = __byte_perm(r1, r0, 0x5140), b_hi = __byte_perm(r1, r0, 0x7362);
    *reinterpret_cast<uint4*>(dst + 4 * t0 + 16 * j) =
        make_uint4(__byte_perm(a_lo, b_lo, 0x5410), __byte_perm(a_lo, b_lo, 0x7632),
                   __byte_perm(a_hi, b_hi, 0x5410), __byte_perm(a_hi, b_hi, 0x7632));
  }
  stage_wait<0>();
  if (j == 0) consumed[row] = static_cast<int32_t>(ptr);
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
    encode_scan_kernel<<<n, 32, 0, as_stream(stream)>>>(
        static_cast<const uint8_t*>(chunks), static_cast<const int32_t*>(tables),
        static_cast<int16_t*>(words), static_cast<uint8_t*>(flags),
        static_cast<int32_t*>(states), c);
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
    constexpr int smem = kDecWarps * sizeof(DecodeSmem);
    const cudaError_t err =
        cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_kernel<<<(n + kDecWarps - 1) / kDecWarps, 32 * kDecWarps, smem, as_stream(stream)>>>(
        static_cast<const uint8_t*>(payload), pitch, static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(states), static_cast<const int32_t*>(freq),
        static_cast<const int32_t*>(cum), static_cast<uint8_t*>(out),
        static_cast<int32_t*>(consumed), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Multi-operand bitonic row sort for Hopper (sm_90a): a span kernel and a
// cross kernel, driven by one launcher that runs a schedule of passes.
//
// Replaces kanzi_tpu/ops/ksort_pallas.py _span_kernel (:104) and
// _cross_kernel (:123), reached through ksort_rows (:220): sort each row of
// B x N int32 operands (N a power of two) by the lexicographic ascending
// (signed) order of the first nk operands.  The caller guarantees a total
// order (in practice the last key is the position iota), so the result is
// unique whatever the network, and equals the plain version's stable sorts
// (kanzi_tpu_torch/ops/ksort.py).
//
// The operands arrive stacked, nops (1..8) planes of B * N int32 each, and
// are sorted in place.  The network is the reference's: merge level
// k = 1..log2 N runs the compare-exchange stages of stride 2^j, j = k-1..0;
// element g of a row sorts descending within its 2^k block when bit k of g
// is set.  Its passes come from the caller, ops/ksort.py ksort_schedule, as
// int32 rows (kind, k, j_hi, j_lo), and the launcher runs exactly those:
//   span (kind 0, j_lo = 0): a CTA holds a span of S = 2^(j_hi+1) elements
//     in shared memory and runs merge levels 1..k when k <= j_hi + 1 (the
//     first pass: the full sort of each span), else level k's strides
//     j_hi..0.  The strides of a level run in rounds of up to R (R = 4 for
//     up to 4 planes, 3 for 5-8), aligned to multiples of R: a thread loads
//     the 2^R elements i0 + t 2^j_lo of a group into registers, runs its R
//     stages there and stores them back, one barrier a round, not a stage.
//     The first pass sorts levels 1..R on 16-byte loads in registers
//     before its first store to shared memory; a later pass whose top
//     stride is a round of its own runs it on its loads from device memory
//     (span_top_stage), else its span arrives by cp.async; the last round
//     stores to device memory.  Shared memory is swizzled (word i at
//     i ^ ((i >> 5) & 31)): a round's access is at most 2-way
//     bank-conflicted for R = 4 (4-way for R = 3).  A span of up to 100 KiB
//     runs in CTAs of 256 threads, two to an SM, one's loads and stores
//     beside the other's rounds; a larger one (the first pass's, up to
//     200 KiB) in one CTA of 512.  With two or more payload operands (nops -
//     nk >= 2) a span carries its nk keys and each element's position, and
//     permutes the payload once at the end through the positions: 3 planes
//     in place of 5 at (512, 2^16) x 5, which also fit twice the span.
//   cross (kind 1): strides j_hi..j_lo (at most M of them, 2^M nops <= 128:
//     M = 6 for up to 2 operands, 5 for 3-4, 4 for 5-8) of level k in one
//     pass over device memory.  A thread owns the 2^m elements
//     i0 + t 2^j_lo (m = j_hi - j_lo + 1) of every operand in registers, runs
//     the m stages there, fully unrolled (templated on m and nops), and
//     stores them back.  Neighbouring threads take neighbouring i0, so with
//     j_lo >= the span's log2 (>= 12) every load and store is coalesced; the
//     direction bit k lies above j_hi, one value for the group.
// At (8, 2^22) x 2 operands the schedule is 9 span passes and 11 cross
// passes (one cross pass a stride would be 36); at (512, 2^16) x 5 with 2
// keys, 3 and 2.  Bound on this card: DRAM bytes, every pass reading and
// writing every operand.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// cross CTAs of 128 threads: with 2^M nops operands in registers, three
// fit an SM, so one's loads and stores overlap another's stages
constexpr int kCrossThreads = 128;
constexpr int kSmemBudget = 200 * 1024;
// a span of at most this many bytes runs in CTAs of kPairedThreads, two to
// an SM, so one CTA's loads and stores overlap another's rounds; a larger
// one (the first pass's) in one CTA of 512 threads an SM
constexpr int kPairedSmem = 100 * 1024;
constexpr int kPairedThreads = 256;
constexpr int kMaxOps = 8;
constexpr int kSpan = 0;
constexpr int kCross = 1;

// M: the most strides a cross pass runs, 2^M * nops <= 128, M <= 6
__host__ __device__ constexpr int cross_strides(int nops) {
  return nops <= 2 ? 6 : nops <= 4 ? 5 : 4;
}
// R: the most strides a span group runs in registers
__host__ __device__ constexpr int span_strides(int nops) { return nops <= 4 ? 4 : 3; }

__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 5) & 31); }

// Orders registers t < u of every operand: ascending unless desc.  Swaps
// when v[.][u] < v[.][t] lexicographically over the first nk operands, the
// reference's rule `less ^ desc` (equal keys swap under desc, which a total
// order never meets).
template <int NOPS, int E>
__device__ __forceinline__ void exchange(int32_t (&v)[NOPS][E], int t, int u, int nk, bool desc) {
  bool less = false;
  bool eq = true;
#pragma unroll
  for (int o = 0; o < NOPS; ++o) {
    if (o < nk) {
      less = less | (eq & (v[o][u] < v[o][t]));
      eq = eq & (v[o][u] == v[o][t]);
    }
  }
  const bool swap = less != desc;
#pragma unroll
  for (int o = 0; o < NOPS; ++o) {
    const int32_t a = v[o][t];
    const int32_t b = v[o][u];
    v[o][t] = swap ? b : a;
    v[o][u] = swap ? a : b;
  }
}

// Runs the stages of strides 2^(R-1) .. 1 over t on the 2^R registers of
// each operand, one direction for the group.
template <int NOPS, int R>
__device__ __forceinline__ void exchange_group(int32_t (&v)[NOPS][1 << R], int nk, bool desc) {
#pragma unroll
  for (int s = R - 1; s >= 0; --s) {
#pragma unroll
    for (int t = 0; t < (1 << R); ++t) {
      if (!(t & (1 << s))) exchange<NOPS, 1 << R>(v, t, t | (1 << s), nk, desc);
    }
  }
}

// The span's operands: in shared memory (swizzled planes of span words) and
// in device memory (planes of `plane` words, from the span's first element).
struct Span {
  int32_t* sm;
  int32_t* g;
  long long plane;
  int span;
  long long g0;  // the span's first index in its row
};

// With IDX the span carries its keys and, as its last plane, each element's
// position in the span, in place of the payload planes nk .. nops - 1, which
// are permuted once at the end by those positions (span_write_out).

// One round of a span pass: the group of R strides j_lo + R - 1 .. j_lo of
// level k over the span in shared memory, written back there or, for the
// last round (j_lo = 0: 2^R contiguous elements), to device memory.
template <int NOPS, int T, int R, bool TO_G>
__device__ __forceinline__ void span_group(const Span& m, int nk, int jlo, int k) {
  const int groups = m.span >> R;
  const int lomask = (1 << jlo) - 1;
  for (int gi = threadIdx.x; gi < groups; gi += T) {
    const int i0 = ((gi >> jlo) << (jlo + R)) | (gi & lomask);
    int32_t v[NOPS][1 << R];
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
#pragma unroll
      for (int t = 0; t < (1 << R); ++t) v[o][t] = m.sm[o * m.span + swz(i0 + (t << jlo))];
    }
    exchange_group<NOPS, R>(v, nk, ((m.g0 + i0) >> k) & 1);
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
      if constexpr (TO_G && R >= 2) {
#pragma unroll
        for (int q = 0; q < (1 << R) / 4; ++q) {
          reinterpret_cast<int4*>(m.g + o * m.plane + i0)[q] =
              make_int4(v[o][4 * q], v[o][4 * q + 1], v[o][4 * q + 2], v[o][4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < (1 << R); ++t) {
          if (TO_G) {
            m.g[o * m.plane + i0 + t] = v[o][t];
          } else {
            m.sm[o * m.span + swz(i0 + (t << jlo))] = v[o][t];
          }
        }
      }
    }
  }
}

// Copies the span's operands into shared memory: one cp.async of 4 bytes a
// word, all in flight at once, no register held.
template <int NOPS, int T, bool IDX>
__device__ __forceinline__ void span_fetch(const Span& m) {
  if (IDX) {
    for (int i = threadIdx.x; i < m.span; i += T) m.sm[(NOPS - 1) * m.span + swz(i)] = i;
  }
#pragma unroll
  for (int o = 0; o < NOPS - IDX; ++o) {
    for (int i = threadIdx.x; i < m.span; i += T) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(m.sm + o * m.span + swz(i)));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(m.g + o * m.plane + i)
                   : "memory");
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The top stride of a later pass when it makes a group of its own (ls - 1 a
// multiple of R): the stage runs as the span comes in from device memory,
// P pairs a thread loaded at once, and the pairs go to shared memory, in
// place of a fetch and a round of one stage.
template <int NOPS, int T, bool IDX>
__device__ __forceinline__ void span_top_stage(const Span& m, int nk, int k) {
  constexpr int P = NOPS <= 2 ? 16 : NOPS <= 4 ? 8 : 4;
  const int half = m.span >> 1;
  for (int i0 = threadIdx.x; i0 < half; i0 += T * P) {
    int32_t v[P][NOPS][2];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = i0 + q * T;
      if (i < half) {
#pragma unroll
        for (int o = 0; o < NOPS - IDX; ++o) {
          v[q][o][0] = m.g[o * m.plane + i];
          v[q][o][1] = m.g[o * m.plane + i + half];
        }
        if (IDX) {
          v[q][NOPS - 1][0] = i;
          v[q][NOPS - 1][1] = i + half;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = i0 + q * T;
      if (i < half) {
        exchange<NOPS, 2>(v[q], 0, 1, nk, ((m.g0 + i) >> k) & 1);
#pragma unroll
        for (int o = 0; o < NOPS; ++o) {
          m.sm[o * m.span + swz(i)] = v[q][o][0];
          m.sm[o * m.span + swz(i + half)] = v[q][o][1];
        }
      }
    }
  }
}

// Merge levels 1..R of the full sort, on 2^R contiguous elements a thread,
// loaded from device memory 16 bytes at a time, written to shared memory
// (or straight back when the span is 2^R).  Within a group the direction of
// level kk < R is bit kk of t; of level R, bit R of the group's first index.
template <int NOPS, int T, int R, bool TO_G, bool IDX>
__device__ __forceinline__ void span_presort(const Span& m, int nk) {
  const int groups = m.span >> R;
  for (int gi = threadIdx.x; gi < groups; gi += T) {
    const int i0 = gi << R;
    int32_t v[NOPS][1 << R];
    if (IDX) {
#pragma unroll
      for (int t = 0; t < (1 << R); ++t) v[NOPS - 1][t] = i0 + t;
    }
#pragma unroll
    for (int o = 0; o < NOPS - IDX; ++o) {
#pragma unroll
      for (int q = 0; q < (1 << R) / 4; ++q) {
        const int4 x = reinterpret_cast<const int4*>(m.g + o * m.plane + i0)[q];
        v[o][4 * q] = x.x;
        v[o][4 * q + 1] = x.y;
        v[o][4 * q + 2] = x.z;
        v[o][4 * q + 3] = x.w;
      }
    }
    const bool top = ((m.g0 + i0) >> R) & 1;
#pragma unroll
    for (int kk = 1; kk <= R; ++kk) {
#pragma unroll
      for (int s = kk - 1; s >= 0; --s) {
#pragma unroll
        for (int t = 0; t < (1 << R); ++t) {
          if (!(t & (1 << s))) {
            exchange<NOPS, 1 << R>(v, t, t | (1 << s), nk, kk < R ? ((t >> kk) & 1) : top);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
#pragma unroll
      for (int q = 0; q < (1 << R) / 4; ++q) {
        if (TO_G) {
          reinterpret_cast<int4*>(m.g + o * m.plane + i0)[q] =
              make_int4(v[o][4 * q], v[o][4 * q + 1], v[o][4 * q + 2], v[o][4 * q + 3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) m.sm[o * m.span + swz(i0 + 4 * q + c)] = v[o][4 * q + c];
        }
      }
    }
  }
}

// The end of an IDX pass: the keys go from shared to device memory, then
// each payload plane is gathered through the carried positions into the
// free first plane of shared memory (all its reads before any write, the
// pass being in place) and written back.
template <int NOPS, int T>
__device__ __forceinline__ void span_write_out(const Span& m, int nk, int nops) {
  for (int o = 0; o < NOPS - 1; ++o) {
    for (int i = threadIdx.x; i < m.span; i += T) m.g[o * m.plane + i] = m.sm[o * m.span + swz(i)];
  }
  __syncthreads();
  for (int o = nk; o < nops; ++o) {
    for (int i = threadIdx.x; i < m.span; i += T) {
      m.sm[i] = m.g[o * m.plane + m.sm[(NOPS - 1) * m.span + swz(i)]];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m.span; i += T) m.g[o * m.plane + i] = m.sm[i];
    __syncthreads();
  }
}

// Runs merge levels kfirst..klast of the span's strides (below min(k, ls))
// in rounds of up to R strides, aligned to multiples of R, largest first,
// each but the last from and to shared memory with one barrier, the last
// to device memory.  The span arrives by span_fetch, or for the full sort
// through the register presort of levels 1..R.
// NK, the key count, is a constant of the kernel: nops or nops - 1, or
// with IDX the planes but the positions.
template <int NOPS, int T, bool IDX, int NK>
__global__ void __launch_bounds__(T, T == kPairedThreads ? 2 : 1)
span_kernel(int32_t* __restrict__ data, long long plane, int nops, int ln, int ls, int kfirst,
            int klast) {
  constexpr int R = span_strides(NOPS);
  constexpr int nk = NK;
  extern __shared__ int32_t sm[];
  const long long g0 = (static_cast<long long>(blockIdx.x) & ((1LL << (ln - ls)) - 1)) << ls;
  const long long base = (static_cast<long long>(blockIdx.x) >> (ln - ls) << ln) + g0;
  const Span m{sm, data + base, plane, 1 << ls, g0};
  int k = kfirst;
  int hi = min(k, ls) - 1;                    // the next round's top stride
  if (kfirst == 1 && ls >= R) {
    if (ls == R && !IDX) {
      span_presort<NOPS, T, R, true, IDX>(m, nk);
      return;
    }
    span_presort<NOPS, T, R, false, IDX>(m, nk);
    k = R + 1;
    hi = min(k, ls) - 1;
  } else if (kfirst > ls && ls > 1 && (ls - 1) % R == 0) {
    span_top_stage<NOPS, T, IDX>(m, nk, k);
    hi = ls - 2;
  } else {
    span_fetch<NOPS, T, IDX>(m);
  }
  __syncthreads();
  for (; k <= klast;) {
    const int lo = hi / R * R;
    const bool last = k == klast && lo == 0;
    const bool to_g = last && !IDX;
    switch (hi - lo + 1) {
      case 1:
        to_g ? span_group<NOPS, T, 1, true>(m, nk, lo, k) : span_group<NOPS, T, 1, false>(m, nk, lo, k);
        break;
      case 2:
        to_g ? span_group<NOPS, T, 2, true>(m, nk, lo, k) : span_group<NOPS, T, 2, false>(m, nk, lo, k);
        break;
      case 3:
        to_g ? span_group<NOPS, T, 3, true>(m, nk, lo, k) : span_group<NOPS, T, 3, false>(m, nk, lo, k);
        break;
      default:
        if constexpr (R >= 4) {
          to_g ? span_group<NOPS, T, 4, true>(m, nk, lo, k)
               : span_group<NOPS, T, 4, false>(m, nk, lo, k);
        }
        break;
    }
    if (to_g) return;
    __syncthreads();
    if (last) break;
    if (lo == 0) {
      ++k;
      hi = min(k, ls) - 1;
    } else {
      hi = lo - 1;
    }
  }
  if (IDX) span_write_out<NOPS, T>(m, nk, nops);
}

template <int NOPS, int M>
__global__ void __launch_bounds__(kCrossThreads)
cross_kernel(int32_t* __restrict__ data, long long plane, int nk, int n, int k, int jlo) {
  const long long groups = plane >> M;
  const long long lomask = (1LL << jlo) - 1;
  const long long step = static_cast<long long>(gridDim.x) * kCrossThreads;
  for (long long gi = static_cast<long long>(blockIdx.x) * kCrossThreads + threadIdx.x;
       gi < groups; gi += step) {
    const long long i0 = ((gi >> jlo) << (jlo + M)) | (gi & lomask);
    int32_t v[NOPS][1 << M];
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
#pragma unroll
      for (int t = 0; t < (1 << M); ++t) v[o][t] = data[o * plane + i0 + (static_cast<long long>(t) << jlo)];
    }
    exchange_group<NOPS, M>(v, nk, ((i0 & (n - 1)) >> k) & 1);
    // the stores recompute their addresses: kept from the loads, 2^M nops
    // 64-bit addresses would spill beside the operands
    long long j0 = i0;
    asm volatile("" : "+l"(j0));
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
#pragma unroll
      for (int t = 0; t < (1 << M); ++t) data[o * plane + j0 + (static_cast<long long>(t) << jlo)] = v[o][t];
    }
  }
}

struct Pass {
  int32_t* d;
  long long plane;
  int nk, nops, n, ln;
  cudaStream_t s;
};

// Whether span passes carry positions in place of the payload: for two or
// more payload operands, so fewer planes go through every round.
bool carries_index(int nops, int nk) { return nops - nk >= 2; }

int span_planes(int nops, int nk) { return carries_index(nops, nk) ? nk + 1 : nops; }

template <int NOPS, int M>
cudaError_t run_cross(const Pass& p, int k, int jlo) {
  if constexpr (M > cross_strides(NOPS)) {
    return cudaErrorInvalidValue;
  } else {
    const long long groups = p.plane >> M;
    const int grid = static_cast<int>(
        std::min<long long>((groups + kCrossThreads - 1) / kCrossThreads, 1LL << 20));
    cross_kernel<NOPS, M><<<grid, kCrossThreads, 0, p.s>>>(p.d, p.plane, p.nk, p.n, k, jlo);
    return cudaSuccess;
  }
}

template <int C, int T, bool IDX, int NK>
cudaError_t launch_span(const Pass& p, int ls, int kfirst, int klast) {
  const int smem = C * 4 << ls;
  cudaError_t err = cudaFuncSetAttribute(span_kernel<C, T, IDX, NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(p.plane >> ls);
  span_kernel<C, T, IDX, NK><<<grid, T, smem, p.s>>>(p.d, p.plane, p.nops, p.ln, ls, kfirst,
                                                     klast);
  return cudaSuccess;
}

// C planes in shared memory: the nops operands, or with IDX the nk keys and
// the positions; NK keys among them
template <int C, bool IDX, int NK = IDX ? C - 1 : C>
cudaError_t run_span(const Pass& p, int ls, int kfirst, int klast) {
  if constexpr (!IDX && NK == C && C > 1) {
    if (p.nk == C - 1) return run_span<C, false, C - 1>(p, ls, kfirst, klast);
  }
  return (C * 4 << ls) <= kPairedSmem ? launch_span<C, kPairedThreads, IDX, NK>(p, ls, kfirst, klast)
                                      : launch_span<C, 512, IDX, NK>(p, ls, kfirst, klast);
}

cudaError_t run_span_any(const Pass& p, int ls, int kfirst, int klast) {
  if (carries_index(p.nops, p.nk)) {
    switch (p.nk) {
      case 1: return run_span<2, true>(p, ls, kfirst, klast);
      case 2: return run_span<3, true>(p, ls, kfirst, klast);
      case 3: return run_span<4, true>(p, ls, kfirst, klast);
      case 4: return run_span<5, true>(p, ls, kfirst, klast);
      case 5: return run_span<6, true>(p, ls, kfirst, klast);
      case 6: return run_span<7, true>(p, ls, kfirst, klast);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (p.nops) {
    case 1: return run_span<1, false>(p, ls, kfirst, klast);
    case 2: return run_span<2, false>(p, ls, kfirst, klast);
    case 3: return run_span<3, false>(p, ls, kfirst, klast);
    case 4: return run_span<4, false>(p, ls, kfirst, klast);
    case 5: return run_span<5, false>(p, ls, kfirst, klast);
    case 6: return run_span<6, false>(p, ls, kfirst, klast);
    case 7: return run_span<7, false>(p, ls, kfirst, klast);
    case 8: return run_span<8, false>(p, ls, kfirst, klast);
    default: return cudaErrorInvalidValue;
  }
}

template <int NOPS>
cudaError_t run_row(const Pass& p, const int32_t* r) {
  const int kind = r[0], k = r[1], hi = r[2], lo = r[3];
  if (kind == kSpan) {
    const int ls = hi + 1;
    return k <= ls ? run_span_any(p, ls, 1, k) : run_span_any(p, ls, k, k);
  }
  switch (hi - lo + 1) {
    case 1: return run_cross<NOPS, 1>(p, k, lo);
    case 2: return run_cross<NOPS, 2>(p, k, lo);
    case 3: return run_cross<NOPS, 3>(p, k, lo);
    case 4: return run_cross<NOPS, 4>(p, k, lo);
    case 5: return run_cross<NOPS, 5>(p, k, lo);
    case 6: return run_cross<NOPS, 6>(p, k, lo);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run_row_any(int nops, const Pass& p, const int32_t* r) {
  switch (nops) {
    case 1: return run_row<1>(p, r);
    case 2: return run_row<2>(p, r);
    case 3: return run_row<3>(p, r);
    case 4: return run_row<4>(p, r);
    case 5: return run_row<5>(p, r);
    case 6: return run_row<6>(p, r);
    case 7: return run_row<7>(p, r);
    case 8: return run_row<8>(p, r);
    default: return cudaErrorInvalidValue;
  }
}

// Whether the launcher can run schedule row r: a span that fits the budget
// and the row, or a cross pass of at most M strides below its level.
bool row_ok(const int32_t* r, int nops, int nk, int ln) {
  const int kind = r[0], k = r[1], hi = r[2], lo = r[3];
  if (k < 1 || k > ln || hi < lo || lo < 0) return false;
  if (kind == kSpan) {
    return lo == 0 && hi + 1 <= ln &&
           (static_cast<long long>(span_planes(nops, nk)) * 4 << (hi + 1)) <= kSmemBudget;
  }
  return kind == kCross && hi < k && hi - lo + 1 <= cross_strides(nops);
}

}  // namespace

extern "C" {

// data: nops planes of b * n int32, sorted in place; n a power of two.
// sched: rows host int32 rows (kind, k, j_hi, j_lo), run in order.  Returns
// cudaErrorInvalidValue, and launches nothing, if any row cannot run.
int kz_ksort(void* data, int nops, int nk, int b, int n, const void* sched, int rows,
             void* stream) {
  if (b <= 0 || n <= 1 || nops <= 0) return static_cast<int>(cudaGetLastError());
  if (nops > kMaxOps || nk < 1 || nk > nops || (n & (n - 1)) || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int ln = 0;
  while ((1 << ln) < n) ++ln;
  const int32_t* sc = static_cast<const int32_t*>(sched);
  for (int i = 0; i < rows; ++i) {
    if (!row_ok(sc + 4 * i, nops, nk, ln)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pass p{static_cast<int32_t*>(data), static_cast<long long>(b) * n, nk, nops, n, ln,
               reinterpret_cast<cudaStream_t>(stream)};
  for (int i = 0; i < rows; ++i) {
    const cudaError_t err = run_row_any(nops, p, sc + 4 * i);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Multi-operand bitonic row sort for Hopper (sm_90a): a span kernel and a
// cross kernel, driven by one launcher.
//
// Replaces kanzi_tpu/ops/ksort_pallas.py _span_kernel (:104) and
// _cross_kernel (:123), reached through ksort_rows (:220): sort each row of
// B x N int32 operands (N a power of two) by the lexicographic ascending
// (signed) order of the first nk operands.  The caller guarantees a total
// order (in practice the last key is the position iota), so the result is
// unique whatever the network, and equals the plain version's stable sorts
// (kanzi_tpu_torch/ops/ksort.py).
//
// The operands arrive stacked, nops planes of B * N int32 each, and are
// sorted in place.  The network is the reference's: merge level k = 1..log2 N
// runs the compare-exchange stages of stride 2^j, j = k-1..0; element g of a
// row sorts descending within its 2^k block when bit k of g is set.
//   span kernel: one CTA of 1024 threads loads a span of S = 2^ls elements of
//     every operand into shared memory (dynamic, at most kSmemBudget bytes,
//     so S follows from nops: 16 Ki elements for 2 or 3 operands, 8 Ki for
//     4-6) and runs every stage of stride < S there, a barrier between
//     stages: first merge levels 1..ls (the full sort of each span), then,
//     after each higher level's large strides, that level's strides < S;
//   cross kernel: one stage of stride >= S in global memory, one thread per
//     compare-exchange pair, neighbouring threads on neighbouring pairs.
// In place of the TPU's VMEM-resident strided slices and rolls, one launch
// per large stride.  Bound on this card: DRAM bytes, each pass reading and
// writing every operand (1 + 2 * (log2 N - ls) span passes and
// (log2 N - ls)(log2 N - ls + 1) / 2 cross passes).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSortThreads = 1024;
constexpr int kSmemBudget = 200 * 1024;

// Orders elements i < j of one row (operand o of element x at d[o * ps + x]):
// ascending unless desc.  Swaps when d[j] < d[i] lexicographically over the
// first nk operands, the reference's rule `less ^ desc` (equal keys swap
// under desc, which a total order never meets).
__device__ __forceinline__ void compare_exchange(int32_t* d, long long ps, int nops, int nk,
                                                 long long i, long long j, bool desc) {
  bool less = false;
  for (int o = 0; o < nk; ++o) {
    const int32_t a = d[o * ps + i];
    const int32_t b = d[o * ps + j];
    if (a != b) {
      less = b < a;
      break;
    }
  }
  if (less != desc) {
    for (int o = 0; o < nops; ++o) {
      const int32_t a = d[o * ps + i];
      d[o * ps + i] = d[o * ps + j];
      d[o * ps + j] = a;
    }
  }
}

__global__ void __launch_bounds__(kSortThreads)
span_kernel(int32_t* __restrict__ data, long long plane, int nops, int nk, int n, int ls,
            int kmin, int kmax) {
  extern __shared__ int32_t sm[];
  const int span = 1 << ls;
  const long long spans = n >> ls;                      // spans per row
  const long long row = blockIdx.x / spans;
  const long long g0 = (blockIdx.x - row * spans) << ls;  // the span's first index in its row
  const long long base = row * n + g0;
  for (int o = 0; o < nops; ++o) {
    for (int i = threadIdx.x; i < span; i += kSortThreads) sm[o * span + i] = data[o * plane + base + i];
  }
  __syncthreads();
  for (int k = kmin; k <= kmax; ++k) {
    for (int j = min(k, ls) - 1; j >= 0; --j) {
      for (int p = threadIdx.x; p < span / 2; p += kSortThreads) {
        const int i = ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
        compare_exchange(sm, span, nops, nk, i, i | (1 << j), ((g0 + i) >> k) & 1);
      }
      __syncthreads();
    }
  }
  for (int o = 0; o < nops; ++o) {
    for (int i = threadIdx.x; i < span; i += kSortThreads) data[o * plane + base + i] = sm[o * span + i];
  }
}

__global__ void __launch_bounds__(kSortThreads)
cross_kernel(int32_t* __restrict__ data, long long plane, int nops, int nk, int n, int j, int k,
             long long pairs) {
  const long long half = n >> 1;
  const long long step = static_cast<long long>(gridDim.x) * kSortThreads;
  for (long long p = static_cast<long long>(blockIdx.x) * kSortThreads + threadIdx.x; p < pairs;
       p += step) {
    const long long row = p / half;
    const long long q = p - row * half;
    const long long i = ((q >> j) << (j + 1)) | (q & ((1LL << j) - 1));
    compare_exchange(data + row * n, plane, nops, nk, i, i + (1LL << j), (i >> k) & 1);
  }
}

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// data: nops planes of b * n int32, sorted in place; n a power of two.
int kz_ksort(void* data, int nops, int nk, int b, int n, void* stream) {
  if (b <= 0 || n <= 1 || nops <= 0) return static_cast<int>(cudaGetLastError());
  int ln = 0;
  while ((1 << ln) < n) ++ln;
  int ls = 0;  // the largest span whose nops planes fit the budget, at most n
  while (ls < ln && (static_cast<long long>(nops) * 4 << (ls + 1)) <= kSmemBudget) ++ls;
  const int smem = nops * 4 << ls;
  cudaError_t err = cudaFuncSetAttribute(span_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int32_t* d = static_cast<int32_t*>(data);
  const long long plane = static_cast<long long>(b) * n;
  const int span_grid = b * (n >> ls);
  const long long pairs = plane / 2;
  const int cross_grid = static_cast<int>(std::min<long long>((pairs + kSortThreads - 1) / kSortThreads,
                                                              1LL << 20));
  cudaStream_t s = as_stream(stream);
  span_kernel<<<span_grid, kSortThreads, smem, s>>>(d, plane, nops, nk, n, ls, 1, ls);
  for (int k = ls + 1; k <= ln; ++k) {
    for (int j = k - 1; j >= ls; --j) {
      cross_kernel<<<cross_grid, kSortThreads, 0, s>>>(d, plane, nops, nk, n, j, k, pairs);
    }
    span_kernel<<<span_grid, kSortThreads, smem, s>>>(d, plane, nops, nk, n, ls, k, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

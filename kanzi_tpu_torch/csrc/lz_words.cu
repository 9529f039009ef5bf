// LZX content words for Hopper (sm_90a): one kernel.
//
// Replaces kanzi_tpu/ops/lz_sort.py _words_kernel (:107, pallas_call :155),
// the word builder of the LZX sort engine (ops/lz_sort.py).  For each row of
// n bytes (rows independent) and each position p it writes four big-endian
// 32-bit words, w_j[p] = bytes p+4j .. p+4j+3, j = 0..3.  Bytes past the
// row's end follow the TPU kernel's clamped halo: byte(q) = buf[q] for
// q < n, else buf[q - 1024] (its last tile reads the row's last 1 KiB as
// halo).  Bit-exact with lz_words_ref in kanzi_tpu_torch/ops/lz_words_cuda.py.
//
// Bound on this card: bytes.  A row of n bytes is read once and 16 n bytes
// of words are written (a 4 MiB row: 4 MiB in, 64 MiB out).  Design: one
// CTA of 256 threads per 4,096-byte tile; the tile and a 16-byte halo are
// staged in shared memory with 16-byte loads; each thread builds the words
// of four consecutive positions from five 32-bit shared-memory reads with
// __byte_perm and writes each w_j as one 16-byte store, so a warp writes
// 512 contiguous bytes per store.
//
// The launcher is a plain C function over raw device pointers and the CUDA
// stream; it launches on that stream, does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;            // positions per CTA
constexpr int kHalo = 16;              // bytes past the tile a word can reach
constexpr int kTailBack = 1024;        // byte(q >= n) = buf[q - 1024]
constexpr int kRowAlign = 65536;       // n % 65536 == 0 (every bucket, ROW)

__global__ void __launch_bounds__(kThreads)
lz_words_kernel(const uint8_t* __restrict__ bufs, int32_t* __restrict__ w0,
                int32_t* __restrict__ w1, int32_t* __restrict__ w2,
                int32_t* __restrict__ w3, int n) {
  __shared__ __align__(16) uint8_t tile[kTile + kHalo];
  const size_t row = blockIdx.y;
  const int start = blockIdx.x * kTile;
  const uint8_t* src = bufs + row * static_cast<size_t>(n);
  const int t = threadIdx.x;

  reinterpret_cast<uint4*>(tile)[t] =
      reinterpret_cast<const uint4*>(src + start)[t];
  if (t == 0) {
    // the halo: the next 16 bytes of the row, or past its end the bytes
    // 1,024 before them (n is a multiple of kTile, so a tile never straddles)
    const int h = start + kTile;
    const int from = h < n ? h : n - kTailBack;
    reinterpret_cast<uint4*>(tile)[kTile / 16] =
        *reinterpret_cast<const uint4*>(src + from);
  }
  __syncthreads();

  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(tile);
  int32_t* outs[4] = {w0, w1, w2, w3};
#pragma unroll
  for (int k = 0; k < kTile / (4 * kThreads); ++k) {
    const int base = 4 * (t + kThreads * k);      // 4 consecutive positions
    uint32_t x[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) x[i] = s32[base / 4 + i];
    const size_t o = row * static_cast<size_t>(n) + start + base;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // position base+i, word j: bytes 4j+i .. 4j+i+3 of x, big-endian
      int4 w;
      w.x = static_cast<int32_t>(__byte_perm(x[j], x[j + 1], 0x0123));
      w.y = static_cast<int32_t>(__byte_perm(x[j], x[j + 1], 0x1234));
      w.z = static_cast<int32_t>(__byte_perm(x[j], x[j + 1], 0x2345));
      w.w = static_cast<int32_t>(__byte_perm(x[j], x[j + 1], 0x3456));
      *reinterpret_cast<int4*>(outs[j] + o) = w;
    }
  }
}

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

int kz_lz_words(const void* bufs, void* w0, void* w1, void* w2, void* w3,
                int nb, int n, void* stream) {
  if (n <= 0 || n % kRowAlign != 0 || nb < 0 || nb > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb > 0) {
    const dim3 grid(n / kTile, nb);
    lz_words_kernel<<<grid, kThreads, 0, as_stream(stream)>>>(
        static_cast<const uint8_t*>(bufs), static_cast<int32_t*>(w0),
        static_cast<int32_t*>(w1), static_cast<int32_t*>(w2),
        static_cast<int32_t*>(w3), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

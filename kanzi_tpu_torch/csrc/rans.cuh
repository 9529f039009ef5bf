// The rANS encode step with a reciprocal in place of the divide, shared by
// ans0.cu (encode_scan, logRange 12) and ans1.cu (scan, logRange 11).
//
// For 1 <= f < 2^31, l = ceil(log2 f) and m = ceil(2^(31 + l) / f), which
// lies in [2^31, 2^32): umulhi(2x, m) >> l == x / f for every x < 2^31.
// (m = (2^(31+l) + d) / f with 0 <= d < f, so 2x m / 2^(32+l) exceeds x / f
// by less than x / 2^(31+l) < 1 / f, too little to reach the next integer.)
// This is the Granlund-Montgomery form of F. Giesen's rans_byte.h with the
// dividend doubled instead of the shift cut by one, so f = 1 (m = 2^31,
// l = 0) needs no case of its own.  ans1_cuda.py recip_table is its plain
// version, and ans1.cu recip_check_kernel tests it for every f < 2^lr and
// every x < 2^31.
//
// The chain carries the doubled state st2 = 2 st (st < 2^31), the
// reciprocal's dividend as it is.  Then h = umulhi(st2, m) gives st / f as
// h >> l and, when the step emits and the state to divide is st >> 16,
// (st >> 16) / f as h >> (l + 16) (floor(floor(a / b) / c) ==
// floor(a / (b c))): the renormalisation picks a shift, off the chain,
// instead of feeding the divide.  With x the renormalised state and
// q = x / f, (q << lr) + (x - q f) + cm == x + cm + q (2^lr - f), doubled.
// On the chain: umulhi, shift, multiply-add.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Recip {
  uint32_t m, l;
};

__device__ inline Recip recip(uint32_t f) {
  const uint32_t l = 32 - __clz(static_cast<int>(f - 1));   // ceil(log2 f); __clz(0) = 32
  return {static_cast<uint32_t>(((1ull << (31 + l)) + f - 1) / f), l};
}

// The operands of a symbol with frequency f, less its cm: {2 f << (31 - lr)
// (the doubled renormalisation threshold), m, l, 2 (2^lr - f)}.
__device__ inline uint4 step_operands(uint32_t f, int lr) {
  const Recip r = recip(f);
  return make_uint4(f << (32 - lr), r.m, r.l, ((1u << lr) - f) << 1);
}

// One step of a lane's chain on the doubled state st2, the operands of its
// symbol in s with 2 cm packed above l (s.z = l | 2 cm << 5; the funnel
// shift reads the low 5 bits).  Returns the next doubled state; *em says
// whether the step emitted, and then the emitted word is st2 >> 1, cut to
// 16 bits.
__device__ __forceinline__ uint32_t ans_step_em(uint32_t st2, uint4 s, bool* em) {
  const bool e = st2 >= s.x;
  *em = e;
  const uint32_t q = __funnelshift_r(__umulhi(st2, s.y), 0u, e ? s.z + 16 : s.z);
  const uint32_t x2 = e ? (st2 >> 17) << 1 : st2;
  return q * s.w + (x2 + (s.z >> 5));   // the sum off the chain, then one multiply-add
}

// The same step with the emitted word as flag << 16 | val (0 where nothing
// was emitted) in *word.
__device__ __forceinline__ uint32_t ans_step(uint32_t st2, uint4 s, uint32_t* word) {
  bool em;
  const uint32_t next = ans_step_em(st2, s, &em);
  *word = em ? (0x10000u | ((st2 >> 1) & 0xFFFFu)) : 0u;
  return next;
}

}  // namespace

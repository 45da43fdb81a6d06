// Modular arithmetic on u64 words for primes q < 2^61 (the reference's
// MOD_BIT_COUNT_MAX), the device half of ops/modmath.py.
//
// The TPU has no 64-bit multiplier and the JAX package builds every wide
// product from 32-bit halves; Hopper's IMAD.WIDE and __umul64hi give the
// 128-bit product of two words directly (four 32x32 IMADs each half, as
// the SASS shows).  The Barrett words are floor(2^128 / q) split in two,
// the Shoup words floor(w 2^64 / q).  4q < 2^63, so Harvey's lazy values
// never wrap.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ptk64 {

__device__ __forceinline__ uint64_t csub(uint64_t x, uint64_t q) {
  return x >= q ? x - q : x;
}

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b,
                                            uint64_t q) {
  return csub(a + b, q);
}

// a, b in [0, q)
__device__ __forceinline__ uint64_t sub_mod(uint64_t a, uint64_t b,
                                            uint64_t q) {
  return csub(a + q - b, q);
}

// (hi, lo) += (h, l) mod 2^128
__device__ __forceinline__ void add128(uint64_t& hi, uint64_t& lo,
                                       uint64_t h, uint64_t l) {
  lo += l;
  hi += h + (lo < l ? 1 : 0);
}

// x mod q for any 64-bit x; rhi = floor(2^128 / q) >> 64
__device__ __forceinline__ uint64_t barrett64(uint64_t x, uint64_t q,
                                              uint64_t rhi) {
  return csub(x - __umul64hi(x, rhi) * q, q);
}

// floor(x ratio / 2^128) less at most one (mod 2^64), x = hi 2^64 + lo
__device__ __forceinline__ uint64_t barrett_quotient(uint64_t hi, uint64_t lo,
                                                     uint64_t rlo,
                                                     uint64_t rhi) {
  const uint64_t c = __umul64hi(lo, rlo);
  const uint64_t ha = __umul64hi(lo, rhi), la = lo * rhi;
  const uint64_t hb = __umul64hi(hi, rlo), lb = hi * rlo;
  const uint64_t s1 = la + c;
  const uint64_t s2 = s1 + lb;
  return hi * rhi + ha + hb + (s1 < la ? 1 : 0) + (s2 < s1 ? 1 : 0);
}

// (hi 2^64 + lo) mod q for x < q 2^64
__device__ __forceinline__ uint64_t barrett128(uint64_t hi, uint64_t lo,
                                               uint64_t q, uint64_t rlo,
                                               uint64_t rhi) {
  return csub(lo - barrett_quotient(hi, lo, rlo, rhi) * q, q);
}

// exact floor(x / q) (mod 2^64) and x mod q, for x < q 2^64
__device__ __forceinline__ uint64_t div_mod128(uint64_t hi, uint64_t lo,
                                               uint64_t q, uint64_t rlo,
                                               uint64_t rhi, uint64_t& rem) {
  const uint64_t k = barrett_quotient(hi, lo, rlo, rhi);
  const uint64_t r = lo - k * q;
  const uint64_t fix = r >= q ? 1 : 0;
  rem = r - fix * q;
  return k + fix;
}

// a b mod q, a, b < 2^63
__device__ __forceinline__ uint64_t mul_mod(uint64_t a, uint64_t b,
                                            uint64_t q, uint64_t rlo,
                                            uint64_t rhi) {
  return barrett128(__umul64hi(a, b), a * b, q, rlo, rhi);
}

// x w mod q in [0, 2q) for any 64-bit x; ws = floor(w 2^64 / q)
__device__ __forceinline__ uint64_t shoup_lazy(uint64_t x, uint64_t w,
                                               uint64_t ws, uint64_t q) {
  return x * w - __umul64hi(x, ws) * q;
}

__device__ __forceinline__ uint64_t shoup(uint64_t x, uint64_t w,
                                          uint64_t ws, uint64_t q) {
  return csub(shoup_lazy(x, w, ws, q), q);
}

// (hi 2^64 + lo) mod p for any 128-bit x: the high word reduces first, so
// any p < 2^61 serves (the small t of BGV's conversion to {t} included)
__device__ __forceinline__ uint64_t reduce128_any(uint64_t hi, uint64_t lo,
                                                  uint64_t p, uint64_t rlo,
                                                  uint64_t rhi,
                                                  uint64_t pow64) {
  const uint64_t h = mul_mod(barrett64(hi, p, rhi), pow64, p, rlo, rhi);
  return add_mod(h, barrett64(lo, p, rhi), p);
}

}  // namespace ptk64

// Modular arithmetic on u32 residues for primes q < 2^30.
//
// Hopper multiplies 32x32->64 natively, so the TPU's u16 half-word
// products and int8 digit planes have no counterpart here: a modular
// product is one 64-bit multiply and a Barrett or Shoup reduction.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ptk {

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t q) {
  return x >= q ? x - q : x;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return csub(a + b, q);
}

// a, b in [0, q)
__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return csub(a + q - b, q);
}

// x * w mod q in [0, q) for any 32-bit x; w < q, ws = floor(w * 2^32 / q).
__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w,
                                              uint32_t ws, uint32_t q) {
  const uint32_t k = __umulhi(x, ws);
  return csub(x * w - k * q, q);  // x*w - k*q lies in [0, 2q)
}

// Barrett constant floor((2^64 - 1) / q); for odd q it equals floor(2^64/q).
struct Barrett {
  uint32_t q;
  uint64_t ratio;
};

__device__ __forceinline__ Barrett make_barrett(uint32_t q) {
  Barrett b;
  b.q = q;
  b.ratio = ~0ull / q;
  return b;
}

// x mod q for any 64-bit x: the quotient estimate is at most 2 short.
__device__ __forceinline__ uint32_t reduce64(uint64_t x, const Barrett& b) {
  const uint64_t k = __umul64hi(x, b.ratio);
  uint64_t r = x - k * b.q;
  r = r >= b.q ? r - b.q : r;
  r = r >= b.q ? r - b.q : r;
  return static_cast<uint32_t>(r);
}

// exact (floor(x / q), x mod q) for any 64-bit x
__device__ __forceinline__ uint64_t divmod64(uint64_t x, const Barrett& b,
                                             uint32_t& rem) {
  uint64_t k = __umul64hi(x, b.ratio);
  uint64_t r = x - k * b.q;
  if (r >= b.q) { r -= b.q; ++k; }
  if (r >= b.q) { r -= b.q; ++k; }
  rem = static_cast<uint32_t>(r);
  return k;
}

__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t c,
                                            const Barrett& b) {
  return reduce64(static_cast<uint64_t>(a) * c, b);
}

// (hi * 2^64 + lo) mod q
__device__ __forceinline__ uint32_t reduce128(uint64_t hi, uint64_t lo,
                                              const Barrett& b) {
  const uint32_t pow64 = csub(reduce64(~0ull, b) + 1u, b.q);  // 2^64 mod q
  return add_mod(mul_mod(reduce64(hi, b), pow64, b), reduce64(lo, b), b.q);
}

// lo + hi 2^64 += t k: a 64-bit low word and a carry count, exact for up
// to 2^32 products below 2^64; reduce128(hi, lo) reduces the sum once.
__device__ __forceinline__ void mac(uint64_t& lo, uint32_t& hi, uint32_t t,
                                    uint32_t k) {
  const uint64_t p = static_cast<uint64_t>(t) * k;
  lo += p;
  hi += lo < p;
}

// sum_i a[i * stride] * m[i] over k terms, exact in 128 bits (each product
// is below 2^60, so 2^64 sums cannot overflow the high word), mod q.
__device__ __forceinline__ uint32_t dot_mod(const uint32_t* a,
                                            int64_t stride,
                                            const uint32_t* m, int k,
                                            const Barrett& b) {
  uint64_t lo = 0, hi = 0;
  for (int i = 0; i < k; ++i) {
    const uint64_t p = static_cast<uint64_t>(a[i * stride]) * m[i];
    lo += p;
    hi += lo < p;
  }
  return reduce128(hi, lo, b);
}

}  // namespace ptk

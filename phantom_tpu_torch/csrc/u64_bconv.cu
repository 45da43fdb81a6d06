// U2: fast RNS base conversion over u64 primes.
//
// Replaces the JAX package's u64 base conversion, phantom_tpu/ops/
// bconv.py:153 bconv_approx and :171 bconv_exact (with :86
// accumulate_matmul_128, :108 reduce_u128_any and :122 the floor sum),
// which run as XLA fusions (a scan over the input limbs, no pallas_call):
//
//   y_i   = [x_i (Q/q_i)^-1]_{q_i}          (the "reduce" form takes y)
//   raw_j = [sum_i y_i [Q/q_i]_{p_j}]_{p_j}  over an exact 128-bit sum
//   out_j = [raw_j - v [Q]_{p_j}]_{p_j}      ("exact" only)
//
// v = floor(sum_i y_i / q_i) by the JAX package's 2^-128 fixed-point
// cascade, operation for operation: with 2^64 = U_i q_i + V_i,
// y 2^64 = (y U + q1) q + r1 and r1 2^64 = s2 q + r2, each quotient exact;
// S1 = sum (y U + q1) and S2 = sum s2 over 128 bits; v = S1_hi +
// carry(S1_lo + S2_hi).  Its truncation (< k_in 2^-128) is the JAX
// package's, so v flips where the JAX package's does.
//
// Launch A, one thread a column, writes y and v to a (k_in + 1, M)
// scratch; launch B, one thread a word of an output row, sums the k_in
// products of its column and reduces once.  k_in <= 63 keeps the sum of
// products below 2^61 x 2^61 x 63 < 2^128.

#include "modarith64.cuh"

namespace ptk64 {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bconv_prep_kernel(uint64_t* y, const uint64_t* x, const uint64_t* q,
                  const uint64_t* rlo, const uint64_t* rhi,
                  const uint64_t* qhat_inv, const uint64_t* qhat_inv_shoup,
                  const uint64_t* U, const uint64_t* V, int k_in, int64_t m,
                  int form) {
  for (int64_t c = blockIdx.x * int64_t{blockDim.x} + threadIdx.x; c < m;
       c += int64_t{gridDim.x} * blockDim.x) {
    uint64_t s1_hi = 0, s1_lo = 0, s2_hi = 0, s2_lo = 0;
    for (int i = 0; i < k_in; ++i) {
      uint64_t v = x[i * m + c];
      if (form != 1) v = shoup(v, qhat_inv[i], qhat_inv_shoup[i], q[i]);
      y[i * m + c] = v;
      if (form == 2) {
        uint64_t r1, rem;
        const uint64_t q1 = div_mod128(__umul64hi(v, V[i]), v * V[i], q[i],
                                       rlo[i], rhi[i], r1);
        const uint64_t s2 = div_mod128(r1, 0, q[i], rlo[i], rhi[i], rem);
        add128(s1_hi, s1_lo, 0, v * U[i]);
        add128(s1_hi, s1_lo, 0, q1);
        add128(s2_hi, s2_lo, 0, s2);
      }
    }
    if (form == 2) {
      const uint64_t lo = s1_lo + s2_hi;
      y[k_in * m + c] = s1_hi + (lo < s1_lo ? 1 : 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bconv_sum_kernel(uint64_t* out, const uint64_t* y, const uint64_t* mat,
                 const uint64_t* p, const uint64_t* prlo,
                 const uint64_t* prhi, const uint64_t* pow64,
                 const uint64_t* q_mod_p, int k_in, int64_t m, int form) {
  const int j = blockIdx.y;
  const uint64_t pj = p[j], rl = prlo[j], rh = prhi[j];
  const uint64_t* row = mat + static_cast<int64_t>(j) * k_in;
  for (int64_t c = blockIdx.x * int64_t{blockDim.x} + threadIdx.x; c < m;
       c += int64_t{gridDim.x} * blockDim.x) {
    uint64_t hi = 0, lo = 0;
    for (int i = 0; i < k_in; ++i) {
      const uint64_t a = y[i * m + c], b = row[i];
      add128(hi, lo, __umul64hi(a, b), a * b);
    }
    uint64_t r = reduce128_any(hi, lo, pj, rl, rh, pow64[j]);
    if (form == 2) {
      r = sub_mod(r, mul_mod(y[k_in * m + c], q_mod_p[j], pj, rl, rh), pj);
    }
    out[j * m + c] = r;
  }
}

int grid_for(int64_t m) {
  const int64_t b = (m + kThreads - 1) / kThreads;
  return static_cast<int>(b < 65535 ? b : 65535);
}

}  // namespace
}  // namespace ptk64

using namespace ptk64;

extern "C" {

// U2.  out: (k_out, m); scratch: (k_in + 1, m); x: (k_in, m); the input
// base's q, Barrett words, QhatInv and its Shoup word, U, V (k_in,); mat:
// (k_out, k_in) [Q/q_i]_{p_j}; the output base's p, Barrett words, 2^64
// mod p and Q mod p (k_out,); form 0 "approx", 1 "reduce", 2 "exact".
int ptk_u64_bconv(void* out, void* scratch, const void* x, const void* q,
                  const void* rlo, const void* rhi, const void* qhat_inv,
                  const void* qhat_inv_shoup, const void* U, const void* V,
                  const void* mat, const void* p, const void* prlo,
                  const void* prhi, const void* pow64, const void* q_mod_p,
                  int k_in, int k_out, int m, int form, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using u64p = const uint64_t*;
  bconv_prep_kernel<<<grid_for(m), kThreads, 0, st>>>(
      static_cast<uint64_t*>(scratch), static_cast<u64p>(x),
      static_cast<u64p>(q), static_cast<u64p>(rlo), static_cast<u64p>(rhi),
      static_cast<u64p>(qhat_inv), static_cast<u64p>(qhat_inv_shoup),
      static_cast<u64p>(U), static_cast<u64p>(V), k_in, m, form);
  const dim3 grid(grid_for(m), k_out);
  bconv_sum_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<uint64_t*>(out), static_cast<u64p>(scratch),
      static_cast<u64p>(mat), static_cast<u64p>(p), static_cast<u64p>(prlo),
      static_cast<u64p>(prhi), static_cast<u64p>(pow64),
      static_cast<u64p>(q_mod_p), k_in, m, form);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

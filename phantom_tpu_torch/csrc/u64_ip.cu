// U3: the evaluation-key inner product of hybrid key switching over u64
// primes.
//
// Replaces the JAX package's u64 inner product, phantom_tpu/schemes/
// keyswitch.py:69 inner_product_evk, which runs as XLA fusions (no
// pallas_call).  For QlP row j (modulus q_j) and key half h:
//   out[h, j, c] = sum_d t[d, j, src(c)] evk[d, h, j, c]  mod q_j,
// the beta products summed exactly over 128 bits and reduced once by
// reduce128_any; src(c) = perm[c] where a gather index is given (a hoisted
// rotation's NTT-form permutation, so the permuted modup tensor is never
// stored), else c.  One thread a word of a row, both halves; it is bound
// by device memory, the key stream first.

#include "modarith64.cuh"

namespace ptk64 {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ip64_kernel(uint64_t* out, const uint64_t* t, const uint64_t* evk,
            const uint64_t* q, const uint64_t* rlo, const uint64_t* rhi,
            const uint64_t* pow64, const int32_t* perm, int beta, int k_out,
            int n) {
  const int j = blockIdx.y;
  const int64_t half = static_cast<int64_t>(k_out) * n;
  const uint64_t qj = q[j], rl = rlo[j], rh = rhi[j], p64 = pow64[j];
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += gridDim.x * blockDim.x) {
    const int src = perm == nullptr ? c : perm[c];
    uint64_t hi0 = 0, lo0 = 0, hi1 = 0, lo1 = 0;
    for (int d = 0; d < beta; ++d) {
      const uint64_t tv = t[(static_cast<int64_t>(d) * k_out + j) * n + src];
      const uint64_t* ev = evk + 2 * d * half + static_cast<int64_t>(j) * n;
      const uint64_t e0 = ev[c], e1 = ev[half + c];
      add128(hi0, lo0, __umul64hi(tv, e0), tv * e0);
      add128(hi1, lo1, __umul64hi(tv, e1), tv * e1);
    }
    const int64_t o = static_cast<int64_t>(j) * n + c;
    out[o] = reduce128_any(hi0, lo0, qj, rl, rh, p64);
    out[half + o] = reduce128_any(hi1, lo1, qj, rl, rh, p64);
  }
}

}  // namespace
}  // namespace ptk64

using namespace ptk64;

extern "C" {

// U3.  out: (2, k_out, n); t: (beta, k_out, n); evk: (beta, 2, k_out, n);
// q, rlo, rhi, pow64: (k_out,) per row; perm: (n,) in [0, n), or null.
int ptk_u64_inner_product(void* out, const void* t, const void* evk,
                          const void* q, const void* rlo, const void* rhi,
                          const void* pow64, const void* perm, int beta,
                          int k_out, int n, void* stream) {
  using u64p = const uint64_t*;
  const dim3 grid((n + kThreads - 1) / kThreads, k_out);
  ip64_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(out), static_cast<u64p>(t),
      static_cast<u64p>(evk), static_cast<u64p>(q), static_cast<u64p>(rlo),
      static_cast<u64p>(rhi), static_cast<u64p>(pow64),
      static_cast<const int32_t*>(perm), beta, k_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

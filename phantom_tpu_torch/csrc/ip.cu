// K9: the evaluation-key inner product of hybrid key switching.
//
// Replaces phantom_tpu/ops/ntt_mxu_pallas.py:ip_mxu_pallas (body
// _ip_kernel).  For QlP row j (modulus q_j) and key half h:
//   out[h, j, c] = sum_d t[d, j, src(c)] * evk[d, h, j, c]  mod q_j,
// src(c) = perm[c] when a gather index is given (a hoisted rotation's
// NTT-form permutation, so the permuted modup tensor is never stored), else
// c.  The TPU kernel carries two 96-bit sums across its sequential digit
// grid axis in VMEM; CUDA blocks run in no order, so here each thread owns
// one word of row j and loops over the digits itself, with both sums in
// registers as a 64-bit low word and a carry count (exact for any beta),
// reduced once by the 2^64 residue of q_j.
//
// It does one 32x32->64 product per evk word and is bound by device
// memory: every t, evk and output word moves once, evk being half the bytes
// or more.

#include "modarith.cuh"

namespace ptk {
namespace {

constexpr int kIpThreads = 256;

__global__ void __launch_bounds__(kIpThreads)
ip_kernel(const uint32_t* t, const uint32_t* evk, const uint32_t* q,
          const int32_t* perm, int beta, int k_out, int n, uint32_t* out) {
  const int j = blockIdx.y;
  const Barrett bq = make_barrett(q[j]);
  const int64_t half = static_cast<int64_t>(k_out) * n;  // one key half
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += gridDim.x * blockDim.x) {
    const int src = perm == nullptr ? c : perm[c];
    uint64_t lo0 = 0, lo1 = 0;
    uint32_t hi0 = 0, hi1 = 0;
    for (int d = 0; d < beta; ++d) {
      const uint32_t tv = t[(static_cast<int64_t>(d) * k_out + j) * n + src];
      const uint32_t* ev = evk + 2 * d * half + static_cast<int64_t>(j) * n;
      mac(lo0, hi0, tv, ev[c]);
      mac(lo1, hi1, tv, ev[half + c]);
    }
    const int64_t o = static_cast<int64_t>(j) * n + c;
    out[o] = reduce128(hi0, lo0, bq);
    out[half + o] = reduce128(hi1, lo1, bq);
  }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// K9.  out: (2, k_out, n); t: (beta, k_out, n); evk: (beta, 2, k_out, n);
// q: (k_out,) the modulus of each row; perm: (n,) in [0, n), or null.
int ptk_inner_product(void* out, const void* t, const void* evk,
                      const void* q, const void* perm, int beta, int k_out,
                      int n, void* stream) {
  const dim3 grid((n + kIpThreads - 1) / kIpThreads, k_out);
  ip_kernel<<<grid, kIpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(t), static_cast<const uint32_t*>(evk),
      static_cast<const uint32_t*>(q), static_cast<const int32_t*>(perm),
      beta, k_out, n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

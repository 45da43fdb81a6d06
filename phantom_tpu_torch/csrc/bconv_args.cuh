// The base conversion that K3 (bconv_ntt.cu) and K7 (moddown_rescale.cu)
// fuse into their transforms' prologues: for group g and output row j,
//   x = sum_i y[g alpha + i] * mat[g, j, i] mod q_j
//       - v[g] * vmul[j] - post_sub[j],
// four words at a time with 16-byte loads of y, the matrix row's alpha
// words broadcast from L1.  The product-sum is one 64-bit sum when the
// wrapper finds, from the moduli, that alpha products stay below 2^64
// (`wide`: at the main path's 29-bit special and 28-bit data primes 22
// products stay below 2^62), else a 64-bit low word and a carry count
// reduced once in 128 bits.
#pragma once

#include "ntt_cluster.cuh"

namespace ptk {

struct BconvArgs {
  const uint32_t* y;    // k_in rows of N; group g's start at row g alpha
  const uint32_t* mat;  // (G, k_out, alpha)
  int alpha, k_out, k_in;
  const uint32_t* v;          // optional (G, N)
  const uint32_t* vmul;       // (k_out,)
  const uint32_t* post;       // optional (k_out,)
  const uint32_t* self_rows;  // optional (>= k_data, N)
  int k_data;
  int wide;  // alpha products of the operands stay below 2^64

  __device__ __forceinline__ bool skip(int j, int g) const {
    if (self_rows == nullptr) return false;
    const int hi = min((g + 1) * alpha, k_data);
    return j >= g * alpha && j < hi;
  }

  // the converted words at row positions gi .. gi + 3, in [0, q)
  __device__ __forceinline__ void convert4(uint32_t (&x)[4], int j, int g,
                                           int64_t gi, int n,
                                           const Barrett& bq) const {
    const int terms = min(alpha, k_in - g * alpha);
    const uint32_t* yg = y + static_cast<int64_t>(g) * alpha * n + gi;
    const uint32_t* m = mat + (static_cast<int64_t>(g) * k_out + j) * alpha;
    if (wide) {
      uint64_t acc[4] = {0, 0, 0, 0};
      for (int i = 0; i < terms; ++i) {
        const uint32_t mi = __ldg(m + i);
        const uint4 yv = ld4(yg + static_cast<int64_t>(i) * n);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[c] += static_cast<uint64_t>(lane4(yv, c)) * mi;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = reduce64(acc[c], bq);
    } else {
      uint64_t lo[4] = {0, 0, 0, 0};
      uint32_t hi[4] = {0, 0, 0, 0};
      for (int i = 0; i < terms; ++i) {
        const uint32_t mi = __ldg(m + i);
        const uint4 yv = ld4(yg + static_cast<int64_t>(i) * n);
#pragma unroll
        for (int c = 0; c < 4; ++c) mac(lo[c], hi[c], lane4(yv, c), mi);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = reduce128(hi[c], lo[c], bq);
    }
    if (v != nullptr) {
      const uint4 vv = ld4(v + static_cast<int64_t>(g) * n + gi);
      const uint32_t vm = __ldg(vmul + j);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[c] = sub_mod(x[c], mul_mod(lane4(vv, c), vm, bq), bq.q);
    }
    if (post != nullptr) {
      const uint32_t p = __ldg(post + j);
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = sub_mod(x[c], p, bq.q);
    }
  }
};

}  // namespace ptk

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
// package's, so v flips where the JAX package's does.  The sums are
// exact, so the order in which they are taken does not change them.
//
// One launch, no scratch tensor.  A block of kGroups x kTile threads
// takes kTile columns.  It copies `mat` (k_out, k_in) and the output
// base's words into shared memory once; thread (g, c) reads x's rows i =
// g, g + kGroups, .. of column c (a warp reads 32 consecutive words of a
// row), computes y by Shoup into the (k_in, kTile) tile in shared memory
// and, for "exact", its part of S1 and S2, which the block's four parts
// of a column sum after one barrier.  Then thread (g, c) sums, for the
// output rows of its row blocks (kRows rows each, blocks g, g + kGroups,
// .. so that a warp's rows are one row block: its matrix words are
// broadcasts), the exact 128-bit products over every y of its column
// (on four 32-bit words and the carry chain: mac128), reduces each sum
// once by reduce128_any, applies the "exact" correction and stores: a
// warp writes 32 consecutive words of a row.  x is read
// from device memory once and the output written once.  k_in <= 63 keeps
// the sum of products below 2^61 x 2^61 x 63 < 2^128.  Any M: the last
// block's columns past M read nothing and store nothing.
//
// Form 3, "scale_round", is BFV's exact scale-and-round (the JAX
// package's scaleround.scale_and_round_exact, phantom_tpu/ops/
// scaleround.py:224): round((num/den) x) from the input base D to an
// output base whose primes divide G = num prod(D) / den.  With y_i as
// above (I/d_i in Q/q_i's place), G = omega_i d_i + rho_i, `mat` holding
// omega_i mod p_j and `V` rho_i:
//
//   out_j = [sum_i y_i omega_ji + F]_{p_j},
//   F     = S1 + floor((S2 + 2^127) / 2^64),
//   S1    = sum_i g_i,  g_i, r_i = divmod(y_i rho_i, d_i),
//   S2    = sum_i floor(r_i 2^64 / d_i)
//
// over 128 bits.  The integer part is "approx"'s; the cascade is
// "exact"'s with rho in V's place and no y U term, each part of a column
// summed as there.  F (< 63 x 2^61) is added to each output row's sum (<
// 63 x 2^122) before its one reduce128_any: the total stays below 2^128
// and [sum + F]_p = [[sum]_p + [F]_p]_p, the plain version's two
// reductions.
//
// Bound: at 22 -> 43 rows, M = 2^16, the 43 x 22 x 2^16 products at 7
// 32-bit multiplies (the high word 4, the low word 3) and the 43 x 2^16
// reductions at 45 are 0.56 G multiplies, 0.034 ms at 16.7 T/s, against
// 34 MB of x and out, 0.010 ms at 3.35 TB/s: bound by its products.

#include <atomic>

#include "modarith64.cuh"

namespace ptk64 {
namespace {

// kernel launches made by ptk_u64_bconv since the library was loaded
std::atomic<long long> launched{0};

constexpr int kTile = 64;    // columns a block
constexpr int kGroups = 4;   // threads a column
constexpr int kRows = 4;     // output rows a thread sums at once
constexpr int kThreads = kTile * kGroups;

struct Bconv64Args {
  uint64_t* out;                // (k_out, m)
  const uint64_t* x;            // (k_in, m)
  const uint64_t* q;            // the input base's moduli, Barrett words,
  const uint64_t* rlo;          // QhatInv and its Shoup word, U, V (k_in,)
  const uint64_t* rhi;
  const uint64_t* qhat_inv;
  const uint64_t* qhat_inv_shoup;
  const uint64_t* U;
  const uint64_t* V;
  const uint64_t* mat;          // (k_out, k_in) [Q/q_i]_{p_j}
  const uint64_t* p;            // the output base's moduli, Barrett
  const uint64_t* prlo;         // words, 2^64 mod p and Q mod p (k_out,)
  const uint64_t* prhi;
  const uint64_t* pow64;
  const uint64_t* q_mod_p;
  int k_in, k_out;
  int64_t m;
};

// (a3 a2 a1 a0) += y b mod 2^128 on 32-bit words: the four 32 x 32
// partial products as multiply-adds on the carry chain, 8 multiply-adds
// and 2 adds (the compiler's 64-bit mul.lo, mul.hi and 128-bit add took
// about 16 instructions)
__device__ __forceinline__ void mac128(uint32_t (&a)[4], uint64_t y,
                                       uint64_t b) {
  const uint32_t y0 = static_cast<uint32_t>(y);
  const uint32_t y1 = static_cast<uint32_t>(y >> 32);
  const uint32_t b0 = static_cast<uint32_t>(b);
  const uint32_t b1 = static_cast<uint32_t>(b >> 32);
  asm("mad.lo.cc.u32 %0, %4, %6, %0;\n\t"   // y0 b0 and y1 b1 at 0 and 64
      "madc.hi.cc.u32 %1, %4, %6, %1;\n\t"
      "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
      "madc.hi.u32 %3, %5, %7, %3;\n\t"
      "mad.lo.cc.u32 %1, %4, %7, %1;\n\t"   // y0 b1 at 32
      "madc.hi.cc.u32 %2, %4, %7, %2;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "mad.lo.cc.u32 %1, %5, %6, %1;\n\t"   // y1 b0 at 32
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "addc.u32 %3, %3, 0;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "r"(y0), "r"(y1), "r"(b0), "r"(b1));
}

// words of shared memory: the y tile, mat, five words per output row,
// and for "exact" and "scale_round" the four 128-bit parts of S1 and S2
// per column
int smem_words(int k_in, int k_out, int form) {
  return k_in * kTile + k_out * k_in + 5 * k_out +
         (form >= 2 ? 4 * kGroups * kTile : 0);
}

template <int kForm>  // 0 "approx", 1 "reduce", 2 "exact", 3 "scale_round"
__global__ void __launch_bounds__(kThreads)
bconv64_kernel(Bconv64Args a) {
  extern __shared__ uint64_t sm[];
  const int k_in = a.k_in, k_out = a.k_out;
  uint64_t* ys = sm;                       // (k_in, kTile)
  uint64_t* mat = ys + k_in * kTile;       // (k_out, k_in)
  uint64_t* ob = mat + k_out * k_in;       // (5, k_out)
  uint64_t* part = ob + 5 * k_out;         // (4, kGroups, kTile)
  const int c = threadIdx.x % kTile, g = threadIdx.x / kTile;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTile + c;
  const bool in = col < a.m;
  for (int i = threadIdx.x; i < k_out * k_in; i += kThreads)
    mat[i] = __ldg(reinterpret_cast<const unsigned long long*>(a.mat) + i);
  for (int j = threadIdx.x; j < k_out; j += kThreads) {
    ob[j] = a.p[j];
    ob[k_out + j] = a.prlo[j];
    ob[2 * k_out + j] = a.prhi[j];
    ob[3 * k_out + j] = a.pow64[j];
    ob[4 * k_out + j] = kForm == 2 ? a.q_mod_p[j] : 0;
  }
  uint64_t s1_hi = 0, s1_lo = 0, s2_hi = 0, s2_lo = 0;
  for (int i = g; i < k_in; i += kGroups) {
    uint64_t v = in ? a.x[i * a.m + col] : 0;
    if (kForm != 1) v = shoup(v, a.qhat_inv[i], a.qhat_inv_shoup[i], a.q[i]);
    ys[i * kTile + c] = v;
    if (kForm >= 2) {
      uint64_t r1, rem;
      const uint64_t q1 = div_mod128(__umul64hi(v, a.V[i]), v * a.V[i],
                                     a.q[i], a.rlo[i], a.rhi[i], r1);
      const uint64_t s2 = div_mod128(r1, 0, a.q[i], a.rlo[i], a.rhi[i], rem);
      if (kForm == 2) add128(s1_hi, s1_lo, 0, v * a.U[i]);
      add128(s1_hi, s1_lo, 0, q1);
      add128(s2_hi, s2_lo, 0, s2);
    }
  }
  if (kForm >= 2) {
    part[(0 * kGroups + g) * kTile + c] = s1_hi;
    part[(1 * kGroups + g) * kTile + c] = s1_lo;
    part[(2 * kGroups + g) * kTile + c] = s2_hi;
    part[(3 * kGroups + g) * kTile + c] = s2_lo;
  }
  __syncthreads();
  uint64_t vq = 0;  // v, for "exact"
  if (kForm >= 2) {
    s1_hi = s1_lo = s2_hi = s2_lo = 0;
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      add128(s1_hi, s1_lo, part[(0 * kGroups + h) * kTile + c],
             part[(1 * kGroups + h) * kTile + c]);
      add128(s2_hi, s2_lo, part[(2 * kGroups + h) * kTile + c],
             part[(3 * kGroups + h) * kTile + c]);
    }
    if (kForm == 2) {
      const uint64_t lo = s1_lo + s2_hi;
      vq = s1_hi + (lo < s1_lo ? 1 : 0);
    } else {  // F = S1 + S2_hi + carry(S2_lo + 2^127's low word)
      const uint64_t half = uint64_t{1} << 63;
      add128(s1_hi, s1_lo, 0, s2_hi + (s2_lo + half < s2_lo ? 1 : 0));
    }
  }
  for (int j0 = g * kRows; j0 < k_out; j0 += kGroups * kRows) {
    const uint64_t* mr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      mr[r] = mat + (j0 + r < k_out ? j0 + r : k_out - 1) * k_in;
    uint32_t acc[kRows][4] = {};
    for (int i = 0; i < k_in; ++i) {
      const uint64_t y = ys[i * kTile + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) mac128(acc[r], y, mr[r][i]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 + r;
      if (j >= k_out || !in) continue;
      uint64_t hi = (uint64_t{acc[r][3]} << 32) | acc[r][2];
      uint64_t lo = (uint64_t{acc[r][1]} << 32) | acc[r][0];
      if (kForm == 3) add128(hi, lo, s1_hi, s1_lo);  // + F
      const uint64_t pj = ob[j], rl = ob[k_out + j], rh = ob[2 * k_out + j];
      uint64_t res = reduce128_any(hi, lo, pj, rl, rh, ob[3 * k_out + j]);
      if (kForm == 2)
        res = sub_mod(res, mul_mod(vq, ob[4 * k_out + j], pj, rl, rh), pj);
      a.out[j * a.m + col] = res;
    }
  }
}

template <int kForm>
cudaError_t launch(const Bconv64Args& a, cudaStream_t stream) {
  auto kernel = bconv64_kernel<kForm>;
  const int smem = static_cast<int>(sizeof(uint64_t)) *
                   smem_words(a.k_in, a.k_out, kForm);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (a.m + kTile - 1) / kTile;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) launched.fetch_add(1);
  return e;
}

}  // namespace
}  // namespace ptk64

using namespace ptk64;

extern "C" {

// The kernel launches U2 has made (chip_smoke.py divides them by the
// wrapper's calls: one a call).
long long ptk_u64_bconv_launches() { return launched.load(); }

// U2.  out: (k_out, m); x: (k_in, m); the input base's q, Barrett words,
// QhatInv and its Shoup word, U, V (k_in,); mat: (k_out, k_in)
// [Q/q_i]_{p_j}; the output base's p, Barrett words, 2^64 mod p and Q mod
// p (k_out,); form 0 "approx", 1 "reduce", 2 "exact", 3 "scale_round"
// (I/d_i in Q/q_i's place, omega in mat's, rho in V's).  U and q_mod_p
// are read by "exact" only and may be null otherwise.  k_in <= 63.
int ptk_u64_bconv(void* out, const void* x, const void* q, const void* rlo,
                  const void* rhi, const void* qhat_inv,
                  const void* qhat_inv_shoup, const void* U, const void* V,
                  const void* mat, const void* p, const void* prlo,
                  const void* prhi, const void* pow64, const void* q_mod_p,
                  int k_in, int k_out, int m, int form, void* stream) {
  if (k_in < 1 || k_in > 63 || k_out < 1 || m < 1 || form < 0 || form > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  using u64p = const uint64_t*;
  const Bconv64Args a{static_cast<uint64_t*>(out), static_cast<u64p>(x),
                      static_cast<u64p>(q), static_cast<u64p>(rlo),
                      static_cast<u64p>(rhi), static_cast<u64p>(qhat_inv),
                      static_cast<u64p>(qhat_inv_shoup), static_cast<u64p>(U),
                      static_cast<u64p>(V), static_cast<u64p>(mat),
                      static_cast<u64p>(p), static_cast<u64p>(prlo),
                      static_cast<u64p>(prhi), static_cast<u64p>(pow64),
                      static_cast<u64p>(q_mod_p), k_in, k_out, m};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(form == 0   ? launch<0>(a, st)
                          : form == 1 ? launch<1>(a, st)
                          : form == 2 ? launch<2>(a, st)
                                      : launch<3>(a, st));
}

}  // extern "C"

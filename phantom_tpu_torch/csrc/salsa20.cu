// S1: the reference's Salsa20 sampler (uniform, ternary and error forms).
//
// Replaces no TPU kernel: the JAX package samples on the host, in numpy
// (phantom_tpu/utils/salsa20.py:111, 126, 146) or its native C++ library
// (phantom_tpu/native/host_math.cpp:252 pt_sample_uniform, :292
// pt_sample_ternary, :308 pt_sample_error).  The reference runs this
// sampler on the device (src/prng.cu:142-244), and a seed-compressed
// load regenerates c1 with it: at N = 2^16 over 43 primes, 352,256
// keystream blocks.  The state is the reference's nonstandard one: key
// words at 0-7 and 10-15 (the seed's first 56 bytes), the 64-bit nonce at
// 8-9, no constants, no counter (prng.cu:28-45); 20 rounds, then the
// input words added.
//
//   uniform  a thread a (limb, group of 8 residues): the block at nonce
//            tid = limb N/8 + group, lanes = word pairs low word first; a
//            lane above the largest multiple of q below 2^64 regenerates
//            the block at nonce tid + tries N L for that lane and every
//            later one, until none is; then each lane mod q (barrett64)
//            and the 64 bytes written with four 16-byte stores.
//   ternary  a thread a coefficient i: the block at nonce i, its first
//   error    byte mod 3 less 1 (ternary), or the centered binomial of
//            popcounts of bytes 0, 1, 2 & 0x1F less 3, 4, 5 & 0x1F (error),
//            written to every limb mod q.
//
// Bound: the uniform form by its 20 rounds, 3 ALU operations a quarter-
// round step (add, funnel shift, xor), 976 a block, against 64 bytes
// written a block; about 15 operations a byte, past the card's 5 (16.7 T
// 32-bit operations a second over 3.35 TB/s).  The ternary and error
// forms write L words a block and are bound by their bytes from a few
// limbs on.  The state stays in registers; the seed rides in the kernel's
// parameters.

#include "modarith64.cuh"

namespace pts1 {
namespace {

constexpr int kThreads = 256;
constexpr int kKeyWords = 14;

struct Seed {
  uint32_t w[kKeyWords];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int c) {
  return __funnelshift_l(x, x, c);
}

#define PTS1_QR(a, b, c, r) x[a] ^= rotl(x[b] + x[c], r)

// the keystream block at `nonce`, as 16 words
__device__ __forceinline__ void salsa_block(const Seed& s, uint64_t nonce,
                                            uint32_t out[16]) {
  uint32_t j[16];
#pragma unroll
  for (int w = 0; w < 8; ++w) j[w] = s.w[w];
  j[8] = static_cast<uint32_t>(nonce);
  j[9] = static_cast<uint32_t>(nonce >> 32);
#pragma unroll
  for (int w = 8; w < kKeyWords; ++w) j[w + 2] = s.w[w];
  uint32_t x[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) x[w] = j[w];
#pragma unroll 2
  for (int r = 0; r < 10; ++r) {
    PTS1_QR(4, 0, 12, 7);   PTS1_QR(8, 4, 0, 9);
    PTS1_QR(12, 8, 4, 13);  PTS1_QR(0, 12, 8, 18);
    PTS1_QR(9, 5, 1, 7);    PTS1_QR(13, 9, 5, 9);
    PTS1_QR(1, 13, 9, 13);  PTS1_QR(5, 1, 13, 18);
    PTS1_QR(14, 10, 6, 7);  PTS1_QR(2, 14, 10, 9);
    PTS1_QR(6, 2, 14, 13);  PTS1_QR(10, 6, 2, 18);
    PTS1_QR(3, 15, 11, 7);  PTS1_QR(7, 3, 15, 9);
    PTS1_QR(11, 7, 3, 13);  PTS1_QR(15, 11, 7, 18);
    PTS1_QR(1, 0, 3, 7);    PTS1_QR(2, 1, 0, 9);
    PTS1_QR(3, 2, 1, 13);   PTS1_QR(0, 3, 2, 18);
    PTS1_QR(6, 5, 4, 7);    PTS1_QR(7, 6, 5, 9);
    PTS1_QR(4, 7, 6, 13);   PTS1_QR(5, 4, 7, 18);
    PTS1_QR(11, 10, 9, 7);  PTS1_QR(8, 11, 10, 9);
    PTS1_QR(9, 8, 11, 13);  PTS1_QR(10, 9, 8, 18);
    PTS1_QR(12, 15, 14, 7); PTS1_QR(13, 12, 15, 9);
    PTS1_QR(14, 13, 12, 13); PTS1_QR(15, 14, 13, 18);
  }
#pragma unroll
  for (int w = 0; w < 16; ++w) out[w] = x[w] + j[w];
}

#undef PTS1_QR

__global__ void __launch_bounds__(kThreads)
uniform_kernel(uint64_t* out, const uint64_t* q, const uint64_t* rhi,
               Seed s, uint64_t groups, uint64_t total, uint64_t stride) {
  const uint64_t tid =
      static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const uint64_t li = tid / groups;
  const uint64_t ql = q[li], rh = rhi[li];
  const uint64_t ones = ~0ull;
  const uint64_t max_multiple = ones - ptk64::barrett64(ones, ql, rh) - 1;
  uint32_t b[16];
  salsa_block(s, tid, b);
  uint64_t v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = b[2 * k] | (static_cast<uint64_t>(b[2 * k + 1]) << 32);
  for (uint64_t tries = 1;; ++tries) {
    int first = 8;
#pragma unroll
    for (int k = 7; k >= 0; --k)
      if (v[k] > max_multiple) first = k;
    if (first == 8) break;
    salsa_block(s, tid + tries * stride, b);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k >= first)
        v[k] = b[2 * k] | (static_cast<uint64_t>(b[2 * k + 1]) << 32);
  }
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + tid * 8);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    dst[k] = make_ulonglong2(ptk64::barrett64(v[2 * k], ql, rh),
                             ptk64::barrett64(v[2 * k + 1], ql, rh));
}

template <bool kError>
__global__ void __launch_bounds__(kThreads)
small_kernel(uint64_t* out, const uint64_t* q, Seed s, int num_l, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t b[16];
  salsa_block(s, static_cast<uint64_t>(i), b);
  const uint32_t w0 = b[0], w1 = b[1];
  int v;
  if (kError) {
    v = __popc(w0 & 0xFFu) + __popc((w0 >> 8) & 0xFFu) +
        __popc((w0 >> 16) & 0x1Fu) - __popc(w0 >> 24) - __popc(w1 & 0xFFu) -
        __popc((w1 >> 8) & 0x1Fu);
  } else {
    v = static_cast<int>((w0 & 0xFFu) % 3u) - 1;
  }
  for (int l = 0; l < num_l; ++l) {
    const uint64_t ql = q[l];
    out[static_cast<int64_t>(l) * n + i] =
        v < 0 ? ql - static_cast<uint64_t>(-v) : static_cast<uint64_t>(v);
  }
}

}  // namespace
}  // namespace pts1

using namespace pts1;

extern "C" {

// S1.  form: 0 uniform, 1 ternary, 2 error.  out: (num_l, n) u64 words;
// q, rhi: (num_l,) the moduli and floor(2^128 / q) >> 64 (the uniform
// form's reduction); seed: 14 key words in host memory.  The uniform form
// needs n % 8 == 0.
int ptk_salsa20(int form, void* out, const void* q, const void* rhi,
                const void* seed, int num_l, int n, void* stream) {
  Seed s;
  const uint32_t* sw = static_cast<const uint32_t*>(seed);
  for (int w = 0; w < kKeyWords; ++w) s.w[w] = sw[w];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* o = static_cast<uint64_t*>(out);
  const uint64_t* qq = static_cast<const uint64_t*>(q);
  if (form == 0) {
    const uint64_t groups = static_cast<uint64_t>(n) / 8;
    const uint64_t total = groups * num_l;
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    uniform_kernel<<<blocks, kThreads, 0, st>>>(
        o, qq, static_cast<const uint64_t*>(rhi), s, groups, total,
        static_cast<uint64_t>(n) * num_l);
  } else {
    const unsigned blocks = (n + kThreads - 1) / kThreads;
    if (form == 1)
      small_kernel<false><<<blocks, kThreads, 0, st>>>(o, qq, s, num_l, n);
    else
      small_kernel<true><<<blocks, kThreads, 0, st>>>(o, qq, s, num_l, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// F1: the CKKS special FFT in double-float (two-f32) arithmetic, forward
// (Cooley-Tukey) and inverse (Gentleman-Sande, with the 1/n scale), and the
// device encoder's two forms of it.
//
// Replaces no TPU kernel: the JAX package runs phantom_tpu/ops/ckks_fft.py:
// 168 fft_forward and :192 fft_inverse as XLA fusions, and its device
// encoder's scatter in numpy on the host.  The plain versions are
// phantom_tpu_torch/ops/ckks_fft.py's ckks_fft_plain, ckks_fft_encode_plain
// and ckks_fft_decode_plain, which evaluate every f32 operation of the
// error-free transformations (two_sum, quick_two_sum, the Veltkamp split,
// two_prod) one by one; these kernels equal them bit for bit.  So every f32
// operation here is an explicit __fadd_rn / __fsub_rn / __fmul_rn in the
// plain version's operand order (two_prod is not symmetric in its
// rounding), which the compiler never contracts into an FMA: a fused
// x0 y1 + e in df_mul's cross terms would round once where the plain
// version rounds twice (chip_smoke.py reads the SASS of every kernel named
// ckks_fft_* and requires no FFMA).
//
// Forms (one launch count, F1's):
//   ptk_ckks_fft         (4, n) f32 planes re_hi, re_lo, im_hi, im_lo in and
//                        out, either direction;
//   ptk_ckks_fft_encode  the (m, 2) float64 slot values in (m <= n/2, the
//                        rest zero): each position reads its slot or the
//                        conjugate's (slot_of), multiplies by the scale as
//                        numpy's complex128 z * scale does (re s - im 0,
//                        re 0 + im s in f64, so signed zeros agree) and
//                        splits it into a double-float; the inverse FFT;
//                        then round(hi) + round(lo + (hi - round(hi))) and
//                        the floor modulus by each of the k primes: the
//                        (k, n) int32 residues for K2;
//   ptk_ckks_fft_decode  the coefficient-form limbs 0-1 in: the centered
//                        value by Garner (limb 0 alone for k = 1), hi =
//                        (float) m, lo = (float) (m - (int64) hi), each
//                        times the f32 1/scale; the forward FFT; then each
//                        slot's position (slot_of >= 0) writes hi + lo in
//                        f64, per part: the (n/2, 2) float64 slot values.
//   ptk_ckks_fft_encode64, ptk_ckks_fft_decode64
//                        the same two forms on 64-bit words, for primes up
//                        to 2^61 (the u64 evaluator's): the residues are
//                        int64 words, x mod q in [0, q) for |x| < 2^62
//                        (barrett64 of |x| with floor(2^64 / q), then q - r
//                        for a negative x); the limbs are int64 words,
//                        composed by the wide Garner step (x0 mod q1 first,
//                        since q0 may pass q1; t = (x1 - x0) q0^-1 mod q1 by
//                        Shoup, centered; m = x0 + q0 t_c in int64, which
//                        wraps as the plain version's does for inputs that
//                        cannot be decoded).  Only the two ends differ: the
//                        transform passes and the launches are the 32-bit
//                        forms', and each 32-bit form's instantiation is
//                        the same code (the wide ones are the In / Out
//                        values kInLimbs64 and kOutResidues64).
//
// Bound (NVIDIA H100 SXM: 3.35 TB/s; f32 at 132 SMs x 128 lanes x 1.98 GHz
// = 33.5 T/s).  A butterfly is 162 f32 operations (cdf_mul: four df_mul of
// 24 and a df_add and a df_sub of 11; a cdf_add and a cdf_sub of 22), and
// n = 2^16 has 16 stages of 32768: 84.9 M operations, 2.53 us, against
// 3.1 MB (x, the table, the result) = 0.94 us, so the bare form is bound by
// operations; so is decode (2.4 MB).  Encode at chain index 1 (k = 43)
// writes 11.3 MB of residues: about 13 MB, 3.9 us, bound by bytes; the wide
// encode form writes twice that, 22.5 MB.
//
// Design.  One vector of 2^16 words must be spread over all 132 SMs, which
// no block and no cluster holds, so the transform splits by the butterfly
// distance h at 2^lr (lr = logn / 2, lc = logn - lr):
//   the stages with h >= 2^lr combine only words with equal i mod 2^lr: the
//     column pass, 2^lr independent subproblems ("classes") of 2^lc words,
//     word j of class c at c + 2^lr j;
//   the stages with h < 2^lr combine only words inside one aligned block of
//     2^lr: the row pass, 2^lc contiguous subproblems ("rows").
// Each butterfly keeps its operands, its twiddle (local index m_l + g maps
// to the table entry m_l + g in a column, m_l (2^lc + r) + g in row r) and
// its place in the order of its stage, and no twiddle multiply is inserted,
// so the output is the plain version's word for word.  Forward: the column
// pass, then the row pass; inverse: rows, then columns, the 1/n on the way
// out.  At n = 2^16 each pass is 128 blocks of 256 threads, two
// subproblems of 256 words a block and one butterfly a thread a stage,
// about 8 warps an SM to carry the double-float chains' latency.  A block
// loads its twiddles into shared memory once a pass (a column's 255 are
// every block's, a row's are contiguous per stage) and keeps the four
// planes in shared arrays swizzled by j ^ 31 in every odd run of 32 words,
// so the 32 lanes of a butterfly load hit 32 banks at every distance
// (below 32 a warp's u words have bit log h clear, and the swizzle sets it
// in the second run).  Its twiddles load with cp.async, beside the
// pass's data.  The row pass moves its rows with 16-byte accesses; a
// column block moves its two adjacent classes 8 bytes a row a plane (the
// 1 MiB intermediate stays in L2 between the passes).  Moving a cluster's
// eight classes through distributed shared memory instead, 32 bytes a row,
// measured slower on the H100.  Encode's residues are 11 MB, so there the
// column pass does run in clusters of four blocks (eight adjacent
// classes): each block stages its int64 coefficients in shared memory and
// writes one 32-byte sector a prime a row of the cluster's residues.  The
// passes are joined by a programmatic dependent launch: the second,
// launched with cudaLaunchAttributeProgrammaticStreamSerialization, loads
// its twiddles while the first runs and waits at griddepcontrol.wait.
// One cooperative launch with a grid barrier between the passes measured
// 1.1-4.1 us slower a call in every form on the H100 (PERF.md), so the
// passes stay two launches.  Up to n = 2^11 one block runs every stage in
// one launch.  ptk_ckks_fft_grids reports the blocks of each launch of
// the last call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith64.cuh"

namespace ptk {
namespace {

namespace cg = cooperative_groups;

constexpr int kFftThreads = 256;
constexpr int kSubs = 2;          // subproblems a block holds (two passes)
constexpr int kClusterBlocks = 4;  // a column cluster: 8 adjacent classes
constexpr int kLogOneBlock = 11;  // n <= 2^11: every stage in one block
constexpr int kLogMaxSub = 11;    // the largest subproblem, 2^11 words
constexpr int kPad = 16;          // words after each subproblem in shared
constexpr int kMaxGrids = 8;      // launches of one call recorded

enum { kInPlanes, kInSlots, kInLimbs, kInLimbs64 };
enum { kOutPlanes, kOutSlots, kOutResidues, kOutResidues64 };

struct DF {
  float hi, lo;
};
struct CDF {
  DF re, im;
};

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ DF two_sum(float a, float b) {
  const float s = fadd(a, b);
  const float bb = fsub(s, a);
  return {s, fadd(fsub(a, fsub(s, bb)), fsub(b, bb))};
}

__device__ __forceinline__ DF quick_two_sum(float a, float b) {
  const float s = fadd(a, b);
  return {s, fsub(b, fsub(s, a))};
}

__device__ __forceinline__ DF split(float a) {
  const float t = fmul(4097.0f, a);
  const float hi = fsub(t, fsub(t, a));
  return {hi, fsub(a, hi)};
}

__device__ __forceinline__ DF two_prod(float a, float b) {
  const float p = fmul(a, b);
  const DF as = split(a), bs = split(b);
  const float err = fadd(fadd(fadd(fsub(fmul(as.hi, bs.hi), p),
                                   fmul(as.hi, bs.lo)),
                              fmul(as.lo, bs.hi)),
                         fmul(as.lo, bs.lo));
  return {p, err};
}

__device__ __forceinline__ DF df_add(DF x, DF y) {
  const DF s = two_sum(x.hi, y.hi);
  return quick_two_sum(s.hi, fadd(fadd(s.lo, x.lo), y.lo));
}

__device__ __forceinline__ DF df_neg(DF x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ DF df_sub(DF x, DF y) { return df_add(x, df_neg(y)); }

__device__ __forceinline__ DF df_mul(DF x, DF y) {
  const DF p = two_prod(x.hi, y.hi);
  return quick_two_sum(p.hi, fadd(fadd(p.lo, fmul(x.hi, y.lo)),
                                  fmul(x.lo, y.hi)));
}

__device__ __forceinline__ CDF cdf_add(CDF a, CDF b) {
  return {df_add(a.re, b.re), df_add(a.im, b.im)};
}

__device__ __forceinline__ CDF cdf_sub(CDF a, CDF b) {
  return {df_sub(a.re, b.re), df_sub(a.im, b.im)};
}

__device__ __forceinline__ CDF cdf_mul(CDF a, CDF b) {
  return {df_sub(df_mul(a.re, b.re), df_mul(a.im, b.im)),
          df_add(df_mul(a.re, b.im), df_mul(a.im, b.re))};
}

// one butterfly of distance h on (u, v) with twiddle tw
__device__ __forceinline__ void butterfly(CDF& u, CDF& v, CDF tw,
                                          bool inverse) {
  if (inverse) {
    const CDF s = cdf_add(u, v);
    v = cdf_mul(cdf_sub(u, v), tw);
    u = s;
  } else {
    const CDF wv = cdf_mul(v, tw);
    const CDF a = cdf_add(u, wv);
    v = cdf_sub(u, wv);
    u = a;
  }
}

// the shared-memory slot of word j of a subproblem: j ^ 31 in every odd
// run of 32 words (a bijection on each run)
__device__ __forceinline__ int sw(int j) { return j ^ (((j >> 5) & 1) * 31); }

// The operands of one pass.  x: (4, n) planes read (kInPlanes); z, count,
// scale: the slot values (kInSlots); limbs, rows, q0, q1, qinv,
// inv_scale: the coefficient-form limbs 0-1 and Garner's constants
// (kInLimbs); y: (4, n) planes written (kOutPlanes), scaled by inv_n when
// it is not 0; slots: (n/2, 2) float64 written (kOutSlots); res, q, k: the
// (k, n) residues modulo q[0..k) (kOutResidues); slot_of: position ->
// slot j, or ~j for a conjugate; w: the direction's (4, n) twiddle table.
// The wide forms (after inv_n, so the 32-bit forms' fields keep their
// offsets): limbs64, the int64 limbs 0 (and 1) with Garner's q0w, q1w,
// qinvw = q0^-1 mod q1, its Shoup word qinv_shoup and mu1w = floor(2^64 /
// q1) (kInLimbs64); res64 and q64, the (k, n) int64 residues and the (k,)
// int64 moduli (kOutResidues64).
struct FftArgs {
  const float* x;
  const double* z;
  int count;
  double scale;
  const int32_t* limbs;
  int rows;
  uint32_t q0, q1, qinv;
  float inv_scale;
  float* y;
  double* slots;
  int32_t* res;
  const int32_t* q;
  int k;
  const int32_t* slot_of;
  const float* w;
  int logn, lr, lc;  // n = 2^logn = 2^lr x 2^lc; lc = 0: one block
  float inv_n;
  const int64_t* limbs64;
  int64_t* res64;
  const int64_t* q64;
  uint64_t q0w, q1w, qinvw, qinv_shoup, mu1w;
};

// -- the prologues' and epilogues' arithmetic ------------------------------

// numpy's complex128 slot times the float64 scale, mirrored for a
// conjugate, split as df_from_f64: (re_hi, re_lo, im_hi, im_lo)
__device__ __forceinline__ float4 slot_word(const FftArgs& a, int64_t pos) {
  const int so = __ldg(a.slot_of + pos);
  const int j = so >= 0 ? so : ~so;
  double ar = 0.0, ai = 0.0;
  if (j < a.count) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(a.z) + j);
    ar = v.x;
    ai = v.y;
  }
  const double re = __dsub_rn(__dmul_rn(ar, a.scale), __dmul_rn(ai, 0.0));
  double im = __dadd_rn(__dmul_rn(ar, 0.0), __dmul_rn(ai, a.scale));
  if (so < 0) im = -im;
  const float rh = __double2float_rn(re), ih = __double2float_rn(im);
  return make_float4(
      rh, __double2float_rn(__dsub_rn(re, static_cast<double>(rh))), ih,
      __double2float_rn(__dsub_rn(im, static_cast<double>(ih))));
}

// floor((2^64 - 1) / q) or slightly less, without an integer division:
// the reciprocal rounded down, so that the quotient estimate of `reduce`
// never exceeds the quotient
__device__ __forceinline__ uint64_t barrett_mu(uint32_t q) {
  return __double2ull_rz(__dmul_rz(__drcp_rd(static_cast<double>(q)),
                                   18446744073709551616.0));
}

// u mod q: the estimate is at most 3 below the quotient for q >= 2^13
// (the loop finishes it for any q)
__device__ __forceinline__ uint32_t reduce(uint64_t u, uint32_t q,
                                          uint64_t mu) {
  uint64_t r = u - __umul64hi(u, mu) * q;
  while (r >= q) r -= q;
  return static_cast<uint32_t>(r);
}

// v mod q in [0, q), as torch's % (a floor modulus)
__device__ __forceinline__ int32_t floor_mod(int64_t v, uint32_t q,
                                             uint64_t mu) {
  if (v >= 0) return static_cast<int32_t>(reduce(v, q, mu));
  const uint32_t r = reduce(0ull - static_cast<uint64_t>(v), q, mu);
  return static_cast<int32_t>(r == 0 ? 0 : q - r);
}

// round(hi) + round(lo + (hi - round(hi))), each round half to even
__device__ __forceinline__ int64_t round_df(float hi, float lo) {
  const int64_t a = __float2ll_rz(rintf(hi));
  return a + __float2ll_rz(rintf(fadd(lo, fsub(hi, __ll2float_rn(a)))));
}

// the centered value of limb words x0 (and x1), by Garner
__device__ __forceinline__ int64_t centered(const FftArgs& a, uint32_t x0,
                                            uint32_t x1, uint64_t mu1) {
  if (a.rows == 1)
    return x0 > a.q0 / 2 ? static_cast<int64_t>(x0) - a.q0 : x0;
  // (x1 - x0 % q1) % q1 * qinv % q1, each % a floor modulus
  const int64_t d = static_cast<int64_t>(x1) - reduce(x0, a.q1, mu1);
  const uint32_t dm = static_cast<uint32_t>(floor_mod(d, a.q1, mu1));
  const uint32_t u = reduce(static_cast<uint64_t>(dm) * a.qinv, a.q1, mu1);
  const int64_t uc = u > a.q1 / 2 ? static_cast<int64_t>(u) - a.q1 : u;
  return static_cast<int64_t>(x0) + static_cast<int64_t>(a.q0) * uc;
}

// the wide forms' centered value of limb words x0 (and x1), by Garner:
// x0 mod q1 first (q0 may pass q1), t = (x1 - x0) q0^-1 mod q1 by Shoup,
// centered against q1 / 2, m = x0 + q0 t_c mod 2^64
__device__ __forceinline__ int64_t centered64(const FftArgs& a, uint64_t x0,
                                              uint64_t x1) {
  if (a.rows == 1)
    return static_cast<int64_t>(x0 > a.q0w / 2 ? x0 - a.q0w : x0);
  const uint64_t d =
      ptk64::sub_mod(x1, ptk64::barrett64(x0, a.q1w, a.mu1w), a.q1w);
  const uint64_t u = ptk64::shoup(d, a.qinvw, a.qinv_shoup, a.q1w);
  const uint64_t uc = u > a.q1w / 2 ? u - a.q1w : u;
  return static_cast<int64_t>(x0 + a.q0w * uc);
}

// v mod q in [0, q) for |v| < 2^62 and q < 2^61: |v| mod q by barrett64
// with mu = floor(2^64 / q), then q - r for a negative v
__device__ __forceinline__ int64_t floor_mod64(bool neg, uint64_t u,
                                               uint64_t q, uint64_t mu) {
  const uint64_t r = ptk64::barrett64(u, q, mu);
  return static_cast<int64_t>(neg && r ? q - r : r);
}

// (re_hi, re_lo, 0, 0) of a centered value: its f32 split, times 1/scale
__device__ __forceinline__ float4 limb_word(const FftArgs& a, int64_t m) {
  const float hi = __ll2float_rn(m);
  const float lo = __ll2float_rn(m - __float2ll_rz(hi));
  return make_float4(fmul(hi, a.inv_scale), fmul(lo, a.inv_scale), 0.0f,
                     0.0f);
}

// a 4-byte copy from device to shared memory that does not hold the
// thread (cp.async); copy_async_wait() before the block's barrier makes
// the copies visible, so a pass's twiddles load beside its data
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// -- the stages -----------------------------------------------------------

// Every stage of a 2^L-point transform on nsub subproblems in shared
// memory: word j of subproblem s, plane p at buf[p ps + s ss + sw(j)];
// the twiddle of local index i (m_l + g) at tw[p tps + s tss + i].
template <bool Inv>
__device__ void run_stages(float* buf, int ps, int ss, int nsub, int L,
                           const float* tw, int tps, int tss) {
  const int per = 1 << (L - 1);
  const int total = nsub << (L - 1);
  for (int st = 0; st < L; ++st) {
    const int logh = Inv ? st : L - 1 - st;
    const int h = 1 << logh;
    const int ml = per >> logh;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      const int s = b >> (L - 1);
      const int bl = b & (per - 1);
      const int g = bl >> logh;
      const int iu = (g << (logh + 1)) | (bl & (h - 1));
      float* bs = buf + s * ss;
      const int iu_s = sw(iu), iv_s = sw(iu + h);
      CDF u = {{bs[iu_s], bs[ps + iu_s]}, {bs[2 * ps + iu_s], bs[3 * ps + iu_s]}};
      CDF v = {{bs[iv_s], bs[ps + iv_s]}, {bs[2 * ps + iv_s], bs[3 * ps + iv_s]}};
      const float* wt = tw + s * tss + ml + g;
      butterfly(u, v, {{wt[0], wt[tps]}, {wt[2 * tps], wt[3 * tps]}}, Inv);
      bs[iu_s] = u.re.hi;
      bs[ps + iu_s] = u.re.lo;
      bs[2 * ps + iu_s] = u.im.hi;
      bs[3 * ps + iu_s] = u.im.lo;
      bs[iv_s] = v.re.hi;
      bs[ps + iv_s] = v.re.lo;
      bs[2 * ps + iv_s] = v.im.hi;
      bs[3 * ps + iv_s] = v.im.lo;
    }
    __syncthreads();
  }
}

// words 4i .. 4i + 3 of a subproblem's plane (sw keeps an aligned run of
// four together, reversed in an odd run of 32)
__device__ __forceinline__ void put4(float* plane, int j, float4 v) {
  if ((j >> 5) & 1)
    *reinterpret_cast<float4*>(plane + sw(j + 3)) = make_float4(v.w, v.z,
                                                                v.y, v.x);
  else
    *reinterpret_cast<float4*>(plane + j) = v;
}

__device__ __forceinline__ float4 get4(const float* plane, int j) {
  if ((j >> 5) & 1) {
    const float4 v = *reinterpret_cast<const float4*>(plane + sw(j + 3));
    return make_float4(v.w, v.z, v.y, v.x);
  }
  return *reinterpret_cast<const float4*>(plane + j);
}

__device__ __forceinline__ float4 scaled4(float4 v, float s) {
  return s != 0.0f ? make_float4(fmul(v.x, s), fmul(v.y, s), fmul(v.z, s),
                                 fmul(v.w, s))
                   : v;
}

// -- the row pass (and the one-block transform) ---------------------------

// Shared floats of a row block: the planes, then the twiddles.
__host__ __device__ inline int row_subs(int lc) { return lc == 0 ? 1 : kSubs; }

inline int row_smem(int lr, int lc, int k) {
  const int subs = row_subs(lc), r = 1 << lr;
  return 4 * subs * (r + kPad) + 4 * subs * r + (lc == 0 ? 2 * k : 0);
}

// the twiddles of the block's rows: local index i of row r serves the
// stage with m_l groups (m_l the highest power of two <= i), entry
// i + m_l (2^lc + r - 1) of the table
__device__ void row_twiddles(const FftArgs& a, float* sm) {
  const int64_t n = int64_t{1} << a.logn;
  const int subs = row_subs(a.lc), r = 1 << a.lr;
  const int ps = subs * (r + kPad);
  float* tw = sm + 4 * ps;
  const int row0 = blockIdx.x * subs;
  for (int e = threadIdx.x; e < subs * r; e += blockDim.x) {
    const int s = e >> a.lr, i = e & (r - 1);
    if (i == 0) continue;
    const int64_t ml = int64_t{1} << (31 - __clz(i));
    const int64_t gi = i + ml * ((int64_t{1} << a.lc) + row0 + s - 1);
    for (int p = 0; p < 4; ++p)
      copy_async(tw + p * subs * r + s * r + i, a.w + p * n + gi);
  }
}

template <int In, int Out, bool Inv>
__device__ void row_body(const FftArgs& a, float* sm) {
  const int64_t n = int64_t{1} << a.logn;
  const int subs = row_subs(a.lc), r = 1 << a.lr;
  const int ss = r + kPad, ps = subs * ss;
  const int words = subs * r;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * words;
  if (In == kInPlanes && r >= 4) {
#pragma unroll 4
    for (int e = threadIdx.x; e < words; e += blockDim.x) {
      const int p = e / (words / 4), word = 4 * (e % (words / 4));
      put4(sm + p * ps + (word >> a.lr) * ss, word & (r - 1),
           __ldcg(reinterpret_cast<const float4*>(a.x + p * n + base +
                                                  word)));
    }
  } else {
    uint64_t mu1 = 0;
    if (In == kInLimbs && a.rows == 2) mu1 = barrett_mu(a.q1);
    for (int e = threadIdx.x; e < words; e += blockDim.x) {
      float4 v;
      if constexpr (In == kInSlots) {
        v = slot_word(a, base + e);
      } else if constexpr (In == kInLimbs) {
        const uint32_t x0 = static_cast<uint32_t>(__ldcg(a.limbs + base + e));
        const uint32_t x1 = a.rows == 2 ? static_cast<uint32_t>(
            __ldcg(a.limbs + n + base + e)) : 0u;
        v = limb_word(a, centered(a, x0, x1, mu1));
      } else if constexpr (In == kInLimbs64) {
        const uint64_t x0 = static_cast<uint64_t>(__ldcg(a.limbs64 + base + e));
        const uint64_t x1 = a.rows == 2 ? static_cast<uint64_t>(
            __ldcg(a.limbs64 + n + base + e)) : 0ull;
        v = limb_word(a, centered64(a, x0, x1));
      } else {
        v = make_float4(__ldcg(a.x + base + e), __ldcg(a.x + n + base + e),
                        __ldcg(a.x + 2 * n + base + e),
                        __ldcg(a.x + 3 * n + base + e));
      }
      float* b = sm + (e >> a.lr) * ss + sw(e & (r - 1));
      b[0] = v.x;
      b[ps] = v.y;
      b[2 * ps] = v.z;
      b[3 * ps] = v.w;
    }
  }
  copy_async_wait();
  __syncthreads();
  run_stages<Inv>(sm, ps, ss, subs, a.lr, sm + 4 * ps, subs * r, r);
  if (Out == kOutPlanes && r >= 4) {
    for (int e = threadIdx.x; e < words; e += blockDim.x) {
      const int p = e / (words / 4), word = 4 * (e % (words / 4));
      *reinterpret_cast<float4*>(a.y + p * n + base + word) = scaled4(
          get4(sm + p * ps + (word >> a.lr) * ss, word & (r - 1)), a.inv_n);
    }
    return;
  }
  uint64_t* mu = reinterpret_cast<uint64_t*>(sm + 4 * ps + 4 * subs * r);
  if constexpr (Out == kOutResidues) {
    for (int i = threadIdx.x; i < a.k; i += blockDim.x)
      mu[i] = barrett_mu(static_cast<uint32_t>(__ldg(a.q + i)));
    __syncthreads();
  } else if constexpr (Out == kOutResidues64) {
    for (int i = threadIdx.x; i < a.k; i += blockDim.x)
      mu[i] = ~0ull / static_cast<uint64_t>(__ldg(a.q64 + i));
    __syncthreads();
  }
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const float* b = sm + (e >> a.lr) * ss + sw(e & (r - 1));
    const int64_t pos = base + e;
    if constexpr (Out == kOutPlanes) {
      a.y[pos] = a.inv_n != 0.0f ? fmul(b[0], a.inv_n) : b[0];
      a.y[n + pos] = a.inv_n != 0.0f ? fmul(b[ps], a.inv_n) : b[ps];
      a.y[2 * n + pos] = a.inv_n != 0.0f ? fmul(b[2 * ps], a.inv_n) : b[2 * ps];
      a.y[3 * n + pos] = a.inv_n != 0.0f ? fmul(b[3 * ps], a.inv_n) : b[3 * ps];
    } else if constexpr (Out == kOutSlots) {
      const int so = __ldg(a.slot_of + pos);
      if (so >= 0)
        reinterpret_cast<double2*>(a.slots)[so] = make_double2(
            __dadd_rn(static_cast<double>(b[0]), static_cast<double>(b[ps])),
            __dadd_rn(static_cast<double>(b[2 * ps]),
                      static_cast<double>(b[3 * ps])));
    } else if constexpr (Out == kOutResidues64) {
      const int64_t v = round_df(fmul(b[0], a.inv_n), fmul(b[ps], a.inv_n));
      const bool neg = v < 0;
      const uint64_t u = neg ? 0ull - static_cast<uint64_t>(v) : v;
      for (int i = 0; i < a.k; ++i)
        a.res64[i * n + pos] = floor_mod64(
            neg, u, static_cast<uint64_t>(__ldg(a.q64 + i)), mu[i]);
    } else {
      const int64_t v = round_df(fmul(b[0], a.inv_n), fmul(b[ps], a.inv_n));
      for (int i = 0; i < a.k; ++i)
        a.res[i * n + pos] = floor_mod(v, static_cast<uint32_t>(__ldg(a.q + i)),
                                       mu[i]);
    }
  }
}

// -- the column pass -------------------------------------------------------

// Shared floats of a column block: the planes, the twiddles, then (encode)
// the int64 coefficients, the primes' Barrett constants and the primes
// (32- or, wide, 64-bit).
inline int col_smem(int lc, int k, bool residues, bool wide) {
  const int c = 1 << lc;
  return 4 * kSubs * (c + kPad) + 4 * c +
         (residues ? 2 * (kSubs * c + k) + (wide ? 2 : 1) * k : 0);
}

// the column twiddles: local index i is the table's entry i
__device__ void col_twiddles(const FftArgs& a, float* sm) {
  const int64_t n = int64_t{1} << a.logn;
  const int c = 1 << a.lc;
  float* tw = sm + 4 * kSubs * (c + kPad);
  for (int i = threadIdx.x; i < c; i += blockDim.x)
    for (int p = 0; p < 4; ++p) copy_async(tw + p * c + i, a.w + p * n + i);
}

// A column block holds classes 2 b and 2 b + 1 and moves them itself, 8
// bytes a row a plane.  Encode's residues go out through the block's
// cluster of four (eight adjacent classes): each block stages its int64
// coefficients in shared memory, and block `rank` writes rows [rank c/4,
// (rank + 1) c/4) of the cluster's eight classes, one 32-byte sector a
// prime a row, reading class 2 o + t from subproblem t of block o.
template <int In, int Out, bool Inv>
__device__ void col_body(const FftArgs& a, float* sm) {
  const int64_t n = int64_t{1} << a.logn;
  const int c = 1 << a.lc;
  const int ss = c + kPad, ps = kSubs * ss;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kSubs;
  if constexpr (In == kInPlanes) {
#pragma unroll 4
    for (int e = threadIdx.x; e < 4 * c; e += blockDim.x) {
      const int j = e & (c - 1), p = e >> a.lc;
      const float2 v = __ldcg(reinterpret_cast<const float2*>(
          a.x + p * n + c0 + (static_cast<int64_t>(j) << a.lr)));
      sm[p * ps + sw(j)] = v.x;
      sm[p * ps + ss + sw(j)] = v.y;
    }
  } else if constexpr (In == kInLimbs64) {
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
      const int64_t pos = c0 + (static_cast<int64_t>(j) << a.lr);
      const longlong2 x0 =
          __ldcg(reinterpret_cast<const longlong2*>(a.limbs64 + pos));
      const longlong2 x1 = a.rows == 2 ? __ldcg(reinterpret_cast<
          const longlong2*>(a.limbs64 + n + pos)) : make_longlong2(0, 0);
      const float4 w0 = limb_word(a, centered64(a, x0.x, x1.x));
      const float4 w1 = limb_word(a, centered64(a, x0.y, x1.y));
      float* d = sm + sw(j);
      d[0] = w0.x;
      d[ps] = w0.y;
      d[2 * ps] = w0.z;
      d[3 * ps] = w0.w;
      d[ss] = w1.x;
      d[ps + ss] = w1.y;
      d[2 * ps + ss] = w1.z;
      d[3 * ps + ss] = w1.w;
    }
  } else {
    const uint64_t mu1 = a.rows == 2 ? barrett_mu(a.q1) : 0;
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
      const int64_t pos = c0 + (static_cast<int64_t>(j) << a.lr);
      const uint2 x0 = __ldcg(reinterpret_cast<const uint2*>(a.limbs + pos));
      const uint2 x1 = a.rows == 2 ? __ldcg(reinterpret_cast<const uint2*>(
          a.limbs + n + pos)) : make_uint2(0, 0);
      const float4 w0 = limb_word(a, centered(a, x0.x, x1.x, mu1));
      const float4 w1 = limb_word(a, centered(a, x0.y, x1.y, mu1));
      float* d = sm + sw(j);
      d[0] = w0.x;
      d[ps] = w0.y;
      d[2 * ps] = w0.z;
      d[3 * ps] = w0.w;
      d[ss] = w1.x;
      d[ps + ss] = w1.y;
      d[2 * ps + ss] = w1.z;
      d[3 * ps + ss] = w1.w;
    }
  }
  copy_async_wait();
  __syncthreads();
  run_stages<Inv>(sm, ps, ss, kSubs, a.lc, sm + 4 * ps, c, 0);
  if constexpr (Out == kOutPlanes) {
    for (int e = threadIdx.x; e < 4 * c; e += blockDim.x) {
      const int j = e & (c - 1), p = e >> a.lc;
      float2 v = make_float2(sm[p * ps + sw(j)], sm[p * ps + ss + sw(j)]);
      if (a.inv_n != 0.0f)
        v = make_float2(fmul(v.x, a.inv_n), fmul(v.y, a.inv_n));
      *reinterpret_cast<float2*>(a.y + p * n + c0 +
                                 (static_cast<int64_t>(j) << a.lr)) = v;
    }
  } else if constexpr (Out == kOutResidues64) {
    // as below, 16 bytes a prime a row (two adjacent classes' words)
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int rb = c / kClusterBlocks;
    const int64_t cc0 = c0 - rank * kSubs;
    int64_t* v = reinterpret_cast<int64_t*>(sm + 4 * ps + 4 * c);
    uint64_t* mu = reinterpret_cast<uint64_t*>(v + kSubs * c);
    uint64_t* qs = mu + a.k;
    for (int e = threadIdx.x; e < kSubs * c; e += blockDim.x) {
      const float* b = sm + (e >> a.lc) * ss + sw(e & (c - 1));
      v[e] = round_df(fmul(b[0], a.inv_n), fmul(b[ps], a.inv_n));
    }
    for (int i = threadIdx.x; i < a.k; i += blockDim.x) {
      qs[i] = static_cast<uint64_t>(__ldg(a.q64 + i));
      mu[i] = ~0ull / qs[i];
    }
    cluster.sync();
    for (int e = threadIdx.x; e < kClusterBlocks * rb; e += blockDim.x) {
      const int o = e & (kClusterBlocks - 1), j = rank * rb + (e >> 2);
      const int64_t* vo = cluster.map_shared_rank(v, o);
      const int64_t v0 = vo[j], v1 = vo[c + j];
      const bool n0 = v0 < 0, n1 = v1 < 0;
      const uint64_t u0 = n0 ? 0ull - static_cast<uint64_t>(v0) : v0;
      const uint64_t u1 = n1 ? 0ull - static_cast<uint64_t>(v1) : v1;
      int64_t* dst = a.res64 + cc0 + kSubs * o +
                     (static_cast<int64_t>(j) << a.lr);
#pragma unroll 4
      for (int i = 0; i < a.k; ++i)
        *reinterpret_cast<longlong2*>(dst + i * n) =
            make_longlong2(floor_mod64(n0, u0, qs[i], mu[i]),
                           floor_mod64(n1, u1, qs[i], mu[i]));
    }
    cluster.sync();
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int rb = c / kClusterBlocks;
    const int64_t cc0 = c0 - rank * kSubs;  // the cluster's first class
    int64_t* v = reinterpret_cast<int64_t*>(sm + 4 * ps + 4 * c);
    uint64_t* mu = reinterpret_cast<uint64_t*>(v + kSubs * c);
    uint32_t* qs = reinterpret_cast<uint32_t*>(mu + a.k);
    for (int e = threadIdx.x; e < kSubs * c; e += blockDim.x) {
      const float* b = sm + (e >> a.lc) * ss + sw(e & (c - 1));
      v[e] = round_df(fmul(b[0], a.inv_n), fmul(b[ps], a.inv_n));
    }
    for (int i = threadIdx.x; i < a.k; i += blockDim.x) {
      qs[i] = static_cast<uint32_t>(__ldg(a.q + i));
      mu[i] = barrett_mu(qs[i]);
    }
    cluster.sync();  // every block's coefficients are staged
    for (int e = threadIdx.x; e < kClusterBlocks * rb; e += blockDim.x) {
      const int o = e & (kClusterBlocks - 1), j = rank * rb + (e >> 2);
      const int64_t* vo = cluster.map_shared_rank(v, o);
      const int64_t v0 = vo[j], v1 = vo[c + j];
      // floor_mod with the signs and magnitudes taken once, outside the
      // loop over the primes
      const bool n0 = v0 < 0, n1 = v1 < 0;
      const uint64_t u0 = n0 ? 0ull - static_cast<uint64_t>(v0) : v0;
      const uint64_t u1 = n1 ? 0ull - static_cast<uint64_t>(v1) : v1;
      int32_t* dst = a.res + cc0 + kSubs * o +
                     (static_cast<int64_t>(j) << a.lr);
#pragma unroll 4
      for (int i = 0; i < a.k; ++i) {
        const uint32_t q = qs[i];
        const uint32_t r0 = reduce(u0, q, mu[i]), r1 = reduce(u1, q, mu[i]);
        *reinterpret_cast<int2*>(dst + i * n) = make_int2(
            static_cast<int32_t>(n0 && r0 ? q - r0 : r0),
            static_cast<int32_t>(n1 && r1 ? q - r1 : r1));
      }
    }
    cluster.sync();  // no block leaves while its shared memory is read
  }
}

// -- the kernels -----------------------------------------------------------

// One pass: its twiddles, then (second pass under PDL) the wait for the
// first pass's results, then the pass.  The first pass lets the second
// start at once; griddepcontrol is a no-op outside a dependent launch.
template <int In, int Out, bool Inv>
__global__ void __launch_bounds__(kFftThreads)
ckks_fft_row_kernel(FftArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  asm volatile("griddepcontrol.launch_dependents;");
  row_twiddles(a, sm);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  row_body<In, Out, Inv>(a, sm);
}

template <int In, int Out, bool Inv>
__global__ void __launch_bounds__(kFftThreads)
ckks_fft_col_kernel(FftArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  asm volatile("griddepcontrol.launch_dependents;");
  col_twiddles(a, sm);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  col_body<In, Out, Inv>(a, sm);
}

// -- launches --------------------------------------------------------------

// the launches of the last call and the blocks of the first kMaxGrids
int g_grids[kMaxGrids];
int g_launches = 0;

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, int smem_floats, bool cluster,
                   bool dependent, cudaStream_t stream, Args... args) {
  const int smem = smem_floats * static_cast<int>(sizeof(float));
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)  // past the default, only after opting in
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[2];
  int na = 0;
  if (cluster) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = kClusterBlocks;
    attr[na].val.clusterDim.y = 1;
    attr[na].val.clusterDim.z = 1;
    ++na;
  }
  if (dependent) {
    attr[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[na].val.programmaticStreamSerializationAllowed = 1;
    ++na;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kFftThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = na;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (g_launches < kMaxGrids) g_grids[g_launches] = blocks;
  ++g_launches;
  return e;
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// One form: A then B, each FftArgs filled but for the geometry.  Up to
// 2^11 one row block (In = InA, Out = OutB) runs every stage; above, the
// column and the row pass, the second under PDL.
template <int InA, int OutA, int InB, int OutB, bool Inv>
cudaError_t run_form(FftArgs a, FftArgs b, int n, int k,
                     cudaStream_t stream) {
  g_launches = 0;
  const int logn = log2_of(n);
  if (n < 2 || (1 << logn) != n || logn > 2 * kLogMaxSub)
    return cudaErrorInvalidValue;
  const float inv_n = 1.0f / static_cast<float>(n);
  if (logn <= kLogOneBlock) {
    FftArgs one = a;
    one.y = b.y;
    one.slots = b.slots;
    one.res = b.res;
    one.q = b.q;
    one.res64 = b.res64;
    one.q64 = b.q64;
    one.k = b.k;
    one.logn = logn;
    one.lr = logn;
    one.lc = 0;
    one.inv_n = Inv ? inv_n : 0.0f;
    return launch(ckks_fft_row_kernel<InA, OutB, Inv>, 1,
                  row_smem(logn, 0, k), false, false, stream, one);
  }
  const int lr = logn / 2, lc = logn - lr;
  a.logn = b.logn = logn;
  a.lr = b.lr = lr;
  a.lc = b.lc = lc;
  a.inv_n = 0.0f;
  b.inv_n = Inv ? inv_n : 0.0f;
  const int col_blocks = 1 << (lr - 1), row_blocks = 1 << (lc - 1);
  // encode's column pass writes its residues through clusters of four
  const bool residues = OutB == kOutResidues || OutB == kOutResidues64;
  const int cw = col_smem(lc, k, residues, OutB == kOutResidues64);
  const int rw = row_smem(lr, lc, 0);
  cudaError_t e =
      Inv ? launch(ckks_fft_row_kernel<InA, OutA, Inv>, row_blocks, rw,
                   false, false, stream, a)
          : launch(ckks_fft_col_kernel<InA, OutA, Inv>, col_blocks, cw, false,
                   false, stream, a);
  if (e != cudaSuccess) return e;
  return Inv ? launch(ckks_fft_col_kernel<InB, OutB, Inv>, col_blocks, cw,
                      residues, true, stream, b)
             : launch(ckks_fft_row_kernel<InB, OutB, Inv>, row_blocks, rw,
                      false, true, stream, b);
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// F1, the bare transform: x (4, n) f32 planes -> y (4, n); w the (4, n)
// twiddle table of the direction (psi^rev forward, psi^-rev inverse); n a
// power of two in [2, 2^22].  y is also the intermediate of the passes.
int ptk_ckks_fft(const void* x, const void* w, void* y, int n, int inverse,
                 void* stream) {
  FftArgs a = {};
  a.w = static_cast<const float*>(w);
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  FftArgs b = a;
  b.x = a.y;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      inverse ? run_form<kInPlanes, kOutPlanes, kInPlanes, kOutPlanes, true>(
                    a, b, n, 0, st)
              : run_form<kInPlanes, kOutPlanes, kInPlanes, kOutPlanes, false>(
                    a, b, n, 0, st));
}

// F1's encode form: z (count, 2) float64 slot values at `scale` -> res
// (k, n) int32 residues modulo q (k,); slot_of (n,) int32; w the inverse
// table; scratch (4, n) f32 between the passes.
int ptk_ckks_fft_encode(const void* z, int count, double scale,
                        const void* q, int k, const void* slot_of,
                        const void* w, void* scratch, void* res, int n,
                        void* stream) {
  FftArgs a = {};
  a.w = static_cast<const float*>(w);
  a.slot_of = static_cast<const int32_t*>(slot_of);
  a.z = static_cast<const double*>(z);
  a.count = count;
  a.scale = scale;
  a.y = static_cast<float*>(scratch);
  FftArgs b = a;
  b.x = a.y;
  b.res = static_cast<int32_t*>(res);
  b.q = static_cast<const int32_t*>(q);
  b.k = k;
  return static_cast<int>(
      run_form<kInSlots, kOutPlanes, kInPlanes, kOutResidues, true>(
          a, b, n, k, static_cast<cudaStream_t>(stream)));
}

// F1's decode form: limbs (rows, n) int32, the coefficient-form limbs 0
// (and 1) modulo q0 (and q1; qinv = q0^-1 mod q1), at 1/scale = inv_scale
// -> out (n/2, 2) float64 slot values; w the forward table.
int ptk_ckks_fft_decode(const void* limbs, int rows, int q0, int q1,
                        int qinv, float inv_scale, const void* slot_of,
                        const void* w, void* scratch, void* out, int n,
                        void* stream) {
  FftArgs a = {};
  a.w = static_cast<const float*>(w);
  a.slot_of = static_cast<const int32_t*>(slot_of);
  a.limbs = static_cast<const int32_t*>(limbs);
  a.rows = rows;
  a.q0 = static_cast<uint32_t>(q0);
  a.q1 = static_cast<uint32_t>(q1);
  a.qinv = static_cast<uint32_t>(qinv);
  a.inv_scale = inv_scale;
  a.y = static_cast<float*>(scratch);
  FftArgs b = a;
  b.x = a.y;
  b.slots = static_cast<double*>(out);
  return static_cast<int>(
      run_form<kInLimbs, kOutPlanes, kInPlanes, kOutSlots, false>(
          a, b, n, 0, static_cast<cudaStream_t>(stream)));
}

// F1's wide encode form: as ptk_ckks_fft_encode, into res (k, n) int64
// residues modulo q (k,) int64 primes below 2^61.
int ptk_ckks_fft_encode64(const void* z, int count, double scale,
                          const void* q, int k, const void* slot_of,
                          const void* w, void* scratch, void* res, int n,
                          void* stream) {
  FftArgs a = {};
  a.w = static_cast<const float*>(w);
  a.slot_of = static_cast<const int32_t*>(slot_of);
  a.z = static_cast<const double*>(z);
  a.count = count;
  a.scale = scale;
  a.y = static_cast<float*>(scratch);
  FftArgs b = a;
  b.x = a.y;
  b.res64 = static_cast<int64_t*>(res);
  b.q64 = static_cast<const int64_t*>(q);
  b.k = k;
  return static_cast<int>(
      run_form<kInSlots, kOutPlanes, kInPlanes, kOutResidues64, true>(
          a, b, n, k, static_cast<cudaStream_t>(stream)));
}

// F1's wide decode form: limbs (rows, n) int64 words modulo q0 (and q1;
// qinv = q0^-1 mod q1, qinv_shoup = floor(qinv 2^64 / q1), mu1 =
// floor(2^64 / q1)), at 1/scale = inv_scale -> out (n/2, 2) float64.
int ptk_ckks_fft_decode64(const void* limbs, int rows, uint64_t q0,
                          uint64_t q1, uint64_t qinv, uint64_t qinv_shoup,
                          uint64_t mu1, float inv_scale, const void* slot_of,
                          const void* w, void* scratch, void* out, int n,
                          void* stream) {
  FftArgs a = {};
  a.w = static_cast<const float*>(w);
  a.slot_of = static_cast<const int32_t*>(slot_of);
  a.limbs64 = static_cast<const int64_t*>(limbs);
  a.rows = rows;
  a.q0w = q0;
  a.q1w = q1;
  a.qinvw = qinv;
  a.qinv_shoup = qinv_shoup;
  a.mu1w = mu1;
  a.inv_scale = inv_scale;
  a.y = static_cast<float*>(scratch);
  FftArgs b = a;
  b.x = a.y;
  b.slots = static_cast<double*>(out);
  return static_cast<int>(
      run_form<kInLimbs64, kOutPlanes, kInPlanes, kOutSlots, false>(
          a, b, n, 0, static_cast<cudaStream_t>(stream)));
}

// The blocks of each CUDA launch the last call of any form made, into
// blocks[0..cap) (the first 8 at most); returns the number of launches.
int ptk_ckks_fft_grids(int* blocks, int cap) {
  for (int i = 0; i < g_launches && i < cap && i < kMaxGrids; ++i)
    blocks[i] = g_grids[i];
  return g_launches;
}

}  // extern "C"

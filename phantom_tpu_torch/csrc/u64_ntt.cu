// U1: the negacyclic NTT over u64 primes (q < 2^61), forward and inverse.
//
// Replaces the JAX package's u64 NTT, phantom_tpu/ops/ntt.py:101
// ntt_forward and :151 ntt_inverse, which run as XLA fusions (stage loops
// over a (..., L, m, 2, t) view of emulated u64, no pallas_call).
// Forward: Cooley-Tukey stages s = 0 .. logn-1 (m = 2^s groups, pair
// distance N >> (s+1), twiddle tw[m + group]), Harvey-lazy in [0, 4q),
// output reduced to [0, q).  Inverse: Gentleman-Sande stages s = logn-1
// .. 0 from [0, 2q), then one Shoup multiply by the per-row scale
// (N^-1 or a folded one) to [0, q).
//
// A row of N = 2^16 words is 512 KiB, more than a block holds, so the
// stages run in passes of at most ten.  The stages [s0, s1) of one pass
// only pair words that share the index bits above logn - s0 (the chunk)
// and below logn - s1 (the lane): each such set of 2^(s1 - s0) words is
// an independent subproblem.  A block loads R lanes of one chunk (R
// consecutive words per load, so the loads coalesce), 1024 words in
// 8 KiB of shared memory, runs the pass's stages there and stores them
// back in place.  At N = 2^16 the forward runs six stages on lanes 1024
// words apart, then ten on contiguous 1024-word chunks; the inverse the
// same passes the other way round.  Each launch is one pass over every
// row; the wrapper launches ceil(logn / 10) of them.  Every row takes its
// table row from `rows`, so a transform of any subset of a base needs no
// copied tables.

#include "modarith64.cuh"

namespace ptk64 {
namespace {

constexpr int kPassWords = 1024;
constexpr int kPassStages = 10;
constexpr int kThreads = 512;

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
ntt_pass_kernel(uint64_t* out, const uint64_t* x, const uint64_t* q_all,
                const uint64_t* tw, const uint64_t* tws, const int32_t* rows,
                const uint64_t* scale, const uint64_t* scale_shoup,
                int num_l, int logn, int s0, int s1, int rlog, int last) {
  __shared__ uint64_t sm[kPassWords];
  const int64_t n = int64_t{1} << logn;
  const int row = blockIdx.y;  // (group, limb) flattened
  const int limb = row % num_l;
  const int tr = rows[limb];
  const uint64_t q = q_all[tr];
  const uint64_t q2 = 2 * q;
  const uint64_t* w_row = tw + static_cast<int64_t>(tr) * n;
  const uint64_t* ws_row = tws + static_cast<int64_t>(tr) * n;
  const int k = s1 - s0;
  const int lanes = 1 << rlog;            // R
  const int words = lanes << k;           // P R
  const int lane_groups = 1 << (logn - s1 - rlog);
  const int chunk = blockIdx.x / lane_groups;
  const int lane0 = (blockIdx.x % lane_groups) << rlog;
  const int64_t base = static_cast<int64_t>(row) * n +
                       (static_cast<int64_t>(chunk) << (logn - s0)) + lane0;
  const int sub_shift = logn - s1;        // a subproblem step in words
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    sm[i] = x[base + (static_cast<int64_t>(i >> rlog) << sub_shift) +
              (i & (lanes - 1))];
  }
  __syncthreads();
  for (int step = 0; step < k; ++step) {
    const int ls = kInverse ? k - 1 - step : step;   // local stage
    const int h = 1 << (k - 1 - ls);                 // pair distance in s
    const int m = 1 << (s0 + ls);
    for (int b = threadIdx.x; b < words / 2; b += blockDim.x) {
      const int lane = b & (lanes - 1);
      const int bi = b >> rlog;
      const int grp = bi / h;
      const int s_lo = grp * 2 * h + bi % h;
      const int lo = (s_lo << rlog) + lane;
      const int hi = lo + (h << rlog);
      const int i = (chunk << ls) + grp;
      const uint64_t w = w_row[m + i], ws = ws_row[m + i];
      const uint64_t u = sm[lo], v = sm[hi];
      if (kInverse) {
        uint64_t s = u + v;
        s = s >= q2 ? s - q2 : s;
        sm[lo] = s;
        sm[hi] = shoup_lazy(u - v + q2, w, ws, q);
      } else {
        const uint64_t uu = u >= q2 ? u - q2 : u;
        const uint64_t wv = shoup_lazy(v, w, ws, q);
        sm[lo] = uu + wv;
        sm[hi] = uu - wv + q2;
      }
    }
    __syncthreads();
  }
  const uint64_t sc = last && kInverse ? scale[limb] : 0;
  const uint64_t scs = last && kInverse ? scale_shoup[limb] : 0;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    uint64_t v = sm[i];
    if (last) {
      v = kInverse ? shoup(v, sc, scs, q) : csub(csub(v, q2), q);
    }
    out[base + (static_cast<int64_t>(i >> rlog) << sub_shift) +
        (i & (lanes - 1))] = v;
  }
}

}  // namespace
}  // namespace ptk64

using namespace ptk64;

extern "C" {

// U1.  out, x: (groups, num_l, 2^logn) words; q: the base's moduli; tw,
// tws: (base rows, N) twiddles and Shoup words (forward or inverse
// tables); rows: (num_l,) table row of each limb; scale, scale_shoup:
// (num_l,) the inverse's final factor (null for the forward).
int ptk_u64_ntt(void* out, const void* x, const void* q, const void* tw,
                const void* tws, const void* rows, const void* scale,
                const void* scale_shoup, int groups, int num_l, int logn,
                int inverse, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // passes of at most ten stages, the shortest first in stage order
  int bounds[8];
  int np = 0;
  bounds[np++] = 0;
  int first = logn % kPassStages;
  if (first == 0) first = logn < kPassStages ? logn : kPassStages;
  for (int s = first; s <= logn; s += kPassStages) bounds[np++] = s;
  const int passes = np - 1;
  for (int p = 0; p < passes; ++p) {
    const int idx = inverse ? passes - 1 - p : p;
    const int s0 = bounds[idx], s1 = bounds[idx + 1];
    const int k = s1 - s0;
    int rlog = 0;
    while (rlog + k < kPassStages && rlog < logn - s1) ++rlog;
    const int blocks = (1 << s0) * (1 << (logn - s1 - rlog));
    const dim3 grid(blocks, groups * num_l);
    const bool last = p == passes - 1;
    const uint64_t* src = static_cast<const uint64_t*>(p == 0 ? x : out);
    if (inverse) {
      ntt_pass_kernel<true><<<grid, kThreads, 0, st>>>(
          static_cast<uint64_t*>(out), src, static_cast<const uint64_t*>(q),
          static_cast<const uint64_t*>(tw), static_cast<const uint64_t*>(tws),
          static_cast<const int32_t*>(rows),
          static_cast<const uint64_t*>(scale),
          static_cast<const uint64_t*>(scale_shoup), num_l, logn, s0, s1,
          rlog, last);
    } else {
      ntt_pass_kernel<false><<<grid, kThreads, 0, st>>>(
          static_cast<uint64_t*>(out), src, static_cast<const uint64_t*>(q),
          static_cast<const uint64_t*>(tw), static_cast<const uint64_t*>(tws),
          static_cast<const int32_t*>(rows), nullptr, nullptr, num_l, logn,
          s0, s1, rlog, last);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

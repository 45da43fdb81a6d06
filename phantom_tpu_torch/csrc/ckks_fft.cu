// F1: the CKKS special FFT in double-float (two-f32) arithmetic, forward
// (Cooley-Tukey) and inverse (Gentleman-Sande, with the 1/n scale).
//
// Not a TPU kernel: the JAX package runs phantom_tpu/ops/ckks_fft.py's
// fft_forward / fft_inverse as XLA fusions.  Its plain version is
// phantom_tpu_torch/ops/ckks_fft.py's, which evaluates every f32 operation
// of the error-free transformations (two_sum, quick_two_sum, the Veltkamp
// split, two_prod) one by one; this kernel equals it bit for bit.  So every
// f32 operation here is an explicit __fadd_rn / __fsub_rn / __fmul_rn,
// which the compiler never contracts into an FMA: a fused x0 y1 + e in
// df_mul's cross terms would round once where the plain version rounds
// twice and change the lo word (chip_smoke.py counts FFMA in the SASS of
// both kernels and requires none).
//
// The vector is (4, n) f32 planes re_hi, re_lo, im_hi, im_lo; the twiddle
// table has the same layout, entry m + g serving group g of the stage with
// m groups.  A 2^16-point vector is 1 MiB, more than a block's shared
// memory, so the transform is split by the butterfly distance h:
//   h >= kTile: one launch per stage, one thread per butterfly, in place
//               in device memory (5 launches at n = 2^16);
//   h <  kTile: every remaining stage in one launch, each block holding
//               kTile consecutive words (32 KB) in shared memory, which
//               are all that those stages' butterflies touch.
// The forward transform runs the wide stages first, the inverse last.  It
// is bound by the device-memory round trips of the wide stages and by the
// f32 operations of the butterflies (about 430 a butterfly).

#include <cuda_runtime.h>
#include <cstdint>

namespace ptk {
namespace {

constexpr int kFftThreads = 256;
constexpr int kLogTile = 11;
constexpr int kTile = 1 << kLogTile;

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

// plane p of element i of a (4, n) array
__device__ __forceinline__ CDF load(const float* x, int64_t n, int64_t i) {
  return {{x[i], x[n + i]}, {x[2 * n + i], x[3 * n + i]}};
}

__device__ __forceinline__ void store(float* x, int64_t n, int64_t i, CDF v) {
  x[i] = v.re.hi;
  x[n + i] = v.re.lo;
  x[2 * n + i] = v.im.hi;
  x[3 * n + i] = v.im.lo;
}

__device__ __forceinline__ CDF scaled(CDF v, float s) {
  return {{fmul(v.re.hi, s), fmul(v.re.lo, s)},
          {fmul(v.im.hi, s), fmul(v.im.lo, s)}};
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

// one stage of distance h = 2^logh over the whole vector, in place; the
// last inverse stage also applies the 1/n scale (inv_n != 0)
__global__ void __launch_bounds__(kFftThreads)
fft_stage_kernel(float* x, const float* w, int n, int logh, int inverse,
                 float inv_n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n / 2) return;
  const int half = 1 << logh;
  const int g = b >> logh;
  const int iu = (g << (logh + 1)) | (b & (half - 1));
  const int m = n >> (logh + 1);
  CDF u = load(x, n, iu), v = load(x, n, iu + half);
  butterfly(u, v, load(w, n, m + g), inverse != 0);
  if (inv_n != 0.0f) {
    u = scaled(u, inv_n);
    v = scaled(v, inv_n);
  }
  store(x, n, iu, u);
  store(x, n, iu + half, v);
}

// every stage of distance below 2^logt on blocks of 2^logt consecutive
// words in shared memory: forward from the widest down to 1, inverse from
// 1 up; the inverse applies the 1/n scale on the way out when inv_n != 0
__global__ void __launch_bounds__(kFftThreads)
fft_local_kernel(float* x, const float* w, int n, int logt, int inverse,
                 float inv_n) {
  __shared__ float s[4][kTile];
  const int t = 1 << logt;
  const int base = blockIdx.x * t;
  for (int i = threadIdx.x; i < t; i += blockDim.x)
    for (int p = 0; p < 4; ++p) s[p][i] = x[static_cast<int64_t>(p) * n + base + i];
  __syncthreads();
  for (int st = 0; st < logt; ++st) {
    const int logh = inverse ? st : logt - 1 - st;
    const int half = 1 << logh;
    const int m = n >> (logh + 1);
    for (int b = threadIdx.x; b < t / 2; b += blockDim.x) {
      const int gl = b >> logh;
      const int iu = (gl << (logh + 1)) | (b & (half - 1));
      const int iv = iu + half;
      CDF u = {{s[0][iu], s[1][iu]}, {s[2][iu], s[3][iu]}};
      CDF v = {{s[0][iv], s[1][iv]}, {s[2][iv], s[3][iv]}};
      butterfly(u, v, load(w, n, m + (base >> (logh + 1)) + gl),
                inverse != 0);
      s[0][iu] = u.re.hi; s[1][iu] = u.re.lo;
      s[2][iu] = u.im.hi; s[3][iu] = u.im.lo;
      s[0][iv] = v.re.hi; s[1][iv] = v.re.lo;
      s[2][iv] = v.im.hi; s[3][iv] = v.im.lo;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < t; i += blockDim.x)
    for (int p = 0; p < 4; ++p) {
      const float v = s[p][i];
      x[static_cast<int64_t>(p) * n + base + i] =
          inv_n != 0.0f ? fmul(v, inv_n) : v;
    }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// F1, in place.  x: (4, n) f32 planes; w: the (4, n) twiddle table of the
// direction (psi^rev forward, psi^-rev inverse); n a power of two >= 2.
int ptk_ckks_fft(void* x, const void* w, int n, int inverse, void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const int logt = logn < kLogTile ? logn : kLogTile;
  const float inv_n = 1.0f / static_cast<float>(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* xf = static_cast<float*>(x);
  const float* wf = static_cast<const float*>(w);
  const int stage_blocks = (n / 2 + kFftThreads - 1) / kFftThreads;
  const int tiles = n >> logt;
  if (!inverse) {
    for (int logh = logn - 1; logh >= logt; --logh) {
      fft_stage_kernel<<<stage_blocks, kFftThreads, 0, st>>>(
          xf, wf, n, logh, 0, 0.0f);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    fft_local_kernel<<<tiles, kFftThreads, 0, st>>>(xf, wf, n, logt, 0, 0.0f);
    return static_cast<int>(cudaGetLastError());
  }
  fft_local_kernel<<<tiles, kFftThreads, 0, st>>>(
      xf, wf, n, logt, 1, logt == logn ? inv_n : 0.0f);
  cudaError_t e = cudaGetLastError();
  for (int logh = logt; logh < logn && e == cudaSuccess; ++logh) {
    fft_stage_kernel<<<stage_blocks, kFftThreads, 0, st>>>(
        xf, wf, n, logh, 1, logh == logn - 1 ? inv_n : 0.0f);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

}  // extern "C"

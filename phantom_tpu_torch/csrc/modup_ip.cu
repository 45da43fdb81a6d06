// K4: modup fused with the evaluation-key inner product.
//
// Replaces phantom_tpu/ops/ntt_mxu_pallas.py:modup_ip_mxu_pallas (body
// _modup_ip_kernel).  For QlP row j (modulus q_j) and key half h:
//   out[h, j] = sum_d T_d[j] * evk[d, h, j]  mod q_j,
//   T_d[j] = NTT_j(sum_i y[d alpha + i] * mat[d, j, i] mod q_j)
// except inside digit d (d alpha <= j < min((d+1) alpha, k_data)), where
// T_d[j] is the NTT-form passthrough row a[j], or a[j] b[j] mod q_j (the
// fused tensor product of the CKKS step).  With a null, the coefficient
// form (the TPU kernel's c2_ntt=None, BFV's relinearization), there is no
// passthrough: every (d, j) pair converts and transforms, the digit's own
// rows through the qhat diagonal the caller puts in mat, and launch A
// stores every row.  With mat null, the preconv form (the TPU kernel's
// preconv=True, the CKKS step's "xla" modup route): y is the (beta, k_out,
// N) delta that K5 already converted per digit, and the prologue loads
// delta[d, j] in place of the dot product; digit d's own rows of delta are
// never read.  The digit sum is exact: a 64-bit low word and a carry
// count per element, one 128-bit reduction at the end.
//
// The TPU kernel carries the digit sum in VMEM across its sequential grid
// axis; CUDA blocks run in no order, so here one block owns a 4096-word
// chunk of row j and loops over the digits itself.  A 2^16-point row does
// not fit shared memory, so the transform keeps ntt_core.cuh's two passes:
//   launch A (N > 4096): the column pass with the conversion prologue, for
//     every (d, j) outside digit d, into a (beta, k_out, N) scratch (a
//     digit's own rows are neither converted nor stored);
//   launch B: per (chunk, j), for each digit the chunk stages in shared
//     memory (or the passthrough row), times the evk chunk, accumulated in
//     registers; then the reduction and the store of both halves.
// The scratch round trip (263 rows, 2 x 69 MB at N = 2^16, beta = 6,
// k_out = 51, k_data = 43) is traffic the TPU kernel does not have; with it
// the kernel moves about 1.6 times its compulsory bytes (evk, y, the
// passthrough rows, the output).  It is bound by device memory either way.
// The preconv form at the CKKS headline (beta 2, k_out 65, alpha 22,
// k_data 43) reads 87 delta rows (23 MB), the pair's 43 digit rows twice
// (23 MB), the evk (68 MB) and the 65 twiddle rows with their Shoup words
// (34 MB), and writes 34 MB; its scratch round trip (87 rows, 2 x 23 MB)
// is the known cost over that.

#include "ntt_core.cuh"

namespace ptk {
namespace {

constexpr int kPer = kTile / kThreads;  // chunk words per thread

struct ModupArgs {
  const uint32_t* y;    // (beta * alpha, N) pre-scaled iNTT rows, or with
                        // mat null the (beta, k_out, N) converted delta
  const uint32_t* mat;  // (beta, k_out, alpha), null in the preconv form
  const uint32_t* a;    // (beta * alpha, N) NTT-form passthrough rows
  const uint32_t* b;    // optional: the passthrough is a * b mod q
  const uint32_t* evk;  // (beta, 2, k_out, N)
  int alpha, beta, k_out, k_data;

  // the coefficient form (a null) has no passthrough rows
  __device__ __forceinline__ bool in_digit(int d, int j) const {
    return a != nullptr && j >= d * alpha &&
           j < min((d + 1) * alpha, k_data);
  }

  __device__ __forceinline__ uint32_t convert(int d, int j, int64_t gi,
                                              int n, const Barrett& bq) const {
    if (mat == nullptr)  // preconv: converted already, lazy [0, 2 q_j)
      return csub(y[(static_cast<int64_t>(d) * k_out + j) * n + gi], bq.q);
    return dot_mod(y + static_cast<int64_t>(d) * alpha * n + gi, n,
                   mat + (static_cast<int64_t>(d) * k_out + j) * alpha, alpha,
                   bq);
  }

  __device__ __forceinline__ uint32_t passthrough(int j, int64_t gi, int n,
                                                  const Barrett& bq) const {
    const int64_t o = static_cast<int64_t>(j) * n + gi;
    return b == nullptr ? a[o] : mul_mod(a[o], b[o], bq);
  }

  // the column pass's prologue (fwd_col_kernel, group g = digit); launch B
  // never reads a digit's own rows from the scratch, so they are not stored
  static constexpr bool kStoreSkipped = false;
  __device__ __forceinline__ bool skip(int j, int g) const {
    return in_digit(g, j);
  }
  __device__ __forceinline__ uint32_t load(int, int j, int g, int64_t gi,
                                           int n, const Barrett& bq,
                                           bool) const {
    return convert(g, j, gi, n, bq);
  }
};

// Launch B: one block per (chunk, j), the digit loop inside.
__global__ void __launch_bounds__(kThreads)
modup_ip_chunk_kernel(ModupArgs m, NttTables tb, Geometry G,
                      const uint32_t* scratch, uint32_t* out) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, j = blockIdx.y;
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const uint32_t* w = tb.w + static_cast<int64_t>(limb) * G.n;
  const uint32_t* ws = tb.ws + static_cast<int64_t>(limb) * G.n;
  const int64_t base = static_cast<int64_t>(tile) * G.n2;
  const int64_t half = static_cast<int64_t>(m.k_out) * G.n;
  const bool single = G.n1 == 1;
  uint64_t lo[2][kPer] = {};
  uint32_t hi[2][kPer] = {};
  for (int d = 0; d < m.beta; ++d) {
    const uint32_t* ev =
        m.evk + (static_cast<int64_t>(2 * d) * m.k_out + j) * G.n + base;
    if (m.in_digit(d, j)) {  // uniform over the block
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (e < G.n2) {
          const uint32_t t = m.passthrough(j, base + e, G.n, bq);
          mac(lo[0][i], hi[0][i], t, ev[e]);
          mac(lo[1][i], hi[1][i], t, ev[half + e]);
        }
      }
      continue;
    }
    const uint32_t* sc =
        scratch + (static_cast<int64_t>(d) * m.k_out + j) * G.n + base;
    for (int e = threadIdx.x; e < G.n2; e += blockDim.x)
      s[e] = single ? m.convert(d, j, base + e, G.n, bq) : sc[e];
    __syncthreads();
    for (int mm = G.n1; mm < G.n; mm <<= 1)
      chunk_stage<false>(s, G, tile, mm, w, ws, bq.q);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < G.n2) {
        mac(lo[0][i], hi[0][i], s[e], ev[e]);
        mac(lo[1][i], hi[1][i], s[e], ev[half + e]);
      }
    }
    __syncthreads();  // s is rewritten by the next digit
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < G.n2) {
      const int64_t o = static_cast<int64_t>(j) * G.n + base + e;
      out[o] = reduce128(hi[0][i], lo[0][i], bq);
      out[half + o] = reduce128(hi[1][i], lo[1][i], bq);
    }
  }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// K4.  out: (2, k_out, N); scratch: (beta, k_out, N), used when N > 4096;
// y, a, b: (beta * alpha, N), b may be null, and a too (the coefficient
// form); mat: (beta, k_out, alpha), or null for the preconv form, where y
// is the (beta, k_out, N) delta;
// evk: (beta, 2, k_out, N); q, w, ws: the whole base's forward tables; rows:
// (k_out,) table row of each output row.
int ptk_modup_ip(void* out, void* scratch, const void* y, const void* mat,
                 const void* a, const void* b, const void* evk, int beta,
                 int alpha, int k_out, int k_data, const void* q,
                 const void* w, const void* ws, const void* rows, int logn,
                 void* stream) {
  const Geometry G = make_geometry(logn);
  const NttTables tb{static_cast<const uint32_t*>(q),
                     static_cast<const uint32_t*>(w),
                     static_cast<const uint32_t*>(ws),
                     static_cast<const int32_t*>(rows), k_out};
  const ModupArgs m{static_cast<const uint32_t*>(y),
                    static_cast<const uint32_t*>(mat),
                    static_cast<const uint32_t*>(a),
                    static_cast<const uint32_t*>(b),
                    static_cast<const uint32_t*>(evk),
                    alpha,
                    beta,
                    k_out,
                    k_data};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  if (G.n1 > 1)
    fwd_col_kernel<ModupArgs>
        <<<dim3(G.n1, beta * k_out), kThreads, 0, st>>>(m, tb, G, sc);
  modup_ip_chunk_kernel<<<dim3(G.n1, k_out), kThreads, 0, st>>>(
      m, tb, G, sc, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// K4: modup fused with the evaluation-key inner product, one launch per
// call, in its three forms.
//
// Replaces phantom_tpu/ops/ntt_mxu_pallas.py:modup_ip_mxu_pallas (body
// _modup_ip_kernel).  For QlP row j (modulus q_j) and key half h:
//   out[h, j] = sum_d T_d[j] * evk[d, h, j]  mod q_j,
//   T_d[j] = NTT_j(sum_i y[d alpha + i] * mat[d, j, i] mod q_j),
// the sum over the digit's rows below k_data (a short last digit needs no
// zero rows), except inside digit d (d alpha <= j < min((d+1) alpha,
// k_data)), where T_d[j] is the NTT-form passthrough row a[j], or a[j] b[j]
// mod q_j (the fused tensor product of the CKKS step).  With a null, the
// coefficient form (the TPU kernel's c2_ntt=None, BFV's relinearization):
// no passthrough, every (d, j) pair converts and transforms, the digit's
// own rows through the qhat diagonal the caller puts in mat.  With mat
// null, the preconv form (the TPU kernel's preconv=True, the CKKS step's
// "xla" modup route): y is the (beta, k_out, N) delta that K5 already
// converted per digit, and the prologue loads delta[d, j] (lazy [0, 2q))
// in place of the product-sum; a digit's own rows of delta are never read.
//
// The TPU kernel carries the digit sum in VMEM across its sequential grid
// axis.  Here one thread-block cluster owns output row j whole
// (ntt_cluster.cuh) and loops over the digits itself: per digit its blocks
// convert their shares straight into shared memory, the cluster transforms
// the row, and each thread multiplies its words by its share of evk[d, 0,
// j] and evk[d, 1, j] (16-byte loads, each evk word read once) into the
// digit sums; a passthrough digit skips the transform.  The modup tensor T
// never exists in device memory, and no scratch does.  The digit sums are
// residues in shared memory after the share (2 S words), each reduced
// after every digit, so they are exact for any beta and cost no
// registers: a block stays within 64 registers and two 512-thread blocks
// (2 x 99 KB at S = 8192) share an SM, so one cluster's barriers overlap
// another's work.  The 64-bit sums in registers that came first needed 128
// registers and spilled, one block per SM, and took 17-37% longer
// (PERF.md).
//
// Bound: device memory.  At alpha 8 (beta 6, k_out 51, k_data 43, N =
// 2^16) the compulsory bytes are the evk 160 MB, y 11 MB, the passthrough
// pair 22.5 MB, the output 26.7 MB and 51 table rows with Shoup words 26.7
// MB: 247 MB, 0.074 ms at 3.35 TB/s.  The two-pass version it replaces
// also wrote and read back a (beta, k_out, N) scratch (2 x 69 MB at alpha 8),
// which is gone; its times are in PERF.md.  Around the bytes, each of the
// 263 converted rows is a transform (ntt_cluster.cuh) and an alpha-term
// product-sum re-reading the digit's y rows from L2.

#include "ntt_cluster.cuh"

namespace ptk {
namespace {

struct ModupArgs {
  const uint32_t* y;    // (k_data, N) pre-scaled iNTT rows (digit d's from
                        // row d alpha), or with mat null the (beta, k_out,
                        // N) converted delta
  const uint32_t* mat;  // (beta, k_out, alpha), null in the preconv form
  const uint32_t* a;    // (k_data, N) NTT-form passthrough rows
  const uint32_t* b;    // optional: the passthrough is a * b mod q
  const uint32_t* evk;  // (beta, 2, k_out, N)
  int alpha, beta, k_out, k_data;
  int wide_conv;  // alpha products of the operands stay below 2^64

  // the coefficient form (a null) has no passthrough rows
  __device__ __forceinline__ bool in_digit(int d, int j) const {
    return a != nullptr && j >= d * alpha &&
           j < min((d + 1) * alpha, k_data);
  }

  // T_d[j] before the transform at row positions gi .. gi + 3, in [0, q)
  __device__ __forceinline__ void convert4(uint32_t (&x)[4], int d, int j,
                                           int64_t gi, int n,
                                           const Barrett& bq) const {
    if (mat == nullptr) {  // preconv: converted already, lazy [0, 2 q_j)
      const uint4 v =
          ld4(y + (static_cast<int64_t>(d) * k_out + j) * n + gi);
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = csub(lane4(v, c), bq.q);
      return;
    }
    const int terms = min(alpha, k_data - d * alpha);
    const uint32_t* yd = y + static_cast<int64_t>(d) * alpha * n + gi;
    const uint32_t* m = mat + (static_cast<int64_t>(d) * k_out + j) * alpha;
    if (wide_conv) {
      uint64_t acc[4] = {0, 0, 0, 0};
      for (int i = 0; i < terms; ++i) {
        const uint32_t mi = __ldg(m + i);
        const uint4 yv = ld4(yd + static_cast<int64_t>(i) * n);
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
        const uint4 yv = ld4(yd + static_cast<int64_t>(i) * n);
#pragma unroll
        for (int c = 0; c < 4; ++c) mac(lo[c], hi[c], lane4(yv, c), mi);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = reduce128(hi[c], lo[c], bq);
    }
  }

  // the passthrough at gi .. gi + 3: a[j], or a[j] b[j] mod q_j
  __device__ __forceinline__ void passthrough4(uint32_t (&x)[4], int j,
                                               int64_t gi, int n,
                                               const Barrett& bq) const {
    const int64_t o = static_cast<int64_t>(j) * n + gi;
    const uint4 av = ld4(a + o);
    if (b == nullptr) {
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = lane4(av, c);
      return;
    }
    const uint4 bv = ld4(b + o);
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = mul_mod(lane4(av, c), lane4(bv, c), bq);
  }
};

// words 4v .. 4v + 3 of both digit sums (acc[h S + .], residues) += t * e_h
__device__ __forceinline__ void add_digit4(uint32_t* acc, int S, int v,
                                           const uint32_t (&t)[4],
                                           const uint4& e0, const uint4& e1,
                                           const Barrett& bq) {
  const uint4 a0 = *reinterpret_cast<const uint4*>(acc + 4 * v);
  const uint4 a1 = *reinterpret_cast<const uint4*>(acc + S + 4 * v);
  uint32_t r0[4], r1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    r0[c] = reduce64(
        lane4(a0, c) + static_cast<uint64_t>(t[c]) * lane4(e0, c), bq);
    r1[c] = reduce64(
        lane4(a1, c) + static_cast<uint64_t>(t[c]) * lane4(e1, c), bq);
  }
  st4(acc + 4 * v, r0[0], r0[1], r0[2], r0[3]);
  st4(acc + S + 4 * v, r1[0], r1[1], r1[2], r1[3]);
}

// One cluster per output row j; block `rank` owns the share [rank S,
// (rank + 1) S); thread t serves the 4-word vectors t, t + T, ...
__global__ void __launch_bounds__(kClusterThreads, 2)
modup_ip_kernel(ModupArgs m, NttTables tb, ClusterGeom G, uint32_t* out) {
  extern __shared__ uint32_t s[];  // the share, then the two digit sums
  const int S = 1 << G.logs, vecs = S >> 2;
  uint32_t* acc = s + cluster_smem_words(G.logs);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = blockIdx.x >> G.logc;
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const int n = 1 << G.logn;
  const int64_t share = static_cast<int64_t>(rank) << G.logs;
  const int64_t half = static_cast<int64_t>(m.k_out) * n;
  const int64_t trow = static_cast<int64_t>(limb) * n;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    st4(acc + 4 * v, 0, 0, 0, 0);
    st4(acc + S + 4 * v, 0, 0, 0, 0);
  }
  for (int d = 0; d < m.beta; ++d) {
    const uint32_t* ev =
        m.evk + (static_cast<int64_t>(2 * d) * m.k_out + j) * n + share;
    if (m.in_digit(d, j)) {  // uniform over the cluster: no transform
      for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
        uint32_t t[4];
        m.passthrough4(t, j, share + 4 * v, n, bq);
        add_digit4(acc, S, v, t, ld4(ev + 4 * v), ld4(ev + half + 4 * v),
                   bq);
      }
      continue;
    }
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      uint32_t x[4];
      m.convert4(x, d, j, share + 4 * v, n, bq);
#pragma unroll
      for (int c = 0; c < 4; ++c) s[pad(4 * v + c)] = x[c];
    }
    cluster_ntt(s, cluster, G, rank, tb.w + trow, tb.ws + trow, bq.q);
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      uint32_t t[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) t[c] = canon(s[pad(4 * v + c)], bq.q);
      add_digit4(acc, S, v, t, ld4(ev + 4 * v), ld4(ev + half + 4 * v), bq);
    }
    __syncthreads();  // the next digit's prologue rewrites s
  }
  uint32_t* o = out + static_cast<int64_t>(j) * n + share;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    const uint4 a0 = *reinterpret_cast<const uint4*>(acc + 4 * v);
    const uint4 a1 = *reinterpret_cast<const uint4*>(acc + S + 4 * v);
    st4(o + 4 * v, a0.x, a0.y, a0.z, a0.w);
    st4(o + half + 4 * v, a1.x, a1.y, a1.z, a1.w);
  }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// K4.  out: (2, k_out, N); y, a, b: (k_data, N) (digit d's rows from row
// d alpha, the last digit may be short), b may be null, and a too (the
// coefficient form); mat: (beta, k_out, alpha), or null for the preconv
// form, where y is the (beta, k_out, N) delta; evk: (beta, 2, k_out, N);
// q, w, ws: the whole base's forward tables; rows: (k_out,) table row of
// each output row.  cluster: blocks per row, a power of two up to 8 whose
// share of N / cluster words is 1024 to 16384.  wide_conv: alpha products
// stay below 2^64.
int ptk_modup_ip(void* out, const void* y, const void* mat, const void* a,
                 const void* b, const void* evk, int beta, int alpha,
                 int k_out, int k_data, const void* q, const void* w,
                 const void* ws, const void* rows, int logn, int cluster,
                 int wide_conv, void* stream) {
  const int logc = log2_of(cluster);
  const ClusterGeom G{logn, logc, logn - logc};
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
                    k_data,
                    wide_conv};
  return static_cast<int>(launch_cluster(
      modup_ip_kernel, k_out, G.logc, G.logs, 2 << G.logs,
      static_cast<cudaStream_t>(stream), m, tb, G,
      static_cast<uint32_t*>(out)));
}

}  // extern "C"

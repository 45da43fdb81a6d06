// K8: the moddown of both key-switch halves, R output rows per cluster.
//
// Replaces phantom_tpu/ops/ntt_mxu_pallas.py:moddown_mxu_bconv_pallas (body
// _bconv_mxu_kernel).  It computes what K3's moddown call computes
// (bconv_ntt.cu with v, sub_from, epi_scale and tensor_add): for half g and
// Ql row j,
//   x         = sum_i y[g, i] mat[j, i] - v[g] vmul[j]  mod q_j  (exact)
//   out[g, j] = (sub[g, j] - NTT_j(x)) esc[j] + c_g[j],
// c_0 = d1[0] d2[0], c_1 = d1[0] d2[1] + d1[1] d2[0] (no tensor term when d1
// is null).  What the TPU kernel does, and this one too: a program serves R
// output rows and reads each y element once for all of them, where K3
// re-reads the alpha y rows for every output row.  The TPU kernel's int8
// digit-plane dots and pow2 fold tables are a workaround for its missing
// 32x32->64 multiply and have no counterpart here.
//
// One launch on the one-pass, cluster-resident radix-8 core
// (ntt_cluster.cuh): one cluster of C blocks per (half g, block of R rows),
// block `rank` holding share [rank S, (rank + 1) S) of `held` (Rh) rows at
// a time in dynamic shared memory, Rh the wrapper's choice (at most R, as
// many as fit, the rounds balanced: moddown_kernels.held_rows).  Per round
// each block converts its share of the round's rows straight into their
// shares, reading each y word once for all of them (16-byte loads, Rh x 4
// product-sums: one 64-bit word when alpha products stay below 2^64, else
// a low word and a carry count, as K3), the cluster transforms every held
// row in one cluster_ntt_rows (each pass runs all held rows' units between
// the same barriers), and each block brings its shares to [0, q), applies
// the epilogue and stores them with 16-byte stores.  ceil(R / Rh) rounds
// re-read the y share from L2; the last block of rows masks the rows past
// k.  No row makes a round trip through device memory.
//
// Bound, at the headline moddown ((2, 22, N) -> (2, 43, N), N = 2^16): the
// same 124 MB of device memory as K3 (0.037 ms at 3.35 TB/s); y is read
// from L2 ceil(43 / R) x ceil(R / Rh) times per half instead of 43 times.
// At C = 8 a share is 33 KB, so at most 6 rows fit a block's 227 KB: R = 8
// runs as two rounds of 4, one block of 1024 threads per SM.  Up to 4 held
// rows a block has 1024 threads, 64 registers each (their 16 sums fit);
// 5-8 rows take 512 threads and 128 registers (chip_smoke.py phase 26
// times R = 8 at 512 threads too).

#include "ntt_cluster.cuh"

namespace ptk {
namespace {

constexpr int kMaxRows = 8;  // R: the product-sums a thread keeps
constexpr int kFewRows = 4;  // held rows of the 1024-thread build

struct RowsArgs {
  const uint32_t* y;     // (2, alpha, N)
  const uint32_t* mat;   // (k, alpha)
  const uint32_t* v;     // (2, N)
  const uint32_t* vmul;  // (k,)
  int alpha, k, R, held;
  int wide;  // alpha products of the operands stay below 2^64
};

// A Ql row's constants, in shared memory after the held shares.
struct RowConst {
  uint32_t q, limb;
  uint64_t ratio;  // Barrett's floor((2^64 - 1) / q)
};

// The held rows for cluster_ntt_rows: row i's share at s + i * stride.
struct HeldRows {
  const RowConst* rc;
  const uint32_t* tw;
  const uint32_t* tws;
  int logn, n, stride;
  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int words() const { return stride; }
  __device__ __forceinline__ const uint32_t* w(int i) const {
    return tw + (static_cast<int64_t>(rc[i].limb) << logn);
  }
  __device__ __forceinline__ const uint32_t* ws(int i) const {
    return tws + (static_cast<int64_t>(rc[i].limb) << logn);
  }
  __device__ __forceinline__ uint32_t q(int i) const { return rc[i].q; }
};

// Rows j0 .. j0 + NH - 1 of half g at row positions gi .. gi + 3: the
// converted words, in [0, q), into the rows' shares at share position pos.
template <int NH>
__device__ __forceinline__ void convert_rows(const RowsArgs& a,
                                             const RowConst* rc, uint32_t* s,
                                             int words, int g, int j0,
                                             int64_t gi, int pos, int n) {
  const uint32_t* yg = a.y + static_cast<int64_t>(g) * a.alpha * n + gi;
  const uint32_t* m = a.mat + static_cast<int64_t>(j0) * a.alpha;
  uint32_t x[NH][4];
  if (a.wide) {
    uint64_t acc[NH][4] = {};
    for (int i = 0; i < a.alpha; ++i) {
      const uint4 yv = ld4(yg + static_cast<int64_t>(i) * n);
#pragma unroll
      for (int r = 0; r < NH; ++r) {
        const uint32_t mi = __ldg(m + r * a.alpha + i);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] += static_cast<uint64_t>(lane4(yv, c)) * mi;
      }
    }
#pragma unroll
    for (int r = 0; r < NH; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[r][c] = reduce64(acc[r][c], Barrett{rc[r].q, rc[r].ratio});
  } else {
    uint64_t lo[NH][4] = {};
    uint32_t hi[NH][4] = {};
    for (int i = 0; i < a.alpha; ++i) {
      const uint4 yv = ld4(yg + static_cast<int64_t>(i) * n);
#pragma unroll
      for (int r = 0; r < NH; ++r) {
        const uint32_t mi = __ldg(m + r * a.alpha + i);
#pragma unroll
        for (int c = 0; c < 4; ++c) mac(lo[r][c], hi[r][c], lane4(yv, c), mi);
      }
    }
#pragma unroll
    for (int r = 0; r < NH; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[r][c] =
            reduce128(hi[r][c], lo[r][c], Barrett{rc[r].q, rc[r].ratio});
  }
  const uint4 vv = ld4(a.v + static_cast<int64_t>(g) * n + gi);
#pragma unroll
  for (int r = 0; r < NH; ++r) {
    const Barrett bq{rc[r].q, rc[r].ratio};
    const uint32_t vm = __ldg(a.vmul + j0 + r);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[r * words + pad(pos + c)] =
          sub_mod(x[r][c], mul_mod(lane4(vv, c), vm, bq), bq.q);
  }
}

// convert_rows<nh> for a run-time nh <= H.
template <int H>
__device__ __forceinline__ void convert_held(int nh, const RowsArgs& a,
                                             const RowConst* rc, uint32_t* s,
                                             int words, int g, int j0,
                                             int64_t gi, int pos, int n) {
  if (nh == H)
    convert_rows<H>(a, rc, s, words, g, j0, gi, pos, n);
  else if constexpr (H > 1)
    convert_held<H - 1>(nh, a, rc, s, words, g, j0, gi, pos, n);
}

// One cluster per (half g, block of R rows from j0); block `rank` owns
// each row's share [rank S, (rank + 1) S).  Built for at most H held rows:
// up to kFewRows at 1024 threads a block (64 registers a thread), more
// at 512 (128 registers, which 8 rows' sums need).
template <int H>
__global__ void __launch_bounds__(H <= kFewRows ? 1024 : kClusterThreads, 1)
moddown_rows_kernel(RowsArgs a, NttTables tb, FwdEpilogue epi, ClusterGeom G,
                    uint32_t* out) {
  extern __shared__ uint32_t s[];  // `held` shares, then kMaxRows RowConst
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = (a.k + a.R - 1) / a.R;  // blocks of rows per half
  const int c = blockIdx.x >> G.logc;
  const int g = c / blocks, j0 = (c - g * blocks) * a.R;
  const int nr = min(a.R, a.k - j0);
  const int words = cluster_smem_words(G.logs);
  RowConst* rc = reinterpret_cast<RowConst*>(s + a.held * words);
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    const int limb = tb.rows[j0 + r];
    const uint32_t q = tb.q[limb];
    rc[r] = RowConst{q, static_cast<uint32_t>(limb), ~0ull / q};
  }
  __syncthreads();
  const int n = 1 << G.logn, vecs = 1 << (G.logs - 2);
  const int64_t share = static_cast<int64_t>(rank) << G.logs;
  // A thread converts, and later stores, the same words of every held
  // row, so one round's conversion follows the last round's epilogue with
  // no barrier; cluster_ntt_rows begins with one.
  for (int r0 = 0; r0 < nr; r0 += a.held) {
    const int nh = min(a.held, nr - r0), j = j0 + r0;
    const RowConst* rr = rc + r0;
    for (int v = threadIdx.x; v < vecs; v += blockDim.x)
      convert_held<H>(nh, a, rr, s, words, g, j, share + 4 * v, 4 * v, n);
    cluster_ntt_rows(s, cluster, G, rank,
                     HeldRows{rr, tb.w, tb.ws, G.logn, nh, words});
    for (int r = 0; r < nh; ++r) {
      const int row = g * a.k + j + r;
      const Barrett bq{rr[r].q, rr[r].ratio};
      const uint32_t* sr = s + r * words;
      uint32_t* o = out + (static_cast<int64_t>(row) << G.logn) + share;
      for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
        uint32_t x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = canon(sr[pad(4 * v + e)], bq.q);
        apply_epilogue4(epi, x, row, j + r, g, a.k, share + 4 * v, n, bq);
        st4(o + 4 * v, x[0], x[1], x[2], x[3]);
      }
    }
  }
}

// K8 built for at most H held rows.
template <int H>
cudaError_t launch_rows(const RowsArgs& a, const NttTables& tb,
                        const FwdEpilogue& epi, const ClusterGeom& G,
                        uint32_t* out, cudaStream_t stream) {
  const int extra = (a.held - 1) * cluster_smem_words(G.logs) +
                    kMaxRows * static_cast<int>(sizeof(RowConst) / 4);
  return launch_cluster<true, H <= kFewRows ? 1024 : kClusterThreads>(
      moddown_rows_kernel<H>, 2 * ((a.k + a.R - 1) / a.R), G.logc, G.logs,
      extra, stream, a, tb, epi, G, out);
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// K8.  out: (2, k, N); y: (2, alpha, N); mat: (k, alpha); v: (2, N); vmul:
// (k,); R: rows per cluster, 1..8; q, w, ws: the whole base's forward
// tables; rows: (k,) table row of each Ql row; sub: (2, k, N), esc, escs:
// (k,); d1, d2: (2, k, N) or null.  cluster: blocks per row, as for
// ptk_bconv_ntt_forward; held: rows a block holds at a time, 1..R; wide:
// alpha products stay below 2^64.  A configuration of which the card
// cannot hold one cluster returns cudaErrorInvalidConfiguration.
int ptk_moddown_rows(void* out, const void* y, const void* mat,
                     const void* v, const void* vmul, int alpha, int k, int R,
                     const void* q, const void* w, const void* ws,
                     const void* rows, int logn, const void* sub,
                     const void* esc, const void* escs, const void* d1,
                     const void* d2, int cluster, int held, int wide,
                     void* stream) {
  if (R < 1 || R > kMaxRows || held < 1 || held > R)
    return static_cast<int>(cudaErrorInvalidValue);
  const int logc = log2_of(cluster);
  const ClusterGeom G{logn, logc, logn - logc};
  const NttTables tb{static_cast<const uint32_t*>(q),
                     static_cast<const uint32_t*>(w),
                     static_cast<const uint32_t*>(ws),
                     static_cast<const int32_t*>(rows), k};
  const FwdEpilogue epi{static_cast<const uint32_t*>(sub),
                        static_cast<const uint32_t*>(esc),
                        static_cast<const uint32_t*>(escs),
                        static_cast<const uint32_t*>(d1),
                        static_cast<const uint32_t*>(d2)};
  const RowsArgs a{static_cast<const uint32_t*>(y),
                   static_cast<const uint32_t*>(mat),
                   static_cast<const uint32_t*>(v),
                   static_cast<const uint32_t*>(vmul),
                   alpha,
                   k,
                   R,
                   held,
                   wide};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  return static_cast<int>(held <= kFewRows
                              ? launch_rows<kFewRows>(a, tb, epi, G, o, st)
                              : launch_rows<kMaxRows>(a, tb, epi, G, o, st));
}

}  // extern "C"

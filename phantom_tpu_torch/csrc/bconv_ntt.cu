// K3: base conversion fused into the forward NTT, one launch per call.
//
// Replaces phantom_tpu/ops/ntt_mxu_pallas.py:bconv_ntt_forward_mxu_pallas
// (body _bconv_fwd_kernel).  For group g and output row j:
//   x = sum_i y[g alpha + i] * mat[g, j, i] mod q_j
//       - v[g] * vmul[j] - post_sub[j]
//   out[g, j] = epilogue(NTT_j(x)),
// the sum over the group's rows of y that exist (i < alpha and g alpha + i
// < k_in, so a short last group needs no zero rows), with modup self rows
// (g alpha <= j < min((g+1) alpha, k_data)) passed through untransformed.
//
// One thread-block cluster per output row (ntt_cluster.cuh): each block
// converts its share of the row straight into shared memory (16-byte loads
// of the group's input rows, the matrix row's alpha words broadcast from
// L1), the cluster runs all log N stages on it, and each block applies the
// epilogue to its share and stores it with 16-byte stores.  The converted
// row never reaches device memory and no pass writes it in between.  The
// conversion (BconvArgs, bconv_args.cuh) is shared with K7.
//
// Bound, at the headline moddown ((2, 22, N) -> (2, 43, N), N = 2^16):
// device memory moves y 11.5 MB, sub 22.5, d1 and d2 45, out 22.5 and the
// 43 table rows with Shoup words 22.5 MB, 124 MB in all, 0.037 ms at 3.35
// TB/s; every output row re-reads its group's 22 input rows, 484 MB of
// L2 reads per call, and makes 22 64-bit products per word (0.25 G 32-bit
// multiplies), which the design keeps in registers and L2.  The two-pass
// version it replaces (column pass, a row round trip through device
// memory, chunk pass) has its times in PERF.md.

#include "bconv_args.cuh"

namespace ptk {
namespace {

// One cluster per output row (g, j); block `rank` owns the row's share
// [rank S, (rank + 1) S).
__global__ void __launch_bounds__(kClusterThreads)
bconv_ntt_kernel(BconvArgs a, NttTables tb, FwdEpilogue epi, ClusterGeom G,
                 uint32_t* out) {
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x >> G.logc;
  const int g = row / tb.L, j = row - g * tb.L;  // once per block
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const int n = 1 << G.logn, vecs = 1 << (G.logs - 2);
  const int64_t share = static_cast<int64_t>(rank) << G.logs;
  uint32_t* o = out + static_cast<int64_t>(row) * n + share;
  if (a.skip(j, g)) {  // uniform over the cluster: no transform, no sync
    const uint32_t* src = a.self_rows + static_cast<int64_t>(j) * n + share;
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      const uint4 xv = ld4(src + 4 * v);
      uint32_t x[4] = {xv.x, xv.y, xv.z, xv.w};
      apply_epilogue4(epi, x, row, j, g, tb.L, share + 4 * v, n, bq);
      st4(o + 4 * v, x[0], x[1], x[2], x[3]);
    }
    return;
  }
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint32_t x[4];
    a.convert4(x, j, g, share + 4 * v, n, bq);
#pragma unroll
    for (int c = 0; c < 4; ++c) s[pad(4 * v + c)] = x[c];
  }
  const int64_t trow = static_cast<int64_t>(limb) * n;
  cluster_ntt(s, cluster, G, rank, tb.w + trow, tb.ws + trow, bq.q);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint32_t x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = canon(s[pad(4 * v + c)], bq.q);
    apply_epilogue4(epi, x, row, j, g, tb.L, share + 4 * v, n, bq);
    st4(o + 4 * v, x[0], x[1], x[2], x[3]);
  }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// K3.  out: (G, k_out, N); y: k_in rows of N, group g's alpha rows from
// row g alpha (the last group may be short); mat: (G, k_out, alpha).  q, w,
// ws: the whole base's tables; rows: (k_out,) table row of each output row.
// v/vmul, post, self_rows, sub/esc/escs and d1/d2 may each be null.
// cluster: blocks per row, a power of two up to 8 whose share of N /
// cluster words is at least 1024.  wide: alpha products stay below 2^64.
int ptk_bconv_ntt_forward(void* out, const void* y, const void* mat, int G_,
                          int alpha, int k_out, int k_in, const void* q,
                          const void* w, const void* ws, const void* rows,
                          int logn, const void* v, const void* vmul,
                          const void* post, const void* self_rows,
                          int k_data, const void* sub, const void* esc,
                          const void* escs, const void* d1, const void* d2,
                          int cluster, int wide, void* stream) {
  const int logc = log2_of(cluster);
  const ClusterGeom G{logn, logc, logn - logc};
  const NttTables tb{static_cast<const uint32_t*>(q),
                     static_cast<const uint32_t*>(w),
                     static_cast<const uint32_t*>(ws),
                     static_cast<const int32_t*>(rows), k_out};
  const FwdEpilogue epi{static_cast<const uint32_t*>(sub),
                        static_cast<const uint32_t*>(esc),
                        static_cast<const uint32_t*>(escs),
                        static_cast<const uint32_t*>(d1),
                        static_cast<const uint32_t*>(d2)};
  const BconvArgs a{static_cast<const uint32_t*>(y),
                    static_cast<const uint32_t*>(mat),
                    alpha,
                    k_out,
                    k_in,
                    static_cast<const uint32_t*>(v),
                    static_cast<const uint32_t*>(vmul),
                    static_cast<const uint32_t*>(post),
                    static_cast<const uint32_t*>(self_rows),
                    k_data,
                    wide};
  return static_cast<int>(launch_cluster(
      bconv_ntt_kernel, G_ * k_out, G.logc, G.logs, 0,
      static_cast<cudaStream_t>(stream), a, tb, epi, G,
      static_cast<uint32_t*>(out)));
}

}  // extern "C"

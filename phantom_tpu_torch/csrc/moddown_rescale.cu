// K7: the CKKS step's merged epilogue: the moddown of both key-switch
// halves, the relinearization's tensor adds and the rescale, with one
// forward NTT per row.
//
// Replaces phantom_tpu/ops/ntt_mxu_pallas.py:moddown_rescale_mxu_pallas
// (body _moddown_rescale_kernel).  For half g, with
//   delta_j = sum_i y[g, i] mat[j, i] - v[g] vmul[j]  mod q_j  (exact)
//   c_g     = d1[0] d2[0] (g = 0), d1[0] d2[1] + d1[1] d2[0] (g = 1),
// row k-1 is the moddown output
//   m  = (s_{k-1} - NTT(delta_{k-1})) P^-1 + c_g,
//   xl = iNTT(m) + half  mod q_last,
// and by linearity every other row is
//   out_j = (s_j P^-1 + c_g - NTT_j(delta_j P^-1 + xl - half_j)) q_last^-1,
// equal to the composed moddown pair and rescale (K3, K1, K3) while the
// moddown rows 0..k-2 never reach device memory.
//
// The TPU kernel relies on its sequential grid: its first program does the
// last limb and leaves xl in VMEM for every later one.  CUDA blocks run in
// no order, so here two launches on the one-pass, cluster-resident core
// (ntt_cluster.cuh), one cluster of C blocks per row, each block holding a
// share of S = N / C words:
//   A (rescale_last_kernel, 2 clusters, g = 0, 1): the conversion
//     (BconvArgs, bconv_args.cuh, as K3's) of delta_{k-1} into the share,
//     cluster_ntt, the epilogue m (stored to out[g, k-1] and written back
//     into the share), cluster_intt on the same share, then n^-1 and
//     + half: xl into a (2, N) scratch.
//   B (rescale_rest_kernel, 2 (k-1) clusters): the xl-free part of the
//     prologue, delta_j P^-1 - half_j, into the share; griddepcontrol.wait;
//     + (xl mod q_j); cluster_ntt; the rescaled epilogue, 16-byte loads
//     and stores.
// B is a programmatic dependent launch (PDL): every block of A runs
// griddepcontrol.launch_dependents first, so B's clusters start on the
// SMs that A's 2 C blocks leave idle and convert their rows, the bulk of
// the work, while A transforms, and wait only before they read xl.  B
// cannot start before every block of A has started, so A is resident
// whatever B occupies: no deadlock.  Rejected: one launch whose row
// clusters spin on a flag that the last-limb clusters set (CUDA promises
// no order among blocks, so it hangs whenever those are not resident),
// and xl recomputed in every cluster (2 (k-1) extra forward and inverse
// transforms).
//
// Bound, at the headline ((2, 22, N) -> (2, 43, N), N = 2^16): device
// memory moves y 11.5 MB, sub 22.5, d1 and d2 45, out 22.5, the 43 forward
// table rows with Shoup words 22.5 MB and the last limb's inverse row 0.5
// MB, 125 MB in all, 0.037 ms at 3.35 TB/s (the 1 MB of xl written and
// read back besides); every row re-reads its half's 22 y rows from L2 and
// makes 22 64-bit products per word, as K3 does.  Against that, the call
// replaces three of the pair's (K3's moddown, the rescale's K1 on the last
// limb and its K3), which move the moddown output through device memory
// twice more.  Times in PERF.md.

#include "bconv_args.cuh"

namespace ptk {
namespace {

struct RescaleArgs {
  BconvArgs conv;  // y (2, alpha, N), mat (k, alpha), v (2, N), vmul (k,);
                   // half g is group 0 of its own y and v (half_conv)
  FwdEpilogue md;  // sub (2, k, N), P^-1 and its Shoup word (k,), d1, d2
  const uint32_t* hmq;    // (k-1,) half mod q_j
  const uint32_t* qinv;   // (k-1,) q_last^-1 mod q_j and its Shoup word
  const uint32_t* qinvs;
  const uint32_t* winv;   // the whole base's inverse twiddles
  const uint32_t* winvs;
  const uint32_t* ninv;   // (Lt,) n^-1 and its Shoup word
  const uint32_t* ninvs;
  uint32_t half;          // q_last / 2

  __device__ __forceinline__ BconvArgs half_conv(int g, int n) const {
    BconvArgs c = conv;
    c.y += static_cast<int64_t>(g) * c.alpha * n;
    c.v += static_cast<int64_t>(g) * n;
    return c;
  }
};

// A: one cluster per half g (k = tb.L rows); block `rank` owns the share
// [rank S, (rank + 1) S) of row k-1.
__global__ void __launch_bounds__(kClusterThreads)
rescale_last_kernel(RescaleArgs a, NttTables tb, ClusterGeom G,
                    uint32_t* out, uint32_t* xl) {
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.x >> G.logc, j = tb.L - 1;
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const uint32_t q = bq.q;
  const int n = 1 << G.logn, vecs = 1 << (G.logs - 2);
  const int64_t share = static_cast<int64_t>(rank) << G.logs;
  const BconvArgs c = a.half_conv(g, n);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint32_t x[4];
    c.convert4(x, j, 0, share + 4 * v, n, bq);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[pad(4 * v + e)] = x[e];
  }
  const int64_t trow = static_cast<int64_t>(limb) << G.logn;
  cluster_ntt(s, cluster, G, rank, tb.w + trow, tb.ws + trow, q);
  const int row = g * tb.L + j;
  uint32_t* o = out + (static_cast<int64_t>(row) << G.logn) + share;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint32_t x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = canon(s[pad(4 * v + e)], q);
    apply_epilogue4(a.md, x, row, j, g, tb.L, share + 4 * v, n, bq);
    st4(o + 4 * v, x[0], x[1], x[2], x[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[pad(4 * v + e)] = x[e];
  }
  cluster_intt(s, cluster, G, rank, a.winv + trow, a.winvs + trow, q);
  const uint32_t sc = a.ninv[limb], scs = a.ninvs[limb];
  uint32_t* xo = xl + (static_cast<int64_t>(g) << G.logn) + share;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint32_t x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = add_mod(mul_shoup(s[pad(4 * v + e)], sc, scs, q), a.half, q);
    st4(xo + 4 * v, x[0], x[1], x[2], x[3]);
  }
}

// B: one cluster per row (g, j), j < k-1; block `rank` owns the share
// [rank S, (rank + 1) S).
__global__ void __launch_bounds__(kClusterThreads)
rescale_rest_kernel(RescaleArgs a, NttTables tb, ClusterGeom G,
                    const uint32_t* xl, uint32_t* out) {
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x >> G.logc;
  const int g = row / (tb.L - 1), j = row - g * (tb.L - 1);
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const uint32_t q = bq.q;
  const int n = 1 << G.logn, vecs = 1 << (G.logs - 2);
  const int64_t share = static_cast<int64_t>(rank) << G.logs;
  const BconvArgs c = a.half_conv(g, n);
  const uint32_t pv = __ldg(a.md.esc + j), pvs = __ldg(a.md.escs + j);
  const uint32_t h = __ldg(a.hmq + j);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint32_t x[4];
    c.convert4(x, j, 0, share + 4 * v, n, bq);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[pad(4 * v + e)] = sub_mod(mul_shoup(x[e], pv, pvs, q), h, q);
  }
  // A's xl: after the wait, in L2 (not the read-only path: A wrote it
  // while this grid ran)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const uint32_t* xg = xl + (static_cast<int64_t>(g) << G.logn) + share;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    const uint4 xv = __ldcg(reinterpret_cast<const uint4*>(xg + 4 * v));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[pad(4 * v + e)] = add_mod(s[pad(4 * v + e)],
                                  reduce64(lane4(xv, e), bq), q);
  }
  const int64_t trow = static_cast<int64_t>(limb) << G.logn;
  cluster_ntt(s, cluster, G, rank, tb.w + trow, tb.ws + trow, q);
  const int64_t md_row = static_cast<int64_t>(g) * tb.L + j;
  const uint32_t* sub = a.md.sub + (md_row << G.logn) + share;
  uint32_t* o = out + (md_row << G.logn) + share;
  const uint32_t qi = __ldg(a.qinv + j), qis = __ldg(a.qinvs + j);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    const uint4 sv = ld4(sub + 4 * v);
    uint32_t t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) t[e] = mul_shoup(lane4(sv, e), pv, pvs, q);
    add_tensor4(a.md, t, j, g, tb.L, share + 4 * v, n, bq);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      t[e] = mul_shoup(sub_mod(t[e], canon(s[pad(4 * v + e)], q), q), qi,
                       qis, q);
    st4(o + 4 * v, t[0], t[1], t[2], t[3]);
  }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// K7.  out: (2, k, N); scratch: (2, N); y: (2, alpha, N); mat: (k, alpha);
// v: (2, N); vmul, pinv, pinvs: (k,); sub, d1, d2: (2, k, N); hmq, qinv,
// qinvs: (k-1,); half: q_last / 2; q, w, ws, winv, winvs, ninv, ninvs: the
// whole base's tables; rows: (k,) table row of each Ql row; k >= 2.
// cluster: blocks per row, as for ptk_bconv_ntt_forward; wide: alpha
// products stay below 2^64.
int ptk_moddown_rescale(void* out, void* scratch, const void* y,
                        const void* mat, const void* v, const void* vmul,
                        const void* sub, const void* d1, const void* d2,
                        const void* pinv, const void* pinvs, const void* hmq,
                        const void* qinv, const void* qinvs, int half,
                        int alpha, int k, const void* q, const void* w,
                        const void* ws, const void* winv, const void* winvs,
                        const void* ninv, const void* ninvs, const void* rows,
                        int logn, int cluster, int wide, void* stream) {
  if (k < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int logc = log2_of(cluster);
  const ClusterGeom G{logn, logc, logn - logc};
  const auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  const NttTables tb{u(q), u(w), u(ws), static_cast<const int32_t*>(rows), k};
  const RescaleArgs a{
      BconvArgs{u(y), u(mat), alpha, k, alpha, u(v), u(vmul), nullptr,
                nullptr, 0, wide},
      FwdEpilogue{u(sub), u(pinv), u(pinvs), u(d1), u(d2)},
      u(hmq), u(qinv), u(qinvs), u(winv), u(winvs), u(ninv), u(ninvs),
      static_cast<uint32_t>(half)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* scr = static_cast<uint32_t*>(scratch);
  cudaError_t e = launch_cluster(rescale_last_kernel, 2, logc, G.logs, 0, st,
                                 a, tb, G, o, scr);
  if (e == cudaSuccess)
    e = launch_cluster<false, 0, true>(rescale_rest_kernel, 2 * (k - 1),
                                       logc, G.logs, 0, st, a, tb, G,
                                       static_cast<const uint32_t*>(scr), o);
  return static_cast<int>(e);
}

}  // extern "C"

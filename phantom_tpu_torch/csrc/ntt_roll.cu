// K6: the one-pass, row-resident negacyclic NTT: forward, forward with the
// moddown epilogue (sub_from - NTT(x)) * scale, and the scaled inverse.
//
// Replaces phantom_tpu/ops/ntt_pallas_roll.py:ntt_forward_roll /
// ntt_inverse_roll (bodies _fwd_kernel, _fwd_fused_kernel, _inv_kernel),
// which keep one row in VMEM for all log N stages of one program.  Here one
// launch per call and one thread-block cluster per row: the row stays in
// the cluster's shared memory from the first stage to the last, so it is
// read from device memory once and written once (K1 and K2 make two passes
// of 4096-word tiles and write the row in between, ntt_core.cuh).
//
// A row of N words is held by a cluster of C blocks (C = 1 up to 2^13
// words), block r holding the contiguous share [r S, (r+1) S), S = N / C
// words of dynamic shared memory.  A stage whose butterflies are t apart:
//   t < S   pairs inside every share: each block does its S/2 butterflies
//           in its own shared memory;
//   t >= S  pairs blocks r and r ^ (t/S) at equal offsets: of the pair's S
//           butterflies the lower block does the first S/2 and the upper
//           block the rest, each reading and writing both shares through
//           cluster.map_shared_rank (distributed shared memory), so no word
//           is touched by two blocks in one stage.
// A stage is followed by cluster.sync() when it or the next one crosses
// blocks, else by __syncthreads().  The forward (Cooley-Tukey, m = 1 ..
// N/2) starts with the crossing stages, the inverse (Gentleman-Sande,
// m = N/2 .. 1) ends with them.  Twiddles are the port's tables, read from
// device memory (mostly L2), in the order out[k] = p(psi^(2 rev(k)+1)) of
// ntt_core.cuh; every butterfly keeps [0, q).  Bound by device memory: the
// row in and out once, and its table row, which rows of one limb share.

#include <cooperative_groups.h>

#include "ntt_core.cuh"

namespace cg = cooperative_groups;

namespace ptk {
namespace {

constexpr int kRollThreads = 512;

struct RollArgs {
  const uint32_t* x;            // (nrows, N) in [0, 2q)
  uint32_t* out;                // (nrows, N)
  const uint32_t* scale;        // inverse: (L,), replaces n^-1
  const uint32_t* scale_shoup;
  int logn, log_share;          // N = 2^logn, S = 2^log_share
};

// The stage with m groups (butterflies t = N / (2m) apart), block `rank`
// of the cluster; group i reads twiddle m + i.
template <bool kInverse>
__device__ __forceinline__ void roll_stage(uint32_t* s,
                                           cg::cluster_group& cluster,
                                           int rank, int m, const RollArgs& a,
                                           const uint32_t* w,
                                           const uint32_t* ws, uint32_t q) {
  const int t = (1 << a.logn) / (2 * m);
  const int S = 1 << a.log_share;
  if (t < S) {
    const int g0 = (rank << a.log_share) / (2 * t);  // the share's 1st group
    for (int b = threadIdx.x; b < S / 2; b += blockDim.x) {
      const int il = b / t;
      const int lo = 2 * t * il + b % t;
      const int k = m + g0 + il;
      if (kInverse)
        gs_bfly(s[lo], s[lo + t], w[k], ws[k], q);
      else
        ct_bfly(s[lo], s[lo + t], w[k], ws[k], q);
    }
    return;
  }
  const int step = t >> a.log_share;  // ranks apart
  const int lower = rank & ~step;
  uint32_t* u = cluster.map_shared_rank(s, lower);
  uint32_t* v = cluster.map_shared_rank(s, lower | step);
  const int k = m + (lower << a.log_share) / (2 * t);
  const uint32_t wk = w[k], wsk = ws[k];
  const int off = rank == lower ? 0 : S / 2;
  for (int e = off + threadIdx.x; e < off + S / 2; e += blockDim.x) {
    if (kInverse)
      gs_bfly(u[e], v[e], wk, wsk, q);
    else
      ct_bfly(u[e], v[e], wk, wsk, q);
  }
}

// One cluster per row: load the share, all log N stages, store the share
// (forward: K2's epilogue; inverse: times scale).
template <bool kInverse>
__global__ void __launch_bounds__(kRollThreads)
ntt_roll_kernel(RollArgs a, NttTables tb, FwdEpilogue epi) {
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = 1 << a.logn, S = 1 << a.log_share;
  const int row = blockIdx.x / C;
  const int j = row % tb.L;
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const uint32_t q = bq.q;
  const uint32_t* w = tb.w + static_cast<int64_t>(limb) * n;
  const uint32_t* ws = tb.ws + static_cast<int64_t>(limb) * n;
  const int64_t share = static_cast<int64_t>(rank) * S;  // in the row
  const int64_t base = static_cast<int64_t>(row) * n + share;
  for (int e = threadIdx.x; e < S; e += blockDim.x)
    s[e] = csub(a.x[base + e], q);
  cluster.sync();
  for (int i = 0; i < a.logn; ++i) {
    const int m = kInverse ? n >> (i + 1) : 1 << i;
    roll_stage<kInverse>(s, cluster, rank, m, a, w, ws, q);
    const int next = kInverse ? m >> 1 : m << 1;
    if (2 * m <= C || (i + 1 < a.logn && 2 * next <= C))
      cluster.sync();
    else
      __syncthreads();
  }
  uint32_t* o = a.out + base;
  if (kInverse) {
    const uint32_t sc = a.scale[j], scs = a.scale_shoup[j];
    for (int e = threadIdx.x; e < S; e += blockDim.x)
      o[e] = mul_shoup(s[e], sc, scs, q);
  } else {
    for (int e = threadIdx.x; e < S; e += blockDim.x)
      o[e] = epi.apply(s[e], row, j, 0, tb.L, share + e, n, bq);
  }
}

template <bool kInverse>
cudaError_t launch_roll(const RollArgs& a, const NttTables& tb,
                        const FwdEpilogue& epi, int nrows, int cluster,
                        cudaStream_t stream) {
  const int share = 1 << a.log_share;
  const int smem = share * static_cast<int>(sizeof(uint32_t));
  const cudaError_t e = cudaFuncSetAttribute(
      ntt_roll_kernel<kInverse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nrows * cluster);
  cfg.blockDim = dim3(share / 2 < kRollThreads ? share / 2 : kRollThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ntt_roll_kernel<kInverse>, a, tb, epi);
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// K6.  out, x: (nrows, N); q, w, ws: the whole base's tables (inverse
// twiddles for the inverse); rows: (L,) table row of each group row;
// cluster: blocks per row, a power of two dividing N.  Forward: sub, esc,
// escs may be null (no epilogue).  Inverse: scale, scale_shoup (L,).
int ptk_ntt_roll(void* out, const void* x, const void* q, const void* w,
                 const void* ws, const void* rows, int L, int nrows, int logn,
                 int cluster, const void* sub, const void* esc,
                 const void* escs, const void* scale, const void* scale_shoup,
                 int inverse, void* stream) {
  int log_c = 0;
  while ((1 << log_c) < cluster) ++log_c;
  const NttTables tb{static_cast<const uint32_t*>(q),
                     static_cast<const uint32_t*>(w),
                     static_cast<const uint32_t*>(ws),
                     static_cast<const int32_t*>(rows), L};
  const FwdEpilogue epi{static_cast<const uint32_t*>(sub),
                        static_cast<const uint32_t*>(esc),
                        static_cast<const uint32_t*>(escs), nullptr, nullptr};
  const RollArgs a{static_cast<const uint32_t*>(x),
                   static_cast<uint32_t*>(out),
                   static_cast<const uint32_t*>(scale),
                   static_cast<const uint32_t*>(scale_shoup), logn,
                   logn - log_c};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      inverse ? launch_roll<true>(a, tb, epi, nrows, cluster, st)
              : launch_roll<false>(a, tb, epi, nrows, cluster, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

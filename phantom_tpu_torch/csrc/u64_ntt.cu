// U1: the negacyclic NTT over u64 primes (q < 2^61), forward and inverse.
//
// Replaces the JAX package's u64 NTT, phantom_tpu/ops/ntt.py:101
// ntt_forward and :151 ntt_inverse, which run as XLA fusions (stage loops
// over a (..., L, m, 2, t) view of emulated u64, no pallas_call).
// Forward: Cooley-Tukey stages m = 1 .. N/2, Harvey-lazy in [0, 4q),
// output reduced to [0, q).  Inverse: Gentleman-Sande stages m = N/2 ..
// 1 from [0, 2q), then one Shoup multiply by the per-row scale (N^-1 or
// a folded one) to [0, q).
//
// One launch a call, on the one-pass cluster core (ntt_cluster.cuh) that
// K1-K8 run on, instantiated for u64 words: a row of N words is held by a
// cluster of C = 2^logc blocks, a share of S = N / C words each in
// dynamic shared memory (one pad word per 16), read from device memory
// once and written once, for every N from 2 to 2^17; a row that fits one
// block runs as a cluster of one.  The local stages run in the core's
// radix-8 register passes (each unit loads its 7 twiddles and 7 Shoup
// words once).  Three things differ from the u32 kernels, each measured
// on the card (PERF.md): the crossing stages run inside the row's load
// (forward) and store (inverse), so a word crosses distributed shared
// memory once, not twice; where log S = 1 mod 3 (N = 2^16 on 8 blocks)
// the stage that pairs neighbours runs in the epilogue (forward) or the
// prologue (inverse), saving a local pass; and the clusters run
// limb-major, so that rows sharing a table row run side by side.  C, the
// threads per block and the shared-memory bytes come from the wrapper
// (ops/ntt.py u64_geometry), which picks them from N alone.  Every row
// takes its table row from `rows`, so a transform of any subset of a base
// needs no copied tables.
//
// Bound: at the modup's (2, 65, 2^16) forward the rows move 68 MB in and
// 68 MB out and the 65 table rows with their Shoup words 68 MB, 0.061 ms
// at 3.35 TB/s; the 130 x 2^15 x 16 butterflies at about 10 32-bit
// multiplies each (a 64 x 64 Shoup product: the high word of x ws, the
// low words of x w and of the quotient times q) are 0.68 G multiplies,
// 0.041 ms at 16.7 T/s.  Measured, the products cost a quarter of the
// kernel's time; the local passes' shared-memory traffic, barriers and
// twiddle fetches, at three 256-thread blocks an SM, cost the most.

#include <atomic>

#include "ntt_cluster.cuh"

namespace ptk64 {
namespace {

// kernel launches made by ptk_u64_ntt since the library was loaded
std::atomic<long long> launched{0};

namespace cg = cooperative_groups;

// at most 256 threads a block, three blocks an SM (80 registers, a few
// spilled): the transform waits on its twiddle fetches and shared-memory
// passes more than on its multiplies, so blocks in flight count more than
// registers (two blocks of 114 registers were slower)
constexpr int kMaxThreads = 256;
constexpr int kBlocksPerSM = 3;

struct Ntt64Args {
  uint64_t* out;
  const uint64_t* x;
  const uint64_t* q;      // the base's moduli
  const uint64_t* w;      // (base rows, N) twiddles
  const uint64_t* ws;     // and their Shoup words
  const int32_t* rows;    // (num_l,) table row of each limb
  const uint64_t* scale;  // (num_l,) the inverse's factor
  const uint64_t* scale_shoup;
  int num_l, groups;
};

__device__ __forceinline__ ulonglong2 ld2(const uint64_t* p) {
  return __ldg(reinterpret_cast<const ulonglong2*>(p));
}

// The crossing stages fused with the row's load (forward): block `rank`
// reads, for each of its offsets o of [rank S / C, (rank + 1) S / C), the
// C words x[k S + o] straight from device memory, runs the logc stages in
// registers and writes word k to share k (distributed shared memory: one
// remote write a word, where a load into its own share and a crossing
// pass would take a remote read and a remote write).
template <int LC>
__device__ __forceinline__ void crossing_load(uint64_t* s,
                                              cg::cluster_group& cluster,
                                              const ptk::ClusterGeom& G,
                                              int rank, const uint64_t* x,
                                              const uint64_t* w,
                                              const uint64_t* ws,
                                              uint64_t q) {
  uint64_t* sh[1 << LC];
#pragma unroll
  for (int k = 0; k < (1 << LC); ++k) sh[k] = cluster.map_shared_rank(s, k);
  const int per = 1 << (G.logs - LC);
  for (int o = threadIdx.x; o < per; o += blockDim.x) {
    const int off = (rank << (G.logs - LC)) + o;
    uint64_t v[1 << LC];
#pragma unroll
    for (int k = 0; k < (1 << LC); ++k)
      v[k] = ptk::ldg_w(x + (static_cast<int64_t>(k) << G.logs) + off);
    ptk::radix<LC, false>(v, w, ws, 1, q);
    const int p = ptk::pad_w<uint64_t>(off);
#pragma unroll
    for (int k = 0; k < (1 << LC); ++k) sh[k][p] = v[k];
  }
}

// The crossing stages fused with the row's store (inverse): block `rank`
// reads the C words at each of its offsets from the C shares, runs the
// logc stages, multiplies by the scale and writes them to device memory.
template <int LC>
__device__ __forceinline__ void crossing_store(uint64_t* s,
                                               cg::cluster_group& cluster,
                                               const ptk::ClusterGeom& G,
                                               int rank, uint64_t* out,
                                               const uint64_t* w,
                                               const uint64_t* ws, uint64_t q,
                                               uint64_t sc, uint64_t scs) {
  uint64_t* sh[1 << LC];
#pragma unroll
  for (int k = 0; k < (1 << LC); ++k) sh[k] = cluster.map_shared_rank(s, k);
  const int per = 1 << (G.logs - LC);
  for (int o = threadIdx.x; o < per; o += blockDim.x) {
    const int off = (rank << (G.logs - LC)) + o;
    const int p = ptk::pad_w<uint64_t>(off);
    uint64_t v[1 << LC];
#pragma unroll
    for (int k = 0; k < (1 << LC); ++k) v[k] = sh[k][p];
    ptk::radix<LC, true>(v, w, ws, 1, q);
#pragma unroll
    for (int k = 0; k < (1 << LC); ++k)
      out[(static_cast<int64_t>(k) << G.logs) + off] = shoup(v[k], sc, scs, q);
  }
}

// One cluster a row: block `rank` owns the row's share [rank S,
// (rank + 1) S).  Clusters run limb-major (cluster c: limb c / groups,
// group c % groups), so that the groups' rows of one limb, which read
// the same table row, run side by side and all but the first read it
// from L2.  With more than one block a row, the crossing stages run in
// the load (forward) or the store (inverse): crossing_load,
// crossing_store.  With kPair (log S = 1 mod 3, as at N = 2^16 on 8
// blocks), the stage that pairs neighbours, which would take a local
// pass of its own, runs on the two words a thread holds in the prologue
// (inverse) or the epilogue (forward): word pair v of the share is the
// row's pair rank S / 2 + v, whose twiddle is entry N / 2 + rank S / 2 +
// v.
template <bool kInverse, bool kPair>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
ntt64_cluster_kernel(Ntt64Args a, ptk::ClusterGeom G) {
  extern __shared__ uint64_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x >> G.logc;
  const int j = c / a.groups;  // once per block
  const int row = (c - j * a.groups) * a.num_l + j;
  const int limb = a.rows[j];
  const uint64_t q = a.q[limb], q2 = 2 * q;
  const int vecs = 1 << (G.logs - 1);
  const int64_t row0 = static_cast<int64_t>(row) << G.logn;
  const int64_t base = row0 + (static_cast<int64_t>(rank) << G.logs);
  const int64_t trow = static_cast<int64_t>(limb) << G.logn;
  const uint64_t* w = a.w + trow;
  const uint64_t* ws = a.ws + trow;
  // the pair stage's twiddles: entry N / 2 + rank S / 2 + v
  const int64_t pair_tw = (int64_t{1} << (G.logn - 1)) +
                          (static_cast<int64_t>(rank) << (G.logs - 1));
  const ptk::OneRow<uint64_t> one{w, ws, q};
  if (kInverse) {
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      const ulonglong2 xv = ld2(a.x + base + 2 * v);
      uint64_t u = xv.x, t = xv.y;
      if (kPair)
        ptk::gs_lazy(u, t, ptk::ldg_w(w + pair_tw + v),
                     ptk::ldg_w(ws + pair_tw + v), q, q2);
      s[ptk::pad_w<uint64_t>(2 * v)] = u;
      s[ptk::pad_w<uint64_t>(2 * v + 1)] = t;
    }
    __syncthreads();
    ptk::local_intt<kPair ? 1 : 0>(s, G, rank, one);
    const uint64_t sc = a.scale[j], scs = a.scale_shoup[j];
    if (G.logc > 0) {
      cluster.sync();
      if (G.logc == 1)
        crossing_store<1>(s, cluster, G, rank, a.out + row0, w, ws, q, sc,
                          scs);
      else if (G.logc == 2)
        crossing_store<2>(s, cluster, G, rank, a.out + row0, w, ws, q, sc,
                          scs);
      else
        crossing_store<3>(s, cluster, G, rank, a.out + row0, w, ws, q, sc,
                          scs);
      cluster.sync();  // no block leaves while another reads its share
      return;
    }
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      ulonglong2 y;
      y.x = shoup(s[ptk::pad_w<uint64_t>(2 * v)], sc, scs, q);
      y.y = shoup(s[ptk::pad_w<uint64_t>(2 * v + 1)], sc, scs, q);
      *reinterpret_cast<ulonglong2*>(a.out + base + 2 * v) = y;
    }
    return;
  }
  if (G.logc > 0) {
    cluster.sync();  // every block runs: its share may be written
    if (G.logc == 1)
      crossing_load<1>(s, cluster, G, rank, a.x + row0, w, ws, q);
    else if (G.logc == 2)
      crossing_load<2>(s, cluster, G, rank, a.x + row0, w, ws, q);
    else
      crossing_load<3>(s, cluster, G, rank, a.x + row0, w, ws, q);
    cluster.sync();
  } else {
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      const ulonglong2 xv = ld2(a.x + base + 2 * v);
      s[ptk::pad_w<uint64_t>(2 * v)] = xv.x;
      s[ptk::pad_w<uint64_t>(2 * v + 1)] = xv.y;
    }
    __syncthreads();
  }
  ptk::local_ntt_rows<kPair ? 1 : 0>(s, G, rank, one);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint64_t u = s[ptk::pad_w<uint64_t>(2 * v)];
    uint64_t t = s[ptk::pad_w<uint64_t>(2 * v + 1)];
    if (kPair)
      ptk::ct_lazy(u, t, ptk::ldg_w(w + pair_tw + v),
                   ptk::ldg_w(ws + pair_tw + v), q, q2);
    ulonglong2 y;
    y.x = ptk::canon(u, q);
    y.y = ptk::canon(t, q);
    *reinterpret_cast<ulonglong2*>(a.out + base + 2 * v) = y;
  }
}

template <bool kInverse, bool kPair>
cudaError_t launch(const Ntt64Args& a, const ptk::ClusterGeom& G, int rows,
                   int threads, int smem, cudaStream_t stream) {
  auto kernel = ntt64_cluster_kernel<kInverse, kPair>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << G.logc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows << G.logc);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a, G);
  if (e != cudaSuccess) return e;
  launched.fetch_add(1);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptk64

using namespace ptk64;

extern "C" {

// The kernel launches U1 has made (chip_smoke.py divides them by the
// wrapper's calls: one a call).
long long ptk_u64_ntt_launches() { return launched.load(); }

// U1.  out, x: (groups, num_l, 2^logn) words, 16-byte aligned; q: the
// base's moduli; tw, tws: (base rows, N) twiddles and Shoup words (forward
// or inverse tables); rows: (num_l,) table row of each limb; scale,
// scale_shoup: (num_l,) the inverse's final factor (null for the
// forward).  The geometry (ops/ntt.py u64_geometry): 2^logc blocks a row,
// `threads` a block, `smem` bytes of shared memory a block, at least the
// padded share's.
int ptk_u64_ntt(void* out, const void* x, const void* q, const void* tw,
                const void* tws, const void* rows, const void* scale,
                const void* scale_shoup, int groups, int num_l, int logn,
                int inverse, int logc, int threads, int smem, void* stream) {
  const ptk::ClusterGeom G{logn, logc, logn - logc};
  const int share = 1 << G.logs;
  if (logn < 1 || logc < 0 || logc > 3 || G.logs < 1 || threads < 1 ||
      threads > kMaxThreads ||
      smem < static_cast<int>(sizeof(uint64_t)) * (share + (share >> 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Ntt64Args a{static_cast<uint64_t*>(out),
                    static_cast<const uint64_t*>(x),
                    static_cast<const uint64_t*>(q),
                    static_cast<const uint64_t*>(tw),
                    static_cast<const uint64_t*>(tws),
                    static_cast<const int32_t*>(rows),
                    static_cast<const uint64_t*>(scale),
                    static_cast<const uint64_t*>(scale_shoup),
                    num_l, groups};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nrows = groups * num_l;
  const bool pair = G.logs % 3 == 1;  // saves a local pass
  return static_cast<int>(
      inverse ? (pair ? launch<true, true>(a, G, nrows, threads, smem, st)
                      : launch<true, false>(a, G, nrows, threads, smem, st))
              : (pair ? launch<false, true>(a, G, nrows, threads, smem, st)
                      : launch<false, false>(a, G, nrows, threads, smem, st)));
}

}  // extern "C"

// The one-pass, cluster-resident, radix-8 NTT core, the library's only
// NTT: forward under K2 (ntt.cu), K3 (bconv_ntt.cu), K4 (modup_ip.cu), K6's
// forward (ntt_roll.cu, through K2), K7 (moddown_rescale.cu) and K8
// (moddown_rows.cu), inverse under K1 (ntt.cu), K6's inverse (through K1)
// and K7's last limb.
//
// The negacyclic transforms of the port's tables: out[k] = p(psi^(2 rev(k)
// + 1)), forward Cooley-Tukey stages m = 1 .. N/2 and inverse
// Gentleman-Sande stages m = N/2 .. 1 over bit-reversed twiddle tables (the
// stage with m groups reads entries [m, 2m); phantom_tpu/host/
// ntt_tables.py), one table row per output row (`rows`).
//
// A row of N = 2^logn words is held by a thread-block cluster of C = 2^logc
// blocks (C <= 8, the portable limit), block r holding the contiguous share
// [r S, (r + 1) S), S = N / C words, in dynamic shared memory.  The row is
// read from device memory once (by the caller's prologue, which writes the
// share) and written once (by the caller's epilogue, which reads it).
//   crossing stages  the stages that pair words S or more apart, that is
//     words at equal offsets in different shares (the first logc stages
//     forward, the last logc inverse).  They run as one radix-C step: a
//     thread loads the C words at one offset from the C shares
//     (cluster.map_shared_rank: distributed shared memory), runs the logc
//     stages in registers and writes the words back; a cluster.sync()
//     before (every share is ready) and one after (no block touches
//     another's share again, so a block may exit or refill its share once
//     it is past it).
//   local stages  the other logs = logn - logc stages, in passes of three
//     (radix 8, one pass 1 or 2 stages when 3 does not divide logs: the
//     last, at the smallest strides, forward; the last, at the largest,
//     inverse): a thread loads the 8 words of one radix-8 unit, 2^ls apart,
//     runs three stages on them in registers and stores them, then one
//     __syncthreads() per pass.  Forward passes fall in stride (ls = logs
//     - 3, logs - 6, ..), inverse passes rise (ls = 0, 3, 6, ..); a pass
//     touches the same units in both directions.
// Each unit loads its 7 twiddles and their 7 Shoup words once (__ldg),
// not once per butterfly.  Butterflies are Harvey's lazy forms, inputs in
// [0, 2q): forward CT keeps words in [0, 4q) between stages (q < 2^30, so
// 4q < 2^32) and the caller canonicalises with `canon` before any
// epilogue; inverse GS keeps them in [0, 2q) and the caller's Shoup
// product by the scale takes any 32-bit word.
//
// A cluster may hold several rows at once, a share of each per block (K8:
// the rows of one block of output rows): each pass then spreads the units
// of all of them over the block's threads between the same barriers
// (cluster_ntt_rows), so the barriers do not multiply with the rows.
//
// Shared memory is indexed l + (l >> 5) (one pad word per 32), and the
// units of a pass with ls < 5 are spread over the warp's lanes so that the
// 32 lanes of a load or store hit 32 banks (unit_of); contiguous accesses
// by the prologue and epilogue are conflict-free too.  Every size is a
// power of two, so all index math is shifts and masks.
//
// Bound: a 2^16-word row moves 256 KB in and 256 KB out (0.16 us at
// 3.35 TB/s) and reads its table row with the Shoup words, 512 KB, which
// the rows of one limb share in L2.  Its 2^15 x 16 butterflies at about ten
// 32-bit instructions each (the Shoup product, the lazy add and subtract,
// the shared-memory traffic per three stages) are 5.2 M instructions, 0.3
// us of the card's 16.7 T/s 32-bit multiply-add lanes: the transform alone
// is instruction bound, within 2x of the bytes, and the prologues and
// epilogues around it (a 22-term product-sum per word, the evk stream)
// decide which bound a kernel meets.  Times per kernel are in PERF.md.

#pragma once

#include <cooperative_groups.h>

#include "modarith.cuh"

namespace ptk {

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 512;  // threads per block (S >= 2048)

// NTT tables over a whole base, (Lt,) moduli and (Lt, N) twiddles with
// their Shoup words; row j of a group of L rows transforms with table row
// rows[j].
struct NttTables {
  const uint32_t* q;
  const uint32_t* w;
  const uint32_t* ws;
  const int32_t* rows;
  int L;
};

// Forward epilogue (apply_epilogue4): (sub - x) esc, then the tensor-term
// add (add_tensor4).  Null pointers switch a step off.
struct FwdEpilogue {
  const uint32_t* sub;  // (rows, N), row by row of the output
  const uint32_t* esc;  // (L,) and its Shoup words
  const uint32_t* escs;
  const uint32_t* d1;   // (2, L, N) each
  const uint32_t* d2;
};

struct ClusterGeom {
  int logn, logc, logs;  // N = 2^logn, C = 2^logc, S = 2^logs
};

__device__ __forceinline__ int pad(int l) { return l + (l >> 5); }

// words of dynamic shared memory for a share of 2^logs words (a multiple
// of 4, so a buffer after it is 16-byte aligned)
__host__ __device__ inline int cluster_smem_words(int logs) {
  return (1 << logs) + ((1 << logs) >> 5);
}

// threads per block for a share of 2^logs words: 4 words a thread in the
// contiguous phases, at most kClusterThreads
inline int cluster_threads(int logs) {
  const int t = (1 << logs) / 4;
  return t < kClusterThreads ? t : kClusterThreads;
}

// Harvey's lazy CT butterfly: u, v in [0, 4q) -> [0, 4q).
__device__ __forceinline__ void ct_lazy(uint32_t& u, uint32_t& v, uint32_t w,
                                        uint32_t ws, uint32_t q,
                                        uint32_t q2) {
  const uint32_t x = u >= q2 ? u - q2 : u;
  const uint32_t t = mul_shoup_lazy(v, w, ws, q);
  u = x + t;
  v = x - t + q2;
}

// Harvey's lazy GS butterfly: u, v in [0, 2q) -> [0, 2q).
__device__ __forceinline__ void gs_lazy(uint32_t& u, uint32_t& v, uint32_t w,
                                        uint32_t ws, uint32_t q,
                                        uint32_t q2) {
  const uint32_t a = u + v;
  const uint32_t d = u - v + q2;  // in (0, 4q)
  u = a >= q2 ? a - q2 : a;
  v = mul_shoup_lazy(d, w, ws, q);
}

// [0, 4q) -> [0, q)
__device__ __forceinline__ uint32_t canon(uint32_t x, uint32_t q) {
  x = x >= 2 * q ? x - 2 * q : x;
  return x >= q ? x - q : x;
}

// R stages on 2^R words x[k] = row[base + k * stride] in registers.  The
// stages are levels 0 .. R - 1 from the widest stride down, forward in
// that order, inverse in reverse; at level s word k belongs to group
// (g1 << s) + (k >> (R - s)) (its twiddle index), g1 the group at level 0.
template <int R, bool kInverse>
__device__ __forceinline__ void radix(uint32_t (&x)[1 << R],
                                      const uint32_t* __restrict__ w,
                                      const uint32_t* __restrict__ ws,
                                      int g1, uint32_t q) {
  uint32_t tw[(1 << R) - 1], tws[(1 << R) - 1];
#pragma unroll
  for (int s = 0; s < R; ++s)
#pragma unroll
    for (int b = 0; b < (1 << s); ++b) {
      tw[(1 << s) - 1 + b] = __ldg(w + (g1 << s) + b);
      tws[(1 << s) - 1 + b] = __ldg(ws + (g1 << s) + b);
    }
  const uint32_t q2 = 2 * q;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = kInverse ? R - 1 - i : i;
    const int half = 1 << (R - 1 - s);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if (k & half) continue;
      const int b = (1 << s) - 1 + (k >> (R - s));
      if (kInverse)
        gs_lazy(x[k], x[k + half], tw[b], tws[b], q, q2);
      else
        ct_lazy(x[k], x[k + half], tw[b], tws[b], q, q2);
    }
  }
}

// The rows a cluster transforms at once, one share of each per block:
// row i's share at s + i * words(), transformed with table row w(i),
// ws(i) and modulus q(i).  One row is OneRow; K8 holds several
// (moddown_rows.cu, HeldRows).
struct OneRow {
  const uint32_t* tw;
  const uint32_t* tws;
  uint32_t mod;
  __device__ __forceinline__ int count() const { return 1; }
  __device__ __forceinline__ int words() const { return 0; }
  __device__ __forceinline__ const uint32_t* w(int) const { return tw; }
  __device__ __forceinline__ const uint32_t* ws(int) const { return tws; }
  __device__ __forceinline__ uint32_t q(int) const { return mod; }
};

// Unit u of a local pass of R stages whose last stage pairs words 2^ls
// apart -> (hi, lo): the unit's words are (hi << (ls + R)) | lo | (k << ls).
// For ls >= 5 consecutive units are consecutive words.  For ls < 5 the
// lanes of a warp take 2^ls values of lo and hi values 2^(5-R) apart, and
// the warp index supplies the rest, so that with the padded index each
// access of the warp touches 32 banks (needs 2^(10 - R) units: S >= 1024).
__device__ __forceinline__ void unit_of(int u, int ls, int R, int& hi,
                                        int& lo) {
  lo = u & ((1 << ls) - 1);
  if (ls >= 5) {
    hi = u >> ls;
    return;
  }
  const int sp = 5 - R;
  hi = ((u >> 5) & ((1 << sp) - 1)) | (((u & 31) >> ls) << sp) |
       ((u >> (5 + sp)) << (sp + 5 - ls));
}

// A pass of R stages whose smallest stride is 2^ls, over every row of
// `rows` (a row's units are 2^(logs - R) consecutive values of t, whole
// warps, so unit_of's lane spread holds per row).  For OneRow, count() is
// the constant 1, so i folds to 0 and u to t: no index work is added.
template <int R, bool kInverse, class Rows>
__device__ __forceinline__ void local_pass(uint32_t* s, const ClusterGeom& G,
                                           int rank, int ls,
                                           const Rows& rows) {
  // m = N / 2^(ls + R) groups at the pass's widest stage; the share's
  // first group is rank << (logs - ls - R)
  const int g0 = (1 << (G.logn - ls - R)) + (rank << (G.logs - ls - R));
  const int lu = G.logs - R;  // 2^lu units per row
  const int units = rows.count() << lu;
  for (int t = threadIdx.x; t < units; t += blockDim.x) {
    const int i = rows.count() == 1 ? 0 : t >> lu;
    int hi, lo;
    unit_of(t - (i << lu), ls, R, hi, lo);
    uint32_t* si = s + i * rows.words();
    const int base = (hi << (ls + R)) | lo;
    uint32_t x[1 << R];
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) x[k] = si[pad(base + (k << ls))];
    radix<R, kInverse>(x, rows.w(i), rows.ws(i), g0 + hi, rows.q(i));
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) si[pad(base + (k << ls))] = x[k];
  }
}

// The logc crossing stages: radix C over the cluster's shares at equal
// offsets; block `rank` serves offsets [rank S / C, (rank + 1) S / C) of
// every row of `rows`.
template <int LC, bool kInverse, class Rows>
__device__ __forceinline__ void crossing_pass(uint32_t* s,
                                              cg::cluster_group& cluster,
                                              const ClusterGeom& G, int rank,
                                              const Rows& rows) {
  uint32_t* sh[1 << LC];
#pragma unroll
  for (int k = 0; k < (1 << LC); ++k) sh[k] = cluster.map_shared_rank(s, k);
  const int lp = G.logs - LC;  // 2^lp offsets per row
  const int per = rows.count() << lp;
  const int first = rank << lp;
  for (int o = threadIdx.x; o < per; o += blockDim.x) {
    const int i = rows.count() == 1 ? 0 : o >> lp;
    const int p = i * rows.words() + pad(first + o - (i << lp));
    uint32_t x[1 << LC];
#pragma unroll
    for (int k = 0; k < (1 << LC); ++k) x[k] = sh[k][p];
    radix<LC, kInverse>(x, rows.w(i), rows.ws(i), 1, rows.q(i));
#pragma unroll
    for (int k = 0; k < (1 << LC); ++k) sh[k][p] = x[k];
  }
}

// All log N forward stages on the rows whose shares this block holds in s
// (written by every thread of every block of the cluster before the call,
// [0, 2q)).
// Returns with the shares in [0, 4q) and the block synchronised; no block
// touches another's shares after the call.  Uniform over the cluster.
template <class Rows>
__device__ __forceinline__ void cluster_ntt_rows(uint32_t* s,
                                                 cg::cluster_group& cluster,
                                                 const ClusterGeom& G,
                                                 int rank, const Rows& rows) {
  if (G.logc > 0) {
    cluster.sync();
    if (G.logc == 1)
      crossing_pass<1, false>(s, cluster, G, rank, rows);
    else if (G.logc == 2)
      crossing_pass<2, false>(s, cluster, G, rank, rows);
    else
      crossing_pass<3, false>(s, cluster, G, rank, rows);
    cluster.sync();
  } else {
    __syncthreads();
  }
  for (int left = G.logs; left > 0;) {
    const int r = left >= 3 ? 3 : left;
    left -= r;
    if (r == 3)
      local_pass<3, false>(s, G, rank, left, rows);
    else if (r == 2)
      local_pass<2, false>(s, G, rank, left, rows);
    else
      local_pass<1, false>(s, G, rank, left, rows);
    __syncthreads();
  }
}

// cluster_ntt_rows on one row, table row w, ws, modulus q.
__device__ __forceinline__ void cluster_ntt(uint32_t* s,
                                            cg::cluster_group& cluster,
                                            const ClusterGeom& G, int rank,
                                            const uint32_t* __restrict__ w,
                                            const uint32_t* __restrict__ ws,
                                            uint32_t q) {
  cluster_ntt_rows(s, cluster, G, rank, OneRow{w, ws, q});
}

// The inverse of cluster_ntt on the row whose share this block holds in s
// (written by every thread of the block before the call, [0, 2q)): the
// local passes, strides rising, then the crossing stages.  Returns with
// the share in [0, 2q) and the block synchronised; no block touches
// another's share after the call.  Uniform over the cluster.
__device__ __forceinline__ void cluster_intt(uint32_t* s,
                                             cg::cluster_group& cluster,
                                             const ClusterGeom& G, int rank,
                                             const uint32_t* __restrict__ w,
                                             const uint32_t* __restrict__ ws,
                                             uint32_t q) {
  const OneRow row{w, ws, q};
  __syncthreads();
  for (int ls = 0; ls < G.logs;) {
    const int r = G.logs - ls >= 3 ? 3 : G.logs - ls;
    if (r == 3)
      local_pass<3, true>(s, G, rank, ls, row);
    else if (r == 2)
      local_pass<2, true>(s, G, rank, ls, row);
    else
      local_pass<1, true>(s, G, rank, ls, row);
    ls += r;
    __syncthreads();
  }
  if (G.logc > 0) {
    cluster.sync();
    if (G.logc == 1)
      crossing_pass<1, true>(s, cluster, G, rank, row);
    else if (G.logc == 2)
      crossing_pass<2, true>(s, cluster, G, rank, row);
    else
      crossing_pass<3, true>(s, cluster, G, rank, row);
    cluster.sync();
  }
}

__device__ __forceinline__ uint4 ld4(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st4(uint32_t* p, uint32_t a, uint32_t b,
                                    uint32_t c, uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

__device__ __forceinline__ uint32_t lane4(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// x[0..3] += c_g at row positions gi .. gi + 3 of Ql row j (gi a multiple
// of 4; 16-byte loads): c_0 = d1[0] d2[0], c_1 = d1[0] d2[1] + d1[1] d2[0]
// (the relinearization's tensor terms); nothing when e.d1 is null.
__device__ __forceinline__ void add_tensor4(const FwdEpilogue& e,
                                            uint32_t (&x)[4], int j, int g,
                                            int L, int64_t gi, int n,
                                            const Barrett& bq) {
  if (e.d1 == nullptr) return;
  const uint32_t q = bq.q;
  const int64_t o0 = static_cast<int64_t>(j) * n + gi;
  const int64_t o1 = static_cast<int64_t>(L + j) * n + gi;
  const uint4 a0 = ld4(e.d1 + o0), b0 = ld4(e.d2 + o0);
  if (g == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      x[c] = add_mod(x[c], mul_mod(lane4(a0, c), lane4(b0, c), bq), q);
  } else {
    const uint4 a1 = ld4(e.d1 + o1), b1 = ld4(e.d2 + o1);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      x[c] = add_mod(
          x[c],
          reduce64(static_cast<uint64_t>(lane4(a0, c)) * lane4(b1, c) +
                       static_cast<uint64_t>(lane4(a1, c)) * lane4(b0, c),
                   bq),
          q);
  }
}

// The forward epilogue on the four words x[0..3] at row positions gi ..
// gi + 3 (gi a multiple of 4), with 16-byte loads of sub, d1 and d2.
__device__ __forceinline__ void apply_epilogue4(const FwdEpilogue& e,
                                                uint32_t (&x)[4], int row,
                                                int j, int g, int L,
                                                int64_t gi, int n,
                                                const Barrett& bq) {
  const uint32_t q = bq.q;
  if (e.sub != nullptr) {
    const uint4 sv = ld4(e.sub + static_cast<int64_t>(row) * n + gi);
    const uint32_t w = __ldg(e.esc + j), ws = __ldg(e.escs + j);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      x[c] = mul_shoup(sub_mod(lane4(sv, c), x[c], q), w, ws, q);
  }
  add_tensor4(e, x, j, g, L, gi, n, bq);
}

// Launch `kernel` over `clusters` clusters of 2^logc blocks each, with the
// share's dynamic shared memory and `extra` words after it; returns the
// first CUDA error.  A block has cluster_threads(logs) threads, or with
// kThreads that many, at most one per 4 words of the share.  With
// kCheckFit, a configuration of which the card cannot hold one cluster
// (cudaOccupancyMaxActiveClusters) is refused with
// cudaErrorInvalidConfiguration before the launch.  With kDependent, a
// programmatic dependent launch: its blocks may start once every block of
// the kernel before it on the stream has run
// griddepcontrol.launch_dependents, and must run griddepcontrol.wait
// before they read what that kernel writes.
template <bool kCheckFit = false, int kThreads = 0, bool kDependent = false,
          class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, int clusters, int logc, int logs,
                           int extra, cudaStream_t stream, Args... args) {
  const int smem =
      (cluster_smem_words(logs) + extra) * static_cast<int>(sizeof(uint32_t));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << logc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters << logc);
  const int most = (1 << logs) / 4;
  cfg.blockDim = dim3(kThreads == 0 ? cluster_threads(logs)
                      : kThreads < most ? kThreads : most);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = kDependent ? 2 : 1;
  if (kCheckFit) {
    int fit = 0;
    e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (fit == 0) return cudaErrorInvalidConfiguration;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

inline int log2_of(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

}  // namespace ptk

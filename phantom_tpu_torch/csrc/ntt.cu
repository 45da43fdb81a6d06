// K1 and K2: the per-row negacyclic NTTs with their fused prologues and
// epilogues.
//
// K2 replaces phantom_tpu/ops/ntt_mxu_pallas.py:ntt_forward_mxu_pallas
// (body _fwd_kernel) and K1 replaces ntt_inverse_mxu_pallas (body
// _inv_kernel).  The TPU kernels run a four-step transform as int8
// digit-plane matmuls on the MXU; here the butterflies use native
// 32x32->64 Shoup products.
//
// Both run on the one-pass, cluster-resident radix-8 core
// (ntt_cluster.cuh): one cluster of C blocks per row, one launch per call,
// C the wrapper's default unless the caller picks one (K1 shares of 2^13
// words, K2 of 2^14: ops/ntt_kernels.py).  K6 (ntt_roll.cu) runs the same
// two kernels through ptk_ntt_forward and ptk_ntt_inverse.
//
// K2 (cluster_ntt): each block reads its share of x ([0, 2q), which the
// core takes as it is) with 16-byte loads, the cluster runs the crossing
// stages and the local Cooley-Tukey passes, and each block brings its
// share to [0, q), applies the epilogue (sub_from, epi_scale and the
// tensor adds, apply_epilogue4) and stores it with 16-byte stores: the
// row crosses device memory once each way.  Bound at the headline modup's
// (87, N): x and out 22.8 MB each, 87 table rows with Shoup words 44.6 MB,
// 0.027 ms at 3.35 TB/s.  K2 is held to three 512-thread blocks per SM
// (`__launch_bounds__`), as K1 is, which beats two (chip_smoke.py phase
// 26 times both).
//
// K1 (cluster_intt): each block reads its share with 16-byte loads (times
// mul_by, both reduced first, when given), the cluster runs the local
// Gentleman-Sande passes and the crossing stages, and each block
// multiplies its share by the limb's scale (n^-1 Qhat^-1, a Shoup product
// that takes the lazy [0, 2q) words) and stores it with 16-byte stores.  The row never makes a round trip
// through device memory, and a two-row call (the rescale's and BGV's mod
// switch's (2, 1, N)) is two clusters.  The kernel is held to 40
// registers, three 512-thread blocks per SM, so that the moddown's and
// the modup's 352 and 344 blocks run in one wave; that spills 96 bytes
// and still beats two blocks per SM (chip_smoke.py phase 26, PERF.md).
//
// K1's emit_floor_div output v = floor(sum_l y_l / q_l) per group sums
// over the rows of a group, which live in different clusters, so it
// cannot ride the transform as the TPU's sequential grid lets it; a
// second launch in the same call reads the scaled rows back (from L2 at
// the moddown's (2, 22, N), 11.5 MB) and runs the three-level 2^32
// cascade of phantom_tpu/ops/bconv32.py:floor_sum_div32 exactly, each
// floor by a 32-bit Shoup product: four lanes share four columns (16-byte
// loads), each a quarter of the rows, and add their exact sums by
// shuffles.  Atomics into a zeroed (G, 3, N) u64 scratch from the
// transform's epilogue would be exact too, but would still need that
// scratch zeroed and a pass to finish v, and the cascade's work stays the
// same; they were not built.
//
// K1's bound: device memory.  At the modup's (43, N) with mul_by, N = 2^16, a
// call reads x and mul_by (22.5 MB) and 43 table rows with Shoup words
// (22.5 MB) and writes 11.3 MB: 0.017 ms at 3.35 TB/s.  The transform's
// instructions (ntt_cluster.cuh) stay within 2x of that; what the kernel
// spends beyond, in the local passes' barriers and twiddle fetches, is
// measured in PERF.md.

#include "ntt_cluster.cuh"

namespace ptk {
namespace {

struct InvArgs {
  const uint32_t* x;       // (nrows, N) in [0, 2q)
  const uint32_t* mul_by;  // optional (nrows, N): transform x * mul_by
  const uint32_t* scale;   // (L,) replaces n^-1
  const uint32_t* scale_shoup;
};

// K2: one cluster per row; block `rank` owns the row's share [rank S,
// (rank + 1) S).
__global__ void __launch_bounds__(kClusterThreads, 3)
fwd_cluster_kernel(const uint32_t* x, NttTables tb, FwdEpilogue epi,
                   ClusterGeom G, uint32_t* out) {
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x >> G.logc;
  const int g = row / tb.L, j = row - g * tb.L;  // once per block
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const int vecs = 1 << (G.logs - 2);
  const int64_t share = static_cast<int64_t>(rank) << G.logs;
  const int64_t base = (static_cast<int64_t>(row) << G.logn) + share;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    const uint4 xv = ld4(x + base + 4 * v);
#pragma unroll
    for (int c = 0; c < 4; ++c) s[pad(4 * v + c)] = lane4(xv, c);
  }
  const int64_t trow = static_cast<int64_t>(limb) << G.logn;
  cluster_ntt(s, cluster, G, rank, tb.w + trow, tb.ws + trow, bq.q);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint32_t y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = canon(s[pad(4 * v + c)], bq.q);
    apply_epilogue4(epi, y, row, j, g, tb.L, share + 4 * v, 1 << G.logn, bq);
    st4(out + base + 4 * v, y[0], y[1], y[2], y[3]);
  }
}

// K1: one cluster per row; block `rank` owns the row's share [rank S,
// (rank + 1) S).
__global__ void __launch_bounds__(kClusterThreads, 3)
inv_cluster_kernel(InvArgs a, NttTables tb, ClusterGeom G, uint32_t* out) {
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x >> G.logc;
  const int j = row % tb.L;  // once per block
  const int limb = tb.rows[j];
  const uint32_t q = tb.q[limb];
  const int vecs = 1 << (G.logs - 2);
  const int64_t base = (static_cast<int64_t>(row) << G.logn) +
                       (static_cast<int64_t>(rank) << G.logs);
  if (a.mul_by != nullptr) {
    const Barrett bq = make_barrett(q);
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      const uint4 xv = ld4(a.x + base + 4 * v);
      const uint4 mv = ld4(a.mul_by + base + 4 * v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[pad(4 * v + c)] =
            mul_mod(csub(lane4(xv, c), q), csub(lane4(mv, c), q), bq);
    }
  } else {
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      const uint4 xv = ld4(a.x + base + 4 * v);
#pragma unroll
      for (int c = 0; c < 4; ++c) s[pad(4 * v + c)] = lane4(xv, c);
    }
  }
  const int64_t trow = static_cast<int64_t>(limb) << G.logn;
  cluster_intt(s, cluster, G, rank, tb.w + trow, tb.ws + trow, q);
  const uint32_t sc = a.scale[j], scs = a.scale_shoup[j];
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint32_t x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      x[c] = mul_shoup(s[pad(4 * v + c)], sc, scs, q);
    st4(out + base + 4 * v, x[0], x[1], x[2], x[3]);
  }
}

constexpr int kFloorThreads = 256;
constexpr int kFloorSplit = 4;  // lanes per column quad, a slice of rows each

// (floor(x V / q), x V mod q) for any 32-bit x, V < q, Vs = floor(V 2^32 /
// q): Shoup's product, whose quotient estimate is at most one short.
__device__ __forceinline__ uint32_t div_shoup(uint32_t x, uint32_t V,
                                              uint32_t Vs, uint32_t q,
                                              uint32_t& rem) {
  uint32_t k = __umulhi(x, Vs);
  uint32_t r = x * V - k * q;  // in [0, 2q)
  if (r >= q) {
    r -= q;
    ++k;
  }
  rem = r;
  return k;
}

// v[g, c] = floor(sum_l y[g, l, c] / q_l) by the cascade of
// bconv32.floor_sum_div32: per row the 96-bit fixed-point expansion of
// y / q, words a = y U + floor(y V / q), s2 = floor(r1 2^32 / q), s3 =
// floor(r2 2^32 / q) (r1, r2 the remainders; U = floor(2^32 / q), V = 2^32
// mod q), the three word sums taken exactly, then (A 2^64 + B 2^32 + C) >>
// 96.  Since r 2^32 = r U q + r V, each floor is r U + floor(r V / q), one
// 32-bit Shoup product by V: no 64-bit division per word.  kFloorSplit
// lanes share four columns (16-byte loads), each summing every
// kFloorSplit-th row, and add their exact sums by shuffles; the L rows'
// q, U, V and V's Shoup word (one 64-bit division per row per block) in
// shared memory.
__global__ void __launch_bounds__(kFloorThreads)
floor_sum_kernel(const uint32_t* y, NttTables tb, const uint32_t* U,
                 const uint32_t* V, int logn, int64_t vecs, uint32_t* v) {
  extern __shared__ uint32_t rowc[];  // q, U, V, Shoup(V): (L,) each
  uint32_t* us = rowc + tb.L;
  uint32_t* vs = us + tb.L;
  uint32_t* vss = vs + tb.L;
  for (int l = threadIdx.x; l < tb.L; l += blockDim.x) {
    const uint32_t q = tb.q[tb.rows[l]];
    rowc[l] = q;
    us[l] = U[l];
    vs[l] = V[l];
    vss[l] = static_cast<uint32_t>((static_cast<uint64_t>(V[l]) << 32) / q);
  }
  __syncthreads();
  const int part = threadIdx.x & (kFloorSplit - 1);
  const int shift = logn - 2;  // vectors per row = 2^shift
  // every lane runs the same trips: vecs is a multiple of the grid's quads
  for (int64_t idx = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x) / kFloorSplit;
       idx < vecs;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x / kFloorSplit) {
    const int64_t g = idx >> shift, c = (idx & ((1 << shift) - 1)) * 4;
    uint64_t A[4] = {0, 0, 0, 0}, B[4] = {0, 0, 0, 0}, C[4] = {0, 0, 0, 0};
    for (int l = part; l < tb.L; l += kFloorSplit) {
      const uint32_t q = rowc[l], ul = us[l], vl = vs[l], vsl = vss[l];
      const uint4 yv = ld4(y + ((g * tb.L + l) << logn) + c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t yk = lane4(yv, k);
        uint32_t r1, r2, r3;
        const uint32_t q1 = div_shoup(yk, vl, vsl, q, r1);
        A[k] += static_cast<uint64_t>(yk * ul) + q1;
        B[k] += r1 * ul + div_shoup(r1, vl, vsl, q, r2);
        C[k] += r2 * ul + div_shoup(r2, vl, vsl, q, r3);
      }
    }
#pragma unroll
    for (int m = 1; m < kFloorSplit; m <<= 1)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        A[k] += __shfl_xor_sync(0xffffffffu, A[k], m);
        B[k] += __shfl_xor_sync(0xffffffffu, B[k], m);
        C[k] += __shfl_xor_sync(0xffffffffu, C[k], m);
      }
    if (part == 0) {
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = static_cast<uint32_t>(
            (A[k] + ((B[k] + (C[k] >> 32)) >> 32)) >> 32);
      st4(v + (g << logn) + c, o[0], o[1], o[2], o[3]);
    }
  }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

const char* ptk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2.  out, x: (nrows, N); q, w, ws: the whole base's tables; rows: (L,)
// table row of each group row.  sub, esc, escs and d1, d2 may be null.
// cluster: blocks per row, as for ptk_bconv_ntt_forward.
int ptk_ntt_forward(void* out, const void* x, const void* q, const void* w,
                    const void* ws, const void* rows, int L, int nrows,
                    int logn, const void* sub, const void* esc,
                    const void* escs, const void* d1, const void* d2,
                    int cluster, void* stream) {
  const int logc = log2_of(cluster);
  const ClusterGeom G{logn, logc, logn - logc};
  const NttTables tb{static_cast<const uint32_t*>(q),
                     static_cast<const uint32_t*>(w),
                     static_cast<const uint32_t*>(ws),
                     static_cast<const int32_t*>(rows), L};
  const FwdEpilogue epi{static_cast<const uint32_t*>(sub),
                        static_cast<const uint32_t*>(esc),
                        static_cast<const uint32_t*>(escs),
                        static_cast<const uint32_t*>(d1),
                        static_cast<const uint32_t*>(d2)};
  return static_cast<int>(launch_cluster(
      fwd_cluster_kernel, nrows, logc, G.logs, 0,
      static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(x), tb,
      epi, G, static_cast<uint32_t*>(out)));
}

// K1.  winv, winvs: inverse twiddles; scale, scale_shoup: (L,); mul_by may
// be null; v (groups, N) is written when non-null, with U, V: (L,).
// cluster: blocks per row, as for ptk_bconv_ntt_forward.
int ptk_ntt_inverse(void* out, const void* x, const void* q,
                    const void* winv, const void* winvs, const void* rows,
                    int L, int nrows, int logn, const void* mul_by,
                    const void* scale, const void* scale_shoup, void* v,
                    const void* U, const void* V, int cluster, void* stream) {
  const int logc = log2_of(cluster);
  const ClusterGeom G{logn, logc, logn - logc};
  const NttTables tb{static_cast<const uint32_t*>(q),
                     static_cast<const uint32_t*>(winv),
                     static_cast<const uint32_t*>(winvs),
                     static_cast<const int32_t*>(rows), L};
  const InvArgs a{static_cast<const uint32_t*>(x),
                  static_cast<const uint32_t*>(mul_by),
                  static_cast<const uint32_t*>(scale),
                  static_cast<const uint32_t*>(scale_shoup)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaError_t e = launch_cluster(inv_cluster_kernel, nrows, logc, G.logs, 0,
                                 st, a, tb, G, o);
  if (e != cudaSuccess || v == nullptr) return static_cast<int>(e);
  const int64_t vecs = static_cast<int64_t>(nrows / L) << (logn - 2);
  const int blocks = static_cast<int>(
      (vecs * kFloorSplit + kFloorThreads - 1) / kFloorThreads);
  const int smem = L * 16;  // q, U, V, Shoup(V)
  floor_sum_kernel<<<blocks, kFloorThreads, smem, st>>>(
      o, tb, static_cast<const uint32_t*>(U), static_cast<const uint32_t*>(V),
      logn, vecs, static_cast<uint32_t*>(v));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

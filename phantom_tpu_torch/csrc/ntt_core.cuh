// Negacyclic NTT machinery shared by the forward kernels (K2 in ntt.cu,
// K3 in bconv_ntt.cu) and the inverse kernel (K1 in ntt.cu).
//
// Order and tables are the library's: out[k] = p(psi^(2*rev(k)+1)), twiddle
// tables in bit-reversed order, the stage with m groups reading entries
// [m, 2m) (phantom_tpu/host/ntt_tables.py).  Forward: Cooley-Tukey stages
// m = 1 .. N/2; inverse: Gentleman-Sande stages m = N/2 .. 1, each undoing
// its forward counterpart.  Every butterfly keeps its outputs in [0, q).
//
// A 2^16-point u32 row (256 KB) does not fit a block's shared memory, so a
// row of N = n1 * n2 points (n2 = min(N, kTile)) transforms in two passes
// of kTile-word tiles, all stages of a pass in shared memory:
//   column pass: the log2(n1) stages with stride >= n2 act on columns
//     {c + n2 * r}; a tile holds n1 rows x (kTile / n1) adjacent columns;
//   chunk pass:  the log2(n2) stages with stride < n2 act inside contiguous
//     n2-point chunks; a tile is one chunk.
// Forward runs column then chunk; inverse chunk then column.  When
// N <= kTile only the chunk pass runs, over the whole row.
#pragma once

#include "modarith.cuh"

namespace ptk {

constexpr int kTile = 4096;    // u32 words per tile: 16 KB of shared memory
constexpr int kThreads = 512;  // threads per block

struct Geometry {
  int n, n1, n2;
};

inline Geometry make_geometry(int logn) {
  Geometry g;
  g.n = 1 << logn;
  g.n2 = g.n < kTile ? g.n : kTile;
  g.n1 = g.n / g.n2;
  return g;
}

// NTT tables over a whole base, (Lt,) moduli and (Lt, N) twiddles; row j of a
// group of L rows transforms with table row rows[j].
struct NttTables {
  const uint32_t* q;
  const uint32_t* w;
  const uint32_t* ws;
  const int32_t* rows;
  int L;
};

__device__ __forceinline__ void ct_bfly(uint32_t& u, uint32_t& v, uint32_t w,
                                        uint32_t ws, uint32_t q) {
  const uint32_t wv = mul_shoup(v, w, ws, q);
  const uint32_t a = add_mod(u, wv, q);
  v = sub_mod(u, wv, q);
  u = a;
}

__device__ __forceinline__ void gs_bfly(uint32_t& u, uint32_t& v, uint32_t w,
                                        uint32_t ws, uint32_t q) {
  const uint32_t a = add_mod(u, v, q);
  v = mul_shoup(sub_mod(u, v, q), w, ws, q);
  u = a;
}

// global index of tile element e in the column pass
__device__ __forceinline__ int64_t col_index(const Geometry& G, int tile,
                                             int e) {
  const int C = kTile / G.n1;
  return static_cast<int64_t>(e / C) * G.n2 + tile * C + e % C;
}

// Stage with m groups, in the column pass (m < n1): butterfly rows are
// tr = n1 / (2m) apart, group i = r / (2 tr) reads twiddle m + i.
template <bool kInverse>
__device__ __forceinline__ void col_stage(uint32_t* s, const Geometry& G,
                                          int m, const uint32_t* w,
                                          const uint32_t* ws, uint32_t q) {
  const int C = kTile / G.n1;
  const int tr = G.n1 / (2 * m);
  for (int b = threadIdx.x; b < kTile / 2; b += blockDim.x) {
    const int c = b % C, rp = b / C;
    const int i = rp / tr, jr = rp % tr;
    const int lo = (2 * tr * i + jr) * C + c;
    if (kInverse)
      gs_bfly(s[lo], s[lo + tr * C], w[m + i], ws[m + i], q);
    else
      ct_bfly(s[lo], s[lo + tr * C], w[m + i], ws[m + i], q);
  }
  __syncthreads();
}

// Stage with m groups, in the chunk pass (m >= n1): butterflies t = N / (2m)
// apart inside the chunk; the chunk's first group is tile * n2 / (2t).
template <bool kInverse>
__device__ __forceinline__ void chunk_stage(uint32_t* s, const Geometry& G,
                                            int tile, int m,
                                            const uint32_t* w,
                                            const uint32_t* ws, uint32_t q) {
  const int t = G.n / (2 * m);
  const int base = m + tile * (G.n2 / (2 * t));
  for (int b = threadIdx.x; b < G.n2 / 2; b += blockDim.x) {
    const int il = b / t, j = b % t;
    const int lo = 2 * t * il + j;
    if (kInverse)
      gs_bfly(s[lo], s[lo + t], w[base + il], ws[base + il], q);
    else
      ct_bfly(s[lo], s[lo + t], w[base + il], ws[base + il], q);
  }
  __syncthreads();
}

// Forward epilogue: (sub_from - x) * epi_scale, then the tensor-term add
// (group 0: d1[0] d2[0]; group 1: d1[0] d2[1] + d1[1] d2[0]).  Null
// pointers switch a step off.
struct FwdEpilogue {
  const uint32_t* sub;
  const uint32_t* esc;
  const uint32_t* escs;
  const uint32_t* d1;
  const uint32_t* d2;

  __device__ __forceinline__ uint32_t apply(uint32_t x, int row, int j,
                                            int g, int L, int64_t gi, int n,
                                            const Barrett& bq) const {
    const uint32_t q = bq.q;
    if (sub != nullptr)
      x = mul_shoup(sub_mod(sub[static_cast<int64_t>(row) * n + gi], x, q),
                    esc[j], escs[j], q);
    if (d1 != nullptr) {
      const int64_t o0 = static_cast<int64_t>(j) * n + gi;
      const int64_t o1 = static_cast<int64_t>(L + j) * n + gi;
      uint32_t t;
      if (g == 0)
        t = mul_mod(d1[o0], d2[o0], bq);
      else
        t = reduce64(static_cast<uint64_t>(d1[o0]) * d2[o1] +
                         static_cast<uint64_t>(d1[o1]) * d2[o0],
                     bq);
      x = add_mod(x, t, q);
    }
    return x;
  }
};

// The plain prologue (K2's, and K8's chunk pass): the row as stored, lazy
// [0, 2q) tolerated.
struct RowLoad {
  static constexpr bool kStoreSkipped = true;
  const uint32_t* x;
  __device__ __forceinline__ bool skip(int, int) const { return false; }
  __device__ __forceinline__ uint32_t load(int row, int, int, int64_t gi,
                                           int n, const Barrett& bq,
                                           bool) const {
    return csub(x[static_cast<int64_t>(row) * n + gi], bq.q);
  }
};

// Forward column pass: prologue load, column stages, raw store to out.
// Pro supplies skip(j, g) (row passes through untransformed),
// load(row, j, g, gi, n, bq, skip) (the canonical input value) and
// kStoreSkipped (false: a skipped row is not stored at all).
template <class Pro>
__global__ void __launch_bounds__(kThreads)
fwd_col_kernel(Pro pro, NttTables tb, Geometry G, uint32_t* out) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int j = row % tb.L, g = row / tb.L;
  const bool skip = pro.skip(j, g);
  if (skip && !Pro::kStoreSkipped) return;  // uniform over the block
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  uint32_t* o = out + static_cast<int64_t>(row) * G.n;
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    s[e] = pro.load(row, j, g, col_index(G, tile, e), G.n, bq, skip);
  __syncthreads();
  if (!skip) {
    const uint32_t* w = tb.w + static_cast<int64_t>(limb) * G.n;
    const uint32_t* ws = tb.ws + static_cast<int64_t>(limb) * G.n;
    for (int m = 1; m < G.n1; m <<= 1) col_stage<false>(s, G, m, w, ws, bq.q);
  }
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    o[col_index(G, tile, e)] = s[e];
}

// Forward chunk pass: load (prologue when it is the only pass, else the
// column pass's output), chunk stages, epilogue store.
template <class Pro>
__global__ void __launch_bounds__(kThreads)
fwd_chunk_kernel(Pro pro, NttTables tb, FwdEpilogue epi, Geometry G,
                 uint32_t* out) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int j = row % tb.L, g = row / tb.L;
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const bool skip = pro.skip(j, g);
  const bool single = G.n1 == 1;
  uint32_t* o = out + static_cast<int64_t>(row) * G.n;
  const int64_t base = static_cast<int64_t>(tile) * G.n2;
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x)
    s[e] = single ? pro.load(row, j, g, base + e, G.n, bq, skip) : o[base + e];
  __syncthreads();
  if (!skip) {
    const uint32_t* w = tb.w + static_cast<int64_t>(limb) * G.n;
    const uint32_t* ws = tb.ws + static_cast<int64_t>(limb) * G.n;
    for (int m = G.n1; m < G.n; m <<= 1)
      chunk_stage<false>(s, G, tile, m, w, ws, bq.q);
  }
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x)
    o[base + e] = epi.apply(s[e], row, j, g, tb.L, base + e, G.n, bq);
}

template <class Pro>
void launch_forward(const Pro& pro, const NttTables& tb,
                    const FwdEpilogue& epi, const Geometry& G, uint32_t* out,
                    int nrows, cudaStream_t stream) {
  const dim3 grid(G.n1, nrows);
  if (G.n1 > 1)
    fwd_col_kernel<Pro><<<grid, kThreads, 0, stream>>>(pro, tb, G, out);
  fwd_chunk_kernel<Pro><<<grid, kThreads, 0, stream>>>(pro, tb, epi, G, out);
}

}  // namespace ptk

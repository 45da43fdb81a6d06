// P1: the local phases of the coefficient-sharded negacyclic NTT, over
// u32 words (q < 2^30) or u64 words (q < 2^61).
//
// Replaces the stage loops the JAX package runs as XLA fusions between
// its sharding constraints: phantom_tpu/parallel/ntt_sharded.py:86-211
// (u64) and phantom_tpu/parallel/sharded32.py:66-161 (u32); no
// pallas_call.  A polynomial of N = n1 n2 coefficients is an (n1, n2)
// matrix whose n2 columns are split over W ranks, c2 = n2 / W each (and
// c1 = n1 / W).  The forward transform runs phase A, the log2 n1
// Cooley-Tukey stages along n1 (one twiddle a stage group, the same in
// every column), on the rank's (L, n1, c2) block; an all-to-all; phase B,
// the log2 n2 stages along n2 on the received (W, L, c2, c1) block, whose
// twiddles change with the global n1 column (the phase-B regions of the
// table are stored transposed, so a tile's columns read consecutive
// words); and an all-to-all back.  The inverse runs the Gentleman-Sande
// stages of phase B first, then those of phase A.  Ranges are Harvey's,
// as the JAX code keeps them: forward in [0, 4q) with u reduced below 2q
// before each butterfly, inverse in [0, 2q); the forward's two final
// conditional subtractions are fused into phase B's store, the inverse's
// scale (N^-1, or the caller's Shoup pair) and its subtraction into
// phase A's.  Outputs are canonical, so P1 is bit-equal to its plain
// version (ops/ntt_phase_kernels.py) and to the local NTT.
//
// Layouts.  A phase transforms R = n1 (A) or n2 (B) rows in each of cols
// = (N / R) / W columns of every limb.  Each phase has one side whose
// rows are contiguous runs of cols words ("column side": the forward's
// input, the inverse's output) and one whose columns are contiguous runs
// of R / W rows ("row side", chunk d of the rows going to rank d: the
// forward's output, the inverse's input), so the exchange needs no
// transpose around it:
//   forward A  (L, n1, c2)     column side -> (W, L, c2, c1) row side
//   forward B  (W, L, c2, c1)  column side -> (W, L, c1, c2) row side
// and the inverse the same maps backwards.  Both sides are fixed by R,
// cols, W and L, and by the phase (A's column side is one chunk), so the
// kernel is specialised per word, direction and phase and its address
// math is shifts, masks and 32-bit adds (the wrapper keeps every tensor
// below 2^31 words).
//
// Design.  A block holds R rows by a tile of T consecutive columns of one
// limb in shared memory (T = 32 u32 or 16 u64 words, 32 KB at R = 256; the
// wrapper halves T for calls of few limbs, so that they still fill the
// card).  The tile is loaded with 16-byte vectors, 8 in flight a thread:
// on the column side 4 u32 or 2 u64 columns of a row, on the row side as
// many rows of a column.  The log2 R stages run as radix-8 register passes
// (the last forward pass, the first inverse one, takes the 1 or 2 stages
// left), one barrier a pass.  A thread holds one column's radix-8 units (8
// words, 2^ls rows apart), the lanes of a warp (u32) or half-warp (u64) on
// consecutive columns of the same rows: a shared-memory access of theirs
// is one row's 128 bytes, a phase-B twiddle one coalesced line.  Phase A's
// stage twiddles, the same in every column, are copied once a block into
// shared memory beside the tile as (twiddle, Shoup word) pairs, one
// broadcast 8- or 16-byte load a pair.  A thread's units run lo first, so
// that those of one group load their 7 twiddles and 7 Shoup words once (at
// R = 256, 38 pairs a thread instead of 80).  The forward then writes the
// row side from the tile, canonical in phase B; the inverse's last pass
// writes the column side itself, times the scale in phase A.  The tile is
// swizzled by 16-byte slot, word (i, j) at row i, column j ^ (((i >> v) &
// (T / V - 1)) << v) (V = 2^v words in 16 bytes), so that the row-wise
// lanes of a pass and the column-wise vectors of the row side both hit 32
// distinct banks; the map is linear, so a unit's words past its first cost
// one XOR each.  At R = 256 a word costs 8 shared-memory accesses and 4
// barriers forward, 6 and 3 inverse (radix-2 stages in shared memory: 18
// and 9).
// PERF.md has its times and what each part costs (p1_anatomy.py).

// Bound, at a (130, 2^16) u32 phase with W = 1: the block is read and
// written once, 68 MB, and phase B reads the rows' transposed twiddles
// and Shoup words, 34 MB more: 0.020 ms (A) and 0.031 ms (B) at 3.35
// TB/s; its 130 x 2^15 x 8 butterflies at three 32-bit multiplies each
// are 0.10 G multiplies, 0.006 ms at 16.7 T/s.  Both phases of a
// transform move twice the bytes of the one-pass core's single read and
// write: that is the price of the exchange between them.

#include <cstdint>

#include "ntt_cluster.cuh"

namespace ptkp {
namespace {

using ptk::canon;
using ptk::ct_lazy;
using ptk::gs_lazy;
using ptk::ldg_w;

constexpr int kThreads = 256;

// 16 bytes of words: V = 2^kLog of them, loaded and stored as one vector
template <typename T>
struct Vec16;

template <>
struct Vec16<uint32_t> {
  static constexpr int kLog = 2;
  using V = uint4;
  using Pair = uint2;  // a twiddle and its Shoup word
  static __device__ __forceinline__ void split(const V& v, uint32_t* w) {
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
  static __device__ __forceinline__ V join(const uint32_t* w) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec16<uint64_t> {
  static constexpr int kLog = 1;
  using V = ulonglong2;
  using Pair = ulonglong2;
  static __device__ __forceinline__ void split(const V& v, uint64_t* w) {
    w[0] = v.x, w[1] = v.y;
  }
  static __device__ __forceinline__ V join(const uint64_t* w) {
    return make_ulonglong2(w[0], w[1]);
  }
};

__device__ __forceinline__ uint32_t lazy(uint32_t x, uint32_t w,
                                         uint32_t ws, uint32_t q) {
  return ptk::mul_shoup_lazy(x, w, ws, q);
}

__device__ __forceinline__ uint64_t lazy(uint64_t x, uint64_t w,
                                         uint64_t ws, uint64_t q) {
  return ptk64::shoup_lazy(x, w, ws, q);
}

template <typename T>
__device__ __forceinline__ T csub(T x, T q) {
  return x >= q ? x - q : x;
}

struct PhaseArgs {
  const void* x;
  void* out;
  const void* q;            // the base's moduli
  const void* tw;           // (base rows, N) twiddles, phase-B regions
  const void* tws;          // transposed, and their Shoup words
  const int32_t* rows;      // (L,) table row of each limb
  const void* scale;        // the inverse's factor, phase A only: (L,),
  const void* scale_shoup;  // or (base rows,) with scale_by_row
  int n;                    // N, a table row's length
  int num_l;                // L
  int logr;                 // R = 2^logr rows a transform
  int logt;                 // T = 2^logt columns a tile
  int logcols;              // cols = 2^logcols columns a limb
  int lc;                   // 2^lc rows a chunk of the row side (R / W)
  int lts;                  // phase B: log2 n1, the twiddles' row stride
  int col0;                 // phase B: global n1 column of local column 0
  int scale_by_row;         // the scale by table row (N^-1), else by limb
  int vec_x, vec_out;       // x, out 16-byte aligned
};

// Word (i, j) of the tile (swizzled by 16-byte slot; see the header).
// The map is linear over XOR in (i, j): (i << logt) ^ j ^ swizzle(i).
template <typename T>
__device__ __forceinline__ int tix(int i, int j, int logt) {
  constexpr int v = Vec16<T>::kLog;
  return (i << logt) ^ j ^ (((i >> v) & ((1 << (logt - v)) - 1)) << v);
}

// Where a pass reads and writes a unit's words: at(i, j) is word (i, j)'s
// index, and word (i | d, j), d's bits clear in i, is join(at(i, j),
// at(d, 0)), so that a unit's words cost one operation each past its
// first.  The tile in shared memory joins by XOR.
template <typename T>
struct Tile {
  T* s;
  int logt;
  __device__ __forceinline__ int at(int i, int j) const {
    return tix<T>(i, j, logt);
  }
  static __device__ __forceinline__ int join(int a, int d) { return a ^ d; }
  __device__ __forceinline__ T ld(int a) const { return s[a]; }
  __device__ __forceinline__ void st(int a, T v) const { s[a] = v; }
};

// 16 bytes of words at p, one vector access where p is 16-byte aligned
// (vec), else a word at a time.
template <typename T>
__device__ __forceinline__ typename Vec16<T>::V ld16(const T* p, bool vec) {
  using W = Vec16<T>;
  if (vec) return __ldg(reinterpret_cast<const typename W::V*>(p));
  T w[1 << W::kLog];
#pragma unroll
  for (int k = 0; k < (1 << W::kLog); ++k) w[k] = ldg_w(p + k);
  return W::join(w);
}

template <typename T>
__device__ __forceinline__ void st16(T* p, const typename Vec16<T>::V& v,
                                     bool vec) {
  using W = Vec16<T>;
  if (vec) {
    *reinterpret_cast<typename W::V*>(p) = v;
    return;
  }
  T w[1 << W::kLog];
  W::split(v, w);
#pragma unroll
  for (int k = 0; k < (1 << W::kLog); ++k) p[k] = w[k];
}

// The column side in device memory from the tile's first column: row i
// of chunk i >> lc at (i >> lc) schunk + (i mod 2^lc) cols (kChunked, phase
// B), else at i cols; it joins by addition.  As the inverse's output of
// phase A it applies the scale (kScale).
template <typename T, bool kChunked, bool kScale>
struct ColSide {
  T* p;
  int lc, logcols, schunk;
  T sc, scs, q;
  __device__ __forceinline__ int at(int i, int j) const {
    if (!kChunked) return (i << logcols) + j;
    return (i >> lc) * schunk + ((i & ((1 << lc) - 1)) << logcols) + j;
  }
  static __device__ __forceinline__ int join(int a, int d) { return a + d; }
  __device__ __forceinline__ void st(int a, T v) const {
    if (kScale) v = csub(lazy(v, sc, scs, q), q);
    p[a] = v;
  }
};

// The row side in device memory from the tile's first column: column j's
// run of chunk i >> lc at (i >> lc) schunk + j 2^lc.
struct RowSide {
  int lc, schunk;
  __device__ __forceinline__ int at(int i, int j) const {
    return (i >> lc) * schunk + (j << lc) + (i & ((1 << lc) - 1));
  }
};

// 16-byte vector e of the tile: on the column side row i's V consecutive
// columns from j; on the row side column j's V consecutive rows from i,
// the lanes of a warp on V columns by 32 / V vectors, so that each
// column's run moves in whole lines and the tile's slots spread over the
// banks.
template <typename T, bool kRowSide>
__device__ __forceinline__ void vector_at(int e, int logr, int logt, int& i,
                                          int& j) {
  constexpr int v = Vec16<T>::kLog;
  if (kRowSide) {
    j = ((e >> logr) << v) | (e & ((1 << v) - 1));
    i = ((e >> v) & ((1 << (logr - v)) - 1)) << v;
  } else {
    i = e >> (logt - v);
    j = (e & ((1 << (logt - v)) - 1)) << v;
  }
}

// Device memory (`side` at src) -> the tile, 16 bytes a vector; a thread
// loads kBatch vectors before it stores any, so that they are in flight
// together.
constexpr int kBatch = 8;

template <bool kRowSide, typename T, class Side>
__device__ __forceinline__ void to_tile(const Tile<T>& tile, const Side& side,
                                        const T* src, bool vec, int logr) {
  using W = Vec16<T>;
  constexpr int v = W::kLog;
  const int vectors = 1 << (logr + tile.logt - v);
  for (int e0 = threadIdx.x; e0 < vectors; e0 += kBatch * blockDim.x) {
    typename W::V buf[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * blockDim.x;
      int i, j;
      vector_at<T, kRowSide>(e, logr, tile.logt, i, j);
      if (e < vectors) buf[k] = ld16(src + side.at(i, j), vec);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e >= vectors) break;
      int i, j;
      vector_at<T, kRowSide>(e, logr, tile.logt, i, j);
      if (kRowSide) {
        T w[1 << v];
        W::split(buf[k], w);
#pragma unroll
        for (int c = 0; c < (1 << v); ++c)
          tile.st(tile.at(i, j) ^ (c << tile.logt), w[c]);
      } else {  // one 16-byte slot of the swizzled row
        *reinterpret_cast<typename W::V*>(tile.s + tile.at(i, j)) = buf[k];
      }
    }
  }
}

// The tile -> the row side in device memory at dst, 16 bytes a vector;
// the forward's phase B canonicalises on the way out (kCanon).
template <bool kCanon, typename T>
__device__ __forceinline__ void to_rows(const Tile<T>& tile,
                                        const RowSide& side, T* dst,
                                        bool vec, int logr, T q) {
  using W = Vec16<T>;
  constexpr int v = W::kLog;
  const int vectors = 1 << (logr + tile.logt - v);
  for (int e = threadIdx.x; e < vectors; e += blockDim.x) {
    int i, j;
    vector_at<T, true>(e, logr, tile.logt, i, j);
    T w[1 << v];
#pragma unroll
    for (int c = 0; c < (1 << v); ++c) {
      w[c] = tile.ld(tile.at(i, j) ^ (c << tile.logt));
      if (kCanon) w[c] = canon(w[c], q);
    }
    st16(dst + side.at(i, j), W::join(w), vec);
  }
}

// The twiddles of a radix-2^r unit of column j whose group at the pass's
// widest stage is g1: at level s its word k belongs to group (g1 << s) +
// (k >> (r - s)), whose twiddle is entry idx of the stage.  Phase A: the
// same in every column, read as a (twiddle, Shoup word) pair from the
// block's copy in shared memory (tw); phase B: entry idx n1 + j of the
// transposed regions in device memory (tw, tws at the tile's first
// column).
template <int r, bool kPhaseB, typename T>
__device__ __forceinline__ void twiddles(T (&w)[(1 << r) - 1],
                                         T (&ws)[(1 << r) - 1], const T* tw,
                                         const T* tws, int g1, int lts,
                                         int j) {
#pragma unroll
  for (int s = 0; s < r; ++s)
#pragma unroll
    for (int b = 0; b < (1 << s); ++b) {
      const int idx = (g1 << s) + b;
      if (kPhaseB) {
        const int o = (idx << lts) + j;
        w[(1 << s) - 1 + b] = ldg_w(tw + o);
        ws[(1 << s) - 1 + b] = ldg_w(tws + o);
      } else {
        const auto pair =
            reinterpret_cast<const typename Vec16<T>::Pair*>(tw)[idx];
        w[(1 << s) - 1 + b] = pair.x;
        ws[(1 << s) - 1 + b] = pair.y;
      }
    }
}

// The r stages on a unit x in registers, x[k] row base + k 2^ls.
template <int r, bool kInverse, typename T>
__device__ __forceinline__ void radix(T (&x)[1 << r],
                                      const T (&w)[(1 << r) - 1],
                                      const T (&ws)[(1 << r) - 1], T q) {
  const T q2 = 2 * q;
#pragma unroll
  for (int i = 0; i < r; ++i) {
    const int s = kInverse ? r - 1 - i : i;
    const int half = 1 << (r - 1 - s);
#pragma unroll
    for (int k = 0; k < (1 << r); ++k) {
      if (k & half) continue;
      const int b = (1 << s) - 1 + (k >> (r - s));
      if (kInverse)
        gs_lazy(x[k], x[k + half], w[b], ws[b], q, q2);
      else
        ct_lazy(x[k], x[k + half], w[b], ws[b], q, q2);
    }
  }
}

// The index of word k of a unit whose first word is at a0: a0 joined to
// the offset of each bit of k (the bits are disjoint from a0's row).
template <int r, class Side>
__device__ __forceinline__ int word(int a0, const int (&bit)[r], int k) {
#pragma unroll
  for (int b = 0; b < r; ++b)
    if ((k >> b) & 1) a0 = Side::join(a0, bit[b]);
  return a0;
}

// One pass: the r stages from stage st0 (2^st0 groups) on every unit of
// the tile, read from `src` and written to `dst`.  A unit is (hi, lo, j):
// column j, rows (hi << (ls + r)) | lo | (k << ls).  Thread t holds
// column t mod T, so a warp's lanes share their rows, and the units
// [c per, (c + 1) per) of that column, c = t / T, lo fastest: its units
// of one hi share their twiddles, loaded once.
template <int r, bool kInverse, bool kPhaseB, typename T, class Src,
          class Dst>
__device__ __forceinline__ void pass_r(const Src& src, const Dst& dst,
                                       int st0, int logr, int logt, int lts,
                                       const T* tw, const T* tws, T q) {
  const int ls = logr - st0 - r;
  const int nuc = 1 << (logr - r);              // units a column
  const int groups = blockDim.x >> logt;        // threads a column
  const int per = nuc > groups ? nuc / groups : 1;
  const int run = per < (1 << ls) ? per : 1 << ls;  // units of one hi
  const int j = threadIdx.x & ((1 << logt) - 1);
  const int uc0 = (threadIdx.x >> logt) * per;
  if (uc0 >= nuc) return;
  int sb[r], db[r];  // word 2^b of a unit past its first
#pragma unroll
  for (int b = 0; b < r; ++b) {
    sb[b] = src.at(1 << (ls + b), 0);
    db[b] = dst.at(1 << (ls + b), 0);
  }
#pragma unroll 1
  for (int a = uc0; a < uc0 + per; a += run) {
    const int hi = a >> ls;
    T w[(1 << r) - 1], ws[(1 << r) - 1];
    twiddles<r, kPhaseB>(w, ws, tw, tws, (1 << st0) + hi, lts, j);
#pragma unroll 1
    for (int uc = a; uc < a + run; ++uc) {
      const int base = (hi << (ls + r)) | (uc & ((1 << ls) - 1));
      const int s0 = src.at(base, j), d0 = dst.at(base, j);
      T x[1 << r];
#pragma unroll
      for (int k = 0; k < (1 << r); ++k)
        x[k] = src.ld(word<r, Src>(s0, sb, k));
      radix<r, kInverse>(x, w, ws, q);
#pragma unroll
      for (int k = 0; k < (1 << r); ++k)
        dst.st(word<r, Dst>(d0, db, k), x[k]);
    }
  }
}

// Pass p of the transform: stages [3p, 3p + r), r = 3 but for the last.
template <bool kInverse, bool kPhaseB, typename T, class Src, class Dst>
__device__ __forceinline__ void pass(int p, const Src& src, const Dst& dst,
                                     int logr, int logt, int lts,
                                     const T* tw, const T* tws, T q) {
  const int st0 = 3 * p;
  const int r = logr - st0 < 3 ? logr - st0 : 3;
  if (r == 3)
    pass_r<3, kInverse, kPhaseB>(src, dst, st0, logr, logt, lts, tw, tws, q);
  else if (r == 2)
    pass_r<2, kInverse, kPhaseB>(src, dst, st0, logr, logt, lts, tw, tws, q);
  else
    pass_r<1, kInverse, kPhaseB>(src, dst, st0, logr, logt, lts, tw, tws, q);
}

// One block: limb blockIdx.y, columns [blockIdx.x T, (blockIdx.x + 1) T).
// The launch bounds leave registers for 4 (u32) or 3 (u64) blocks a
// multiprocessor, at most 64 or 80 a thread: the inverses took 71-108
// without them.
template <typename T, bool kInverse, bool kPhaseB>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 3)
ntt_phase_kernel(PhaseArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile<T> tile{reinterpret_cast<T*>(smem_raw), a.logt};
  const int l = blockIdx.y;
  const int j0 = blockIdx.x << a.logt;
  const int row = a.rows[l];
  const T q = static_cast<const T*>(a.q)[row];
  const int64_t trow = static_cast<int64_t>(row) * a.n +
                       (kPhaseB ? a.col0 + j0 : 0);
  const T* const tw = static_cast<const T*>(a.tw) + trow;
  const T* const tws = static_cast<const T*>(a.tws) + trow;
  // phase A: the row's R stage twiddles as pairs past the tile
  T* const pairs = tile.s + (1 << (a.logr + a.logt));
  if (!kPhaseB)
    for (int i = threadIdx.x; i < 1 << a.logr; i += blockDim.x) {
      pairs[2 * i] = ldg_w(tw + i);
      pairs[2 * i + 1] = ldg_w(tws + i);
    }
  const T* const ptw = kPhaseB ? tw : pairs;
  const int schunk = a.num_l << (a.lc + a.logcols);
  // the column side: chunks of 2^lc rows in phase B, one chunk in A
  const int lcc = kPhaseB ? a.lc : a.logr;
  const int coff = (l << (lcc + a.logcols)) + j0;
  const int roff = (l << (a.lc + a.logcols)) + (j0 << a.lc);
  const RowSide rs{a.lc, schunk};
  const int np = (a.logr + 2) / 3;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  constexpr bool kScale = kInverse && !kPhaseB;  // the inverse's last
  if (!kInverse) {
    const ColSide<T, kPhaseB, false> cs{nullptr, a.lc, a.logcols, schunk,
                                        0, 0, q};
    to_tile<false>(tile, cs, x + coff, a.vec_x, a.logr);
    __syncthreads();
    for (int p = 0; p < np; ++p) {
      pass<false, kPhaseB>(p, tile, tile, a.logr, a.logt, a.lts, ptw, tws, q);
      __syncthreads();
    }
    to_rows<kPhaseB>(tile, rs, out + roff, a.vec_out, a.logr, q);
  } else {
    to_tile<true>(tile, rs, x + roff, a.vec_x, a.logr);
    __syncthreads();
    for (int p = np - 1; p > 0; --p) {
      pass<true, kPhaseB>(p, tile, tile, a.logr, a.logt, a.lts, ptw, tws, q);
      __syncthreads();
    }
    T sc = 0, scs = 0;
    if (kScale) {  // N^-1 by table row, or the caller's factor by limb
      const int at = a.scale_by_row ? row : l;
      sc = static_cast<const T*>(a.scale)[at];
      scs = static_cast<const T*>(a.scale_shoup)[at];
    }
    const ColSide<T, kPhaseB, kScale> dst{out + coff, a.lc, a.logcols,
                                          schunk, sc, scs, q};
    pass<true, kPhaseB>(0, tile, dst, a.logr, a.logt, a.lts, ptw, tws, q);
  }
}

template <typename T, bool kInverse, bool kPhaseB>
cudaError_t launch(const PhaseArgs& a, cudaStream_t stream) {
  // the tile, and in phase A the stage twiddles' R pairs
  const int smem = static_cast<int>(sizeof(T)) *
                   ((1 << (a.logr + a.logt)) + (kPhaseB ? 0 : 2 << a.logr));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_phase_kernel<T, kInverse, kPhaseB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  // one radix-8 unit a thread, 32 to kThreads threads
  const int units = 1 << (a.logr + a.logt - 3 > 5 ? a.logr + a.logt - 3 : 5);
  const int threads = units < kThreads ? units : kThreads;
  const dim3 grid(1 << (a.logcols - a.logt), a.num_l);
  ntt_phase_kernel<T, kInverse, kPhaseB><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_word(const PhaseArgs& a, bool phase_b, bool inverse,
                        cudaStream_t s) {
  if (phase_b)
    return inverse ? launch<T, true, true>(a, s) : launch<T, false, true>(a, s);
  return inverse ? launch<T, true, false>(a, s) : launch<T, false, false>(a, s);
}

int log2_exact(long long v) {
  int k = 0;
  while ((1ll << k) < v) ++k;
  return (1ll << k) == v ? k : -1;
}

}  // namespace
}  // namespace ptkp

using namespace ptkp;

extern "C" {

// P1.  word: 4 (u32) or 8 (u64) bytes; out, x: the phase's output and
// input in its layouts (see the header) for num_l limbs of R = 2^logr rows
// a transform over W = 2^logw ranks, tiles of 2^logt columns; q, tw, tws:
// the sharded tables (their phase-B regions transposed); rows: (num_l,)
// table rows; col0: phase B's global n1 column of local column 0; scale,
// scale_shoup: the inverse's factor (phase A inverse, else unread),
// (num_l,) by limb or, with scale_by_row, the tables' (rows,) N^-1 by
// table row.
int ptk_ntt_phase(int word, void* out, const void* x, const void* q,
                  const void* tw, const void* tws, const void* rows,
                  const void* scale, const void* scale_shoup,
                  int scale_by_row, int num_l, int n, int logr, int logt,
                  int logw, int col0, int phase_b, int inverse,
                  void* stream) {
  const int logn = log2_exact(n);
  const int v = word == 4 ? Vec16<uint32_t>::kLog : Vec16<uint64_t>::kLog;
  const int logcols = logn - logr - logw;
  const int lc = logr - logw;
  if ((word != 4 && word != 8) || logn < 0 || logr < 1 || logw < 0 ||
      num_l < 1 || lc < v || logt < v || logt > logcols ||
      (static_cast<long long>(num_l) << (logn - logw)) >= (1ll << 31) ||
      (inverse && !phase_b && (scale == nullptr || scale_shoup == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) == 0);
  };
  PhaseArgs a{x, out, q, tw, tws, static_cast<const int32_t*>(rows),
              scale, scale_shoup, n, num_l, logr, logt, logcols, lc,
              logn - logr, col0, scale_by_row, aligned(x), aligned(out)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      word == 4 ? launch_word<uint32_t>(a, phase_b, inverse, s)
                : launch_word<uint64_t>(a, phase_b, inverse, s);
  return static_cast<int>(e);
}

}  // extern "C"

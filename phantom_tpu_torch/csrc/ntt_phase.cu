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
// Layouts.  Each phase reads one layout and writes another, so the
// exchange needs no transpose around it: phase A reads the canonical
// (L, n1, c2) block and writes (W, L, c2, c1), the chunk for rank d
// holding its n1 rows transposed; phase B reads (W, L, c2, c1) and writes
// (W, L, c1, c2).  The inverse runs the same maps backwards.  A layout is
// five numbers (Layout below): element i of the transform line (l, j) sits
// at (i >> log_chunk) s_chunk + l s_limb + (i mod chunk) s_row + j s_col.
//
// Design.  A block takes R = n1 or n2 rows by a tile of T consecutive
// columns of one limb into shared memory (rows padded by one word, so that
// both the row-wise load of a transposed layout and the butterflies run
// without bank conflicts), runs the log2 R radix-2 stages there with one
// Shoup product a butterfly, and writes the tile out.  T is 32 u32 words
// or 16 u64 words (33 or 35 KB at R = 256).  Loads and stores walk the
// layout's contiguous axis, so device memory is read and written in whole
// lines.
//
// Bound, at a (65, 2^16) u32 phase with W = 1: the block is read and
// written once, 34 MB, and phase B reads the rows' transposed twiddles
// and Shoup words, 34 MB more: 0.020 ms at 3.35 TB/s; its 65 x 2^15 x 8
// butterflies at three 32-bit multiplies each are 51 M multiplies, 0.003
// ms at 16.7 T/s.  Both phases of a transform move twice the bytes of the
// one-pass core's single read and write: that is the price of the
// exchange between them.

#include <cstdint>

#include "modarith.cuh"
#include "modarith64.cuh"

namespace ptkp {
namespace {

constexpr int kThreads = 256;

template <typename T>
struct Word;

template <>
struct Word<uint32_t> {
  static __device__ __forceinline__ uint32_t lazy(uint32_t x, uint32_t w,
                                                  uint32_t ws, uint32_t q) {
    return ptk::mul_shoup_lazy(x, w, ws, q);
  }
};

template <>
struct Word<uint64_t> {
  static __device__ __forceinline__ uint64_t lazy(uint64_t x, uint64_t w,
                                                  uint64_t ws, uint64_t q) {
    return ptk64::shoup_lazy(x, w, ws, q);
  }
};

template <typename T>
__device__ __forceinline__ T csub(T x, T q) {
  return x >= q ? x - q : x;
}

struct Layout {
  int log_chunk;  // rows of a chunk (log2)
  int64_t s_chunk, s_limb, s_row, s_col;
};

__device__ __forceinline__ int64_t at(const Layout& g, int l, int i, int j) {
  return static_cast<int64_t>(i >> g.log_chunk) * g.s_chunk +
         static_cast<int64_t>(l) * g.s_limb +
         static_cast<int64_t>(i & ((1 << g.log_chunk) - 1)) * g.s_row +
         static_cast<int64_t>(j) * g.s_col;
}

struct PhaseArgs {
  const void* x;
  void* out;
  const void* q;            // the base's moduli
  const void* tw;           // (base rows, N) twiddles, phase-B regions
  const void* tws;          // transposed, and their Shoup words
  const int32_t* rows;      // (L,) table row of each limb
  const void* scale;        // (L,) the inverse's factor, last phase only
  const void* scale_shoup;
  int n;                    // N, a table row's length
  int logr;                 // log2 of the transform length R
  int logt;                 // log2 of the tile's columns T
  int tstride;              // 1 in phase A, n1 in phase B
  int col0;                 // phase B: global n1 column of local column 0
  int colmul;               // 1 in phase B (twiddles by column), else 0
  int last;                 // the transform's last phase: fused ends
  Layout lin, lout;  // the input's and the output's layouts
};

template <typename T, bool kInverse>
__global__ void __launch_bounds__(kThreads)
ntt_phase_kernel(PhaseArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int l = blockIdx.y;
  const int tile = 1 << a.logt;
  const int stride = tile + 1;  // padded row
  const int j0 = blockIdx.x * tile;
  const int r_len = 1 << a.logr;
  const int words = r_len << a.logt;
  const int row = a.rows[l];
  const T q = static_cast<const T*>(a.q)[row];
  const T q2 = q + q;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);

  // load along the input's contiguous axis
  const bool in_cols = a.lin.s_col == 1;
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const int i = in_cols ? e >> a.logt : e & (r_len - 1);
    const int j = in_cols ? e & (tile - 1) : e >> a.logr;
    s[i * stride + j] = x[at(a.lin, l, i, j0 + j)];
  }
  __syncthreads();

  const int64_t base = static_cast<int64_t>(row) * a.n;
  const T* tw = static_cast<const T*>(a.tw) + base;
  const T* tws = static_cast<const T*>(a.tws) + base;
  const int cbase = a.colmul ? a.col0 + j0 : 0;
  const int half = r_len >> 1;
  const int flies = half << a.logt;
  for (int st = 0; st < a.logr; ++st) {
    // forward: mg = 2^st groups of 2h rows; inverse: mg = R / 2^(st+1)
    const int logm = kInverse ? a.logr - 1 - st : st;
    const int logh = a.logr - 1 - logm;
    const int mg = 1 << logm;
    for (int e = threadIdx.x; e < flies; e += blockDim.x) {
      const int j = e & (tile - 1);
      const int t = e >> a.logt;
      const int g = t >> logh;
      const int ui = (g << (logh + 1)) + (t & ((1 << logh) - 1));
      const int vi = ui + (1 << logh);
      const int64_t wi = static_cast<int64_t>(mg + g) * a.tstride +
                         (a.colmul ? cbase + j : 0);
      const T w = tw[wi], ws = tws[wi];
      T* pu = s + ui * stride + j;
      T* pv = s + vi * stride + j;
      const T u = *pu, v = *pv;
      if (!kInverse) {
        const T ur = csub(u, q2);
        const T wv = Word<T>::lazy(v, w, ws, q);
        *pu = ur + wv;
        *pv = ur - wv + q2;
      } else {
        *pu = csub(u + v, q2);
        *pv = Word<T>::lazy(u - v + q2, w, ws, q);
      }
    }
    __syncthreads();
  }

  T sc = 0, scs = 0;
  if (kInverse && a.last) {
    sc = static_cast<const T*>(a.scale)[l];
    scs = static_cast<const T*>(a.scale_shoup)[l];
  }
  const bool out_cols = a.lout.s_col == 1;
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const int i = out_cols ? e >> a.logt : e & (r_len - 1);
    const int j = out_cols ? e & (tile - 1) : e >> a.logr;
    T v = s[i * stride + j];
    if (a.last)
      v = kInverse ? csub(Word<T>::lazy(v, sc, scs, q), q)
                   : csub(csub(v, q2), q);
    out[at(a.lout, l, i, j0 + j)] = v;
  }
}

template <typename T, bool kInverse>
cudaError_t launch(const PhaseArgs& a, int num_l, int cols,
                   cudaStream_t stream) {
  const int tile = 1 << a.logt;
  const int smem = static_cast<int>(sizeof(T)) * (tile + 1) << a.logr;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_phase_kernel<T, kInverse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(cols >> a.logt, num_l);
  ntt_phase_kernel<T, kInverse><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptkp

using namespace ptkp;

extern "C" {

// P1.  word: 4 (u32) or 8 (u64) bytes; out, x: the phase's output and
// input in the layouts `lo` and `li` (log_chunk, s_chunk, s_limb, s_row,
// s_col each); q, tw, tws: the sharded tables (ops' phase-B regions
// transposed); rows: (num_l,) table rows; scale, scale_shoup: (num_l,)
// the inverse's factor (its last phase only, else null).  The transform
// runs along 2^logr rows for `cols` local columns, 2^logt columns a
// block; tstride, col0 and colmul place the twiddles (see PhaseArgs).
int ptk_ntt_phase(int word, void* out, const void* x, const void* q,
                  const void* tw, const void* tws, const void* rows,
                  const void* scale, const void* scale_shoup, int num_l,
                  int n, int logr, int cols, int logt, int tstride, int col0,
                  int colmul, int inverse, int last, int li_log,
                  long long li_chunk, long long li_limb, long long li_row,
                  long long li_col, int lo_log, long long lo_chunk,
                  long long lo_limb, long long lo_row, long long lo_col,
                  void* stream) {
  if ((word != 4 && word != 8) || logr < 1 || logt < 0 || num_l < 1 ||
      cols < (1 << logt) || cols % (1 << logt) ||
      (inverse && last && (scale == nullptr || scale_shoup == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  PhaseArgs a{x, out, q, tw, tws, static_cast<const int32_t*>(rows),
              scale, scale_shoup, n, logr, logt, tstride, col0, colmul,
              last,
              Layout{li_log, li_chunk, li_limb, li_row, li_col},
              Layout{lo_log, lo_chunk, lo_limb, lo_row, lo_col}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (word == 4)
    e = inverse ? launch<uint32_t, true>(a, num_l, cols, s)
                : launch<uint32_t, false>(a, num_l, cols, s);
  else
    e = inverse ? launch<uint64_t, true>(a, num_l, cols, s)
                : launch<uint64_t, false>(a, num_l, cols, s);
  return static_cast<int>(e);
}

}  // extern "C"

// K5: the base-conversion modular matmul
//   out[j, c] = sum_i y[i, c] * mat[j, i] mod q_j,  y, mat < 2^30,
// on Hopper's int8 tensor cores.
//
// Replaces phantom_tpu/ops/bconv_pallas.py:fold_matmul_pallas (body
// _kernel), which splits the operands into 8-bit digit planes for the MXU
// and folds each diagonal with a Shoup product.  On this card that is the
// native form of the work too, not a workaround: split y = sum_a y_a 2^(8a)
// and mat = sum_b m_b 2^(8b) into four unsigned 8-bit planes each; then
//   sum_i y[i, c] mat[j, i] = sum_d 2^(8d) D_d[j, c],
//   D_d = sum_{a + b = d} m_b y_a   (d = 0 .. 6),
// sixteen plane products m_b y_a, each an exact u8 x u8 -> s32 matmul.  A
// diagonal holds at most 4 pairs x 255^2 x k_in, below 2^31 for k_in <=
// 8256, so the s32 sums are exact (padding rows and columns are zero and
// add nothing), and
//   out[j, c] = sum_d D_d[j, c] (2^(8d) mod q_j) mod q_j
// by seven Shoup products against a per-row table of 2^(8d) mod q_j and its
// Shoup words, built in shared memory from q with one 64-bit division (a
// Barrett ratio) per row per block, then the row's entries in parallel.
//
// A block takes kK5Cols columns.  Its prologue splits the columns' k_in
// words into planes as it stages them (16-byte loads of y, a 4 x 4 byte
// transpose in registers), and the whole matrix likewise; in shared memory
// a column (of y) or a row (of mat) is a run of 16-byte units, unit `qd`
// holding the four planes of k = 4 qd .. 4 qd + 3, padded to a stride of
// 4 mod 8 units so that every 16-byte load and store of a quarter-warp
// hits all 32 banks.  Each warp owns 16 columns (two n-tiles of 8) and,
// per n-tile and 16-row m-tile of the output, runs mma.sync m16n8k32 (M =
// k_out padded to 16, K = k_in padded to 32) for the 16 plane pairs into
// the 7 diagonals: one 16-byte load gives a fragment register of all four
// planes.  The epilogue folds the diagonals (lazy Shoup products, words
// in [0, 2q) between terms), trades half a row with the neighbour lane
// (one shuffle pair) and stores 16 bytes a lane.  One n-tile at a time
// keeps a warp to 28 accumulator registers, so that three blocks share
// an SM where shared memory allows (k_in <= 64).
//
// Why not the scalar route: a scalar K5, however register-blocked, pays
// about five instructions per 64-bit product, and BFV's (87, N) -> 44 at N
// = 2^16 makes 251 M of them, 0.075 ms of the card's 16.7 T/s 32-bit
// multiply lanes.  The plane products are about 8 G int8 operations, 4 us
// at the 1,979 TOP/s of the int8 tensor cores; the call's bytes (y 22.8
// MB in, 11.5 MB out) take 10 us at 3.35 TB/s, so device memory bounds it.
// The one-column-per-thread scalar kernel this replaces ran at 7x its
// operation bound there (PERF.md).  Next steps: wgmma (a warpgroup's
// 64-row tile from shared memory), TMA loads of y into a ring of
// column tiles with a persistent block per SM, so that one tile's planes
// are split while the previous tile's products run.

#include "modarith.cuh"

namespace ptk {
namespace {

constexpr int kK5Cols = 128;     // columns per block
constexpr int kK5Threads = 256;  // 8 warps x 16 columns

struct K5Geom {
  int kq;   // 16-byte units of a column's planes: k_in padded to 32, / 4
  int kqs;  // their stride in shared memory, = 4 mod 8
  int mp;   // k_out padded to 16
};

__host__ __device__ inline K5Geom k5_geom(int k_in, int k_out) {
  K5Geom g;
  g.kq = (k_in + 31) / 32 * 8;
  g.kqs = g.kq + 4;
  g.mp = (k_out + 15) / 16 * 16;
  return g;
}

// bytes of shared memory: y's and mat's planes, then a 16-word table row
// (q, 2^(8d) mod q for d = 0..6, their Shoup words) and a Barrett ratio
// per output row
__host__ __device__ inline int k5_smem(int k_in, int k_out) {
  const K5Geom g = k5_geom(k_in, k_out);
  return (kK5Cols + g.mp) * g.kqs * 16 + g.mp * (16 * 4 + 8);
}

// The 4 x 4 byte transpose: w[r]'s byte a -> byte r of plane word a.
__device__ __forceinline__ uint4 planes4(uint32_t w0, uint32_t w1,
                                         uint32_t w2, uint32_t w3) {
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
  return make_uint4(__byte_perm(lo01, lo23, 0x5410),
                    __byte_perm(lo01, lo23, 0x7632),
                    __byte_perm(hi01, hi23, 0x5410),
                    __byte_perm(hi01, hi23, 0x7632));
}

__device__ __forceinline__ uint32_t plane(const uint4& v, int p) {
  return p == 0 ? v.x : p == 1 ? v.y : p == 2 ? v.z : v.w;
}

// d += a b on the int8 tensor cores: a (16 x 32, row-major) and b (32 x 8,
// column-major) unsigned 8-bit fragments, d (16 x 8) signed 32-bit, in the
// PTX ISA's m16n8k32 fragment layout.
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4],
                                       const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kK5Threads, 3)
fold_matmul_kernel(const uint32_t* y, const uint32_t* mat, const uint32_t* q,
                   int k_in, int k_out, int n, uint32_t* out) {
  extern __shared__ uint4 sm[];
  const K5Geom G = k5_geom(k_in, k_out);
  uint4* yp = sm;                        // (kK5Cols, kqs) units
  uint4* mp = sm + kK5Cols * G.kqs;      // (mp, kqs) units
  uint32_t* tab = reinterpret_cast<uint32_t*>(mp + G.mp * G.kqs);
  uint64_t* ratio = reinterpret_cast<uint64_t*>(tab + 16 * G.mp);
  const int c0 = blockIdx.x * kK5Cols;

  // y's planes: a unit (column quad cq, k quad qd) loads 4 rows x 16 bytes;
  // the 8 lanes of a quarter-warp take 8 consecutive qd at one cq
  for (int u = threadIdx.x; u < (kK5Cols / 4) * G.kq; u += blockDim.x) {
    const int qd = (u & 7) | ((u >> 8) << 3);
    const int cq = (u >> 3) & (kK5Cols / 4 - 1);
    const int c = c0 + 4 * cq;
    uint4 w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * qd + r;
      w[r] = i < k_in && c < n
                 ? __ldg(reinterpret_cast<const uint4*>(
                       y + static_cast<int64_t>(i) * n + c))
                 : make_uint4(0, 0, 0, 0);
    }
    uint4* dst = yp + 4 * cq * G.kqs + qd;
    dst[0] = planes4(w[0].x, w[1].x, w[2].x, w[3].x);
    dst[G.kqs] = planes4(w[0].y, w[1].y, w[2].y, w[3].y);
    dst[2 * G.kqs] = planes4(w[0].z, w[1].z, w[2].z, w[3].z);
    dst[3 * G.kqs] = planes4(w[0].w, w[1].w, w[2].w, w[3].w);
  }
  // mat's planes: a unit (row j, k quad qd)
  for (int u = threadIdx.x; u < G.mp * G.kq; u += blockDim.x) {
    const int j = u / G.kq, qd = u - j * G.kq;
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * qd + r;
      w[r] = j < k_out && i < k_in ? __ldg(mat + j * k_in + i) : 0u;
    }
    mp[j * G.kqs + qd] = planes4(w[0], w[1], w[2], w[3]);
  }
  // the fold table: one Barrett ratio (a 64-bit division) per row, then
  // its 7 entries in parallel
  for (int j = threadIdx.x; j < k_out; j += blockDim.x) {
    const uint32_t qj = __ldg(q + j);
    tab[16 * j] = qj;
    ratio[j] = make_barrett(qj).ratio;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 7 * k_out; e += blockDim.x) {
    const int j = e / 7, d = e - 7 * j;
    const Barrett bq{tab[16 * j], ratio[j]};
    const uint32_t p = reduce64(1ull << (8 * d), bq);
    uint32_t rem;
    tab[16 * j + 1 + d] = p;
    tab[16 * j + 8 + d] = static_cast<uint32_t>(
        divmod64(static_cast<uint64_t>(p) << 32, bq, rem));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cw = 16 * warp;  // the warp's 16 columns in the tile
  // one n-tile of 8 columns at a time: 28 accumulator registers, so that
  // three blocks share an SM
  for (int nt = 0; nt < 2; ++nt) {
    const uint4* yb = yp + (cw + 8 * nt + g) * G.kqs + t;
    for (int m0 = 0; m0 < G.mp; m0 += 16) {
      uint32_t acc[7][4];
#pragma unroll
      for (int d = 0; d < 7; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] = 0;
      const uint4* ma = mp + (m0 + g) * G.kqs + t;
      for (int k0 = 0; k0 < G.kq; k0 += 8) {
        const uint4 a0 = ma[k0], a1 = ma[8 * G.kqs + k0], a2 = ma[k0 + 4],
                    a3 = ma[8 * G.kqs + k0 + 4];
        const uint4 b0 = yb[k0], b1 = yb[k0 + 4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t af[4] = {plane(a0, b), plane(a1, b), plane(a2, b),
                                  plane(a3, b)};
#pragma unroll
          for (int a = 0; a < 4; ++a)
            mma_u8(acc[a + b], af, plane(b0, a), plane(b1, a));
        }
      }
      // fold: element e of a lane is row m0 + g (+ 8 for e >= 2), column
      // 2t + (e & 1) of the n-tile
      uint32_t o[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = m0 + g + 8 * h;
        const uint32_t* tj = tab + 16 * (j < k_out ? j : 0);
        const uint32_t qj = tj[0], q2 = 2 * qj;
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          uint32_t x = 0;  // in [0, 2q) between terms
#pragma unroll
          for (int d = 0; d < 7; ++d)
            x = csub(x + mul_shoup_lazy(acc[d][e], tj[1 + d], tj[8 + d], qj),
                     q2);
          o[e] = csub(x, qj);
        }
      }
      // even lanes store row g's columns 2t .. 2t + 3, odd lanes row g + 8's
      // columns 2t - 2 .. 2t + 1
      const bool odd = t & 1;
      const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? o[0] : o[2], 1);
      const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? o[1] : o[3], 1);
      const int j = m0 + g + (odd ? 8 : 0);
      const int c = c0 + cw + 8 * nt + 4 * (t >> 1);
      if (j < k_out && c < n) {
        uint32_t* dst = out + static_cast<int64_t>(j) * n + c;
        *reinterpret_cast<uint4*>(dst) =
            odd ? make_uint4(r0, r1, o[2], o[3])
                : make_uint4(o[0], o[1], r0, r1);
      }
    }
  }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// Shared memory a launch needs, for the wrapper's check.
int ptk_fold_matmul_smem(int k_in, int k_out) { return k5_smem(k_in, k_out); }

// K5.  out: (k_out, n); y: (k_in, n), n a multiple of 4, 16-byte aligned;
// mat: (k_out, k_in); q: (k_out,).
int ptk_fold_matmul(void* out, const void* y, const void* mat, const void* q,
                    int k_in, int k_out, int n, void* stream) {
  const int blocks = (n + kK5Cols - 1) / kK5Cols;
  const int smem = k5_smem(k_in, k_out);
  const cudaError_t e = cudaFuncSetAttribute(
      fold_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fold_matmul_kernel<<<blocks, kK5Threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(y), static_cast<const uint32_t*>(mat),
      static_cast<const uint32_t*>(q), k_in, k_out, n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

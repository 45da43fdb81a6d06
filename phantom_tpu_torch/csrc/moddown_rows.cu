// K8: the moddown of both key-switch halves, R output rows per block.
//
// Replaces phantom_tpu/ops/ntt_mxu_pallas.py:moddown_mxu_bconv_pallas (body
// _bconv_mxu_kernel).  It computes what K3's moddown call computes
// (bconv_ntt.cu with v, sub_from, epi_scale and tensor_add): for half g and
// Ql row j,
//   x         = sum_i y[g, i] mat[j, i] - v[g] vmul[j]  mod q_j  (exact)
//   out[g, j] = (sub[g, j] - NTT_j(x)) esc[j] + c_g[j],
// c_0 = d1[0] d2[0], c_1 = d1[0] d2[1] + d1[1] d2[0] (no tensor term when d1
// is null).  What the TPU kernel does, and this one too: a program serves R
// output rows and reads each y element once for all R, where K3 re-reads
// the alpha y rows for every output row.  The TPU kernel's int8 digit-plane
// dots and pow2 fold tables are a workaround for its missing 32x32->64
// multiply and have no counterpart: here each of the R sums is native
// 64-bit products into a low word and a carry count, reduced once.
//
//   launch A: one block per (tile, half, block of R rows): the conversion
//     of the R rows into R tiles of dynamic shared memory (R x 16 KB), then
//     their column stages (N > 4096), stored raw into out;
//   launch B: K2's chunk pass (ntt.cu:fwd_chunk_kernel) over every
//     row, reading out back, with the epilogue.
// The last block of rows masks the rows past k.  Like K3 it is bound by
// device memory: y is read ceil(k / R) times (mostly from L2) instead of k
// times, sub, d1 and d2 once, and out makes the two passes' round trip.

#include "ntt_core.cuh"

namespace ptk {
namespace {

constexpr int kMaxRows = 8;  // R sums a thread keeps in registers

struct RowsArgs {
  const uint32_t* y;     // (2, alpha, N)
  const uint32_t* mat;   // (k, alpha)
  const uint32_t* v;     // (2, N)
  const uint32_t* vmul;  // (k,)
  int alpha, k, R;
};

size_t rows_smem(int R, int alpha, const Geometry& G) {
  return static_cast<size_t>(R) * (G.n2 + alpha) * sizeof(uint32_t);
}

// Launch A: rows j0 .. j0 + nr - 1 of half g, one tile of each.
__global__ void __launch_bounds__(kThreads)
rows_col_kernel(RowsArgs a, NttTables tb, Geometry G, uint32_t* out) {
  extern __shared__ uint32_t smem[];  // R tiles of n2 words, then mat rows
  const int tile = blockIdx.x, g = blockIdx.y, j0 = blockIdx.z * a.R;
  const int nr = min(a.R, a.k - j0);
  uint32_t* ms = smem + a.R * G.n2;  // (nr, alpha)
  for (int i = threadIdx.x; i < nr * a.alpha; i += blockDim.x)
    ms[i] = a.mat[static_cast<int64_t>(j0) * a.alpha + i];
  Barrett bq[kMaxRows];
  uint32_t vm[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    const int j = min(j0 + r, a.k - 1);  // masked rows hold a valid row
    bq[r] = make_barrett(tb.q[tb.rows[j]]);
    vm[r] = a.vmul[j];
  }
  __syncthreads();
  const uint32_t* yg = a.y + static_cast<int64_t>(g) * a.alpha * G.n;
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x) {
    const int64_t gi = col_index(G, tile, e);
    uint64_t lo[kMaxRows] = {};
    uint32_t hi[kMaxRows] = {};
    for (int i = 0; i < a.alpha; ++i) {
      const uint32_t yv = yg[static_cast<int64_t>(i) * G.n + gi];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < nr) mac(lo[r], hi[r], yv, ms[r * a.alpha + i]);
    }
    const uint32_t vv = a.v[static_cast<int64_t>(g) * G.n + gi];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < nr)
        smem[r * G.n2 + e] = sub_mod(reduce128(hi[r], lo[r], bq[r]),
                                     mul_mod(vv, vm[r], bq[r]), bq[r].q);
  }
  __syncthreads();
  for (int m = 1; m < G.n1; m <<= 1)
    for (int r = 0; r < nr; ++r) {
      const int limb = tb.rows[j0 + r];
      col_stage<false>(smem + r * G.n2, G, m,
                       tb.w + static_cast<int64_t>(limb) * G.n,
                       tb.ws + static_cast<int64_t>(limb) * G.n, tb.q[limb]);
    }
  for (int r = 0; r < nr; ++r) {
    uint32_t* o = out + (static_cast<int64_t>(g) * a.k + j0 + r) * G.n;
    for (int e = threadIdx.x; e < G.n2; e += blockDim.x)
      o[col_index(G, tile, e)] = smem[r * G.n2 + e];
  }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// K8.  out: (2, k, N); y: (2, alpha, N); mat: (k, alpha); v: (2, N); vmul:
// (k,); R: rows per block, 1..8; q, w, ws: the whole base's forward tables;
// rows: (k,) table row of each Ql row; sub: (2, k, N), esc, escs: (k,); d1,
// d2: (2, k, N) or null.
int ptk_moddown_rows(void* out, const void* y, const void* mat,
                     const void* v, const void* vmul, int alpha, int k, int R,
                     const void* q, const void* w, const void* ws,
                     const void* rows, int logn, const void* sub,
                     const void* esc, const void* escs, const void* d1,
                     const void* d2, void* stream) {
  if (R < 1 || R > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry G = make_geometry(logn);
  const NttTables tb{static_cast<const uint32_t*>(q),
                     static_cast<const uint32_t*>(w),
                     static_cast<const uint32_t*>(ws),
                     static_cast<const int32_t*>(rows), k};
  const FwdEpilogue epi{static_cast<const uint32_t*>(sub),
                        static_cast<const uint32_t*>(esc),
                        static_cast<const uint32_t*>(escs),
                        static_cast<const uint32_t*>(d1),
                        static_cast<const uint32_t*>(d2)};
  const RowsArgs a{static_cast<const uint32_t*>(y),
                   static_cast<const uint32_t*>(mat),
                   static_cast<const uint32_t*>(v),
                   static_cast<const uint32_t*>(vmul),
                   alpha,
                   k,
                   R};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  const size_t smem = rows_smem(R, alpha, G);
  const cudaError_t err = cudaFuncSetAttribute(
      rows_col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_col_kernel<<<dim3(G.n1, 2, (k + R - 1) / R), kThreads, smem, st>>>(
      a, tb, G, o);
  launch_forward_chunks(tb, epi, G, o, 2 * k, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

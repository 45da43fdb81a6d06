// K1 and K2: the per-row negacyclic NTTs with their fused prologues and
// epilogues.
//
// K2 replaces phantom_tpu/ops/ntt_mxu_pallas.py:ntt_forward_mxu_pallas
// (body _fwd_kernel) and K1 replaces ntt_inverse_mxu_pallas (body
// _inv_kernel).  The TPU kernels run a four-step transform as int8
// digit-plane matmuls on the MXU; here a row transforms as radix-2
// butterflies in shared memory with native 32x32->64 Shoup products (see
// ntt_core.cuh).  Both are bound by device memory: each pass reads and
// writes the row once, plus twiddle reads that mostly hit L2.
//
// K1's emit_floor_div output v = floor(sum_rows y / q) per group cannot
// ride a sequential grid as on the TPU (CUDA blocks run in no order), so a
// second launch walks each group's rows per column once the transform is
// done, with the same three-level 2^32 cascade as
// phantom_tpu/ops/bconv32.py:floor_sum_div32.

#include "ntt_core.cuh"

namespace ptk {
namespace {

struct InvArgs {
  const uint32_t* x;       // (nrows, N) in [0, 2q)
  const uint32_t* mul_by;  // optional (nrows, N): transform x * mul_by
  const uint32_t* scale;   // (L,) replaces n^-1
  const uint32_t* scale_shoup;
};

// K1 chunk pass (first): prologue, chunk stages; scales too when it is the
// only pass.
__global__ void __launch_bounds__(kThreads)
inv_chunk_kernel(InvArgs a, NttTables tb, Geometry G, uint32_t* out) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int j = row % tb.L;
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const uint32_t q = bq.q;
  const int64_t base = static_cast<int64_t>(row) * G.n +
                       static_cast<int64_t>(tile) * G.n2;
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x) {
    uint32_t x = csub(a.x[base + e], q);
    if (a.mul_by != nullptr) x = mul_mod(x, csub(a.mul_by[base + e], q), bq);
    s[e] = x;
  }
  __syncthreads();
  const uint32_t* w = tb.w + static_cast<int64_t>(limb) * G.n;
  const uint32_t* ws = tb.ws + static_cast<int64_t>(limb) * G.n;
  for (int m = G.n >> 1; m >= G.n1; m >>= 1)
    chunk_stage<true>(s, G, tile, m, w, ws, q);
  const bool single = G.n1 == 1;
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x)
    out[base + e] = single ? mul_shoup(s[e], a.scale[j], a.scale_shoup[j], q)
                           : s[e];
}

// K1 column pass (second): column stages, then the scale.
__global__ void __launch_bounds__(kThreads)
inv_col_kernel(InvArgs a, NttTables tb, Geometry G, uint32_t* out) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int j = row % tb.L;
  const int limb = tb.rows[j];
  const uint32_t q = tb.q[limb];
  uint32_t* o = out + static_cast<int64_t>(row) * G.n;
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    s[e] = o[col_index(G, tile, e)];
  __syncthreads();
  const uint32_t* w = tb.w + static_cast<int64_t>(limb) * G.n;
  const uint32_t* ws = tb.ws + static_cast<int64_t>(limb) * G.n;
  for (int m = G.n1 >> 1; m >= 1; m >>= 1) col_stage<true>(s, G, m, w, ws, q);
  const uint32_t sc = a.scale[j], scs = a.scale_shoup[j];
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    o[col_index(G, tile, e)] = mul_shoup(s[e], sc, scs, q);
}

// v[g, c] = floor(sum_l y[g, l, c] / q_l) by the cascade of
// bconv32.floor_sum_div32: per row the 96-bit fixed-point expansion of
// y / q (words a = y U + floor(y V / q), s2, s3), the three word sums taken
// exactly, then (A 2^64 + B 2^32 + C) >> 96.
__global__ void floor_div_kernel(const uint32_t* y, NttTables tb,
                                 const uint32_t* U, const uint32_t* V, int n,
                                 int groups, uint32_t* v) {
  const int64_t total = static_cast<int64_t>(groups) * n;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t g = idx / n, c = idx % n;
    uint64_t A = 0, B = 0, C = 0;
    for (int l = 0; l < tb.L; ++l) {
      const Barrett bq = make_barrett(tb.q[tb.rows[l]]);
      const uint32_t yv = y[(g * tb.L + l) * n + c];
      uint32_t r1, r2, r3;
      const uint64_t q1 = divmod64(static_cast<uint64_t>(yv) * V[l], bq, r1);
      const uint64_t s2 = divmod64(static_cast<uint64_t>(r1) << 32, bq, r2);
      const uint64_t s3 = divmod64(static_cast<uint64_t>(r2) << 32, bq, r3);
      A += static_cast<uint32_t>(yv * U[l]) + q1;
      B += s2;
      C += s3;
    }
    v[idx] = static_cast<uint32_t>((A + ((B + (C >> 32)) >> 32)) >> 32);
  }
}

// Forward column pass: the row as stored (lazy [0, 2q) tolerated), column
// stages, raw store to out.
__global__ void __launch_bounds__(kThreads)
fwd_col_kernel(const uint32_t* x, NttTables tb, Geometry G, uint32_t* out) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int limb = tb.rows[row % tb.L];
  const uint32_t q = tb.q[limb];
  const int64_t r0 = static_cast<int64_t>(row) * G.n;
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    s[e] = csub(x[r0 + col_index(G, tile, e)], q);
  __syncthreads();
  const uint32_t* w = tb.w + static_cast<int64_t>(limb) * G.n;
  const uint32_t* ws = tb.ws + static_cast<int64_t>(limb) * G.n;
  for (int m = 1; m < G.n1; m <<= 1) col_stage<false>(s, G, m, w, ws, q);
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    out[r0 + col_index(G, tile, e)] = s[e];
}

// Forward chunk pass: load (x when it is the only pass, else the column
// pass's output in out), chunk stages, epilogue store.
__global__ void __launch_bounds__(kThreads)
fwd_chunk_kernel(const uint32_t* x, NttTables tb, FwdEpilogue epi,
                 Geometry G, uint32_t* out) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int j = row % tb.L, g = row / tb.L;
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const bool single = G.n1 == 1;
  uint32_t* o = out + static_cast<int64_t>(row) * G.n;
  const int64_t base = static_cast<int64_t>(tile) * G.n2;
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x)
    s[e] = single ? csub(x[static_cast<int64_t>(row) * G.n + base + e], bq.q)
                  : o[base + e];
  __syncthreads();
  const uint32_t* w = tb.w + static_cast<int64_t>(limb) * G.n;
  const uint32_t* ws = tb.ws + static_cast<int64_t>(limb) * G.n;
  for (int m = G.n1; m < G.n; m <<= 1)
    chunk_stage<false>(s, G, tile, m, w, ws, bq.q);
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x)
    o[base + e] = epi.apply(s[e], row, j, g, tb.L, base + e, G.n, bq);
}

}  // namespace

void launch_forward(const uint32_t* x, const NttTables& tb,
                    const FwdEpilogue& epi, const Geometry& G, uint32_t* out,
                    int nrows, cudaStream_t stream) {
  const dim3 grid(G.n1, nrows);
  if (G.n1 > 1) fwd_col_kernel<<<grid, kThreads, 0, stream>>>(x, tb, G, out);
  fwd_chunk_kernel<<<grid, kThreads, 0, stream>>>(x, tb, epi, G, out);
}

void launch_forward_chunks(const NttTables& tb, const FwdEpilogue& epi,
                           const Geometry& G, uint32_t* out, int nrows,
                           cudaStream_t stream) {
  fwd_chunk_kernel<<<dim3(G.n1, nrows), kThreads, 0, stream>>>(out, tb, epi,
                                                               G, out);
}

}  // namespace ptk

using namespace ptk;

extern "C" {

const char* ptk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2.  out, x: (nrows, N); q, w, ws: the whole base's tables; rows: (L,)
// table row of each group row.  sub, esc, escs and d1, d2 may be null.
int ptk_ntt_forward(void* out, const void* x, const void* q, const void* w,
                    const void* ws, const void* rows, int L, int nrows,
                    int logn, const void* sub, const void* esc,
                    const void* escs, const void* d1, const void* d2,
                    void* stream) {
  const Geometry G = make_geometry(logn);
  const NttTables tb{static_cast<const uint32_t*>(q),
                     static_cast<const uint32_t*>(w),
                     static_cast<const uint32_t*>(ws),
                     static_cast<const int32_t*>(rows), L};
  const FwdEpilogue epi{static_cast<const uint32_t*>(sub),
                        static_cast<const uint32_t*>(esc),
                        static_cast<const uint32_t*>(escs),
                        static_cast<const uint32_t*>(d1),
                        static_cast<const uint32_t*>(d2)};
  launch_forward(static_cast<const uint32_t*>(x), tb, epi, G,
                 static_cast<uint32_t*>(out), nrows,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K1.  winv, winvs: inverse twiddles; scale, scale_shoup: (L,); mul_by may
// be null; v (groups, N) is written when non-null, with U, V: (L,).
int ptk_ntt_inverse(void* out, const void* x, const void* q,
                    const void* winv, const void* winvs, const void* rows,
                    int L, int nrows, int logn, const void* mul_by,
                    const void* scale, const void* scale_shoup, void* v,
                    const void* U, const void* V, void* stream) {
  const Geometry G = make_geometry(logn);
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
  const dim3 grid(G.n1, nrows);
  inv_chunk_kernel<<<grid, kThreads, 0, st>>>(a, tb, G, o);
  if (G.n1 > 1) inv_col_kernel<<<grid, kThreads, 0, st>>>(a, tb, G, o);
  if (v != nullptr) {
    const int groups = nrows / L;
    const int64_t total = static_cast<int64_t>(groups) * G.n;
    const int threads = 256;
    const int blocks = static_cast<int>((total + threads - 1) / threads);
    floor_div_kernel<<<blocks, threads, 0, st>>>(
        o, tb, static_cast<const uint32_t*>(U),
        static_cast<const uint32_t*>(V), G.n, groups,
        static_cast<uint32_t*>(v));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// K7: the CKKS step's merged epilogue: the moddown of both key-switch
// halves, the relinearization's tensor adds and the rescale, with one
// forward NTT per row.
//
// Replaces phantom_tpu/ops/ntt_mxu_pallas.py:moddown_rescale_mxu_pallas
// (body _moddown_rescale_kernel).  For half g, with
//   delta_j = sum_i y[g, i] mat[j, i] - v[g] vmul[j]  mod q_j  (exact)
//   c_g     = d1[0] d2[0] (g = 0), d1[0] d2[1] + d1[1] d2[0] (g = 1),
// row k-1 is the moddown output
//   m  = (s_{k-1} - NTT(delta_{k-1})) P^-1 + c_g,
//   xl = iNTT(m) + half  mod q_last,
// and by linearity every other row is
//   out_j = (s_j P^-1 + c_g - NTT_j(delta_j P^-1 + xl - half_j)) q_last^-1,
// equal to the composed moddown pair and rescale (K3, K1, K3) while the
// moddown rows 0..k-2 never reach device memory.  The TPU kernel relies on
// its sequential grid: its first program does the last limb and leaves xl
// in VMEM for every later one.  CUDA blocks run in no order, so the last
// limb has launches of its own, which leave xl in a (2, N) scratch, before
// those of rows 0..k-2.  A 2^16-point row exceeds shared memory, so every
// transform keeps ntt_core.cuh's two passes (N > 4096):
//   1. last limb: forward column pass of delta            -> scratch
//   2. last limb: forward chunk pass, m -> out[g, k-1], then the inverse
//      chunk pass of m in the same chunk                  -> scratch
//   3. last limb: inverse column pass, n^-1, + half       -> scratch (xl)
//   4. rows 0..k-2: forward column pass of the prologue   -> out
//   5. rows 0..k-2: forward chunk pass with the epilogue  -> out
// For N <= 4096 launches 2 and 5 alone run, each the whole transform.
// Like K3 it is bound by device memory: each row's alpha y reads (mostly
// from L2), sub, d1, d2 and the output once, and the passes' round trip
// through out; launches 1-3 run 2 x n1 blocks each.

#include "ntt_core.cuh"

namespace ptk {
namespace {

struct MergedArgs {
  const uint32_t* y;      // (2, alpha, N)
  const uint32_t* mat;    // (k, alpha)
  const uint32_t* v;      // (2, N)
  const uint32_t* vmul;   // (k,)
  const uint32_t* sub;    // (2, k, N): the key-switch halves s
  const uint32_t* d1;     // (2, k, N)
  const uint32_t* d2;     // (2, k, N)
  const uint32_t* pinv;   // (k,) P^-1 mod q_j and its Shoup word
  const uint32_t* pinvs;
  const uint32_t* hmq;    // (k-1,) half mod q_j
  const uint32_t* qinv;   // (k-1,) q_last^-1 mod q_j and its Shoup word
  const uint32_t* qinvs;
  const uint32_t* winv;   // the whole base's inverse twiddles
  const uint32_t* winvs;
  const uint32_t* ninv;   // (Lt,) n^-1 and its Shoup word
  const uint32_t* ninvs;
  uint32_t half;
  int alpha, k;

  __device__ __forceinline__ int64_t at(int g, int j, int64_t gi,
                                        int n) const {
    return (static_cast<int64_t>(g) * k + j) * n + gi;
  }

  __device__ __forceinline__ uint32_t delta(int g, int j, int64_t gi, int n,
                                            const Barrett& bq) const {
    const uint32_t x = dot_mod(y + static_cast<int64_t>(g) * alpha * n + gi,
                               n, mat + static_cast<int64_t>(j) * alpha,
                               alpha, bq);
    return sub_mod(x, mul_mod(v[static_cast<int64_t>(g) * n + gi], vmul[j],
                              bq),
                   bq.q);
  }

  __device__ __forceinline__ uint32_t tensor(int g, int j, int64_t gi,
                                             int n, const Barrett& bq) const {
    const int64_t o0 = at(0, j, gi, n), o1 = at(1, j, gi, n);
    if (g == 0) return mul_mod(d1[o0], d2[o0], bq);
    return reduce64(static_cast<uint64_t>(d1[o0]) * d2[o1] +
                        static_cast<uint64_t>(d1[o1]) * d2[o0],
                    bq);
  }

  // the transform input of row j < k-1: delta_j P^-1 + (xl mod q_j) - half_j
  __device__ __forceinline__ uint32_t rest_load(int g, int j, int64_t gi,
                                                int n, const Barrett& bq,
                                                const uint32_t* xl) const {
    const uint32_t dp = mul_shoup(delta(g, j, gi, n, bq), pinv[j], pinvs[j],
                                  bq.q);
    const uint32_t d2j = sub_mod(
        reduce64(xl[static_cast<int64_t>(g) * n + gi], bq), hmq[j], bq.q);
    return add_mod(dp, d2j, bq.q);
  }
};

__device__ __forceinline__ const uint32_t* row_of(const uint32_t* t, int limb,
                                                  int n) {
  return t + static_cast<int64_t>(limb) * n;
}

// 1. (N > 4096) the last limb's forward column pass: scr[g] <- delta
__global__ void __launch_bounds__(kThreads)
last_col_kernel(MergedArgs a, NttTables tb, Geometry G, uint32_t* scr) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, g = blockIdx.y, j = a.k - 1;
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    s[e] = a.delta(g, j, col_index(G, tile, e), G.n, bq);
  __syncthreads();
  for (int m = 1; m < G.n1; m <<= 1)
    col_stage<false>(s, G, m, row_of(tb.w, limb, G.n),
                     row_of(tb.ws, limb, G.n), bq.q);
  uint32_t* x = scr + static_cast<int64_t>(g) * G.n;
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    x[col_index(G, tile, e)] = s[e];
}

// 2. the last limb's forward chunk pass and moddown epilogue (out[g, k-1]
// <- m), then the inverse chunk pass of m (scr[g]; for N <= 4096 the whole
// inverse, scaled, + half)
__global__ void __launch_bounds__(kThreads)
last_chunk_kernel(MergedArgs a, NttTables tb, Geometry G, uint32_t* out,
                  uint32_t* scr) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, g = blockIdx.y, j = a.k - 1;
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const uint32_t q = bq.q;
  const bool single = G.n1 == 1;
  const int64_t base = static_cast<int64_t>(tile) * G.n2;
  uint32_t* x = scr + static_cast<int64_t>(g) * G.n;
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x)
    s[e] = single ? a.delta(g, j, base + e, G.n, bq) : x[base + e];
  __syncthreads();
  for (int m = G.n1; m < G.n; m <<= 1)
    chunk_stage<false>(s, G, tile, m, row_of(tb.w, limb, G.n),
                       row_of(tb.ws, limb, G.n), q);
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x) {
    const int64_t o = a.at(g, j, base + e, G.n);
    const uint32_t md = add_mod(
        mul_shoup(sub_mod(a.sub[o], s[e], q), a.pinv[j], a.pinvs[j], q),
        a.tensor(g, j, base + e, G.n, bq), q);
    out[o] = md;
    s[e] = md;
  }
  __syncthreads();
  for (int m = G.n >> 1; m >= G.n1; m >>= 1)
    chunk_stage<true>(s, G, tile, m, row_of(a.winv, limb, G.n),
                      row_of(a.winvs, limb, G.n), q);
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x)
    x[base + e] =
        single ? add_mod(mul_shoup(s[e], a.ninv[limb], a.ninvs[limb], q),
                         a.half, q)
               : s[e];
}

// 3. (N > 4096) the last limb's inverse column pass, n^-1, + half: scr[g]
// <- xl
__global__ void __launch_bounds__(kThreads)
last_inv_col_kernel(MergedArgs a, NttTables tb, Geometry G, uint32_t* scr) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, g = blockIdx.y;
  const int limb = tb.rows[a.k - 1];
  const uint32_t q = tb.q[limb];
  uint32_t* x = scr + static_cast<int64_t>(g) * G.n;
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    s[e] = x[col_index(G, tile, e)];
  __syncthreads();
  for (int m = G.n1 >> 1; m >= 1; m >>= 1)
    col_stage<true>(s, G, m, row_of(a.winv, limb, G.n),
                    row_of(a.winvs, limb, G.n), q);
  const uint32_t sc = a.ninv[limb], scs = a.ninvs[limb];
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    x[col_index(G, tile, e)] = add_mod(mul_shoup(s[e], sc, scs, q), a.half,
                                       q);
}

// 4. (N > 4096) rows 0..k-2: the forward column pass of the prologue
__global__ void __launch_bounds__(kThreads)
rest_col_kernel(MergedArgs a, NttTables tb, Geometry G, const uint32_t* xl,
                uint32_t* out) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int g = row / (a.k - 1), j = row % (a.k - 1);
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    s[e] = a.rest_load(g, j, col_index(G, tile, e), G.n, bq, xl);
  __syncthreads();
  for (int m = 1; m < G.n1; m <<= 1)
    col_stage<false>(s, G, m, row_of(tb.w, limb, G.n),
                     row_of(tb.ws, limb, G.n), bq.q);
  uint32_t* o = out + a.at(g, j, 0, G.n);
  for (int e = threadIdx.x; e < kTile; e += blockDim.x)
    o[col_index(G, tile, e)] = s[e];
}

// 5. rows 0..k-2: the forward chunk pass and the rescaled epilogue
__global__ void __launch_bounds__(kThreads)
rest_chunk_kernel(MergedArgs a, NttTables tb, Geometry G, const uint32_t* xl,
                  uint32_t* out) {
  __shared__ uint32_t s[kTile];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int g = row / (a.k - 1), j = row % (a.k - 1);
  const int limb = tb.rows[j];
  const Barrett bq = make_barrett(tb.q[limb]);
  const uint32_t q = bq.q;
  const int64_t base = static_cast<int64_t>(tile) * G.n2;
  uint32_t* o = out + a.at(g, j, 0, G.n);
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x)
    s[e] = G.n1 == 1 ? a.rest_load(g, j, base + e, G.n, bq, xl) : o[base + e];
  __syncthreads();
  for (int m = G.n1; m < G.n; m <<= 1)
    chunk_stage<false>(s, G, tile, m, row_of(tb.w, limb, G.n),
                       row_of(tb.ws, limb, G.n), q);
  for (int e = threadIdx.x; e < G.n2; e += blockDim.x) {
    const uint32_t t = add_mod(
        mul_shoup(a.sub[a.at(g, j, base + e, G.n)], a.pinv[j], a.pinvs[j], q),
        a.tensor(g, j, base + e, G.n, bq), q);
    o[base + e] = mul_shoup(sub_mod(t, s[e], q), a.qinv[j], a.qinvs[j], q);
  }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// K7.  out: (2, k, N); scratch: (2, N); y: (2, alpha, N); mat: (k, alpha);
// v: (2, N); vmul, pinv, pinvs: (k,); sub, d1, d2: (2, k, N); hmq, qinv,
// qinvs: (k-1,); half: q_last / 2; q, w, ws, winv, winvs, ninv, ninvs: the
// whole base's tables; rows: (k,) table row of each Ql row; k >= 2.
int ptk_moddown_rescale(void* out, void* scratch, const void* y,
                        const void* mat, const void* v, const void* vmul,
                        const void* sub, const void* d1, const void* d2,
                        const void* pinv, const void* pinvs, const void* hmq,
                        const void* qinv, const void* qinvs, int half,
                        int alpha, int k, const void* q, const void* w,
                        const void* ws, const void* winv, const void* winvs,
                        const void* ninv, const void* ninvs, const void* rows,
                        int logn, void* stream) {
  if (k < 2) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry G = make_geometry(logn);
  const NttTables tb{static_cast<const uint32_t*>(q),
                     static_cast<const uint32_t*>(w),
                     static_cast<const uint32_t*>(ws),
                     static_cast<const int32_t*>(rows), k};
  const auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  const MergedArgs a{u(y),     u(mat),  u(v),     u(vmul),  u(sub),
                     u(d1),    u(d2),   u(pinv),  u(pinvs), u(hmq),
                     u(qinv),  u(qinvs), u(winv), u(winvs), u(ninv),
                     u(ninvs), static_cast<uint32_t>(half), alpha, k};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* scr = static_cast<uint32_t*>(scratch);
  const dim3 last(G.n1, 2), rest(G.n1, 2 * (k - 1));
  if (G.n1 > 1)
    last_col_kernel<<<last, kThreads, 0, st>>>(a, tb, G, scr);
  last_chunk_kernel<<<last, kThreads, 0, st>>>(a, tb, G, o, scr);
  if (G.n1 > 1) {
    last_inv_col_kernel<<<last, kThreads, 0, st>>>(a, tb, G, scr);
    rest_col_kernel<<<rest, kThreads, 0, st>>>(a, tb, G, scr, o);
  }
  rest_chunk_kernel<<<rest, kThreads, 0, st>>>(a, tb, G, scr, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

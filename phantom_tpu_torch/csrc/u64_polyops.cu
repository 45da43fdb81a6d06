// U4: the u64 evaluator's modular products, with the modular glue around
// them fused in.
//
// Replaces the JAX package's u64 products, phantom_tpu/ops/modmath.py:146
// mul_mod under phantom_tpu/ops/polyops.py:34-103 (mul_rns, fma_rns,
// scalar_mul_rns, tensor_prod_2x2, tensor_square_2x2, tensor_prod_mxn),
// and the add_mod / sub_mod the JAX package writes beside them, which XLA
// fuses with the products (no pallas_call): the moddown's addend
// (phantom_tpu/schemes/evaluate.py relinearize, apply_galois, the hoisted
// forms), BGV's t-corrected moddown delta (schemes/keyswitch.py:95-116),
// the rescale's rounding (evaluate.py:379-383) and BGV's modulus-switch
// delta (evaluate.py:440-470).
//
// Every form is bound by device memory on the H100: a Barrett-128 product
// is about 31 32-bit multiplies against 24 bytes a word.  So the design
// moves fewer bytes and makes fewer launches:
//   - each form is one instantiation (no per-thread form branch), each
//     word read once and written once;
//   - a thread holds 2V words (V 16-byte vectors, the block's vectors
//     interleaved so every load instruction is coalesced), loads all its
//     operands' vectors before any arithmetic, and masks the row's tail
//     (N = 2 works); V is the form's, chosen on the card among 1, 2 and 4
//     (vectors_of below);
//   - a block of the product forms is one output row's slice, so the limb
//     (and its constants) is the block's; a operands and addends take a
//     group stride (x[..., :k-1, :] read in place);
//   - the row forms read their (G, 1, N) row slice once, compute the
//     column's value every limb needs (u mod t, x + half), then loop over
//     a chunk of the output limbs.
// Forms (out mod q_l in [0, q_l); w_l with its Shoup word, e_l, scalars
// s0..s3 from the constants table):
//   products  0 mul      a b                      b (Gb, L, N), Gb = G or 1
//             1 fma      a b + c
//             2 tensor   (a0 b0, a0 b1 + a1 b0, a1 b1), the cross term
//                        summed over 128 bits, reduced once
//             3 square   (a0^2, 2 a0 a1, a1^2)
//             4 mxn      (m, L, N) x (mb, L, N) -> (m + mb - 1, L, N), each
//                        output's products summed over 128 bits
//             5-8 shoup  (a [- b]) w_l [+ c]     b like out; 6 with b, 7
//                        with c, 8 with both (the moddown + its addend)
//   rows      9 rows_times       x w_l                          x (G, 1, N)
//            10 rescale_delta    ((x + s1) mod s0) mod q_l - e_l
//            11 modswitch_delta  x mod q_l + u w_l,  u = [x s1]_s0 by Shoup
//                                (s2 its Shoup word)
//            12 moddown_delta    b_l - e_l + u w_l,  u = [(x - s1) s2]_s0
//                                (s3 the Shoup word), b (G, L, N)

#include <atomic>

#include "modarith64.cuh"

namespace ptk64 {
namespace {

constexpr int kThreads = 256;

enum Form : int {
  kMul = 0, kFma, kTensor, kSquare, kMxn, kShoup, kShoupSub, kShoupAdd,
  kShoupSubAdd, kRowsTimes, kRescaleDelta, kModswitchDelta, kModdownDelta,
  kForms
};
constexpr int kFirstRowForm = kRowsTimes;

// the constants table: these rows of L words each, then four scalars (the
// products' Barrett forms read rows kQ-kRhi only)
enum Row : int { kQ = 0, kRlo, kRhi, kW, kWs, kE, kRows };

// kernel launches made by ptk_u64_polyops since the library was loaded
std::atomic<long long> launched{0};

struct Args {
  uint64_t* out;        // (rows of the output, n), contiguous
  const uint64_t* a;    // (G, R, n), group stride a_gs, rows contiguous
  const uint64_t* b;    // (Gb, L, n), contiguous
  const uint64_t* c;    // like out, group stride c_gs
  const uint64_t* k;    // the constants table
  int64_t a_gs, c_gs;
  int num_l, n;
  int b_groups;         // Gb (mxn: the second operand's size)
  int m;                // mxn: the first operand's size
  int l_chunk;          // row forms: output limbs a block
};

// one constant word, through the read-only cache
__device__ __forceinline__ uint64_t ld1(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

// The block's slice of a row: vector j of this thread is v0 + j kThreads,
// past the row's n / 2 vectors masked.
template <int V>
__device__ __forceinline__ void load(uint64_t (&x)[2 * V], const uint64_t* row,
                                     int64_t v0, int64_t nv) {
  const ulonglong2* p = reinterpret_cast<const ulonglong2*>(row);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int64_t vi = v0 + j * kThreads;
    const ulonglong2 t = vi < nv ? __ldg(p + vi) : make_ulonglong2(0, 0);
    x[2 * j] = t.x;
    x[2 * j + 1] = t.y;
  }
}

template <int V>
__device__ __forceinline__ void store(uint64_t* row,
                                      const uint64_t (&x)[2 * V], int64_t v0,
                                      int64_t nv) {
  ulonglong2* p = reinterpret_cast<ulonglong2*>(row);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int64_t vi = v0 + j * kThreads;
    if (vi < nv) p[vi] = make_ulonglong2(x[2 * j], x[2 * j + 1]);
  }
}

// The product forms: blockIdx.y is an output row r = g L + l (tensor,
// square, mxn: r = l, each block writing its slice of every output), the
// x blocks cover the row's vectors.
template <int F, int V>
__global__ void __launch_bounds__(kThreads) polyops64_kernel(Args p) {
  constexpr int W = 2 * V;
  const int num_l = p.num_l;
  const int r = blockIdx.y;
  const int g = r / num_l, l = r - g * num_l;
  const int64_t n = p.n, nv = n >> 1, ln = int64_t{num_l} * n;
  const int64_t v0 = int64_t{blockIdx.x} * V * kThreads + threadIdx.x;
  const uint64_t q = ld1(p.k + kQ * num_l + l);
  const uint64_t* a = p.a + g * p.a_gs + l * n;
  uint64_t x[W], y[W], z[W];
  if constexpr (F == kMul || F == kFma) {
    const uint64_t rlo = ld1(p.k + kRlo * num_l + l);
    const uint64_t rhi = ld1(p.k + kRhi * num_l + l);
    load<V>(x, a, v0, nv);
    load<V>(y, p.b + (p.b_groups == 1 ? 0 : g * ln) + l * n, v0, nv);
    if constexpr (F == kFma) load<V>(z, p.c + g * p.c_gs + l * n, v0, nv);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      x[i] = mul_mod(x[i], y[i], q, rlo, rhi);
      if constexpr (F == kFma) x[i] = add_mod(x[i], z[i], q);
    }
    store<V>(p.out + r * n, x, v0, nv);
  } else if constexpr (F == kTensor || F == kSquare) {
    const uint64_t rlo = ld1(p.k + kRlo * num_l + l);
    const uint64_t rhi = ld1(p.k + kRhi * num_l + l);
    uint64_t x1[W], y1[W];
    load<V>(x, a, v0, nv);
    load<V>(x1, a + p.a_gs, v0, nv);
    if constexpr (F == kTensor) {
      load<V>(y, p.b + l * n, v0, nv);
      load<V>(y1, p.b + ln + l * n, v0, nv);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t a0 = x[i], a1 = x1[i];
      const uint64_t b0 = F == kTensor ? y[i] : a0;
      const uint64_t b1 = F == kTensor ? y1[i] : a1;
      uint64_t hi = __umul64hi(a0, b1), lo = a0 * b1;
      if constexpr (F == kTensor) {
        add128(hi, lo, __umul64hi(a1, b0), a1 * b0);
      } else {
        add128(hi, lo, hi, lo);
      }
      x[i] = mul_mod(a0, b0, q, rlo, rhi);
      z[i] = barrett128(hi, lo, q, rlo, rhi);
      x1[i] = mul_mod(a1, b1, q, rlo, rhi);
    }
    store<V>(p.out + l * n, x, v0, nv);
    store<V>(p.out + ln + l * n, z, v0, nv);
    store<V>(p.out + 2 * ln + l * n, x1, v0, nv);
  } else if constexpr (F == kMxn) {
    const uint64_t rlo = ld1(p.k + kRlo * num_l + l);
    const uint64_t rhi = ld1(p.k + kRhi * num_l + l);
    const int m = p.m, mb = p.b_groups;
    for (int t = 0; t < m + mb - 1; ++t) {
      uint64_t hi[W], lo[W];
#pragma unroll
      for (int i = 0; i < W; ++i) hi[i] = lo[i] = 0;
      for (int i = max(0, t - mb + 1); i < min(m, t + 1); ++i) {
        load<V>(x, p.a + i * p.a_gs + l * n, v0, nv);
        load<V>(y, p.b + (t - i) * ln + l * n, v0, nv);
#pragma unroll
        for (int w = 0; w < W; ++w)
          add128(hi[w], lo[w], __umul64hi(x[w], y[w]), x[w] * y[w]);
      }
#pragma unroll
      for (int w = 0; w < W; ++w) x[w] = barrett128(hi[w], lo[w], q, rlo, rhi);
      store<V>(p.out + t * ln + l * n, x, v0, nv);
    }
  } else {  // the Shoup forms
    constexpr bool kSub = F == kShoupSub || F == kShoupSubAdd;
    constexpr bool kAdd = F == kShoupAdd || F == kShoupSubAdd;
    const uint64_t w = ld1(p.k + kW * num_l + l);
    const uint64_t ws = ld1(p.k + kWs * num_l + l);
    load<V>(x, a, v0, nv);
    if constexpr (kSub) load<V>(y, p.b + r * n, v0, nv);
    if constexpr (kAdd) load<V>(z, p.c + g * p.c_gs + l * n, v0, nv);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      uint64_t v = x[i];
      if constexpr (kSub) v = sub_mod(v, y[i], q);
      v = shoup(v, w, ws, q);
      if constexpr (kAdd) v = add_mod(v, z[i], q);
      x[i] = v;
    }
    store<V>(p.out + r * n, x, v0, nv);
  }
}

// The row forms: blockIdx.y is the group g, blockIdx.z a chunk of
// l_chunk output limbs; the block reads its slice of the row once.
template <int F, int V>
__global__ void __launch_bounds__(kThreads) polyrows64_kernel(Args p) {
  constexpr int W = 2 * V;
  const int num_l = p.num_l;
  const int g = blockIdx.y;
  const int l0 = blockIdx.z * p.l_chunk;
  const int l1 = min(num_l, l0 + p.l_chunk);
  const int64_t n = p.n, nv = n >> 1;
  const int64_t v0 = int64_t{blockIdx.x} * V * kThreads + threadIdx.x;
  const uint64_t* s = p.k + kRows * num_l;  // the scalars
  uint64_t x[W], u[W], y[W];
  load<V>(x, p.a + g * p.a_gs, v0, nv);
  if constexpr (F == kRescaleDelta) {
    const uint64_t ql = ld1(s), half = ld1(s + 1);
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = add_mod(x[i], half, ql);
  } else if constexpr (F == kModswitchDelta) {
    const uint64_t t = ld1(s), wt = ld1(s + 1), wst = ld1(s + 2);
#pragma unroll
    for (int i = 0; i < W; ++i) u[i] = shoup(x[i], wt, wst, t);
  } else if constexpr (F == kModdownDelta) {
    const uint64_t t = ld1(s), ph = ld1(s + 1), wt = ld1(s + 2),
                   wst = ld1(s + 3);
#pragma unroll
    for (int i = 0; i < W; ++i) u[i] = shoup(sub_mod(x[i], ph, t), wt, wst, t);
  }
  for (int l = l0; l < l1; ++l) {
    const uint64_t q = ld1(p.k + kQ * num_l + l);
    const int64_t r = int64_t{g} * num_l + l;
    if constexpr (F == kModdownDelta) load<V>(y, p.b + r * n, v0, nv);
    if constexpr (F == kRowsTimes) {
      const uint64_t w = ld1(p.k + kW * num_l + l);
      const uint64_t ws = ld1(p.k + kWs * num_l + l);
#pragma unroll
      for (int i = 0; i < W; ++i) y[i] = shoup(x[i], w, ws, q);
    } else if constexpr (F == kRescaleDelta) {
      const uint64_t rhi = ld1(p.k + kRhi * num_l + l);
      const uint64_t e = ld1(p.k + kE * num_l + l);
#pragma unroll
      for (int i = 0; i < W; ++i) y[i] = sub_mod(shoup(x[i], 1, rhi, q), e, q);
    } else if constexpr (F == kModswitchDelta) {
      const uint64_t rhi = ld1(p.k + kRhi * num_l + l);
      const uint64_t w = ld1(p.k + kW * num_l + l);
      const uint64_t ws = ld1(p.k + kWs * num_l + l);
#pragma unroll
      for (int i = 0; i < W; ++i)
        y[i] = add_mod(shoup(x[i], 1, rhi, q), shoup(u[i], w, ws, q), q);
    } else {
      const uint64_t w = ld1(p.k + kW * num_l + l);
      const uint64_t ws = ld1(p.k + kWs * num_l + l);
      const uint64_t e = ld1(p.k + kE * num_l + l);
#pragma unroll
      for (int i = 0; i < W; ++i)
        y[i] = add_mod(sub_mod(y[i], e, q), shoup(u[i], w, ws, q), q);
    }
    store<V>(p.out + r * n, y, v0, nv);
  }
}

// 16-byte vectors a thread of each form, the fastest of 1, 2 and 4 on the
// u64 steps' calls at N = 2^16 (PERF.md §6, PR 16): one for the products
// and the Shoup forms, whose blocks are one output row's slice; two for
// rows_times and modswitch_delta; four for moddown_delta, which reads a
// whole operand for every limb
constexpr int vectors_of(int form) {
  if (form == kModdownDelta) return 4;
  return form == kRowsTimes || form == kModswitchDelta ? 2 : 1;
}

template <int F>
cudaError_t launch_form(const Args& p, dim3 grid, cudaStream_t st) {
  if constexpr (F < kFirstRowForm)
    polyops64_kernel<F, vectors_of(F)><<<grid, kThreads, 0, st>>>(p);
  else
    polyrows64_kernel<F, vectors_of(F)><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <int F = 0>
cudaError_t dispatch(int form, const Args& p, dim3 grid, cudaStream_t st) {
  if constexpr (F == kForms) {
    return cudaErrorInvalidValue;
  } else {
    return form == F ? launch_form<F>(p, grid, st)
                     : dispatch<F + 1>(form, p, grid, st);
  }
}

int sm_count() {
  static const int count = [] {
    int dev = 0, c = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    return c > 0 ? c : 1;
  }();
  return count;
}

}  // namespace
}  // namespace ptk64

using namespace ptk64;

extern "C" {

// The kernel launches U4 has made (chip_smoke.py divides them by the
// wrappers' calls: one a call).
long long ptk_u64_polyops_launches() { return launched.load(); }

// U4.  form: the list above.  out: contiguous, (groups, num_l, n) words
// (tensor, square: (3, num_l, n); mxn: (m + b_groups - 1, num_l, n)); a:
// groups (mxn: m; tensor, square: 2) of (num_l, n) rows (row forms: of
// one row), group stride a_gs; b: contiguous (b_groups, num_l, n),
// b_groups = groups or 1 (mul, fma), 2 (tensor), the second factor's size
// (mxn), groups (shoup with b, moddown_delta); c: like out, group stride
// c_gs; k: the constants table (rows of num_l words, then four scalars).
// n even, every row and vector 16-byte aligned (the wrapper checks).
int ptk_u64_polyops(int form, void* out, const void* a, const void* b,
                    const void* c, const void* k, long long a_gs,
                    long long c_gs, int groups, int b_groups, int m,
                    int num_l, int n, void* stream) {
  using u64p = const uint64_t*;
  if (form < 0 || form >= kForms || n < 2 || n % 2 || num_l < 1 ||
      groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<uint64_t*>(out), static_cast<u64p>(a),
         static_cast<u64p>(b), static_cast<u64p>(c), static_cast<u64p>(k),
         a_gs, c_gs, num_l, n, b_groups, m, num_l};
  const int v = vectors_of(form);
  const int64_t per_block = int64_t{v} * kThreads;
  const int xblocks = static_cast<int>((n / 2 + per_block - 1) / per_block);
  dim3 grid;
  if (form < kFirstRowForm) {
    const bool one = form == kTensor || form == kSquare || form == kMxn;
    const int rows = one ? num_l : num_l * groups;
    if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(xblocks, rows);
  } else {
    // enough chunks of limbs for two blocks an SM, each chunk reading the
    // row once
    const int64_t blocks = int64_t{xblocks} * groups;
    const int64_t want = (2 * sm_count() + blocks - 1) / blocks;
    const int chunks = static_cast<int>(want < num_l ? want : num_l);
    p.l_chunk = (num_l + chunks - 1) / chunks;
    if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(xblocks, groups, (num_l + p.l_chunk - 1) / p.l_chunk);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dispatch(form, p, grid, st);
  if (e == cudaSuccess) launched.fetch_add(1);
  return static_cast<int>(e);
}

}  // extern "C"

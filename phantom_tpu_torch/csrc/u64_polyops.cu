// U4: the Barrett-128 products of the u64 evaluator.
//
// Replaces the JAX package's u64 products, phantom_tpu/ops/modmath.py:146
// mul_mod under phantom_tpu/ops/polyops.py:34-103 (mul_rns, fma_rns,
// scalar_mul_rns, tensor_prod_2x2, tensor_square_2x2), which run as XLA
// fusions (no pallas_call).  One thread a word; the form is fixed per
// launch:
//   0 mul     out = a b                       b (Gb, L, N), Gb = G or 1
//   1 fma     out = a b + c
//   2 tensor  (a0 b0, a0 b1 + a1 b0, a1 b1)   cross term summed over 128
//                                             bits, reduced once
//   3 square  (a0^2, 2 a0 a1, a1^2)           the doubled cross term
//   4 shoup   out = (a - c) w_l               c optional, w_l per limb
//                                             with its Shoup word; a may
//                                             hold one row per group, read
//                                             for every limb
// every result mod q_l in [0, q_l).  Each word is read once and written
// once: the forms are bound by device memory.  A block row of the grid
// is one output row, so the limb of every word is the block's.

#include "modarith64.cuh"

namespace ptk64 {
namespace {

constexpr int kThreads = 256;

// blockIdx.y is an output row r = g L + l (forms 2 and 3: r = l, each
// thread writing the word of all three outputs), the x blocks its words:
// the limb comes from the block, so no word needs a 64-bit division.
__global__ void __launch_bounds__(kThreads)
polyops_kernel(int form, uint64_t* out, const uint64_t* a, const uint64_t* b,
               const uint64_t* c, const uint64_t* q, const uint64_t* rlo,
               const uint64_t* rhi, const uint64_t* w, const uint64_t* ws,
               int num_l, int n, int bcast, int a_row) {
  const int r = blockIdx.y;
  const int l = r % num_l;
  const int64_t ln = int64_t{num_l} * n;
  const int64_t row = int64_t{r} * n;
  const uint64_t ql = q[l], rl = rlo[l], rh = rhi[l];
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const int64_t e = row + j;
    if (form == 2 || form == 3) {
      const uint64_t a0 = a[e], a1 = a[ln + e];
      const uint64_t b0 = form == 2 ? b[e] : a0;
      const uint64_t b1 = form == 2 ? b[ln + e] : a1;
      uint64_t hi = __umul64hi(a0, b1), lo = a0 * b1;
      if (form == 2) {
        add128(hi, lo, __umul64hi(a1, b0), a1 * b0);
      } else {
        add128(hi, lo, hi, lo);
      }
      out[e] = mul_mod(a0, b0, ql, rl, rh);
      out[ln + e] = barrett128(hi, lo, ql, rl, rh);
      out[2 * ln + e] = mul_mod(a1, b1, ql, rl, rh);
    } else if (form == 4) {
      const uint64_t ae = a[a_row ? int64_t{r / num_l} * n + j : e];
      const uint64_t x = c == nullptr ? ae : sub_mod(ae, c[e], ql);
      out[e] = shoup(x, w[l], ws[l], ql);
    } else {
      uint64_t v = mul_mod(a[e], b[bcast ? int64_t{l} * n + j : e], ql, rl,
                           rh);
      if (form == 1) v = add_mod(v, c[e], ql);
      out[e] = v;
    }
  }
}

}  // namespace
}  // namespace ptk64

using namespace ptk64;

extern "C" {

// U4.  a (and out for forms 0, 1, 4): (groups, L, n), for form 4 also
// (groups, 1, n) with a_rows = 1; b: (gb, L, n) with gb = groups or 1
// (forms 0, 1), (2, L, n) (form 2); c like out or null; q, rlo, rhi, w,
// ws: (L,); forms 2 and 3 take groups = 2 and write (3, L, n).
int ptk_u64_polyops(int form, void* out, const void* a, const void* b,
                    const void* c, const void* q, const void* rlo,
                    const void* rhi, const void* w, const void* ws,
                    int groups, int gb, int num_l, int n, int a_rows,
                    void* stream) {
  using u64p = const uint64_t*;
  const int rows = (form == 2 || form == 3) ? num_l : num_l * groups;
  const dim3 grid((n + kThreads - 1) / kThreads, rows);
  polyops_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      form, static_cast<uint64_t*>(out), static_cast<u64p>(a),
      static_cast<u64p>(b), static_cast<u64p>(c), static_cast<u64p>(q),
      static_cast<u64p>(rlo), static_cast<u64p>(rhi), static_cast<u64p>(w),
      static_cast<u64p>(ws), num_l, n, gb == 1 && groups > 1,
      form == 4 && a_rows == 1 && num_l > 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

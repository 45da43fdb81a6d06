// K3: base conversion fused into the forward NTT.
//
// Replaces phantom_tpu/ops/ntt_mxu_pallas.py:bconv_ntt_forward_mxu_pallas
// (body _bconv_fwd_kernel).  For group g and output row j:
//   x = sum_i y[g, i] * mat[g, j, i] mod q_j  (exact: 128-bit accumulation)
//       - v[g] * vmul[j] - post_sub[j]
//   out[g, j] = epilogue(NTT_j(x)),
// with modup self rows (g*alpha <= j < min((g+1)*alpha, k_data)) passed
// through untransformed.  The conversion is the column pass's prologue
// (ntt_core.cuh), so the converted row never reaches device memory.  Each
// output row re-reads its group's alpha input rows (from L2 at the main
// path's shapes), so the kernel is bound by those reads and the
// alpha 64-bit products per element.

#include "ntt_core.cuh"

namespace ptk {
namespace {

struct BconvLoad {
  static constexpr bool kStoreSkipped = true;  // self rows pass through
  const uint32_t* y;    // (G, alpha, N)
  const uint32_t* mat;  // (G, k_out, alpha)
  int alpha, k_out;
  const uint32_t* v;     // optional (G, N)
  const uint32_t* vmul;  // (k_out,)
  const uint32_t* post;  // optional (k_out,)
  const uint32_t* self_rows;  // optional (>= k_data, N)
  int k_data;

  __device__ __forceinline__ bool skip(int j, int g) const {
    if (self_rows == nullptr) return false;
    const int hi = min((g + 1) * alpha, k_data);
    return j >= g * alpha && j < hi;
  }

  __device__ __forceinline__ uint32_t load(int, int j, int g, int64_t gi,
                                           int n, const Barrett& bq,
                                           bool is_self) const {
    if (is_self) return self_rows[static_cast<int64_t>(j) * n + gi];
    uint32_t x = dot_mod(y + static_cast<int64_t>(g) * alpha * n + gi, n,
                         mat + (static_cast<int64_t>(g) * k_out + j) * alpha,
                         alpha, bq);
    if (v != nullptr)
      x = sub_mod(x, mul_mod(v[static_cast<int64_t>(g) * n + gi], vmul[j], bq),
                  bq.q);
    if (post != nullptr) x = sub_mod(x, post[j], bq.q);
    return x;
  }
};

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// K3.  out: (G, k_out, N).  q, w, ws: the whole base's tables; rows: (k_out,)
// table row of each output row.  v/vmul, post, self_rows, sub/esc/escs and
// d1/d2 may each be null.
int ptk_bconv_ntt_forward(void* out, const void* y, const void* mat, int G_,
                          int alpha, int k_out, const void* q, const void* w,
                          const void* ws, const void* rows, int logn,
                          const void* v, const void* vmul, const void* post,
                          const void* self_rows, int k_data, const void* sub,
                          const void* esc, const void* escs, const void* d1,
                          const void* d2, void* stream) {
  const Geometry G = make_geometry(logn);
  const NttTables tb{static_cast<const uint32_t*>(q),
                     static_cast<const uint32_t*>(w),
                     static_cast<const uint32_t*>(ws),
                     static_cast<const int32_t*>(rows), k_out};
  const FwdEpilogue epi{static_cast<const uint32_t*>(sub),
                        static_cast<const uint32_t*>(esc),
                        static_cast<const uint32_t*>(escs),
                        static_cast<const uint32_t*>(d1),
                        static_cast<const uint32_t*>(d2)};
  const BconvLoad pro{static_cast<const uint32_t*>(y),
                      static_cast<const uint32_t*>(mat),
                      alpha,
                      k_out,
                      static_cast<const uint32_t*>(v),
                      static_cast<const uint32_t*>(vmul),
                      static_cast<const uint32_t*>(post),
                      static_cast<const uint32_t*>(self_rows),
                      k_data};
  launch_forward(pro, tb, epi, G, static_cast<uint32_t*>(out), G_ * k_out,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

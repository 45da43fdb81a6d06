// K6: the "pallas-roll" engine's one-pass negacyclic NTT: forward, forward
// with the moddown epilogue (sub_from - NTT(x)) * scale, and the scaled
// inverse.
//
// Replaces phantom_tpu/ops/ntt_pallas_roll.py:ntt_forward_roll /
// ntt_inverse_roll (bodies _fwd_kernel, _fwd_fused_kernel, _inv_kernel),
// which keep one row in VMEM for all log N stages of one program.  They
// compute what K2 (forward with the moddown epilogue, no tensor adds) and
// K1 (inverse with a per-limb scale, no mul_by, no floor sum) compute, so
// this entry runs K2's and K1's kernels (ntt.cu) on the one-pass,
// cluster-resident core (ntt_cluster.cuh): one cluster per row, the row
// read from device memory once and written once.  The TPU kernel's
// roll/select form and its stage tables are Mosaic workarounds with no
// counterpart.  Bound and times: K2's and K1's (ntt.cu, PERF.md).

#include <cuda_runtime.h>

extern "C" {

int ptk_ntt_forward(void* out, const void* x, const void* q, const void* w,
                    const void* ws, const void* rows, int L, int nrows,
                    int logn, const void* sub, const void* esc,
                    const void* escs, const void* d1, const void* d2,
                    int cluster, void* stream);
int ptk_ntt_inverse(void* out, const void* x, const void* q,
                    const void* winv, const void* winvs, const void* rows,
                    int L, int nrows, int logn, const void* mul_by,
                    const void* scale, const void* scale_shoup, void* v,
                    const void* U, const void* V, int cluster, void* stream);

// K6.  out, x: (nrows, N) in [0, 2q); q, w, ws: the whole base's tables
// (inverse twiddles for the inverse); rows: (L,) table row of each group
// row; cluster: blocks per row, as for ptk_ntt_forward.  Forward: sub,
// esc, escs may be null (no epilogue).  Inverse: scale, scale_shoup (L,).
int ptk_ntt_roll(void* out, const void* x, const void* q, const void* w,
                 const void* ws, const void* rows, int L, int nrows, int logn,
                 int cluster, const void* sub, const void* esc,
                 const void* escs, const void* scale, const void* scale_shoup,
                 int inverse, void* stream) {
  if (inverse)
    return ptk_ntt_inverse(out, x, q, w, ws, rows, L, nrows, logn, nullptr,
                           scale, scale_shoup, nullptr, nullptr, nullptr,
                           cluster, stream);
  return ptk_ntt_forward(out, x, q, w, ws, rows, L, nrows, logn, sub, esc,
                         escs, nullptr, nullptr, cluster, stream);
}

}  // extern "C"

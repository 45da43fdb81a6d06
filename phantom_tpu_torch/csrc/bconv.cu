// K5: the base-conversion modular matmul
//   out[j, c] = sum_i y[i, c] * mat[j, i] mod q_j.
//
// Replaces phantom_tpu/ops/bconv_pallas.py:fold_matmul_pallas (body
// _kernel), which splits operands into int8 digit planes for the MXU and
// folds each diagonal with a Shoup product.  Here each thread owns one
// column: the block stages its kBconvCols-column slice of y and the whole
// matrix in shared memory, and every output row is one exact 128-bit dot
// product and one reduction.  At the main path's shapes (k_in ~ 22,
// k_out ~ 44) it reads y once and writes out once, so device memory bounds
// it, with k_in * k_out 64-bit products per column beside that.  BFV's
// scale-and-round from D = Ql u Rl (k_in 87, k_out 44 at the headline)
// stages 59,856 bytes, past the 48 KB a launch gets by default: above
// that the launch opts into the larger dynamic shared memory first, and a
// size beyond the device's limit fails there with its CUDA error.

#include "modarith.cuh"

namespace ptk {
namespace {

constexpr int kBconvCols = 128;

__global__ void __launch_bounds__(kBconvCols)
fold_matmul_kernel(const uint32_t* y, const uint32_t* mat, const uint32_t* q,
                   int k_in, int k_out, int n, uint32_t* out) {
  extern __shared__ uint32_t sm[];
  uint32_t* ys = sm;                       // (k_in, kBconvCols)
  uint32_t* ms = sm + k_in * kBconvCols;   // (k_out, k_in)
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kBconvCols;
  for (int e = threadIdx.x; e < k_in * kBconvCols; e += blockDim.x) {
    const int64_t c = c0 + e % kBconvCols;
    ys[e] = c < n ? y[static_cast<int64_t>(e / kBconvCols) * n + c] : 0u;
  }
  for (int e = threadIdx.x; e < k_out * k_in; e += blockDim.x) ms[e] = mat[e];
  __syncthreads();
  for (int cl = threadIdx.x; cl < kBconvCols && c0 + cl < n;
       cl += blockDim.x) {
    for (int j = 0; j < k_out; ++j) {
      const Barrett bq = make_barrett(q[j]);
      out[static_cast<int64_t>(j) * n + c0 + cl] =
          dot_mod(ys + cl, kBconvCols, ms + j * k_in, k_in, bq);
    }
  }
}

}  // namespace
}  // namespace ptk

using namespace ptk;

extern "C" {

// Shared memory the launch needs, for the wrapper's size check.
int ptk_fold_matmul_smem(int k_in, int k_out) {
  return (k_in * kBconvCols + k_out * k_in) * static_cast<int>(sizeof(uint32_t));
}

// K5.  out: (k_out, n); y: (k_in, n); mat: (k_out, k_in); q: (k_out,).
int ptk_fold_matmul(void* out, const void* y, const void* mat, const void* q,
                    int k_in, int k_out, int n, void* stream) {
  const int blocks = (n + kBconvCols - 1) / kBconvCols;
  const int smem = ptk_fold_matmul_smem(k_in, k_out);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fold_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fold_matmul_kernel<<<blocks, kBconvCols, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(y), static_cast<const uint32_t*>(mat),
      static_cast<const uint32_t*>(q), k_in, k_out, n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

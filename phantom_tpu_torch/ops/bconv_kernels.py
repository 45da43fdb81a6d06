"""K5: the base-conversion modular matmul, its CUDA kernel and plain twin.

    out[j, c] = sum_i y[i, c] * mat[j, i] mod q[j]

Replaces phantom_tpu/ops/bconv_pallas.py:fold_matmul_pallas, which the JAX
package's flat-layout dispatch (bconv32._accumulate_reduce32) reaches for
every 2-D conversion.  On the main path it converts each modup digit to
its complement base: (22, N) -> (43, N) and (21, N) -> (44, N) at the
headline configuration.

The CUDA kernel (csrc/bconv.cu) runs on the int8 tensor cores: it splits
y and mat into four 8-bit digit planes each (as the TPU kernel does for
its MXU), multiplies the 16 plane pairs with mma.sync m16n8k32 into seven
exact s32 diagonal sums, and folds them with Shoup products by 2^(8d) mod
q.  Device memory bounds it: y is read once and out written once.  It
takes k_in up to MAX_K_IN (shared memory; the s32 diagonals stay exact to
k_in 8256) and N a multiple of 4, 16-byte aligned.
"""

from __future__ import annotations

import torch

from .. import _build
from .modmath32 import u32


def fold_matmul_plain(y: torch.Tensor, mat: torch.Tensor,
                      q: torch.Tensor) -> torch.Tensor:
    """y (k_in, N), mat (k_out, k_in), q (k_out,), entries < 2^30 ->
    (k_out, N) int32 in [0, q).  One reduced multiply-add per input row
    keeps every int64 intermediate below 2^61."""
    qc = u32(q).view(-1, 1)
    m = mat.long()
    acc = torch.zeros((mat.shape[0], y.shape[1]), dtype=torch.int64,
                      device=y.device)
    for i in range(y.shape[0]):
        acc = (acc + y[i].long().view(1, -1) * m[:, i:i + 1]) % qc
    return acc.int()


# the largest k_in the kernel takes: a block holds the planes of 128
# columns of y (4 k_in + 64 bytes each, k_in padded to 32) and of the
# matrix in shared memory, 194 KB at k_in 256 and k_out 44
MAX_K_IN = 256


def fold_matmul(y: torch.Tensor, mat: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """K5 on a CUDA tensor; the plain version on a CPU tensor."""
    if _build.is_plain(y, "fold_matmul"):
        return fold_matmul_plain(y, mat, q)
    k_in, n = y.shape
    k_out = mat.shape[0]
    if mat.shape != (k_out, k_in) or q.shape != (k_out,):
        raise ValueError(f"fold_matmul: mat {tuple(mat.shape)}, "
                         f"q {tuple(q.shape)} against y {tuple(y.shape)}")
    if not 1 <= k_in <= MAX_K_IN or n % 4:
        raise ValueError(f"fold_matmul: k_in={k_in}, N={n}: the kernel "
                         f"takes 1 <= k_in <= {MAX_K_IN} and N a multiple "
                         "of 4")
    _build.check_operands(y, mat, q)
    lib = _build.library()
    if lib.ptk_fold_matmul_smem(k_in, k_out) > _build.SMEM_OPTIN:
        raise ValueError(f"fold_matmul: k_in={k_in}, k_out={k_out} exceed "
                         "a block's shared memory")
    out = torch.empty((k_out, n), dtype=torch.int32, device=y.device)
    _build.check_aligned(y, out)
    with torch.cuda.device(y.device):
        err = lib.ptk_fold_matmul(out.data_ptr(), y.data_ptr(),
                                  mat.data_ptr(), q.data_ptr(), k_in, k_out,
                                  n, _build.stream(y))
    _build.check(err, "fold_matmul")
    fold_matmul.launches += 1
    return out


fold_matmul.launches = 0

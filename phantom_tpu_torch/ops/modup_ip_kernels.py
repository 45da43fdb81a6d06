"""K4: modup fused with the evaluation-key inner product, its CUDA kernel
and plain twin.

    out[h, j] = sum_d T_d[j] * evk[d, h, j]  mod q_j       (h = 0, 1)
    T_d[j]    = NTT_j(sum_i y[d alpha + i] * mats[d, j, i] mod q_j)

except inside digit d (d alpha <= j < min((d+1) alpha, k_data)), where
T_d[j] is the NTT-form passthrough row c2[j], or a[j] b[j] mod q_j when c2 is
the pair (a, b) (the CKKS step's tensor product, never stored).  Replaces
phantom_tpu/ops/ntt_mxu_pallas.py:modup_ip_mxu_pallas, which the JAX
package's default dispatch takes at alpha <= 8 for every NTT-form key
switch (rotations) and for the fused CKKS step.  The modup tensor T
(beta, k_out, N) never leaves the kernel.

The CUDA kernel (csrc/modup_ip.cu) runs the transform in two launches: the
column pass with the conversion prologue into a (beta, k_out, N) scratch
(for N > 4096; a digit's own rows are not stored), then one block per (4096-word chunk, row j) that loops over
the digits, finishes the transform in shared memory, multiplies by the evk
chunk and keeps the exact digit sum in registers.  It is bound by device
memory.  The coefficient-form variant (c2=None) and the preconv variant of
the TPU kernel are not ported.
"""

from __future__ import annotations

import torch

from .. import _build
from . import ntt32
from .bconv_kernels import fold_matmul_plain
from .modmath32 import u32
from .ntt32 import NTTTables32, resolve_rows
from .ntt_kernels import _expect, _logn


def _passthrough(c2, j_lo: int, j_hi: int, q: torch.Tensor) -> torch.Tensor:
    """Rows [j_lo, j_hi) of the passthrough, int64; q: (rows, 1)."""
    if isinstance(c2, tuple):
        a, b = (u32(x[j_lo:j_hi]) % q for x in c2)
        return a * b % q
    return u32(c2[j_lo:j_hi])


def modup_ip_plain(y, mats, c2, evk, t: NTTTables32, rows=None,
                   k_data=None) -> torch.Tensor:
    """y: (beta alpha, N); mats: (beta, k_out, alpha); c2: (beta alpha, N)
    or a pair of them; evk: (beta, 2, k_out, N) -> (2, k_out, N) int32."""
    if c2 is None:
        raise ValueError("modup_ip: the coefficient-form variant (c2=None) "
                         "is not ported")
    beta, k_out, alpha = mats.shape
    rows = resolve_rows(t, rows, k_out)
    q_rows = t.q[rows.long()]
    q = u32(q_rows).view(k_out, 1)
    k_data = beta * alpha if k_data is None else k_data
    x = torch.stack([fold_matmul_plain(y[d * alpha:(d + 1) * alpha], mats[d],
                                       q_rows) for d in range(beta)])
    tn = ntt32.ntt_forward32(x, t, rows).long()
    acc = torch.zeros((2, k_out, y.shape[-1]), dtype=torch.int64,
                      device=y.device)
    for d in range(beta):
        lo, hi = d * alpha, min((d + 1) * alpha, k_data, k_out)
        if hi > lo:
            tn[d, lo:hi] = _passthrough(c2, lo, hi, q[lo:hi])
        acc = (acc + tn[d] * u32(evk[d])) % q
    return acc.int()


def modup_ip(y: torch.Tensor, mats: torch.Tensor, c2, evk: torch.Tensor,
             t: NTTTables32, rows=None, k_data=None) -> torch.Tensor:
    """K4 on CUDA tensors; the plain version on CPU tensors.  y, c2 (or
    each of the pair): (beta alpha, N); mats: (beta, k_out, alpha); evk:
    (beta, 2, k_out, N); rows: the table row of each of the k_out output
    rows (default all of `t`'s).  Returns (2, k_out, N) int32 in [0, q)."""
    if _build.is_plain(y, "modup_ip"):
        return modup_ip_plain(y, mats, c2, evk, t, rows, k_data)
    if c2 is None:
        raise ValueError("modup_ip: the coefficient-form variant (c2=None) "
                         "is not ported")
    if mats.dim() != 3:
        raise ValueError(f"modup_ip: mats {tuple(mats.shape)} is not "
                         "(beta, k_out, alpha)")
    beta, k_out, alpha = mats.shape
    k = beta * alpha
    n = y.shape[-1]
    logn = _logn(n)
    k_data = k if k_data is None else k_data
    if not 0 < k_data <= k:
        raise ValueError(f"modup_ip: k_data={k_data} outside (0, {k}]")
    rows = resolve_rows(t, rows, k_out)
    a, b = c2 if isinstance(c2, tuple) else (c2, None)
    _expect(y, (k, n), "y")
    _expect(a, (k, n), "c2")
    _expect(b, (k, n), "c2 b")
    _expect(evk, (beta, 2, k_out, n), "evk")
    opt = [b] if b is not None else []
    _build.check_operands(y, mats, a, evk, rows, t.q, t.root_powers,
                          t.root_powers_shoup, *opt)
    out = torch.empty((2, k_out, n), dtype=torch.int32, device=y.device)
    scratch = torch.empty((beta, k_out, n), dtype=torch.int32,
                          device=y.device)
    with torch.cuda.device(y.device):
        err = _build.library().ptk_modup_ip(
            out.data_ptr(), scratch.data_ptr(), y.data_ptr(), mats.data_ptr(),
            a.data_ptr(), None if b is None else b.data_ptr(),
            evk.data_ptr(), beta, alpha, k_out, k_data, t.q.data_ptr(),
            t.root_powers.data_ptr(), t.root_powers_shoup.data_ptr(),
            rows.data_ptr(), logn, _build.stream(y))
    _build.check(err, "modup_ip")
    modup_ip.launches += 1
    return out


modup_ip.launches = 0

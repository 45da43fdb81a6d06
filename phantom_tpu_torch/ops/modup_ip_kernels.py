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

The coefficient-form variant (the TPU kernel with c2_ntt=None, which the
JAX package's keyswitch32 takes on its default engine for the BFV
relinearization) is `modup_ip_coeff`, a wrapper of its own with its own
launch count: no passthrough rows, every (digit, row) pair converted and
transformed, the digit's own rows included (the caller's mats carry the
digit's qhat diagonal there, so the conversion recovers x_j from the
pre-scaled y_j).

The CUDA kernel (csrc/modup_ip.cu) is one launch per call: one
thread-block cluster per output row j holds the row in shared memory
(csrc/ntt_cluster.cuh) and loops over the digits, converting, transforming
(radix 8 in registers) and multiplying by the evk share in turn, with the
digit sums as residues in shared memory (exact for any beta).  y and c2
hold the data rows only (k_data rows, a short last digit unpadded): the
kernel clamps each digit's rows by k_data.

The preconv form (the TPU kernel with preconv=True, which the JAX package's
CKKS step takes on its "xla" modup route) is `modup_ip_preconv`, again a
wrapper of its own with its own launch count: the base conversion is done
before the call (K5 per digit, pipeline32.modup_delta_xla32), so the kernel
reads the converted (beta, k_out, N) delta in place of y and mats and only
transforms and multiply-accumulates.  Inside digit d it passes a[j] (or
a[j] b[j]) through as the NTT form does and never reads delta[d, j].
"""

from __future__ import annotations

import torch

from .. import _build
from . import ntt32
from .bconv_kernels import fold_matmul_plain
from .modmath32 import u32
from .ntt32 import NTTTables32, resolve_rows
from .ntt_kernels import (_expect, _logn, check_aligned, default_cluster,
                          sum_fits_64)


def _passthrough(c2, j_lo: int, j_hi: int, q: torch.Tensor) -> torch.Tensor:
    """Rows [j_lo, j_hi) of the passthrough, int64; q: (rows, 1)."""
    if isinstance(c2, tuple):
        a, b = (u32(x[j_lo:j_hi]) % q for x in c2)
        return a * b % q
    return u32(c2[j_lo:j_hi])


def _modup(y, mats, t: NTTTables32, rows, k_data):
    """T_d = NTT(sum_i y[d alpha + i] mats[d, :, i]) for every digit and
    row, over the digit's rows below k_data, int64 (beta, k_out, N), and
    the moduli (k_out, 1)."""
    beta, k_out, alpha = mats.shape
    rows = resolve_rows(t, rows, k_out)
    q_rows = t.q[rows.long()]
    x = torch.stack([fold_matmul_plain(
        y[d * alpha:min((d + 1) * alpha, k_data)], mats[d], q_rows)
        for d in range(beta)])
    return ntt32.ntt_forward32(x, t, rows).long(), u32(q_rows).view(k_out, 1)


def _in_digit(beta: int, alpha: int, k_data: int, k_out: int):
    """(d, lo, hi) of each digit's own rows: d alpha <= j < min((d + 1)
    alpha, k_data, k_out)."""
    for d in range(beta):
        lo, hi = d * alpha, min((d + 1) * alpha, k_data, k_out)
        if hi > lo:
            yield d, lo, hi


def _digit_sum(tn, evk, q) -> torch.Tensor:
    acc = torch.zeros((2,) + tuple(tn.shape[1:]), dtype=torch.int64,
                      device=tn.device)
    for d in range(tn.shape[0]):
        acc = (acc + tn[d] * u32(evk[d])) % q
    return acc.int()


def modup_ip_plain(y, mats, c2, evk, t: NTTTables32, rows=None,
                   k_data=None) -> torch.Tensor:
    """y: (k_y, N), digit d's rows from row d alpha, those below k_data
    (default k_y) read; mats: (beta, k_out, alpha); c2: (k_y, N) or a pair
    of them; evk: (beta, 2, k_out, N) -> (2, k_out, N) int32."""
    if c2 is None:
        raise ValueError("modup_ip: c2=None is the coefficient form; call "
                         "modup_ip_coeff")
    beta, k_out, alpha = mats.shape
    k_data = y.shape[0] if k_data is None else k_data
    tn, q = _modup(y, mats, t, rows, k_data)
    for d, lo, hi in _in_digit(beta, alpha, k_data, k_out):
        tn[d, lo:hi] = _passthrough(c2, lo, hi, q[lo:hi])
    return _digit_sum(tn, evk, q)


def modup_ip_preconv_plain(delta, c2, evk, t: NTTTables32, rows=None,
                           k_data=None, alpha=None) -> torch.Tensor:
    """The preconv form.  delta: (beta, k_out, N), the converted rows in
    [0, 2 q_j), read only outside each digit's own rows; c2: (k_c, N) or a
    pair of them, the rows below k_data (default k_c) read; evk: (beta, 2,
    k_out, N); alpha: the digit width -> (2, k_out, N) int32."""
    if alpha is None:
        raise ValueError("modup_ip_preconv: alpha (the digit width) is "
                         "required")
    beta, k_out, n = delta.shape
    rows = resolve_rows(t, rows, k_out)
    q = u32(t.q[rows.long()]).view(k_out, 1)
    k_data = (c2[0] if isinstance(c2, tuple) else c2).shape[0] \
        if k_data is None else k_data
    x = delta.clone()
    for d, lo, hi in _in_digit(beta, alpha, k_data, k_out):
        x[d, lo:hi] = 0  # never read: the passthrough takes these rows
    tn = ntt32.ntt_forward32(x, t, rows).long()
    for d, lo, hi in _in_digit(beta, alpha, k_data, k_out):
        tn[d, lo:hi] = _passthrough(c2, lo, hi, q[lo:hi])
    return _digit_sum(tn, evk, q)


def modup_ip_coeff_plain(y, mats, evk, t: NTTTables32,
                         rows=None) -> torch.Tensor:
    """The coefficient form: every (digit, row) converted and transformed,
    no passthrough, the rows of y read (k_data = its row count).  Shapes as
    modup_ip_plain's."""
    tn, q = _modup(y, mats, t, rows, y.shape[0])
    return _digit_sum(tn, evk, q)


def _launch(y, mats, c2, evk, t: NTTTables32, rows, k_data, alpha=None):
    """ptk_modup_ip; c2 None is the coefficient form; mats None the preconv
    form, where y is the (beta, k_out, N) delta and alpha is given."""
    a, b = c2 if isinstance(c2, tuple) else (c2, None)
    if mats is None:
        beta, k_out = y.shape[:2]
        _expect(y, (beta, k_out, y.shape[-1]), "delta")
        k_rows = a.shape[0]
    elif mats.dim() != 3:
        raise ValueError(f"modup_ip: mats {tuple(mats.shape)} is not "
                         "(beta, k_out, alpha)")
    else:
        beta, k_out, alpha = mats.shape
        k_rows = y.shape[0]
    n = y.shape[-1]
    logn = _logn(n)
    k_data = k_rows if k_data is None else k_data
    lo, hi = (beta - 1) * alpha, min(k_rows, beta * alpha)
    if not lo < k_data <= hi:
        raise ValueError(f"modup_ip: k_data={k_data} outside ({lo}, {hi}]")
    rows = resolve_rows(t, rows, k_out)
    if mats is not None:
        _expect(y, (k_rows, n), "y")
    for x, what in ((a, "c2"), (b, "c2 b")):
        if x is not None and (x.dim() != 2 or x.shape[1] != n
                              or x.shape[0] < k_data):
            raise ValueError(f"modup_ip: {what} {tuple(x.shape)} needs "
                             f"k_data={k_data} rows of N={n}")
    _expect(evk, (beta, 2, k_out, n), "evk")
    opt = [x for x in (mats, a, b) if x is not None]
    _build.check_operands(y, evk, rows, t.q, t.root_powers,
                          t.root_powers_shoup, *opt)
    out = torch.empty((2, k_out, n), dtype=torch.int32, device=y.device)
    check_aligned(out, y, a, b, evk)
    with torch.cuda.device(y.device):
        err = _build.library().ptk_modup_ip(
            out.data_ptr(), y.data_ptr(),
            None if mats is None else mats.data_ptr(),
            None if a is None else a.data_ptr(),
            None if b is None else b.data_ptr(),
            evk.data_ptr(), beta, alpha, k_out, k_data, t.q.data_ptr(),
            t.root_powers.data_ptr(), t.root_powers_shoup.data_ptr(),
            rows.data_ptr(), logn, default_cluster(n),
            int(sum_fits_64(alpha, t)), _build.stream(y))
    _build.check(err, "modup_ip")
    return out


def modup_ip(y: torch.Tensor, mats: torch.Tensor, c2, evk: torch.Tensor,
             t: NTTTables32, rows=None, k_data=None) -> torch.Tensor:
    """K4 on CUDA tensors; the plain version on CPU tensors.  y, c2 (or
    each of the pair): (k_y, N), digit d's rows from row d alpha, the rows
    below k_data (default k_y; (beta - 1) alpha < k_data <= beta alpha)
    read, so a short last digit needs no zero rows; y below 2^b (b the bit
    length of `t`'s largest modulus); mats: (beta, k_out, alpha), words
    below 2^30; evk: (beta, 2, k_out, N) residues; rows: the table row of
    each of the k_out output rows (default all of `t`'s).  Returns (2,
    k_out, N) int32 in [0, q)."""
    if _build.is_plain(y, "modup_ip"):
        return modup_ip_plain(y, mats, c2, evk, t, rows, k_data)
    if c2 is None:
        raise ValueError("modup_ip: c2=None is the coefficient form; call "
                         "modup_ip_coeff")
    out = _launch(y, mats, c2, evk, t, rows, k_data)
    modup_ip.launches += 1
    return out


def modup_ip_coeff(y: torch.Tensor, mats: torch.Tensor, evk: torch.Tensor,
                   t: NTTTables32, rows=None) -> torch.Tensor:
    """K4's coefficient form on CUDA tensors; the plain version on CPU
    tensors.  Shapes as modup_ip's; mats carries each digit's qhat
    diagonal on its own rows."""
    if _build.is_plain(y, "modup_ip_coeff"):
        return modup_ip_coeff_plain(y, mats, evk, t, rows)
    out = _launch(y, mats, None, evk, t, rows, None)
    modup_ip_coeff.launches += 1
    return out


def modup_ip_preconv(delta: torch.Tensor, c2, evk: torch.Tensor,
                     t: NTTTables32, rows=None, k_data=None,
                     alpha=None) -> torch.Tensor:
    """K4's preconv form on CUDA tensors; the plain version on CPU tensors.
    delta: (beta, k_out, N) converted rows in [0, 2 q_j) (a digit's own
    rows are never read); c2 (or each of the pair): (k_c, N), the rows
    below k_data (default k_c) read; evk: (beta, 2, k_out, N); alpha: the
    digit width.  Returns (2, k_out, N) int32 in [0, q)."""
    if _build.is_plain(delta, "modup_ip_preconv"):
        return modup_ip_preconv_plain(delta, c2, evk, t, rows, k_data, alpha)
    if alpha is None or c2 is None:
        raise ValueError("modup_ip_preconv: needs alpha and the "
                         "passthrough c2")
    out = _launch(delta, None, c2, evk, t, rows, k_data, alpha)
    modup_ip_preconv.launches += 1
    return out


modup_ip.launches = 0
modup_ip_coeff.launches = 0
modup_ip_preconv.launches = 0

"""RNS base conversion on 32-bit residues (q < 2^30).

Counterpart of phantom_tpu/ops/bconv32.py:21-182.  Every conversion takes
`fold_matmul`, the K5 wrapper or its plain version, so the pipelines'
`ops` reach every K5 launch.  Constants come from a
host `BaseConverter`; the conversion matmul runs on K5
(ops/bconv_kernels.py), the rest is plain int64 torch.  The MXU
digit-plane formulations and their pow2 fold tables are TPU workarounds
and have no counterpart here.
"""

from __future__ import annotations

import torch
from torch import nn

from . import bconv_kernels
from .modmath32 import mul_mod_shoup32, u32
from .ntt32 import u32_tensor


class ModulusVec32(nn.Module):
    """The moduli of a base, an int32 buffer `q`.  The JAX package's Barrett
    ratio and 2^32 / 2^64 words have no counterpart: the plain versions
    reduce with exact int64 `%` and the kernels derive their Barrett
    constants from q."""

    def __init__(self, moduli):
        super().__init__()
        qs = [int(q) for q in moduli]
        if not all(q < (1 << 30) for q in qs):
            raise ValueError("32-bit moduli must be < 2^30")
        self.register_buffer("q", u32_tensor(qs))


class BaseConvConsts32(nn.Module):
    """Constants to convert from ibase to obase: QhatInv mod q_i and its
    Shoup word, the (k_out, k_in) matrix Qhat_i mod p_j, Q mod p_j, and
    U = floor(2^32/q_i), V = 2^32 mod q_i for the floor-sum."""

    def __init__(self, conv):
        """conv: a host BaseConverter (phantom_tpu/host/rns.py)."""
        super().__init__()
        ib, ob = conv.ibase, conv.obase
        self.ibase = ModulusVec32(ib.moduli)
        self.obase = ModulusVec32(ob.moduli)
        self.register_buffer("qhat_inv", u32_tensor(ib.qhat_inv_mod_qi))
        self.register_buffer("qhat_inv_shoup", u32_tensor(
            [(v << 32) // q for v, q in zip(ib.qhat_inv_mod_qi, ib.moduli)]))
        self.register_buffer("qhat_mod_p", u32_tensor(conv.qhat_mod_p))
        self.register_buffer("q_mod_p", u32_tensor(conv.q_mod_p))
        self.register_buffer("U", u32_tensor([(1 << 32) // q
                                              for q in ib.moduli]))
        self.register_buffer("V", u32_tensor([(1 << 32) % q
                                              for q in ib.moduli]))


def consts32_from_host(conv) -> BaseConvConsts32:
    return BaseConvConsts32(conv)


def _col(vec: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(L,) constant against (L, ...) data, as int64."""
    return u32(vec).view((-1,) + (1,) * (x.dim() - 1))


def scale_by_qhat_inv32(x: torch.Tensor, c: BaseConvConsts32) -> torch.Tensor:
    return mul_mod_shoup32(x, _col(c.qhat_inv, x), _col(c.qhat_inv_shoup, x),
                           _col(c.ibase.q, x)).int()


def matmul_reduce32(y: torch.Tensor, c: BaseConvConsts32,
                    fold_matmul=bconv_kernels.fold_matmul) -> torch.Tensor:
    """sum_i y_i * Qhat_i mod p_j on *pre-scaled* y (x * QhatInv already
    applied, e.g. fused into an inverse NTT).  y: (k_in, ...)."""
    out = fold_matmul(y.reshape(y.shape[0], -1).contiguous(), c.qhat_mod_p,
                      c.obase.q)
    return out.view((-1,) + tuple(y.shape[1:]))


def floor_sum_div32(y: torch.Tensor, c: BaseConvConsts32) -> torch.Tensor:
    """v = floor(sum_i y_i / q_i) over y: (k_in, ...) in [0, q)."""
    return floor_sum_div_uv(y, c.ibase.q, c.U, c.V)


def floor_sum_div_uv(y: torch.Tensor, q: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """floor_sum_div32 on explicit (k_in,) constants q, U = floor(2^32/q),
    V = 2^32 mod q, by the JAX package's three-level 2^32 cascade: per row
    the 96-bit expansion y/q ~ (y U + q1) 2^-32 + s2 2^-64 + s3 2^-96
    (q1, s2, s3 from successive exact divisions by q), the three word sums
    A, B, C taken exactly, then (A 2^64 + B 2^32 + C) >> 96.  Sums over
    dim 0; returns int32 (...)."""
    qc = _col(q, y)
    yv = u32(y)
    y_u = (yv * _col(u, y)) & 0xFFFFFFFF
    h = yv * _col(v, y)
    q1, r1 = h // qc, h % qc
    s2, r2 = (r1 << 32) // qc, (r1 << 32) % qc
    s3 = (r2 << 32) // qc
    a = (y_u + q1).sum(0)
    b = s2.sum(0)
    cc = s3.sum(0)
    return ((a + ((b + (cc >> 32)) >> 32)) >> 32).int()


def bconv_approx32(x: torch.Tensor, c: BaseConvConsts32,
                   fold_matmul=bconv_kernels.fold_matmul) -> torch.Tensor:
    """Fast (approximate) conversion: sum_i [x_i QhatInv_i] Qhat_i mod p_j,
    off by a multiple v Q of the exact value (the modup's digit
    conversion)."""
    return matmul_reduce32(scale_by_qhat_inv32(x, c), c, fold_matmul)


def bconv_exact32(x: torch.Tensor, c: BaseConvConsts32,
                  fold_matmul=bconv_kernels.fold_matmul) -> torch.Tensor:
    """Value-exact conversion (reference bConv_HPS semantics).
    fold_matmul: the matmul's K5 (or its plain version)."""
    y = scale_by_qhat_inv32(x, c)
    return exact_from_scaled32(y, floor_sum_div32(y, c), c, fold_matmul)


def exact_from_scaled32(y: torch.Tensor, v: torch.Tensor,
                        c: BaseConvConsts32,
                        fold_matmul=bconv_kernels.fold_matmul) -> torch.Tensor:
    """bconv_exact32 from the pre-scaled y = [x QhatInv] and its floor sum
    v, which depend on the input base alone: two conversions of one x to
    two output bases share them."""
    raw = matmul_reduce32(y, c, fold_matmul).long()
    q = _col(c.obase.q, raw)
    return ((raw - v.long().unsqueeze(0) * _col(c.q_mod_p, raw)) % q).int()

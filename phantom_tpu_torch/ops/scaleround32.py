"""Exact scale-and-round on 32-bit residues (q, t < 2^30).

Counterpart of phantom_tpu/ops/scaleround32.py:26-130: round((num/den) x)
from ibase to obase by the v-free construction (every output prime divides
G = num prod(ibase) / den).  With y_i = [x_i (I/d_i)^-1]_{d_i} and the
exact split G = omega_i d_i + rho_i,

    round((num/den) x) = sum_i y_i omega_i + round(sum_i y_i rho_i / d_i)
                         (mod every output prime),

the integer part is the (k_out, k_in) matmul of y with omega mod out_j,
which runs on K5 (bconv_kernels.fold_matmul); the fractional part
F = round(sum_i y_i rho_i / d_i) is the JAX package's three-level 2^32
fixed-point cascade, here in plain int64 torch (in JAX it is XLA, outside
any Pallas kernel): per row y_i rho_i = g_i d_i + r_i, then three more
exact divisions give the 2^-32, 2^-64, 2^-96 words of r_i / d_i; the four
word sums over the rows are exact in int64 (at most 87 rows of words below
2^32), and F = sum g_i + floor((E2 2^64 + E3 2^32 + E4 + 2^95) / 2^96),
the 2^95 rounding bit placed as in the JAX code.  Bit-equal to the JAX
function on the same inputs.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import host
from . import bconv_kernels
from .bconv32 import ModulusVec32, _col
from .modmath32 import MASK32, mul_mod_shoup32, u32
from .ntt32 import u32_tensor


class ExactScaleRound32(nn.Module):
    """Tables for round((num/den) x) : ibase -> obase: (I/d_i)^-1 mod d_i
    with its Shoup word, the (k_out, k_in) matrix omega_i mod out_j and
    rho_i (buffers)."""

    def __init__(self, in_moduli, num: int, den: int, out_moduli):
        super().__init__()
        ibase = host.RNSBase(list(in_moduli))
        if ibase.prod % den:
            raise ValueError("den must divide prod(ibase)")
        g = num * (ibase.prod // den)
        if any(g % p for p in out_moduli):
            raise ValueError("output primes must divide num prod(I) / den")
        omega = [g // d for d in ibase.moduli]
        self.ibase = ModulusVec32(ibase.moduli)
        self.obase = ModulusVec32(out_moduli)
        self.register_buffer("ihat_inv", u32_tensor(ibase.qhat_inv_mod_qi))
        self.register_buffer("ihat_inv_shoup", u32_tensor(
            [(v << 32) // q for v, q in zip(ibase.qhat_inv_mod_qi,
                                            ibase.moduli)]))
        self.register_buffer("omega_mod_out", u32_tensor(
            [[w % p for w in omega] for p in out_moduli]))
        self.register_buffer("rho", u32_tensor(
            [g - w * d for w, d in zip(omega, ibase.moduli)]))


def make_exact_scale_round32(in_moduli, num: int, den: int,
                             out_moduli) -> ExactScaleRound32:
    return ExactScaleRound32(in_moduli, num, den, out_moduli)


def scale_and_round_exact32(x: torch.Tensor, c: ExactScaleRound32,
                            fold_matmul=bconv_kernels.fold_matmul
                            ) -> torch.Tensor:
    """x: (k_in, N) residues -> (k_out, N) int32 residues of
    round((num/den) x).  fold_matmul: the integer part's K5 (or its plain
    version)."""
    d = _col(c.ibase.q, x)
    y = mul_mod_shoup32(x, _col(c.ihat_inv, x), _col(c.ihat_inv_shoup, x),
                        d)
    int_part = fold_matmul(y.int().contiguous(), c.omega_mod_out, c.obase.q)
    prod = y * _col(c.rho, x)                     # < 2^60
    g, r = prod // d, prod % d
    f2, r2 = (r << 32) // d, (r << 32) % d
    f3, r3 = (r2 << 32) // d, (r2 << 32) % d
    f4 = (r3 << 32) // d
    e2, e3, e4 = f2.sum(0), f3.sum(0), f4.sum(0)
    # floor((E2 2^64 + E3 2^32 + E4 + 2^95) / 2^96), word by word
    w1 = (e3 & MASK32) + (e4 >> 32)
    w2 = (e2 & MASK32) + (e3 >> 32) + (1 << 31) + (w1 >> 32)
    frac = g.sum(0) + (e2 >> 32) + (w2 >> 32)
    q_out = _col(c.obase.q, int_part)
    return ((u32(int_part) + frac.unsqueeze(0)) % q_out).int()

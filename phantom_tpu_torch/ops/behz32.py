"""BEHZ's RNS machinery on 32-bit residues (every Ql and Bsk prime < 2^30).

Counterpart of phantom_tpu/ops/behz32.py:1-164 (BEHZConsts32,
make_behz_consts32, sm_mrq32, fast_floor32, fastbconv_sk32).  Each
approximate conversion's matmul runs on K5 (ops/bconv_kernels.py):
Ql -> Bsk in the lift and in the fast floor, B -> Ql and B -> {m_sk} in
the Shenoy-Kumaresan conversion.  The rest is plain int64 torch, as the
JAX package runs it in XLA.

The redundant modulus m_tilde = 2^32 is native in the JAX code (uint32
wraparound); the port's residues are int32, so that arithmetic is done in
int64 and masked to 32 bits: each product y_i (Qhat_i mod 2^32) below
2^62 masked before the sum, and the product of two 32-bit words split in
16-bit halves so it stays inside int64.  The test r > 2^31 is on the
unsigned value.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import host
from . import bconv_kernels
from .bconv32 import (BaseConvConsts32, ModulusVec32, _col, bconv_approx32,
                      matmul_reduce32, scale_by_qhat_inv32)
from .modmath32 import MASK32, u32
from .ntt32 import u32_tensor

M_TILDE = 1 << 32


class BEHZConsts32(nn.Module):
    """The BEHZ tables of one level (the JAX package's BEHZConsts32): the
    converters Ql -> Bsk, B -> Ql and B -> {m_sk}, the Bsk moduli, Qhat_i
    mod 2^32 and -Q^-1 mod 2^32 for the Ql -> {m_tilde} conversion, and
    the per-Bsk-prime constants of the Montgomery correction, the fast
    floor and the Shenoy-Kumaresan correction (buffers; scalars are host
    integers)."""

    def __init__(self, data_moduli, bsk_moduli, t: int):
        super().__init__()
        data_moduli = [int(q) for q in data_moduli]
        bsk_moduli = [int(m) for m in bsk_moduli]
        if not all(m < 1 << 30 for m in bsk_moduli):
            raise ValueError("32-bit BEHZ needs Bsk primes < 2^30")
        q_base = host.RNSBase(data_moduli)
        b_base = host.RNSBase(bsk_moduli[:-1])
        m_sk = bsk_moduli[-1]
        big_q, big_b = q_base.prod, b_base.prod
        inv = host.numth.invert_mod
        qinv_bsk = [inv(big_q % m, m) for m in bsk_moduli]
        mtinv_bsk = [inv(M_TILDE % m, m) for m in bsk_moduli]
        self.q_to_bsk = BaseConvConsts32(host.BaseConverter(
            q_base, host.RNSBase(bsk_moduli)))
        self.b_to_q = BaseConvConsts32(host.BaseConverter(b_base, q_base))
        self.b_to_msk = BaseConvConsts32(host.BaseConverter(
            b_base, host.RNSBase([m_sk])))
        self.bsk = ModulusVec32(bsk_moduli)
        self.register_buffer("qhat_mod_mtilde", u32_tensor(
            [big_q // q % M_TILDE for q in data_moduli]))
        self.neg_q_inv_mod_mtilde = (M_TILDE - inv(big_q % M_TILDE,
                                                   M_TILDE)) % M_TILDE
        for name, vals in (
                ("q_mod_bsk", [big_q % m for m in bsk_moduli]),
                ("mtilde_inv_mod_bsk", mtinv_bsk),
                ("mtilde_mod_bsk", [M_TILDE % m for m in bsk_moduli]),
                ("q_inv_mod_bsk", qinv_bsk),
                ("b_mod_q", [big_b % q for q in data_moduli]),
                ("t_mod_q", [t % q for q in data_moduli]),
                ("t_mod_bsk", [t % m for m in bsk_moduli])):
            self.register_buffer(name, u32_tensor(vals))
        self.b_inv_mod_msk = inv(big_b % m_sk, m_sk)
        self.m_sk = m_sk
        self.msk_half = m_sk >> 1


def make_behz_consts32(data_moduli, bsk_moduli, t: int) -> BEHZConsts32:
    return BEHZConsts32(data_moduli, bsk_moduli, t)


def mul_mod_2_32(a: torch.Tensor, b: int) -> torch.Tensor:
    """a b mod 2^32 for a: int64 words below 2^32 and a host word b below
    2^32, in 16-bit halves of b so that no product leaves int64."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def sm_mrq32(x_q: torch.Tensor, c: BEHZConsts32,
             fold_matmul=bconv_kernels.fold_matmul) -> torch.Tensor:
    """Lift x (size_ql, N) over Ql to Bsk with the small Montgomery
    reduction by m_tilde = 2^32: (size_ql + 1, N).  fold_matmul: the
    Ql -> Bsk conversion's K5 (or its plain version)."""
    conv = c.q_to_bsk
    qcol = _col(conv.ibase.q, x_q)
    xp = (x_q.long() * ((M_TILDE % qcol))) % qcol   # m_tilde x mod q
    y = scale_by_qhat_inv32(xp, conv)
    conv_bsk = matmul_reduce32(y, conv, fold_matmul).long()
    # Ql -> {m_tilde}: sum_i y_i (Qhat_i mod 2^32) mod 2^32
    conv_mt = ((u32(y) * _col(c.qhat_mod_mtilde, y)) & MASK32).sum(0) & MASK32
    r = mul_mod_2_32(conv_mt, c.neg_q_inv_mod_mtilde)
    bskq = _col(c.bsk.q, conv_bsk)
    r_red = r.unsqueeze(0) % bskq
    r_eff = torch.where((r > 1 << 31).unsqueeze(0),
                        (r_red - _col(c.mtilde_mod_bsk, conv_bsk)) % bskq,
                        r_red)
    summed = (conv_bsk + r_eff * _col(c.q_mod_bsk, conv_bsk)) % bskq
    return (summed * _col(c.mtilde_inv_mod_bsk, conv_bsk) % bskq).int()


def fast_floor32(x_q: torch.Tensor, x_bsk: torch.Tensor, c: BEHZConsts32,
                 fold_matmul=bconv_kernels.fold_matmul) -> torch.Tensor:
    """floor(x / Q) in base Bsk, off by less than size_ql: (x_bsk - the
    fast conversion of x_q) Q^-1 mod each Bsk prime.  fold_matmul: the
    Ql -> Bsk conversion's K5."""
    conv = bconv_approx32(x_q, c.q_to_bsk, fold_matmul).long()
    bskq = _col(c.bsk.q, conv)
    return ((x_bsk.long() - conv) * _col(c.q_inv_mod_bsk, conv)
            % bskq).int()


def fastbconv_sk32(x_bsk: torch.Tensor, c: BEHZConsts32,
                   fold_matmul=bconv_kernels.fold_matmul) -> torch.Tensor:
    """Shenoy-Kumaresan's exact conversion Bsk -> Ql: the fast conversions
    of the B rows to Ql and to {m_sk} (K5 each, sharing the QhatInv
    scale), then the correction by alpha = (conv_msk - x_msk) B^-1 mod
    m_sk, centered."""
    k_b = c.b_to_q.ibase.q.shape[0]
    y = scale_by_qhat_inv32(x_bsk[:k_b], c.b_to_q)
    conv_q = matmul_reduce32(y, c.b_to_q, fold_matmul).long()
    conv_msk = matmul_reduce32(y, c.b_to_msk, fold_matmul)[0].long()
    msk = c.m_sk
    alpha = (conv_msk - x_bsk[k_b].long()) % msk * c.b_inv_mod_msk % msk
    q = _col(c.b_to_q.obase.q, conv_q)
    b_mod = _col(c.b_mod_q, conv_q)
    out = torch.where((alpha > c.msk_half).unsqueeze(0),
                      conv_q + (msk - alpha).unsqueeze(0) * b_mod % q,
                      conv_q - alpha.unsqueeze(0) * b_mod % q)
    return (out % q).int()

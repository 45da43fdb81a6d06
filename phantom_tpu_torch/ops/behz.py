"""BEHZ's RNS machinery for BFV over u64 primes (counterpart of
phantom_tpu/ops/behz.py, which the JAX package runs as XLA fusions, no
pallas_call): the auxiliary base Bsk = B u {m_sk} (61-bit primes), the
redundant modulus m_tilde = 2^32, the small Montgomery reduction SmMRq,
the divide-and-floor by Q in Bsk and the Shenoy-Kumaresan conversion
back to Q.

Every conversion is U2's approximate form (ops/bconv.py), to Bsk, to
{2^32}, to Ql and to {m_sk}.  Every product by a constant is U4's Shoup
form (ops/polyops.py), whose canonical result equals the JAX package's
Barrett and Shoup products: by m_tilde over Ql, by m_tilde^-1 and Q^-1
over Bsk, by B^-1 mod m_sk, and the row forms that lift a (1, N) row to
every prime of a base (r mod bsk_j, alpha B mod q_i).  What stays plain
torch is the centered choice between two representatives (where r or
alpha is past half its modulus) and r mod 2^32, the low word of an int64
product.  Bit-equal to the JAX package's functions on the same inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import host
from . import bconv as bc
from . import modmath as mm
from . import polyops as po
from .rns_host import ModulusVec, i64_tensor, modulus_vec

M_TILDE = 1 << 32


class BEHZConsts(NamedTuple):
    """One level's BEHZ tables (the JAX package's BEHZConsts): the
    conversions Ql -> Bsk, Ql -> {m_tilde}, B -> Ql, B -> {m_sk}; the Bsk
    base and its table rows; U4's tables `mtilde_q` (w = m_tilde mod q_i,
    over Ql), `one_bsk` (w = 1), `mtilde_inv` (w = m_tilde^-1),
    `q_mtilde_inv` (w = Q m_tilde^-1) and `q_inv` (w = Q^-1, over Bsk),
    `b_inv_msk` (w = B^-1, over {m_sk}) and `b_mod_q` (w = B mod q_i, over
    Ql); [-Q^-1]_{m_tilde} and m_tilde mod bsk_j; floor(m_sk / 2); and the
    inverse NTT's scales t N^-1 over Ql and over Bsk with their Shoup
    words (the product by t folded into the transform)."""

    q_to_bsk: bc.BaseConvConsts
    q_to_mtilde: bc.BaseConvConsts
    b_to_q: bc.BaseConvConsts
    b_to_msk: bc.BaseConvConsts
    bsk: ModulusVec
    rows_bsk: torch.Tensor
    mtilde_q: po.Limbs
    one_bsk: po.Limbs
    mtilde_inv: po.Limbs
    q_mtilde_inv: po.Limbs
    q_inv: po.Limbs
    b_inv_msk: po.Limbs
    b_mod_q: po.Limbs
    neg_q_inv_mod_mtilde: int
    mtilde_mod_bsk: torch.Tensor
    msk_half: int
    t_scale_q: torch.Tensor
    t_scale_q_shoup: torch.Tensor
    t_scale_bsk: torch.Tensor
    t_scale_bsk_shoup: torch.Tensor


def make_behz_consts(data_moduli: Sequence[int], bsk_moduli: Sequence[int],
                     t: int, n: int, rows_bsk: Sequence[int],
                     device=None) -> BEHZConsts:
    """bsk_moduli: B's primes, then m_sk; rows_bsk: their rows in the
    context's NTT tables."""
    inv = host.numth.invert_mod
    data_moduli = [int(q) for q in data_moduli]
    bsk_moduli = [int(m) for m in bsk_moduli]
    q_base = host.RNSBase(data_moduli)
    b_base = host.RNSBase(bsk_moduli[:-1])
    bsk_base = host.RNSBase(bsk_moduli)
    m_sk = bsk_moduli[-1]
    big_q, big_b = q_base.prod, b_base.prod
    mtinv = [inv(M_TILDE % m, m) for m in bsk_moduli]

    def conv(ib, ob):
        return bc.consts_from_host(host.BaseConverter(ib, ob), device)

    def table(moduli, w):
        return po.limbs(moduli, w=w, device=device)

    def scale(moduli):
        s = [inv(n, m) * t % m for m in moduli]
        return (i64_tensor(s, device), i64_tensor(
            [host.compute_shoup(v, m) for v, m in zip(s, moduli)], device))

    t_q, t_q_shoup = scale(data_moduli)
    t_bsk, t_bsk_shoup = scale(bsk_moduli)
    return BEHZConsts(
        q_to_bsk=conv(q_base, bsk_base),
        q_to_mtilde=conv(q_base, host.RNSBase([M_TILDE])),
        b_to_q=conv(b_base, q_base),
        b_to_msk=conv(b_base, host.RNSBase([m_sk])),
        bsk=modulus_vec(bsk_moduli, device),
        rows_bsk=torch.tensor(list(rows_bsk), dtype=torch.int32,
                              device=device),
        mtilde_q=table(data_moduli, [M_TILDE % q for q in data_moduli]),
        one_bsk=table(bsk_moduli, None),
        mtilde_inv=table(bsk_moduli, mtinv),
        q_mtilde_inv=table(bsk_moduli, [big_q * v % m for v, m in zip(
            mtinv, bsk_moduli)]),
        q_inv=table(bsk_moduli, [inv(big_q % m, m) for m in bsk_moduli]),
        b_inv_msk=table([m_sk], [inv(big_b % m_sk, m_sk)]),
        b_mod_q=table(data_moduli, [big_b % q for q in data_moduli]),
        neg_q_inv_mod_mtilde=(M_TILDE - inv(big_q % M_TILDE, M_TILDE))
        % M_TILDE,
        mtilde_mod_bsk=i64_tensor([M_TILDE % m for m in bsk_moduli], device),
        msk_half=m_sk >> 1,
        t_scale_q=t_q, t_scale_q_shoup=t_q_shoup, t_scale_bsk=t_bsk,
        t_scale_bsk_shoup=t_bsk_shoup)


def sm_mrq(x_q: torch.Tensor, c: BEHZConsts, ops) -> torch.Tensor:
    """x (k, N) over Ql -> (k + 1, N) over Bsk: x + u Q, |u| small, by the
    small Montgomery reduction by m_tilde: x' = m_tilde x mod Ql (U4), x'
    converted to Bsk and to {m_tilde} (U2), r = [x'_mtilde (-Q^-1)]_{m_tilde}
    read centered (r - 2^32 where r > 2^31, for Bsk primes on either side
    of 2^32), then (conv + Q r) m_tilde^-1 mod Bsk as conv m_tilde^-1 + r
    (Q m_tilde^-1) (U4: r mod bsk_j by the row form, the two products)."""
    xp = ops.shoup_rns(x_q, c.mtilde_q)
    conv_bsk = bc.bconv_approx(xp, c.q_to_bsk, ops.bconv)
    conv_mt = bc.bconv_approx(xp, c.q_to_mtilde, ops.bconv)
    r = conv_mt * c.neg_q_inv_mod_mtilde & (M_TILDE - 1)
    bskq = c.bsk.q.view(-1, 1)
    r_red = ops.shoup_rns(r, c.one_bsk)
    r_eff = torch.where(r > M_TILDE >> 1,
                        mm.sub_mod(r_red, c.mtilde_mod_bsk.view(-1, 1), bskq),
                        r_red)
    return ops.shoup_rns(r_eff, c.q_mtilde_inv,
                         c=ops.shoup_rns(conv_bsk, c.mtilde_inv))


def fast_floor(x_q: torch.Tensor, x_bsk: torch.Tensor, c: BEHZConsts,
               ops) -> torch.Tensor:
    """floor(x / Q) in Bsk from x's residues over Ql and Bsk:
    (x_bsk - conv(x_q)) Q^-1, the conversion U2, the product U4's
    shoup_sub form."""
    conv = bc.bconv_approx(x_q, c.q_to_bsk, ops.bconv)
    return ops.shoup_rns(x_bsk, c.q_inv, conv)


def fastbconv_sk(x_bsk: torch.Tensor, c: BEHZConsts, ops) -> torch.Tensor:
    """Shenoy-Kumaresan's exact conversion Bsk -> Ql: the approximate
    conversions of the B rows to Ql and to {m_sk} (U2), alpha =
    [(conv_msk - x_msk) B^-1]_{m_sk} (U4) read centered, out = conv_q -
    alpha B mod q_i (U4's row form for |alpha| B, the sign in plain
    torch)."""
    k_b = c.b_to_q.ibase.q.shape[0]
    x_b = x_bsk[:k_b]
    conv_q = bc.bconv_approx(x_b, c.b_to_q, ops.bconv)
    conv_msk = bc.bconv_approx(x_b, c.b_to_msk, ops.bconv)
    msk = c.b_to_msk.obase.q
    alpha = ops.shoup_rns(mm.sub_mod(conv_msk, x_bsk[k_b:], msk),
                          c.b_inv_msk)
    neg = alpha > c.msk_half
    term = ops.shoup_rns(torch.where(neg, msk - alpha, alpha), c.b_mod_q)
    out_q = c.b_to_q.obase.q.view(-1, 1)
    return torch.where(neg, mm.add_mod(conv_q, term, out_q),
                       mm.sub_mod(conv_q, term, out_q))

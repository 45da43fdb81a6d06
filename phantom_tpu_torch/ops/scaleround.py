"""BFV's exact scale-and-round over u64 primes (counterpart of
phantom_tpu/ops/scaleround.py, which the JAX package runs as XLA
fusions, no pallas_call).

Every round(t x / Q) is exact fixed-point integer arithmetic, as in the
JAX package: with y_i = [x_i (Q/q_i)^-1]_{q_i} and the exact splits
t 2^64 = Lam_i q_i + rho_i (decryption) or G = omega_i d_i + rho_i (the
v-free scale-and-round, every output prime dividing G = num prod(I) /
den), the integer words sum over 128 bits and the remainders r_i / q_i
are refined one more 2^-64 level.

  make_decrypt_consts / decrypt_scale_and_round   round(t x / Ql) mod t
      (one call a decryption, (k, N) -> (N,); plain torch)
  make_plain_lift_consts / scale_plain_up   round(Ql m / t) mod q_i:
      Delta m by U4's row form (Delta mod q_i times the row m), plus
      round(r_t m / t) in plain torch
  make_exact_scale_round / scale_and_round_exact   round((num/den) x):
      U2's "scale_round" form (ops/bconv.py), one launch
  scale_and_round_hps_to_r / scale_and_round_hps   HPS's round(t x / Ql)
      from D = Ql u Rl, to Rl (U2) and on to Ql through the centered exact
      conversion Rl -> Ql (U2; the (Rl - 1)/2 shifts in plain torch)

Constants are int64 words on the caller's device, built from exact
Python integers.  Each function is bit-equal to the JAX package's on the
same inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import host
from . import bconv as bc
from . import modmath as mm
from . import polyops as po
from .rns_host import ModulusVec, i64_tensor, modulus_vec


class DecryptScaleRoundConsts(NamedTuple):
    """round(t x / Q) mod t over the base Q (the JAX package's
    DecryptScaleRoundConsts): QhatInv with its Shoup words, Lam_i =
    floor(t 2^64 / q_i), rho_i = t 2^64 mod q_i, t and floor(2^128 / t)
    >> 64."""

    base: ModulusVec
    qhat_inv: torch.Tensor
    qhat_inv_shoup: torch.Tensor
    lam: torch.Tensor
    rho: torch.Tensor
    t: int
    t_ratio_hi: int


def make_decrypt_consts(moduli: Sequence[int], t: int,
                        device=None) -> DecryptScaleRoundConsts:
    base = host.RNSBase(list(moduli))
    if len(base.moduli) * t >= 1 << 63:
        raise ValueError("k t must fit in 63 bits for exact rounding")
    lam = [(t << 64) // q for q in base.moduli]
    if any(v >= 1 << 64 for v in lam):
        raise ValueError("the plain modulus must be below every q_i")
    return DecryptScaleRoundConsts(
        base=modulus_vec(base.moduli, device),
        qhat_inv=i64_tensor(base.qhat_inv_mod_qi, device),
        qhat_inv_shoup=i64_tensor([host.compute_shoup(v, q) for v, q in zip(
            base.qhat_inv_mod_qi, base.moduli)], device),
        lam=i64_tensor(lam, device),
        rho=i64_tensor([(t << 64) - v * q for v, q in zip(lam, base.moduli)],
                       device),
        t=t, t_ratio_hi=((1 << 128) // t) >> 64)


def decrypt_scale_and_round(x: torch.Tensor,
                            c: DecryptScaleRoundConsts) -> torch.Tensor:
    """x: (k, N) residues of [c0 + c1 s]_Q -> (N,) plaintext in [0, t)."""
    q, rlo, rhi = c.base.col()
    y = mm.mul_mod_shoup(x, c.qhat_inv.view(-1, 1),
                         c.qhat_inv_shoup.view(-1, 1), q)
    a_hi, a_lo = mm.mul_wide(y, c.lam.view(-1, 1))
    ph, plv = mm.mul_wide(y, c.rho.view(-1, 1))
    g, r = mm.barrett_div_mod_u128(ph, plv, q, rlo, rhi)
    f2, _ = mm.barrett_div_mod_u128(r, torch.zeros_like(r), q, rlo, rhi)
    z = torch.zeros_like(y[0])
    s_hi, s_lo, e_hi, e_lo = z, z, z, z
    for i in range(x.shape[0]):
        s_hi, s_lo = mm.add_wide(s_hi, s_lo, a_hi[i], a_lo[i])
        s_lo, cr = mm.add_u64_carry(s_lo, g[i])
        s_hi = s_hi + cr
        e_lo, cr = mm.add_u64_carry(e_lo, f2[i])
        e_hi = e_hi + cr
    # m = floor((S 2^64 + E2 + 2^127) / 2^128) = S_hi + carry(S_lo + W_hi)
    _, c3 = mm.add_u64_carry(s_lo, e_hi + mm.SIGN)
    return mm.barrett_reduce_u64(s_hi + c3, c.t, c.t_ratio_hi)


class PlainLiftConsts(NamedTuple):
    """round(Q m / t) mod q_i = Delta m + round(r_t m / t), Q = Delta t +
    r_t (the JAX package's PlainLiftConsts): `delta`, U4's table over Q
    with w = Delta mod q_i; r_t, t, floor(t / 2) and floor(2^128 / t) in
    two words, as Python integers."""

    delta: po.Limbs
    q: torch.Tensor
    r_t: int
    t: int
    t_half: int
    t_ratio_lo: int
    t_ratio_hi: int


def make_plain_lift_consts(moduli: Sequence[int], t: int,
                           device=None) -> PlainLiftConsts:
    moduli = [int(q) for q in moduli]
    if t >= min(moduli):
        raise ValueError("require t < q_i (the fix term must be reduced)")
    big_q = 1
    for q in moduli:
        big_q *= q
    delta, ratio = big_q // t, (1 << 128) // t
    return PlainLiftConsts(
        delta=po.limbs(moduli, w=[delta % q for q in moduli], device=device),
        q=i64_tensor(moduli, device), r_t=big_q - delta * t, t=t,
        t_half=t // 2, t_ratio_lo=ratio & ((1 << 64) - 1),
        t_ratio_hi=ratio >> 64)


def scale_plain_up(m: torch.Tensor, c: PlainLiftConsts,
                   shoup=po.shoup_rns) -> torch.Tensor:
    """m: (N,) plaintext coefficients in [0, t) -> (k, N) round(Q m / t)
    mod q_i: Delta m mod q_i by `shoup` (U4's row form: the row m times
    each Delta mod q_i; canonical, as the JAX package's Shoup product is),
    plus fix = floor((r_t m + floor(t / 2)) / t) < t <= q_i."""
    m = m.long()
    h, lo = mm.mul_wide(m, c.r_t)
    lo2, cr = mm.add_u64_carry(lo, torch.full_like(lo, c.t_half))
    fix, _ = mm.barrett_div_mod_u128(h + cr, lo2, c.t, c.t_ratio_lo,
                                     c.t_ratio_hi)
    main = shoup(m.view(1, -1), c.delta)
    return mm.add_mod(main, fix.unsqueeze(0), c.q.view(-1, 1))


class ExactScaleRoundConsts(NamedTuple):
    """round((num / den) x) : ibase -> obase, v-free (the JAX package's
    ExactScaleRoundConsts): (I/d_i)^-1 mod d_i with its Shoup words,
    omega_i mod out_j (k_out, k_in), rho_i = G mod d_i, 2^64 mod out_j."""

    ibase: ModulusVec
    ihat_inv: torch.Tensor
    ihat_inv_shoup: torch.Tensor
    omega_mod_out: torch.Tensor
    rho: torch.Tensor
    obase: ModulusVec
    pow64_mod_out: torch.Tensor

    def kernel_words(self):
        """U2's "scale_round" words in BaseConvConsts.kernel_words' order:
        (I/d_i)^-1 in QhatInv's place, rho in V's, omega in the matrix's;
        the kernel reads no U and no Q mod p for this form."""
        return (self.ihat_inv, self.ihat_inv_shoup, None, self.rho,
                self.omega_mod_out, self.pow64_mod_out, None)


def make_exact_scale_round(in_moduli: Sequence[int], num: int, den: int,
                           out_moduli: Sequence[int],
                           device=None) -> ExactScaleRoundConsts:
    ibase = host.RNSBase(list(in_moduli))
    if ibase.prod % den:
        raise ValueError("den must divide prod(ibase)")
    g = num * (ibase.prod // den)
    out_moduli = [int(p) for p in out_moduli]
    if any(g % p for p in out_moduli):
        raise ValueError("output primes must divide num prod(I) / den")
    omega = [g // d for d in ibase.moduli]
    return ExactScaleRoundConsts(
        ibase=modulus_vec(ibase.moduli, device),
        ihat_inv=i64_tensor(ibase.qhat_inv_mod_qi, device),
        ihat_inv_shoup=i64_tensor([host.compute_shoup(v, d) for v, d in zip(
            ibase.qhat_inv_mod_qi, ibase.moduli)], device),
        omega_mod_out=i64_tensor([[w % p for w in omega]
                                  for p in out_moduli], device),
        rho=i64_tensor([g - w * d for w, d in zip(omega, ibase.moduli)],
                       device),
        obase=modulus_vec(out_moduli, device),
        pow64_mod_out=i64_tensor([(1 << 64) % p for p in out_moduli],
                                 device))


def scale_and_round_exact(x: torch.Tensor, c: ExactScaleRoundConsts,
                          op=bc.bconv) -> torch.Tensor:
    """x: (k_in, N) residues -> (k_out, N) residues of round((num/den) x):
    U2's "scale_round" form (`op`: bc.bconv, or bc.bconv_plain)."""
    return op(x, c, "scale_round")


class HPSConsts(NamedTuple):
    """The u64 tables of a level's HPS multiply (the JAX package's
    HPSMulConsts): the exact conversions Ql -> Rl and Rl -> Ql, the base D
    = Ql u Rl and its table rows, round(t/Ql .) D -> Rl, the (Rl - 1)/2
    shifts mod r_j and mod q_i, and HPSoverQ's round(Rl/Ql .) Ql -> Rl and
    round(t/Rl .) D -> Ql."""

    q_to_r: bc.BaseConvConsts
    r_to_q: bc.BaseConvConsts
    dbase: ModulusVec
    rows_d: torch.Tensor
    sr_to_r: ExactScaleRoundConsts
    rl_half_mod_r: torch.Tensor
    rl_half_mod_q: torch.Tensor
    sr_ql_to_rl: ExactScaleRoundConsts
    sr_final_overq: ExactScaleRoundConsts


def scale_and_round_hps_to_r(x_d: torch.Tensor, hps: HPSConsts,
                             op=bc.bconv) -> torch.Tensor:
    """round((t/Ql) x) : D -> Rl, exact (t Rl == 0 mod r_j)."""
    return scale_and_round_exact(x_d, hps.sr_to_r, op)


def scale_and_round_hps(x_d: torch.Tensor, hps: HPSConsts,
                        op=bc.bconv) -> torch.Tensor:
    """round((t/Ql) x) : D -> Ql: W to Rl, then read centered (|W| <
    Rl/2): W + (Rl - 1)/2 converted exactly to Ql, the shift taken off
    mod q_i."""
    w_r = scale_and_round_hps_to_r(x_d, hps, op)
    r_q = hps.sr_to_r.obase.q.view(-1, 1)
    shifted = mm.add_mod(w_r, hps.rl_half_mod_r.view(-1, 1), r_q)
    conv = bc.bconv_exact(shifted, hps.r_to_q, op)
    return mm.sub_mod(conv, hps.rl_half_mod_q.view(-1, 1),
                      hps.r_to_q.obase.q.view(-1, 1))

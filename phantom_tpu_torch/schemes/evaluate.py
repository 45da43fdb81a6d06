"""The u64 evaluator: CKKS, BFV and BGV verbs over primes up to 2^61
(counterpart of phantom_tpu/schemes/evaluate.py, the JAX package's
generic path, `bench.py --path u64`).

Each verb is a function of the context and the port's Ciphertexts, whose
data are u64 words stored as int64 tensors, (size, L, N), on the
context's device: add, sub, negate, add_many and the plain ops;
multiply, square, relinearize and multiply_and_relin; rescale_to_next,
mod_switch_to_next and mod_switch_to (BGV's divides by q_last keeping
the value mod t and tracks the correction factor; unequal factors are
balanced before an add); apply_galois, the rotations, complex_conjugate,
hoisting and hoisted_linear_combo.  The bookkeeping follows the JAX
package verb for verb, and so do the results, bit for bit.

The kernels: U1 (ops/ntt.py) takes every NTT, U2 (ops/bconv.py) every
base conversion, U3 (schemes/keyswitch.py) every key inner product and
U4 (ops/polyops.py) the tensor and plain products (the hoisted forms'
multiply-adds as its fma), the moddown's (x - delta) P^-1 with the
ciphertext's addend, the rescale's rounding correction and (x - delta)
q_last^-1, BGV's modulus-switch delta and the balanced add's scaling;
the other additions and subtractions stay plain torch.  Every verb takes `ops`, the kernels
it calls (keyswitch.KERNELS64, or PLAIN64 for the plain versions).

BFV's ciphertexts are in coefficient form.  Its multiply follows the
context's mul_tech, as the JAX package's does:
  hps        lift both operands Ql -> D = Ql u Rl (U2 exact), NTT over D
             (U1), the tensor product over D (U4), inverse NTT, then
             round(t/Ql .) D -> Rl (U2's scale_round form) and the centered
             exact conversion Rl -> Ql (U2);
  behz       SmMRq's lift to Bsk (U4, U2 to Bsk and to {2^32}), NTT over Ql
             and Bsk, the tensor products, inverse NTTs with t folded into
             their scale, the fast floor (U2, U4) and Shenoy-Kumaresan back
             to Ql (U2);
  hps_overq  ct2 scaled to round(Rl x2 / Ql) over Rl and converted to Ql
             (U2), ct1 lifted to D, the product over D, round(t/Rl .) D ->
             Ql (U2);
  hps_overq_leveled  the same at the level the noise model
             (host/noise.find_levels_to_drop) drops to: the operands scaled
             Q -> Ql and Q -> Rl (U2), the result lifted back to Q
             (`_expand_ql_to_q`, U2).
The sums of a conversion or scale-and-round take at most 63 rows, as the
JAX package's (ops/bconv.MAX_ROWS): a multiply whose base D = Ql u Rl
passes 63 raises ValueError before it starts.  Relinearization, the
rotations and hoisting key-switch the coefficient form and come back by
U1's inverse; mod_switch_to_next divides by q_last with rounding (U4's
rescale_delta and Shoup forms, no NTT); the plain ops lift the message
by round(Ql m / t) (ops/scaleround.scale_plain_up) or, for the product,
centered in NTT form.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..fast32 import _balance_factors
from ..host.noise import find_levels_to_drop
from ..ops import bconv as bc
from ..ops import behz as bz
from ..ops import modmath as mm
from ..ops import polyops as po
from ..ops import scaleround as sr
from . import galois as gal
from .ciphertext import Ciphertext, Plaintext
from .context import Context, ContextData
from .keyswitch import (KERNELS64, Kernels64, evk_rows, inner_product_evk,
                        keyswitch, keyswitch_from_ntt, moddown_pair, modup,
                        modup_from_ntt)


def _cd(ctx: Context, ct, what: str = "the u64 evaluator") -> ContextData:
    ctx.require_u64(what)
    return ctx.get_context_data(ct.chain_index)


def _bfv(ctx: Context) -> bool:
    return ctx.params.scheme == "bfv"


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(-1, 1)


def _tool(ctx: Context) -> gal.GaloisTool:
    tool = getattr(ctx, "_galois_tool", None)
    if tool is None:
        tool = ctx._galois_tool = gal.GaloisTool(ctx.params.n)
    return tool


def _check_compatible(ct1: Ciphertext, ct2: Ciphertext,
                      check_scale: bool = True) -> None:
    if ct1.chain_index != ct2.chain_index:
        raise ValueError("ciphertexts are at different levels")
    if ct1.is_ntt_form != ct2.is_ntt_form:
        raise ValueError("NTT form mismatch")
    if check_scale and abs(ct1.scale - ct2.scale) > 1e-6 * ct1.scale:
        raise ValueError("scale mismatch")


def _rows(ctx: Context, k: int) -> torch.Tensor:
    return ctx.rows_qp[:k]


# ---------------------------------------------------------------------------
# linear ops
# ---------------------------------------------------------------------------

def negate(ctx: Context, ct: Ciphertext) -> Ciphertext:
    cd = _cd(ctx, ct, "negate")
    return ct.replace(data=po.neg_rns(ct.data, cd.u64.mv))


def _pad_to(data: torch.Tensor, size: int) -> torch.Tensor:
    if data.shape[0] == size:
        return data
    return torch.cat([data, data.new_zeros((size - data.shape[0],)
                                           + tuple(data.shape[1:]))])


def _balance_correction(ctx: Context, ct1: Ciphertext, ct2: Ciphertext,
                        ops: Kernels64):
    """Scale both BGV operands to a common correction factor, each by the
    centered representative of its multiplier: U4's Shoup form with w_l =
    that representative mod q_l."""
    t = ctx.params.plain_modulus
    f, m1, m2 = _balance_factors(ct1.correction_factor,
                                 ct2.correction_factor, t)
    cd = ctx.get_context_data(ct1.chain_index)
    mv = cd.u64.mv

    def scale_ct(ct, m):
        if m == 1:
            return ct.replace(correction_factor=f)
        centered = m - t if m > t // 2 else m
        lw = po.limbs(cd.moduli, w=[centered % q for q in cd.moduli],
                      device=mv.q.device)
        return ct.replace(data=ops.shoup_rns(ct.data, lw),
                          correction_factor=f)

    return scale_ct(ct1, m1), scale_ct(ct2, m2)


def _add_sub(ctx: Context, ct1: Ciphertext, ct2: Ciphertext, fn, what: str,
             ops: Kernels64):
    _check_compatible(ct1, ct2)
    cd = _cd(ctx, ct1, what)
    if (ctx.params.scheme == "bgv"
            and ct1.correction_factor != ct2.correction_factor):
        ct1, ct2 = _balance_correction(ctx, ct1, ct2, ops)
    size = max(ct1.size, ct2.size)
    return ct1.replace(data=fn(_pad_to(ct1.data, size),
                               _pad_to(ct2.data, size), cd.u64.mv))


def add(ctx: Context, ct1: Ciphertext, ct2: Ciphertext,
        ops: Kernels64 = KERNELS64) -> Ciphertext:
    """ct1 + ct2; BGV operands with unequal correction factors are
    balanced first (U4)."""
    return _add_sub(ctx, ct1, ct2, po.add_rns, "add", ops)


def sub(ctx: Context, ct1: Ciphertext, ct2: Ciphertext,
        ops: Kernels64 = KERNELS64) -> Ciphertext:
    return _add_sub(ctx, ct1, ct2, po.sub_rns, "sub", ops)


def add_many(ctx: Context, cts, ops: Kernels64 = KERNELS64) -> Ciphertext:
    cts = list(cts)
    if not cts:
        raise ValueError("add_many needs at least one ciphertext")
    acc = cts[0]
    for ct in cts[1:]:
        acc = add(ctx, acc, ct, ops)
    return acc


# ---------------------------------------------------------------------------
# multiplication and relinearization
# ---------------------------------------------------------------------------

def _tensor(a: torch.Tensor, b: torch.Tensor, mv, ops: Kernels64):
    if a.shape[0] == 2 and b.shape[0] == 2:
        return ops.tensor_prod_2x2(a, b, mv)
    return ops.tensor_prod_mxn(a, b, mv)


def multiply(ctx: Context, ct1: Ciphertext, ct2: Ciphertext,
             ops: Kernels64 = KERNELS64) -> Ciphertext:
    """The tensor product (U4); BFV's multiply by the context's mul_tech
    (a size m + n - 1 ciphertext at the same level)."""
    _check_compatible(ct1, ct2, check_scale=False)
    cd = _cd(ctx, ct1, "multiply")
    if _bfv(ctx):
        return _bfv_multiply(ctx, ct1, ct2, ops)
    prod = _tensor(ct1.data, ct2.data, cd.u64.mv, ops)
    if ctx.params.scheme == "ckks":
        return ct1.replace(data=prod, scale=ct1.scale * ct2.scale)
    t = ctx.params.plain_modulus
    return ct1.replace(data=prod, correction_factor=(
        ct1.correction_factor * ct2.correction_factor) % t)


def square(ctx: Context, ct: Ciphertext,
           ops: Kernels64 = KERNELS64) -> Ciphertext:
    cd = _cd(ctx, ct, "square")
    if _bfv(ctx):
        return _bfv_multiply(ctx, ct, ct, ops)
    if ct.size != 2:
        return multiply(ctx, ct, ct, ops)
    prod = ops.tensor_square_2x2(ct.data, cd.u64.mv)
    if ctx.params.scheme == "ckks":
        return ct.replace(data=prod, scale=ct.scale * ct.scale)
    t = ctx.params.plain_modulus
    return ct.replace(data=prod,
                      correction_factor=ct.correction_factor ** 2 % t)


def _keyswitch_coeff(ctx: Context, cd: ContextData, c2: torch.Tensor,
                     evk: torch.Tensor, ops: Kernels64) -> torch.Tensor:
    """The key switch of a coefficient-form c2 (size_ql, N), back in
    coefficient form (2, size_ql, N): keyswitch, then U1's inverse."""
    return ops.ntt_inverse(keyswitch(ctx, cd, c2, evk, ops), ctx.ntt64,
                           _rows(ctx, cd.size_ql))


def relinearize(ctx: Context, ct: Ciphertext, rlk: torch.Tensor,
                ops: Kernels64 = KERNELS64) -> Ciphertext:
    """A size-3 ciphertext -> size 2, by the relin key (dnum, 2, K, N)."""
    if ct.size != 3:
        raise ValueError("relinearize expects a size-3 ciphertext")
    cd = _cd(ctx, ct, "relinearize")
    if not ct.is_ntt_form:
        switched = _keyswitch_coeff(ctx, cd, ct.data[2], rlk, ops)
        return ct.replace(data=po.add_rns(ct.data[:2], switched, cd.u64.mv))
    return ct.replace(data=keyswitch_from_ntt(ctx, cd, ct.data[2], rlk, ops,
                                              (ct.data[0], ct.data[1])))


def multiply_and_relin(ctx: Context, ct1: Ciphertext, ct2: Ciphertext,
                       rlk: torch.Tensor,
                       ops: Kernels64 = KERNELS64) -> Ciphertext:
    return relinearize(ctx, multiply(ctx, ct1, ct2, ops), rlk, ops)


# ---------------------------------------------------------------------------
# BFV multiplication
# ---------------------------------------------------------------------------

def _bfv_multiply(ctx: Context, ct1: Ciphertext, ct2: Ciphertext,
                  ops: Kernels64) -> Ciphertext:
    mt = ctx.params.mul_tech
    if mt == "behz":
        return bfv_multiply_behz(ctx, ct1, ct2, ops)
    if mt in ("hps_overq", "hps_overq_leveled"):
        return bfv_multiply_hps_overq(ctx, ct1, ct2, ops)
    return bfv_multiply_hps(ctx, ct1, ct2, ops)


def _lift_d(x: torch.Tensor, hps: sr.HPSConsts, ops: Kernels64):
    """(size, k, N) over Ql -> (size, 2k + 1, N) over D = Ql u Rl: each
    poly's rows, then its exact conversion to Rl (U2)."""
    k = x.shape[1]
    out = x.new_empty((x.shape[0], hps.dbase.q.shape[0], x.shape[-1]))
    out[:, :k] = x
    for i in range(x.shape[0]):
        out[i, k:] = bc.bconv_exact(x[i], hps.q_to_r, ops.bconv)
    return out


def _product_d(ctx: Context, hps: sr.HPSConsts, a: torch.Tensor,
               b: Optional[torch.Tensor], ops: Kernels64) -> torch.Tensor:
    """The product over D in coefficient form: both operands forward
    (U1), the tensor product (U4; a's square where b is None), the
    inverse (U1)."""
    t, rows = ctx.ntt64, hps.rows_d
    a = ops.ntt_forward(a, t, rows)
    if b is None:
        prod = (ops.tensor_square_2x2(a, hps.dbase) if a.shape[0] == 2
                else ops.tensor_prod_mxn(a, a, hps.dbase))
    else:
        prod = _tensor(a, ops.ntt_forward(b, t, rows), hps.dbase, ops)
    return ops.ntt_inverse(prod, t, rows)


def bfv_multiply_hps(ctx: Context, ct1: Ciphertext, ct2: Ciphertext,
                     ops: Kernels64 = KERNELS64) -> Ciphertext:
    """BFV multiply, HPS: both operands lifted Ql -> D exactly, the
    product over D, then round(t/Ql .) back to Ql exactly (the JAX
    package's bfv_multiply_hps, and bfv_square_hps where ct2 is ct1)."""
    cd = ctx.get_context_data(ct1.chain_index)
    bc.check_rows(2 * cd.size_ql + 1, "BFV multiply (hps) over Ql u Rl")
    hps = cd.u64.hps
    a = _lift_d(ct1.data, hps, ops)
    prod = _product_d(ctx, hps, a,
                      None if ct2 is ct1 else _lift_d(ct2.data, hps, ops),
                      ops)
    return ct1.replace(data=torch.stack([
        sr.scale_and_round_hps(x, hps, ops.bconv) for x in prod]))


def bfv_multiply_behz(ctx: Context, ct1: Ciphertext, ct2: Ciphertext,
                      ops: Kernels64 = KERNELS64) -> Ciphertext:
    """BFV multiply, BEHZ: each operand over Ql and, by SmMRq, over Bsk;
    the products over Ql and over Bsk; t folded into the inverse NTTs'
    scale (canonical, as the JAX package's product by t after them); the
    fast floor by Ql in Bsk and Shenoy-Kumaresan back to Ql."""
    cd = ctx.get_context_data(ct1.chain_index)
    k = cd.size_ql
    bc.check_rows(k, "BFV multiply (behz) from Ql")
    c = cd.u64.behz
    t, rows_q = ctx.ntt64, _rows(ctx, k)

    def lift(ct):
        x_bsk = torch.stack([bz.sm_mrq(x, c, ops) for x in ct.data])
        return (ops.ntt_forward(ct.data, t, rows_q),
                ops.ntt_forward(x_bsk, t, c.rows_bsk))

    a_q, a_bsk = lift(ct1)
    b_q, b_bsk = (a_q, a_bsk) if ct2 is ct1 else lift(ct2)
    prod_q = ops.ntt_inverse(_tensor(a_q, b_q, cd.u64.mv, ops), t, rows_q,
                             c.t_scale_q, c.t_scale_q_shoup)
    prod_bsk = ops.ntt_inverse(_tensor(a_bsk, b_bsk, c.bsk, ops), t,
                               c.rows_bsk, c.t_scale_bsk,
                               c.t_scale_bsk_shoup)
    return ct1.replace(data=torch.stack([
        bz.fastbconv_sk(bz.fast_floor(xq, xb, c, ops), c, ops)
        for xq, xb in zip(prod_q, prod_bsk)]))


def bfv_multiply_hps_overq(ctx: Context, ct1: Ciphertext, ct2: Ciphertext,
                           ops: Kernels64 = KERNELS64) -> Ciphertext:
    """BFV multiply, HPSoverQ and its leveled form: ct2 scaled to
    round(Rl x2 / Ql) over Rl (U2's scale_round) and converted exactly to
    Ql, ct1 lifted to D, the product over D, round(t/Rl .) D -> Ql.  The
    leveled form first drops the levels the noise model allows (the JAX
    package's find_levels_to_drop): ct1 scaled Q -> Ql, ct2 Q -> Rl, the
    result lifted back to Q.  noise_scale_deg grows by one."""
    p = ctx.params
    nsd = max(ct1.noise_scale_deg, ct2.noise_scale_deg)
    lvl = 0
    if p.mul_tech == "hps_overq_leveled":
        beta = len(ctx.get_context_data(ct1.chain_index).ks.digit_convs)
        lvl = find_levels_to_drop(
            p.n, p.size_q, p.size_p, beta, p.plain_modulus,
            max(q.bit_length() for q in p.data_moduli), nsd - 1, False, True)
    cd = ctx.get_context_data(ct1.chain_index + lvl)
    k_l = cd.size_ql
    bc.check_rows(max(2 * k_l + 1, ct2.coeff_modulus_size),
                  f"BFV multiply ({p.mul_tech}) over Ql u Rl")
    lv = cd.u64
    hps = lv.hps
    x = ct1.data
    if lvl:
        x = torch.stack([sr.scale_and_round_exact(v, lv.leveled.q_to_ql,
                                                  ops.bconv) for v in x])
    a = _lift_d(x, hps, ops)
    to_rl = lv.leveled.q_to_rl if lvl else hps.sr_ql_to_rl
    b = a.new_empty((ct2.size,) + a.shape[1:])
    for i in range(ct2.size):
        w_rl = sr.scale_and_round_exact(ct2.data[i], to_rl, ops.bconv)
        b[i, :k_l] = bc.bconv_exact(w_rl, hps.r_to_q, ops.bconv)
        b[i, k_l:] = w_rl
    prod = _product_d(ctx, hps, a, b, ops)
    out = [sr.scale_and_round_exact(v, hps.sr_final_overq, ops.bconv)
           for v in prod]
    if lvl:
        out = [_expand_ql_to_q(cd, w, ops) for w in out]
    return ct1.replace(data=torch.stack(out), noise_scale_deg=nsd + 1)


def _expand_ql_to_q(cd: ContextData, w: torch.Tensor,
                    ops: Kernels64) -> torch.Tensor:
    """The centered exact lift Ql -> the full Q: Ql's rows, then w +
    (Ql - 1)/2 converted exactly to the dropped primes (U2), less the
    shift."""
    lc = cd.u64.leveled
    shifted = mm.add_mod(w, _col(lc.qlhalf_mod_ql), _col(cd.u64.mv.q))
    drop = bc.bconv_exact(shifted, lc.ql_to_drop, ops.bconv)
    drop = mm.sub_mod(drop, _col(lc.qlhalf_mod_drop),
                      _col(lc.ql_to_drop.obase.q))
    return torch.cat([w, drop])


# ---------------------------------------------------------------------------
# plaintext ops
# ---------------------------------------------------------------------------

def _bgv_plain(ctx: Context, cd: ContextData, ct: Ciphertext,
               pt: Plaintext, ops: Kernels64) -> torch.Tensor:
    """BGV's plaintext m (times the correction factor) lifted to NTT form
    over Ql."""
    from .keys import lift_plain_ntt64
    t = ctx.params.plain_modulus
    m = pt.data[0]
    f = ct.correction_factor % t
    if f != 1:
        m = m * f % t
    return lift_plain_ntt64(ctx, cd, m, ops)


def _plain_c0(ctx: Context, ct: Ciphertext, pt: Plaintext, fn,
              ops: Kernels64, what: str) -> Ciphertext:
    """c0 (+/-) the plaintext: CKKS's NTT residues, BFV's round(Ql m / t)
    (ops/scaleround.scale_plain_up), BGV's centered lift."""
    cd = _cd(ctx, ct, what)
    scheme = ctx.params.scheme
    if scheme == "ckks":
        plain = pt.data
    elif scheme == "bfv":
        plain = sr.scale_plain_up(pt.data[0], cd.u64.plain_lift,
                                  ops.shoup_rns)
    else:
        plain = _bgv_plain(ctx, cd, ct, pt, ops)
    c0 = fn(ct.data[0], plain, cd.u64.mv)
    return ct.replace(data=torch.cat([c0.unsqueeze(0), ct.data[1:]]))


def add_plain(ctx: Context, ct: Ciphertext, pt: Plaintext,
              ops: Kernels64 = KERNELS64) -> Ciphertext:
    return _plain_c0(ctx, ct, pt, po.add_rns, ops, "add_plain")


def sub_plain(ctx: Context, ct: Ciphertext, pt: Plaintext,
              ops: Kernels64 = KERNELS64) -> Ciphertext:
    return _plain_c0(ctx, ct, pt, po.sub_rns, ops, "sub_plain")


def multiply_plain(ctx: Context, ct: Ciphertext, pt: Plaintext,
                   ops: Kernels64 = KERNELS64) -> Ciphertext:
    """ct * pt (U4): CKKS's scale multiplies; BGV's plaintext enters
    without the correction factor, as in the JAX package; BFV's product is
    taken in NTT form (the ciphertext forward and back, U1) with m
    centered mod t."""
    from .keys import lift_plain_ntt64
    cd = _cd(ctx, ct, "multiply_plain")
    mv = cd.u64.mv
    if ctx.params.scheme == "ckks":
        return ct.replace(data=ops.mul_rns(ct.data, pt.data, mv),
                          scale=ct.scale * pt.scale)
    m_ntt = lift_plain_ntt64(ctx, cd, pt.data[0], ops)
    if ctx.params.scheme == "bgv":
        return ct.replace(data=ops.mul_rns(ct.data, m_ntt, mv))
    rows = _rows(ctx, cd.size_ql)
    prod = ops.mul_rns(ops.ntt_forward(ct.data, ctx.ntt64, rows), m_ntt, mv)
    return ct.replace(data=ops.ntt_inverse(prod, ctx.ntt64, rows))


# ---------------------------------------------------------------------------
# rescale and modulus switching
# ---------------------------------------------------------------------------

def _divide_round_qlast_ntt(ctx: Context, cd: ContextData, x: torch.Tensor,
                            ops: Kernels64) -> torch.Tensor:
    """round(x / q_last) over the remaining limbs, NTT form in and out:
    U1 inverse of the last limb, U4's rounding correction for every limb,
    U1 forward, U4's (x - delta) q_last^-1 (x's limbs read in place)."""
    lw = cd.u64.rescale
    k = cd.size_ql
    xl = ops.ntt_inverse(x[..., k - 1:k, :], ctx.ntt64,
                         ctx.rows_qp[k - 1:k])
    delta_ntt = ops.ntt_forward(ops.rescale_delta(xl, lw), ctx.ntt64,
                                _rows(ctx, k - 1))
    return ops.shoup_rns(x[..., :k - 1, :], lw, delta_ntt)


def rescale_to_next(ctx: Context, ct: Ciphertext,
                    ops: Kernels64 = KERNELS64) -> Ciphertext:
    """CKKS: divide by q_last with rounding; the scale divides by it."""
    if ctx.params.scheme != "ckks":
        raise ValueError("rescale is CKKS-only; use mod_switch for BFV/BGV")
    cd = _cd(ctx, ct, "rescale_to_next")
    if cd.size_ql < 2:
        raise ValueError("cannot rescale: last level")
    qlast = ctx.params.data_moduli[cd.size_ql - 1]
    return ct.replace(data=_divide_round_qlast_ntt(ctx, cd, ct.data, ops),
                      chain_index=ct.chain_index + 1,
                      scale=ct.scale / qlast)


def _bgv_mod_switch(ctx: Context, cd: ContextData, ct: Ciphertext,
                    ops: Kernels64):
    """Subtract delta == c (mod q_last), == 0 (mod t), divide exactly by
    q_last; the plaintext picks up q_last^-1 mod t (the correction
    factor).  U1 inverse of the last limb, U4's delta c_last + u q_last
    with u = [-c_last q_last^-1]_t, U1 forward, U4's (x - delta)
    q_last^-1."""
    lv = cd.u64
    k = cd.size_ql
    x = ct.data
    c_last = ops.ntt_inverse(x[..., k - 1:k, :], ctx.ntt64,
                             ctx.rows_qp[k - 1:k])
    delta = ops.modswitch_delta(c_last, lv.bgv.modswitch)
    delta_ntt = ops.ntt_forward(delta, ctx.ntt64, _rows(ctx, k - 1))
    out = ops.shoup_rns(x[..., :k - 1, :], lv.rescale, delta_ntt)
    t_int = ctx.params.plain_modulus
    qlast = ctx.params.data_moduli[k - 1]
    return out, ct.correction_factor * pow(qlast % t_int, -1, t_int) % t_int


def _divide_round_qlast_coeff(cd: ContextData, x: torch.Tensor,
                              ops: Kernels64) -> torch.Tensor:
    """round(x / q_last) over the remaining limbs, coefficient form: U4's
    rounding correction of the last limb for every limb, then U4's (x -
    delta) q_last^-1 (x's limbs read in place)."""
    lw = cd.u64.rescale
    k = cd.size_ql
    delta = ops.rescale_delta(x[..., k - 1:k, :], lw)
    return ops.shoup_rns(x[..., :k - 1, :], lw, delta)


def mod_switch_to_next(ctx: Context, ct: Ciphertext,
                       ops: Kernels64 = KERNELS64) -> Ciphertext:
    """Drop the last prime: CKKS drops the limb (scale unchanged), BFV
    divides by q_last with rounding, BGV divides by q_last keeping the
    value mod t."""
    cd = _cd(ctx, ct, "mod_switch_to_next")
    if cd.size_ql < 2:
        raise ValueError("cannot mod-switch: last level")
    if ctx.params.scheme == "ckks":  # contiguous: the kernels' operands
        return ct.replace(data=ct.data[..., :cd.size_ql - 1, :].contiguous(),
                          chain_index=ct.chain_index + 1)
    if ctx.params.scheme == "bfv":
        return ct.replace(data=_divide_round_qlast_coeff(cd, ct.data, ops),
                          chain_index=ct.chain_index + 1)
    out, f = _bgv_mod_switch(ctx, cd, ct, ops)
    return ct.replace(data=out, chain_index=ct.chain_index + 1,
                      correction_factor=f)


def mod_switch_to(ctx: Context, ct: Ciphertext, chain_index: int,
                  ops: Kernels64 = KERNELS64) -> Ciphertext:
    while ct.chain_index < chain_index:
        ct = mod_switch_to_next(ctx, ct, ops)
    return ct


def mod_switch_plain_to_next(ctx: Context, pt: Plaintext) -> Plaintext:
    """Drop the last prime of an NTT-form (CKKS) plaintext."""
    cd = ctx.get_context_data(pt.chain_index)
    if cd.size_ql < 2:
        raise ValueError("cannot mod-switch plaintext: last level")
    return pt.replace(data=pt.data[..., :cd.size_ql - 1, :].contiguous(),
                      chain_index=pt.chain_index + 1)


def mod_switch_plain_to(ctx: Context, pt: Plaintext,
                        chain_index: int) -> Plaintext:
    while pt.chain_index < chain_index:
        pt = mod_switch_plain_to_next(ctx, pt)
    return pt


# ---------------------------------------------------------------------------
# Galois automorphisms and rotations
# ---------------------------------------------------------------------------

def _key_index(glk, elt: int) -> int:
    if elt not in glk.elts:
        raise ValueError(f"no galois key for element {elt}")
    return glk.elts.index(elt)


def apply_galois(ctx: Context, ct: Ciphertext, elt: int, glk,
                 ops: Kernels64 = KERNELS64) -> Ciphertext:
    """sigma_elt, then the key switch of c1 back to s; glk:
    keys.GaloisKeys."""
    if ct.size != 2:
        raise ValueError("apply_galois requires a size-2 ciphertext "
                         "(relinearize first)")
    cd = _cd(ctx, ct, "apply_galois")
    kidx = _key_index(glk, elt)
    tool = _tool(ctx)
    if not ct.is_ntt_form:  # BFV: the key switch in coefficient form
        mv = cd.u64.mv
        c0p = tool.apply_coeff(ct.data[0], elt, mv.q)
        c1p = tool.apply_coeff(ct.data[1], elt, mv.q)
        sw = _keyswitch_coeff(ctx, cd, c1p, glk.data[kidx], ops)
        return ct.replace(data=torch.stack([po.add_rns(c0p, sw[0], mv),
                                            sw[1]]))
    c0p = tool.apply_ntt(ct.data[0], elt)
    c1p = tool.apply_ntt(ct.data[1], elt)
    return ct.replace(data=keyswitch_from_ntt(ctx, cd, c1p, glk.data[kidx],
                                              ops, (c0p, None)))


def _naf(value: int):
    """Non-adjacent form: the signed powers of two summing to value."""
    out = []
    while value:
        zs = value & 3
        if zs == 1:
            out.append(1)
            value -= 1
        elif zs == 3:
            out.append(-1)
            value += 1
        else:
            out.append(0)
        value >>= 1
    return [d << i for i, d in enumerate(out) if d]


def rotate(ctx: Context, ct: Ciphertext, step: int, glk,
           ops: Kernels64 = KERNELS64) -> Ciphertext:
    """Rotate by `step`, by its NAF decomposition where its own element
    has no key."""
    n = ctx.params.n
    if step % (n // 2) == 0:
        return ct
    elt = gal.get_elt_from_step(step, n)
    if elt in glk.elts:
        return apply_galois(ctx, ct, elt, glk, ops)
    for part in _naf(step):
        e = gal.get_elt_from_step(part, n)
        if e not in glk.elts:
            raise ValueError(f"no galois key for step {part}")
        ct = apply_galois(ctx, ct, e, glk, ops)
    return ct


def rotate_rows(ctx: Context, ct: Ciphertext, step: int, glk,
                ops: Kernels64 = KERNELS64) -> Ciphertext:
    """BFV and BGV row rotation."""
    return rotate(ctx, ct, step, glk, ops)


def rotate_columns(ctx: Context, ct: Ciphertext, glk,
                   ops: Kernels64 = KERNELS64) -> Ciphertext:
    """BFV and BGV column swap: the element 2N - 1."""
    return apply_galois(ctx, ct, 2 * ctx.params.n - 1, glk, ops)


def rotate_vector(ctx: Context, ct: Ciphertext, step: int, glk,
                  ops: Kernels64 = KERNELS64) -> Ciphertext:
    """CKKS slot rotation."""
    return rotate(ctx, ct, step, glk, ops)


def complex_conjugate(ctx: Context, ct: Ciphertext, glk,
                      ops: Kernels64 = KERNELS64) -> Ciphertext:
    return apply_galois(ctx, ct, 2 * ctx.params.n - 1, glk, ops)


def hoisting(ctx: Context, ct: Ciphertext, glk, steps,
             ops: Kernels64 = KERNELS64) -> Ciphertext:
    """sum_s rotate(ct, s) with one modup and one moddown pair: per step
    the permuted c0 and the inner product of the shared modup read
    through the step's permutation (U3's perm).  A coefficient-form (BFV)
    ciphertext takes the modup of its c1 as it is and comes back by U1's
    inverse."""
    if ct.size != 2:
        raise ValueError("hoisting requires a size-2 ciphertext")
    cd = _cd(ctx, ct, "hoisting")
    lv = cd.u64
    tool = _tool(ctx)
    ntt = ct.is_ntt_form
    elts = [gal.get_elt_from_step(s, ctx.params.n) for s in steps]
    kidx = [_key_index(glk, e) for e in elts]
    t_modup = (modup_from_ntt if ntt else modup)(ctx, cd, ct.data[1], ops)
    qlp_q = _col(lv.ks.qlp.q)
    acc_c0 = acc_cx = None
    for elt, ki in zip(elts, kidx):
        c0p = (tool.apply_ntt(ct.data[0], elt) if ntt
               else tool.apply_coeff(ct.data[0], elt, lv.mv.q))
        prod = inner_product_evk(t_modup, evk_rows(ctx, glk.data[ki], cd),
                                 cd, ops, tool.ntt_perm(elt, ct.data.device))
        acc_c0 = c0p if acc_c0 is None else po.add_rns(acc_c0, c0p, lv.mv)
        acc_cx = prod if acc_cx is None else mm.add_mod(acc_cx, prod, qlp_q)
    if ntt:
        return ct.replace(data=moddown_pair(ctx, cd, acc_cx, ops,
                                            (acc_c0, None)))
    cx = ops.ntt_inverse(moddown_pair(ctx, cd, acc_cx, ops), ctx.ntt64,
                         _rows(ctx, cd.size_ql))
    return ct.replace(data=torch.stack([po.add_rns(acc_c0, cx[0], lv.mv),
                                        cx[1]]))


def hoisted_linear_combo(ctx: Context, ct: Ciphertext, glk, steps, pts_qlp,
                         pts_scale: float,
                         t_modup: Optional[torch.Tensor] = None,
                         ops: Kernels64 = KERNELS64) -> Ciphertext:
    """sum_s pt_s * rotate(ct, s) with one modup and one moddown: the
    weights (size_qlp, N) NTT form over QlP (ckks_encoder.encode_extended)
    multiply each step's key-switch product while it still lives over QlP;
    a step of 0 mod N/2 needs no key switch.  t_modup: a shared
    modup_from_ntt of c1."""
    if ctx.params.scheme != "ckks":
        raise ValueError("hoisted_linear_combo expects NTT-form CKKS input")
    if ct.size != 2:
        raise ValueError("requires a size-2 ciphertext")
    cd = _cd(ctx, ct, "hoisted_linear_combo")
    lv = cd.u64
    mv, qlp = lv.mv, lv.ks.qlp
    k = cd.size_ql
    n = ctx.params.n
    tool = _tool(ctx)
    c0, c1 = ct.data[0], ct.data[1]
    if t_modup is None:
        t_modup = modup_from_ntt(ctx, cd, c1, ops)
    acc_c0 = acc_c1 = acc_cx = None

    def mac(a, b, acc, mv):  # acc + a b, one U4 launch
        return ops.mul_rns(a, b, mv) if acc is None else ops.fma_rns(
            a, b, acc, mv)

    for s, pt in zip(steps, pts_qlp):
        if s % (n // 2) == 0:
            acc_c0 = mac(c0, pt[:k], acc_c0, mv)
            acc_c1 = mac(c1, pt[:k], acc_c1, mv)
            continue
        elt = gal.get_elt_from_step(s, n)
        if elt not in glk.elts:
            raise ValueError(f"no galois key for step {s}")
        ki = glk.elts.index(elt)
        prod = inner_product_evk(
            t_modup, evk_rows(ctx, glk.data[ki], cd), cd, ops,
            tool.ntt_perm(elt, c0.device))
        acc_cx = mac(prod, pt, acc_cx, qlp)
        acc_c0 = mac(tool.apply_ntt(c0, elt), pt[:k], acc_c0, mv)
    if acc_cx is None:
        data = torch.stack([acc_c0, acc_c1])
    else:
        data = moddown_pair(ctx, cd, acc_cx, ops, (acc_c0, acc_c1))
    return ct.replace(data=data, scale=ct.scale * pts_scale)

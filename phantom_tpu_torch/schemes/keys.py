"""Key generation, encryption and decryption (CKKS, BFV, BGV).

Counterpart of phantom_tpu/schemes/keys.py and of the u32 cores of
phantom_tpu/fast32.py:734-821.  Keys live in NTT form over the full key
base QP: the secret key (K, N), the public key (2, K, N), an encryption
of zero (-(a s + e), a); the relin key holds dnum digit keys, each an
encryption of zero with P * s^2 added on its own digit's rows, and a
Galois key the same with P * sigma_elt(s) in place of P * s^2.  BGV
multiplies every error by t (keys and encryptions).

Asymmetric encryption at chain index l draws u (ternary) and e0, e1
(CBD), forms (u pk_i + e_i) over QlP and moddowns it to Ql
(encrypt_zero_core32): in NTT form for CKKS and BGV (the moddown pair),
in coefficient form for BFV (moddown_coeff32).  The plaintext then enters
c0: CKKS as its NTT residues, BFV as round(Ql m / t) (its plain lift),
BGV as m centered mod t, in NTT form.  Symmetric encryption is
(-(a s + e) + m, a) at the first data level in the same forms.  BFV
decryption is round(t [c0 + c1 s]_Ql / Ql) mod t (ops/scaleround32.py
with num = t, den = Ql and the output base {t}); BGV's the exact centered
conversion of [c0 + c1 s]_Ql to {t}, divided by the ciphertext's
correction factor.  invariant_noise_budget gives a BFV ciphertext's
remaining noise budget in bits, by the CRT in Python integers.

Each `*_core32` takes its samples as tensors (ternary and CBD vectors
(N,), uniform residues (K, N)), so tests feed it the JAX package's own
draws; the other functions draw them from an explicit `torch.Generator`
(ops/sampling.py), on the generator's device.  Every function takes
`ops`, the kernels it calls (pipeline32.KERNELS or PLAIN).

The `*64` functions are the same on a wide context (the u64 evaluator,
every scheme): `*_core64` take the JAX draws, the others draw from a
generator; `ops` is keyswitch.KERNELS64 or PLAIN64.  BFV's u64
decryption is ops/scaleround.decrypt_scale_and_round, and
invariant_noise_budget64 its budget.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import bconv as bconv64
from ..ops import modmath as mm64
from ..ops import polyops as po64
from ..ops import sampling as smp
from ..ops import scaleround as sr64
from ..ops.bconv32 import BaseConvConsts32, bconv_exact32
from ..ops.modmath32 import mul_mod_shoup32, u32
from ..ops.ntt32 import u32_tensor
from ..ops.pipeline32 import (KERNELS, Kernels, KeySwitch32, _fwd, _inv,
                              build_keyswitch32, moddown32_pair,
                              moddown_coeff32)
from ..ops.rns_host import u64_values
from ..ops.scaleround32 import ExactScaleRound32, scale_and_round_exact32
from . import galois as gal
from .ciphertext import Ciphertext, Plaintext
from .context import Context
from .keyswitch import KERNELS64, Kernels64


def _qcol(q: torch.Tensor) -> torch.Tensor:
    return u32(q).view(-1, 1)


class GaloisKeys(NamedTuple):
    data: torch.Tensor      # (n_elts, dnum, 2, K, N)
    elts: Tuple[int, ...]


# ---------------------------------------------------------------------------
# cores: samples in, residues out
# ---------------------------------------------------------------------------

def _bgv_mult(ctx: Context, rows=None):
    """BGV's noise multiplier: (t mod q, its Shoup word) over the key base
    rows `rows` (all of QP by default); (None, None) for CKKS and BFV."""
    if ctx.params.scheme != "bgv":
        return None, None
    if rows is None:
        return ctx.t_mod_q, ctx.t_mod_q_shoup
    rows = rows.long()
    return ctx.t_mod_q[rows], ctx.t_mod_q_shoup[rows]


def gen_secret_core32(ctx: Context, s: torch.Tensor,
                      ops: Kernels = KERNELS) -> torch.Tensor:
    """The ternary vector s (N,) -> the secret key in NTT form over QP,
    (K, N)."""
    return ops.ntt_forward(smp.lift_signed_to_rns32(s, ctx.key_q), ctx.ntt,
                           ctx.rows_qp)


def encrypt_zero_sym_core32(ctx: Context, sk: torch.Tensor, a: torch.Tensor,
                            e: torch.Tensor, ops: Kernels = KERNELS):
    """(c0, c1) = (-(a s + e), a) in NTT form at the key level (t e for
    BGV): a (..., K, N) uniform, e (..., N) CBD, one forward NTT over every
    leading group."""
    e_ntt = ops.ntt_forward(smp.lift_signed_to_rns32(e, ctx.key_q,
                                                     *_bgv_mult(ctx)),
                            ctx.ntt, ctx.rows_qp)
    q = _qcol(ctx.key_q)
    c0 = -(a.long() * sk.long() % q + e_ntt.long()) % q
    return c0.int(), a


def gen_kswitch_core32(ctx: Context, sk: torch.Tensor, new_key: torch.Tensor,
                       a: torch.Tensor, e: torch.Tensor,
                       ops: Kernels = KERNELS) -> torch.Tensor:
    """Key-switching key for `new_key` (K, N), NTT form: (dnum, 2, K, N)
    from dnum encryptions of zero (a (dnum, K, N), e (dnum, N)), digit d's
    with P * new_key added on its own rows."""
    p = ctx.params
    alpha = p.size_p
    big_p = 1
    for v in p.special_moduli:
        big_p *= v
    q = _qcol(ctx.key_q)
    qs = p.coeff_modulus
    pm = u32_tensor([big_p % v for v in qs]).to(new_key.device)
    pm_shoup = u32_tensor([((big_p % v) << 32) // v for v in qs]).to(
        new_key.device)
    term = mul_mod_shoup32(new_key, _qcol(pm), _qcol(pm_shoup), q)
    c0, c1 = encrypt_zero_sym_core32(ctx, sk, a, e, ops)
    c0 = c0.long()
    for d in range(a.shape[0]):
        lo, hi = d * alpha, min((d + 1) * alpha, p.size_q)
        c0[d, lo:hi] = (c0[d, lo:hi] + term[lo:hi]) % q[lo:hi]
    return torch.stack([c0.int(), c1], dim=1)


def encrypt_zero_core32(ks: KeySwitch32, pk_qlp: torch.Tensor,
                        u: torch.Tensor, e: torch.Tensor, is_ntt: bool,
                        mult=None, mult_shoup=None,
                        ops: Kernels = KERNELS) -> torch.Tensor:
    """An encryption of zero at the KeySwitch32's level, (2, size_ql, N):
    (u pk_i + e_i) over QlP (pk_qlp: the public key's QlP rows, (2,
    size_qlp, N); u (N,) ternary; e (2, N) CBD, times `mult` with its Shoup
    word when given), then the moddown: in NTT form (is_ntt) the moddown
    pair, else the sum in coefficient form and moddown_coeff32."""
    qv = ks.mv_qlp.q
    q = _qcol(qv)
    u_ntt = _fwd(ks, smp.lift_signed_to_rns32(u, qv), ks.rows_qlp, ops)
    e32 = smp.lift_signed_to_rns32(e, qv, mult, mult_shoup)
    prod = u_ntt.long() * pk_qlp.long() % q
    if is_ntt:
        x = ((prod + _fwd(ks, e32, ks.rows_qlp, ops).long()) % q).int()
        return torch.stack(moddown32_pair(ks, x[0], x[1], ops=ops))
    x = (_inv(ks, prod.int(), ks.rows_qlp, ops).long() + e32.long()) % q
    return moddown_coeff32(ks, x.int(), ops)


def scale_plain_up(ctx: Context, m: torch.Tensor,
                   chain_index: int) -> torch.Tensor:
    """BFV: m (N,) in [0, t) -> round(Ql m / t) mod q_i at the level, (k,
    N) int64: Delta m + round(r_t m / t) with Ql = Delta t + r_t."""
    b = ctx.get_context_data(chain_index).bfv
    t = ctx.params.plain_modulus
    q = _qcol(ctx.key_q[:len(b.delta_mod_q)])
    delta = torch.tensor(b.delta_mod_q, device=m.device).view(-1, 1)
    m = m.long()
    fix = (b.r_t * m + t // 2) // t
    return (m.view(1, -1) * delta + fix) % q


def lift_plain_centered(ctx: Context, m: torch.Tensor,
                        k: int) -> torch.Tensor:
    """m (N,) in [0, t) -> its centered lift over the first k data primes
    ([t/2, t) -> q - (t - m)), coefficient form (k, N)."""
    t = ctx.params.plain_modulus
    m = m.long()
    return smp.lift_signed_to_rns32(torch.where(m >= (t + 1) >> 1, m - t, m),
                                    ctx.key_q[:k])


def bgv_lift_plain_ntt(ctx: Context, m: torch.Tensor, k: int,
                       ops: Kernels = KERNELS) -> torch.Tensor:
    """BGV: lift_plain_centered in NTT form (k, N)."""
    return ops.ntt_forward(lift_plain_centered(ctx, m, k), ctx.ntt,
                           ctx.rows_qp[:k])


def encrypt_asymmetric_core(ctx: Context, ks: KeySwitch32, pk: torch.Tensor,
                            plain: Plaintext, u: torch.Tensor,
                            e: torch.Tensor,
                            ops: Kernels = KERNELS) -> Ciphertext:
    """Public-key encryption of `plain` with the samples u (N,) and e (2,
    N), at the level of `ks`: the plaintext's chain index for CKKS, the
    first data level for BFV and BGV."""
    scheme = ctx.params.scheme
    ci = plain.chain_index if scheme == "ckks" else ctx.first_data_index
    k = ks.size_ql
    if k != ctx.get_context_data(ci).size_ql:
        raise ValueError(f"the key-switch tables are not at chain index {ci}")
    zero = encrypt_zero_core32(ks, pk.index_select(1, ks.rows_qlp), u, e,
                               scheme != "bfv", *_bgv_mult(ctx, ks.rows_qlp),
                               ops=ops)
    q = _qcol(ks.mv_ql.q)
    if scheme == "bfv":
        pt = scale_plain_up(ctx, plain.data[0], ci)
    elif scheme == "bgv":
        pt = bgv_lift_plain_ntt(ctx, plain.data[0], k, ops)
    else:
        pt = plain.data
    c0 = ((zero[0].long() + pt) % q).int()
    return Ciphertext(data=torch.stack([c0, zero[1]]), chain_index=ci,
                      is_ntt_form=scheme != "bfv",
                      scale=plain.scale if scheme == "ckks" else 1.0)


# ---------------------------------------------------------------------------
# the same, drawing from a torch.Generator
# ---------------------------------------------------------------------------

def gen_secret_key(ctx: Context, gen: torch.Generator,
                   ops: Kernels = KERNELS) -> torch.Tensor:
    """Ternary secret in NTT form over QP: (K, N)."""
    return gen_secret_core32(ctx, smp.sample_ternary_vec(gen, ctx.params.n),
                             ops)


def gen_public_key(ctx: Context, sk: torch.Tensor, gen: torch.Generator,
                   ops: Kernels = KERNELS) -> torch.Tensor:
    """An encryption of zero at the key level: (2, K, N)."""
    a = smp.sample_uniform_rns(gen, ctx.params.n, ctx.key_q)
    e = smp.sample_error_cbd(gen, ctx.params.n)
    return torch.stack(encrypt_zero_sym_core32(ctx, sk, a, e, ops))


def _gen_kswitch_key(ctx: Context, sk: torch.Tensor, new_key: torch.Tensor,
                     gen: torch.Generator, ops: Kernels) -> torch.Tensor:
    """Per digit a uniform a, then a CBD e."""
    p = ctx.params
    draws = [(smp.sample_uniform_rns(gen, p.n, ctx.key_q),
              smp.sample_error_cbd(gen, p.n))
             for _ in range(-(-p.size_q // p.size_p))]
    return gen_kswitch_core32(ctx, sk, new_key,
                              torch.stack([a for a, _ in draws]),
                              torch.stack([e for _, e in draws]), ops)


def gen_relin_key(ctx: Context, sk: torch.Tensor, gen: torch.Generator,
                  ops: Kernels = KERNELS) -> torch.Tensor:
    """The relin key (dnum, 2, K, N): switches s^2 to s."""
    s_sq = sk.long() * sk.long() % _qcol(ctx.key_q)
    return _gen_kswitch_key(ctx, sk, s_sq.int(), gen, ops)


def galois_elts(ctx: Context, steps=None, elts=None) -> Tuple[int, ...]:
    """The Galois elements of `elts`, else of the rotation `steps`, else
    the parameters' galois_elts, else default_elts."""
    n = ctx.params.n
    if elts is None:
        if steps is not None:
            elts = gal.get_elts_from_steps(steps, n)
        elif ctx.params.galois_elts:
            elts = ctx.params.galois_elts
        else:
            elts = gal.default_elts(n)
    return tuple(int(e) for e in elts)


def create_galois_keys(ctx: Context, sk: torch.Tensor, gen: torch.Generator,
                       steps: Optional[Sequence[int]] = None, elts=None,
                       ops: Kernels = KERNELS) -> GaloisKeys:
    """One key-switching key per Galois element (galois_elts), switching
    sigma_elt(s) (the NTT-form permutation of sk) back to s."""
    n = ctx.params.n
    elts = galois_elts(ctx, steps, elts)
    data = []
    for elt in elts:
        perm = torch.from_numpy(gal.make_ntt_perm(elt, n)).to(sk.device)
        data.append(_gen_kswitch_key(ctx, sk, sk[:, perm], gen, ops))
    return GaloisKeys(torch.stack(data), elts)


def encrypt_asymmetric(ctx: Context, pk: torch.Tensor, plain: Plaintext,
                       gen: torch.Generator, ks: KeySwitch32 = None,
                       ops: Kernels = KERNELS) -> Ciphertext:
    """Public-key encryption (encrypt_asymmetric_core) with u, e0, e1 drawn
    in that order; ks: the level's KeySwitch32, built on the context's
    device when not given."""
    n = ctx.params.n
    if ks is None:
        ci = (plain.chain_index if ctx.params.scheme == "ckks"
              else ctx.first_data_index)
        ks = build_keyswitch32(ctx, ci, ctx.key_q.device)
    u = smp.sample_ternary_vec(gen, n)
    e = torch.stack([smp.sample_error_cbd(gen, n) for _ in range(2)])
    return encrypt_asymmetric_core(ctx, ks, pk, plain, u, e, ops)


def encrypt_symmetric(ctx: Context, sk: torch.Tensor, plain: torch.Tensor,
                      gen: torch.Generator,
                      ops: Kernels = KERNELS) -> torch.Tensor:
    """CKKS: plain (k, N) NTT form over the first k data primes -> (2, k,
    N), NTT form.  BFV: plain (N,), an integer polynomial taken mod t ->
    (2, size_q, N) at the first data level, coefficient form.  BGV: the
    same plain -> (2, size_q, N) at the first data level, NTT form, with
    correction factor 1."""
    scheme = ctx.params.scheme
    n = ctx.params.n
    if scheme == "ckks":
        k = plain.shape[0]
    else:
        k = ctx.get_context_data(ctx.first_data_index).size_ql
        plain = plain.long() % ctx.params.plain_modulus
    qk = ctx.key_q[:k]
    q = _qcol(qk)
    rows = ctx.rows_qp[:k]
    a = smp.sample_uniform_rns(gen, n, qk)
    e = smp.lift_signed_to_rns32(smp.sample_error_cbd(gen, n), qk,
                                 *_bgv_mult(ctx, rows))
    if scheme == "bfv":
        a_s = ops.ntt_inverse((a.long() * sk[:k].long() % q).int(), ctx.ntt,
                              rows)
        c0 = (scale_plain_up(ctx, plain, ctx.first_data_index)
              - a_s.long() - e.long()) % q
        return torch.stack([c0.int(), ops.ntt_inverse(a, ctx.ntt, rows)])
    if scheme == "bgv":
        plain = bgv_lift_plain_ntt(ctx, plain, k, ops)
    e = ops.ntt_forward(e, ctx.ntt, rows)
    c0 = (plain.long() - a.long() * sk[:k].long() - e.long()) % q
    return torch.stack([c0.int(), a])


# ---------------------------------------------------------------------------
# decryption
# ---------------------------------------------------------------------------

def decrypt(ctx: Context, sk: torch.Tensor, ct: torch.Tensor,
            correction_factor: int = 1,
            ops: Kernels = KERNELS) -> torch.Tensor:
    """CKKS: (size, k, N) ciphertext -> [c0 + c1 s + c2 s^2 + ...]_Ql, the
    NTT-form plaintext (k, N).  BFV: a coefficient-form ciphertext -> the
    message (N,) in [0, t).  BGV: an NTT-form ciphertext and its
    correction factor -> the message (N,) in [0, t), int64."""
    if ctx.params.scheme == "bfv":
        return _decrypt_bfv(ctx, sk, ct, ops)
    if ctx.params.scheme == "bgv":
        return _decrypt_bgv(ctx, sk, ct, correction_factor, ops)
    return _dot_with_sk_powers(ctx, sk, ct)


def _decrypt_bgv(ctx: Context, sk: torch.Tensor, ct: torch.Tensor,
                 correction_factor: int, ops: Kernels) -> torch.Tensor:
    """The exact centered conversion of x = [c0 + c1 s]_Ql to {t}: convert
    x + (Ql - 1) / 2 exactly, subtract (Ql - 1) / 2 mod t, then multiply
    by the correction factor's inverse mod t."""
    k = ct.shape[1]
    p = ctx.params
    b = ctx.get_context_data(p.size_q - k + 1).bgv
    t = p.plain_modulus
    q = _qcol(ctx.key_q[:k])
    x = ops.ntt_inverse(_dot_with_sk_powers(ctx, sk, ct), ctx.ntt,
                        ctx.rows_qp[:k])
    shifted = (x.long() + torch.tensor(b.qhalf_mod_q, device=x.device).view(
        -1, 1)) % q
    conv = bconv_exact32(shifted.int(), BaseConvConsts32(b.q_to_t).to(
        x.device), ops.fold_matmul)[0].long()
    m = (conv - b.qhalf_mod_t) % t
    f = correction_factor % t
    if f != 1:
        m = m * pow(f, -1, t) % t
    return m


def _decrypt_bfv(ctx: Context, sk: torch.Tensor, ct: torch.Tensor,
                 ops: Kernels) -> torch.Tensor:
    k = ct.shape[1]
    rows = ctx.rows_qp[:k]
    acc = _dot_with_sk_powers(ctx, sk, ops.ntt_forward(ct, ctx.ntt, rows))
    ql = ctx.params.data_moduli[:k]
    big_ql = 1
    for q in ql:
        big_ql *= q
    t = ctx.params.plain_modulus
    sr = ExactScaleRound32(ql, t, big_ql, [t]).to(ct.device)
    return scale_and_round_exact32(ops.ntt_inverse(acc, ctx.ntt, rows), sr,
                                   ops.fold_matmul)[0]


def _dot_with_sk_powers(ctx: Context, sk: torch.Tensor,
                        ct: torch.Tensor) -> torch.Tensor:
    """[c0 + c1 s + c2 s^2 + ...]_Ql over NTT-form polys (k, N)."""
    k = ct.shape[1]
    q = _qcol(ctx.key_q[:k])
    s = sk[:k].long()
    acc = ct[0].long()
    s_pow = s
    for i in range(1, ct.shape[0]):
        acc = (acc + ct[i].long() * s_pow) % q
        s_pow = s_pow * s % q
    return acc.int()


def invariant_noise_budget(ctx: Context, sk: torch.Tensor, ct: Ciphertext,
                           ops: Kernels = KERNELS) -> int:
    """A BFV ciphertext's remaining noise budget in bits (the JAX package's
    invariant_noise_budget): v = t [c0 + c1 s + ...]_Ql composed by the
    CRT in Python integers and centered, then log2(Ql) - log2(2 max |v|),
    each a bit length as the reference counts it; 0 at the least."""
    if ctx.params.scheme != "bfv":
        raise ValueError("noise budget is defined for BFV")
    data = ct.data
    k = data.shape[1]
    rows = ctx.rows_qp[:k]
    if not ct.is_ntt_form:
        data = ops.ntt_forward(data, ctx.ntt, rows)
    x = u32(ops.ntt_inverse(_dot_with_sk_powers(ctx, sk, data), ctx.ntt,
                            rows)).cpu().numpy()
    return _noise_budget(x, ctx.params.data_moduli[:k],
                         ctx.params.plain_modulus)


def _noise_budget(x: np.ndarray, moduli, t: int) -> int:
    """The budget of the phase x (k, N) residues over `moduli`."""
    total = 1
    for q in moduli:
        total *= q
    acc = np.zeros(x.shape[1], dtype=object)
    for row, q in zip(x, moduli):
        punct = total // q
        acc += row.astype(object) * pow(punct % q, -1, q) % q * punct
    v = acc % total * t % total
    norm = int(np.where(v > total // 2, total - v, v).max())
    if norm == 0:
        return total.bit_length() - 1
    return max((total.bit_length() - 1) - (2 * norm).bit_length(), 0)


# ---------------------------------------------------------------------------
# the u64 half (contexts with a prime of 2^30 or more): the JAX package's
# keys.py on u64 words, the samples as tensors in the *_core64 functions
# ---------------------------------------------------------------------------

def lift_signed_to_rns64(e: torch.Tensor, mv, mult: po64.Limbs = None,
                         ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """Signed (..., N) small integers -> (..., L, N) u64 residues of mv,
    times U4's per-limb multiplier table `mult` (L limbs) when given
    (BGV's t e)."""
    r = mm64.reduce_i64_centered(e.long().unsqueeze(-2), mv.q.view(-1, 1))
    return r if mult is None else ops.shoup_rns(r, mult)


def _t_mult64(ctx: Context, cd=None):
    """BGV's noise multiplier t mod q (U4's table) over the level `cd`
    (the key level by default); None for CKKS and BFV."""
    return (ctx.chain[0] if cd is None else cd).u64.t_mult


def gen_secret_core64(ctx: Context, s: torch.Tensor,
                      ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """The ternary vector s (N,) -> the secret key, NTT form over QP."""
    ctx.require_u64("gen_secret_key")
    return ops.ntt_forward(lift_signed_to_rns64(s, ctx.key_mv), ctx.ntt64,
                           ctx.rows_qp)


def encrypt_zero_sym_core64(ctx: Context, sk: torch.Tensor, a: torch.Tensor,
                            e: torch.Tensor, ops: Kernels64 = KERNELS64):
    """(c0, c1) = (-(a s + e), a) in NTT form at the key level (t e for
    BGV): a (..., K, N) uniform, e (..., N) CBD."""
    mv = ctx.key_mv
    e_ntt = ops.ntt_forward(lift_signed_to_rns64(e, mv, _t_mult64(ctx), ops),
                            ctx.ntt64, ctx.rows_qp)
    return po64.neg_rns(ops.fma_rns(a, sk, e_ntt, mv), mv), a


def gen_kswitch_core64(ctx: Context, sk: torch.Tensor, new_key: torch.Tensor,
                       a: torch.Tensor, e: torch.Tensor,
                       ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """The key-switching key for `new_key` (K, N): (dnum, 2, K, N), digit
    d's encryption of zero with P * new_key (U4, by P mod q and its Shoup
    word) added on its own rows."""
    p = ctx.params
    alpha = p.size_p
    big_p = 1
    for v in p.special_moduli:
        big_p *= v
    mv = ctx.key_mv
    pm = [big_p % v for v in p.coeff_modulus]
    dev = new_key.device
    term = ops.shoup_rns(new_key, po64.limbs(p.coeff_modulus, w=pm,
                                             device=dev))
    c0, c1 = encrypt_zero_sym_core64(ctx, sk, a, e, ops)
    q = mv.q.view(-1, 1)
    c0 = c0.clone()
    for d in range(a.shape[0]):
        lo, hi = d * alpha, min((d + 1) * alpha, p.size_q)
        c0[d, lo:hi] = mm64.add_mod(c0[d, lo:hi], term[lo:hi], q[lo:hi])
    return torch.stack([c0, c1], dim=1)


def gen_relin_core64(ctx: Context, sk: torch.Tensor, a: torch.Tensor,
                     e: torch.Tensor, ops: Kernels64 = KERNELS64):
    """The relin key from its samples: switches s^2 to s."""
    return gen_kswitch_core64(ctx, sk, ops.mul_rns(sk, sk, ctx.key_mv), a, e,
                              ops)


def gen_galois_core64(ctx: Context, sk: torch.Tensor, elt: int,
                      a: torch.Tensor, e: torch.Tensor,
                      ops: Kernels64 = KERNELS64):
    """One Galois key from its samples: switches sigma_elt(s) to s."""
    perm = torch.from_numpy(gal.make_ntt_perm(elt, ctx.params.n)).to(
        sk.device)
    return gen_kswitch_core64(ctx, sk, sk[:, perm], a, e, ops)


def lift_plain_ntt64(ctx: Context, cd, m: torch.Tensor,
                     ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """m (N,) in [0, t) centered ([t/2, t) -> q - (t - m)) over Ql, NTT
    form (k, N): BGV's plaintext, and BFV's in multiply_plain."""
    t = ctx.params.plain_modulus
    m = m.long()
    k = cd.size_ql
    return ops.ntt_forward(lift_signed_to_rns64(
        torch.where(m >= (t + 1) >> 1, m - t, m), cd.u64.mv), ctx.ntt64,
        ctx.rows_qp[:k])


def encrypt_zero_asym_core64(ctx: Context, pk: torch.Tensor, chain_index: int,
                             u: torch.Tensor, e: torch.Tensor,
                             ops: Kernels64 = KERNELS64,
                             ntt_form: bool = True) -> torch.Tensor:
    """An encryption of zero at `chain_index`, (2, size_ql, N): (u pk_i +
    e_i) at the key level (u (N,) ternary, e (2, N) CBD), its QlP rows,
    then the moddown of each half; NTT form, or (`ntt_form` False, BFV)
    u pk_i brought back by U1's inverse, e_i added in coefficient form and
    the moddown of the coefficients."""
    from .keyswitch import moddown_coeff, moddown_pair
    cd = ctx.get_context_data(chain_index)
    mv = ctx.key_mv
    u_ntt = ops.ntt_forward(lift_signed_to_rns64(u, mv), ctx.ntt64,
                            ctx.rows_qp)
    e_rns = lift_signed_to_rns64(e, mv, _t_mult64(ctx), ops)
    if ntt_form:
        x = ops.fma_rns(pk, u_ntt, ops.ntt_forward(e_rns, ctx.ntt64,
                                                   ctx.rows_qp), mv)
    else:
        x = po64.add_rns(ops.ntt_inverse(ops.mul_rns(pk, u_ntt, mv),
                                         ctx.ntt64, ctx.rows_qp), e_rns, mv)
    x = x.index_select(1, cd.u64.ks.rows_qlp.long())
    if ntt_form:
        return moddown_pair(ctx, cd, x, ops)
    return torch.stack([moddown_coeff(ctx, cd, h, ops) for h in x])


def encrypt_asymmetric_core64(ctx: Context, pk: torch.Tensor,
                              plain: Plaintext, u: torch.Tensor,
                              e: torch.Tensor,
                              ops: Kernels64 = KERNELS64) -> Ciphertext:
    """Public-key encryption with the samples u (N,) and e (2, N): CKKS at
    the plaintext's chain index, BFV and BGV at the first data level; NTT
    form (BGV: correction factor 1), BFV in coefficient form with
    round(Ql m / t) added to c0."""
    ctx.require_u64("encrypt_asymmetric")
    scheme = ctx.params.scheme
    ci = plain.chain_index if scheme == "ckks" else ctx.first_data_index
    cd = ctx.get_context_data(ci)
    bfv = scheme == "bfv"
    zero = encrypt_zero_asym_core64(ctx, pk, ci, u, e, ops, not bfv)
    pt = (plain.data if scheme == "ckks" else
          sr64.scale_plain_up(plain.data[0], cd.u64.plain_lift,
                              ops.shoup_rns) if bfv else
          lift_plain_ntt64(ctx, cd, plain.data[0], ops))
    c0 = po64.add_rns(zero[0], pt, cd.u64.mv)
    return Ciphertext(data=torch.stack([c0, zero[1]]), chain_index=ci,
                      is_ntt_form=not bfv,
                      scale=plain.scale if scheme == "ckks" else 1.0)


def encrypt_symmetric_core64(ctx: Context, sk: torch.Tensor,
                             plain: Plaintext, a: torch.Tensor,
                             e: torch.Tensor,
                             ops: Kernels64 = KERNELS64) -> Ciphertext:
    """Secret-key encryption with the samples a (k, N) uniform over the
    level and e (N,) CBD: (-(a s + e) + m, a); NTT form, BFV in
    coefficient form (a s and a brought back by U1's inverse, e and
    round(Ql m / t) added there)."""
    ctx.require_u64("encrypt_symmetric")
    scheme = ctx.params.scheme
    ci = plain.chain_index if scheme == "ckks" else ctx.first_data_index
    cd = ctx.get_context_data(ci)
    k = cd.size_ql
    mv = cd.u64.mv
    e_rns = lift_signed_to_rns64(e, mv, _t_mult64(ctx, cd), ops)
    if scheme == "bfv":
        back = ops.ntt_inverse(torch.stack([ops.mul_rns(a, sk[:k], mv), a]),
                               ctx.ntt64, ctx.rows_qp[:k])
        c0 = po64.neg_rns(po64.add_rns(back[0], e_rns, mv), mv)
        c0 = po64.add_rns(c0, sr64.scale_plain_up(
            plain.data[0], cd.u64.plain_lift, ops.shoup_rns), mv)
        return Ciphertext(data=torch.stack([c0, back[1]]), chain_index=ci,
                          is_ntt_form=False)
    e_ntt = ops.ntt_forward(e_rns, ctx.ntt64, ctx.rows_qp[:k])
    c0 = po64.neg_rns(ops.fma_rns(a, sk[:k], e_ntt, mv), mv)
    pt = (plain.data if scheme == "ckks"
          else lift_plain_ntt64(ctx, cd, plain.data[0], ops))
    return Ciphertext(data=torch.stack([po64.add_rns(c0, pt, mv), a]),
                      chain_index=ci, is_ntt_form=True,
                      scale=plain.scale if scheme == "ckks" else 1.0)


def sample_uniform_rns64(gen: torch.Generator, n: int, cd,
                         ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """(L, N) u64 words over the level `cd`, row l uniform in [0, q_l):
    (hi 2^62 + lo) mod q for two 62-bit draws (hi's (L, N) first), the
    product by 2^62 mod q U4's Shoup form; statistical distance below
    q / 2^124 from uniform."""
    lv = cd.u64
    q = lv.mv.q.view(-1, 1)
    shape = (q.shape[0], n)
    hi = torch.randint(0, 1 << smp.DRAW_BITS, shape, generator=gen,
                       device=gen.device)
    lo = torch.randint(0, 1 << smp.DRAW_BITS, shape, generator=gen,
                       device=gen.device)
    return mm64.add_mod(ops.shoup_rns(torch.remainder(hi, q), lv.pow62),
                        torch.remainder(lo, q), q)


def gen_secret_key64(ctx: Context, gen: torch.Generator,
                     ops: Kernels64 = KERNELS64) -> torch.Tensor:
    return gen_secret_core64(ctx, smp.sample_ternary_vec(gen, ctx.params.n),
                             ops)


def gen_public_key64(ctx: Context, sk: torch.Tensor, gen: torch.Generator,
                     ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """(2, K, N): a, then e."""
    a = sample_uniform_rns64(gen, ctx.params.n, ctx.chain[0], ops)
    e = smp.sample_error_cbd(gen, ctx.params.n)
    return torch.stack(encrypt_zero_sym_core64(ctx, sk, a, e, ops))


def _kswitch_draws64(ctx: Context, gen: torch.Generator, ops: Kernels64):
    """Per digit a uniform a, then a CBD e: (dnum, K, N), (dnum, N)."""
    p = ctx.params
    draws = [(sample_uniform_rns64(gen, p.n, ctx.chain[0], ops),
              smp.sample_error_cbd(gen, p.n))
             for _ in range(-(-p.size_q // p.size_p))]
    return (torch.stack([a for a, _ in draws]),
            torch.stack([e for _, e in draws]))


def gen_relin_key64(ctx: Context, sk: torch.Tensor, gen: torch.Generator,
                    ops: Kernels64 = KERNELS64) -> torch.Tensor:
    return gen_relin_core64(ctx, sk, *_kswitch_draws64(ctx, gen, ops), ops)


def create_galois_keys64(ctx: Context, sk: torch.Tensor,
                         gen: torch.Generator, steps=None, elts=None,
                         ops: Kernels64 = KERNELS64) -> GaloisKeys:
    elts = galois_elts(ctx, steps, elts)
    return GaloisKeys(torch.stack([
        gen_galois_core64(ctx, sk, elt, *_kswitch_draws64(ctx, gen, ops),
                          ops)
        for elt in elts]), elts)


def encrypt_asymmetric64(ctx: Context, pk: torch.Tensor, plain: Plaintext,
                         gen: torch.Generator,
                         ops: Kernels64 = KERNELS64) -> Ciphertext:
    """u, e0, e1 drawn in that order."""
    n = ctx.params.n
    u = smp.sample_ternary_vec(gen, n)
    e = torch.stack([smp.sample_error_cbd(gen, n) for _ in range(2)])
    return encrypt_asymmetric_core64(ctx, pk, plain, u, e, ops)


def encrypt_symmetric64(ctx: Context, sk: torch.Tensor, plain: Plaintext,
                        gen: torch.Generator,
                        ops: Kernels64 = KERNELS64) -> Ciphertext:
    """a, then e."""
    ci = (plain.chain_index if ctx.params.scheme == "ckks"
          else ctx.first_data_index)
    a = sample_uniform_rns64(gen, ctx.params.n, ctx.get_context_data(ci),
                             ops)
    e = smp.sample_error_cbd(gen, ctx.params.n)
    return encrypt_symmetric_core64(ctx, sk, plain, a, e, ops)


def _dot_with_sk_powers64(ctx: Context, sk: torch.Tensor, ct: Ciphertext,
                          ops: Kernels64) -> torch.Tensor:
    """[c0 + c1 s + c2 s^2 + ...]_Ql in NTT form (U4's fma and mul; a
    coefficient-form ciphertext forward first, U1)."""
    cd = ctx.get_context_data(ct.chain_index)
    mv = cd.u64.mv
    s = sk[:cd.size_ql]
    data = ct.data
    if not ct.is_ntt_form:
        data = ops.ntt_forward(data, ctx.ntt64, ctx.rows_qp[:cd.size_ql])
    acc = data[0]
    s_pow = s
    for i in range(1, ct.size):
        acc = ops.fma_rns(data[i], s_pow, acc, mv)
        if i + 1 < ct.size:
            s_pow = ops.mul_rns(s_pow, s, mv)
    return acc


def _phase64(ctx: Context, sk: torch.Tensor, ct: Ciphertext,
             ops: Kernels64) -> torch.Tensor:
    """[c0 + c1 s + ...]_Ql in coefficient form (k, N)."""
    k = ctx.get_context_data(ct.chain_index).size_ql
    return ops.ntt_inverse(_dot_with_sk_powers64(ctx, sk, ct, ops),
                           ctx.ntt64, ctx.rows_qp[:k])


def decrypt64(ctx: Context, sk: torch.Tensor, ct: Ciphertext,
              ops: Kernels64 = KERNELS64) -> Plaintext:
    """CKKS: the NTT-form plaintext at the ciphertext's level and scale.
    BFV: the message (1, N) mod t, round(t [c0 + c1 s + ...]_Ql / Ql)
    (ops/scaleround.decrypt_scale_and_round).  BGV: the message (1, N) mod
    t: the exact centered conversion of [c0 + c1 s + ...]_Ql to {t} (U2),
    divided by the correction factor (U4's Shoup form, by f^-1 mod t)."""
    ctx.require_u64("decrypt")
    scheme = ctx.params.scheme
    cd = ctx.get_context_data(ct.chain_index)
    lv = cd.u64
    if scheme == "bfv":
        m = sr64.decrypt_scale_and_round(_phase64(ctx, sk, ct, ops),
                                         lv.decrypt_sr)
        return Plaintext(data=m.unsqueeze(0), chain_index=ct.chain_index)
    if scheme == "ckks":
        return Plaintext(data=_dot_with_sk_powers64(ctx, sk, ct, ops),
                         chain_index=ct.chain_index, is_ntt_form=True,
                         scale=ct.scale)
    b = lv.bgv
    t = ctx.params.plain_modulus
    x = _phase64(ctx, sk, ct, ops)
    shifted = mm64.add_mod(x, b.qhalf_mod_q.view(-1, 1),
                           lv.mv.q.view(-1, 1))
    conv = bconv64.bconv_exact(shifted, b.q_to_t, ops.bconv)
    m = mm64.sub_mod(conv, b.qhalf_mod_t, b.t_mv.q.view(-1, 1))
    f = ct.correction_factor % t
    if f != 1:
        m = ops.shoup_rns(m, po64.limbs([t], w=[pow(f, -1, t)],
                                        device=m.device))
    return Plaintext(data=m, chain_index=ct.chain_index)


def invariant_noise_budget64(ctx: Context, sk: torch.Tensor, ct: Ciphertext,
                             ops: Kernels64 = KERNELS64) -> int:
    """A BFV ciphertext's remaining noise budget in bits on the u64 path
    (the JAX package's invariant_noise_budget): v = t [c0 + c1 s + ...]_Ql
    composed by the CRT in Python integers and centered, then log2(Ql) -
    log2(2 max |v|), each a bit length; 0 at the least."""
    if ctx.params.scheme != "bfv":
        raise ValueError("noise budget is defined for BFV")
    x = u64_values(_phase64(ctx, sk, ct, ops))
    return _noise_budget(x, ctx.get_context_data(ct.chain_index).moduli,
                         ctx.params.plain_modulus)

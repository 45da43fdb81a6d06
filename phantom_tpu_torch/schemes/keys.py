"""Key generation, symmetric encryption and decryption (CKKS, BFV, BGV).

Counterpart of the CKKS, BFV and BGV paths of phantom_tpu/schemes/keys.py.
Keys live in NTT form over the full key base QP; the relin key holds dnum
digit keys, each an encryption of zero with P * s^2 added on its own
digit's rows, and a Galois key the same with P * sigma_elt(s) in place of
P * s^2.  CKKS ciphertexts are in NTT form; BFV ones in coefficient form
at the first data level, (c0, c1) = (-(a s + e) + round(Ql m / t), a),
and BFV decryption is round(t [c0 + c1 s]_Ql / Ql) mod t, through
ops/scaleround32.py with num = t, den = Ql and the output base {t}.  BGV
multiplies every error by t (keys and encryptions), encrypts in NTT form
at the first data level, (c0, c1) = (-(a s + t e) + m, a) with m centered
mod t, and decrypts by the exact centered conversion of [c0 + c1 s]_Ql to
{t}, divided by the ciphertext's correction factor.
Randomness comes from an explicit `torch.Generator` (ops/sampling.py),
so keys match the JAX package's in structure and distribution, not bits.
Tensors are int32 residues on the generator's device; forward NTTs go
through the K2 wrapper.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..ops import sampling as smp
from ..ops.bconv32 import BaseConvConsts32, bconv_exact32
from ..ops.modmath32 import u32
from ..ops.ntt_kernels import ntt_forward, ntt_inverse
from ..ops.scaleround32 import ExactScaleRound32, scale_and_round_exact32
from . import galois as gal
from .context import Context


def _qcol(q: torch.Tensor) -> torch.Tensor:
    return u32(q).view(-1, 1)


def gen_secret_key(ctx: Context, gen: torch.Generator) -> torch.Tensor:
    """Ternary secret in NTT form over QP: (K, N)."""
    s = smp.lift_signed(smp.sample_ternary(gen, ctx.params.n), ctx.key_q)
    return ntt_forward(s, ctx.ntt, ctx.rows_qp)


def _error(ctx: Context, gen: torch.Generator, k: int) -> torch.Tensor:
    """CBD noise over the first k primes of QP, coefficient form; times t
    for BGV."""
    q = ctx.key_q[:k]
    e = smp.lift_signed(smp.sample_error_cbd(gen, ctx.params.n), q)
    if ctx.params.scheme == "bgv":
        e = (e.long() * u32(ctx.t_mod_q[:k]).view(-1, 1) % _qcol(q)).int()
    return e


def _encrypt_zero_symmetric_ntt(ctx: Context, sk: torch.Tensor,
                                gen: torch.Generator):
    """(c0, c1) = (-(a s + e), a) in NTT form at the key level (t e for
    BGV)."""
    n = ctx.params.n
    q = _qcol(ctx.key_q)
    a = smp.sample_uniform_rns(gen, n, ctx.key_q)
    e = ntt_forward(_error(ctx, gen, len(ctx.key_q)), ctx.ntt, ctx.rows_qp)
    c0 = (-(a.long() * sk.long() + e.long())) % q
    return c0.int(), a


def _gen_kswitch_key(ctx: Context, sk: torch.Tensor, new_key: torch.Tensor,
                     gen: torch.Generator) -> torch.Tensor:
    """Key-switching key for `new_key` (K, N): (dnum, 2, K, N)."""
    p = ctx.params
    alpha = p.size_p
    dnum = -(-p.size_q // alpha)
    big_p = 1
    for v in p.special_moduli:
        big_p *= v
    q = _qcol(ctx.key_q)
    pm = torch.tensor([big_p % v for v in p.coeff_modulus],
                      device=new_key.device).view(-1, 1)
    term = new_key.long() * pm % q
    keys = []
    for d in range(dnum):
        c0, c1 = _encrypt_zero_symmetric_ntt(ctx, sk, gen)
        lo, hi = d * alpha, min((d + 1) * alpha, p.size_q)
        c0[lo:hi] = ((c0[lo:hi].long() + term[lo:hi]) % q[lo:hi]).int()
        keys.append(torch.stack([c0, c1]))
    return torch.stack(keys)


def gen_relin_key(ctx: Context, sk: torch.Tensor,
                  gen: torch.Generator) -> torch.Tensor:
    s_sq = sk.long() * sk.long() % _qcol(ctx.key_q)
    return _gen_kswitch_key(ctx, sk, s_sq.int(), gen)


class GaloisKeys(NamedTuple):
    data: torch.Tensor      # (n_elts, dnum, 2, K, N)
    elts: Tuple[int, ...]


def create_galois_keys(ctx: Context, sk: torch.Tensor, gen: torch.Generator,
                       steps: Sequence[int]) -> GaloisKeys:
    """One key-switching key per rotation step, switching sigma_elt(s)
    (the NTT-form permutation of sk) back to s."""
    n = ctx.params.n
    elts = tuple(gal.get_elts_from_steps(steps, n))
    data = []
    for elt in elts:
        perm = torch.from_numpy(gal.make_ntt_perm(elt, n)).to(sk.device)
        data.append(_gen_kswitch_key(ctx, sk, sk[:, perm], gen))
    return GaloisKeys(torch.stack(data), elts)


def _scale_plain_up(ctx: Context, m: torch.Tensor) -> torch.Tensor:
    """BFV: m (N,) in [0, t) -> round(Ql m / t) mod q_i, (k, N) int64:
    Delta m + round(r_t m / t) with Ql = Delta t + r_t."""
    b = ctx.get_context_data(1).bfv
    t = ctx.params.plain_modulus
    q = _qcol(ctx.key_q[:len(b.delta_mod_q)])
    delta = torch.tensor(b.delta_mod_q, device=m.device).view(-1, 1)
    fix = (b.r_t * m + t // 2) // t
    return (m.view(1, -1) * delta + fix) % q


def _encrypt_bfv(ctx: Context, sk: torch.Tensor, m: torch.Tensor,
                 gen: torch.Generator) -> torch.Tensor:
    k = ctx.get_context_data(1).size_ql
    n = ctx.params.n
    qk = ctx.key_q[:k]
    q = _qcol(qk)
    rows = ctx.rows_qp[:k]
    a = smp.sample_uniform_rns(gen, n, qk)
    e = smp.lift_signed(smp.sample_error_cbd(gen, n), qk)
    a_s = ntt_inverse((a.long() * sk[:k].long() % q).int(), ctx.ntt, rows)
    c0 = (_scale_plain_up(ctx, m.long() % ctx.params.plain_modulus)
          - a_s.long() - e.long()) % q
    return torch.stack([c0.int(), ntt_inverse(a, ctx.ntt, rows)])


def _bgv_lift_plain_ntt(ctx: Context, m: torch.Tensor,
                        k: int) -> torch.Tensor:
    """BGV: m (N,) in [0, t) -> its centered lift over the first k data
    primes ([t/2, t) -> q - (t - m)), NTT form (k, N)."""
    t = ctx.params.plain_modulus
    mc = torch.where(m >= (t + 1) >> 1, m - t, m)
    return ntt_forward(smp.lift_signed(mc, ctx.key_q[:k]), ctx.ntt,
                       ctx.rows_qp[:k])


def encrypt_symmetric(ctx: Context, sk: torch.Tensor, plain: torch.Tensor,
                      gen: torch.Generator) -> torch.Tensor:
    """CKKS: plain (k, N) NTT form over the first k data primes -> (2, k,
    N), NTT form.  BFV: plain (N,), an integer polynomial taken mod t ->
    (2, size_q, N) at the first data level, coefficient form.  BGV: the
    same plain -> (2, size_q, N) at the first data level, NTT form, with
    correction factor 1."""
    scheme = ctx.params.scheme
    if scheme == "bfv":
        return _encrypt_bfv(ctx, sk, plain, gen)
    if scheme == "bgv":
        k = ctx.get_context_data(1).size_ql
        plain = _bgv_lift_plain_ntt(
            ctx, plain.long() % ctx.params.plain_modulus, k)
    k, n = plain.shape
    qk = ctx.key_q[:k]
    q = _qcol(qk)
    a = smp.sample_uniform_rns(gen, n, qk)
    e = ntt_forward(_error(ctx, gen, k), ctx.ntt, ctx.rows_qp[:k])
    c0 = (plain.long() - a.long() * sk[:k].long() - e.long()) % q
    return torch.stack([c0.int(), a])


def decrypt(ctx: Context, sk: torch.Tensor, ct: torch.Tensor,
            correction_factor: int = 1) -> torch.Tensor:
    """CKKS: (size, k, N) ciphertext -> [c0 + c1 s + c2 s^2 + ...]_Ql, the
    NTT-form plaintext (k, N).  BFV: a coefficient-form ciphertext -> the
    message (N,) in [0, t).  BGV: an NTT-form ciphertext at any built level
    and its correction factor -> the message (N,) in [0, t), int64."""
    if ctx.params.scheme == "bfv":
        return _decrypt_bfv(ctx, sk, ct)
    if ctx.params.scheme == "bgv":
        return _decrypt_bgv(ctx, sk, ct, correction_factor)
    return _dot_with_sk_powers(ctx, sk, ct)


def _decrypt_bgv(ctx: Context, sk: torch.Tensor, ct: torch.Tensor,
                 correction_factor: int) -> torch.Tensor:
    """The exact centered conversion of x = [c0 + c1 s]_Ql to {t}: convert
    x + (Ql - 1) / 2 exactly, subtract (Ql - 1) / 2 mod t, then multiply
    by the correction factor's inverse mod t."""
    k = ct.shape[1]
    p = ctx.params
    b = ctx.get_context_data(p.size_q - k + 1).bgv
    t = p.plain_modulus
    q = _qcol(ctx.key_q[:k])
    x = ntt_inverse(_dot_with_sk_powers(ctx, sk, ct), ctx.ntt,
                    ctx.rows_qp[:k])
    shifted = (x.long() + torch.tensor(b.qhalf_mod_q, device=x.device).view(
        -1, 1)) % q
    conv = bconv_exact32(shifted.int(), BaseConvConsts32(b.q_to_t).to(
        x.device))[0].long()
    m = (conv - b.qhalf_mod_t) % t
    f = correction_factor % t
    if f != 1:
        m = m * pow(f, -1, t) % t
    return m


def _decrypt_bfv(ctx: Context, sk: torch.Tensor,
                 ct: torch.Tensor) -> torch.Tensor:
    k = ct.shape[1]
    rows = ctx.rows_qp[:k]
    acc = _dot_with_sk_powers(ctx, sk, ntt_forward(ct, ctx.ntt, rows))
    ql = ctx.params.data_moduli[:k]
    big_ql = 1
    for q in ql:
        big_ql *= q
    t = ctx.params.plain_modulus
    sr = ExactScaleRound32(ql, t, big_ql, [t]).to(ct.device)
    return scale_and_round_exact32(ntt_inverse(acc, ctx.ntt, rows), sr)[0]


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

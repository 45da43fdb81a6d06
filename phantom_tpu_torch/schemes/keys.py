"""CKKS key generation, symmetric encryption and decryption.

Counterpart of the CKKS paths of phantom_tpu/schemes/keys.py.  Keys live in
NTT form over the full key base QP; the relin key holds dnum digit keys,
each an encryption of zero with P * s^2 added on its own digit's rows, and
a Galois key the same with P * sigma_elt(s) in place of P * s^2.
Randomness comes from an explicit `torch.Generator` (ops/sampling.py),
so keys match the JAX package's in structure and distribution, not bits.
Tensors are int32 residues on the generator's device; forward NTTs go
through the K2 wrapper.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..ops import sampling as smp
from ..ops.modmath32 import u32
from ..ops.ntt_kernels import ntt_forward
from . import galois as gal
from .context import Context


def _qcol(q: torch.Tensor) -> torch.Tensor:
    return u32(q).view(-1, 1)


def gen_secret_key(ctx: Context, gen: torch.Generator) -> torch.Tensor:
    """Ternary secret in NTT form over QP: (K, N)."""
    s = smp.lift_signed(smp.sample_ternary(gen, ctx.params.n), ctx.key_q)
    return ntt_forward(s, ctx.ntt)


def _encrypt_zero_symmetric_ntt(ctx: Context, sk: torch.Tensor,
                                gen: torch.Generator):
    """(c0, c1) = (-(a s + e), a) in NTT form at the key level."""
    n = ctx.params.n
    q = _qcol(ctx.key_q)
    a = smp.sample_uniform_rns(gen, n, ctx.key_q)
    e = ntt_forward(smp.lift_signed(smp.sample_error_cbd(gen, n), ctx.key_q),
                    ctx.ntt)
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


def encrypt_symmetric(ctx: Context, sk: torch.Tensor, plain: torch.Tensor,
                      gen: torch.Generator) -> torch.Tensor:
    """plain: (k, N) NTT form over the first k data primes -> (2, k, N)."""
    k, n = plain.shape
    qk = ctx.key_q[:k]
    q = _qcol(qk)
    a = smp.sample_uniform_rns(gen, n, qk)
    e = ntt_forward(smp.lift_signed(smp.sample_error_cbd(gen, n), qk),
                    ctx.ntt, ctx.ntt.all_rows()[:k])
    c0 = (plain.long() - a.long() * sk[:k].long() - e.long()) % q
    return torch.stack([c0.int(), a])


def decrypt(ctx: Context, sk: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """(size, k, N) ciphertext -> [c0 + c1 s + c2 s^2 + ...]_Ql, the NTT-form
    plaintext (k, N)."""
    k = ct.shape[1]
    q = _qcol(ctx.key_q[:k])
    s = sk[:k].long()
    acc = ct[0].long()
    s_pow = s
    for i in range(1, ct.shape[0]):
        acc = (acc + ct[i].long() * s_pow) % q
        s_pow = s_pow * s % q
    return acc.int()

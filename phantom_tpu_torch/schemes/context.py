"""Context: the NTT tables and the per-level constants of the whole
modulus chain (counterpart of phantom_tpu/schemes/context.py: CKKS, BFV
with every multiplication technique, and BGV).

Chain indexing matches the JAX package: index 0 is the key level (all of
Q and P), index 1 the first data level (all of Q, `first_data_index`), and
each next level drops one data prime, down to index size_q with one.
Every level exists from the start, but its constants (rescale, key
switch, BFV, BGV) are built on first use and cached: the NTT tables over
QP u Rl are the only eager work, and a level that is never visited costs
nothing.  Level constants are Python integers and host `BaseConverter`s,
as the JAX package's `_rescale_consts` / `_keyswitch_consts` /
`_hps_mul_consts` and scaleround.make_plain_lift_consts compute them;
Shoup words here are the host's 64-bit ones, floor(w * 2^64 / q).

BFV's auxiliary base Rl (size_q + 1 primes == 1 mod 2N below min(QP), as
the JAX package picks them) has no table of its own: the NTT tables
(`ntt`, or `ntt64` on a wide context) are ONE table over QP then Rl, and
the base D = Ql u Rl of the HPS product is table rows `BFVConsts.rows_d`
of it, so the kernels, which take (tables, rows), transform D, Ql and QlP
rows alike.  A BFV context with mul_tech "behz" also holds BEHZ's base
Bsk = B u {m_sk}, chosen as the JAX package chooses it (`bsk_base`): the
first size_q + 1 primes == 1 mod 2N outside QP, of 29 bits (61 bits where
some QP prime is 2^30 or more), B then m_sk.  Its rows follow Rl in the
same table; a level's Bsk is B[:size_ql] + [m_sk] (`BEHZConsts.rows_bsk`,
indexed like rows_d).  On a 32-bit context the Rl primes are below
min(QP), 27 or 28 bits at N = 2^16; every kernel keeps its lazy values
below 4q < 2^32 for any q < 2^30, so they need nothing else.
BFV and BGV contexts also hold `plain_ntt`, the tables mod t of the batch
encoder's slot map.

A context with a prime of 2^30 or more (`wide`, up to the reference's
61-bit bound) is the u64 evaluator's (schemes/evaluate.py, the JAX
package's generic path): it holds `ntt64`, u64 tables over QP (then Rl
and Bsk for BFV), and no 32-bit tables (`ntt` is None; `key_q` holds the
QP moduli as u64 words), and each level's u64 constants
(`ContextData.u64`, a Level64: the moduli with their Barrett words, the
rescale, key-switch and BGV constants of the JAX package's context, and
for BFV the HPS, leveled, BEHZ, plain-lift and decryption constants, as
int64 words) are built on first use on the context's device, like the
32-bit ones.  The 32-bit paths raise on it (`require_u32`).
`make_context(params, u64=True)` builds a chain of primes below 2^30 the
same way, for the u64 evaluator (as the JAX package runs its generic
path on any chain): on the same keys it gives the same residues as a
Fast32 run of the 32-bit context.
"""

from __future__ import annotations

from functools import cached_property
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import host
from ..ops import bconv as bc64
from ..ops import behz as bz64
from ..ops import polyops as po
from ..ops import scaleround as sr64
from ..ops.ntt import NTTTables64
from ..ops.ntt32 import NTTTables32, u32_tensor
from ..ops.rns_host import ModulusVec, i64_tensor, modulus_vec
from .params import EncryptionParameters

WIDE_PRIME = 1 << 30


class RescaleConsts(NamedTuple):
    qlast_inv: List[int]        # (k-1,) q_last^{-1} mod q_i
    qlast_inv_shoup: List[int]  # 64-bit Shoup words
    half: int                   # floor(q_last / 2)
    half_mod_q: List[int]       # (k-1,) half mod q_i


class KeySwitchConsts(NamedTuple):
    digit_convs: Tuple[object, ...]  # host BaseConverter, digit -> complement
    p_to_q: object                   # host BaseConverter, P -> Ql
    pinv_mod_q: List[int]
    pinv_shoup: List[int]
    modup_scale: List[int]           # n^-1 * digit QhatInv per Ql row
    modup_scale_shoup: List[int]
    # BGV's t-corrected moddown (the JAX package's bgv_extra), else None
    p_to_t: object = None            # host BaseConverter, P -> {t}
    phalf_mod_p: List[int] = None    # (P - 1) / 2 mod p_i
    phalf_mod_q: List[int] = None    # (P - 1) / 2 mod q_i
    phalf_mod_t: int = None          # (P - 1) / 2 mod t
    neg_pinv_mod_t: int = None       # [-P^-1]_t
    bigp_mod_q: List[int] = None     # P mod q_i


class BFVConsts(NamedTuple):
    """A BFV level's HPS multiplication, plain-lift and decryption
    constants (the fields of the JAX package's HPSMulConsts that HPS uses,
    and PlainLiftConsts)."""

    rl: Tuple[int, ...]              # Rl at this level: size_ql + 1 primes
    rows_d: Tuple[int, ...]          # table rows of D = Ql u Rl in ctx.ntt
    big_ql: int                      # prod(Ql)
    q_to_r: object                   # host BaseConverter, Ql -> Rl
    r_to_q: object                   # host BaseConverter, Rl -> Ql
    rl_half_mod_r: List[int]         # (Rl - 1) / 2 mod r_j
    rl_half_mod_q: List[int]         # (Rl - 1) / 2 mod q_i
    delta_mod_q: List[int]           # floor(Ql / t) mod q_i
    r_t: int                         # Ql mod t


class BEHZConsts(NamedTuple):
    """A BFV level's BEHZ base: Bsk = B[:size_ql] + [m_sk] and its table
    rows in ctx.ntt (the JAX package's tables_bsk(size_ql))."""

    bsk: Tuple[int, ...]             # B[:size_ql], then m_sk
    rows_bsk: Tuple[int, ...]        # table rows of Bsk in ctx.ntt


class BGVConsts(NamedTuple):
    """A BGV level's decryption and modulus-switch constants (the JAX
    package's BGVConsts): the exact centered conversion Ql -> {t} and the
    mod-t-preserving division by q_last."""

    q_to_t: object                   # host BaseConverter, Ql -> {t}, exact
    qhalf_mod_q: List[int]           # (Ql - 1) / 2 mod q_i
    qhalf_mod_t: int                 # (Ql - 1) / 2 mod t
    neg_qlast_inv_mod_t: Optional[int]   # [-q_last^-1]_t (None at k = 1)
    qlast_mod_qi: Optional[List[int]]    # (k-1,) q_last mod q_i


class ContextData:
    """One level of the chain: its moduli, and its constants, each built
    on first use (None where the level or the scheme has none)."""

    def __init__(self, params: EncryptionParameters, chain_index: int,
                 moduli, rl_moduli=(), bsk_moduli=(), device=None):
        self.chain_index = chain_index
        self.moduli = tuple(moduli)
        self._params = params
        self._device = device  # () -> the context's device
        self._rl_moduli = tuple(rl_moduli)
        self._bsk_moduli = tuple(bsk_moduli)

    @property
    def size_ql(self) -> int:
        return len(self.moduli)

    @property
    def _data(self) -> bool:
        return self.chain_index > 0

    @cached_property
    def rescale(self) -> Optional[RescaleConsts]:
        return _rescale_consts(self.moduli) if self._data else None

    @cached_property
    def ks(self) -> Optional[KeySwitchConsts]:
        p = self._params
        if not self._data:
            return None
        return _keyswitch_consts(self.moduli, p.special_moduli, p.n,
                                 p.plain_modulus if p.scheme == "bgv" else 0)

    @cached_property
    def bfv(self) -> Optional[BFVConsts]:
        p = self._params
        if not self._data or p.scheme != "bfv":
            return None
        return _bfv_consts(self.moduli, self._rl_moduli, p.size_qp,
                           p.plain_modulus)

    @cached_property
    def behz(self) -> Optional[BEHZConsts]:
        if not self._data or not self._bsk_moduli:
            return None
        k, p = self.size_ql, self._params
        base = p.size_qp + p.size_q + 1  # the rows after QP and Rl
        return BEHZConsts(
            bsk=self._bsk_moduli[:k] + self._bsk_moduli[-1:],
            rows_bsk=tuple(range(base, base + k)) + (base + p.size_q,))

    @cached_property
    def bgv(self) -> Optional[BGVConsts]:
        p = self._params
        if not self._data or p.scheme != "bgv":
            return None
        return _bgv_consts(self.moduli, p.plain_modulus)

    @cached_property
    def u64(self) -> "Level64":
        """The level's u64 constants on the context's device."""
        return Level64(self, self._device())


class Level64:
    """A level's u64 constants (the device half of the JAX package's
    ContextData): `mv` (Ql), `rescale`, `ks` and `bgv`, None where the
    level or the scheme has none; int64 words on `device`.  `rescale` is
    U4's table over q_0..q_{k-2} for the rescale and the modulus switch:
    w = q_last^-1 mod q_i (the division), e = floor(q_last / 2) mod q_i
    and the scalars q_last, floor(q_last / 2) (the rounding's row form).
    BFV's constants (`hps`, `leveled`, `behz`, `plain_lift`, `decrypt_sr`)
    and the samplers' tables (`t_mult`, `pow62`) are built on first use."""

    def __init__(self, cd: ContextData, device):
        self._cd = cd
        self._device = device
        self.mv = modulus_vec(cd.moduli, device)
        rc, ks, bgv = cd.rescale, cd.ks, cd.bgv
        self.rescale = None if rc is None else po.limbs(
            cd.moduli[:-1], w=rc.qlast_inv, e=rc.half_mod_q,
            scalars=(cd.moduli[-1], rc.half), device=device)
        self.ks = None if ks is None else _keyswitch_consts64(
            cd, ks, device)
        t = cd._params.plain_modulus
        self.bgv = None if bgv is None else BGVConsts64(
            q_to_t=bc64.consts_from_host(bgv.q_to_t, device),
            qhalf_mod_q=i64_tensor(bgv.qhalf_mod_q, device),
            qhalf_mod_t=bgv.qhalf_mod_t,
            t_mv=modulus_vec([t], device),
            modswitch=None if bgv.qlast_mod_qi is None else po.limbs(
                cd.moduli[:-1], w=bgv.qlast_mod_qi,
                scalars=_t_words(t, bgv.neg_qlast_inv_mod_t),
                device=device))

    @cached_property
    def hps(self) -> Optional[sr64.HPSConsts]:
        b = self._cd.bfv
        return None if b is None else _hps_consts64(
            self._cd, b, self._device)

    @cached_property
    def leveled(self) -> Optional["LeveledConsts64"]:
        cd = self._cd
        if cd.bfv is None or cd._params.mul_tech != "hps_overq_leveled":
            return None
        return _leveled_consts64(cd, self._device)

    @cached_property
    def behz(self) -> Optional[bz64.BEHZConsts]:
        cd = self._cd
        b = cd.behz
        return None if b is None else bz64.make_behz_consts(
            cd.moduli, b.bsk, cd._params.plain_modulus, cd._params.n,
            b.rows_bsk, self._device)

    @cached_property
    def plain_lift(self) -> Optional[sr64.PlainLiftConsts]:
        cd = self._cd
        return None if cd.bfv is None else sr64.make_plain_lift_consts(
            cd.moduli, cd._params.plain_modulus, self._device)

    @cached_property
    def decrypt_sr(self) -> Optional[sr64.DecryptScaleRoundConsts]:
        cd = self._cd
        return None if cd.bfv is None else sr64.make_decrypt_consts(
            cd.moduli, cd._params.plain_modulus, self._device)

    @cached_property
    def t_mult(self) -> Optional[po.Limbs]:
        """BGV's noise multiplier: U4's table with w = t mod q_i."""
        p = self._cd._params
        if p.scheme != "bgv":
            return None
        t = p.plain_modulus
        return po.limbs(self._cd.moduli, w=[t % q for q in self._cd.moduli],
                        device=self._device)

    @cached_property
    def pow62(self) -> po.Limbs:
        """The uniform sampler's table: w = 2^62 mod q_i."""
        return po.limbs(self._cd.moduli, w=[(1 << 62) % q
                                            for q in self._cd.moduli],
                        device=self._device)


class LeveledConsts64(NamedTuple):
    """HPSoverQ-leveled's tables at a level Ql below the full Q (the JAX
    package's LeveledConsts): round(Ql/Q .) Q -> Ql and round(Rl/Q .) Q ->
    Rl, the exact conversion Ql -> the dropped primes and the (Ql - 1)/2
    shifts mod Ql and mod the dropped primes (None at the first data
    level, which drops nothing)."""

    q_to_ql: Optional[sr64.ExactScaleRoundConsts]
    q_to_rl: sr64.ExactScaleRoundConsts
    ql_to_drop: Optional[bc64.BaseConvConsts]
    qlhalf_mod_ql: torch.Tensor
    qlhalf_mod_drop: Optional[torch.Tensor]


class KeySwitchConsts64(NamedTuple):
    """The JAX package's KeySwitchConsts as int64 words; `pinv` and BGV's
    `delta` are U4's tables over Ql (the moddown's P^-1, and its delta:
    w = P mod q_i, e = (P - 1) / 2 mod q_i, the scalars t, (P - 1) / 2 mod
    t, [-P^-1]_t and its Shoup word)."""

    digit_convs: Tuple[bc64.BaseConvConsts, ...]  # digit -> complement
    p_to_q: bc64.BaseConvConsts
    pinv: po.Limbs
    qlp: ModulusVec                  # Ql then P rows
    pow64_mod_qlp: torch.Tensor      # 2^64 mod each QlP prime
    modup_scale: torch.Tensor        # n^-1 * digit QhatInv per Ql row
    modup_scale_shoup: torch.Tensor
    rows_qlp: torch.Tensor           # (size_qlp,) int32 rows of QP
    p_to_t: Optional[bc64.BaseConvConsts] = None   # BGV only, below
    phalf_mod_p: Optional[torch.Tensor] = None
    delta: Optional[po.Limbs] = None


class BGVConsts64(NamedTuple):
    """`modswitch`: U4's table over q_0..q_{k-2} for the modulus switch's
    delta (w = q_last mod q_i, the scalars t, [-q_last^-1]_t and its Shoup
    word); None at k = 1."""

    q_to_t: bc64.BaseConvConsts
    qhalf_mod_q: torch.Tensor
    qhalf_mod_t: int
    t_mv: ModulusVec
    modswitch: Optional[po.Limbs]


def _t_words(t: int, *ws: int):
    """t, then each w mod t with its Shoup word floor(w 2^64 / t)."""
    return (t, *(v for w in ws for v in (w, (w << 64) // t)))


def _keyswitch_consts64(cd: ContextData, ks: KeySwitchConsts,
                        device) -> KeySwitchConsts64:
    p = cd._params
    rows = list(range(cd.size_ql)) + list(range(p.size_q, p.size_qp))
    qlp = [p.coeff_modulus[r] for r in rows]
    bgv = {}
    if ks.p_to_t is not None:
        bgv = dict(p_to_t=bc64.consts_from_host(ks.p_to_t, device),
                   phalf_mod_p=i64_tensor(ks.phalf_mod_p, device),
                   delta=po.limbs(cd.moduli, w=ks.bigp_mod_q,
                                  e=ks.phalf_mod_q,
                                  scalars=(p.plain_modulus, ks.phalf_mod_t,
                                           *_t_words(p.plain_modulus,
                                                     ks.neg_pinv_mod_t)[1:]),
                                  device=device))
    return KeySwitchConsts64(
        digit_convs=tuple(bc64.consts_from_host(c, device)
                          for c in ks.digit_convs),
        p_to_q=bc64.consts_from_host(ks.p_to_q, device),
        pinv=po.limbs(cd.moduli, w=ks.pinv_mod_q, device=device),
        qlp=modulus_vec(qlp, device),
        pow64_mod_qlp=i64_tensor([(1 << 64) % q for q in qlp], device),
        modup_scale=i64_tensor(ks.modup_scale, device),
        modup_scale_shoup=i64_tensor(ks.modup_scale_shoup, device),
        rows_qlp=torch.tensor(rows, dtype=torch.int32, device=device),
        **bgv)


def _rescale_consts(moduli) -> Optional[RescaleConsts]:
    if len(moduli) < 2:
        return None
    qlast = moduli[-1]
    rest = moduli[:-1]
    inv = [host.numth.invert_mod(qlast % q, q) for q in rest]
    half = qlast >> 1
    return RescaleConsts(
        qlast_inv=inv,
        qlast_inv_shoup=[host.compute_shoup(v, q) for v, q in zip(inv, rest)],
        half=half,
        half_mod_q=[half % q for q in rest])


def _keyswitch_consts(data_moduli, special_moduli, n: int,
                      t: int = 0) -> KeySwitchConsts:
    """t > 0 adds BGV's t-corrected moddown tables."""
    size_ql = len(data_moduli)
    alpha = len(special_moduli)
    beta = -(-size_ql // alpha)
    digit_convs = []
    modup_scale = []
    for d in range(beta):
        lo, hi = d * alpha, min((d + 1) * alpha, size_ql)
        digit = list(data_moduli[lo:hi])
        compl = list(data_moduli[:lo]) + list(data_moduli[hi:]) + list(
            special_moduli)
        base_digit = host.RNSBase(digit)
        digit_convs.append(host.BaseConverter(base_digit, host.RNSBase(compl)))
        for qi, qhi in zip(digit, base_digit.qhat_inv_mod_qi):
            modup_scale.append(host.numth.invert_mod(n, qi) * qhi % qi)
    p_base = host.RNSBase(list(special_moduli))
    big_p = p_base.prod
    pinv = [host.numth.invert_mod(big_p % q, q) for q in data_moduli]
    shoup = lambda vs: [host.compute_shoup(v, q)
                        for v, q in zip(vs, data_moduli)]
    bgv = {}
    if t:
        phalf = (big_p - 1) >> 1
        bgv = dict(
            p_to_t=host.BaseConverter(p_base, host.RNSBase([t])),
            phalf_mod_p=[phalf % p for p in special_moduli],
            phalf_mod_q=[phalf % q for q in data_moduli],
            phalf_mod_t=phalf % t,
            neg_pinv_mod_t=(t - host.numth.invert_mod(big_p % t, t)) % t,
            bigp_mod_q=[big_p % q for q in data_moduli])
    return KeySwitchConsts(
        digit_convs=tuple(digit_convs),
        p_to_q=host.BaseConverter(p_base, host.RNSBase(list(data_moduli))),
        pinv_mod_q=pinv,
        pinv_shoup=shoup(pinv),
        modup_scale=modup_scale,
        modup_scale_shoup=shoup(modup_scale), **bgv)


def _bfv_consts(data_moduli, rl_moduli, size_qp: int, t: int) -> BFVConsts:
    k = len(data_moduli)
    rl = list(rl_moduli[:k + 1])
    ql_base, rl_base = host.RNSBase(list(data_moduli)), host.RNSBase(rl)
    half = (rl_base.prod - 1) >> 1
    return BFVConsts(
        rl=tuple(rl), rows_d=tuple(range(k)) + tuple(
            range(size_qp, size_qp + k + 1)),
        big_ql=ql_base.prod,
        q_to_r=host.BaseConverter(ql_base, rl_base),
        r_to_q=host.BaseConverter(rl_base, ql_base),
        rl_half_mod_r=[half % r for r in rl],
        rl_half_mod_q=[half % q for q in data_moduli],
        delta_mod_q=[ql_base.prod // t % q for q in data_moduli],
        r_t=ql_base.prod % t)


def _bgv_consts(data_moduli, t: int) -> BGVConsts:
    base = host.RNSBase(list(data_moduli))
    half = (base.prod - 1) >> 1
    qlast = data_moduli[-1]
    last = len(data_moduli) >= 2
    return BGVConsts(
        q_to_t=host.BaseConverter(base, host.RNSBase([t])),
        qhalf_mod_q=[half % q for q in data_moduli],
        qhalf_mod_t=half % t,
        neg_qlast_inv_mod_t=((t - host.numth.invert_mod(qlast % t, t)) % t
                             if last else None),
        qlast_mod_qi=[qlast % q for q in data_moduli[:-1]] if last else None)


def _prod(moduli) -> int:
    out = 1
    for q in moduli:
        out *= q
    return out


def _hps_consts64(cd: ContextData, b: BFVConsts, device) -> sr64.HPSConsts:
    t = cd._params.plain_modulus
    ql, rl = list(cd.moduli), list(b.rl)
    d = ql + rl
    big_rl = _prod(rl)
    return sr64.HPSConsts(
        q_to_r=bc64.consts_from_host(b.q_to_r, device),
        r_to_q=bc64.consts_from_host(b.r_to_q, device),
        dbase=modulus_vec(d, device),
        rows_d=torch.tensor(b.rows_d, dtype=torch.int32, device=device),
        sr_to_r=sr64.make_exact_scale_round(d, t, b.big_ql, rl, device),
        rl_half_mod_r=i64_tensor(b.rl_half_mod_r, device),
        rl_half_mod_q=i64_tensor(b.rl_half_mod_q, device),
        sr_ql_to_rl=sr64.make_exact_scale_round(ql, big_rl, b.big_ql, rl,
                                                device),
        sr_final_overq=sr64.make_exact_scale_round(d, t, big_rl, ql,
                                                   device))


def _leveled_consts64(cd: ContextData, device) -> LeveledConsts64:
    full = list(cd._params.data_moduli)
    ql = list(cd.moduli)
    rl = list(cd.bfv.rl)
    dropped = full[len(ql):]
    big_q, big_ql = _prod(full), _prod(ql)
    qlhalf = (big_ql - 1) >> 1
    return LeveledConsts64(
        q_to_ql=sr64.make_exact_scale_round(full, big_ql, big_q, ql, device)
        if dropped else None,
        q_to_rl=sr64.make_exact_scale_round(full, _prod(rl), big_q, rl,
                                            device),
        ql_to_drop=bc64.consts_from_host(host.BaseConverter(
            host.RNSBase(ql), host.RNSBase(dropped)), device)
        if dropped else None,
        qlhalf_mod_ql=i64_tensor([qlhalf % q for q in ql], device),
        qlhalf_mod_drop=i64_tensor([qlhalf % q for q in dropped], device)
        if dropped else None)


class Context(nn.Module):
    """Parameters, the NTT tables over all of QP (and Rl for BFV; the
    tables mod t for BFV and BGV; buffers: `.to(device)` moves them) and
    chain levels 0 to size_q.  Built on the CPU; `make_context` places
    it."""

    def __init__(self, params: EncryptionParameters, u64: bool = False):
        super().__init__()
        self.params = params
        qp = list(params.coeff_modulus)
        bfv = params.scheme == "bfv"
        bgv = params.scheme == "bgv"
        t = params.plain_modulus
        self.wide = u64 or max(qp) >= WIDE_PRIME
        self.bsk_moduli = tuple(bsk_base(params)) if (
            bfv and params.mul_tech == "behz") else ()
        self.rl_moduli = tuple(host.numth.get_primes_below(
            min(qp), 2 * params.n, params.size_q + 1)) if bfv else ()
        self.ntt = self.ntt64 = None
        rows = qp + list(self.rl_moduli) + list(self.bsk_moduli)
        if self.wide:
            self.ntt64 = NTTTables64(host.make_rns_ntt_tables(params.n,
                                                              rows))
            self.register_buffer("key_q", i64_tensor(qp))
        else:
            self.ntt = NTTTables32(host.make_rns_ntt_tables(params.n, rows))
            self.register_buffer("key_q", u32_tensor(qp))
        self.plain_ntt = NTTTables32(host.make_rns_ntt_tables(
            params.n, [t])) if bfv or bgv else None
        self.register_buffer("rows_qp", torch.arange(len(qp),
                                                     dtype=torch.int32))
        if bgv and not self.wide:  # BGV's t e noise on the 32-bit paths
            # (a wide level's is Level64.t_mult): t mod each QP prime and
            # its Shoup word
            self.register_buffer("t_mod_q", u32_tensor([t % q for q in qp]))
            self.register_buffer("t_mod_q_shoup", u32_tensor(
                [(t % q << 32) // q for q in qp]))
        data = params.data_moduli
        dev = lambda: self.key_q.device  # noqa: E731
        self.chain = (ContextData(params, 0, qp, device=dev),) + tuple(
            ContextData(params, ci, data[:params.size_q + 1 - ci],
                        self.rl_moduli, self.bsk_moduli, dev)
            for ci in range(1, params.size_q + 1))

    @property
    def first_data_index(self) -> int:
        return 1

    def data_level_count(self) -> int:
        return len(self.chain) - 1

    @property
    def key_mv(self) -> ModulusVec:
        """QP with its Barrett words (u64 contexts), on the context's
        device: the tables' first size_qp rows, one ModulusVec while the
        NTT tables' buffers stay, so U4 packs its words (ModulusVec.words)
        once, not at every call; made anew when `to()` has moved the
        buffers."""
        t = self.ntt64
        held = self.__dict__.get("_key_mv")
        if held is None or held[0] is not t.q:
            k = self.params.size_qp
            held = self.__dict__["_key_mv"] = (t.q, ModulusVec(
                t.q[:k], t.ratio_lo[:k], t.ratio_hi[:k]))
        return held[1]

    def require_u32(self, what: str) -> None:
        """Raise where a 32-bit path meets a wide context."""
        if self.wide:
            raise ValueError(
                f"{what}: the 32-bit paths take primes below 2^30; this "
                "context has wider ones (the u64 evaluator, "
                "schemes/evaluate.py, runs it)")

    def require_u64(self, what: str) -> None:
        """Raise where the u64 evaluator meets a 32-bit context."""
        if not self.wide:
            raise ValueError(
                f"{what}: the u64 evaluator runs contexts with a prime of "
                "2^30 or more; this one takes the 32-bit paths (Fast32)")

    def get_context_data(self, chain_index: int) -> ContextData:
        if not 0 <= chain_index < len(self.chain):
            raise ValueError(f"chain index {chain_index} outside the chain "
                             f"(0 to {len(self.chain) - 1})")
        return self.chain[chain_index]


def bsk_base(params: EncryptionParameters) -> List[int]:
    """BEHZ's Bsk: B (size_q primes) then m_sk, the first size_q + 1 of
    the primes == 1 mod 2N that are not in QP, as the JAX package picks
    them: 29-bit where every QP prime is below 2^30 (the 32-bit paths),
    61-bit otherwise (the u64 evaluator)."""
    qp = params.coeff_modulus
    bits = 61 if max(qp) >= WIDE_PRIME else 29
    used = set(qp)
    pool = [p for p in host.numth.get_primes(
        2 * params.n, bits, params.size_q + 1 + len(qp)) if p not in used]
    return pool[:params.size_q + 1]


def resolve_device(device=None) -> torch.device:
    """The device a build function puts its buffers on: `device` if given,
    else the CUDA device; without one, pass device="cpu" to build on the
    CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to build on "
                           "the CPU")
    return torch.device("cuda")


def make_context(params: EncryptionParameters, device=None,
                 u64: bool = False) -> Context:
    """The context with its tables on `device` (default: the CUDA
    device); `u64` makes a chain of primes below 2^30 the u64 evaluator's
    (a wide context)."""
    return Context(params, u64).to(resolve_device(device))


def qlp_rows(ctx: Context, size_ql: int) -> List[int]:
    """Rows of the QlP base inside the full QP key base."""
    p = ctx.params
    return list(range(size_ql)) + list(range(p.size_q, p.size_qp))

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
the JAX package picks them) has no table of its own: `ntt` is ONE
NTTTables32 over QP then Rl, and the base D = Ql u Rl of the HPS product
is table rows `BFVConsts.rows_d` of it, so the kernels, which take
(tables, rows), transform D, Ql and QlP rows alike.  The Rl primes are
below min(QP), 27 or 28 bits at N = 2^16; every kernel keeps its lazy
values below 4q < 2^32 for any q < 2^30, so they need nothing else.
A BFV context with mul_tech "behz" also holds BEHZ's base Bsk = B u
{m_sk}, chosen as the JAX package chooses it: the first size_q + 1
29-bit primes == 1 mod 2N outside QP, B then m_sk.  Its rows follow Rl
in `ntt`; a level's Bsk is B[:size_ql] + [m_sk] (`BEHZConsts.rows_bsk`,
indexed like rows_d).  Where some QP prime is 2^30 or more the JAX
package takes 61-bit Bsk primes, which no 32-bit residue holds, so the
port raises there.
BFV and BGV contexts also hold `plain_ntt`, the tables mod t of the batch
encoder's slot map.
"""

from __future__ import annotations

from functools import cached_property
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import host
from ..ops.ntt32 import NTTTables32, u32_tensor
from .params import EncryptionParameters


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
                 moduli, rl_moduli=(), bsk_moduli=()):
        self.chain_index = chain_index
        self.moduli = tuple(moduli)
        self._params = params
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


class Context(nn.Module):
    """Parameters, the NTT tables over all of QP (and Rl for BFV; the
    tables mod t for BFV and BGV; buffers: `.to(device)` moves them) and
    chain levels 0 to size_q.  Built on the CPU; `make_context` places
    it."""

    def __init__(self, params: EncryptionParameters):
        super().__init__()
        self.params = params
        qp = list(params.coeff_modulus)
        bfv = params.scheme == "bfv"
        bgv = params.scheme == "bgv"
        t = params.plain_modulus
        self.rl_moduli = tuple(host.numth.get_primes_below(
            min(qp), 2 * params.n, params.size_q + 1)) if bfv else ()
        self.bsk_moduli = tuple(bsk_base(params)) if (
            bfv and params.mul_tech == "behz") else ()
        self.ntt = NTTTables32(host.make_rns_ntt_tables(
            params.n, qp + list(self.rl_moduli) + list(self.bsk_moduli)))
        self.plain_ntt = NTTTables32(host.make_rns_ntt_tables(
            params.n, [t])) if bfv or bgv else None
        self.register_buffer("key_q", u32_tensor(qp))
        self.register_buffer("rows_qp", torch.arange(len(qp),
                                                     dtype=torch.int32))
        if bgv:  # t mod each QP prime and its Shoup word: BGV's t e noise
            self.register_buffer("t_mod_q", u32_tensor([t % q for q in qp]))
            self.register_buffer("t_mod_q_shoup", u32_tensor(
                [(t % q << 32) // q for q in qp]))
        data = params.data_moduli
        self.chain = (ContextData(params, 0, qp),) + tuple(
            ContextData(params, ci, data[:params.size_q + 1 - ci],
                        self.rl_moduli, self.bsk_moduli)
            for ci in range(1, params.size_q + 1))

    @property
    def first_data_index(self) -> int:
        return 1

    def data_level_count(self) -> int:
        return len(self.chain) - 1

    def get_context_data(self, chain_index: int) -> ContextData:
        if not 0 <= chain_index < len(self.chain):
            raise ValueError(f"chain index {chain_index} outside the chain "
                             f"(0 to {len(self.chain) - 1})")
        return self.chain[chain_index]


def bsk_base(params: EncryptionParameters) -> List[int]:
    """BEHZ's Bsk: B (size_q primes) then m_sk, the first size_q + 1 of
    the 29-bit primes == 1 mod 2N that are not in QP, as the JAX package
    picks them for 32-bit parameters.  It raises where some QP prime is
    2^30 or more: the JAX package then takes 61-bit Bsk primes, which the
    port's 32-bit residues cannot hold."""
    qp = params.coeff_modulus
    if max(qp) >= 1 << 30:
        raise ValueError("BEHZ with a QP prime of 2^30 or more needs 61-bit "
                         "Bsk primes; the port's residues are 32-bit")
    used = set(qp)
    pool = [p for p in host.numth.get_primes(
        2 * params.n, 29, params.size_q + 1 + len(qp)) if p not in used]
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


def make_context(params: EncryptionParameters, device=None) -> Context:
    """The context with its tables on `device` (default: the CUDA
    device)."""
    return Context(params).to(resolve_device(device))


def qlp_rows(ctx: Context, size_ql: int) -> List[int]:
    """Rows of the QlP base inside the full QP key base."""
    p = ctx.params
    return list(range(size_ql)) + list(range(p.size_q, p.size_qp))

"""Context: the QP NTT tables and the per-level constants of the first
levels (counterpart of phantom_tpu/schemes/context.py, CKKS subset).

Chain indexing matches the JAX package: index 0 is the key level (all of
Q and P), index 1 the first data level (all of Q), and each next level
drops one data prime.  Only the levels a mult+relin+rescale step from
level 1 touches are built (0 to 2).  Level constants are Python
integers and host `BaseConverter`s, as the JAX package's
`_rescale_consts` / `_keyswitch_consts` compute them; Shoup words here are
the host's 64-bit ones, floor(w * 2^64 / q).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import host
from ..ops.ntt32 import NTTTables32, u32_tensor
from .params import EncryptionParameters

LEVELS = 3  # chain indices 0 (key level), 1 (step input), 2 (step output)


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


@dataclass(frozen=True)
class ContextData:
    chain_index: int
    moduli: Tuple[int, ...]
    rescale: Optional[RescaleConsts]
    ks: Optional[KeySwitchConsts]

    @property
    def size_ql(self) -> int:
        return len(self.moduli)


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


def _keyswitch_consts(data_moduli, special_moduli, n: int) -> KeySwitchConsts:
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
    return KeySwitchConsts(
        digit_convs=tuple(digit_convs),
        p_to_q=host.BaseConverter(p_base, host.RNSBase(list(data_moduli))),
        pinv_mod_q=pinv,
        pinv_shoup=shoup(pinv),
        modup_scale=modup_scale,
        modup_scale_shoup=shoup(modup_scale))


class Context(nn.Module):
    """Parameters, the NTT tables over all of QP (buffers: `.to(device)`
    moves them) and chain levels 0 to LEVELS - 1.  Built on the CPU;
    `make_context` places it."""

    def __init__(self, params: EncryptionParameters):
        super().__init__()
        self.params = params
        qp = list(params.coeff_modulus)
        self.ntt = NTTTables32(host.make_rns_ntt_tables(params.n, qp))
        self.register_buffer("key_q", u32_tensor(qp))
        chain = [ContextData(0, tuple(qp), None, None)]
        data = list(params.data_moduli)
        for lvl in range(min(LEVELS, params.size_q + 1) - 1):
            ql = data[:len(data) - lvl]
            chain.append(ContextData(
                chain_index=lvl + 1, moduli=tuple(ql),
                rescale=_rescale_consts(ql),
                ks=_keyswitch_consts(ql, params.special_moduli, params.n)))
        self.chain = tuple(chain)

    def get_context_data(self, chain_index: int) -> ContextData:
        if chain_index >= len(self.chain):
            raise ValueError(f"chain index {chain_index} was not built "
                             f"({len(self.chain)} levels)")
        return self.chain[chain_index]


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

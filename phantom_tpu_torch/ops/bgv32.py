"""The BGV multiply + relinearize + modulus-switch step on 32-bit residues.

Counterpart of phantom_tpu/ops/bgv32.py (BGVPipeline32, build_bgv32,
bgv_mult_relin32, bgv_mod_switch32, bgv_mult_relin_modswitch32): the 2x2
tensor product in NTT form, the hybrid key switch of c2 with BGV's
t-corrected moddown (KeySwitch32 built on a BGV context), and the
mod-t-preserving division by q_last.  On the default engine:

  tensor product                plain torch
  key switch of c2              pipeline32.keyswitch_from_ntt32 on the
                                KeySwitch32's modup route ("auto": K1, K4
                                at alpha <= 8, else K1, K5 per digit, K2,
                                K9), then per half K1 over the P rows, K5
                                to Ql and to {t}, K2 with (x - .) P^-1
  modulus switch                K1 of the last limb, the reductions mod t
                                and mod q_i in plain torch, K2 over Ql-1
                                with (x - .) q_last^-1 in its epilogue

Ciphertexts are (2, size_ql, N) int32 in NTT form.  Correction factors
stay host integers that the caller tracks, as in the JAX package: the
step's output carries f1 f2 q_last^-1 mod t.  The output is bit-equal to
the JAX package's bgv_mult_relin_modswitch32.
"""

from __future__ import annotations

import torch
from torch import nn

from .ntt32 import u32_tensor
from .pipeline32 import (DEFAULT_ENGINE, KERNELS, Kernels, KeySwitch32,
                         _fwd, _inv, _qcol, _rows, _tensor_2x2,
                         convert_key32, keyswitch_from_ntt32)
from ..schemes.context import Context, resolve_device


class BGVPipeline32(nn.Module):
    """The step's state at one level: the key-switch tables with BGV's
    t-correction on a modup route, the relin evk (beta, 2, size_qlp, N)
    and the modulus switch's constants.  `ks`: the level's KeySwitch32 to
    share, else one is built; evk may be None where only the modulus switch
    runs.  Calling it runs bgv_mult_relin_modswitch32."""

    def __init__(self, ctx: Context, evk: torch.Tensor, chain_index: int = 1,
                 engine: str = DEFAULT_ENGINE, modup: str = "auto",
                 ks: KeySwitch32 = None):
        super().__init__()
        cd = ctx.get_context_data(chain_index)
        if cd.bgv is None:
            raise ValueError("BGVPipeline32 needs a BGV context")
        if engine != DEFAULT_ENGINE:
            raise ValueError(f"the BGV step runs on the {DEFAULT_ENGINE!r} "
                             f"engine only so far, not {engine!r}")
        if cd.bgv.qlast_mod_qi is None:
            raise ValueError("the modulus switch needs two data primes")
        self.ks = KeySwitch32(ctx, chain_index, engine, modup) if ks is None \
            else ks
        k = self.ks.size_ql
        rc = cd.rescale
        self.t = ctx.params.plain_modulus
        self.neg_qlast_inv_mod_t = cd.bgv.neg_qlast_inv_mod_t
        self.register_buffer("evk", evk)
        self.register_buffer("rows_ql_next", _rows(range(k - 1)))
        self.register_buffer("qlast_mod_qi", u32_tensor(cd.bgv.qlast_mod_qi))
        self.register_buffer("qlast_inv", u32_tensor(rc.qlast_inv))
        self.register_buffer("qlast_inv_shoup", u32_tensor(
            [s >> 32 for s in rc.qlast_inv_shoup]))

    def forward(self, d1: torch.Tensor, d2: torch.Tensor,
                ops: Kernels = KERNELS) -> torch.Tensor:
        return bgv_mult_relin_modswitch32(self, d1, d2, ops)


def build_bgv32(ctx: Context, rlk: torch.Tensor, chain_index: int = 1,
                device=None, engine: str = DEFAULT_ENGINE,
                modup: str = "auto") -> BGVPipeline32:
    """rlk: the relin key (dnum, 2, K, N) over QP of a BGV context; engine
    "mxu-pallas" only so far; modup one of pipeline32.MODUP_ROUTES ("xla"
    is "xla-split" here, as in the JAX package: K4's preconv form serves
    the CKKS step only)."""
    return BGVPipeline32(ctx, convert_key32(ctx, rlk, chain_index),
                         chain_index, engine, modup).to(
                             resolve_device(device))


def bgv_mult_relin32(p: BGVPipeline32, d1: torch.Tensor, d2: torch.Tensor,
                     ops: Kernels = KERNELS) -> torch.Tensor:
    """d1, d2: (2, size_ql, N) int32 NTT form -> (2, size_ql, N): the
    tensor product, c2 key-switched and folded into c0, c1.  The caller
    multiplies the correction factors mod t."""
    ks = p.ks
    q = _qcol(ks.mv_ql.q)
    c0, c1, c2 = _tensor_2x2(q, d1, d2)
    sw = keyswitch_from_ntt32(ks, c2.int(), p.evk, ops)
    return torch.stack([(c0 + sw[0]) % q, (c1 + sw[1]) % q]).int()


def bgv_mod_switch32(p: BGVPipeline32, x: torch.Tensor,
                     ops: Kernels = KERNELS) -> torch.Tensor:
    """Drop q_last keeping the value mod t: (size, k, N) NTT form ->
    (size, k - 1, N).  delta = c_last + u q_last with u = [-c_last
    q_last^-1]_t, so delta == c_last (mod q_last) and == 0 (mod t); the
    output is (x - delta) q_last^-1 over Ql-1.  The caller multiplies the
    correction factor by q_last^-1 mod t."""
    ks = p.ks
    k = ks.size_ql
    c_last = _inv(ks, x[:, k - 1:k].contiguous(), ks.rows_ql[k - 1:k],
                  ops).long()
    u = c_last % p.t * p.neg_qlast_inv_mod_t % p.t
    q = _qcol(ks.mv_ql.q[:k - 1])
    delta = ((c_last % q + u * _qcol(p.qlast_mod_qi)) % q).int()
    return _fwd(ks, delta, p.rows_ql_next, ops,
                sub_from=x[:, :k - 1].contiguous(), epi_scale=p.qlast_inv,
                epi_scale_shoup=p.qlast_inv_shoup)


def bgv_mult_relin_modswitch32(p: BGVPipeline32, d1: torch.Tensor,
                               d2: torch.Tensor,
                               ops: Kernels = KERNELS) -> torch.Tensor:
    """The BGV headline step: (2, size_ql, N) x 2 -> (2, size_ql - 1, N),
    NTT form; the output's correction factor is f1 f2 q_last^-1 mod t."""
    return bgv_mod_switch32(p, bgv_mult_relin32(p, d1, d2, ops), ops)

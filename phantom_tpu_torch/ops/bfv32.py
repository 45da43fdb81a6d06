"""The BFV HPS multiply + relinearize step on 32-bit residues.

Counterpart of phantom_tpu/ops/bfv32.py:30-202 (BFVPipeline32,
build_bfv32, bfv_mult32, _scale_and_round_hps32, bfv_relin32,
bfv_mult_relin32) with the JAX package's default lift (PHANTOM_BFV_LIFT
unset), on the engine its KeySwitch32 was built for:

  lift Ql -> D = Ql u Rl        K5 (exact conversion Ql -> Rl), per poly
  forward NTT over D            K2, or K6 on "pallas-roll"
  tensor product                plain torch
  inverse NTT over D            K1, or K6
  round(t/Ql .) D -> Ql, x3     K5 twice each (omega matmul, then the exact
                                Rl -> Ql conversion), the fraction cascade
                                in plain torch (ops/scaleround32.py)
  relinearize                   pipeline32.keyswitch32 on c2, then the
                                inverse NTT of the switched pair (K1 or K6)

The layout stays flat (L, N), so the JAX package's _blocked_step, a TPU
tiling, has no counterpart, and every conversion is K5.  Ciphertexts are
in coefficient form.  The step's output is bit-equal to the JAX
package's bfv_mult_relin32 on both engines.
"""

from __future__ import annotations

import torch
from torch import nn

from .bconv32 import BaseConvConsts32, ModulusVec32, bconv_exact32
from .pipeline32 import (DEFAULT_ENGINE, KERNELS, Kernels, KeySwitch32,
                         _fwd, _inv, _qcol, _rows, convert_key32,
                         keyswitch32)
from .ntt32 import u32_tensor
from .scaleround32 import ExactScaleRound32, scale_and_round_exact32
from ..schemes.context import Context, resolve_device


class BFVPipeline32(nn.Module):
    """The HPS step's state at one level: the key-switch tables on the
    pipeline's engine, the relin evk (beta, 2, size_qlp, N), the D rows of
    the context's NTT tables, the Ql -> Rl lift, the D -> Rl
    scale-and-round, the Rl -> Ql conversion and the centering constants.
    `ks`: the level's KeySwitch32 to share, else one is built.  Calling it
    runs bfv_mult_relin32."""

    def __init__(self, ctx: Context, evk: torch.Tensor, chain_index: int = 1,
                 engine: str = DEFAULT_ENGINE, ks: KeySwitch32 = None):
        super().__init__()
        cd = ctx.get_context_data(chain_index)
        b = cd.bfv
        if b is None:
            raise ValueError("BFVPipeline32 needs a BFV context")
        self.ks = KeySwitch32(ctx, chain_index, engine) if ks is None else ks
        self.register_buffer("evk", evk)
        self.register_buffer("rows_d", _rows(b.rows_d))
        self.mv_d = ModulusVec32(list(cd.moduli) + list(b.rl))
        self.q_to_r = BaseConvConsts32(b.q_to_r)
        self.r_to_q = BaseConvConsts32(b.r_to_q)
        self.sr_to_r = ExactScaleRound32(list(cd.moduli) + list(b.rl),
                                         ctx.params.plain_modulus, b.big_ql,
                                         b.rl)
        self.register_buffer("rl_half_mod_r", u32_tensor(b.rl_half_mod_r))
        self.register_buffer("rl_half_mod_q", u32_tensor(b.rl_half_mod_q))

    def forward(self, d1: torch.Tensor, d2: torch.Tensor,
                ops: Kernels = KERNELS) -> torch.Tensor:
        return bfv_mult_relin32(self, d1, d2, ops)


def build_bfv32(ctx: Context, rlk: torch.Tensor, chain_index: int = 1,
                engine: str = DEFAULT_ENGINE, device=None) -> BFVPipeline32:
    """rlk: the relin key (dnum, 2, K, N) over QP; engine: "mxu-pallas"
    (the default) or "pallas-roll"."""
    return BFVPipeline32(ctx, convert_key32(ctx, rlk, chain_index),
                         chain_index, engine).to(resolve_device(device))


def _scale_and_round_hps32(p: BFVPipeline32, x_d: torch.Tensor,
                           ops: Kernels = KERNELS) -> torch.Tensor:
    """round((t/Ql) x) : D -> Ql through the exact Rl intermediate with the
    centered half-shift: (k_d, N) -> (size_ql, N)."""
    w_r = scale_and_round_exact32(x_d, p.sr_to_r, ops.fold_matmul)
    rl = _qcol(p.sr_to_r.obase.q)
    shifted = (w_r.long() + _qcol(p.rl_half_mod_r)) % rl
    conv = bconv_exact32(shifted.int(), p.r_to_q, ops.fold_matmul)
    return ((conv.long() - _qcol(p.rl_half_mod_q))
            % _qcol(p.r_to_q.obase.q)).int()


def _lift(p: BFVPipeline32, d: torch.Tensor, ops: Kernels) -> torch.Tensor:
    """(2, size_ql, N) over Ql -> (2, k_d, N) over D: each poly's exact
    conversion to Rl below its Ql rows."""
    return torch.stack([torch.cat([x, bconv_exact32(x, p.q_to_r,
                                                    ops.fold_matmul)])
                        for x in d])


def bfv_mult32(p: BFVPipeline32, d1: torch.Tensor, d2: torch.Tensor,
               ops: Kernels = KERNELS) -> torch.Tensor:
    """d1, d2: (2, size_ql, N) int32 coefficient form -> (3, size_ql, N):
    the HPS tensor product scaled by t/Ql and rounded."""
    ab = _fwd(p.ks, torch.stack([_lift(p, d1, ops), _lift(p, d2, ops)]),
              p.rows_d, ops)
    prod = _inv(p.ks, _tensor_2x2(p, ab), p.rows_d, ops)
    return torch.stack([_scale_and_round_hps32(p, x, ops) for x in prod])


def _tensor_2x2(p: BFVPipeline32, ab: torch.Tensor) -> torch.Tensor:
    """(a0, a1) x (b0, b1) over D, NTT form: (2, 2, k_d, N) ->
    (a0 b0, a0 b1 + a1 b0, a1 b1), (3, k_d, N)."""
    a, b = ab[0].long(), ab[1].long()
    q = _qcol(p.mv_d.q)
    return torch.stack([a[0] * b[0] % q,
                        (a[0] * b[1] + a[1] * b[0]) % q,
                        a[1] * b[1] % q]).int()


def bfv_relin32(p: BFVPipeline32, d3: torch.Tensor,
                ops: Kernels = KERNELS) -> torch.Tensor:
    """(3, size_ql, N) coefficient form -> (2, size_ql, N): key-switch c2
    and fold it into c0, c1."""
    ks = p.ks
    switched = _inv(ks, keyswitch32(ks, d3[2], p.evk, ops), ks.rows_ql, ops)
    q = _qcol(ks.mv_ql.q)
    return ((d3[:2].long() + switched) % q).int()


def bfv_mult_relin32(p: BFVPipeline32, d1: torch.Tensor, d2: torch.Tensor,
                     ops: Kernels = KERNELS) -> torch.Tensor:
    """The fused multiply + relinearize: (2, size_ql, N) x 2 ->
    (2, size_ql, N), coefficient form."""
    return bfv_relin32(p, bfv_mult32(p, d1, d2, ops), ops)

"""The coefficient-sharded CKKS, BGV and BFV steps on u64 words
(counterpart of phantom_tpu/parallel/pipeline_sharded.py).

Each rank holds the (2, size_ql, n1, c2) block of both operands
(mesh.shard_coeff) and its slice of the relin key, (beta, 2, size_qlp,
n1, c2).  The JAX package's 3D helpers (_tensor_2x2_3, _bconv_approx3,
_bconv_exact3, _sr_exact3, _inner_product3, _moddown_delta3) are
coefficient-local mirrors of the u64 evaluator's functions, so here the
evaluator's own run on the block viewed as (rows, n1 c2): U2 for the
conversions and BFV's exact scale-and-round, U3 for the inner product,
U4 for the products, the moddown's (x - delta) P^-1 + c, BGV's
t-corrected delta and the rescale's and the modulus switch's row forms.
The NTTs are the sharded ones (ntt_sharded.py: P1 and the all-to-alls in
place of U1), each over every row it transforms at once (both halves of
the moddown, both polys of the rescale).  Each step is bit-identical to
the u64 evaluator's on the whole ciphertext:

  sharded_mult_relin_rescale        rescale_to_next(multiply_and_relin)
  sharded_bgv_mult_relin_modswitch  mod_switch_to_next(multiply_and_relin)
  sharded_bfv_mult_relin            multiply_and_relin, HPS, coefficient
                                    form (the relinearization's key
                                    switch on the coefficient form)

Every function takes `ops`: keyswitch.KERNELS64 (P1 and U2-U4) or
PLAIN64 (their plain versions).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import bconv as bc
from ..ops import polyops as po
from ..ops import scaleround as sr
from ..schemes import evaluate as ev
from ..schemes.keyswitch import (KERNELS64, Kernels64, _moddown_delta,
                                 evk_rows, inner_product_evk)
from .mesh import CoeffMesh, coeff_split, shard_coeff
from .ntt_sharded import (ntt_forward_sharded, ntt_inverse_sharded,
                          prepare_sharded_tables)


class ShardedPipelineConsts(nn.Module):
    """One level's constants: the level (its u64 consts, ContextData.u64),
    the sharded tables of the context's base (QP, and Rl, Bsk where it
    has them), its rows, and the rank's slice of the relin key, evk
    (beta, 2, size_qlp, n1, c2)."""

    def __init__(self, ctx, rlk: torch.Tensor, mesh: CoeffMesh,
                 chain_index: int = 1):
        super().__init__()
        ctx.require_u64("the sharded u64 step")
        self.cd = ctx.get_context_data(chain_index)
        self.n1, self.n2 = coeff_split(ctx.params.n, mesh)
        self.size_ql = self.cd.size_ql
        self.size_q = ctx.params.size_q
        self.size_p = ctx.params.size_p
        self.st = prepare_sharded_tables(ctx.ntt64)
        self.register_buffer("rows_qp", ctx.rows_qp.clone())
        self.register_buffer("evk", shard_coeff(
            evk_rows(ctx, rlk.to(ctx.rows_qp.device), self.cd), mesh))

    @property
    def lv(self):
        return self.cd.u64


def build_sharded_consts(ctx, rlk: torch.Tensor, mesh: CoeffMesh,
                         chain_index: int = 1) -> ShardedPipelineConsts:
    """rlk: the relin key (dnum, 2, K, N) over QP (int64 words); the
    constants on the mesh's device (the context's level constants stay
    on the context's)."""
    return ShardedPipelineConsts(ctx, rlk, mesh, chain_index).to(
        mesh.device)


class _Ntt:
    """The sharded transforms of one step over (..., rows, n1 c2)
    blocks: the consts' tables, the mesh and the kernel bundle whose
    ntt_phase runs them."""

    def __init__(self, c: ShardedPipelineConsts, mesh, ops: Kernels64):
        self.c, self.mesh, self.ops = c, mesh, ops

    def fwd(self, x, rows):
        return ntt_forward_sharded(x, self.c.st, self.mesh, rows, self.ops)

    def inv(self, x, rows):
        return ntt_inverse_sharded(x, self.c.st, self.mesh, rows,
                                   ops=self.ops)


def _modup(c: ShardedPipelineConsts, t: _Ntt, c2: torch.Tensor,
           ops: Kernels64) -> torch.Tensor:
    """c2 (size_ql, cols) coefficient form -> (beta, size_qlp, cols) NTT
    form: per digit U2's approximate conversion to its complement, the
    digit's rows between, one sharded forward of every digit."""
    ks = c.lv.ks
    out = []
    for d, conv in enumerate(ks.digit_convs):
        lo = d * c.size_p
        hi = min(lo + c.size_p, c.size_ql)
        x = c2[lo:hi]
        compl = bc.bconv_approx(x, conv, ops.bconv)
        out.append(torch.cat([compl[:lo], x, compl[lo:]]))
    return t.fwd(torch.stack(out), ks.rows_qlp)


def _keyswitch_product(c, t, c2, ops):
    """(2, size_qlp, cols): the modup of a coefficient-form c2 times the
    key (U3)."""
    cols = c2.shape[-1]
    beta, _, kp = c.evk.shape[:3]
    return inner_product_evk(_modup(c, t, c2, ops),
                             c.evk.reshape(beta, 2, kp, cols), c.cd, ops)


def _moddown_pair(c, t, s, ops, adds=None):
    """Both halves of (2, size_qlp, cols) down to Ql, NTT form: the P
    rows' inverse (one call), the delta over both halves' columns (U2;
    BGV's t-corrected by U4), its forward (one call), U4's (x - .) P^-1
    plus `adds` (2, size_ql, cols) or nothing."""
    ks = c.lv.ks
    k, alpha = c.size_ql, c.size_p
    cols = s.shape[-1]
    x_p = t.inv(s[:, k:].contiguous(),
                c.rows_qp[c.size_q:c.size_q + alpha])
    delta = _moddown_delta(ks, x_p.transpose(0, 1).reshape(alpha, 2 * cols),
                           ops)
    delta = delta.reshape(k, 2, cols).transpose(0, 1).contiguous()
    delta = t.fwd(delta, c.rows_qp[:k])
    return ops.shoup_rns(s[:, :k], ks.pinv, delta, adds)


def _relin(c, t, d1, d2, ops):
    """The tensor product (U4) and the relinearization of its c2, c0 and
    c1 added in the moddown's U4: (2, size_ql, cols) NTT form."""
    prod = ops.tensor_prod_2x2(d1, d2, c.lv.mv)
    c2 = t.inv(prod[2], c.rows_qp[:c.size_ql])
    return _moddown_pair(c, t, _keyswitch_product(c, t, c2, ops), ops,
                         prod[:2])


def _flat(c, d):
    return d.reshape(2, c.size_ql, -1)


def sharded_mult_relin_rescale(c: ShardedPipelineConsts, mesh: CoeffMesh,
                               d1: torch.Tensor, d2: torch.Tensor,
                               ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """d1, d2: the rank's (2, size_ql, n1, c2) int64 blocks, NTT form ->
    (2, size_ql - 1, n1, c2), the rescaled product."""
    t = _Ntt(c, mesh, ops)
    k = c.size_ql
    x = _relin(c, t, _flat(c, d1), _flat(c, d2), ops)
    lw = c.lv.rescale
    xl = t.inv(x[:, k - 1:k].contiguous(), c.rows_qp[k - 1:k])
    delta = t.fwd(ops.rescale_delta(xl, lw), c.rows_qp[:k - 1])
    out = ops.shoup_rns(x[:, :k - 1], lw, delta)
    return out.reshape(d1.shape[0], k - 1, *d1.shape[2:])


def sharded_bgv_mult_relin_modswitch(c: ShardedPipelineConsts,
                                     mesh: CoeffMesh, d1: torch.Tensor,
                                     d2: torch.Tensor,
                                     ops: Kernels64 = KERNELS64
                                     ) -> torch.Tensor:
    """BGV: the product, relinearized with the t-corrected moddown, then
    switched down a prime (delta == c mod q_last, == 0 mod t; exact
    division).  The caller tracks the correction factor, as the
    evaluator does (it picks up q_last^-1 mod t)."""
    t = _Ntt(c, mesh, ops)
    k = c.size_ql
    x = _relin(c, t, _flat(c, d1), _flat(c, d2), ops)
    c_last = t.inv(x[:, k - 1:k].contiguous(), c.rows_qp[k - 1:k])
    delta = t.fwd(ops.modswitch_delta(c_last, c.lv.bgv.modswitch),
                  c.rows_qp[:k - 1])
    out = ops.shoup_rns(x[:, :k - 1], c.lv.rescale, delta)
    return out.reshape(d1.shape[0], k - 1, *d1.shape[2:])


class BFVShardedConsts(nn.Module):
    """The CKKS/BGV constants of the level and its HPS tables (the lift
    Ql -> Rl, the base D = Ql u Rl and its rows, round(t/Ql .) and the
    conversion back)."""

    def __init__(self, base: ShardedPipelineConsts):
        super().__init__()
        self.base = base
        self.hps = base.lv.hps


def build_bfv_sharded_consts(ctx, rlk: torch.Tensor, mesh: CoeffMesh,
                             chain_index: int = 1) -> BFVShardedConsts:
    base = build_sharded_consts(ctx, rlk, mesh, chain_index)
    bc.check_rows(2 * base.size_ql + 1, "the sharded BFV multiply (hps)")
    return BFVShardedConsts(base)


def sharded_bfv_mult_relin(bc3: BFVShardedConsts, mesh: CoeffMesh,
                           d1: torch.Tensor, d2: torch.Tensor,
                           ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """BFV HPS multiply + relinearize, coefficient form: (2, size_ql, n1,
    c2) -> the same.  Both operands lifted to D (U2 exact), one forward
    over D of all four polys, the tensor product (U4), one inverse of the
    three, round(t/Ql .) back to Ql (U2's scale_round, then exact), the
    key switch of the third on its coefficient form and one inverse of
    both switched halves, added (plain torch)."""
    c = bc3.base
    hps = bc3.hps
    t = _Ntt(c, mesh, ops)
    k = c.size_ql
    a = ev._lift_d(_flat(c, d1), hps, ops)
    b = ev._lift_d(_flat(c, d2), hps, ops)
    ab = t.fwd(torch.cat([a, b]), hps.rows_d)
    prod = t.inv(ops.tensor_prod_2x2(ab[:2], ab[2:], hps.dbase), hps.rows_d)
    outs = torch.stack([sr.scale_and_round_hps(x, hps, ops.bconv)
                        for x in prod])
    md = _moddown_pair(c, t, _keyswitch_product(c, t, outs[2], ops), ops)
    sw = t.inv(md, c.rows_qp[:k])
    return po.add_rns(outs[:2], sw, c.lv.mv).reshape(d1.shape)


def build_sharded_step(ctx, rlk: torch.Tensor, mesh: CoeffMesh,
                       chain_index: int = 1):
    """(consts, step): the step of the context's scheme over the rank's
    (B / dp, 2, size_ql, n1, c2) items (mesh.shard_batch of a (B, 2,
    size_ql, N) batch): CKKS sharded_mult_relin_rescale (the JAX
    package's step), BGV sharded_bgv_mult_relin_modswitch, BFV
    sharded_bfv_mult_relin."""
    scheme = ctx.params.scheme
    if scheme == "bfv":
        consts = build_bfv_sharded_consts(ctx, rlk, mesh, chain_index)
        fn = sharded_bfv_mult_relin
    else:
        consts = build_sharded_consts(ctx, rlk, mesh, chain_index)
        fn = (sharded_mult_relin_rescale if scheme == "ckks"
              else sharded_bgv_mult_relin_modswitch)

    def step(d1, d2, ops=KERNELS64):
        return torch.stack([fn(consts, mesh, a, b, ops)
                            for a, b in zip(d1, d2)])
    return consts, step

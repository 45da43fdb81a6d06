"""BFV multiply (+ relinearize) on 32-bit residues, by each of the JAX
package's four techniques.

Counterpart of phantom_tpu/ops/bfv32.py (BFVPipeline32, build_bfv32,
bfv_mult32, the HPSoverQ functions, BFVBehz32, BFVLeveled32 and their
multiplies, _lift_ntt_fused) on the engine its KeySwitch32 was built for.
Ciphertexts are in coefficient form; every output is bit-equal to the
JAX package's on both engines.

HPS (bfv_mult32, bfv_mult_relin32):
  lift Ql -> D = Ql u Rl        K5 (exact conversion Ql -> Rl), per poly
  forward NTT over D            K2, or K6 on "pallas-roll"
  tensor product                plain torch
  inverse NTT over D            K1, or K6
  round(t/Ql .) D -> Ql, x3     K5 twice each (omega matmul, then the exact
                                Rl -> Ql conversion), the fraction cascade
                                in plain torch (ops/scaleround32.py)
  with lift="kernel" (the JAX package's PHANTOM_BFV_LIFT=kernel) the four
  lifts and the forward NTT are one K3 over all D rows: the exact
  conversion of the pre-scaled y = x QhatInv with the floor sum v, whose
  Ql rows give back x (Q = 0 mod q_j)
HPSoverQ (bfv_mult_hps_overq32): d1 lifts as above; each poly of d2
  becomes w = round(Rl/Ql x) over Rl (K5) and its exact conversion to Ql
  (K5); after the product, round(t/Rl .) D -> Ql (K5), x3
HPSoverQ-leveled (BFVLeveled32): as HPSoverQ at level 1 + lvl, where the
  noise model (host/noise.py) or `force_lvl` sets lvl; d1's polys first
  scale to Ql (round(Ql/Q .), K5), d2's to Rl from the full Q; the
  product expands back to Q by the centered exact conversion of Ql to the
  dropped primes (K5)
BEHZ (BFVBehz32): each poly lifts to Bsk by the small Montgomery
  reduction (K5 Ql -> Bsk, ops/behz32.py); forward NTTs over Ql and over
  Bsk (K2 each, or K6), the tensor products, the inverse NTTs (K1 each,
  or K6), times t; then per poly the fast floor by Q in Bsk (K5 Ql ->
  Bsk) and Shenoy-Kumaresan's conversion back to Ql (K5 B -> Ql and
  B -> {m_sk})
relinearize (each technique): pipeline32.keyswitch32 on c2, then the
  inverse NTT of the switched pair (K1 or K6), at the level's key switch
  (leveled: the full level's)

The layout stays flat (L, N), so the JAX package's _blocked_step, a TPU
tiling, has no counterpart, and every conversion is K5.  The
elementwise stages (the tensor products, the scale-and-rounds' fraction
cascades, BEHZ's corrections) are plain int64 torch, as they are XLA in
the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import host
from . import behz32 as bz
from .bconv32 import (BaseConvConsts32, ModulusVec32, bconv_exact32,
                      floor_sum_div32, scale_by_qhat_inv32)
from .pipeline32 import (DEFAULT_ENGINE, KERNELS, Kernels, KeySwitch32,
                         _fwd, _inv, _qcol, _rows, convert_key32,
                         keyswitch32)
from .ntt32 import u32_tensor
from .scaleround32 import ExactScaleRound32, scale_and_round_exact32
from ..schemes.context import Context, resolve_device

LIFTS = ("xla", "kernel")  # the HPS lift: K5 per poly and K2, or one K3


def _prod(moduli) -> int:
    out = 1
    for q in moduli:
        out *= int(q)
    return out


class BFVPipeline32(nn.Module):
    """The HPS and HPSoverQ state at one level: the key-switch tables on
    the pipeline's engine, the relin evk (beta, 2, size_qlp, N), the D
    rows of the context's NTT tables, the Ql -> Rl lift, the D -> Rl
    scale-and-round, the Rl -> Ql conversion and the centering constants;
    HPSoverQ's Ql -> Rl and D -> Ql scale-and-rounds; the fused lift's
    (size_d, size_ql) matrix [Qhat_i mod d_j] and vmul [0 | Ql mod r_j].
    `ks`: the level's KeySwitch32 to share, else one is built; `lift`
    (LIFTS): "kernel" runs HPS's lift and forward NTT as one K3, on the
    default engine only.  Calling it runs bfv_mult_relin32."""

    def __init__(self, ctx: Context, evk: torch.Tensor, chain_index: int = 1,
                 engine: str = DEFAULT_ENGINE, ks: KeySwitch32 = None,
                 lift: str = "xla"):
        super().__init__()
        cd = ctx.get_context_data(chain_index)
        b = cd.bfv
        if b is None:
            raise ValueError("BFVPipeline32 needs a BFV context")
        if lift not in LIFTS:
            raise ValueError(f"lift {lift!r} not in {LIFTS}")
        if lift == "kernel" and engine != DEFAULT_ENGINE:
            raise ValueError(f"lift=\"kernel\" runs K3, on the "
                             f"{DEFAULT_ENGINE!r} engine only")
        self.lift = lift
        self.ks = KeySwitch32(ctx, chain_index, engine) if ks is None else ks
        self.register_buffer("evk", evk)
        self.register_buffer("rows_d", _rows(b.rows_d))
        ql, rl = list(cd.moduli), list(b.rl)
        t = ctx.params.plain_modulus
        big_rl = _prod(rl)
        self.mv_d = ModulusVec32(ql + rl)
        self.q_to_r = BaseConvConsts32(b.q_to_r)
        self.r_to_q = BaseConvConsts32(b.r_to_q)
        self.sr_to_r = ExactScaleRound32(ql + rl, t, b.big_ql, rl)
        self.register_buffer("rl_half_mod_r", u32_tensor(b.rl_half_mod_r))
        self.register_buffer("rl_half_mod_q", u32_tensor(b.rl_half_mod_q))
        self.sr_ql_to_rl = ExactScaleRound32(ql, big_rl, b.big_ql, rl)
        self.sr_final_overq = ExactScaleRound32(ql + rl, t, big_rl, ql)
        # the conversion of x = sum_i y_i Qhat_i - v Q to every D row: on
        # the Ql rows Qhat_i = 0 mod q_j (i != j) and Q = 0, so it gives x
        ql_to_ql = host.BaseConverter(host.RNSBase(ql), host.RNSBase(ql))
        self.register_buffer("lift_mats", u32_tensor(
            ql_to_ql.qhat_mod_p + b.q_to_r.qhat_mod_p))
        self.register_buffer("lift_vmul", u32_tensor(
            [0] * len(ql) + b.q_to_r.q_mod_p))

    def forward(self, d1: torch.Tensor, d2: torch.Tensor,
                ops: Kernels = KERNELS) -> torch.Tensor:
        return bfv_mult_relin32(self, d1, d2, ops)


def build_bfv32(ctx: Context, rlk: torch.Tensor, chain_index: int = 1,
                engine: str = DEFAULT_ENGINE, device=None,
                lift: str = "xla") -> BFVPipeline32:
    """rlk: the relin key (dnum, 2, K, N) over QP; engine: "mxu-pallas"
    (the default) or "pallas-roll"; lift: LIFTS."""
    return BFVPipeline32(ctx, convert_key32(ctx, rlk, chain_index),
                         chain_index, engine, lift=lift).to(
                             resolve_device(device))


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


def _lift(p, d: torch.Tensor, ops: Kernels) -> torch.Tensor:
    """(2, size_ql, N) over Ql -> (2, k_d, N) over D: each poly's exact
    conversion to Rl below its Ql rows."""
    return torch.stack([torch.cat([x, bconv_exact32(x, p.q_to_r,
                                                    ops.fold_matmul)])
                        for x in d])


def _lift_ntt_fused(p: BFVPipeline32, polys: torch.Tensor,
                    ops: Kernels = KERNELS) -> torch.Tensor:
    """(P, size_ql, N) coefficient form -> (P, k_d, N), NTT form over D, in
    one K3: each D row is the exact conversion sum_i y_i Qhat_i - v Q of
    the pre-scaled y = x QhatInv (the scale and the floor sums v in plain
    torch)."""
    c = p.q_to_r
    y = torch.stack([scale_by_qhat_inv32(x, c) for x in polys])
    v = torch.stack([floor_sum_div32(yy, c) for yy in y])
    mats = p.lift_mats.expand((polys.shape[0],) + tuple(p.lift_mats.shape))
    return ops.bconv_ntt_forward(y, mats.contiguous(), p.ks.ntt, p.rows_d,
                                 v=v, vmul=p.lift_vmul)


def _tensor_2x2(mv: ModulusVec32, ab: torch.Tensor) -> torch.Tensor:
    """(a0, a1) x (b0, b1) in NTT form over mv's base: (2, 2, k, N) ->
    (a0 b0, a0 b1 + a1 b0, a1 b1), (3, k, N)."""
    a, b = ab[0].long(), ab[1].long()
    q = _qcol(mv.q)
    return torch.stack([a[0] * b[0] % q,
                        (a[0] * b[1] + a[1] * b[0]) % q,
                        a[1] * b[1] % q]).int()


def _product_d(p, a: torch.Tensor, b: torch.Tensor,
               ops: Kernels) -> torch.Tensor:
    """The tensor product over D of two lifted operands (2, k_d, N) in
    coefficient form: one forward NTT of both, the product, the inverse:
    (3, k_d, N)."""
    ab = _fwd(p.ks, torch.stack([a, b]), p.rows_d, ops)
    return _inv(p.ks, _tensor_2x2(p.mv_d, ab), p.rows_d, ops)


def bfv_mult32(p: BFVPipeline32, d1: torch.Tensor, d2: torch.Tensor,
               ops: Kernels = KERNELS) -> torch.Tensor:
    """HPS.  d1, d2: (2, size_ql, N) int32 coefficient form ->
    (3, size_ql, N): the tensor product scaled by t/Ql and rounded."""
    if p.lift == "kernel":
        ab = _lift_ntt_fused(p, torch.cat([d1, d2]), ops)
        ab = ab.view((2, 2) + tuple(ab.shape[1:]))
        prod = _inv(p.ks, _tensor_2x2(p.mv_d, ab), p.rows_d, ops)
    else:
        prod = _product_d(p, _lift(p, d1, ops), _lift(p, d2, ops), ops)
    return torch.stack([_scale_and_round_hps32(p, x, ops) for x in prod])


def bfv_relin32(p, d3: torch.Tensor, ops: Kernels = KERNELS) -> torch.Tensor:
    """(3, size_ql, N) coefficient form -> (2, size_ql, N): key-switch c2
    and fold it into c0, c1 (any technique's pipeline: its ks and evk)."""
    ks = p.ks
    switched = _inv(ks, keyswitch32(ks, d3[2], p.evk, ops), ks.rows_ql, ops)
    q = _qcol(ks.mv_ql.q)
    return ((d3[:2].long() + switched) % q).int()


def bfv_mult_relin32(p: BFVPipeline32, d1: torch.Tensor, d2: torch.Tensor,
                     ops: Kernels = KERNELS) -> torch.Tensor:
    """HPS's fused multiply + relinearize: (2, size_ql, N) x 2 ->
    (2, size_ql, N), coefficient form."""
    return bfv_relin32(p, bfv_mult32(p, d1, d2, ops), ops)


# ---------------------------------------------------------------------------
# HPSoverQ
# ---------------------------------------------------------------------------

def _lift_over(p, d: torch.Tensor, sr: ExactScaleRound32,
               ops: Kernels) -> torch.Tensor:
    """d2's side of HPSoverQ: each poly to w = round(Rl x / Q) over Rl
    (`sr`), then over D as [w mod Ql | w] (the exact Rl -> Ql
    conversion)."""
    out = []
    for x in d:
        w_rl = scale_and_round_exact32(x, sr, ops.fold_matmul)
        out.append(torch.cat([bconv_exact32(w_rl, p.r_to_q,
                                            ops.fold_matmul), w_rl]))
    return torch.stack(out)


def bfv_mult_hps_overq32(p: BFVPipeline32, d1: torch.Tensor,
                         d2: torch.Tensor,
                         ops: Kernels = KERNELS) -> torch.Tensor:
    """HPSoverQ: the 1/Ql scaling moves onto d2 before the tensor product,
    then round(t/Rl .) back to Ql: (2, size_ql, N) x 2 -> (3, size_ql,
    N)."""
    prod = _product_d(p, _lift(p, d1, ops),
                      _lift_over(p, d2, p.sr_ql_to_rl, ops), ops)
    return torch.stack([scale_and_round_exact32(x, p.sr_final_overq,
                                                ops.fold_matmul)
                        for x in prod])


def bfv_mult_relin_overq32(p: BFVPipeline32, d1: torch.Tensor,
                           d2: torch.Tensor,
                           ops: Kernels = KERNELS) -> torch.Tensor:
    return bfv_relin32(p, bfv_mult_hps_overq32(p, d1, d2, ops), ops)


# ---------------------------------------------------------------------------
# BEHZ
# ---------------------------------------------------------------------------

class BFVBehz32(nn.Module):
    """BEHZ's state at one level (the JAX package's BFVBehz32): the
    key-switch tables on the pipeline's engine, the relin evk, the BEHZ
    tables (ops/behz32.py) and the Bsk rows of the context's NTT tables.
    Needs a context built with mul_tech "behz".  Calling it runs
    bfv_mult_relin_behz32."""

    def __init__(self, ctx: Context, evk: torch.Tensor, chain_index: int = 1,
                 engine: str = DEFAULT_ENGINE, ks: KeySwitch32 = None):
        super().__init__()
        cd = ctx.get_context_data(chain_index)
        if cd.behz is None:
            raise ValueError("BFVBehz32 needs a BFV context with mul_tech "
                             "\"behz\"")
        self.ks = KeySwitch32(ctx, chain_index, engine) if ks is None else ks
        self.register_buffer("evk", evk)
        self.behz = bz.BEHZConsts32(cd.moduli, cd.behz.bsk,
                                    ctx.params.plain_modulus)
        self.register_buffer("rows_bsk", _rows(cd.behz.rows_bsk))

    def forward(self, d1: torch.Tensor, d2: torch.Tensor,
                ops: Kernels = KERNELS) -> torch.Tensor:
        return bfv_mult_relin_behz32(self, d1, d2, ops)


def build_bfv_behz32(ctx: Context, rlk: torch.Tensor, chain_index: int = 1,
                     engine: str = DEFAULT_ENGINE, device=None) -> BFVBehz32:
    """rlk: the relin key (dnum, 2, K, N) over QP of a "behz" context."""
    return BFVBehz32(ctx, convert_key32(ctx, rlk, chain_index), chain_index,
                     engine).to(resolve_device(device))


def bfv_mult_behz32(p: BFVBehz32, d1: torch.Tensor, d2: torch.Tensor,
                    ops: Kernels = KERNELS) -> torch.Tensor:
    """BEHZ: lift to Ql u Bsk with SmMRq, the tensor products in both
    bases, times t, the floor of the division by Ql in Bsk, and
    Shenoy-Kumaresan back to Ql: (2, size_ql, N) x 2 -> (3, size_ql, N)."""
    ks, c = p.ks, p.behz
    ab_q = torch.stack([d1, d2])
    ab_bsk = torch.stack([torch.stack([bz.sm_mrq32(x, c, ops.fold_matmul)
                                       for x in d]) for d in (d1, d2)])
    ab_q = _fwd(ks, ab_q, ks.rows_ql, ops)
    ab_bsk = _fwd(ks, ab_bsk, p.rows_bsk, ops)
    prod_q = _inv(ks, _tensor_2x2(ks.mv_ql, ab_q), ks.rows_ql, ops)
    prod_bsk = _inv(ks, _tensor_2x2(c.bsk, ab_bsk), p.rows_bsk, ops)
    tq = prod_q.long() * _qcol(c.t_mod_q) % _qcol(ks.mv_ql.q)
    tbsk = prod_bsk.long() * _qcol(c.t_mod_bsk) % _qcol(c.bsk.q)
    return torch.stack([
        bz.fastbconv_sk32(bz.fast_floor32(tq[i].int(), tbsk[i].int(), c,
                                          ops.fold_matmul),
                          c, ops.fold_matmul) for i in range(3)])


def bfv_mult_relin_behz32(p: BFVBehz32, d1: torch.Tensor, d2: torch.Tensor,
                          ops: Kernels = KERNELS) -> torch.Tensor:
    return bfv_relin32(p, bfv_mult_behz32(p, d1, d2, ops), ops)


# ---------------------------------------------------------------------------
# HPSoverQ-leveled
# ---------------------------------------------------------------------------

class BFVLeveled32(nn.Module):
    """HPSoverQ-leveled's state at a fixed level drop `lvl` (the JAX
    package's BFVLeveled32): the full level's key switch and evk; D = Ql u
    Rl at chain index 1 + lvl with its rows, lift and conversion back;
    round(t/Rl .) D -> Ql, round(Rl/Q .) Q -> Rl; with lvl > 0 also
    round(Ql/Q .) Q -> Ql, the conversion Ql -> the dropped primes and
    the centering constants (Ql - 1) / 2.  Calling it runs
    bfv_mult_relin_leveled32."""

    def __init__(self, ctx: Context, evk: torch.Tensor, lvl: int,
                 engine: str = DEFAULT_ENGINE, ks: KeySwitch32 = None):
        super().__init__()
        p = ctx.params
        cd = ctx.get_context_data(1 + lvl)
        b = cd.bfv
        if b is None:
            raise ValueError("BFVLeveled32 needs a BFV context")
        self.lvl = lvl
        self.ks = KeySwitch32(ctx, 1, engine) if ks is None else ks
        self.register_buffer("evk", evk)
        self.register_buffer("rows_d", _rows(b.rows_d))
        full, ql, rl = list(p.data_moduli), list(cd.moduli), list(b.rl)
        t = p.plain_modulus
        big_q, big_rl = _prod(full), _prod(rl)
        self.mv_d = ModulusVec32(ql + rl)
        self.q_to_r = BaseConvConsts32(b.q_to_r)
        self.r_to_q = BaseConvConsts32(b.r_to_q)
        self.sr_final = ExactScaleRound32(ql + rl, t, big_rl, ql)
        self.q_to_rl = ExactScaleRound32(full, big_rl, big_q, rl)
        if lvl:
            dropped = full[len(ql):]
            half = (b.big_ql - 1) >> 1
            self.q_to_ql = ExactScaleRound32(full, b.big_ql, big_q, ql)
            self.ql_to_drop = BaseConvConsts32(host.BaseConverter(
                host.RNSBase(ql), host.RNSBase(dropped)))
            self.register_buffer("qlhalf_mod_ql", u32_tensor(
                [half % q for q in ql]))
            self.register_buffer("qlhalf_mod_drop", u32_tensor(
                [half % q for q in dropped]))

    def forward(self, d1: torch.Tensor, d2: torch.Tensor,
                ops: Kernels = KERNELS) -> torch.Tensor:
        return bfv_mult_relin_leveled32(self, d1, d2, ops)


def levels_to_drop(ctx: Context, noise_scale_deg: int = 1) -> int:
    """The noise model's drop for operands of `noise_scale_deg` at chain
    index 1 (the JAX package's call of find_levels_to_drop)."""
    p = ctx.params
    beta = len(ctx.get_context_data(1).ks.digit_convs)
    dcrt_bits = max(q.bit_length() for q in p.data_moduli)
    return host.noise.find_levels_to_drop(
        p.n, p.size_q, p.size_p, beta, p.plain_modulus, dcrt_bits,
        noise_scale_deg - 1, False, True)


def build_bfv_leveled32(ctx: Context, rlk: torch.Tensor,
                        noise_scale_deg: int = 1,
                        engine: str = DEFAULT_ENGINE, device=None,
                        force_lvl: int = None) -> BFVLeveled32:
    """rlk: the relin key (dnum, 2, K, N) over QP; the drop is
    levels_to_drop(ctx, noise_scale_deg) unless `force_lvl` gives it."""
    lvl = levels_to_drop(ctx, noise_scale_deg) if force_lvl is None \
        else force_lvl
    return BFVLeveled32(ctx, convert_key32(ctx, rlk, 1), lvl, engine).to(
        resolve_device(device))


def bfv_mult_leveled32(p: BFVLeveled32, d1: torch.Tensor, d2: torch.Tensor,
                       ops: Kernels = KERNELS) -> torch.Tensor:
    """HPSoverQ-leveled: d1 scaled from the full Q down to Ql, d2 to Rl,
    the product over D at the dropped level, round(t/Rl .) to Ql, and with
    a drop the centered exact expansion back to Q: (2, size_q, N) x 2 ->
    (3, size_q, N)."""
    if p.lvl:
        d1 = torch.stack([scale_and_round_exact32(x, p.q_to_ql,
                                                  ops.fold_matmul)
                          for x in d1])
    prod = _product_d(p, _lift(p, d1, ops), _lift_over(p, d2, p.q_to_rl, ops),
                      ops)
    out = [scale_and_round_exact32(x, p.sr_final, ops.fold_matmul)
           for x in prod]
    if p.lvl:
        ql = _qcol(p.sr_final.obase.q)
        drop_q = _qcol(p.ql_to_drop.obase.q)
        expanded = []
        for w in out:
            shifted = (w.long() + _qcol(p.qlhalf_mod_ql)) % ql
            drop = bconv_exact32(shifted.int(), p.ql_to_drop,
                                 ops.fold_matmul)
            drop = (drop.long() - _qcol(p.qlhalf_mod_drop)) % drop_q
            expanded.append(torch.cat([w, drop.int()]))
        out = expanded
    return torch.stack(out)


def bfv_mult_relin_leveled32(p: BFVLeveled32, d1: torch.Tensor,
                             d2: torch.Tensor,
                             ops: Kernels = KERNELS) -> torch.Tensor:
    return bfv_relin32(p, bfv_mult_leveled32(p, d1, d2, ops), ops)

"""Hybrid key switching, rotations and the CKKS multiply + relinearize +
rescale step on 32-bit residues.

Counterpart of phantom_tpu/ops/pipeline32.py on its default engine, with
its two modup structures, chosen as the JAX package chooses them: by the
special base's size alpha against KERNEL_BCONV_ALPHA_MAX = 8.

  alpha <= 8, the fused route:
    modup + evk inner product       K1 iNTT (x n^-1 QhatInv), K4
    modup alone (hoisted rotations) K1, K3 with the digit rows passed
                                    through
  alpha > 8, the xla-split route (the headline: N = 2^16, alpha = 22):
    modup                           K1, K5 per digit, K2 over the
                                    complement rows, the digit rows
                                    spliced back
    inner product                   K9
  on both:
    moddown pair                    K1 over the P rows emitting the floor
                                    correction v, then K3: exact P -> Ql
                                    conversion, forward NTT, (x - .) P^-1
    rescale                         K1 of the last limb, + half, then K3
                                    with alpha = 1, post_sub, * q_last^-1
  the CKKS step's epilogue, fixed when its pipeline is built:
    the pair (default)              the moddown pair, then rescale
    moddown_rows=R                  K1, then K8 (R output rows per block)
                                    for the pair, then rescale
    merged_epilogue=True            K1, then K7: the pair and the rescale
                                    with one forward NTT per row

The CKKS step on the fused route never stores the tensor term c2 = d1[1]
d2[1]: K1 computes it in its prologue (mul_by) and K4 again in its
passthrough rows; the xla-split route computes it in plain torch.  The
terms c0 and c1 ride the moddown's epilogue (tensor_add) on both.
Rotations permute NTT-form ciphertexts with a gather (the evaluation order
out[k] = p(psi^(2 rev(k)+1)) turns sigma_g into an index permutation) and
key-switch c1; the hoisted forms share one modup over all steps, and K9
reads it through each step's permutation.

Every function takes `ops`, the kernels it calls: `KERNELS` (the default)
dispatches each to its CUDA kernel or, for CPU tensors, its plain version;
`PLAIN` forces the plain versions on any device, which is how the kernels
are checked against them on the card.  Residues are int32 tensors in
[0, q); the layout is flat (L, N).  The build_* functions put their
buffers on the CUDA device unless `device` says otherwise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from . import (bconv_kernels, ip_kernels, moddown_kernels, modup_ip_kernels,
               ntt_kernels)
from .bconv32 import BaseConvConsts32, ModulusVec32, matmul_reduce32
from .modmath32 import u32
from .ntt32 import u32_tensor
from ..schemes import galois as gal
from ..schemes.context import Context, qlp_rows, resolve_device

# the JAX package's default: the fused modup (K4, K3 self rows) up to this
# special-base size, the xla-split modup above it (KeySwitch32.fused_modup)
KERNEL_BCONV_ALPHA_MAX = 8


class Kernels(NamedTuple):
    ntt_inverse: Callable        # K1
    ntt_forward: Callable        # K2
    bconv_ntt_forward: Callable  # K3
    fold_matmul: Callable        # K5
    modup_ip: Callable           # K4
    inner_product: Callable      # K9
    moddown_rows: Callable       # K8
    moddown_rescale: Callable    # K7


KERNELS = Kernels(ntt_kernels.ntt_inverse, ntt_kernels.ntt_forward,
                  ntt_kernels.bconv_ntt_forward, bconv_kernels.fold_matmul,
                  modup_ip_kernels.modup_ip, ip_kernels.inner_product,
                  moddown_kernels.moddown_rows,
                  moddown_kernels.moddown_rescale)
PLAIN = Kernels(ntt_kernels.ntt_inverse_plain, ntt_kernels.ntt_forward_plain,
                ntt_kernels.bconv_ntt_forward_plain,
                bconv_kernels.fold_matmul_plain,
                modup_ip_kernels.modup_ip_plain,
                ip_kernels.inner_product_plain,
                moddown_kernels.moddown_rows_plain,
                moddown_kernels.moddown_rescale_plain)


def _rows(idx) -> torch.Tensor:
    return torch.tensor(list(idx), dtype=torch.int32)


def _qcol(q: torch.Tensor) -> torch.Tensor:
    return u32(q).view(-1, 1)


class KeySwitch32(nn.Module):
    """u32 tables for hybrid key switching at one level: the QP NTT tables
    with the row indices of Ql, P, QlP and the concatenated per-digit
    complement rows, the conversion constants, the fused modup matrices
    and the fused scales.  Holds no key material."""

    def __init__(self, ctx: Context, chain_index: int = 1):
        super().__init__()
        cd = ctx.get_context_data(chain_index)
        ks = cd.ks
        k = cd.size_ql
        alpha = ctx.params.size_p
        beta = len(ks.digit_convs)
        n = ctx.params.n
        rows = qlp_rows(ctx, k)
        qp = ctx.params.coeff_modulus
        self.size_ql, self.size_p, self.beta = k, alpha, beta
        self.ntt = ctx.ntt
        self.mv_ql = ModulusVec32(cd.moduli)
        self.mv_qlp = ModulusVec32([qp[r] for r in rows])
        self.digit_convs = nn.ModuleList(
            BaseConvConsts32(c) for c in ks.digit_convs)
        self.p_to_q = BaseConvConsts32(ks.p_to_q)
        # the moddown conversion matrix for both key-switch halves
        self.register_buffer("moddown_mat", self.p_to_q.qhat_mod_p.expand(
            2, -1, -1).contiguous())
        self.register_buffer("rows_ql", _rows(rows[:k]))
        self.register_buffer("rows_p", _rows(rows[k:]))
        self.register_buffer("rows_qlp", _rows(rows))
        compl, sizes = [], []
        # fused modup: digit d's (size_qlp, alpha) conversion matrix, zero
        # rows inside the digit and zero columns past a short last digit
        mats = np.zeros((beta, k + alpha, alpha), dtype=np.uint32)
        for d in range(beta):
            lo, hi = d * alpha, min((d + 1) * alpha, k)
            r = list(range(lo)) + list(range(hi, k + alpha))
            compl += [rows[i] for i in r]
            sizes.append(len(r))
            src = np.array(ks.digit_convs[d].qhat_mod_p, dtype=np.uint32)
            mats[d, :lo, :hi - lo] = src[:lo]
            mats[d, hi:, :hi - lo] = src[lo:]
        self.register_buffer("rows_compl", _rows(compl))
        self.compl_sizes = tuple(sizes)
        self.register_buffer("modup_mats", u32_tensor(mats))
        self.register_buffer("pinv", u32_tensor(ks.pinv_mod_q))
        self.register_buffer("pinv_shoup", u32_tensor(
            [s >> 32 for s in ks.pinv_shoup]))
        self.register_buffer("modup_scale", u32_tensor(ks.modup_scale))
        self.register_buffer("modup_scale_shoup", u32_tensor(
            [s >> 32 for s in ks.modup_scale_shoup]))
        # (x - delta) * P^-1 moddown: n^-1 * PhatInv folded into the P-rows
        # inverse NTT
        special = ctx.params.special_moduli
        md = [v * pow(n, -1, p) % p
              for v, p in zip(ks.p_to_q.ibase.qhat_inv_mod_qi, special)]
        self.register_buffer("moddown_scale", u32_tensor(md))
        self.register_buffer("moddown_scale_shoup", u32_tensor(
            [(s << 32) // p for s, p in zip(md, special)]))

    @property
    def fused_modup(self) -> bool:
        """The modup route, set by alpha alone: fused (K4, K3 self rows) up
        to KERNEL_BCONV_ALPHA_MAX, xla-split above."""
        return self.size_p <= KERNEL_BCONV_ALPHA_MAX


def build_keyswitch32(ctx: Context, chain_index: int = 1,
                      device=None) -> KeySwitch32:
    return KeySwitch32(ctx, chain_index).to(resolve_device(device))


def convert_key32(ctx: Context, key_data: torch.Tensor,
                  chain_index: int = 1) -> torch.Tensor:
    """(dnum, 2, K, N) key over QP -> (beta, 2, size_qlp, N) at this
    level."""
    cd = ctx.get_context_data(chain_index)
    rows = torch.tensor(qlp_rows(ctx, cd.size_ql), device=key_data.device)
    beta = len(cd.ks.digit_convs)
    return key_data[:beta].index_select(2, rows).contiguous()


def _pad_digit_rows(ks: KeySwitch32, x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the limb axis from size_ql to beta * alpha rows: a short
    last digit's pad rows contribute nothing and are never digit rows."""
    pad = ks.beta * ks.size_p - ks.size_ql
    if pad == 0:
        return x.contiguous()
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def modup_xla32(ks: KeySwitch32, y: torch.Tensor, c2_ntt: torch.Tensor,
                ops: Kernels = KERNELS) -> torch.Tensor:
    """y: the pre-scaled iNTT rows (size_ql, N); c2_ntt: the NTT-form input.
    Per digit the complement rows convert (K5) and only those transform, in
    one forward NTT over all digits (K2); the digit's own rows splice back
    in NTT form.  Returns (beta, size_qlp, N)."""
    k, alpha = ks.size_ql, ks.size_p
    compl = [matmul_reduce32(y[d * alpha:min((d + 1) * alpha, k)],
                             ks.digit_convs[d], ops.fold_matmul)
             for d in range(ks.beta)]
    tn = ops.ntt_forward(torch.cat(compl), ks.ntt, ks.rows_compl)
    out = []
    off = 0
    for d in range(ks.beta):
        lo, hi = d * alpha, min((d + 1) * alpha, k)
        part = tn[off:off + ks.compl_sizes[d]]
        off += ks.compl_sizes[d]
        out.append(torch.cat([part[:lo], c2_ntt[lo:hi], part[lo:]]))
    return torch.stack(out)


def _modup_inverse(ks: KeySwitch32, c2_ntt: torch.Tensor, ops: Kernels,
                   mul_by=None) -> torch.Tensor:
    """K1: the iNTT of the Ql rows scaled by n^-1 * QhatInv."""
    return ops.ntt_inverse(c2_ntt, ks.ntt, ks.rows_ql, scale=ks.modup_scale,
                           scale_shoup=ks.modup_scale_shoup, mul_by=mul_by)


def modup_from_ntt32(ks: KeySwitch32, c2_ntt: torch.Tensor,
                     ops: Kernels = KERNELS) -> torch.Tensor:
    """(size_ql, N) NTT form -> the modup tensor (beta, size_qlp, N), NTT
    form.  At alpha <= 8 one K3 converts and transforms every QlP row of
    every digit, the digit's own rows passed through; above, modup_xla32."""
    y = _modup_inverse(ks, c2_ntt, ops)
    if not ks.fused_modup:
        return modup_xla32(ks, y, c2_ntt, ops)
    yp = _pad_digit_rows(ks, y)
    return ops.bconv_ntt_forward(
        yp.view(ks.beta, ks.size_p, -1), ks.modup_mats, ks.ntt, ks.rows_qlp,
        self_rows=_pad_digit_rows(ks, c2_ntt), k_data=ks.size_ql)


def inner_product32(ks: KeySwitch32, t_modup: torch.Tensor,
                    evk: torch.Tensor, ops: Kernels = KERNELS, perm=None):
    """(s0, s1) = sum_d t_d evk[d] mod q over QlP, exact for any beta (K9).
    perm: a gather index over the coefficients of t (a hoisted rotation's
    NTT-form permutation), which K9 applies as it reads t."""
    s = ops.inner_product(t_modup, evk, ks.mv_qlp.q, perm)
    return s[0], s[1]


def _modup_ip_split(ks: KeySwitch32, c2_ntt: torch.Tensor, evk: torch.Tensor,
                    ops: Kernels = KERNELS):
    """modup_ip32 on the xla-split route at any alpha: modup_xla32, then
    inner_product32."""
    y = _modup_inverse(ks, c2_ntt, ops)
    return inner_product32(ks, modup_xla32(ks, y, c2_ntt, ops), evk, ops)


def modup_ip32(ks: KeySwitch32, c2_ntt: torch.Tensor, evk: torch.Tensor,
               ops: Kernels = KERNELS):
    """Modup and the evk inner product: (s0, s1), each (size_qlp, N).  At
    alpha <= 8 one K4 launch after the modup iNTT (the modup tensor never
    exists in memory); above, _modup_ip_split."""
    if not ks.fused_modup:
        return _modup_ip_split(ks, c2_ntt, evk, ops)
    y = _modup_inverse(ks, c2_ntt, ops)
    s = ops.modup_ip(_pad_digit_rows(ks, y), ks.modup_mats,
                     _pad_digit_rows(ks, c2_ntt), evk, ks.ntt, ks.rows_qlp,
                     k_data=ks.size_ql)
    return s[0], s[1]


def _moddown_inputs(ks: KeySwitch32, xs, ops: Kernels):
    """K1 over the G x alpha P rows of G = len(xs) <= 2 inputs (size_qlp,
    N), emitting the floor correction v; returns (y, v, the Ql rows)."""
    k = ks.size_ql
    xp = torch.stack([x[k:] for x in xs])
    sub = torch.stack([x[:k] for x in xs])
    y, v = ops.ntt_inverse(xp, ks.ntt, ks.rows_p, scale=ks.moddown_scale,
                           scale_shoup=ks.moddown_scale_shoup,
                           emit_floor_div=(ks.p_to_q.U, ks.p_to_q.V))
    return y, v, sub


def _moddown(ks: KeySwitch32, xs, tensor_add, ops: Kernels,
             rows_per_block=None) -> torch.Tensor:
    """G = len(xs) <= 2 inputs (size_qlp, N) -> (G, size_ql, N): K1, then
    one K3 over G x size_ql outputs, or with rows_per_block (G = 2) one K8
    serving that many output rows per block."""
    y, v, sub = _moddown_inputs(ks, xs, ops)
    if rows_per_block is not None:
        return ops.moddown_rows(y, ks.p_to_q.qhat_mod_p, v, ks.p_to_q.q_mod_p,
                                sub, tensor_add, ks.ntt, ks.rows_ql, ks.pinv,
                                ks.pinv_shoup, rows_per_block)
    return ops.bconv_ntt_forward(
        y, ks.moddown_mat[:len(xs)], ks.ntt, ks.rows_ql, v=v,
        vmul=ks.p_to_q.q_mod_p, sub_from=sub, epi_scale=ks.pinv,
        epi_scale_shoup=ks.pinv_shoup, tensor_add=tensor_add)


def moddown32(ks: KeySwitch32, x: torch.Tensor,
              ops: Kernels = KERNELS) -> torch.Tensor:
    """(x_Ql - delta(x_P)) * P^-1 over Ql, NTT form in and out:
    (size_qlp, N) -> (size_ql, N)."""
    return _moddown(ks, [x], None, ops)[0]


def moddown32_pair(ks: KeySwitch32, x0: torch.Tensor, x1: torch.Tensor,
                   tensor_add=None, ops: Kernels = KERNELS):
    """moddown32 of both key-switch halves in one K1 and one K3 launch,
    bit-identical to two moddown32 calls.  tensor_add = (d1, d2) adds the
    relin tensor terms c0 and c1 in K3's epilogue."""
    out = _moddown(ks, [x0, x1], tensor_add, ops)
    return out[0], out[1]


def keyswitch_from_ntt32(ks: KeySwitch32, c2_ntt: torch.Tensor,
                         evk: torch.Tensor,
                         ops: Kernels = KERNELS) -> torch.Tensor:
    """Hybrid key switch of an NTT-form (size_ql, N) polynomial ->
    (2, size_ql, N)."""
    s0, s1 = modup_ip32(ks, c2_ntt, evk, ops)
    return torch.stack(moddown32_pair(ks, s0, s1, ops=ops))


# ---------------------------------------------------------------------------
# CKKS multiply + relinearize + rescale
# ---------------------------------------------------------------------------

class CKKSPipeline32(nn.Module):
    """The step's state at one level: key-switch tables, the relin evk
    (beta, 2, size_qlp, N), the rescale constants and the epilogue, fixed
    at construction: the moddown pair then rescale (the default, as in the
    JAX package), K8 with `moddown_rows` = R output rows per block, or K7
    with `merged_epilogue`.  The two options exclude each other.  Calling
    it runs mult_relin_rescale32."""

    def __init__(self, ctx: Context, evk: torch.Tensor, chain_index: int = 1,
                 moddown_rows=None, merged_epilogue: bool = False):
        super().__init__()
        if moddown_rows is not None:
            if merged_epilogue:
                raise ValueError("choose one epilogue: moddown_rows or "
                                 "merged_epilogue")
            if not 1 <= moddown_rows <= moddown_kernels.MAX_ROWS:
                raise ValueError(f"moddown_rows={moddown_rows} outside "
                                 f"[1, {moddown_kernels.MAX_ROWS}]")
        self._moddown_rows = moddown_rows
        self._merged_epilogue = bool(merged_epilogue)
        rc = ctx.get_context_data(chain_index).rescale
        self.ks = KeySwitch32(ctx, chain_index)
        k = self.ks.size_ql
        self.register_buffer("evk", evk)
        self.register_buffer("rows_ql_next", _rows(range(k - 1)))
        self.register_buffer("rescale_mat", torch.ones((2, k - 1, 1),
                                                       dtype=torch.int32))
        self.register_buffer("qlast_inv", u32_tensor(rc.qlast_inv))
        self.register_buffer("qlast_inv_shoup", u32_tensor(
            [s >> 32 for s in rc.qlast_inv_shoup]))
        self.register_buffer("half_mod_q", u32_tensor(rc.half_mod_q))
        self.half = rc.half

    @property
    def moddown_rows(self):
        """R for the K8 epilogue, or None."""
        return self._moddown_rows

    @property
    def merged_epilogue(self) -> bool:
        """True for the K7 epilogue."""
        return self._merged_epilogue

    def forward(self, d1: torch.Tensor, d2: torch.Tensor,
                ops: Kernels = KERNELS) -> torch.Tensor:
        return mult_relin_rescale32(self, d1, d2, ops)


def build_pipeline32(ctx: Context, rlk: torch.Tensor, chain_index: int = 1,
                     device=None, moddown_rows=None,
                     merged_epilogue: bool = False) -> CKKSPipeline32:
    """rlk: the relin key (dnum, 2, K, N) over QP; the epilogue options as
    CKKSPipeline32's."""
    return CKKSPipeline32(ctx, convert_key32(ctx, rlk, chain_index),
                          chain_index, moddown_rows, merged_epilogue).to(
                              resolve_device(device))


def _rescale(p: CKKSPipeline32, x: torch.Tensor,
             ops: Kernels = KERNELS) -> torch.Tensor:
    """round(x / q_last) on NTT-form (2, k, N) -> (2, k-1, N)."""
    ks = p.ks
    k = ks.size_ql
    xl = ops.ntt_inverse(x[:, k - 1:k].contiguous(), ks.ntt,
                         ks.rows_ql[k - 1:k])
    xl = ((xl.long() + p.half) % u32(ks.mv_ql.q[k - 1:k])).int()
    return ops.bconv_ntt_forward(
        xl, p.rescale_mat, ks.ntt, p.rows_ql_next, post_sub=p.half_mod_q,
        sub_from=x[:, :k - 1].contiguous(), epi_scale=p.qlast_inv,
        epi_scale_shoup=p.qlast_inv_shoup)


def mult_relin_rescale32(p: CKKSPipeline32, d1: torch.Tensor,
                         d2: torch.Tensor,
                         ops: Kernels = KERNELS) -> torch.Tensor:
    """d1, d2: (2, size_ql, N) int32 NTT form -> (2, size_ql - 1, N).

    Bit-identical to the JAX package's mult_relin_rescale32 (and so to
    its u64 evaluator's multiply_and_relin + rescale_to_next) on either
    route (at alpha <= 8 the K4 route, above it _mult_relin_rescale_split)
    and through each epilogue (_relin_rescale).  With merged_epilogue the
    result is a view: rows [0, size_ql - 1) of K7's output."""
    ks = p.ks
    if not ks.fused_modup:
        return _mult_relin_rescale_split(p, d1, d2, ops)
    y = _modup_inverse(ks, d1[1], ops, mul_by=d2[1])
    s = ops.modup_ip(_pad_digit_rows(ks, y), ks.modup_mats,
                     (_pad_digit_rows(ks, d1[1]), _pad_digit_rows(ks, d2[1])),
                     p.evk, ks.ntt, ks.rows_qlp, k_data=ks.size_ql)
    return _relin_rescale(p, s[0], s[1], d1, d2, ops)


def _mult_relin_rescale_split(p: CKKSPipeline32, d1: torch.Tensor,
                              d2: torch.Tensor,
                              ops: Kernels = KERNELS) -> torch.Tensor:
    """The step on the xla-split route at any alpha: the tensor term c2 in
    plain torch, modup_xla32, inner_product32."""
    ks = p.ks
    c2 = (d1[1].long() * d2[1].long() % _qcol(ks.mv_ql.q)).int()
    s0, s1 = _modup_ip_split(ks, c2, p.evk, ops)
    return _relin_rescale(p, s0, s1, d1, d2, ops)


def _relin_rescale(p: CKKSPipeline32, s0, s1, d1, d2,
                   ops: Kernels) -> torch.Tensor:
    """The moddown of both halves with the tensor terms c0, c1 added, then
    rescale, through the pipeline's epilogue: the pair (K1, K3) or K1 and
    K8, then _rescale; or K1 and K7, which rescales too."""
    ks = p.ks
    if not p.merged_epilogue:
        return _rescale(p, _moddown(ks, [s0, s1], (d1, d2), ops,
                                    p.moddown_rows), ops)
    y, v, sub = _moddown_inputs(ks, [s0, s1], ops)
    out = ops.moddown_rescale(
        y, ks.p_to_q.qhat_mod_p, v, ks.p_to_q.q_mod_p, sub, (d1, d2), ks.ntt,
        ks.rows_ql, ks.pinv, ks.pinv_shoup, p.half, p.half_mod_q,
        p.qlast_inv, p.qlast_inv_shoup)
    return out[:, :ks.size_ql - 1]


# ---------------------------------------------------------------------------
# Galois rotations and hoisting (NTT form)
# ---------------------------------------------------------------------------

class Galois32(nn.Module):
    """Rotation state at one level: the Galois elements, their NTT-form
    gather indices `perms` (n_elts, N) int32 and keys `evks` (n_elts,
    beta, 2, size_qlp, N)."""

    def __init__(self, ctx: Context, data: torch.Tensor,
                 elts: Sequence[int], chain_index: int = 1):
        """data: (n_elts, dnum, 2, K, N) Galois keys over QP."""
        super().__init__()
        n = ctx.params.n
        self.elts = tuple(int(e) for e in elts)
        self.register_buffer("perms", torch.from_numpy(np.stack(
            [gal.make_ntt_perm(e, n) for e in self.elts]).astype(np.int32)))
        self.register_buffer("evks", torch.stack(
            [convert_key32(ctx, k, chain_index) for k in data]))

    def key_index(self, elt: int) -> int:
        if elt not in self.elts:
            raise ValueError(f"no Galois key for element {elt}")
        return self.elts.index(elt)

    def step_index(self, step: int) -> int:
        return self.key_index(gal.get_elt_from_step(step,
                                                    self.perms.shape[1]))


def build_galois32(ctx: Context, glk, chain_index: int = 1,
                   device=None) -> Galois32:
    """glk: keys.GaloisKeys (data (n_elts, dnum, 2, K, N), elts)."""
    return Galois32(ctx, glk.data, glk.elts, chain_index).to(
        resolve_device(device))


def apply_galois32(ks: KeySwitch32, g: Galois32, d: torch.Tensor, elt: int,
                   ops: Kernels = KERNELS) -> torch.Tensor:
    """sigma_elt of an NTT-form (2, size_ql, N) ciphertext: permute both
    halves, key-switch c1."""
    kidx = g.key_index(elt)
    perm = g.perms[kidx]
    c0p = d[0][:, perm]
    sw = keyswitch_from_ntt32(ks, d[1][:, perm], g.evks[kidx], ops)
    q = _qcol(ks.mv_ql.q)
    return torch.stack([((c0p.long() + sw[0]) % q).int(), sw[1]])


def rotate32(ks: KeySwitch32, g: Galois32, d: torch.Tensor, step: int,
             ops: Kernels = KERNELS) -> torch.Tensor:
    """Slot rotation by `step` (one hop; a step without its own key is the
    caller's to decompose), NTT form."""
    return apply_galois32(ks, g, d, gal.get_elt_from_step(step, d.shape[-1]),
                          ops)


def hoisted_linear_combo32(ks: KeySwitch32, g: Galois32, d: torch.Tensor,
                           steps: Sequence[int], pts: Sequence[torch.Tensor],
                           ops: Kernels = KERNELS) -> torch.Tensor:
    """sum_s pt_s * rotate(d, s) with one modup and one moddown pair: the
    Halevi-Shoup matvec inner loop.  pts: per-step (size_qlp, N) NTT-form
    weights over QlP, aligned with `steps`; a step of 0 mod N/2 is the
    identity and needs no key switch."""
    k = ks.size_ql
    c0, c1 = d[0].long(), d[1].long()
    q, qlp = _qcol(ks.mv_ql.q), _qcol(ks.mv_qlp.q)
    t_up = modup_from_ntt32(ks, d[1], ops)
    acc_c0 = acc_c1 = acc0 = acc1 = None
    for s, pt in zip(steps, pts):
        pt = pt.long()
        if s % (d.shape[-1] // 2) == 0:
            term0 = c0 * pt[:k] % q
            term1 = c1 * pt[:k] % q
            acc_c1 = term1 if acc_c1 is None else (acc_c1 + term1) % q
        else:
            kidx = g.step_index(s)
            perm = g.perms[kidx]
            s0, s1 = inner_product32(ks, t_up, g.evks[kidx], ops, perm)
            w0 = s0.long() * pt % qlp
            w1 = s1.long() * pt % qlp
            term0 = c0[:, perm] * pt[:k] % q
            acc0 = w0 if acc0 is None else (acc0 + w0) % qlp
            acc1 = w1 if acc1 is None else (acc1 + w1) % qlp
        acc_c0 = term0 if acc_c0 is None else (acc_c0 + term0) % q
    if acc0 is None:
        return torch.stack([acc_c0, acc_c1]).int()
    cx0, cx1 = moddown32_pair(ks, acc0.int(), acc1.int(), ops=ops)
    out1 = cx1.long() if acc_c1 is None else (cx1 + acc_c1) % q
    return torch.stack([(acc_c0 + cx0) % q, out1]).int()


def hoisting_sum32(ks: KeySwitch32, g: Galois32, d: torch.Tensor,
                   steps: Sequence[int],
                   ops: Kernels = KERNELS) -> torch.Tensor:
    """sum_s rotate(d, s): one modup, per step the NTT-domain digit
    permutation and the evk inner product, one moddown pair."""
    t_up = modup_from_ntt32(ks, d[1], ops)
    q, qlp = _qcol(ks.mv_ql.q), _qcol(ks.mv_qlp.q)
    acc_c0 = acc0 = acc1 = 0
    for s in steps:
        kidx = g.step_index(s)
        perm = g.perms[kidx]
        s0, s1 = inner_product32(ks, t_up, g.evks[kidx], ops, perm)
        acc_c0 = (d[0][:, perm].long() + acc_c0) % q
        acc0 = (s0.long() + acc0) % qlp
        acc1 = (s1.long() + acc1) % qlp
    cx0, cx1 = moddown32_pair(ks, acc0.int(), acc1.int(), ops=ops)
    return torch.stack([((acc_c0 + cx0) % q).int(), cx1])

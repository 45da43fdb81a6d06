"""Hybrid key switching, rotations and the CKKS multiply + relinearize +
rescale step on 32-bit residues.

Counterpart of phantom_tpu/ops/pipeline32.py on two of its engines, fixed
when a KeySwitch32 is built (`engine`, named as in the JAX package's
normalize_engine):

  "mxu-pallas" (the default; the JAX package's default dispatch), below;
  "pallas-roll": every transform is K6 (ops/ntt_roll_kernels.py), the
    coefficient-form key switch converts with K5 (the digit's own rows
    ride in coefficient form and transform too), K9 takes the inner
    product, and each half's moddown is K6's inverse of the P rows, the
    exact conversion (K5) and K6's forward with the (x - .) P^-1 epilogue.
    It runs BFV only so far: the CKKS entry points raise on it.

The coefficient-form key switch of BFV's relinearization (keyswitch32) on
the default engine: the QhatInv pre-scale in plain torch, then K4's
coefficient form (modup + evk inner product, every row converted and
transformed), then the moddown pair.

The default engine's NTT-form paths take one of the JAX package's modup
routes (its PHANTOM_MODUP_VARIANT), fixed when a KeySwitch32 is built
(`modup`, MODUP_ROUTES): "auto" (the default) is "kernel" up to
KERNEL_BCONV_ALPHA_MAX = 8 special primes and "xla-split" above.

  "kernel", the fused route:
    modup + evk inner product       K1 iNTT (x n^-1 QhatInv), K4
    modup alone (hoisted rotations) K1, K3 with the digit rows passed
                                    through
  "xla-split" (the headline: N = 2^16, alpha = 22):
    modup                           K1, K5 per digit, K2 over the
                                    complement rows, the digit rows
                                    spliced back
    inner product                   K9
  "xla": the CKKS step only; every other path takes "xla-split" there
    modup + evk inner product       K1, K5 per digit into the (beta,
                                    size_qlp, N) delta (modup_delta_xla32),
                                    then K4's preconv form: the forward NTT
                                    of the complement rows and the evk
                                    product-sum, c2 in its digit rows
  on all:
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
passthrough rows; the xla routes compute it in plain torch ("xla" passes
the pair to K4p, which multiplies it again in its passthrough rows).  The
terms c0 and c1 ride the moddown's epilogue (tensor_add) on both.
Rotations permute NTT-form ciphertexts with a gather (the evaluation order
out[k] = p(psi^(2 rev(k)+1)) turns sigma_g into an index permutation) and
key-switch c1; the hoisted forms share one modup over all steps, and K9
reads it through each step's permutation.

A KeySwitch32 built on a BGV context carries the t-corrected moddown (the
reference's bgv_moddown_kernel), unfused and for both halves at once: one
K1 over their P rows without the moddown scale, the exact conversions
P -> Ql and P -> {t} (one K5 each over both halves' columns, sharing the
QhatInv scale and the floor sum), the t correction in plain torch, and
one K2 with the (x_Ql - .) P^-1 epilogue.

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
               ntt_kernels, ntt_roll_kernels)
from .bconv32 import (BaseConvConsts32, ModulusVec32, bconv_approx32,
                      bconv_exact32, exact_from_scaled32, floor_sum_div32,
                      matmul_reduce32, scale_by_qhat_inv32)
from .modmath32 import mul_mod_shoup32, u32
from .ntt32 import u32_tensor
from ..schemes import galois as gal
from ..schemes.context import Context, qlp_rows, resolve_device

# the JAX package's default: the fused modup (K4, K3 self rows) up to this
# special-base size, the xla-split modup above it (KeySwitch32.modup)
KERNEL_BCONV_ALPHA_MAX = 8
MODUP_ROUTES = ("auto", "kernel", "xla", "xla-split")
DEFAULT_ENGINE = "mxu-pallas"
ROLL_ENGINE = "pallas-roll"
ENGINES = (DEFAULT_ENGINE, ROLL_ENGINE)


class Kernels(NamedTuple):
    ntt_inverse: Callable        # K1
    ntt_forward: Callable        # K2
    bconv_ntt_forward: Callable  # K3
    fold_matmul: Callable        # K5
    modup_ip: Callable           # K4
    inner_product: Callable      # K9
    moddown_rows: Callable       # K8
    moddown_rescale: Callable    # K7
    modup_ip_coeff: Callable     # K4, coefficient form
    ntt_forward_roll: Callable   # K6
    ntt_inverse_roll: Callable   # K6
    modup_ip_preconv: Callable   # K4, preconv form


KERNELS = Kernels(ntt_kernels.ntt_inverse, ntt_kernels.ntt_forward,
                  ntt_kernels.bconv_ntt_forward, bconv_kernels.fold_matmul,
                  modup_ip_kernels.modup_ip, ip_kernels.inner_product,
                  moddown_kernels.moddown_rows,
                  moddown_kernels.moddown_rescale,
                  modup_ip_kernels.modup_ip_coeff,
                  ntt_roll_kernels.ntt_forward_roll,
                  ntt_roll_kernels.ntt_inverse_roll,
                  modup_ip_kernels.modup_ip_preconv)
PLAIN = Kernels(ntt_kernels.ntt_inverse_plain, ntt_kernels.ntt_forward_plain,
                ntt_kernels.bconv_ntt_forward_plain,
                bconv_kernels.fold_matmul_plain,
                modup_ip_kernels.modup_ip_plain,
                ip_kernels.inner_product_plain,
                moddown_kernels.moddown_rows_plain,
                moddown_kernels.moddown_rescale_plain,
                modup_ip_kernels.modup_ip_coeff_plain,
                ntt_kernels.ntt_forward_plain,
                ntt_kernels.ntt_inverse_plain,
                modup_ip_kernels.modup_ip_preconv_plain)


def _rows(idx) -> torch.Tensor:
    return torch.tensor(list(idx), dtype=torch.int32)


def _qcol(q: torch.Tensor) -> torch.Tensor:
    return u32(q).view(-1, 1)


class KeySwitch32(nn.Module):
    """u32 tables for hybrid key switching at one level on one engine
    (ENGINES) and modup route (MODUP_ROUTES): the QP NTT tables with the
    row indices of Ql, P, QlP and the concatenated per-digit complement
    rows, the conversion constants, the fused modup matrices (NTT and
    coefficient form) and the fused scales; on a BGV context also the
    t-corrected moddown's tables.  Holds no key material."""

    def __init__(self, ctx: Context, chain_index: int = 1,
                 engine: str = DEFAULT_ENGINE, modup: str = "auto"):
        super().__init__()
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r} not in {ENGINES}")
        if modup not in MODUP_ROUTES:
            raise ValueError(f"modup {modup!r} not in {MODUP_ROUTES}")
        self._engine = engine
        cd = ctx.get_context_data(chain_index)
        ks = cd.ks
        k = cd.size_ql
        alpha = ctx.params.size_p
        beta = len(ks.digit_convs)
        n = ctx.params.n
        rows = qlp_rows(ctx, k)
        qp = ctx.params.coeff_modulus
        self.size_ql, self.size_p, self.beta = k, alpha, beta
        if modup == "auto":
            modup = ("kernel" if alpha <= KERNEL_BCONV_ALPHA_MAX
                     else "xla-split")
        self._modup = modup
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
        # the coefficient form: the digit's own rows carry its qhat
        # diagonal, so the conversion of the pre-scaled y_j = x_j QhatInv_j
        # recovers x_j there; with the per-row QhatInv (and Shoup word)
        for d, conv in enumerate(ks.digit_convs):
            lo = d * alpha
            for i, qh in enumerate(conv.ibase.qhat_mod_qi):
                mats[d, lo + i, i] = qh
        self.register_buffer("modup_mats_coeff", u32_tensor(mats))
        self.register_buffer("modup_qhat_inv", u32_tensor(
            [v for c in ks.digit_convs for v in c.ibase.qhat_inv_mod_qi]))
        self.register_buffer("modup_qhat_inv_shoup", u32_tensor(
            [(v << 32) // q for c in ks.digit_convs for v, q in zip(
                c.ibase.qhat_inv_mod_qi, c.ibase.moduli)]))
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
        self.p_to_t = None
        if ks.p_to_t is not None:  # BGV: the t-corrected moddown
            self.p_to_t = BaseConvConsts32(ks.p_to_t)
            self.register_buffer("phalf_mod_p", u32_tensor(ks.phalf_mod_p))
            self.register_buffer("phalf_mod_q", u32_tensor(ks.phalf_mod_q))
            self.register_buffer("bigp_mod_q", u32_tensor(ks.bigp_mod_q))
            self.phalf_mod_t = ks.phalf_mod_t
            self.neg_pinv_mod_t = ks.neg_pinv_mod_t
            self.t = ctx.params.plain_modulus

    @property
    def engine(self) -> str:
        return self._engine

    @property
    def modup(self) -> str:
        """The modup route, "auto" resolved by alpha: "kernel", "xla" or
        "xla-split"."""
        return self._modup

    @property
    def fused_modup(self) -> bool:
        """True on the "kernel" route (K4, K3 self rows)."""
        return self._modup == "kernel"

    @property
    def bgv(self) -> bool:
        """True when built on a BGV context: the moddown is t-corrected."""
        return self.p_to_t is not None


def build_keyswitch32(ctx: Context, chain_index: int = 1, device=None,
                      engine: str = DEFAULT_ENGINE,
                      modup: str = "auto") -> KeySwitch32:
    return KeySwitch32(ctx, chain_index, engine, modup).to(
        resolve_device(device))


def _default_engine_only(ks: KeySwitch32, what: str) -> None:
    if ks.engine != DEFAULT_ENGINE:
        raise ValueError(f"{what}: runs on the {DEFAULT_ENGINE!r} engine "
                         f"only so far, not {ks.engine!r}")


def _fwd(ks: KeySwitch32, x: torch.Tensor, rows, ops: Kernels,
         **epi) -> torch.Tensor:
    """The engine's forward NTT over table rows `rows`, with K2's (sub_from,
    epi_scale, epi_scale_shoup) epilogue: K2 or K6."""
    fwd = (ops.ntt_forward_roll if ks.engine == ROLL_ENGINE
           else ops.ntt_forward)
    return fwd(x, ks.ntt, rows, **epi)


def _inv(ks: KeySwitch32, x: torch.Tensor, rows, ops: Kernels,
         **kw) -> torch.Tensor:
    """The engine's inverse NTT (scale, scale_shoup): K1 or K6."""
    inv = (ops.ntt_inverse_roll if ks.engine == ROLL_ENGINE
           else ops.ntt_inverse)
    return inv(x, ks.ntt, rows, **kw)


def convert_key32(ctx: Context, key_data: torch.Tensor,
                  chain_index: int = 1) -> torch.Tensor:
    """(dnum, 2, K, N) key over QP -> (beta, 2, size_qlp, N) at this
    level."""
    cd = ctx.get_context_data(chain_index)
    rows = torch.tensor(qlp_rows(ctx, cd.size_ql), device=key_data.device)
    beta = len(cd.ks.digit_convs)
    return key_data[:beta].index_select(2, rows).contiguous()


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


def modup_delta_xla32(ks: KeySwitch32, y: torch.Tensor,
                      ops: Kernels = KERNELS) -> torch.Tensor:
    """y: the pre-scaled iNTT rows (size_ql, N) -> the converted (beta,
    size_qlp, N) delta, K5 per digit, zeros at each digit's own rows: K4's
    preconv input (which never reads those rows)."""
    k, alpha = ks.size_ql, ks.size_p
    out = []
    for d in range(ks.beta):
        lo, hi = d * alpha, min((d + 1) * alpha, k)
        compl = matmul_reduce32(y[lo:hi], ks.digit_convs[d], ops.fold_matmul)
        out.append(torch.cat([compl[:lo], compl.new_zeros(
            (hi - lo,) + tuple(y.shape[1:])), compl[lo:]]))
    return torch.stack(out)


def _modup_inverse(ks: KeySwitch32, c2_ntt: torch.Tensor, ops: Kernels,
                   mul_by=None) -> torch.Tensor:
    """K1: the iNTT of the Ql rows scaled by n^-1 * QhatInv."""
    return ops.ntt_inverse(c2_ntt, ks.ntt, ks.rows_ql, scale=ks.modup_scale,
                           scale_shoup=ks.modup_scale_shoup, mul_by=mul_by)


def modup_from_ntt32(ks: KeySwitch32, c2_ntt: torch.Tensor,
                     ops: Kernels = KERNELS) -> torch.Tensor:
    """(size_ql, N) NTT form -> the modup tensor (beta, size_qlp, N), NTT
    form.  On the "kernel" route one K3 converts and transforms every QlP
    row of every digit, the digit's own rows passed through; else
    modup_xla32."""
    _default_engine_only(ks, "modup_from_ntt32")
    y = _modup_inverse(ks, c2_ntt, ops)
    if not ks.fused_modup:
        return modup_xla32(ks, y, c2_ntt, ops)
    return ops.bconv_ntt_forward(y, ks.modup_mats, ks.ntt, ks.rows_qlp,
                                 self_rows=c2_ntt.contiguous(),
                                 k_data=ks.size_ql)


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
    _default_engine_only(ks, "modup_ip32")
    y = _modup_inverse(ks, c2_ntt, ops)
    return inner_product32(ks, modup_xla32(ks, y, c2_ntt, ops), evk, ops)


def modup_ip32(ks: KeySwitch32, c2_ntt: torch.Tensor, evk: torch.Tensor,
               ops: Kernels = KERNELS):
    """Modup and the evk inner product: (s0, s1), each (size_qlp, N).  On
    the "kernel" route one K4 launch after the modup iNTT (the modup tensor
    never exists in memory); else _modup_ip_split."""
    if not ks.fused_modup:
        return _modup_ip_split(ks, c2_ntt, evk, ops)
    _default_engine_only(ks, "modup_ip32")
    y = _modup_inverse(ks, c2_ntt, ops)
    s = ops.modup_ip(y, ks.modup_mats, c2_ntt.contiguous(), evk, ks.ntt,
                     ks.rows_qlp, k_data=ks.size_ql)
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


def _moddown_delta32(ks: KeySwitch32, x_p: torch.Tensor,
                     ops: Kernels) -> torch.Tensor:
    """BGV's delta over Ql from the coefficient-form P rows x_p (alpha,
    ...): delta == x (mod P) and delta == 0 (mod t), the centered (P - 1)
    / 2 shift around both exact conversions -> (size_ql, ...)."""
    def col(v):
        return u32(v).view((-1,) + (1,) * (x_p.dim() - 1))
    t = ks.t
    y = scale_by_qhat_inv32(((x_p.long() + col(ks.phalf_mod_p))
                             % col(ks.p_to_q.ibase.q)).int(), ks.p_to_q)
    v = floor_sum_div32(y, ks.p_to_q)
    dt = exact_from_scaled32(y, v, ks.p_to_t, ops.fold_matmul).long()
    u = (dt - ks.phalf_mod_t) % t * ks.neg_pinv_mod_t % t
    dq = exact_from_scaled32(y, v, ks.p_to_q, ops.fold_matmul).long()
    return ((dq - col(ks.phalf_mod_q) + u * col(ks.bigp_mod_q))
            % col(ks.mv_ql.q)).int()


def _moddown_bgv(ks: KeySwitch32, xs, ops: Kernels) -> torch.Tensor:
    """BGV's moddown of G = len(xs) inputs (size_qlp, N) -> (G, size_ql,
    N): one inverse NTT of their P rows, the t-corrected delta over all G N
    columns at once, one forward NTT with the (x_Ql - .) P^-1 epilogue."""
    k = ks.size_ql
    x_p = _inv(ks, torch.stack([x[k:] for x in xs]), ks.rows_p, ops)
    delta = _moddown_delta32(ks, x_p.transpose(0, 1), ops)
    return _fwd(ks, delta.transpose(0, 1).contiguous(), ks.rows_ql, ops,
                sub_from=torch.stack([x[:k] for x in xs]), epi_scale=ks.pinv,
                epi_scale_shoup=ks.pinv_shoup)


def moddown32(ks: KeySwitch32, x: torch.Tensor,
              ops: Kernels = KERNELS) -> torch.Tensor:
    """(x_Ql - delta(x_P)) * P^-1 over Ql, NTT form in and out:
    (size_qlp, N) -> (size_ql, N).  Unfused on the roll engine and for
    BGV: the inverse NTT of the P rows, the exact conversion delta (K5;
    BGV's t-corrected _moddown_delta32), the forward NTT with the
    (x_Ql - .) P^-1 epilogue."""
    if ks.bgv:
        return _moddown_bgv(ks, [x], ops)[0]
    if ks.engine == DEFAULT_ENGINE:
        return _moddown(ks, [x], None, ops)[0]
    k = ks.size_ql
    delta = bconv_exact32(_inv(ks, x[k:], ks.rows_p, ops), ks.p_to_q,
                          ops.fold_matmul)
    return _fwd(ks, delta, ks.rows_ql, ops, sub_from=x[:k],
                epi_scale=ks.pinv, epi_scale_shoup=ks.pinv_shoup)


def moddown32_pair(ks: KeySwitch32, x0: torch.Tensor, x1: torch.Tensor,
                   tensor_add=None, ops: Kernels = KERNELS):
    """moddown32 of both key-switch halves in one K1 and one K3 launch (for
    BGV one K1, two K5 and one K2: _moddown_bgv), bit-identical to two
    moddown32 calls (which the roll engine makes).  tensor_add = (d1, d2)
    adds the relin tensor terms c0 and c1 in K3's epilogue (the default
    engine's CKKS moddown only)."""
    if ks.engine != DEFAULT_ENGINE or ks.bgv:
        if tensor_add is not None:
            raise ValueError("moddown32_pair: tensor_add needs the "
                             f"{DEFAULT_ENGINE!r} engine's CKKS moddown")
        if ks.bgv:
            out = _moddown_bgv(ks, [x0, x1], ops)
            return out[0], out[1]
        return moddown32(ks, x0, ops), moddown32(ks, x1, ops)
    out = _moddown(ks, [x0, x1], tensor_add, ops)
    return out[0], out[1]


def moddown_coeff32(ks: KeySwitch32, x: torch.Tensor,
                    ops: Kernels = KERNELS) -> torch.Tensor:
    """(x_Ql - delta(x_P)) * P^-1 in coefficient form: (..., size_qlp, N)
    -> (..., size_ql, N), with delta the exact conversion (K5; BGV's
    t-corrected _moddown_delta32) over every leading group at once."""
    k = ks.size_ql
    x_p = x[..., k:, :].movedim(-2, 0)
    delta = (_moddown_delta32(ks, x_p, ops) if ks.bgv else
             bconv_exact32(x_p, ks.p_to_q, ops.fold_matmul)).movedim(0, -2)
    q = _qcol(ks.mv_ql.q)
    return mul_mod_shoup32((x[..., :k, :].long() - delta) % q,
                           _qcol(ks.pinv), _qcol(ks.pinv_shoup), q).int()


def _modup_coeff_prescale(ks: KeySwitch32, c2_coeff: torch.Tensor):
    """x_j QhatInv_j over the Ql rows, each by its digit's QhatInv."""
    q = _qcol(ks.mv_ql.q)
    return mul_mod_shoup32(c2_coeff, _qcol(ks.modup_qhat_inv),
                           _qcol(ks.modup_qhat_inv_shoup), q).int()


def modup32(ks: KeySwitch32, c2_coeff: torch.Tensor,
            ops: Kernels = KERNELS) -> torch.Tensor:
    """(size_ql, N) coefficient form -> the modup tensor (beta, size_qlp,
    N), NTT form, as the JAX package's roll engine builds it: per digit the
    fast conversion (K5) of its rows to the complement, the digit's own
    rows between, then one forward NTT of the engine (K6 on the roll
    engine).  keyswitch32 on the default engine never stores this tensor
    (K4's coefficient form)."""
    k, alpha = ks.size_ql, ks.size_p
    out = []
    for d in range(ks.beta):
        lo, hi = d * alpha, min((d + 1) * alpha, k)
        x = c2_coeff[lo:hi]
        compl = bconv_approx32(x, ks.digit_convs[d], ops.fold_matmul)
        out.append(torch.cat([compl[:lo], x, compl[lo:]]))
    return _fwd(ks, torch.stack(out), ks.rows_qlp, ops)


def keyswitch32(ks: KeySwitch32, c2_coeff: torch.Tensor, evk: torch.Tensor,
                ops: Kernels = KERNELS) -> torch.Tensor:
    """Hybrid key switch of a coefficient-form (size_ql, N) polynomial ->
    (2, size_ql, N), NTT form.  Default engine: K4's coefficient form on
    the pre-scaled rows (the modup tensor never exists in memory), then
    the moddown pair (K1, K3); roll engine: modup32, K9, two moddown32."""
    if ks.engine == DEFAULT_ENGINE:
        s = ops.modup_ip_coeff(_modup_coeff_prescale(ks, c2_coeff),
                               ks.modup_mats_coeff, evk, ks.ntt, ks.rows_qlp)
        s0, s1 = s[0], s[1]
    else:
        s0, s1 = inner_product32(ks, modup32(ks, c2_coeff, ops), evk, ops)
    return torch.stack(moddown32_pair(ks, s0, s1, ops=ops))


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
    """The step's state at one level: key-switch tables on a modup route
    (`modup`, MODUP_ROUTES), the relin evk (beta, 2, size_qlp, N), the
    rescale constants and the epilogue, fixed at construction: the moddown
    pair then rescale (the default, as in the JAX package), K8 with
    `moddown_rows` = R output rows per block, or K7 with `merged_epilogue`.
    The two options exclude each other.  `ks`: the level's KeySwitch32 to
    share (Fast32's), else one is built; evk may be None where only the
    rescale runs.  Calling it runs mult_relin_rescale32."""

    def __init__(self, ctx: Context, evk: torch.Tensor, chain_index: int = 1,
                 moddown_rows=None, merged_epilogue: bool = False,
                 engine: str = DEFAULT_ENGINE, modup: str = "auto",
                 ks: KeySwitch32 = None):
        super().__init__()
        if engine != DEFAULT_ENGINE:
            raise ValueError(f"the CKKS step runs on the {DEFAULT_ENGINE!r} "
                             f"engine only so far, not {engine!r}")
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
        if rc is None:
            raise ValueError(f"chain index {chain_index} has no prime to "
                             "rescale by")
        self.ks = KeySwitch32(ctx, chain_index, modup=modup) if ks is None \
            else ks
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
                     merged_epilogue: bool = False,
                     engine: str = DEFAULT_ENGINE,
                     modup: str = "auto") -> CKKSPipeline32:
    """rlk: the relin key (dnum, 2, K, N) over QP; the epilogue options and
    the modup route as CKKSPipeline32's; `engine` "mxu-pallas" only so
    far."""
    return CKKSPipeline32(ctx, convert_key32(ctx, rlk, chain_index),
                          chain_index, moddown_rows, merged_epilogue,
                          engine, modup).to(resolve_device(device))


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
    its u64 evaluator's multiply_and_relin + rescale_to_next) on each
    modup route (the K4 route, _mult_relin_rescale_split,
    _mult_relin_rescale_preconv) and through each epilogue
    (_relin_rescale).  With merged_epilogue the result is a view: rows
    [0, size_ql - 1) of K7's output."""
    ks = p.ks
    if ks.modup == "xla-split":
        return _mult_relin_rescale_split(p, d1, d2, ops)
    if ks.modup == "xla":
        return _mult_relin_rescale_preconv(p, d1, d2, ops)
    y = _modup_inverse(ks, d1[1], ops, mul_by=d2[1])
    pair = (d1[1].contiguous(), d2[1].contiguous())
    s = ops.modup_ip(y, ks.modup_mats, pair, p.evk, ks.ntt, ks.rows_qlp,
                     k_data=ks.size_ql)
    return _relin_rescale(p, s[0], s[1], d1, d2, ops)


def _tensor_2x2(q: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor):
    """(d1[0] d2[0], d1[0] d2[1] + d1[1] d2[0], d1[1] d2[1]) mod q, int64;
    q: (size_ql, 1)."""
    a, b = d1.long(), d2.long()
    return (a[0] * b[0] % q, (a[0] * b[1] + a[1] * b[0]) % q,
            a[1] * b[1] % q)


def _tensor_square_2x2(q: torch.Tensor, d: torch.Tensor):
    """_tensor_2x2(q, d, d) with the cross term computed once: (d0^2,
    2 d0 d1, d1^2) mod q, int64."""
    a = d.long()
    return a[0] * a[0] % q, 2 * (a[0] * a[1] % q) % q, a[1] * a[1] % q


def _mult_relin_rescale_split(p: CKKSPipeline32, d1: torch.Tensor,
                              d2: torch.Tensor,
                              ops: Kernels = KERNELS) -> torch.Tensor:
    """The step on the xla-split route at any alpha: the tensor term c2 in
    plain torch, modup_xla32, inner_product32."""
    ks = p.ks
    c2 = (d1[1].long() * d2[1].long() % _qcol(ks.mv_ql.q)).int()
    s0, s1 = _modup_ip_split(ks, c2, p.evk, ops)
    return _relin_rescale(p, s0, s1, d1, d2, ops)


def _mult_relin_rescale_preconv(p: CKKSPipeline32, d1: torch.Tensor,
                                d2: torch.Tensor,
                                ops: Kernels = KERNELS) -> torch.Tensor:
    """The step on the "xla" route at any alpha: c2 in plain torch, its
    modup iNTT, the per-digit conversion into the delta
    (modup_delta_xla32), then K4's preconv form with the pair (d1[1],
    d2[1]) in its digit rows."""
    ks = p.ks
    c2 = (d1[1].long() * d2[1].long() % _qcol(ks.mv_ql.q)).int()
    delta = modup_delta_xla32(ks, _modup_inverse(ks, c2, ops), ops)
    pair = (d1[1].contiguous(), d2[1].contiguous())
    s = ops.modup_ip_preconv(delta, pair, p.evk, ks.ntt, ks.rows_qlp,
                             k_data=ks.size_ql, alpha=ks.size_p)
    return _relin_rescale(p, s[0], s[1], d1, d2, ops)


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
    gather indices `perms` (n_elts, N) int32, their coefficient-form
    gathers `coeff_src` (n_elts, N) int32 with the sign flips `coeff_neg`
    (n_elts, N) bool, and keys `evks` (n_elts, beta, 2, size_qlp, N)."""

    def __init__(self, ctx: Context, data: torch.Tensor,
                 elts: Sequence[int], chain_index: int = 1):
        """data: (n_elts, dnum, 2, K, N) Galois keys over QP."""
        super().__init__()
        n = ctx.params.n
        self.elts = tuple(int(e) for e in elts)
        self.register_buffer("perms", torch.from_numpy(np.stack(
            [gal.make_ntt_perm(e, n) for e in self.elts]).astype(np.int32)))
        coeff = [gal.make_coeff_perm(e, n) for e in self.elts]
        self.register_buffer("coeff_src", torch.from_numpy(np.stack(
            [c[0] for c in coeff]).astype(np.int32)))
        self.register_buffer("coeff_neg", torch.from_numpy(np.stack(
            [c[1] for c in coeff])))
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


def apply_galois_coeff32(ks: KeySwitch32, g: Galois32, d: torch.Tensor,
                         elt: int, ops: Kernels = KERNELS) -> torch.Tensor:
    """sigma_elt of a coefficient-form (2, size_ql, N) ciphertext (BFV):
    the signed gather of both halves, c1 key-switched in coefficient form
    (keyswitch32: K4c on the default engine) and brought back by the
    inverse NTT."""
    kidx = g.key_index(elt)
    src, neg = g.coeff_src[kidx], g.coeff_neg[kidx]
    q = _qcol(ks.mv_ql.q)

    def perm(x):
        x = x[:, src].long()
        return torch.where(neg, (q - x) % q, x)

    c0p = perm(d[0])
    sw = _inv(ks, keyswitch32(ks, perm(d[1]).int(), g.evks[kidx], ops),
              ks.rows_ql, ops)
    return torch.stack([((c0p + sw[0]) % q).int(), sw[1]])


def rotate32(ks: KeySwitch32, g: Galois32, d: torch.Tensor, step: int,
             ops: Kernels = KERNELS, is_ntt_form: bool = True
             ) -> torch.Tensor:
    """Slot rotation by `step` (one hop; a step without its own key is the
    caller's to decompose), NTT form or, with is_ntt_form=False,
    coefficient form."""
    elt = gal.get_elt_from_step(step, d.shape[-1])
    if is_ntt_form:
        return apply_galois32(ks, g, d, elt, ops)
    return apply_galois_coeff32(ks, g, d, elt, ops)


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

"""Hybrid key switching over u64 primes: modup, the evaluation-key inner
product (U3), moddown (counterpart of phantom_tpu/schemes/keyswitch.py:
31-208).

The ciphertext digit c2 splits into beta digits of alpha primes; each is
base-extended to QlP (its own rows copied, the complement converted by
U2), transformed (U1) and multiplied into the key with a 128-bit
accumulator (U3); both halves come back to Ql by the P^-1-corrected
moddown: the inverse NTT of the P rows, the exact conversion P -> Ql
(BGV: centered, and forced to 0 mod t by U4's moddown_delta), the
forward NTT, and (x - delta) P^-1 plus the caller's addend (U4), both
halves written into one tensor.  For NTT-form input (`modup_from_ntt`)
one inverse NTT folds n^-1 QhatInv in, the digit's own rows stay in NTT
form and only the complement rows convert ("reduce", the scale already
applied) and transform; the JAX package takes it where alpha divides
size_ql, and the plain modup after an inverse NTT elsewhere, and so does
the port.

U3 (csrc/u64_ip.cu) is `inner_product_evk`: one thread a word of a QlP
row, both key halves, the digits summed exactly over 128 bits and
reduced once by reduce_u128_any; `perm` gathers t's coefficients as it
reads them (a hoisted rotation's NTT-form permutation).

`Kernels64` names the kernels every u64 function calls: KERNELS64
dispatches each to its CUDA kernel (its plain version for CPU tensors),
PLAIN64 forces the plain versions, which is how the card checks them.
Its last two fields are F1's wide forms (ops/ckks_fft.py), the device
encoder's on a wide context, so that every u64 caller takes one `ops`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import _build
from ..ops import bconv as bc
from ..ops import ckks_fft as cf
from ..ops import modmath as mm
from ..ops import ntt as nttmod
from ..ops import ntt_phase_kernels as ntp
from ..ops import polyops as po
from ..ops.ntt import _ptr, check_words
from .context import Context, ContextData


# ---------------------------------------------------------------------------
# U3
# ---------------------------------------------------------------------------

def inner_product_evk_plain(t: torch.Tensor, evk: torch.Tensor,
                            q: torch.Tensor, ratio_lo: torch.Tensor,
                            ratio_hi: torch.Tensor, pow64: torch.Tensor,
                            perm: Optional[torch.Tensor] = None):
    """t (beta, K', N), evk (beta, 2, K', N) -> (2, K', N) in [0, q)."""
    if perm is not None:
        t = t[:, :, perm.long()]
    cols = [v.view(-1, 1) for v in (q, ratio_lo, ratio_hi, pow64)]
    halves = []
    for j in range(2):
        acc = None
        for d in range(t.shape[0]):
            w = mm.mul_wide(t[d], evk[d, j])
            acc = w if acc is None else mm.add_wide(*acc, *w)
        halves.append(bc.reduce_u128_any(*acc, *cols))
    return torch.stack(halves)


def inner_product_evk_kernel(t: torch.Tensor, evk: torch.Tensor,
                             q: torch.Tensor, ratio_lo: torch.Tensor,
                             ratio_hi: torch.Tensor, pow64: torch.Tensor,
                             perm: Optional[torch.Tensor] = None):
    """U3 on CUDA tensors; the plain version on CPU tensors.  q, ratio_lo,
    ratio_hi, pow64: (K',) per QlP row; perm: (N,) int32 indices in [0,
    N) (not checked) or None."""
    if _build.is_plain(t, "inner_product_evk"):
        return inner_product_evk_plain(t, evk, q, ratio_lo, ratio_hi, pow64,
                                       perm)
    t, evk = t.contiguous(), evk.contiguous()
    beta, k_out, n = t.shape
    if evk.shape != (beta, 2, k_out, n) or q.shape != (k_out,):
        raise ValueError(f"inner_product_evk: t {tuple(t.shape)}, evk "
                         f"{tuple(evk.shape)}, q {tuple(q.shape)}")
    if perm is not None and (perm.dtype != torch.int32
                             or perm.shape != (n,)):
        raise ValueError("perm must be an int32 (N,) tensor")
    check_words(t, evk, q, ratio_lo, ratio_hi, pow64)
    _build.check_device(t, perm)
    out = torch.empty((2, k_out, n), dtype=torch.int64, device=t.device)
    with torch.cuda.device(t.device):
        err = _build.library().ptk_u64_inner_product(
            out.data_ptr(), t.data_ptr(), evk.data_ptr(), q.data_ptr(),
            ratio_lo.data_ptr(), ratio_hi.data_ptr(), pow64.data_ptr(),
            _ptr(perm), beta, k_out, n, _build.stream(t))
    _build.check(err, "u64_inner_product")
    inner_product_evk_kernel.launches += 1
    return out


inner_product_evk_kernel.launches = 0


class Kernels64(NamedTuple):
    ntt_forward: Callable        # U1
    ntt_inverse: Callable        # U1
    bconv: Callable              # U2
    inner_product: Callable      # U3
    mul_rns: Callable            # U4 (every form counts as U4)
    fma_rns: Callable
    tensor_prod_2x2: Callable
    tensor_square_2x2: Callable
    tensor_prod_mxn: Callable
    shoup_rns: Callable
    rescale_delta: Callable
    modswitch_delta: Callable
    moddown_delta: Callable
    ckks_fft_encode: Callable    # F1's wide encode form (counts as F1)
    ckks_fft_decode: Callable    # F1's wide decode form (counts as F1)
    ntt_phase: Callable          # P1, the sharded NTT's local phases


KERNELS64 = Kernels64(nttmod.ntt_forward, nttmod.ntt_inverse, bc.bconv,
                      inner_product_evk_kernel, po.mul_rns, po.fma_rns,
                      po.tensor_prod_2x2, po.tensor_square_2x2,
                      po.tensor_prod_mxn, po.shoup_rns, po.rescale_delta,
                      po.modswitch_delta, po.moddown_delta,
                      cf.ckks_fft_encode64, cf.ckks_fft_decode64,
                      ntp.ntt_phase)
PLAIN64 = Kernels64(nttmod.ntt_forward_plain, nttmod.ntt_inverse_plain,
                    bc.bconv_plain, inner_product_evk_plain,
                    po.mul_rns_plain, po.fma_rns_plain,
                    po.tensor_prod_2x2_plain, po.tensor_square_2x2_plain,
                    po.tensor_prod_mxn_plain, po.shoup_rns_plain,
                    po.rescale_delta_plain, po.modswitch_delta_plain,
                    po.moddown_delta_plain, cf.ckks_fft_encode64_plain,
                    cf.ckks_fft_decode64_plain, ntp.ntt_phase_plain)


# ---------------------------------------------------------------------------
# the key switch
# ---------------------------------------------------------------------------

def digit_bounds(ctx: Context, size_ql: int, d: int) -> Tuple[int, int]:
    alpha = ctx.params.size_p
    lo = d * alpha
    return lo, min(lo + alpha, size_ql)


def modup(ctx: Context, cd: ContextData, c2: torch.Tensor,
          ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """c2 (size_ql, N) coefficient form -> (beta, size_qlp, N) NTT form:
    per digit the approximate conversion (U2) to its complement, the
    digit's rows between, then one forward NTT (U1) of all digits."""
    ks = cd.u64.ks
    k = cd.size_ql
    out = []
    for d, conv in enumerate(ks.digit_convs):
        lo, hi = digit_bounds(ctx, k, d)
        x = c2[lo:hi]
        compl = bc.bconv_approx(x, conv, ops.bconv)
        out.append(torch.cat([compl[:lo], x, compl[lo:]]))
    return ops.ntt_forward(torch.stack(out), ctx.ntt64, ks.rows_qlp)


def inner_product_evk(t_modup: torch.Tensor, evk: torch.Tensor,
                      cd: ContextData, ops: Kernels64 = KERNELS64,
                      perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_d t_d evk[d, j] over QlP (U3): (2, K', N)."""
    ks = cd.u64.ks
    return ops.inner_product(t_modup, evk, *ks.qlp, ks.pow64_mod_qlp, perm)


def _moddown_delta(ks, x_p: torch.Tensor, ops: Kernels64) -> torch.Tensor:
    """delta == x (mod P) over Ql; BGV also forces delta == 0 (mod t), by
    the centered conversion of x + (P - 1) / 2 to Ql and to {t} and the
    correction u P, u = [-delta_t P^-1]_t (U4's moddown_delta)."""
    if ks.p_to_t is None:
        return bc.bconv_exact(x_p, ks.p_to_q, ops.bconv)
    shifted = mm.add_mod(x_p, ks.phalf_mod_p.view(-1, 1),
                         ks.p_to_q.ibase.q.view(-1, 1))
    return ops.moddown_delta(bc.bconv_exact(shifted, ks.p_to_q, ops.bconv),
                             bc.bconv_exact(shifted, ks.p_to_t, ops.bconv),
                             ks.delta)


def moddown_ntt(ctx: Context, cd: ContextData, x: torch.Tensor,
                ops: Kernels64 = KERNELS64,
                add: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x_Ql - delta(x_P)) P^-1 (+ add) over Ql, NTT form in and out:
    (size_qlp, N) -> (size_ql, N), into `out` if given.  U1 inverse over
    P, U2 exact (BGV: twice, to Ql and to {t}, and U4's delta), U1
    forward over Ql, U4's (x - .) P^-1 + add."""
    ks = cd.u64.ks
    k = cd.size_ql
    p = ctx.params
    x_p = ops.ntt_inverse(x[k:], ctx.ntt64, ctx.rows_qp[p.size_q:])
    delta = ops.ntt_forward(_moddown_delta(ks, x_p, ops), ctx.ntt64,
                            ctx.rows_qp[:k])
    return ops.shoup_rns(x[:k], ks.pinv, delta, add, out)


def moddown_pair(ctx: Context, cd: ContextData, prod: torch.Tensor,
                 ops: Kernels64 = KERNELS64,
                 adds=(None, None)) -> torch.Tensor:
    """The moddown of both halves of a (2, size_qlp, N) key-switch
    product, each plus its addend (or None), written into one (2,
    size_ql, N) tensor."""
    out = prod.new_empty((2, cd.size_ql, prod.shape[-1]))
    for h in range(2):
        moddown_ntt(ctx, cd, prod[h], ops, adds[h], out[h])
    return out


def moddown_coeff(ctx: Context, cd: ContextData, x: torch.Tensor,
                  ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """The moddown of a coefficient-form (size_qlp, N) input."""
    ks = cd.u64.ks
    delta = _moddown_delta(ks, x[cd.size_ql:], ops)
    return ops.shoup_rns(x[:cd.size_ql], ks.pinv, delta)


def evk_rows(ctx: Context, evk_data: torch.Tensor,
             cd: ContextData) -> torch.Tensor:
    """A (dnum, 2, K, N) key restricted to this level's digits and QlP
    rows: (beta, 2, size_qlp, N)."""
    ks = cd.u64.ks
    beta = len(ks.digit_convs)
    return evk_data[:beta].index_select(2, ks.rows_qlp.long())


def keyswitch(ctx: Context, cd: ContextData, c2: torch.Tensor,
              evk_data: torch.Tensor,
              ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """Hybrid key switch of a coefficient-form c2 (size_ql, N) ->
    (2, size_ql, N) NTT form over Ql."""
    prod = inner_product_evk(modup(ctx, cd, c2, ops),
                             evk_rows(ctx, evk_data, cd), cd, ops)
    return moddown_pair(ctx, cd, prod, ops)


def modup_from_ntt(ctx: Context, cd: ContextData, c2_ntt: torch.Tensor,
                   ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """The fused modup of an NTT-form c2 (size_ql, N) -> (beta, size_qlp,
    N), bit-identical to ntt_inverse + modup."""
    ks = cd.u64.ks
    k = cd.size_ql
    rows_ql = ctx.rows_qp[:k]
    if k % ctx.params.size_p:
        return modup(ctx, cd, ops.ntt_inverse(c2_ntt, ctx.ntt64, rows_ql),
                     ops)
    y = ops.ntt_inverse(c2_ntt, ctx.ntt64, rows_ql, ks.modup_scale,
                        ks.modup_scale_shoup)
    full = ks.rows_qlp
    out = []
    for d, conv in enumerate(ks.digit_convs):
        lo, hi = digit_bounds(ctx, k, d)
        compl = ops.bconv(y[lo:hi], conv, "reduce")
        compl_ntt = ops.ntt_forward(compl, ctx.ntt64,
                                    torch.cat([full[:lo], full[hi:]]))
        out.append(torch.cat([compl_ntt[:lo], c2_ntt[lo:hi],
                              compl_ntt[lo:]]))
    return torch.stack(out)


def keyswitch_from_ntt(ctx: Context, cd: ContextData, c2_ntt: torch.Tensor,
                       evk_data: torch.Tensor,
                       ops: Kernels64 = KERNELS64,
                       adds=(None, None)) -> torch.Tensor:
    """Hybrid key switch of an NTT-form c2 with the fused modup, each half
    plus its addend (or None) in the moddown's last launch."""
    prod = inner_product_evk(modup_from_ntt(ctx, cd, c2_ntt, ops),
                             evk_rows(ctx, evk_data, cd), cd, ops)
    return moddown_pair(ctx, cd, prod, ops, adds)

"""U4: the RNS products over u64 primes, their plain versions and the CUDA
kernel's wrappers, beside the elementwise ops (counterpart of
phantom_tpu/ops/polyops.py:22-103 and the Barrett product of
phantom_tpu/ops/modmath.py:146, which the JAX package runs as XLA
fusions, no pallas_call).

Operands are (..., L, N) int64 words in [0, q); a ModulusVec carries the
moduli with their 2^128 Barrett words.  add, sub and neg stay plain torch
everywhere (one or two integer ops a word); the Barrett products run on
U4 (csrc/u64_polyops.cu, one thread a word, every form one launch):

  mul_rns            a b mod q             (b may broadcast over a's
  fma_rns            a b + c mod q          leading groups: a plaintext)
  tensor_prod_2x2    (a0 b0, a0 b1 + a1 b0, a1 b1), the cross term summed
                     over 128 bits and reduced once (2 q^2 < q 2^64)
  tensor_square_2x2  (a0^2, 2 a0 a1, a1^2), the cross term doubled over
                     128 bits and reduced once
  sub_mul_shoup      (a - s) w mod q with a per-limb w and its Shoup
                     word, s optional (the moddown's and the rescale's
                     (x - delta) P^-1 and q_last^-1, the JAX package's
                     scalar_mul_rns); a (..., 1, N) is read for each
                     limb (rows_times: one row times a constant per
                     limb, or reduced mod each limb, BGV's corrections
                     and the rescale's last limb)

All count in `mul_rns.launches`.  Outputs are canonical, so each form is
bit-equal to its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import modmath as mm
from .ntt import _ptr, check_words
from .rns_host import ModulusVec

FORMS = ("mul", "fma", "tensor", "square", "shoup")


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1)


def add_rns(a, b, mv: ModulusVec):
    return mm.add_mod(a, b, _col(mv.q))


def sub_rns(a, b, mv: ModulusVec):
    return mm.sub_mod(a, b, _col(mv.q))


def neg_rns(a, mv: ModulusVec):
    return mm.neg_mod(a, _col(mv.q))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def mul_rns_plain(a, b, mv: ModulusVec):
    return mm.mul_mod(a, b, *mv.col())


def fma_rns_plain(a, b, c, mv: ModulusVec):
    return mm.add_mod(mul_rns_plain(a, b, mv), c, _col(mv.q))


def _reduce_cross(h, l_, mv: ModulusVec):
    return mm.barrett_reduce_u128(h, l_, *mv.col())


def tensor_prod_2x2_plain(ct1, ct2, mv: ModulusVec):
    """(2, L, N) x (2, L, N) -> (3, L, N)."""
    a0, a1, b0, b1 = ct1[0], ct1[1], ct2[0], ct2[1]
    h, l_ = mm.add_wide(*mm.mul_wide(a0, b1), *mm.mul_wide(a1, b0))
    return torch.stack([mul_rns_plain(a0, b0, mv), _reduce_cross(h, l_, mv),
                        mul_rns_plain(a1, b1, mv)])


def tensor_square_2x2_plain(ct, mv: ModulusVec):
    a0, a1 = ct[0], ct[1]
    h, l_ = mm.mul_wide(a0, a1)
    h, l_ = mm.add_wide(h, l_, h, l_)
    return torch.stack([mul_rns_plain(a0, a0, mv), _reduce_cross(h, l_, mv),
                        mul_rns_plain(a1, a1, mv)])


def sub_mul_shoup_plain(a, w, w_shoup, mv: ModulusVec, s=None):
    q = _col(mv.q)
    x = a if s is None else mm.sub_mod(a, s, q)
    return mm.mul_mod_shoup(x, _col(w), _col(w_shoup), q)


def tensor_prod_mxn(ct1, ct2, mv: ModulusVec):
    """(m, L, N) x (n, L, N) -> (m + n - 1, L, N), each output's wide
    products summed over 128 bits and reduced once (plain torch: only
    ciphertexts past size 2 take it)."""
    m, n = ct1.shape[0], ct2.shape[0]
    out = []
    for k in range(m + n - 1):
        acc = None
        for i in range(max(0, k - n + 1), min(m, k + 1)):
            w = mm.mul_wide(ct1[i], ct2[k - i])
            acc = w if acc is None else mm.add_wide(*acc, *w)
        out.append(_reduce_cross(*acc, mv))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# U4
# ---------------------------------------------------------------------------

def _launch(form: str, a, mv: ModulusVec, b=None, c=None, w=None,
            w_shoup=None, out_lead=None):
    """One U4 launch over a (G, L, N) (any leading shape; the Shoup form
    also takes (G, 1, N), one row read for each of mv's L limbs), b
    (Gb, L, N) with Gb == G or 1, c like the output."""
    a = a.contiguous()
    num_l, n = mv.q.shape[0], a.shape[-1]
    a_rows = a.shape[-2]
    if a_rows != num_l and not (form == "shoup" and a_rows == 1):
        raise ValueError(f"U4 {form}: {num_l} moduli for {a_rows} limbs")
    groups = a.numel() // (a_rows * n)
    shape = (a.shape[:-2] + (num_l, n) if out_lead is None
             else (out_lead, num_l, n))
    gb = 0
    if b is not None:
        b = b.contiguous()
        gb = b.numel() // (num_l * n)
        if b.shape[-2:] != a.shape[-2:] or gb not in (1, groups):
            raise ValueError(f"U4 {form}: b {tuple(b.shape)} against a "
                             f"{tuple(a.shape)}")
    if c is not None:
        c = c.contiguous()
        if c.shape != shape:
            raise ValueError(f"U4 {form}: c {tuple(c.shape)} against the "
                             f"output {tuple(shape)}")
    check_words(a, b, c, w, w_shoup, *mv)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.library().ptk_u64_polyops(
            FORMS.index(form), out.data_ptr(), a.data_ptr(), _ptr(b),
            _ptr(c), mv.q.data_ptr(), mv.ratio_lo.data_ptr(),
            mv.ratio_hi.data_ptr(), _ptr(w), _ptr(w_shoup), groups, gb,
            num_l, n, a_rows, _build.stream(a))
    _build.check(err, f"u64_polyops ({form})")
    mul_rns.launches += 1
    return out


def mul_rns(a, b, mv: ModulusVec):
    """U4: a b mod q; b (L, N) or a's shape."""
    if _build.is_plain(a, "mul_rns"):
        return mul_rns_plain(a, b, mv)
    return _launch("mul", a, mv, b=b)


def fma_rns(a, b, c, mv: ModulusVec):
    """U4: (a b + c) mod q."""
    if _build.is_plain(a, "fma_rns"):
        return fma_rns_plain(a, b, c, mv)
    return _launch("fma", a, mv, b=b, c=c)


def tensor_prod_2x2(ct1, ct2, mv: ModulusVec):
    """U4: the dyadic product of two size-2 ciphertexts, (3, L, N)."""
    if _build.is_plain(ct1, "tensor_prod_2x2"):
        return tensor_prod_2x2_plain(ct1, ct2, mv)
    if ct1.shape[0] != 2 or ct2.shape != ct1.shape:
        raise ValueError("tensor_prod_2x2 takes two (2, L, N) operands")
    return _launch("tensor", ct1, mv, b=ct2, out_lead=3)


def tensor_square_2x2(ct, mv: ModulusVec):
    """U4: (a0^2, 2 a0 a1, a1^2), (3, L, N)."""
    if _build.is_plain(ct, "tensor_square_2x2"):
        return tensor_square_2x2_plain(ct, mv)
    if ct.shape[0] != 2:
        raise ValueError("tensor_square_2x2 takes a (2, L, N) operand")
    return _launch("square", ct, mv, out_lead=3)


def sub_mul_shoup(a, w, w_shoup, mv: ModulusVec,
                  s: Optional[torch.Tensor] = None):
    """U4: (a - s) w mod q (a w without s); w, w_shoup (L,).  a (..., 1, N)
    stands for each of the L limbs (no s then): any 64-bit words."""
    if _build.is_plain(a, "sub_mul_shoup"):
        return sub_mul_shoup_plain(a, w, w_shoup, mv, s)
    return _launch("shoup", a, mv, c=s, w=w, w_shoup=w_shoup)


def rows_times(x, w, w_shoup, mv: ModulusVec, op=sub_mul_shoup):
    """x (..., 1, N), any 64-bit words, times w_l mod q_l for each of mv's
    L rows -> (..., L, N), by `op` (U4's Shoup form, which reads the one
    row for every limb).  With w = 1 and w_shoup = floor(2^64 / q) =
    mv.ratio_hi it is x mod q_l."""
    if w is None:
        w, w_shoup = torch.ones_like(mv.q), mv.ratio_hi
    return op(x, w, w_shoup, mv)


mul_rns.launches = 0

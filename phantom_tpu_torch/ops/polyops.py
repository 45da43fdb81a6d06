"""U4: the RNS products over u64 primes and the modular glue around them,
their plain versions and the CUDA kernel's wrappers, beside the
elementwise ops (counterpart of phantom_tpu/ops/polyops.py:22-103, the
Barrett product of phantom_tpu/ops/modmath.py:146 and the add_mod /
sub_mod the JAX package writes next to them, which it runs as XLA
fusions, no pallas_call).

Operands are (..., L, N) int64 words in [0, q).  add, sub and neg stay
plain torch; the products run on U4 (csrc/u64_polyops.cu), every form one
launch:

  mul_rns            a b mod q             (b may broadcast over a's
  fma_rns            a b + c mod q          leading groups: a plaintext)
  tensor_prod_2x2    (a0 b0, a0 b1 + a1 b0, a1 b1), the cross term summed
                     over 128 bits and reduced once (2 q^2 < q 2^64)
  tensor_square_2x2  (a0^2, 2 a0 a1, a1^2)
  tensor_prod_mxn    (m, L, N) x (n, L, N) -> (m + n - 1, L, N), each
                     output's products summed over 128 bits, reduced once
  shoup_rns          (a - s) w + c mod q with a per-limb w and its Shoup
                     word, s and c optional (the moddown's (x - delta)
                     P^-1 plus the ciphertext's addend, the rescale's
                     q_last^-1, the JAX package's scalar_mul_rns); a
                     (..., 1, N) row alone stands for every limb (row
                     times w_l, its slice read once)
  rescale_delta      ((x + half) mod q_last mod q_i - half mod q_i) of the
                     rescale's last-limb row, for every i
  modswitch_delta    BGV's modulus switch: x mod q_i + u (q_last mod q_i),
                     u = [-x q_last^-1]_t per column
  moddown_delta      BGV's moddown: dq_i - phalf_i + u (P mod q_i),
                     u = [-(dt - phalf_t) P^-1]_t per column

The products read the Barrett words of a ModulusVec (`mv.words`); the
Shoup and row forms a `Limbs` table of one call site, built once from
exact integers (`limbs`) and kept on the context's level (Level64).  The
kernel reads one layout: a Limbs table's first three rows are a
ModulusVec's words, and the products read only those.  The products
take the ModulusVec because their callers hold the base as one (the
NTT, the conversions, add_rns and the plain versions take it too);
a Limbs adds one call site's multipliers and scalars, which a base has
not, so one Limbs a base for the products would be a second object
beside every ModulusVec.  A
operands and addends may be strided between groups (x[..., :k-1, :] is
read in place); every row must be contiguous and 16-byte aligned, or the
wrapper raises.  All forms count in `mul_rns.launches`.  Outputs are
canonical, so each form is bit-equal to its plain version, which is the
composition of the plain calls it replaces.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import _build
from . import modmath as mm
from .rns_host import ModulusVec, i64_tensor

FORMS = ("mul", "fma", "tensor", "square", "mxn", "shoup", "shoup_sub",
         "shoup_add", "shoup_sub_add", "rows_times", "rescale_delta",
         "modswitch_delta", "moddown_delta")
# the rows of a Limbs table, L words each, then SCALARS words
ROWS = ("q", "ratio_lo", "ratio_hi", "w", "w_shoup", "e")
SCALARS = 4
_M64 = (1 << 64) - 1


class Limbs(NamedTuple):
    """One call site's per-limb words, the table U4's Shoup and row forms
    read through one pointer: the rows of ROWS (q with its Barrett words,
    the multiplier w with its Shoup word, an extra word e), then four
    scalars (words mod the scalar modulus: see each form)."""

    words: torch.Tensor
    num_l: int

    def row(self, name: str) -> torch.Tensor:
        i = ROWS.index(name) * self.num_l
        return self.words[i:i + self.num_l]

    def col(self, name: str) -> torch.Tensor:
        return self.row(name).view(-1, 1)

    def scalar(self, j: int) -> torch.Tensor:
        """Scalar j as a (1,) tensor."""
        i = len(ROWS) * self.num_l + j
        return self.words[i:i + 1]


def limbs(moduli: Sequence[int], w: Optional[Sequence[int]] = None,
          e: Optional[Sequence[int]] = None, scalars: Sequence[int] = (),
          device=None) -> Limbs:
    """A Limbs table from exact integers: the moduli q_l, the multipliers
    w_l < q_l (default 1) with their Shoup words floor(w 2^64 / q), e_l
    (default 0) and up to four scalars, one host-to-device copy."""
    qs = [int(q) for q in moduli]
    num_l = len(qs)
    ws = [1] * num_l if w is None else [int(v) for v in w]
    ratio = [(1 << 128) // q for q in qs]
    words = (qs + [r & _M64 for r in ratio] + [r >> 64 for r in ratio] + ws
             + [(v << 64) // q for v, q in zip(ws, qs)]
             + ([0] * num_l if e is None else [int(v) for v in e])
             + [int(s) for s in scalars] + [0] * (SCALARS - len(scalars)))
    return Limbs(i64_tensor(words, device), num_l)


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


def tensor_prod_mxn_plain(ct1, ct2, mv: ModulusVec):
    """(m, L, N) x (n, L, N) -> (m + n - 1, L, N), each output's wide
    products summed over 128 bits and reduced once."""
    m, n = ct1.shape[0], ct2.shape[0]
    out = []
    for k in range(m + n - 1):
        acc = None
        for i in range(max(0, k - n + 1), min(m, k + 1)):
            w = mm.mul_wide(ct1[i], ct2[k - i])
            acc = w if acc is None else mm.add_wide(*acc, *w)
        out.append(_reduce_cross(*acc, mv))
    return torch.stack(out)


def shoup_rns_plain(a, lw: Limbs, s=None, c=None, out=None):
    q = lw.col("q")
    x = a if s is None else mm.sub_mod(a, s, q)
    y = mm.mul_mod_shoup(x, lw.col("w"), lw.col("w_shoup"), q)
    if c is not None:
        y = mm.add_mod(y, c, q)
    return y if out is None else out.copy_(y)


def rescale_delta_plain(x, lw: Limbs):
    """x (..., 1, N) in [0, q_last); lw over q_0..q_{k-2} with e = half
    mod q_i and the scalars q_last, half."""
    q = lw.col("q")
    xl = mm.add_mod(x, lw.scalar(1), lw.scalar(0))
    red = mm.mul_mod_shoup(xl, 1, lw.col("ratio_hi"), q)
    return mm.sub_mod(red, lw.col("e"), q)


def modswitch_delta_plain(x, lw: Limbs):
    """x (..., 1, N) any words; lw over q_0..q_{k-2} with w = q_last mod
    q_i and the scalars t, [-q_last^-1]_t and its Shoup word."""
    q = lw.col("q")
    u = mm.mul_mod_shoup(x, lw.scalar(1), lw.scalar(2), lw.scalar(0))
    return mm.add_mod(mm.mul_mod_shoup(x, 1, lw.col("ratio_hi"), q),
                      mm.mul_mod_shoup(u, lw.col("w"), lw.col("w_shoup"), q),
                      q)


def moddown_delta_plain(dq, dt, lw: Limbs):
    """dq (..., L, N) in [0, q), dt (..., 1, N) in [0, t); lw with w = P
    mod q_i, e = (P - 1) / 2 mod q_i and the scalars t, (P - 1) / 2 mod t,
    [-P^-1]_t and its Shoup word."""
    q = lw.col("q")
    dq = mm.sub_mod(dq, lw.col("e"), q)
    dt = mm.sub_mod(dt, lw.scalar(1), lw.scalar(0))
    u = mm.mul_mod_shoup(dt, lw.scalar(2), lw.scalar(3), lw.scalar(0))
    return mm.add_mod(dq, mm.mul_mod_shoup(u, lw.col("w"),
                                           lw.col("w_shoup"), q), q)


# ---------------------------------------------------------------------------
# U4
# ---------------------------------------------------------------------------

_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev: torch.device) -> int:
    """PyTorch's current stream on dev, as _build.stream gives it."""
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _layout(x: torch.Tensor, what: str):
    """(groups, group stride in words) of an (..., R, N) operand of int64
    words whose rows are contiguous and 16-byte aligned and whose leading
    dimensions are one stride; ValueError otherwise."""
    n, r = x.shape[-1], x.shape[-2]
    if x.is_contiguous() and x.dtype == torch.int64 and not (
            n % 2 or x.data_ptr() % 16):
        return x.numel() // (r * n), r * n
    st = x.stride()
    if (x.dtype != torch.int64 or n % 2 or st[-1] != 1
            or (r > 1 and st[-2] != n) or x.data_ptr() % 16):
        raise ValueError(f"U4: {what} {tuple(x.shape)} must be int64 words "
                         "in contiguous, 16-byte aligned rows of even N")
    groups, gs = 1, r * n
    for size, stride in zip(x.shape[-3::-1], st[-3::-1]):
        if size == 1:
            continue
        if groups == 1:
            gs = stride
        elif stride != gs * groups:
            raise ValueError(f"U4: {what} {tuple(x.shape)} with strides "
                             f"{st}: its groups are not one stride")
        groups *= size
    if gs % 2:
        raise ValueError(f"U4: {what}'s groups are not 16-byte aligned")
    return groups, gs


def _dense(x: Optional[torch.Tensor], shape, what: str) -> None:
    """A b operand or an out slot: contiguous, aligned int64 of `shape`."""
    if x is not None and (tuple(x.shape) != tuple(shape)
                          or x.dtype != torch.int64 or not x.is_contiguous()
                          or x.data_ptr() % 16):
        raise ValueError(f"U4: {what} {tuple(x.shape)} must be contiguous, "
                         f"16-byte aligned int64 of shape {tuple(shape)}")


def _launch(form: str, a: torch.Tensor, table: torch.Tensor, num_l: int,
            shape, b=None, c=None, out=None, b_groups: int = 0,
            m: int = 0) -> torch.Tensor:
    """One U4 launch: a (read with its group stride), b contiguous, c
    (like the output, with its group stride), the constants table, into
    `out` (a new tensor of `shape`, or the slot given)."""
    groups, a_gs = _layout(a, "a")
    dev = a.device
    c_gs = 0
    if c is not None:
        if tuple(c.shape) != tuple(shape):
            raise ValueError(f"U4 {form}: c {tuple(c.shape)} against the "
                             f"output {tuple(shape)}")
        c_gs = _layout(c, "c")[1]
    if out is None:
        out = torch.empty(shape, dtype=torch.int64, device=dev)
    else:
        _dense(out, shape, "out")
    for x in (b, c, table, out):
        if x is not None and x.device != dev:
            raise ValueError(f"U4 {form}: operands on {x.device} and {dev}")
    words = (3 * num_l if FORMS.index(form) < FORMS.index("shoup")
             else len(ROWS) * num_l + SCALARS)  # the words the form reads
    if (table.dtype != torch.int64 or not table.is_contiguous()
            or table.numel() < words):
        raise ValueError(f"U4 {form}: the constants must be {words} "
                         "contiguous int64 words")
    args = (FORMS.index(form), out.data_ptr(), a.data_ptr(),
            None if b is None else b.data_ptr(),
            None if c is None else c.data_ptr(), table.data_ptr(), a_gs,
            c_gs, groups, b_groups, m, num_l, a.shape[-1], _stream(dev))
    lib = _build.library()
    if dev.index == torch.cuda.current_device():
        err = lib.ptk_u64_polyops(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.ptk_u64_polyops(*args)
    _build.check(err, f"u64_polyops ({form})")
    mul_rns.launches += 1
    return out


def _limbs_of(a: torch.Tensor, num_l: int, form: str) -> int:
    if a.shape[-2] != num_l:
        raise ValueError(f"U4 {form}: {num_l} moduli for {a.shape[-2]} "
                         "limbs")
    return a.numel() // (num_l * a.shape[-1])


def mul_rns(a, b, mv: ModulusVec):
    """U4: a b mod q; b (L, N) or a's shape."""
    if _build.is_plain(a, "mul_rns"):
        return mul_rns_plain(a, b, mv)
    num_l = mv.q.shape[0]
    groups = _limbs_of(a, num_l, "mul")
    gb = b.numel() // (num_l * a.shape[-1])
    if b.shape[-2:] != a.shape[-2:] or gb not in (1, groups):
        raise ValueError(f"U4 mul: b {tuple(b.shape)} against a "
                         f"{tuple(a.shape)}")
    _dense(b, b.shape, "b")
    return _launch("mul", a, mv.words, num_l, a.shape, b=b, b_groups=gb)


def fma_rns(a, b, c, mv: ModulusVec):
    """U4: (a b + c) mod q; b (L, N) or a's shape, c a's shape."""
    if _build.is_plain(a, "fma_rns"):
        return fma_rns_plain(a, b, c, mv)
    num_l = mv.q.shape[0]
    groups = _limbs_of(a, num_l, "fma")
    gb = b.numel() // (num_l * a.shape[-1])
    if b.shape[-2:] != a.shape[-2:] or gb not in (1, groups):
        raise ValueError(f"U4 fma: b {tuple(b.shape)} against a "
                         f"{tuple(a.shape)}")
    _dense(b, b.shape, "b")
    return _launch("fma", a, mv.words, num_l, a.shape, b=b, c=c,
                   b_groups=gb)


def tensor_prod_2x2(ct1, ct2, mv: ModulusVec):
    """U4: the dyadic product of two size-2 ciphertexts, (3, L, N)."""
    if _build.is_plain(ct1, "tensor_prod_2x2"):
        return tensor_prod_2x2_plain(ct1, ct2, mv)
    if ct1.dim() != 3 or ct1.shape[0] != 2 or ct2.shape != ct1.shape:
        raise ValueError("tensor_prod_2x2 takes two (2, L, N) operands")
    num_l = mv.q.shape[0]
    _limbs_of(ct1, num_l, "tensor")
    _dense(ct2, ct1.shape, "ct2")
    return _launch("tensor", ct1, mv.words, num_l, (3,) + ct1.shape[1:],
                   b=ct2, b_groups=2)


def tensor_square_2x2(ct, mv: ModulusVec):
    """U4: (a0^2, 2 a0 a1, a1^2), (3, L, N)."""
    if _build.is_plain(ct, "tensor_square_2x2"):
        return tensor_square_2x2_plain(ct, mv)
    if ct.dim() != 3 or ct.shape[0] != 2:
        raise ValueError("tensor_square_2x2 takes a (2, L, N) operand")
    num_l = mv.q.shape[0]
    _limbs_of(ct, num_l, "square")
    return _launch("square", ct, mv.words, num_l, (3,) + ct.shape[1:])


def tensor_prod_mxn(ct1, ct2, mv: ModulusVec):
    """U4: the product of an (m, L, N) and an (n, L, N) ciphertext,
    (m + n - 1, L, N)."""
    if _build.is_plain(ct1, "tensor_prod_mxn"):
        return tensor_prod_mxn_plain(ct1, ct2, mv)
    if ct1.dim() != 3 or ct2.dim() != 3 or ct1.shape[1:] != ct2.shape[1:]:
        raise ValueError("tensor_prod_mxn takes (m, L, N) and (n, L, N)")
    num_l = mv.q.shape[0]
    _limbs_of(ct1, num_l, "mxn")
    m, n = ct1.shape[0], ct2.shape[0]
    _dense(ct2, ct2.shape, "ct2")
    return _launch("mxn", ct1, mv.words, num_l,
                   (m + n - 1,) + ct1.shape[1:], b=ct2, b_groups=n, m=m)


def shoup_rns(a, lw: Limbs, s: Optional[torch.Tensor] = None,
              c: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None):
    """U4: ((a - s) w + c) mod q, s and c optional (a (..., L, N) in [0,
    q) where s is given, s contiguous), into `out` if given (contiguous).
    An a of one row (..., 1, N), any 64-bit words, without s and c stands
    for each of the L limbs: row times w_l."""
    if _build.is_plain(a, "shoup_rns"):
        return shoup_rns_plain(a, lw, s, c, out)
    num_l = lw.num_l
    row = a.shape[-2] == 1 and num_l > 1
    if row:
        if s is not None or c is not None:
            raise ValueError("U4 shoup: a row takes no s and no c")
        form = "rows_times"
    else:
        _limbs_of(a, num_l, "shoup")
        form = ("shoup", "shoup_sub", "shoup_add", "shoup_sub_add")[
            (s is not None) + 2 * (c is not None)]
    shape = a.shape[:-2] + (num_l, a.shape[-1])
    _dense(s, shape, "s")
    return _launch(form, a, lw.words, num_l, shape, b=s, c=c, out=out)


def _row_form(form: str, x, lw: Limbs, dq=None):
    if x.shape[-2] != 1:
        raise ValueError(f"U4 {form}: x {tuple(x.shape)} is not a row")
    shape = x.shape[:-2] + (lw.num_l, x.shape[-1])
    _dense(dq, shape, "dq")
    return _launch(form, x, lw.words, lw.num_l, shape, b=dq)


def rescale_delta(x, lw: Limbs):
    """U4: the rescale's rounding correction of the last limb x (..., 1,
    N) for each of lw's limbs (rescale_delta_plain)."""
    if _build.is_plain(x, "rescale_delta"):
        return rescale_delta_plain(x, lw)
    return _row_form("rescale_delta", x, lw)


def modswitch_delta(x, lw: Limbs):
    """U4: BGV's modulus-switch delta of the last limb x (..., 1, N)
    (modswitch_delta_plain)."""
    if _build.is_plain(x, "modswitch_delta"):
        return modswitch_delta_plain(x, lw)
    return _row_form("modswitch_delta", x, lw)


def moddown_delta(dq, dt, lw: Limbs):
    """U4: BGV's t-corrected moddown delta from its conversions to Ql (dq
    (..., L, N)) and to {t} (dt (..., 1, N)) (moddown_delta_plain)."""
    if _build.is_plain(dq, "moddown_delta"):
        return moddown_delta_plain(dq, dt, lw)
    if dt.numel() * lw.num_l != dq.numel():
        raise ValueError(f"U4 moddown_delta: dq {tuple(dq.shape)} against "
                         f"dt {tuple(dt.shape)}")
    return _row_form("moddown_delta", dt, lw, dq)


mul_rns.launches = 0

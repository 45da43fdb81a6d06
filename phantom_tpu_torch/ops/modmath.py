"""64-bit modular arithmetic in plain torch (counterpart of
phantom_tpu/ops/modmath.py:30-179).

A u64 word is the int64 tensor of its bit pattern.  int64 products and
sums wrap mod 2^64 as u64 ones do, so they need nothing; three things
differ from u64 and are handled here: `>>` is arithmetic (`srl` masks
after the shift), a comparison of words that may reach 2^63 must be
unsigned (`lt_u` flips the sign bit), and a Shoup word floor(w 2^64 / q)
fills all 64 bits.  The wide products are built from 32-bit halves, as
in the JAX package.  Every modulus is below 2^61 (the reference's
MOD_BIT_COUNT_MAX), so 4q < 2^63 and the lazy values below compare
signed.

Value ranges follow Harvey's lazy reduction: `*_lazy` results in [0, 2q),
the others in [0, q).  These are the arithmetic of every plain version
of the u64 kernels (ops/ntt.py, bconv.py, polyops.py,
schemes/keyswitch.py) and of the evaluator's glue.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
SIGN = -(1 << 63)


def srl(x, k: int):
    """Logical right shift of u64 words by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def lt_u(a, b):
    """a < b as u64 words."""
    return (a ^ SIGN) < (b ^ SIGN)


def mul_wide(a, b):
    """64 x 64 -> 128-bit product as (hi, lo): the low word is int64's
    wrapping product."""
    return mul_hi(a, b), a * b


def mul_hi(a, b):
    """The high 64 bits of the 64 x 64 product, from four 32 x 32 -> 64
    partial products (the middle sum is below 3 2^32, so its shift needs
    no mask)."""
    a0, a1 = a & MASK32, srl(a, 32)
    b0, b1 = b & MASK32, srl(b, 32)
    p01 = a0 * b1
    p10 = a1 * b0
    mid = srl(a0 * b0, 32) + (p01 & MASK32) + (p10 & MASK32)
    return a1 * b1 + srl(p01, 32) + srl(p10, 32) + (mid >> 32)


def add_wide(a_hi, a_lo, b_hi, b_lo):
    """128 + 128 -> 128 (mod 2^128) as (hi, lo)."""
    lo = a_lo + b_lo
    return a_hi + b_hi + lt_u(lo, a_lo).long(), lo


def add_u64_carry(a, b):
    """64 + 64 -> (sum mod 2^64, carry)."""
    s = a + b
    return s, lt_u(s, a).long()


def csub(x, q):
    """x - q if x >= q else x, for x < 2^63: [0, 2q) -> [0, q)."""
    return torch.where(x >= q, x - q, x)


def add_mod(a, b, q):
    return csub(a + b, q)


def sub_mod(a, b, q):
    return csub(a - b + q, q)


def neg_mod(a, q):
    return torch.where(a == 0, torch.zeros_like(a), q - a)


def barrett_reduce_u64(x, q, ratio_hi):
    """x mod q for any 64-bit x; ratio_hi = floor(2^128 / q) >> 64."""
    return csub(x - mul_hi(x, ratio_hi) * q, q)


def _barrett_quotient(x_hi, x_lo, ratio_lo, ratio_hi):
    """floor(x ratio / 2^128) less at most one, mod 2^64."""
    c = mul_hi(x_lo, ratio_lo)
    ha, la = mul_wide(x_lo, ratio_hi)
    hb, lb = mul_wide(x_hi, ratio_lo)
    s1, c1 = add_u64_carry(la, c)
    _, c2 = add_u64_carry(s1, lb)
    return x_hi * ratio_hi + ha + hb + c1 + c2


def barrett_reduce_u128(x_hi, x_lo, q, ratio_lo, ratio_hi):
    """(x_hi 2^64 + x_lo) mod q for x < q 2^64."""
    k = _barrett_quotient(x_hi, x_lo, ratio_lo, ratio_hi)
    return csub(x_lo - k * q, q)


def barrett_div_mod_u128(x_hi, x_lo, q, ratio_lo, ratio_hi):
    """Exact (floor(x / q) mod 2^64, x mod q) for x < q 2^64."""
    k = _barrett_quotient(x_hi, x_lo, ratio_lo, ratio_hi)
    r = x_lo - k * q
    fix = (r >= q).long()
    return k + fix, r - fix * q


def mul_mod(a, b, q, ratio_lo, ratio_hi):
    """(a b) mod q by the full 128-bit Barrett reduction; a, b < 2^63."""
    hi, lo = mul_wide(a, b)
    return barrett_reduce_u128(hi, lo, q, ratio_lo, ratio_hi)


def mul_mod_shoup_lazy(x, w, w_shoup, q):
    """x w mod q in [0, 2q) for any 64-bit x, w < q, w_shoup =
    floor(w 2^64 / q)."""
    return x * w - mul_hi(x, w_shoup) * q


def mul_mod_shoup(x, w, w_shoup, q):
    return csub(mul_mod_shoup_lazy(x, w, w_shoup, q), q)


def fma_mod(a, b, c, q, ratio_lo, ratio_hi):
    """(a b + c) mod q with c in [0, q)."""
    return add_mod(mul_mod(a, b, q, ratio_lo, ratio_hi), c, q)


def reduce_i64_centered(x, q):
    """Signed x in (-2^62, 2^62) -> [0, q)."""
    return torch.remainder(x, q)

"""Automatic CKKS polynomial evaluation: Paterson-Stockmeyer BSGS with
exact scale management (counterpart of phantom_tpu/schemes/poly.py).

p(ct) for a polynomial with plaintext coefficients, in the monomial or
the Chebyshev basis, by the baby-step/giant-step split

    p(x) = hi(x) x^(bs 2^k) + lo(x)      (recursively on hi and lo)

so the depth is about log2(deg) + 1 and the ciphertext products about
bs + gs.  Every addition's operands reach the same (scale, level)
because each plaintext coefficient is encoded at exactly the scale its
term needs, so no correcting product by an encoded 1.0 is inserted.
Results are unrescaled (scale about the input's squared): the caller
spends the final rescale, as after multiply_and_relin.  The schedule, the
scales and every verb are the JAX package's, so an evaluation is bit-equal
to it on the same inputs: poly_eval and poly_eval_cheb on the u64
evaluator (schemes/evaluate.py, `ops` a Kernels64), poly_eval_fast32 and
poly_eval_cheb_fast32 on a Fast32 evaluator.  The encoder argument is
either the host CKKSEncoder or the CKKSDeviceEncoder.

Precision: as in all rescale-chain CKKS code, the power ladder's scale
stays within a few bits of the input's only where the rescale primes are
close to the scale (the standard choice); with 50-bit primes and a
44-bit scale each rung loses about 6 bits.
"""

from __future__ import annotations

import numpy as np

from ..ops.pipeline32 import KERNELS, Kernels
from . import evaluate as ev
from .keyswitch import KERNELS64, Kernels64

__all__ = ["poly_eval", "poly_eval_fast32", "poly_eval_cheb",
           "poly_eval_cheb_fast32", "chebyshev_fit", "poly_depth",
           "bsgs_counts"]

_TOL = 1e-6  # the JAX package's scale tolerance (evaluate._check_compatible)


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def bsgs_counts(degree: int, bs: int | None = None) -> tuple[int, int]:
    """(baby, giant) sizes for a degree; bs is a power of two."""
    if bs is None:
        bs = _pow2_ceil(max(1, int(round(np.sqrt(degree + 1)))))
    else:
        bs = _pow2_ceil(bs)
    return bs, -(-(degree + 1) // bs)


def poly_depth(degree: int, bs: int | None = None) -> int:
    """Levels the evaluation consumes before the caller's final rescale
    (the power ladder and the giant products)."""
    bs, _ = bsgs_counts(degree, bs)
    if degree < bs:
        return (degree - 1).bit_length()
    k_top = (degree // bs).bit_length() - 1
    return (bs.bit_length() - 1) + k_top + 1


# -- engines ------------------------------------------------------------------

class _Engine:
    """The verbs every engine shares: scales and levels, plaintext
    constants through the encoder (its kernels `ops`), the prime a
    rescale drops."""

    def __init__(self, ctx, enc, ops: Kernels = KERNELS):
        self.ctx, self.enc, self.ops = ctx, enc, ops

    def scale(self, c):
        return c.scale

    def chain(self, c):
        return c.chain_index

    def set_scale(self, c, s: float):
        assert abs(c.scale - s) <= _TOL * s, \
            f"internal scale drift: {c.scale} vs {s}"
        return c.replace(scale=s)

    def _pt(self, value: float, s_pt: float, level: int):
        return self.enc.encode(np.full(self.enc.slots, value), s_pt, level,
                               ops=self.ops)

    def drop_prime(self, level: int) -> float:
        """The prime a rescale at `level` removes."""
        return float(self.ctx.get_context_data(level).moduli[-1])


class _U64Engine(_Engine):
    """The verbs on the u64 evaluator, each through `ops`."""

    def __init__(self, ctx, rlk, enc, ops: Kernels64 = KERNELS64):
        super().__init__(ctx, enc, ops)
        self.rlk = rlk

    def mult(self, a, b):
        if a.chain_index != b.chain_index:
            tgt = max(a.chain_index, b.chain_index)
            a = ev.mod_switch_to(self.ctx, a, tgt, self.ops)
            b = ev.mod_switch_to(self.ctx, b, tgt, self.ops)
        if a is b:
            return ev.relinearize(self.ctx, ev.square(self.ctx, a, self.ops),
                                  self.rlk, self.ops)
        return ev.multiply_and_relin(self.ctx, a, b, self.rlk, self.ops)

    def rescale(self, c):
        return ev.rescale_to_next(self.ctx, c, self.ops)

    def mod_switch_to(self, c, level: int):
        return ev.mod_switch_to(self.ctx, c, level, self.ops)

    def mult_plain_const(self, c, value: float, s_pt: float):
        return ev.multiply_plain(
            self.ctx, c, self._pt(value, s_pt, c.chain_index), self.ops)

    def add_const(self, c, value: float):
        return ev.add_plain(
            self.ctx, c, self._pt(value, c.scale, c.chain_index), self.ops)

    def add(self, a, b):
        return ev.add(self.ctx, a, b, self.ops)

    def sub(self, a, b):
        return ev.sub(self.ctx, a, b, self.ops)


class _Fast32Engine(_Engine):
    """The verbs on a Fast32 evaluator, each through `ops`."""

    def __init__(self, fast, enc, ops: Kernels = KERNELS):
        super().__init__(fast.ctx, enc, ops)
        self.fast = fast

    def mult(self, a, b):
        while a.chain_index < b.chain_index:
            a = self.fast.mod_switch_to_next(a, self.ops)
        while b.chain_index < a.chain_index:
            b = self.fast.mod_switch_to_next(b, self.ops)
        if a is b:
            return self.fast.square_and_relin(a, self.ops)
        return self.fast.multiply_and_relin(a, b, self.ops)

    def rescale(self, c):
        return self.fast.rescale_to_next(c, self.ops)

    def mod_switch_to(self, c, level: int):
        while c.chain_index < level:
            c = self.fast.mod_switch_to_next(c, self.ops)
        return c

    def mult_plain_const(self, c, value: float, s_pt: float):
        return self.fast.multiply_plain(
            c, self._pt(value, s_pt, c.chain_index), self.ops)

    def add_const(self, c, value: float):
        return self.fast.add_plain(
            c, self._pt(value, c.scale, c.chain_index), self.ops)

    def add(self, a, b):
        return self.fast.add(a, b)

    def sub(self, a, b):
        return self.fast.sub(a, b)


# -- the evaluator ------------------------------------------------------------

class _PolyEvaluator:
    def __init__(self, E, ct, bs: int, basis: str = "monomial"):
        self.E = E
        self.bs = bs
        self.basis = basis
        self.pw = {1: ct}

    def power(self, i: int):
        """x^i (or T_i) by binary splitting, each built once and rescaled.

        Chebyshev splits take i = a + b with a - b in {0, 1}, so the
        linearization T_{a+b} = 2 T_a T_b - T_{a-b} corrects only by the
        constant T_0 = 1 or by a plain-rescaled copy of T_1."""
        E = self.E
        if i not in self.pw:
            if self.basis == "chebyshev":
                a = -(-i // 2)
                b = i // 2
            else:
                a = 1 << (i.bit_length() - 1)
                b = i - a
                if b == 0:
                    a = b = i // 2
            x = self.power(a)
            y = x if b == a else self.power(b)
            prod = E.mult(x, y)
            if self.basis == "chebyshev":
                prod = E.add(prod, prod)           # 2 T_a T_b
                if a == b:                         # - T_0 = -1
                    prod = E.add_const(prod, -1.0)
                else:                              # - T_1, plain-rescaled
                    t1 = self.pw[1]
                    adj = E.mult_plain_const(
                        t1, 1.0, E.scale(prod) / E.scale(t1))
                    adj = E.set_scale(
                        E.mod_switch_to(adj, E.chain(prod)), E.scale(prod))
                    prod = E.sub(prod, adj)
            self.pw[i] = E.rescale(prod)
        return self.pw[i]

    def _split(self, c, m: int):
        """(quotient, remainder) of p by the m-th basis polynomial:
        monomial p = hi x^m + lo; Chebyshev by T_i = 2 T_{i-m} T_m -
        T_{2m-i} (m <= i < 2m, which the giant step guarantees)."""
        if self.basis != "chebyshev":
            return list(c[m:]), list(c[:m])
        c = list(c)
        deg = len(c) - 1
        quot = [0.0] * (deg - m + 1)
        for i in range(deg, m, -1):
            ci = c[i]
            if ci != 0.0:
                quot[i - m] += 2.0 * ci
                c[2 * m - i] -= ci
        quot[0] += c[m]
        return quot, c[:m]

    def chunk(self, c, s_target: float, level: int):
        """The degree-below-bs tail sum_i c[i] x^i at exactly (s_target,
        level): (ciphertext or None, the constant term left over)."""
        E = self.E
        acc = None
        for i in range(1, len(c)):
            if c[i] == 0.0:
                continue
            p = self.power(i)
            term = E.mult_plain_const(p, float(c[i]), s_target / E.scale(p))
            term = E.set_scale(E.mod_switch_to(term, level), s_target)
            acc = term if acc is None else E.add(acc, term)
        return acc, float(c[0])

    def eval_rec(self, c, s_target: float, level: int):
        """p(x) at exactly (s_target, level): (ciphertext or None, c0)."""
        E, bs = self.E, self.bs
        c = list(c)
        while len(c) > 1 and c[-1] == 0.0:   # splits can leave zero tails
            c.pop()
        deg = len(c) - 1
        if deg < bs:
            return self.chunk(c, s_target, level)
        k = (deg // bs).bit_length() - 1
        g = self.giants[k]
        g_level = E.chain(g)
        s_hi = s_target * E.drop_prime(g_level) / E.scale(g)
        hi_c, lo_c = self._split(c, bs << k)
        hi_ct, hi_c0 = self.eval_rec(hi_c, s_hi, g_level)
        if hi_ct is not None:
            if hi_c0 != 0.0:
                hi_ct = E.add_const(hi_ct, hi_c0)
            prod = E.rescale(E.mult(hi_ct, g))
        elif hi_c0 != 0.0:
            prod = E.mult_plain_const(g, hi_c0, s_target / E.scale(g))
        else:
            prod = None
        if prod is not None:
            prod = E.set_scale(E.mod_switch_to(prod, level), s_target)
        lo_ct, lo_c0 = self.eval_rec(lo_c, s_target, level)
        if prod is None:
            return lo_ct, lo_c0
        if lo_ct is None:
            return prod, lo_c0
        return E.add(prod, lo_ct), lo_c0

    def _check_headroom(self, level: int, s_target: float):
        """The modulus left at `level` must hold the unrescaled result
        (plus headroom for value and noise), or values wrap."""
        cd = self.E.ctx.get_context_data(level)
        bits = sum(int(q).bit_length() for q in cd.moduli)
        need = np.log2(s_target) + 16
        if bits < need:
            raise ValueError(
                f"chain too short for this polynomial: level {level} has "
                f"{bits} modulus bits, the unrescaled result needs "
                f"~{need:.0f}; add levels or lower the degree")

    def run(self, coeffs):
        E, bs = self.E, self.bs
        deg = len(coeffs) - 1
        ct = self.pw[1]
        if deg < bs:
            # no giants: one chunk at the deepest power's level
            level = max(E.chain(self.power(i))
                        for i in range(1, deg + 1) if coeffs[i] != 0.0)
            self._check_headroom(level, E.scale(ct) ** 2)
            out, c0 = self.chunk(coeffs, E.scale(ct) ** 2, level)
        else:
            k_top = (deg // bs).bit_length() - 1
            # power() memoizes, so the giant ladder is the doubling chain
            self.giants = [self.power(bs << j) for j in range(k_top + 1)]
            level = E.chain(self.giants[k_top]) + 1
            self._check_headroom(level, E.scale(ct) ** 2)
            out, c0 = self.eval_rec(coeffs, E.scale(ct) ** 2, level)
        if out is None:
            raise ValueError("polynomial has no non-constant term at this "
                             "baby-step size; evaluate it as a plain add")
        return E.add_const(out, c0) if c0 != 0.0 else out


def _prep_coeffs(coeffs):
    c = [float(v) for v in np.asarray(coeffs, dtype=np.float64).ravel()]
    while len(c) > 1 and c[-1] == 0.0:
        c.pop()
    if len(c) < 2:
        raise ValueError("poly_eval needs degree >= 1 (constant "
                         "polynomials are a plain add)")
    return c


def poly_eval(ctx, ct, coeffs, rlk, enc, bs: int | None = None,
              ops: Kernels64 = KERNELS64):
    """sum_i coeffs[i] ct^i on the u64 evaluator, coefficients in the
    monomial basis, low order first; returns an unrescaled ciphertext
    (scale about ct.scale^2): rescale_to_next it."""
    c = _prep_coeffs(coeffs)
    bs, _ = bsgs_counts(len(c) - 1, bs)
    return _PolyEvaluator(_U64Engine(ctx, rlk, enc, ops), ct, bs).run(c)


def poly_eval_fast32(fast, ct, coeffs, enc, bs: int | None = None,
                     ops: Kernels = KERNELS):
    """sum_i coeffs[i] ct^i on a Fast32 evaluator, coefficients in the
    monomial basis, low order first; returns an unrescaled ciphertext
    (scale about ct.scale^2): rescale_to_next it."""
    c = _prep_coeffs(coeffs)
    bs, _ = bsgs_counts(len(c) - 1, bs)
    return _PolyEvaluator(_Fast32Engine(fast, enc, ops), ct, bs).run(c)


# -- the Chebyshev basis ------------------------------------------------------

def chebyshev_fit(fn, degree: int, interval=(-1.0, 1.0)) -> np.ndarray:
    """Chebyshev-series coefficients of fn over [a, b], interpolated at
    the Chebyshev nodes of the interval (near minimax; the coefficients
    stay of the order of max |fn|)."""
    a, b = float(interval[0]), float(interval[1])
    k = np.arange(degree + 1)
    t = np.cos(np.pi * (k + 0.5) / (degree + 1))      # nodes in [-1, 1]
    x = 0.5 * (b - a) * t + 0.5 * (a + b)
    return np.polynomial.chebyshev.chebfit(t, np.asarray(fn(x)), degree)


def _cheb_run(E, ct, c, bs, interval):
    if interval is not None:
        a, b = float(interval[0]), float(interval[1])
        if (a, b) != (-1.0, 1.0):
            # t = (2x - (a + b)) / (b - a): one level (plain product,
            # rescale)
            s_pt = E.drop_prime(E.chain(ct))
            t = E.mult_plain_const(ct, 2.0 / (b - a), s_pt)
            if a + b != 0.0:
                t = E.add_const(t, -(a + b) / (b - a))
            ct = E.rescale(t)
    bs, _ = bsgs_counts(len(c) - 1, bs)
    return _PolyEvaluator(E, ct, bs, basis="chebyshev").run(c)


def poly_eval_cheb(ctx, ct, cheb_coeffs, rlk, enc, bs: int | None = None,
                   interval=None, ops: Kernels64 = KERNELS64):
    """sum_i c_i T_i(ct) on the u64 evaluator (the same schedule through
    T_i = 2 T_{i-m} T_m - T_{2m-i}).  `interval=(a, b)` first maps ct into
    [-1, 1] (one level); returns an unrescaled ciphertext."""
    c = _prep_coeffs(cheb_coeffs)
    return _cheb_run(_U64Engine(ctx, rlk, enc, ops), ct, c, bs, interval)


def poly_eval_cheb_fast32(fast, ct, cheb_coeffs, enc, bs: int | None = None,
                          interval=None, ops: Kernels = KERNELS):
    """sum_i c_i T_i(ct) on a Fast32 evaluator (the same schedule through
    T_i = 2 T_{i-m} T_m - T_{2m-i}).  `interval=(a, b)` first maps ct into
    [-1, 1] (one level); returns an unrescaled ciphertext."""
    c = _prep_coeffs(cheb_coeffs)
    return _cheb_run(_Fast32Engine(fast, enc, ops), ct, c, bs, interval)

"""Exact-integer number theory for parameters and tables.

The port's own copy of what it uses of phantom_tpu/host/numth.py:
Miller-Rabin primality, the NTT-friendly prime searches (primes == 1 mod
2N, downward from 2^bits or from a bound), modular inverses and the
minimal primitive 2N-th root of unity.  Pure Python with exact integers; the minimal-root walk over
the N odd powers is vectorised with numpy (every modulus here is below
2^31, so each product fits 64 bits).
"""

from __future__ import annotations

from typing import List

import numpy as np

# Deterministic Miller-Rabin witnesses for all n < 3.3e24 (covers u64).
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
_SMALL_PRIMES = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for 64-bit-range integers."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n == p:
            return True
        if n % p == 0:
            return False
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def get_primes(factor: int, bit_size: int, count: int) -> List[int]:
    """`count` primes p of exactly `bit_size` bits with p == 1 (mod factor),
    the largest first."""
    if bit_size < 2 or bit_size > 61:
        raise ValueError(f"prime bit_size must be in [2, 61], got {bit_size}")
    out: List[int] = []
    value = (1 << bit_size) - 1
    value -= (value - 1) % factor
    while len(out) < count and value.bit_length() == bit_size:
        if is_prime(value):
            out.append(value)
        value -= factor
    if len(out) < count:
        raise ValueError(
            f"failed to find {count} {bit_size}-bit primes == 1 mod {factor}")
    return out


def get_primes_below(upper_bound: int, factor: int, count: int) -> List[int]:
    """`count` primes p < upper_bound with p == 1 (mod factor), the largest
    first: BFV's auxiliary base Rl below min(QP)."""
    out: List[int] = []
    value = upper_bound - 1
    value -= (value - 1) % factor
    while len(out) < count and value > factor:
        if is_prime(value):
            out.append(value)
        value -= factor
    if len(out) < count:
        raise ValueError(f"failed to find {count} primes below {upper_bound} "
                         f"== 1 mod {factor}")
    return out


def invert_mod(value: int, modulus: int) -> int:
    value %= modulus
    try:
        return pow(value, -1, modulus)
    except ValueError:
        raise ValueError(f"{value} not invertible mod {modulus}") from None


def powers_mod(base: int, count: int, q: int) -> np.ndarray:
    """base^0 .. base^(count-1) mod q as uint64, for q < 2^31."""
    out = np.ones(1, dtype=np.uint64)
    while out.size < count:
        step = pow(base, out.size, q)
        out = np.concatenate([out, out * np.uint64(step) % np.uint64(q)])
    return out[:count]


def minimal_primitive_root(degree: int, modulus: int) -> int:
    """The least primitive `degree`-th root of unity mod the prime
    `modulus` (degree a power of two dividing modulus - 1): the first base
    b = 2, 3, ... whose b^((q-1)/degree) is primitive gives a root, and the
    least of its odd powers is the answer."""
    if (modulus - 1) % degree:
        raise ValueError(f"no primitive {degree}-th root mod {modulus}")
    quotient = (modulus - 1) // degree
    for base in range(2, min(modulus, 2002)):
        root = pow(base, quotient, modulus)
        if pow(root, degree // 2, modulus) == modulus - 1:
            break
    else:
        raise ValueError(f"no primitive {degree}-th root mod {modulus}")
    if degree <= 2:
        return root
    odd = powers_mod(root * root % modulus, degree // 2, modulus)
    return int((odd * np.uint64(root) % np.uint64(modulus)).min())

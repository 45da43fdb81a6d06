"""Shoup words, the coefficient and the plain moduli (the port's copy of
phantom_tpu/host/modulus.py: compute_shoup, CoeffModulus.create and
PlainModulus.batching).  The JAX package's `Modulus` object, with its
2^128 Barrett ratio, has no counterpart: the port's tables take plain
integer moduli, so the factories return integers."""

from __future__ import annotations

from typing import List, Sequence

from . import numth


def compute_shoup(operand: int, modulus: int) -> int:
    """Shoup companion word floor(operand * 2^64 / modulus), operand <
    modulus."""
    if operand >= modulus:
        raise ValueError("compute_shoup requires operand < modulus")
    return (operand << 64) // modulus


class CoeffModulus:
    """NTT-friendly coefficient-modulus chains."""

    @staticmethod
    def create(poly_modulus_degree: int, bit_sizes: Sequence[int]
               ) -> List[int]:
        """Distinct primes == 1 mod 2N of the requested bit sizes, searched
        downward from 2^bits; equal sizes take the next prime down."""
        n = int(poly_modulus_degree)
        if n < 2 or n & (n - 1):
            raise ValueError("poly_modulus_degree must be a power of two >= 2")
        counts = {}
        for b in bit_sizes:
            if not 2 <= b <= 61:
                raise ValueError(f"bit size {b} out of [2, 61]")
            counts[b] = counts.get(b, 0) + 1
        pools = {b: numth.get_primes(2 * n, b, c) for b, c in counts.items()}
        taken = dict.fromkeys(counts, 0)
        out = []
        for b in bit_sizes:
            out.append(pools[b][taken[b]])
            taken[b] += 1
        return out


class PlainModulus:
    """Batching-capable plain moduli: primes == 1 mod 2N."""

    @staticmethod
    def batching(poly_modulus_degree: int, bit_size: int) -> int:
        """The largest `bit_size`-bit prime == 1 mod 2N, as an integer (the
        JAX package returns it wrapped in a Modulus)."""
        n = int(poly_modulus_degree)
        if n < 2 or n & (n - 1):
            raise ValueError("poly_modulus_degree must be a power of two >= 2")
        return numth.get_primes(2 * n, bit_size, 1)[0]

"""Shoup words and the plain modulus (the port's copy of
phantom_tpu/host/modulus.py:compute_shoup and PlainModulus.batching).
The JAX package's `Modulus` object, with its 2^128 Barrett ratio, has no
counterpart: the port's tables take plain integer moduli."""

from __future__ import annotations

from . import numth


def compute_shoup(operand: int, modulus: int) -> int:
    """Shoup companion word floor(operand * 2^64 / modulus), operand <
    modulus."""
    if operand >= modulus:
        raise ValueError("compute_shoup requires operand < modulus")
    return (operand << 64) // modulus


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

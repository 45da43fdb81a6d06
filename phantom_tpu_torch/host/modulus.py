"""Shoup words (the port's copy of phantom_tpu/host/modulus.py:compute_shoup).
The JAX package's `Modulus` object, with its 2^128 Barrett ratio, has no
counterpart: the port's tables take plain integer moduli."""

from __future__ import annotations


def compute_shoup(operand: int, modulus: int) -> int:
    """Shoup companion word floor(operand * 2^64 / modulus), operand <
    modulus."""
    if operand >= modulus:
        raise ValueError("compute_shoup requires operand < modulus")
    return (operand << 64) // modulus

"""Default coefficient-modulus chains per security level (the port's copy
of phantom_tpu/host/globals_.py).

NTT-friendly primes == 1 mod 2N whose bit sizes fill the HE-standard
budget of each N (host/hestd.py), derived as CoeffModulus.create derives
them, so the chains are the JAX package's prime for prime; the port's
chains are lists of integers.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

from . import hestd
from .modulus import CoeffModulus

# bit sizes per prime, a ladder that fills the HE-standard budget of each N
_PROFILES = {
    128: {
        1024: [27],
        2048: [54],
        4096: [36, 36, 37],
        8192: [43, 43, 44, 44, 44],
        16384: [48, 48, 48, 49, 49, 49, 49, 49, 49],
        32768: [55] * 14 + [56, 56],
    },
    192: {
        1024: [19],
        2048: [37],
        4096: [25, 25, 25],
        8192: [38, 38, 38, 38],
        16384: [43, 43, 43, 44, 44, 44, 44],
        32768: [50] * 4 + [51] * 8,
    },
    256: {
        1024: [14],
        2048: [29],
        4096: [29, 29],
        8192: [39, 39, 40],
        16384: [47, 47, 47, 48, 48],
        32768: [53] * 9,
    },
}


@lru_cache(maxsize=None)
def _default_chain(n: int, sec: int) -> tuple:
    profiles = _PROFILES[sec]
    if n not in profiles:
        raise ValueError(f"no default coeff modulus for N={n} at {sec}-bit "
                         "security")
    bits = profiles[n]
    assert sum(bits) <= hestd.max_coeff_modulus_bits(n, sec)
    return tuple(CoeffModulus.create(n, bits))


def default_coeff_modulus_128(poly_modulus_degree: int) -> List[int]:
    return list(_default_chain(poly_modulus_degree, 128))


def default_coeff_modulus_192(poly_modulus_degree: int) -> List[int]:
    return list(_default_chain(poly_modulus_degree, 192))


def default_coeff_modulus_256(poly_modulus_degree: int) -> List[int]:
    return list(_default_chain(poly_modulus_degree, 256))

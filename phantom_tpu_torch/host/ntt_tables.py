"""NTT twiddle tables (the port's copy of phantom_tpu/host/ntt_tables.py).

For each prime q == 1 mod 2N: psi, the least primitive 2N-th root of
unity, and the powers of psi and psi^-1 in bit-reversed order (the stage
with m groups reads entries [m, 2m)), with their 64-bit Shoup words
floor(w * 2^64 / q) and N^-1.  Vectorised with numpy: every modulus is
below 2^31, so each product and each w * 2^32 fits 64 bits.  Bit-equal to
the JAX package's tables (tests/test_torch_ntt.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from . import numth
from .modulus import compute_shoup


@dataclass(frozen=True)
class RNSNTTTables:
    """Tables stacked over an RNS base: (L, N) and (L,) uint64 arrays."""

    n: int
    moduli: tuple
    root_powers: np.ndarray
    root_powers_shoup: np.ndarray
    inv_root_powers: np.ndarray
    inv_root_powers_shoup: np.ndarray
    inv_degree: np.ndarray
    inv_degree_shoup: np.ndarray


def bit_reverse_indices(logn: int) -> np.ndarray:
    """rev[i] = i with its logn low bits reversed, int64 (N,)."""
    i = np.arange(1 << logn, dtype=np.int64)
    rev = np.zeros_like(i)
    for b in range(logn):
        rev |= ((i >> b) & 1) << (logn - 1 - b)
    return rev


def _shoup64(w: np.ndarray, q: int) -> np.ndarray:
    """floor(w * 2^64 / q) for w < q < 2^31, as hi * 2^32 + lo."""
    qq = np.uint64(q)
    w32 = w << np.uint64(32)
    hi, r = w32 // qq, w32 % qq
    return (hi << np.uint64(32)) | ((r << np.uint64(32)) // qq)


def _one(n: int, q: int, rev: np.ndarray):
    if q >= 1 << 31 or (q - 1) % (2 * n):
        raise ValueError(f"modulus {q} is not NTT-friendly for N={n} "
                         "below 2^31")
    psi = numth.minimal_primitive_root(2 * n, q)
    fwd = numth.powers_mod(psi, n, q)[rev]
    inv = numth.powers_mod(numth.invert_mod(psi, q), n, q)[rev]
    return fwd, _shoup64(fwd, q), inv, _shoup64(inv, q)


def make_rns_ntt_tables(n: int, moduli: Sequence[int]) -> RNSNTTTables:
    logn = n.bit_length() - 1
    rev = bit_reverse_indices(logn)
    moduli = tuple(int(q) for q in moduli)
    parts = [_one(n, q, rev) for q in moduli]
    inv_degree = [numth.invert_mod(n, q) for q in moduli]
    return RNSNTTTables(
        n=n, moduli=moduli,
        root_powers=np.stack([p[0] for p in parts]),
        root_powers_shoup=np.stack([p[1] for p in parts]),
        inv_root_powers=np.stack([p[2] for p in parts]),
        inv_root_powers_shoup=np.stack([p[3] for p in parts]),
        inv_degree=np.array(inv_degree, dtype=np.uint64),
        inv_degree_shoup=np.array([compute_shoup(v, q) for v, q in zip(
            inv_degree, moduli)], dtype=np.uint64))

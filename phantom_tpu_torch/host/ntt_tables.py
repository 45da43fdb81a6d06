"""NTT twiddle tables (the port's copy of phantom_tpu/host/ntt_tables.py).

For each prime q == 1 mod 2N: psi, the least primitive 2N-th root of
unity, and the powers of psi and psi^-1 in bit-reversed order (the stage
with m groups reads entries [m, 2m)), with their 64-bit Shoup words
floor(w * 2^64 / q) and N^-1.  Vectorised with numpy where every
modulus is below 2^31 (each product and each w * 2^32 fits 64 bits);
a base with a wider prime (up to the reference's 61-bit bound) takes the
u64 arithmetic of ops/modmath.py over all its rows at once, so N = 2^16
with 65 primes builds in seconds.  Bit-equal to the JAX package's tables
(tests/test_torch_ntt.py, tests/test_torch_u64_ops.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from . import numth
from .modulus import compute_shoup
from ..ops.rns_host import i64_tensor


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


def _powers_wide(bases, n: int, qs, mv):
    """(L, n) int64: bases[l]^i mod qs[l], i < n, by doubling."""
    from ..ops import modmath as mm
    q, rlo, rhi = mv
    out = torch.ones((len(qs), 1), dtype=torch.int64)
    while out.shape[1] < n:
        step = i64_tensor([pow(b, out.shape[1], m) for b, m in zip(bases, qs)]
                          ).view(-1, 1)
        out = torch.cat([out, mm.mul_mod(out, step, q, rlo, rhi)], dim=1)
    return out[:, :n]


def _shoup_wide(w: torch.Tensor, mv) -> torch.Tensor:
    """floor(w * 2^64 / q) for w < q < 2^61."""
    from ..ops import modmath as mm
    q, rlo, rhi = mv
    return mm.barrett_div_mod_u128(w, torch.zeros_like(w), q, rlo, rhi)[0]


def _wide_tables(n: int, moduli, rev: np.ndarray) -> RNSNTTTables:
    """Tables of a base with primes up to 2^61, in u64 arithmetic."""
    from ..ops.rns_host import modulus_vec, u64_values
    for q in moduli:
        if q >= 1 << 61 or (q - 1) % (2 * n):
            raise ValueError(f"modulus {q} is not NTT-friendly for N={n} "
                             "below 2^61")
    mv = modulus_vec(moduli).col()
    roots = []
    for q in moduli:  # a primitive 2N-th root, then the least odd power
        quo = (q - 1) // (2 * n)
        for base in range(2, 2002):
            root = pow(base, quo, q)
            if pow(root, n, q) == q - 1:
                break
        roots.append(root)
    from ..ops import modmath as mm
    odd = mm.mul_mod(_powers_wide([r * r % q for r, q in zip(roots, moduli)],
                                  n, moduli, mv),
                     i64_tensor(roots).view(-1, 1), *mv)
    psi = [int(v) for v in odd.min(dim=1).values]
    idx = torch.from_numpy(rev)
    fwd = _powers_wide(psi, n, moduli, mv)[:, idx]
    inv = _powers_wide([pow(p, -1, q) for p, q in zip(psi, moduli)], n,
                       moduli, mv)[:, idx]
    inv_degree = [pow(n, -1, q) for q in moduli]
    return RNSNTTTables(
        n=n, moduli=moduli, root_powers=u64_values(fwd),
        root_powers_shoup=u64_values(_shoup_wide(fwd, mv)),
        inv_root_powers=u64_values(inv),
        inv_root_powers_shoup=u64_values(_shoup_wide(inv, mv)),
        inv_degree=np.array(inv_degree, dtype=np.uint64),
        inv_degree_shoup=np.array([compute_shoup(v, q) for v, q in zip(
            inv_degree, moduli)], dtype=np.uint64))


def make_rns_ntt_tables(n: int, moduli: Sequence[int]) -> RNSNTTTables:
    logn = n.bit_length() - 1
    rev = bit_reverse_indices(logn)
    moduli = tuple(int(q) for q in moduli)
    if max(moduli) >= 1 << 31:
        return _wide_tables(n, moduli, rev)
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

"""Galois elements and their permutations (counterpart of
phantom_tpu/schemes/galois.py:21-101).

A rotation by `step` slots is the automorphism sigma_g, g = 5^step mod 2N
(step 0: conjugation, g = 2N - 1).  With the evaluation order out[k] =
p(psi^(2 rev(k)+1)), (sigma_g p)(psi^e) = p(psi^(e g)), so on an NTT-form
polynomial sigma_g is the gather out[k] = in[perm[k]] with
perm[k] = rev(((2 rev(k) + 1) g mod 2N - 1) / 2).  On a coefficient-form
polynomial (BFV) sigma_g moves coefficient i to i g mod 2N, negated past
N: the gather out[j] = +-in[src[j]] with src[j] = j g^-1 mod 2N (less N
where the sign flips).

`GaloisTool` applies both gathers to u64 words on any device, caching
each element's index tensors (the JAX package's GaloisTool,
phantom_tpu/schemes/galois.py:104-138), for the u64 evaluator.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..host.ntt_tables import bit_reverse_indices

GENERATOR = 5


def get_elt_from_step(step: int, n: int) -> int:
    """Rotation step -> Galois element; step 0 is conjugation (2N - 1)."""
    m = 2 * n
    if step == 0:
        return m - 1
    return pow(GENERATOR, step % (n // 2), m)


def get_elts_from_steps(steps: Sequence[int], n: int) -> List[int]:
    return [get_elt_from_step(s, n) for s in steps]


def default_elts(n: int) -> List[int]:
    """Every power-of-two rotation, both ways, then conjugation."""
    elts = []
    step = 1
    while step < n // 2:
        elts += [get_elt_from_step(step, n), get_elt_from_step(-step, n)]
        step <<= 1
    return elts + [2 * n - 1]


def make_ntt_perm(elt: int, n: int) -> np.ndarray:
    """Gather indices (N,) int64 for sigma_elt on NTT-form operands."""
    rev = bit_reverse_indices(n.bit_length() - 1)
    e = (2 * rev + 1) * elt % (2 * n)
    return rev[(e - 1) >> 1]


def make_coeff_perm(elt: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Coefficient-form gather for sigma_elt: out[j] = -in[src[j]] where
    neg[j], else in[src[j]]; src (N,) int64, neg (N,) bool."""
    i = np.arange(n, dtype=np.int64) * pow(elt, -1, 2 * n) % (2 * n)
    neg = i >= n
    return np.where(neg, i - n, i), neg


class GaloisTool:
    """Per-degree cache of the permutations as index tensors."""

    def __init__(self, n: int):
        self.n = n
        self._ntt: Dict[tuple, torch.Tensor] = {}
        self._coeff: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def ntt_perm(self, elt: int, device) -> torch.Tensor:
        """(N,) int32 gather indices of sigma_elt on NTT-form data."""
        key = (elt, str(device))
        if key not in self._ntt:
            self._ntt[key] = torch.from_numpy(make_ntt_perm(
                elt, self.n).astype(np.int32)).to(device)
        return self._ntt[key]

    def apply_ntt(self, x: torch.Tensor, elt: int) -> torch.Tensor:
        """x (..., N) NTT form -> sigma_elt(x)."""
        return x[..., self.ntt_perm(elt, x.device).long()]

    def apply_coeff(self, x: torch.Tensor, elt: int,
                    q: torch.Tensor) -> torch.Tensor:
        """x (..., L, N) coefficient form, q (L,) -> sigma_elt(x)."""
        key = (elt, str(x.device))
        if key not in self._coeff:
            src, neg = make_coeff_perm(elt, self.n)
            self._coeff[key] = (torch.from_numpy(src).to(x.device),
                                torch.from_numpy(neg).to(x.device))
        src, neg = self._coeff[key]
        g = x[..., src]
        negated = torch.where(g == 0, torch.zeros_like(g), q.view(-1, 1) - g)
        return torch.where(neg, negated, g)

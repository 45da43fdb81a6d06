"""Host integers into u64 device words (counterpart of
phantom_tpu/ops/rns_host.py).

The port keeps a u64 word as the int64 tensor of its bit pattern
(torch.uint64 has no arithmetic on the CPU): `i64_tensor` carries exact
Python integers below 2^64 across.  `ModulusVec` holds a base's moduli
with their 2^128 Barrett ratios floor(2^128 / q) split into two words.
"""

from __future__ import annotations

from functools import cached_property
from typing import NamedTuple, Sequence

import numpy as np
import torch

_M64 = (1 << 64) - 1


def to_u64_array(values: Sequence[int]) -> np.ndarray:
    """Exact Python ints (< 2^64) -> numpy uint64 array."""
    return np.array([int(v) & _M64 for v in values], dtype=np.uint64)


def i64_tensor(values, device=None) -> torch.Tensor:
    """Integers below 2^64 (a sequence or a uint64 array) -> the int64
    tensor of their bit patterns."""
    if isinstance(values, np.ndarray) and values.dtype.kind in "ui":
        a = values.astype(np.uint64)
    else:  # Python ints (numpy would take a mix past 2^63 for floats)
        obj = np.array(values, dtype=object)
        a = to_u64_array(obj.ravel()).reshape(obj.shape)
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def u64_values(x: torch.Tensor) -> np.ndarray:
    """An int64 tensor of u64 bit patterns -> numpy uint64 array."""
    return x.detach().cpu().numpy().view(np.uint64)


def split_u128(values: Sequence[int]):
    """Exact ints (< 2^128) -> (lo, hi) numpy uint64 arrays."""
    lo = np.array([int(v) & _M64 for v in values], dtype=np.uint64)
    hi = np.array([(int(v) >> 64) & _M64 for v in values], dtype=np.uint64)
    return lo, hi


class _Moduli(NamedTuple):  # the fields; ModulusVec adds a cache slot
    q: torch.Tensor
    ratio_lo: torch.Tensor
    ratio_hi: torch.Tensor


class ModulusVec(_Moduli):
    """A base's moduli (L,) and the words of floor(2^128 / q), int64 bit
    patterns."""

    def to(self, device) -> "ModulusVec":
        return ModulusVec(*(x.to(device) for x in self))

    def slice(self, lo: int, hi: int) -> "ModulusVec":
        return ModulusVec(*(x[lo:hi] for x in self))

    def col(self):
        """(q, ratio_lo, ratio_hi) as (L, 1) columns."""
        return tuple(x.view(-1, 1) for x in self)

    @cached_property
    def words(self) -> torch.Tensor:
        """q, ratio_lo and ratio_hi in one (3L,) tensor, the table U4's
        products read through one pointer (built on first use, kept in
        the instance's __dict__, which a NamedTuple itself has not): the
        first three rows of a polyops.Limbs table."""
        return torch.cat(tuple(self))


def modulus_vec(moduli: Sequence[int], device=None) -> ModulusVec:
    qs = [int(m) for m in moduli]
    lo, hi = split_u128([(1 << 128) // q for q in qs])
    return ModulusVec(q=i64_tensor(to_u64_array(qs), device),
                      ratio_lo=i64_tensor(lo, device),
                      ratio_hi=i64_tensor(hi, device))

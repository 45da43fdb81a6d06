"""The JAX package's state, as numpy arrays, into the port's tensors.

Takes numpy arrays only (call `np.asarray` on a JAX array first), so this
module, like the rest of the port, never imports JAX.  Residues are below
2^30, so u64 and u32 words both become int32 tensors with the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.pipeline32 import Galois32, convert_key32
from .schemes.context import Context


def residues(a: np.ndarray) -> torch.Tensor:
    """Unsigned residues below 2^30 (u32 or u64 array) -> int32 tensor:
    Ciphertext.data, SecretKey.data, plaintexts, keys."""
    if not isinstance(a, np.ndarray):
        raise TypeError(f"expected a numpy array, got {type(a).__name__}")
    if a.dtype.kind != "u" or (a.size and int(a.max()) >= 1 << 30):
        raise ValueError("expected unsigned residues below 2^30")
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32)))


def relin_evk(ctx: Context, rlk_data: np.ndarray,
              chain_index: int = 1) -> torch.Tensor:
    """RelinKey.data (dnum, 2, K, N) -> the level's evk
    (beta, 2, size_qlp, N), through the rows of qlp_rows."""
    return convert_key32(ctx, residues(rlk_data), chain_index)


def galois_keys(ctx: Context, glk_data: np.ndarray, elts,
                chain_index: int = 1) -> Galois32:
    """GaloisKeys.data (n_elts, dnum, 2, K, N) with its elements -> the
    level's rotation state, on the context's device."""
    return Galois32(ctx, residues(glk_data), elts, chain_index).to(
        ctx.key_q.device)

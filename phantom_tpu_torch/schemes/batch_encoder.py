"""Batch encoder for BFV and BGV: a slot vector mod t <-> a plaintext
polynomial mod t (counterpart of phantom_tpu/schemes/batch_encoder.py).

Slots map to the negacyclic NTT evaluation order mod t through the
generator-5 index map (two rows of N/2 slots); encode is the inverse NTT
mod t (K1 on the card), decode the forward NTT (K2), over the context's
`plain_ntt` tables (t < 2^30 for every batching prime the port takes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.ntt_tables import bit_reverse_indices
from ..ops.pipeline32 import KERNELS, Kernels
from .ciphertext import Plaintext
from .context import Context


class BatchEncoder:
    def __init__(self, ctx: Context):
        if ctx.plain_ntt is None:
            raise ValueError("BatchEncoder requires a BFV or BGV context")
        self.ctx = ctx
        n = ctx.params.n
        self.slots = n
        rev = bit_reverse_indices(n.bit_length() - 1)
        m, row = 2 * n, n >> 1
        pos = np.ones(row, dtype=np.int64)
        for i in range(1, row):
            pos[i] = pos[i - 1] * 5 & (m - 1)
        self._index_np = np.concatenate([rev[(pos - 1) >> 1],
                                         rev[(m - pos - 1) >> 1]])

    def encode(self, values, ops: Kernels = KERNELS) -> Plaintext:
        """values: integers mod t (array-like, length <= N) -> the
        plaintext (1, N) on the context's device."""
        n = self.slots
        t = self.ctx.params.plain_modulus
        v = np.asarray(values, dtype=np.uint64)
        slots = np.zeros(n, dtype=np.int32)
        slots[self._index_np[:v.shape[0]]] = (v % np.uint64(t)).astype(
            np.int32)
        x = torch.from_numpy(slots).to(self.ctx.key_q.device).view(1, n)
        return Plaintext(data=ops.ntt_inverse(x, self.ctx.plain_ntt),
                         chain_index=0)

    def encode_signed(self, values, ops: Kernels = KERNELS) -> Plaintext:
        """Signed integers: a negative v maps to t - |v|."""
        t = self.ctx.params.plain_modulus
        v = np.asarray(values, dtype=np.int64) % t
        return self.encode(v.astype(np.uint64), ops)

    def decode(self, plain: Plaintext, ops: Kernels = KERNELS) -> np.ndarray:
        """The plaintext (1, N) -> its slots, uint64 (N,)."""
        evals = ops.ntt_forward(plain.data.int().contiguous(),
                                self.ctx.plain_ntt)
        return evals[0].cpu().numpy()[self._index_np].astype(np.uint64)

    def decode_signed(self, plain: Plaintext,
                      ops: Kernels = KERNELS) -> np.ndarray:
        t = self.ctx.params.plain_modulus
        vals = self.decode(plain, ops).astype(np.int64)
        return np.where(vals > t // 2, vals - t, vals)

"""Negacyclic NTT over 32-bit RNS primes: tables and the plain transform.

Counterpart of phantom_tpu/ops/ntt32.py.  The evaluation order is the
library's, out[k] = p(psi^(2*rev(k)+1)), with the bit-reversed twiddle
tables of phantom_tpu/host/ntt_tables.py: the stage with m groups reads
entries [m, 2m).  Forward runs Cooley-Tukey stages m = 1 .. N/2, inverse
Gentleman-Sande stages m = N/2 .. 1 and then multiplies by `scale`
(default n^-1).  The transforms here are plain int64 torch, one stage per
step over all rows at once: the oracle for the K1/K2 CUDA kernels
(ops/ntt_kernels.py).

One `NTTTables32` holds a whole base (e.g. all QP primes); a transform of L
rows takes `rows`, the table row of each of its L limbs, so sub-bases and
bases that repeat a modulus need no copied tables.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .modmath32 import u32


def u32_tensor(values) -> torch.Tensor:
    """Integers below 2^32 -> int32 tensor of their bit patterns."""
    a = np.asarray(values).astype(np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32).copy())


class NTTTables32(nn.Module):
    """u32 NTT tables of one base, as int32 buffers: q (L,), root_powers,
    inv_root_powers (L, N), their Shoup words floor(w * 2^32 / q) as int32
    bit patterns, inv_degree (L,) and its Shoup word; modulus_bits, the
    bit length of the largest modulus."""

    def __init__(self, host_tables):
        """host_tables: a host RNSNTTTables (u64 numpy, q < 2^30)."""
        super().__init__()
        q = np.asarray(host_tables.moduli, dtype=np.uint64)
        if not (q < (1 << 30)).all():
            raise ValueError("32-bit NTT tables need q < 2^30")
        self.register_buffer("q", u32_tensor(q))
        # every residue of the base is below 2^modulus_bits (a host int, so
        # the kernels' wrappers read it without a device sync)
        self.modulus_bits = int(q.max()).bit_length()
        for name in ("root_powers", "inv_root_powers"):
            self.register_buffer(name, u32_tensor(getattr(host_tables, name)))
            self.register_buffer(name + "_shoup", u32_tensor(
                np.asarray(getattr(host_tables, name + "_shoup")) >> 32))
        self.register_buffer("inv_degree",
                             u32_tensor(host_tables.inv_degree))
        self.register_buffer("inv_degree_shoup", u32_tensor(
            np.asarray(host_tables.inv_degree_shoup) >> 32))

    @property
    def num_limbs(self) -> int:
        return self.q.shape[0]

    def all_rows(self) -> torch.Tensor:
        return torch.arange(self.num_limbs, dtype=torch.int32,
                            device=self.q.device)


def resolve_rows(t: NTTTables32, rows, num_l: int) -> torch.Tensor:
    """Table row per limb: int32 (num_l,) on the tables' device."""
    if rows is None:
        if t.num_limbs != num_l:
            raise ValueError(f"{num_l} limbs against {t.num_limbs} table rows"
                             "; pass rows=")
        return t.all_rows()
    rows = torch.as_tensor(rows, dtype=torch.int32, device=t.q.device)
    if rows.shape != (num_l,):
        raise ValueError(f"rows {tuple(rows.shape)} != ({num_l},)")
    return rows


def ntt_forward32(x: torch.Tensor, t: NTTTables32, rows=None) -> torch.Tensor:
    """(..., L, N) residues in [0, 2q) -> NTT form in [0, q), int32."""
    n, num_l = x.shape[-1], x.shape[-2]
    rows = resolve_rows(t, rows, num_l).long()
    q = u32(t.q[rows]).view(num_l, 1, 1)
    w_all = u32(t.root_powers[rows])
    a = x.reshape(-1, num_l, n).long() % q.view(num_l, 1)
    b = a.shape[0]
    m = 1
    while m < n:
        a = a.view(b, num_l, m, 2, n // (2 * m))
        u, v = a[:, :, :, 0], a[:, :, :, 1]
        wv = v * w_all[:, m:2 * m].view(num_l, m, 1) % q
        a = torch.stack([(u + wv) % q, (u - wv) % q], dim=3)
        m *= 2
    return a.reshape(x.shape).int()


def ntt_inverse32(x: torch.Tensor, t: NTTTables32, rows=None,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., L, N) NTT form in [0, 2q) -> coefficients times `scale` (per
    limb, default n^-1) in [0, q), int32."""
    n, num_l = x.shape[-1], x.shape[-2]
    rows = resolve_rows(t, rows, num_l).long()
    q = u32(t.q[rows]).view(num_l, 1, 1)
    w_all = u32(t.inv_root_powers[rows])
    if scale is None:
        scale = t.inv_degree[rows]
    a = x.reshape(-1, num_l, n).long() % q.view(num_l, 1)
    b = a.shape[0]
    m = n // 2
    while m >= 1:
        a = a.view(b, num_l, m, 2, n // (2 * m))
        u, v = a[:, :, :, 0], a[:, :, :, 1]
        d = (u - v) * w_all[:, m:2 * m].view(num_l, m, 1) % q
        a = torch.stack([(u + v) % q, d], dim=3)
        m //= 2
    a = a.view(b, num_l, n) * u32(scale).view(num_l, 1) % q.view(num_l, 1)
    return a.reshape(x.shape).int()

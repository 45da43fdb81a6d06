"""U1: the negacyclic NTT over u64 RNS primes, its tables, its plain
version and its CUDA kernel's wrapper (counterpart of
phantom_tpu/ops/ntt.py:101 ntt_forward and :151 ntt_inverse, which the
JAX package runs as XLA fusions over emulated u64, no pallas_call).

Words are int64 bit patterns (ops/modmath.py).  The evaluation order and
the tables are the library's: out[k] = p(psi^(2 rev(k)+1)), the stage
with m groups reads entries [m, 2m) of the bit-reversed twiddle tables.
Forward: Cooley-Tukey stages m = 1 .. N/2, Harvey-lazy in [0, 4q), input
[0, q), output [0, q).  Inverse: Gentleman-Sande stages m = N/2 .. 1,
input [0, 2q), then one multiply by the per-limb `scale` (default N^-1;
the key switch folds its QhatInv in, as the JAX package does), output
[0, q).  One `NTTTables64` holds a whole base; a transform of L rows
takes `rows`, the table row of each limb.

The CUDA kernel (csrc/u64_ntt.cu) runs each call as one launch on the
one-pass cluster core (csrc/ntt_cluster.cuh) that K1-K8 run on, a row in
a cluster of C blocks, read from device memory once and written once, at
every N from 2 to 2^17; `u64_geometry` picks C, the threads and the
shared memory from N.  Outputs are canonical, so it is bit-equal to the
plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import _build
from . import modmath as mm
from .rns_host import i64_tensor, split_u128


class NTTTables64(nn.Module):
    """u64 NTT tables of one base, as int64 buffers: q (L,) with its
    Barrett words ratio_lo, ratio_hi, root_powers, inv_root_powers (L, N)
    and their Shoup words floor(w 2^64 / q), inv_degree (L,) and its Shoup
    word."""

    def __init__(self, host_tables):
        super().__init__()
        qs = [int(q) for q in host_tables.moduli]
        lo, hi = split_u128([(1 << 128) // q for q in qs])
        self.register_buffer("q", i64_tensor(qs))
        self.register_buffer("ratio_lo", i64_tensor(lo))
        self.register_buffer("ratio_hi", i64_tensor(hi))
        for name in ("root_powers", "root_powers_shoup", "inv_root_powers",
                     "inv_root_powers_shoup", "inv_degree",
                     "inv_degree_shoup"):
            self.register_buffer(name, i64_tensor(
                np.asarray(getattr(host_tables, name), dtype=np.uint64)))

    @property
    def n(self) -> int:
        return self.root_powers.shape[-1]

    @property
    def num_limbs(self) -> int:
        return self.q.shape[0]


def _rows(t: NTTTables64, rows, num_l: int) -> torch.Tensor:
    if rows is None:
        if num_l != t.num_limbs:
            raise ValueError(f"{num_l} limbs against tables of "
                             f"{t.num_limbs}: pass rows")
        return torch.arange(num_l, dtype=torch.int32, device=t.q.device)
    return rows


def ntt_forward_plain(x: torch.Tensor, t: NTTTables64,
                      rows=None) -> torch.Tensor:
    """(..., L, N) in [0, q) -> NTT form in [0, q)."""
    n, num_l = x.shape[-1], x.shape[-2]
    r = _rows(t, rows, num_l).long()
    batch = x.shape[:-2]
    q = t.q[r].view(num_l, 1, 1)
    tq = 2 * q
    m, h = 1, n // 2
    while m < n:
        xr = x.reshape(*batch, num_l, m, 2, h)
        w = t.root_powers[r, m:2 * m].view(num_l, m, 1)
        ws = t.root_powers_shoup[r, m:2 * m].view(num_l, m, 1)
        u, v = xr[..., 0, :], xr[..., 1, :]
        u = torch.where(u >= tq, u - tq, u)
        wv = mm.mul_mod_shoup_lazy(v, w, ws, q)
        x = torch.stack([u + wv, u - wv + tq], dim=-2)
        m, h = 2 * m, h // 2
    qc = q.view(num_l, 1)
    return mm.csub(mm.csub(x.reshape(*batch, num_l, n), 2 * qc), qc)


def ntt_inverse_plain(x: torch.Tensor, t: NTTTables64, rows=None,
                      scale=None, scale_shoup=None) -> torch.Tensor:
    """(..., L, N) in [0, 2q) -> coefficients in [0, q), times `scale`
    (L,) with its Shoup words (default N^-1)."""
    n, num_l = x.shape[-1], x.shape[-2]
    r = _rows(t, rows, num_l).long()
    batch = x.shape[:-2]
    q = t.q[r].view(num_l, 1, 1)
    tq = 2 * q
    m, h = n // 2, 1
    while m >= 1:
        xr = x.reshape(*batch, num_l, m, 2, h)
        w = t.inv_root_powers[r, m:2 * m].view(num_l, m, 1)
        ws = t.inv_root_powers_shoup[r, m:2 * m].view(num_l, m, 1)
        u, v = xr[..., 0, :], xr[..., 1, :]
        s = u + v
        s = torch.where(s >= tq, s - tq, s)
        d = mm.mul_mod_shoup_lazy(u - v + tq, w, ws, q)
        x = torch.stack([s, d], dim=-2)
        m, h = m // 2, 2 * h
    if scale is None:
        scale, scale_shoup = t.inv_degree[r], t.inv_degree_shoup[r]
    qc = q.view(num_l, 1)
    return mm.csub(mm.mul_mod_shoup_lazy(
        x.reshape(*batch, num_l, n), scale.view(-1, 1),
        scale_shoup.view(-1, 1), qc), qc)


# the largest share one block holds: 2^13 u64 words (64 KiB, 68 KiB with
# the pad), so that three blocks fit an SM; C = 8 (the portable
# cluster size) at most, so that N = 2^17 runs at C = 8 on 2^14-word
# shares (136 KiB, one block an SM) and not on a non-portable 16
U64_SHARE_LOG = 13
U64_CLUSTER_LOG = 3
U64_MAX_LOGN = 17


class Geometry(NamedTuple):
    logc: int     # 2^logc blocks a row (a cluster)
    threads: int  # threads a block
    smem: int     # bytes of dynamic shared memory a block


def u64_geometry(n: int) -> Geometry:
    """U1's launch at N = n: C = 2^logc blocks a row, each holding a share
    of S = N / C u64 words in `smem` bytes of dynamic shared memory (S
    words and one pad word per 16), with `threads` threads (one per 32
    words of the share, 32 to 256: the kernel runs three blocks an
    SM)."""
    logn = n.bit_length() - 1
    if n != 1 << logn or not 1 <= logn <= U64_MAX_LOGN:
        raise ValueError(f"U1 takes N = 2 .. 2^{U64_MAX_LOGN}, not {n}")
    logc = min(max(logn - U64_SHARE_LOG, 0), U64_CLUSTER_LOG)
    s = 1 << (logn - logc)
    return Geometry(logc=logc, threads=min(max(s // 32, 32), 256),
                    smem=8 * (s + (s >> 4)))


def check_words(*tensors) -> None:
    """The u64 kernels' operands: contiguous int64 tensors on one
    device."""
    dev = tensors[0].device
    for x in tensors:
        if x is None:
            continue
        if x.device != dev or x.dtype != torch.int64 or \
                not x.is_contiguous():
            raise ValueError("u64 kernel operands must be contiguous int64 "
                             f"tensors on {dev}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _launch(x, t: NTTTables64, rows, inverse: bool, scale=None,
            scale_shoup=None):
    n, num_l = x.shape[-1], x.shape[-2]
    logn = n.bit_length() - 1
    if n != 1 << logn or n < 2:
        raise ValueError(f"N={n} is not a power of two >= 2")
    if n != t.n:
        raise ValueError(f"N={n} against tables of N={t.n}")
    rows = _rows(t, rows, num_l)
    if rows.dtype != torch.int32 or rows.shape != (num_l,):
        raise ValueError("rows must be an int32 (L,) tensor")
    if (scale is None) != (scale_shoup is None):
        raise ValueError("scale and scale_shoup go together")
    _build.check_device(rows, t.q)
    check_words(x, t.q, t.root_powers, scale, scale_shoup)
    geo = u64_geometry(n)
    groups = x.numel() // (num_l * n)
    out = torch.empty_like(x)
    _build.check_aligned(x, out)
    tw, tws = ((t.inv_root_powers, t.inv_root_powers_shoup) if inverse
               else (t.root_powers, t.root_powers_shoup))
    if inverse and scale is None:
        scale, scale_shoup = t.inv_degree[rows.long()], \
            t.inv_degree_shoup[rows.long()]
    with torch.cuda.device(x.device):
        err = _build.library().ptk_u64_ntt(
            out.data_ptr(), x.data_ptr(), t.q.data_ptr(), tw.data_ptr(),
            tws.data_ptr(), rows.data_ptr(), _ptr(scale), _ptr(scale_shoup),
            groups, num_l, logn, int(inverse), geo.logc, geo.threads,
            geo.smem, _build.stream(x))
    _build.check(err, "u64_ntt")
    ntt_forward.launches += 1
    return out


def ntt_forward(x: torch.Tensor, t: NTTTables64, rows=None) -> torch.Tensor:
    """U1, forward, on CUDA tensors; the plain version on CPU tensors.  x:
    (..., L, N) int64 in [0, q); rows: (L,) int32 table rows or None (the
    tables' first L).  Returns NTT form in [0, q)."""
    if _build.is_plain(x, "ntt_forward64"):
        return ntt_forward_plain(x, t, rows)
    return _launch(x.contiguous(), t, rows, False)


def ntt_inverse(x: torch.Tensor, t: NTTTables64, rows=None, scale=None,
                scale_shoup=None) -> torch.Tensor:
    """U1, inverse (counts as U1).  x in [0, 2q); scale (L,) with its
    Shoup words, default N^-1."""
    if _build.is_plain(x, "ntt_inverse64"):
        return ntt_inverse_plain(x, t, rows, scale, scale_shoup)
    return _launch(x.contiguous(), t, rows, True, scale, scale_shoup)


ntt_forward.launches = 0

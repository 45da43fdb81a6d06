"""The coefficient-sharded negacyclic NTT over u32 and u64 words
(counterpart of phantom_tpu/parallel/ntt_sharded.py and the u32 half of
phantom_tpu/parallel/sharded32.py:31-161).

A polynomial of N = n1 n2 coefficients is the (n1, n2) matrix x[a n2 +
b]; a mesh of W ranks along "coeff" gives rank r the columns b in [r c2,
(r + 1) c2), c2 = n2 / W, for every row: the rank's block of an (L, N)
tensor is (L, n1, c2) (mesh.shard_coeff).  The forward transform runs

  phase A   the log2 n1 Cooley-Tukey stages along n1, local (P1);
  exchange  all_to_all_single over the mesh's subgroup;
  phase B   the log2 n2 stages along n2, local again, on the rank's n1
            columns [r c1, (r + 1) c1), c1 = n1 / W (P1);
  exchange  back to the canonical (L, n1, c2) block,

and the inverse runs phase B's stages first, then phase A's.  Twiddles
ride replicated on every rank; the phase-B regions [m, 2m), m >= n1, of
each table row are stored transposed (`_transpose_regions`), so the
twiddle of group g and global column a is fwd[m + g n1 + a].  Ranges
are the JAX package's: forward Harvey-lazy in [0, 4q) from [0, q),
ending with two conditional subtractions; inverse in [0, 2q), ending
with the Shoup product by its scale (n^-1, or the caller's pair, as
sharded32's inverse takes it) and one subtraction.  Outputs are
canonical, so both transforms are bit-equal to the local NTT.

Each phase is one launch of P1 (ops/ntt_phase_kernels.py,
csrc/ntt_phase.cu) over every limb, which writes the layout the exchange
sends as it is.  The forward's returned (W, L, c1, c2) and the inverse's
canonical input are the (L, n1, c2) block with its first two axes
swapped: a view at W = 1, one torch copy past it.  A transform of (...,
L, n1, c2) folds its leading groups into the limbs (their table rows
repeated), so one call of each phase serves them all.  Every transform
takes `ops`, a kernel bundle (pipeline32.Kernels or keyswitch.Kernels64)
whose `ntt_phase` runs the phases: P1 by default, its plain version in
the bundles of plain versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops.ntt_phase_kernels import (ntt_phase,  # noqa: F401
                                     ntt_phase_plain, phase_layout)


def split_n(n: int):
    """(n1, n2) with n1 n2 = n, n1 = 2^floor(log2(n) / 2) (the JAX
    package's ops/ntt_mxu.py:128 _split_n)."""
    logn = n.bit_length() - 1
    log1 = logn // 2
    return 1 << log1, 1 << (logn - log1)


def _transpose_regions(table: np.ndarray, n1: int) -> np.ndarray:
    """Transpose every stage region [m, 2m) for m >= n1, per row: region
    entry m + a (m / n1) + g moves to m + g n1 + a."""
    out = table.copy()
    n = table.shape[-1]
    m = n1
    while m < n:
        seg = table[..., m:2 * m]
        rows = seg.shape[0]
        out[..., m:2 * m] = seg.reshape(rows, n1, m // n1).transpose(
            0, 2, 1).reshape(rows, m)
        m <<= 1
    return out


class _ShardedTables(nn.Module):
    """The NTT tables of one base, phase-B regions transposed, as buffers
    in the word of the tables they were made from: q (L,), fwd, fwd_shoup,
    inv, inv_shoup (L, N), inv_degree and its Shoup word (L,); n1, n2."""

    word = 0

    def __init__(self, t):
        super().__init__()
        n = t.root_powers.shape[-1]
        self.n1, self.n2 = split_n(n)
        dev = t.q.device

        def tr(x):
            a = _transpose_regions(x.detach().cpu().numpy(), self.n1)
            return torch.from_numpy(a).to(dev)
        self.register_buffer("q", t.q.clone())
        for mine, theirs in (("fwd", "root_powers"),
                             ("inv", "inv_root_powers")):
            self.register_buffer(mine, tr(getattr(t, theirs)))
            self.register_buffer(mine + "_shoup",
                                 tr(getattr(t, theirs + "_shoup")))
        self.register_buffer("inv_degree", t.inv_degree.clone())
        self.register_buffer("inv_degree_shoup",
                             t.inv_degree_shoup.clone())

    @property
    def n(self) -> int:
        return self.n1 * self.n2

    @property
    def num_limbs(self) -> int:
        return self.q.shape[0]


class ShardedNTTTables(_ShardedTables):
    """u64 tables (int64 bit patterns, Shoup words floor(w 2^64 / q))."""

    word = 8


class ShardedNTTTables32(_ShardedTables):
    """u32 tables (int32 bit patterns, Shoup words floor(w 2^32 / q))."""

    word = 4


def prepare_sharded_tables(t) -> ShardedNTTTables:
    """From an ops.ntt.NTTTables64, on its device."""
    return ShardedNTTTables(t)


def prepare_sharded_tables32(t) -> ShardedNTTTables32:
    """From an ops.ntt32.NTTTables32, on its device."""
    return ShardedNTTTables32(t)


def exchange(x: torch.Tensor, mesh) -> torch.Tensor:
    """all_to_all_single over the mesh's coefficient subgroup: chunk d of
    dim 0 goes to rank d, chunk s of the result came from rank s.
    Counts its calls and bytes sent (exchange.calls, exchange.bytes)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    exchange.calls += 1
    exchange.bytes += x.numel() * x.element_size()
    return out


exchange.calls = 0
exchange.bytes = 0


def _fold(x: torch.Tensor, t: _ShardedTables, rows, mesh):
    """(..., L, n1, c2) -> the (L', n1, c2) limbs of every group and their
    (L',) int32 table rows."""
    c2 = t.n2 // mesh.coeff
    if x.dim() < 3 or tuple(x.shape[-2:]) != (t.n1, c2):
        raise ValueError(f"sharded NTT: x {tuple(x.shape)} is not "
                         f"(..., L, {t.n1}, {c2})")
    num_l = x.shape[-3]
    if rows is None:
        if num_l > t.num_limbs:
            raise ValueError(f"{num_l} limbs against {t.num_limbs} table "
                             "rows: pass rows")
        rows = torch.arange(num_l, dtype=torch.int32, device=t.q.device)
    elif rows.shape != (num_l,):
        raise ValueError(f"rows {tuple(rows.shape)} != ({num_l},)")
    groups = x.numel() // (num_l * t.n1 * c2)
    return (x.reshape(groups * num_l, t.n1, c2),
            rows.repeat(groups) if groups > 1 else rows, groups)


def _phase(ops):
    return ntt_phase if ops is None else ops.ntt_phase


def ntt_forward_sharded3(x: torch.Tensor, t: _ShardedTables, mesh,
                         rows=None, ops=None) -> torch.Tensor:
    """x (..., L, n1, c2), the rank's block in [0, q) -> NTT form, the
    same layout, [0, q).  rows: (L,) int32 table rows (default the
    tables' first L); ops: a kernel bundle (default P1)."""
    xs, rr, _ = _fold(x, t, rows, mesh)
    world = mesh.coeff
    phase = _phase(ops)
    a = phase(xs.contiguous(), t, rr, "A", False, world)
    b = phase(exchange(a, mesh), t, rr, "B", False, world,
              col0=mesh.coeff_index * (t.n1 // world))
    # (W, L', c1, c2) -> (L', n1, c2): a view at W = 1, else a copy
    return exchange(b, mesh).transpose(0, 1).reshape(x.shape)


def ntt_inverse_sharded3(x: torch.Tensor, t: _ShardedTables, mesh,
                         rows=None, scale: Optional[torch.Tensor] = None,
                         scale_shoup: Optional[torch.Tensor] = None,
                         ops=None) -> torch.Tensor:
    """x (..., L, n1, c2) NTT form in [0, 2q) -> coefficients times
    `scale` (L,) with its Shoup words (default n^-1), in [0, q)."""
    xs, rr, groups = _fold(x, t, rows, mesh)
    world = mesh.coeff
    phase = _phase(ops)
    num_l = xs.shape[0]
    c1, c2 = t.n1 // world, t.n2 // world
    if scale is not None and groups > 1:
        scale, scale_shoup = scale.repeat(groups), scale_shoup.repeat(groups)
    s0 = xs.reshape(num_l, world, c1, c2).transpose(0, 1).contiguous()
    b = phase(exchange(s0, mesh), t, rr, "B", True, world,
              col0=mesh.coeff_index * c1)
    out = phase(exchange(b, mesh), t, rr, "A", True, world,
                scale=scale, scale_shoup=scale_shoup)
    return out.reshape(x.shape)


def ntt_forward_sharded(x: torch.Tensor, t: _ShardedTables, mesh,
                        rows=None, ops=None) -> torch.Tensor:
    """ntt_forward_sharded3 on the block flattened, (..., L, n1 c2)."""
    c2 = t.n2 // mesh.coeff
    return ntt_forward_sharded3(x.reshape(*x.shape[:-1], t.n1, c2), t,
                                mesh, rows, ops).reshape(x.shape)


def ntt_inverse_sharded(x: torch.Tensor, t: _ShardedTables, mesh,
                        rows=None, scale=None, scale_shoup=None,
                        ops=None) -> torch.Tensor:
    """ntt_inverse_sharded3 on the block flattened, (..., L, n1 c2)."""
    c2 = t.n2 // mesh.coeff
    return ntt_inverse_sharded3(x.reshape(*x.shape[:-1], t.n1, c2), t,
                                mesh, rows, scale, scale_shoup,
                                ops).reshape(x.shape)

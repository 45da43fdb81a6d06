"""P1, the local phases of the coefficient-sharded NTT
(parallel/ntt_sharded.py), on u32 and u64 words: the wrapper of
csrc/ntt_phase.cu and its plain version.

One launch runs one phase of one direction over every limb, reading the
layout the phase takes and writing the one the exchange (or the caller)
takes, c1 = n1 / W, c2 = n2 / W:

  forward A  (L, n1, c2)     -> (W, L, c2, c1)  chunk d: its n1 rows
  forward B  (W, L, c2, c1)  -> (W, L, c1, c2)  chunk d: its n2 rows,
                                                  csub'd to [0, q)
  inverse B  (W, L, c1, c2)  -> (W, L, c2, c1)
  inverse A  (W, L, c2, c1)  -> (L, n1, c2)     times the scale, [0, q)

so the exchange sends each buffer as it is.  Phase A runs the log2 n1
stages along n1 with the stage twiddles fwd[m:2m], the same for every
column; phase B the log2 n2 stages along n2, the twiddle of group g and
global column a at fwd[m + g n1 + a] (the tables' phase-B regions
transposed, ntt_sharded._transpose_regions), so the rank passes its
column offset.  `ntt_phase_plain` is the same map in plain torch, stage
for stage the JAX package's loops (phantom_tpu/parallel/ntt_sharded.py
:86-211, sharded32.py:66-161); the wrapper takes it for CPU tensors
only.  pipeline32.Kernels and keyswitch.Kernels64 carry both as their
`ntt_phase` field.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import _build
from . import modmath as mm
from . import modmath32 as m32

PHASES = ("A", "B")
# columns a P1 tile holds: 32 u32 or 16 u64 words (a row of 128 bytes,
# 32 KB a tile of 256 rows), halved down to 8 or 4 (32 bytes) while a call
# has fewer than two blocks a multiprocessor
TILE_COLS = {4: 32, 8: 16}
TILE_COLS_MIN = {4: 8, 8: 4}


def _dtype(t):
    return torch.int32 if t.word == 4 else torch.int64


def _log2(v: int) -> int:
    return v.bit_length() - 1


def phase_layout(t, phase: str, inverse: bool, num_l: int, world: int):
    """(R, cols, input shape, output shape) of one P1 call, c1 = n1 / W,
    c2 = n2 / W (the module docstring's table)."""
    n1, n2 = t.n1, t.n2
    c1, c2 = n1 // world, n2 // world
    if phase == "A":
        r_len, cols = n1, c2
        ends = ((num_l, n1, c2), (world, num_l, c2, c1))
    else:
        r_len, cols = n2, c1
        ends = ((world, num_l, c2, c1), (world, num_l, c1, c2))
    src, dst = ends[::-1] if inverse else ends
    return r_len, cols, src, dst


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_cols(word: int, num_l: int, cols: int, sms: int) -> int:
    """The columns a P1 block holds for num_l limbs of cols columns on a
    card of `sms` multiprocessors."""
    tile = min(TILE_COLS[word], cols)
    while tile > TILE_COLS_MIN[word] and num_l * (cols // tile) < 2 * sms:
        tile //= 2
    return tile


def _check(x, t, rows, phase, world):
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} not in {PHASES}")
    if world < 1 or t.n1 % world or t.n2 % world:
        raise ValueError(f"n1 = {t.n1}, n2 = {t.n2}: {world} ranks must "
                         "divide both")
    if x.dtype != _dtype(t):
        raise ValueError(f"ntt_phase: {x.dtype} words against "
                         f"{8 * t.word}-bit tables")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError("rows must be an int32 (L,) tensor")


def ntt_phase(x: torch.Tensor, t, rows: torch.Tensor,
              phase: str, inverse: bool, world: int, col0: int = 0,
              scale: Optional[torch.Tensor] = None,
              scale_shoup: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P1 on CUDA tensors; the plain version on CPU tensors.  t: the
    sharded tables (ntt_sharded.ShardedNTTTables or ShardedNTTTables32).
    One phase ("A" or "B") of one direction over L = rows.numel() limbs,
    x in the
    phase's input layout (phase_layout), rows (L,) int32 table rows; col0
    the global n1 column of the rank's first (phase B); scale,
    scale_shoup (L,) the inverse's factor (default n^-1), read by its
    last phase (A).  Returns the output layout's tensor."""
    _check(x, t, rows, phase, world)
    if _build.is_plain(x, "ntt_phase"):
        return ntt_phase_plain(x, t, rows, phase, inverse, world, col0,
                               scale, scale_shoup)
    num_l = rows.numel()
    r_len, cols, in_shape, out_shape = phase_layout(t, phase, inverse,
                                                    num_l, world)
    if tuple(x.shape) != in_shape:
        raise ValueError(f"ntt_phase {phase}: x {tuple(x.shape)} is not "
                         f"{in_shape}")
    if x.numel() >= 1 << 31:
        raise ValueError(f"ntt_phase: {x.numel()} words, 2^31 or more")
    if (scale is None) != (scale_shoup is None):
        raise ValueError("scale and scale_shoup go together")
    for v in (x, rows, scale, scale_shoup):
        if v is not None and not v.is_contiguous():
            raise ValueError("ntt_phase: operands must be contiguous")
    for v in (scale, scale_shoup):
        if v is not None and (v.dtype != x.dtype or v.shape != (num_l,)):
            raise ValueError(f"ntt_phase: a scale must be ({num_l},) "
                             f"{x.dtype} words")
    # the inverse's last phase reads N^-1 by table row unless given one
    by_row = inverse and phase == "A" and scale is None
    if by_row:
        scale, scale_shoup = t.inv_degree, t.inv_degree_shoup
    _build.check_device(x, t.q, rows, scale, scale_shoup)
    tile = tile_cols(t.word, num_l, cols, _multiprocessors(x.device.index))
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    tw, tws = (t.inv, t.inv_shoup) if inverse else (t.fwd, t.fwd_shoup)
    with torch.cuda.device(x.device):
        err = _build.library().ptk_ntt_phase(
            t.word, out.data_ptr(), x.data_ptr(), t.q.data_ptr(),
            tw.data_ptr(), tws.data_ptr(), rows.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if scale_shoup is None else scale_shoup.data_ptr(),
            int(by_row), num_l, t.n, _log2(r_len), _log2(tile),
            _log2(world), col0, int(phase == "B"), int(inverse),
            _build.stream(x))
    _build.check(err, "ntt_phase")
    ntt_phase.launches += 1
    return out


ntt_phase.launches = 0


def _to_lines(x, phase, inverse, num_l, n1, n2, world):
    """A phase's input -> (L, R, cols): element i of line (l, j)."""
    c1, c2 = n1 // world, n2 // world
    if phase == "A":
        if not inverse:
            return x
        return x.permute(1, 0, 3, 2).reshape(num_l, n1, c2)
    if not inverse:
        return x.permute(1, 0, 2, 3).reshape(num_l, n2, c1)
    return x.permute(1, 0, 3, 2).reshape(num_l, n2, c1)


def _from_lines(y, phase, inverse, num_l, n1, n2, world):
    """(L, R, cols) -> the phase's output layout."""
    c1, c2 = n1 // world, n2 // world
    if phase == "A":
        if inverse:
            return y.contiguous()
        return y.reshape(num_l, world, c1, c2).permute(1, 0, 3, 2)
    if not inverse:
        return y.reshape(num_l, world, c2, c1).permute(1, 0, 3, 2)
    return y.reshape(num_l, world, c2, c1).permute(1, 0, 2, 3)


def ntt_phase_plain(x: torch.Tensor, t, rows: torch.Tensor,
                    phase: str, inverse: bool, world: int, col0: int = 0,
                    scale: Optional[torch.Tensor] = None,
                    scale_shoup: Optional[torch.Tensor] = None):
    """P1's plain version: the JAX package's stage loops of one phase
    (Harvey-lazy, the same ends) on the same layouts."""
    _check(x, t, rows, phase, world)
    num_l = rows.numel()
    n1, n2 = t.n1, t.n2
    r = rows.long()
    if t.word == 4:
        def word(v):
            return m32.u32(v)
        lazy = m32.mul_mod_shoup_lazy32
    else:
        def word(v):
            return v
        lazy = mm.mul_mod_shoup_lazy
    y = word(_to_lines(x, phase, inverse, num_l, n1, n2, world))
    r_len, cols = y.shape[1], y.shape[2]
    q = word(t.q[r]).view(num_l, 1, 1, 1)
    q2 = 2 * q
    tw, tws = (t.inv, t.inv_shoup) if inverse else (t.fwd, t.fwd_shoup)
    stages = [1 << s for s in range(_log2(r_len))]
    for mg in (stages[::-1] if inverse else stages):
        h = r_len // (2 * mg)
        if phase == "A":
            w = word(tw[r, mg:2 * mg]).view(num_l, mg, 1, 1)
            ws = tws[r, mg:2 * mg].view(num_l, mg, 1, 1)
        else:
            m = mg * n1
            w = word(tw[r, m:2 * m]).view(num_l, mg, n1)[
                :, :, col0:col0 + cols].reshape(num_l, mg, 1, cols)
            ws = tws[r, m:2 * m].view(num_l, mg, n1)[
                :, :, col0:col0 + cols].reshape(num_l, mg, 1, cols)
        yr = y.reshape(num_l, mg, 2, h, cols)
        u, v = yr[:, :, 0], yr[:, :, 1]
        if inverse:
            s = u + v
            s = torch.where(s >= q2, s - q2, s)
            y = torch.stack([s, lazy(u - v + q2, w, ws, q)], dim=2)
        else:
            u = torch.where(u >= q2, u - q2, u)
            wv = lazy(v, w, ws, q)
            y = torch.stack([u + wv, u - wv + q2], dim=2)
        y = y.reshape(num_l, r_len, cols)
    qc = q.view(num_l, 1, 1)
    if (phase == "B") != inverse:  # the last phase: the ends
        if inverse:
            if scale is None:
                scale, scale_shoup = t.inv_degree[r], t.inv_degree_shoup[r]
            y = lazy(y, word(scale).view(num_l, 1, 1),
                     scale_shoup.view(num_l, 1, 1), qc)
            y = torch.where(y >= qc, y - qc, y)
        else:
            y = torch.where(y >= 2 * qc, y - 2 * qc, y)
            y = torch.where(y >= qc, y - qc, y)
    if t.word == 4:  # [0, 4q) below 2^32: the int32 bit pattern
        y = torch.where(y >= 1 << 31, y - (1 << 32), y)
    y = y.to(_dtype(t))
    return _from_lines(y, phase, inverse, num_l, n1, n2,
                       world).contiguous()

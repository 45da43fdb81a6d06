"""Encrypted linear transforms: the Halevi-Shoup diagonal method with
baby-step/giant-step (BSGS) rotations (counterpart of
phantom_tpu/schemes/linear.py).

    M @ x = sum_j rot_{j bs}( sum_i rot_{-j bs}(diag_{j bs + i}) * rot_i(x) )

The inner (baby) sums run through the hoisted linear combination (one
evk inner product per step, one moddown pair per group), and every group
shares one modup of c1 (pipeline32.hoisted_linear_combo32's t_up); the
outer (giant) rotations are ordinary key-switched rotations, gs - 1 of
them in place of d - 1.  Vectors are packed d-periodically across the
slots (d | slots), so that slot rotation is the cyclic rotation the
diagonal method assumes; `encode_input` does the tiling.  Diagonals that
are all zero are skipped when the transform is built, which shrinks both
the Galois key set and the work.

`prepare` encodes the diagonals over QlP on the host (encode_extended),
once per level; it is preparation, not serving.  `apply` runs the matvec
on the u64 evaluator (schemes/evaluate.py: keyswitch.modup_from_ntt once,
hoisted_linear_combo per group, rotate_vector by the giant step, add,
rescale_to_next), `apply_fast32` on a Fast32 evaluator; both take `ops`,
the kernels their verbs call.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops import pipeline32 as pp
from ..ops.pipeline32 import KERNELS, Kernels
from . import evaluate as ev
from .ckks_encoder import encode_extended
from .keyswitch import KERNELS64, Kernels64, modup_from_ntt


def bsgs_split(d: int, bs: int | None = None) -> tuple[int, int]:
    """(baby, giant) counts: bs gs >= d with bs about sqrt(d)."""
    if bs is None:
        bs = max(1, int(round(math.sqrt(d))))
    return bs, -(-d // bs)


class LinearTransform:
    """A plaintext d x d matrix applied to encrypted slot vectors.

    groups[j] = (giant step, [baby steps], [diagonals pre-rotated by minus
    the giant step]), all-zero diagonals left out."""

    def __init__(self, M, bs: int | None = None):
        M = np.asarray(M)
        if M.ndim != 2 or M.shape[0] != M.shape[1]:
            raise ValueError("LinearTransform expects a square matrix")
        self.d = int(M.shape[0])
        self.bs, self.gs = bsgs_split(self.d, bs)
        self.groups: list[tuple[int, list[int], list[np.ndarray]]] = []
        idx = np.arange(self.d)
        for j in range(self.gs):
            gstep = j * self.bs
            steps: list[int] = []
            diags: list[np.ndarray] = []
            for i in range(self.bs):
                k = gstep + i
                if k >= self.d:
                    break
                diag = M[idx, (idx + k) % self.d]
                if not np.any(diag):
                    continue
                steps.append(i)
                diags.append(np.roll(diag, gstep))
            if steps:
                self.groups.append((gstep, steps, diags))
        self._prepared: dict = {}  # chain_index -> per group its QlP weights
        self.pts_scale: float | None = None

    def steps_required(self) -> list[int]:
        """The rotation steps that need Galois keys."""
        need = set()
        for gstep, steps, _ in self.groups:
            if gstep:
                need.add(gstep)
            need.update(s for s in steps if s)
        return sorted(need)

    def encode_input(self, enc, x, scale: float):
        """Tile x d-periodically across the slots and encode it (either
        encoder)."""
        x = np.asarray(x).ravel()
        if x.shape[0] != self.d:
            raise ValueError(f"expected a length-{self.d} vector")
        if enc.slots % self.d:
            raise ValueError("d must divide the slot count")
        return enc.encode(np.tile(x, enc.slots // self.d), scale)

    def prepare(self, enc, scale: float, chain_index: int = 1,
                ops: Kernels = KERNELS) -> None:
        """Encode the diagonals over QlP at `chain_index` (NTT form, on the
        context's device) with the host encoder `enc`."""
        if enc.slots % self.d:
            raise ValueError("d must divide the slot count")
        reps = enc.slots // self.d
        self._prepared[chain_index] = [
            [encode_extended(enc, np.tile(dg, reps), scale, chain_index, ops)
             for dg in diags] for _, _, diags in self.groups]
        if self.pts_scale is not None and self.pts_scale != scale:
            raise ValueError("prepare() must use one scale per transform")
        self.pts_scale = scale

    def _pts_at(self, chain_index: int):
        try:
            return self._prepared[chain_index]
        except KeyError:
            raise ValueError(f"prepare(enc, scale, chain_index="
                             f"{chain_index}) has not been called") from None

    def apply(self, ctx, ct, glk, rescale: bool = True,
              ops: Kernels64 = KERNELS64):
        """The BSGS matvec on the u64 evaluator; ct must be d-periodic.
        One modup of c1 serves every group."""
        pts = self._pts_at(ct.chain_index)
        t_modup = modup_from_ntt(ctx, ev._cd(ctx, ct), ct.data[1], ops)
        acc = None
        for (gstep, steps, _), group_pts in zip(self.groups, pts):
            inner = ev.hoisted_linear_combo(ctx, ct, glk, steps, group_pts,
                                            self.pts_scale, t_modup, ops)
            if gstep:
                inner = ev.rotate_vector(ctx, inner, gstep, glk, ops)
            acc = inner if acc is None else ev.add(ctx, acc, inner, ops)
        return ev.rescale_to_next(ctx, acc, ops) if rescale else acc

    def apply_fast32(self, fast, ct, rescale: bool = True,
                     ops: Kernels = KERNELS):
        """The BSGS matvec on a Fast32 evaluator; ct must be d-periodic.
        One modup of c1 serves every group."""
        ci = ct.chain_index
        pts = self._pts_at(ci)
        ks = fast.keyswitch_at(ci)
        g = fast.galois_at(ci)
        t_up = pp.modup_from_ntt32(ks, ct.data[1], ops)
        acc = None
        for (gstep, steps, _), group_pts in zip(self.groups, pts):
            out = pp.hoisted_linear_combo32(ks, g, ct.data, steps,
                                            group_pts, ops, t_up=t_up)
            inner = ct.replace(data=out, scale=ct.scale * self.pts_scale)
            if gstep:
                inner = fast.rotate(inner, gstep, ops)
            acc = inner if acc is None else fast.add(acc, inner)
        return fast.rescale_to_next(acc, ops) if rescale else acc

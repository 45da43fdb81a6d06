"""K6: the one-pass, row-resident NTT of the "pallas-roll" engine, its
CUDA kernel and plain twins.

Replaces phantom_tpu/ops/ntt_pallas_roll.py:ntt_forward_roll and
ntt_inverse_roll (bodies _fwd_kernel, _fwd_fused_kernel, _inv_kernel),
which the JAX package's "pallas-roll" engine takes for every transform.
For each row l of (..., L, N), with table row rows[l mod L]:

  ntt_forward_roll  [0, 2q) in, NTT form in [0, q) out; with sub_from,
                    (sub_from - NTT(x)) epi_scale mod q (the moddown
                    epilogue)
  ntt_inverse_roll  [0, 2q) in, coefficients in [0, q) out, times `scale`
                    per limb, which replaces n^-1

in the repo's order out[k] = p(psi^(2 rev(k) + 1)), reading the port's
NTTTables32 as K1 and K2 do.  The plain twins are ntt_kernels'
ntt_forward_plain and ntt_inverse_plain, which compute the same function.
The TPU kernel's roll/select form and its cols_a/blk_b stage tables are
Mosaic workarounds and have no counterpart.

On the card (csrc/ntt_roll.cu) the forward runs K2's kernel (the moddown
epilogue, no tensor adds) and the inverse K1's (a per-limb scale, no
mul_by, no floor sum): one launch per call on the one-pass,
cluster-resident radix-8 core (csrc/ntt_cluster.cuh), each row held by a
cluster of `cluster` blocks for all log2 N stages, read once and written
once; the default cluster is K2's (shares of 2^14 words) forward and K1's
(2^13) inverse.  Bound by device memory.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import check_aligned
from .ntt32 import NTTTables32, resolve_rows
from .ntt_kernels import (CLUSTER_WORDS, K2_CLUSTER_WORDS, _epilogue_args,
                          _expect, _logn, _ptr, _tables, check_cluster,
                          default_cluster, ntt_forward_plain,
                          ntt_inverse_plain)


def _launch(x, t: NTTTables32, rows, inverse: bool, cluster, sub_from=None,
            epi_scale=None, epi_scale_shoup=None, scale=None,
            scale_shoup=None) -> torch.Tensor:
    n, num_l = x.shape[-1], x.shape[-2]
    logn = _logn(n)
    words = CLUSTER_WORDS if inverse else K2_CLUSTER_WORDS
    c = default_cluster(n, words) if cluster is None else int(cluster)
    check_cluster(n, c)
    rows = resolve_rows(t, rows, num_l)
    epi = _epilogue_args(sub_from, epi_scale, epi_scale_shoup, None, x.shape,
                         num_l)[:3]
    if inverse:
        if scale is None:
            scale = t.inv_degree[rows.long()]
            scale_shoup = t.inv_degree_shoup[rows.long()]
        elif scale_shoup is None:
            raise ValueError("scale needs scale_shoup")
        _expect(scale, (num_l,), "scale")
        _expect(scale_shoup, (num_l,), "scale_shoup")
    tabs = _tables(t, inverse)
    opt = [a for a in (*epi, scale, scale_shoup) if a is not None]
    _build.check_operands(x, rows, *tabs, *opt)
    out = torch.empty_like(x)
    check_aligned(x, out, epi[0])
    with torch.cuda.device(x.device):
        err = _build.library().ptk_ntt_roll(
            out.data_ptr(), x.data_ptr(), *(a.data_ptr() for a in tabs),
            rows.data_ptr(), num_l, x.numel() // n, logn, c,
            *(_ptr(e) for e in epi), _ptr(scale), _ptr(scale_shoup),
            int(inverse), _build.stream(x))
    _build.check(err, "ntt_roll")
    return out


def ntt_forward_roll(x: torch.Tensor, t: NTTTables32, rows=None,
                     sub_from=None, epi_scale=None, epi_scale_shoup=None,
                     cluster=None) -> torch.Tensor:
    """K6 forward on a CUDA tensor; ntt_forward_plain on a CPU tensor.
    x: (..., L, N) in [0, 2q) -> NTT form in [0, q); with sub_from (x's
    shape): (sub_from - NTT(x)) * epi_scale.  cluster: blocks per row
    (default default_cluster(N, K2_CLUSTER_WORDS), as K2's)."""
    if _build.is_plain(x, "ntt_forward_roll"):
        return ntt_forward_plain(x, t, rows, sub_from, epi_scale,
                                 epi_scale_shoup)
    out = _launch(x, t, rows, False, cluster, sub_from, epi_scale,
                  epi_scale_shoup)
    ntt_forward_roll.launches += 1
    return out


def ntt_inverse_roll(x: torch.Tensor, t: NTTTables32, rows=None, scale=None,
                     scale_shoup=None, cluster=None) -> torch.Tensor:
    """K6 inverse on a CUDA tensor; ntt_inverse_plain on a CPU tensor.
    x: (..., L, N) in [0, 2q) -> coefficients in [0, q) times `scale` per
    limb (default n^-1).  cluster: blocks per row (default
    default_cluster(N), as K1's)."""
    if _build.is_plain(x, "ntt_inverse_roll"):
        return ntt_inverse_plain(x, t, rows, scale, scale_shoup)
    out = _launch(x, t, rows, True, cluster, scale=scale,
                  scale_shoup=scale_shoup)
    ntt_inverse_roll.launches += 1
    return out


ntt_forward_roll.launches = 0
ntt_inverse_roll.launches = 0

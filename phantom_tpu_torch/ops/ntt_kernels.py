"""K1, K2, K3: the NTT kernels of the main path, with their plain twins.

Each wrapper takes the CUDA kernel for a CUDA tensor and the plain int64
torch version beside it for a CPU tensor (any other device raises); it
counts its launches in `<wrapper>.launches`.

  K1 ntt_inverse        csrc/ntt.cu        replaces ntt_mxu_pallas.py:
                                           ntt_inverse_mxu_pallas
  K2 ntt_forward        csrc/ntt.cu        ntt_forward_mxu_pallas
  K3 bconv_ntt_forward  csrc/bconv_ntt.cu  bconv_ntt_forward_mxu_pallas

All three hold each row in a thread-block cluster for all log N stages,
in radix-8 passes in registers (csrc/ntt_cluster.cuh: Gentleman-Sande
for K1, the local passes then the crossing stages; Cooley-Tukey for K2
and K3): one launch, the row read once (K3 converts it straight into
shared memory) and written once.  K1's floor sum v, a sum over the rows
of a group, is a second launch in the same call that reads the scaled
rows back.

Arguments follow the JAX kernels, with one addition: `rows`, the table row
of each of the L limbs (default: all of `t`'s rows), so one `NTTTables32`
over QP serves every sub-base, including K2's complement rows that repeat
moduli.  Per-limb constants (scales, Shoup words, vmul, post_sub) are
(L,) int32 tensors holding u32 words.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build
from .._build import check_aligned
from . import ntt32
from .bconv32 import floor_sum_div_uv
from .bconv_kernels import fold_matmul_plain
from .modmath32 import u32
from .ntt32 import NTTTables32, resolve_rows


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _fwd_epilogue(out, q, sub_from, epi_scale, tensor_add):
    """(sub_from - out) * epi_scale, then the tensor-term adds: group 0 gets
    d1[0] d2[0], group 1 d1[0] d2[1] + d1[1] d2[0].  out: (..., L, N)
    int64, q: (L, 1)."""
    if sub_from is not None:
        out = (sub_from.long().view(out.shape) - out) * u32(epi_scale).view(
            -1, 1) % q
    if tensor_add is not None:
        d1, d2 = (d.long() for d in tensor_add)
        num_l, n = out.shape[-2:]
        out = out.view(2, num_l, n)
        out = torch.stack([(out[0] + d1[0] * d2[0]) % q,
                           (out[1] + (d1[0] * d2[1] + d1[1] * d2[0]) % q)
                           % q])
    return out


def ntt_forward_plain(x, t: NTTTables32, rows=None, sub_from=None,
                      epi_scale=None, epi_scale_shoup=None, tensor_add=None):
    num_l = x.shape[-2]
    rows = resolve_rows(t, rows, num_l)
    q = u32(t.q[rows.long()]).view(num_l, 1)
    out = ntt32.ntt_forward32(x, t, rows).long()
    return _fwd_epilogue(out, q, sub_from, epi_scale,
                         tensor_add).view(x.shape).int()


def ntt_inverse_plain(x, t: NTTTables32, rows=None, scale=None,
                      scale_shoup=None, mul_by=None, emit_floor_div=None):
    num_l, n = x.shape[-2:]
    rows = resolve_rows(t, rows, num_l)
    q = u32(t.q[rows.long()]).view(num_l, 1)
    if mul_by is not None:
        x = (x.long() % q) * (mul_by.long() % q) % q
    y = ntt32.ntt_inverse32(x, t, rows, scale)
    if emit_floor_div is None:
        return y
    u_c, v_c = emit_floor_div
    v = floor_sum_div_uv(y.reshape(-1, num_l, n).transpose(0, 1),
                         t.q[rows.long()], u_c, v_c)
    return y, v


def bconv_ntt_forward_plain(y, mat, t: NTTTables32, rows=None, v=None,
                            vmul=None, post_sub=None, self_rows=None,
                            sub_from=None, epi_scale=None,
                            epi_scale_shoup=None, tensor_add=None,
                            k_data=None):
    g_, k_out, alpha = mat.shape
    n = y.shape[-1]
    rows = resolve_rows(t, rows, k_out)
    q_rows = t.q[rows.long()]
    q = u32(q_rows).view(k_out, 1)
    yr = y.reshape(-1, n)  # group g's rows from g alpha, the last maybe short
    x = torch.stack([fold_matmul_plain(yr[g * alpha:(g + 1) * alpha], mat[g],
                                       q_rows).long() for g in range(g_)])
    if v is not None:
        x = (x - v.long().view(g_, 1, n) * u32(vmul).view(1, k_out, 1)) % q
    if post_sub is not None:
        x = (x - u32(post_sub).view(k_out, 1)) % q
    out = ntt32.ntt_forward32(x, t, rows).long()
    if self_rows is not None:
        kd = g_ * alpha if k_data is None else k_data
        for g in range(g_):
            lo, hi = g * alpha, min((g + 1) * alpha, kd, k_out)
            out[g, lo:hi] = self_rows[lo:hi].long()
    return _fwd_epilogue(out, q, sub_from, epi_scale,
                         tensor_add).view(g_, k_out, n).int()


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _logn(n: int) -> int:
    logn = n.bit_length() - 1
    if n != 1 << logn or not 10 <= logn <= 17:
        raise ValueError(f"N={n}: the kernels take powers of two from 2^10 "
                         "to 2^17")
    return logn


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _expect(x: Optional[torch.Tensor], shape, what: str):
    if x is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(x.shape)} != {tuple(shape)}")


# every modulus of the port is below 2^MODULUS_BITS, so is every word of a
# conversion matrix
MODULUS_BITS = 30


def sum_fits_64(terms: int, t: NTTTables32) -> bool:
    """Whether `terms` products of a residue of `t`'s base (below 2^b, b the
    bit length of its largest modulus) and a matrix word (below 2^30) sum
    below 2^64: K3's and K4's conversions then keep the sum in one 64-bit
    word, else with a carry word."""
    return terms << (t.modulus_bits + MODULUS_BITS) < 1 << 64


def _tables(t: NTTTables32, inverse: bool):
    if inverse:
        return t.q, t.inv_root_powers, t.inv_root_powers_shoup
    return t.q, t.root_powers, t.root_powers_shoup


def _epilogue_args(sub_from, epi_scale, epi_scale_shoup, tensor_add,
                   out_shape, num_l):
    if sub_from is not None:
        if epi_scale is None or epi_scale_shoup is None:
            raise ValueError("sub_from needs epi_scale and epi_scale_shoup")
        _expect(sub_from, out_shape, "sub_from")
        _expect(epi_scale, (num_l,), "epi_scale")
        _expect(epi_scale_shoup, (num_l,), "epi_scale_shoup")
    d1 = d2 = None
    if tensor_add is not None:
        d1, d2 = tensor_add
        n = out_shape[-1]
        if math.prod(out_shape[:-1]) != 2 * num_l:
            raise ValueError("tensor_add needs exactly two groups of rows")
        _expect(d1, (2, num_l, n), "tensor_add d1")
        _expect(d2, (2, num_l, n), "tensor_add d2")
    return [sub_from, epi_scale, epi_scale_shoup, d1, d2]


def ntt_forward(x: torch.Tensor, t: NTTTables32, rows=None, sub_from=None,
                epi_scale=None, epi_scale_shoup=None, tensor_add=None,
                cluster=None) -> torch.Tensor:
    """K2.  x: (..., L, N) in [0, 2q) -> NTT form in [0, q); with sub_from:
    (sub_from - NTT(x)) * epi_scale; with tensor_add = (d1, d2), each
    (2, L, N) and x of two groups: group 0 += d1[0] d2[0], group 1 +=
    d1[0] d2[1] + d1[1] d2[0].  On the card each row is one cluster of the
    radix-8 core (cluster: blocks per row, default default_cluster(N,
    K2_CLUSTER_WORDS))."""
    if _build.is_plain(x, "ntt_forward"):
        return ntt_forward_plain(x, t, rows, sub_from, epi_scale,
                                 epi_scale_shoup, tensor_add)
    n, num_l = x.shape[-1], x.shape[-2]
    logn = _logn(n)
    c = default_cluster(n, K2_CLUSTER_WORDS) if cluster is None else int(
        cluster)
    check_cluster(n, c)
    rows = resolve_rows(t, rows, num_l)
    epi = _epilogue_args(sub_from, epi_scale, epi_scale_shoup, tensor_add,
                         x.shape, num_l)
    tabs = _tables(t, inverse=False)
    _build.check_operands(x, rows, *tabs, *(e for e in epi if e is not None))
    out = torch.empty_like(x)
    check_aligned(x, out, epi[0], epi[3], epi[4])
    with torch.cuda.device(x.device):
        err = _build.library().ptk_ntt_forward(
            out.data_ptr(), x.data_ptr(), *(a.data_ptr() for a in tabs),
            rows.data_ptr(), num_l, x.numel() // n, logn,
            *(_ptr(e) for e in epi), c, _build.stream(x))
    _build.check(err, "ntt_forward")
    ntt_forward.launches += 1
    return out


def ntt_inverse(x: torch.Tensor, t: NTTTables32, rows=None, scale=None,
                scale_shoup=None, mul_by=None, emit_floor_div=None,
                cluster=None):
    """K1.  x: (..., L, N) in [0, 2q) -> coefficients in [0, q), times
    `scale` per limb (default n^-1).  mul_by: transform x * mul_by.
    emit_floor_div = (U, V): also return v = floor(sum_l y_l / q_l) per
    leading group, (G, N).  On the card each row is one cluster of the
    radix-8 core (cluster: blocks per row, default default_cluster(N)),
    and v a second launch of the same call."""
    if _build.is_plain(x, "ntt_inverse"):
        return ntt_inverse_plain(x, t, rows, scale, scale_shoup, mul_by,
                                 emit_floor_div)
    n, num_l = x.shape[-1], x.shape[-2]
    logn = _logn(n)
    c = default_cluster(n) if cluster is None else int(cluster)
    check_cluster(n, c)
    rows = resolve_rows(t, rows, num_l)
    if scale is None:
        scale = t.inv_degree[rows.long()]
        scale_shoup = t.inv_degree_shoup[rows.long()]
    elif scale_shoup is None:
        raise ValueError("scale needs scale_shoup")
    _expect(scale, (num_l,), "scale")
    _expect(scale_shoup, (num_l,), "scale_shoup")
    _expect(mul_by, x.shape, "mul_by")
    nrows = x.numel() // n
    tabs = _tables(t, inverse=True)
    extra = [scale, scale_shoup] + ([mul_by] if mul_by is not None else [])
    out = torch.empty_like(x)
    v = u_c = v_c = None
    if emit_floor_div is not None:
        u_c, v_c = emit_floor_div
        _expect(u_c, (num_l,), "U")
        _expect(v_c, (num_l,), "V")
        extra += [u_c, v_c]
        v = torch.empty((nrows // num_l, n), dtype=torch.int32,
                        device=x.device)
    _build.check_operands(x, rows, *tabs, *extra)
    check_aligned(x, mul_by, out, v)
    with torch.cuda.device(x.device):
        err = _build.library().ptk_ntt_inverse(
            out.data_ptr(), x.data_ptr(), *(a.data_ptr() for a in tabs),
            rows.data_ptr(), num_l, nrows, logn, _ptr(mul_by),
            scale.data_ptr(), scale_shoup.data_ptr(), _ptr(v), _ptr(u_c),
            _ptr(v_c), c, _build.stream(x))
    _build.check(err, "ntt_inverse")
    ntt_inverse.launches += 1
    return out if v is None else (out, v)


MAX_CLUSTER = 8          # the largest portable cluster
CLUSTER_WORDS = 1 << 13  # the default share of a row per block
# K2's: with no prologue to spread, half the crossing traffic beats twice
# the blocks (C = 4 at N = 2^16: 0.077 against 0.088 ms at (87, N), NVIDIA
# H100 80GB HBM3, 700 W; chip_smoke.py phase 6)
K2_CLUSTER_WORDS = 1 << 14
MIN_SHARE = 1 << 10      # the smallest share the radix-8 core takes


def default_cluster(n: int, words: int = CLUSTER_WORDS) -> int:
    """Blocks per row of the cluster kernels (K1-K4, K6-K8): one up to
    `words` words, then shares of `words`, at most MAX_CLUSTER blocks."""
    return min(MAX_CLUSTER, max(1, n // words))


def share_bytes(words: int) -> int:
    """Shared memory of a share of `words` words on the core: one pad word
    per 32 (csrc/ntt_cluster.cuh, cluster_smem_words)."""
    return (words + words // 32) * 4


def check_cluster(n: int, cluster: int) -> None:
    if (cluster < 1 or cluster > MAX_CLUSTER or cluster & (cluster - 1)
            or n // cluster < MIN_SHARE
            or share_bytes(n // cluster) > _build.SMEM_OPTIN):
        raise ValueError(f"cluster={cluster} at N={n}: a power of two up to "
                         f"{MAX_CLUSTER} whose share of at least {MIN_SHARE} "
                         "words fits shared memory")


def bconv_ntt_forward(y: torch.Tensor, mat: torch.Tensor, t: NTTTables32,
                      rows=None, v=None, vmul=None, post_sub=None,
                      self_rows=None, sub_from=None, epi_scale=None,
                      epi_scale_shoup=None, tensor_add=None,
                      k_data=None, cluster=None) -> torch.Tensor:
    """K3.  y: (G, alpha, N), or (k_in, N) with group g's rows from row g
    alpha and a short last group ((G - 1) alpha < k_in <= G alpha), in [0,
    2^b) for b the bit length of `t`'s largest modulus; mat: (G, k_out,
    alpha), words below 2^30.  Row j of group g: x = sum_i y[g alpha + i]
    mat[g, j, i] mod q_j [- v[g] vmul[j]] [- post_sub[j]], then NTT_j(x)
    and the K2 epilogue.  self_rows (>= min(k_data, G alpha), N): output
    rows g alpha <= j < min((g+1) alpha, k_data) take self_rows[j]
    untransformed (epilogue still applies).  cluster: blocks per row on
    the card (default default_cluster(N))."""
    if _build.is_plain(y, "bconv_ntt_forward"):
        return bconv_ntt_forward_plain(y, mat, t, rows, v, vmul, post_sub,
                                       self_rows, sub_from, epi_scale,
                                       epi_scale_shoup, tensor_add, k_data)
    if mat.dim() != 3:
        raise ValueError(f"bconv_ntt_forward: mat {tuple(mat.shape)} is not "
                         "(G, k_out, alpha)")
    g_, k_out, alpha = mat.shape
    n = y.shape[-1]
    logn = _logn(n)
    if y.dim() == 3:
        _expect(y, (g_, alpha, n), "y")
    elif y.dim() != 2 or not (g_ - 1) * alpha < y.shape[0] <= g_ * alpha:
        raise ValueError(f"bconv_ntt_forward: y {tuple(y.shape)} is neither "
                         f"({g_}, {alpha}, N) nor ({g_} groups of {alpha} "
                         "rows, N)")
    k_in = y.numel() // n
    c = default_cluster(n) if cluster is None else int(cluster)
    check_cluster(n, c)
    rows = resolve_rows(t, rows, k_out)
    if v is not None:
        _expect(v, (g_, n), "v")
        _expect(vmul, (k_out,), "vmul")
    _expect(post_sub, (k_out,), "post_sub")
    if self_rows is not None:
        if tensor_add is not None:
            raise ValueError("self_rows and tensor_add do not combine")
        if self_rows.dim() != 2 or self_rows.shape[1] != n:
            raise ValueError("self_rows must be (rows, N)")
    k_data = g_ * alpha if k_data is None else k_data
    if self_rows is not None and self_rows.shape[0] < min(k_data, g_ * alpha):
        raise ValueError("self_rows has fewer rows than the digits cover")
    epi = _epilogue_args(sub_from, epi_scale, epi_scale_shoup, tensor_add,
                         (g_, k_out, n), k_out)
    tabs = _tables(t, inverse=False)
    opt = [a for a in (v, vmul, post_sub, self_rows) if a is not None]
    _build.check_operands(y, mat, rows, *tabs, *opt,
                          *(e for e in epi if e is not None))
    out = torch.empty((g_, k_out, n), dtype=torch.int32, device=y.device)
    check_aligned(out, y, v, self_rows, epi[0], epi[3], epi[4])
    with torch.cuda.device(y.device):
        err = _build.library().ptk_bconv_ntt_forward(
            out.data_ptr(), y.data_ptr(), mat.data_ptr(), g_, alpha, k_out,
            k_in, *(a.data_ptr() for a in tabs), rows.data_ptr(), logn,
            _ptr(v), _ptr(vmul), _ptr(post_sub), _ptr(self_rows), k_data,
            *(_ptr(e) for e in epi), c, int(sum_fits_64(alpha, t)),
            _build.stream(y))
    _build.check(err, "bconv_ntt_forward")
    bconv_ntt_forward.launches += 1
    return out


ntt_forward.launches = 0
ntt_inverse.launches = 0
bconv_ntt_forward.launches = 0

"""K8 and K7: the CKKS step's moddown epilogues, their CUDA kernels and
plain twins.  Both take the moddown of both key-switch halves (g = 0, 1)
after K1 has transformed their P rows:

    delta_j   = sum_i y[g, i] mat[j, i] - v[g] vmul[j]  mod q_j   (exact)
    m[g, j]   = (sub[g, j] - NTT_j(delta_j)) P^-1 + c_g[j]
    c_0 = d1[0] d2[0],  c_1 = d1[0] d2[1] + d1[1] d2[0]   (the tensor adds)

  K8 moddown_rows     csrc/moddown_rows.cu     replaces ntt_mxu_pallas.py:
                                               moddown_mxu_bconv_pallas
      m, as K3 computes it (bconv_ntt_forward with v, sub_from, epi_scale,
      tensor_add), with one block serving R output rows so that each y
      element is read once for all R.  The JAX package selects it with
      PHANTOM_MODDOWN_R=R, the port with CKKSPipeline32(moddown_rows=R).
  K7 moddown_rescale  csrc/moddown_rescale.cu  moddown_rescale_mxu_pallas
      m and the rescale in one call with one forward NTT per row, by
      linearity: rows [0, k-1) of the result are
      (s_j P^-1 + c_g - NTT_j(delta_j P^-1 + xl - half_j)) q_last^-1 with
      xl = iNTT(m[g, k-1]) + half mod q_last, row k-1 is m[g, k-1] itself.
      The JAX package selects it with PHANTOM_MERGED_EPILOGUE=1, the port
      with CKKSPipeline32(merged_epilogue=True).

Both are bound by device memory (csrc/).  The plain twins are the composed
functions: K8's is K3's plain version, K7's that and the rescale.  `rows`
is the table row of each of the k Ql rows, as in ops/ntt_kernels.py.
"""

from __future__ import annotations

import torch

from .. import _build
from .modmath32 import u32
from .ntt32 import NTTTables32, resolve_rows
from .ntt_kernels import (_epilogue_args, _expect, _logn, _ptr, _tables,
                          bconv_ntt_forward_plain, ntt_inverse_plain)

MAX_ROWS = 8  # K8's rows per block: its R sums live in registers


def moddown_rows_plain(y, mat, v, vmul, sub_from, tensor_add,
                       t: NTTTables32, rows, epi_scale, epi_scale_shoup,
                       rows_per_block: int = 8) -> torch.Tensor:
    """y: (2, alpha, N); mat: (k, alpha); v: (2, N); vmul: (k,); sub_from:
    (2, k, N); tensor_add: (d1, d2), each (2, k, N), or None -> (2, k, N).
    The result does not depend on rows_per_block."""
    return bconv_ntt_forward_plain(
        y, mat.expand(2, -1, -1), t, rows, v=v, vmul=vmul, sub_from=sub_from,
        epi_scale=epi_scale, epi_scale_shoup=epi_scale_shoup,
        tensor_add=tensor_add)


def moddown_rows(y: torch.Tensor, mat: torch.Tensor, v: torch.Tensor,
                 vmul: torch.Tensor, sub_from: torch.Tensor, tensor_add,
                 t: NTTTables32, rows, epi_scale: torch.Tensor,
                 epi_scale_shoup: torch.Tensor,
                 rows_per_block: int = 8) -> torch.Tensor:
    """K8 on CUDA tensors; the plain version on CPU tensors.  Arguments as
    moddown_rows_plain's; rows_per_block: R in [1, MAX_ROWS]."""
    if _build.is_plain(y, "moddown_rows"):
        return moddown_rows_plain(y, mat, v, vmul, sub_from, tensor_add, t,
                                  rows, epi_scale, epi_scale_shoup,
                                  rows_per_block)
    g_, alpha, n = y.shape
    k = mat.shape[0]
    if g_ != 2:
        raise ValueError(f"moddown_rows: y {tuple(y.shape)} is not "
                         "(2, alpha, N)")
    if not 1 <= rows_per_block <= MAX_ROWS:
        raise ValueError(f"moddown_rows: rows_per_block={rows_per_block} "
                         f"outside [1, {MAX_ROWS}]")
    logn = _logn(n)
    rows = resolve_rows(t, rows, k)
    _expect(mat, (k, alpha), "mat")
    _expect(v, (2, n), "v")
    _expect(vmul, (k,), "vmul")
    if sub_from is None:
        raise ValueError("moddown_rows: sub_from is required")
    epi = _epilogue_args(sub_from, epi_scale, epi_scale_shoup, tensor_add,
                         (2, k, n), k)
    tabs = _tables(t, inverse=False)
    _build.check_operands(y, mat, v, vmul, rows, *tabs,
                          *(e for e in epi if e is not None))
    out = torch.empty((2, k, n), dtype=torch.int32, device=y.device)
    with torch.cuda.device(y.device):
        err = _build.library().ptk_moddown_rows(
            out.data_ptr(), y.data_ptr(), mat.data_ptr(), v.data_ptr(),
            vmul.data_ptr(), alpha, k, rows_per_block,
            *(a.data_ptr() for a in tabs), rows.data_ptr(), logn,
            *(_ptr(e) for e in epi),
            _build.stream(y))
    _build.check(err, "moddown_rows")
    moddown_rows.launches += 1
    return out


def moddown_rescale_plain(y, mat, v, vmul, sub_from, tensor_add,
                          t: NTTTables32, rows, pinv, pinv_shoup, half: int,
                          half_mod_q, qlast_inv,
                          qlast_inv_shoup) -> torch.Tensor:
    """y: (2, alpha, N); mat: (k, alpha); v: (2, N); vmul, pinv,
    pinv_shoup: (k,); sub_from and each of tensor_add = (d1, d2): (2, k,
    N); half = q_last // 2; half_mod_q, qlast_inv, qlast_inv_shoup: (k-1,)
    -> (2, k, N): rows [0, k-1) rescaled, row k-1 the moddown output."""
    k = mat.shape[0]
    rows = resolve_rows(t, rows, k)
    m = moddown_rows_plain(y, mat, v, vmul, sub_from, tensor_add, t, rows,
                           pinv, pinv_shoup)
    xl = ntt_inverse_plain(m[:, k - 1:k], t, rows[k - 1:k])
    xl = ((xl.long() + half) % u32(t.q[rows[k - 1].long()])).int()
    out = bconv_ntt_forward_plain(
        xl, torch.ones((2, k - 1, 1), dtype=torch.int32, device=y.device), t,
        rows[:k - 1], post_sub=half_mod_q, sub_from=m[:, :k - 1],
        epi_scale=qlast_inv, epi_scale_shoup=qlast_inv_shoup)
    return torch.cat([out, m[:, k - 1:]], dim=1)


def moddown_rescale(y: torch.Tensor, mat: torch.Tensor, v: torch.Tensor,
                    vmul: torch.Tensor, sub_from: torch.Tensor, tensor_add,
                    t: NTTTables32, rows, pinv: torch.Tensor,
                    pinv_shoup: torch.Tensor, half: int,
                    half_mod_q: torch.Tensor, qlast_inv: torch.Tensor,
                    qlast_inv_shoup: torch.Tensor) -> torch.Tensor:
    """K7 on CUDA tensors; the plain version on CPU tensors.  Arguments as
    moddown_rescale_plain's (tensor_add is required, k >= 2)."""
    if _build.is_plain(y, "moddown_rescale"):
        return moddown_rescale_plain(y, mat, v, vmul, sub_from, tensor_add,
                                     t, rows, pinv, pinv_shoup, half,
                                     half_mod_q, qlast_inv, qlast_inv_shoup)
    g_, alpha, n = y.shape
    k = mat.shape[0]
    if g_ != 2 or k < 2:
        raise ValueError(f"moddown_rescale: y {tuple(y.shape)}, mat "
                         f"{tuple(mat.shape)}: needs (2, alpha, N), k >= 2")
    logn = _logn(n)
    rows = resolve_rows(t, rows, k)
    d1, d2 = tensor_add
    _expect(mat, (k, alpha), "mat")
    _expect(v, (2, n), "v")
    for x, what in ((sub_from, "sub_from"), (d1, "d1"), (d2, "d2")):
        _expect(x, (2, k, n), what)
    for x, what in ((vmul, "vmul"), (pinv, "pinv"),
                    (pinv_shoup, "pinv_shoup")):
        _expect(x, (k,), what)
    for x, what in ((half_mod_q, "half_mod_q"), (qlast_inv, "qlast_inv"),
                    (qlast_inv_shoup, "qlast_inv_shoup")):
        _expect(x, (k - 1,), what)
    fwd = _tables(t, inverse=False)
    inv = (t.inv_root_powers, t.inv_root_powers_shoup, t.inv_degree,
           t.inv_degree_shoup)
    operands = (y, mat, v, vmul, sub_from, d1, d2, pinv, pinv_shoup,
                half_mod_q, qlast_inv, qlast_inv_shoup)
    _build.check_operands(*operands, rows, *fwd, *inv)
    out = torch.empty((2, k, n), dtype=torch.int32, device=y.device)
    scratch = torch.empty((2, n), dtype=torch.int32, device=y.device)
    with torch.cuda.device(y.device):
        err = _build.library().ptk_moddown_rescale(
            out.data_ptr(), scratch.data_ptr(),
            *(a.data_ptr() for a in operands),
            int(half), alpha, k, *(a.data_ptr() for a in fwd + inv),
            rows.data_ptr(), logn, _build.stream(y))
    _build.check(err, "moddown_rescale")
    moddown_rescale.launches += 1
    return out


moddown_rows.launches = 0
moddown_rescale.launches = 0

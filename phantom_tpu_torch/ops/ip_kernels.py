"""K9: the evaluation-key inner product of hybrid key switching, its CUDA
kernel and plain twin.

    out[h, j, c] = sum_d t[d, j, src(c)] evk[d, h, j, c]  mod q_j  (h = 0, 1)

src(c) = perm[c] when a gather index `perm` is given (the NTT-form Galois
permutation of a hoisted rotation: the kernel reads the shared modup tensor
through it, so t[:, :, perm] is never stored), else c.  Replaces
phantom_tpu/ops/ntt_mxu_pallas.py:ip_mxu_pallas, which the JAX package's
inner_product32 takes under PHANTOM_IP_KERNEL=1.  The port takes it for
every inner product outside K4: the step's on the xla-split route (the
headline) and each key-switched step of the hoisted forms.

The CUDA kernel (csrc/ip.cu) gives each thread one word of one row and
loops over the digits, both sums exact in registers; it is bound by device
memory, the evk stream first.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .modmath32 import u32
from .ntt_kernels import _expect, _ptr


def inner_product_plain(t: torch.Tensor, evk: torch.Tensor, q: torch.Tensor,
                        perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """t: (beta, k_out, N); evk: (beta, 2, k_out, N); q: (k_out,); perm:
    (N,) or None -> (2, k_out, N) int32 in [0, q).  Products are below
    2^60 (q < 2^30), so four of them and a reduced partial sum fit int64:
    the partial sum is reduced every four digits."""
    if perm is not None:
        t = t[:, :, perm.long()]
    qc = u32(q).view(-1, 1)
    acc = None
    for d in range(t.shape[0]):
        p_ = t[d].long() * evk[d].long()
        acc = p_ if acc is None else acc + p_
        if d % 4 == 3 and d + 1 < t.shape[0]:
            acc %= qc
    return (acc % qc).int()


def inner_product(t: torch.Tensor, evk: torch.Tensor, q: torch.Tensor,
                  perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9 on CUDA tensors; the plain version on CPU tensors.  t: (beta,
    k_out, N) residues; evk: (beta, 2, k_out, N); q: (k_out,) the modulus
    of each row; perm: (N,) int32 indices in [0, N) (not checked), or
    None.  Returns (2, k_out, N) int32 in [0, q)."""
    if _build.is_plain(t, "inner_product"):
        return inner_product_plain(t, evk, q, perm)
    beta, k_out, n = t.shape
    _expect(evk, (beta, 2, k_out, n), "evk")
    _expect(q, (k_out,), "q")
    _expect(perm, (n,), "perm")
    opt = [perm] if perm is not None else []
    _build.check_operands(t, evk, q, *opt)
    out = torch.empty((2, k_out, n), dtype=torch.int32, device=t.device)
    with torch.cuda.device(t.device):
        err = _build.library().ptk_inner_product(
            out.data_ptr(), t.data_ptr(), evk.data_ptr(), q.data_ptr(),
            _ptr(perm), beta, k_out, n, _build.stream(t))
    _build.check(err, "inner_product")
    inner_product.launches += 1
    return out


inner_product.launches = 0

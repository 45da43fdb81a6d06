"""The coefficient-sharded CKKS multiply + relinearize + rescale on 32-bit
residues (counterpart of phantom_tpu/parallel/sharded32.py:333-470, its
"xla" engine).

Each rank holds the (2, size_ql, n1, c2) block of both operands
(mesh.shard_coeff) and its slice of the relin key, (beta, 2, size_qlp,
n1, c2).  Every stage but the NTT is local to a coefficient and runs on
the port's functions over the block viewed as (rows, n1 c2): the tensor
product (pipeline32._tensor_2x2), the digit conversions (bconv_approx32,
K5), the inner product (inner_product32, K9), the moddown's exact
conversion (bconv_exact32, K5, both halves in one launch) and the
moddown's and rescale's modular glue (plain torch, as the JAX step's).
The transforms are the sharded ones (ntt_sharded.py, P1 with the
all-to-alls), each over all the rows it transforms at once: c2's
inverse, the modup's forward of every digit, the P rows' inverse and
the delta's forward of both halves, the last limb's inverse and the
rounding correction's forward of both polys.  The step is bit-identical
to pipeline32.mult_relin_rescale32 on the whole ciphertext.

The JAX package's "mxu" engine (its four-step MXU matmul NTT) is the
TPU's: build_sharded32 refuses it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import pipeline32 as pp
from ..ops.bconv32 import bconv_approx32, bconv_exact32
from ..ops.modmath32 import mul_mod_shoup32, u32
from .mesh import CoeffMesh, coeff_split, shard_coeff
from .ntt_sharded import (ntt_forward_sharded, ntt_inverse_sharded,
                          prepare_sharded_tables32)

ENGINES = ("xla",)


class Sharded32Consts(nn.Module):
    """The level's u32 key-switch and rescale constants (a CKKSPipeline32
    on the xla-split route, without its evk), the sharded tables of the
    context's base and the rank's slice of the relin key, evk (beta, 2,
    size_qlp, n1, c2)."""

    def __init__(self, ctx, rlk: torch.Tensor, mesh: CoeffMesh,
                 chain_index: int = 1):
        super().__init__()
        self.pipe = pp.CKKSPipeline32(ctx, None, chain_index,
                                      modup="xla-split")
        self.n1, self.n2 = coeff_split(ctx.params.n, mesh)
        self.st = prepare_sharded_tables32(ctx.ntt)
        self.register_buffer("evk", shard_coeff(
            pp.convert_key32(ctx, rlk, chain_index), mesh))

    @property
    def ks(self) -> pp.KeySwitch32:
        return self.pipe.ks


def build_sharded32(ctx, rlk: torch.Tensor, mesh: CoeffMesh,
                    chain_index: int = 1,
                    engine: str = "xla") -> Sharded32Consts:
    """rlk: the relin key (dnum, 2, K, N) over QP; the constants on the
    mesh's device."""
    if engine == "mxu":
        raise ValueError("engine 'mxu' is the JAX package's four-step MXU "
                         "matmul NTT, a TPU engine: the port shards the "
                         "butterfly NTT (engine 'xla', P1)")
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    return Sharded32Consts(ctx, rlk, mesh, chain_index).to(mesh.device)


def sharded_mult_relin_rescale32(c: Sharded32Consts, mesh: CoeffMesh,
                                 d1: torch.Tensor, d2: torch.Tensor,
                                 ops: pp.Kernels = pp.KERNELS
                                 ) -> torch.Tensor:
    """d1, d2: the rank's (2, size_ql, n1, c2) int32 blocks, NTT form ->
    (2, size_ql - 1, n1, c2).  ops: P1, K5 and K9 (pipeline32.KERNELS)
    or their plain versions (PLAIN)."""
    ks, p = c.ks, c.pipe
    k, alpha, beta = ks.size_ql, ks.size_p, ks.beta
    kp = k + alpha
    n1, c2 = c.n1, c.n2 // mesh.coeff
    cols = n1 * c2

    def fwd(x, rows):
        return ntt_forward_sharded(x, c.st, mesh, rows, ops)

    def inv(x, rows):
        return ntt_inverse_sharded(x, c.st, mesh, rows, ops=ops)

    q = pp._qcol(ks.mv_ql.q)
    t0, t1, t2 = pp._tensor_2x2(q, d1.reshape(2, k, cols),
                                d2.reshape(2, k, cols))
    # modup: c2 to coefficients, per digit the fast conversion of its rows
    # to the complement (K5), the digit's rows between, one forward NTT
    c2_coeff = inv(t2.int(), ks.rows_ql)
    t_up = []
    for d in range(beta):
        lo, hi = d * alpha, min((d + 1) * alpha, k)
        x = c2_coeff[lo:hi]
        compl = bconv_approx32(x, ks.digit_convs[d], ops.fold_matmul)
        t_up.append(torch.cat([compl[:lo], x, compl[lo:]]))
    t_up = fwd(torch.stack(t_up), ks.rows_qlp)
    s = pp.inner_product32(ks, t_up, c.evk.reshape(beta, 2, kp, cols), ops)
    s = torch.stack(s)
    # moddown of both halves: the P rows' inverse, the exact conversion P
    # -> Ql over both halves' columns (one K5), its forward, (x - .) P^-1
    # plus the tensor terms c0, c1
    x_p = inv(s[:, k:].contiguous(), ks.rows_p)
    delta = bconv_exact32(x_p.transpose(0, 1), ks.p_to_q,
                          ops.fold_matmul).transpose(0, 1)
    delta = fwd(delta.contiguous(), ks.rows_ql).long()
    down = mul_mod_shoup32((s[:, :k].long() - delta) % q, pp._qcol(ks.pinv),
                           pp._qcol(ks.pinv_shoup), q)
    out = (torch.stack([t0, t1]) + down) % q
    # rescale: the last limb to coefficients, + half, reduced mod each
    # q_i less half, forward, (x - .) q_last^-1
    xl = inv(out[:, k - 1:k].int().contiguous(), ks.rows_ql[k - 1:k])
    xl = (xl.long() + p.half) % u32(ks.mv_ql.q[k - 1])
    rest = q[:k - 1]
    delta = (xl % rest - pp._qcol(p.half_mod_q)) % rest
    delta = fwd(delta.int(), p.rows_ql_next).long()
    res = mul_mod_shoup32((out[:, :k - 1] - delta) % rest,
                          pp._qcol(p.qlast_inv),
                          pp._qcol(p.qlast_inv_shoup), rest).int()
    return res.reshape(2, k - 1, n1, c2)


def build_sharded_step32(ctx, rlk: torch.Tensor, mesh: CoeffMesh,
                         chain_index: int = 1, engine: str = "xla"):
    """(consts, step): step(d1, d2) over the rank's (B / dp, 2, size_ql,
    n1, c2) items (mesh.shard_batch of a (B, 2, size_ql, N) batch) ->
    (B / dp, 2, size_ql - 1, n1, c2)."""
    consts = build_sharded32(ctx, rlk, mesh, chain_index, engine)

    def step(d1, d2, ops=pp.KERNELS):
        return torch.stack([sharded_mult_relin_rescale32(
            consts, mesh, a, b, ops) for a, b in zip(d1, d2)])
    return consts, step

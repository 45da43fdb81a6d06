"""The limb-sharded CKKS multiply + relinearize + rescale step on u64 words
(the ("dp", "limb") layout's step: phantom_tpu/parallel/mesh.py:77
sharded_mul_relin_rescale_step, which jits the u64 evaluator's
rescale_to_next(multiply_and_relin) vmapped over a batch and lets GSPMD
place the collectives).

Rank l of a limb group holds the rows R_l = [l k / limb, (l + 1) k /
limb) of both operands at the level (k = size_ql), and of the special
primes its block P_l of ceil(alpha / limb) rows (the last block shorter,
padded for the all-gathers).  Every target row of a base conversion, of
the key's inner product and of the epilogues depends only on its own
modulus, so each stage runs on the rank's rows (U1-U4, the same kernels
as the local step) and only these collectives cross the group:

  1. U4's tensor product over R_l;
  2. c2's rows R_l through U1's inverse (times n^-1 QhatInv where alpha
     divides k, the fused modup's scale), all-gathered: c2 (k, N) in
     coefficient form on every rank;
  3. per digit, U2 converts its rows to the rank's rows outside it (R_l
     outside the digit, then P_l), U1 transforms them forward, and the
     rank's rows inside the digit are c2's own NTT-form rows: (beta,
     |R_l| + |P_l|, N);
  4. U3 with the key's rows R_l and P_l: (2, |R_l| + |P_l|, N);
  5. the moddown: U1's inverse of the P_l rows of both halves,
     all-gathered to (2, alpha, N); U2's exact conversion P -> R_l over
     both halves at once, U1 forward, U4's (x - delta) P^-1 + c0 / c1;
  6. the rescale: the rank holding row k - 1 runs U1's inverse on it and
     broadcasts the (2, 1, N) row over the group; every rank runs U4's
     rescale_delta, U1 forward and U4's Shoup form on its rows below
     k - 1;
  7. the (2, k - 1, N) result all-gathered, whole on every rank of the
     limb group (the JAX package's out_shardings=P("dp") ends the same
     way).

Each stage is the local step's, row for row (the local step takes the
fused modup where alpha divides k and the inverse NTT then the
approximate conversion elsewhere, and so does this one; the two routes
are bit-identical), so the output is bit-equal to the u64 evaluator's.
A world of one runs the same collectives.  `collectives` counts the
collectives and the bytes each rank receives, by kind.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch import nn

from ..ops import bconv as bc
from ..ops import polyops as po
from ..ops.rns_host import ModulusVec, modulus_vec
from ..schemes.keyswitch import KERNELS64, Kernels64
from .mesh import LimbMesh


class _Collectives:
    """The limb step's collectives: calls and bytes received a rank, by
    kind ("c2", "P rows", "last row", "result")."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = {}
        self.bytes = {}

    def add(self, kind: str, nbytes: int) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes


collectives = _Collectives()


def _gather(x: torch.Tensor, mesh: LimbMesh, kind: str) -> List[torch.Tensor]:
    """all_gather of equal blocks over the limb group, in limb order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.limb)]
    dist.all_gather(parts, x, group=mesh.group)
    collectives.add(kind, 8 * x.numel() * mesh.limb)
    return parts


def _rows_of(c: bc.BaseConvConsts, idx: List[int]) -> bc.BaseConvConsts:
    """A conversion restricted to the output rows `idx` of its obase (each
    output row depends on its own modulus only)."""
    i = torch.tensor(idx, dtype=torch.long, device=c.qhat_mod_p.device)
    return c._replace(obase=ModulusVec(*(v.index_select(0, i)
                                         for v in c.obase)),
                      qhat_mod_p=c.qhat_mod_p.index_select(0, i),
                      q_mod_p=c.q_mod_p.index_select(0, i),
                      pow64_mod_p=c.pow64_mod_p.index_select(0, i))


def _i32(rows, device) -> torch.Tensor:
    return torch.tensor(list(rows), dtype=torch.int32, device=device)


class LimbStepConsts(nn.Module):
    """One rank's share of a level's tables for the limb step, on the
    context's device (the mesh's): its rows R_l = [lo, hi) of Ql and P_l =
    [p_lo, p_hi) of P, per digit the conversion from the digit to the
    rank's rows outside it (sliced from the level's digit_convs) with
    their table rows, the exact conversion P -> R_l (sliced from p_to_q),
    U4's P^-1 over R_l and the rescale's table over R_l below k - 1, U3's
    moduli over R_l u P_l, the fused modup's scale over R_l, and the
    key's rows R_l u P_l of its first beta digits (the buffer evk, (beta,
    2, |R_l| + |P_l|, N)); the whole key stays with the caller, as
    keyswitch.evk_rows reads its rows.  rlk: the relin key (dnum, 2, K,
    N) over QP, int64 words."""

    def __init__(self, ctx, rlk: torch.Tensor, mesh: LimbMesh,
                 chain_index: int = 1):
        super().__init__()
        ctx.require_u64("the limb-sharded step")
        if ctx.params.scheme != "ckks":
            raise ValueError("the limb-sharded step rescales: CKKS only "
                             "(rescale_to_next raises on BFV and BGV)")
        dev = ctx.key_q.device
        if torch.device(mesh.device) != dev:
            raise ValueError(f"the context is on {dev}, the mesh on "
                             f"{mesh.device}")
        cd = ctx.get_context_data(chain_index)
        prm = ctx.params
        k, alpha, size_q = cd.size_ql, prm.size_p, prm.size_q
        if k < 2:
            raise ValueError("cannot rescale: last level")
        if k % mesh.limb:
            raise ValueError(f"{k} limbs do not divide by limb = "
                             f"{mesh.limb}")
        self.size_ql, self.alpha = k, alpha
        per = k // mesh.limb
        lo, hi = mesh.limb_index * per, (mesh.limb_index + 1) * per
        self.lo, self.hi = lo, hi
        self.p_rows = -(-alpha // mesh.limb)          # P's padded block
        p_lo = min(mesh.limb_index * self.p_rows, alpha)
        p_hi = min(p_lo + self.p_rows, alpha)
        self.p_lo, self.p_hi = p_lo, p_hi
        self.holder = hi == k                         # holds row k - 1
        self.fused = k % alpha == 0
        ks, host_ks, rc = cd.u64.ks, cd.ks, cd.rescale
        moduli = cd.moduli
        own = list(range(lo, hi))
        own_p = list(range(p_lo, p_hi))
        below = list(range(lo, min(hi, k - 1)))
        self.mv = modulus_vec(moduli[lo:hi], dev)
        self.rows_own = _i32(own, dev)
        self.rows_p = _i32((size_q + i for i in own_p), dev)
        self.row_last = _i32([k - 1], dev)
        self.rows_below = _i32(below, dev)
        self.digits = []
        for d, conv in enumerate(ks.digit_convs):
            d_lo, d_hi = d * alpha, min(d * alpha + alpha, k)
            before = list(range(lo, min(hi, d_lo)))
            after = list(range(max(lo, d_hi), hi))
            # the complement base: Ql below the digit, above it, then P
            idx = (before + [j - (d_hi - d_lo) for j in after]
                   + [k - (d_hi - d_lo) + i for i in own_p])
            a = max(lo, d_lo) - lo
            self.digits.append(dict(
                lo=d_lo, hi=d_hi, before=len(before),
                inside=(a, max(a, min(hi, d_hi) - lo)),
                conv=_rows_of(conv, idx) if idx else None,
                rows=_i32(before + after + [size_q + i for i in own_p],
                          dev)))
        self.p_to_own = _rows_of(ks.p_to_q, own)
        self.pinv = po.limbs(moduli[lo:hi], w=host_ks.pinv_mod_q[lo:hi],
                             device=dev)
        self.rescale = po.limbs(
            [moduli[j] for j in below], w=[rc.qlast_inv[j] for j in below],
            e=[rc.half_mod_q[j] for j in below],
            scalars=(moduli[-1], rc.half), device=dev) if below else None
        i = torch.tensor(own + [k + j for j in own_p], dtype=torch.long,
                         device=dev)
        self.qlp = ModulusVec(*(v.index_select(0, i) for v in ks.qlp))
        self.pow64 = ks.pow64_mod_qlp.index_select(0, i)
        self.modup_scale = ks.modup_scale[lo:hi]
        self.modup_scale_shoup = ks.modup_scale_shoup[lo:hi]
        key_rows = torch.tensor(own + [size_q + j for j in own_p],
                                dtype=torch.long, device=rlk.device)
        beta = len(ks.digit_convs)
        self.register_buffer("evk", rlk[:beta].index_select(2, key_rows)
                             .to(dev).contiguous())


def _modup(c: LimbStepConsts, ntt, c2_own: torch.Tensor, mesh: LimbMesh,
           ops: Kernels64) -> torch.Tensor:
    """Stages 2-3: the NTT-form c2 rows R_l (|R_l|, N) -> (beta, |R_l| +
    |P_l|, N) in NTT form."""
    if c.fused:
        y_own = ops.ntt_inverse(c2_own, ntt, c.rows_own, c.modup_scale,
                                c.modup_scale_shoup)
    else:
        y_own = ops.ntt_inverse(c2_own, ntt, c.rows_own)
    y = torch.cat(_gather(y_own, mesh, "c2"))
    form = "reduce" if c.fused else "approx"
    out = []
    for dg in c.digits:
        a, b = dg["inside"]
        if dg["conv"] is None:  # every row of the rank is the digit's
            out.append(c2_own)
            continue
        compl = ops.bconv(y[dg["lo"]:dg["hi"]], dg["conv"], form)
        compl = ops.ntt_forward(compl, ntt, dg["rows"])
        cut = dg["before"]
        out.append(torch.cat([compl[:cut], c2_own[a:b], compl[cut:]]))
    return torch.stack(out)


def _moddown(c: LimbStepConsts, ntt, s: torch.Tensor, adds: torch.Tensor,
             mesh: LimbMesh, ops: Kernels64) -> torch.Tensor:
    """Stage 5: both halves of (2, |R_l| + |P_l|, N) down to R_l, NTT
    form, plus `adds` (2, |R_l|, N)."""
    r = c.hi - c.lo
    n = s.shape[-1]
    pr = c.p_hi - c.p_lo
    send = s.new_zeros((c.p_rows, 2, n))
    if pr:
        send[:pr] = ops.ntt_inverse(s[:, r:], ntt, c.rows_p).transpose(0, 1)
    x_p = torch.cat(_gather(send, mesh, "P rows"))[:c.alpha]
    delta = bc.bconv_exact(x_p.reshape(c.alpha, 2 * n), c.p_to_own, ops.bconv)
    delta = delta.reshape(r, 2, n).transpose(0, 1).contiguous()
    delta = ops.ntt_forward(delta, ntt, c.rows_own)
    return ops.shoup_rns(s[:, :r], c.pinv, delta, adds)


def _rescale(c: LimbStepConsts, ntt, x: torch.Tensor, mesh: LimbMesh,
             ops: Kernels64) -> torch.Tensor:
    """Stage 6: (2, |R_l|, N) NTT form -> the rank's rows below k - 1 of
    round(x / q_last), (2, |R_l \\ {k - 1}|, N)."""
    n = x.shape[-1]
    if c.holder:
        last = ops.ntt_inverse(x[:, -1:], ntt, c.row_last)
    else:
        last = x.new_empty((2, 1, n))
    dist.broadcast(last, src=mesh.group_ranks[-1], group=mesh.group)
    collectives.add("last row", 8 * last.numel())
    if c.rescale is None:
        return x[:, :0]
    below = c.rows_below.numel()
    delta = ops.ntt_forward(ops.rescale_delta(last, c.rescale), ntt,
                            c.rows_below)
    return ops.shoup_rns(x[:, :below], c.rescale, delta)


def limb_mult_relin_rescale(ctx, c: LimbStepConsts, mesh: LimbMesh,
                            d1: torch.Tensor, d2: torch.Tensor,
                            ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """One item: the rank's rows (2, |R_l|, N) of two NTT-form size-2
    ciphertexts at the consts' level -> rescale_to_next(
    multiply_and_relin) (2, k - 1, N), whole on every rank of the limb
    group."""
    ntt = ctx.ntt64
    r = c.hi - c.lo
    if d1.shape[-2] != r or d2.shape != d1.shape or d1.shape[0] != 2:
        raise ValueError(f"the limb step takes the rank's (2, {r}, N) rows, "
                         f"not {tuple(d1.shape)} and {tuple(d2.shape)}")
    prod = ops.tensor_prod_2x2(d1, d2, c.mv)
    t = _modup(c, ntt, prod[2], mesh, ops)
    s = ops.inner_product(t, c.evk, *c.qlp, c.pow64, None)
    x = _moddown(c, ntt, s, prod[:2], mesh, ops)
    mine = _rescale(c, ntt, x, mesh, ops)
    send = x.new_zeros((2, r, x.shape[-1]))
    send[:, :mine.shape[1]] = mine
    parts = _gather(send, mesh, "result")
    k = c.size_ql
    return torch.cat([p[:, :min(r, k - 1 - i * r)]
                      for i, p in enumerate(parts)], dim=1)


def limb_step(ctx, c: LimbStepConsts, mesh: LimbMesh, b1: torch.Tensor,
              b2: torch.Tensor, ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """The rank's (B / dp, 2, |R_l|, N) blocks -> (B / dp, 2, k - 1, N),
    item by item (the JAX package's vmap)."""
    if b1.dim() != 4 or b1.shape != b2.shape:
        raise ValueError(f"the limb step takes (B / dp, 2, L / limb, N) "
                         f"blocks, not {tuple(b1.shape)} and "
                         f"{tuple(b2.shape)}")
    return torch.stack([limb_mult_relin_rescale(ctx, c, mesh, a, b, ops)
                        for a, b in zip(b1, b2)])

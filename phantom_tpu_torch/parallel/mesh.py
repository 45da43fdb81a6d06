"""The ("dp", "coeff") mesh over torch.distributed, and the coefficient
layout's shard and gather (counterpart of phantom_tpu/parallel/mesh.py:42
make_coeff_mesh and :73 shard_ciphertext_data).

The world's ranks form a dp x coeff grid, rank = d coeff + c: the dp
groups of `coeff` consecutive ranks each take their share of a batch of
ciphertext pairs, and inside a group the coefficients of every
polynomial are split over its ranks (parallel/ntt_sharded.py), so that
the only collectives of a step are its NTTs' all-to-alls over the
group.  Rank c of a group holds the columns [c c2, (c + 1) c2), c2 = n2
/ coeff, of each limb's (n1, n2) matrix: its block of a (..., N) tensor
is (..., n1, c2) (`shard_coeff`), which is not a contiguous range of
coefficients.  NCCL runs on the card (one rank a card, device
cuda:<local rank>), gloo on the CPU; each process initializes the
default group first (parallel/launch.py does).

The ("dp", "limb") layout (phantom_tpu/parallel/mesh.py:26 make_mesh,
:64 ct_sharding, :69 replicate, :73 shard_ciphertext_data, :77
sharded_mul_relin_rescale_step): the same grid, rank = d limb + l, but
rank l of a dp group holds the rows [l L / limb, (l + 1) L / limb) of
every (B / dp, size, L, N) ciphertext block, all N coefficients of each.
`ct_sharding` and `replicate` are the placements the JAX package names
with a PartitionSpec; `shard_ciphertext_data` cuts the rank's block by
one.  The step itself is parallel/limb_step.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .ntt_sharded import split_n


@dataclass(frozen=True)
class CoeffMesh:
    """One rank's view of the mesh: the world's size, the dp x coeff
    grid, this rank's indices along both, its coefficient subgroup (the
    group of the all-to-alls) and the device its tensors live on."""

    world: int
    dp: int
    coeff: int
    rank: int
    dp_index: int
    coeff_index: int
    group: object
    device: torch.device


def _device(backend: str, device) -> torch.device:
    if backend == "nccl":
        if device is None:
            local = int(os.environ.get("LOCAL_RANK",
                                       dist.get_rank()
                                       % max(torch.cuda.device_count(), 1)))
            device = torch.device("cuda", local)
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"the nccl backend takes CUDA devices, not "
                             f"{device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError("device cuda: no CUDA device here")
    if device.type != "cpu":
        raise ValueError(f"the {backend} backend runs on the CPU here; "
                         f"device {device} takes nccl")
    return device


def make_coeff_mesh(dp: int = 1, device=None) -> CoeffMesh:
    """The mesh of the initialized default group: `dp` batch groups of
    world / dp ranks each.  Every rank calls dist.new_group for every
    subgroup, in the same order.  device: cuda:<local rank> by default
    with NCCL; "cpu" (the default) with gloo; any other mix raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_coeff_mesh: initialize the default process "
                           "group first (parallel/launch.py)")
    world = dist.get_world_size()
    if dp < 1 or world % dp:
        raise ValueError(f"dp = {dp} does not divide the world of {world}")
    dev = _device(dist.get_backend(), device)
    coeff = world // dp
    rank = dist.get_rank()
    mine = None
    for d in range(dp):
        ranks = list(range(d * coeff, (d + 1) * coeff))
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return CoeffMesh(world=world, dp=dp, coeff=coeff, rank=rank,
                     dp_index=rank // coeff, coeff_index=rank % coeff,
                     group=mine, device=dev)


def coeff_split(n: int, mesh: CoeffMesh):
    """(n1, n2) of N = n, both divisible by the mesh's coeff."""
    n1, n2 = split_n(n)
    if n != n1 * n2 or n1 % mesh.coeff or n2 % mesh.coeff:
        raise ValueError(f"N = {n} (n1 = {n1}, n2 = {n2}): coeff = "
                         f"{mesh.coeff} must divide n1 and n2")
    return n1, n2


def shard_coeff(x: torch.Tensor, mesh: CoeffMesh) -> torch.Tensor:
    """The rank's block of a (..., N) tensor: (..., n1, n2 / coeff),
    columns [c c2, (c + 1) c2) of every row of the (n1, n2) matrix."""
    n1, n2 = coeff_split(x.shape[-1], mesh)
    c2 = n2 // mesh.coeff
    c = mesh.coeff_index
    return x.reshape(*x.shape[:-1], n1, n2)[..., c * c2:(c + 1) * c2]\
        .contiguous()


def gather_coeff(x: torch.Tensor, mesh: CoeffMesh) -> torch.Tensor:
    """The whole (..., N) tensor from each rank's (..., n1, c2) block, on
    every rank of the coefficient subgroup (all_gather)."""
    parts = [torch.empty_like(x) for _ in range(mesh.coeff)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    whole = torch.cat(parts, dim=-1)
    return whole.reshape(*x.shape[:-2], -1)


def shard_batch(x: torch.Tensor, mesh: CoeffMesh) -> torch.Tensor:
    """A (B, ..., N) batch -> this rank's (B / dp, ..., n1, c2): its dp
    group's items, its block of each."""
    b = x.shape[0]
    if b % mesh.dp:
        raise ValueError(f"a batch of {b} over dp = {mesh.dp}")
    per = b // mesh.dp
    return shard_coeff(x[mesh.dp_index * per:(mesh.dp_index + 1) * per],
                       mesh)


# ---------------------------------------------------------------------------
# the ("dp", "limb") layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LimbMesh:
    """One rank's view of the ("dp", "limb") mesh: the world's size, the
    dp x limb grid, this rank's indices along both, its limb subgroup
    (the group of the step's all-gathers and broadcast), the global ranks
    of that group, and the device its tensors live on."""

    world: int
    dp: int
    limb: int
    rank: int
    dp_index: int
    limb_index: int
    group: object
    group_ranks: Tuple[int, ...]
    device: torch.device


def _largest_pow2_leq(n: int, cap: int) -> int:
    p = 1
    while p * 2 <= min(n, cap):
        p *= 2
    return p


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              limb: Optional[int] = None, device=None) -> LimbMesh:
    """The ("dp", "limb") mesh of the initialized default group, with the
    JAX package's defaults: unless both dp and limb are given, limb =
    limb or the largest power of two <= min(n, 4) and dp = n // limb (a
    dp given alone is overridden, as there).  n_devices must be the
    world's size: a torch.distributed world cannot leave ranks out, as a
    JAX mesh over the first n devices does.  Every rank calls
    dist.new_group for every limb group, in the same order.  device:
    cuda:<local rank> by default with NCCL; "cpu" (the default) with
    gloo; any other mix raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialize the default process group "
                           "first (parallel/launch.py)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"make_mesh: n_devices = {n} against a world of {world}; a "
            "torch.distributed world cannot leave ranks out, so the mesh "
            "takes every rank")
    if dp is None or limb is None:
        limb = limb or _largest_pow2_leq(n, 4)
        dp = n // limb
    if dp < 1 or limb < 1 or dp * limb != n:
        raise ValueError(f"make_mesh: dp = {dp} x limb = {limb} is not the "
                         f"{n} devices")
    dev = _device(dist.get_backend(), device)
    rank = dist.get_rank()
    mine, mine_ranks = None, ()
    for d in range(dp):
        ranks = list(range(d * limb, (d + 1) * limb))
        g = dist.new_group(ranks)
        if rank in ranks:
            mine, mine_ranks = g, tuple(ranks)
    return LimbMesh(world=world, dp=dp, limb=limb, rank=rank,
                    dp_index=rank // limb, limb_index=rank % limb,
                    group=mine, group_ranks=mine_ranks, device=dev)


@dataclass(frozen=True)
class Placement:
    """Where each axis of a tensor goes on a LimbMesh: `spec[i]` names the
    mesh axis ("dp" or "limb") that splits axis i, None (or an axis past
    the spec) keeps it whole (the JAX package's PartitionSpec)."""

    mesh: LimbMesh
    spec: Tuple[Optional[str], ...]


def ct_sharding(mesh: LimbMesh) -> Placement:
    """The placement of a ciphertext batch (B, size, L, N): B over "dp", L
    over "limb"."""
    return Placement(mesh, ("dp", None, "limb", None))


def replicate(mesh: LimbMesh) -> Placement:
    """Every axis whole on every rank."""
    return Placement(mesh, ())


def shard(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's block of x under `placement` (contiguous); ValueError
    where an axis does not divide by its mesh axis (jax.device_put
    refuses the same split)."""
    m = placement.mesh
    index = {"dp": (m.dp, m.dp_index), "limb": (m.limb, m.limb_index)}
    for axis, name in enumerate(placement.spec):
        if name is None:
            continue
        parts, i = index[name]
        size = x.shape[axis]
        if size % parts:
            raise ValueError(f"axis {axis} of {tuple(x.shape)} ({size}) does "
                             f"not divide by {name} = {parts}")
        per = size // parts
        x = x.narrow(axis, i * per, per)
    return x.contiguous()


def shard_ciphertext_data(data: torch.Tensor, mesh: LimbMesh) -> torch.Tensor:
    """A (B, size, L, N) batch -> this rank's (B / dp, size, L / limb, N)
    block."""
    if data.dim() != 4:
        raise ValueError(f"a ciphertext batch is (B, size, L, N), not "
                         f"{tuple(data.shape)}")
    return shard(data, ct_sharding(mesh))


def sharded_mul_relin_rescale_step(ctx, ct_proto1, ct_proto2,
                                   rlk: torch.Tensor, mesh: LimbMesh,
                                   ops=None):
    """The limb-sharded batched multiply + relinearize + rescale step
    (parallel/limb_step.py) at the prototypes' level: returns step(d1,
    d2) from the rank's (B / dp, 2, L / limb, N) blocks of two NTT-form
    CKKS batches to (B / dp, 2, L - 1, N), whole on every rank of the limb
    group, bit-equal to the u64 evaluator's rescale_to_next(
    multiply_and_relin) of each item.  rlk: the relin key (dnum, 2, K, N)
    as a tensor, whole on every rank.  ops: keyswitch.KERNELS64 (U1-U4,
    the default) or PLAIN64 (their plain versions); step(d1, d2, ops)
    takes another bundle for one call.  Raises on BFV and BGV, where
    rescale_to_next does."""
    from ..schemes.keyswitch import KERNELS64
    from .limb_step import LimbStepConsts, limb_step
    if ct_proto1.chain_index != ct_proto2.chain_index:
        raise ValueError("ciphertexts are at different levels")
    if not (ct_proto1.is_ntt_form and ct_proto2.is_ntt_form):
        raise ValueError("the limb-sharded step takes NTT-form ciphertexts")
    consts = LimbStepConsts(ctx, rlk, mesh, ct_proto1.chain_index)
    default = KERNELS64 if ops is None else ops

    def step(d1: torch.Tensor, d2: torch.Tensor, ops=None) -> torch.Tensor:
        return limb_step(ctx, consts, mesh, d1, d2,
                         default if ops is None else ops)
    return step

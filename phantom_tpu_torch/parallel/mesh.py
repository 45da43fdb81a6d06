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
"""

from __future__ import annotations

import os
from dataclasses import dataclass

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

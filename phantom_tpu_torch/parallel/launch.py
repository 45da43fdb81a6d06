"""Start the ranks of a mesh and run a function on each (what
jax.distributed.initialize and the JAX tests' multihost worker do there).

    run(fn, world)          # fn(mesh, *args) on `world` cards, NCCL
    run(fn, world, "gloo")  # the same on `world` CPU ranks
    run(fn, world, layout="limb")  # on a ("dp", "limb") mesh

Each rank is a process of its own, forked from multiprocessing's server
process, which imports torch and the port once (PRELOAD) and never
touches CUDA (a process that has cannot fork): over NCCL, the default,
a rank first selects its card, `torch.cuda.set_device(rank)` (one rank
a card; fewer cards than ranks raise), over gloo it runs on the CPU.  The ranks meet through a
FileStore in a fresh temporary directory (no TCP port), build the mesh
(`make_coeff_mesh(dp, device)`; with layout="limb", `make_mesh(world,
dp, world // dp, device)`), call the module-level `fn(mesh,
*args)`, send its result back to the parent (anything picklable: numpy,
not tensors) and destroy their group.  The parent builds the kernel
library before it starts any rank, so that the ranks do not each run
the nvcc build, raises if a rank fails or runs past `timeout` seconds,
and kills the others.

    python3 -m phantom_tpu_torch.parallel.launch --world W [--dp D]
        [--layout coeff|limb]

runs (--layout coeff, the default) the four sharded steps at full
width on W cards (`full_width`): the u32 CKKS step at N = 2^16 with 43
data primes of 28 bits and 22 special of 29, the u64 CKKS and BGV steps
with 43 data primes of 50 bits and 22 of 51, the u64 BFV HPS step with
31 data primes of 50 bits,
each from chain index 1 on seeded uniform operands and relin key, a
batch of D items through the batched steps (build_sharded_step32,
build_sharded_step), one item a dp group; each rank's block bit-equal
to its block of the local step on its item, and the chained ms a step,
sharded and local on the rank's card.  --layout limb runs the
limb-sharded CKKS step instead (`limb_full_width`: LIMB_STEP, 44 data
primes of 50 bits, which divide by 2 and 4, and 22 special of 51, on the
same seeded operands and key), each rank's output, whole on every rank
of its limb group, bit-equal to the local step on its item.  It prints
one line a step and rank and exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import make_coeff_mesh, make_mesh

BACKENDS = ("gloo", "nccl")
LAYOUTS = ("coeff", "limb")
# what the ranks' server process imports once before it forks them
PRELOAD = ("torch", "phantom_tpu_torch.parallel.pipeline_sharded",
           "phantom_tpu_torch.parallel.sharded32",
           "phantom_tpu_torch.parallel.limb_step")


def _rank_main(rank, world, backend, store_path, device, dp, layout, fn,
               args, results):
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            mesh = (make_coeff_mesh(dp, device) if layout == "coeff"
                    else make_mesh(world, dp, world // dp, device))
            out = fn(mesh, *args)
            if backend == "nccl":
                torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def run(fn, world: int, backend: str = "nccl", device=None,
        timeout: float = 120.0, args=(), dp: int = 1,
        layout: str = "coeff") -> list:
    """fn(mesh, *args) on ranks 0 .. world - 1; returns their results in
    rank order.  backend: "nccl" (one card a rank: device cuda:<rank>)
    or "gloo" (the CPU); layout: "coeff" (a CoeffMesh) or "limb" (a
    LimbMesh of dp x world / dp)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    if backend == "nccl":
        if torch.cuda.device_count() < world:
            raise ValueError(f"{world} ranks over nccl need {world} cards; "
                             f"this machine has {torch.cuda.device_count()}")
        from .. import _build
        _build.build()
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ptk_store_")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, backend, os.path.join(tmp, "store"), device, dp, layout,
        fn, args, results), daemon=True) for r in range(world)]
    try:
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world)) - set(got))
                raise TimeoutError(f"ranks {late} past {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the full-width steps
# ---------------------------------------------------------------------------

# N = 2^16; data primes, special primes, their bits (the special's one
# more), BFV's t bits
STEPS = {
    "u32 CKKS": dict(scheme="ckks", limbs=43, alpha=22, bits=28),
    "u64 CKKS": dict(scheme="ckks", limbs=43, alpha=22, bits=50),
    "u64 BGV": dict(scheme="bgv", limbs=43, alpha=22, bits=50),
    "u64 BFV": dict(scheme="bfv", limbs=31, alpha=22, bits=50),
}
LOGN = 16
T_BITS = 20
SEED = 2026
# the limb-sharded step at full width: 44 data primes (U64_CFG's 43 do not
# divide by 2 or 4, and the JAX package refuses that split too)
LIMB_STEP = dict(scheme="ckks", limbs=44, alpha=22, bits=50)


def step_params(scheme: str, limbs: int, alpha: int, bits: int,
                n: int = 1 << LOGN):
    """`limbs` data primes of `bits` bits and `alpha` special primes of
    bits + 1 (utils/benchsetup.chain_primes, as the JAX bench builds
    them); t the largest T_BITS-bit prime == 1 mod 2n for BGV and BFV
    (HPS)."""
    from ..host.modulus import PlainModulus
    from ..schemes.params import EncryptionParameters
    from ..utils.benchsetup import chain_primes
    qs, ps = chain_primes(n, limbs, alpha, bits)
    if scheme == "ckks":
        return EncryptionParameters.create(n, qs, ps)
    return EncryptionParameters.create(n, qs, ps, scheme,
                                       PlainModulus.batching(n, T_BITS))


def _operands(cfg: dict, mesh, seed: int, n: int):
    """(ctx, rlk, x1, x2) on the mesh's device, from a generator seeded
    `seed` (the same on every rank): the context of `cfg`, a uniform relin
    key (dnum, 2, K, N) and two batches of mesh.dp uniform operand pairs
    (mesh.dp, 2, size_q, N), residues of the context's words."""
    from ..schemes.context import make_context
    prm = step_params(n=n, **cfg)
    dev = mesh.device
    ctx = make_context(prm, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k = prm.size_q
    dt = torch.int64 if ctx.wide else torch.int32
    q = ctx.key_q.long()

    def uniform(*lead, rows=None):
        mods = q if rows is None else q[:rows]
        x = torch.randint(0, 1 << 62, lead + (mods.numel(), n),
                          generator=gen, device=dev)
        return (x % mods.view(-1, 1)).to(dt)
    dnum = -(-k // prm.size_p)
    rlk = uniform(dnum, 2)
    return ctx, rlk, uniform(mesh.dp, 2, rows=k), uniform(mesh.dp, 2, rows=k)


def step_setup(what: str, mesh, seed: int = SEED, n: int = 1 << LOGN,
               cfg=None):
    """(ctx, step, local, d1, d2, b1, b2) of one of STEPS (or of `cfg`, a
    dict like STEPS' on the same scheme and word) on the mesh's device.
    From a seeded generator (the same on every rank): the relin key and
    a batch of mesh.dp uniform operand pairs (2, size_ql, N), an item a
    dp group; d1, d2 the rank's item, b1, b2 its (1, 2, size_ql, n1, c2)
    blocks (mesh.shard_batch).  step(b1, b2, ops) is the batched sharded
    step (build_sharded_step32 or build_sharded_step), local(d1, d2,
    ops) the local one on a whole item."""
    from ..ops import pipeline32 as pp
    from ..schemes import evaluate as ev
    from ..schemes.ciphertext import Ciphertext
    from ..schemes.keyswitch import KERNELS64
    from . import pipeline_sharded as ps
    from . import sharded32 as s32
    from .mesh import shard_batch
    cfg = STEPS[what] if cfg is None else cfg
    ctx, rlk, x1, x2 = _operands(cfg, mesh, seed, n)
    dev = mesh.device
    wide = ctx.wide
    b1, b2 = shard_batch(x1, mesh), shard_batch(x2, mesh)
    d1, d2 = x1[mesh.dp_index], x2[mesh.dp_index]
    if not wide:
        _, step = s32.build_sharded_step32(ctx, rlk, mesh)
        pipe = pp.CKKSPipeline32(ctx, pp.convert_key32(ctx, rlk), 1,
                                 modup="xla-split").to(dev)

        def local(a, b, ops=pp.KERNELS):
            return pp.mult_relin_rescale32(pipe, a, b, ops)
        return ctx, step, local, d1, d2, b1, b2
    _, step = ps.build_sharded_step(ctx, rlk, mesh)
    scheme = cfg["scheme"]

    def local(a, b, ops=KERNELS64):
        c1, c2 = (Ciphertext(x, chain_index=1, is_ntt_form=scheme != "bfv")
                  for x in (a, b))
        out = ev.multiply_and_relin(ctx, c1, c2, rlk, ops)
        if scheme == "ckks":
            out = ev.rescale_to_next(ctx, out, ops)
        elif scheme == "bgv":
            out = ev.mod_switch_to_next(ctx, out, ops)
        return out.data
    return ctx, step, local, d1, d2, b1, b2


def remix(out, q, dim: int = 1):
    """A step's output with one limb dropped along `dim` -> a whole input:
    the dropped limb is row 0 reduced mod q (the JAX bench's re-pad)."""
    row0 = out.narrow(dim, 0, 1)
    return torch.cat([out, torch.where(row0 >= q, row0 - q, row0)], dim=dim)


def _chained_ms(one, a, q_last, steps: int, dim: int) -> float:
    """ms a step of `steps` chained calls a = one(a), CUDA events, after
    one call untimed; a limb dropped along `dim` is re-padded (remix)."""
    def call(a):
        out = one(a)
        return remix(out, q_last, dim) if out.shape[dim] < a.shape[dim] \
            else out
    a = call(a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        a = call(a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _row(mesh, what, got, want, parts, **moved) -> dict:
    """A full-width row: the rank's place, whether its output `got` (a
    batch of one) equals the local step's `want`, and `moved`, the
    layout's collective counters."""
    return dict(step=what, world=mesh.world, dp=mesh.dp, parts=parts,
                rank=mesh.rank, item=mesh.dp_index, shape=tuple(got.shape),
                equal=got.shape[0] == 1 and torch.equal(got[0], want),
                cpus=len(os.sched_getaffinity(0)), **moved)


def _time_row(row, mesh, sharded, b1, local, d1, q_last, steps) -> None:
    """On the card: the ms a step of the sharded link chained, then of the
    local one on this rank's card alone (which tells a slow card or host
    from a slow exchange), each from a world barrier so that no rank's
    host set-up runs beside another's timed chain; the peak memory."""
    if mesh.device.type != "cuda":
        return
    torch.cuda.reset_peak_memory_stats(mesh.device)
    dist.barrier(device_ids=[mesh.device.index])
    row["ms"] = _chained_ms(sharded, b1, q_last, steps, 2)
    dist.barrier(device_ids=[mesh.device.index])
    row["local_ms"] = _chained_ms(local, d1, q_last, steps, 1)
    row["peak_mib"] = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 20


def full_width(mesh, steps: int = 10, seed: int = SEED) -> list:
    """Each of STEPS on this rank, its dp group's item of a batch of
    mesh.dp: its block of the batched sharded step bit-equal to its
    block of the local step on the item, the all-to-alls and the bytes
    sent; on the card the chained ms and peak memory (_time_row).
    Returns one dict a step."""
    from .mesh import shard_coeff
    from .ntt_sharded import exchange
    out = []
    for what in STEPS:
        ctx, step, local, d1, d2, b1, b2 = step_setup(what, mesh, seed)
        calls, byt = exchange.calls, exchange.bytes
        got = step(b1, b2)
        row = _row(mesh, what, got, shard_coeff(local(d1, d2), mesh),
                   ("coeff", mesh.coeff), all_to_alls=exchange.calls - calls,
                   a2a_bytes=exchange.bytes - byt)
        _time_row(row, mesh, lambda a: step(a, b2), b1,
                  lambda a: local(a, d2), d1,
                  ctx.key_q[b1.shape[2] - 1], steps)
        out.append(row)
        del ctx, step, local, d1, d2, b1, b2
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def describe(r: dict) -> str:
    """One full_width or limb_full_width row as a line."""
    axis, parts = r["parts"]
    if axis == "coeff":
        kind = "sharded"
        moved = (f"{r['all_to_alls']} all-to-alls, "
                 f"{r['a2a_bytes'] / 2**20:.1f} MiB sent a step")
    else:
        kind = "limb-sharded"
        moved = (f"{r['collectives']} collectives, received "
                 + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in
                             r["received"].items()) + " a step")
    return (f"{kind} {r['step']} step: W={r['world']} dp={r['dp']} "
            f"{axis}={parts} rank {r['rank']} (item {r['item']}, "
            f"{r['cpus']} host CPUs): block {r['shape']} "
            f"{'bit-equal' if r['equal'] else 'DIFFERS'} to the local "
            f"step's; {moved}; "
            f"{r.get('ms', float('nan')):.3f} ms a step chained, local "
            f"{r.get('local_ms', float('nan')):.3f}; peak "
            f"{r.get('peak_mib', float('nan')):.1f} MiB")


def limb_step_setup(mesh, seed: int = SEED, n: int = 1 << LOGN, cfg=None):
    """(ctx, step, local, d1, d2, b1, b2) of the limb-sharded CKKS step
    (LIMB_STEP, or `cfg`) on a LimbMesh's device, from the same seeded
    draws as step_setup: d1, d2 the rank's item of a batch of mesh.dp,
    b1, b2 its (1, 2, size_q / limb, N) blocks (shard_ciphertext_data).
    step(b1, b2, ops) is sharded_mul_relin_rescale_step's (the item's
    (1, 2, size_q - 1, N), whole on the rank), local(d1, d2, ops) the u64
    evaluator's rescale_to_next(multiply_and_relin) on the whole item."""
    from ..schemes import evaluate as ev
    from ..schemes.ciphertext import Ciphertext
    from ..schemes.keyswitch import KERNELS64
    from .mesh import shard_ciphertext_data, sharded_mul_relin_rescale_step
    cfg = LIMB_STEP if cfg is None else cfg
    if cfg["scheme"] != "ckks":
        raise ValueError("the limb-sharded step is CKKS's")
    ctx, rlk, x1, x2 = _operands(cfg, mesh, seed, n)
    b1, b2 = shard_ciphertext_data(x1, mesh), shard_ciphertext_data(x2, mesh)
    d1, d2 = x1[mesh.dp_index], x2[mesh.dp_index]
    proto = Ciphertext(d1, chain_index=1, is_ntt_form=True)
    step = sharded_mul_relin_rescale_step(ctx, proto, proto, rlk, mesh)

    def local(a, b, ops=KERNELS64):
        c1, c2 = (Ciphertext(x, chain_index=1, is_ntt_form=True)
                  for x in (a, b))
        return ev.rescale_to_next(ctx, ev.multiply_and_relin(
            ctx, c1, c2, rlk, ops), ops).data
    return ctx, step, local, d1, d2, b1, b2


def limb_chain(step, b2, q_last, mesh):
    """The limb step as a chain link on the rank's blocks: its whole
    output re-padded (remix), then the rank's rows of it again."""
    from .mesh import Placement, shard
    rows = Placement(mesh, (None, None, "limb", None))
    return lambda a: shard(remix(step(a, b2), q_last, 2), rows)


def limb_full_width(mesh, steps: int = 10, seed: int = SEED) -> list:
    """The limb-sharded step (LIMB_STEP) on this rank, its dp group's item
    of a batch of mesh.dp: its output bit-equal to the local step on the
    item, the collectives and the bytes this rank received; on the card
    the chained ms and peak memory (_time_row).  Returns one dict."""
    from .limb_step import collectives
    ctx, step, local, d1, d2, b1, b2 = limb_step_setup(mesh, seed)
    collectives.reset()
    got = step(b1, b2)
    calls, byt = dict(collectives.calls), dict(collectives.bytes)
    row = _row(mesh, "u64 CKKS limb", got, local(d1, d2),
               ("limb", mesh.limb), collectives=sum(calls.values()),
               received=byt)
    q_last = ctx.key_q[d1.shape[1] - 1]
    _time_row(row, mesh, limb_chain(step, b2, q_last, mesh), b1,
              lambda a: local(a, d2), d1, q_last, steps)
    return [row]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=torch.cuda.device_count())
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--layout", choices=LAYOUTS, default="coeff")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--timeout", type=float, default=900.0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available() or a.world < 1:
        print("launch: no CUDA device", file=sys.stderr)
        return 1
    fn = full_width if a.layout == "coeff" else limb_full_width
    rows = run(fn, a.world, timeout=a.timeout, args=(a.steps,), dp=a.dp,
               layout=a.layout)
    ok = True
    for per_rank in zip(*rows):
        for r in per_rank:
            ok &= r["equal"]
            print(describe(r))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""The ("dp", "limb") layout of phantom_tpu_torch.parallel on the CPU over
gloo: the limb-sharded multiply + relinearize + rescale step against the
JAX package's sharded_mul_relin_rescale_step (the golden file
limb_n1024.npz, made on make_mesh(8), dp 2 x limb 4, over eight CPU
devices: alpha = 4, the fused modup, and alpha = 3, three digits across
the ranks' blocks, the unfused one), bit for bit, for both dp items.

W = 1 runs in this process (a FileStore under tmp_path); W = 2 (limb 2)
and W = 4 (limb 4, then dp 2 x limb 2 on the same ranks) run through
launch.run with layout="limb", both spawns started together when the
module starts.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from _torch_parallel_ranks import limb_rank_checks
from phantom_tpu_torch import EncryptionParameters, make_context
from phantom_tpu_torch.parallel import launch, mesh as pm
from phantom_tpu_torch.parallel import limb_step as ls
from phantom_tpu_torch.schemes import evaluate as ev
from phantom_tpu_torch.schemes.ciphertext import Ciphertext
from phantom_tpu_torch.schemes.keyswitch import PLAIN64

SPAWN_TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def spawned():
    """W = 2 and W = 4 over gloo, both spawns started at once."""
    pool = ThreadPoolExecutor(2)
    futures = {w: pool.submit(launch.run, limb_rank_checks, w, "gloo",
                              timeout=SPAWN_TIMEOUT, layout="limb")
               for w in (2, 4)}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # leave the cores to the ranks' start
    yield futures
    torch.set_num_threads(threads)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("store") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    try:
        yield pm.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def golden():
    return np.load(chip_smoke.LIMB_GOLDEN)


def _check(out: dict, where: str) -> None:
    for alpha, (got, want) in out.items():
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"alpha {alpha} {where}")


def test_limb_step_w1(world1, golden):
    """At W = 1 (dp 1 x limb 1, both items on the rank) the step equals
    the JAX package's on the 8-device mesh, through the kernels' wrappers
    (their plain versions here) and through PLAIN64, and the port's local
    step on each item; it runs the layout's collectives all the same."""
    assert (world1.dp, world1.limb, world1.group_ranks) == (1, 1, (0,))
    ls.collectives.reset()
    _check(chip_smoke.limb_golden(world1), "W = 1")
    assert ls.collectives.calls == {"c2": 4, "P rows": 4, "last row": 4,
                                    "result": 4}
    _check(chip_smoke.limb_golden(world1, PLAIN64), "W = 1, PLAIN64")
    ctx, key, d1, d2, want = chip_smoke.limb_case(golden, 3, "cpu")
    for b in range(2):
        c1, c2 = (Ciphertext(d[b], chain_index=1, is_ntt_form=True)
                  for d in (d1, d2))
        local = ev.rescale_to_next(ctx, ev.multiply_and_relin(ctx, c1, c2,
                                                              key)).data
        np.testing.assert_array_equal(local.numpy().view(np.uint64), want[b])


@pytest.mark.parametrize("world", [2, 4])
def test_limb_step_spawned(spawned, world):
    """Every rank of W = 2 (limb 2) and W = 4 (limb 4; then dp 2 x limb 2)
    holds the whole output of its dp group's items, bit-equal to the JAX
    package's, for both alpha (with alpha = 3 at limb 4 the last rank owns
    no special prime)."""
    ranks = spawned[world].result()
    assert sorted(r["mesh"] for r in ranks) == [
        (1, world, 0, i) for i in range(world)]
    for r in ranks:
        _check(r["out"], f"W = {world}, rank {r['mesh']}")
    if world == 4:
        assert sorted(r["mesh2"] for r in ranks) == [
            (2, 2, d, i) for d in (0, 1) for i in (0, 1)]
        for r in ranks:
            assert all(got.shape[0] == 1 for got, _ in r["out2"].values())
            _check(r["out2"], f"dp 2 x limb 2, rank {r['mesh2']}")


def test_limb_mesh_refuses(world1, golden):
    """n_devices other than the world, L % limb, B % dp, a BGV context,
    a CUDA device over gloo; the JAX defaults (limb the largest power of
    two up to 4, a dp given alone overridden)."""
    with pytest.raises(ValueError, match="cannot leave ranks out"):
        pm.make_mesh(2)
    with pytest.raises(ValueError, match="is not the"):
        pm.make_mesh(1, dp=2, limb=1)
    with pytest.raises(ValueError, match="cuda"):
        pm.make_mesh(device="cuda")
    assert pm.make_mesh(1, dp=3).dp == 1
    assert [pm._largest_pow2_leq(n, 4) for n in (1, 2, 3, 4, 6, 8)] == [
        1, 2, 2, 4, 4, 4]
    ctx, key, d1, d2, _ = chip_smoke.limb_case(golden, 4, "cpu")
    three = pm.LimbMesh(world=3, dp=1, limb=3, rank=0, dp_index=0,
                        limb_index=0, group=None, group_ranks=(0, 1, 2),
                        device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide by limb = 3"):
        pm.shard_ciphertext_data(d1, three)
    proto = Ciphertext(d1[0], chain_index=1, is_ntt_form=True)
    with pytest.raises(ValueError, match="do not divide by limb = 3"):
        pm.sharded_mul_relin_rescale_step(ctx, proto, proto, key, three)
    dp3 = pm.LimbMesh(world=3, dp=3, limb=1, rank=0, dp_index=0,
                      limb_index=0, group=None, group_ranks=(0,),
                      device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide by dp = 3"):
        pm.shard_ciphertext_data(d1, dp3)
    assert pm.replicate(world1).spec == ()
    assert pm.ct_sharding(world1).spec == ("dp", None, "limb", None)
    p = ctx.params
    bgv = make_context(EncryptionParameters.create(
        p.n, p.data_moduli, p.special_moduli, "bgv", 12289), device="cpu")
    with pytest.raises(ValueError, match="CKKS only"):
        pm.sharded_mul_relin_rescale_step(bgv, proto, proto, key, world1)
    with pytest.raises(ValueError, match="layout"):
        launch.run(limb_rank_checks, 1, "gloo", layout="ring")


def test_limb_step_setup_w1(world1):
    """The launcher's limb step (limb_step_setup, at n = 1024 on four
    50-bit data primes and two special) equals its local step, and one
    link of its chain (limb_chain) is the next input's rows: the output
    re-padded by row 0 reduced mod q_last."""
    cfg = dict(scheme="ckks", limbs=4, alpha=2, bits=50)
    ctx, step, local, d1, d2, b1, b2 = launch.limb_step_setup(
        world1, n=1024, cfg=cfg)
    assert b1.shape == (1, 2, 4, 1024) and d1.shape == (2, 4, 1024)
    out = step(b1, b2)
    assert torch.equal(out[0], local(d1, d2))
    q_last = ctx.key_q[3]
    nxt = launch.limb_chain(step, b2, q_last, world1)(b1)
    assert torch.equal(nxt[0, :, :3], out[0])
    assert torch.equal(nxt[0, :, 3], out[0, :, 0] % q_last)
    with pytest.raises(ValueError, match="CKKS"):
        launch.limb_step_setup(world1, n=1024, cfg=dict(cfg, scheme="bgv"))

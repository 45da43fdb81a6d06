"""The coefficient-sharded NTTs and steps of phantom_tpu_torch.parallel on
the CPU over gloo, against the JAX package's sharded functions (the
golden file sharded_n1024.npz, made on a (1, 8) coeff mesh of eight CPU
devices) and against the port's local functions, bit for bit.

W = 1 runs in this process (a FileStore under tmp_path); W = 2 and W = 4
run through launch.run, one spawn each, started together when the module
starts: every rank computes its blocks of every output, the parent puts
the blocks together.  The W = 4 spawn also runs a dp = 2 x coeff = 2
mesh, each dp group its item of a batch of two.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

import p1_anatomy
from _torch_parallel_ranks import (GOLDEN, NTTS, STEPS, _ctx, _ntt_inputs,
                                   _step_inputs, _u32, local_step,
                                   rank_checks, sharded_ntts, sharded_step)
from phantom_tpu_torch.ops import ntt as ntt64
from phantom_tpu_torch.ops import ntt32
from phantom_tpu_torch.parallel import launch, mesh as pm
from phantom_tpu_torch.parallel import ntt_sharded as ns
from phantom_tpu_torch.parallel import sharded32 as s32

SPAWN_TIMEOUT = 120


def _join(blocks):
    """Rank blocks (..., n1, c2) in coefficient order -> (..., N)."""
    whole = np.concatenate(blocks, axis=-1)
    return whole.reshape(*whole.shape[:-2], -1)


def _want(g, key):
    name = key.split("_")[0]
    return g[f"{name}_out" if name in STEPS else key]


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module", autouse=True)
def spawned():
    """W = 2 and W = 4 over gloo, both spawns started at once."""
    pool = ThreadPoolExecutor(2)
    futures = {w: pool.submit(launch.run, rank_checks, w, "gloo",
                              timeout=SPAWN_TIMEOUT, args=(GOLDEN,))
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
        yield pm.make_coeff_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("key", NTTS)
def test_sharded_ntt_w1(world1, golden, key):
    """Each sharded transform at W = 1 equals the JAX package's (8
    devices) and the port's local NTT (U1's and K1/K2's plain versions)."""
    got = sharded_ntts(world1, golden)[key]
    want = golden[key]
    np.testing.assert_array_equal(
        got.numpy().view(want.dtype).reshape(want.shape), want)
    t32, x32, t64, x64 = _ntt_inputs(golden)
    local = {"ntt32_fwd": lambda: ntt32.ntt_forward32(x32, t32),
             "ntt32_inv": lambda: ntt32.ntt_inverse32(x32, t32),
             "ntt32_inv_scaled": lambda: ntt32.ntt_inverse32(
                 x32, t32, scale=_u32(golden["scale32"])),
             "ntt64_fwd": lambda: ntt64.ntt_forward_plain(x64, t64),
             "ntt64_inv": lambda: ntt64.ntt_inverse_plain(x64, t64)}[key]()
    assert torch.equal(got.reshape(local.shape), local)


@pytest.mark.parametrize("name", STEPS)
def test_sharded_step_w1(world1, golden, name):
    """The four sharded steps at W = 1 equal the JAX package's sharded
    steps and the port's local steps (pipeline32.mult_relin_rescale32;
    the u64 evaluator's multiply_and_relin with rescale_to_next,
    mod_switch_to_next, or nothing for BFV)."""
    d1, d2, rlk = _step_inputs(golden, name)
    got = sharded_step(world1, golden, name, d1, d2, rlk)
    want = golden[f"{name}_out"]
    np.testing.assert_array_equal(
        got.numpy().view(want.dtype).reshape(want.shape), want)
    local = local_step(golden, name, d1, d2, rlk)
    assert torch.equal(got.reshape(local.shape), local)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_spawned(spawned, golden, world):
    """Every transform and step over W ranks (gloo): the blocks, put
    together, equal the JAX package's outputs, and so does each rank's
    gather_coeff of the u64 forward; on four ranks the dp = 2 x
    coeff = 2 batch too (item 0 the golden step, item 1 the port's local
    step of (d1, d1))."""
    ranks = spawned[world].result()
    assert sorted(r["coeff_index"] for r in ranks) == list(range(world))
    ranks.sort(key=lambda r: r["coeff_index"])
    want = golden["ntt64_fwd"]
    for r in ranks:  # gather_coeff: every rank holds the whole transform
        np.testing.assert_array_equal(
            r["gathered"].view(want.dtype).reshape(want.shape), want)
    for key in NTTS + STEPS:
        want = _want(golden, key)
        got = _join([r["out"][key] for r in ranks])
        np.testing.assert_array_equal(got.view(want.dtype).reshape(
            want.shape), want, err_msg=f"{key} at W = {world}")
    if world == 4:
        for name in STEPS:
            d1, d2, rlk = _step_inputs(golden, name)
            items = [golden[f"{name}_out"].reshape(2, -1, d1.shape[-1]),
                     local_step(golden, name, d1, d1, rlk).numpy().view(
                         golden[f"{name}_out"].dtype)]
            for d in (0, 1):
                mine = sorted((r for r in ranks if r["dp_index"] == d),
                              key=lambda r: r["dp_coeff_index"])
                got = _join([r[f"dp_{name}"][0] for r in mine])
                np.testing.assert_array_equal(
                    got.view(items[d].dtype), items[d],
                    err_msg=f"dp item {d} of {name}")


def test_mesh_refuses(world1, golden):
    """dp not dividing the world, n1 or n2 not divisible by coeff, a CUDA
    device without CUDA or over gloo, and the TPU's "mxu" engine."""
    with pytest.raises(ValueError, match="does not divide"):
        pm.make_coeff_mesh(dp=2)
    x = torch.zeros((2, 1024), dtype=torch.int32)
    for coeff in (64, 3):
        wide = pm.CoeffMesh(world=coeff, dp=1, coeff=coeff, rank=0,
                            dp_index=0, coeff_index=0, group=None,
                            device=torch.device("cpu"))
        with pytest.raises(ValueError, match="must divide n1 and n2"):
            pm.shard_coeff(x, wide)
    with pytest.raises(ValueError, match="cuda"):
        pm.make_coeff_mesh(device="cuda")
    with pytest.raises(ValueError, match="backend"):
        launch.run(rank_checks, 1, "mpi")
    ctx = _ctx(golden, "s32")
    rlk = _step_inputs(golden, "s32")[2]
    with pytest.raises(ValueError, match="TPU"):
        s32.build_sharded32(ctx, rlk, world1, engine="mxu")


def test_ntt_phase_plain_layouts(world1, golden):
    """P1's plain version alone, phase by phase at W = 1: forward A then B
    is the local forward, inverse B then A the local inverse, and the
    wrapper takes the plain version for CPU tensors (no launch)."""
    t32, x32, _, _ = _ntt_inputs(golden)
    st = ns.prepare_sharded_tables32(t32)
    rows = torch.arange(x32.shape[0], dtype=torch.int32)
    x = x32.reshape(-1, st.n1, st.n2)
    launches = ns.ntt_phase.launches
    a = ns.ntt_phase(x, st, rows, "A", False, 1)
    assert a.shape == (1, x.shape[0], st.n2, st.n1)
    b = ns.ntt_phase(a, st, rows, "B", False, 1)
    assert torch.equal(b.reshape(x32.shape), ntt32.ntt_forward32(x32, t32))
    c = ns.ntt_phase(b, st, rows, "B", True, 1)
    d = ns.ntt_phase(c, st, rows, "A", True, 1)
    assert torch.equal(d.reshape(x32.shape), x32)
    assert ns.ntt_phase.launches == launches


def test_ntt_phase_tiles():
    """P1's tile: 32 u32 or 16 u64 columns while a call has two blocks a
    multiprocessor (the steps' 43- to 130-limb calls on 132), halved for
    the rescale's two limbs down to 32 bytes a row; never past the
    columns; and each phase's shapes at W = 2 with n1 != n2."""
    from phantom_tpu_torch.ops import ntt_phase_kernels as npk
    for limbs in (43, 44, 130):
        assert npk.tile_cols(4, limbs, 256, 132) == 32
        assert npk.tile_cols(8, limbs, 256, 132) == 16
    assert npk.tile_cols(4, 2, 256, 132) == 8
    assert npk.tile_cols(8, 2, 256, 132) == 4
    assert npk.tile_cols(4, 130, 8, 132) == 8
    assert npk.tile_cols(8, 1000, 8, 132) == 8
    t = type("T", (), dict(n1=64, n2=128))
    c1, c2 = 32, 64
    assert npk.phase_layout(t, "A", False, 3, 2) == (
        64, c2, (3, 64, c2), (2, 3, c2, c1))
    assert npk.phase_layout(t, "B", False, 3, 2) == (
        128, c1, (2, 3, c2, c1), (2, 3, c1, c2))
    assert npk.phase_layout(t, "B", True, 3, 2) == (
        128, c1, (2, 3, c1, c2), (2, 3, c2, c1))
    assert npk.phase_layout(t, "A", True, 3, 2) == (
        64, c2, (2, 3, c2, c1), (3, 64, c2))


@pytest.mark.parametrize("probe", sorted(p1_anatomy.PROBES))
def test_p1_anatomy_patches_match_source(probe):
    """Each of p1_anatomy.py's probes patches lines that csrc/ntt_phase.cu
    holds, each once, so that the probe builds what its name says."""
    from phantom_tpu_torch import _build
    with open(os.path.join(_build.CSRC, "ntt_phase.cu")) as fh:
        src = fh.read()
    for old, new in p1_anatomy.PROBES[probe]:
        assert src.count(old) == 1, old
        assert old != new

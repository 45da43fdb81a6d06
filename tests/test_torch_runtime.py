"""The port's runtime and utils on the CPU: StreamExecutor against direct
per-item calls of the CKKS step (the cases of the JAX package's
tests/test_runtime.py) and against the JAX package's step outputs in the
golden files, the range sanitizer at the step's seams (those of
tests/test_debug_sanitizer.py), and OpTimer's CSV row.  Outputs are held
bit-equal."""

import os
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from phantom_tpu_torch import EncryptionParameters, convert, make_context
from phantom_tpu_torch.ops import pipeline32 as pp
from phantom_tpu_torch.runtime import StreamExecutor, pipeline_map
from phantom_tpu_torch.schemes import keys
from phantom_tpu_torch.utils import debug
from phantom_tpu_torch.utils.timer import (OpTimer, print_timer_banner,
                                           time_op)

CPU = torch.device("cpu")
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def setup():
    """n = 128, four 28-bit data primes, two special: keys and six
    symmetric encryptions from a seeded generator."""
    ctx = make_context(chip_smoke.chain_params(128, 4, 2), device="cpu")
    sk, pipe, d1, d2, _, _ = chip_smoke.make_step_inputs(ctx, 7, 20, CPU)
    gen = torch.Generator().manual_seed(8)
    rng = np.random.default_rng(8)
    cts = [d1, d2] + [keys.encrypt_symmetric(ctx, sk, chip_smoke.encode_coeffs(
        ctx, rng.integers(-3, 4, 128), 20), gen) for _ in range(4)]
    return pipe, cts


def _direct(pipe, pairs):
    return [pp.mult_relin_rescale32(pipe, a, b) for a, b in pairs]


@pytest.mark.parametrize("batch,n_items", [(1, 3), (4, 4), (4, 10), (8, 5)])
def test_executor_matches_direct(setup, batch, n_items):
    """Full batches, several batches and partial tails give the direct
    calls' outputs, bit for bit, in order; no lane is padded."""
    pipe, cts = setup
    pairs = [(cts[i % len(cts)], cts[(i + 1) % len(cts)])
             for i in range(n_items)]
    ref = _direct(pipe, pairs)
    ex = StreamExecutor(pp.mult_relin_rescale32, pipe, batch=batch)
    outs = ex.map(pairs)
    assert len(outs) == n_items
    for o, r in zip(outs, ref):
        assert torch.equal(o, r)
    assert ex.stats.items == n_items
    assert ex.stats.batches == -(-n_items // batch)
    assert ex.stats.padded_lanes == 0
    assert ex.stats.first_batch_s > 0
    assert ex.throughput() > 0


@pytest.mark.parametrize("fname", ["step_n128_even", "step_n128_uneven",
                                   "ckks_step_n1024"])
def test_executor_matches_jax_golden(fname):
    """The golden file's d1, d2 and relin key (the JAX package's step,
    made by tests/fixtures/gen_torch_port_fixtures.py): six items in
    batches of 4 (a tail of 2) through StreamExecutor and pipeline_map,
    each bit-equal to the JAX output and to the direct call."""
    g = np.load(os.path.join(FIXTURES, f"{fname}.npz"))
    qs, ps = g["data_moduli"].tolist(), g["special_moduli"].tolist()
    ctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), qs, ps), device="cpu")
    pipe = pp.build_pipeline32(ctx, convert.residues(g["rlk"]), device=CPU)
    d1, d2 = convert.residues(g["d1"]), convert.residues(g["d2"])
    pairs = [(d1, d2)] * 6
    direct = pp.mult_relin_rescale32(pipe, d1, d2)
    np.testing.assert_array_equal(direct.numpy().view(np.uint32), g["out"])
    ex = StreamExecutor(pp.mult_relin_rescale32, pipe, batch=4)
    outs = ex.map(pairs)
    assert (ex.stats.items, ex.stats.batches) == (6, 2)
    for o in outs + pipeline_map(pp.mult_relin_rescale32, pipe, pairs,
                                 batch=4):
        np.testing.assert_array_equal(o.numpy().view(np.uint32), g["out"])
        assert torch.equal(o, direct)


def test_handle_triggers_flush(setup):
    """result() on an item waiting in a partial batch flushes it."""
    pipe, cts = setup
    ex = StreamExecutor(pp.mult_relin_rescale32, pipe, batch=4)
    h = ex.submit(cts[0], cts[1])
    assert ex.stats.batches == 0
    assert torch.equal(h.result(), _direct(pipe, [(cts[0], cts[1])])[0])
    assert ex.stats.batches == 1 and ex.stats.padded_lanes == 0


def test_pipeline_map_no_donate(setup):
    pipe, cts = setup
    pairs = [(cts[0], cts[1]), (cts[2], cts[3]), (cts[4], cts[5])]
    outs = pipeline_map(pp.mult_relin_rescale32, pipe, pairs, batch=2,
                        donate=False)
    for o, r in zip(outs, _direct(pipe, pairs)):
        assert torch.equal(o, r)


def test_batch_must_be_positive(setup):
    with pytest.raises(ValueError, match="batch"):
        StreamExecutor(pp.mult_relin_rescale32, setup[0], batch=0)


@pytest.fixture
def sanitizer():
    debug.enable()
    yield
    debug.enable(False)


def test_clean_run_passes_checks(setup, sanitizer):
    pipe, cts = setup
    ref = _direct(pipe, [(cts[0], cts[1])])[0]
    out = debug.checked_call(pp.mult_relin_rescale32, pipe, cts[0], cts[1])
    assert torch.equal(out, ref)
    assert torch.equal(pp.mult_relin_rescale32(pipe, cts[0], cts[1]), ref)


@pytest.mark.parametrize("word", ["q", "0xffffffff"])
def test_out_of_range_input_trips(setup, sanitizer, word):
    """A word of d1 at q (or 0xFFFFFFFF, the JAX test's) raises with the
    seam's label, queued under checked_call and at once outside it."""
    pipe, cts = setup
    bad = cts[0].clone()
    bad[0, 0, 0] = (int(pipe.ks.mv_ql.q[0]) if word == "q" else -1)
    with pytest.raises(debug.SanitizerError, match="d1 not canonical"):
        debug.checked_call(pp.mult_relin_rescale32, pipe, bad, cts[1])
    with pytest.raises(debug.SanitizerError, match="d2 not canonical"):
        pp.mult_relin_rescale32(pipe, cts[1], bad)
    step = debug.checked(pp.mult_relin_rescale32)
    with pytest.raises(debug.SanitizerError, match="not canonical"):
        step(pipe, bad, cts[1])


class _Ops(TorchDispatchMode):
    """Counts the aten ops dispatched (a host sync is one too:
    aten._local_scalar_dense)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_disabled_mode_adds_no_checks(setup):
    """Disabled, the seams dispatch no tensor op and no host sync: the
    step's ops are those of the route's step alone; enabled, more."""
    pipe, cts = setup
    assert not debug.enabled()
    with _Ops() as seams:
        pp.mult_relin_rescale32(pipe, cts[0], cts[1])
    with _Ops() as bare:
        pp._mult_relin_rescale(pipe, cts[0], cts[1], pp.KERNELS)
    assert seams.ops == bare.ops
    debug.enable()
    try:
        with _Ops() as checked:
            pp.mult_relin_rescale32(pipe, cts[0], cts[1])
    finally:
        debug.enable(False)
    assert len(checked.ops) > len(bare.ops)
    assert "aten._local_scalar_dense.default" in checked.ops


def test_op_timer_csv_row(capsys):
    """The reference's CSV contract: a banner, then name, trials, median
    and mean in microseconds, two decimals."""
    print_timer_banner()
    t = OpTimer("mul", trials=5, warmup=1)
    x = torch.arange(1024, dtype=torch.int64)
    out = t.run(torch.mul, x, x)
    assert torch.equal(out, x * x) and len(t.samples_us) == 5
    t.print_csv()
    med = time_op("add", torch.add, x, x, trials=3)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "function,trials,median time (us),mean time (us)"
    row = re.compile(r"^(\w+),(\d+),(\d+\.\d\d),(\d+\.\d\d)$")
    m1, m2 = row.match(lines[1]), row.match(lines[2])
    assert m1.group(1, 2) == ("mul", "5") and m2.group(1, 2) == ("add", "3")
    assert float(m1.group(3)) == round(t.median_us, 2)
    assert float(m1.group(4)) == round(t.mean_us, 2)
    assert float(m2.group(3)) == round(med, 2) and med > 0


def test_kernel_fusing_example(capsys):
    """examples/kernel_fusing.py (JAX examples/5_kernel_fusing.py) on the
    CPU at n = 1024: the fused inverse equal to the inverse then U4's
    Shoup product, both timed in OpTimer's rows."""
    import os
    import runpy
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "phantom_tpu_torch", "examples",
        "kernel_fusing.py")
    fused, separate = runpy.run_path(path)["demo"](n=1024, device="cpu",
                                                   trials=2)
    out = capsys.readouterr().out
    assert "intt_fused_scale,2," in out and "intt_then_scale,2," in out
    assert fused > 0 and separate > 0

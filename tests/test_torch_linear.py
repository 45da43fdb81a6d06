"""The port's LinearTransform against the JAX package's
phantom_tpu/schemes/linear.py, and the shared modup of its BSGS groups.

The construction (bsgs_split, groups, steps, skipped diagonals) is numpy
in both packages and is compared live; prepare's QlP weights and
apply_fast32's output are compared with the golden file
tests/fixtures/torch_port/linear_n1024.npz (n = 1024, four 28-bit
primes, one special; a d = 8 matrix whose diagonals 4 and 5 are zero;
JAX keys, encryption and Fast32 output), bit for bit with metadata.
The MLP example of the port runs here at n = 1024, d = 16."""

import os
import runpy

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu.schemes.linear import LinearTransform as JLinearTransform
from phantom_tpu.schemes.linear import bsgs_split as jbsgs_split
from phantom_tpu_torch import CKKSEncoder, LinearTransform
from phantom_tpu_torch.ops import pipeline32 as tpp
from phantom_tpu_torch.schemes.linear import bsgs_split

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def results():
    return chip_smoke.linear_golden(CPU)


@pytest.mark.parametrize("d,bs", [(1, None), (8, None), (16, None), (17, 4),
                                  (64, None), (64, 8)])
def test_bsgs_split_matches_jax(d, bs):
    assert bsgs_split(d, bs) == jbsgs_split(d, bs)


@pytest.mark.parametrize("kind", ["dense", "band", "diagonal", "sparse"])
def test_groups_and_steps_match_jax(kind):
    rng = np.random.default_rng(11)
    d = 16
    M = rng.standard_normal((d, d))
    idx = np.arange(d)
    if kind == "band":   # diagonals 0-3 and 12-15: half of them skipped
        for k in range(4, 12):
            M[idx, (idx + k) % d] = 0.0
    elif kind == "diagonal":
        M = np.diag(np.diag(M))
    elif kind == "sparse":
        M[rng.random((d, d)) < 0.3] = 0.0
    mine, ref = LinearTransform(M), JLinearTransform(M)
    assert (mine.bs, mine.gs) == (ref.bs, ref.gs)
    assert mine.steps_required() == ref.steps_required()
    assert len(mine.groups) == len(ref.groups)
    for (g1, s1, d1), (g2, s2, d2) in zip(mine.groups, ref.groups):
        assert g1 == g2 and s1 == s2
        np.testing.assert_array_equal(np.stack(d1), np.stack(d2))


def test_prepare_weights_bit_match(results):
    got, want = results["linear: pts"]
    np.testing.assert_array_equal(got, want)


def test_apply_fast32_bit_match(results):
    got, want = results["linear: y"]
    np.testing.assert_array_equal(got, want)


def test_skipped_diagonals_need_no_key():
    g = np.load(os.path.join(chip_smoke.FIXTURES, "linear_n1024.npz"))
    lt = LinearTransform(g["M"])
    assert sum(len(s) for _, s, _ in lt.groups) == 6   # 8 less 2 zero
    assert lt.steps_required() == [1, 2, 3, 6]


def test_t_up_given_no_modup(monkeypatch):
    """With t_up given, hoisted_linear_combo32 does no modup of its own and
    returns what it returns without it; apply_fast32 takes one modup for
    all its groups."""
    g, ctx, _, ev = chip_smoke.golden_case("linear_n1024.npz", "ckks", CPU)
    ct = chip_smoke.fast32_ct(ctx, g, "ct")
    ks, gal = ev.keyswitch_at(1), ev.galois_at(1)
    pts = [torch.from_numpy(p.view(np.int32)) for p in g["pts"][:3]]
    calls = []
    real = tpp.modup_from_ntt32

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tpp, "modup_from_ntt32", counted)
    own = tpp.hoisted_linear_combo32(ks, gal, ct.data, [0, 1, 2], pts)
    assert len(calls) == 1
    t_up = real(ks, ct.data[1])
    shared = tpp.hoisted_linear_combo32(ks, gal, ct.data, [0, 1, 2], pts,
                                        t_up=t_up)
    assert len(calls) == 1 and torch.equal(own, shared)
    lt = LinearTransform(g["M"])
    lt.prepare(CKKSEncoder(ctx), float(g["scale"]))
    calls.clear()
    lt.apply_fast32(ev, ct)
    assert len(calls) == 1 and len(lt.groups) == 3


def test_prepare_is_required():
    with pytest.raises(ValueError, match="prepare"):
        LinearTransform(np.eye(4))._pts_at(1)
    with pytest.raises(ValueError, match="square"):
        LinearTransform(np.ones((2, 3)))


def test_mlp_example_on_cpu():
    """phantom_tpu_torch/examples/mlp_inference.py's network at n = 1024,
    d = 16 on the CPU: two LinearTransform layers around a square
    activation, self-checked against numpy."""
    mod = runpy.run_path(os.path.join(chip_smoke.ROOT, "phantom_tpu_torch",
                                      "examples", "mlp_inference.py"))
    err = mod["mlp_demo"](n=1024, d=16, device="cpu")
    assert err < mod["TOLERANCE"]

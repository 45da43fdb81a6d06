"""BFV on the port's u64 evaluator against the JAX package's generic path,
bit for bit, on the golden files tests/fixtures/torch_port/
u64_bfv_{hps,behz,overq,leveled}_b50.npz (n = 1024, five data primes of 50
bits, two special primes of 51 bits, t = PlainModulus.batching(n, 20)):
keygen from the stored JAX draws, both encryptions, every verb, each
decryption, the noise budgets and the modules' functions (ops/scaleround,
ops/behz); chip_smoke.u64_bfv_golden replays them, on the card too.
Also: U2's scale_round form against Python integers at 63 input rows of
61-bit primes, the refusal past 63 rows, a generator round trip per
technique and examples/bfv.py.  Every kernel runs its plain version on
the CPU."""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu_torch import BatchEncoder, make_context
from phantom_tpu_torch.host import numth
from phantom_tpu_torch.host.modulus import PlainModulus
from phantom_tpu_torch.ops import bconv, scaleround
from phantom_tpu_torch.ops.rns_host import i64_tensor
from phantom_tpu_torch.schemes import evaluate, keys
from phantom_tpu_torch.schemes.params import MUL_TECHS, EncryptionParameters

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# outputs replayed: HPS every one (keys, pt1, c1, c2, 14 verbs and their
# decryptions, four budgets, the decryption's rounding whole, the modules'
# functions); the others what depends on the technique (keys but the
# Galois keys, pt1, c1, c2, 5 products and their decryptions, two budgets,
# their own functions; leveled's chained products)
HELD = {"hps": 45, "behz": 21, "overq": 18, "leveled": 27}
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Every tensor here is small (n <= 1024): one intra-op thread runs
    them faster than a pool whose threads spin between ops."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.mark.parametrize("fname", chip_smoke.U64_BFV_GOLDEN)
def test_u64_bfv_golden(fname):
    """Every output of the file bit-equal to the JAX package's: the HPS
    file replayed whole; each other technique's products replayed, and
    every output that does not depend on the technique equal to the HPS
    file's."""
    tech = fname.split("_")[2]
    shared = tech == "hps"
    assert chip_smoke.u64_bfv_golden(CPU, fname, shared=shared) == HELD[tech]
    if shared:
        return
    g = np.load(os.path.join(FIXTURES, fname))
    h = np.load(os.path.join(FIXTURES, chip_smoke.U64_BFV_GOLDEN[0]))
    own = ("multiply", "square", "relinearize", "mod_switch", "deep",
           "budget_mr")
    for name in g.files:
        if name in h.files and not any(o in name for o in own):
            np.testing.assert_array_equal(g[name], h[name], err_msg=name)


def test_scale_round_plain_against_integers():
    """round(t X / Ql) mod r_j from D = Ql u Rl at 31 + 32 = 63 rows of
    61-bit primes, X the CRT value of each column (0, 1, D - 1, D - 2, then
    uniform), against Python integers."""
    primes = numth.get_primes(1 << 11, 61, 63)
    ql, rl = primes[:31], primes[31:]
    t = PlainModulus.batching(1024, 20)
    big_ql = 1
    for q in ql:
        big_ql *= q
    c = scaleround.make_exact_scale_round(primes, t, big_ql, rl)
    rng = np.random.default_rng(63)
    big_d = big_ql
    for r in rl:
        big_d *= r
    xs = [0, 1, big_d - 1, big_d - 2] + [
        int.from_bytes(rng.bytes(500), "little") % big_d for _ in range(28)]
    x = np.array([[v % q for v in xs] for q in primes], dtype=np.uint64)
    got = scaleround.scale_and_round_exact(i64_tensor(x), c,
                                           bconv.bconv_plain)
    for j, r in enumerate(rl):
        want = [(2 * t * v + big_ql) // (2 * big_ql) % r for v in xs]
        assert got[j].numpy().view(np.uint64).tolist() == want


def _params(n, k, tech, bits=50):
    qs = numth.get_primes(2 * n, bits, k)
    ps = numth.get_primes(2 * n, bits + 1, 2)
    return EncryptionParameters.create(n, qs, ps, "bfv",
                                       PlainModulus.batching(n, 20),
                                       mul_tech=tech)


def test_refuses_past_63_rows():
    """U2's forms take at most 63 input rows, plain and kernel wrapper
    alike; a BFV context whose D = Ql u Rl passes 63 rows builds,
    encrypts and decrypts, HPS's multiply raises ValueError naming the
    bound, and BEHZ (which sums Ql's 32 rows) multiplies."""
    primes = numth.get_primes(1 << 11, 61, 65)
    c = scaleround.make_exact_scale_round(primes[:64], primes[64], 1,
                                          primes[64:])
    x = torch.zeros((64, 8), dtype=torch.int64)
    for op in (bconv.bconv, bconv.bconv_plain):
        with pytest.raises(ValueError, match="at most 63"):
            scaleround.scale_and_round_exact(x, c, op)
    n = 64
    for tech in ("hps", "behz"):
        ctx = make_context(_params(n, 32, tech), device=CPU)
        gen = torch.Generator().manual_seed(5)
        sk = keys.gen_secret_key64(ctx, gen)
        enc = BatchEncoder(ctx)
        t = ctx.params.plain_modulus
        v = np.arange(n) % t
        ct = keys.encrypt_symmetric64(ctx, sk, enc.encode(v), gen)
        assert (enc.decode(keys.decrypt64(ctx, sk, ct)) == v).all()
        if tech == "hps":
            with pytest.raises(ValueError,
                               match="at most 63.*phantom_tpu/ops/bconv.py"):
                evaluate.multiply(ctx, ct, ct)
        else:
            got = enc.decode(keys.decrypt64(ctx, sk, evaluate.square(
                ctx, ct)))
            assert (got.astype(np.int64) == v * v % t).all()


@pytest.mark.parametrize("tech", MUL_TECHS)
def test_generator_round_trip(tech):
    """Keys and encryptions drawn from a torch.Generator at n = 256: the
    product (asymmetric times symmetric encryption), relinearized,
    decrypts to the slot-wise product mod t; the leveled product of
    operands of noise_scale_deg 4 drops a level and decrypts over it."""
    n = 256
    params = _params(n, 4, tech)
    t = params.plain_modulus
    ctx = make_context(params, device=CPU)
    gen = torch.Generator().manual_seed(3)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    rlk = keys.gen_relin_key64(ctx, sk, gen)
    enc = BatchEncoder(ctx)
    x, y = np.random.default_rng(4).integers(0, t, (2, n))
    a = keys.encrypt_asymmetric64(ctx, pk, enc.encode(x), gen)
    b = keys.encrypt_symmetric64(ctx, sk, enc.encode(y), gen)
    c = evaluate.multiply_and_relin(ctx, a, b, rlk)
    got = enc.decode(keys.decrypt64(ctx, sk, c)).astype(np.int64)
    np.testing.assert_array_equal(got, x * y % t)
    assert keys.invariant_noise_budget64(ctx, sk, c) > 100
    if tech == "hps_overq_leveled":
        d = evaluate.multiply_and_relin(ctx, a.replace(noise_scale_deg=4),
                                        b, rlk)
        low = d.replace(data=d.data[:, :3].contiguous(), chain_index=2)
        got = enc.decode(keys.decrypt64(ctx, sk, low)).astype(np.int64)
        np.testing.assert_array_equal(got, x * y % t)
        assert d.noise_scale_deg == 5 and d.data.shape[1] == 4


def test_bfv_example(monkeypatch, capsys):
    """examples/bfv.py, run as a script, decrypts right on the CPU (it
    raises otherwise); one technique here, since
    test_generator_round_trip drives each."""
    monkeypatch.setattr(sys, "argv", ["bfv.py", "--device", "cpu",
                                      "--mul-tech", "behz"])
    runpy.run_path(os.path.join(ROOT, "phantom_tpu_torch", "examples",
                                "bfv.py"), run_name="__main__")
    assert "examples passed" in capsys.readouterr().out

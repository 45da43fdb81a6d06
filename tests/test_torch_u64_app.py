"""The u64 application layer of the port against the JAX package's, bit
for bit, on the golden files tests/fixtures/torch_port/u64_linear_b50.npz
(LinearTransform.apply), u64_poly_b50.npz (poly_eval, poly_eval_cheb)
and ckks_fft_wide.npz (the CKKSDeviceEncoder on primes of 2^30 and more),
all at n = 1024; chip_smoke replays the same files, on the card too.

Oracles: the linear and polynomial outputs (digests), their scales and
chain indices equal the JAX package's; the wide device encoder equals
the JAX package's eager evaluation word for word (its wide path runs op
by op, unjitted).  Also: F1's wide plain forms against Python integers
at 31- to 61-bit primes, the u64 evaluator against Fast32 on a 28-bit
chain (make_context(..., u64=True)), and the new examples as scripts.
Every kernel runs its plain version on the CPU."""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu_torch import (CKKSEncoder, EncryptionParameters, Fast32,
                               LinearTransform, chebyshev_fit, make_context,
                               poly_eval_cheb, poly_eval_cheb_fast32)
from phantom_tpu_torch.host import numth
from phantom_tpu_torch.ops import ckks_fft as cf
from phantom_tpu_torch.schemes import evaluate, keys

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Every tensor here is small (n <= 1024): one intra-op thread runs
    them faster than a pool whose threads spin between ops."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def wide_encoder():
    return chip_smoke.wide_encoder_golden(CPU)


@pytest.mark.parametrize("case", [f"{c} {ci}" for c, chain in
                                  chip_smoke.WIDE_FFT_CASES.items()
                                  for ci in chain])
@pytest.mark.parametrize("what", ["ints", "enc", "dec", "host"])
def test_wide_encoder_golden(wide_encoder, case, what):
    """The rounded coefficients, the encoded plaintext (F1's wide encode
    form and U1), the decode of the JAX package's plaintext (U1 on two
    limbs, the wide decode form) and the host decode bit-equal to the JAX
    package's: 40-bit q0 over a 30-bit q1 (q0 > q1: Garner reduces x0 mod
    q1 first), five 50-bit primes, and one limb alone."""
    got, want = wide_encoder[f"{case} {what}"]
    np.testing.assert_array_equal(got, want)


def test_u64_linear_golden():
    """The keys, the encoded input, prepare's six QlP weights, the
    encryption and LinearTransform.apply's output with its scale and
    chain index bit-equal to the JAX package's, and its decode."""
    assert chip_smoke.u64_linear_golden(CPU) == 14


def test_u64_poly_golden():
    """poly_eval of degree 7 and poly_eval_cheb of degree 13 on (-2, 2)
    bit-equal to the JAX package's, with their scales and chain
    indices."""
    assert chip_smoke.u64_poly_golden(CPU) == 6


@pytest.mark.parametrize("bits", [31, 50, 61])
def test_wide_encode_plain_against_integers(bits):
    """The wide encode form's residues are int(x) % q of its rounded
    coefficients x, at scales that take them near 2^62, of both signs."""
    n = 64
    t = cf.make_fft_tables(n, CPU)
    qs = numth.get_primes(2 * n, bits, 3)
    q = torch.tensor(qs, dtype=torch.int64)
    rng = np.random.default_rng(bits)
    for scale, z in ((2.0 ** 61, rng.uniform(-1, 1, (n // 2, 2))),
                     (2.0 ** 61 - 2.0 ** 40, np.ones((n // 2, 2))),
                     (float(qs[0]) - 1, np.full((n // 2, 2), -0.5)),
                     (2.0 ** 20, np.zeros((n // 2, 2)))):
        zt = torch.from_numpy(np.ascontiguousarray(z / np.sqrt(2)))
        c = cf.ckks_fft_plain(cf.scatter_plain(zt, scale, t), t,
                              inverse=True)
        ints = cf.round_coeffs(c[0], c[1]).tolist()
        assert max(abs(v) for v in ints) < 1 << 62
        want = [[v % p for v in ints] for p in qs]
        assert cf.ckks_fft_encode64_plain(zt, scale, q, t).tolist() == want


@pytest.mark.parametrize("bits", [(31, 31), (50, 40), (61, 61), (40, 61)])
def test_wide_garner_against_crt(bits):
    """garner_centered64 composes the centered value of two residues
    exactly (for |value| <= q0 (q1 - 1) / 2 below 2^63: the centered
    digit t_c takes |t_c| <= (q1 - 1) / 2), and one limb takes the
    centered limb 0."""
    q0 = numth.get_primes(2048, bits[0], 1)[0]
    q1 = numth.get_primes(2048, bits[1], 2)[-1]
    top = min(q0 * (q1 - 1) // 2, (1 << 63) - 1)
    rng = np.random.default_rng(bits[0] + bits[1])
    vals = [0, 1, -1, top, -top, q0, -q0, q1 - 1, -(q1 - 1)]
    vals += [int(v) * top // (1 << 62) for v in rng.integers(
        -(1 << 62), 1 << 62, 64)]
    x = torch.tensor([[v % q0 for v in vals], [v % q1 for v in vals]],
                     dtype=torch.int64)
    assert cf.garner_centered64(x, [q0, q1]).tolist() == vals
    one = [v % q0 - q0 if v % q0 > q0 // 2 else v % q0 for v in vals]
    assert cf.garner_centered64(x[:1], [q0]).tolist() == one


def test_device_encoder_refuses_past_2_62():
    """The device encoder rounds to int64: scale x |value| of 2^62 or more
    raises (the host encoder takes such constants exactly, as the
    polynomial evaluators' constants at the square of a 2^50 scale)."""
    from phantom_tpu_torch import CKKSDeviceEncoder
    n = 64
    ctx = make_context(EncryptionParameters.create(
        n, numth.get_primes(2 * n, 50, 3), numth.get_primes(2 * n, 51, 1)),
        CPU)
    enc, host = CKKSDeviceEncoder(ctx), CKKSEncoder(ctx)
    with pytest.raises(ValueError, match="2\\^62"):
        enc.encode(np.full(enc.slots, 0.5), 2.0 ** 63)
    got = host.decode(host.encode(np.full(enc.slots, 0.5), 2.0 ** 100))
    np.testing.assert_allclose(got, 0.5, atol=1e-9)


def test_u64_matches_fast32_on_28_bit_chain():
    """LinearTransform.apply + poly_eval_cheb on the u64 evaluator over a
    28-bit chain (make_context(..., u64=True)) equal apply_fast32 +
    poly_eval_cheb_fast32 on the same chain, keys and draws, word for
    word, with scale and chain index."""
    n, d = 1024, 4
    qs = numth.get_primes(2 * n, 28, 8)
    params = EncryptionParameters.create(n, qs[:7], qs[7:])
    rg = np.random.default_rng(5)
    M = rg.standard_normal((d, d)) * 0.3
    x = rg.uniform(-1, 1, d)
    cc = chebyshev_fit(np.tanh, 3, (-2.0, 2.0))
    outs = []
    for u64 in (True, False):
        ctx = make_context(params, CPU, u64=u64)
        lt = LinearTransform(M)
        enc = CKKSEncoder(ctx)
        scale = float(ctx.get_context_data(1).moduli[-1])
        lt.prepare(enc, scale)
        pt = lt.encode_input(enc, x, 2.0 ** 28)
        gen = torch.Generator().manual_seed(9)
        if u64:
            sk = keys.gen_secret_key64(ctx, gen)
            pk = keys.gen_public_key64(ctx, sk, gen)
            rlk = keys.gen_relin_key64(ctx, sk, gen)
            glk = keys.create_galois_keys64(ctx, sk, gen,
                                            steps=lt.steps_required())
            ct = keys.encrypt_asymmetric64(ctx, pk, pt, gen)
            y = poly_eval_cheb(ctx, lt.apply(ctx, ct, glk), cc, rlk, enc,
                               interval=(-2.0, 2.0))
            got = enc.decode(keys.decrypt64(ctx, sk, evaluate.rescale_to_next(
                ctx, y))).real[:d]
        else:
            ev = Fast32(ctx)
            sk = ev.gen_secret_key(gen)
            pk = ev.gen_public_key(sk, gen)
            ev = Fast32(ctx, rlk=ev.gen_relin_key(sk, gen),
                        glk=ev.create_galois_keys(sk, gen,
                                                  lt.steps_required()))
            ct = ev.encrypt_asymmetric(pk, pt, gen)
            y = poly_eval_cheb_fast32(ev, lt.apply_fast32(ev, ct), cc, enc,
                                      interval=(-2.0, 2.0))
            got = enc.decode(ev.decrypt(sk, ev.rescale_to_next(y))).real[:d]
        want = np.polynomial.chebyshev.chebval(M @ x / 2.0, cc)
        np.testing.assert_allclose(got, want, atol=1e-2)
        outs.append(y)
    y64, y32 = outs
    assert torch.equal(y64.data, y32.data.long())
    assert (y64.scale, y64.chain_index) == (y32.scale, y32.chain_index)


@pytest.mark.parametrize("name", ["encrypted_matmul", "poly_eval",
                                  "logistic_inference"])
def test_example(monkeypatch, capsys, name):
    """Each new example, run as a script with --device cpu at n = 1024,
    checks itself against numpy (it raises otherwise)."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--device", "cpu",
                                      "--n", "1024"])
    runpy.run_path(os.path.join(ROOT, "phantom_tpu_torch", "examples",
                                f"{name}.py"), run_name="__main__")
    assert "examples passed" in capsys.readouterr().out


def test_mlp_example_u64_half():
    """examples/mlp_inference.py's u64 half: the network on the u64
    evaluator and on Fast32, bit-identical, within the tolerance."""
    mod = runpy.run_path(os.path.join(ROOT, "phantom_tpu_torch", "examples",
                                      "mlp_inference.py"))
    assert mod["mlp_u64_demo"](n=1024, d=4, device="cpu") < mod["TOLERANCE"]

"""The port's u64 evaluator (schemes/evaluate.py, keyswitch.py, the u64
half of keys.py and context.py) against the JAX package's generic path,
bit for bit, on the golden files tests/fixtures/torch_port/
u64_{ckks,bgv}_b{50,60}.npz (n = 1024, five data primes of 50 or 60 bits,
two special primes of 51 or 61 bits, alpha = 2 so the last digit is
short): keygen from the stored JAX draws, both encryptions, every verb,
the decryptions and decodings, and the kernels' functions (the files
keep outputs as sha256 digests; chip_smoke.u64_golden replays them, on
the card too).  Also: the examples, a wide context's refusals (the
32-bit paths, BFV, the u64 evaluator on a 32-bit context), the host
encoder's round trip and convert.py's u64 words.  Every kernel runs its
plain version on the CPU."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu_torch import (CKKSEncoder, Fast32, convert,
                               make_context)
from phantom_tpu_torch.host import numth
from phantom_tpu_torch.host.modulus import PlainModulus
from phantom_tpu_torch.ops import pipeline32 as tpp
from phantom_tpu_torch.schemes import evaluate, keys
from phantom_tpu_torch.schemes.params import EncryptionParameters

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("fname", chip_smoke.U64_GOLDEN)
def test_u64_golden(fname):
    """Every output of the file bit-equal to the JAX package's (49 for
    CKKS, 44 for BGV)."""
    held = chip_smoke.u64_golden(CPU, fname)
    assert held == (49 if "ckks" in fname else 44)


@pytest.mark.parametrize("name", ["ckks", "bgv"])
def test_u64_examples(name):
    """examples/ckks.py and bgv.py decrypt right on the CPU (they raise
    otherwise)."""
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "phantom_tpu_torch", "examples",
                                      f"{name}.py"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "examples passed" in r.stdout


def _wide(scheme="ckks", n=64, bits=50):
    qs = numth.get_primes(2 * n, bits, 3)
    ps = numth.get_primes(2 * n, bits + 1, 1)
    t = PlainModulus.batching(n, 20) if scheme != "ckks" else 0
    return EncryptionParameters.create(n, qs, ps, scheme, t)


def test_wide_context_holds_u64_tables_only():
    """A context with a prime of 2^30 or more holds u64 tables and no
    32-bit ones; the 32-bit paths refuse it, a wide BFV context builds
    with `ntt64` over QP u Rl (u Bsk, of 61-bit primes, for "behz"), and
    the u64 evaluator refuses a 32-bit context."""
    ctx = make_context(_wide(), device=CPU)
    assert ctx.wide and ctx.ntt is None
    assert ctx.ntt64.root_powers.dtype == torch.int64
    assert ctx.key_q.dtype == torch.int64
    with pytest.raises(ValueError, match="below 2\\^30"):
        tpp.build_keyswitch32(ctx, device=CPU)
    with pytest.raises(ValueError, match="below 2\\^30"):
        Fast32(ctx)
    for tech in ("hps", "behz"):
        params = _wide("bfv")
        params = EncryptionParameters.create(
            params.n, params.data_moduli, params.special_moduli, "bfv",
            params.plain_modulus, mul_tech=tech)
        bfv = make_context(params, device=CPU)
        rows = (list(params.coeff_modulus) + list(bfv.rl_moduli)
                + list(bfv.bsk_moduli))
        assert bfv.ntt is None and bfv.ntt64.q.tolist() == rows
        assert len(bfv.rl_moduli) == params.size_q + 1
        assert len(bfv.bsk_moduli) == (params.size_q + 1) * (tech == "behz")
        assert all(b.bit_length() == 61 for b in bfv.bsk_moduli)
        assert bfv.key_mv.q.tolist() == list(params.coeff_modulus)
    narrow = make_context(EncryptionParameters.create(
        64, numth.get_primes(128, 28, 2), numth.get_primes(128, 29, 1)),
        device=CPU)
    ct = SimpleNamespace(chain_index=1, is_ntt_form=True)
    with pytest.raises(ValueError, match="2\\^30 or more"):
        evaluate.negate(narrow, ct)


@pytest.mark.parametrize("scheme", ["ckks", "bgv"])
def test_u64_generator_round_trip(scheme):
    """Keys and encryptions drawn from a torch.Generator decrypt: CKKS's
    product within 1e-3 after the rescale, BGV's exactly after the modulus
    switch; the symmetric encryption too; at 61-bit primes."""
    from phantom_tpu_torch import BatchEncoder
    params = _wide(scheme, n=256, bits=60)
    ctx = make_context(params, device=CPU)
    gen = torch.Generator().manual_seed(3)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    rlk = keys.gen_relin_key64(ctx, sk, gen)
    rg = np.random.default_rng(4)
    if scheme == "ckks":
        enc = CKKSEncoder(ctx)
        x, y = rg.standard_normal((2, enc.slots))
        a = keys.encrypt_asymmetric64(ctx, pk, enc.encode(x, 2.0 ** 40), gen)
        b = keys.encrypt_symmetric64(ctx, sk, enc.encode(y, 2.0 ** 40), gen)
        c = evaluate.rescale_to_next(
            ctx, evaluate.multiply_and_relin(ctx, a, b, rlk))
        got = enc.decode(keys.decrypt64(ctx, sk, c)).real
        np.testing.assert_allclose(got, x * y, atol=1e-3)
        return
    t = params.plain_modulus
    enc = BatchEncoder(ctx)
    x, y = rg.integers(0, t, (2, params.n))
    a = keys.encrypt_asymmetric64(ctx, pk, enc.encode(x), gen)
    b = keys.encrypt_symmetric64(ctx, sk, enc.encode(y), gen)
    c = evaluate.mod_switch_to_next(
        ctx, evaluate.multiply_and_relin(ctx, a, b, rlk))
    got = enc.decode(keys.decrypt64(ctx, sk, c)).astype(np.int64)
    np.testing.assert_array_equal(got, x * y % t)


def test_plaintext_mod_switch():
    """mod_switch_plain_to drops an NTT-form plaintext's last limbs."""
    from phantom_tpu_torch import Plaintext
    ctx = make_context(_wide(), device=CPU)
    pt = CKKSEncoder(ctx).encode([0.5], 2.0 ** 30)
    low = evaluate.mod_switch_plain_to(ctx, pt, 3)
    assert low.chain_index == 3 and torch.equal(low.data, pt.data[:1])
    with pytest.raises(ValueError, match="last level"):
        evaluate.mod_switch_plain_to_next(ctx, low)
    assert isinstance(low, Plaintext)


def test_convert_carries_u64_words():
    """convert.py carries numpy uint64 keys and ciphertexts of a wide
    context as int64 words with the same bits and metadata."""
    ctx = make_context(_wide(), device=CPU)
    a = np.array([[1 << 63, 5], [(1 << 64) - 1, 0]], dtype=np.uint64)
    assert convert.secret_key(ctx, SimpleNamespace(data=a)).numpy().view(
        np.uint64).tolist() == a.tolist()
    ct = convert.ciphertext(ctx, SimpleNamespace(
        data=a[None], chain_index=2, is_ntt_form=True, scale=2.0 ** 40,
        correction_factor=3, noise_scale_deg=1))
    assert ct.data.dtype == torch.int64 and ct.chain_index == 2
    assert ct.correction_factor == 3 and ct.scale == 2.0 ** 40

"""The port's Salsa20 sampler (phantom_tpu_torch/utils/salsa20.py, S1's
plain version on the CPU) against the JAX package's
(phantom_tpu/utils/salsa20.py), bit for bit: the ECRYPT Salsa20/20 test
vector, the keystream words, and the uniform, ternary and error samplers
against both of the JAX package's paths (numpy, use_native=False, and its
native C++ library) at 28-, 36-, 50- and 61-bit primes, the last
rejecting about one lane in nine so that retry chains of several tries
occur; then the golden file refformat_n1024.npz, which chip_smoke.py
replays through S1 on the card."""

import struct

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu.utils import salsa20 as jsalsa
from phantom_tpu_torch.host import numth
from phantom_tpu_torch.ops.rns_host import modulus_vec, u64_values
from phantom_tpu_torch.utils import salsa20

CPU = torch.device("cpu")
N = 256
SEED = bytes(range(5, 69))
BITS = (28, 36, 50, 61)


def _moduli(bits, n=N, count=3):
    if bits == 61:
        return chip_smoke.rejecting_primes(n, count)
    return numth.get_primes(2 * n, bits, count)


def test_ecrypt_vector():
    """The core against the ECRYPT Salsa20/20 vector, through a phantom
    seed whose layout coincides with the standard cipher's (as the JAX
    package's tests/test_utils.py does)."""
    sigma = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
    k = struct.unpack("<8I", bytes([0x80] + [0] * 31))
    seed_words = [sigma[0], k[0], k[1], k[2], k[3], sigma[1], 0, 0,
                  sigma[2], k[4], k[5], k[6], k[7], sigma[3]]
    seed = struct.pack("<14I", *seed_words) + bytes(8)
    block = salsa20.phantom_salsa20_block(seed, [0], CPU)[0].numpy()
    expect = bytes.fromhex(
        "E3BE8FDD8BECA2E3EA8EF9475B29A6E7"
        "003951E1097A5C38D23B7A5FAD9F6844"
        "B22C97559E2723C7CBBD3FE4FC8D9A07"
        "44652A83E72A9C461876AF4D7EF1A117")
    assert block.tobytes() == expect


def test_block_words_match_jax():
    """Keystream words at nonces across the whole u64 range (past 2^63
    too), and the byte view, equal to the JAX package's."""
    nonces = (np.arange(257, dtype=np.uint64)
              * np.uint64(0x9E3779B97F4A7C15))
    want = jsalsa.phantom_salsa20_block_words(SEED, nonces)
    got = salsa20.phantom_salsa20_block_words(SEED, nonces, CPU)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(
        salsa20.phantom_salsa20_block(SEED, nonces, CPU).numpy(),
        jsalsa.phantom_salsa20_block(SEED, nonces))


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("form", chip_smoke.SALSA_FORMS)
@pytest.mark.parametrize("bits", BITS)
def test_sampler_matches_jax(bits, form, native):
    """Each sampler bit-equal to the JAX package's numpy and native
    paths; the entry point on a CPU device is the plain version."""
    qs = _moduli(bits)
    want = getattr(jsalsa, f"sample_{form}_ref")(SEED, qs, N,
                                                 use_native=native)
    got = getattr(salsa20, f"sample_{form}_ref")(SEED, qs, N, device=CPU)
    assert got.dtype == torch.int64 and got.shape == (3, N)
    np.testing.assert_array_equal(u64_values(got), want)


def test_uniform_retry_chains():
    """At the rejecting 61-bit primes the uniform sampler's chains reach
    several tries, and still equal the JAX package's; at 50-bit primes
    no group retries at n = 1024."""
    stats = {}
    qs = _moduli(61, 1024)
    got = salsa20.sample_plain("uniform", SEED, modulus_vec(qs, CPU), 1024,
                               stats)
    assert stats["tries"] >= 4 and stats["blocks"] > 3 * 1024 // 8
    np.testing.assert_array_equal(
        u64_values(got), jsalsa.sample_uniform_ref(SEED, qs, 1024))
    stats = {}
    salsa20.sample_plain("uniform", SEED, modulus_vec(_moduli(50, 1024),
                                                      CPU), 1024, stats)
    assert stats == {"blocks": 3 * 1024 // 8, "tries": 1}


def test_bad_arguments_raise():
    mv = modulus_vec(_moduli(50), CPU)
    with pytest.raises(ValueError, match="form"):
        salsa20.sample("gauss", SEED, mv, N)
    with pytest.raises(ValueError, match="multiple of 8"):
        salsa20.sample("uniform", SEED, mv, 12)
    with pytest.raises(ValueError, match="56-byte seed"):
        salsa20.sample("ternary", SEED[:40], mv, N)


def test_golden_file():
    """refformat_n1024.npz's samples (the JAX package's, n = 1024, 28-,
    50- and 61-bit primes) through the port, bit-equal: chip_smoke
    replays the same through S1 on the card."""
    assert chip_smoke.salsa_golden(CPU) == 9

"""The port's BatchEncoder, CKKSEncoder and encode_extended against the
JAX package's, on the Fast32 golden files
(tests/fixtures/torch_port/fast32_<case>.npz, n = 1024): the encoded
plaintexts bit-equal, the decoded slots equal to the JAX decoding of the
same plaintext.  Also the signed forms, the integer budget check at a
modulus past float64's range, and the context each encoder needs.  Every
transform runs its plain version on the CPU."""

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu_torch import (BatchEncoder, CKKSEncoder, encode_extended,
                               make_context)
from phantom_tpu_torch.host import numth
from phantom_tpu_torch.host.modulus import PlainModulus
from phantom_tpu_torch.schemes.params import EncryptionParameters

CPU = torch.device("cpu")


def _case(case):
    g, ctx, _, _ = chip_smoke.fast32_case(case, CPU)
    return g, ctx


def _res(x):
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_batch_encoder_bit_match(scheme):
    g, ctx = _case(f"encrypt_{scheme}")
    enc = BatchEncoder(ctx)
    pt = enc.encode(g["vals"])
    np.testing.assert_array_equal(_res(pt.data), g["pt"])
    assert pt.chain_index == 0 and not pt.is_ntt_form
    got = enc.decode(chip_smoke.fast32_pt(ctx, g, "dec"))
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, g["decoded"])


def test_batch_encoder_bgv_chain():
    """The BGV chain's two encodings and its decoding at chain index 3."""
    g, ctx = _case("bgv_chain")
    enc = BatchEncoder(ctx)
    for v, name in (("a", "pa"), ("b", "pb")):
        np.testing.assert_array_equal(_res(enc.encode(g[v]).data), g[name])
    np.testing.assert_array_equal(
        enc.decode(chip_smoke.fast32_pt(ctx, g, "dec")), g["slots"])


def test_batch_encoder_signed():
    """encode_signed(v) is encode(v mod t); decode_signed inverts it over
    [-(t - 1)/2, (t - 1)/2]."""
    _, ctx = _case("encrypt_bgv")
    enc = BatchEncoder(ctx)
    t = ctx.params.plain_modulus
    v = np.random.default_rng(1).integers(-(t // 2), t // 2 + 1,
                                          ctx.params.n)
    v[:2] = (-(t // 2), t // 2)
    pt = enc.encode_signed(v)
    assert torch.equal(pt.data, enc.encode(v % t).data)
    np.testing.assert_array_equal(enc.decode_signed(pt), v)


@pytest.mark.parametrize("case,scale", [("encrypt_ckks", 2.0 ** 24),
                                        ("ckks_chain", 2.0 ** 28)])
def test_ckks_encoder_bit_match(case, scale):
    g, ctx = _case(case)
    enc = CKKSEncoder(ctx)
    vals = g["vals"] if "vals" in g else g["z"]
    pt = enc.encode(vals, scale)
    np.testing.assert_array_equal(_res(pt.data), g["pt"])
    assert (pt.chain_index, pt.is_ntt_form, pt.scale) == (1, True, scale)
    got = enc.decode(chip_smoke.fast32_pt(ctx, g, "dec"))
    np.testing.assert_array_equal(got, g["decoded"])


def test_encode_extended_bit_match():
    """The hoisted combination's weights over QlP."""
    g, ctx = _case("combo")
    enc = CKKSEncoder(ctx)
    scale = float(g["ct__scale"])
    for w, want in zip(g["weights"], g["pts"]):
        np.testing.assert_array_equal(
            _res(encode_extended(enc, w, scale, 1)), want)


def test_budget_check_past_float_range():
    """Sixty primes make Q and QlP wider than a float64 can hold: the
    budget check compares integers, so a fitting scale encodes and an
    oversized one raises."""
    n = 1024
    ctx = make_context(EncryptionParameters.create(
        n, numth.get_primes(2 * n, 29, 40), numth.get_primes(2 * n, 30, 20)),
        device=CPU)
    enc = CKKSEncoder(ctx)
    z = np.full(enc.slots, 0.5)
    assert enc.encode(z, 2.0 ** 40).data.shape == (40, n)
    assert encode_extended(enc, z, 2.0 ** 40).shape == (60, n)
    enc_small = CKKSEncoder(make_context(EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, 1), numth.get_primes(2 * n, 29, 1)),
        device=CPU))
    with pytest.raises(ValueError, match="too large"):
        enc_small.encode(z, 2.0 ** 40)
    with pytest.raises(ValueError, match="too large"):
        encode_extended(enc_small, z, 2.0 ** 60)


def test_encoders_need_their_scheme():
    n = 128
    qs, ps = numth.get_primes(2 * n, 28, 2), numth.get_primes(2 * n, 29, 1)
    ckks = make_context(EncryptionParameters.create(n, qs, ps), device=CPU)
    bfv = make_context(EncryptionParameters.create(
        n, qs, ps, "bfv", PlainModulus.batching(n, 16)), device=CPU)
    with pytest.raises(ValueError, match="BFV or BGV"):
        BatchEncoder(ckks)
    with pytest.raises(ValueError, match="CKKS"):
        CKKSEncoder(bfv)

"""The port's Fast32 against the JAX package's, case for case after
tests/test_fast32.py, on the golden files
tests/fixtures/torch_port/fast32_<case>.npz (n = 1024; made by
tests/fixtures/gen_torch_port_fixtures.py with the JAX package's keys,
samples and Fast32 outputs): the CKKS depth-2 chain with a rotation at
chain index 3, the BGV chain with balanced correction factors down to
chain index 3, encryption and decryption per scheme, the hoisted forms,
the plain ops and the modulus switch, square, multiply then relinearize,
the other verbs, and keygen fed the JAX samplers' draws.  Bit-exact on
residues and metadata; decoded slots as the JAX package decoded them.
Also: every level of the chain is built on first use, BFV multiplies by
the context's mul_tech (BEHZ, HPSoverQ and leveled against
bfv_multech_n1024.npz), every CKKS and BGV case also on "pallas-roll",
a BEHZ context past 30-bit primes and the engines the port lacks raise,
and Fast32.encrypt_asymmetric draws u, e0, e1 in that order.  Every kernel
runs its plain version on the CPU."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu_torch import Ciphertext, Fast32, make_context
from phantom_tpu_torch.ops import pipeline32 as tpp
from phantom_tpu_torch.ops import sampling
from phantom_tpu_torch.schemes.params import EncryptionParameters

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def golden():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = chip_smoke.fast32_golden(CPU, (case,))
        return cache[case]
    return get


def _check(golden, case, names=None):
    res = golden(case)
    names = names or [k.split(": ", 1)[1] for k in res]
    for name in names:
        got, want = res[f"{case}: {name}"]
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_ckks_depth2_chain_bit_match(golden):
    """Encode, encrypt, (square + relin + rescale) twice, a rotation at
    chain index 3, decrypt and decode; the slots within the JAX test's
    1e-2 of z^4 rolled by one."""
    _check(golden, "ckks_chain")
    g = np.load(os.path.join(chip_smoke.FIXTURES, "fast32_ckks_chain.npz"))
    got = golden("ckks_chain")["ckks_chain: decoded"][0]
    np.testing.assert_allclose(got.real, np.roll(g["z"] ** 4, -1), atol=1e-2)
    assert g["rot__meta"][0] == 3


def test_bgv_chain_bit_match(golden):
    """Two products at chain index 2 with different correction factors,
    their balanced sum, a modulus switch to chain index 3, decryption to
    2 a b in every slot."""
    _check(golden, "bgv_chain")
    g = np.load(os.path.join(chip_smoke.FIXTURES, "fast32_bgv_chain.npz"))
    t = int(g["t"])
    got = golden("bgv_chain")["bgv_chain: slots"][0]
    want = 2 * g["a"].astype(object) * g["b"].astype(object) % t
    np.testing.assert_array_equal(got.astype(object), want)
    assert g["A__meta"][2] != g["B__meta"][2] and g["s3__meta"][0] == 3


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_encrypt_decrypt_u32_bit_match(golden, scheme):
    _check(golden, f"encrypt_{scheme}")


def test_hoisted_linear_combo_u32_bit_match(golden):
    _check(golden, "combo")


@pytest.mark.parametrize("scheme", ["bfv", "bgv", "ckks"])
def test_plain_ops_and_modswitch_u32_bit_match(golden, scheme):
    names = ["add_plain", "sub_plain", "multiply_plain", "mod_switch"]
    _check(golden, f"verbs_{scheme}", names + (
        ["add_plain_ms"] if scheme == "bgv" else []))


@pytest.mark.parametrize("scheme", ["ckks", "bgv", "bfv"])
def test_square_and_relin_u32_bit_match(golden, scheme):
    _check(golden, f"verbs_{scheme}", ["square_and_relin"])


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_multiply_then_relinearize_u32_bit_match(golden, scheme):
    _check(golden, f"verbs_{scheme}", ["multiply", "relinearize"])


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_other_verbs_u32_bit_match(golden, scheme):
    """add, sub, negate, multiply + relin, rotate (BFV in coefficient
    form), decrypt; CKKS's rescale."""
    _check(golden, f"verbs_{scheme}", [
        "add", "sub", "negate", "multiply_and_relin", "rotate", "dec"] + (
        ["rescale"] if scheme == "ckks" else []))


@pytest.mark.parametrize("scheme", ["ckks", "bgv"])
def test_keygen_u32_bit_match(golden, scheme):
    """The cores fed the JAX samplers' draws give the JAX keys: secret,
    public, relin, and Galois keys for steps 1 and 2."""
    _check(golden, f"keygen_{scheme}")


@pytest.mark.parametrize("case", ["verbs_ckks", "verbs_bgv", "ckks_chain",
                                  "bgv_chain", "combo", "encrypt_ckks",
                                  "encrypt_bgv"])
def test_roll_engine_ckks_bgv_bit_match(case):
    """Fast32 on "pallas-roll" (K6 for every transform, the xla-split
    modup, the CKKS tensor terms after the moddown pair) gives every output
    of the CKKS and BGV golden files; the generator's `fast32_roll` holds
    the JAX package's Fast32 on "pallas-roll" to the verbs files."""
    res = chip_smoke.fast32_golden(CPU, (case,), engine="pallas-roll")
    for key, (got, want) in res.items():
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_bfv_roll_engine_bit_match():
    """Fast32 on "pallas-roll" (K6 for every transform) gives the golden
    BFV multiply + relin, rotation and plain product."""
    g, ctx, _, ev = chip_smoke.fast32_case("verbs_bfv", CPU, "pallas-roll")
    c, c2 = (chip_smoke.fast32_ct(ctx, g, n) for n in ("c", "c2"))
    pt2 = chip_smoke.fast32_pt(ctx, g, "pt2")
    for name, x in (("multiply_and_relin", ev.multiply_and_relin(c, c2)),
                    ("rotate", ev.rotate(c, 1)),
                    ("multiply_plain", ev.multiply_plain(c, pt2))):
        np.testing.assert_array_equal(x.data.numpy().view(np.uint32),
                                      g[name], err_msg=name)


def test_encrypt_asymmetric_draws(monkeypatch):
    """Fast32.encrypt_asymmetric draws u, then e0, then e1 from its
    generator: replaying the JAX draws through the samplers gives the JAX
    ciphertext."""
    g, ctx, k, ev = chip_smoke.fast32_case("encrypt_bgv", CPU)
    draws = [torch.from_numpy(g["enc_u"])] + [torch.from_numpy(e)
                                             for e in g["enc_e"]]
    monkeypatch.setattr(sampling, "sample_ternary_vec",
                        lambda gen, n: draws.pop(0))
    monkeypatch.setattr(sampling, "sample_error_cbd",
                        lambda gen, n: draws.pop(0))
    c = ev.encrypt_asymmetric(k["pk"], chip_smoke.fast32_pt(ctx, g, "pt"),
                              torch.Generator())
    assert not draws
    np.testing.assert_array_equal(c.data.numpy().view(np.uint32), g["ct"])


def _params(scheme, k=6, n=1024, **kw):
    from phantom_tpu_torch.host import numth
    from phantom_tpu_torch.host.modulus import PlainModulus
    return EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, k), numth.get_primes(2 * n, 29, 1),
        scheme, PlainModulus.batching(n, 16) if scheme != "ckks" else 0,
        **kw)


def test_every_level_built_on_first_use():
    """Chain indices 0 to size_q exist; each level's constants are built
    when first read and then cached; indices outside raise."""
    ctx = make_context(_params("bgv"), device=CPU)
    assert len(ctx.chain) == 7 and ctx.data_level_count() == 6
    cd = ctx.get_context_data(5)
    assert "ks" not in cd.__dict__
    assert cd.size_ql == 2 and cd.ks is cd.ks and "ks" in cd.__dict__
    assert ctx.get_context_data(6).bgv.qlast_mod_qi is None
    assert ctx.get_context_data(0).ks is None
    with pytest.raises(ValueError, match="outside the chain"):
        ctx.get_context_data(7)


@pytest.mark.parametrize("tech,case", [("behz", "behz"),
                                       ("hps_overq", "overq"),
                                       ("hps_overq_leveled", "lev0")])
def test_bfv_techniques_dispatch(tech, case):
    """Fast32 multiplies by the context's mul_tech: multiply and
    multiply_and_relin bit-equal to the JAX package's outputs in
    bfv_multech_n1024.npz (leveled at the noise model's drop for
    noise_scale_deg 1, none there), and noise_scale_deg as the JAX
    package's Fast32 sets it (+1 for leveled)."""
    g = np.load(chip_smoke.BFV_MULTECH_GOLDEN)
    ctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), "bfv", int(g["t"]), mul_tech=tech),
        device=CPU)
    ev = Fast32(ctx, rlk=torch.from_numpy(g["rlk"].astype(np.int32)))
    c1 = Ciphertext(torch.from_numpy(g["d1"].astype(np.int32)))
    c2 = Ciphertext(torch.from_numpy(g["d2"].astype(np.int32)),
                    noise_scale_deg=2)
    nsd = 2 + (tech == "hps_overq_leveled")
    for verb, name in ((ev.multiply, "mul"),
                       (ev.multiply_and_relin, "relin")):
        out = verb(c1, c2)
        np.testing.assert_array_equal(out.data.numpy().astype(np.uint32),
                                      g[f"{name}_{case}"])
        assert out.noise_scale_deg == nsd and out.chain_index == 1


def test_bfv_behz_refuses_primes_past_30_bits():
    """A Fast32 on a BEHZ context whose QP has a prime of 2^30 or more
    raises: the context is the u64 evaluator's, with the JAX package's
    61-bit Bsk, which has no 32-bit counterpart, and nothing falls back
    to HPS."""
    from phantom_tpu_torch.host import numth
    from phantom_tpu_torch.host.modulus import PlainModulus
    n = 1024
    params = EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, 3), numth.get_primes(2 * n, 31, 1),
        "bfv", PlainModulus.batching(n, 16), mul_tech="behz")
    ctx = make_context(params, device=CPU)
    assert ctx.wide and {b.bit_length() for b in ctx.bsk_moduli} == {61}
    with pytest.raises(ValueError, match="below 2\\^30"):
        Fast32(ctx)


def test_engines_the_port_lacks_raise():
    ctx = make_context(_params("ckks", k=3), device=CPU)
    for engine in (False, "xla", "mxu"):
        with pytest.raises(ValueError, match="no counterpart"):
            Fast32(ctx, engine=engine)
    with pytest.raises(ValueError, match="xla-split"):
        Fast32(ctx, engine=tpp.ROLL_ENGINE, modup="kernel").keyswitch_at(1)

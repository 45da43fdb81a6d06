"""The port's CKKS mult+relin+rescale step against the JAX package:
its tables against build_pipeline32's, the "xla" route's delta against
JAX modup_delta_xla32, its output on each modup route ("kernel", "xla"
through K4's preconv form, "xla-split") and through each epilogue against
JAX mult_relin_rescale32 on the xla-split structure (golden files at n = 128 and n = 1024, made by
tests/fixtures/gen_torch_port_fixtures.py with the Pallas kernels in
interpret mode; the JAX package's composed and merged epilogues are
bit-identical, tests/test_pipeline32.py), a real JAX key carried over by
convert.py against the u64 evaluator, and its own keys and encryptions
decrypting to the exact product.  Bit-exact throughout."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu.ops import pipeline32 as jpp
from phantom_tpu.schemes import EncryptionParameters as JaxParams
from phantom_tpu.schemes import Scheme, keys as jkeys
from phantom_tpu.schemes import make_context as jax_context
from phantom_tpu_torch import convert, make_context
from phantom_tpu_torch.ops import pipeline32 as tpp
from phantom_tpu_torch.schemes import keys as tkeys
from phantom_tpu_torch.schemes.params import EncryptionParameters

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
GOLDEN = os.path.join(FIXTURES, "ckks_step_n1024.npz")
CPU = "cpu"


def u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module", params=["even", "uneven"])
def step(request):
    """The golden file's random relin key, d1, d2 and JAX output (k = 4
    and 5 data primes, alpha = 2, n = 128), with the JAX and port
    pipelines built on that key and the port's context."""
    g = np.load(os.path.join(FIXTURES, f"step_n128_{request.param}.npz"))
    qs, ps = g["data_moduli"].tolist(), g["special_moduli"].tolist()
    n = g["d1"].shape[-1]
    jctx = jax_context(JaxParams.create(Scheme.CKKS, n, qs + ps,
                                        special_modulus_size=len(ps)))
    jp = jpp.build_pipeline32(jctx, jkeys.RelinKey(data=jnp.asarray(
        g["rlk"].astype(np.uint64))), use_pallas="mxu-pallas")
    tctx = make_context(EncryptionParameters.create(n, qs, ps), device=CPU)
    tp = tpp.build_pipeline32(tctx, convert.residues(g["rlk"]), device=CPU)
    return jp, tp, g, tctx


EPILOGUES = {"K8_R2": dict(moddown_rows=2), "K8_R8": dict(moddown_rows=8),
             "K7": dict(merged_epilogue=True)}


def test_tables_match_build_pipeline32(step):
    jp, tp, *_ = step
    jks, tks = jp.ks, tp.ks
    pairs = [(jks.pinv, tks.pinv), (jks.pinv_shoup, tks.pinv_shoup),
             (jks.modup_scale, tks.modup_scale),
             (jks.modup_scale_shoup, tks.modup_scale_shoup),
             (jks.moddown_scale, tks.moddown_scale),
             (jks.moddown_scale_shoup, tks.moddown_scale_shoup),
             (jks.t_qlp_compl.q, tks.ntt.q[tks.rows_compl.long()]),
             (jks.t_qlp.q, tks.mv_qlp.q),
             (jks.t_ql.q, tks.ntt.q[tks.rows_ql.long()]),
             (jks.t_p.q, tks.ntt.q[tks.rows_p.long()]),
             (jp.qlast_inv, tp.qlast_inv),
             (jp.qlast_inv_shoup, tp.qlast_inv_shoup),
             (jp.half_mod_q, tp.half_mod_q),
             (jp.evk.reshape(tp.evk.shape), tp.evk)]
    for jc, tc in [(jks.p_to_q, tks.p_to_q)] + list(
            zip(jks.digit_convs, tks.digit_convs)):
        pairs += [(getattr(jc, f), getattr(tc, f)) for f in (
            "qhat_inv", "qhat_inv_shoup", "qhat_mod_p", "q_mod_p", "U", "V")]
        pairs += [(getattr(jc, b).q, getattr(tc, b).q)
                  for b in ("ibase", "obase")]
    pairs += [(jks.mv_ql.q, tks.mv_ql.q), (jks.mv_qlp.q, tks.mv_qlp.q)]
    for i, (j, t) in enumerate(pairs):
        np.testing.assert_array_equal(u32(t), np.asarray(j), f"pair {i}")
    assert tks.compl_sizes == jks.compl_sizes
    assert int(jp.half) == tp.half


def test_step_matches_jax(step):
    """Both of the port's routes (alpha = 2: the K4 route by default, the
    xla-split route through its own function) equal the JAX xla-split
    output."""
    _, tp, g, _ = step
    d1, d2 = convert.residues(g["d1"]), convert.residues(g["d2"])
    assert tp.ks.fused_modup
    np.testing.assert_array_equal(u32(tp(d1, d2)), g["out"])
    np.testing.assert_array_equal(
        u32(tpp._mult_relin_rescale_split(tp, d1, d2)), g["out"])


@pytest.mark.parametrize("modup", ["xla", "kernel"])
def test_step_modup_routes_match_jax(step, modup):
    """The step built on the "xla" route (K4's preconv form) and on the
    "kernel" route equals the JAX xla-split output."""
    _, tp, g, ctx = step
    p = tpp.CKKSPipeline32(ctx, tp.evk, modup=modup)
    assert p.ks.modup == modup and p.ks.fused_modup == (modup == "kernel")
    d1, d2 = convert.residues(g["d1"]), convert.residues(g["d2"])
    np.testing.assert_array_equal(u32(p(d1, d2)), g["out"])


def test_modup_delta_matches_jax(step):
    """modup_delta_xla32: the per-digit conversion with zeros at each
    digit's own rows, as the JAX function lays it out."""
    jp, tp, g, _ = step
    ks = tp.ks
    q = u32(ks.mv_ql.q).astype(np.uint64)[:, None]
    rng = np.random.default_rng(3)
    y = (rng.integers(0, 1 << 62, (ks.size_ql, g["d1"].shape[-1]),
                      dtype=np.uint64) % q).astype(np.uint32)
    want = np.asarray(jpp.modup_delta_xla32(jp.ks, jnp.asarray(y)))
    got = tpp.modup_delta_xla32(ks, convert.residues(y))
    np.testing.assert_array_equal(u32(got), want)


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_step_epilogues_match_jax(step, epilogue):
    """The step through K8 (R = 2 and 8: a masked tail row at k = 5, k <
    R) and through K7, on both routes, equals the JAX output."""
    _, tp, g, ctx = step
    p = tpp.CKKSPipeline32(ctx, tp.evk, **EPILOGUES[epilogue])
    d1, d2 = convert.residues(g["d1"]), convert.residues(g["d2"])
    np.testing.assert_array_equal(u32(p(d1, d2)), g["out"])
    np.testing.assert_array_equal(
        u32(tpp._mult_relin_rescale_split(p, d1, d2)), g["out"])


def test_epilogue_options_exclude_each_other(step):
    _, tp, _, ctx = step
    with pytest.raises(ValueError, match="choose one"):
        tpp.CKKSPipeline32(ctx, tp.evk, moddown_rows=2, merged_epilogue=True)
    with pytest.raises(ValueError, match="outside"):
        tpp.CKKSPipeline32(ctx, tp.evk, moddown_rows=9)
    with pytest.raises(ValueError, match="modup"):
        tpp.CKKSPipeline32(ctx, tp.evk, modup="mega")


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    ctx = make_context(EncryptionParameters.create(
        g["d1"].shape[-1], g["data_moduli"].tolist(),
        g["special_moduli"].tolist()), device=CPU)
    return g, ctx


def test_golden(golden):
    g, ctx = golden
    p = tpp.CKKSPipeline32(ctx, convert.residues(g["evk"]))
    got = p(convert.residues(g["d1"]), convert.residues(g["d2"]))
    np.testing.assert_array_equal(u32(got), g["out"])


@pytest.mark.parametrize("epilogue", ["pair", "K7"])
@pytest.mark.parametrize("modup", ["xla", "kernel"])
def test_golden_modup_routes(golden, modup, epilogue):
    """The n = 1024 golden step (a short last digit) on the "xla" and
    "kernel" routes, through the pair and K7."""
    g, ctx = golden
    p = tpp.CKKSPipeline32(ctx, convert.residues(g["evk"]), modup=modup,
                           **EPILOGUES.get(epilogue, {}))
    got = p(convert.residues(g["d1"]), convert.residues(g["d2"]))
    np.testing.assert_array_equal(u32(got), g["out"])


@pytest.mark.parametrize("epilogue", ["K8_R8", "K7"])
def test_golden_epilogues(golden, epilogue):
    g, ctx = golden
    p = tpp.CKKSPipeline32(ctx, convert.residues(g["evk"]),
                           **EPILOGUES[epilogue])
    got = p(convert.residues(g["d1"]), convert.residues(g["d2"]))
    np.testing.assert_array_equal(u32(got), g["out"])


def test_jax_key_via_convert_matches_u64_evaluator(golden):
    """The golden file's raw JAX relin key, secret key and ciphertexts go
    through convert.py; the step equals the u64 evaluator's output (which
    the generator asserted) and decrypts as the JAX package decrypts it."""
    g, ctx = golden
    p = tpp.CKKSPipeline32(ctx, convert.relin_evk(ctx, g["rlk"]))
    out = p(convert.residues(g["d1"]), convert.residues(g["d2"]))
    np.testing.assert_array_equal(u32(out), g["out"])
    pt = tkeys.decrypt(ctx, convert.residues(g["sk"]), out)
    np.testing.assert_array_equal(u32(pt), g["pt_out"])


def test_keygen_encrypt_step_decrypt():
    """The port's own keys and encryptions at n = 1024 (the chip smoke's
    flow on the CPU): the step decrypts to the exact m1 m2."""
    ctx = make_context(chip_smoke.chain_params(1024, 5, 2), device=CPU)
    sk, pipe, d1, d2, m1, m2 = chip_smoke.make_step_inputs(
        ctx, 11, chip_smoke.DELTA_BITS, torch.device(CPU))
    out = pipe(d1, d2)
    dist = chip_smoke.check_decrypt(ctx, sk, out, m1, m2,
                                    chip_smoke.DELTA_BITS)
    assert dist < 0.25
    q_pad = ctx.key_q[4:5].view(1, 1, 1)
    again = chip_smoke.remix(out, q_pad)
    assert again.shape == d1.shape and torch.equal(again[:, :4], out)

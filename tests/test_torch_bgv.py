"""The port's BGV multiply + relinearize + modulus-switch step against the
JAX package: its context and key-switch tables against the JAX package's
(make_context, build_keyswitch32(for_bgv=True), build_bgv32), the
t-corrected moddown delta against the JAX _moddown_delta32, the step on
every modup route against the golden file at n = 1024 (five data primes,
alpha = 2, a short last digit; made by
tests/fixtures/gen_torch_port_fixtures.py with the JAX package's keys,
asymmetric encryptions and step), the golden ciphertexts decrypted with
the tracked correction factor, and the port's own keys and encryptions
decrypting to m1 m2 mod (X^n + 1, t).  Bit-exact throughout; every kernel
runs its plain version on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_tpu.ops import bgv32 as jbgv
from phantom_tpu.ops import pipeline32 as jpp
from phantom_tpu.schemes import EncryptionParameters as JaxParams
from phantom_tpu.schemes import Scheme
from phantom_tpu.schemes import make_context as jax_context
from phantom_tpu_torch import convert, make_context
from phantom_tpu_torch.ops import bgv32 as tbgv
from phantom_tpu_torch.ops import pipeline32 as tpp
from phantom_tpu_torch.schemes import keys as tkeys
from phantom_tpu_torch.schemes.params import EncryptionParameters

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port",
                      "bgv_step_n1024.npz")
CPU = "cpu"


def u32(t):
    return t.numpy().view(np.uint32)


def negacyclic_mod_t(m1, m2, t):
    n = m1.shape[0]
    full = np.concatenate([np.convolve(m1, m2), [0]])
    return (full[:n] - full[n:]) % t


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    ctx = make_context(EncryptionParameters.create(
        g["d1"].shape[-1], g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), "bgv", int(g["t"])), device=CPU)
    return g, ctx


@pytest.fixture(scope="module")
def jax_state(golden):
    g, _ = golden
    qs, ps = g["data_moduli"].tolist(), g["special_moduli"].tolist()
    jctx = jax_context(JaxParams.create(
        Scheme.BGV, g["d1"].shape[-1], qs + ps, plain_modulus=int(g["t"]),
        special_modulus_size=len(ps)))
    return jctx, jpp.build_keyswitch32(jctx, 1, for_bgv=True)


def test_tables_match_jax(golden, jax_state):
    """The BGV key switch's t-correction tables, the modulus switch's
    constants, each level's decryption constants and t mod q."""
    g, ctx = golden
    jctx, jks = jax_state
    jp = jbgv.build_bgv32(jctx, None)
    tp = tbgv.build_bgv32(ctx, convert.residues(g["rlk"]), device=CPU)
    tks = tp.ks
    assert tks.bgv and tks.t == int(g["t"])
    pairs = [(jks.phalf_mod_p, tks.phalf_mod_p),
             (jks.phalf_mod_q, tks.phalf_mod_q),
             (jks.bigp_mod_q, tks.bigp_mod_q),
             (jks.t_mv.q, tks.p_to_t.obase.q),
             (jp.qlast_inv, tp.qlast_inv),
             (jp.qlast_inv_shoup, tp.qlast_inv_shoup),
             (jp.qlast_mod_qi, tp.qlast_mod_qi),
             (np.asarray(jctx.t_mod_q), ctx.t_mod_q[:len(g["data_moduli"])])]
    pairs += [(getattr(jks.p_to_t, f), getattr(tks.p_to_t, f)) for f in (
        "qhat_inv", "qhat_inv_shoup", "qhat_mod_p", "q_mod_p", "U", "V")]
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_array_equal(u32(got), np.asarray(want), f"pair {i}")
    assert int(jks.phalf_mod_t) == tks.phalf_mod_t
    assert int(jks.neg_pinv_mod_t) == tks.neg_pinv_mod_t
    assert int(jp.neg_qlast_inv_mod_t) == tp.neg_qlast_inv_mod_t
    for ci in (1, 2):
        jb, tb = jctx.get_context_data(ci).bgv, ctx.get_context_data(ci).bgv
        assert np.asarray(jb.qhalf_mod_q).tolist() == tb.qhalf_mod_q
        assert int(jb.qhalf_mod_t) == tb.qhalf_mod_t
        assert np.asarray(jb.q_to_t.qhat_mod_p).tolist() == \
            tb.q_to_t.qhat_mod_p


def test_moddown_delta_matches_jax(golden, jax_state):
    """BGV's t-corrected delta over Ql (delta == x mod P, == 0 mod t) from
    uniform P rows, with the P - 1 and 0 edges."""
    g, ctx = golden
    _, jks = jax_state
    ks = tpp.build_keyswitch32(ctx, device=CPU)
    p = np.array(g["special_moduli"], dtype=np.uint64)[:, None]
    rng = np.random.default_rng(9)
    x = (rng.integers(0, 1 << 62, (len(p), ctx.params.n), dtype=np.uint64)
         % p).astype(np.uint32)
    x[:, 0] = 0
    x[:, 1] = (p[:, 0] - 1).astype(np.uint32)
    want = np.asarray(jpp._moddown_delta32(jks, jnp.asarray(x)))
    got = tpp._moddown_delta32(ks, convert.residues(x), tpp.KERNELS)
    np.testing.assert_array_equal(u32(got), want)


@pytest.mark.parametrize("modup", tpp.MODUP_ROUTES)
def test_golden(golden, modup):
    """The JAX relin key through convert.bgv_pipeline and the step on each
    modup route ("auto" is "kernel" at alpha = 2; "xla" is "xla-split" for
    BGV), bit-equal to the JAX package's output."""
    g, ctx = golden
    p = convert.bgv_pipeline(ctx, g["rlk"], modup=modup)
    assert p.ks.modup == {"auto": "kernel"}.get(modup, modup)
    out = p(convert.residues(g["d1"]), convert.residues(g["d2"]))
    np.testing.assert_array_equal(u32(out), g["out"])


def test_golden_decrypt(golden):
    """The JAX ciphertexts decrypt to their encoded plaintexts, and the
    step's output, with the tracked factor f1 f2 q_last^-1 mod t, to the
    JAX decryption, which is pt1 pt2 mod (X^n + 1, t)."""
    g, ctx = golden
    t = int(g["t"])
    sk = convert.residues(g["sk"])
    for d, pt in (("d1", "pt1"), ("d2", "pt2")):
        np.testing.assert_array_equal(
            tkeys.decrypt(ctx, sk, convert.residues(g[d])).numpy(), g[pt])
    cf = pow(int(g["data_moduli"][-1]) % t, -1, t)
    assert cf == int(g["cf"])
    got = tkeys.decrypt(ctx, sk, convert.residues(g["out"]), cf).numpy()
    np.testing.assert_array_equal(got, g["pt_out"].astype(np.int64))
    np.testing.assert_array_equal(got, negacyclic_mod_t(g["pt1"], g["pt2"],
                                                        t))


def test_own_keys_encrypt_step_decrypt(golden):
    """Keys and encryptions from a seeded torch.Generator at the golden
    file's parameters: each ciphertext decrypts to its message, the routes
    agree, and the step's output decrypts (factor q_last^-1 mod t) to
    m1 m2 mod (X^n + 1, t)."""
    _, ctx = golden
    n, t = ctx.params.n, ctx.params.plain_modulus
    gen = torch.Generator()
    gen.manual_seed(6)
    sk = tkeys.gen_secret_key(ctx, gen)
    rlk = tkeys.gen_relin_key(ctx, sk, gen)
    rng = np.random.default_rng(6)
    m1, m2 = (rng.integers(-3, 4, n) for _ in range(2))
    d1, d2 = (tkeys.encrypt_symmetric(ctx, sk, torch.from_numpy(m), gen)
              for m in (m1, m2))
    np.testing.assert_array_equal(tkeys.decrypt(ctx, sk, d1).numpy(), m1 % t)
    outs = [tbgv.build_bgv32(ctx, rlk, device=CPU, modup=r)(d1, d2)
            for r in ("kernel", "xla-split")]
    assert torch.equal(outs[0], outs[1])
    cf = pow(ctx.params.data_moduli[-1] % t, -1, t)
    np.testing.assert_array_equal(tkeys.decrypt(ctx, sk, outs[0], cf).numpy(),
                                  negacyclic_mod_t(m1, m2, t))


def test_bgv_step_refuses_other_contexts(golden):
    g, ctx = golden
    rlk = convert.residues(g["rlk"])
    with pytest.raises(ValueError, match="engine"):
        tbgv.build_bgv32(ctx, rlk, device=CPU, engine="pallas-roll")
    with pytest.raises(ValueError, match="modup"):
        tbgv.build_bgv32(ctx, rlk, device=CPU, modup="mega")
    ks = tpp.build_keyswitch32(ctx, device=CPU)
    x = torch.zeros((ctx.params.size_qp, ctx.params.n), dtype=torch.int32)
    with pytest.raises(ValueError, match="tensor_add"):
        tpp.moddown32_pair(ks, x, x, tensor_add=(x, x))
    ckks = make_context(EncryptionParameters.create(
        ctx.params.n, ctx.params.data_moduli, ctx.params.special_moduli),
        device=CPU)
    with pytest.raises(ValueError, match="BGV context"):
        tbgv.build_bgv32(ckks, rlk, device=CPU)

"""The port's BFV HPS multiply + relinearize step against the JAX package:
its tables against bfv32.build_bfv32's, scale_and_round_exact32 against
the JAX function, the step on both port engines against the JAX
bfv_mult_relin32 at n = 128 (four data primes, alpha = 2, as
tests/test_fastpath32.py; the JAX side's outputs in the golden file
bfv_live_n128.npz, made with jax.jit) and against the golden file at n =
1024 (five data primes, a short last digit; made by
tests/fixtures/gen_torch_port_fixtures.py, with the JAX package's key
switch and decryption), and the port's own keys and encryptions
decrypting to m1 m2 mod (X^n + 1, t).  Bit-exact throughout; every kernel
runs its plain version on the CPU."""

import os

import numpy as np
import pytest
import torch

from phantom_tpu.host import numth as jnumth
from phantom_tpu.host.modulus import PlainModulus as JaxPlainModulus
from phantom_tpu_torch import convert, make_context
from phantom_tpu_torch.host import numth
from phantom_tpu_torch.host.modulus import PlainModulus
from phantom_tpu_torch.ops import bfv32 as tbfv
from phantom_tpu_torch.ops import pipeline32 as tpp
from phantom_tpu_torch.ops import scaleround32 as tsr
from phantom_tpu_torch.schemes import keys as tkeys
from phantom_tpu_torch.schemes.params import EncryptionParameters

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
GOLDEN = os.path.join(FIXTURES, "bfv_step_n1024.npz")
LIVE = os.path.join(FIXTURES, "bfv_live_n128.npz")
ENGINES = ["mxu-pallas", "pallas-roll"]
CPU = "cpu"
N = 128


def u32(t):
    return t.numpy().view(np.uint32)


def negacyclic_mod_t(m1, m2, t):
    n = m1.shape[0]
    full = np.concatenate([np.convolve(m1, m2), [0]])
    return (full[:n] - full[n:]) % t


@pytest.fixture(scope="module")
def live():
    """n = 128, four data primes, two special, t 16-bit; a uniform relin
    key and uniform d1, d2 from a seeded numpy generator, and the JAX
    pipeline's (xla engine, jitted) tables and output (bfv_live_n128.npz);
    the port's context."""
    g = np.load(LIVE)
    qs = g["data_moduli"].tolist()
    tctx = make_context(EncryptionParameters.create(
        N, qs, g["special_moduli"].tolist(), "bfv", int(g["t"])), device=CPU)
    return dict(g=g, tctx=tctx, rlk=g["rlk"], d1=g["d1"], d2=g["d2"],
                out=g["out"], qs=qs, t=int(g["t"]))


def test_host_copies_match():
    """get_primes_below and PlainModulus.batching against the JAX
    package's host functions."""
    assert PlainModulus.batching(1 << 16, 20) == \
        JaxPlainModulus.batching(1 << 16, 20).value
    ub = min(jnumth.get_primes(2 * N, 28, 4))
    assert numth.get_primes_below(ub, 2 * N, 9) == \
        jnumth.get_primes_below(ub, 2 * N, 9)


def test_tables_match_build_bfv32(live):
    g, tctx = live["g"], live["tctx"]
    tp = tbfv.build_bfv32(tctx, convert.residues(live["rlk"]), device=CPU)
    assert list(tctx.rl_moduli) == g["rl_moduli"].tolist()
    pairs = [("mv_d_q", tp.mv_d.q), ("rl_half_mod_r", tp.rl_half_mod_r),
             ("rl_half_mod_q", tp.rl_half_mod_q), ("evk", tp.evk),
             ("mv_qlp_q", tp.ks.ntt.q[tp.ks.rows_qlp.long()]),
             ("mv_d_q", tp.ks.ntt.q[tp.rows_d.long()])]
    for name, tc in (("q_to_r", tp.q_to_r), ("r_to_q", tp.r_to_q)):
        pairs += [(f"{name}_{f}", getattr(tc, f)) for f in (
            "qhat_inv", "qhat_inv_shoup", "qhat_mod_p", "q_mod_p")]
    for f in ("ihat_inv", "ihat_inv_shoup", "omega_mod_out", "rho"):
        pairs.append((f"sr_to_r_{f}", getattr(tp.sr_to_r, f)))
    for name, got in pairs:
        want = g[f"tab_{name}"]
        np.testing.assert_array_equal(u32(got), want.reshape(got.shape)
                                      if name == "evk" else want)


@pytest.mark.parametrize("table", ["d_to_rl", "decrypt"])
def test_scale_and_round_matches_jax(live, table):
    """round((t / Ql) x) from D = Ql u Rl to Rl, and decryption's
    round((t / Ql) x) from Ql to {t}, on uniform residues and on the
    rounding edges (all-zero and all q - 1 columns)."""
    g, qs, t = live["g"], live["qs"], live["t"]
    rl = list(live["tctx"].rl_moduli)
    big_ql = 1
    for q in qs:
        big_ql *= q
    ins, outs = (qs + rl, rl) if table == "d_to_rl" else (qs, [t])
    x = g[f"x_{table}"]
    assert (x[:, 0] == 0).all() and (x[:, 1] == np.array(ins) - 1).all()
    tc = tsr.make_exact_scale_round32(ins, t, big_ql, outs)
    got = tsr.scale_and_round_exact32(convert.residues(x), tc)
    np.testing.assert_array_equal(u32(got), g[f"sr_{table}"])


@pytest.mark.parametrize("engine", ENGINES)
def test_step_matches_jax(live, engine):
    tp = tbfv.build_bfv32(live["tctx"], convert.residues(live["rlk"]),
                          engine=engine, device=CPU)
    assert tp.ks.engine == engine
    got = tp(convert.residues(live["d1"]), convert.residues(live["d2"]))
    np.testing.assert_array_equal(u32(got), live["out"])


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    n = g["d1"].shape[-1]
    ctx = make_context(EncryptionParameters.create(
        n, g["data_moduli"].tolist(), g["special_moduli"].tolist(), "bfv",
        int(g["t"])), device=CPU)
    return g, ctx


@pytest.mark.parametrize("engine", ENGINES)
def test_golden(golden, engine):
    """The step and the key switch of d1[1] through convert.bfv_pipeline,
    bit-equal to the JAX package's outputs."""
    g, ctx = golden
    p = convert.bfv_pipeline(ctx, g["rlk"], engine=engine)
    d1, d2 = convert.residues(g["d1"]), convert.residues(g["d2"])
    np.testing.assert_array_equal(u32(p(d1, d2)), g["out"])
    np.testing.assert_array_equal(
        u32(tpp.keyswitch32(p.ks, d1[1], p.evk)), g["keyswitch"])


def test_golden_decrypt(golden):
    """The port's decryption of the JAX step output equals the JAX
    decryption, which is m1 m2 mod (X^n + 1, t)."""
    g, ctx = golden
    pt = tkeys.decrypt(ctx, convert.residues(g["sk"]),
                       convert.residues(g["out"]))
    np.testing.assert_array_equal(pt.numpy(), g["pt_out"].astype(np.int64))
    np.testing.assert_array_equal(
        pt.numpy(), negacyclic_mod_t(g["m1"], g["m2"], int(g["t"])))


def test_own_keys_encrypt_step_decrypt(golden):
    """Keys and encryptions from a seeded torch.Generator at the golden
    file's parameters: each ciphertext decrypts to its message, and the
    step's output on either engine to m1 m2 mod (X^n + 1, t)."""
    _, ctx = golden
    n, t = ctx.params.n, ctx.params.plain_modulus
    gen = torch.Generator()
    gen.manual_seed(5)
    sk = tkeys.gen_secret_key(ctx, gen)
    rlk = tkeys.gen_relin_key(ctx, sk, gen)
    rng = np.random.default_rng(5)
    m1, m2 = (rng.integers(-3, 4, n) for _ in range(2))
    d1, d2 = (tkeys.encrypt_symmetric(ctx, sk, torch.from_numpy(m), gen)
              for m in (m1, m2))
    np.testing.assert_array_equal(tkeys.decrypt(ctx, sk, d1).numpy(), m1 % t)
    outs = [tbfv.build_bfv32(ctx, rlk, engine=e, device=CPU)(d1, d2)
            for e in ENGINES]
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_array_equal(tkeys.decrypt(ctx, sk, outs[0]).numpy(),
                                  negacyclic_mod_t(m1, m2, t))


def test_ckks_entry_points_refuse_the_roll_engine(golden):
    """The roll engine runs the CKKS entry points on its own routes only:
    not the K7 or K8 epilogue, not the fused modup, not the xla-bconv
    moddown."""
    _, ctx = golden
    with pytest.raises(ValueError, match="engine"):
        tpp.CKKSPipeline32(ctx, torch.zeros(1, dtype=torch.int32),
                           engine="pallas-roll", merged_epilogue=True)
    with pytest.raises(ValueError, match="engine"):
        tpp.build_keyswitch32(ctx, device=CPU, engine="pallas-roll",
                              modup="kernel")
    with pytest.raises(ValueError, match="engine"):
        tpp.build_keyswitch32(ctx, device=CPU, engine="pallas-roll",
                              moddown="xla")
    with pytest.raises(ValueError, match="engine"):
        tpp.build_keyswitch32(ctx, device=CPU, engine="xla")

"""BFV's BEHZ, HPSoverQ and HPSoverQ-leveled multiplications, the fused
K3 lift, and the host noise and security tables of the port against the
JAX package.

The techniques replay the golden file bfv_multech_n1024.npz (n = 1024,
five 28-bit data primes, alpha = 2; made by
tests/fixtures/gen_torch_port_fixtures.py with the JAX package's keys,
its Fast32 engine and its u64 evaluator) through
chip_smoke.bfv_multech_golden on both engines, every kernel on its plain
version; no test compiles live JAX.  The host modules (noise, hestd,
globals_) import no JAX, so they are compared with the JAX package's
directly.  Bit-exact throughout."""

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu.host import globals_ as jglobals
from phantom_tpu.host import hestd as jhestd
from phantom_tpu.host import noise as jnoise
from phantom_tpu.schemes.params import EncryptionParameters as JaxParams
from phantom_tpu.schemes.params import Scheme
from phantom_tpu_torch import convert, make_context
from phantom_tpu_torch.host import globals_, hestd, noise, numth
from phantom_tpu_torch.host.modulus import PlainModulus
from phantom_tpu_torch.ops import behz32, bfv32
from phantom_tpu_torch.ops import ntt_kernels as nk
from phantom_tpu_torch.schemes.params import EncryptionParameters

CPU = torch.device("cpu")
ENGINES = list(chip_smoke.ENGINES)
TECHS = list(chip_smoke.GOLDEN_TECHS)


@pytest.fixture(scope="module")
def replay():
    return chip_smoke.bfv_multech_golden(CPU)


@pytest.fixture(scope="module")
def golden():
    g = np.load(chip_smoke.BFV_MULTECH_GOLDEN)
    ctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), "bfv", int(g["t"]), mul_tech="behz"),
        device=CPU)
    return g, ctx


def _check(replay, name):
    got, want = replay[name]
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("tech", TECHS)
def test_technique_matches_jax(replay, tech, engine):
    """The multiply and the multiply + relinearize of each technique (BEHZ,
    HPSoverQ, leveled at the model's drop and at force_lvl=1) on each
    engine, bit-equal to the JAX package's (itself equal to its u64
    evaluator)."""
    for kind in ("multiply", "multiply + relin"):
        _check(replay, f"{tech} {kind}, {engine}")


def test_bsk_base_matches_jax(replay, golden):
    """The context's Bsk: B then m_sk, the first size_q + 1 29-bit primes
    == 1 mod 2N outside QP, at table rows after QP and Rl."""
    _check(replay, "Bsk")
    _, ctx = golden
    p = ctx.params
    b = ctx.get_context_data(2).behz
    assert b.bsk == ctx.bsk_moduli[:4] + ctx.bsk_moduli[-1:]
    assert ctx.ntt.q[list(b.rows_bsk)].tolist() == list(b.bsk)
    assert b.rows_bsk[0] == p.size_qp + p.size_q + 1


def test_fused_lift_matches_jax(replay, golden):
    """One K3 over all D rows (y scaled by QhatInv, the floor sums v, vmul
    [0 | Ql mod r_j]) = the JAX package's _lift_ntt_fused = the port's xla
    lift followed by K2's plain version."""
    _check(replay, "fused lift")
    g, ctx = golden
    p = convert.bfv_pipeline(ctx, g["rlk"])
    d1, d2 = convert.residues(g["d1"]), convert.residues(g["d2"])
    lifted = torch.stack([bfv32._lift(p, d, bfv32.KERNELS)
                          for d in (d1, d2)]).view(4, -1, ctx.params.n)
    want = nk.ntt_forward_plain(lifted, ctx.ntt, p.rows_d)
    np.testing.assert_array_equal(replay["fused lift"][0],
                                  want.numpy().astype(np.uint32))


@pytest.mark.parametrize("engine", ENGINES)
def test_fused_lift_option(engine):
    """lift="kernel" gives HPS's step bit for bit (the bfv_step golden
    file), and is refused on the "pallas-roll" engine."""
    g = np.load(chip_smoke.BFV_GOLDEN)
    ctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), "bfv", int(g["t"])), device=CPU)
    if engine == "pallas-roll":
        with pytest.raises(ValueError, match="lift"):
            convert.bfv_pipeline(ctx, g["rlk"], engine=engine, lift="kernel")
        return
    p = convert.bfv_pipeline(ctx, g["rlk"], lift="kernel")
    got = p(convert.residues(g["d1"]), convert.residues(g["d2"]))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), g["out"])


@pytest.mark.parametrize("tech", TECHS)
def test_decrypt_and_budget_match_jax(replay, tech):
    """The port's decryption of each JAX output (the multiply and the
    multiply + relinearize) and the invariant noise budget of the latter
    equal the JAX package's."""
    for name in (f"{tech} decrypt of mul", f"{tech} decrypt of relin",
                 f"{tech} noise budget"):
        _check(replay, name)


def test_budget_of_fresh_ciphertext(replay, golden):
    _check(replay, "d1 noise budget")
    g, _ = golden
    assert int(g["budget_d1"]) > int(g["budget_behz"]) > 0


def test_products_decrypt(golden):
    """BEHZ, HPSoverQ and leveled at the model's drop decrypt to m1 m2 mod
    (X^n + 1, t); leveled with a drop at its level's Ql (the rows before
    the dropped primes)."""
    g, ctx = golden
    from phantom_tpu_torch.schemes import keys
    t = int(g["t"])
    want = chip_smoke.negacyclic_product(g["m1"], g["m2"]) % t
    sk = convert.residues(g["sk"])
    for tech in TECHS:
        out = convert.residues(g[f"relin_{tech}"])
        k = out.shape[1] - (1 if tech == "lev1" else 0)
        got = keys.decrypt(ctx, sk, out[:, :k]).numpy()
        np.testing.assert_array_equal(got, want, err_msg=tech)


@pytest.mark.parametrize("n,size_q,size_p", [(1024, 5, 2), (4096, 8, 3),
                                             (32768, 20, 8), (65536, 43, 22)])
def test_find_levels_to_drop_matches_jax(n, size_q, size_p):
    """The port's copy of the noise model against the JAX package's over
    depths 0-5, both key-switch modes and both encryption kinds."""
    t = PlainModulus.batching(n, 20)
    beta = -(-size_q // size_p)
    for depth in range(6):
        for ks in (False, True):
            for asym in (False, True):
                args = (n, size_q, size_p, beta, t, 28, depth, ks, asym)
                assert noise.find_levels_to_drop(*args) == \
                    jnoise.find_levels_to_drop(*args), args


def test_hestd_tables_match_jax():
    for sec in (0, 128, 192, 256):
        for n in (1024, 4096, 32768, 65536, 131072, 512):
            assert hestd.max_coeff_modulus_bits(n, sec) == \
                jhestd.max_coeff_modulus_bits(n, sec)
            if sec:
                assert hestd.max_coeff_modulus_bits_quantum(n, sec) == \
                    jhestd.max_coeff_modulus_bits_quantum(n, sec)
    with pytest.raises(ValueError):
        hestd.max_coeff_modulus_bits(1024, 100)
    assert hestd.HE_STD_PARMS_ERROR_STD_DEV == \
        jhestd.HE_STD_PARMS_ERROR_STD_DEV


@pytest.mark.parametrize("sec", [128, 192, 256])
def test_default_chains_match_jax(sec):
    """Prime for prime where the JAX package builds a chain; where its
    profile exceeds its own budget (an assertion of the reference) the
    port raises too."""
    for n in (1024, 2048, 4096, 8192, 16384):
        f = getattr(globals_, f"default_coeff_modulus_{sec}")
        jf = getattr(jglobals, f"default_coeff_modulus_{sec}")
        try:
            want = [m.value for m in jf(n)]
        except AssertionError:
            with pytest.raises(AssertionError):
                f(n)
            continue
        assert f(n) == want


@pytest.mark.parametrize("sec", [0, 128, 192, 256])
def test_sec_level_refuses_as_jax(sec):
    """EncryptionParameters' HE-standard check: the port refuses what the
    JAX package refuses, at each security level, on both sides of the
    budget."""
    n = 4096
    for k in (2, 3, 4):
        qs = numth.get_primes(2 * n, 30, k + 1)
        data, special = qs[:k], qs[k:]
        try:
            JaxParams.create(Scheme.CKKS, n, data + special,
                             special_modulus_size=1, sec_level=sec)
            refused = False
        except ValueError:
            refused = True
        if refused:
            with pytest.raises(ValueError, match="HE-std"):
                EncryptionParameters.create(n, data, special, sec_level=sec)
        else:
            assert EncryptionParameters.create(n, data, special,
                                               sec_level=sec).sec_level == sec
    assert sec == 0 or refused


def _behz_small():
    n = 1024
    qs = numth.get_primes(2 * n, 28, 5)
    ctx = make_context(EncryptionParameters.create(
        n, qs, numth.get_primes(2 * n, 29, 2), "bfv",
        PlainModulus.batching(n, 16), mul_tech="behz"), device=CPU)
    c = behz32.BEHZConsts32(qs, ctx.get_context_data(1).behz.bsk,
                            ctx.params.plain_modulus)
    return n, qs, c


def test_sm_mrq32_exact_lift():
    """SmMRq against the exact-integer oracle: with c = sum_i y_i Qhat_i
    (y = [m_tilde x QhatInv]_q) and r = -c Q^-1 mod 2^32, centered (the
    unsigned test r > 2^31), the lift is (c + r Q) / 2^32, the
    representative of x mod Q below Q (1/2 + (k + 1) / 2^32) in absolute
    value.  The inputs (uniform residues, all q - 1, all zero) take r
    above 2^31 and to 0, so both branches and the masked 2^32 arithmetic
    run."""
    n, qs, c = _behz_small()
    rng = np.random.default_rng(1)
    x = np.stack([rng.integers(0, q, n) for q in qs])
    x[:, 0] = 0
    x[:, 1] = np.array(qs) - 1
    got = behz32.sm_mrq32(torch.from_numpy(x).int(), c).numpy()
    m = 1 << 32
    big_q = int(np.prod(np.array(qs, dtype=object)))
    bsk = [int(b) for b in c.bsk.q.tolist()]
    rs = []
    for j in range(n):
        col = [int(v) for v in x[:, j]]
        cc = sum(v * m % q * pow(big_q // q, -1, q) % q * (big_q // q)
                 for v, q in zip(col, qs))
        r = -cc * pow(big_q, -1, m) % m
        rs.append(r)
        lift = (cc + (r - m if r > 1 << 31 else r) * big_q) // m
        value = sum(v * (big_q // q) * pow(big_q // q, -1, q)
                    for v, q in zip(col, qs)) % big_q
        assert (lift - value) % big_q == 0
        assert abs(lift) <= big_q // 2 + (len(qs) + 1) * big_q // m
        assert got[:, j].tolist() == [lift % b for b in bsk], j
    assert rs[0] == 0 and sum(r > 1 << 31 for r in rs) > n // 4


def test_mul_mod_2_32():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 32, 1000, dtype=np.int64)
    for b in (0, 1, 0xFFFFFFFF, 0x80000001, int(rng.integers(0, 1 << 32))):
        got = behz32.mul_mod_2_32(torch.from_numpy(a), b).numpy()
        want = [(int(v) * b) % (1 << 32) for v in a]
        assert got.tolist() == want


def test_behz_refuses_primes_past_30_bits():
    """A BEHZ context whose QP has a prime of 2^30 or more takes the JAX
    package's 61-bit Bsk (the u64 evaluator runs it); the 32-bit BEHZ
    pipeline refuses it rather than fall back."""
    n = 1024
    qs = numth.get_primes(2 * n, 28, 3)
    ctx = make_context(EncryptionParameters.create(
        n, qs, numth.get_primes(2 * n, 31, 1), "bfv",
        PlainModulus.batching(n, 16), mul_tech="behz"), device=CPU)
    assert {b.bit_length() for b in ctx.bsk_moduli} == {61}
    with pytest.raises(ValueError, match="below 2\\^30"):
        bfv32.build_bfv_behz32(ctx, torch.zeros((3, 2, 4, n),
                                                dtype=torch.int64),
                               device=CPU)


def test_leveled_noise_scale_deg_drop(golden):
    """build_bfv_leveled32 takes the noise model's drop for the operands'
    noise_scale_deg, or force_lvl."""
    g, ctx = golden
    rlk = convert.residues(g["rlk"])
    p = ctx.params
    for deg in (1, 2, 3, 4):
        lev = bfv32.build_bfv_leveled32(ctx, rlk, deg, device=CPU)
        assert lev.lvl == noise.find_levels_to_drop(
            p.n, p.size_q, p.size_p, 3, p.plain_modulus, 28, deg - 1, False,
            True)
    assert bfv32.build_bfv_leveled32(ctx, rlk, device=CPU,
                                     force_lvl=2).lvl == 2

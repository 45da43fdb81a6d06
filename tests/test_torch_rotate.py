"""The port's key switching and rotations against the JAX package: the
golden file tests/fixtures/torch_port/rotate_n1024.npz (n = 1024, five
data primes, alpha = 2, beta = 3 with a short last digit; real JAX keys
carried over by convert.py, outputs of the mxu-pallas engine's default
dispatch, which runs the fused modup + inner product at alpha <= 8), the
step through each of its epilogues against the same file, the hoisted
forms' inner products through ops.inner_product with their permutations,
inner_product32 at beta > 4, the Galois tables, and the port's own keys
and encryptions decrypting to the rotated polynomials.  Bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu.host import numth
from phantom_tpu.ops import pipeline32 as jpp
from phantom_tpu.schemes import EncryptionParameters as JaxParams
from phantom_tpu.schemes import Scheme
from phantom_tpu.schemes import galois as jgal
from phantom_tpu.schemes import make_context as jax_context
from phantom_tpu_torch import make_context
from phantom_tpu_torch.ops import pipeline32 as tpp
from phantom_tpu_torch.schemes import galois as tgal
from phantom_tpu_torch.schemes.params import EncryptionParameters

CPU = torch.device("cpu")
GOLDEN = ["rotate", "keyswitch", "hoisting_sum", "linear_combo", "moddown",
          "step", "step_K8", "step_K7"]


@pytest.fixture(scope="module")
def golden():
    return chip_smoke.rotate_golden(CPU)


@pytest.mark.parametrize("name", GOLDEN)
def test_rotate_golden(golden, name):
    got, want = golden[name]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_hoisted_forms_through_inner_product():
    """Each key-switched step of both hoisted forms is one ops.inner_product
    call on the shared modup tensor with that step's permutation (step 0
    of the combination needs none); the outputs equal the golden file."""
    g, _, ks, gal, t = chip_smoke.rotate_golden_state(CPU)
    calls = []

    def inner_product(t_up, evk, q, perm=None):
        calls.append(perm)
        return tpp.PLAIN.inner_product(t_up, evk, q, perm)

    ops = tpp.PLAIN._replace(inner_product=inner_product)
    hoist = g["hoist_steps"].tolist()
    combo = g["combo_steps"].tolist()
    got = tpp.hoisting_sum32(ks, gal, t["d1"], hoist, ops)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), g["hoist"])
    got = tpp.hoisted_linear_combo32(ks, gal, t["d1"], combo, list(t["pts"]),
                                     ops)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), g["combo"])
    keyed = hoist + [s for s in combo if s % (t["d1"].shape[-1] // 2)]
    assert len(calls) == len(keyed)
    for perm, s in zip(calls, keyed):
        assert torch.equal(perm, gal.perms[gal.step_index(s)])


def test_galois_tables_match():
    n = 1024
    steps = [0, 1, 2, 3, -1, 7, 100, n // 2 - 1]
    assert tgal.get_elts_from_steps(steps, n) == \
        jgal.get_elts_from_steps(steps, n)
    for elt in tgal.get_elts_from_steps(steps, n):
        np.testing.assert_array_equal(tgal.make_ntt_perm(elt, n),
                                      jgal.make_ntt_perm(elt, n))


@pytest.mark.parametrize("beta", [6, 9])
def test_inner_product_beyond_beta4(beta):
    """inner_product32 at beta > 4 against the JAX package's 96-bit triple
    path, n = 128, alpha = 2, inputs of every residue up to q - 1."""
    n, alpha = 128, 2
    k = 2 * beta - 1
    qs = numth.get_primes(2 * n, 28, k)
    ps = numth.get_primes(2 * n, 29, alpha)
    jks = jpp.build_keyswitch32(jax_context(JaxParams.create(
        Scheme.CKKS, n, qs + ps, special_modulus_size=alpha)), 1)
    tks = tpp.build_keyswitch32(make_context(EncryptionParameters.create(
        n, qs, ps), device=CPU), device=CPU)
    assert tks.beta == beta
    rng = np.random.default_rng(beta)
    q = np.array(qs + ps, dtype=np.int64)[:, None]
    t, evk = ((rng.integers(0, 1 << 40, shape) % q).astype(np.uint32)
              for shape in ((beta, k + alpha, n), (beta, 2, k + alpha, n)))
    t[:, :, :4] = (q - 1).astype(np.uint32)
    evk[..., :4] = (q - 1).astype(np.uint32)
    ref = jpp.inner_product32(jks, jnp.asarray(t), jnp.asarray(evk))
    got = tpp.inner_product32(tks, torch.from_numpy(t.view(np.int32)),
                              torch.from_numpy(evk.view(np.int32)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(r))


def test_own_keys_rotate_hoist_decrypt():
    """The chip smoke's alpha-8 flow at n = 1024, L = 5, alpha = 2 on the
    CPU: the port's own keys; a rotation, hoisting_sum32 and
    hoisted_linear_combo32 decrypt to sigma(m1), sum sigma(m1) and
    sum w_s sigma_s(m1), and both modup routes agree."""
    n = 1024
    ctx = make_context(chip_smoke.chain_params(n, 5, 2), device=CPU)
    sk, pipe, d1, _, m1, _ = chip_smoke.make_step_inputs(
        ctx, 5, chip_smoke.DELTA_BITS, CPU)
    steps = chip_smoke.STEPS
    gal = chip_smoke.make_galois(ctx, sk, 5, steps, CPU)
    ks = pipe.ks
    rng = np.random.default_rng(6)
    ws = [rng.integers(-3, 4, n) for _ in range(len(steps) + 1)]
    pts = [chip_smoke.encode_weights(ctx, ks, w) for w in ws]
    sig = {0: m1, **{s: chip_smoke.galois_coeffs(
        m1, tgal.get_elt_from_step(s, n)) for s in steps}}
    scale = 2.0 ** chip_smoke.DELTA_BITS
    rot = tpp.rotate32(ks, gal, d1, 1)
    cases = [
        (rot, sig[1]),
        (tpp.hoisting_sum32(ks, gal, d1, steps), sum(sig[s] for s in steps)),
        (tpp.hoisted_linear_combo32(ks, gal, d1, range(len(ws)), pts),
         sum(chip_smoke.negacyclic_product(w, sig[s])
             for s, w in enumerate(ws))),
    ]
    for i, (ct, want) in enumerate(cases):
        dist = chip_smoke.check_coeffs(chip_smoke.decrypt_coeffs(
            ctx, sk, ct, scale), want, f"case {i}")
        assert dist < 0.25
    # the rotation's key switch (c1 permuted) on both modup routes
    kidx = gal.step_index(1)
    c1p = d1[1][:, gal.perms[kidx]]
    for got, want in zip(tpp._modup_ip_split(ks, c1p, gal.evks[kidx]),
                         tpp.modup_ip32(ks, c1p, gal.evks[kidx])):
        assert torch.equal(got, want)

"""Generate the golden files for the PyTorch port's tests, with the JAX
package on the CPU (Pallas kernels in interpret mode).

ckks_step_n1024.npz: n = 1024, five 28-bit data primes and two 29-bit
  special primes (so the last key-switch digit is short), real JAX keys and
  two encryptions at chain index 1, and the output of
  `pipeline32.mult_relin_rescale32` on the xla-split structure of the
  mxu-pallas engine, asserted equal to the u64 evaluator's
  rescale_to_next(multiply_and_relin) before anything is written.  Stored
  (u32 unless noted): data_moduli, special_moduli (u64), d1, d2 (2, 5, N),
  rlk (dnum, 2, K, N) as keys.gen_relin_key made it, evk (beta, 2,
  size_qlp, N) as build_pipeline32 converts it, sk (K, N), out (2, 4, N)
  and pt_out (4, N), the JAX decryption of out.

rotate_n1024.npz: the same chain (alpha = 2, beta = 3 with a short last
  digit) on the mxu-pallas engine's default dispatch, which runs the fused
  modup + inner product kernel (modup_ip_mxu_pallas) at alpha <= 8.  Real
  JAX keys: glk (n_elts, dnum, 2, K, N) for steps (1, 2, -1) with its
  elements `elts`, rlk, sk; two encryptions d1, d2; pts (3, size_qlp, N),
  uniform NTT-form weights over QlP; moddown_in (size_qlp, N), uniform
  residues.  Outputs: rotate = rotate32(d1, 1) (asserted equal to the u64
  evaluator's rotate), keyswitch = keyswitch_from_ntt32(d1[1]) with the
  step-1 key, hoist = hoisting_sum32 over hoist_steps (1, 2, -1), combo =
  hoisted_linear_combo32 over combo_steps (0, 1, 2) with pts, moddown =
  moddown32(moddown_in), step = mult_relin_rescale32 on the fused route
  (asserted equal to the u64 evaluator).

step_n128_{even,uneven}.npz: n = 128, 28-bit data primes (4 and 5 of
  them) and two 29-bit special primes, a uniform random relin key rlk
  (dnum, 2, K, N) and uniform d1, d2 (2, k, N) from
  numpy.random.default_rng(k), and `out`, mult_relin_rescale32 on the
  xla-split structure of the mxu-pallas engine.

bfv_step_n1024.npz: BFV at n = 1024, the same chain (five 28-bit data
  primes, alpha = 2, so beta = 3 with a short last digit), t =
  PlainModulus.batching(n, 16) as utils/benchsetup.py picks it, real JAX
  keys and two symmetric encryptions (coefficient form, chain index 1) of
  polynomials m1, m2 with coefficients in [-3, 3] taken mod t.  Outputs,
  on the mxu-pallas engine's default dispatch (K4's coefficient form,
  modup_ip_mxu_pallas with c2_ntt=None): keyswitch = keyswitch32 of d1[1]
  with the relin key, out = bfv_mult_relin32(d1, d2) (asserted equal to
  the xla engine's and to the u64 evaluator's multiply_and_relin), and
  pt_out, the JAX decryption of out (asserted equal to m1 m2 mod
  (X^n + 1, t)).  Stored: data_moduli, special_moduli (u64), t, sk, rlk,
  d1, d2, m1, m2 (int64), keyswitch, out, pt_out.

bfv_multech_n1024.npz: BFV's other multiplication techniques at
  bfv_step_n1024.npz's parameters (n = 1024, five 28-bit data primes,
  alpha = 2, t = PlainModulus.batching(n, 16)): real JAX keys over QP,
  which every technique shares, and two symmetric encryptions d1, d2 of
  polynomials m1, m2 with coefficients in [-3, 3].  One context per
  mul_tech (the BEHZ one holds the Bsk base, stored as bsk_moduli).  For
  behz, overq (HPSoverQ), lev0 (leveled at the noise model's drop for
  noise_scale_deg 1, which is 0 here) and lev1 (leveled with force_lvl=1,
  the u64 evaluator's noise model patched to 1), on the JAX Fast32's
  default engine (use_pallas=False): mul_<tech>, the multiply, and
  relin_<tech>, the multiply + relinearize, each asserted equal to the u64
  evaluator's multiply and multiply_and_relin before anything is
  written; pt_mul_<tech> and pt_relin_<tech>, their JAX decryptions;
  budget_<tech>, the invariant_noise_budget of relin_<tech>, and
  budget_d1, d1's.  lift: the fused lift (_lift_ntt_fused on the
  mxu-pallas engine, K3 in interpret mode) of the four polys of (d1, d2),
  (4, size_d, N) in NTT form over D, asserted equal to the xla lift
  followed by the forward NTT.  Stored also: data_moduli, special_moduli
  (u64), t, sk, rlk, m1, m2 (int64).

bgv_step_n1024.npz: BGV at n = 1024, the same chain (five 28-bit data
  primes, alpha = 2, a short last digit), t = PlainModulus.batching(n, 16),
  built as tests/test_fastpath32.py's BGV fixture builds it: real JAX keys
  (secret, public, relin) and two asymmetric encryptions of BatchEncoder
  encodings of uniform slot vectors mod t (NTT form, chain index 1,
  correction factor 1).  Outputs: out = bgv32.bgv_mult_relin_modswitch32
  on the mxu-pallas engine's default dispatch (at alpha = 2 the K4
  route), asserted equal to the xla-split route's and to the u64
  evaluator's mod_switch_to_next(multiply_and_relin), whose correction
  factor cf (= q_last^-1 mod t) is stored; pt_out, the JAX decryption of
  that ciphertext (asserted equal to pt1 pt2 mod (X^n + 1, t), the
  product of the encoded plaintext polynomials).  Stored: data_moduli,
  special_moduli (u64), t, cf, sk, rlk, d1, d2 (2, 5, N), pt1, pt2
  (int64), out (2, 4, N), pt_out.

bfv_live_n128.npz: what tests/test_torch_bfv.py compared with live jitted
  JAX until it moved onto this file: BFV at n = 128, four 28-bit data
  primes, two 29-bit special primes, t = PlainModulus.batching(128, 16);
  from numpy.random.default_rng(4), a uniform relin key rlk (2, 2, K, N)
  and uniform d1, d2 (2, 4, N), then the scale-and-round inputs x_d_to_rl
  (D = Ql u Rl rows) and x_decrypt (Ql rows), each with an all-zero
  column 0 and an all q - 1 column 1.  Outputs: out =
  jit(bfv_mult_relin32) on build_bfv32's default engine; sr_d_to_rl and
  sr_decrypt = jit(scale_and_round_exact32) to Rl and to {t}; rl_moduli
  and the pipeline's tables (tab_<field>: mv_d_q, rl_half_mod_r,
  rl_half_mod_q, evk, mv_qlp_q, the q_to_r and r_to_q converters' qhat_inv,
  qhat_inv_shoup, qhat_mod_p, q_mod_p, and sr_to_r's ihat_inv,
  ihat_inv_shoup, omega_mod_out, rho).

ntt32_n128.npz: what tests/test_torch_ntt.py compared with live jitted
  JAX: n = 128, three 28-bit primes and one 29-bit prime; for lazy in (0,
  1), x_<lazy> (2, 4, N) in [0, q) and xi_<lazy> in [0, q) or [0, 2q) from
  numpy.random.default_rng(31), fwd_<lazy> = jit(ntt32.ntt_forward32)(x)
  and inv_<lazy> = jit(ntt32.ntt_inverse32)(xi).

fast32_<case>.npz: the JAX package's Fast32 verbs at n = 1024 (the card's
  NTT core takes N >= 2^10, so these files also run through the kernels),
  case for case after tests/test_fast32.py, on its primes (28-bit data
  primes, 29-bit special primes) and PRNG keys, with JAX keys, samples
  and outputs.  Ciphertexts are stored as <name> (u32 residues),
  <name>__meta (chain index, NTT form, correction factor, noise scale
  degree) and <name>__scale; plaintexts as <name>, <name>__meta (chain
  index, NTT form) and <name>__scale.  The draws the JAX samplers made are
  stored beside the outputs, so the port's cores take the same samples:
  enc_u (N,) ternary, enc_e (2, N) CBD for an asymmetric encryption
  (split(key, 3)); s_tern, and a (uniform (K, N)) and e (CBD (N,)) for
  each encryption of zero of the public, relin and Galois keys.  Cases:
  ckks_chain (five data primes, alpha 2, slots half the JAX test's at
  scale 2^28: encrypt, square + relin + rescale twice, rotate by 1 at
  chain index 3, decrypt and decode),
  bgv_chain (four data primes, alpha 1: multiply + relin then modswitch,
  the two modswitched inputs multiplied, their sum with balanced
  correction factors, a modswitch to chain index 3, decrypt and decode),
  encrypt_{ckks,bfv,bgv} (three data primes, alpha 1: encode, encrypt,
  decrypt, decode), combo (four data primes, alpha 2:
  hoisted_linear_combo over steps (0, 1, 2) with encode_extended weights,
  hoisting over (1, 2), apply_galois of step 2's element), verbs_{ckks,
  bfv,bgv} (three data primes, alpha 1: add, sub, negate, the plain ops,
  modswitch, multiply, relinearize, multiply + relin, square + relin,
  rotate, decrypt; CKKS also rescale; BGV also add_plain after a
  modswitch) and keygen_{ckks,bgv} (four data primes, alpha 2: secret,
  public, relin and Galois keys for steps (1, 2)).

Run from the repo root (CPU, about four minutes for all; names choose
files, e.g. `bfv_step` writes only bfv_step_n1024.npz, `bfv_multech`
only bfv_multech_n1024.npz):

    PYTHONPATH=. python tests/fixtures/gen_torch_port_fixtures.py [name ...]
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from phantom_tpu.host import numth  # noqa: E402
from phantom_tpu.host.modulus import PlainModulus  # noqa: E402
from phantom_tpu.host.modulus import Modulus  # noqa: E402
from phantom_tpu.host.ntt_tables import make_rns_ntt_tables  # noqa: E402
from phantom_tpu import Fast32  # noqa: E402
from phantom_tpu.ops import bfv32, bgv32, scaleround32  # noqa: E402
from phantom_tpu.ops import sampling as jsmp  # noqa: E402
from phantom_tpu.ops import ntt as ntt64  # noqa: E402
from phantom_tpu.ops import ntt32  # noqa: E402
from phantom_tpu.ops import pipeline32 as pp  # noqa: E402
from phantom_tpu.schemes import (BatchEncoder, CKKSEncoder,  # noqa: E402
                                 EncryptionParameters, Plaintext, Scheme,
                                 evaluate, keys, make_context)
from phantom_tpu.schemes.ckks_encoder import encode_extended  # noqa: E402

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port")
N, K_DATA, ALPHA, SEED = 1024, 5, 2, 7
HOIST_STEPS = (1, 2, -1)
COMBO_STEPS = (0, 1, 2)


def u32(a):
    return np.asarray(a).astype(np.uint32)


def uniform(rng, moduli, lead, n):
    q = np.array(moduli, dtype=np.uint64)[:, None]
    return (rng.integers(0, 1 << 62, lead + (len(moduli), n),
                        dtype=np.uint64) % q).astype(np.uint32)


def _save(name, **arrays):
    path = os.path.join(DIR, name)
    os.makedirs(DIR, exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


def _setup():
    qs = numth.get_primes(2 * N, 28, K_DATA)
    ps = numth.get_primes(2 * N, 29, ALPHA)
    params = EncryptionParameters.create(Scheme.CKKS, N, qs + ps,
                                         special_modulus_size=ALPHA)
    ctx = make_context(params)
    k_sk, k_rlk, k1, k2 = jax.random.split(jax.random.PRNGKey(SEED), 4)
    sk = keys.gen_secret_key(ctx, k_sk)
    rlk = keys.gen_relin_key(ctx, sk, k_rlk)
    enc = CKKSEncoder(ctx)
    rng = np.random.default_rng(SEED)
    pt1 = enc.encode(rng.standard_normal(enc.slots), 2.0 ** 20)
    pt2 = enc.encode(rng.standard_normal(enc.slots), 2.0 ** 20)
    ct1 = keys.encrypt_symmetric(ctx, sk, pt1, k1)
    ct2 = keys.encrypt_symmetric(ctx, sk, pt2, k2)
    return qs, ps, ctx, sk, rlk, ct1, ct2


def ckks_step(qs, ps, ctx, sk, rlk, ct1, ct2):
    ref_ct = evaluate.rescale_to_next(
        ctx, evaluate.multiply_and_relin(ctx, ct1, ct2, rlk))
    ref = u32(ref_ct.data)
    old = pp.MODUP_VARIANT
    pp.MODUP_VARIANT = "xla-split"
    try:
        p = pp.build_pipeline32(ctx, rlk, use_pallas="mxu-pallas")
        d1, d2 = u32(ct1.data), u32(ct2.data)
        out = np.asarray(pp.mult_relin_rescale32(p, jnp.asarray(d1),
                                                 jnp.asarray(d2)))
    finally:
        pp.MODUP_VARIANT = old
    np.testing.assert_array_equal(out, ref)
    evk = np.asarray(p.evk)
    _save("ckks_step_n1024.npz",
          data_moduli=np.array(qs, dtype=np.uint64),
          special_moduli=np.array(ps, dtype=np.uint64), d1=d1, d2=d2,
          rlk=u32(rlk.data), evk=evk.reshape(*evk.shape[:3], N),
          sk=u32(sk.data), out=out,
          pt_out=u32(keys.decrypt(ctx, sk, ref_ct).data))


def rotate(qs, ps, ctx, sk, rlk, ct1, ct2):
    glk = keys.create_galois_keys(ctx, sk, jax.random.PRNGKey(SEED + 1),
                                  steps=list(HOIST_STEPS))
    ks = pp.build_keyswitch32(ctx, 1, use_pallas="mxu-pallas")
    g = pp.build_galois32(ctx, glk)
    p = pp.build_pipeline32(ctx, rlk, use_pallas="mxu-pallas")
    d1, d2 = u32(ct1.data), u32(ct2.data)
    j1 = jnp.asarray(d1)
    rng = np.random.default_rng(SEED + 2)
    qlp = list(qs) + list(ps)
    pts = uniform(rng, qlp, (len(COMBO_STEPS),), N)
    moddown_in = uniform(rng, qlp, (), N)
    out = dict(
        rotate=np.asarray(pp.rotate32(ks, g, j1, 1)),
        keyswitch=np.asarray(pp.keyswitch_from_ntt32(
            ks, j1[1], g.evks[g.elts.index(glk.elts[0])])),
        hoist=np.asarray(pp.hoisting_sum32(ks, g, j1, HOIST_STEPS)),
        combo=np.asarray(pp.hoisted_linear_combo32(
            ks, g, j1, COMBO_STEPS, [jnp.asarray(x) for x in pts])),
        moddown=np.asarray(pp.moddown32(ks, jnp.asarray(moddown_in))),
        step=np.asarray(pp.mult_relin_rescale32(p, j1, jnp.asarray(d2))))
    np.testing.assert_array_equal(
        out["rotate"], u32(evaluate.rotate(ctx, ct1, 1, glk).data))
    np.testing.assert_array_equal(out["step"], u32(evaluate.rescale_to_next(
        ctx, evaluate.multiply_and_relin(ctx, ct1, ct2, rlk)).data))
    _save("rotate_n1024.npz",
          data_moduli=np.array(qs, dtype=np.uint64),
          special_moduli=np.array(ps, dtype=np.uint64),
          glk=u32(glk.data), elts=np.array(glk.elts, dtype=np.int64),
          rlk=u32(rlk.data), sk=u32(sk.data), d1=d1, d2=d2, pts=pts,
          moddown_in=moddown_in, hoist_steps=np.array(HOIST_STEPS),
          combo_steps=np.array(COMBO_STEPS), **out)


def step_n128(k, alpha=2, n=128):
    qs = numth.get_primes(2 * n, 28, k)
    ps = numth.get_primes(2 * n, 29, alpha)
    ctx = make_context(EncryptionParameters.create(
        Scheme.CKKS, n, qs + ps, special_modulus_size=alpha))
    rng = np.random.default_rng(k)
    dnum = -(-k // alpha)
    rlk = np.stack([uniform(rng, qs + ps, (2,), n) for _ in range(dnum)])
    d1, d2 = (uniform(rng, qs, (2,), n) for _ in range(2))
    old = pp.MODUP_VARIANT
    pp.MODUP_VARIANT = "xla-split"
    try:
        p = pp.build_pipeline32(ctx, keys.RelinKey(data=jnp.asarray(
            rlk.astype(np.uint64))), use_pallas="mxu-pallas")
        out = np.asarray(pp.mult_relin_rescale32(p, jnp.asarray(d1),
                                                 jnp.asarray(d2)))
    finally:
        pp.MODUP_VARIANT = old
    _save(f"step_n128_{'even' if k % alpha == 0 else 'uneven'}.npz",
          data_moduli=np.array(qs, dtype=np.uint64),
          special_moduli=np.array(ps, dtype=np.uint64), rlk=rlk, d1=d1,
          d2=d2, out=out)


def negacyclic_mod_t(m1, m2, t):
    n = m1.shape[0]
    full = np.convolve(m1, m2)
    full = np.concatenate([full, np.zeros(1, dtype=full.dtype)])
    return (full[:n] - full[n:]) % t


def bfv_step():
    qs = numth.get_primes(2 * N, 28, K_DATA)
    ps = numth.get_primes(2 * N, 29, ALPHA)
    t = PlainModulus.batching(N, max(16, N.bit_length() + 3)).value
    ctx = make_context(EncryptionParameters.create(
        Scheme.BFV, N, qs + ps, plain_modulus=t, special_modulus_size=ALPHA))
    k_sk, k_rlk, k1, k2 = jax.random.split(jax.random.PRNGKey(SEED + 3), 4)
    sk = keys.gen_secret_key(ctx, k_sk)
    rlk = keys.gen_relin_key(ctx, sk, k_rlk)
    rng = np.random.default_rng(SEED + 3)
    m1, m2 = (rng.integers(-3, 4, N) for _ in range(2))
    ct1, ct2 = (keys.encrypt_symmetric(ctx, sk, Plaintext(
        data=jnp.asarray((m % t).astype(np.uint64))[None], chain_index=1), k)
        for m, k in ((m1, k1), (m2, k2)))
    d1, d2 = u32(ct1.data), u32(ct2.data)
    p = bfv32.build_bfv32(ctx, rlk, use_pallas="mxu-pallas")
    out = np.asarray(bfv32.bfv_mult_relin32(p, jnp.asarray(d1),
                                            jnp.asarray(d2)))
    ks_out = np.asarray(pp.keyswitch32(p.ks, jnp.asarray(d1[1]), p.evk))
    ref_ct = evaluate.multiply_and_relin(ctx, ct1, ct2, rlk)
    np.testing.assert_array_equal(out, u32(ref_ct.data))
    px = bfv32.build_bfv32(ctx, rlk, use_pallas=False)
    np.testing.assert_array_equal(out, np.asarray(bfv32.bfv_mult_relin32(
        px, jnp.asarray(d1), jnp.asarray(d2))))
    np.testing.assert_array_equal(ks_out, np.asarray(pp.keyswitch32(
        px.ks, jnp.asarray(d1[1]), px.evk)))
    pt_out = np.asarray(keys.decrypt(ctx, sk, ref_ct).data)[0]
    np.testing.assert_array_equal(pt_out, negacyclic_mod_t(m1, m2, t))
    _save("bfv_step_n1024.npz",
          data_moduli=np.array(qs, dtype=np.uint64),
          special_moduli=np.array(ps, dtype=np.uint64),
          t=np.array(t, dtype=np.uint64), sk=u32(sk.data),
          rlk=u32(rlk.data), d1=d1, d2=d2, m1=m1, m2=m2, keyswitch=ks_out,
          out=out, pt_out=u32(pt_out))


def bfv_multech():
    from phantom_tpu.host import noise as noise_mod
    from phantom_tpu.schemes import MulTech
    qs = numth.get_primes(2 * N, 28, K_DATA)
    ps = numth.get_primes(2 * N, 29, ALPHA)
    t = PlainModulus.batching(N, 16).value
    ctxs = {mt: make_context(EncryptionParameters.create(
        Scheme.BFV, N, qs + ps, plain_modulus=t, special_modulus_size=ALPHA,
        mul_tech=mt)) for mt in MulTech}
    hps = ctxs[MulTech.HPS]
    k_sk, k_rlk, k1, k2 = jax.random.split(jax.random.PRNGKey(SEED + 11), 4)
    sk = keys.gen_secret_key(hps, k_sk)
    rlk = keys.gen_relin_key(hps, sk, k_rlk)
    rng = np.random.default_rng(SEED + 11)
    m1, m2 = (rng.integers(-3, 4, N) for _ in range(2))
    ct1, ct2 = (keys.encrypt_symmetric(hps, sk, Plaintext(
        data=jnp.asarray((m % t).astype(np.uint64))[None], chain_index=1), k)
        for m, k in ((m1, k1), (m2, k2)))
    d1, d2 = jnp.asarray(u32(ct1.data)), jnp.asarray(u32(ct2.data))
    out = dict(budget_d1=np.array(keys.invariant_noise_budget(hps, sk, ct1)))
    techs = {
        "behz": (MulTech.BEHZ, lambda c: bfv32.build_bfv_behz32(c, rlk),
                 bfv32.bfv_mult_behz32, bfv32.bfv_mult_relin_behz32),
        "overq": (MulTech.HPS_OVERQ, lambda c: bfv32.build_bfv32(c, rlk),
                  bfv32.bfv_mult_hps_overq32, bfv32.bfv_mult_relin_overq32),
        "lev0": (MulTech.HPS_OVERQ_LEVELED,
                 lambda c: bfv32.build_bfv_leveled32(c, rlk),
                 bfv32.bfv_mult_leveled32, bfv32.bfv_mult_relin_leveled32),
        "lev1": (MulTech.HPS_OVERQ_LEVELED,
                 lambda c: bfv32.build_bfv_leveled32(c, rlk, force_lvl=1),
                 bfv32.bfv_mult_leveled32, bfv32.bfv_mult_relin_leveled32),
    }
    for name, (mt, build, mul, mul_relin) in techs.items():
        ctx = ctxs[mt]
        p = build(ctx)
        if name.startswith("lev"):
            assert p.lvl == int(name[-1]), p.lvl
        drop = noise_mod.find_levels_to_drop
        if name == "lev1":  # the u64 evaluator consults the noise model
            noise_mod.find_levels_to_drop = lambda *a, **kw: 1
        try:
            ref_mul = evaluate.multiply(ctx, ct1, ct2)
            ref = evaluate.multiply_and_relin(ctx, ct1, ct2, rlk)
        finally:
            noise_mod.find_levels_to_drop = drop
        got_mul, got = (np.asarray(f(p, d1, d2)) for f in (mul, mul_relin))
        np.testing.assert_array_equal(got_mul, u32(ref_mul.data))
        np.testing.assert_array_equal(got, u32(ref.data))
        out.update({f"mul_{name}": got_mul, f"relin_{name}": got,
                    f"pt_mul_{name}": u32(keys.decrypt(
                        ctx, sk, ref_mul).data)[0],
                    f"pt_relin_{name}": u32(keys.decrypt(
                        ctx, sk, ref).data)[0],
                    f"budget_{name}": np.array(keys.invariant_noise_budget(
                        ctx, sk, ref))})
        right = np.array_equal(out[f"pt_relin_{name}"],
                               negacyclic_mod_t(m1, m2, t))
        print(f"{name}: lvl {getattr(p, 'lvl', 0)}, budget "
              f"{int(out['budget_' + name])}, decrypts to m1 m2: {right}")
    # the fused lift, in the kernels' blocked tiling, against the xla lift
    pf = bfv32.build_bfv32(hps, rlk, use_pallas="mxu-pallas")
    tq = pf.ks.t_ql
    polys = jnp.concatenate([d1, d2])
    lift = np.asarray(bfv32._lift_ntt_fused(
        pf, polys.reshape(4, K_DATA, tq.n1, tq.n2))).reshape(4, -1, N)
    px = bfv32.build_bfv32(hps, rlk)
    lifted = jnp.stack([jnp.concatenate(
        [x, bfv32.bc32.bconv_exact32(x, px.q_to_r)]) for x in polys])
    np.testing.assert_array_equal(lift, np.asarray(pp._fwd(px.ks, lifted,
                                                           px.t_d)))
    _save("bfv_multech_n1024.npz",
          data_moduli=np.array(qs, dtype=np.uint64),
          special_moduli=np.array(ps, dtype=np.uint64),
          bsk_moduli=np.asarray(ctxs[MulTech.BEHZ].bsk_ntt.q).astype(
              np.uint64),
          t=np.array(t, dtype=np.uint64), sk=u32(sk.data),
          rlk=u32(rlk.data), d1=np.asarray(d1), d2=np.asarray(d2), m1=m1,
          m2=m2, lift=lift, **out)


def bgv_step():
    qs = numth.get_primes(2 * N, 28, K_DATA)
    ps = numth.get_primes(2 * N, 29, ALPHA)
    t = PlainModulus.batching(N, 16).value
    ctx = make_context(EncryptionParameters.create(
        Scheme.BGV, N, qs + ps, plain_modulus=t, special_modulus_size=ALPHA))
    k = jax.random.split(jax.random.PRNGKey(11), 5)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    rlk = keys.gen_relin_key(ctx, sk, k[2])
    enc = BatchEncoder(ctx)
    rg = np.random.default_rng(5)
    pt1, pt2 = (enc.encode(rg.integers(0, t, N, dtype=np.uint64))
                for _ in range(2))
    ct1 = keys.encrypt_asymmetric(ctx, pk, pt1, k[3])
    ct2 = keys.encrypt_asymmetric(ctx, pk, pt2, k[4])
    d1, d2 = u32(ct1.data), u32(ct2.data)
    p = bgv32.build_bgv32(ctx, rlk, use_pallas="mxu-pallas")
    out = np.asarray(bgv32.bgv_mult_relin_modswitch32(p, jnp.asarray(d1),
                                                      jnp.asarray(d2)))
    ref_ct = evaluate.mod_switch_to_next(
        ctx, evaluate.multiply_and_relin(ctx, ct1, ct2, rlk))
    np.testing.assert_array_equal(out, u32(ref_ct.data))
    old = pp.MODUP_VARIANT
    pp.MODUP_VARIANT = "xla-split"
    try:
        split = np.asarray(bgv32.bgv_mult_relin_modswitch32(
            p, jnp.asarray(d1), jnp.asarray(d2)))
    finally:
        pp.MODUP_VARIANT = old
    np.testing.assert_array_equal(split, out)
    cf = int(ref_ct.correction_factor)
    assert cf == pow(qs[-1] % t, -1, t)
    p1, p2 = (np.asarray(x.data).reshape(N).astype(np.int64)
              for x in (pt1, pt2))
    pt_out = np.asarray(keys.decrypt(ctx, sk, ref_ct).data).reshape(N)
    np.testing.assert_array_equal(pt_out, negacyclic_mod_t(p1, p2, t))
    _save("bgv_step_n1024.npz",
          data_moduli=np.array(qs, dtype=np.uint64),
          special_moduli=np.array(ps, dtype=np.uint64),
          t=np.array(t, dtype=np.uint64), cf=np.array(cf, dtype=np.uint64),
          sk=u32(sk.data), rlk=u32(rlk.data), d1=d1, d2=d2, pt1=p1, pt2=p2,
          out=out, pt_out=u32(pt_out))


def bfv_live(n=128):
    qs = numth.get_primes(2 * n, 28, 4)
    ps = numth.get_primes(2 * n, 29, 2)
    t = PlainModulus.batching(n, 16).value
    ctx = make_context(EncryptionParameters.create(
        Scheme.BFV, n, qs + ps, plain_modulus=t, special_modulus_size=2))
    rng = np.random.default_rng(4)
    rlk = np.stack([uniform(rng, qs + ps, (2,), n) for _ in range(2)])
    d1, d2 = (uniform(rng, qs, (2,), n) for _ in range(2))
    p = bfv32.build_bfv32(ctx, keys.RelinKey(data=jnp.asarray(
        rlk.astype(np.uint64))))
    out = np.asarray(jax.jit(bfv32.bfv_mult_relin32)(
        p, jnp.asarray(d1), jnp.asarray(d2)))
    rl = [int(v) for v in np.asarray(ctx.rl_ntt.q)]
    big_ql = 1
    for q in qs:
        big_ql *= q
    sr = {}
    for table, ins, outs in (("d_to_rl", qs + rl, rl), ("decrypt", qs, [t])):
        x = uniform(rng, ins, (), n)
        x[:, 0] = 0
        x[:, 1] = np.array(ins, dtype=np.uint32) - 1
        c = scaleround32.make_exact_scale_round32(ins, t, big_ql, outs)
        sr[f"x_{table}"] = x
        sr[f"sr_{table}"] = np.asarray(jax.jit(
            scaleround32.scale_and_round_exact32)(jnp.asarray(x), c))
    tab = {"mv_d_q": p.mv_d.q, "rl_half_mod_r": p.rl_half_mod_r,
           "rl_half_mod_q": p.rl_half_mod_q, "evk": p.evk,
           "mv_qlp_q": p.ks.mv_qlp.q}
    for name, conv in (("q_to_r", p.q_to_r), ("r_to_q", p.r_to_q)):
        for f in ("qhat_inv", "qhat_inv_shoup", "qhat_mod_p", "q_mod_p"):
            tab[f"{name}_{f}"] = getattr(conv, f)
    for f in ("ihat_inv", "ihat_inv_shoup", "omega_mod_out", "rho"):
        tab[f"sr_to_r_{f}"] = getattr(p.sr_to_r, f)
    _save("bfv_live_n128.npz",
          data_moduli=np.array(qs, dtype=np.uint64),
          special_moduli=np.array(ps, dtype=np.uint64),
          t=np.array(t, dtype=np.uint64), rlk=rlk, d1=d1, d2=d2, out=out,
          rl_moduli=np.array(rl, dtype=np.uint64), **sr,
          **{f"tab_{k}": np.asarray(v) for k, v in tab.items()})


def ntt32_n128(n=128):
    qs = numth.get_primes(2 * n, 28, 3) + numth.get_primes(2 * n, 29, 1)
    j32 = ntt32.tables32_from_tables64(ntt64.tables_from_host(
        make_rns_ntt_tables(n, [Modulus(q) for q in qs])))
    q = np.array(qs, dtype=np.int64)[:, None]
    rng = np.random.default_rng(31)
    arrays = {}
    for lazy in (0, 1):
        x = (rng.integers(0, 1 << 40, (2, 4, n)) % q).astype(np.uint32)
        xi = (rng.integers(0, 1 << 40, (2, 4, n)) % ((1 + lazy) * q)).astype(
            np.uint32)
        arrays[f"x_{lazy}"], arrays[f"xi_{lazy}"] = x, xi
        arrays[f"fwd_{lazy}"] = np.asarray(jax.jit(ntt32.ntt_forward32)(
            x, j32))
        arrays[f"inv_{lazy}"] = np.asarray(jax.jit(ntt32.ntt_inverse32)(
            xi, j32))
    _save("ntt32_n128.npz", moduli=np.array(qs, dtype=np.uint64), **arrays)


# ---------------------------------------------------------------------------
# Fast32
# ---------------------------------------------------------------------------

F32_N = 1024
SCHEMES = {"ckks": Scheme.CKKS, "bfv": Scheme.BFV, "bgv": Scheme.BGV}


def _f32_ctx(scheme, k, alpha, t_bits=16):
    qs = numth.get_primes(2 * F32_N, 28, k)
    ps = numth.get_primes(2 * F32_N, 29, alpha)
    extra = {}
    if scheme != "ckks":
        extra["plain_modulus"] = PlainModulus.batching(F32_N, t_bits).value
    ctx = make_context(EncryptionParameters.create(
        SCHEMES[scheme], F32_N, qs + ps, special_modulus_size=alpha, **extra))
    out = dict(data_moduli=np.array(qs, dtype=np.uint64),
               special_moduli=np.array(ps, dtype=np.uint64),
               t=np.array(extra.get("plain_modulus", 0), dtype=np.uint64))
    return ctx, out


def _ct(out, name, c):
    out[name] = u32(c.data)
    out[name + "__meta"] = np.array([c.chain_index, int(c.is_ntt_form),
                                     int(c.correction_factor),
                                     int(c.noise_scale_deg)], dtype=np.int64)
    out[name + "__scale"] = np.array(c.scale, dtype=np.float64)


def _pt(out, name, p):
    out[name] = u32(p.data)
    out[name + "__meta"] = np.array([p.chain_index, int(p.is_ntt_form)],
                                    dtype=np.int64)
    out[name + "__scale"] = np.array(p.scale, dtype=np.float64)


def _enc_samples(out, name, rng):
    """keys.encrypt_zero_asymmetric's draws from `rng`."""
    k_u, k_e0, k_e1 = jax.random.split(rng, 3)
    out[name + "_u"] = np.asarray(jsmp.sample_ternary_vec(k_u, F32_N))
    out[name + "_e"] = np.stack([np.asarray(jsmp.sample_error_cbd(k, F32_N))
                                 for k in (k_e0, k_e1)])


def _zero_samples(ctx, rng):
    """keys._encrypt_zero_symmetric_ntt's draws: (a (K, N), e (N,))."""
    k_a, k_e = jax.random.split(rng)
    return (u32(jsmp.sample_uniform_rns(k_a, F32_N, ctx.key_mv)),
            np.asarray(jsmp.sample_error_cbd(k_e, F32_N)))


def _kswitch_samples(ctx, rng):
    dnum = -(-ctx.params.size_q // ctx.params.size_p)
    draws = [_zero_samples(ctx, k) for k in jax.random.split(rng, dnum)]
    return np.stack([a for a, _ in draws]), np.stack([e for _, e in draws])


def _keys(out, ctx, sk=None, pk=None, rlk=None, glk=None):
    for name, key in (("sk", sk), ("pk", pk), ("rlk", rlk), ("glk", glk)):
        if key is not None:
            out[name] = u32(key.data)
    if glk is not None:
        out["elts"] = np.array(glk.elts, dtype=np.int64)


def f32_ckks_chain():
    ctx, out = _f32_ctx("ckks", 5, 2)
    k = jax.random.split(jax.random.PRNGKey(41), 5)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    rlk = keys.gen_relin_key(ctx, sk, k[2])
    glk = keys.create_galois_keys(ctx, sk, k[3], steps=[1])
    enc = CKKSEncoder(ctx)
    # at n = 1024 the JAX test's scale of 2^26 leaves noise past 1e-2 on z^4
    # (the rescales take it down to 2^20): half its slots at 2^28
    z = 0.5 * np.random.default_rng(0).standard_normal(enc.slots)
    pt = enc.encode(z, 2.0 ** 28)
    ev = Fast32(ctx, rlk=rlk, glk=glk)
    c = ev.encrypt_asymmetric(pk, pt, k[4])
    _enc_samples(out, "enc", k[4])
    _keys(out, ctx, sk, pk, rlk, glk)
    _pt(out, "pt", pt)
    _ct(out, "ct", c)
    m1 = ev.multiply_and_relin(c, c)
    r1 = ev.rescale_to_next(m1)
    m2 = ev.multiply_and_relin(r1, r1)
    r2 = ev.rescale_to_next(m2)
    rot = ev.rotate(r2, 1)
    for name, x in (("m1", m1), ("r1", r1), ("m2", m2), ("r2", r2),
                    ("rot", rot)):
        _ct(out, name, x)
    dec = ev.decrypt(sk, rot)
    _pt(out, "dec", dec)
    out["z"] = z
    out["decoded"] = enc.decode(dec)
    assert rot.chain_index == 3
    np.testing.assert_allclose(out["decoded"].real, np.roll(z ** 4, -1),
                               atol=1e-2)
    _save("fast32_ckks_chain.npz", **out)


def f32_bgv_chain():
    ctx, out = _f32_ctx("bgv", 4, 1)
    t = ctx.params.plain_modulus
    k = jax.random.split(jax.random.PRNGKey(43), 5)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    rlk = keys.gen_relin_key(ctx, sk, k[2])
    enc = BatchEncoder(ctx)
    rg = np.random.default_rng(6)
    a = rg.integers(0, t, F32_N, dtype=np.uint64)
    b = rg.integers(0, t, F32_N, dtype=np.uint64)
    ev = Fast32(ctx, rlk=rlk)
    pa, pb = enc.encode(a), enc.encode(b)
    ca = ev.encrypt_asymmetric(pk, pa, k[3])
    cb = ev.encrypt_asymmetric(pk, pb, k[4])
    _enc_samples(out, "enca", k[3])
    _enc_samples(out, "encb", k[4])
    _keys(out, ctx, sk, pk, rlk)
    out["a"], out["b"] = a, b
    _pt(out, "pa", pa)
    _pt(out, "pb", pb)
    _ct(out, "ca", ca)
    _ct(out, "cb", cb)
    ms_a = ev.mod_switch_to_next(ca)
    big_a = ev.mod_switch_to_next(ev.multiply_and_relin(ca, cb))
    big_b = ev.multiply_and_relin(ms_a, ev.mod_switch_to_next(cb))
    s = ev.add(big_a, big_b)
    s3 = ev.mod_switch_to_next(s)
    for name, x in (("ms_a", ms_a), ("A", big_a), ("B", big_b), ("s", s),
                    ("s3", s3)):
        _ct(out, name, x)
    dec = ev.decrypt(sk, s3)
    _pt(out, "dec", dec)
    out["slots"] = enc.decode(dec)
    assert s3.chain_index == 3
    expect = (2 * a.astype(object) * b.astype(object)) % t
    np.testing.assert_array_equal(out["slots"].astype(object), expect)
    _save("fast32_bgv_chain.npz", **out)


def _encode(ctx, scheme, rng, scale=2.0 ** 24):
    """(encoder, values, plaintext) as tests/test_fast32.py makes them."""
    if scheme == "ckks":
        enc = CKKSEncoder(ctx)
        vals = rng.standard_normal(enc.slots)
        return enc, vals, enc.encode(vals, scale)
    enc = BatchEncoder(ctx)
    vals = rng.integers(0, ctx.params.plain_modulus, F32_N, dtype=np.uint64)
    return enc, vals, enc.encode(vals)


def f32_encrypt(scheme):
    ctx, out = _f32_ctx(scheme, 3, 1)
    k = jax.random.split(jax.random.PRNGKey(61), 4)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    enc, vals, pt = _encode(ctx, scheme, np.random.default_rng(2))
    ev = Fast32(ctx)
    c = ev.encrypt_asymmetric(pk, pt, k[2])
    ref = keys.encrypt_asymmetric(ctx, pk, pt, k[2])
    np.testing.assert_array_equal(u32(c.data), u32(ref.data))
    _enc_samples(out, "enc", k[2])
    _keys(out, ctx, sk, pk)
    out["vals"] = vals
    _pt(out, "pt", pt)
    _ct(out, "ct", c)
    dec = ev.decrypt(sk, c)
    _pt(out, "dec", dec)
    out["decoded"] = enc.decode(dec)
    _save(f"fast32_encrypt_{scheme}.npz", **out)


def f32_combo():
    ctx, out = _f32_ctx("ckks", 4, 2)
    k = jax.random.split(jax.random.PRNGKey(71), 5)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    glk = keys.create_galois_keys(ctx, sk, k[2], steps=[1, 2])
    enc = CKKSEncoder(ctx)
    scale = 2.0 ** 22
    rg = np.random.default_rng(3)
    z = rg.standard_normal(enc.slots)
    ct = keys.encrypt_asymmetric(ctx, pk, enc.encode(z, scale), k[3])
    steps = [0, 1, 2]
    weights = np.stack([rg.standard_normal(enc.slots) for _ in steps])
    pts = [encode_extended(enc, w, scale, ct.chain_index) for w in weights]
    ev = Fast32(ctx, glk=glk)
    c = ev.from_ciphertext(ct)
    _keys(out, ctx, sk, pk, glk=glk)
    _ct(out, "ct", c)
    out["weights"] = weights
    out["pts"] = np.stack([u32(p) for p in pts])
    _ct(out, "combo", ev.hoisted_linear_combo(c, steps, pts, scale))
    _ct(out, "hoist", ev.hoisting(c, [1, 2]))
    _ct(out, "galois", ev.apply_galois(c, glk.elts[1]))
    _save("fast32_combo.npz", **out)


def f32_verbs(scheme):
    ctx, out = _f32_ctx(scheme, 3, 1)
    k = jax.random.split(jax.random.PRNGKey(73), 6)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    rlk = keys.gen_relin_key(ctx, sk, k[2])
    glk = keys.create_galois_keys(ctx, sk, k[3], steps=[1])
    rng = np.random.default_rng(4)
    _, _, pt = _encode(ctx, scheme, rng)
    _, _, pt2 = _encode(ctx, scheme, rng)
    ev = Fast32(ctx, rlk=rlk, glk=glk)
    c = ev.encrypt_asymmetric(pk, pt, k[4])
    c2 = ev.encrypt_asymmetric(pk, pt2, k[5])
    _keys(out, ctx, sk, pk, rlk, glk)
    _pt(out, "pt2", pt2)
    _ct(out, "c", c)
    _ct(out, "c2", c2)
    c3 = ev.multiply(c, c2)
    mr = ev.multiply_and_relin(c, c2)
    res = dict(add=ev.add(c, c2), sub=ev.sub(c, c2), negate=ev.negate(c),
               add_plain=ev.add_plain(c, pt2), sub_plain=ev.sub_plain(c, pt2),
               multiply_plain=ev.multiply_plain(c, pt2),
               mod_switch=ev.mod_switch_to_next(c), multiply=c3,
               relinearize=ev.relinearize(c3), multiply_and_relin=mr,
               square_and_relin=ev.square_and_relin(c),
               rotate=ev.rotate(c, 1))
    if scheme == "ckks":
        res["rescale"] = ev.rescale_to_next(mr)
    if scheme == "bgv":
        res["add_plain_ms"] = ev.add_plain(res["mod_switch"], pt2)
    for name, x in res.items():
        _ct(out, name, x)
    _pt(out, "dec", ev.decrypt(sk, mr))
    _save(f"fast32_verbs_{scheme}.npz", **out)


def f32_keygen(scheme):
    ctx, out = _f32_ctx(scheme, 4, 2, t_bits=17)
    k = jax.random.split(jax.random.PRNGKey(77), 4)
    ev = Fast32(ctx)
    sk = ev.gen_secret_key(k[0])
    pk = ev.gen_public_key(sk, k[1])
    rlk = ev.gen_relin_key(sk, k[2])
    glk = ev.create_galois_keys(sk, k[3], steps=[1, 2])
    _keys(out, ctx, sk, pk, rlk, glk)
    out["s_tern"] = np.asarray(jsmp.sample_ternary_vec(k[0], F32_N))
    out["pk_a"], out["pk_e"] = _zero_samples(ctx, k[1])
    out["rlk_a"], out["rlk_e"] = _kswitch_samples(ctx, k[2])
    rng, draws = k[3], []
    for _ in glk.elts:
        rng, sub = jax.random.split(rng)
        draws.append(_kswitch_samples(ctx, sub))
    out["glk_a"] = np.stack([a for a, _ in draws])
    out["glk_e"] = np.stack([e for _, e in draws])
    _save(f"fast32_keygen_{scheme}.npz", **out)


FAST32 = {"fast32_ckks_chain": f32_ckks_chain,
          "fast32_bgv_chain": f32_bgv_chain,
          "fast32_combo": f32_combo,
          **{f"fast32_encrypt_{s}": (lambda s=s: f32_encrypt(s))
             for s in SCHEMES},
          **{f"fast32_verbs_{s}": (lambda s=s: f32_verbs(s)) for s in SCHEMES},
          **{f"fast32_keygen_{s}": (lambda s=s: f32_keygen(s))
             for s in ("ckks", "bgv")}}


def main(names):
    names = names or ["ckks_step", "rotate", "step_n128", "bfv_step",
                      "bfv_multech", "bgv_step", "bfv_live", "ntt32_n128", "fast32"]
    if {"ckks_step", "rotate"} & set(names):
        setup = _setup()
        if "ckks_step" in names:
            ckks_step(*setup)
        if "rotate" in names:
            rotate(*setup)
    if "step_n128" in names:
        step_n128(4)
        step_n128(5)
    if "bfv_step" in names:
        bfv_step()
    if "bfv_multech" in names:
        bfv_multech()
    if "bgv_step" in names:
        bgv_step()
    if "bfv_live" in names:
        bfv_live()
    if "ntt32_n128" in names:
        ntt32_n128()
    for name, make in FAST32.items():
        if name in names or "fast32" in names:
            make()


if __name__ == "__main__":
    main(sys.argv[1:])

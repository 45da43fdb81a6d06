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

Run from the repo root (CPU, about four minutes):

    PYTHONPATH=. python tests/fixtures/gen_torch_port_fixtures.py
"""

import os

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from phantom_tpu.host import numth  # noqa: E402
from phantom_tpu.ops import pipeline32 as pp  # noqa: E402
from phantom_tpu.schemes import (CKKSEncoder, EncryptionParameters,  # noqa: E402
                                 Scheme, evaluate, keys, make_context)

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


def main():
    setup = _setup()
    ckks_step(*setup)
    rotate(*setup)
    step_n128(4)
    step_n128(5)


if __name__ == "__main__":
    main()

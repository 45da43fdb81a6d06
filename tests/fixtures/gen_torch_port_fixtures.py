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

roll_n1024.npz: the u32 key-switch paths on the "pallas-roll" engine and
  the xla-bconv moddown (PHANTOM_MODDOWN_VARIANT=xla), at ckks_step's
  chain (n = 1024, five 28-bit data primes, alpha = 2, a short last
  digit) and bgv_step's.  CKKS (ckks_step's keys and encryptions d1, d2):
  roll_step = mult_relin_rescale32 on the roll engine, xla_step = the same
  on the mxu-pallas engine's xla-split modup with the xla-bconv moddown,
  both asserted equal to the u64 evaluator's
  rescale_to_next(multiply_and_relin); roll_modup = modup_from_ntt32 of
  d1[1] and roll_ks = keyswitch_from_ntt32 of d1[1] (relin evk) on the
  roll engine; xla_pair = moddown32_pair of the uniform pair (md0, md1)
  with the xla-bconv moddown, asserted equal to two moddown32 calls.  BGV
  (bgv_step's keys and encryptions bd1, bd2): bgv_roll_step =
  bgv_mult_relin_modswitch32 on the roll engine, asserted equal to the u64
  evaluator's mod_switch_to_next(multiply_and_relin).  Stored beside:
  data_moduli, special_moduli (u64), rlk, bgv_rlk, t.  `fast32_roll`
  also runs the JAX Fast32 on the roll engine over fast32_verbs_ckks and
  fast32_verbs_bgv's cases and asserts every output equal to those
  files (it writes nothing).

u64_{ckks,bgv}_b{50,60}.npz: the u64 generic evaluator (evaluate.py,
  keyswitch.py, keys.py and ops/ntt, bconv, polyops) at n = 1024 on a
  chain of five data primes of 50 (60) bits and two special primes of 51
  (61) bits (alpha = 2, beta = 3 with a short last digit); BGV with t =
  PlainModulus.batching(n, 20).  To keep the files small every output is
  stored as `digest` (sha256 over its shape and u64 words) under
  h__<name>; inputs stay whole.  Inputs: the JAX draws of the keys
  (s_tern; pk_a, pk_e; rlk_a, rlk_e; glk_a, glk_e, for steps (1, 2) and
  conjugation, elts), plaintexts pt1, pt2 of uniform slot values z1, z2
  (CKKS at scale 2^(bits - 10)), the draws of c1 =
  encrypt_asymmetric(pt1) (enc_u, enc_e) and of c2 = encrypt_symmetric(pt2)
  (sym_a, sym_e), combo_pts (CKKS), fs_x (2, N) over P whose columns are
  near a floor boundary (X = 0, 1, 2, P - 1, P - 2, then uniform).
  Digests: the keys (sk, pk, rlk, glk), c1, c2, every verb's output
  (U64_VERBS below, with __meta and __scale whole), and the kernels'
  functions on u64_kernel_inputs (cut from the draws): ntt_fwd, ntt_inv,
  ntt_inv_scaled (over Ql, the modup scale), bc_approx, bc_exact (first
  digit -> complement), fs_y, fs_v (also whole), fs_exact (P -> Ql;
  BGV also fs_exact_t, P -> {t}), ip_out (inner_product_evk), po_mul,
  po_fma, po_tensor, po_square, po_shoup.  The verbs of U64_DECRYPTED
  keep their decryption whole (dec_<verb>), CKKS also decoded
  (decoded_<verb>).

u64_mxn_n1024.npz: tensor_prod_mxn, the product of ciphertexts past size
  2, at n = 1024 over three primes of 50 bits and three of 61 (u64_mxn;
  `u64_mxn` writes only this file).

u64_bfv_{hps,behz,overq,leveled}_b50.npz: BFV through the u64 evaluator
  with mul_tech HPS, BEHZ, HPS_OVERQ and HPS_OVERQ_LEVELED, at
  u64_chain's 50-bit chain (n = 1024, five data primes, two of 51 bits,
  alpha = 2), t = PlainModulus.batching(n, 20).  Stored as u64_chain's:
  the key draws (s_tern, pk_a/pk_e, rlk_a/rlk_e, glk_a/glk_e for steps 1,
  2 and conjugation, elts), pt1, pt2 of uniform slots z1, z2, the draws
  of c1 = encrypt_asymmetric(pt1) and c2 = encrypt_symmetric(pt2), and
  digests of the keys, c1, c2 and every verb of U64_BFV_VERBS (with
  __meta and __scale), each verb's decryption whole (dec_<verb>), the
  noise budgets of c1, c2, the product (mr) and its mod switch, and the
  modules' functions on inputs near a rounding boundary (x_d over D = Ql
  u Rl, x_q over Ql, m_t mod t, BEHZ's x_bsk over Bsk, stored whole):
  scale_and_round_exact D -> Rl (sr_d_to_rl), D -> Ql (sr_d_to_ql), Ql ->
  Rl (sr_ql_to_rl), decrypt_scale_and_round (decrypt_sr, also whole),
  scale_plain_up (plain_up); BEHZ also sm_mrq, fast_floor, fastbconv_sk
  and bsk_moduli; leveled also lev_q_to_ql, lev_q_to_rl (chain index 2)
  and multiply_and_relin chained on its own output (deep2-deep4, each
  with the noise model's drop, <name>__lvl): deep4's operands have
  noise_scale_deg 4, it drops a level, and its decryption over that
  level's primes (dec_deep4_ql) is asserted right before anything is
  written.  `u64_bfv` writes the four, `u64_bfv_<tech>` one (about four
  minutes each).

u64_linear_b50.npz, u64_poly_b50.npz, ckks_fft_wide.npz: the CKKS
  application layer on the u64 evaluator at n = 1024 with 50-bit primes
  (`u64_app` writes the three; `u64_linear`, `u64_poly` and
  `ckks_fft_wide` one each).  u64_linear_b50: three data primes of 50
  bits, two special of 51 (alpha 2: the unfused modup), the key draws as
  u64_chain stores them (Galois keys for LinearTransform.steps_required of
  a d = 8 matrix M with diagonals 4 and 5 zero), x, the draws of ct =
  encrypt_asymmetric of the tiled x at 2^40, digests of the encoded input
  (pt_in), of prepare's QlP weights at the scale q_2 (w_<i>, in group
  order), of ct and of y = LinearTransform.apply(ct) (with __meta and
  __scale), and y's decoded slots (asserted within 1e-3 of M x).
  u64_poly_b50: nine data primes of 50 bits, three special of 51 (alpha
  3), the key draws (no Galois keys), x uniform in (-0.8, 0.8), the draws
  of ct = encrypt_asymmetric(x at 2^50), and digests of ct, y_mono =
  poly_eval of degree 7 (poly_coeffs("dense7")) and y_cheb =
  poly_eval_cheb of degree 13 fitting tanh on the interval (-2, 2), each
  with __meta and __scale; the coefficients stored (coeffs_mono,
  coeffs_cheb), each decoded result asserted within 5e-3 of numpy.
  ckks_fft_wide: the JAX CKKSDeviceEncoder's wide path (primes of 2^30 or
  more: the double-float FFT eager, reduce_i64_centered into the level's
  primes, the u64 NTT; decode by the wide Garner step) on two chains:
  w40 (tests/test_ckks_device_encoder.py's primes at n = 1024: data q0
  of 40 bits and q1 of 30, a special one of 40) at scale 2^30, chain
  index 1; w50 (five data primes of 50 bits, two of 51) at 2^40, chain
  indices 1 and 5 (one limb).  Per case <c>_<ci>: the moduli (moduli_<c>,
  special_<c>), z_<c> (N/2 complex), scale, ints_<c>_<ci> (the rounded
  coefficients, eager), enc_<c>_<ci> (the plaintext, NTT form, u64),
  dec_<c>_<ci> (its decode), and the host CKKSEncoder's decode of it
  (host_<c>_<ci>).

refformat_n1024.npz: the wire formats and the reference's Salsa20
  sampler at n = 1024 (refformat_golden below): the JAX package's salsa20
  samples, its refformat blobs of BFV keys, ciphertexts (a seeded
  symmetric one too) and a plaintext, the sha256 of its serialize blobs,
  and a seeded CKKS ciphertext.

sharded_n1024.npz: the coefficient-sharded functions of
  phantom_tpu/parallel on a (1, 8) ("dp", "coeff") mesh of eight CPU
  devices at n = 1024 (n1 = n2 = 32, four columns a device).  The NTTs:
  u32 over the five 28-bit data primes of ckks_step_n1024.npz (x32,
  ntt32_fwd, ntt32_inv; ntt32_inv_scaled with a uniform scale32 and its
  Shoup words scale32_shoup) and u64 over three 50-bit primes (x64,
  ntt64_fwd, ntt64_inv), each (L, n1, n2).  s32_out:
  sharded_mult_relin_rescale32 on ckks_step_n1024.npz's chain, keys and
  encryptions (s32_d1, s32_d2, s32_rlk; asserted equal to that file's
  out).  u64: five data primes of 50 bits and two special of 51 (alpha
  2), t = PlainModulus.batching(n, 16) for BGV and BFV, uniform operands
  <s>_d1, <s>_d2 (2, 5, N) and a uniform relin key <s>_rlk (3, 2, 7, N)
  for s = ckks, bgv, bfv; outputs ckks_out (sharded_mult_relin_rescale),
  bgv_out (sharded_bgv_mult_relin_modswitch), bfv_out
  (sharded_bfv_mult_relin, coefficient form), each asserted equal to the
  JAX evaluator's local verbs.  Moduli: data_moduli, special_moduli
  (u32 chain), q64 (the NTT's), u64_data, u64_special, t.

limb_n1024.npz: the ("dp", "limb") layout of phantom_tpu/parallel/mesh.py
  (sharded_mul_relin_rescale_step) on make_mesh(8), dp 2 x limb 4 over
  eight CPU devices, at n = 1024 with eight data primes of 50 bits.  Two
  configurations: a4, four special primes of 51 bits (alpha divides
  size_ql: the fused modup), and a3, three (three digits across the
  ranks' blocks of two rows: the unfused modup).  The inputs are
  chip_smoke.limb_inputs of the primes and seed LIMB_SEED + alpha (a
  uniform key (dnum, 2, K, N), two batches of two distinct items (2, 2,
  8, N)); stored per configuration <c>: <c>_special and <c>_out (2, 2,
  7, N), the step's output, each item asserted equal to the JAX
  evaluator's rescale_to_next(multiply_and_relin) first.  data_moduli:
  the eight primes.

benchsetup_n1024.npz: phantom_tpu/utils/benchsetup.setup_bench at n =
  1024, two data primes and two special ones (BENCHSETUP), written to a
  temporary PHANTOM_SETUP_CACHE and read back by benchcache.load_setup:
  for s = ckks (bits 50), bgv and bfv (HPS, bits 28): the cache entry's
  arrays <s>_sk, <s>_pk, <s>_rlk, <s>_pt, <s>_ct1, <s>_ct2 and its
  metadata <s>_meta (JSON), the encoded <s>_values, the primes <s>_data
  and <s>_special, and <s>_t (0 for CKKS).

Run from the repo root (CPU, about four minutes for all; names choose
files, e.g. `bfv_step` writes only bfv_step_n1024.npz, `bfv_multech`
only bfv_multech_n1024.npz):

    PYTHONPATH=. python tests/fixtures/gen_torch_port_fixtures.py [name ...]
"""

import os
import sys

# the sharded file's (1, 8) coeff mesh: eight CPU devices, set before JAX
# starts its backend (as tests/conftest.py does)
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=8").strip()

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

from chip_smoke import rejecting_primes  # noqa: E402

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


def f32_verbs(scheme, use_pallas=False, save=True):
    ctx, out = _f32_ctx(scheme, 3, 1)
    k = jax.random.split(jax.random.PRNGKey(73), 6)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    rlk = keys.gen_relin_key(ctx, sk, k[2])
    glk = keys.create_galois_keys(ctx, sk, k[3], steps=[1])
    rng = np.random.default_rng(4)
    _, _, pt = _encode(ctx, scheme, rng)
    _, _, pt2 = _encode(ctx, scheme, rng)
    ev = Fast32(ctx, rlk=rlk, glk=glk, use_pallas=use_pallas)
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
    if save:
        _save(f"fast32_verbs_{scheme}.npz", **out)
    return out


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


# ---------------------------------------------------------------------------
# the CKKS application path: the double-float FFT, the device encoder, the
# linear transform and polynomial evaluation
# ---------------------------------------------------------------------------

def _planes(x):
    """A complex double-float ((re_hi, re_lo), (im_hi, im_lo)) as (4, N)
    f32."""
    return np.stack([np.asarray(x[0][0]), np.asarray(x[0][1]),
                     np.asarray(x[1][0]), np.asarray(x[1][1])])


def _nested(p):
    return ((jnp.asarray(p[0]), jnp.asarray(p[1])),
            (jnp.asarray(p[2]), jnp.asarray(p[3])))


def ckks_fft():
    """ckks_fft.npz: the JAX package's ops/ckks_fft.py and its
    CKKSDeviceEncoder, eager (op by op) and jitted."""
    from phantom_tpu.ops import ckks_fft as cf
    from phantom_tpu.schemes.ckks_encoder import (CKKSDeviceEncoder,
                                                  _decode_dev32,
                                                  _encode_dev32)
    out = {}
    rng = np.random.default_rng(SEED + 20)
    # the primitives on f32 pairs spanning many exponents
    a, b, c, d = (rng.standard_normal((4, 4096)) * 2.0 ** rng.integers(
        -30, 30, (4, 4096))).astype(np.float32)
    prims = dict(two_sum=cf.two_sum(a, b), quick_two_sum=cf.quick_two_sum(
        a, b), two_prod=cf.two_prod(a, b), df_add=cf.df_add((a, b), (c, d)),
        df_sub=cf.df_sub((a, b), (c, d)), df_mul=cf.df_mul((a, b), (c, d)))
    x, y = ((a, b), (c, d)), ((c, a), (d, b))
    prims.update(cdf_add=sum(cf.cdf_add(x, y), ()),
                 cdf_sub=sum(cf.cdf_sub(x, y), ()),
                 cdf_mul=sum(cf.cdf_mul(x, y), ()))
    out["prim_in"] = np.stack([a, b, c, d])
    for name, r in prims.items():
        out[f"prim_{name}"] = np.stack([np.asarray(v) for v in r])
    for n in (256, 1024):
        t = cf.make_fft_tables(n)
        out[f"fwd_{n}"] = np.stack([np.asarray(getattr(t, f"fwd_{p}"))
                                    for p in ("re_hi", "re_lo", "im_hi",
                                              "im_lo")])
        out[f"inv_{n}"] = np.stack([np.asarray(getattr(t, f"inv_{p}"))
                                    for p in ("re_hi", "re_lo", "im_hi",
                                              "im_lo")])
        out[f"slot_pos_{n}"] = np.asarray(t.slot_pos)
        out[f"slot_conj_{n}"] = np.asarray(t.slot_conj)
        v = rng.standard_normal((2, n)) * 2.0 ** 30
        x = np.stack(cf.df_from_f64(v[0]) + cf.df_from_f64(v[1]))
        out[f"x_{n}"] = x
        for name, f in (("forward", cf.fft_forward),
                        ("inverse", cf.fft_inverse)):
            out[f"{name}_eager_{n}"] = _planes(f(_nested(x), t))
            out[f"{name}_jit_{n}"] = _planes(jax.jit(f)(_nested(x), t))
    # the device encoder at n = 1024 on 28-bit primes, at two levels
    ctx, meta = _f32_ctx("ckks", 5, 2)
    out.update(meta)
    enc = CKKSDeviceEncoder(ctx, engine="xla")
    z = 0.5 * (rng.standard_normal(enc.slots)
               + 1j * rng.standard_normal(enc.slots))
    out["z"] = z
    for ci, bits in ((1, 28), (3, 40)):
        scale = 2.0 ** bits
        pt = enc.encode(z, scale, ci)
        out[f"enc_jit_{ci}"] = u32(pt.data)
        out[f"scale_{ci}"] = np.array(scale)
        t32, mv32, garner = enc._fast_consts(ci)
        re, im = enc._scatter(z, scale)
        with jax.disable_jit():
            coeffs = cf.fft_inverse((re, im), enc.tables)
            hi, lo = coeffs[0]
            ai = jnp.round(hi).astype(jnp.int64)
            bi = jnp.round(lo + (hi - ai.astype(jnp.float32))).astype(
                jnp.int64)
            out[f"ints_eager_{ci}"] = np.asarray(ai + bi)
            out[f"enc_eager_{ci}"] = u32(_encode_dev32(enc.tables, t32, mv32,
                                                       re, im))
            evs = np.asarray(_decode_dev32(
                enc.tables, t32, mv32, garner,
                jnp.asarray(pt.data).astype(jnp.uint32),
                jnp.float32(1.0 / scale)))
        sp = np.asarray(enc.tables.slot_pos)
        out[f"dec_eager_{ci}"] = (evs[0][sp].astype(np.float64)
                                  + evs[1][sp].astype(np.float64)) + 1j * (
            evs[2][sp].astype(np.float64) + evs[3][sp].astype(np.float64))
        out[f"dec_jit_{ci}"] = enc.decode(pt)
        np.testing.assert_allclose(out[f"dec_jit_{ci}"], z, atol=1e-6)
    _save("ckks_fft.npz", **out)


def linear():
    """linear_n1024.npz: a BSGS LinearTransform on the JAX Fast32, after
    tests/test_linear.py (n = 1024, four 28-bit primes, one special)."""
    from phantom_tpu.schemes import LinearTransform
    qs = numth.get_primes(2 * F32_N, 28, 4)
    ctx = make_context(EncryptionParameters.create(
        Scheme.CKKS, F32_N, qs, special_modulus_size=1))
    out = dict(data_moduli=np.array(qs[:3], dtype=np.uint64),
               special_moduli=np.array(qs[3:], dtype=np.uint64),
               t=np.array(0, dtype=np.uint64))
    k_sk, k_pk, k_glk, k_enc = jax.random.split(jax.random.PRNGKey(81), 4)
    sk = keys.gen_secret_key(ctx, k_sk)
    pk = keys.gen_public_key(ctx, sk, k_pk)
    enc = CKKSEncoder(ctx)
    rng = np.random.default_rng(5)
    d = 8
    M = rng.standard_normal((d, d)) * 0.3
    idx = np.arange(d)
    M[idx, (idx + 4) % d] = 0.0             # diagonals 4 and 5 skipped
    M[idx, (idx + 5) % d] = 0.0
    x = rng.standard_normal(d) * 0.3
    lt = LinearTransform(M)
    glk = keys.create_galois_keys(ctx, sk, k_glk, steps=lt.steps_required())
    scale = 2.0 ** 26
    lt.prepare(enc, scale)
    ct = keys.encrypt_asymmetric(ctx, pk, lt.encode_input(enc, x, scale),
                                 k_enc)
    ev = Fast32(ctx, glk=glk)
    y = lt.apply_fast32(ev, ev.from_ciphertext(ct))
    got = enc.decode(keys.decrypt(ctx, sk, ev.to_ciphertext(y))).real[:d]
    np.testing.assert_allclose(got, M @ x, atol=1e-3)
    _keys(out, ctx, sk, pk, glk=glk)
    out["M"], out["x"], out["scale"] = M, x, np.array(scale)
    out["pts"] = np.stack([u32(p) for grp in lt._prepared[1] for p in grp])
    _ct(out, "ct", ev.from_ciphertext(ct))
    _ct(out, "y", y)
    _save("linear_n1024.npz", **out)


POLY_CASES = {  # name: (basis, coefficients' seed, degree, kind, interval)
    "dense7": ("monomial", 1, 7, "dense", None),
    "sparse": ("monomial", 2, 9, "sparse", None),
    "odd": ("monomial", 3, 7, "odd", None),
    "cheb": ("chebyshev", 4, 13, "dense", None),
    "cheb_interval": ("chebyshev", 5, 11, "sine", (-2.0, 2.0)),
}


def poly_coeffs(case):
    """The case's coefficients (chip_smoke and the tests make the same)."""
    from phantom_tpu.schemes.poly import chebyshev_fit
    basis, seed, deg, kind, interval = POLY_CASES[case]
    r = np.random.default_rng(seed)
    if kind == "sine":
        return chebyshev_fit(lambda v: np.sin(2 * v) / 2, deg, interval)
    c = r.uniform(-0.3, 0.3, deg + 1)
    if kind == "sparse":
        c[[2, 3, 5, 6, 8]] = 0.0
    if kind == "odd":
        c[::2] = 0.0
    return c


def poly():
    """poly_n1024.npz: poly_eval_fast32 and poly_eval_cheb_fast32 on the
    JAX Fast32, after tests/test_poly.py (n = 1024, nine 28-bit data
    primes; three special primes, so the relin key has three digits)."""
    from phantom_tpu.schemes.poly import (poly_eval_cheb_fast32,
                                          poly_eval_fast32)
    qs = numth.get_primes(2 * F32_N, 28, 12)
    ctx = make_context(EncryptionParameters.create(
        Scheme.CKKS, F32_N, qs, special_modulus_size=3))
    out = dict(data_moduli=np.array(qs[:9], dtype=np.uint64),
               special_moduli=np.array(qs[9:], dtype=np.uint64),
               t=np.array(0, dtype=np.uint64))
    k = jax.random.split(jax.random.PRNGKey(83), 4)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    rlk = keys.gen_relin_key(ctx, sk, k[2])
    enc = CKKSEncoder(ctx)
    scale = 2.0 ** 28
    x = np.random.default_rng(6).uniform(-0.8, 0.8, enc.slots)
    ct = keys.encrypt_asymmetric(ctx, pk, enc.encode(x, scale), k[3])
    ev = Fast32(ctx, rlk=rlk)
    c = ev.from_ciphertext(ct)
    _keys(out, ctx, sk, pk, rlk)
    out["x"] = x
    _ct(out, "ct", c)
    for case, (basis, _, _, _, interval) in POLY_CASES.items():
        cc = poly_coeffs(case)
        if basis == "monomial":
            y = poly_eval_fast32(ev, c, cc, enc)
            want = np.polyval(cc[::-1], x)
        else:
            y = poly_eval_cheb_fast32(ev, c, cc, enc, interval=interval)
            a, b = interval or (-1.0, 1.0)
            want = np.polynomial.chebyshev.chebval(
                (2 * x - (a + b)) / (b - a), cc)
        got = enc.decode(keys.decrypt(ctx, sk, ev.to_ciphertext(
            ev.rescale_to_next(y)))).real
        np.testing.assert_allclose(got, want, atol=5e-3)
        out[f"coeffs_{case}"] = cc
        _ct(out, f"y_{case}", y)
    _save("poly_n1024.npz", **out)


# ---------------------------------------------------------------------------
# the u32 key switch on "pallas-roll" and the xla-bconv moddown
# ---------------------------------------------------------------------------

def roll():
    qs, ps, ctx, sk, rlk, ct1, ct2 = _setup()
    ref = u32(evaluate.rescale_to_next(
        ctx, evaluate.multiply_and_relin(ctx, ct1, ct2, rlk)).data)
    d1, d2 = u32(ct1.data), u32(ct2.data)
    j1, j2 = jnp.asarray(d1), jnp.asarray(d2)
    pr = pp.build_pipeline32(ctx, rlk, use_pallas="pallas-roll")
    ksr = pr.ks
    out = dict(roll_step=np.asarray(pp.mult_relin_rescale32(pr, j1, j2)),
               roll_modup=np.asarray(pp.modup_from_ntt32(ksr, j1[1])),
               roll_ks=np.asarray(pp.keyswitch_from_ntt32(ksr, j1[1],
                                                          pr.evk)))
    np.testing.assert_array_equal(out["roll_step"], ref)
    rng = np.random.default_rng(SEED + 5)
    md = uniform(rng, list(qs) + list(ps), (2,), N)
    old = pp.MODUP_VARIANT, pp.MODDOWN_VARIANT
    pp.MODUP_VARIANT, pp.MODDOWN_VARIANT = "xla-split", "xla"
    try:
        px = pp.build_pipeline32(ctx, rlk, use_pallas="mxu-pallas")
        out["xla_step"] = np.asarray(pp.mult_relin_rescale32(px, j1, j2))
        pair = pp.moddown32_pair(px.ks, jnp.asarray(md[0]),
                                 jnp.asarray(md[1]))
        out["xla_pair"] = np.stack([np.asarray(x) for x in pair])
    finally:
        pp.MODUP_VARIANT, pp.MODDOWN_VARIANT = old
    np.testing.assert_array_equal(out["xla_step"], ref)
    single = np.stack([np.asarray(pp.moddown32(px.ks, jnp.asarray(x)))
                       for x in md])
    np.testing.assert_array_equal(out["xla_pair"], single)
    # BGV at bgv_step's parameters
    t = PlainModulus.batching(N, 16).value
    bctx = make_context(EncryptionParameters.create(
        Scheme.BGV, N, qs + ps, plain_modulus=t, special_modulus_size=ALPHA))
    k = jax.random.split(jax.random.PRNGKey(11), 5)
    bsk = keys.gen_secret_key(bctx, k[0])
    bpk = keys.gen_public_key(bctx, bsk, k[1])
    brlk = keys.gen_relin_key(bctx, bsk, k[2])
    benc = BatchEncoder(bctx)
    rg = np.random.default_rng(5)
    bpt = [benc.encode(rg.integers(0, t, N, dtype=np.uint64))
           for _ in range(2)]
    bc1 = keys.encrypt_asymmetric(bctx, bpk, bpt[0], k[3])
    bc2 = keys.encrypt_asymmetric(bctx, bpk, bpt[1], k[4])
    pb = bgv32.build_bgv32(bctx, brlk, use_pallas="pallas-roll")
    out["bgv_roll_step"] = np.asarray(bgv32.bgv_mult_relin_modswitch32(
        pb, jnp.asarray(u32(bc1.data)), jnp.asarray(u32(bc2.data))))
    np.testing.assert_array_equal(out["bgv_roll_step"], u32(
        evaluate.mod_switch_to_next(
            bctx, evaluate.multiply_and_relin(bctx, bc1, bc2, brlk)).data))
    _save("roll_n1024.npz", data_moduli=np.array(qs, dtype=np.uint64),
          special_moduli=np.array(ps, dtype=np.uint64),
          t=np.array(t, dtype=np.uint64), rlk=u32(rlk.data), d1=d1, d2=d2,
          md=md, bgv_rlk=u32(brlk.data), bd1=u32(bc1.data),
          bd2=u32(bc2.data), **out)


def fast32_roll():
    """The JAX Fast32 on "pallas-roll" reproduces fast32_verbs_{ckks,bgv}
    (which the default engine made)."""
    for scheme in ("ckks", "bgv"):
        ref = np.load(os.path.join(DIR, f"fast32_verbs_{scheme}.npz"))
        got = f32_verbs(scheme, use_pallas="pallas-roll", save=False)
        for name, v in got.items():
            np.testing.assert_array_equal(v, ref[name], err_msg=name)
        print(f"fast32 {scheme} verbs on pallas-roll: {len(got)} arrays "
              "equal to the file")


# ---------------------------------------------------------------------------
# the u64 generic evaluator
# ---------------------------------------------------------------------------

U64_T_BITS = 20


def digest(a) -> np.ndarray:
    """sha256 over an array's shape and u64 words, (32,) uint8: the u64
    files keep outputs as digests (the port's tests and chip_smoke.py
    compute the same of theirs)."""
    import hashlib
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint64))
    h = hashlib.sha256(repr(a.shape).encode() + a.tobytes())
    return np.frombuffer(h.digest(), dtype=np.uint8).copy()


def _ct64(out, name, c):
    out["h__" + name] = digest(c.data)
    out[name + "__meta"] = np.array([c.chain_index, int(c.is_ntt_form),
                                     int(c.correction_factor),
                                     int(c.noise_scale_deg)], dtype=np.int64)
    out[name + "__scale"] = np.array(c.scale, dtype=np.float64)


def _pt64(out, name, p, keep=False):
    if keep:
        out[name] = np.asarray(p.data).astype(np.uint64)
    else:
        out["h__" + name] = digest(p.data)
    out[name + "__meta"] = np.array([p.chain_index, int(p.is_ntt_form)],
                                    dtype=np.int64)
    out[name + "__scale"] = np.array(p.scale, dtype=np.float64)


def _zero_samples64(ctx, rng, mv=None):
    k_a, k_e = jax.random.split(rng)
    mv = ctx.key_mv if mv is None else mv
    return (np.asarray(jsmp.sample_uniform_rns(k_a, N, mv)),
            np.asarray(jsmp.sample_error_cbd(k_e, N)).astype(np.int8))


def _kswitch_samples64(ctx, rng):
    dnum = -(-ctx.params.size_q // ctx.params.size_p)
    draws = [_zero_samples64(ctx, k) for k in jax.random.split(rng, dnum)]
    return np.stack([a for a, _ in draws]), np.stack([e for _, e in draws])


def _near_boundary(rng, moduli, n):
    """(len(moduli), n) residues of X = 0, 1, 2, P - 1, P - 2 (P the
    product), then uniform X."""
    big_p = 1
    for q in moduli:
        big_p *= q
    xs = [0, 1, 2, big_p - 1, big_p - 2]
    xs += [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62))
           % big_p for _ in range(n - len(xs))]
    return np.array([[x % q for x in xs] for q in moduli], dtype=np.uint64)


def u64_kernel_inputs(d, k):
    """The u64 kernels' uniform inputs, cut from a u64 file's stored draws
    (d: its arrays; k: the data primes at chain index 1).  chip_smoke.py
    keeps a copy (it reads no JAX)."""
    rlk_a, glk_a, pk_a = d["rlk_a"], d["glk_a"], d["pk_a"]
    return dict(
        ntt_x=rlk_a[:2], ntt_xi=rlk_a[:2] + glk_a[0, :2],
        bc_x=pk_a[:2], ip_t=rlk_a,
        ip_evk=np.ascontiguousarray(glk_a[:2].transpose(1, 0, 2, 3)),
        po_a=rlk_a[:2, :k], po_b=rlk_a[1:3, :k], po_c=glk_a[2, :2, :k],
        po_w=rlk_a[0, :k, 0])


def _kernel_outputs(ctx, out):
    """Digests of the u64 kernels' functions on u64_kernel_inputs."""
    from phantom_tpu.ops import bconv as bc
    from phantom_tpu.ops import polyops as po
    from phantom_tpu.schemes import keyswitch as ksw
    cd = ctx.get_context_data(1)
    ks = cd.ks
    k = cd.size_ql
    inp = {n: jnp.asarray(v) for n, v in u64_kernel_inputs(out, k).items()}
    res = dict(
        ntt_fwd=ntt64.ntt_forward(inp["ntt_x"], ctx.ntt),
        ntt_inv=ntt64.ntt_inverse(inp["ntt_xi"], ctx.ntt),
        ntt_inv_scaled=ntt64.ntt_inverse(
            inp["ntt_xi"][:, :k], ctx.tables_q(k), scale=ks.modup_scale,
            scale_shoup=ks.modup_scale_shoup),
        bc_approx=bc.bconv_approx(inp["bc_x"], ks.digit_convs[0]),
        bc_exact=bc.bconv_exact(inp["bc_x"], ks.digit_convs[0]),
        ip_out=ksw.inner_product_evk(inp["ip_t"], inp["ip_evk"], cd))
    x = jnp.asarray(out["fs_x"])
    y = bc.scale_by_qhat_inv(x, ks.p_to_q)
    res["fs_y"] = y
    res["fs_v"] = bc.floor_sum_div(y, ks.p_to_q)
    res["fs_exact"] = bc.bconv_exact(x, ks.p_to_q)
    if ks.p_to_t is not None:
        res["fs_exact_t"] = bc.bconv_exact(x, ks.p_to_t)
    a, b, c = inp["po_a"], inp["po_b"], inp["po_c"]
    mv = cd.mv
    res.update(po_mul=po.mul_rns(a, b, mv), po_fma=po.fma_rns(a, b, c, mv),
               po_tensor=po.tensor_prod_2x2(a, b, mv),
               po_square=po.tensor_square_2x2(a, mv))
    w = out["rlk_a"][0, :k, 0]
    ws = np.array([(int(v) << 64) // int(q) for v, q in zip(
        w, ctx.params.data_moduli[:k])], dtype=np.uint64)
    res["po_shoup"] = po.scalar_mul_rns(a, jnp.asarray(w), jnp.asarray(ws),
                                        mv)
    out["fs_v"] = np.asarray(res["fs_v"])
    for name, v in res.items():
        out["h__" + name] = digest(v)


U64_VERBS = {
    "ckks": ("negate", "add", "sub", "add_plain", "sub_plain",
             "multiply_plain", "multiply", "square", "relinearize",
             "multiply_and_relin", "rescale", "mod_switch", "mod_switch_to",
             "rotate1", "rotate2", "conjugate", "hoisting", "combo",
             "add_many", "keyswitch_coeff"),
    "bgv": ("negate", "add", "sub", "add_plain", "sub_plain",
            "multiply_plain", "multiply", "square", "relinearize",
            "multiply_and_relin", "mod_switch", "mod_switch_to",
            "balanced_add", "rotate_rows", "rotate_columns", "hoisting",
            "add_many", "add_plain_ms"),
}
# verbs whose decryption (and CKKS decoding) the files keep whole
U64_DECRYPTED = ("multiply_and_relin", "mod_switch", "rotate1",
                 "rotate_rows", "rescale", "balanced_add")


def u64_chain(scheme, bits):
    from phantom_tpu.schemes import galois as jgal
    from phantom_tpu.schemes import keyswitch as ksw
    qs = numth.get_primes(2 * N, bits, K_DATA)
    ps = numth.get_primes(2 * N, bits + 1, ALPHA)
    extra = {}
    if scheme == "bgv":
        extra["plain_modulus"] = PlainModulus.batching(N, U64_T_BITS).value
    ctx = make_context(EncryptionParameters.create(
        SCHEMES[scheme], N, qs + ps, special_modulus_size=ALPHA, **extra))
    t = extra.get("plain_modulus", 0)
    out = dict(data_moduli=np.array(qs, dtype=np.uint64),
               special_moduli=np.array(ps, dtype=np.uint64),
               t=np.array(t, dtype=np.uint64))
    k = jax.random.split(jax.random.PRNGKey(bits * 7 + len(scheme)), 6)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    rlk = keys.gen_relin_key(ctx, sk, k[2])
    elts = jgal.get_elts_from_steps([1, 2], N) + [2 * N - 1]
    glk = keys.create_galois_keys(ctx, sk, k[3], elts=elts)
    for name, key in (("sk", sk), ("pk", pk), ("rlk", rlk), ("glk", glk)):
        out["h__" + name] = digest(key.data)
    out["elts"] = np.array(glk.elts, dtype=np.int64)
    out["s_tern"] = np.asarray(jsmp.sample_ternary_vec(k[0], N)).astype(
        np.int8)
    out["pk_a"], out["pk_e"] = _zero_samples64(ctx, k[1])
    out["rlk_a"], out["rlk_e"] = _kswitch_samples64(ctx, k[2])
    rng, draws = k[3], []
    for _ in glk.elts:
        rng, sub = jax.random.split(rng)
        draws.append(_kswitch_samples64(ctx, sub))
    out["glk_a"] = np.stack([a for a, _ in draws])
    out["glk_e"] = np.stack([e for _, e in draws])
    rg = np.random.default_rng(bits)
    scale = 2.0 ** (bits - 10)
    if scheme == "ckks":
        enc = CKKSEncoder(ctx)
        vals = [rg.standard_normal(enc.slots) + 1j * rg.standard_normal(
            enc.slots) for _ in range(2)]
        pts = [enc.encode(v, scale) for v in vals]
    else:
        enc = BatchEncoder(ctx)
        vals = [rg.integers(0, t, N, dtype=np.uint64) for _ in range(2)]
        pts = [enc.encode(v) for v in vals]
    out["z1"], out["z2"] = vals
    _pt64(out, "pt1", pts[0], keep=True)
    _pt64(out, "pt2", pts[1], keep=True)
    c1 = keys.encrypt_asymmetric(ctx, pk, pts[0], k[4])
    k_u, k_e0, k_e1 = jax.random.split(k[4], 3)
    out["enc_u"] = np.asarray(jsmp.sample_ternary_vec(k_u, N)).astype(
        np.int8)
    out["enc_e"] = np.stack([np.asarray(jsmp.sample_error_cbd(x, N))
                             for x in (k_e0, k_e1)]).astype(np.int8)
    c2 = keys.encrypt_symmetric(ctx, sk, pts[1], k[5])
    out["sym_a"], out["sym_e"] = _zero_samples64(
        ctx, k[5], ctx.get_context_data(c2.chain_index).mv)
    _ct64(out, "c1", c1)
    _ct64(out, "c2", c2)
    ev = evaluate
    mul = ev.multiply(ctx, c1, c2)
    mr = ev.multiply_and_relin(ctx, c1, c2, rlk)
    res = dict(negate=ev.negate(ctx, c1), add=ev.add(ctx, c1, c2),
               sub=ev.sub(ctx, c1, c2),
               add_plain=ev.add_plain(ctx, c1, pts[1]),
               sub_plain=ev.sub_plain(ctx, c1, pts[1]),
               multiply_plain=ev.multiply_plain(ctx, c1, pts[1]),
               multiply=mul, square=ev.square(ctx, c1),
               relinearize=ev.relinearize(ctx, mul, rlk),
               multiply_and_relin=mr,
               mod_switch=ev.mod_switch_to_next(ctx, mr),
               mod_switch_to=ev.mod_switch_to(ctx, c1, 3),
               hoisting=ev.hoisting(ctx, c1, glk, [1, 2]),
               add_many=ev.add_many(ctx, [c1, c2, c1]))
    if scheme == "ckks":
        res["rescale"] = ev.rescale_to_next(ctx, mr)
        res["rotate1"] = ev.rotate_vector(ctx, c1, 1, glk)
        res["rotate2"] = ev.rotate_vector(ctx, c1, 2, glk)
        res["conjugate"] = ev.complex_conjugate(ctx, c1, glk)
        weights = [rg.standard_normal(enc.slots) for _ in range(3)]
        pts_qlp = [encode_extended(enc, w, 2.0 ** 20, 1) for w in weights]
        out["combo_pts"] = np.stack([np.asarray(x) for x in pts_qlp])
        res["combo"] = ev.hoisted_linear_combo(ctx, c1, glk, [0, 1, 2],
                                               pts_qlp, 2.0 ** 20)
        cd = ctx.get_context_data(1)
        c2_coeff = ntt64.ntt_inverse(c1.data[1], ctx.tables_q(cd.size_ql))
        res["keyswitch_coeff"] = c1.replace(data=ksw.keyswitch(
            ctx, cd, c2_coeff, rlk.data), is_ntt_form=True)
    else:
        ms1 = ev.mod_switch_to_next(ctx, c1)
        prod = ev.multiply_and_relin(ctx, ms1, ev.mod_switch_to_next(ctx, c2),
                                     rlk)
        assert prod.correction_factor != ms1.correction_factor
        res["balanced_add"] = ev.add(ctx, prod, ms1)
        res["rotate_rows"] = ev.rotate_rows(ctx, c1, 1, glk)
        res["rotate_columns"] = ev.rotate_columns(ctx, c1, glk)
        res["add_plain_ms"] = ev.add_plain(ctx, ms1, pts[1])
    assert set(res) == set(U64_VERBS[scheme]), set(res) ^ set(
        U64_VERBS[scheme])
    for name, c in res.items():
        _ct64(out, name, c)
        if name in U64_DECRYPTED:
            dec = keys.decrypt(ctx, sk, c)
            _pt64(out, "dec_" + name, dec, keep=True)
            if scheme == "ckks":
                out["decoded_" + name] = enc.decode(dec)
    if scheme == "ckks":
        np.testing.assert_allclose(out["decoded_rescale"], vals[0] * vals[1],
                                   atol=1e-2)
    else:
        got = np.asarray(enc.decode(keys.decrypt(ctx, sk, mr)))
        want = vals[0].astype(object) * vals[1].astype(object) % t
        np.testing.assert_array_equal(got.astype(object), want)
    out["fs_x"] = _near_boundary(np.random.default_rng(bits),
                                 ctx.params.special_moduli, N)
    _kernel_outputs(ctx, out)
    _save(f"u64_{scheme}_b{bits}.npz", **out)


U64_FILES = {f"u64_{s}_b{b}": (lambda s=s, b=b: u64_chain(s, b))
             for s in ("ckks", "bgv") for b in (50, 60)}
# the (m, n) pairs of u64_mxn_n1024.npz
MXN_CASES = ((3, 2), (3, 3), (2, 3), (1, 2))


def u64_mxn():
    """tensor_prod_mxn of ciphertexts past size 2 (phantom_tpu/ops/
    polyops.py:84) at n = 1024 over three primes of 50 bits and three of
    61: per chain `b`, the inputs ct1_b<b>, ct2_b<b> (3, 3, N) uniform
    (columns 0-3 all q - 1) and moduli_b<b> whole, the products of
    ct1[:m] and ct2[:n] as digests under h__mxn<m><n>_b<b>."""
    from phantom_tpu.ops import polyops as po
    from phantom_tpu.ops.rns_host import modulus_vec
    rng = np.random.default_rng(SEED + 64)
    out = {}
    for bits in (50, 61):
        qs = numth.get_primes(2 * N, bits, 3)
        q = np.array(qs, dtype=np.uint64)[:, None]
        cts = []
        for _ in range(2):
            x = rng.integers(0, 1 << 63, (3, 3, N), dtype=np.uint64) % q
            x[:, :, :4] = q - 1
            cts.append(x)
        out[f"moduli_b{bits}"] = q[:, 0]
        out[f"ct1_b{bits}"], out[f"ct2_b{bits}"] = cts
        mv = modulus_vec(qs)
        for m, n in MXN_CASES:
            got = po.tensor_prod_mxn(jnp.asarray(cts[0][:m]),
                                     jnp.asarray(cts[1][:n]), mv)
            out[f"h__mxn{m}{n}_b{bits}"] = digest(got)
    _save("u64_mxn_n1024.npz", **out)


# BFV on the u64 evaluator: the files' techniques and verbs
U64_BFV_TECHS = {"hps": "HPS", "behz": "BEHZ", "overq": "HPS_OVERQ",
                 "leveled": "HPS_OVERQ_LEVELED"}
U64_BFV_VERBS = ("negate", "add", "sub", "add_plain", "sub_plain",
                 "multiply_plain", "multiply", "square", "relinearize",
                 "multiply_and_relin", "mod_switch", "rotate_rows",
                 "rotate_columns", "hoisting")
# leveled: multiply_and_relin chained on its own output; the last product
# takes operands of noise_scale_deg 4, where the noise model drops a level
U64_BFV_DEEP = ("deep2", "deep3", "deep4")


def u64_bfv(tech):
    """BFV through the u64 evaluator with mul_tech `tech` (u64_chain's
    primes at 50 bits: five data primes, two of 51 bits, alpha = 2, t =
    PlainModulus.batching(n, 20))."""
    from phantom_tpu.host import noise as noise_mod
    from phantom_tpu.ops import behz as jbz
    from phantom_tpu.ops import scaleround as jsr
    from phantom_tpu.schemes import MulTech
    from phantom_tpu.schemes import galois as jgal
    bits = 50
    qs = numth.get_primes(2 * N, bits, K_DATA)
    ps = numth.get_primes(2 * N, bits + 1, ALPHA)
    t = PlainModulus.batching(N, U64_T_BITS).value
    ctx = make_context(EncryptionParameters.create(
        Scheme.BFV, N, qs + ps, plain_modulus=t, special_modulus_size=ALPHA,
        mul_tech=getattr(MulTech, U64_BFV_TECHS[tech])))
    out = dict(data_moduli=np.array(qs, dtype=np.uint64),
               special_moduli=np.array(ps, dtype=np.uint64),
               t=np.array(t, dtype=np.uint64))
    k = jax.random.split(jax.random.PRNGKey(bits * 7 + 3), 6)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    rlk = keys.gen_relin_key(ctx, sk, k[2])
    elts = jgal.get_elts_from_steps([1, 2], N) + [2 * N - 1]
    glk = keys.create_galois_keys(ctx, sk, k[3], elts=elts)
    for name, key in (("sk", sk), ("pk", pk), ("rlk", rlk), ("glk", glk)):
        out["h__" + name] = digest(key.data)
    out["elts"] = np.array(glk.elts, dtype=np.int64)
    out["s_tern"] = np.asarray(jsmp.sample_ternary_vec(k[0], N)).astype(
        np.int8)
    out["pk_a"], out["pk_e"] = _zero_samples64(ctx, k[1])
    out["rlk_a"], out["rlk_e"] = _kswitch_samples64(ctx, k[2])
    rng, draws = k[3], []
    for _ in glk.elts:
        rng, sub = jax.random.split(rng)
        draws.append(_kswitch_samples64(ctx, sub))
    out["glk_a"] = np.stack([a for a, _ in draws])
    out["glk_e"] = np.stack([e for _, e in draws])
    rg = np.random.default_rng(bits + 17)
    enc = BatchEncoder(ctx)
    vals = [rg.integers(0, t, N, dtype=np.uint64) for _ in range(2)]
    pts = [enc.encode(v) for v in vals]
    out["z1"], out["z2"] = vals
    _pt64(out, "pt1", pts[0], keep=True)
    _pt64(out, "pt2", pts[1], keep=True)
    c1 = keys.encrypt_asymmetric(ctx, pk, pts[0], k[4])
    k_u, k_e0, k_e1 = jax.random.split(k[4], 3)
    out["enc_u"] = np.asarray(jsmp.sample_ternary_vec(k_u, N)).astype(
        np.int8)
    out["enc_e"] = np.stack([np.asarray(jsmp.sample_error_cbd(x, N))
                             for x in (k_e0, k_e1)]).astype(np.int8)
    c2 = keys.encrypt_symmetric(ctx, sk, pts[1], k[5])
    out["sym_a"], out["sym_e"] = _zero_samples64(
        ctx, k[5], ctx.get_context_data(1).mv)
    _ct64(out, "c1", c1)
    _ct64(out, "c2", c2)
    ev = evaluate
    mul = ev.multiply(ctx, c1, c2)
    mr = ev.multiply_and_relin(ctx, c1, c2, rlk)
    res = dict(negate=ev.negate(ctx, c1), add=ev.add(ctx, c1, c2),
               sub=ev.sub(ctx, c1, c2),
               add_plain=ev.add_plain(ctx, c1, pts[1]),
               sub_plain=ev.sub_plain(ctx, c1, pts[1]),
               multiply_plain=ev.multiply_plain(ctx, c1, pts[1]),
               multiply=mul, square=ev.square(ctx, c1),
               relinearize=ev.relinearize(ctx, mul, rlk),
               multiply_and_relin=mr,
               mod_switch=ev.mod_switch_to_next(ctx, mr),
               rotate_rows=ev.rotate_rows(ctx, c1, 1, glk),
               rotate_columns=ev.rotate_columns(ctx, c1, glk),
               hoisting=ev.hoisting(ctx, c1, glk, [1, 2]))
    z1, z2 = (v.astype(object) for v in vals)
    want = {"multiply": z1 * z2 % t, "multiply_and_relin": z1 * z2 % t,
            "square": z1 * z1 % t, "add": (z1 + z2) % t}
    if tech == "leveled":
        d = mr
        for name in U64_BFV_DEEP:
            nsd = d.noise_scale_deg
            lvl = noise_mod.find_levels_to_drop(
                N, K_DATA, ALPHA, len(ctx.get_context_data(1).ks.digit_convs),
                t, bits, nsd - 1, False, True)
            out[name + "__lvl"] = np.array(lvl)
            d = res[name] = ev.multiply_and_relin(ctx, d, d, rlk)
        lvl = int(out["deep4__lvl"])
        assert lvl > 0, "no level dropped"
        # the product of a drop carries its level's Delta: it decrypts over
        # that level's primes (the first K_DATA - lvl rows), not over Q
        low = d.replace(data=d.data[:, :K_DATA - lvl], chain_index=1 + lvl)
        dec = keys.decrypt(ctx, sk, low)
        _pt64(out, "dec_deep4_ql", dec, keep=True)
        got = np.asarray(enc.decode(dec)).astype(object)
        assert (got == (z1 * z2 % t) ** 8 % t).all(), "deep4 decrypts wrong"
    for name, c in res.items():
        _ct64(out, name, c)
        dec = keys.decrypt(ctx, sk, c)
        _pt64(out, "dec_" + name, dec, keep=True)
        if name in want:
            got = np.asarray(enc.decode(dec)).astype(object)
            assert (got == want[name]).all(), f"{tech}: {name} decrypts wrong"
    for name, c in (("c1", c1), ("c2", c2), ("mr", mr), ("mod_switch",
                                                        res["mod_switch"])):
        out["budget_" + name] = np.array(keys.invariant_noise_budget(
            ctx, sk, c))
    # the modules' functions on seeded inputs (near a rounding boundary
    # first, as _near_boundary makes them), digests of their outputs
    cd = ctx.get_context_data(1)
    hps = cd.hps
    d_moduli = list(cd.moduli) + list(
        np.asarray(hps.sr_to_r.obase.q).tolist())
    rng = np.random.default_rng(bits + 29)
    out["x_d"] = _near_boundary(rng, d_moduli, N)
    out["x_q"] = _near_boundary(rng, cd.moduli, N)
    out["m_t"] = rng.integers(0, t, N, dtype=np.uint64)
    x_d, x_q = jnp.asarray(out["x_d"]), jnp.asarray(out["x_q"])
    fns = dict(sr_d_to_rl=jsr.scale_and_round_exact(x_d, hps.sr_to_r),
               sr_d_to_ql=jsr.scale_and_round_exact(x_d, hps.sr_final_overq),
               sr_ql_to_rl=jsr.scale_and_round_exact(x_q, hps.sr_ql_to_rl),
               decrypt_sr=jsr.decrypt_scale_and_round(x_q, cd.decrypt_sr),
               plain_up=jsr.scale_plain_up(jnp.asarray(out["m_t"]),
                                           cd.plain_lift))
    out["decrypt_sr"] = np.asarray(fns["decrypt_sr"]).astype(np.uint64)
    if tech == "behz":
        bz = cd.behz
        out["bsk_moduli"] = np.asarray(ctx.bsk_ntt.q).astype(np.uint64)
        out["x_bsk"] = _near_boundary(rng, np.asarray(bz.bsk.q).tolist(), N)
        x_bsk = jnp.asarray(out["x_bsk"])
        fns.update(sm_mrq=jbz.sm_mrq(x_q, bz),
                   fast_floor=jbz.fast_floor(x_q, x_bsk, bz),
                   fastbconv_sk=jbz.fastbconv_sk(x_bsk, bz))
    if tech == "leveled":
        lc = ctx.get_context_data(2).leveled
        fns.update(lev_q_to_ql=jsr.scale_and_round_exact(x_q, lc.q_to_ql),
                   lev_q_to_rl=jsr.scale_and_round_exact(x_q, lc.q_to_rl))
    for name, v in fns.items():
        out["h__" + name] = digest(v)
    print(f"u64_bfv {tech}: budgets " + ", ".join(
        f"{k[7:]} {int(v)}" for k, v in out.items()
        if k.startswith("budget_")))
    _save(f"u64_bfv_{tech}_b{bits}.npz", **out)


U64_BFV_FILES = {f"u64_bfv_{tech}": (lambda tech=tech: u64_bfv(tech))
                 for tech in U64_BFV_TECHS}


# ---------------------------------------------------------------------------
# the CKKS application layer on the u64 evaluator
# ---------------------------------------------------------------------------

def _key_draws64(out, ctx, k, steps=None):
    """Keys from the PRNG keys k (secret, public, relin, Galois), their
    draws stored as u64_chain stores them."""
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    rlk = keys.gen_relin_key(ctx, sk, k[2])
    out["s_tern"] = np.asarray(jsmp.sample_ternary_vec(k[0], N)).astype(
        np.int8)
    out["pk_a"], out["pk_e"] = _zero_samples64(ctx, k[1])
    out["rlk_a"], out["rlk_e"] = _kswitch_samples64(ctx, k[2])
    for name, key in (("sk", sk), ("pk", pk), ("rlk", rlk)):
        out["h__" + name] = digest(key.data)
    glk = None
    if steps is not None:
        glk = keys.create_galois_keys(ctx, sk, k[3], steps=steps)
        rng, draws = k[3], []
        for _ in glk.elts:
            rng, sub = jax.random.split(rng)
            draws.append(_kswitch_samples64(ctx, sub))
        out["glk_a"] = np.stack([a for a, _ in draws])
        out["glk_e"] = np.stack([e for _, e in draws])
        out["elts"] = np.array(glk.elts, dtype=np.int64)
        out["h__glk"] = digest(glk.data)
    return sk, pk, rlk, glk


def _enc_draws64(out, key):
    k_u, k_e0, k_e1 = jax.random.split(key, 3)
    out["enc_u"] = np.asarray(jsmp.sample_ternary_vec(k_u, N)).astype(
        np.int8)
    out["enc_e"] = np.stack([np.asarray(jsmp.sample_error_cbd(x, N))
                             for x in (k_e0, k_e1)]).astype(np.int8)


def _app_ctx(data_bits, k_data, special_bits, alpha):
    qs = numth.get_primes(2 * N, data_bits, k_data)
    ps = numth.get_primes(2 * N, special_bits, alpha)
    ctx = make_context(EncryptionParameters.create(
        Scheme.CKKS, N, qs + ps, special_modulus_size=alpha))
    return ctx, dict(data_moduli=np.array(qs, dtype=np.uint64),
                     special_moduli=np.array(ps, dtype=np.uint64),
                     t=np.array(0, dtype=np.uint64))


def u64_linear():
    from phantom_tpu.schemes import LinearTransform
    ctx, out = _app_ctx(50, 3, 51, 2)
    rng = np.random.default_rng(SEED + 80)
    d = 8
    M = rng.standard_normal((d, d)) * 0.3
    idx = np.arange(d)
    M[idx, (idx + 4) % d] = 0.0
    M[idx, (idx + 5) % d] = 0.0
    x = rng.standard_normal(d) * 0.3
    lt = LinearTransform(M)
    k = jax.random.split(jax.random.PRNGKey(181), 5)
    sk, pk, rlk, glk = _key_draws64(out, ctx, k, lt.steps_required())
    enc = CKKSEncoder(ctx)
    scale = 2.0 ** 40
    w_scale = float(ctx.params.data_moduli[2])
    lt.prepare(enc, w_scale)
    pt = lt.encode_input(enc, x, scale)
    ct = keys.encrypt_asymmetric(ctx, pk, pt, k[4])
    _enc_draws64(out, k[4])
    y = lt.apply(ctx, ct, glk)
    got = enc.decode(keys.decrypt(ctx, sk, y))
    np.testing.assert_allclose(got.real[:d], M @ x, atol=1e-3)
    out["M"], out["x"] = M, x
    out["scale"], out["w_scale"] = np.array(scale), np.array(w_scale)
    _pt64(out, "pt_in", pt)
    for i, w in enumerate(p for grp in lt._prepared[1] for p in grp):
        out[f"h__w_{i}"] = digest(w)
    _ct64(out, "ct", ct)
    _ct64(out, "y", y)
    out["decoded_y"] = got
    _save("u64_linear_b50.npz", **out)


def u64_poly():
    from phantom_tpu.schemes.poly import (chebyshev_fit, poly_eval,
                                          poly_eval_cheb)
    ctx, out = _app_ctx(50, 9, 51, 3)
    k = jax.random.split(jax.random.PRNGKey(183), 5)
    sk, pk, rlk, _ = _key_draws64(out, ctx, k)
    enc = CKKSEncoder(ctx)
    scale = 2.0 ** 50
    x = np.random.default_rng(SEED + 81).uniform(-0.8, 0.8, enc.slots)
    ct = keys.encrypt_asymmetric(ctx, pk, enc.encode(x, scale), k[4])
    _enc_draws64(out, k[4])
    out["x"], out["scale"] = x, np.array(scale)
    _ct64(out, "ct", ct)
    mono = poly_coeffs("dense7")
    interval = (-2.0, 2.0)
    cheb = chebyshev_fit(np.tanh, 13, interval)
    out["coeffs_mono"], out["coeffs_cheb"] = mono, cheb
    out["interval"] = np.array(interval)
    for name, y, want in (
            ("y_mono", poly_eval(ctx, ct, mono, rlk, enc),
             np.polyval(mono[::-1], x)),
            ("y_cheb", poly_eval_cheb(ctx, ct, cheb, rlk, enc,
                                      interval=interval),
             np.polynomial.chebyshev.chebval(x / 2.0, cheb))):
        got = enc.decode(keys.decrypt(
            ctx, sk, evaluate.rescale_to_next(ctx, y))).real
        np.testing.assert_allclose(got, want, atol=5e-3)
        _ct64(out, name, y)
    _save("u64_poly_b50.npz", **out)


def ckks_fft_wide():
    from phantom_tpu.ops import ckks_fft as cf
    from phantom_tpu.schemes.ckks_encoder import CKKSDeviceEncoder
    out = {}
    rng = np.random.default_rng(SEED + 82)
    q40 = numth.get_primes(2 * N, 40, 2) + numth.get_primes(2 * N, 30, 1)
    q50 = numth.get_primes(2 * N, 50, 5) + numth.get_primes(2 * N, 51, 2)
    for c, data, special, scale, chain in (
            ("w40", [q40[0], q40[2]], [q40[1]], 2.0 ** 30, (1,)),
            ("w50", q50[:5], q50[5:], 2.0 ** 40, (1, 5))):
        ctx = make_context(EncryptionParameters.create(
            Scheme.CKKS, N, data + special,
            special_modulus_size=len(special)))
        enc, host = CKKSDeviceEncoder(ctx), CKKSEncoder(ctx)
        z = rng.standard_normal(enc.slots) + 1j * rng.standard_normal(
            enc.slots)
        out[f"moduli_{c}"] = np.array(data, dtype=np.uint64)
        out[f"special_{c}"] = np.array(special, dtype=np.uint64)
        out[f"z_{c}"], out[f"scale_{c}"] = z, np.array(scale)
        for ci in chain:
            with jax.disable_jit():
                re, im = enc._scatter(z, scale)
                hi, lo = cf.fft_inverse((re, im), enc.tables)[0]
                a = jnp.round(hi).astype(jnp.int64)
                b = jnp.round(lo + (hi - a.astype(jnp.float32))).astype(
                    jnp.int64)
                out[f"ints_{c}_{ci}"] = np.asarray(a + b)
                pt = enc.encode(z, scale, ci)
                dec = enc.decode(pt)
            out[f"enc_{c}_{ci}"] = np.asarray(pt.data).astype(np.uint64)
            out[f"dec_{c}_{ci}"] = dec
            out[f"host_{c}_{ci}"] = host.decode(pt)
            np.testing.assert_allclose(dec, z, atol=1e-6)
    _save("ckks_fft_wide.npz", **out)


REF_SALSA_BITS = (28, 50, 61)
REF_STEPS = (1,)


def salsa_moduli(bits, n=N, count=3):
    """61-bit primes that reject about one lane in nine
    (chip_smoke.rejecting_primes, which the tests replay), else the
    package's primes of `bits` bits."""
    return rejecting_primes(n, count) if bits == 61 else numth.get_primes(
        2 * n, bits, count)


def _blob(save, *args):
    import io
    buf = io.BytesIO()
    save(*args, buf)
    return np.frombuffer(buf.getvalue(), dtype=np.uint8).copy()


def _sha(blob):
    import hashlib
    return np.frombuffer(hashlib.sha256(blob.tobytes()).digest(),
                         dtype=np.uint8).copy()


def refformat_golden():
    """refformat_n1024.npz: the JAX package's salsa20 samplers (numpy
    path) at n = 1024 over three primes of 28, 50 and 61 bits (the last
    rejecting about one lane in nine): seed, salsa_moduli_<b>,
    <form>_<b>.  BFV at n = 1024 (two 40-bit data primes, one special, t
    = PlainModulus.batching(n, 16), as JAX examples/4_serialization.py):
    JAX keys, an asymmetric encryption ct of vals1, a seeded symmetric
    encryption ct_sym of vals2 (refformat.encrypt_symmetric_seeded,
    sym_seed), the plaintext pt of vals1, and prod = multiply_and_relin
    (ct, ct_sym); each through refformat's writers as ref_<name> (uint8
    blobs), and through serialize's as the sha256 of its bytes,
    ser_<name> (ser_cts: the whole JAX PTCS blob of ct_sym, its threefry
    seed 2 words).  h__sym_data is ct_sym's data digest.  CKKS at n =
    1024 (three 50-bit data primes, one of 51): ckks_ref_sk, ckks_ref_sym
    (a seeded encryption of ckks_z at scale 2^40, NTT form), its data
    digest h__ckks_sym_data."""
    from phantom_tpu.host.modulus import CoeffModulus
    from phantom_tpu.utils import refformat as ref
    from phantom_tpu.utils import salsa20
    from phantom_tpu.utils import serialize as ser
    out = {}
    seed = bytes(range(3, 67))
    out["seed"] = np.frombuffer(seed, dtype=np.uint8).copy()
    for b in REF_SALSA_BITS:
        qs = salsa_moduli(b)
        out[f"salsa_moduli_{b}"] = np.array(qs, dtype=np.uint64)
        for form in ("uniform", "ternary", "error"):
            out[f"{form}_{b}"] = getattr(salsa20, f"sample_{form}_ref")(
                seed, qs, N, use_native=False)
    coeff = [m.value for m in CoeffModulus.create(N, [40, 40, 40])]
    t = PlainModulus.batching(N, 16).value
    ctx = make_context(EncryptionParameters.create(
        Scheme.BFV, N, coeff, plain_modulus=t, special_modulus_size=1))
    out["bfv_moduli"] = np.array(coeff, dtype=np.uint64)
    out["t"] = np.array(t)
    k = jax.random.split(jax.random.PRNGKey(SEED + 90), 7)
    sk = keys.gen_secret_key(ctx, k[0])
    pk = keys.gen_public_key(ctx, sk, k[1])
    rlk = keys.gen_relin_key(ctx, sk, k[2])
    glk = keys.create_galois_keys(ctx, sk, k[3], steps=list(REF_STEPS))
    out["glk_elts"] = np.array(glk.elts, dtype=np.int64)
    enc = BatchEncoder(ctx)
    rng = np.random.default_rng(SEED + 90)
    vals1 = rng.integers(0, t, N, dtype=np.uint64)
    vals2 = rng.integers(0, t, N, dtype=np.uint64)
    out["vals1"], out["vals2"] = vals1, vals2
    pt = enc.encode(vals1)
    ct = keys.encrypt_asymmetric(ctx, pk, pt, k[4])
    sym_seed = bytes(range(100, 164))
    out["sym_seed"] = np.frombuffer(sym_seed, dtype=np.uint8).copy()
    ct_sym = ref.encrypt_symmetric_seeded(ctx, sk, enc.encode(vals2),
                                          sym_seed, k[5])
    out["h__sym_data"] = digest(ct_sym.data)
    prod = evaluate.multiply_and_relin(ctx, ct, ct_sym, rlk)
    np.testing.assert_array_equal(
        enc.decode(keys.decrypt(ctx, sk, prod)),
        (vals1.astype(object) * vals2.astype(object) % t).astype(np.uint64))
    out["ref_sk"] = _blob(ref.save_secret_key_ref, sk)
    out["ref_pk"] = _blob(ref.save_public_key_ref, pk)
    out["ref_rlk"] = _blob(ref.save_relin_key_ref, rlk)
    out["ref_glk"] = _blob(ref.save_galois_key_ref, glk)
    out["ref_ct"] = _blob(ref.save_ciphertext_ref, ct)
    out["ref_pt"] = _blob(ref.save_plaintext_ref, pt)
    out["ref_prod"] = _blob(ref.save_ciphertext_ref, prod)
    out["ref_sym"] = _blob(lambda c, f: ref.save_ciphertext_symmetric_ref(
        c, sym_seed, f), ct_sym)
    for name, obj in (("sk", sk), ("pk", pk), ("rlk", rlk), ("glk", glk),
                      ("ct", ct), ("pt", pt), ("prod", prod)):
        out[f"ser_{name}"] = _sha(np.frombuffer(ser.to_bytes(obj),
                                                dtype=np.uint8))
    ct_c, key = ser.encrypt_symmetric_compressed(ctx, sk, enc.encode(vals2),
                                                 k[6])
    out["ser_cts"] = _blob(lambda c, f: ser.save_ciphertext_symmetric(
        c, key, f), ct_c)
    q50 = numth.get_primes(2 * N, 50, 3) + numth.get_primes(2 * N, 51, 1)
    cctx = make_context(EncryptionParameters.create(
        Scheme.CKKS, N, q50, special_modulus_size=1))
    out["ckks_moduli"] = np.array(q50, dtype=np.uint64)
    kc = jax.random.split(jax.random.PRNGKey(SEED + 91), 2)
    csk = keys.gen_secret_key(cctx, kc[0])
    z = rng.standard_normal(N // 2) + 1j * rng.standard_normal(N // 2)
    out["ckks_z"] = z
    cpt = CKKSEncoder(cctx).encode(z, 2.0 ** 40)
    cseed = bytes(range(200, 256)) + bytes(range(8))
    out["ckks_seed"] = np.frombuffer(cseed, dtype=np.uint8).copy()
    csym = ref.encrypt_symmetric_seeded(cctx, csk, cpt, cseed, kc[1])
    out["h__ckks_sym_data"] = digest(csym.data)
    out["ckks_ref_sk"] = _blob(ref.save_secret_key_ref, csk)
    out["ckks_ref_sym"] = _blob(lambda c, f: ref.save_ciphertext_symmetric_ref(
        c, cseed, f), csym)
    _save("refformat_n1024.npz", **out)


def sharded():
    from types import SimpleNamespace

    from jax.sharding import NamedSharding, PartitionSpec as P

    from phantom_tpu.parallel import make_coeff_mesh
    from phantom_tpu.parallel import ntt_sharded as ns
    from phantom_tpu.parallel import pipeline_sharded as psh
    from phantom_tpu.parallel import sharded32 as s32
    from phantom_tpu.schemes.ciphertext import Ciphertext
    mesh = make_coeff_mesh(8, dp=1)
    n1, n2 = ns._split_n(N)
    sh3 = NamedSharding(mesh, P(None, None, "coeff"))
    sh4 = NamedSharding(mesh, P(None, None, None, "coeff"))
    rep = NamedSharding(mesh, P())
    rng = np.random.default_rng(SEED + 20)
    out = {}

    def run3(f, x):
        fn = jax.jit(f, in_shardings=sh3, out_shardings=sh3)
        return np.asarray(fn(jnp.asarray(x.reshape(x.shape[0], n1, n2))))

    # u32 NTTs over the ckks_step chain's data primes
    qs, ps, ctx, sk, rlk, ct1, ct2 = _setup()
    t32 = ntt32.tables32_from_tables64(ntt64.tables_from_host(
        make_rns_ntt_tables(N, [Modulus(q) for q in qs])))
    tp32 = s32.prepare_sharded_tables32(t32)
    x32 = uniform(rng, qs, (), N)
    sc = np.array([rng.integers(1, q) for q in qs], dtype=np.uint64)
    sc_sh = np.array([(int(v) << 32) // q for v, q in zip(sc, qs)],
                     dtype=np.uint64)
    out.update(
        data_moduli=np.array(qs, dtype=np.uint64),
        special_moduli=np.array(ps, dtype=np.uint64), x32=x32,
        ntt32_fwd=run3(lambda v: s32.ntt_forward_sharded32(v, tp32, mesh),
                       x32),
        ntt32_inv=run3(lambda v: s32.ntt_inverse_sharded32(v, tp32, mesh),
                       x32),
        ntt32_inv_scaled=run3(lambda v: s32.ntt_inverse_sharded32(
            v, tp32, mesh, scale=jnp.asarray(u32(sc)),
            scale_shoup=jnp.asarray(u32(sc_sh))), x32),
        scale32=u32(sc), scale32_shoup=u32(sc_sh))
    np.testing.assert_array_equal(
        out["ntt32_fwd"].reshape(len(qs), N),
        np.asarray(ntt32.ntt_forward32(jnp.asarray(x32), t32)))
    # u64 NTTs over three 50-bit primes
    q64 = numth.get_primes(2 * N, 50, 3)
    t64 = ntt64.tables_from_host(make_rns_ntt_tables(
        N, [Modulus(q) for q in q64]))
    tp64 = ns.prepare_sharded_tables(t64)
    x64 = np.stack([rng.integers(0, q, N, dtype=np.uint64) for q in q64])
    out.update(
        q64=np.array(q64, dtype=np.uint64), x64=x64,
        ntt64_fwd=run3(lambda v: ns.ntt_forward_sharded3(v, tp64, mesh,
                                                         "coeff"), x64),
        ntt64_inv=run3(lambda v: ns.ntt_inverse_sharded3(v, tp64, mesh,
                                                         "coeff"), x64))
    np.testing.assert_array_equal(
        out["ntt64_fwd"].reshape(3, N),
        np.asarray(ntt64.ntt_forward(jnp.asarray(x64), t64)))
    # the u32 CKKS step on ckks_step_n1024.npz's chain
    consts = s32.build_sharded32(ctx, rlk)
    fn = jax.jit(lambda c, a, b: s32.sharded_mult_relin_rescale32(
        c, mesh, a, b), in_shardings=(rep, sh4, sh4), out_shardings=sh4)
    d1, d2 = u32(ct1.data), u32(ct2.data)
    s32_out = np.asarray(fn(consts, jnp.asarray(d1.reshape(2, -1, n1, n2)),
                            jnp.asarray(d2.reshape(2, -1, n1, n2))))
    ref = np.load(os.path.join(DIR, "ckks_step_n1024.npz"))
    np.testing.assert_array_equal(s32_out.reshape(2, -1, N), ref["out"])
    out.update(s32_d1=d1, s32_d2=d2, s32_rlk=u32(rlk.data), s32_out=s32_out)
    # the u64 steps: five 50-bit data primes, two of 51, t of 16 bits
    qd = numth.get_primes(2 * N, 50, K_DATA)
    qp = numth.get_primes(2 * N, 51, ALPHA)
    t = PlainModulus.batching(N, 16).value
    out.update(u64_data=np.array(qd, dtype=np.uint64),
               u64_special=np.array(qp, dtype=np.uint64),
               t=np.array(t, dtype=np.uint64))
    dnum = -(-K_DATA // ALPHA)
    for name in ("ckks", "bgv", "bfv"):
        extra = {} if name == "ckks" else dict(plain_modulus=t)
        sctx = make_context(EncryptionParameters.create(
            SCHEMES[name], N, qd + qp, special_modulus_size=ALPHA, **extra))
        key = np.stack([np.stack([np.stack([
            rng.integers(0, q, N, dtype=np.uint64) for q in qd + qp])
            for _ in range(2)]) for _ in range(dnum)])
        a, b = (np.stack([np.stack([rng.integers(0, q, N, dtype=np.uint64)
                                    for q in qd]) for _ in range(2)])
                for _ in range(2))
        skey = SimpleNamespace(data=jnp.asarray(key))
        ja, jb = (jnp.asarray(v.reshape(2, -1, n1, n2)) for v in (a, b))
        ntt_form = name != "bfv"
        c1, c2 = (Ciphertext(data=jnp.asarray(v), chain_index=1,
                             is_ntt_form=ntt_form) for v in (a, b))
        local = evaluate.multiply_and_relin(sctx, c1, c2, skey)
        if name == "ckks":
            c = psh.build_sharded_consts(sctx, skey)
            got = jax.jit(lambda c_, x, y: psh.sharded_mult_relin_rescale(
                c_, mesh, x, y), in_shardings=(rep, sh4, sh4),
                out_shardings=sh4)(c, ja, jb)
            local = evaluate.rescale_to_next(sctx, local)
        elif name == "bgv":
            c = psh.build_sharded_consts(sctx, skey)
            bgv = sctx.get_context_data(1).bgv
            got = jax.jit(lambda c_, g, x, y:
                          psh.sharded_bgv_mult_relin_modswitch(
                              c_, mesh, g, x, y),
                          in_shardings=(rep, rep, sh4, sh4),
                          out_shardings=sh4)(c, bgv, ja, jb)
            local = evaluate.mod_switch_to_next(sctx, local)
        else:
            c = psh.build_bfv_sharded_consts(sctx, skey)
            got = jax.jit(lambda c_, x, y: psh.sharded_bfv_mult_relin(
                c_, mesh, x, y), in_shardings=(rep, sh4, sh4),
                out_shardings=sh4)(c, ja, jb)
        got = np.asarray(got)
        np.testing.assert_array_equal(got.reshape(2, -1, N),
                                      np.asarray(local.data))
        out.update({f"{name}_d1": a, f"{name}_d2": b, f"{name}_rlk": key,
                    f"{name}_out": got})
        print(f"sharded: {name} bit-equal to the local verbs")
    _save("sharded_n1024.npz", **out)


def limb():
    from chip_smoke import LIMB_ALPHAS, LIMB_SEED, limb_inputs
    from phantom_tpu.parallel import (make_mesh, shard_ciphertext_data,
                                      sharded_mul_relin_rescale_step)
    from phantom_tpu.schemes.ciphertext import Ciphertext
    mesh = make_mesh(8)
    assert (mesh.shape["dp"], mesh.shape["limb"]) == (2, 4), mesh.shape
    qd = numth.get_primes(2 * N, 50, 8)
    out = dict(data_moduli=np.array(qd, dtype=np.uint64))
    for alpha in LIMB_ALPHAS:
        qp = numth.get_primes(2 * N, 51, alpha)
        ctx = make_context(EncryptionParameters.create(
            Scheme.CKKS, N, qd + qp, special_modulus_size=alpha))
        key, d1, d2 = limb_inputs(qd, qp, N, LIMB_SEED + alpha)
        rlk = keys.RelinKey(data=jnp.asarray(key))
        proto = Ciphertext(data=jnp.asarray(d1[0]), chain_index=1,
                           is_ntt_form=True, scale=2.0 ** 40)
        step = sharded_mul_relin_rescale_step(ctx, proto, proto, rlk, mesh)
        got = np.asarray(step(shard_ciphertext_data(jnp.asarray(d1), mesh),
                              shard_ciphertext_data(jnp.asarray(d2), mesh)))
        for b in range(2):
            c1, c2 = (proto.replace(data=jnp.asarray(d[b])) for d in (d1, d2))
            local = evaluate.rescale_to_next(
                ctx, evaluate.multiply_and_relin(ctx, c1, c2, rlk))
            np.testing.assert_array_equal(got[b], np.asarray(local.data))
        out.update({f"a{alpha}_special": np.array(qp, dtype=np.uint64),
                    f"a{alpha}_out": got})
        print(f"limb: alpha {alpha} bit-equal to the local step")
    _save("limb_n1024.npz", **out)


# benchsetup_n1024.npz: scheme -> setup_bench's keywords beside n = 1024
BENCHSETUP = {"ckks": dict(limbs=2, alpha=2, bits=50),
              "bgv": dict(limbs=2, alpha=2, bits=28),
              "bfv": dict(limbs=2, alpha=2, bits=28, multech="hps")}


def benchsetup():
    import json
    import tempfile

    from phantom_tpu.utils import benchcache
    from phantom_tpu.utils.benchsetup import setup_bench
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["PHANTOM_SETUP_CACHE"] = tmp
        for scheme, kw in BENCHSETUP.items():
            s = setup_bench(scheme, n=N, seed=SEED, verbose=False, **kw)
            cfg = dict(scheme=scheme, n=N, limbs=kw["limbs"],
                       alpha=kw["alpha"], bits=kw["bits"],
                       multech=kw.get("multech", ""), galois_steps=[],
                       seed=SEED)
            arrays, meta = benchcache.load_setup(**cfg)
            out.update({f"{scheme}_{k}": np.asarray(v)
                        for k, v in arrays.items()})
            p = s.params
            out.update({
                f"{scheme}_meta": np.asarray(json.dumps(meta)),
                f"{scheme}_values": np.asarray(s.values),
                f"{scheme}_data": np.array(
                    p.coeff_modulus[:kw["limbs"]], dtype=np.uint64),
                f"{scheme}_special": np.array(
                    p.coeff_modulus[kw["limbs"]:], dtype=np.uint64),
                f"{scheme}_t": np.array(
                    p.plain_modulus if scheme != "ckks" else 0,
                    dtype=np.uint64)})
            print(f"benchsetup: {scheme} {sorted(arrays)}")
    _save("benchsetup_n1024.npz", **out)


def main(names):
    names = names or ["ckks_step", "rotate", "step_n128", "bfv_step",
                      "bfv_multech", "bgv_step", "bfv_live", "ntt32_n128",
                      "fast32", "ckks_fft", "linear", "poly", "roll",
                      "fast32_roll", "u64", "u64_bfv", "u64_app",
                      "refformat", "sharded", "limb", "benchsetup"]
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
    for name, make in (("ckks_fft", ckks_fft), ("linear", linear),
                       ("poly", poly), ("roll", roll),
                       ("fast32_roll", fast32_roll)):
        if name in names:
            make()
    for name, make in U64_FILES.items():
        if name in names or "u64" in names:
            make()
    if "u64_mxn" in names or "u64" in names:
        u64_mxn()
    for name, make in U64_BFV_FILES.items():
        if name in names or "u64_bfv" in names:
            make()
    for name, make in (("u64_linear", u64_linear), ("u64_poly", u64_poly),
                       ("ckks_fft_wide", ckks_fft_wide)):
        if name in names or "u64_app" in names:
            make()
    if "refformat" in names:
        refformat_golden()
    if "sharded" in names:
        sharded()
    if "limb" in names:
        limb()
    if "benchsetup" in names:
        benchsetup()


if __name__ == "__main__":
    main(sys.argv[1:])

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's CKKS key switching, BFV multiply (by each
of the four techniques), BGV multiply and its Fast32 evaluator on one
NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repo root, one CUDA device
    python3 chip_smoke.py --calls  # only every kernel call of each path
                                   # against its plain version, timed

Four configurations, all N = 2^16 with 43 data primes of 28 bits from
chain index 1, primes as phantom_tpu/utils/benchsetup.py builds them:
  headline  22 special primes of 29 bits (dnum 2, the last digit 21 rows):
            the multiply + relinearize + rescale step on the xla-split
            modup (K1, K2, K5, K9) through each epilogue: the pair (K1,
            K3, then the rescale's K1 and K3), K8 with 8 rows per block
            (then the rescale), K7 (moddown and rescale in one); and on
            the other two modup routes: "xla" (K1, K5 per digit, K4's
            preconv form K4p) and "kernel" (K1, K4 at alpha 22);
  alpha 8   8 special primes of 29 bits (dnum 6, the last digit 3 rows):
            rotations, hoisted rotations (K9 per step) and the step on the
            fused modup (K1, K3, K4), as the JAX package's default dispatch
            runs them at alpha <= 8;
  BFV       `bench.py --scheme bfv` at its defaults: alpha 22, t the 20-bit
            batching prime, the 44 Rl primes below min(QP), so D = Ql u Rl
            has 87 rows: the HPS multiply + relinearize step in coefficient
            form on the default engine (K5 x10, K2, K1 x3, K4's coefficient
            form, K3) and on "pallas-roll" (K6 for every transform, K5 x14,
            K9); with the fused lift (one K3 at alpha 43 for the four lifts
            and K2); BEHZ over Bsk (44 more primes of 29 bits), HPSoverQ,
            and leveled without and with a level drop, on both engines;
  BGV       `bench.py --scheme bgv` at its defaults: alpha 22, t the 20-bit
            batching prime: the multiply + relinearize + modulus-switch
            step in NTT form, its key switch on the "auto" route
            (xla-split: K1, K5 x2, K2, K9) and on "kernel" (K1, K4), the
            t-corrected moddown of both halves unfused (K1, K5 to Ql and
            to {t}, K2), the modulus switch K1 and K2.
K1 (csrc/ntt.cu) runs each row on the one-pass, cluster-resident radix-8
core (csrc/ntt_cluster.cuh, the library's only NTT; Gentleman-Sande
passes, then the crossing stages over distributed shared memory), its
floor sum v a second launch of the same call; K2, K3 and K4 run on the
same core forward, one launch each, and K8 too, a cluster holding a share
of several output rows at a time (csrc/moddown_rows.cu); K6
(csrc/ntt_roll.cu) runs K2's and K1's kernels; K7
(csrc/moddown_rescale.cu) is two launches on the core, the last limb's
forward and inverse transforms, then the other rows as a programmatic
dependent launch that converts its rows while the first runs.  K5
(csrc/bconv.cu) runs on the int8 tensor cores: four 8-bit digit planes of
y and of the matrix, 16 plane products on mma.sync m16n8k32 into seven
exact s32 diagonals, folded by Shoup products.
Phases, one line each or more; any failure exits non-zero:

  1. device    card name and power limit, CUDA, nvcc, triton, device count
  2. build     the kernels of phantom_tpu_torch/csrc, built from source;
               K5's int8 tensor-core instructions (IMMA) counted in the
               built library's SASS (cuobjdump); no kernel of the two-pass
               K2, K7 and K8 or of the radix-2 K6 (STALE_KERNELS) left in
               its symbols, the core's kernels (CORE_KERNELS) there;
               registers and stack of the core's kernels, and K7's
               registers and spills (nvcc -Xptxas -v)
  3. golden    the step (n = 1024, alpha = 2) through each epilogue on both
               routes, and the rotation golden file (rotation, key switch,
               both hoisted forms, moddown, the step through each
               epilogue) through the kernels, bit-equal to the JAX
               package's outputs
  4. kernels   every kernel call of one headline step through each
               epilogue is bit-equal to its plain torch version on the
               same inputs, and both are timed
  5. step      keys from a seeded generator, two encryptions of small
               integer polynomials times 2^22 (coefficient encoding), the
               step through the kernels bit-equal to the step through the
               plain versions and through the other two epilogues, the
               launch counts, and a decryption equal to the exact
               negacyclic product m1 m2
  6. timing    a chain of steps, each output re-padded into the next input
               (as bench.py does), kernel path against plain path in turns,
               then the three epilogues in turns (pair, K8, K7, K7, K8,
               pair), timed with CUDA events; K8 alone at 1, 2, 4, 6 and
               8 rows per cluster; K3 and K1 alone on the moddown pair's
               operands ((2, 22, N) -> (2, 43, N), and the (2, 22, N)
               inverse with its floor sum v), K2 alone on the modup's
               (87, N), on BFV's D forward shape (2, 2, 87, N) and BGV's
               moddown shape (2, 43, N), and K8 (R = 8) and K7 alone on the
               moddown's operands at 8, 4 and 2 blocks per row (in turns
               8, 4, 2, 2, 4, 8), each bit-equal to the default; K7 beside
               the three calls of the pair that it replaces (K3's moddown,
               the rescale's K1 and K3) on the same operands, device time,
               in turns
  7. profile   torch.profiler over a few chained kernel-path steps through
               each epilogue (pair, K8, K7): the device-busy time, the
               idle share and the top device kernels
  8. routes    the step on the "xla" route (K4p) and on the "kernel" route
               (K4 at alpha 22) with every kernel call bit-equal to its
               plain version and timed, then each route's launch counts,
               kernel path = plain path = the xla-split route, decryption
               equal to m1 m2
  9. route timing  chained steps on the three routes in turns (xla-split,
               xla, kernel, kernel, xla, xla-split) with peak memory; the
               profiler over the "xla" route
 10. alpha-8 setup   the secret key, the relin key, Galois keys for steps
               1..7 and two encryptions, from a seeded generator
 11. alpha-8 kernels one rotation, one hoisting_sum32, one
               hoisted_linear_combo32 and the step on both routes and
               through the K8 and K7 epilogues, with every kernel call
               bit-equal to its plain version, and timed
 12. rotate    rotate32(., 1): kernels = plain, launch counts, decryption
               equal to sigma_g(m1)
 13. hoist     hoisting_sum32 over steps 1..7 and hoisted_linear_combo32
               over steps 0..7 with weights in [-3, 3]: kernels = plain,
               launch counts, decryptions equal to sum sigma(m1) and
               sum w_s sigma_s(m1)
 14. alpha-8 step  the K4 route = the plain path = the xla-split route =
               the K8 and K7 epilogues, launch counts, decryption equal to
               m1 m2
 15. alpha-8 timing  chained steps on both routes in turns, chained
               rotations, hoisting_sum32, hoisted_linear_combo32, peak
               memory
 16. BFV golden  the BFV step (n = 1024, alpha = 2, a short last digit)
               and the key switch of its d1[1] on both engines through the
               kernels, and the decryption of the step, bit-equal to the
               JAX package's outputs
 17. BFV setup  the context, the secret and relin keys and two symmetric
               encryptions of polynomials with coefficients in [-3, 3], from
               a seeded generator
 18. BFV kernels  every kernel call of one step on each engine bit-equal to
               its plain version, and timed; K6 (at 8, 4 and 2 blocks per
               row) beside K2 and K1 on the same operands, event and
               device time: the D forward (2, 2, 87, N) and the D inverse
               (3, 87, N)
 19. BFV step  kernel path = plain path on each engine, the engines equal,
               the launch counts; d1, d2 decrypt to m1, m2, and the step's
               output to m1 m2 mod (X^N + 1, t) in every coefficient where
               HPS's bound holds (hps_bound; the golden file of phase 16
               is inside it, the full configuration is not: its count of
               right coefficients is printed)
 20. BFV timing  chained steps (each output the next d1, d2 fixed), the
               engines in turns (default, roll, roll, default), the plain
               path once, peak memory per engine; the profiler over a few
               chained steps of each engine
 21. BGV golden  the BGV step (n = 1024, alpha = 2, a short last digit)
               on the "auto" and "kernel" routes through the kernels, and
               the decryption of its output with the tracked correction
               factor, bit-equal to the JAX package's outputs
 22. BGV setup  the context, the secret and relin keys and two symmetric
               encryptions of polynomials with coefficients in [-3, 3],
               from a seeded generator
 23. BGV kernels  every kernel call of one step on each route bit-equal to
               its plain version, and timed
 24. BGV step  kernel path = plain path on both routes, the routes equal,
               the launch counts; d1, d2 decrypt to m1, m2 and the step's
               output, with the factor q_last^-1 mod t, to m1 m2 mod
               (X^N + 1, t) in every coefficient
 25. BGV timing  chained steps (each output re-padded to 43 rows, as
               bench.py does), kernel path and plain path in turns, peak
               memory; each stage alone (tensor product, modup + inner
               product, the t-corrected moddown of both halves, and of
               each half by itself as two calls, one delta over both
               halves, the modulus switch); the profiler over a few
               chained steps
 26. anatomy  K3, K8 (R = 8), K7 and K1 on the headline moddown's shapes
               (K1 also on the modup's (43, N) with mul_by), K2 on the
               modup's (87, N), K5 on the modup's digit (22, N) -> 43 and BFV's
               (87, N) -> 44, and K4 on the alpha-8 step's (seeded
               operands), on the library as built and on timing probes
               built from copies of their sources that each drop one part
               of the work (ANATOMY: the transform, all but one prologue
               term, the crossing stages and cluster syncs, the local
               passes, the twiddle fetches, K1's floor sum; K5's plane
               products, fold, fold table, y planes, store; K7's last-limb
               launch, its other rows' launch, its transforms) or take the
               path the wrappers do not pick (K1 and K2 at two blocks per
               SM, the conversion's carry word, K8 with one transform per
               held row, K8 at 512 threads a block, K7 in plain stream
               order without PDL), in turns, each call's device time
               (_device_ms)
 27. Fast32 golden  the Fast32 golden files (n = 1024, FAST32_CASES:
               keygen fed the JAX samples, encode, encrypt_asymmetric,
               every verb, decrypt and decode, for the three schemes, down
               to chain index 3) through the kernels, bit-equal to the JAX
               package's outputs
 28. Fast32 CKKS  at the headline configuration: keys (Galois for steps
               0..7) from a seeded generator, two slot vectors uniform in
               the unit disc encoded at scale q_last and encrypted with
               the public key, then multiply + relin and rescale, modswitch,
               add, sub, add_plain, multiply_plain, square + relin,
               hoisted_linear_combo with encode_extended weights, two more
               multiplies, at chain index 7 a plain product and a
               rotation, decrypt, decode: within 1e-2 of numpy's float64
               evaluation (the largest error printed; also a fresh
               encryption's and its rotation's at scale q_last, not gated)
 29. Fast32 BGV  at the BGV configuration: batch-encoded slots encrypted
               with the public key, two multiply + relin each followed by
               a modswitch, multiply_plain, add with balanced correction
               factors, a rotation, decrypt, decode: exact in every slot
 30. Fast32 BFV  at the BFV configuration, with mul_tech "hps", "behz"
               and "hps_overq": encrypt_asymmetric, add, multiply_plain, a
               rotation in coefficient form (K4c), a modswitch, decrypt,
               decode: exact in every slot; multiply + relin bit-equal to
               the technique's ops-level function, its right slots
               counted and gated where multech_bound holds (BEHZ and
               HPSoverQ; HPS's bound does not hold here)
 31. BFV techniques golden  bfv_multech_n1024.npz (n = 1024, alpha = 2):
               BEHZ, HPSoverQ, leveled at the model's drop and at
               force_lvl=1, multiply and multiply + relin on both engines,
               the fused lift, the decryptions and the noise budgets
               through the kernels, bit-equal to the JAX package's outputs
 32. BFV techniques  at the BFV configuration (a "behz" context, the keys
               and encryptions of phase 17): every kernel call of BEHZ,
               HPSoverQ, leveled at noise_scale_deg 1 (no drop) and 4 (a
               drop of 3) on both engines and of the fused lift (K3 at
               alpha 43, k_out 87, the carry path) bit-equal to its plain
               version, and timed; each kernel path = its plain path, the
               engines equal, the fused lift = the xla lift, the launch
               counts; per technique the decryption to m1 m2 mod (X^N + 1,
               t) (leveled with a drop over its level's Ql), the count of
               right coefficients, the noise budget and multech_bound's
               margin, gated where the bound holds
 33. BFV techniques timing  chained steps in turns (hps, behz, overq,
               leveled with a drop, then back) with peak memory; leveled
               without a drop chained = HPSoverQ; the fused lift against
               the xla lift chained in turns and the lift + forward NTT
               alone, device time; the profiler over each technique
In phases 28-30 every verb runs through the kernels under the launch
counts (EXPECTED), then through the plain versions on the same inputs
(the generator's state replayed) and is held bit-equal, then is timed
(CUDA events); each level's first use (Fast32.prebuild) is timed, and
the peak memory of each circuit printed.
Each probed call (phases 4, 8, 11, 18 and 23) prints its event time with
the host's launch overhead, as every run of this script has, and its
device time alone (_device_ms: the calls enqueued while the device
sleeps).  Then a {"kernels": [...]} line: per kernel its launches over
the counted path runs (EXPECTED), its largest error against plain, and
the summed event time of the probed calls through the kernel and the
plain version beside their bound.  The bound of a call is the largest
of its bytes (each input, the NTT tables' rows included, read once, each
output written once) at 3.35 TB/s, its 32-bit integer multiplies (a Shoup
product 3, a Barrett product 8, a 32x32->64 product 2, the floor-sum
cascade 20 per word; a sum of products reduced once, by a 64-bit Barrett
reduction 6 where the operands' range keeps it below 2^64, else by a
128-bit reduction 20) at 132 SMs x 64 lanes x 1.98 GHz = 16.7 T/s, and
its int8 tensor-core operations at 1,979 TOP/s (NVIDIA's H100 SXM data
sheet, dense int8).  K5 runs on the tensor cores, so its work is priced
as there: 16 plane products of 2 k_out k_in N operations each (the
unpadded shape) and 7 Shoup products per output for the fold.  No single
PyTorch call computes a modular NTT or a modular product-sum, so
library_ms is null.  Last comes {"ok": true, "device": ...}.  Without a
CUDA device, or without the repo around it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
GOLDEN = os.path.join(FIXTURES, "ckks_step_n1024.npz")
ROTATE_GOLDEN = os.path.join(FIXTURES, "rotate_n1024.npz")
BFV_GOLDEN = os.path.join(FIXTURES, "bfv_step_n1024.npz")
BFV_MULTECH_GOLDEN = os.path.join(FIXTURES, "bfv_multech_n1024.npz")
BGV_GOLDEN = os.path.join(FIXTURES, "bgv_step_n1024.npz")
HEADLINE = dict(n=1 << 16, limbs=43, alpha=22, bits=28)
ALPHA8 = dict(n=1 << 16, limbs=43, alpha=8, bits=28)
BFV = dict(n=1 << 16, limbs=43, alpha=22, bits=28, t_bits=20)
BGV = BFV
ROUTES = ("xla-split", "xla", "kernel")  # the CKKS step's modup routes
ENGINES = ("mxu-pallas", "pallas-roll")
CHAIN_BFV_STEPS = 10
CHAIN_BGV_STEPS = 10
CLUSTERS = (8, 4, 2)  # K6's blocks per 2^16-word row, timed in turns
K8_ROWS = (1, 2, 4, 6, 8)  # K8's rows per cluster, timed (phase 6)
K3_CLUSTERS = (8, 4, 2)  # K1-K3's and K8's blocks per row (phase 6)
STEPS = tuple(range(1, 8))
STEPS_HOIST = tuple(range(8))  # Fast32's CKKS circuit: Galois keys, combo
DELTA_BITS = 22
SEED = 2026
CHAIN_STEPS = 20
CHAIN8_STEPS = 10
PROFILE_STEPS = 5
REPS = 10
KERNELS = [  # name, wrapper attribute, source, the TPU kernel it replaces
    ("K1", "ntt_inverse", "phantom_tpu_torch/csrc/ntt.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:434"),
    ("K2", "ntt_forward", "phantom_tpu_torch/csrc/ntt.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:371"),
    ("K3", "bconv_ntt_forward", "phantom_tpu_torch/csrc/bconv_ntt.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:635"),
    ("K5", "fold_matmul", "phantom_tpu_torch/csrc/bconv.cu",
     "phantom_tpu/ops/bconv_pallas.py:97"),
    ("K4", "modup_ip", "phantom_tpu_torch/csrc/modup_ip.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:1427"),
    ("K9", "inner_product", "phantom_tpu_torch/csrc/ip.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:1378"),
    ("K8", "moddown_rows", "phantom_tpu_torch/csrc/moddown_rows.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:877"),
    ("K7", "moddown_rescale", "phantom_tpu_torch/csrc/moddown_rescale.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:1101"),
    ("K4c", "modup_ip_coeff", "phantom_tpu_torch/csrc/modup_ip.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:1427"),
    ("K6f", "ntt_forward_roll", "phantom_tpu_torch/csrc/ntt_roll.cu",
     "phantom_tpu/ops/ntt_pallas_roll.py:274"),
    ("K6i", "ntt_inverse_roll", "phantom_tpu_torch/csrc/ntt_roll.cu",
     "phantom_tpu/ops/ntt_pallas_roll.py:306"),
    ("K4p", "modup_ip_preconv", "phantom_tpu_torch/csrc/modup_ip.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:1427"),
]


def _launches(**kw):
    return {name: kw.get(name, 0) for name, *_ in KERNELS}


EXPECTED = {  # launches per path run
    "headline step": _launches(K1=3, K2=1, K3=2, K5=2, K9=1),
    "headline step, K8 epilogue": _launches(K1=3, K2=1, K3=1, K5=2, K9=1,
                                            K8=1),
    "headline step, K7 epilogue": _launches(K1=2, K2=1, K5=2, K9=1, K7=1),
    # the modup iNTT, K5 per digit into the delta, K4p; the pair, rescale
    "headline step, xla route": _launches(K1=3, K3=2, K5=2, K4p=1),
    "headline step, kernel route": _launches(K1=3, K3=2, K4=1),
    "rotation": _launches(K1=2, K3=1, K4=1),
    "hoisting_sum32": _launches(K1=2, K3=2, K9=7),
    "hoisted_linear_combo32": _launches(K1=2, K3=2, K9=7),
    "alpha-8 step": _launches(K1=3, K3=2, K4=1),
    "alpha-8 step, K8 epilogue": _launches(K1=3, K3=1, K4=1, K8=1),
    "alpha-8 step, K7 epilogue": _launches(K1=2, K4=1, K7=1),
    "alpha-8 xla-split step": _launches(K1=3, K2=1, K3=2, K5=6, K9=1),
    # the JAX package's dispatch: 4 lifts and 3 scale-and-rounds of 2 K5
    # each; K4's coefficient form, the moddown pair (K1, K3)
    "BFV step, mxu-pallas": _launches(K1=3, K2=1, K3=1, K4c=1, K5=10),
    # every transform K6: D forward, modup, 2 moddown forwards (fused) and
    # D inverse, 2 moddown inverses, the switched pair; K5 also converts
    # each digit (2) and each moddown (2)
    "BFV step, pallas-roll": _launches(K5=14, K9=1, K6f=4, K6i=4),
    # lift="kernel": one K3 in place of the four lifts (K5 each) and K2
    "BFV step, fused lift": _launches(K1=3, K3=2, K4c=1, K5=6),
    # SmMRq per poly (K5 Ql -> Bsk, 4), K2 over Ql and over Bsk, K1 over
    # each; per output poly the fast floor (K5) and Shenoy-Kumaresan (K5
    # B -> Ql, K5 B -> {m_sk}); the relinearization as HPS's
    "BFV BEHZ step, mxu-pallas": _launches(K1=4, K2=2, K3=1, K4c=1, K5=13),
    "BFV BEHZ step, pallas-roll": _launches(K5=17, K9=1, K6f=5, K6i=5),
    # d1's lifts (2), d2's round to Rl and conversion to Ql (4), the final
    # rounds (3); the leveled technique without a drop runs the same calls
    "BFV HPSoverQ step, mxu-pallas": _launches(K1=3, K2=1, K3=1, K4c=1,
                                               K5=9),
    "BFV HPSoverQ step, pallas-roll": _launches(K5=13, K9=1, K6f=4, K6i=4),
    "BFV leveled step, mxu-pallas": _launches(K1=3, K2=1, K3=1, K4c=1, K5=9),
    "BFV leveled step, pallas-roll": _launches(K5=13, K9=1, K6f=4, K6i=4),
    # with a drop also d1's round to Ql (2) and the expansion back to Q (3)
    "BFV leveled step with a drop, mxu-pallas": _launches(
        K1=3, K2=1, K3=1, K4c=1, K5=14),
    "BFV leveled step with a drop, pallas-roll": _launches(
        K5=18, K9=1, K6f=4, K6i=4),
    # "auto" = xla-split at alpha 22: the modup (K1, K5 x2, K2), K9; both
    # halves' moddown K1, K5 to Ql and to {t}, K2; the mod switch K1, K2
    "BGV step": _launches(K1=3, K2=3, K5=4, K9=1),
    "BGV step, kernel route": _launches(K1=3, K2=2, K4=1, K5=2),
    # Fast32 at the headline configuration, "auto" = xla-split, beta = 2 at
    # every level the circuits visit; a verb without a kernel (add, sub,
    # negate, CKKS's plain ops, modswitch and decrypt, BFV's modswitch)
    "Fast32, no kernel": _launches(),
    # keygen: one K2 over the dnum encryptions of zero of each key
    "Fast32 gen_secret_key": _launches(K2=1),
    "Fast32 gen_public_key": _launches(K2=1),
    "Fast32 gen_relin_key": _launches(K2=1),
    "Fast32 create_galois_keys, 8 elements": _launches(K2=8),
    "Fast32 create_galois_keys, 1 element": _launches(K2=1),
    "Fast32 CKKS encode": _launches(K2=1),
    "Fast32 CKKS encode_extended": _launches(K2=1),
    "Fast32 CKKS decode": _launches(K1=1),
    # u over QlP (K2), e0 and e1 (one K2), the moddown pair (K1, K3)
    "Fast32 CKKS encrypt_asymmetric": _launches(K1=1, K2=2, K3=1),
    # the modup (K1, K5 per digit, K2), K9, the moddown pair with the
    # tensor terms in K3's epilogue (K1, K3)
    "Fast32 CKKS multiply_and_relin": _launches(K1=2, K2=1, K3=1, K5=2,
                                                K9=1),
    "Fast32 CKKS rescale_to_next": _launches(K1=1, K3=1),
    "Fast32 CKKS rotate": _launches(K1=2, K2=1, K3=1, K5=2, K9=1),
    "Fast32 CKKS hoisted_linear_combo, steps 0..7": _launches(
        K1=2, K2=1, K3=1, K5=2, K9=7),
    "Fast32 BGV encode": _launches(K1=1),
    "Fast32 BGV decode": _launches(K2=1),
    # u, e0 and e1, the plaintext's lift (K2 x3); the t-corrected moddown
    # of both halves (K1, K5 to Ql and to {t}, K2)
    "Fast32 BGV encrypt_asymmetric": _launches(K1=1, K2=4, K5=2),
    # the modup (K1, K5 x2, K2), K9, the t-corrected moddown pair
    "Fast32 BGV multiply_and_relin": _launches(K1=2, K2=2, K5=4, K9=1),
    "Fast32 BGV rotate": _launches(K1=2, K2=2, K5=4, K9=1),
    "Fast32 BGV mod_switch_to_next": _launches(K1=1, K2=1),
    "Fast32 BGV multiply_plain": _launches(K2=1),
    "Fast32 BGV decrypt": _launches(K1=1, K5=1),
    "Fast32 BFV encode": _launches(K1=1),
    "Fast32 BFV decode": _launches(K2=1),
    # u (K2), the inverse of u pk (K1), the exact moddown conversion of
    # both halves' P rows (K5)
    "Fast32 BFV encrypt_asymmetric": _launches(K1=1, K2=1, K5=1),
    "Fast32 BFV multiply_plain": _launches(K1=1, K2=1),
    # K4c, the moddown pair (K1, K3), the switched pair's inverse (K1)
    "Fast32 BFV rotate": _launches(K1=2, K3=1, K4c=1),
    "Fast32 BFV decrypt": _launches(K1=1, K2=1, K5=1),
}
EPILOGUES = {  # the CKKS step's epilogues, by the kernel each adds
    "pair": {}, "K8": {"moddown_rows": 8}, "K7": {"merged_epilogue": True}}
# Phase 26's timing probes of the one-pass core (csrc/ntt_cluster.cuh)
# under K3, K4, K7, K8, K2 and K1, and of K5, each built from a patched copy
# of the sources (the base is the library as built; every patch replaces
# each occurrence, so the core's patches reach both directions).  Most
# remove one part of the work, so their results are wrong by design and
# only their times are read; the others take a path the wrappers do not:
# K1 and K2 at two blocks per SM, the conversion's product-sum with a
# carry word, K8 with one transform per held row in place of one over all
# of them, K8 at 512 threads a block where it holds up to 4 rows, and K7's
# second launch in plain stream order (without PDL).
# name: [(file, old, new)]
_TERMS = "const int terms = min(alpha"
_FWD = "  cluster_ntt(s, cluster, G, rank, tb.w + trow, tb.ws + trow, bq.q);"
_HELD = ("    cluster_ntt_rows(s, cluster, G, rank,\n"
         "                     HeldRows{rr, tb.w, tb.ws, G.logn, nh, words});")
_K7B = "launch_cluster<false, 0, true>("  # K7's second launch, under PDL
ANATOMY = {
    "no transform": [
        ("bconv_ntt.cu", _FWD, "  __syncthreads();"),
        ("modup_ip.cu", "  " + _FWD, "    __syncthreads();"),
        ("ntt.cu", "  cluster_intt(s, cluster, G, rank, tb.w + trow, "
         "tb.ws + trow, q);", "  __syncthreads();"),
        ("ntt.cu", _FWD, "  __syncthreads();"),
        ("moddown_rows.cu", _HELD, "    __syncthreads();")],
    "one-term prologue": [
        (f, _TERMS, "const int terms = 1 + 0 * min(alpha")
        for f in ("bconv_args.cuh", "modup_ip.cu")] + [
        ("moddown_rows.cu", "for (int i = 0; i < a.alpha; ++i) {",
         "for (int i = 0; i < 1 + 0 * a.alpha; ++i) {")],
    "no crossing stages or cluster syncs": [
        ("ntt_cluster.cuh", "  if (G.logc > 0) {", "  if (G.logc > 9) {")],
    "no local passes": [
        ("ntt_cluster.cuh", "  for (int left = G.logs; left > 0;) {",
         "  for (int left = 0; left > 0;) {"),
        ("ntt_cluster.cuh", "  for (int ls = 0; ls < G.logs;) {",
         "  for (int ls = G.logs; ls < G.logs;) {")],
    "twiddles from L1": [
        ("ntt_cluster.cuh", "__ldg(w + (g1 << s) + b)", "__ldg(w + b)"),
        ("ntt_cluster.cuh", "__ldg(ws + (g1 << s) + b)", "__ldg(ws + b)")],
    "no floor sum": [
        ("ntt.cu", "  if (e != cudaSuccess || v == nullptr) return "
         "static_cast<int>(e);", "  return static_cast<int>(e);")],
    "K1 at 2 blocks per SM": [
        ("ntt.cu", "__launch_bounds__(kClusterThreads, 3)\n"
         "inv_cluster_kernel(", "__launch_bounds__(kClusterThreads, 2)\n"
         "inv_cluster_kernel(")],
    "K2 at 2 blocks per SM": [
        ("ntt.cu", "__launch_bounds__(kClusterThreads, 3)\n"
         "fwd_cluster_kernel(", "__launch_bounds__(kClusterThreads, 2)\n"
         "fwd_cluster_kernel(")],
    "K8 at 512 threads a block": [
        ("moddown_rows.cu", "H <= kFewRows ? 1024 : kClusterThreads",
         "kClusterThreads")],
    "K8 one transform per held row": [
        ("moddown_rows.cu", _HELD,
         "    for (int r = 0; r < nh; ++r)\n"
         "      cluster_ntt(s + r * words, cluster, G, rank,\n"
         "                  tb.w + (static_cast<int64_t>(rr[r].limb) << "
         "G.logn),\n"
         "                  tb.ws + (static_cast<int64_t>(rr[r].limb) << "
         "G.logn),\n"
         "                  rr[r].q);")],
    "K7 without PDL": [("moddown_rescale.cu", _K7B, "launch_cluster(")],
    "K7 launch A alone": [
        ("moddown_rescale.cu", "  if (e == cudaSuccess)\n    e = " + _K7B,
         "  if (false)\n    e = " + _K7B)],
    "K7 launch B alone": [
        ("moddown_rescale.cu", "cudaError_t e = launch_cluster(",
         "cudaError_t e = cudaSuccess;\n  if (false) e = launch_cluster(")],
    "K7 no transform": [
        ("moddown_rescale.cu", "  cluster_ntt(s, cluster, G, rank, tb.w + "
         "trow, tb.ws + trow, q);", "  __syncthreads();"),
        ("moddown_rescale.cu", "  cluster_intt(s, cluster, G, rank, a.winv "
         "+ trow, a.winvs + trow, q);", "  __syncthreads();")],
    # K5: the conditions depend on k_in at run time, so the compiler keeps
    # the rest of the work
    "no plane products": [
        ("bconv.cu", "k0 < G.kq;", "k0 < G.kq * (k_in > 9999);")],
    "no fold": [
        ("bconv.cu", "            x = csub(x + mul_shoup_lazy(acc[d][e], "
         "tj[1 + d], tj[8 + d], qj),\n                     q2);",
         "            x += acc[d][e];")],
    "no fold table": [
        ("bconv.cu", "j < k_out; j += blockDim.x) {",
         "j < k_out * (k_in > 9999); j += blockDim.x) {"),
        ("bconv.cu", "e < 7 * k_out; e += blockDim.x) {",
         "e < 7 * k_out * (k_in > 9999); e += blockDim.x) {")],
    "no y planes": [
        ("bconv.cu", "u < (kK5Cols / 4) * G.kq;",
         "u < (kK5Cols / 4) * G.kq * (k_in > 9999);")],
    "no store": [
        ("bconv.cu", "      if (j < k_out && c < n) {",
         "      if (j < k_out && c < n && k_in > 9999) {")],
    "carry product-sum": [
        ("bconv_args.cuh", "    if (wide) {", "    if (false) {"),
        ("modup_ip.cu", "    if (wide_conv) {", "    if (false) {"),
        ("moddown_rows.cu", "  if (a.wide) {", "  if (false) {")],
}
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 132 * 64 * 1.98e9
INT8_TC_OPS_PER_S = 1979e12  # NVIDIA's H100 SXM data sheet, dense int8


# ---------------------------------------------------------------------------
# helpers (also driven on the CPU by tests/test_torch_pipeline.py and
# tests/test_torch_rotate.py)
# ---------------------------------------------------------------------------

def chain_params(n: int, limbs: int, alpha: int, bits: int = 28):
    """Primes as utils/benchsetup.py builds them: `limbs` data primes of
    `bits` bits, `alpha` special primes of bits + 1."""
    from phantom_tpu_torch import EncryptionParameters
    from phantom_tpu_torch.host import numth
    qs = numth.get_primes(2 * n, bits, limbs + 1)
    ps = numth.get_primes(2 * n, bits + 1, alpha)
    return EncryptionParameters.create(n, qs[:limbs], ps)


def mod_t_params(n: int, limbs: int, alpha: int, bits: int = 28,
                 t_bits: int = 20, scheme: str = "bfv", mul_tech: str = "hps"):
    """chain_params' primes with the plain modulus, the largest t_bits-bit
    prime == 1 mod 2n (bench.py --scheme bfv, and bgv; BFV multiplies by
    `mul_tech`)."""
    from phantom_tpu_torch import EncryptionParameters
    from phantom_tpu_torch.host.modulus import PlainModulus
    p = chain_params(n, limbs, alpha, bits)
    return EncryptionParameters.create(n, p.data_moduli, p.special_moduli,
                                       scheme,
                                       PlainModulus.batching(n, t_bits),
                                       mul_tech=mul_tech)


def make_mod_t_inputs(ctx, seed: int, device):
    """The secret key, the relin key over QP and two symmetric encryptions
    of random polynomials with coefficients in [-3, 3], from a seeded
    generator on `device` (BFV or BGV)."""
    import torch
    from phantom_tpu_torch.schemes import keys
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sk = keys.gen_secret_key(ctx, gen)
    rlk = keys.gen_relin_key(ctx, sk, gen)
    rng = np.random.default_rng(seed)
    m1, m2 = (rng.integers(-3, 4, ctx.params.n) for _ in range(2))
    d1, d2 = (keys.encrypt_symmetric(ctx, sk, torch.as_tensor(m,
                                                              device=device),
                                     gen) for m in (m1, m2))
    return sk, rlk, d1, d2, m1, m2


def hps_bound(ctx):
    """(log2 Rl/Ql, log2 2Nt, whether Rl/Ql > 2Nt) at chain index 1.  The
    HPS step lifts each operand to its value in [0, Ql), so a product
    coefficient is below N Ql^2 in size and W = round(t x / Ql) below
    N t Ql; W is read back from its residues mod Rl as a centered value,
    which is exact only when |W| < Rl / 2: Rl / Ql > 2 N t suffices."""
    import math
    b = ctx.get_context_data(1).bfv
    margin = sum(math.log2(r) for r in b.rl) - math.log2(b.big_ql)
    need = math.log2(2 * ctx.params.n * ctx.params.plain_modulus)
    return margin, need, margin > need


def multech_bound(ctx, tech: str, lvl: int = 0):
    """(margin, need, inside, what): the bound under which a BFV product of
    two fresh ciphertexts at chain index 1 decrypts to m1 m2, as this code
    reckons it for each technique (log2 of each side):
      hps      hps_bound: Rl/Ql > 2 N t;
      behz     SmMRq lifts each operand to its representative below
               Q (1/2 + (k + 1) / 2^32) in size, so a product coefficient
               is below N Q^2 / 2 (two cross terms) and y = floor(t x / Q)
               (the fast floor: minus less than k) below N t Q / 2 + k;
               Shenoy-Kumaresan takes y mod B plus g B (0 <= g < k) and
               reads g - floor(y / B) centered mod m_sk, exact when
               N t Q / B + k + 1 < m_sk / 2;
      overq, leveled   the product over D wraps by multiples of Ql Rl,
               which round(t/Rl .) maps to multiples of t Ql, 0 mod Ql; the
               rounding of w = round(Rl x2 / Q) adds at most N t Ql / Rl
               (x1 < Ql, two cross terms), below Delta/2 = Ql / 2t when
               Rl > 2 N t^2, at level 1 + lvl (a leveled product with a
               drop carries the dropped level's Delta, so it decrypts over
               that level's Ql)."""
    import math
    p = ctx.params
    n, t = p.n, p.plain_modulus
    if tech == "hps":
        margin, need, _ = hps_bound(ctx)
        return margin, need, margin > need, "log2 Rl/Ql against 2Nt"
    if tech == "behz":
        cd = ctx.get_context_data(1)
        k = cd.size_ql
        big_b = math.prod(cd.behz.bsk[:-1])
        margin = math.log2(cd.behz.bsk[-1] / 2)
        need = math.log2(n * t * cd.bfv.big_ql / big_b + k + 1)
        return (margin, need, margin > need,
                "log2 m_sk/2 against NtQ/B + k + 1")
    rl = ctx.get_context_data(1 + lvl).bfv.rl
    margin = sum(math.log2(r) for r in rl)
    need = math.log2(2 * n * t * t)
    return (margin, need, margin > need,
            f"log2 Rl against 2Nt^2 at level {1 + lvl}")


def bfv_golden(device, path: str = BFV_GOLDEN):
    """The BFV golden file through the port on `device`: {name: (port
    output, JAX output)} for the step and the key switch of d1[1] on each
    engine, and the decryption of the JAX step output."""
    from phantom_tpu_torch import convert, make_context
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    g = np.load(path)
    ctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), "bfv", int(g["t"])), device=device)
    d1, d2, out, sk = (convert.residues(g[k]).to(device)
                       for k in ("d1", "d2", "out", "sk"))
    res = {"decrypt": (keys.decrypt(ctx, sk, out), g["pt_out"])}
    for engine in ENGINES:
        p = convert.bfv_pipeline(ctx, g["rlk"], engine=engine)
        res[f"step, {engine}"] = (p(d1, d2), g["out"])
        res[f"keyswitch32, {engine}"] = (pp.keyswitch32(p.ks, d1[1], p.evk),
                                         g["keyswitch"])
    return res


# the golden file's techniques: BEHZ, HPSoverQ, leveled at the noise
# model's drop (0 there) and with force_lvl=1
GOLDEN_TECHS = ("behz", "overq", "lev0", "lev1")


def bfv_multech_golden(device, engines=ENGINES, ops=None):
    """bfv_multech_n1024.npz through the port on `device`: {name: (port,
    JAX)} as numpy arrays: the Bsk base; each technique's multiply and
    multiply + relinearize on each engine (the pipelines through
    convert.py); the fused lift of (d1, d2); the port's decryption of each
    JAX output; each invariant_noise_budget."""
    import torch
    from phantom_tpu_torch import convert, make_context
    from phantom_tpu_torch.ops import bfv32
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes.ciphertext import Ciphertext
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    ops = pp.KERNELS if ops is None else ops
    g = np.load(BFV_MULTECH_GOLDEN)
    # the BEHZ context holds Bsk; every technique's pipeline runs on it
    ctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), "bfv", int(g["t"]), mul_tech="behz"),
        device=device)

    def on(name):
        return convert.residues(g[name]).to(device)

    def u32(x):
        return x.cpu().numpy().astype(np.uint32)

    sk, d1, d2 = on("sk"), on("d1"), on("d2")
    res = {"Bsk": (np.array(ctx.bsk_moduli, dtype=np.uint64),
                   g["bsk_moduli"])}
    for e in engines:
        pipes = {
            "behz": (convert.bfv_behz_pipeline(ctx, g["rlk"], engine=e),
                     bfv32.bfv_mult_behz32, bfv32.bfv_mult_relin_behz32),
            "overq": (convert.bfv_pipeline(ctx, g["rlk"], engine=e),
                      bfv32.bfv_mult_hps_overq32,
                      bfv32.bfv_mult_relin_overq32)}
        for tech in ("lev0", "lev1"):
            pipes[tech] = (convert.bfv_leveled_pipeline(
                ctx, g["rlk"], engine=e, force_lvl=None if tech == "lev0"
                else 1), bfv32.bfv_mult_leveled32,
                bfv32.bfv_mult_relin_leveled32)
        for tech, (p, mul, relin) in pipes.items():
            res[f"{tech} multiply, {e}"] = (u32(mul(p, d1, d2, ops)),
                                            g[f"mul_{tech}"])
            res[f"{tech} multiply + relin, {e}"] = (
                u32(relin(p, d1, d2, ops)), g[f"relin_{tech}"])
    pf = convert.bfv_pipeline(ctx, g["rlk"], lift="kernel")
    res["fused lift"] = (u32(bfv32._lift_ntt_fused(
        pf, torch.cat([d1, d2]), ops)), g["lift"])
    res["d1 noise budget"] = (np.array(keys.invariant_noise_budget(
        ctx, sk, Ciphertext(d1), ops)), g["budget_d1"])
    for tech in GOLDEN_TECHS:
        for kind in ("mul", "relin"):
            res[f"{tech} decrypt of {kind}"] = (u32(keys.decrypt(
                ctx, sk, on(f"{kind}_{tech}"), ops=ops)),
                g[f"pt_{kind}_{tech}"])
        res[f"{tech} noise budget"] = (np.array(keys.invariant_noise_budget(
            ctx, sk, Ciphertext(on(f"relin_{tech}")), ops)),
            g[f"budget_{tech}"])
    return res


def bgv_golden(device, path: str = BGV_GOLDEN):
    """The BGV golden file through the port on `device`: {name: (port
    output, JAX output)} for the step on the "auto" and "kernel" routes
    and the decryption of the JAX step output with its correction
    factor."""
    from phantom_tpu_torch import convert, make_context
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    g = np.load(path)
    ctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), "bgv", int(g["t"])), device=device)
    d1, d2, out, sk = (convert.residues(g[k]).to(device)
                       for k in ("d1", "d2", "out", "sk"))
    res = {"decrypt": (keys.decrypt(ctx, sk, out, int(g["cf"])),
                       g["pt_out"])}
    for route in ("auto", "kernel"):
        p = convert.bgv_pipeline(ctx, g["rlk"], modup=route)
        res[f"step, {route} route"] = (p(d1, d2), g["out"])
    return res


def encode_coeffs(ctx, m: np.ndarray, delta_bits: int, rows=None):
    """Integer polynomial m (N,) times 2^delta_bits -> NTT-form plaintext
    over the table rows `rows` (default all data primes), int32."""
    import torch
    from phantom_tpu_torch.ops import ntt_kernels, sampling
    if rows is None:
        rows = ctx.ntt.all_rows()[:ctx.params.size_q]
    e = torch.as_tensor(m.astype(np.int64) << delta_bits,
                        device=ctx.key_q.device)
    return ntt_kernels.ntt_forward(
        sampling.lift_signed_to_rns32(e, ctx.ntt.q[rows.long()]), ctx.ntt,
        rows)


def negacyclic_product(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """m1 m2 mod X^N + 1 for small integer polynomials, exactly."""
    n = m1.shape[0]
    f = np.fft.rfft(m1.astype(np.float64), 2 * n) * np.fft.rfft(
        m2.astype(np.float64), 2 * n)
    full = np.fft.irfft(f, 2 * n)
    exact = np.rint(full).astype(np.int64)
    if np.abs(full - exact).max() >= 0.25:
        raise RuntimeError("negacyclic_product: FFT not exact")
    return exact[:n] - exact[n:]


def galois_coeffs(m: np.ndarray, elt: int) -> np.ndarray:
    """sigma_elt on an integer polynomial: coefficient i moves to i elt mod
    2N and is negated when it lands at N or above."""
    n = m.shape[0]
    dst = np.arange(n, dtype=np.int64) * elt % (2 * n)
    out = np.zeros_like(m)
    out[dst % n] = np.where(dst >= n, -m, m)
    return out


def make_step_inputs(ctx, seed: int, delta_bits: int, device):
    """Keys on `device` from a seeded generator and two encryptions of
    random polynomials with coefficients in [-3, 3]."""
    import torch
    from phantom_tpu_torch.ops.pipeline32 import build_pipeline32
    from phantom_tpu_torch.schemes import keys
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sk = keys.gen_secret_key(ctx, gen)
    pipe = build_pipeline32(ctx, keys.gen_relin_key(ctx, sk, gen),
                            device=device)
    rng = np.random.default_rng(seed)
    m1, m2 = (rng.integers(-3, 4, ctx.params.n) for _ in range(2))
    d1, d2 = (keys.encrypt_symmetric(ctx, sk, encode_coeffs(
        ctx, m, delta_bits), gen) for m in (m1, m2))
    return sk, pipe, d1, d2, m1, m2


def make_galois(ctx, sk, seed: int, steps, device):
    """Galois keys for `steps` from a seeded generator -> Galois32."""
    import torch
    from phantom_tpu_torch.ops.pipeline32 import build_galois32
    from phantom_tpu_torch.schemes import keys
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    return build_galois32(ctx, keys.create_galois_keys(ctx, sk, gen, steps),
                          device=device)


def decrypt_coeffs(ctx, sk, ct, scale: float) -> np.ndarray:
    """Decrypt, CRT the first two limbs to the centred value, divide by
    `scale`: float64 (N,)."""
    from phantom_tpu_torch.ops import ntt_kernels
    from phantom_tpu_torch.schemes import keys
    pt = keys.decrypt(ctx, sk, ct)
    x = ntt_kernels.ntt_inverse(pt[:2].contiguous(), ctx.ntt,
                                ctx.ntt.all_rows()[:2]).cpu().numpy()
    q0, q1 = ctx.params.data_moduli[:2]
    r0, r1 = x[0].astype(np.int64), x[1].astype(np.int64)
    t = (r1 - r0) % q1 * pow(q0, -1, q1) % q1
    val = r0 + q0 * t
    val = np.where(val > q0 * q1 // 2, val - q0 * q1, val)
    return val.astype(np.float64) / scale


def check_coeffs(est: np.ndarray, want: np.ndarray, what: str) -> float:
    """Raise unless est rounds to want in every coefficient; return the
    largest distance before rounding."""
    got = np.rint(est).astype(np.int64)
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)
        raise RuntimeError(f"{what}: {bad.size} coefficients differ, first "
                           f"at {bad[0]}: {got[bad[0]]} != {want[bad[0]]}")
    return float(np.abs(est - want).max())


def check_decrypt(ctx, sk, out, m1, m2, delta_bits: int) -> float:
    """The step's output (scale 2^(2 delta_bits) / q_last) decrypts to
    m1 m2 in every coefficient; returns the largest distance before
    rounding."""
    qlast = ctx.params.data_moduli[out.shape[1]]
    return check_coeffs(decrypt_coeffs(ctx, sk, out,
                                       2.0 ** (2 * delta_bits) / qlast),
                        negacyclic_product(m1, m2), "decrypt")


def encode_weights(ctx, ks, w: np.ndarray):
    """Integer polynomial w (N,) -> NTT-form (size_qlp, N) weights over
    QlP, for hoisted_linear_combo32."""
    return encode_coeffs(ctx, w, 0, ks.rows_qlp)


def remix(out, q):
    """A step output (2, k-1, N) -> a full (2, k, N) input: the dropped
    limb is row 0 reduced into its modulus (bench.py's re-pad)."""
    import torch
    row0 = out[:, :1]
    pad = torch.where(row0 >= q, row0 - q, row0)
    return torch.cat([out, pad], dim=1)


def rotate_golden_state(device, path: str = ROTATE_GOLDEN):
    """The rotation golden file on `device`: (the file, its context, the
    key-switch tables, its Galois keys, its tensors d1, d2, pts,
    moddown_in)."""
    from phantom_tpu_torch import convert, make_context
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    g = np.load(path)
    ctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist()), device=device)
    ks = pp.build_keyswitch32(ctx, device=device)
    gal = convert.galois_keys(ctx, g["glk"], g["elts"].tolist())
    t = {k: convert.residues(g[k]).to(device)
         for k in ("d1", "d2", "pts", "moddown_in")}
    return g, ctx, ks, gal, t


def rotate_golden(device, path: str = ROTATE_GOLDEN):
    """The rotation golden file through the port on `device`: returns
    {name: (port output, JAX output)} for the rotation, the key switch,
    both hoisted forms, moddown32 and the step through each epilogue of
    EPILOGUES (K8's last block of rows at k = 5 masks three)."""
    from phantom_tpu_torch import convert
    from phantom_tpu_torch.ops import pipeline32 as pp
    g, ctx, ks, gal, t = rotate_golden_state(device, path)
    rlk = convert.residues(g["rlk"]).to(device)
    d1 = t["d1"]
    kidx = gal.key_index(int(g["elts"][0]))
    out = {
        "rotate": (pp.rotate32(ks, gal, d1, 1), g["rotate"]),
        "keyswitch": (pp.keyswitch_from_ntt32(ks, d1[1], gal.evks[kidx]),
                      g["keyswitch"]),
        "hoisting_sum": (pp.hoisting_sum32(ks, gal, d1,
                                           g["hoist_steps"].tolist()),
                         g["hoist"]),
        "linear_combo": (pp.hoisted_linear_combo32(
            ks, gal, d1, g["combo_steps"].tolist(), list(t["pts"])),
            g["combo"]),
        "moddown": (pp.moddown32(ks, t["moddown_in"]), g["moddown"]),
    }
    for name, kw in EPILOGUES.items():
        pipe = pp.build_pipeline32(ctx, rlk, device=device, **kw)
        out["step" if name == "pair" else f"step_{name}"] = (
            pipe(d1, t["d2"]), g["step"])
    return out


# ---------------------------------------------------------------------------
# Fast32: the golden files and the circuits
# ---------------------------------------------------------------------------

# tests/fixtures/torch_port/fast32_<case>.npz and each case's scheme
FAST32_CASES = {"ckks_chain": "ckks", "bgv_chain": "bgv",
                "encrypt_ckks": "ckks", "encrypt_bfv": "bfv",
                "encrypt_bgv": "bgv", "combo": "ckks", "verbs_ckks": "ckks",
                "verbs_bfv": "bfv", "verbs_bgv": "bgv",
                "keygen_ckks": "ckks", "keygen_bgv": "bgv"}


def fast32_case(case: str, device, engine: str = "mxu-pallas"):
    """A Fast32 golden file on `device`: (the file, its context, its keys
    carried over by convert.py (sk, pk, rlk, glk, None where absent), a
    Fast32 with its rlk and glk on `engine`)."""
    from types import SimpleNamespace
    from phantom_tpu_torch import Fast32, convert, make_context
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    g = np.load(os.path.join(FIXTURES, f"fast32_{case}.npz"))
    ctx = make_context(EncryptionParameters.create(
        int(g["sk"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), FAST32_CASES[case], int(g["t"])),
        device=device)
    got = {name: f(ctx, SimpleNamespace(data=g[name])) if name in g
           else None for name, f in (("sk", convert.secret_key),
                                     ("pk", convert.public_key),
                                     ("rlk", convert.relin_key))}
    got["glk"] = convert.galois_key_set(ctx, SimpleNamespace(
        data=g["glk"], elts=g["elts"].tolist())) if "glk" in g else None
    return g, ctx, got, Fast32(ctx, rlk=got["rlk"], glk=got["glk"],
                               engine=engine)


def fast32_ct(ctx, g, name: str):
    """The golden file's ciphertext `name` as the port's, metadata and
    all."""
    from types import SimpleNamespace
    from phantom_tpu_torch import convert
    meta = g[name + "__meta"].tolist()
    return convert.ciphertext(ctx, SimpleNamespace(
        data=g[name], chain_index=meta[0], is_ntt_form=meta[1],
        scale=float(g[name + "__scale"]), correction_factor=meta[2],
        noise_scale_deg=meta[3]))


def fast32_pt(ctx, g, name: str):
    from types import SimpleNamespace
    from phantom_tpu_torch import convert
    meta = g[name + "__meta"].tolist()
    return convert.plaintext(ctx, SimpleNamespace(
        data=g[name], chain_index=meta[0], is_ntt_form=meta[1],
        scale=float(g[name + "__scale"])))


def _samples(g, name: str, device):
    import torch
    return (torch.from_numpy(g[name + "_u"]).to(device),
            torch.from_numpy(g[name + "_e"]).to(device))


def fast32_golden(device, cases=tuple(FAST32_CASES), ops=None):
    """The Fast32 golden files through the port on `device`: {"<case>:
    <name>": (port output, JAX output)}, numpy arrays (residues as uint32,
    decoded slots as they are); each ciphertext's and plaintext's metadata
    is checked against the file's on the way (RuntimeError)."""
    import torch
    from phantom_tpu_torch import BatchEncoder, CKKSEncoder, encode_extended
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes import galois, keys
    ops = pp.KERNELS if ops is None else ops
    out = {}

    def res(x):
        return x.cpu().numpy().view(np.uint32)

    def cmp(case, g, name, c):
        meta = g[name + "__meta"].tolist()
        have = [c.chain_index, int(c.is_ntt_form)]
        if len(meta) > 2:
            have += [c.correction_factor, c.noise_scale_deg]
        if have != meta or c.scale != float(g[name + "__scale"]):
            raise RuntimeError(f"Fast32 golden {case}: {name} metadata "
                               f"{have}, scale {c.scale} != {meta}, "
                               f"{float(g[name + '__scale'])}")
        out[f"{case}: {name}"] = (res(c.data), g[name])

    for case in cases:
        g, ctx, k, ev = fast32_case(case, device)
        scheme = FAST32_CASES[case]
        if case.startswith("keygen"):
            t = {n: torch.from_numpy(g[n].view(np.int32) if g[n].dtype ==
                                     np.uint32 else g[n]).to(device)
                 for n in ("s_tern", "pk_a", "pk_e", "rlk_a", "rlk_e",
                           "glk_a", "glk_e")}
            sk = keys.gen_secret_core32(ctx, t["s_tern"], ops)
            q = ctx.key_q.long().view(-1, 1)
            gen = {"sk": sk, "pk": torch.stack(keys.encrypt_zero_sym_core32(
                       ctx, sk, t["pk_a"], t["pk_e"], ops)),
                   "rlk": keys.gen_kswitch_core32(
                       ctx, sk, (sk.long() * sk.long() % q).int(),
                       t["rlk_a"], t["rlk_e"], ops)}
            gen["glk"] = torch.stack([keys.gen_kswitch_core32(
                ctx, sk, sk[:, torch.from_numpy(galois.make_ntt_perm(
                    e, ctx.params.n)).to(device)], t["glk_a"][i],
                t["glk_e"][i], ops) for i, e in enumerate(g["elts"].tolist())])
            for name, x in gen.items():
                out[f"{case}: {name}"] = (res(x), g[name])
            continue
        sk, pk = k["sk"], k["pk"]
        if scheme == "ckks":
            enc = CKKSEncoder(ctx)
        else:
            enc = BatchEncoder(ctx)

        def encrypt(pt, samples):
            ci = pt.chain_index if scheme == "ckks" else 1
            return keys.encrypt_asymmetric_core(
                ctx, ev.keyswitch_at(ci), pk, pt, *samples, ops=ops)

        def decode(name, pt):
            got = enc.decode(pt, ops)
            out[f"{case}: {name}"] = (got, g[name])

        if case == "ckks_chain":
            pt = enc.encode(g["z"], 2.0 ** 28, ops=ops)
            cmp(case, g, "pt", pt)
            c = encrypt(pt, _samples(g, "enc", device))
            cmp(case, g, "ct", c)
            for name in ("m1", "r1", "m2", "r2"):
                c = (ev.multiply_and_relin(c, c, ops) if name[0] == "m"
                     else ev.rescale_to_next(c, ops))
                cmp(case, g, name, c)
            c = ev.rotate(c, 1, ops)
            cmp(case, g, "rot", c)
            dec = ev.decrypt(sk, c, ops)
            cmp(case, g, "dec", dec)
            decode("decoded", dec)
        elif case == "bgv_chain":
            pa, pb = (enc.encode(g[v], ops) for v in ("a", "b"))
            cmp(case, g, "pa", pa)
            cmp(case, g, "pb", pb)
            ca = encrypt(pa, _samples(g, "enca", device))
            cb = encrypt(pb, _samples(g, "encb", device))
            cmp(case, g, "ca", ca)
            cmp(case, g, "cb", cb)
            ms_a = ev.mod_switch_to_next(ca, ops)
            big_a = ev.mod_switch_to_next(ev.multiply_and_relin(ca, cb, ops),
                                          ops)
            big_b = ev.multiply_and_relin(ms_a, ev.mod_switch_to_next(cb, ops),
                                          ops)
            s = ev.add(big_a, big_b)
            s3 = ev.mod_switch_to_next(s, ops)
            for name, c in (("ms_a", ms_a), ("A", big_a), ("B", big_b),
                            ("s", s), ("s3", s3)):
                cmp(case, g, name, c)
            dec = ev.decrypt(sk, s3, ops)
            cmp(case, g, "dec", dec)
            decode("slots", dec)
        elif case.startswith("encrypt"):
            pt = (enc.encode(g["vals"], 2.0 ** 24, ops=ops) if scheme == "ckks"
                  else enc.encode(g["vals"], ops))
            cmp(case, g, "pt", pt)
            c = encrypt(pt, _samples(g, "enc", device))
            cmp(case, g, "ct", c)
            dec = ev.decrypt(sk, c, ops)
            cmp(case, g, "dec", dec)
            decode("decoded", dec)
        elif case == "combo":
            c = fast32_ct(ctx, g, "ct")
            scale = c.scale
            pts = [encode_extended(enc, w, scale, c.chain_index, ops)
                   for w in g["weights"]]
            out[f"{case}: pts"] = (res(torch.stack(pts)), g["pts"])
            cmp(case, g, "combo", ev.hoisted_linear_combo(c, [0, 1, 2], pts,
                                                          scale, ops))
            cmp(case, g, "hoist", ev.hoisting(c, [1, 2], ops))
            cmp(case, g, "galois", ev.apply_galois(c, int(g["elts"][1]), ops))
        else:  # verbs
            c, c2 = fast32_ct(ctx, g, "c"), fast32_ct(ctx, g, "c2")
            pt2 = fast32_pt(ctx, g, "pt2")
            c3 = ev.multiply(c, c2, ops)
            mr = ev.multiply_and_relin(c, c2, ops)
            verbs = dict(
                add=ev.add(c, c2), sub=ev.sub(c, c2), negate=ev.negate(c),
                add_plain=ev.add_plain(c, pt2, ops),
                sub_plain=ev.sub_plain(c, pt2, ops),
                multiply_plain=ev.multiply_plain(c, pt2, ops),
                mod_switch=ev.mod_switch_to_next(c, ops), multiply=c3,
                relinearize=ev.relinearize(c3, ops), multiply_and_relin=mr,
                square_and_relin=ev.square_and_relin(c, ops),
                rotate=ev.rotate(c, 1, ops))
            if scheme == "ckks":
                verbs["rescale"] = ev.rescale_to_next(mr, ops)
            if scheme == "bgv":
                verbs["add_plain_ms"] = ev.add_plain(verbs["mod_switch"], pt2,
                                                     ops)
            for name, x in verbs.items():
                cmp(case, g, name, x)
            cmp(case, g, "dec", ev.decrypt(sk, mr, ops))
    return out


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for one kernel call
# ---------------------------------------------------------------------------

def _n(x) -> int:
    return 0 if x is None else x.numel()


def _ntt_ops(rows: int, n: int) -> int:
    return rows * (n // 2) * (n.bit_length() - 1) * 3


def _max(x) -> int:
    """The largest word of an int32 residue tensor (every modulus is below
    2^31, so no word is negative)."""
    return int(x.max())


def _reduce_ops(terms: int, a_max: int, b_max: int) -> int:
    """Multiplies that reduce a sum of `terms` products a b with a <= a_max,
    b <= b_max: a 64-bit Barrett reduction (6) when the sum cannot leave 64
    bits, else a 128-bit one (20)."""
    return 6 if terms * a_max * b_max < 1 << 64 else 20


def _table_bytes(t, rows, num_l: int) -> int:
    """The twiddle table rows a call reads, with their Shoup words."""
    used = num_l if rows is None else len(set(rows.tolist()))
    return used * t.root_powers.shape[1] * 8


def call_bound(name: str, a: dict, out):
    """(bytes, 32-bit multiplies, int8 tensor-core operations) of one call
    from its bound arguments."""
    byt, ops = _call_work(name, a, out)
    tc_ops = 0
    if name == "K5":  # 16 plane products, 2 k_out k_in N operations each
        k_out, k_in = a["mat"].shape
        tc_ops = 16 * 2 * k_out * k_in * a["y"].shape[1]
    return byt, ops, tc_ops


def _call_work(name: str, a: dict, out):
    """(bytes, 32-bit multiplies) of one call."""
    w = 4
    if name == "K5":  # the fold: 7 Shoup products per output
        return (w * (_n(a["y"]) + _n(a["mat"]) + _n(out)), 7 * 3 * _n(out))
    if name in ("K1", "K2", "K6f", "K6i"):
        x = a["x"]
        n, num_l = x.shape[-1], x.shape[-2]
        rows_n = x.numel() // n
        out0 = out[0] if isinstance(out, tuple) else out
        byt = w * (x.numel() + out0.numel()) + _table_bytes(
            a["t"], a["rows"], num_l)
        ops = _ntt_ops(rows_n, n)
        if name in ("K1", "K6i"):
            ops += 3 * x.numel()
            if a["mul_by"] is not None:
                byt += w * a["mul_by"].numel()
                ops += 8 * x.numel()
            if a["emit_floor_div"] is not None:
                byt += w * _n(out[1])
                ops += 20 * x.numel()
        else:
            if a["sub_from"] is not None:
                byt += w * a["sub_from"].numel()
                ops += 3 * x.numel()
            if a["tensor_add"] is not None:
                byt += w * sum(_n(d) for d in a["tensor_add"])
                ops += 9 * x.numel()
        return byt, ops
    if name in ("K3", "K8"):
        y, mat = a["y"], a["mat"]
        # K3's y may be (k_in, N), its last group short; K8's is (2, alpha,
        # N) with a (k, alpha) matrix serving both halves
        g_, alpha, n = (mat.shape[0], mat.shape[2], y.shape[-1]) \
            if name == "K3" else y.shape
        k_out = mat.shape[-2]
        self_n = 0
        if name == "K3" and a["self_rows"] is not None:
            kd = g_ * alpha if a["k_data"] is None else a["k_data"]
            self_n = sum(max(0, min((g + 1) * alpha, kd, k_out) - g * alpha)
                         for g in range(g_))
        conv = g_ * k_out - self_n
        byt = w * (y.numel() + mat.numel() + _n(out) + self_n * n
                   + _n(a["v"]) + _n(a["sub_from"])
                   + sum(_n(d) for d in a["tensor_add"] or ())) + \
            _table_bytes(a["t"], a["rows"], k_out)
        ops = conv * n * (2 * alpha + _reduce_ops(alpha, _max(y), _max(mat)))
        ops += _ntt_ops(conv, n)
        ops += 8 * conv * n if a["v"] is not None else 0
        ops += 3 * _n(a["sub_from"])
        ops += 9 * _n(out) if a["tensor_add"] is not None else 0
        return byt, ops
    if name == "K9":
        t, evk = a["t"], a["evk"]
        beta, k_out, n = t.shape
        byt = w * (t.numel() + evk.numel() + _n(out) + _n(a["perm"]))
        return byt, (4 * beta * k_out * n + 2 * k_out * n * _reduce_ops(
            beta, _max(t), _max(evk)))
    if name == "K7":
        y, mat = a["y"], a["mat"]
        _, alpha, n = y.shape
        k = mat.shape[0]
        byt = w * (y.numel() + mat.numel() + _n(a["v"]) + _n(a["sub_from"])
                   + sum(_n(d) for d in a["tensor_add"]) + _n(out)) + \
            _table_bytes(a["t"], a["rows"], k) + 8 * n  # + the last iNTT row
        # per word: the conversion and v (as K3), the forward NTT of every
        # row; the last limb's iNTT, n^-1 and its epilogue (s - x) P^-1 +
        # c_g (12); the other rows' delta P^-1, xl mod q_j, s P^-1, c_g and
        # q_last^-1 (26)
        ops = 2 * k * n * (2 * alpha + _reduce_ops(alpha, _max(y), _max(mat))
                           + 8)
        ops += _ntt_ops(2 * k, n) + _ntt_ops(2, n) + 3 * 2 * n
        ops += 12 * 2 * n + 26 * 2 * (k - 1) * n
        return byt, ops
    if name in ("K4", "K4c"):
        y, mats, c2, evk = a["y"], a["mats"], a.get("c2"), a["evk"]
        beta, k_out, alpha = mats.shape
        n = y.shape[-1]
        # the coefficient form (K4c) passes no row through; y holds the
        # k_data data rows (or padding below beta alpha, never read)
        kd = 0 if c2 is None else (y.shape[0] if a["k_data"] is None
                                   else a["k_data"])
        y_rows = y.shape[0] if c2 is None else kd
        pairs = () if c2 is None else c2 if isinstance(c2, tuple) else (c2,)
        conv = beta * k_out - kd
        byt = w * (y_rows * n + mats.numel() + len(pairs) * kd * n
                   + evk.numel() + _n(out)) + _table_bytes(
                       a["t"], a["rows"], k_out)
        # T_d[j] < q_j: the digit sum's products are below max q times evk
        rows = a["rows"]
        q_out = a["t"].q[:k_out] if rows is None else a["t"].q[rows.long()]
        ops = (conv * n * (2 * alpha + _reduce_ops(alpha, _max(y),
                                                   _max(mats)))
               + _ntt_ops(conv, n) + (8 * kd * n if len(pairs) == 2 else 0)
               + beta * k_out * n * 4
               + 2 * k_out * n * _reduce_ops(beta, _max(q_out) - 1,
                                             _max(evk)))
        return byt, ops
    if name == "K4p":
        delta, c2, evk, alpha = a["delta"], a["c2"], a["evk"], a["alpha"]
        beta, k_out, n = delta.shape
        pairs = c2 if isinstance(c2, tuple) else (c2,)
        kd = pairs[0].shape[0] if a["k_data"] is None else a["k_data"]
        # each digit's own rows: the passthrough, never read from delta
        own = sum(max(0, min((d + 1) * alpha, kd, k_out) - d * alpha)
                  for d in range(beta))
        conv = beta * k_out - own
        byt = w * (conv * n + len(pairs) * own * n + evk.numel()
                   + _n(out)) + _table_bytes(a["t"], a["rows"], k_out)
        rows = a["rows"]
        q_out = a["t"].q[:k_out] if rows is None else a["t"].q[rows.long()]
        ops = (_ntt_ops(conv, n) + (8 * own * n if len(pairs) == 2 else 0)
               + beta * k_out * n * 4
               + 2 * k_out * n * _reduce_ops(beta, _max(q_out) - 1,
                                             _max(evk)))
        return byt, ops
    raise ValueError(name)


def bound_ms(byt: int, ops: int, tc_ops: int = 0):
    t_b = byt / HBM_BYTES_PER_S
    t_o = max(ops / INT_MULS_PER_S, tc_ops / INT8_TC_OPS_PER_S)
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _cmd(args):
    try:
        r = subprocess.run(args, capture_output=True, text=True, timeout=60)
        return (r.stdout or r.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


# the kernels of the two-pass K2, K7 and K8 and of the radix-2 K6, which
# the library must not hold, and the one-pass core's kernels, which it must
STALE_KERNELS = ("fwd_col_kernel", "fwd_chunk_kernel", "rows_col_kernel",
                 "last_col_kernel", "last_chunk_kernel",
                 "last_inv_col_kernel", "rest_col_kernel",
                 "rest_chunk_kernel", "ntt_roll_kernel")
CORE_KERNELS = ("fwd_cluster_kernel", "inv_cluster_kernel",
                "bconv_ntt_kernel", "modup_ip_kernel", "moddown_rows_kernel",
                "rescale_last_kernel", "rescale_rest_kernel")
K7_KERNELS = CORE_KERNELS[-2:]


def _cuobjdump(lib: str, *args) -> str:
    from phantom_tpu_torch import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, *args, lib], capture_output=True, text=True,
                          timeout=120, check=True).stdout


def resource_usage(lib: str, kernels) -> dict:
    """{kernel, or kernel<N> for a build templated on an int: its "REG:..
    STACK:.. SHARED:.. LOCAL:.." line} from cuobjdump
    --dump-resource-usage; raises for a kernel it does not list."""
    import re
    out, name = {}, None
    for line in _cuobjdump(lib, "--dump-resource-usage").splitlines():
        if "Function" in line:
            name = next((k for k in kernels if k in line), None)
            t = name and re.search(name + r"ILi(\d+)E", line)
            if t:
                name += f"<{t.group(1)}>"
        elif name is not None and "REG:" in line:
            out[name] = " ".join(w for w in line.split()
                                 if w.split(":")[0] in ("REG", "STACK",
                                                        "SHARED", "LOCAL"))
            name = None
    missing = [k for k in kernels
               if not any(n.split("<")[0] == k for n in out)]
    if missing:
        raise RuntimeError(f"cuobjdump lists no resources of {missing}")
    return out


def start_ptxas_report(src: str, obj: str):
    """Start nvcc -Xptxas -v on one source of csrc/ (its kernels' registers
    and spills; the library's build does not print them)."""
    from phantom_tpu_torch import _build
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         obj, os.path.join(_build.CSRC, src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def ptxas_report(proc, kernels) -> dict:
    """{kernel: "Used N registers; S bytes stack frame, X bytes spill
    stores, Y bytes spill loads"} from start_ptxas_report's process."""
    err = proc.communicate(timeout=300)[1]
    if proc.returncode:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{err}")
    out, name, spills = {}, None, ""
    for line in err.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in kernels if k in line), None)
        elif name is not None and "spill stores" in line:
            spills = line.strip()
        elif name is not None and "registers" in line:
            used = line.split(":", 1)[1].split(",")[0].strip()
            out[name] = f"{used}; {spills}"
            name = None
    missing = [k for k in kernels if k not in out]
    if missing:
        raise RuntimeError(f"ptxas reports nothing of {missing}")
    return out


def sass_count(lib: str, kernel: str, opcode: str) -> dict:
    """{instruction: count} of the `opcode` instructions in `kernel`'s SASS
    in the built library (cuobjdump -sass)."""
    sass = _cuobjdump(lib, "-sass")
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and f" {opcode}" in line:
            ins = line.split("*/")[1].split()[0] if "*/" in line else opcode
            counts[ins] = counts.get(ins, 0) + 1
    return counts


def _time(fn, reps: int) -> float:
    """Milliseconds per call, CUDA events around `reps` calls after one
    warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int) -> float:
    """Milliseconds per call on the device alone: CUDA events around `reps`
    calls (after a warm-up call) that the host enqueues while the device
    sleeps, so that they run back to back and the host's launch overhead,
    which bounds the event time of a small call, stays outside."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1000000)  # cycles: 2x enough
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(_max_err(x, y) for x, y in zip(a, b))
    return int((a.long() - b.long()).abs().max())


class _Probe:
    """Stands in for one kernel wrapper: runs the kernel, holds it against
    the plain version on the same inputs, times both, and computes the
    call's bound."""

    def __init__(self, name, kernel, plain, reps: int):
        self.name, self.kernel, self.plain, self.reps = (name, kernel, plain,
                                                         reps)
        self.sig = inspect.signature(plain)
        self.calls = []

    def __call__(self, *args, **kw):
        import torch
        out = self.kernel(*args, **kw)
        ref = self.plain(*args, **kw)
        torch.cuda.synchronize()
        shape = tuple(args[0].shape)
        err = _max_err(out, ref)
        if err:
            raise RuntimeError(f"{self.name}: kernel differs from plain at "
                               f"{shape}: max_abs_err {err}")
        ba = self.sig.bind(*args, **kw)
        ba.apply_defaults()
        byt, ops, tc_ops = call_bound(self.name, ba.arguments, out)
        b_ms, b_by = bound_ms(byt, ops, tc_ops)
        self.calls.append(dict(
            shape=shape, err=err, bound_ms=b_ms, bound_by=b_by, bytes=byt,
            ops=ops, tc_ops=tc_ops,
            dev_ms=_device_ms(lambda: self.kernel(*args, **kw), self.reps),
            ms=_time(lambda: self.kernel(*args, **kw), self.reps),
            plain_ms=_time(lambda: self.plain(*args, **kw), self.reps)))
        return out


def kernel_wrappers():
    """The wrappers of KERNELS, in its order."""
    from phantom_tpu_torch.ops import bconv_kernels, ip_kernels
    from phantom_tpu_torch.ops import moddown_kernels, modup_ip_kernels
    from phantom_tpu_torch.ops import ntt_kernels, ntt_roll_kernels
    mods = (ntt_kernels, bconv_kernels, modup_ip_kernels, ip_kernels,
            moddown_kernels, ntt_roll_kernels)
    return [next(getattr(m, attr) for m in mods if hasattr(m, attr))
            for _, attr, *_ in KERNELS]


def calls_only(card: str, dev) -> None:
    """--calls: every kernel call of one headline step on each modup route
    and through the K8 and K7 epilogues, one alpha-8 xla-split step and
    one through each of those epilogues, one BFV step on each engine and
    one BGV step on each route, under the probes (phases 4, 8, 11, 18 and
    23 without the rest).  It passes the wrappers only their common
    arguments, so a copy of this file measures an earlier tree of the port
    the same way."""
    import torch
    from phantom_tpu_torch import make_context
    from phantom_tpu_torch.ops import bfv32, bgv32
    from phantom_tpu_torch.ops import pipeline32 as pp
    probes = _probes(pp, kernel_wrappers())
    since = {name: 0 for name, *_ in KERNELS}
    ctx = make_context(chain_params(**HEADLINE))
    _, pipe, d1, d2, *_ = make_step_inputs(ctx, SEED, DELTA_BITS, dev)
    pipe(d1, d2, probes)
    epilogues = [kw for kw in EPILOGUES.values() if kw]
    for kw in [dict(modup=r) for r in ROUTES[1:]] + epilogues:
        pp.CKKSPipeline32(ctx, pipe.evk, **kw).to(dev)(d1, d2, probes)
    ctx8 = make_context(chain_params(**ALPHA8))
    _, pipe8, e1, e2, *_ = make_step_inputs(ctx8, SEED, DELTA_BITS, dev)
    pp._mult_relin_rescale_split(pipe8, e1, e2, probes)
    for kw in epilogues:
        pp.CKKSPipeline32(ctx8, pipe8.evk, **kw).to(dev)(e1, e2, probes)
    del ctx, pipe, d1, d2, ctx8, pipe8, e1, e2
    for scheme, cfg, build, kws in (
            ("bfv", BFV, bfv32.build_bfv32,
             [dict(engine=e) for e in ENGINES]),
            ("bgv", BGV, bgv32.build_bgv32,
             [dict(modup=r) for r in ("auto", "kernel")])):
        torch.cuda.empty_cache()
        c = make_context(mod_t_params(**cfg, scheme=scheme))
        _, rlk, a, b, *_ = make_mod_t_inputs(c, SEED, dev)
        for kw in kws:
            build(c, rlk, **kw)(a, b, probes)
    _print_calls(probes, card, since)


def _probes(pp, wrappers):
    return pp.Kernels(*(_Probe(name, k, p, REPS) for (name, *_), k, p
                        in zip(KERNELS, wrappers, pp.PLAIN)))


def _print_calls(probes, card, since):
    for (name, *_), probe in zip(KERNELS, probes):
        for c in probe.calls[since[name]:]:
            tc = (f", {c['tc_ops'] / 1e9:.3f} G int8" if c["tc_ops"]
                  else "")
            print(f"kernel {name} {c['shape']}: bit-equal to plain; "
                  f"{c['ms']:.4f} ms (device {c['dev_ms']:.4f}) vs plain "
                  f"{c['plain_ms']:.4f} ms, bound "
                  f"{c['bound_ms']:.4f} ms by {c['bound_by']} "
                  f"({c['bytes'] / 1e6:.1f} MB, {c['ops'] / 1e9:.3f} G mul"
                  f"{tc}) [{card}]")
        since[name] = len(probe.calls)


def _count(wrappers, what: str, fn, launches: dict):
    """Run fn with every launch count set to 0 just before and read just
    after; check them against EXPECTED[what] and add them to launches."""
    import torch
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    got = {name: w.launches for (name, *_), w in zip(KERNELS, wrappers)}
    print(f"launches, {what}: " + ", ".join(f"{k}={v}"
                                            for k, v in got.items()))
    if got != EXPECTED[what]:
        raise RuntimeError(f"{what}: launches {got} != {EXPECTED[what]}")
    for k, v in got.items():
        launches[k] += v
    return out


def _chain_timing(runs, make_chain, steps: int, card: str, what: str):
    """Time make_chain(route) per route in the order given (e.g. A, B, B,
    A), with the peak device memory of each route; returns the final
    outputs per route."""
    import torch
    times, finals, peaks = {}, {}, {}
    for route in runs:
        chain = make_chain(route)
        chain(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        finals[route] = chain(steps)
        end.record()
        torch.cuda.synchronize()
        times.setdefault(route, []).append(start.elapsed_time(end) / steps)
        peaks[route] = max(peaks.get(route, 0),
                           torch.cuda.max_memory_allocated())
    for route, ts in times.items():
        ms = float(np.mean(ts))
        print(f"timing {what}, {route}: {ms:.3f} ms/op, {1000 / ms:.1f} "
              f"ops/s ({steps} chained, runs "
              f"{', '.join(f'{t:.3f}' for t in ts)} ms); "
              f"max_memory_allocated {peaks[route] / 2**20:.1f} MiB [{card}]")
    return finals


def _profile(run, steps: int, card: str, what: str) -> None:
    """torch.profiler over `steps` calls of run(): device-busy time per
    call against the wall time, and the top device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    if busy_ms == 0:
        print(f"profile {what}: device time not measured (no CUDA events) "
              f"[{card}]")
        return
    print(f"profile {what}: {busy_ms:.3f} ms device-busy of {wall_ms:.3f} ms "
          f"wall per step, idle share {1 - busy_ms / wall_ms:.3f} [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3 / steps
        print(f"profile   {ms:8.4f} ms/step {e.count // steps:4d}x  "
              f"{e.key[:90]}")


def _k7_vs_pair(calls, card: str) -> None:
    """Phase 6: K7 beside the three calls of the pair that it replaces on
    the same step's operands (K3's moddown, the rescale's K1 on the last
    limb and its K3), device time, in turns (K7, pair, pair, K7)."""
    from phantom_tpu_torch.ops import moddown_kernels, ntt_kernels
    (a7, kw7), = calls["K7"]
    k1_rs = next(c for c in calls["K1"] if c[0][0].shape[-2] == 1)
    runs = {"K7": [(moddown_kernels.moddown_rescale, a7, kw7)],
            "pair": [(ntt_kernels.bconv_ntt_forward, *calls["K3"][0]),
                     (ntt_kernels.ntt_inverse, *k1_rs),
                     (ntt_kernels.bconv_ntt_forward, *calls["K3"][1])]}
    times = {}
    for label in ("K7", "pair", "pair", "K7"):
        for i, (fn, a, kw) in enumerate(runs[label]):
            times.setdefault((label, i), []).append(
                _device_ms(lambda: fn(*a, **kw), REPS))
    ba = inspect.signature(moddown_kernels.moddown_rescale_plain).bind(
        *a7, **kw7)
    ba.apply_defaults()
    b_ms, b_by = bound_ms(*call_bound(
        "K7", ba.arguments, moddown_kernels.moddown_rescale(*a7, **kw7)))
    ms = {key: float(np.mean(v)) for key, v in times.items()}
    runs_ms = {key: ", ".join(f"{u:.4f}" for u in v)
               for key, v in times.items()}
    names = ("K3 moddown", "K1 rescale", "K3 rescale")
    print(f"K7 vs the pair's three calls on the same operands (device "
          f"time): K7 {tuple(a7[0].shape)} -> (2, {a7[1].shape[0]}, N) "
          f"{ms['K7', 0]:.4f} ms ({runs_ms['K7', 0]}); "
          + " + ".join(f"{nm} {ms['pair', i]:.4f} ({runs_ms['pair', i]})"
                       for i, nm in enumerate(names))
          + f" = {sum(ms['pair', i] for i in range(3)):.4f} ms; K7 bound "
          f"{b_ms:.4f} ms by {b_by} [{card}]")


def _bfv_phases(card: str, probes, wrappers, since, launches, dev) -> None:
    """Phases 16-20: the BFV HPS step on both engines."""
    import torch
    from phantom_tpu_torch import make_context
    from phantom_tpu_torch.ops import bfv32, ntt_kernels, ntt_roll_kernels
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes import keys

    # 16. golden
    for name, (got, want) in bfv_golden(dev).items():
        if not np.array_equal(got.cpu().numpy().astype(np.uint32), want):
            raise RuntimeError(f"BFV golden: {name} differs from the JAX "
                               "output")
        print(f"BFV golden: {name} bit-equal to the JAX package's output "
              f"{tuple(want.shape)}")

    # 17. setup
    t0 = time.time()
    params = mod_t_params(**BFV)
    ctx = make_context(params)
    t_ctx = time.time() - t0
    sk, rlk, d1, d2, m1, m2 = make_mod_t_inputs(ctx, SEED, dev)
    pipes = {e: bfv32.build_bfv32(ctx, rlk, engine=e) for e in ENGINES}
    torch.cuda.synchronize()
    print(f"BFV setup: N={params.n} L={params.size_q} alpha={params.size_p} "
          f"dnum={pipes[ENGINES[0]].ks.beta} t={params.plain_modulus} "
          f"|Rl|={len(ctx.rl_moduli)} (D {len(ctx.rl_moduli) + params.size_q}"
          f" rows); context (host tables of {ctx.ntt.num_limbs} moduli) "
          f"{t_ctx:.1f} s, keys and encryptions {time.time() - t0:.1f} s")

    # 18. kernels under the probes, and K6 beside K2 / K1 on equal work
    for p in pipes.values():
        p(d1, d2, probes)
    _print_calls(probes, card, since)
    seen = {}

    def keep(name, fn):
        def call(*a, **kw):
            seen.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return call

    pipes["pallas-roll"](d1, d2, pp.KERNELS._replace(
        ntt_forward_roll=keep("fwd", ntt_roll_kernels.ntt_forward_roll),
        ntt_inverse_roll=keep("inv", ntt_roll_kernels.ntt_inverse_roll)))
    for what, core, k6, bname in (
            ("D forward", ntt_kernels.ntt_forward,
             ntt_roll_kernels.ntt_forward_roll, "K2"),
            ("D inverse", ntt_kernels.ntt_inverse,
             ntt_roll_kernels.ntt_inverse_roll, "K1")):
        (x, t, rows), _ = seen["fwd" if bname == "K2" else "inv"]
        ref = core(x, t, rows)
        ba = inspect.signature(getattr(pp.PLAIN, core.__name__)).bind(
            x, t, rows)
        ba.apply_defaults()
        b_ms, b_by = bound_ms(*call_bound(bname, ba.arguments, ref))
        runs = [(f"K6 C={c}", lambda c=c: k6(x, t, rows, cluster=c))
                for c in CLUSTERS] + [(bname, lambda: core(x, t, rows))]
        for label, fn in runs:
            if not torch.equal(fn(), ref):
                raise RuntimeError(f"{what}: {label} differs from {bname}")
        times, dev_times = {}, {}
        for label, fn in runs + runs[::-1]:
            times.setdefault(label, []).append(_time(fn, REPS))
            dev_times.setdefault(label, []).append(_device_ms(fn, REPS))
        runs_ms = {k: ", ".join(f"{u:.4f}" for u in v)
                   for k, v in times.items()}
        print(f"K6 vs {bname}, {what} {tuple(x.shape)} (equal work, "
              f"bit-equal): " + ", ".join(
                  f"{k} {np.mean(v):.4f} ms ({runs_ms[k]}; device "
                  f"{np.mean(dev_times[k]):.4f})"
                  for k, v in times.items())
              + f"; bound {b_ms:.4f} ms by {b_by} [{card}]")

    # 19. step: kernels = plain, engines equal, launches, decryption
    outs = {}
    for e, p in pipes.items():
        outs[e] = _count(wrappers, f"BFV step, {e}", lambda: p(d1, d2),
                         launches)
        if not torch.equal(outs[e], p(d1, d2, pp.PLAIN)):
            raise RuntimeError(f"BFV step ({e}): kernel path differs from "
                               "the plain path")
    if not torch.equal(*outs.values()):
        raise RuntimeError("BFV step: the engines differ")
    print(f"BFV step: kernel path bit-equal to the plain path on both "
          f"engines, the engines bit-equal {tuple(outs[ENGINES[0]].shape)}")
    t_ = params.plain_modulus
    for name, d, m in (("d1", d1, m1), ("d2", d2, m2)):
        if not np.array_equal(keys.decrypt(ctx, sk, d).cpu().numpy(), m % t_):
            raise RuntimeError(f"BFV decrypt: {name} does not decrypt to its "
                               "message")
    got = keys.decrypt(ctx, sk, outs[ENGINES[0]]).cpu().numpy()
    right = int((got == negacyclic_product(m1, m2) % t_).sum())
    margin, need, inside = hps_bound(ctx)
    if inside and right != params.n:
        raise RuntimeError(f"BFV decrypt: {params.n - right} coefficients of "
                           "m1*m2 differ inside HPS's bound")
    print(f"BFV decrypt: d1, d2 decrypt to m1, m2 in all {params.n} "
          f"coefficients; the step's output to m1*m2 mod (X^N + 1, t) in "
          f"{right} of {params.n}; HPS's bound Rl/Ql > 2 N t: log2 Rl/Ql = "
          f"{margin:.2f}, log2 2Nt = {need:.2f}, "
          f"{'inside' if inside else 'OUTSIDE'} the bound")

    # 20. timing
    def chain(route):
        p = pipes["mxu-pallas" if route == "plain path" else route]
        ops = pp.PLAIN if route == "plain path" else pp.KERNELS

        def run(steps):
            d = d1
            for _ in range(steps):
                d = p(d, d2, ops)
            return d
        return run

    finals = _chain_timing(ENGINES + ENGINES[::-1] + ("plain path",), chain,
                           CHAIN_BFV_STEPS, card, "BFV step")
    if not all(torch.equal(f, finals["plain path"]) for f in finals.values()):
        raise RuntimeError("BFV timing: chained outputs differ")
    for e in ENGINES:
        d = [d1]

        def run(e=e):
            d[0] = pipes[e](d[0], d2)
        _profile(run, PROFILE_STEPS, card, f"BFV step, {e}")
        _bfv_stages(pipes[e], d1, d2, card)


def _bfv_stages(p, d1, d2, card: str) -> None:
    """Where one BFV step's time goes: each stage timed alone on the
    step's own operands (CUDA events), the D -> Rl scale-and-round's K5
    omega matmul beside the whole round."""
    import torch
    from phantom_tpu_torch.ops import bfv32, scaleround32
    from phantom_tpu_torch.ops import pipeline32 as pp
    ks, ops = p.ks, pp.KERNELS

    def lift():
        return torch.stack([bfv32._lift(p, d1, ops), bfv32._lift(p, d2, ops)])

    lifted = lift()
    ab = pp._fwd(ks, lifted, p.rows_d, ops)
    tp = bfv32._tensor_2x2(p.mv_d, ab)
    prod = pp._inv(ks, tp, p.rows_d, ops)
    d3 = torch.stack([bfv32._scale_and_round_hps32(p, x) for x in prod])
    sr = p.sr_to_r
    y = prod[0]
    stages = {
        "lift (K5 x4)": lift,
        "D forward": lambda: pp._fwd(ks, lifted, p.rows_d, ops),
        "tensor product": lambda: bfv32._tensor_2x2(p.mv_d, ab),
        "D inverse": lambda: pp._inv(ks, tp, p.rows_d, ops),
        "scale-and-round x3 (K5 x6)": lambda: [
            bfv32._scale_and_round_hps32(p, x) for x in prod],
        "relinearize": lambda: bfv32.bfv_relin32(p, d3),
    }
    times = {k: _time(f, REPS) for k, f in stages.items()}
    round_ms = _time(lambda: scaleround32.scale_and_round_exact32(y, sr),
                     REPS)
    omega_ms = _time(lambda: ops.fold_matmul(y, sr.omega_mod_out,
                                             sr.obase.q), REPS)
    print(f"BFV stages, {ks.engine}: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in times.items())
          + f"; sum {sum(times.values()):.3f} ms; one D -> Rl round "
          f"{round_ms:.3f} ms, of it the K5 omega matmul {omega_ms:.3f} ms "
          f"[{card}]")


def _bgv_phases(card: str, probes, wrappers, since, launches, dev) -> None:
    """Phases 21-25: the BGV multiply + relinearize + modulus switch."""
    import torch
    from phantom_tpu_torch import make_context
    from phantom_tpu_torch.ops import bgv32
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes import keys

    # 21. golden
    for name, (got, want) in bgv_golden(dev).items():
        if not np.array_equal(got.cpu().numpy().astype(np.uint32), want):
            raise RuntimeError(f"BGV golden: {name} differs from the JAX "
                               "output")
        print(f"BGV golden: {name} bit-equal to the JAX package's output "
              f"{tuple(want.shape)}")

    # 22. setup
    t0 = time.time()
    params = mod_t_params(**BGV, scheme="bgv")
    ctx = make_context(params)
    t_ctx = time.time() - t0
    sk, rlk, d1, d2, m1, m2 = make_mod_t_inputs(ctx, SEED, dev)
    pipes = {r: bgv32.build_bgv32(ctx, rlk, modup=r)
             for r in ("auto", "kernel")}
    torch.cuda.synchronize()
    t_ = params.plain_modulus
    cf = pow(params.data_moduli[params.size_q - 1] % t_, -1, t_)
    print(f"BGV setup: N={params.n} L={params.size_q} alpha={params.size_p} "
          f"dnum={pipes['auto'].ks.beta} t={t_}, modup "
          f"{pipes['auto'].ks.modup}; context {t_ctx:.1f} s, keys and "
          f"encryptions {time.time() - t0:.1f} s")

    # 23. kernels under the probes
    for p in pipes.values():
        p(d1, d2, probes)
    _print_calls(probes, card, since)

    # 24. step: kernels = plain, routes equal, launches, decryption
    outs = {}
    for r, p in pipes.items():
        what = "BGV step" if r == "auto" else f"BGV step, {r} route"
        outs[r] = _count(wrappers, what, lambda: p(d1, d2), launches)
        if not torch.equal(outs[r], p(d1, d2, pp.PLAIN)):
            raise RuntimeError(f"BGV step ({r}): kernel path differs from "
                               "the plain path")
    if not torch.equal(outs["auto"], outs["kernel"]):
        raise RuntimeError("BGV step: the routes differ")
    print(f"BGV step: kernel path bit-equal to the plain path on the auto "
          f"(xla-split) and kernel routes, the routes bit-equal "
          f"{tuple(outs['auto'].shape)}")
    for name, d, m in (("d1", d1, m1), ("d2", d2, m2)):
        if not np.array_equal(keys.decrypt(ctx, sk, d).cpu().numpy(), m % t_):
            raise RuntimeError(f"BGV decrypt: {name} does not decrypt to its "
                               "message")
    got = keys.decrypt(ctx, sk, outs["auto"], cf).cpu().numpy()
    right = int((got == negacyclic_product(m1, m2) % t_).sum())
    if right != params.n:
        raise RuntimeError(f"BGV decrypt: {params.n - right} coefficients of "
                           "m1*m2 differ")
    print(f"BGV decrypt: d1, d2 decrypt to m1, m2, and the step's output "
          f"(correction factor {cf} = q_last^-1 mod t) to m1*m2 mod "
          f"(X^N + 1, t) in all {params.n} coefficients")

    # 25. timing, stages, profile
    p = pipes["auto"]
    q_pad = ctx.key_q[params.size_q - 1:params.size_q].view(1, 1, 1)

    def chain(route):
        ops = pp.PLAIN if route == "plain path" else pp.KERNELS

        def run(steps):
            d = d1
            for _ in range(steps):
                d = remix(p(d, d2, ops), q_pad)
            return d
        return run

    finals = _chain_timing(("kernel path", "plain path", "plain path",
                            "kernel path"), chain, CHAIN_BGV_STEPS, card,
                           "BGV step")
    if not torch.equal(finals["kernel path"], finals["plain path"]):
        raise RuntimeError("BGV timing: chained outputs differ")
    ks, ops = p.ks, pp.KERNELS
    k = ks.size_ql
    q = ks.mv_ql.q.long().view(-1, 1)
    c2 = bgv32._tensor_2x2(q, d1, d2)[2].int()
    s0, s1 = pp.modup_ip32(ks, c2, p.evk)
    x_p = pp._inv(ks, torch.stack([s0[k:], s1[k:]]), ks.rows_p,
                  ops).transpose(0, 1)
    x3 = bgv32.bgv_mult_relin32(p, d1, d2)
    stages = {
        "tensor product": lambda: bgv32._tensor_2x2(q, d1, d2),
        "modup + inner product (K1, K5 x2, K2, K9)": lambda: pp.modup_ip32(
            ks, c2, p.evk),
        "t-corrected moddown of both halves (K1, K5 x2, K2)":
            lambda: pp.moddown32_pair(ks, s0, s1),
        "the same as two moddown32 calls":
            lambda: (pp.moddown32(ks, s0), pp.moddown32(ks, s1)),
        "its delta over both halves (K5 x2, plain torch)":
            lambda: pp._moddown_delta32(ks, x_p, ops),
        "modulus switch (K1, K2)": lambda: bgv32.bgv_mod_switch32(p, x3),
    }
    times = {name: _time(f, REPS) for name, f in stages.items()}
    print("BGV stages: " + ", ".join(f"{name} {ms:.3f} ms"
                                     for name, ms in times.items())
          + f" [{card}]")
    d = [d1]

    def run():
        d[0] = remix(p(d[0], d2), q_pad)
    _profile(run, PROFILE_STEPS, card, "BGV step")


def _same(a, b) -> bool:
    """Kernel path against plain path: tensors, numpy arrays, ciphertexts
    and plaintexts (their metadata too) and keys.GaloisKeys."""
    import torch
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    meta = [f for f in ("chain_index", "is_ntt_form", "scale",
                        "correction_factor", "noise_scale_deg", "elts")
            if hasattr(a, f)]
    return torch.equal(a.data, b.data) and all(
        getattr(a, f) == getattr(b, f) for f in meta)


class _Circuit:
    """Runs a circuit's verbs one at a time: each through the kernels
    with every launch count set to 0 just before and read just after
    (_count against EXPECTED[key]), then through the plain versions on the
    same inputs (a generator's state replayed) and held bit-equal, then
    timed on the kernel path (CUDA events, _time); and each level's
    first-use build (Fast32.prebuild), timed."""

    def __init__(self, what, ev, wrappers, launches, card, gen=None):
        self.what, self.ev, self.wrappers = what, ev, wrappers
        self.launches, self.card, self.gen = launches, card, gen
        self.times, self.builds = [], []

    def level(self, ci: int) -> None:
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.ev.prebuild(ci)
        torch.cuda.synchronize()
        self.builds.append((ci, (time.perf_counter() - t0) * 1e3))

    def __call__(self, name: str, key: str, fn, draws: bool = False,
                 reps: int = REPS):
        from phantom_tpu_torch.ops import pipeline32 as pp
        gen = self.gen if draws else None
        state = gen.get_state() if gen is not None else None
        out = _count(self.wrappers, key, lambda: fn(pp.KERNELS),
                     self.launches)
        if gen is not None:
            after = gen.get_state()
            gen.set_state(state)
        ref = fn(pp.PLAIN)
        if gen is not None:
            gen.set_state(after)
        if not _same(out, ref):
            raise RuntimeError(f"{self.what} {name}: the kernel path differs "
                               "from the plain path")
        self.times.append((name, _time(lambda: fn(pp.KERNELS), reps)))
        return out

    def report(self) -> None:
        import torch
        print(f"{self.what}: every verb bit-equal to its plain path; "
              + ", ".join(f"{n} {ms:.3f} ms" for n, ms in self.times)
              + f" [{self.card}]")
        print(f"{self.what}: first-use build per chain index: "
              + ", ".join(f"{ci}: {ms:.1f} ms" for ci, ms in self.builds)
              + f"; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{self.card}]")


def unit_disc(rng, size: int) -> np.ndarray:
    """Complex values uniform in the unit disc."""
    return np.sqrt(rng.random(size)) * np.exp(2j * np.pi * rng.random(size))


def rotate_rows(v: np.ndarray, step: int) -> np.ndarray:
    """The batch encoder's slots rotated by `step`: each row of N/2 slots
    rolled left."""
    h = v.shape[0] // 2
    return np.concatenate([np.roll(v[:h], -step), np.roll(v[h:], -step)])


def _fast32_keys(c: _Circuit, elts_what: str, steps):
    """Secret, public, relin and Galois keys for `steps` through Fast32,
    each kernel path against its plain path."""
    ev = c.ev
    sk = c("gen_secret_key", "Fast32 gen_secret_key",
           lambda ops: ev.gen_secret_key(c.gen, ops), True, 1)
    pk = c("gen_public_key", "Fast32 gen_public_key",
           lambda ops: ev.gen_public_key(sk, c.gen, ops), True, 1)
    rlk = c("gen_relin_key", "Fast32 gen_relin_key",
            lambda ops: ev.gen_relin_key(sk, c.gen, ops), True, 1)
    glk = c("create_galois_keys", f"Fast32 create_galois_keys, {elts_what}",
            lambda ops: ev.create_galois_keys(sk, c.gen, steps, ops=ops),
            True, 1)
    return sk, pk, rlk, glk


def fast32_ckks_circuit(params, card, wrappers, launches, dev):
    """Phase 28: keys, encode, encrypt_asymmetric, then multiply + relin,
    rescale, modswitch, add, sub, add_plain, multiply_plain, square +
    relin, hoisted_linear_combo over steps 0..7 with encode_extended
    weights, two more multiplies, at chain index 7 a plain product and a
    rotation (at scale q_last^2: a rotation at scale q_last alone leaves up
    to about 8e-3 of the moddown's bias in a slot at N = 2^16), decrypt
    and decode against numpy's float64 evaluation of the same circuit
    (1e-2).  Returns the largest error."""
    import torch
    from phantom_tpu_torch import (CKKSEncoder, Fast32, encode_extended,
                                   make_context)
    t0 = time.time()
    ctx = make_context(params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    c = _Circuit("Fast32 CKKS", Fast32(ctx), wrappers, launches, card, gen)
    sk, pk, rlk, glk = _fast32_keys(c, "8 elements", STEPS_HOIST)
    ev = c.ev = Fast32(ctx, rlk=rlk, glk=glk)
    print(f"Fast32 CKKS setup: N={params.n} L={params.size_q} "
          f"alpha={params.size_p}, modup {ev.keyswitch_at(1).modup}; context "
          f"and keys (steps {STEPS_HOIST[0]}..{STEPS_HOIST[-1]}) "
          f"{time.time() - t0:.1f} s")
    enc = CKKSEncoder(ctx)
    rng = np.random.default_rng(SEED)
    z1, z2 = unit_disc(rng, enc.slots), unit_disc(rng, enc.slots)
    w1, w2 = 0.5 * unit_disc(rng, enc.slots), 0.25 * unit_disc(rng, enc.slots)
    wc = [unit_disc(rng, enc.slots) / len(STEPS_HOIST) for _ in STEPS_HOIST]
    w3 = unit_disc(rng, enc.slots)
    qs = params.data_moduli

    def qlast(ci):
        return float(qs[params.size_q - ci])

    none = "Fast32, no kernel"
    c.level(1)
    pt1 = c("encode", "Fast32 CKKS encode",
            lambda ops: enc.encode(z1, qlast(1), ops=ops))
    c1 = c("encrypt_asymmetric", "Fast32 CKKS encrypt_asymmetric",
           lambda ops: ev.encrypt_asymmetric(pk, pt1, gen, ops), True)
    c2 = ev.encrypt_asymmetric(pk, enc.encode(z2, qlast(1)), gen)
    fresh1, fresh2 = c1, c2
    v = c("multiply_and_relin @1", "Fast32 CKKS multiply_and_relin",
          lambda ops: ev.multiply_and_relin(c1, c2, ops))
    v = c("rescale_to_next @1", "Fast32 CKKS rescale_to_next",
          lambda ops: ev.rescale_to_next(v, ops))
    c.level(2)
    c1 = c("mod_switch_to_next @1", none,
           lambda ops: ev.mod_switch_to_next(c1, ops))
    v = c("add @2", none, lambda ops: ev.add(v, c1))
    c2 = ev.mod_switch_to_next(c2)
    v = c("sub @2", none, lambda ops: ev.sub(v, c2))
    p = enc.encode(w1, v.scale, 2)
    v = c("add_plain @2", none, lambda ops: ev.add_plain(v, p, ops))
    p = enc.encode(w2, qlast(2), 2)
    v = c("multiply_plain @2", none, lambda ops: ev.multiply_plain(v, p, ops))
    v = ev.rescale_to_next(v)
    c.level(3)
    v = c("square_and_relin @3", "Fast32 CKKS multiply_and_relin",
          lambda ops: ev.square_and_relin(v, ops))
    v = ev.rescale_to_next(v)
    c.level(4)
    pts = [c(f"encode_extended @4 (step {s})", "Fast32 CKKS encode_extended",
             lambda ops: encode_extended(enc, w, qlast(4), 4, ops), reps=1)
           for s, w in zip(STEPS_HOIST, wc)]
    v = c("hoisted_linear_combo @4", "Fast32 CKKS hoisted_linear_combo, "
          "steps 0..7", lambda ops: ev.hoisted_linear_combo(
              v, STEPS_HOIST, pts, qlast(4), ops))
    v = ev.rescale_to_next(v)
    for _ in range(3):
        c1 = ev.mod_switch_to_next(c1)
    c.level(5)
    v = c("multiply_and_relin @5", "Fast32 CKKS multiply_and_relin",
          lambda ops: ev.multiply_and_relin(v, c1, ops))
    v = ev.rescale_to_next(v)
    c.level(6)
    v = c("multiply_and_relin @6", "Fast32 CKKS multiply_and_relin",
          lambda ops: ev.multiply_and_relin(v, v, ops))
    v = ev.rescale_to_next(v)
    c.level(7)
    p = enc.encode(w3, qlast(7), 7)
    v = c("multiply_plain @7", none, lambda ops: ev.multiply_plain(v, p, ops))
    v = c("rotate @7", "Fast32 CKKS rotate", lambda ops: ev.rotate(v, 1, ops))
    pt = c("decrypt @7", none, lambda ops: ev.decrypt(sk, v, ops))
    got = c("decode @7", "Fast32 CKKS decode",
            lambda ops: enc.decode(pt, ops), reps=1)
    want = (z1 * z2 + z1 - z2 + w1) * w2
    want = want * want
    want = sum(w * np.roll(want, -s) for s, w in zip(STEPS_HOIST, wc))
    want = want * z1
    want = np.roll(want * want * w3, -1)
    err = float(np.abs(got - want).max())
    c.report()
    print(f"Fast32 CKKS circuit: chain index {v.chain_index}, scale "
          f"2^{np.log2(v.scale):.3f}; decoded slots within {err:.3e} of "
          f"numpy's float64 evaluation (bound 1e-2)")
    # the reference's moddown floors, so an encryption of zero and a key
    # switch leave a bias of -1/2 (1 + s) per coefficient, whose embedding
    # peaks at the slots nearest zeta^(+-1): read at scale q_last
    fresh = float(np.abs(enc.decode(ev.decrypt(sk, fresh1)) - z1).max())
    rot = float(np.abs(enc.decode(ev.decrypt(sk, ev.rotate(fresh1, 1)))
                       - np.roll(z1, -1)).max())
    print(f"Fast32 CKKS at scale 2^{np.log2(fresh1.scale):.3f}: a fresh "
          f"encryption decodes within {fresh:.3e} of its slots, its rotation "
          f"within {rot:.3e} (the floored moddown's bias; not gated)")
    c6 = ev.mod_switch_to_next(c1)
    for ci, d1, d2 in ((1, fresh1, fresh2), (c6.chain_index, c6, c6)):
        ms = _device_ms(lambda: ev.rescale_to_next(ev.multiply_and_relin(
            d1, d2)), REPS)
        print(f"Fast32 CKKS multiply_and_relin + rescale_to_next at chain "
              f"index {ci}: {ms:.4f} ms device time [{card}]")
    _profile(lambda: ev.rescale_to_next(ev.multiply_and_relin(
        fresh1, fresh2)), PROFILE_STEPS, card,
        "Fast32 CKKS multiply_and_relin + rescale_to_next at chain index 1")
    if not err <= 1e-2:
        raise RuntimeError(f"Fast32 CKKS circuit: error {err} > 1e-2")
    return err


def fast32_bgv_circuit(params, card, wrappers, launches, dev):
    """Phase 29: encode, encrypt_asymmetric, two multiply + relin each
    followed by a modswitch, multiply_plain, add (balancing the correction
    factors), a rotation, decrypt and decode: exact in every slot."""
    import torch
    from phantom_tpu_torch import BatchEncoder, Fast32, make_context
    t0 = time.time()
    ctx = make_context(params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    c = _Circuit("Fast32 BGV", Fast32(ctx), wrappers, launches, card, gen)
    sk, pk, rlk, glk = _fast32_keys(c, "1 element", [1])
    ev = c.ev = Fast32(ctx, rlk=rlk, glk=glk)
    t = params.plain_modulus
    print(f"Fast32 BGV setup: N={params.n} L={params.size_q} "
          f"alpha={params.size_p} t={t}, modup {ev.keyswitch_at(1).modup}; "
          f"context and keys {time.time() - t0:.1f} s")
    be = BatchEncoder(ctx)
    rng = np.random.default_rng(SEED)
    a, b, m = (rng.integers(0, t, params.n) for _ in range(3))
    c.level(1)
    pa = c("encode", "Fast32 BGV encode", lambda ops: be.encode(a, ops))
    ca = c("encrypt_asymmetric", "Fast32 BGV encrypt_asymmetric",
           lambda ops: ev.encrypt_asymmetric(pk, pa, gen, ops), True)
    cb = ev.encrypt_asymmetric(pk, be.encode(b), gen)
    x = c("multiply_and_relin @1", "Fast32 BGV multiply_and_relin",
          lambda ops: ev.multiply_and_relin(ca, cb, ops))
    x = c("mod_switch_to_next @1", "Fast32 BGV mod_switch_to_next",
          lambda ops: ev.mod_switch_to_next(x, ops))
    c.level(2)
    cb = ev.mod_switch_to_next(cb)
    x = c("multiply_and_relin @2", "Fast32 BGV multiply_and_relin",
          lambda ops: ev.multiply_and_relin(x, cb, ops))
    x = c("mod_switch_to_next @2", "Fast32 BGV mod_switch_to_next",
          lambda ops: ev.mod_switch_to_next(x, ops))
    c.level(3)
    pm = be.encode(m)
    x = c("multiply_plain @3", "Fast32 BGV multiply_plain",
          lambda ops: ev.multiply_plain(x, pm, ops))
    ca = ev.mod_switch_to_next(ev.mod_switch_to_next(ca))
    if ca.correction_factor == x.correction_factor:
        raise RuntimeError("Fast32 BGV: the add needs unequal factors")
    x = c("add @3 (balanced)", "Fast32, no kernel", lambda ops: ev.add(x, ca))
    x = c("rotate @3", "Fast32 BGV rotate", lambda ops: ev.rotate(x, 1, ops))
    pt = c("decrypt @3", "Fast32 BGV decrypt",
           lambda ops: ev.decrypt(sk, x, ops))
    got = c("decode @3", "Fast32 BGV decode", lambda ops: be.decode(pt, ops))
    c.report()
    ao, bo, mo = (v.astype(object) for v in (a, b, m))
    want = rotate_rows((ao * bo * bo * mo + ao) % t, 1)
    right = int((got.astype(object) == want).sum())
    print(f"Fast32 BGV circuit: chain index {x.chain_index}, correction "
          f"factor {x.correction_factor}; (a b^2 m + a) rotated by 1 in "
          f"{right} of {params.n} slots")
    if right != params.n:
        raise RuntimeError(f"Fast32 BGV circuit: {params.n - right} slots "
                           "differ")


# the Fast32 BFV circuit's techniques: mul_tech -> (the multiply +
# relin's EXPECTED label, its ops-level function's name, multech_bound's
# name)
FAST32_BFV_TECHS = {
    "hps": ("BFV step, mxu-pallas", "bfv_mult_relin32", "hps"),
    "behz": ("BFV BEHZ step, mxu-pallas", "bfv_mult_relin_behz32", "behz"),
    "hps_overq": ("BFV HPSoverQ step, mxu-pallas", "bfv_mult_relin_overq32",
                  "overq")}


def fast32_bfv_circuit(params, card, wrappers, launches, dev):
    """Phase 30: encode, encrypt_asymmetric, add, multiply_plain, a
    rotation in coefficient form (K4c), a modswitch, decrypt and decode:
    exact in every slot; multiply_and_relin by the context's mul_tech
    (FAST32_BFV_TECHS) bit-equal to the ops-level function on the same
    inputs, its right slots counted, and gated where multech_bound
    holds (HPS's does not hold here)."""
    import torch
    from phantom_tpu_torch import BatchEncoder, Fast32, make_context
    from phantom_tpu_torch.ops import bfv32
    mt = params.mul_tech
    key, fn_name, bound_name = FAST32_BFV_TECHS[mt]
    what = f"Fast32 BFV ({mt})"
    t0 = time.time()
    ctx = make_context(params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    c = _Circuit(what, Fast32(ctx), wrappers, launches, card, gen)
    sk, pk, rlk, glk = _fast32_keys(c, "1 element", [1])
    ev = c.ev = Fast32(ctx, rlk=rlk, glk=glk)
    t = params.plain_modulus
    print(f"{what} setup: N={params.n} L={params.size_q} "
          f"alpha={params.size_p} t={t}, engine {ev.engine}; context and "
          f"keys {time.time() - t0:.1f} s")
    be = BatchEncoder(ctx)
    rng = np.random.default_rng(SEED)
    a, b, m = (rng.integers(0, t, params.n) for _ in range(3))
    none = "Fast32, no kernel"
    c.level(1)
    pa = c("encode", "Fast32 BFV encode", lambda ops: be.encode(a, ops))
    ca = c("encrypt_asymmetric", "Fast32 BFV encrypt_asymmetric",
           lambda ops: ev.encrypt_asymmetric(pk, pa, gen, ops), True)
    cb = ev.encrypt_asymmetric(pk, be.encode(b), gen)
    x = c("add", none, lambda ops: ev.add(ca, cb))
    pm = be.encode(m)
    x = c("multiply_plain", "Fast32 BFV multiply_plain",
          lambda ops: ev.multiply_plain(x, pm, ops))
    x = c("rotate (coefficient form)", "Fast32 BFV rotate",
          lambda ops: ev.rotate(x, 1, ops))
    x = c("mod_switch_to_next", none,
          lambda ops: ev.mod_switch_to_next(x, ops))
    pt = c("decrypt @2", "Fast32 BFV decrypt",
           lambda ops: ev.decrypt(sk, x, ops))
    got = c("decode @2", "Fast32 BFV decode", lambda ops: be.decode(pt, ops))
    mr = c("multiply_and_relin", key,
           lambda ops: ev.multiply_and_relin(ca, cb, ops))
    c.report()
    ao, bo, mo = (v.astype(object) for v in (a, b, m))
    want = rotate_rows((ao + bo) * mo % t, 1)
    right = int((got.astype(object) == want).sum())
    print(f"{what} circuit: chain index {x.chain_index}; ((a + b) m) "
          f"rotated by 1 in {right} of {params.n} slots")
    if right != params.n:
        raise RuntimeError(f"{what} circuit: {params.n - right} slots "
                           "differ")
    if not torch.equal(mr.data, getattr(bfv32, fn_name)(
            ev._bfv_at(1), ca.data, cb.data)):
        raise RuntimeError(f"{what} multiply_and_relin differs from "
                           f"{fn_name}")
    prod = be.decode(ev.decrypt(sk, mr)).astype(object)
    right = int((prod == ao * bo % t).sum())
    margin, need, inside, bound = multech_bound(ctx, bound_name)
    print(f"{what} multiply_and_relin: bit-equal to {fn_name} on the same "
          f"inputs; decrypts to a b in {right} of {params.n} slots (bound "
          f"{bound}: {margin:.2f} against {need:.2f}, "
          f"{'inside: gated' if inside else 'OUTSIDE: not gated'})")
    if inside and right != params.n:
        raise RuntimeError(f"{what} multiply_and_relin: {params.n - right} "
                           "slots differ inside the bound")


def _fast32_phases(card: str, wrappers, launches, dev) -> None:
    """Phases 27-30: the Fast32 golden files through the kernels, then the
    CKKS, BGV and BFV circuits at full width, each circuit's state
    released before the next."""
    import torch
    for name, (got, want) in fast32_golden(dev).items():
        if not np.array_equal(got, want):
            raise RuntimeError(f"Fast32 golden: {name} differs from the JAX "
                               "output")
    print(f"Fast32 golden: {len(FAST32_CASES)} files, every verb through "
          "the kernels bit-equal to the JAX package's output")
    fast32_ckks_circuit(chain_params(**HEADLINE), card, wrappers, launches,
                        dev)
    torch.cuda.empty_cache()
    fast32_bgv_circuit(mod_t_params(**BGV, scheme="bgv"), card, wrappers,
                       launches, dev)
    torch.cuda.empty_cache()
    for mt in FAST32_BFV_TECHS:
        fast32_bfv_circuit(mod_t_params(**BFV, scheme="bfv", mul_tech=mt),
                           card, wrappers, launches, dev)
        torch.cuda.empty_cache()


# phases 32-33: each technique's EXPECTED label, and its noise_scale_deg
# for the leveled drop (find_levels_to_drop gives 3 at the BFV
# configuration for degree 4, 0 for degree 1)
MULTECH_LABELS = {"hps": "BFV step", "behz": "BFV BEHZ step",
                  "overq": "BFV HPSoverQ step", "leveled": "BFV leveled step",
                  "leveled, drop": "BFV leveled step with a drop"}
LEVELED_DROP_DEG = 4


def _multech_pipes(ctx, evk, dev):
    """{(technique, engine): (pipeline, multiply + relin, level drop)} at
    chain index 1, one KeySwitch32 per engine shared by every technique,
    and the HPS pipeline with lift="kernel"."""
    from phantom_tpu_torch.ops import bfv32
    from phantom_tpu_torch.ops import pipeline32 as pp
    drop = bfv32.levels_to_drop(ctx, LEVELED_DROP_DEG)
    pipes = {}
    for e in ENGINES:
        ks = pp.KeySwitch32(ctx, 1, e).to(dev)
        hps = bfv32.BFVPipeline32(ctx, evk, 1, e, ks=ks).to(dev)
        pipes["hps", e] = (hps, bfv32.bfv_mult_relin32, 0)
        pipes["behz", e] = (bfv32.BFVBehz32(ctx, evk, 1, e, ks=ks).to(dev),
                            bfv32.bfv_mult_relin_behz32, 0)
        pipes["overq", e] = (hps, bfv32.bfv_mult_relin_overq32, 0)
        for tech, lvl in (("leveled", bfv32.levels_to_drop(ctx, 1)),
                          ("leveled, drop", drop)):
            pipes[tech, e] = (bfv32.BFVLeveled32(ctx, evk, lvl, e,
                                                 ks=ks).to(dev),
                              bfv32.bfv_mult_relin_leveled32, lvl)
    fused = bfv32.BFVPipeline32(ctx, evk, 1, ENGINES[0],
                                ks=pipes["hps", ENGINES[0]][0].ks,
                                lift="kernel").to(dev)
    return pipes, fused


def _bfv_multech_phases(card, probes, wrappers, since, launches, dev):
    """Phases 31-33: BFV's BEHZ, HPSoverQ and leveled multiplications and
    the fused lift: the golden file, every kernel call at the BFV
    configuration, the steps' checks and decryptions, the timing."""
    import torch
    from phantom_tpu_torch import make_context
    from phantom_tpu_torch.ops import bfv32
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes.ciphertext import Ciphertext

    # 31. golden
    res = bfv_multech_golden(dev)
    for name, (got, want) in res.items():
        if not np.array_equal(got, want):
            raise RuntimeError(f"BFV techniques golden: {name} differs from "
                               "the JAX output")
    print(f"BFV techniques golden: {len(res)} outputs (BEHZ, HPSoverQ, "
          "leveled at the model's drop and at force_lvl=1, multiply and "
          "multiply + relin on both engines; the fused lift; decryptions "
          "and noise budgets) bit-equal to the JAX package's")

    # 32. at the BFV configuration
    t0 = time.time()
    params = mod_t_params(**BFV, mul_tech="behz")
    ctx = make_context(params)
    t_ctx = time.time() - t0
    sk, rlk, d1, d2, m1, m2 = make_mod_t_inputs(ctx, SEED, dev)
    evk = pp.convert_key32(ctx, rlk)
    pipes, fused = _multech_pipes(ctx, evk, dev)
    drop = pipes["leveled, drop", ENGINES[0]][2]
    if not drop:
        raise RuntimeError("BFV techniques: the noise model drops no level "
                           f"at noise_scale_deg {LEVELED_DROP_DEG}")
    torch.cuda.synchronize()
    print(f"BFV techniques setup: N={params.n} L={params.size_q} "
          f"alpha={params.size_p} t={params.plain_modulus}, Bsk "
          f"{len(ctx.bsk_moduli)} primes of 29 bits; leveled drops "
          f"{pipes['leveled', ENGINES[0]][2]} levels at noise_scale_deg 1 "
          f"and {drop} at {LEVELED_DROP_DEG}; context (host tables of "
          f"{ctx.ntt.num_limbs} moduli) {t_ctx:.1f} s, keys, encryptions "
          f"and pipelines {time.time() - t0:.1f} s")
    for (tech, e), (p, fn, _) in pipes.items():
        if tech != "hps":  # HPS's calls are phase 18's
            fn(p, d1, d2, probes)
    fused(d1, d2, probes)
    _print_calls(probes, card, since)
    outs = {}
    for (tech, e), (p, fn, _) in pipes.items():
        label = f"{MULTECH_LABELS[tech]}, {e}"
        got = _count(wrappers, label, lambda: fn(p, d1, d2), launches)
        if not torch.equal(got, fn(p, d1, d2, pp.PLAIN)):
            raise RuntimeError(f"{label}: kernel path differs from the plain "
                               "path")
        if tech in outs and not torch.equal(outs[tech], got):
            raise RuntimeError(f"{MULTECH_LABELS[tech]}: the engines differ")
        outs[tech] = got
    got = _count(wrappers, "BFV step, fused lift", lambda: fused(d1, d2),
                 launches)
    if not (torch.equal(got, outs["hps"])
            and torch.equal(fused(d1, d2, pp.PLAIN), got)):
        raise RuntimeError("BFV step: the fused lift differs from the xla "
                           "lift or from its plain path")
    print("BFV techniques: each kernel path bit-equal to its plain path on "
          "both engines, the engines bit-equal; the fused lift (one K3 at "
          "alpha 43, k_out 87) bit-equal to the xla lift")
    t_ = params.plain_modulus
    want = negacyclic_product(m1, m2) % t_
    for tech, out in outs.items():
        lvl = pipes[tech, ENGINES[0]][2]
        k_l = params.size_q - lvl
        got = keys.decrypt(ctx, sk,
                           out[:, :k_l].contiguous()).cpu().numpy()
        right = int((got == want).sum())
        budget = keys.invariant_noise_budget(ctx, sk, Ciphertext(out))
        margin, need, inside, what = multech_bound(
            ctx, "hps" if tech == "hps" else tech.split(",")[0], lvl)
        print(f"BFV decrypt, {tech}: m1*m2 mod (X^N + 1, t) in {right} of "
              f"{params.n} coefficients (over Ql, {k_l} primes); noise "
              f"budget {budget} bits; bound {what}: {margin:.2f} against "
              f"{need:.2f}, {'inside' if inside else 'OUTSIDE'}"
              + ("" if inside else " (not gated)"))
        if inside and right != params.n:
            raise RuntimeError(f"BFV decrypt, {tech}: {params.n - right} "
                               "coefficients of m1*m2 differ inside the "
                               "bound")

    # 33. timing: the techniques chained in turns, the lifts in turns,
    # peak memory, the profiler
    def chain_pipe(tech):
        return ((fused, bfv32.bfv_mult_relin32, 0) if tech == "fused lift"
                else pipes[tech, ENGINES[0]])

    def chain(tech):
        p, fn, _ = chain_pipe(tech)

        def run(steps):
            d = d1
            for _ in range(steps):
                d = fn(p, d, d2)
            return d
        return run

    order = ("hps", "behz", "overq", "leveled, drop")
    finals = _chain_timing(order + order[::-1], chain, CHAIN_BFV_STEPS, card,
                           "BFV step by technique")
    if not torch.equal(finals["overq"], chain("leveled")(CHAIN_BFV_STEPS)):
        raise RuntimeError("BFV timing: leveled without a drop differs from "
                           "HPSoverQ")
    finals = _chain_timing(("hps", "fused lift", "fused lift", "hps"), chain,
                           CHAIN_BFV_STEPS, card, "BFV step by lift")
    if not torch.equal(finals["hps"], finals["fused lift"]):
        raise RuntimeError("BFV timing: the lifts' chained outputs differ")
    hps = pipes["hps", ENGINES[0]][0]
    both = torch.cat([d1, d2])
    lifts = {"xla lift (K5 x4, K2)": lambda: pp._fwd(
        hps.ks, torch.stack([bfv32._lift(hps, d1, pp.KERNELS),
                             bfv32._lift(hps, d2, pp.KERNELS)]), hps.rows_d,
        pp.KERNELS),
        "fused lift (K3)": lambda: bfv32._lift_ntt_fused(fused, both)}
    times = {}
    for label in list(lifts) + list(lifts)[::-1]:
        times.setdefault(label, []).append(_device_ms(lifts[label], REPS))
    print("timing the lift and forward NTT of (d1, d2), device time: "
          + ", ".join(f"{k} {np.mean(v):.4f} ms ("
                      + ", ".join(f"{u:.4f}" for u in v) + ")"
                      for k, v in times.items()) + f" [{card}]")
    for tech in order[1:] + ("fused lift",):
        p, fn, _ = chain_pipe(tech)
        d = [d1]

        def run(p=p, fn=fn):
            d[0] = fn(p, d[0], d2)
        _profile(run, PROFILE_STEPS, card, f"BFV {tech} step")


_PROBED_SOURCES = ("bconv_ntt.cu", "modup_ip.cu", "ntt.cu", "bconv.cu",
                   "moddown_rows.cu", "moddown_rescale.cu")


def _probe_library(name: str, patches, tmp: str):
    """Start the nvcc builds of a patched copy of the probed kernels'
    sources; returns (library path, objects, processes)."""
    import shutil
    from phantom_tpu_torch import _build
    d = os.path.join(tmp, name.replace(" ", "_"))
    shutil.copytree(_build.CSRC, d)
    for f, old, new in patches:
        path = os.path.join(d, f)
        with open(path) as fh:
            src = fh.read()
        if old not in src:
            raise RuntimeError(f"anatomy probe {name!r}: {f} has no {old!r}")
        with open(path, "w") as fh:
            fh.write(src.replace(old, new))
    objs, procs = [], []
    for f in _PROBED_SOURCES:
        obj = os.path.join(d, f + ".o")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-c", "-o", obj,
               os.path.join(d, f)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
        objs.append(obj)
    return os.path.join(d, "lib.so"), objs, procs


def _anatomy(card: str, dev) -> None:
    """Phase 26: K3, K8, K7 and K1 on the headline moddown's shapes, K1
    and K2 on the modup's, K5 on the modup's digit and BFV's
    scale-and-round, and K4 on the alpha-8 step's, timed (device time) on
    the library as built and on each probe of ANATOMY (seeded operands),
    in turns (base, probes, probes reversed, base)."""
    import ctypes
    import tempfile
    import torch
    from phantom_tpu_torch import _build, make_context
    from phantom_tpu_torch.ops import bconv_kernels, moddown_kernels
    from phantom_tpu_torch.ops import modup_ip_kernels, ntt_kernels
    from phantom_tpu_torch.ops import pipeline32 as pp
    libs = {}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        started = {name: _probe_library(name, patches, tmp)
                   for name, patches in ANATOMY.items()}
        for name, (so, objs, procs) in started.items():
            _build._run(procs)
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
                   so, *objs]
            _build._run([(cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))])
            lib = ctypes.CDLL(so)
            for fn in ("ptk_bconv_ntt_forward", "ptk_modup_ip",
                       "ptk_ntt_inverse", "ptk_ntt_forward",
                       "ptk_moddown_rows", "ptk_moddown_rescale",
                       "ptk_fold_matmul", "ptk_fold_matmul_smem",
                       "ptk_error_string"):
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = \
                    _build._SIGNATURES[fn]
            libs[name] = lib
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 26)

    def res(shape, q):
        return (torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
                % q).int()

    calls = {}
    ctx = make_context(chain_params(**HEADLINE))
    t, k, alpha, n = ctx.ntt, HEADLINE["limbs"], HEADLINE["alpha"], \
        HEADLINE["n"]
    q = t.q.long().view(-1, 1)
    y = res((2, alpha, n), q[k:k + alpha].view(1, alpha, 1))
    mat = res((2, k, alpha), q[:k].view(1, k, 1))
    v = torch.randint(0, alpha, (2, n), generator=gen, device=dev).int()
    vmul, sc = (res((k,), q[:k].view(k)) for _ in range(2))
    scs = ((sc.long() << 32) // q[:k].view(k)).int()
    sub, d1, d2 = (res((2, k, n), q[:k]) for _ in range(3))
    rows = t.all_rows()[:k].contiguous()
    calls[f"K3 moddown (2, {alpha}, N) -> (2, {k}, N)"] = \
        lambda: ntt_kernels.bconv_ntt_forward(
            y, mat, t, rows, v=v, vmul=vmul, sub_from=sub, epi_scale=sc,
            epi_scale_shoup=scs, tensor_add=(d1, d2))
    mat8 = mat[0].contiguous()
    calls[f"K8 moddown (2, {alpha}, N) -> (2, {k}, N), R = 8"] = \
        lambda: moddown_kernels.moddown_rows(
            y, mat8, v, vmul, sub, (d1, d2), t, rows, sc, scs, 8)
    # K7: the rescale's constants seeded too (only times are read)
    half = int(q[k - 1]) // 2
    hmq, qi = (res((k - 1,), q[:k - 1].view(k - 1)) for _ in range(2))
    qis = ((qi.long() << 32) // q[:k - 1].view(k - 1)).int()
    calls[f"K7 merged epilogue (2, {alpha}, N) -> (2, {k}, N)"] = \
        lambda: moddown_kernels.moddown_rescale(
            y, mat8, v, vmul, sub, (d1, d2), t, rows, sc, scs, half, hmq, qi,
            qis)
    # K2: the modup's complement rows of both digits, lazy [0, 2q)
    rows_c = pp.build_keyswitch32(ctx, device=dev).rows_compl
    xc = res((rows_c.numel(), n), 2 * q[rows_c.long()])
    calls[f"K2 modup ({rows_c.numel()}, N)"] = \
        lambda: ntt_kernels.ntt_forward(xc, t, rows_c)
    # K1: the moddown's inverse with v, the modup's with mul_by
    qp, qk = q[k:k + alpha].view(alpha), q[:k].view(k)
    psc, ksc = res((alpha,), qp), res((k,), qk)
    psh, ksh = ((psc.long() << 32) // qp).int(), ((ksc.long() << 32) //
                                                   qk).int()
    uv = (((1 << 32) // qp).int(), ((1 << 32) % qp).int())
    xp = res((2, alpha, n), q[k:k + alpha].view(1, alpha, 1))
    xq, mq = (res((k, n), q[:k]) for _ in range(2))
    prow = t.all_rows()[k:k + alpha].contiguous()
    calls[f"K1 moddown (2, {alpha}, N) with v"] = \
        lambda: ntt_kernels.ntt_inverse(xp, t, prow, psc, psh,
                                        emit_floor_div=uv)
    calls[f"K1 modup ({k}, N) with mul_by"] = \
        lambda: ntt_kernels.ntt_inverse(xq, t, rows, ksc, ksh, mul_by=mq)
    # K5: the headline modup's digit, (22, N) -> 43, and BFV's (87, N) -> 44
    for k_in, k_out in ((alpha, k), (2 * k + 1, k + 1)):
        y5 = res((k_in, n), q[:1])
        m5 = res((k_out, k_in), q[:k_out])
        calls[f"K5 ({k_in}, N) -> {k_out}"] = \
            lambda y5=y5, m5=m5, k_out=k_out: bconv_kernels.fold_matmul(
                y5, m5, t.q[:k_out])
    ctx8 = make_context(chain_params(**ALPHA8))
    t8, k8, a8 = ctx8.ntt, ALPHA8["limbs"], ALPHA8["alpha"]
    q8 = t8.q.long().view(-1, 1)
    beta, k_out = -(-k8 // a8), k8 + a8
    y8, pa, pb = (res((k8, n), q8[:k8]) for _ in range(3))
    mats = res((beta, k_out, a8), q8[:k_out].view(1, k_out, 1))
    evk = res((beta, 2, k_out, n), q8[:k_out].view(1, 1, k_out, 1))
    calls[f"K4 alpha {a8} (beta {beta}, k_out {k_out})"] = \
        lambda: modup_ip_kernels.modup_ip(y8, mats, (pa, pb), evk, t8,
                                          k_data=k8)
    base_lib = _build.library()
    order = ["base", *ANATOMY, *reversed(ANATOMY), "base"]
    times = {}
    try:
        for name in order:
            lib = base_lib if name == "base" else libs[name]
            _build.library = lambda lib=lib: lib
            for what, fn in calls.items():
                times.setdefault(what, {}).setdefault(name, []).append(
                    _device_ms(fn, REPS))
    finally:
        _build.library = lambda: base_lib
    for what, by in times.items():
        base = float(np.mean(by["base"]))
        print(f"anatomy {what}: base {base:.4f} ms; " + "; ".join(
            f"{name} {np.mean(ms):.4f} ms ({np.mean(ms) - base:+.4f})"
            for name, ms in by.items() if name != "base") + f" [{card}]")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from phantom_tpu_torch import _build, make_context
    from phantom_tpu_torch.ops import moddown_kernels, ntt_kernels
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes import galois
    from phantom_tpu_torch.schemes.context import resolve_device
    from phantom_tpu_torch.schemes.params import EncryptionParameters

    dev = resolve_device()
    card = _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    print(card)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
          f", CUDA {torch.version.cuda}; triton {triton_v}; "
          f"devices {torch.cuda.device_count()}")
    print("nvcc: " + _cmd([_build.nvcc_path(), "--version"]).splitlines()[-1])

    # 2. build
    t0 = time.time()
    calls = sys.argv[1:] == ["--calls"]
    if not calls:  # K7's registers and spills, beside the library's build
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        ptxas = start_ptxas_report("moddown_rescale.cu", os.path.join(
            _build.BUILD_DIR, "moddown_rescale_ptxas.o"))
    path = _build.build()
    _build.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s")
    if calls:
        calls_only(card, dev)
        return 0
    imma = sass_count(path, "fold_matmul_kernel", "IMMA")
    if not imma:
        raise RuntimeError("K5: no IMMA instruction in fold_matmul_kernel")
    print(f"sass: K5 fold_matmul_kernel issues {sum(imma.values())} int8 "
          f"tensor-core instructions ({', '.join(sorted(imma))})")
    syms = _cuobjdump(path, "-symbols")
    stale = [k for k in STALE_KERNELS if k in syms]
    missing = [k for k in CORE_KERNELS if k not in syms]
    if stale or missing:
        raise RuntimeError(f"build: two-pass kernels {stale} in the library, "
                           f"core kernels {missing} not")
    use = resource_usage(path, CORE_KERNELS)
    print(f"symbols: none of {', '.join(STALE_KERNELS)}; resources: "
          + "; ".join(f"{k} {v}" for k, v in use.items()))
    print("ptxas: " + "; ".join(f"{k} {v}" for k, v in ptxas_report(
        ptxas, K7_KERNELS).items()))

    # 3. golden files from the JAX package
    g = np.load(GOLDEN)
    gctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist()))
    grlk = torch.as_tensor(g["rlk"].view(np.int32), device=dev)
    gd = [torch.as_tensor(g[k].view(np.int32), device=dev)
          for k in ("d1", "d2")]
    for name, kw in EPILOGUES.items():
        gpipe = pp.build_pipeline32(gctx, grlk, **kw)
        for route, gout in (("K4", gpipe(*gd)), ("xla-split", pp.
                            _mult_relin_rescale_split(gpipe, *gd))):
            if not np.array_equal(gout.cpu().numpy().view(np.uint32),
                                  g["out"]):
                raise RuntimeError(f"golden: step ({name} epilogue, {route} "
                                   "route) differs from the JAX output")
        print(f"golden: step, {name} epilogue, K4 and xla-split routes, "
              f"bit-equal to the JAX package's output {tuple(g['out'].shape)}")
    for name, (got, want) in rotate_golden(dev).items():
        if not np.array_equal(got.cpu().numpy().view(np.uint32), want):
            raise RuntimeError(f"golden: {name} differs from the JAX output")
        print(f"golden: {name} bit-equal to the JAX package's output "
              f"{tuple(want.shape)}")

    # 4-5. headline step
    t0 = time.time()
    params = chain_params(**HEADLINE)
    ctx = make_context(params)
    sk, pipe, d1, d2, m1, m2 = make_step_inputs(ctx, SEED, DELTA_BITS, dev)
    torch.cuda.synchronize()
    print(f"setup: N={params.n} L={params.size_q} alpha={params.size_p} "
          f"dnum={pipe.ks.beta}, keys and encryptions in "
          f"{time.time() - t0:.1f} s")

    wrappers = kernel_wrappers()
    probes = _probes(pp, wrappers)
    since = {name: 0 for name, *_ in KERNELS}
    # the same relin key through each epilogue
    pipes = {name: pp.CKKSPipeline32(ctx, pipe.evk, **kw).to(dev) if kw
             else pipe for name, kw in EPILOGUES.items()}
    for p in pipes.values():
        p(d1, d2, probes)
    _print_calls(probes, card, since)

    launches = {name: 0 for name, *_ in KERNELS}
    out = _count(wrappers, "headline step", lambda: pipe(d1, d2), launches)
    out_plain = pipe(d1, d2, pp.PLAIN)
    if not torch.equal(out, out_plain):
        raise RuntimeError("step: kernel path differs from plain path")
    print(f"step: kernel path bit-equal to plain path {tuple(out.shape)}")
    for name in ("K8", "K7"):
        got = _count(wrappers, f"headline step, {name} epilogue",
                     lambda: pipes[name](d1, d2), launches)
        if not torch.equal(got, out):
            raise RuntimeError(f"step: the {name} epilogue differs from the "
                               "pair")
    print(f"step: the K8 (R = {EPILOGUES['K8']['moddown_rows']}) and K7 "
          "epilogues bit-equal to the pair")
    dist = check_decrypt(ctx, sk, out, m1, m2, DELTA_BITS)
    print(f"decrypt: equals m1*m2 in all {params.n} coefficients; largest "
          f"distance before rounding {dist:.3e}")

    # 6. timing: chained steps, plain and kernel paths in turns
    q_pad = ctx.key_q[params.size_q - 1:params.size_q].view(1, 1, 1)

    def step_chain(route):
        ops = pp.PLAIN if route == "plain path" else pp.KERNELS

        def run(steps):
            d = d1
            for _ in range(steps):
                d = remix(pipe(d, d2, ops), q_pad)
            return d
        return run

    finals = _chain_timing(("plain path", "kernel path", "kernel path",
                            "plain path"), step_chain, CHAIN_STEPS, card,
                           "headline step")
    if not torch.equal(finals["plain path"], finals["kernel path"]):
        raise RuntimeError("timing: chained outputs differ")

    def epilogue_chain(route):
        def run(steps):
            d = d1
            for _ in range(steps):
                d = remix(pipes[route](d, d2), q_pad)
            return d
        return run

    finals = _chain_timing(("pair", "K8", "K7", "K7", "K8", "pair"),
                           epilogue_chain, CHAIN_STEPS, card,
                           "headline step by epilogue")
    if not all(torch.equal(f, finals["pair"]) for f in finals.values()):
        raise RuntimeError("timing: chained outputs differ by epilogue")
    # K8 alone on the step's operands at each R (the epilogue's R is fixed)
    k8_args = []

    def keep_args(*a):
        k8_args.extend(a)
        return moddown_kernels.moddown_rows(*a)

    pipes["K8"](d1, d2, pp.KERNELS._replace(moddown_rows=keep_args))
    times = {r: _time(lambda: moddown_kernels.moddown_rows(*k8_args[:-1], r),
                      REPS) for r in K8_ROWS}
    c8 = ntt_kernels.default_cluster(params.n)
    print("timing K8 per call by rows per cluster: " + ", ".join(
        f"R={r} (held {moddown_kernels.held_rows(r, params.n, c8)}) "
        f"{ms:.4f} ms" for r, ms in times.items()) + f" [{card}]")
    # K3, K8, K7 and K1 alone on the moddown's operands, K2 on the modup's,
    # at each cluster size, in turns
    calls = {"K3": [], "K1": [], "K2": [], "K7": []}

    def keep(name, fn):
        def call(*a, **kw):
            calls[name].append((a, kw))
            return fn(*a, **kw)
        return call

    pipe(d1, d2, pp.KERNELS._replace(
        bconv_ntt_forward=keep("K3", ntt_kernels.bconv_ntt_forward),
        ntt_inverse=keep("K1", ntt_kernels.ntt_inverse),
        ntt_forward=keep("K2", ntt_kernels.ntt_forward)))
    pipes["K7"](d1, d2, pp.KERNELS._replace(moddown_rescale=keep(
        "K7", moddown_kernels.moddown_rescale)))
    _k7_vs_pair(calls, card)
    k1_md = next(c for c in calls["K1"]
                 if c[1].get("emit_floor_div") is not None)
    # K2 also at BFV's D forward and BGV's moddown shapes (seeded, lazy
    # [0, 2q), over the modup's complement rows and the first 43)
    (_, t_, rows_c), _ = calls["K2"][0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    rows_q = t_.all_rows()[:params.size_q].contiguous()
    x_d, x_q = ((torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
                 % (2 * t_.q[r.long()].long().view(-1, 1))).int()
                for shape, r in (((2, 2, rows_c.numel(), params.n), rows_c),
                                 ((2, params.size_q, params.n), rows_q)))
    for name, fn, (args, kw), what in (
            ("K3", ntt_kernels.bconv_ntt_forward, calls["K3"][0],
             "moddown"),  # the moddown pair's calls
            ("K8", moddown_kernels.moddown_rows, (k8_args, {}),
             f"moddown, R = {k8_args[-1]},"),
            ("K7", moddown_kernels.moddown_rescale, calls["K7"][0],
             "merged epilogue"),
            ("K1", ntt_kernels.ntt_inverse, k1_md, "moddown"),
            ("K2", ntt_kernels.ntt_forward, calls["K2"][0], "modup"),
            ("K2", ntt_kernels.ntt_forward, ((x_d, t_, rows_c), {}),
             "BFV's D forward shape"),
            ("K2", ntt_kernels.ntt_forward, ((x_q, t_, rows_q), {}),
             "BGV's moddown shape")):
        ref = fn(*args, **kw)
        words = (ntt_kernels.K2_CLUSTER_WORDS if name == "K2"
                 else ntt_kernels.CLUSTER_WORDS)
        times = {}
        for c in K3_CLUSTERS + K3_CLUSTERS[::-1]:
            def run(c=c):
                return fn(*args, **kw, cluster=c)
            if _max_err(run(), ref):
                raise RuntimeError(f"{name} at cluster {c} differs from the "
                                   "default")
            times.setdefault(c, []).append(_time(run, REPS))
        what += (f" {tuple(args[0].shape)} with v" if name == "K1" else
                 f" {tuple(args[0].shape)} -> {tuple(ref.shape)}")
        print(f"timing {name} per call by blocks per row, {what} "
              "(bit-equal): "
              + ", ".join(f"C={c} {np.mean(v):.4f} ms ("
                          + ", ".join(f"{u:.4f}" for u in v) + ")"
                          for c, v in times.items())
              + f"; default C={ntt_kernels.default_cluster(params.n, words)} "
              f"[{card}]")
    del calls, k1_md, k8_args, args, kw, ref, x_d, x_q  # phase 6's alone

    # 7. profile: where one chained kernel-path step's device time goes,
    # through each epilogue
    for name in pipes:
        dd = [d1]

        def prof_step(name=name):
            dd[0] = remix(pipes[name](dd[0], d2), q_pad)
        _profile(prof_step, PROFILE_STEPS, card, "headline step" if
                 name == "pair" else f"headline step, {name} epilogue")

    # 8. the modup routes: K4p ("xla") and K4 at alpha 22 ("kernel")
    rpipes = {r: pp.CKKSPipeline32(ctx, pipe.evk, modup=r).to(dev)
              for r in ROUTES[1:]}
    rpipes[pipe.ks.modup] = pipe
    for r in ROUTES[1:]:
        rpipes[r](d1, d2, probes)
    _print_calls(probes, card, since)
    for r in ROUTES[1:]:
        got = _count(wrappers, f"headline step, {r} route",
                     lambda: rpipes[r](d1, d2), launches)
        if not (torch.equal(got, out)
                and torch.equal(rpipes[r](d1, d2, pp.PLAIN), out)):
            raise RuntimeError(f"step: the {r} route differs from the "
                               "xla-split route or from its plain path")
        dist = check_decrypt(ctx, sk, got, m1, m2, DELTA_BITS)
        print(f"step, {r} route: kernel path bit-equal to its plain path "
              f"and to the xla-split route {tuple(got.shape)}; decrypts to "
              f"m1*m2 in all {params.n} coefficients, largest distance "
              f"{dist:.3e}")

    # 9. the routes in turns, chained
    def route_chain(route):
        def run(steps):
            d = d1
            for _ in range(steps):
                d = remix(rpipes[route](d, d2), q_pad)
            return d
        return run

    finals = _chain_timing(ROUTES + ROUTES[::-1], route_chain, CHAIN_STEPS,
                           card, "headline step by modup route")
    if not all(torch.equal(f, finals[ROUTES[0]]) for f in finals.values()):
        raise RuntimeError("timing: chained outputs differ by modup route")
    dd = [d1]

    def prof_xla():
        dd[0] = remix(rpipes["xla"](dd[0], d2), q_pad)
    _profile(prof_xla, PROFILE_STEPS, card, "headline step, xla route")
    del sk, pipe, pipes, rpipes, d1, d2, out, out_plain, finals, dd
    torch.cuda.empty_cache()

    # 10. alpha = 8 setup
    t0 = time.time()
    params8 = chain_params(**ALPHA8)
    ctx8 = make_context(params8)
    t_ctx = time.time() - t0
    sk8, pipe8, e1, e2, n1, n2 = make_step_inputs(ctx8, SEED, DELTA_BITS,
                                                   dev)
    gal = make_galois(ctx8, sk8, SEED, STEPS, dev)
    ks8 = pipe8.ks
    rng = np.random.default_rng(SEED + 2)
    weights = [rng.integers(-3, 4, params8.n) for _ in range(8)]
    pts = [encode_weights(ctx8, ks8, w) for w in weights]
    torch.cuda.synchronize()
    print(f"alpha-8 setup: N={params8.n} L={params8.size_q} "
          f"alpha={params8.size_p} dnum={ks8.beta}; context (host tables of "
          f"{params8.size_qp} moduli) {t_ctx:.1f} s, keys (relin + "
          f"{len(STEPS)} Galois) and encryptions {time.time() - t0:.1f} s")

    # 11. alpha = 8 kernels under the probes
    rot = lambda ops: pp.rotate32(ks8, gal, e1, 1, ops)
    hoist = lambda ops: pp.hoisting_sum32(ks8, gal, e1, STEPS, ops)
    combo = lambda ops: pp.hoisted_linear_combo32(ks8, gal, e1,
                                                  range(8), pts, ops)
    step8 = lambda ops: pipe8(e1, e2, ops)
    split8 = lambda ops: pp._mult_relin_rescale_split(pipe8, e1, e2, ops)
    pipes8 = {name: pp.CKKSPipeline32(ctx8, pipe8.evk, **kw).to(dev)
              for name, kw in EPILOGUES.items() if kw}
    for fn in (rot, hoist, combo, step8, split8):
        fn(probes)
    for p in pipes8.values():
        p(e1, e2, probes)
    _print_calls(probes, card, since)

    # 12-14. each path: launch counts, kernels = plain, decryption
    m1s = {0: n1, **{s: galois_coeffs(n1, galois.get_elt_from_step(
        s, params8.n)) for s in STEPS}}
    scale = 2.0 ** DELTA_BITS
    checks = [
        ("rotation", rot, m1s[1]),
        ("hoisting_sum32", hoist, sum(m1s[s] for s in STEPS)),
        ("hoisted_linear_combo32", combo,
         sum(negacyclic_product(w, m1s[s]) for s, w in enumerate(weights))),
    ]
    for what, fn, want in checks:
        got = _count(wrappers, what, lambda: fn(pp.KERNELS), launches)
        if not torch.equal(got, fn(pp.PLAIN)):
            raise RuntimeError(f"{what}: kernel path differs from plain")
        dist = check_coeffs(decrypt_coeffs(ctx8, sk8, got, scale), want, what)
        print(f"{what}: kernel path bit-equal to plain path "
              f"{tuple(got.shape)}; decrypts to the expected polynomial in "
              f"all {params8.n} coefficients, largest distance before "
              f"rounding {dist:.3e}")
    out8 = _count(wrappers, "alpha-8 step", lambda: step8(pp.KERNELS),
                  launches)
    if not torch.equal(out8, step8(pp.PLAIN)):
        raise RuntimeError("alpha-8 step: kernel path differs from plain")
    out_split = _count(wrappers, "alpha-8 xla-split step",
                       lambda: split8(pp.KERNELS), launches)
    if not torch.equal(out8, out_split):
        raise RuntimeError("alpha-8 step: K4 route differs from xla-split")
    for name, p in pipes8.items():
        got = _count(wrappers, f"alpha-8 step, {name} epilogue",
                     lambda: p(e1, e2), launches)
        if not torch.equal(got, out8):
            raise RuntimeError(f"alpha-8 step: the {name} epilogue differs "
                               "from the pair")
    dist = check_decrypt(ctx8, sk8, out8, n1, n2, DELTA_BITS)
    print(f"alpha-8 step: K4 route bit-equal to the plain path, to the "
          f"xla-split route (K5/K2/K9) and through the K8 and K7 epilogues "
          f"{tuple(out8.shape)}; decrypts to m1*m2 in all {params8.n} "
          f"coefficients, largest distance {dist:.3e}")

    # 15. alpha = 8 timing
    q8 = ctx8.key_q[params8.size_q - 1:params8.size_q].view(1, 1, 1)

    def step8_chain(route):
        step = (pipe8 if route == "K4 route" else
                lambda a, b: pp._mult_relin_rescale_split(pipe8, a, b))

        def run(steps):
            d = e1
            for _ in range(steps):
                d = remix(step(d, e2), q8)
            return d
        return run

    finals = _chain_timing(("K4 route", "xla-split route", "xla-split route",
                            "K4 route"), step8_chain, CHAIN8_STEPS, card,
                           "alpha-8 step")
    if not torch.equal(finals["K4 route"], finals["xla-split route"]):
        raise RuntimeError("alpha-8 timing: chained outputs differ")

    def rot_chain(_):
        def run(steps):
            d = e1
            for _ in range(steps):
                d = pp.rotate32(ks8, gal, d, 1)
            return d
        return run

    _chain_timing(("kernel path",), rot_chain, CHAIN8_STEPS, card,
                  "rotation (chained)")
    torch.cuda.reset_peak_memory_stats()
    print(f"timing hoisting_sum32 over {len(STEPS)} steps: "
          f"{_time(lambda: hoist(pp.KERNELS), REPS):.3f} ms [{card}]")
    print(f"timing hoisted_linear_combo32 over 8 steps: "
          f"{_time(lambda: combo(pp.KERNELS), REPS):.3f} ms; both hoisted "
          f"forms max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]")
    del ctx8, sk8, pipe8, e1, e2, gal, ks8, pts, pipes8, finals, out8
    del out_split
    torch.cuda.empty_cache()

    # 16-20. BFV
    _bfv_phases(card, probes, wrappers, since, launches, dev)
    torch.cuda.empty_cache()

    # 21-25. BGV
    _bgv_phases(card, probes, wrappers, since, launches, dev)
    torch.cuda.empty_cache()

    # 26. where the kernels' time goes
    _anatomy(card, dev)
    torch.cuda.empty_cache()

    # 27-30. Fast32
    _fast32_phases(card, wrappers, launches, dev)
    torch.cuda.empty_cache()

    # 31-33. BFV's other multiplication techniques and the fused lift
    _bfv_multech_phases(card, probes, wrappers, since, launches, dev)

    rows = []
    for (name, attr, src, repl), probe in zip(KERNELS, probes):
        if not probe.calls:
            raise RuntimeError(f"{name}: not probed")
        rows.append(dict(
            name=f"{name} {attr}", route="cuda", source=src, replaces=repl,
            launches=launches[name],
            max_abs_err=max(c["err"] for c in probe.calls),
            ms=round(sum(c["ms"] for c in probe.calls), 5),
            plain_ms=round(sum(c["plain_ms"] for c in probe.calls), 5),
            bound_ms=round(sum(c["bound_ms"] for c in probe.calls), 5),
            bound_by=max(("bytes", "operations"), key=lambda b: sum(
                c["bound_ms"] for c in probe.calls if c["bound_by"] == b)),
            library_ms=None))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

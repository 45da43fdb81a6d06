#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's CKKS key switching, BFV multiply (by each
of the four techniques, on 32- and 64-bit words), BGV multiply, its
Fast32 evaluator, the CKKS application path (the device encoder,
LinearTransform, polynomial evaluation), the runtime and utils layer
(the reference's Salsa20 sampler S1, the wire formats, StreamExecutor, the
range sanitizer), the coefficient-sharded steps over torch.distributed
(P1, the sharded NTT's local phases), the bench setup cache and the
limb-sharded step on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repo root, one CUDA device
    python3 chip_smoke.py --calls  # only every kernel call of each path
                                   # against its plain version, timed
    python3 chip_smoke.py --calls u64  # the same of the u64 steps only

Four configurations, all N = 2^16 with 43 data primes of 28 bits from
chain index 1, primes as phantom_tpu_torch/utils/benchsetup.chain_primes
(the JAX package's phantom_tpu/utils/benchsetup.py) builds them:
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
               K2, K7 and K8, of the radix-2 K6, of the former two-pass U1,
               two-launch U2 or one-kernel U4 (STALE_KERNELS) left in its
               symbols, the core's kernels, U2's and U4's (CORE_KERNELS)
               there; registers and stack of those, and K7's, U1's, U2's
               and each U4 form's registers and spills (nvcc -Xptxas -v)
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
               each epilogue (pair, K8, K7), after a warm-up step it
               drops (every profile does so): the device-busy time, the
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
 34. F1        the double-float FFT kernels: no FFMA in the SASS of any
               kernel named ckks_fft_*; ckks_fft.npz's tables and
               transforms (n = 256, 1024) bit-equal to the JAX package's
               eager evaluation; forward and inverse at N = 2^16 on seeded
               inputs under the probes (bit-equal to the plain FFT, timed,
               bound); each form's CUDA launches and their blocks as the
               library records them (ptk_ckks_fft_grids: fewer than six,
               more than 32 blocks each); torch.fft.fft over complex128 of
               the twisted vector as the library's yardstick (not
               bit-identical); int64 -> f32 on the card rounding as on the
               CPU
 35. encoder   CKKSDeviceEncoder: ckks_fft.npz's encodings and decodings
               bit-equal to the JAX eager encoder, within +-1 and 1e-10 of
               the jitted one; at the headline configuration, chain
               indices 1 and 7: launch counts, kernel path = plain path,
               encode at 2^28 within +-1 of the host CKKSEncoder in every
               coefficient and decoded within 1e-9 of the host decode, a
               round trip at 2^30 within 1e-6, uniform residues decoded
               without raising; event times beside the host encoder's;
               F1's encode and decode forms under the probes (bit-equal
               to plain, timed, bound), and encode's and
               decode's parts timed apart (host preparation, copy, F1, K2;
               K1 on two limbs, F1, copy back)
 36. MLP       linear_n1024.npz and poly_n1024.npz through the kernels
               bit-equal to the JAX package's outputs; then at the headline
               configuration a d = 64 network: x through CKKSDeviceEncoder
               at scale q_{L-2} q_{L-3}, encrypt_asymmetric, a dense
               LinearTransform (bs 8, gs 8, 14 Galois keys, its QlP weights
               1.1 GiB), a rescale, square + relin, a rescale, a banded
               LinearTransform (diagonals 0-15 and 48-63), a degree-15
               Chebyshev series of the sigmoid on (-8, 8), a rescale,
               decrypt, decode on the device: every stage under the launch
               counts (one modup per layer) and bit-equal to its plain path,
               the whole circuit once more on the plain path, the decoded
               slots within 1e-2 of numpy's float64 evaluation; prepare
               timed apart, event time per stage and end to end, a
               profile
 37. roll      roll_n1024.npz through the kernels: the CKKS step, the
               NTT-form modup and the key switch on "pallas-roll", the
               CKKS step and the moddown pair on the xla-bconv moddown,
               the BGV step on "pallas-roll", bit-equal to the JAX
               package's same routes
 38. routes    the headline CKKS step on "pallas-roll" (K6 both ways, K5,
               K9) and on the xla-bconv moddown (K1, K5 over both halves,
               K2 with the epilogue): launch counts, bit-equal to the
               default route and to the plain path, decryption, event
               time; a profile of the roll step
 39. BGV roll  the BGV step on "pallas-roll": launch counts, bit-equal to
               the default engine and to the plain path
 40. Fast32    Fast32's CKKS (multiply_and_relin, rotate,
     roll      rescale_to_next) and BGV (multiply_and_relin, rotate,
               mod_switch_to_next) verbs on "pallas-roll" at the headline
               and BGV configurations: launch counts, bit-equal to the
               default engine, event time
 41. u64       the IMADs of each U kernel in the SASS (U1's, U2's and
     golden    U4's kernels found there); the four u64 golden files (CKKS
               and BGV, 50- and 60-bit chains) through U1-U4, every output
               bit-equal to the JAX package's, u64_mxn_n1024.npz
               through U4's mxn form, and the four BFV u64 files (one per
               technique, keys, encryptions, every verb, decryptions,
               noise budgets, scaleround's and behz's functions)
 42. u64 CKKS  bench.py --path u64: N = 2^16, 43 data primes of 50 bits, 22
               special of 51; the context's build time (at most 30 s), the
               keys and two encryptions on the card (relin key and
               encryption under launch counts), the step multiply_and_relin
               + rescale_to_next with every U call under a probe (bit-equal
               to plain, event and device time, plain time, bound; U4's
               host time a call), the launch counts, the whole step
               bit-equal to the plain path, decoded within 1e-2 of numpy's
               float64 product (the error printed), 10 chained steps timed
               (event time per step, peak memory), the plain step timed, a
               profile (device-busy, idle share, the aten kernels a step by
               name; its records of U1-U4 held against their launch
               counts); the
               kernel launches U1's, U2's and U4's entry points made in
               the step per wrapper call: one each
 43. u64 BGV   the same for BGV (t the 20-bit batching prime):
               multiply_and_relin + mod_switch_to_next, decrypted right in
               every one of the 65536 slots
 44-47. u64    bench.py --scheme bfv --path u64 --limbs 31 (U64_BFV_CFG:
     BFV       31 data primes of 50 bits, 22 special of 51, t = 786433),
               one context per technique (HPS, BEHZ, HPSoverQ, leveled):
               keys and two encryptions on the card, multiply_and_relin
               with every U call probed (U2's scale_round form among
               them), the launch counts, bit-equal to the plain path, the
               product decrypted right in every slot and its noise budget,
               leveled also with operands of noise_scale_deg 3 (a level
               dropped, decrypted over that level), 10 chained steps, the
               plain step timed, a profile as above
 48. F1 wide   F1's wide forms (64-bit words, primes to 2^61) alone at N =
               2^16 under the probes: encode over 43 primes of 50 bits and
               of 61 bits (coefficients near 2^61), decode of centered
               values up to 2^62 (two limbs and one), bit-equal to plain,
               event and device time, bound; two CUDA launches a call; a
               decode of uniform residues
 49. u64 app   golden: ckks_fft_wide.npz (the wide device encoder at 40- and
     golden    50-bit primes), u64_linear_b50.npz (LinearTransform.apply),
               u64_poly_b50.npz (poly_eval, poly_eval_cheb) through U1-U4
               and F1's wide forms, bit-equal to the JAX package's
 50. u64 MLP   phase 36's network on the u64 evaluator at U64_CFG width
               (43 data primes of 50 bits, 22 special of 51, N = 2^16),
               the input's scale the prime q[41] (about 2^50): keys on the
               card, the weights over QlP (prepare, timed), then encode
               (the wide CKKSDeviceEncoder), layer 1 (dense, d = 64),
               square + relinearize + rescale, layer 2 (banded),
               poly_eval_cheb of degree 15 on (-8, 8) with the final
               rescale (its constants through the host encoder), decode:
               each stage's U1-U4 and F1 launches (EXPECTED_APP64) and
               event time; the whole circuit once more on PLAIN64 from the
               same plaintext and generator state, bit-equal; one modup a
               layer, counted; the decoded output within MLP_TOL of
               numpy's float64 evaluation; end to end timed, a profile,
               peak memory
 51. S1        the reference's Salsa20 sampler (csrc/salsa20.cu) alone at N
               = 2^16 in its three forms (uniform, ternary, error) over 43
               primes of 50 bits (U64_CFG), of 28 bits (the headline
               chain) and of 61 bits that reject about one lane in nine
               (rejecting_primes: retry chains), under the probe
               (bit-equal to plain, event and device time, plain time,
               bound); refformat_n1024.npz's samples (the JAX package's,
               n = 1024) through S1, bit-equal
 52. wire      at U64_CFG (CKKS, 43 data primes of 50 bits, 22 special of
               51): the keys (secret, public, relin, a Galois key) made on
               the card through the reference format and back, bit-equal;
               a client's two encrypt_symmetric_seeded (S1, U1, U4) saved
               seed-compressed (c0 and 64 bytes against the full size);
               the server's loads (S1 regenerates c1) bit-equal to what
               was encrypted, multiply_and_relin + rescale_to_next, its
               save; the client's load, decryption and decode within
               U64_TOL of float64; every object through the port's own
               format and a PTCS encryption, bit-equal; at U64_BFV_CFG a
               seeded BFV ciphertext saved and loaded (S1, U1's inverse),
               bit-equal and decrypted in every slot; each save and load
               timed (host and CUDA events); S1's launches on the path
               (EXPECTED_S1_WIRE)
 53. runtime   at the headline configuration: StreamExecutor(
               mult_relin_rescale32, pipe, batch=4) over 10 request pairs
               (two full batches and a tail of 2) on the shared side CUDA
               stream: the launch counts (10 headline steps), the outputs
               bit-equal in order to direct calls, the stats; items/s of
               the kept executor and of pipeline_map (a new executor a
               run) against the same direct calls in turns with CUDA
               events, peak memory, a profile; the sanitizer enabled:
               the step passes on canonical inputs and raises on an
               input word equal to q
 54. examples  phantom_tpu_torch/examples/serialization.py and
               kernel_fusing.py (JAX examples 4 and 5) as scripts
 55. parallel  phantom_tpu_torch/parallel on a world of one over NCCL
               (a FileStore in a temporary directory): the u32 CKKS step
               at the headline configuration, the u64 CKKS and BGV steps
               at U64_CFG and the u64 BFV HPS step at U64_BFV_CFG, each
               from chain index 1 on seeded uniform operands and relin
               key (parallel/launch.step_setup): W, dp and coeff; P1's
               calls of the u32 and u64 CKKS steps under the probe
               (bit-equal to plain, event and device time, plain time,
               bound); the launch counts (EXPECTED "sharded ... step":
               P1, K5 and K9, or U2-U4) with the all-to-alls and their
               bytes; the output bit-equal to the rank's block of the
               local kernel step and to the sharded step on the plain
               versions; 10 chained steps, local and sharded in turns
               (A, B, B, A), peak memory; a profile.  With two or more
               cards also W = 2 and 4 through the launcher
               (parallel/launch.full_width: each rank's blocks bit-equal
               to the local step's, chained ms, peak memory); with one
               card those lines say "not run"
 56. limb      the bench setup and the ("dp", "limb") layout:
               setup_bench("ckks", **U64_CFG) fresh into an empty cache
               directory (PHANTOM_TORCH_SETUP_CACHE), timed, the context
               build's share apart; the blob's bytes on disk; the setup
               loaded, timed, bit-equal to the fresh one; on a world of
               one over NCCL the limb-sharded step on its (ct1, ct2), a
               batch of one: U1-U4's launches (EXPECTED "limb-sharded
               step") with its collectives and the bytes received, the
               output bit-equal to the local kernel step and to the limb
               step on the plain versions, decrypted and decoded within
               U64_TOL of values^2; 10 chained steps, local and limb in
               turns (A, B, B, A), peak memory; a profile.  With two or
               more cards W = 2, 4 and dp 2 x limb 2 through `launch
               --layout limb` (44 data primes); with one card those
               lines say "not run"
In phases 28-30 every verb runs through the kernels under the launch
counts (EXPECTED), then through the plain versions on the same inputs
(the generator's state replayed) and is held bit-equal, then is timed
(CUDA events); each level's first use (Fast32.prebuild) is timed, and
the peak memory of each circuit printed.
Each probed call (phases 4, 8, 11, 18, 23 and 34) prints its event time
with the host's launch overhead, as every run of this script has, and its
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
unpadded shape) and 7 Shoup products per output for the fold.  F1's work
is its f32 operations, 162 a butterfly, at 132 SMs x 128 lanes x 1.98
GHz = 33.5 T/s; its fused forms' bytes add the slots and slot_of (encode:
and the (k, N) residues written), the limbs and slot_of (decode).  No
single PyTorch call computes a modular NTT or a modular product-sum, so
library_ms is null for K1-K9; F1's is torch.fft.fft over complex128 (the
bare form's calls; its row lists the fused forms' sums under "forms",
with library_ms null: no PyTorch call fuses the scatter or the residues;
the wide forms of phase 48 too, their bound adding a barrett64, 7 32-bit
multiplies, a residue (encode) and Garner's 20 a coefficient (decode)).
U1-U4's rows sum the probed calls of phases 42-47 (U1's forward and
inverse, U2's forms by the form each call took, U4's forms, each listed
under "forms" with its calls, device time and host time a call; U1's, U2's and U4's "launches_per_call", the
kernels one call launches); their bound counts u64 work in 32-bit
multiplies (MUL_HI, MUL_LO: a 64 x 64 product's high word 4, its low
word 3, so a Shoup product 10, a Barrett-128 product 31, reduce128_any
45, the floor sum 58 a word) and each operand's words once (a row form's
(..., 1, N) row once, not once a limb); no PyTorch call computes a u64
modular function, so their library_ms is null.  S1's row sums phase
51's calls (its forms under "forms"), its launches those of the wire path
(phase 52); its bound counts 32-bit integer operations (S1_BLOCK_OPS a
keystream block, the blocks this call's data needs, retries included) at
the same 16.7 T/s, and the words written; library_ms is null: no PyTorch
call computes this keystream.  P1's row sums phase 55's probed calls
(its forms by word, phase and direction under "forms"), its launches
those of the four counted sharded steps; its bound counts each call's
input and output once and the twiddles and Shoup words of each distinct
table row that the phase reads (phase B: every local column's), and a
Shoup product a butterfly (3 32-bit multiplies in u32, SHOUP_OPS in
u64); library_ms is null: no PyTorch call computes a modular NTT phase.
U1-U4's launches count phase 56's limb-sharded step too.
Last comes {"ok": true, "device": ...}.
Without a CUDA device, or without the repo around it, it exits non-zero
before printing any result.
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
    # not a TPU kernel: the JAX package runs this FFT as XLA fusions
    ("F1", "ckks_fft", "phantom_tpu_torch/csrc/ckks_fft.cu",
     "phantom_tpu/ops/ckks_fft.py:168 (XLA, no pallas_call)"),
]
# F1's fused forms (pipeline32.Kernels fields past KERNELS): their probes'
# names; they launch F1's kernels and count in its one launch count
F1_FORMS = {"ckks_fft_encode": "F1 encode", "ckks_fft_decode": "F1 decode"}
PROBE_NAMES = [name for name, *_ in KERNELS] + list(F1_FORMS.values())


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
    # the CKKS application path (phases 34-36) at the headline
    # configuration: the device encoder's inverse FFT and K2; K1 and the
    # forward FFT
    "device encode": _launches(K2=1, F1=1),
    "device decode": _launches(K1=1, F1=1),
    # LinearTransform at d = 64 (bs 8, gs 8) at chain index 1: ONE modup
    # (K1, K5 per digit, K2) shared by the 8 groups; per group K9 for its 7
    # baby steps and one moddown pair (K1, K3); 7 giant rotations (K1 x2,
    # K2, K3, K5 x2, K9 each); the rescale (K1, K3).  A modup per group
    # would add K1 x7, K2 x7 and K5 x14.
    "MLP layer 1, dense": _launches(K1=24, K2=8, K3=16, K5=16, K9=63),
    # the banded layer at chain index 4: 4 groups of 8 diagonals, 3 giant
    # rotations (steps 8, 48, 56), one modup
    "MLP layer 2, banded": _launches(K1=12, K2=4, K3=8, K5=8, K9=31),
    # poly_eval_cheb_fast32 of degree 15 with the interval map: 7 products
    # (multiply_and_relin's K1 x2, K2, K3, K5 x2, K9 each), 8 rescales (K1,
    # K3), 21 constants through the device encoder (F1, K2 each)
    "MLP activation, Chebyshev degree 15": _launches(K1=22, K2=28, K3=15,
                                                     K5=14, K9=7, F1=21),
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
        ("ntt_cluster.cuh", "  for (int left = G.logs; left > kLeave;) {",
         "  for (int left = 0; left > kLeave;) {"),
        ("ntt_cluster.cuh", "  for (int ls = kDone; ls < G.logs;) {",
         "  for (int ls = G.logs; ls < G.logs;) {")],
    "twiddles from L1": [
        ("ntt_cluster.cuh", "ldg_w(w + (g1 << s) + b)", "ldg_w(w + b)"),
        ("ntt_cluster.cuh", "ldg_w(ws + (g1 << s) + b)", "ldg_w(ws + b)")],
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
F32_OPS_PER_S = 132 * 128 * 1.98e9  # f32 lanes, one add or multiply each


# ---------------------------------------------------------------------------
# helpers (also driven on the CPU by tests/test_torch_pipeline.py and
# tests/test_torch_rotate.py)
# ---------------------------------------------------------------------------

def chain_params(n: int, limbs: int, alpha: int, bits: int = 28):
    """The bench's primes (phantom_tpu_torch/utils/benchsetup.chain_primes,
    as the JAX package's benchsetup builds them): `limbs` data primes of
    `bits` bits, `alpha` special primes of bits + 1."""
    from phantom_tpu_torch import EncryptionParameters
    from phantom_tpu_torch.utils.benchsetup import chain_primes
    return EncryptionParameters.create(n, *chain_primes(n, limbs, alpha,
                                                        bits))


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


def remix(out, q, dim: int = 1):
    """A step output (2, k-1, N) -> a full (2, k, N) input: the dropped
    limb is row 0 reduced into its modulus (bench.py's re-pad,
    parallel/launch.remix); dim: the limbs' axis."""
    from phantom_tpu_torch.parallel.launch import remix as launch_remix
    return launch_remix(out, q, dim)


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


ROLL_GOLDEN = os.path.join(FIXTURES, "roll_n1024.npz")


def roll_golden(device, ops=None, schemes=("ckks", "bgv"),
                path: str = ROLL_GOLDEN) -> dict:
    """roll_n1024.npz through the port on `device`: {name: (port output,
    JAX output)} as uint32 arrays, for the CKKS step, the NTT-form modup
    and the key switch on "pallas-roll", the CKKS step and the moddown
    pair on the xla-bconv moddown ("ckks" in schemes), and the BGV step on
    "pallas-roll" ("bgv")."""
    import torch
    from phantom_tpu_torch import make_context
    from phantom_tpu_torch.ops import bgv32
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    ops = pp.KERNELS if ops is None else ops
    g = np.load(path)
    n = int(g["d1"].shape[-1])
    qs, ps = g["data_moduli"].tolist(), g["special_moduli"].tolist()

    def t(name):
        return torch.as_tensor(g[name].view(np.int32), device=device)

    out = {}
    if "ckks" in schemes:
        out.update(_roll_golden_ckks(g, t, n, qs, ps, device, ops))
    if "bgv" in schemes:
        bctx = make_context(EncryptionParameters.create(
            n, qs, ps, "bgv", int(g["t"])), device=device)
        bgv = bgv32.build_bgv32(bctx, t("bgv_rlk"), device=device,
                                engine=pp.ROLL_ENGINE)
        out["bgv_roll_step"] = bgv(t("bd1"), t("bd2"), ops)
    return {k: (v.cpu().numpy().view(np.uint32), g[k])
            for k, v in out.items()}


def _roll_golden_ckks(g, t, n, qs, ps, device, ops) -> dict:
    import torch
    from phantom_tpu_torch import make_context
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    ctx = make_context(EncryptionParameters.create(n, qs, ps),
                       device=device)
    d1, d2 = t("d1"), t("d2")
    roll = pp.build_pipeline32(ctx, t("rlk"), device=device,
                               engine=pp.ROLL_ENGINE)
    xla = pp.build_pipeline32(ctx, t("rlk"), device=device,
                              modup="xla-split", moddown="xla")
    md = t("md")
    return dict(
        roll_step=roll(d1, d2, ops),
        roll_modup=pp.modup_from_ntt32(roll.ks, d1[1], ops),
        roll_ks=pp.keyswitch_from_ntt32(roll.ks, d1[1], roll.evk, ops),
        xla_step=xla(d1, d2, ops),
        xla_pair=torch.stack(pp.moddown32_pair(xla.ks, md[0], md[1],
                                               ops=ops)))


def fast32_case(case: str, device, engine: str = "mxu-pallas"):
    """A Fast32 golden file on `device`: (the file, its context, its keys
    carried over by convert.py (sk, pk, rlk, glk, None where absent), a
    Fast32 with its rlk and glk on `engine`)."""
    return golden_case(f"fast32_{case}.npz", FAST32_CASES[case], device,
                       engine)


def golden_case(fname: str, scheme: str, device,
                engine: str = "mxu-pallas"):
    """fast32_case for the golden file `fname` of `scheme`."""
    from types import SimpleNamespace
    from phantom_tpu_torch import Fast32, convert, make_context
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    g = np.load(os.path.join(FIXTURES, fname))
    ctx = make_context(EncryptionParameters.create(
        int(g["sk"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), scheme, int(g["t"])),
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


def _res(x):
    """A tensor's 32-bit words (int32 residues, f32 planes) as numpy
    uint32."""
    return x.cpu().numpy().view(np.uint32)


def _golden_cmp(out: dict, case: str, g, name: str, c) -> None:
    """out["<case>: <name>"] = (c's residues, the file's), after holding
    c's metadata to the file's (RuntimeError)."""
    meta = g[name + "__meta"].tolist()
    have = [c.chain_index, int(c.is_ntt_form)]
    if len(meta) > 2:
        have += [c.correction_factor, c.noise_scale_deg]
    if have != meta or c.scale != float(g[name + "__scale"]):
        raise RuntimeError(f"golden {case}: {name} metadata {have}, scale "
                           f"{c.scale} != {meta}, "
                           f"{float(g[name + '__scale'])}")
    out[f"{case}: {name}"] = (_res(c.data), g[name])


def fast32_golden(device, cases=tuple(FAST32_CASES), ops=None,
                  engine: str = "mxu-pallas"):
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

    def cmp(case, g, name, c):
        _golden_cmp(out, case, g, name, c)

    for case in cases:
        g, ctx, k, ev = fast32_case(case, device, engine)
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
                out[f"{case}: {name}"] = (_res(x), g[name])
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
            out[f"{case}: pts"] = (_res(torch.stack(pts)), g["pts"])
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


# tests/fixtures/torch_port/ckks_fft.npz, linear_n1024.npz, poly_n1024.npz
# (the CKKS application path); poly_n1024.npz's cases and their intervals
APP_GOLDEN = ("ckks_fft.npz", "linear_n1024.npz", "poly_n1024.npz")
POLY_CASES = {"dense7": None, "sparse": None, "odd": None, "cheb": None,
              "cheb_interval": (-2.0, 2.0)}


def fft_golden(device, ops=None) -> dict:
    """ckks_fft.npz's tables and transforms through the port on `device`:
    {name: (port, JAX eager)} as uint32 words (the slot indices as
    int64): the eight planes and slot indices of make_fft_tables and F1
    (or ops.ckks_fft) forward and inverse, at n = 256 and 1024."""
    import torch
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.ops.ckks_fft import make_fft_tables
    ops = pp.KERNELS if ops is None else ops
    g = np.load(os.path.join(FIXTURES, "ckks_fft.npz"))
    out = {}
    for n in (256, 1024):
        t = make_fft_tables(n, device)
        out[f"table fwd {n}"] = (_res(t.fwd), g[f"fwd_{n}"].view(np.uint32))
        out[f"table inv {n}"] = (_res(t.inv), g[f"inv_{n}"].view(np.uint32))
        for name in ("slot_pos", "slot_conj"):
            out[f"{name} {n}"] = (getattr(t, name).cpu().numpy(),
                                  g[f"{name}_{n}"])
        x = torch.from_numpy(g[f"x_{n}"]).to(device)
        for name in ("forward", "inverse"):
            got = ops.ckks_fft(x, t, inverse=name == "inverse")
            out[f"{name} {n}"] = (_res(got),
                                  g[f"{name}_eager_{n}"].view(np.uint32))
    return out


def _centered_diff(a, b, q: int) -> np.ndarray:
    d = (a.astype(np.int64) - b.astype(np.int64)) % q
    return np.minimum(d, q - d)


def encoder_golden(device, ops=None):
    """CKKSDeviceEncoder on ckks_fft.npz's chain (n = 1024, five 28-bit
    data primes) at chain indices 1 (scale 2^28) and 3 (2^40): (exact,
    jitted).  exact = {name: (port, JAX eager)}: the rounded integers,
    the residues, and the decoded slots of the jitted JAX encoder's
    plaintext.  jitted = {chain index: (the coefficients where the port's
    encoding differs from the jitted JAX encoder's, the largest centered
    difference there, the largest difference of the decoded slots from
    the jitted JAX decoder's)}."""
    import torch
    from phantom_tpu_torch import CKKSDeviceEncoder, Plaintext, make_context
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    ops = pp.KERNELS if ops is None else ops
    g = np.load(os.path.join(FIXTURES, "ckks_fft.npz"))
    ctx = make_context(EncryptionParameters.create(
        int(g["fwd_1024"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist()), device=device)
    enc = CKKSDeviceEncoder(ctx)
    exact, jitted = {}, {}
    for ci in (1, 3):
        scale = float(g[f"scale_{ci}"])
        k = ctx.get_context_data(ci).size_ql
        exact[f"ints {ci}"] = (enc.encode_ints(g["z"], scale, ops).cpu()
                               .numpy(), g[f"ints_eager_{ci}"])
        pt = enc.encode(g["z"], scale, ci, ops)
        exact[f"residues {ci}"] = (_res(pt.data), g[f"enc_eager_{ci}"])
        jit_pt = Plaintext(data=torch.from_numpy(
            g[f"enc_jit_{ci}"].view(np.int32)).to(device), chain_index=ci,
            is_ntt_form=True, scale=scale)
        dec = enc.decode(jit_pt, ops)
        exact[f"decoded {ci}"] = (dec, g[f"dec_eager_{ci}"])
        coeffs = [ops.ntt_inverse(p.data.contiguous(), ctx.ntt,
                                  ctx.rows_qp[:k]).cpu().numpy()
                  for p in (pt, jit_pt)]
        diff = _centered_diff(coeffs[0][0], coeffs[1][0],
                              ctx.params.data_moduli[0])
        where = np.flatnonzero(diff)
        jitted[ci] = (where, int(diff.max()),
                      float(np.abs(dec - g[f"dec_jit_{ci}"]).max()))
    return exact, jitted


def linear_golden(device, ops=None) -> dict:
    """linear_n1024.npz through the port's LinearTransform on `device`:
    {name: (port, JAX)} residues of the prepared diagonals and of
    apply_fast32's output (its metadata held on the way)."""
    import torch
    from phantom_tpu_torch import CKKSEncoder, LinearTransform
    from phantom_tpu_torch.ops import pipeline32 as pp
    ops = pp.KERNELS if ops is None else ops
    g, ctx, _, ev = golden_case("linear_n1024.npz", "ckks", device)
    lt = LinearTransform(g["M"])
    lt.prepare(CKKSEncoder(ctx), float(g["scale"]), 1, ops)
    out = {"linear: pts": (_res(torch.stack(
        [p for grp in lt._prepared[1] for p in grp])), g["pts"])}
    _golden_cmp(out, "linear", g, "y",
                lt.apply_fast32(ev, fast32_ct(ctx, g, "ct"), ops=ops))
    return out


def poly_golden(device, ops=None) -> dict:
    """poly_n1024.npz through the port's poly_eval_fast32 and
    poly_eval_cheb_fast32 on `device` with the host encoder: {"poly:
    y_<case>": (port, JAX)} residues, metadata held on the way."""
    from phantom_tpu_torch import (CKKSEncoder, poly_eval_cheb_fast32,
                                   poly_eval_fast32)
    from phantom_tpu_torch.ops import pipeline32 as pp
    ops = pp.KERNELS if ops is None else ops
    g, ctx, _, ev = golden_case("poly_n1024.npz", "ckks", device)
    enc = CKKSEncoder(ctx)
    c = fast32_ct(ctx, g, "ct")
    out = {}
    for case, interval in POLY_CASES.items():
        cc = g[f"coeffs_{case}"]
        y = (poly_eval_fast32(ev, c, cc, enc, ops=ops)
             if case in ("dense7", "sparse", "odd") else
             poly_eval_cheb_fast32(ev, c, cc, enc, interval=interval,
                                   ops=ops))
        _golden_cmp(out, "poly", g, f"y_{case}", y)
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


# f32 operations of one double-float butterfly: cdf_mul (4 df_mul of 24,
# a df_add and a df_sub of 11) and a cdf_add and a cdf_sub (22 each)
F1_BUTTERFLY_OPS = 4 * 24 + 2 * 11 + 2 * 22


def call_bound(name: str, a: dict, out):
    """(bytes, 32-bit multiplies, int8 tensor-core operations, f32
    operations) of one call from its bound arguments."""
    if name.startswith("F1"):
        # the transform's f32 operations; bytes: the direction's table, the
        # input and the output (encode also reads slot_of and the moduli,
        # decode slot_of; the scatter, rounding and residues are not priced)
        n = a["t"].n
        f32 = (n // 2) * (n.bit_length() - 1) * F1_BUTTERFLY_OPS
        byt = 4 * a["t"].fwd.numel() + out.numel() * out.element_size()
        ops = 0
        if name == "F1":
            f32 += 4 * n if a["inverse"] else 0
            byt += 4 * a["x"].numel()
        elif name == "F1 encode":
            f32 += 2 * n
            byt += 8 * a["z"].numel() + 4 * (n + a["q"].numel())
        elif name == "F1 encode64":  # and a barrett64 a residue
            k = a["q"].numel()
            f32 += 2 * n
            byt += 8 * a["z"].numel() + 4 * n + 8 * k
            ops = k * n * BARRETT64_OPS
        elif name == "F1 decode64":  # and, over two limbs, Garner's
            # barrett64, Shoup product and q0 t_c a coefficient
            byt += 8 * a["x"].numel() + 4 * n
            if a["x"].shape[0] == 2:
                ops = n * (BARRETT64_OPS + SHOUP_OPS + MUL_LO)
        else:
            byt += 4 * (a["x"].numel() + n)
        return byt, ops, 0, f32
    byt, ops = _call_work(name, a, out)
    tc_ops = 0
    if name == "K5":  # 16 plane products, 2 k_out k_in N operations each
        k_out, k_in = a["mat"].shape
        tc_ops = 16 * 2 * k_out * k_in * a["y"].shape[1]
    return byt, ops, tc_ops, 0


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


def bound_ms(byt: int, ops: int, tc_ops: int = 0, f32_ops: int = 0):
    t_b = byt / HBM_BYTES_PER_S
    t_o = max(ops / INT_MULS_PER_S, tc_ops / INT8_TC_OPS_PER_S,
              f32_ops / F32_OPS_PER_S)
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------
# the u64 evaluator (CKKS and BGV over 50- and 61-bit primes): golden files
# ---------------------------------------------------------------------------

U64_GOLDEN = ("u64_ckks_b50.npz", "u64_ckks_b60.npz", "u64_bgv_b50.npz",
              "u64_bgv_b60.npz")
# the generator's U64_VERBS and U64_DECRYPTED (the files are its output)
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
U64_DECRYPTED = ("multiply_and_relin", "mod_switch", "rotate1",
                 "rotate_rows", "rescale", "balanced_add")


def digest(a) -> np.ndarray:
    """sha256 over an array's shape and u64 words, (32,) uint8, as the
    golden files' generator takes it (a tensor of int64 words or a numpy
    array)."""
    import hashlib
    if not isinstance(a, np.ndarray):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(a.astype(np.int64).view(np.uint64)
                             if a.dtype != np.uint64 else a)
    h = hashlib.sha256(repr(a.shape).encode() + a.tobytes())
    return np.frombuffer(h.digest(), dtype=np.uint8).copy()


def u64_kernel_inputs(d, k):
    """The u64 kernels' uniform inputs cut from a golden file's draws (a
    copy of the generator's)."""
    rlk_a, glk_a, pk_a = d["rlk_a"], d["glk_a"], d["pk_a"]
    return dict(
        ntt_x=rlk_a[:2], ntt_xi=rlk_a[:2] + glk_a[0, :2],
        bc_x=pk_a[:2], ip_t=rlk_a,
        ip_evk=np.ascontiguousarray(glk_a[:2].transpose(1, 0, 2, 3)),
        po_a=rlk_a[:2, :k], po_b=rlk_a[1:3, :k], po_c=glk_a[2, :2, :k],
        po_w=rlk_a[0, :k, 0])


def _u64_cmp(g, fname: str, name: str, x, meta_of=None) -> None:
    """x's digest (and, given a ciphertext or plaintext, its metadata)
    against the file's (RuntimeError)."""
    if meta_of is not None:
        c = meta_of
        meta = g[name + "__meta"].tolist()
        have = [c.chain_index, int(c.is_ntt_form)]
        if len(meta) > 2:
            have += [c.correction_factor, c.noise_scale_deg]
        if have != meta or c.scale != float(g[name + "__scale"]):
            raise RuntimeError(f"golden {fname}: {name} metadata {have}, "
                               f"scale {c.scale} != {meta}")
    want = g[name] if name in g else None
    if want is not None:
        got = x.detach().cpu().numpy().view(np.uint64) if not isinstance(
            x, np.ndarray) else x
        if not np.array_equal(got.astype(np.uint64), want):
            raise RuntimeError(f"golden {fname}: {name} differs")
    elif not np.array_equal(digest(x), g["h__" + name]):
        raise RuntimeError(f"golden {fname}: {name} differs (digest)")


def u64_golden(device, fname: str, ops=None) -> int:
    """One u64 golden file through the port's u64 evaluator on `device`
    (`ops`: keyswitch.KERNELS64 by default): keys from the stored JAX
    draws, both encryptions, every verb, the decryptions and decodings and
    the kernels' functions, each bit-equal to the JAX package's (digests,
    RuntimeError otherwise).  Returns the number of outputs held."""
    import torch
    from phantom_tpu_torch import BatchEncoder, CKKSEncoder, make_context
    from phantom_tpu_torch.ops import bconv as bc
    from phantom_tpu_torch.schemes import evaluate as ev
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes import keyswitch as ksw
    from phantom_tpu_torch.schemes.ciphertext import Plaintext
    from phantom_tpu_torch.schemes.ckks_encoder import encode_extended
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    ops = ksw.KERNELS64 if ops is None else ops
    g = np.load(os.path.join(FIXTURES, fname))
    scheme = "ckks" if "ckks" in fname else "bgv"
    n = int(g["s_tern"].shape[0])
    ctx = make_context(EncryptionParameters.create(
        n, g["data_moduli"].tolist(), g["special_moduli"].tolist(), scheme,
        int(g["t"])), device=device)

    held = [0]

    def cmp(name, x, meta_of=None):
        _u64_cmp(g, fname, name, x, meta_of)
        held[0] += 1

    sk, pk, rlk, glk, w, s = _u64_keys(g, ctx, ops, cmp)

    def pt(name):
        meta = g[name + "__meta"].tolist()
        return Plaintext(data=w(name), chain_index=meta[0],
                         is_ntt_form=bool(meta[1]),
                         scale=float(g[name + "__scale"]))

    pt1, pt2 = pt("pt1"), pt("pt2")
    if scheme == "ckks":
        enc = CKKSEncoder(ctx)
        mine = enc.encode(g["z1"], pt1.scale, ops=ops)
        cmp("pt1", mine.data, mine)
    else:
        enc = BatchEncoder(ctx)
        mine = enc.encode(g["z1"].astype(np.int64))
        cmp("pt1", mine.data.long())
    c1 = keys.encrypt_asymmetric_core64(ctx, pk, pt1, s("enc_u"),
                                        s("enc_e"), ops)
    cmp("c1", c1.data, c1)
    c2 = keys.encrypt_symmetric_core64(ctx, sk, pt2, w("sym_a"), s("sym_e"),
                                       ops)
    cmp("c2", c2.data, c2)
    mul = ev.multiply(ctx, c1, c2, ops)
    mr = ev.multiply_and_relin(ctx, c1, c2, rlk, ops)
    res = dict(negate=ev.negate(ctx, c1), add=ev.add(ctx, c1, c2, ops),
               sub=ev.sub(ctx, c1, c2, ops),
               add_plain=ev.add_plain(ctx, c1, pt2, ops),
               sub_plain=ev.sub_plain(ctx, c1, pt2, ops),
               multiply_plain=ev.multiply_plain(ctx, c1, pt2, ops),
               multiply=mul, square=ev.square(ctx, c1, ops),
               relinearize=ev.relinearize(ctx, mul, rlk, ops),
               multiply_and_relin=mr,
               mod_switch=ev.mod_switch_to_next(ctx, mr, ops),
               mod_switch_to=ev.mod_switch_to(ctx, c1, 3, ops),
               hoisting=ev.hoisting(ctx, c1, glk, [1, 2], ops),
               add_many=ev.add_many(ctx, [c1, c2, c1], ops))
    if scheme == "ckks":
        res["rescale"] = ev.rescale_to_next(ctx, mr, ops)
        res["rotate1"] = ev.rotate_vector(ctx, c1, 1, glk, ops)
        res["rotate2"] = ev.rotate_vector(ctx, c1, 2, glk, ops)
        res["conjugate"] = ev.complex_conjugate(ctx, c1, glk, ops)
        pts = w("combo_pts")
        res["combo"] = ev.hoisted_linear_combo(
            ctx, c1, glk, [0, 1, 2], list(pts), 2.0 ** 20, ops=ops)
        cd = ctx.get_context_data(1)
        c2_coeff = ops.ntt_inverse(c1.data[1], ctx.ntt64,
                                   ctx.rows_qp[:cd.size_ql])
        res["keyswitch_coeff"] = c1.replace(data=ksw.keyswitch(
            ctx, cd, c2_coeff, rlk, ops))
        rng = np.random.default_rng(int(g["data_moduli"][0]) % 1000)
        wts = rng.standard_normal((1, enc.slots))
        mine = encode_extended(enc, wts[0], 2.0 ** 20, 1, ops)
        want = encode_extended(enc, wts[0], 2.0 ** 20, 1,
                               ksw.PLAIN64)
        if not torch.equal(mine, want):
            raise RuntimeError(f"golden {fname}: encode_extended differs")
    else:
        ms1 = ev.mod_switch_to_next(ctx, c1, ops)
        prod = ev.multiply_and_relin(
            ctx, ms1, ev.mod_switch_to_next(ctx, c2, ops), rlk, ops)
        res["balanced_add"] = ev.add(ctx, prod, ms1, ops)
        res["rotate_rows"] = ev.rotate_rows(ctx, c1, 1, glk, ops)
        res["rotate_columns"] = ev.rotate_columns(ctx, c1, glk, ops)
        res["add_plain_ms"] = ev.add_plain(ctx, ms1, pt2, ops)
    if set(res) != set(U64_VERBS[scheme]):
        raise RuntimeError(f"golden {fname}: verbs {sorted(res)}")
    for name, c in res.items():
        cmp(name, c.data, c)
        if name in U64_DECRYPTED:
            dec = keys.decrypt64(ctx, sk, c, ops)
            cmp("dec_" + name, dec.data, dec)
            if scheme == "ckks":
                got = enc.decode(dec, ops=ops)
                if not np.array_equal(got, g["decoded_" + name]):
                    raise RuntimeError(f"golden {fname}: decoded_{name} "
                                       "differs")
                held[0] += 1
    held[0] += _u64_kernel_golden(g, fname, ctx, ops, device)
    return held[0]


def _u64_kernel_golden(g, fname, ctx, ops, device) -> int:
    """The kernels' functions of a u64 golden file (ntt_*, bc_*, fs_*,
    ip_out, po_*) on its inputs."""
    import torch
    from phantom_tpu_torch.ops import bconv as bc
    from phantom_tpu_torch.ops import polyops
    from phantom_tpu_torch.schemes import keyswitch as ksw
    cd = ctx.get_context_data(1)
    lv = cd.u64
    ks = lv.ks
    k = cd.size_ql
    inp = {n: torch.from_numpy(np.ascontiguousarray(v).astype(
        np.uint64).view(np.int64)).to(device)
        for n, v in u64_kernel_inputs(g, k).items()}
    t = ctx.ntt64
    x = torch.from_numpy(g["fs_x"].view(np.int64)).to(device)
    y = bc.scale_by_qhat_inv(x, ks.p_to_q)
    res = dict(
        ntt_fwd=ops.ntt_forward(inp["ntt_x"], t),
        ntt_inv=ops.ntt_inverse(inp["ntt_xi"], t),
        ntt_inv_scaled=ops.ntt_inverse(
            inp["ntt_xi"][:, :k].contiguous(), t, ctx.rows_qp[:k],
            ks.modup_scale, ks.modup_scale_shoup),
        bc_approx=ops.bconv(inp["bc_x"], ks.digit_convs[0], "approx"),
        bc_exact=ops.bconv(inp["bc_x"], ks.digit_convs[0], "exact"),
        ip_out=ksw.inner_product_evk(inp["ip_t"], inp["ip_evk"], cd, ops),
        fs_y=y, fs_v=bc.floor_sum_div(y, ks.p_to_q),
        fs_exact=ops.bconv(x, ks.p_to_q, "exact"),
        po_mul=ops.mul_rns(inp["po_a"], inp["po_b"], lv.mv),
        po_fma=ops.fma_rns(inp["po_a"], inp["po_b"], inp["po_c"], lv.mv),
        po_tensor=ops.tensor_prod_2x2(inp["po_a"], inp["po_b"], lv.mv),
        po_square=ops.tensor_square_2x2(inp["po_a"], lv.mv))
    res["po_shoup"] = ops.shoup_rns(inp["po_a"], polyops.limbs(
        ctx.params.data_moduli[:k], w=g["rlk_a"][0, :k, 0], device=device))
    if ks.p_to_t is not None:
        res["fs_exact_t"] = ops.bconv(x, ks.p_to_t, "exact")
    if not np.array_equal(res["fs_v"].cpu().numpy().view(np.uint64),
                          g["fs_v"]):
        raise RuntimeError(f"golden {fname}: fs_v differs")
    for name, v in res.items():
        if not np.array_equal(digest(v), g["h__" + name]):
            raise RuntimeError(f"golden {fname}: {name} differs (digest)")
    return len(res)


# BFV on the u64 evaluator: the files' techniques (file name -> mul_tech),
# verbs and leveled's chained products (the generator's)
U64_BFV_TECHS = {"hps": "hps", "behz": "behz", "overq": "hps_overq",
                 "leveled": "hps_overq_leveled"}
U64_BFV_GOLDEN = tuple(f"u64_bfv_{tech}_b50.npz" for tech in U64_BFV_TECHS)
U64_BFV_VERBS = ("negate", "add", "sub", "add_plain", "sub_plain",
                 "multiply_plain", "multiply", "square", "relinearize",
                 "multiply_and_relin", "mod_switch", "rotate_rows",
                 "rotate_columns", "hoisting")
U64_BFV_DEEP = ("deep2", "deep3", "deep4")


def _u64_keys(g, ctx, ops, cmp, galois: bool = True):
    """sk, pk, rlk and (`galois`, else None) the Galois keys of a u64
    golden file, from its draws, each held against the file."""
    import torch
    from phantom_tpu_torch.schemes import keys
    dev = ctx.key_q.device

    def w(name):
        return torch.from_numpy(g[name].astype(np.uint64).view(
            np.int64)).to(dev)

    def s(name):
        return torch.from_numpy(g[name].astype(np.int64)).to(dev)

    sk = keys.gen_secret_core64(ctx, s("s_tern"), ops)
    cmp("sk", sk)
    pk = torch.stack(keys.encrypt_zero_sym_core64(ctx, sk, w("pk_a"),
                                                  s("pk_e"), ops))
    cmp("pk", pk)
    rlk = keys.gen_relin_core64(ctx, sk, w("rlk_a"), s("rlk_e"), ops)
    cmp("rlk", rlk)
    glk = None
    if galois:
        elts = tuple(g["elts"].tolist())
        glk = keys.GaloisKeys(torch.stack([
            keys.gen_galois_core64(ctx, sk, e, w("glk_a")[i], s("glk_e")[i],
                                   ops)
            for i, e in enumerate(elts)]), elts)
        cmp("glk", glk.data)
    return sk, pk, rlk, glk, w, s


def u64_bfv_golden(device, fname: str, ops=None, shared: bool = True) -> int:
    """One BFV u64 golden file (u64_bfv_<tech>_b50.npz) through the port
    on `device` (`ops`: keyswitch.KERNELS64 by default): keys from the
    JAX draws, both encryptions, every verb (leveled also its chained
    products, the last with a level dropped, and that one's decryption
    over its level), each decryption, the noise budgets and the modules'
    functions (scale-and-round D -> Rl, D -> Ql, Ql -> Rl, the decryption's
    and the plain lift's rounding; BEHZ's sm_mrq, fast_floor and
    fastbconv_sk; leveled's Q -> Ql and Q -> Rl), bit-equal to the JAX
    package's (RuntimeError otherwise).  Without `shared`, only what
    depends on the technique: the keys but the Galois keys, the
    encryptions, the products, their decryptions and budgets and the
    technique's own functions.  Returns the outputs held."""
    import torch
    from phantom_tpu_torch import BatchEncoder, make_context
    from phantom_tpu_torch.host.noise import find_levels_to_drop
    from phantom_tpu_torch.ops import behz as bz
    from phantom_tpu_torch.ops import scaleround as sr
    from phantom_tpu_torch.schemes import evaluate as ev
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes import keyswitch as ksw
    from phantom_tpu_torch.schemes.ciphertext import Plaintext
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    ops = ksw.KERNELS64 if ops is None else ops
    g = np.load(os.path.join(FIXTURES, fname))
    tech = fname.split("_")[2]
    n = int(g["s_tern"].shape[0])
    ctx = make_context(EncryptionParameters.create(
        n, g["data_moduli"].tolist(), g["special_moduli"].tolist(), "bfv",
        int(g["t"]), mul_tech=U64_BFV_TECHS[tech]), device=device)
    held = [0]

    def cmp(name, x, meta_of=None):
        _u64_cmp(g, fname, name, x, meta_of)
        held[0] += 1

    sk, pk, rlk, glk, w, s = _u64_keys(g, ctx, ops, cmp, shared)
    pt1, pt2 = (Plaintext(data=w(name)) for name in ("pt1", "pt2"))
    enc = BatchEncoder(ctx)
    cmp("pt1", enc.encode(g["z1"].astype(np.int64)).data.long())
    c1 = keys.encrypt_asymmetric_core64(ctx, pk, pt1, s("enc_u"),
                                        s("enc_e"), ops)
    cmp("c1", c1.data, c1)
    c2 = keys.encrypt_symmetric_core64(ctx, sk, pt2, w("sym_a"), s("sym_e"),
                                       ops)
    cmp("c2", c2.data, c2)
    mul = ev.multiply(ctx, c1, c2, ops)
    mr = ev.multiply_and_relin(ctx, c1, c2, rlk, ops)
    res = dict(multiply=mul, square=ev.square(ctx, c1, ops),
               relinearize=ev.relinearize(ctx, mul, rlk, ops),
               multiply_and_relin=mr,
               mod_switch=ev.mod_switch_to_next(ctx, mr, ops))
    if shared:
        res.update(negate=ev.negate(ctx, c1), add=ev.add(ctx, c1, c2, ops),
                   sub=ev.sub(ctx, c1, c2, ops),
                   add_plain=ev.add_plain(ctx, c1, pt2, ops),
                   sub_plain=ev.sub_plain(ctx, c1, pt2, ops),
                   multiply_plain=ev.multiply_plain(ctx, c1, pt2, ops),
                   rotate_rows=ev.rotate_rows(ctx, c1, 1, glk, ops),
                   rotate_columns=ev.rotate_columns(ctx, c1, glk, ops),
                   hoisting=ev.hoisting(ctx, c1, glk, [1, 2], ops))
    if tech == "leveled":
        p = ctx.params
        d = mr
        for name in U64_BFV_DEEP:
            lvl = find_levels_to_drop(
                n, p.size_q, p.size_p,
                len(ctx.get_context_data(1).ks.digit_convs),
                p.plain_modulus, 50, d.noise_scale_deg - 1, False, True)
            if lvl != int(g[name + "__lvl"]):
                raise RuntimeError(f"golden {fname}: {name} drops {lvl}")
            d = res[name] = ev.multiply_and_relin(ctx, d, d, rlk, ops)
        low = d.replace(data=d.data[:, :p.size_q - lvl].contiguous(),
                        chain_index=1 + lvl)
        dec = keys.decrypt64(ctx, sk, low, ops)
        cmp("dec_deep4_ql", dec.data, dec)
    if shared and set(res) != set(U64_BFV_VERBS) | set(
            U64_BFV_DEEP if tech == "leveled" else ()):
        raise RuntimeError(f"golden {fname}: verbs {sorted(res)}")
    for name, c in res.items():
        cmp(name, c.data, c)
        dec = keys.decrypt64(ctx, sk, c, ops)
        cmp("dec_" + name, dec.data, dec)
    budgets = [("mr", mr), ("mod_switch", res["mod_switch"])]
    if shared:
        budgets += [("c1", c1), ("c2", c2)]
    for name, c in budgets:
        if keys.invariant_noise_budget64(ctx, sk, c, ops) != int(
                g["budget_" + name]):
            raise RuntimeError(f"golden {fname}: budget of {name} differs")
        held[0] += 1
    lv = ctx.get_context_data(1).u64
    hps = lv.hps
    x_d, x_q = w("x_d"), w("x_q")
    fns = {}
    if shared:
        fns.update(
            sr_d_to_rl=sr.scale_and_round_exact(x_d, hps.sr_to_r, ops.bconv),
            sr_d_to_ql=sr.scale_and_round_exact(x_d, hps.sr_final_overq,
                                                ops.bconv),
            sr_ql_to_rl=sr.scale_and_round_exact(x_q, hps.sr_ql_to_rl,
                                                 ops.bconv),
            decrypt_sr=sr.decrypt_scale_and_round(x_q, lv.decrypt_sr),
            plain_up=sr.scale_plain_up(w("m_t"), lv.plain_lift,
                                       ops.shoup_rns))
        cmp("decrypt_sr", fns["decrypt_sr"])
    if tech == "behz":
        if list(ctx.bsk_moduli) != g["bsk_moduli"].tolist():
            raise RuntimeError(f"golden {fname}: Bsk differs")
        c = lv.behz
        x_bsk = w("x_bsk")
        fns.update(sm_mrq=bz.sm_mrq(x_q, c, ops),
                   fast_floor=bz.fast_floor(x_q, x_bsk, c, ops),
                   fastbconv_sk=bz.fastbconv_sk(x_bsk, c, ops))
    if tech == "leveled":
        lc = ctx.get_context_data(2).u64.leveled
        fns.update(lev_q_to_ql=sr.scale_and_round_exact(x_q, lc.q_to_ql,
                                                        ops.bconv),
                   lev_q_to_rl=sr.scale_and_round_exact(x_q, lc.q_to_rl,
                                                        ops.bconv))
    for name, v in fns.items():
        if not np.array_equal(digest(v), g["h__" + name]):
            raise RuntimeError(f"golden {fname}: {name} differs (digest)")
        held[0] += 1
    return held[0]


U64_MXN = "u64_mxn_n1024.npz"
MXN_CASES = ((3, 2), (3, 3), (2, 3), (1, 2))  # the generator's


def u64_mxn_golden(device, op=None) -> int:
    """u64_mxn_n1024.npz: tensor_prod_mxn (U4's mxn form, or `op`) of each
    (m, n) case on both chains, bit-equal to the JAX package's (digests,
    RuntimeError otherwise).  Returns the number of products held."""
    import torch
    from phantom_tpu_torch.ops import polyops
    from phantom_tpu_torch.ops.rns_host import modulus_vec
    op = polyops.tensor_prod_mxn if op is None else op
    g = np.load(os.path.join(FIXTURES, U64_MXN))
    held = 0
    for bits in (50, 61):
        mv = modulus_vec(g[f"moduli_b{bits}"].tolist(), device)
        ct1, ct2 = (torch.from_numpy(g[f"{c}_b{bits}"].view(np.int64)).to(
            device) for c in ("ct1", "ct2"))
        for m, n in MXN_CASES:
            name = f"mxn{m}{n}_b{bits}"
            got = op(ct1[:m], ct2[:n], mv)
            if got.shape != (m + n - 1,) + ct1.shape[1:] or not \
                    np.array_equal(digest(got), g["h__" + name]):
                raise RuntimeError(f"golden {U64_MXN}: {name} differs")
            held += 1
    return held


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

U64_APP_GOLDEN = ("u64_linear_b50.npz", "u64_poly_b50.npz")
WIDE_FFT_GOLDEN = "ckks_fft_wide.npz"
WIDE_FFT_CASES = {"w40": (1,), "w50": (1, 5)}  # chain: chain indices


def _u64_app_case(g, device, ops, cmp):
    """A u64 application golden file's context on `device`, its keys from
    the stored JAX draws (each held), the encryption of `pt` from its
    draws: (ctx, sk, rlk, glk, encrypt(pt))."""
    from phantom_tpu_torch import make_context
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    ctx = make_context(EncryptionParameters.create(
        int(g["s_tern"].shape[0]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist()), device=device)
    sk, pk, rlk, glk, _, s = _u64_keys(g, ctx, ops, cmp, "glk_a" in g)

    def encrypt(pt):
        return keys.encrypt_asymmetric_core64(ctx, pk, pt, s("enc_u"),
                                              s("enc_e"), ops)
    return ctx, sk, rlk, glk, encrypt


def u64_linear_golden(device, ops=None) -> int:
    """u64_linear_b50.npz through LinearTransform on the u64 evaluator on
    `device` (`ops`: keyswitch.KERNELS64 by default): the keys, the
    encoded input, prepare's QlP weights, the encryption and apply's
    output (with its metadata) bit-equal to the JAX package's (digests,
    RuntimeError otherwise), and its decode.  Returns the outputs held."""
    from phantom_tpu_torch import CKKSEncoder, LinearTransform
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes import keyswitch as ksw
    ops = ksw.KERNELS64 if ops is None else ops
    fname = U64_APP_GOLDEN[0]
    held = [0]

    def cmp(name, x, meta_of=None):
        _u64_cmp(g, fname, name, x, meta_of)
        held[0] += 1

    g = np.load(os.path.join(FIXTURES, fname))
    ctx, sk, _, glk, encrypt = _u64_app_case(g, device, ops, cmp)
    enc = CKKSEncoder(ctx)
    lt = LinearTransform(g["M"])
    lt.prepare(enc, float(g["w_scale"]), 1, ops)
    for i, w in enumerate(p for grp in lt._prepared[1] for p in grp):
        cmp(f"w_{i}", w)
    pt = enc.encode(np.tile(g["x"], enc.slots // lt.d), float(g["scale"]),
                    ops=ops)
    cmp("pt_in", pt.data, pt)
    ct = encrypt(pt)
    cmp("ct", ct.data, ct)
    y = lt.apply(ctx, ct, glk, ops=ops)
    cmp("y", y.data, y)
    if not np.array_equal(enc.decode(keys.decrypt64(ctx, sk, y, ops), ops),
                          g["decoded_y"]):
        raise RuntimeError(f"golden {fname}: decoded_y differs")
    return held[0] + 1


def u64_poly_golden(device, ops=None) -> int:
    """u64_poly_b50.npz through poly_eval and poly_eval_cheb on the u64
    evaluator on `device` with the host encoder: the keys, the encryption
    and both results (with their metadata) bit-equal to the JAX
    package's.  Returns the outputs held."""
    from phantom_tpu_torch import CKKSEncoder, poly_eval, poly_eval_cheb
    from phantom_tpu_torch.schemes import keyswitch as ksw
    ops = ksw.KERNELS64 if ops is None else ops
    fname = U64_APP_GOLDEN[1]
    held = [0]

    def cmp(name, x, meta_of=None):
        _u64_cmp(g, fname, name, x, meta_of)
        held[0] += 1

    g = np.load(os.path.join(FIXTURES, fname))
    ctx, _, rlk, _, encrypt = _u64_app_case(g, device, ops, cmp)
    enc = CKKSEncoder(ctx)
    ct = encrypt(enc.encode(g["x"], float(g["scale"]), ops=ops))
    cmp("ct", ct.data, ct)
    y = poly_eval(ctx, ct, g["coeffs_mono"], rlk, enc, ops=ops)
    cmp("y_mono", y.data, y)
    y = poly_eval_cheb(ctx, ct, g["coeffs_cheb"], rlk, enc,
                       interval=tuple(g["interval"].tolist()), ops=ops)
    cmp("y_cheb", y.data, y)
    return held[0]


def wide_encoder_golden(device, ops=None) -> dict:
    """ckks_fft_wide.npz through CKKSDeviceEncoder on wide contexts on
    `device` (`ops`: keyswitch.KERNELS64 by default): {"<chain> <ci>
    <what>": (port, JAX)} for the rounded coefficients (ints, the bare
    transform's), the encoded plaintext (enc), the decode of the JAX
    package's plaintext (dec) and the host encoder's decode of it
    (host)."""
    import torch
    from phantom_tpu_torch import (CKKSDeviceEncoder, CKKSEncoder,
                                   Plaintext, make_context)
    from phantom_tpu_torch.schemes import keyswitch as ksw
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    ops = ksw.KERNELS64 if ops is None else ops
    g = np.load(os.path.join(FIXTURES, WIDE_FFT_GOLDEN))
    out = {}
    for c, chain in WIDE_FFT_CASES.items():
        z, scale = g[f"z_{c}"], float(g[f"scale_{c}"])
        ctx = make_context(EncryptionParameters.create(
            2 * z.shape[0], g[f"moduli_{c}"].tolist(),
            g[f"special_{c}"].tolist()), device=device)
        enc, host = CKKSDeviceEncoder(ctx), CKKSEncoder(ctx)
        for ci in chain:
            key = f"{c} {ci}"
            want = g[f"enc_{c}_{ci}"]
            jax_pt = Plaintext(data=torch.from_numpy(want.view(np.int64)).to(
                ctx.key_q.device), chain_index=ci, is_ntt_form=True,
                scale=scale)
            out[f"{key} ints"] = (enc.encode_ints(z, scale).cpu().numpy(),
                                  g[f"ints_{c}_{ci}"])
            pt = enc.encode(z, scale, ci, ops)
            out[f"{key} enc"] = (pt.data.cpu().numpy().view(np.uint64), want)
            out[f"{key} dec"] = (enc.decode(jax_pt, ops), g[f"dec_{c}_{ci}"])
            out[f"{key} host"] = (host.decode(jax_pt, ops),
                                  g[f"host_{c}_{ci}"])
    return out


REF_GOLDEN = os.path.join(FIXTURES, "refformat_n1024.npz")
SALSA_BITS = (28, 50, 61)  # the golden file's and phase 51's prime sizes
SALSA_FORMS = ("uniform", "ternary", "error")


def rejecting_primes(n: int, count: int) -> list:
    """`count` 61-bit primes == 1 mod 2n just above 2^64 / 9, where the
    Salsa20 uniform sampler rejects about one lane in nine (chains of
    retries); the golden files' generator calls this one."""
    from phantom_tpu_torch.host import numth
    q = (1 << 64) // 9 + 1
    q += (1 - q) % (2 * n)
    out = []
    while len(out) < count:
        if numth.is_prime(q):
            out.append(q)
        q += 2 * n
    return out


def salsa_golden(device, path: str = REF_GOLDEN) -> int:
    """The golden file's Salsa20 samples (the JAX package's numpy
    samplers at n = 1024 over three primes of 28, 50 and 61 bits, the
    last rejecting about one lane in nine) through utils/salsa20.sample on
    `device` (S1 on the card), bit-equal; returns the count held."""
    from phantom_tpu_torch.ops.rns_host import modulus_vec, u64_values
    from phantom_tpu_torch.utils import salsa20
    g = np.load(path)
    seed = g["seed"].tobytes()
    held = 0
    for b in SALSA_BITS:
        mv = modulus_vec(g[f"salsa_moduli_{b}"].tolist(), device)
        for form in SALSA_FORMS:
            want = g[f"{form}_{b}"]
            got = salsa20.sample(form, seed, mv, want.shape[-1])
            if not np.array_equal(u64_values(got), want):
                raise RuntimeError(f"salsa20 golden: the {form} form at "
                                   f"{b}-bit primes differs from the JAX "
                                   "package's")
            held += 1
    return held


def _resaved(save, obj, *extra) -> bytes:
    import io
    buf = io.BytesIO()
    save(obj, *extra, buf)
    return buf.getvalue()


def _sha256(blob: bytes) -> np.ndarray:
    import hashlib
    return np.frombuffer(hashlib.sha256(blob).digest(), dtype=np.uint8)


def wire_golden(device, path: str = REF_GOLDEN) -> int:
    """The golden file's JAX blobs in the port on `device`: every
    refformat blob (BFV keys, a ciphertext, a plaintext, a product, a
    seeded symmetric ciphertext whose c1 S1 and U1's inverse regenerate)
    loaded and saved again byte for byte; the port's serialize bytes of
    each object hashed equal to the JAX package's; the JAX package's PTCS
    blob refused; the decryptions right and the port's multiply_and_relin
    of the loaded ciphertexts with the loaded relin key bit-equal to the
    JAX product; a seeded CKKS ciphertext (NTT form) regenerated bit-equal
    and decoded within 1e-6.  Returns the count of objects held."""
    import io
    from phantom_tpu_torch import (BatchEncoder, CKKSEncoder,
                                   make_context)
    from phantom_tpu_torch.schemes import evaluate, keys
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    from phantom_tpu_torch.utils import refformat as ref
    from phantom_tpu_torch.utils import serialize as ser
    g = np.load(path)
    n = g["vals1"].shape[0]
    qs, t = g["bfv_moduli"].tolist(), int(g["t"])
    ctx = make_context(EncryptionParameters.create(
        n, qs[:2], qs[2:], "bfv", t), device=device)
    dev = ctx.key_q.device
    elts = tuple(g["glk_elts"].tolist())
    kinds = {
        "sk": (ref.load_secret_key_ref, ref.save_secret_key_ref),
        "pk": (ref.load_public_key_ref, ref.save_public_key_ref),
        "rlk": (ref.load_relin_key_ref, ref.save_relin_key_ref),
        "glk": (lambda f, d: ref.load_galois_key_ref(f, elts, d),
                ref.save_galois_key_ref),
        "ct": (ref.load_ciphertext_ref, ref.save_ciphertext_ref),
        "pt": (ref.load_plaintext_ref, ref.save_plaintext_ref),
        "prod": (ref.load_ciphertext_ref, ref.save_ciphertext_ref),
    }
    obj = {}
    for name, (load, save) in kinds.items():
        blob = g["ref_" + name].tobytes()
        obj[name] = load(io.BytesIO(blob), dev)
        if _resaved(save, obj[name]) != blob:
            raise RuntimeError(f"refformat golden: {name} not saved again "
                               "byte for byte")
        if not np.array_equal(_sha256(ser.to_bytes(obj[name])),
                              g["ser_" + name]):
            raise RuntimeError(f"serialize golden: the port's bytes of "
                               f"{name} differ from the JAX package's")
    seed = g["sym_seed"].tobytes()
    blob = g["ref_sym"].tobytes()
    sym = ref.load_ciphertext_symmetric_ref(ctx, io.BytesIO(blob))
    if not np.array_equal(digest(sym.data), g["h__sym_data"]):
        raise RuntimeError("refformat golden: the seeded ciphertext's c1 "
                           "differs from the JAX package's")
    if _resaved(ref.save_ciphertext_symmetric_ref, sym, seed) != blob:
        raise RuntimeError("refformat golden: the seeded ciphertext not "
                           "saved again byte for byte")
    try:
        ser.from_bytes(g["ser_cts"].tobytes(), ctx)
    except ValueError as e:
        if "JAX" not in str(e):
            raise
    else:
        raise RuntimeError("serialize: a JAX PTCS blob was not refused")
    enc = BatchEncoder(ctx)
    v1, v2 = g["vals1"], g["vals2"]
    want = {"ct": v1, "sym": v2,
            "prod": (v1.astype(object) * v2.astype(object) % t).astype(
                np.uint64)}
    for name, ct in (("ct", obj["ct"]), ("sym", sym),
                     ("prod", obj["prod"])):
        if not np.array_equal(enc.decode(keys.decrypt64(ctx, obj["sk"], ct)),
                              want[name]):
            raise RuntimeError(f"refformat golden: {name} decrypts wrong")
    mine = evaluate.multiply_and_relin(ctx, obj["ct"], sym, obj["rlk"])
    if not _same(mine, obj["prod"]):
        raise RuntimeError("refformat golden: the port's multiply_and_relin"
                           " of the loaded ciphertexts differs from the JAX "
                           "product")
    cq = g["ckks_moduli"].tolist()
    cctx = make_context(EncryptionParameters.create(n, cq[:-1], cq[-1:]),
                        device=device)
    csk = ref.load_secret_key_ref(io.BytesIO(g["ckks_ref_sk"].tobytes()),
                                  dev)
    blob = g["ckks_ref_sym"].tobytes()
    csym = ref.load_ciphertext_symmetric_ref(cctx, io.BytesIO(blob))
    if not np.array_equal(digest(csym.data), g["h__ckks_sym_data"]):
        raise RuntimeError("refformat golden: the seeded CKKS ciphertext "
                           "differs from the JAX package's")
    if _resaved(ref.save_ciphertext_symmetric_ref, csym,
                g["ckks_seed"].tobytes()) != blob:
        raise RuntimeError("refformat golden: the seeded CKKS ciphertext "
                           "not saved again byte for byte")
    z = CKKSEncoder(cctx).decode(keys.decrypt64(cctx, csk, csym))
    err = float(np.abs(z - g["ckks_z"]).max())
    if err > 1e-6:
        raise RuntimeError(f"refformat golden: the seeded CKKS ciphertext "
                           f"decodes within {err:.3e}, not 1e-6")
    return len(kinds) + 2


def _cmd(args):
    try:
        r = subprocess.run(args, capture_output=True, text=True, timeout=60)
        return (r.stdout or r.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


# the kernels of the two-pass K2, K7 and K8, of the radix-2 K6 and of the
# two-pass U1 and two-launch U2, which the library must not hold, and the
# one-pass core's kernels (U1's among them) and U2's one kernel, which it
# must
STALE_KERNELS = ("fwd_col_kernel", "fwd_chunk_kernel", "rows_col_kernel",
                 "last_col_kernel", "last_chunk_kernel",
                 "last_inv_col_kernel", "rest_col_kernel",
                 "rest_chunk_kernel", "ntt_roll_kernel", "ntt_pass_kernel",
                 "bconv_prep_kernel", "bconv_sum_kernel", "polyops_kernel")
K7_KERNELS = ("rescale_last_kernel", "rescale_rest_kernel")
# U1's, U2's and U4's kernels (U4: one instantiation a form and words a
# thread, its products and its row forms)
U64_NEW_KERNELS = ("ntt64_cluster_kernel", "bconv64_kernel",
                   "polyops64_kernel", "polyrows64_kernel")
# the sources whose kernels' registers and spills phase 2 prints (nvcc
# -Xptxas -v)
PTXAS_REPORTS = (("moddown_rescale.cu", K7_KERNELS),
                 ("u64_ntt.cu", U64_NEW_KERNELS[:1]),
                 ("u64_bconv.cu", U64_NEW_KERNELS[1:2]),
                 ("u64_polyops.cu", U64_NEW_KERNELS[2:]),
                 ("ntt_phase.cu", ("ntt_phase_kernel",)))
CORE_KERNELS = ("fwd_cluster_kernel", "inv_cluster_kernel",
                "bconv_ntt_kernel", "modup_ip_kernel", "moddown_rows_kernel",
                *K7_KERNELS, *U64_NEW_KERNELS)


def _cuobjdump(lib: str, *args) -> str:
    from phantom_tpu_torch import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, *args, lib], capture_output=True, text=True,
                          timeout=120, check=True).stdout


def _kernel_key(line: str, kernels):
    """The kernel of `kernels` that a line of cuobjdump or ptxas names, as
    kernel<N, ...> for a build templated on ints or bools, led by its word
    (u32 or u64) where the template takes one first (U4's as "U4 <form>,
    <W> words"); None if none."""
    import re
    name = next((k for k in kernels if k in line), None)
    t = name and re.search(name + r"I([jm]?)((?:L[ib]\d+E)+)E", line)
    if not t:
        return name
    args = [int(v) for v in re.findall(r"L[ib](\d+)E", t.group(2))]
    if name in U64_NEW_KERNELS[2:]:
        from phantom_tpu_torch.ops import polyops
        return f"{name}<U4 {polyops.FORMS[args[0]]}, {2 * args[1]} words>"
    word = {"j": ["u32"], "m": ["u64"]}.get(t.group(1), [])
    return f"{name}<{', '.join(word + [str(v) for v in args])}>"


def resource_usage(lib: str, kernels) -> dict:
    """{kernel, or kernel<N> for a build templated on an int or a bool:
    its "REG:.. STACK:.. SHARED:.. LOCAL:.." line} from cuobjdump
    --dump-resource-usage; raises for a kernel it does not list."""
    out, name = {}, None
    for line in _cuobjdump(lib, "--dump-resource-usage").splitlines():
        if "Function" in line:
            name = _kernel_key(line, kernels)
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
            name = _kernel_key(line, kernels)
        elif name is not None and "spill stores" in line:
            spills = line.strip()
        elif name is not None and "registers" in line:
            used = line.split(":", 1)[1].split(",")[0].strip()
            out[name] = f"{used}; {spills}"
            name = None
    missing = [k for k in kernels
               if not any(n.split("<")[0] == k for n in out)]
    if missing:
        raise RuntimeError(f"ptxas reports nothing of {missing}")
    return out


def sass_by_function(lib: str, needle: str, opcodes) -> dict:
    """{function: {instruction: count}} of the `opcodes` in every function
    of the library's SASS whose name holds `needle` (one cuobjdump)."""
    out, name = {}, None
    for line in _cuobjdump(lib, "-sass").splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if needle in name else None
            if name:
                out[name] = {}
        elif name and "*/" in line:
            ins = [w for w in line.split("*/")[1].split()
                   if not w.startswith("@")]  # the predicate, if any
            if ins and ins[0].split(".")[0] in opcodes:
                out[name][ins[0]] = out[name].get(ins[0], 0) + 1
    return out


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


def _max_err(a, b):
    """The largest difference of two residue tensors; for float tensors 0
    when they are equal word for word, else their largest difference (at
    least the least f32 subnormal, so that it reads as a mismatch)."""
    import torch
    if isinstance(a, tuple):
        return max(_max_err(x, y) for x, y in zip(a, b))
    if a.is_floating_point():
        if torch.equal(a.view(torch.int32), b.view(torch.int32)):
            return 0
        return max(float((a.double() - b.double()).abs().nan_to_num(
            float("inf")).max()), 2.0 ** -149)
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
        byt, ops, tc_ops, f32_ops = self.bound(ba.arguments, out)
        b_ms, b_by = bound_ms(byt, ops, tc_ops, f32_ops)
        self.calls.append(dict(
            shape=shape, err=err, bound_ms=b_ms, bound_by=b_by, bytes=byt,
            ops=ops, tc_ops=tc_ops, f32_ops=f32_ops,
            dev_ms=_device_ms(lambda: self.kernel(*args, **kw), self.reps),
            ms=_time(lambda: self.kernel(*args, **kw), self.reps),
            plain_ms=_time(lambda: self.plain(*args, **kw), self.reps)))
        return out

    def bound(self, arguments, out):
        """(bytes, 32-bit multiplies, int8 tensor-core and f32 operations)
        the call needs."""
        return call_bound(self.name, arguments, out)


def kernel_wrappers():
    """The wrappers of KERNELS, in its order."""
    from phantom_tpu_torch.ops import bconv_kernels, ckks_fft, ip_kernels
    from phantom_tpu_torch.ops import moddown_kernels, modup_ip_kernels
    from phantom_tpu_torch.ops import ntt_kernels, ntt_roll_kernels
    mods = (ntt_kernels, bconv_kernels, modup_ip_kernels, ip_kernels,
            moddown_kernels, ntt_roll_kernels, ckks_fft)
    return [next(getattr(m, attr) for m in mods if hasattr(m, attr))
            for _, attr, *_ in KERNELS]


def calls_only(card: str, dev, only_u64: bool = False) -> None:
    """--calls: every kernel call of one headline step on each modup route
    and through the K8 and K7 epilogues, one alpha-8 xla-split step and
    one through each of those epilogues, one BFV step on each engine and
    one BGV step on each route, under the probes (phases 4, 8, 11, 18 and
    23 without the rest; none of them with `only_u64`, --calls u64);
    then the u64 CKKS, BGV and BFV steps (phases 42-47 without the
    golden files and the plain step's timing: every U call probed,
    chained timing, profile, U1's, U2's and U4's kernel launches per
    call, the launch counts).  It passes the 32-bit wrappers only their common
    arguments, so a copy of this file measures an earlier tree of the
    port's 32-bit paths the same way."""
    import torch
    from phantom_tpu_torch import make_context
    from phantom_tpu_torch.ops import bfv32, bgv32
    from phantom_tpu_torch.ops import pipeline32 as pp
    if only_u64:
        launches64 = {name: 0 for name, *_ in U64_KERNELS}
        probes64, _ = _u64_phases(card, launches64, dev, None, calls=True)
        _u64_bfv_phases(card, probes64, launches64, dev, calls=True)
        return
    probes = _probes(pp, kernel_wrappers())
    since = {name: 0 for name in PROBE_NAMES}
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
    del c, rlk, a, b
    torch.cuda.empty_cache()
    # the u64 CKKS, BGV and BFV steps: every U call probed, chained,
    # profiled
    launches64 = {name: 0 for name, *_ in U64_KERNELS}
    probes64, _ = _u64_phases(card, launches64, dev, None, calls=True)
    _u64_bfv_phases(card, probes64, launches64, dev, calls=True)


def _probes(pp, wrappers):
    """A Kernels of probes: KERNELS' wrappers, then the fields past them
    (F1's forms and P1, where the tree has them)."""
    extra = pp.Kernels._fields[len(KERNELS):]
    return pp.Kernels(*(
        [_Probe(name, k, p, REPS) for (name, *_), k, p
         in zip(KERNELS, wrappers, pp.PLAIN)]
        + [_P1Probe(REPS) if f == "ntt_phase" else
           _Probe(F1_FORMS[f], getattr(pp.KERNELS, f), getattr(pp.PLAIN, f),
                  REPS) for f in extra]))


def _print_calls(probes, card, since):
    for name, probe in zip(PROBE_NAMES, probes):
        for c in probe.calls[since[name]:]:
            tc = (f", {c['tc_ops'] / 1e9:.3f} G int8" if c["tc_ops"]
                  else f", {c['f32_ops'] / 1e9:.4f} G f32" if c["f32_ops"]
                  else "")
            print(f"kernel {name} {c['shape']}: bit-equal to plain; "
                  f"{c['ms']:.4f} ms (device {c['dev_ms']:.4f}) vs plain "
                  f"{c['plain_ms']:.4f} ms, bound "
                  f"{c['bound_ms']:.4f} ms by {c['bound_by']} "
                  f"({c['bytes'] / 1e6:.1f} MB, {c['ops'] / 1e9:.3f} G mul"
                  f"{tc}) [{card}]")
        since[name] = len(probe.calls)


def _count_named(named, what: str, fn, want: dict, extra=None):
    """Run fn with the launch count of every (name, wrapper) of `named`
    set to 0 just before and read just after, print them and check them
    against `want`.  extra: a function that reads other counters ({name:
    value}, the all-to-alls), read before and after as well and printed
    beside.  Returns (fn's output, the launch counts, the other
    counters' increase)."""
    import torch
    for _, w in named:
        w.launches = 0
    before = extra() if extra else {}
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    got = {name: w.launches for name, w in named}
    more = {k: v - before[k] for k, v in (extra() if extra else {}).items()}
    print(f"launches, {what}: " + ", ".join(f"{k}={v}"
                                            for k, v in got.items())
          + "".join(f"; {k} {v}" for k, v in more.items()))
    if got != want:
        raise RuntimeError(f"{what}: launches {got} != {want}")
    return out, got, more


def _count(wrappers, what: str, fn, launches: dict):
    """Run fn with every launch count set to 0 just before and read just
    after; check them against EXPECTED[what] and add them to launches."""
    out, got, _ = _count_named(
        [(name, w) for (name, *_), w in zip(KERNELS, wrappers)], what, fn,
        EXPECTED[what])
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


def _trace(run, steps: int):
    """torch.profiler over `steps` calls of run() after one warm-up call
    that the profiler traces and drops (late in a long process it loses
    the records of the first kernels after it starts: the warm-up takes
    that loss): (the device events by kernel, wall ms a call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(steps):
            run()
            if i + 1 < steps:
                prof.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        prof.step()
    # ProfilerStep#: the schedule's step ranges, not kernels
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")], wall_ms


def _profile(run, steps: int, card: str, what: str,
             launched=None) -> None:
    """torch.profiler over `steps` calls of run() (_trace): device-busy
    time per call against the wall time, and the top device kernels.
    Where `launched()` counts the port's kernel launches apart from the
    profiler (the wrappers' counts of kernels launching once a call), the
    trace's records of the port's kernels are held against the launches
    of the timed calls, and the aten kernels are listed by name."""
    before = None if launched is None else launched()
    events, wall_ms = _trace(run, steps)
    if launched is not None:
        want = (launched() - before) * steps // (steps + 1)
        held = sum(e.count for e in events if "ptk" in e.key)
        print(f"profile {what}: the trace holds {held} of the {want} "
              "kernel launches the port's counters saw" + (
                  "" if held == want else
                  "; it dropped records, so the numbers below are short"))
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    if busy_ms == 0:
        print(f"profile {what}: device time not measured (no CUDA events) "
              f"[{card}]")
        return
    print(f"profile {what}: {busy_ms:.3f} ms device-busy of {wall_ms:.3f} ms "
          f"wall per step, idle share {1 - busy_ms / wall_ms:.3f} [{card}]")
    # the kernels that are not the port's own (namespaces ptk, ptk64):
    # aten's elementwise, cat and copy kernels and the rest
    aten = [e for e in events if "ptk" not in e.key]

    def kind(k):
        if "Cat" in k or "copy" in k.lower() or "Memcpy" in k:
            return "cat / copy"
        return "elementwise" if "elementwise" in k else "other"
    counts = {c: sum(e.count for e in aten if kind(e.key) == c) / steps
              for c in ("elementwise", "cat / copy", "other")}
    aten_ms = sum(e.self_device_time_total for e in aten) / 1e3 / steps
    print(f"profile {what}: {sum(e.count for e in aten) / steps:g} aten "
          "kernels a step (" + ", ".join(f"{v:g} {c}" for c, v in
                                        counts.items())
          + f"), {aten_ms:.3f} ms device [{card}]")
    if launched is not None:
        print(f"profile {what}: aten kernels a step: " + "; ".join(
            f"{e.count / steps:g}x {e.key[:60]}" for e in sorted(
                aten, key=lambda e: e.key)))
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


# phases 34-36: the CKKS application path at the headline configuration
ENC_CHAIN = (1, 7)        # the device encoder's chain indices
MLP_D = 64                # the MLP's width: bs 8, gs 8, 14 Galois keys
MLP_BAND = 16             # layer 2 keeps diagonals 0..15 and 48..63
MLP_INTERVAL = (-8.0, 8.0)
MLP_DEGREE = 15
MLP_TOL = 1e-2            # PERF.md section 2 reckons it


def sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def mlp_weights(d: int, band: int, seed: int):
    """(W1 dense, W2 banded: diagonals 0..band-1 and d-band..d-1, x):
    entries scaled so that the activation's input stays inside
    MLP_INTERVAL."""
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((d, d)) * (1.5 / np.sqrt(d))
    w2 = rng.standard_normal((d, d)) * (1.5 / np.sqrt(2 * band))
    idx = np.arange(d)
    for k in range(band, d - band):
        w2[idx, (idx + k) % d] = 0.0
    return w1, w2, rng.uniform(-1.0, 1.0, d)


# F1's kernels are templates named ckks_fft_<pass>_kernel
F1_PREFIX = "ckks_fft_"
F1_KERNELS = ("ckks_fft_row_kernel", "ckks_fft_col_kernel")


def f1_grids(fn) -> list:
    """The blocks of each CUDA launch of one call of an F1 form, as the
    library records them (ptk_ckks_fft_grids; the first 8, and a 0 for
    each launch past them)."""
    import ctypes
    from phantom_tpu_torch import _build
    fn()
    blocks = (ctypes.c_int * 8)()
    count = _build.library().ptk_ckks_fft_grids(blocks, len(blocks))
    return list(blocks[:count]) + [0] * (count - len(blocks))


def _f1_inputs(dev, t, ctx):
    """Seeded inputs of F1's forms at N = 2^16: the bare transforms'
    planes (forward: rounded coefficients; inverse: slot-like values, both
    at 2^40), the encoder's slots at 2^28 over chain index 1's primes, and
    two uniform coefficient-form limbs."""
    import torch
    from phantom_tpu_torch.ops.ckks_fft import df_from_f64
    n = t.n
    rng = np.random.default_rng(SEED + 30)
    coeffs = np.round(rng.standard_normal(n) * 2.0 ** 40)
    slots = rng.standard_normal((2, n)) * 2.0 ** 40

    def planes(re, im):
        return torch.from_numpy(np.stack(df_from_f64(re) + df_from_f64(im))
                                ).to(dev)

    z = unit_disc(rng, n // 2)
    k = ctx.get_context_data(1).size_ql
    moduli = ctx.get_context_data(1).moduli[:2]
    limbs = torch.from_numpy(np.stack([rng.integers(0, q, n)
                                       for q in moduli])).int().to(dev)
    return dict(
        coeffs=coeffs, fwd=planes(coeffs, np.zeros(n)), inv=planes(*slots),
        z=torch.from_numpy(z.view(np.float64).reshape(-1, 2)).to(dev),
        q=ctx.key_q[:k], limbs=limbs, moduli=moduli)


def _f1_phase(card, probes, dev, lib, ctx) -> None:
    """Phase 34: every F1 kernel's SASS (no FFMA), the golden file through
    F1, F1 forward and inverse at N = 2^16 under the probes (bit-equal to
    the plain FFT, timed, bound), the CUDA launches and blocks of each
    form, torch.fft.fft over complex128 as the library's yardstick, and
    int64 -> f32 on the card against the CPU."""
    import torch
    from phantom_tpu_torch.ops import ckks_fft as cf
    counts = sass_by_function(lib, F1_PREFIX, ("FFMA", "FMUL", "FADD"))
    missing = [k for k in F1_KERNELS if not any(k in f for f in counts)]
    if missing:
        raise RuntimeError(f"F1: no {missing} in the library")
    for f, c in counts.items():
        fma = {k: v for k, v in c.items() if k.startswith("FFMA")}
        muls = sum(v for k, v in c.items() if k.startswith("FMUL"))
        if fma or not muls:
            raise RuntimeError(f"F1 {f}: FFMA {fma}, FMUL {muls} in SASS")
    print(f"sass: {len(counts)} F1 kernels ({', '.join(F1_KERNELS)} "
          f"instances) issue no FFMA ("
          + ", ".join(f"{sum(v for k, v in c.items() if k.startswith('FMUL'))}"
                      for c in counts.values()) + " FMUL)")
    got = fft_golden(dev)
    for name, (a, b) in got.items():
        if not np.array_equal(a, b):
            raise RuntimeError(f"F1 golden: {name} differs from the JAX "
                               "package's eager evaluation")
    print(f"F1 golden: {len(got)} tables and transforms at n = 256 and "
          "1024 bit-equal to the JAX package's eager evaluation")
    n = HEADLINE["n"]
    t = cf.make_fft_tables(n, dev)
    a = _f1_inputs(dev, t, ctx)
    probes.ckks_fft(a["fwd"], t)
    probes.ckks_fft(a["inv"], t, inverse=True)
    for c, what in zip(probes.ckks_fft.calls[-2:], ("forward", "inverse")):
        print(f"F1 {what}, N = {n}: {c['dev_ms']:.5f} ms device a call "
              f"({c['dev_ms'] / c['bound_ms']:.1f}x its bound "
              f"{c['bound_ms']:.5f} ms by {c['bound_by']}), event "
              f"{c['ms']:.5f} [{card}]")
    forms = {
        "forward": lambda: cf.ckks_fft(a["fwd"], t),
        "inverse": lambda: cf.ckks_fft(a["inv"], t, inverse=True),
        "encode": lambda: cf.ckks_fft_encode(a["z"], 2.0 ** 28, a["q"], t),
        "decode": lambda: cf.ckks_fft_decode(a["limbs"], a["moduli"],
                                             2.0 ** 28, t)}
    for what, fn in forms.items():
        blocks = f1_grids(fn)
        print(f"F1 {what}, N = {n}: {len(blocks)} CUDA launches a call, "
              f"blocks {blocks} (ptk_ckks_fft_grids)")
        if not 0 < len(blocks) < 6 or min(blocks) <= 32:
            raise RuntimeError(f"F1 {what}: {len(blocks)} launches, blocks "
                               f"{blocks}: not spread over the card")
    v = torch.from_numpy(a["coeffs"] * np.exp(1j * np.pi * np.arange(n) / n)
                         ).to(dev)
    # the kernels line sums the two probed calls, so two library calls
    probes.ckks_fft.library_ms = round(2 * _time(lambda: torch.fft.fft(v),
                                                 REPS), 5)
    print(f"F1 library yardstick: torch.fft.fft of the twisted vector, "
          f"complex128, N = {n}: {probes.ckks_fft.library_ms / 2:.4f} ms per "
          f"call, device {_device_ms(lambda: torch.fft.fft(v), REPS):.5f} "
          f"(not bit-identical to F1) [{card}]")
    m = torch.randint(-(1 << 60), 1 << 60, (1 << 20,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    m[:4] = torch.tensor([(1 << 40) + 1, (1 << 40) + 3, -(1 << 53) - 1,
                          (1 << 25) + 1], device=dev)  # ties, both ways
    for what, x in (("m", m), ("m - hi", m - m.float().long())):
        if not torch.equal(x.float().cpu().view(torch.int32),
                           x.cpu().float().view(torch.int32)):
            raise RuntimeError(f"int64 -> f32 of {what} on the card differs "
                               "from the CPU's")
    print("int64 -> f32 on the card rounds as on the CPU (to nearest, ties "
          f"to even) in {m.numel()} seeded values and their remainders")


def _host_ms(fn, reps: int) -> float:
    """Milliseconds per call on the host's clock, the device synchronized
    after each call, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _encoder_parts(card, enc, f1ops, z, scale: float, ci: int, pt):
    """F1's forms at chain index ci under the probes (bit-equal to plain,
    timed, bound), then encode's and decode's parts timed apart: the host
    preparation, the copy, F1 and K2; K1 on two limbs, F1 and the copy
    back."""
    import torch
    from phantom_tpu_torch.ops import ntt_kernels
    ctx = enc.ctx
    dev = ctx.key_q.device
    k = ctx.get_context_data(ci).size_ql
    enc.encode(z, scale, ci, ops=f1ops)
    enc.decode(pt, f1ops)
    fe, fd = f1ops.ckks_fft_encode.calls[-1], f1ops.ckks_fft_decode.calls[-1]
    zh = enc._slots(z, scale)
    zd = zh.to(dev)
    rns = f1ops.ckks_fft_encode.kernel(zd, scale, ctx.key_q[:k], enc.tables)
    x2 = ntt_kernels.ntt_inverse(pt.data[:2].contiguous(), ctx.ntt,
                                 ctx.rows_qp[:2])
    out = f1ops.ckks_fft_decode.kernel(
        x2, ctx.get_context_data(ci).moduli[:2], pt.scale, enc.tables)
    parts_e = dict(
        prep=_host_ms(lambda: enc._slots(z, scale), REPS),
        copy=_time(lambda: zh.to(dev), REPS),
        k2=_time(lambda: ntt_kernels.ntt_forward(rns, ctx.ntt,
                                                 ctx.rows_qp[:k]), REPS))
    parts_d = dict(
        k1=_time(lambda: ntt_kernels.ntt_inverse(
            pt.data[:2].contiguous(), ctx.ntt, ctx.rows_qp[:2]), REPS),
        back=_host_ms(lambda: torch.view_as_complex(out).cpu().numpy(),
                      REPS))
    print(f"F1 encode form, chain index {ci} ({k} primes): bit-equal to "
          f"plain; {fe['ms']:.5f} ms (device {fe['dev_ms']:.5f}), bound "
          f"{fe['bound_ms']:.5f} ms by {fe['bound_by']} "
          f"({fe['bytes'] / 1e6:.1f} MB); decode form {fd['ms']:.5f} ms "
          f"(device {fd['dev_ms']:.5f}), bound {fd['bound_ms']:.5f} ms by "
          f"{fd['bound_by']} [{card}]")
    print(f"encode parts, chain index {ci}: host preparation "
          f"{parts_e['prep']:.4f} ms, copy {parts_e['copy']:.4f}, F1 "
          f"{fe['ms']:.4f}, K2 {parts_e['k2']:.4f} (sum "
          f"{parts_e['prep'] + parts_e['copy'] + fe['ms'] + parts_e['k2']:.4f})"
          f"; decode parts: K1 on 2 limbs {parts_d['k1']:.4f}, F1 "
          f"{fd['ms']:.4f}, copy back {parts_d['back']:.4f} (sum "
          f"{parts_d['k1'] + fd['ms'] + parts_d['back']:.4f}) [{card}]")


def _encoder_phase(card, probes, wrappers, launches, dev, ctx) -> None:
    """Phase 35: the golden file through the device encoder, then at the
    headline chain (chain indices 1 and 7): the launch counts, the kernel
    path against the plain path, encode's residues at 2^28 against the
    host encoder's (+-1), their decode against the host decode (1e-9), a
    round trip at 2^30 (1e-6), decode of uniform residues, event times
    beside the host encoder's; F1's forms under the probes and encode's and decode's parts (_encoder_parts)."""
    import torch
    from phantom_tpu_torch import CKKSDeviceEncoder, CKKSEncoder, Plaintext
    from phantom_tpu_torch.ops import ntt_kernels
    from phantom_tpu_torch.ops import pipeline32 as pp
    exact, jitted = encoder_golden(dev)
    for name, (a, b) in exact.items():
        if not np.array_equal(a, b):
            raise RuntimeError(f"encoder golden: {name} differs from the JAX "
                               "package's eager evaluation")
    for ci, (where, worst, dec) in jitted.items():
        print(f"encoder golden, chain index {ci}: ints, residues and decoded "
              f"slots bit-equal to the JAX eager encoder; against the jitted "
              f"JAX encoder {where.size} coefficients differ "
              f"{where.tolist()[:8]} (largest {worst}), decode within "
              f"{dec:.3e}")
        if worst > 1 or not dec < 1e-10:
            raise RuntimeError("encoder golden: beyond +-1 or 1e-10 of the "
                               "jitted JAX encoder")
    enc, host = CKKSDeviceEncoder(ctx), CKKSEncoder(ctx)
    rng = np.random.default_rng(SEED + 31)
    scale = 2.0 ** 28
    f1ops = pp.KERNELS._replace(ckks_fft_encode=probes.ckks_fft_encode,
                                ckks_fft_decode=probes.ckks_fft_decode)
    for ci in ENC_CHAIN:
        z = unit_disc(rng, enc.slots)
        k = ctx.get_context_data(ci).size_ql
        pt = _count(wrappers, "device encode",
                    lambda: enc.encode(z, scale, ci), launches)
        if not _same(pt, enc.encode(z, scale, ci, ops=pp.PLAIN)):
            raise RuntimeError("device encode: kernel path differs from "
                               "plain path")
        hp = host.encode(z, scale, ci)
        c = [ntt_kernels.ntt_inverse(p.data, ctx.ntt, ctx.rows_qp[:k])[0]
             .cpu().numpy() for p in (pt, hp)]
        diff = _centered_diff(c[0], c[1], ctx.params.data_moduli[0])
        dec = _count(wrappers, "device decode", lambda: enc.decode(pt),
                     launches)
        if not np.array_equal(dec, enc.decode(pt, pp.PLAIN)):
            raise RuntimeError("device decode: kernel path differs from "
                               "plain path")
        # at 2^28 the rounding alone leaves about 1e-6 in a slot at N =
        # 2^16, so the 1e-6 bound holds at 2^30 (the JAX package's test)
        err28 = float(np.abs(dec - z).max())
        err = float(np.abs(enc.decode(enc.encode(z, 2.0 ** 30, ci)) - z)
                    .max())
        q = ctx.key_q[:k].long().view(-1, 1)
        junk = Plaintext(data=(torch.randint(
            0, 1 << 62, (k, enc.slots * 2), device=dev,
            generator=torch.Generator(device=dev).manual_seed(ci)) % q).int(),
            chain_index=ci, is_ntt_form=True, scale=scale)
        finite = int(np.isfinite(enc.decode(junk)).sum())
        t_enc = _time(lambda: enc.encode(z, scale, ci), REPS)
        t_dec = _time(lambda: enc.decode(pt), REPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hp = host.encode(z, scale, ci)
        torch.cuda.synchronize()
        h_enc = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        hd = host.decode(pt)
        h_dec = (time.perf_counter() - t0) * 1e3
        vs_host = float(np.abs(dec - hd).max())
        print(f"device encoder, chain index {ci} ({k} primes): kernel path "
              f"bit-equal to plain path; encode at 2^28 against the host "
              f"encoder: {np.count_nonzero(diff)} of {diff.size} coefficients "
              f"differ, largest {int(diff.max())}; its decode within "
              f"{vs_host:.3e} of the host decode (bound 1e-9) and {err28:.3e} "
              f"of the input; at 2^30 within {err:.3e} of the input (bound "
              f"1e-6); uniform residues decode to {finite} finite of "
              f"{enc.slots} slots")
        if diff.max() > 1 or not (err < 1e-6 and vs_host < 1e-9):
            raise RuntimeError(f"device encoder at chain index {ci}: "
                               f"+-{int(diff.max())}, {err}, {vs_host}")
        try:
            host.decode(junk)
            h_junk = "returns"
        except OverflowError:
            h_junk = "raises OverflowError"
        print(f"timing device encoder, chain index {ci}: encode {t_enc:.3f} "
              f"ms, decode {t_dec:.3f} ms; host encoder (one call each) "
              f"encode {h_enc:.1f} ms, decode {h_dec:.1f} ms; the host "
              f"decode of uniform residues {h_junk} [{card}]")
        _encoder_parts(card, enc, f1ops, z, scale, ci, pt)


def _mlp_phase(card, wrappers, launches, dev, ctx) -> float:
    """Phase 36: the golden files of LinearTransform and the polynomial
    evaluators through the kernels, then the MLP + Chebyshev circuit at the
    headline configuration, each stage through _Circuit (launch counts,
    kernel path = plain path, event time), the whole circuit once more on
    the plain path from the same plaintext and generator state, the modups
    per layer counted, the decoded output against numpy's float64
    evaluation (MLP_TOL), a profile and peak memory.  Returns the error."""
    import torch
    from numpy.polynomial import chebyshev as C
    from phantom_tpu_torch import (CKKSDeviceEncoder, CKKSEncoder, Fast32,
                                   LinearTransform, chebyshev_fit,
                                   poly_eval_cheb_fast32)
    from phantom_tpu_torch.ops import pipeline32 as pp
    for what, got in (("linear", linear_golden(dev)),
                      ("poly", poly_golden(dev))):
        for name, (a, b) in got.items():
            if not np.array_equal(a, b):
                raise RuntimeError(f"golden {name} differs from the JAX "
                                   "output")
        print(f"golden {what}: {len(got)} outputs through the kernels "
              "bit-equal to the JAX package's")
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    ev = Fast32(ctx)
    sk = ev.gen_secret_key(gen)
    pk = ev.gen_public_key(sk, gen)
    rlk = ev.gen_relin_key(sk, gen)
    w1, w2, x = mlp_weights(MLP_D, MLP_BAND, SEED + 33)
    h2 = w2 @ (w1 @ x) ** 2
    if not np.abs(h2).max() < MLP_INTERVAL[1]:
        raise RuntimeError("MLP: the activation's input leaves its interval")
    lt1, lt2 = LinearTransform(w1), LinearTransform(w2)
    steps = sorted(set(lt1.steps_required()) | set(lt2.steps_required()))
    ev = Fast32(ctx, rlk=rlk, glk=ev.create_galois_keys(sk, gen, steps))
    enc, host = CKKSDeviceEncoder(ctx), CKKSEncoder(ctx)
    q = ctx.params.data_moduli
    L = ctx.params.size_q
    # the input at q_{L-2} q_{L-3} (so the floored moddown's bias of the
    # fresh encryption, 2.5e-2 at scale q_last, falls far below the
    # tolerance); layer 1's weights at the prime its rescale drops, then
    # one more rescale: scale q_{L-3} from chain index 3 on
    s_in = float(q[L - 2]) * float(q[L - 3])
    torch.cuda.synchronize()
    print(f"MLP setup: d={MLP_D} (bs {lt1.bs}, gs {lt1.gs}), layer 2 "
          f"{sum(len(s) for _, s, _ in lt2.groups)} of {MLP_D} diagonals; "
          f"{len(steps)} Galois keys; keys {time.time() - t0:.1f} s")
    for lt, ci, p in ((lt1, 1, float(q[L - 1])), (lt2, 4, float(q[L - 4]))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lt.prepare(host, p, ci)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        nd = sum(len(s) for _, s, _ in lt.groups)
        size = sum(w.numel() * 4 for grp in lt._prepared[ci] for w in grp)
        print(f"MLP prepare (host encode_extended over QlP) at chain index "
              f"{ci}: {nd} diagonals in {ms:.0f} ms ({ms / nd:.1f} ms a "
              f"diagonal), {size / 2**30:.2f} GiB of weights [{card}]")
    cc = chebyshev_fit(sigmoid, MLP_DEGREE, MLP_INTERVAL)
    c = _Circuit("MLP circuit", ev, wrappers, launches, card, gen)
    tiled = np.tile(x, enc.slots // MLP_D)
    state = gen.get_state()
    pt = c("encode", "device encode",
           lambda ops: enc.encode(tiled, s_in, ops=ops))
    ct = c("encrypt_asymmetric", "Fast32 CKKS encrypt_asymmetric",
           lambda ops: ev.encrypt_asymmetric(pk, pt, gen, ops), True)
    h = c("layer 1", "MLP layer 1, dense",
          lambda ops: lt1.apply_fast32(ev, ct, ops=ops), reps=3)
    h = c("rescale", "Fast32 CKKS rescale_to_next",
          lambda ops: ev.rescale_to_next(h, ops))
    h = c("square_and_relin", "Fast32 CKKS multiply_and_relin",
          lambda ops: ev.square_and_relin(h, ops))
    h1 = c("rescale", "Fast32 CKKS rescale_to_next",
           lambda ops: ev.rescale_to_next(h, ops))
    h = c("layer 2", "MLP layer 2, banded",
          lambda ops: lt2.apply_fast32(ev, h1, ops=ops), reps=3)
    y = c("activation", "MLP activation, Chebyshev degree 15",
          lambda ops: poly_eval_cheb_fast32(ev, h, cc, enc,
                                            interval=MLP_INTERVAL, ops=ops),
          reps=3)
    y = c("rescale", "Fast32 CKKS rescale_to_next",
          lambda ops: ev.rescale_to_next(y, ops))
    dec = c("decrypt", "Fast32, no kernel", lambda ops: ev.decrypt(sk, y, ops))
    got = c("decode", "device decode", lambda ops: enc.decode(dec, ops))
    c.report()
    # the whole circuit once more on the plain path, the same draws
    after = gen.get_state()
    gen.set_state(state)
    p_ = pp.PLAIN
    v = ev.encrypt_asymmetric(pk, enc.encode(tiled, s_in, ops=p_), gen, p_)
    v = ev.rescale_to_next(lt1.apply_fast32(ev, v, ops=p_), p_)
    v = ev.rescale_to_next(ev.square_and_relin(v, p_), p_)
    v = poly_eval_cheb_fast32(ev, lt2.apply_fast32(ev, v, ops=p_), cc, enc,
                              interval=MLP_INTERVAL, ops=p_)
    v = ev.rescale_to_next(v, p_)
    gen.set_state(after)
    if not _same(v, y):
        raise RuntimeError("MLP circuit: the plain path's final ciphertext "
                           "differs from the kernel path's")
    modups = [0]
    real = pp._modup_inverse

    def counted(*a, **kw):
        modups[0] += 1
        return real(*a, **kw)

    pp._modup_inverse = counted
    try:
        lt1.apply_fast32(ev, ct)
        m1 = modups[0]
        lt2.apply_fast32(ev, h1)
    finally:
        pp._modup_inverse = real
    m2 = modups[0] - m1
    g1 = sum(1 for g, *_ in lt1.groups if g)
    g2 = sum(1 for g, *_ in lt2.groups if g)
    print(f"MLP modups: layer 1 {m1} (1 shared by its {len(lt1.groups)} "
          f"groups + {g1} giant rotations), layer 2 {m2} (1 shared by "
          f"{len(lt2.groups)} groups + {g2})")
    if (m1, m2) != (1 + g1, 1 + g2):
        raise RuntimeError("MLP: not one modup per layer")
    a, b = MLP_INTERVAL
    want = np.tile(C.chebval((2 * h2 - (a + b)) / (b - a), cc),
                   enc.slots // MLP_D)
    err = float(np.abs(got - want).max())
    print(f"MLP circuit: kernel path bit-equal to the plain path on the "
          f"final ciphertext (chain index {y.chain_index}, scale "
          f"2^{np.log2(y.scale):.3f}); |h2| <= {np.abs(h2).max():.3f}; decoded "
          f"slots within {err:.3e} of numpy's float64 evaluation of the "
          f"network and the Chebyshev series (bound {MLP_TOL}); the series "
          f"within {np.abs(C.chebval(h2 / b, cc) - sigmoid(h2)).max():.2e} "
          f"of the sigmoid")

    def run():
        v = ev.encrypt_asymmetric(pk, enc.encode(tiled, s_in), gen)
        v = ev.rescale_to_next(lt1.apply_fast32(ev, v))
        v = ev.rescale_to_next(ev.square_and_relin(v))
        v = poly_eval_cheb_fast32(ev, lt2.apply_fast32(ev, v), cc, enc,
                                  interval=MLP_INTERVAL)
        return enc.decode(ev.decrypt(sk, ev.rescale_to_next(v)))

    act = dict(c.times)["activation"]
    print(f"timing MLP circuit end to end (encode to decode): "
          f"{_time(run, 3):.3f} ms, the activation {act:.3f} ms [{card}]")
    _profile(run, 2, card, "MLP circuit, encode to decode")
    if not err <= MLP_TOL:
        raise RuntimeError(f"MLP circuit: error {err} > {MLP_TOL}")
    return err


def _app_phases(card, probes, wrappers, launches, dev, lib) -> None:
    """Phases 34-36 on one headline context."""
    import torch
    from phantom_tpu_torch import make_context
    ctx = make_context(chain_params(**HEADLINE))
    _f1_phase(card, probes, dev, lib, ctx)
    _encoder_phase(card, probes, wrappers, launches, dev, ctx)
    torch.cuda.empty_cache()
    _mlp_phase(card, wrappers, launches, dev, ctx)



# ---------------------------------------------------------------------------
# phases 37-44: the u32 roll engine and xla-bconv moddown, and the u64
# evaluator on U1-U4
# ---------------------------------------------------------------------------

# bench.py --path u64: 43 data primes of 50 bits, 22 special of 51 (dnum
# 2), N = 2^16; CKKS at scale 2^44; BGV with bench.py's 20-bit t
U64_CFG = dict(n=1 << 16, limbs=43, alpha=22, bits=50)
U64_SCALE_BITS = 44
U64_CHAIN_STEPS = 10
U64_TOL = 1e-2  # JAX tests/test_ckks.py:84's bound
U64_REPS = 3    # timed calls per probed U call (the plain versions are slow)
HOST_REPS = 50  # calls whose host time is averaged (U4)
U64_KERNELS = [  # name, wrapper attribute, source, the stage it replaces
    ("U1", "ntt_forward", "phantom_tpu_torch/csrc/u64_ntt.cu",
     "phantom_tpu/ops/ntt.py:101 and :151 (XLA, no pallas_call)"),
    ("U2", "bconv", "phantom_tpu_torch/csrc/u64_bconv.cu",
     "phantom_tpu/ops/bconv.py:153 and :171 (XLA, no pallas_call)"),
    ("U3", "inner_product_evk_kernel", "phantom_tpu_torch/csrc/u64_ip.cu",
     "phantom_tpu/schemes/keyswitch.py:69 (XLA, no pallas_call)"),
    ("U4", "mul_rns", "phantom_tpu_torch/csrc/u64_polyops.cu",
     "phantom_tpu/ops/modmath.py:146 in ops/polyops.py:34-103 (XLA, no "
     "pallas_call)"),
]
# the Kernels64 fields, by the kernel each launches
U4_FIELDS = ("mul_rns", "fma_rns", "tensor_prod_2x2", "tensor_square_2x2",
             "tensor_prod_mxn", "shoup_rns", "rescale_delta",
             "modswitch_delta", "moddown_delta")
U64_FIELDS = {"ntt_forward": "U1", "ntt_inverse": "U1", "bconv": "U2",
              "inner_product": "U3", **{f: "U4" for f in U4_FIELDS}}
# Kernels64's F1 fields (the wide forms): their probes' names
U64_F1_FORMS = {"ckks_fft_encode": "F1 encode64",
                "ckks_fft_decode": "F1 decode64"}
# 32-bit multiplies per u64 operation, as the bounds count them: a 64 x 64
# product's high word (__umul64hi) 4, its low word 3 (the 32-bit partial
# products of one decomposition; phase 41 prints the IMADs each U kernel's
# SASS holds)
MUL_HI, MUL_LO = 4, 3
SHOUP_OPS = MUL_HI + 2 * MUL_LO                     # x w - floor(x ws) q
BARRETT64_OPS = MUL_HI + MUL_LO
# the quotient's three high and three low products, then k q
BARRETT128_OPS = 3 * MUL_HI + 4 * MUL_LO
MULMOD_OPS = MUL_HI + MUL_LO + BARRETT128_OPS
REDUCE_ANY_OPS = 2 * BARRETT64_OPS + MULMOD_OPS
# the floor sum's y V (wide), y U (low) and two exact divisions
FLOOR_SUM_OPS = MUL_HI + 2 * MUL_LO + 2 * BARRETT128_OPS


def _launches64(**kw):
    return {name: kw.get(name, 0) for name, *_ in U64_KERNELS}


# k = 43 is not a multiple of alpha = 22, so the modup is the unfused
# one, as in the JAX package: the inverse NTT of c2, U2 per digit, one
# forward NTT; U3; per half the moddown's U1 inverse, U2 exact (BGV: to Ql
# and to {t}), U1 forward and U4's (x - .) P^-1 + the ciphertext's half
EXPECTED64 = {
    # U4's tensor product; the relinearization above (its adds in the
    # moddown's U4); the rescale's U1 inverse, its rounding correction for
    # every limb (U4's rescale_delta), U1 forward and U4
    "u64 CKKS step": _launches64(U1=8, U2=4, U3=1, U4=5),
    # BGV's moddown adds U4's moddown_delta per half (u = [-delta_t
    # P^-1]_t, u P and the shifts in one launch); the modulus switch's U1
    # inverse, U4's modswitch_delta (u mod t, c_last mod q_i, u q_last and
    # their sum), U1 forward and U4
    "u64 BGV step": _launches64(U1=8, U2=6, U3=1, U4=7),
    # u and e (U1 x2), u pk + e (U4's fma), the moddown of both halves;
    # BGV also t e (U4's Shoup form), the plaintext's lift (U1) and
    # moddown_delta per half
    "u64 CKKS encrypt_asymmetric": _launches64(U1=6, U2=2, U4=3),
    "u64 BGV encrypt_asymmetric": _launches64(U1=7, U2=4, U4=6),
    # per digit a uniform draw's 2^62 hi (U4's Shoup form); s^2, (P mod
    # q) s^2 (U4's Shoup form), a s + e (U4's fma); BGV also t e
    "u64 CKKS gen_relin_key": _launches64(U1=1, U4=5),
    "u64 BGV gen_relin_key": _launches64(U1=1, U4=6),
    "u64 BFV gen_relin_key": _launches64(U1=1, U4=5),
    # BFV (31 data primes, alpha 22): u (U1), u pk (U4), back (U1), per
    # half the coefficient moddown (U2 exact, U4), round(Ql m / t)'s
    # Delta m (U4's row form)
    "u64 BFV encrypt_asymmetric": _launches64(U1=2, U2=2, U4=4),
    # multiply_and_relin.  The relinearization of a coefficient-form c2:
    # per digit U2, one U1 forward, U3, per half the moddown (U1 both
    # ways, U2, U4), U1's inverse of both halves: U1=6 U2=4 U3=1 U4=2.
    # HPS: per operand poly the exact lift Ql -> Rl (U2), U1 forward of
    # each operand over D, the tensor product (U4), U1 inverse, per output
    # poly U2's scale_round to Rl and the exact conversion Rl -> Ql
    "u64 BFV hps step": _launches64(U1=9, U2=14, U3=1, U4=3),
    # BEHZ: per operand poly SmMRq (U4 m_tilde x, U2 to Bsk and to {2^32},
    # U4's row form for r mod bsk_j, U4 x2 for conv m_tilde^-1 + r Q
    # m_tilde^-1), per operand U1 over Ql and over Bsk, the tensor
    # products over Ql and Bsk (U4 x2), U1's inverses with t in their
    # scale, per output poly the fast floor (U2, U4) and Shenoy-Kumaresan
    # (U2 x2, U4 alpha, U4's row form alpha B)
    "u64 BFV behz step": _launches64(U1=12, U2=21, U3=1, U4=29),
    # HPSoverQ: ct1's lift (U2 per poly), per ct2 poly U2's scale_round
    # Ql -> Rl and the exact conversion Rl -> Ql, U1 x3, U4, per output
    # poly U2's scale_round D -> Ql; leveled without a drop the same
    "u64 BFV hps_overq step": _launches64(U1=9, U2=13, U3=1, U4=3),
    "u64 BFV hps_overq_leveled step": _launches64(U1=9, U2=13, U3=1,
                                                  U4=3),
    # leveled with a drop: ct1 scaled Q -> Ql first (U2 per poly), ct2 Q ->
    # Rl, and per output poly the exact lift back to the dropped prime (U2)
    "u64 BFV hps_overq_leveled step, drop 1": _launches64(U1=9, U2=18, U3=1,
                                                          U4=3),
}
EXPECTED.update({
    # every transform K6: the modup's inverse and the complement rows'
    # forward, K5 per digit (2), K9; two moddowns (K6 inverse, K5, K6
    # forward each); the rescale's K6 inverse and forward
    "headline step, pallas-roll": _launches(K5=4, K9=1, K6f=4, K6i=4),
    # the xla-split modup (K1, K5 x2, K2), K9; the pair's K1 with v, one
    # K5 over both halves, one K2 with the epilogue; the rescale (K1, K3)
    "headline step, xla-bconv moddown": _launches(K1=3, K2=2, K3=1, K5=3,
                                                  K9=1),
    # the modup as on the CKKS step, K9; both halves' moddown K6 inverse,
    # K5 to Ql and to {t}, K6 forward; the modulus switch K6 both ways
    "BGV step, pallas-roll": _launches(K5=4, K9=1, K6f=3, K6i=3),
    # Fast32 on "pallas-roll": the CKKS and BGV verbs of phase 40
    "Fast32 roll CKKS multiply_and_relin": _launches(K5=4, K9=1, K6f=3,
                                                     K6i=3),
    "Fast32 roll CKKS rescale_to_next": _launches(K6f=1, K6i=1),
    "Fast32 roll CKKS rotate": _launches(K5=4, K9=1, K6f=3, K6i=3),
    "Fast32 roll BGV multiply_and_relin": _launches(K5=4, K9=1, K6f=2,
                                                    K6i=2),
    "Fast32 roll BGV mod_switch_to_next": _launches(K6f=1, K6i=1),
    "Fast32 roll BGV rotate": _launches(K5=4, K9=1, K6f=2, K6i=2),
})


def kernel_wrappers64():
    """U1-U4's wrappers, in U64_KERNELS' order (each holds its kernel's
    launch count; U1's forward and inverse share one, as do U4's forms)."""
    from phantom_tpu_torch.ops import bconv, ntt, polyops
    from phantom_tpu_torch.schemes import keyswitch
    return [ntt.ntt_forward, bconv.bconv,
            keyswitch.inner_product_evk_kernel, polyops.mul_rns]


def _named64(wrappers):
    return [(name, w) for (name, *_), w in zip(U64_KERNELS, wrappers)]


def _count64(wrappers, what: str, fn, launches: dict):
    """_count for U1-U4 against EXPECTED64[what]."""
    out, got, _ = _count_named(_named64(wrappers), what, fn,
                               EXPECTED64[what])
    for k, v in got.items():
        launches[k] += v
    return out


def _words_bytes(*xs) -> int:
    return sum(8 * x.numel() for x in xs if x is not None)


def _work64(field: str, a: dict, out):
    """(bytes, 32-bit multiplies) one U call needs on these operands: each
    input read once, each output written once (twiddle tables per row
    used), the products as MUL_HI / MUL_LO count them."""
    x = next(v for v in a.values() if hasattr(v, "numel"))
    if field in ("ntt_forward", "ntt_inverse"):
        n, num_l = x.shape[-1], x.shape[-2]
        rows = x.numel() // n
        logn = n.bit_length() - 1
        ops = rows * (n // 2) * logn * SHOUP_OPS
        if field == "ntt_inverse":
            ops += x.numel() * SHOUP_OPS
        return 2 * _words_bytes(x) + num_l * 2 * n * 8, ops
    if field == "bconv":
        c, form = a["c"], a["form"]
        k_in, m = x.shape
        k_out = c.obase.q.shape[0]
        if form == "scale_round":  # y, y rho (wide), two exact divisions;
            # per output the products and one reduction of their sum plus F
            prep = SHOUP_OPS + MUL_HI + MUL_LO + 2 * BARRETT128_OPS
            per = k_in * (MUL_HI + MUL_LO) + REDUCE_ANY_OPS
            return (_words_bytes(x, out, c.omega_mod_out),
                    m * (k_in * prep + k_out * per))
        prep = 0 if form == "reduce" else SHOUP_OPS
        if form == "exact":
            prep += FLOOR_SUM_OPS
        per = k_in * (MUL_HI + MUL_LO) + REDUCE_ANY_OPS + (
            MULMOD_OPS if form == "exact" else 0)
        return (_words_bytes(x, out, c.qhat_mod_p),
                m * (k_in * prep + k_out * per))
    if field == "inner_product":
        beta, kk, n = x.shape
        ops = 2 * kk * n * (beta * (MUL_HI + MUL_LO) + REDUCE_ANY_OPS)
        return _words_bytes(x, a["evk"], out), ops
    words = out.numel()
    ins = [v for k, v in a.items() if k in ("a", "b", "c", "ct", "ct1",
                                            "ct2", "s", "x", "dq", "dt")
           and v is not None]  # a (..., 1, N) row counted once
    if field == "tensor_prod_mxn":
        m, n = a["ct1"].shape[0], a["ct2"].shape[0]
        cols = a["ct1"][0].numel()
        return _words_bytes(*ins, out), cols * (
            m * n * (MUL_HI + MUL_LO) + (m + n - 1) * BARRETT128_OPS)
    per = {"mul_rns": MULMOD_OPS, "fma_rns": MULMOD_OPS,
           "tensor_prod_2x2": (2 * MULMOD_OPS + 2 * (MUL_HI + MUL_LO)
                               + BARRETT128_OPS) / 3,
           "tensor_square_2x2": (2 * MULMOD_OPS + MUL_HI + MUL_LO
                                 + BARRETT128_OPS) / 3,
           "shoup_rns": SHOUP_OPS,
           "rescale_delta": BARRETT64_OPS,
           "modswitch_delta": BARRETT64_OPS + SHOUP_OPS,
           "moddown_delta": SHOUP_OPS}[field]
    # the row forms' per-column u mod t, one Shoup product
    row = {"modswitch_delta": "x", "moddown_delta": "dt"}.get(field)
    cols = 0 if row is None else a[row].numel()
    return _words_bytes(*ins, out), int(words * per) + cols * SHOUP_OPS


class _Probe64(_Probe):
    """A _Probe of one Kernels64 field: the bound from _work64."""

    def __init__(self, field, kernel, plain, reps: int):
        super().__init__(f"{U64_FIELDS[field]} {field}", kernel, plain,
                         reps)
        self.field = field

    def __call__(self, *args, **kw):
        """As _Probe's, the kernel and the plain version each into an
        output of its own where the caller gives an `out` slot (then
        filled with the kernel's); U4's calls also time the host's part
        (_enqueue_ms)."""
        ba = self.sig.bind(*args, **kw)
        slot = ba.arguments.get("out")
        if slot is not None:
            ba.arguments["out"] = None
        got = super().__call__(*ba.args, **ba.kwargs)
        if self.field == "bconv":
            ba.apply_defaults()
            self.calls[-1]["form"] = ba.arguments["form"]
        if self.name.startswith("U4"):
            self.calls[-1]["host_ms"] = _enqueue_ms(
                lambda: self.kernel(*ba.args, **ba.kwargs), HOST_REPS)
        return got if slot is None else slot.copy_(got)

    def bound(self, arguments, out):
        byt, ops = _work64(self.field, arguments, out)
        return byt, ops, 0, 0


def _enqueue_ms(fn, reps: int) -> float:
    """Host milliseconds a call: `reps` calls (after a warm-up call)
    enqueued while the device sleeps, so the host never waits for it."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # cycles, about 0.1 s
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def _probes64(reps: int = REPS):
    from phantom_tpu_torch.schemes import keyswitch as ksw
    return ksw.Kernels64(*(
        _P1Probe(reps) if f == "ntt_phase" else
        _Probe(U64_F1_FORMS[f], getattr(ksw.KERNELS64, f),
               getattr(ksw.PLAIN64, f), reps) if f in U64_F1_FORMS else
        _Probe64(f, getattr(ksw.KERNELS64, f), getattr(ksw.PLAIN64, f), reps)
        for f in ksw.Kernels64._fields))


def _print_calls64(probes, card, since):
    for probe in probes:
        for c in probe.calls[since.get(probe.name, 0):]:
            host = (f", host {c['host_ms']:.4f} ms a call"
                    if "host_ms" in c else "")
            form = f" ({c['form']})" if "form" in c else ""
            print(f"kernel {probe.name}{form} {c['shape']}: bit-equal to "
                  "plain; "
                  f"{c['ms']:.4f} ms (device {c['dev_ms']:.4f}{host}) vs "
                  f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} "
                  f"ms by {c['bound_by']} ({c['bytes'] / 1e6:.1f} MB, "
                  f"{c['ops'] / 1e9:.3f} G mul) [{card}]")
        since[probe.name] = len(probe.calls)


def _roll_phases(card, wrappers, launches, dev) -> None:
    """Phases 37-40: the roll engine's and the xla-bconv moddown's golden
    file on the card, the headline CKKS step on both (launch counts, bit
    equality with the default route, decryption), the BGV step on
    "pallas-roll", and Fast32's CKKS and BGV verbs on "pallas-roll"."""
    import torch
    from phantom_tpu_torch import Fast32, make_context
    from phantom_tpu_torch.ops import bgv32
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes.ciphertext import Ciphertext
    res = roll_golden(dev)
    for name, (got, want) in res.items():
        if not np.array_equal(got, want):
            raise RuntimeError(f"golden: roll file {name} differs")
    print(f"golden: {', '.join(res)} (roll engine, xla-bconv moddown) "
          "bit-equal to the JAX package's same routes")
    params = chain_params(**HEADLINE)
    ctx = make_context(params)
    sk, pipe, d1, d2, m1, m2 = make_step_inputs(ctx, SEED, DELTA_BITS, dev)
    out = pipe(d1, d2)
    pipes = {"headline step, pallas-roll": dict(engine=pp.ROLL_ENGINE),
             "headline step, xla-bconv moddown": dict(modup="xla-split",
                                                      moddown="xla")}
    pipes = {what: pp.CKKSPipeline32(ctx, pipe.evk, **kw).to(dev)
             for what, kw in pipes.items()}
    for what, p in pipes.items():
        got = _count(wrappers, what, lambda: p(d1, d2), launches)
        if not (torch.equal(got, out) and torch.equal(p(d1, d2, pp.PLAIN),
                                                      out)):
            raise RuntimeError(f"{what}: differs from the default route or "
                               "from its plain path")
        dist = check_decrypt(ctx, sk, got, m1, m2, DELTA_BITS)
        ms = _time(lambda: p(d1, d2), REPS)
        print(f"{what}: bit-equal to the default route and to its plain "
              f"path {tuple(got.shape)}; decrypts to m1*m2 in all "
              f"{params.n} coefficients (largest distance {dist:.3e}); "
              f"{ms:.3f} ms/step [{card}]")
    roll = pipes["headline step, pallas-roll"]
    _profile(lambda: roll(d1, d2), PROFILE_STEPS, card,
             "headline step, pallas-roll")
    del ctx, sk, pipe, pipes, roll, d1, d2, out
    torch.cuda.empty_cache()
    bctx = make_context(mod_t_params(**BGV, scheme="bgv"))
    _, rlk, a, b, *_ = make_mod_t_inputs(bctx, SEED, dev)
    ref = bgv32.build_bgv32(bctx, rlk)(a, b)
    p = bgv32.build_bgv32(bctx, rlk, engine=pp.ROLL_ENGINE)
    got = _count(wrappers, "BGV step, pallas-roll", lambda: p(a, b),
                 launches)
    if not (torch.equal(got, ref) and torch.equal(p(a, b, pp.PLAIN), ref)):
        raise RuntimeError("BGV step, pallas-roll: differs from the default "
                           "engine or from its plain path")
    print(f"BGV step, pallas-roll: bit-equal to the default engine and to "
          f"its plain path {tuple(got.shape)}; "
          f"{_time(lambda: p(a, b), REPS):.3f} ms/step [{card}]")
    del bctx, rlk, a, b, ref, p, got
    torch.cuda.empty_cache()
    for scheme in ("ckks", "bgv"):
        prm = (chain_params(**HEADLINE) if scheme == "ckks"
               else mod_t_params(**BGV, scheme="bgv"))
        c = make_context(prm)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 40)
        sk = keys.gen_secret_key(c, gen)
        rlk = keys.gen_relin_key(c, sk, gen)
        glk = keys.create_galois_keys(c, sk, gen, steps=[1])
        evs = {e: Fast32(c, rlk=rlk, glk=glk, engine=e)
               for e in (pp.DEFAULT_ENGINE, pp.ROLL_ENGINE)}
        rng = np.random.default_rng(SEED + 40)
        m1, m2 = (rng.integers(-3, 4, prm.n) for _ in range(2))
        plain = ((lambda m: encode_coeffs(c, m, DELTA_BITS))
                 if scheme == "ckks" else
                 (lambda m: torch.as_tensor(m, device=dev)))
        x, y = (Ciphertext(data=keys.encrypt_symmetric(c, sk, plain(m), gen),
                           chain_index=1, is_ntt_form=True,
                           scale=(2.0 ** DELTA_BITS if scheme == "ckks"
                                  else 1.0)) for m in (m1, m2))
        mr = {e: ev.multiply_and_relin(x, y) for e, ev in evs.items()}
        verbs = [("multiply_and_relin", lambda ev: ev.multiply_and_relin(
            x, y)), ("rotate", lambda ev: ev.rotate(x, 1))]
        verbs.append(("rescale_to_next", lambda ev: ev.rescale_to_next(
            mr[pp.DEFAULT_ENGINE])) if scheme == "ckks" else
            ("mod_switch_to_next", lambda ev: ev.mod_switch_to_next(
                mr[pp.DEFAULT_ENGINE])))
        for verb, fn in verbs:
            evs[pp.ROLL_ENGINE].prebuild(x.chain_index)
            got = _count(wrappers, f"Fast32 roll {scheme.upper()} {verb}",
                         lambda: fn(evs[pp.ROLL_ENGINE]), launches)
            want = fn(evs[pp.DEFAULT_ENGINE])
            if not _same(got, want):
                raise RuntimeError(f"Fast32 roll {scheme} {verb}: differs "
                                   "from the default engine")
            print(f"Fast32 {scheme.upper()} {verb} on pallas-roll: bit-equal "
                  f"to the default engine; "
                  f"{_time(lambda: fn(evs[pp.ROLL_ENGINE]), REPS):.3f} ms "
                  f"[{card}]")
        del c, sk, rlk, glk, evs, x, y, mr
        torch.cuda.empty_cache()


U64_COUNTED = {"U1": "ptk_u64_ntt_launches", "U2": "ptk_u64_bconv_launches",
               "U4": "ptk_u64_polyops_launches"}


def _u64_library_launches():
    """{U1, U2, U4: the kernel launches their C entry points have made}."""
    from phantom_tpu_torch import _build
    lib = _build.library()
    return {name: getattr(lib, fn)() for name, fn in U64_COUNTED.items()}


def _u64_per_call(before, after, wrappers, what: str) -> dict:
    """{U1, U2, U4: kernel launches a wrapper call} over a counted run: the
    launches their entry points made between `before` and `after`
    (_u64_library_launches) over the wrapper's launch count.  The smoke
    fails unless each is 1."""
    got = {}
    for (name, *_), w in zip(U64_KERNELS, wrappers):
        if name not in U64_COUNTED:
            continue
        got[name] = (after[name] - before[name]) / max(w.launches, 1)
        print(f"launches per call, {what}, {name}: {got[name]:g} kernel "
              f"launches a call ({w.launches} calls)")
    if any(k != 1 for k in got.values()):
        raise RuntimeError(f"{what}: U1 / U2 / U4 not one launch a call: "
                           f"{got}")
    return got


def _u64_phases(card, launches64, dev, lib, calls: bool = False):
    """Phases 41-44: the u64 golden files through U1-U4 on the card; the
    u64 CKKS and BGV steps at bench.py --path u64 width (keygen and
    encryption on the card, every U call under a probe, the launch
    counts, kernel path bit-equal to plain path, decryption, chained
    timing, profile, U1's, U2's and U4's kernel launches per call).  With
    `calls` (--calls) without the SASS, the golden files and the plain
    step's timing.  Returns the probes and U1's, U2's and U4's kernels
    per call."""
    import torch
    from phantom_tpu_torch import BatchEncoder, CKKSEncoder, make_context
    from phantom_tpu_torch.schemes import evaluate as ev
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes import keyswitch as ksw
    if not calls:
        imads, found = {}, set()
        for fn, counts in sass_by_function(lib, "ptk64", ("IMAD",)).items():
            key = _kernel_key(fn, U64_NEW_KERNELS)
            found.add(key and key.split("<")[0])
            imads[key or fn.split("(")[0][-40:]] = sum(counts.values())
        print("sass: IMAD instructions per U kernel function: " + ", ".join(
            f"{k} {v}" for k, v in imads.items()) + f"; the bounds count a "
            f"64x64 product's high word as {MUL_HI} and its low word as "
            f"{MUL_LO} 32-bit multiplies")
        absent = [k for k in U64_NEW_KERNELS if k not in found]
        if absent:
            raise RuntimeError(f"sass: no function of {absent} under ptk64")
        for fname in U64_GOLDEN:
            t0 = time.time()
            held = u64_golden(dev, fname)
            print(f"golden: {fname}: {held} outputs through U1-U4 bit-equal "
                  f"to the JAX package's ({time.time() - t0:.1f} s)")
        print(f"golden: {U64_MXN}: {u64_mxn_golden(dev)} products through "
              "U4's mxn form bit-equal to the JAX package's tensor_prod_mxn")
        for fname in U64_BFV_GOLDEN:
            t0 = time.time()
            held = u64_bfv_golden(dev, fname)
            print(f"golden: {fname}: {held} outputs through U1-U4 bit-equal "
                  f"to the JAX package's ({time.time() - t0:.1f} s)")
    wrappers = kernel_wrappers64()
    probes = _probes64(U64_REPS)
    since, per_call = {}, {}
    for scheme in ("ckks", "bgv"):
        torch.cuda.empty_cache()
        t0 = time.time()
        prm = (chain_params(**U64_CFG) if scheme == "ckks" else
               mod_t_params(**U64_CFG, scheme="bgv"))
        ctx = make_context(prm)
        torch.cuda.synchronize()
        t_ctx = time.time() - t0
        if t_ctx > 30:
            raise RuntimeError(f"u64 context build {t_ctx:.1f} s > 30 s")
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 64)
        t0 = time.time()
        sk = keys.gen_secret_key64(ctx, gen)
        pk = keys.gen_public_key64(ctx, sk, gen)
        rlk = _count64(wrappers, f"u64 {scheme.upper()} gen_relin_key",
                       lambda: keys.gen_relin_key64(ctx, sk, gen),
                       launches64)
        rng = np.random.default_rng(SEED + 64)
        n = prm.n
        if scheme == "ckks":
            enc = CKKSEncoder(ctx)
            z = [rng.uniform(-1, 1, enc.slots) + 1j * rng.uniform(
                -1, 1, enc.slots) for _ in range(2)]
            pts = [enc.encode(v, 2.0 ** U64_SCALE_BITS) for v in z]
        else:
            enc = BatchEncoder(ctx)
            t = prm.plain_modulus
            z = [rng.integers(0, t, n) for _ in range(2)]
            pts = [enc.encode(v) for v in z]
        c1 = _count64(wrappers, f"u64 {scheme.upper()} encrypt_asymmetric",
                      lambda: keys.encrypt_asymmetric64(ctx, pk, pts[0],
                                                        gen), launches64)
        c2 = keys.encrypt_asymmetric64(ctx, pk, pts[1], gen)
        torch.cuda.synchronize()
        print(f"u64 {scheme.upper()} setup: N={n} L={prm.size_q} "
              f"alpha={prm.size_p} ({max(prm.data_moduli).bit_length()}-bit "
              f"data, {max(prm.special_moduli).bit_length()}-bit special "
              f"primes); context {t_ctx:.1f} s, keys and encryptions on the "
              f"card {time.time() - t0:.1f} s")

        def step(a, b, ops):
            m = ev.multiply_and_relin(ctx, a, b, rlk, ops)
            if scheme == "ckks":
                return ev.rescale_to_next(ctx, m, ops)
            return ev.mod_switch_to_next(ctx, m, ops)

        step(c1, c2, probes)
        _print_calls64(probes, card, since)
        before = _u64_library_launches()
        what = f"u64 {scheme.upper()} step"
        out = _count64(wrappers, what, lambda: step(c1, c2, ksw.KERNELS64),
                       launches64)
        got = _u64_per_call(before, _u64_library_launches(), wrappers, what)
        if scheme == "ckks":
            per_call = got
        ref = step(c1, c2, ksw.PLAIN64)
        if not _same(out, ref):
            raise RuntimeError(f"u64 {scheme} step: kernel path differs "
                               "from the plain path")
        dec = keys.decrypt64(ctx, sk, out)
        if scheme == "ckks":
            got = enc.decode(dec)
            err = float(np.abs(got - z[0] * z[1]).max())
            print(f"u64 CKKS step: kernel path bit-equal to the plain path "
                  f"{tuple(out.data.shape)}; decoded slots within {err:.3e} "
                  f"of numpy's float64 product (bound {U64_TOL})")
            if not err <= U64_TOL:
                raise RuntimeError(f"u64 CKKS step: error {err} > {U64_TOL}")
        else:
            got = enc.decode(dec).astype(np.int64)
            want = z[0] * z[1] % t
            right = int((got == want).sum())
            print(f"u64 BGV step: kernel path bit-equal to the plain path "
                  f"{tuple(out.data.shape)}; decrypts right in {right} of "
                  f"{n} slots (correction factor {out.correction_factor})")
            if right != n:
                raise RuntimeError("u64 BGV step: wrong decryption")
        zero = torch.zeros_like(out.data[:, :1])

        def chain(route):
            ops = ksw.PLAIN64 if route == "plain path" else ksw.KERNELS64

            def run(steps):
                d = c1
                for _ in range(steps):
                    o = step(d, c2, ops)
                    d = o.replace(data=torch.cat([o.data, zero], dim=1),
                                  chain_index=1, scale=c1.scale,
                                  correction_factor=1)
                return d
            return run

        _chain_timing(("kernel path",), chain, U64_CHAIN_STEPS, card,
                      f"u64 {scheme.upper()} step")
        if not calls:
            print(f"timing u64 {scheme.upper()} step, plain path: "
                  f"{_time(lambda: step(c1, c2, ksw.PLAIN64), 1):.1f} ms/op "
                  f"(one step after a warm-up) [{card}]")
        dd = [c1]

        def prof():
            o = step(dd[0], c2, ksw.KERNELS64)
            dd[0] = o.replace(data=torch.cat([o.data, zero], dim=1),
                              chain_index=1, scale=c1.scale,
                              correction_factor=1)
        _profile(prof, PROFILE_STEPS, card, f"u64 {scheme.upper()} step",
                 lambda: sum(w.launches for w in wrappers))
        del ctx, sk, pk, rlk, c1, c2, out, ref, dec, dd, pts
    return probes, per_call


U64_BFV_CFG = dict(n=1 << 16, limbs=31, alpha=22, bits=50)
U64_BFV_TIMED = ("hps", "behz", "hps_overq", "hps_overq_leveled")
# operands of noise_scale_deg 3: at U64_BFV_CFG the noise model drops one
# level there
U64_BFV_DROP_DEG = 3


def _u64_bfv_phases(card, probes, launches64, dev, calls: bool = False):
    """Phases 44-47: BFV on the u64 evaluator at bench.py --scheme bfv
    --path u64 --limbs 31 width, one context per mul_tech: keygen and two
    asymmetric encryptions of random slot vectors on the card, then
    multiply_and_relin (as bench.py chains it: the first operand's data
    replaced by the output, its metadata kept) with every U call under
    `probes`, the launch counts (EXPECTED64) and U1's, U2's and U4's
    kernel launches per call, the kernel path bit-equal to the plain path,
    the decryption in every slot, the noise budget, chained timing and a
    profile (device-busy, idle share, aten kernels by name, peak memory);
    leveled also a product of operands of noise_scale_deg 3, which drops a
    level, checked and decrypted over that level.  With `calls` no plain
    step's timing."""
    import torch
    from phantom_tpu_torch import BatchEncoder, make_context
    from phantom_tpu_torch.host.noise import find_levels_to_drop
    from phantom_tpu_torch.schemes import evaluate as ev
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes import keyswitch as ksw
    wrappers = kernel_wrappers64()
    since = {}
    for tech in U64_BFV_TIMED:
        torch.cuda.empty_cache()
        t0 = time.time()
        prm = mod_t_params(**U64_BFV_CFG, mul_tech=tech)
        ctx = make_context(prm)
        torch.cuda.synchronize()
        t_ctx = time.time() - t0
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 65)
        t0 = time.time()
        sk = keys.gen_secret_key64(ctx, gen)
        pk = keys.gen_public_key64(ctx, sk, gen)
        rlk = _count64(wrappers, "u64 BFV gen_relin_key",
                       lambda: keys.gen_relin_key64(ctx, sk, gen),
                       launches64)
        rng = np.random.default_rng(SEED + 65)
        n, t = prm.n, prm.plain_modulus
        enc = BatchEncoder(ctx)
        z = [rng.integers(0, t, n) for _ in range(2)]
        c1 = _count64(wrappers, "u64 BFV encrypt_asymmetric",
                      lambda: keys.encrypt_asymmetric64(
                          ctx, pk, enc.encode(z[0]), gen), launches64)
        c2 = keys.encrypt_asymmetric64(ctx, pk, enc.encode(z[1]), gen)
        torch.cuda.synchronize()
        label = f"u64 BFV {tech}"
        print(f"{label} setup: N={n} L={prm.size_q} alpha={prm.size_p} "
              f"({max(prm.data_moduli).bit_length()}-bit data, "
              f"{max(prm.special_moduli).bit_length()}-bit special, "
              f"{max(ctx.rl_moduli).bit_length()}-bit Rl"
              + (f", {max(ctx.bsk_moduli).bit_length()}-bit Bsk primes"
                 if ctx.bsk_moduli else " primes") + f", t={t}); context "
              f"{t_ctx:.1f} s, keys and encryptions on the card "
              f"{time.time() - t0:.1f} s")

        def step(a, b, ops):
            return ev.multiply_and_relin(ctx, a, b, rlk, ops)

        step(c1, c2, probes)
        _print_calls64(probes, card, since)
        before = _u64_library_launches()
        what = f"{label} step"
        out = _count64(wrappers, what, lambda: step(c1, c2, ksw.KERNELS64),
                       launches64)
        _u64_per_call(before, _u64_library_launches(), wrappers, what)
        if not _same(out, step(c1, c2, ksw.PLAIN64)):
            raise RuntimeError(f"{what}: kernel path differs from the plain "
                               "path")
        want = z[0] * z[1] % t
        got = enc.decode(keys.decrypt64(ctx, sk, out)).astype(np.int64)
        right = int((got == want).sum())
        budget = keys.invariant_noise_budget64(ctx, sk, out)
        print(f"{what}: kernel path bit-equal to the plain path "
              f"{tuple(out.data.shape)}; decrypts right in {right} of {n} "
              f"slots; noise budget {budget} bits (fresh "
              f"{keys.invariant_noise_budget64(ctx, sk, c1)})")
        if right != n:
            raise RuntimeError(f"{what}: wrong decryption")
        if tech == "hps_overq_leveled":
            deep = c1.replace(noise_scale_deg=U64_BFV_DROP_DEG)
            lvl = find_levels_to_drop(
                n, prm.size_q, prm.size_p,
                len(ctx.get_context_data(1).ks.digit_convs), t,
                U64_BFV_CFG["bits"], U64_BFV_DROP_DEG - 1, False, True)
            dwhat = f"{what}, drop {lvl}"
            d_out = _count64(wrappers, dwhat, lambda: step(
                deep, c2, ksw.KERNELS64), launches64)
            if not _same(d_out, step(deep, c2, ksw.PLAIN64)):
                raise RuntimeError(f"{dwhat}: kernel path differs from the "
                                   "plain path")
            low = d_out.replace(
                data=d_out.data[:, :prm.size_q - lvl].contiguous(),
                chain_index=1 + lvl)
            got = enc.decode(keys.decrypt64(ctx, sk, low)).astype(np.int64)
            right = int((got == want).sum())
            print(f"{dwhat}: kernel path bit-equal to the plain path "
                  f"{tuple(d_out.data.shape)}; decrypts right over its "
                  f"{prm.size_q - lvl} primes in {right} of {n} slots")
            if right != n:
                raise RuntimeError(f"{dwhat}: wrong decryption")
            del deep, d_out, low

        def chain(route):
            ops = ksw.PLAIN64 if route == "plain path" else ksw.KERNELS64

            def run(steps):
                d = c1
                for _ in range(steps):
                    d = d.replace(data=step(d, c2, ops).data)
                return d
            return run

        _chain_timing(("kernel path",), chain, U64_CHAIN_STEPS, card, what)
        if not calls:
            print(f"timing {what}, plain path: "
                  f"{_time(lambda: step(c1, c2, ksw.PLAIN64), 1):.1f} ms/op "
                  f"(one step after a warm-up) [{card}]")
        dd = [c1]

        def prof():
            dd[0] = dd[0].replace(data=step(dd[0], c2, ksw.KERNELS64).data)
        _profile(prof, PROFILE_STEPS, card, what,
                 lambda: sum(w.launches for w in wrappers))
        del ctx, sk, pk, rlk, c1, c2, out, dd
    return probes


# ---------------------------------------------------------------------------
# phases 48-50: the u64 application layer (F1's wide forms, the device
# encoder on the u64 evaluator's primes, LinearTransform.apply,
# poly_eval_cheb)
# ---------------------------------------------------------------------------

# The u64 MLP + Chebyshev circuit's scale: one of the rescale primes
# (U64_CFG's data primes have 50 bits).  poly_eval's power ladder keeps
# its scale only where the primes are close to it; at U64_SCALE_BITS = 44
# each rung would lose about 6 bits.
U64_MLP_SCALE_PRIME = 2  # the input's scale is q[L - 2]
F1_WIDE_BITS = (50, 61)  # the wide forms' primes, alone at full width
EXPECTED_APP64 = {  # the u64 circuit's stages: U1-U4 and F1 launches
    # the wide encode form, U1 over the level's 43 rows
    "u64 MLP encode": dict(U1=1, U2=0, U3=0, U4=0, F1=1),
    # d = 64 (bs 8, gs 8) at chain index 1 (k = 43, not a multiple of 22:
    # the unfused modup, 2 digits): ONE modup (U1 x2, U2 x2) shared by the
    # 8 groups; per group U3 for each of its 7 rotated baby steps, U4 twice
    # a step (the QlP and c0 sums' fma; step 0: c0 and c1), one moddown
    # pair (U1 x4, U2 x2, U4 x2); 7 giant rotations (U1 x6, U2 x4, U3, U4
    # x2 each); the adds plain; the rescale (U1 x2, U4 x2).  A modup per
    # group would add U1 x14 and U2 x14.
    "u64 MLP layer 1": dict(U1=78, U2=46, U3=63, U4=160, F1=0),
    # square (U4), relinearize (U1 x6, U2 x4, U3, U4 x2), rescale (U1 x2,
    # U4 x2)
    "u64 MLP square": dict(U1=8, U2=4, U3=1, U4=5, F1=0),
    # the banded layer at chain index 3: 4 groups of 8 diagonals (28
    # rotated baby steps), 3 giant rotations (steps 8, 48, 56), one modup
    "u64 MLP layer 2": dict(U1=38, U2=22, U3=31, U4=80, F1=0),
    # poly_eval_cheb of degree 15 with the interval map and the final
    # rescale: 7 products (square or multiply, relinearize), 9 rescales,
    # the constants through the host encoder (U1 each over their level)
    "u64 MLP activation": dict(U1=81, U2=28, U3=7, U4=53, F1=0),
    # U1's inverse of two limbs, the wide decode form
    "u64 MLP decode": dict(U1=1, U2=0, U3=0, U4=0, F1=1),
}


def _count_app64(wrappers64, what: str, fn, launches: dict,
                 launches64: dict):
    """_count64 with F1 beside U1-U4, against EXPECTED_APP64[what]; U1-U4
    add to launches64, F1 to launches."""
    from phantom_tpu_torch.ops import ckks_fft as cf
    out, got, _ = _count_named(_named64(wrappers64) + [("F1", cf.ckks_fft)],
                               what, fn, EXPECTED_APP64.get(what))
    for k, v in got.items():
        if k == "F1":
            launches["F1"] += v
        else:
            launches64[k] += v
    return out


def _f1_wide_inputs(dev, n: int, bits: int, k: int, seed: int):
    """Seeded inputs of F1's wide forms at N = n over k primes of `bits`
    bits: the slots in the unit disc and the scale that brings the
    largest coefficient near 2^61 (2^61 / max |slot| for 61-bit primes,
    else 2^50), the moduli (k,) int64, and two limbs of centered values
    up to 2^62 of both signs, their residues mod the first two primes."""
    import torch
    from phantom_tpu_torch.host import numth
    rng = np.random.default_rng(seed)
    moduli = numth.get_primes(2 * n, bits, k)
    z = unit_disc(rng, n // 2)
    scale = 2.0 ** 61 if bits > 60 else 2.0 ** 50
    m = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    m[:4] = [(1 << 62) - 1, -(1 << 62) + 1, 0, -1]
    mt = torch.from_numpy(m)
    limbs = torch.stack([torch.remainder(mt, q) for q in moduli[:2]])
    return dict(z=torch.from_numpy(z.view(np.float64).reshape(-1, 2)).to(
        dev), scale=scale, q=torch.tensor(moduli, dtype=torch.int64,
                                          device=dev),
        limbs=limbs.to(dev), moduli=moduli[:2])


def _f1_wide_phase(card, probes64, dev) -> None:
    """Phase 48: F1's wide forms alone at N = 2^16 under the probes
    (bit-equal to their plain versions, event and device times, bound),
    over U64_CFG's 43 primes of 50 bits and over 43 of 61 bits (the
    encode form's coefficients near 2^61 there; the decode form on
    centered values up to 2^62, one limb and two), their CUDA launches
    and blocks, and a decode of uniform residues that does not raise."""
    import torch
    from phantom_tpu_torch.ops import ckks_fft as cf
    n, k = U64_CFG["n"], U64_CFG["limbs"]
    t = cf.make_fft_tables(n, dev)
    for bits in F1_WIDE_BITS:
        a = _f1_wide_inputs(dev, n, bits, k, SEED + 48 + bits)
        probes64.ckks_fft_encode(a["z"], a["scale"], a["q"], t)
        probes64.ckks_fft_decode(a["limbs"], a["moduli"], 2.0 ** 40, t)
        probes64.ckks_fft_decode(a["limbs"][:1].contiguous(),
                                 a["moduli"][:1], 2.0 ** 40, t)
        fe = probes64.ckks_fft_encode.calls[-1]
        for c, what in ((fe, f"encode form, {k} primes"),
                        (probes64.ckks_fft_decode.calls[-2],
                         "decode form, 2 limbs"),
                        (probes64.ckks_fft_decode.calls[-1],
                         "decode form, 1 limb")):
            print(f"F1 wide {what} of {bits} bits, N = {n}: bit-equal to "
                  f"plain; {c['ms']:.5f} ms (device {c['dev_ms']:.5f}, "
                  f"{c['dev_ms'] / c['bound_ms']:.1f}x its bound "
                  f"{c['bound_ms']:.5f} ms by {c['bound_by']}: "
                  f"{c['bytes'] / 1e6:.1f} MB, {c['f32_ops'] / 1e6:.1f} M "
                  f"f32, {c['ops'] / 1e6:.1f} M mul) vs plain "
                  f"{c['plain_ms']:.3f} ms [{card}]")
    forms = {
        "encode64": lambda: cf.ckks_fft_encode64(a["z"], a["scale"], a["q"],
                                                 t),
        "decode64": lambda: cf.ckks_fft_decode64(a["limbs"], a["moduli"],
                                                 2.0 ** 40, t)}
    for what, fn in forms.items():
        blocks = f1_grids(fn)
        print(f"F1 {what}, N = {n}: {len(blocks)} CUDA launches a call, "
              f"blocks {blocks} (ptk_ckks_fft_grids)")
        if len(blocks) != 2 or min(blocks) <= 32:
            raise RuntimeError(f"F1 {what}: {len(blocks)} launches, blocks "
                               f"{blocks}")
    q = a["q"][:2].view(-1, 1)
    junk = torch.randint(0, 1 << 62, (2, n), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED)) % q
    out = cf.ckks_fft_decode64(junk, a["moduli"], 2.0 ** 40, t)
    torch.cuda.synchronize()
    print(f"F1 wide decode form of uniform residues: {out.shape[0]} slots, "
          f"{int(torch.isfinite(out).all(dim=1).sum())} finite")


def _u64_app_golden(dev) -> None:
    """Phase 49: the wide device encoder's golden file (bit-equal to the
    JAX package's eager evaluation) and the u64 application layer's
    (LinearTransform.apply, poly_eval, poly_eval_cheb) through U1-U4 and
    F1's wide forms."""
    got = wide_encoder_golden(dev)
    for name, (a, b) in got.items():
        if not np.array_equal(a, b):
            raise RuntimeError(f"golden {WIDE_FFT_GOLDEN}: {name} differs "
                               "from the JAX package's")
    print(f"golden: {WIDE_FFT_GOLDEN}: {len(got)} outputs of the wide "
          "device encoder (40- and 50-bit primes, one and five limbs) "
          "bit-equal to the JAX package's eager evaluation")
    for fname, fn in zip(U64_APP_GOLDEN, (u64_linear_golden,
                                          u64_poly_golden)):
        t0 = time.time()
        print(f"golden: {fname}: {fn(dev)} outputs through U1-U4 bit-equal "
              f"to the JAX package's ({time.time() - t0:.1f} s)")


def _u64_mlp_phase(card, launches, launches64, dev) -> float:
    """Phase 50: the MLP + Chebyshev circuit of phase 36 on the u64
    evaluator at U64_CFG width (N = 2^16, 43 data primes of 50 bits, 22
    special of 51, dnum 2): keys on the card, a dense LinearTransform (d
    = 64, bs 8, gs 8, 14 Galois keys) at chain index 1, square +
    relinearize + rescale, the banded one at chain index 3,
    poly_eval_cheb of degree MLP_DEGREE on MLP_INTERVAL, the final
    rescale; the input and output through the wide CKKSDeviceEncoder,
    the weights and poly_eval_cheb's constants through the host encoder
    (some constants are encoded at the square of the scale, past the
    device encoder's 2^62).  The input's scale is the prime
    q[L - U64_MLP_SCALE_PRIME], about 2^50: the power ladder keeps its
    scale only where the primes are close to it.  Each stage's launch
    counts (EXPECTED_APP64) and event time; one modup a layer, counted;
    the whole circuit once more on PLAIN64 from the same plaintext and
    generator state, bit-equal; the decoded output within MLP_TOL of
    numpy's float64 evaluation; a profile and peak memory.  Returns the
    error."""
    import torch
    from numpy.polynomial import chebyshev as C
    from phantom_tpu_torch import (CKKSDeviceEncoder, CKKSEncoder,
                                   LinearTransform, chebyshev_fit,
                                   make_context, poly_eval_cheb)
    from phantom_tpu_torch.schemes import evaluate as ev
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes import keyswitch as ksw
    from phantom_tpu_torch.ops import ckks_fft as cf
    from phantom_tpu_torch.schemes import linear
    wrappers64 = kernel_wrappers64()
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    prm = chain_params(**U64_CFG)
    ctx = make_context(prm)
    gen = torch.Generator(device=dev).manual_seed(SEED + 66)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    rlk = keys.gen_relin_key64(ctx, sk, gen)
    w1, w2, x = mlp_weights(MLP_D, MLP_BAND, SEED + 33)
    h2 = w2 @ (w1 @ x) ** 2
    lt1, lt2 = LinearTransform(w1), LinearTransform(w2)
    steps = sorted(set(lt1.steps_required()) | set(lt2.steps_required()))
    glk = keys.create_galois_keys64(ctx, sk, gen, steps=steps)
    enc, host = CKKSDeviceEncoder(ctx), CKKSEncoder(ctx)
    q = prm.data_moduli
    L = prm.size_q
    s_in = float(q[L - U64_MLP_SCALE_PRIME])
    torch.cuda.synchronize()
    key_s = time.time() - t0
    # layer 1's weights at the prime its rescale drops (chain index 1),
    # layer 2's likewise at chain index 3: the scale stays s_in
    for lt, ci in ((lt1, 1), (lt2, 3)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lt.prepare(host, float(ctx.get_context_data(ci).moduli[-1]), ci)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        nd = sum(len(st) for _, st, _ in lt.groups)
        size = sum(w.numel() * 8 for grp in lt._prepared[ci] for w in grp)
        print(f"u64 MLP prepare (host encode_extended over QlP) at chain "
              f"index {ci}: {nd} diagonals in {ms:.0f} ms, "
              f"{size / 2**30:.2f} GiB of weights [{card}]")
    print(f"u64 MLP setup: N={prm.n} L={L} alpha={prm.size_p} "
          f"({max(q).bit_length()}-bit data, "
          f"{max(prm.special_moduli).bit_length()}-bit special primes), "
          f"d={MLP_D} (bs {lt1.bs}, gs {lt1.gs}), layer 2 "
          f"{sum(len(st) for _, st, _ in lt2.groups)} of {MLP_D} diagonals; "
          f"{len(steps)} Galois keys; scale q[L-{U64_MLP_SCALE_PRIME}] = "
          f"2^{np.log2(s_in):.4f}; keys on the card {key_s:.1f} s")
    cc = chebyshev_fit(sigmoid, MLP_DEGREE, MLP_INTERVAL)
    tiled = np.tile(x, enc.slots // MLP_D)
    times = []

    def stage(name, fn, reps=REPS):
        out = _count_app64(wrappers64, f"u64 MLP {name}",
                           lambda: fn(ksw.KERNELS64), launches, launches64)
        times.append((name, _time(lambda: fn(ksw.KERNELS64), reps)))
        return out

    def activation(v, ops):
        return ev.rescale_to_next(ctx, poly_eval_cheb(
            ctx, v, cc, rlk, host, interval=MLP_INTERVAL, ops=ops), ops)

    state = gen.get_state()
    pt = stage("encode", lambda ops: enc.encode(tiled, s_in, ops=ops))
    ct = keys.encrypt_asymmetric64(ctx, pk, pt, gen)
    h = stage("layer 1", lambda ops: lt1.apply(ctx, ct, glk, ops=ops), 3)
    h1 = stage("square", lambda ops: ev.rescale_to_next(ctx, ev.relinearize(
        ctx, ev.square(ctx, h, ops), rlk, ops), ops))
    h = stage("layer 2", lambda ops: lt2.apply(ctx, h1, glk, ops=ops), 3)
    y = stage("activation", lambda ops: activation(h, ops), 3)
    dec = keys.decrypt64(ctx, sk, y)
    got = stage("decode", lambda ops: enc.decode(dec, ops))
    print("u64 MLP circuit: " + ", ".join(f"{nm} {ms:.3f} ms"
                                          for nm, ms in times)
          + f"; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    # the whole circuit once more on the plain path, the same draws
    after = gen.get_state()
    gen.set_state(state)
    t0 = time.time()
    p_ = ksw.PLAIN64
    v = keys.encrypt_asymmetric64(ctx, pk, enc.encode(tiled, s_in, ops=p_),
                                  gen, p_)
    v = lt1.apply(ctx, v, glk, ops=p_)
    v = ev.rescale_to_next(ctx, ev.relinearize(ctx, ev.square(ctx, v, p_),
                                               rlk, p_), p_)
    v = activation(lt2.apply(ctx, v, glk, ops=p_), p_)
    plain_got = enc.decode(keys.decrypt64(ctx, sk, v, p_), p_)
    plain_s = time.time() - t0
    gen.set_state(after)
    if not (_same(v, y) and np.array_equal(plain_got, got)):
        raise RuntimeError("u64 MLP circuit: the plain path's final "
                           "ciphertext or output differs from the kernel "
                           "path's")
    modups = [0]
    real = ksw.modup_from_ntt

    def counted(*a, **kw):
        modups[0] += 1
        return real(*a, **kw)

    ksw.modup_from_ntt = linear.modup_from_ntt = counted
    try:
        lt1.apply(ctx, ct, glk)
        m1 = modups[0]
        lt2.apply(ctx, h1, glk)
    finally:
        ksw.modup_from_ntt = linear.modup_from_ntt = real
    m2 = modups[0] - m1
    g1 = sum(1 for g, *_ in lt1.groups if g)
    g2 = sum(1 for g, *_ in lt2.groups if g)
    print(f"u64 MLP modups: layer 1 {m1} (1 shared by its "
          f"{len(lt1.groups)} groups + {g1} giant rotations), layer 2 {m2} "
          f"(1 shared by {len(lt2.groups)} groups + {g2})")
    if (m1, m2) != (1 + g1, 1 + g2):
        raise RuntimeError("u64 MLP: not one modup per layer")
    a, b = MLP_INTERVAL
    want = np.tile(C.chebval((2 * h2 - (a + b)) / (b - a), cc),
                   enc.slots // MLP_D)
    err = float(np.abs(got - want).max())
    print(f"u64 MLP circuit: kernel path bit-equal to the plain path (the "
          f"whole circuit, {plain_s:.1f} s) on the final ciphertext (chain "
          f"index {y.chain_index}, scale 2^{np.log2(y.scale):.4f}) and the "
          f"decoded output; decoded slots within {err:.3e} of numpy's "
          f"float64 evaluation (bound {MLP_TOL})")

    def run():
        v = keys.encrypt_asymmetric64(ctx, pk, enc.encode(tiled, s_in), gen)
        v = lt1.apply(ctx, v, glk)
        v = ev.rescale_to_next(ctx, ev.relinearize(ctx, ev.square(ctx, v),
                                                   rlk))
        v = activation(lt2.apply(ctx, v, glk), ksw.KERNELS64)
        return enc.decode(keys.decrypt64(ctx, sk, v))

    print(f"timing u64 MLP circuit end to end (encode to decode): "
          f"{_time(run, 3):.3f} ms [{card}]")
    # U1-U4 launch one kernel a call, F1 two at N = 2^16
    _profile(run, 2, card, "u64 MLP circuit, encode to decode",
             lambda: sum(w.launches for w in wrappers64)
             + 2 * cf.ckks_fft.launches)
    print(f"u64 MLP circuit: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if not err <= MLP_TOL:
        raise RuntimeError(f"u64 MLP circuit: error {err} > {MLP_TOL}")
    return err


def _u64_app_phases(card, probes64, launches, launches64, dev) -> None:
    """Phases 48-50."""
    import torch
    _f1_wide_phase(card, probes64, dev)
    _u64_app_golden(dev)
    torch.cuda.empty_cache()
    _u64_mlp_phase(card, launches, launches64, dev)
    torch.cuda.empty_cache()


# S1, the reference's Salsa20 sampler (phases 51-52)
S1_SOURCE = "phantom_tpu_torch/csrc/salsa20.cu"
S1_REPLACES = ("phantom_tpu/native/host_math.cpp:252, :292, :308 and "
               "phantom_tpu/utils/salsa20.py:146, :111, :126 (host "
               "sampler, no pallas_call)")
# 32-bit integer operations of one keystream block: 10 double rounds of 32
# quarter-round steps (add, funnel shift, xor), then 16 adds; priced at
# INT_MULS_PER_S, the INT32 pipe's rate (64 lanes an SM a clock, as IMAD)
S1_BLOCK_OPS = 10 * 32 * 3 + 16
# per uniform lane: its 64-bit comparison (2) and barrett64 with the
# conditional subtraction (2); per ternary or error coefficient its value
# (mod 3, or six popcounts and their sum), then one select a limb
S1_LANE_OPS = 2 + BARRETT64_OPS + 2
S1_VALUE_OPS = {"ternary": 4, "error": 12}
S1_REPS = 10
WIRE_STEPS = (1,)  # the wire path's Galois key
EXEC_ITEMS, EXEC_BATCH = 10, 4  # phase 53: two full batches and a tail of 2
# S1's launches on the wire path (phase 52): the client's two seeded
# encryptions and the server's two loads; the port's PTCS encryption and
# load; the BFV seeded encryption and load
EXPECTED_S1_WIRE = 8
EXAMPLES = ("serialization", "kernel_fusing")
EXEC_WHAT = f"StreamExecutor, {EXEC_ITEMS} headline steps"
EXPECTED[EXEC_WHAT] = {k: v * EXEC_ITEMS
                       for k, v in EXPECTED["headline step"].items()}


def _s1_work(form: str, num_l: int, n: int, blocks: int):
    """(bytes, 32-bit integer operations) of one S1 call: the (L, N)
    words written once and the moduli read once; the uniform form's
    blocks (retries included, as this call's data needs them) and lanes,
    the other forms' N blocks and values and a select a word."""
    byt = 8 * num_l * n + 16 * num_l
    if form == "uniform":
        return byt, blocks * S1_BLOCK_OPS + num_l * n * S1_LANE_OPS
    return byt, n * (S1_BLOCK_OPS + S1_VALUE_OPS[form]) + num_l * n


class _S1Probe:
    """S1 under a probe: the kernel against its plain version on the same
    seed and moduli (bit-equal), event and device time, the plain
    version's time and the bound (_s1_work, the plain version's count of
    blocks)."""

    name = "S1"

    def __init__(self, reps: int):
        self.reps = reps
        self.calls = []

    def __call__(self, form: str, seed: bytes, mv, n: int, what: str):
        import torch
        from phantom_tpu_torch.utils import salsa20
        out = salsa20.sample(form, seed, mv, n)
        stats = {}
        ref = salsa20.sample_plain(form, seed, mv, n, stats)
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        if err:
            raise RuntimeError(f"S1 {form} ({what}): kernel differs from "
                               f"plain: max_abs_err {err}")
        num_l = mv.q.shape[0]
        byt, ops = _s1_work(form, num_l, n, stats.get("blocks", n))
        b_ms, b_by = bound_ms(byt, ops)
        run = lambda: salsa20.sample(form, seed, mv, n)  # noqa: E731
        self.calls.append(dict(
            form=form, what=what, shape=(num_l, n), err=err, bound_ms=b_ms,
            bound_by=b_by, bytes=byt, ops=ops, tc_ops=0, f32_ops=0,
            tries=stats.get("tries", 1), dev_ms=_device_ms(run, self.reps),
            ms=_time(run, self.reps),
            plain_ms=_time(lambda: salsa20.sample_plain(form, seed, mv, n),
                           2)))
        return out


def _s1_phase(card, probe: _S1Probe, dev) -> None:
    """Phase 51: S1's three forms alone at N = 2^16 over 43 primes of 50
    bits (U64_CFG), of 28 bits (the headline chain) and of 61 bits that
    reject about one lane in nine, under the probe; then the golden
    file's samples (the JAX package's, n = 1024) through S1."""
    from phantom_tpu_torch.ops.rns_host import modulus_vec
    n = U64_CFG["n"]
    rng = np.random.default_rng(SEED + 51)
    seed = rng.bytes(64)
    for what, qs in (
            ("43 primes of 50 bits", chain_params(**U64_CFG).data_moduli),
            ("43 primes of 28 bits", chain_params(**HEADLINE).data_moduli),
            ("43 rejecting primes of 61 bits", rejecting_primes(n, 43))):
        mv = modulus_vec(qs, dev)
        for form in SALSA_FORMS:
            probe(form, seed, mv, n, what)
            c = probe.calls[-1]
            tries = f", chains to {c['tries']} tries" if form == "uniform" \
                else ""
            print(f"kernel S1 {form}, {what} {c['shape']}{tries}: bit-equal "
                  f"to plain; {c['ms']:.4f} ms (device {c['dev_ms']:.4f}) "
                  f"vs plain {c['plain_ms']:.4f} ms, bound "
                  f"{c['bound_ms']:.4f} ms by {c['bound_by']} "
                  f"({c['bytes'] / 1e6:.1f} MB, {c['ops'] / 1e9:.3f} G int "
                  f"ops) [{card}]")
    print(f"golden: {os.path.basename(REF_GOLDEN)}: {salsa_golden(dev)} "
          "samples (uniform, ternary, error at 28, 50 and 61 bits, n = "
          "1024) through S1 bit-equal to the JAX package's")


def _timed(times: dict, what: str, fn):
    """fn() with its host time (perf_counter to a synchronize) and its
    CUDA-event time, kept under `what`."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    times.setdefault(what, []).append(
        ((time.perf_counter() - t0) * 1e3, e0.elapsed_time(e1)))
    return out


def _round_trip(times: dict, what: str, save, load, obj,
                nbytes: dict) -> int:
    """save then load, each timed, the blob's bytes kept under both in
    `nbytes`; the loaded object bit-equal; returns the blob's bytes."""
    import io
    buf = io.BytesIO()
    _timed(times, f"save {what}", lambda: save(obj, buf))
    blob = buf.getvalue()
    nbytes[f"save {what}"] = nbytes[f"load {what}"] = len(blob)
    back = _timed(times, f"load {what}", lambda: load(io.BytesIO(blob)))
    if not _same(back, obj):
        raise RuntimeError(f"wire: {what} differs after its round trip")
    return len(blob)


def _wire_phase(card, dev) -> int:
    """Phase 52: the wire path at U64_CFG (CKKS, N = 2^16, 43 data primes
    of 50 bits, 22 special of 51): the keys made on the card through the
    reference format and back; a client's two seeded symmetric encryptions
    (S1, U1, U4) saved seed-compressed; the server's loads (S1 regenerates
    c1), multiply_and_relin + rescale_to_next (U1-U4) and its save; the
    client's load and decryption; every object through the port's own
    format, and a PTCS encryption; then at U64_BFV_CFG a seeded BFV
    ciphertext saved and loaded (S1, U1's inverse) and decrypted.  Each
    save and load timed.  Returns S1's launches on this path."""
    import io
    import torch
    from phantom_tpu_torch import BatchEncoder, CKKSEncoder, make_context
    from phantom_tpu_torch.schemes import evaluate as ev
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.utils import refformat as ref
    from phantom_tpu_torch.utils import salsa20
    from phantom_tpu_torch.utils import serialize as ser
    torch.cuda.empty_cache()
    t0 = time.time()
    prm = chain_params(**U64_CFG)
    ctx = make_context(prm)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 52)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    rlk = keys.gen_relin_key64(ctx, sk, gen)
    glk = keys.create_galois_keys64(ctx, sk, gen, steps=list(WIRE_STEPS))
    torch.cuda.synchronize()
    print(f"wire setup: N={prm.n} L={prm.size_q} alpha={prm.size_p} "
          f"(50-bit data, 51-bit special primes); keys on the card in "
          f"{time.time() - t0:.1f} s")
    times, sizes, nbytes = {}, {}, {}
    salsa20.sample.launches = 0
    for what, save, load, obj in (
            ("secret key", ref.save_secret_key_ref,
             lambda f: ref.load_secret_key_ref(f, dev), sk),
            ("public key", ref.save_public_key_ref,
             lambda f: ref.load_public_key_ref(f, dev), pk),
            ("relin key", ref.save_relin_key_ref,
             lambda f: ref.load_relin_key_ref(f, dev), rlk),
            ("Galois key", ref.save_galois_key_ref,
             lambda f: ref.load_galois_key_ref(f, glk.elts, dev), glk)):
        sizes[what] = _round_trip(times, what, save, load, obj, nbytes)
    print("wire: the keys through the reference format bit-equal: " + ", ".join(
        f"{k} {v / 2**20:.1f} MiB" for k, v in sizes.items()))
    # the client: two seeded encryptions, saved seed-compressed
    enc = CKKSEncoder(ctx)
    rng = np.random.default_rng(SEED + 52)
    z = [rng.uniform(-1, 1, enc.slots) + 1j * rng.uniform(-1, 1, enc.slots)
         for _ in range(2)]
    seeds = [rng.bytes(ref.SEED_BYTES) for _ in range(2)]
    pts = [enc.encode(v, 2.0 ** U64_SCALE_BITS) for v in z]
    cts = [_timed(times, "encrypt_symmetric_seeded",
                  lambda p=p, s=s: ref.encrypt_symmetric_seeded(
                      ctx, sk, p, s, gen)) for p, s in zip(pts, seeds)]
    blobs = []
    for ct, s in zip(cts, seeds):
        buf = io.BytesIO()
        _timed(times, "save seed-compressed ciphertext",
               lambda: ref.save_ciphertext_symmetric_ref(ct, s, buf))
        blobs.append(buf.getvalue())
    buf = io.BytesIO()
    _timed(times, "save ciphertext", lambda: ref.save_ciphertext_ref(
        cts[0], buf))
    full = nbytes["save ciphertext"] = len(buf.getvalue())
    nbytes["save seed-compressed ciphertext"] = nbytes[
        "load seed-compressed ciphertext"] = len(blobs[0])
    c0 = cts[0].data[0].numel() * 8
    print(f"wire: seed-compressed ciphertext {len(blobs[0])} bytes (c0 "
          f"{c0} + 64-byte seed + {len(blobs[0]) - c0 - 64}-byte header) "
          f"against {full} bytes in full ({full / 2**20:.1f} MiB)")
    if len(blobs[0]) != c0 + 64 + 58:
        raise RuntimeError("wire: the seed-compressed blob is not c0, the "
                           "seed and the header")
    # the server: loads (S1 regenerates c1), the step, its save
    loaded = [_timed(times, "load seed-compressed ciphertext",
                     lambda b=b: ref.load_ciphertext_symmetric_ref(
                         ctx, io.BytesIO(b))) for b in blobs]
    for a, b in zip(loaded, cts):
        if not _same(a, b):
            raise RuntimeError("wire: a seed-compressed load differs from "
                               "the ciphertext encrypted")
    out = ev.rescale_to_next(ctx, ev.multiply_and_relin(
        ctx, loaded[0], loaded[1], rlk))
    buf = io.BytesIO()
    _timed(times, "save product", lambda: ref.save_ciphertext_ref(out, buf))
    blob = buf.getvalue()
    nbytes["save product"] = nbytes["load product"] = len(blob)
    # the client: load, decrypt, decode
    back = _timed(times, "load product", lambda: ref.load_ciphertext_ref(
        io.BytesIO(blob), dev))
    if not _same(back, out):
        raise RuntimeError("wire: the product differs after its round trip")
    err = float(np.abs(enc.decode(keys.decrypt64(ctx, sk, back))
                       - z[0] * z[1]).max())
    print(f"wire: the loaded ciphertexts bit-equal to those encrypted; the "
          f"server's product {tuple(out.data.shape)} loaded back bit-equal "
          f"and decoded within {err:.3e} of numpy's float64 product (bound "
          f"{U64_TOL})")
    if not err <= U64_TOL:
        raise RuntimeError(f"wire: error {err} > {U64_TOL}")
    # the port's own format
    for what, obj in (("secret key", sk), ("public key", pk),
                      ("relin key", rlk), ("Galois key", glk),
                      ("ciphertext", cts[0]), ("product", out),
                      ("plaintext", pts[0])):
        _round_trip(times, f"{what} (PTCT / PTPT / PTKY)", ser.save,
                    lambda f: ser.from_bytes(f.getvalue(), ctx), obj, nbytes)
    ct_c, words = ser.encrypt_symmetric_compressed(ctx, sk, pts[1], gen)
    _round_trip(times, "ciphertext (PTCS)", lambda o, f:
                ser.save_ciphertext_symmetric(o, words, f),
                lambda f: ser.load_ciphertext_symmetric(f, ctx), ct_c,
                nbytes)
    print("wire: the keys, ciphertexts, product and plaintext through the "
          "port's own format bit-equal; a PTCS ciphertext regenerated "
          "bit-equal")
    del ctx, sk, pk, rlk, glk, cts, loaded, out, back, ct_c, pts
    torch.cuda.empty_cache()
    # BFV: a seeded symmetric ciphertext out of NTT form
    bprm = mod_t_params(**U64_BFV_CFG)
    bctx = make_context(bprm)
    bsk = keys.gen_secret_key64(bctx, gen)
    benc = BatchEncoder(bctx)
    vals = rng.integers(0, bprm.plain_modulus, bprm.n)
    seed = rng.bytes(ref.SEED_BYTES)
    ct = ref.encrypt_symmetric_seeded(bctx, bsk, benc.encode(vals), seed,
                                      gen)
    buf = io.BytesIO()
    _timed(times, "save seed-compressed BFV ciphertext",
           lambda: ref.save_ciphertext_symmetric_ref(ct, seed, buf))
    blob = buf.getvalue()
    nbytes["save seed-compressed BFV ciphertext"] = nbytes[
        "load seed-compressed BFV ciphertext"] = len(blob)
    back = _timed(times, "load seed-compressed BFV ciphertext",
                  lambda: ref.load_ciphertext_symmetric_ref(
                      bctx, io.BytesIO(blob)))
    right = int((benc.decode(keys.decrypt64(bctx, bsk, back)).astype(
        np.int64) == vals).sum())
    print(f"wire: BFV (N={bprm.n} L={bprm.size_q}, t={bprm.plain_modulus}) "
          f"seed-compressed ciphertext ({len(blob)} bytes) loaded through "
          f"S1 and U1's inverse bit-equal: {_same(back, ct)}; decrypts "
          f"right in {right} of {bprm.n} slots")
    if not _same(back, ct) or right != bprm.n:
        raise RuntimeError("wire: the BFV seed-compressed load is wrong")
    s1 = salsa20.sample.launches
    for what, v in times.items():
        host = [h for h, _ in v]
        dev_ms = [d for _, d in v]
        rate = (f"{nbytes[what]} bytes, "
                f"{nbytes[what] / np.mean(host) / 1e6:.3f} GB/s by host "
                "time; " if what in nbytes else "")
        print(f"timing wire {what}: {rate}host {np.mean(host):.3f} ms, CUDA "
              f"events {np.mean(dev_ms):.3f} ms a call ({len(v)} calls) "
              f"[{card}]")
    print(f"launches, wire path: S1={s1}")
    if s1 != EXPECTED_S1_WIRE:
        raise RuntimeError(f"wire: S1 launched {s1} times, not "
                           f"{EXPECTED_S1_WIRE}")
    del bctx, bsk, ct, back
    torch.cuda.empty_cache()
    return s1


def _runtime_phase(card, wrappers, launches, dev) -> None:
    """Phase 53: StreamExecutor(mult_relin_rescale32, pipe, batch=4) at the
    headline configuration over EXEC_ITEMS request pairs (two full
    batches and a tail of 2): the launch counts (EXEC_ITEMS headline
    steps), the outputs bit-equal in order to direct calls, the stats;
    items/s against the same direct calls, in turns (direct, executor,
    pipeline_map, pipeline_map, executor, direct; the executor kept, a new
    one each pipeline_map call, both on the shared side stream), with CUDA
    events, peak memory, a profile of the first two; the sanitizer
    enabled: the same step passes on canonical inputs and raises on an
    input word equal to q."""
    import torch
    from phantom_tpu_torch import make_context
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.runtime import StreamExecutor, pipeline_map
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.utils import debug
    torch.cuda.empty_cache()
    ctx = make_context(chain_params(**HEADLINE))
    sk, pipe, d1, d2, _, _ = make_step_inputs(ctx, SEED + 53, DELTA_BITS, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 53)
    rng = np.random.default_rng(SEED + 53)
    cts = [d1, d2] + [keys.encrypt_symmetric(ctx, sk, encode_coeffs(
        ctx, rng.integers(-3, 4, ctx.params.n), DELTA_BITS), gen)
        for _ in range(3)]
    pairs = [(cts[i % len(cts)], cts[(i + 1) % len(cts)])
             for i in range(EXEC_ITEMS)]
    direct = [pp.mult_relin_rescale32(pipe, a, b) for a, b in pairs]
    ex = StreamExecutor(pp.mult_relin_rescale32, pipe, batch=EXEC_BATCH)
    outs = _count(wrappers, EXEC_WHAT, lambda: ex.map(pairs), launches)
    if not all(torch.equal(o, r) for o, r in zip(outs, direct)):
        raise RuntimeError("runtime: the executor's outputs differ from "
                           "direct calls")
    st = ex.stats
    print(f"runtime: {EXEC_ITEMS} items through StreamExecutor(batch="
          f"{EXEC_BATCH}) bit-equal in order to direct calls; stats: items "
          f"{st.items}, batches {st.batches}, padded lanes "
          f"{st.padded_lanes}, dispatch {st.dispatch_s * 1e3:.3f} ms, first "
          f"batch {st.first_batch_s * 1e3:.3f} ms")
    if (st.items, st.batches, st.padded_lanes) != (
            EXEC_ITEMS, -(-EXEC_ITEMS // EXEC_BATCH), 0):
        raise RuntimeError(f"runtime: stats {st}")

    def run_direct():
        return [pp.mult_relin_rescale32(pipe, a, b) for a, b in pairs]

    def run_exec():  # the same executor, as a server keeps one
        return ex.map(pairs)

    def run_map():  # a new executor a call, on the same side stream
        return pipeline_map(pp.mult_relin_rescale32, pipe, pairs,
                            batch=EXEC_BATCH)

    if not all(torch.equal(o, r) for o, r in zip(run_map(), direct)):
        raise RuntimeError("runtime: pipeline_map's outputs differ from "
                           "direct calls")
    fns = {"direct": run_direct, "executor": run_exec,
           "pipeline_map": run_map}
    res = {}
    for name in ("direct", "executor", "pipeline_map", "pipeline_map",
                 "executor", "direct"):
        fn = fns[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = _time(fn, 3)
        res.setdefault(name, []).append(
            (ms, torch.cuda.max_memory_allocated() / 2**20))
    print(f"timing runtime, {EXEC_ITEMS} headline steps: " + "; ".join(
        f"{name} {np.mean([m for m, _ in v]):.3f} ms a run ("
        + ", ".join(f"{m:.3f}" for m, _ in v) + f"), "
        f"{EXEC_ITEMS * 1e3 / np.mean([m for m, _ in v]):.1f} items/s, peak "
        f"{max(p for _, p in v):.0f} MiB" for name, v in res.items())
        + f" [{card}]")
    for name, fn in (("direct calls", run_direct),
                     ("StreamExecutor", run_exec)):
        _profile(fn, 2, card, f"runtime, {name}, {EXEC_ITEMS} headline "
                 "steps")
    debug.enable()
    try:
        got = debug.checked_call(pp.mult_relin_rescale32, pipe, d1, d2)
        if not torch.equal(got, direct[0]):
            raise RuntimeError("runtime: the checked step differs")
        bad = d1.clone()
        bad[0, 0, 0] = pipe.ks.mv_ql.q[0]
        try:
            debug.checked_call(pp.mult_relin_rescale32, pipe, bad, d2)
        except debug.SanitizerError as e:
            print(f"sanitizer: the checked step passes on canonical inputs, "
                  f"bit-equal; an input word equal to q raises: {e}")
        else:
            raise RuntimeError("sanitizer: an input word equal to q passed")
    finally:
        debug.enable(False)
    del ctx, sk, pipe, cts, pairs, direct, outs, ex
    torch.cuda.empty_cache()


def _examples_phase(card) -> None:
    """Phase 54: examples 4 and 5 (serialization, kernel fusing) run as
    scripts on the card."""
    import runpy
    argv = sys.argv
    for name in EXAMPLES:
        path = os.path.join(ROOT, "phantom_tpu_torch", "examples",
                            name + ".py")
        t0 = time.time()
        sys.argv = [path]
        try:
            runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = argv
        print(f"example {name}.py: passed in {time.time() - t0:.1f} s "
              f"[{card}]")


def _runtime_utils_phases(card, wrappers, launches, dev) -> tuple:
    """Phases 51-54; returns S1's probe and its launches on the wire
    path."""
    probe = _S1Probe(S1_REPS)
    _s1_phase(card, probe, dev)
    s1 = _wire_phase(card, dev)
    _runtime_phase(card, wrappers, launches, dev)
    _examples_phase(card)
    return probe, s1


# ---------------------------------------------------------------------------
# phase 55: the coefficient-sharded steps (phantom_tpu_torch/parallel)
# ---------------------------------------------------------------------------

P1_SOURCE = "phantom_tpu_torch/csrc/ntt_phase.cu"
P1_REPLACES = ("phantom_tpu/parallel/ntt_sharded.py:86-211 and "
               "phantom_tpu/parallel/sharded32.py:66-161 (XLA stage loops, "
               "no pallas_call)")
SHARDED_CHAIN_STEPS = 10
# (W, dp) through the launcher, where the machine has the cards
SHARDED_WORLDS = ((2, 1), (4, 1), (4, 2))
SHARDED_PROBED = ("u32 CKKS", "u64 CKKS")  # P1 under the probe: both words
# P1's device ms a call in these steps as radix-2 stages in shared memory,
# before its radix-8 redesign (this phase on an NVIDIA H100 80GB HBM3 at
# 700.00 W), by (form, limbs)
P1_RADIX2_DEVICE_MS = {
    ("u32 B inverse", 43): 0.0710, ("u32 A inverse", 43): 0.0484,
    ("u32 A forward", 130): 0.0991, ("u32 B forward", 130): 0.1432,
    ("u32 B inverse", 44): 0.0609, ("u32 A inverse", 44): 0.0486,
    ("u32 A forward", 86): 0.0768, ("u32 B forward", 86): 0.0828,
    ("u32 B inverse", 2): 0.0313, ("u32 A inverse", 2): 0.0360,
    ("u32 A forward", 84): 0.0743, ("u32 B forward", 84): 0.0809,
    ("u64 B inverse", 43): 0.0690, ("u64 A inverse", 43): 0.0716,
    ("u64 A forward", 130): 0.1451, ("u64 B forward", 130): 0.1743,
    ("u64 B inverse", 44): 0.0641, ("u64 A inverse", 44): 0.0720,
    ("u64 A forward", 86): 0.1038, ("u64 B forward", 86): 0.1228,
    ("u64 B inverse", 2): 0.0216, ("u64 A inverse", 2): 0.0307,
    ("u64 A forward", 84): 0.1044, ("u64 B forward", 84): 0.1227,
}
U32_SHOUP_OPS = 3


def _launches_all(**kw):
    """A launch count over P1, KERNELS and U64_KERNELS."""
    names = ["P1"] + [n for n, *_ in KERNELS] + [n for n, *_ in U64_KERNELS]
    return {name: kw.get(name, 0) for name in names}


# one sharded step at W = 1: each sharded NTT is two P1 launches (phase A,
# phase B) around two all-to-alls, six NTTs a step (c2's inverse, the
# modup's forward, the moddown's P-row inverse and delta forward over both
# halves, the rescale's or switch's inverse and forward over both polys;
# BFV: D forward, D inverse, the modup's forward, the moddown's two, the
# switched halves' inverse)
EXPECTED.update({
    # K5 per digit (2) and the moddown's exact conversion (1); K9
    "sharded u32 CKKS step": _launches_all(P1=12, K5=3, K9=1),
    # U2 per digit and the moddown's exact conversion; U3; U4's tensor
    # product, (x - .) P^-1 + c, the rescale's delta and its Shoup form
    "sharded u64 CKKS step": _launches_all(P1=12, U2=3, U3=1, U4=4),
    # BGV's moddown converts P to Ql and to {t} (U2 x2) and adds U4's
    # moddown_delta; the switch's modswitch_delta
    "sharded u64 BGV step": _launches_all(P1=12, U2=4, U3=1, U4=5),
    # the four lifts (U2), three scale-and-rounds (U2 x2 each), the
    # modup's two digits and the moddown's conversion; U4's tensor product
    # and (x - .) P^-1
    "sharded u64 BFV step": _launches_all(P1=12, U2=13, U3=1, U4=2),
})


def _p1_work(a: dict, out):
    """(bytes, 32-bit multiplies) of one P1 call: its input read and its
    output written once, each distinct table row's twiddles and Shoup words
    that the phase reads (phase B: every column's), a Shoup product a
    butterfly (and a word at the inverse's scale)."""
    x, t, rows = a["x"], a["t"], a["rows"]
    wb = t.word
    num_l = rows.numel()
    r_len, cols = ((t.n1, t.n2 // a["world"]) if a["phase"] == "A"
                   else (t.n2, t.n1 // a["world"]))
    tw_cols = 1 if a["phase"] == "A" else cols
    byt = wb * (x.numel() + out.numel()
                + int(rows.unique().numel()) * 2 * (r_len - 1) * tw_cols)
    shoup = U32_SHOUP_OPS if wb == 4 else SHOUP_OPS
    logr = r_len.bit_length() - 1
    ops = num_l * cols * (r_len // 2) * logr * shoup
    if a["inverse"] and a["phase"] == "A":
        ops += x.numel() * shoup
    return byt, ops


class _P1Probe(_Probe):
    """P1 (ops/ntt_phase_kernels.ntt_phase) under a probe: each call held
    against its plain version and timed, its form (word, phase, direction)
    recorded."""

    def __init__(self, reps: int):
        from phantom_tpu_torch.ops import ntt_phase_kernels as npk
        super().__init__("P1", npk.ntt_phase, npk.ntt_phase_plain, reps)

    def __call__(self, *args, **kw):
        out = super().__call__(*args, **kw)
        ba = self.sig.bind(*args, **kw)
        ba.apply_defaults()
        a = ba.arguments
        self.calls[-1]["form"] = (f"u{8 * a['t'].word} {a['phase']} "
                                  + ("inverse" if a["inverse"]
                                     else "forward"))
        return out

    def bound(self, arguments, out):
        byt, ops = _p1_work(arguments, out)
        return byt, ops, 0, 0


def _p1_limbs(call) -> int:
    """The limbs of a P1 call: dim 0 of a (L, n1, c2) input, else dim 1."""
    shape = call["shape"]
    return shape[0] if len(shape) == 3 else shape[1]


def _p1_summary(calls, card) -> None:
    """P1's device ms a call for each word x phase at the steps' widest
    call (the forward's folded limbs), and each form's device ms summed
    over the probed calls, beside the radix-2 design's and the bound."""
    widest = max((_p1_limbs(c) for c in calls), default=0)
    for c in calls:
        if _p1_limbs(c) == widest:
            old = P1_RADIX2_DEVICE_MS.get((c["form"], widest))
            print(f"P1 {c['form']} at {c['shape']}: device {c['dev_ms']:.4f}"
                  f" ms a call (radix-2: "
                  f"{'-' if old is None else f'{old:.4f}'}), bound "
                  f"{c['bound_ms']:.4f} ms: {c['dev_ms'] / c['bound_ms']:.2f}"
                  f"x [{card}]")
    forms = sorted({c["form"] for c in calls})
    for form in forms:
        cs = [c for c in calls if c["form"] == form]
        olds = [P1_RADIX2_DEVICE_MS.get((form, _p1_limbs(c))) for c in cs]
        old = (f"{sum(olds):.4f}" if None not in olds else "-")
        dev, bound = (sum(c[k] for c in cs) for k in ("dev_ms", "bound_ms"))
        print(f"P1 {form}: device {dev:.4f} ms over {len(cs)} calls (radix-2: "
              f"{old}), bound {bound:.4f} ms: {dev / bound:.2f}x [{card}]")


def _init_nccl_world1(dev):
    """The default group as a world of one over NCCL (a FileStore in a
    fresh temporary directory); returns the directory."""
    import tempfile

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0 if dev.index is None else dev.index)
    tmp = tempfile.mkdtemp(prefix="ptk_store_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    return tmp


def _parallel_phase(card, dev, steps=None, n=None) -> tuple:
    """Phase 55: the four sharded steps at full width (launch.STEPS; or
    `steps`, {what: cfg}, at N = n) on a world of one over NCCL: per step
    W, dp and coeff; P1's calls probed on the u32 and u64 CKKS steps;
    the launch counts (EXPECTED) with the all-to-alls and their bytes;
    the output bit-equal to the rank's block of the local kernel step and
    to the sharded step on the plain versions; chained ms a step, sharded
    and local in turns (A, B, B, A), peak memory; a profile.  Each step
    is the batched one (launch.step_setup) on a batch of one.  With two
    or more cards, SHARDED_WORLDS through the launcher
    (launch.full_width).  Returns (P1's probe, P1's launches)."""
    import shutil

    import torch
    import torch.distributed as dist
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.parallel import launch
    from phantom_tpu_torch.parallel import ntt_sharded as ns
    from phantom_tpu_torch.parallel.mesh import make_coeff_mesh, shard_coeff
    from phantom_tpu_torch.schemes import keyswitch as ksw
    probe = _P1Probe(U64_REPS)
    launches = {"P1": 0}
    named = ([("P1", ns.ntt_phase)]
             + [(name, w) for (name, *_), w in zip(KERNELS,
                                                   kernel_wrappers())]
             + _named64(kernel_wrappers64()))
    steps = {w: None for w in launch.STEPS} if steps is None else steps
    n = 1 << launch.LOGN if n is None else n
    tmp = _init_nccl_world1(dev)
    try:
        mesh = make_coeff_mesh()
        for what, cfg in steps.items():
            torch.cuda.empty_cache()
            t0 = time.time()
            ctx, step, local, d1, d2, b1, b2 = launch.step_setup(
                what, mesh, SEED + 55, n, cfg)
            torch.cuda.synchronize()
            wide = ctx.wide
            kern, plain = ((ksw.KERNELS64, ksw.PLAIN64) if wide
                           else (pp.KERNELS, pp.PLAIN))
            prm = ctx.params
            print(f"sharded {what} setup: N={prm.n} L={prm.size_q} "
                  f"alpha={prm.size_p} ({max(prm.data_moduli).bit_length()}"
                  f"-bit data primes), W={mesh.world} dp={mesh.dp} "
                  f"coeff={mesh.coeff} over {dist.get_backend()}, block "
                  f"{tuple(b1.shape)}; context, uniform operands and relin "
                  f"key in {time.time() - t0:.1f} s [{card}]")
            if what in SHARDED_PROBED:
                since = len(probe.calls)
                step(b1, b2, kern._replace(ntt_phase=probe))
                for c in probe.calls[since:]:
                    old = P1_RADIX2_DEVICE_MS.get((c["form"], _p1_limbs(c)))
                    print(f"kernel P1 {c['form']} {c['shape']}: bit-equal "
                          f"to plain; {c['ms']:.4f} ms (device "
                          f"{c['dev_ms']:.4f}, radix-2 "
                          f"{'-' if old is None else f'{old:.4f}'}) vs plain "
                          f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f}"
                          f" ms by {c['bound_by']} ({c['bytes'] / 1e6:.1f} "
                          f"MB, {c['ops'] / 1e9:.3f} G mul; device "
                          f"{c['dev_ms'] / c['bound_ms']:.2f}x the bound) "
                          f"[{card}]")
            label = f"sharded {what} step"
            out, got, more = _count_named(
                named, label, lambda: step(b1, b2, kern), EXPECTED[label],
                lambda: {"all-to-alls": ns.exchange.calls,
                         "bytes sent": ns.exchange.bytes})
            launches["P1"] += got["P1"]
            a2a, a2a_bytes = more["all-to-alls"], more["bytes sent"]
            want = shard_coeff(local(d1, d2, kern), mesh)
            if out.shape[0] != 1 or not torch.equal(out[0], want):
                raise RuntimeError(f"{label}: differs from the local step")
            if not torch.equal(out, step(b1, b2, plain)):
                raise RuntimeError(f"{label}: differs from the sharded "
                                   "plain step")
            print(f"{label}: W={mesh.world} dp={mesh.dp} coeff="
                  f"{mesh.coeff}: {tuple(out.shape)} bit-equal to the "
                  "local kernel step's block and to the sharded step on "
                  f"the plain versions; {a2a} all-to-alls a step, "
                  f"{a2a_bytes / 2**20:.1f} MiB sent [{card}]")
            k = d1.shape[1]
            q_last = ctx.key_q[k - 1]

            def chain(route):
                sharded = route == "sharded W=1"

                def run(count):
                    a = b1 if sharded else d1
                    for _ in range(count):
                        o = step(a, b2) if sharded else local(a, d2)
                        dim = 2 if sharded else 1
                        a = remix(o, q_last, dim) if o.shape[dim] < k else o
                    return a
                return run
            finals = _chain_timing(("local", "sharded W=1", "sharded W=1",
                                    "local"), chain, SHARDED_CHAIN_STEPS,
                                   card, label + " against the local step")
            if not torch.equal(finals["local"].reshape(-1),
                               finals["sharded W=1"].reshape(-1)):
                raise RuntimeError(f"{label}: chained outputs differ")
            aa = [b1]

            def prof_step():
                o = step(aa[0], b2)
                aa[0] = remix(o, q_last, 2) if o.shape[2] < k else o
            _profile(prof_step, PROFILE_STEPS, card, label + ", W = 1")
            del ctx, step, local, d1, d2, b1, b2, out, want, finals, aa
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    _p1_summary(probe.calls, card)
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    for world, dp in SHARDED_WORLDS:
        if world > cards:
            print(f"sharded steps at W = {world}, dp = {dp}: not run "
                  f"({cards} card{'s' if cards > 1 else ''} here)")
            continue
        t0 = time.time()
        res = launch.run(launch.full_width, world, timeout=600,
                         args=(SHARDED_CHAIN_STEPS,), dp=dp)
        for per_rank in zip(*res):
            for r in per_rank:
                print(f"{launch.describe(r)} [{card}]")
                if not r["equal"]:
                    raise RuntimeError(f"sharded {r['step']} at W = {world}, "
                                       f"rank {r['rank']}: differs from the "
                                       "local step's block")
        print(f"sharded steps at W = {world}, dp = {dp} through the "
              f"launcher in {time.time() - t0:.1f} s")
    return probe, launches["P1"]


# ---------------------------------------------------------------------------
# phase 56: the ("dp", "limb") layout and the bench setup cache
# ---------------------------------------------------------------------------

LIMB_GOLDEN = os.path.join(FIXTURES, "limb_n1024.npz")
LIMB_ALPHAS = (4, 3)  # the golden file's configurations: fused, unfused
LIMB_SEED = 22        # configuration alpha draws from LIMB_SEED + alpha


def limb_inputs(data, special, n: int, seed: int):
    """The limb golden file's inputs from numpy's default_rng(seed), uint64:
    a uniform relin key (dnum, 2, K, N) over data + special, then two
    batches d1, d2 of two items (2, 2, k, N) over data."""
    rng = np.random.default_rng(seed)
    qd = np.array(data, dtype=np.uint64)[:, None]
    qk = np.array(list(data) + list(special), dtype=np.uint64)[:, None]
    dnum = -(-len(data) // len(special))
    key = rng.integers(0, qk, (dnum, 2, len(qk), n), dtype=np.uint64)
    d1, d2 = (rng.integers(0, qd, (2, 2, len(qd), n), dtype=np.uint64)
              for _ in range(2))
    return key, d1, d2


def limb_case(g, alpha: int, device):
    """(ctx, rlk, d1, d2, want) of the golden file's configuration `alpha`
    on `device`: the context over its primes, the inputs as int64 words,
    the JAX package's output (numpy uint64)."""
    import torch
    from phantom_tpu_torch import EncryptionParameters, make_context
    data = g["data_moduli"].tolist()
    special = g[f"a{alpha}_special"].tolist()
    want = g[f"a{alpha}_out"]
    ctx = make_context(EncryptionParameters.create(want.shape[-1], data,
                                                   special), device=device)
    key, d1, d2 = (torch.from_numpy(a.view(np.int64)).to(device)
                   for a in limb_inputs(data, special, want.shape[-1],
                                        LIMB_SEED + alpha))
    return ctx, key, d1, d2, want


def limb_golden(mesh, ops=None) -> dict:
    """Each configuration of limb_n1024.npz through the limb step on this
    rank's blocks: {alpha: (the rank's output (B / dp, 2, k - 1, N) as
    uint64, the golden items of its dp group)}."""
    from phantom_tpu_torch.parallel import (shard_ciphertext_data,
                                            sharded_mul_relin_rescale_step)
    from phantom_tpu_torch.schemes.ciphertext import Ciphertext
    g = np.load(LIMB_GOLDEN)
    out = {}
    for alpha in LIMB_ALPHAS:
        ctx, key, d1, d2, want = limb_case(g, alpha, mesh.device)
        proto = Ciphertext(d1[0], chain_index=1, is_ntt_form=True)
        step = sharded_mul_relin_rescale_step(ctx, proto, proto, key, mesh,
                                              ops)
        got = step(shard_ciphertext_data(d1, mesh),
                   shard_ciphertext_data(d2, mesh))
        per = want.shape[0] // mesh.dp
        out[alpha] = (got.cpu().numpy().view(np.uint64),
                      want[mesh.dp_index * per:(mesh.dp_index + 1) * per])
    return out


# one limb-sharded step at W = 1, U64_CFG (k = 43, alpha = 22: two digits,
# the unfused modup): U1's inverse of c2, its forward per digit, the P
# rows' inverse, the moddown's forward over both halves, the rescale's
# inverse and forward; U2 per digit and the exact conversion P -> Ql over
# both halves; U3; U4's tensor product, (x - .) P^-1 + c, the rescale's
# delta and its Shoup form
EXPECTED["limb-sharded step"] = _launches_all(U1=7, U2=3, U3=1, U4=4)
LIMB_KINDS = ("c2", "P rows", "last row", "result")
# (W, dp) of the limb layout through the launcher, where the machine has
# the cards
LIMB_WORLDS = ((2, 1), (4, 1), (4, 2))


def _limb_phase(card, dev, launches64, cfg=None) -> None:
    """Phase 56: the bench setup and the limb-sharded step.
    setup_bench("ckks", **U64_CFG) (or `cfg`) fresh into an empty cache
    directory of its own (PHANTOM_TORCH_SETUP_CACHE), timed with the
    context build's share; the blob's bytes on disk; the setup loaded,
    timed, bit-equal to the fresh one.  On a world of one over NCCL the
    limb step on (ct1, ct2), a batch of one: the launch counts
    (EXPECTED["limb-sharded step"], added to launches64) with the
    collectives and the bytes received; bit-equal to the local kernel
    step (multiply_and_relin + rescale_to_next) and to the limb step on
    PLAIN64; decrypted and decoded within U64_TOL of values^2; 10
    chained steps, limb and local in turns (A, B, B, A) with peak memory;
    a profile.  With two or more cards LIMB_WORLDS through `launch
    --layout limb` (44 data primes); with one, "not run"."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from phantom_tpu_torch.parallel import (launch, make_mesh,
                                            shard_ciphertext_data,
                                            sharded_mul_relin_rescale_step)
    from phantom_tpu_torch.parallel import limb_step as ls
    from phantom_tpu_torch.parallel import ntt_sharded as ns
    from phantom_tpu_torch.schemes import evaluate as ev
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes import keyswitch as ksw
    from phantom_tpu_torch.utils import benchcache, setup_bench
    cfg = U64_CFG if cfg is None else cfg
    named = ([("P1", ns.ntt_phase)]
             + [(name, w) for (name, *_), w in zip(KERNELS,
                                                   kernel_wrappers())]
             + _named64(kernel_wrappers64()))
    cache = tempfile.mkdtemp(prefix="ptk_setup_")
    old = os.environ.get(benchcache.ENV)
    os.environ[benchcache.ENV] = cache
    try:
        t0 = time.perf_counter()
        s = setup_bench("ckks", **cfg, seed=SEED + 56, verbose=False,
                        device=dev)
        fresh = time.perf_counter() - t0
        if s.cached:
            raise RuntimeError("limb setup: a fresh cache directory hit")
        tm = s.times
        prm = s.params
        print(f"limb setup: setup_bench ckks N={prm.n} L={prm.size_q} "
              f"alpha={prm.size_p} fresh in {fresh:.2f} s: context build "
              f"{tm['context']:.2f} s ({tm['context'] / fresh:.0%} of it), "
              f"keys {tm['keys']:.2f} s, encode + two encryptions "
              f"{tm['encrypt']:.2f} s, the blob's save {tm['save']:.2f} s "
              f"[{card}]")
        blob = os.path.getsize(s.path)
        t0 = time.perf_counter()
        back = setup_bench("ckks", **cfg, seed=SEED + 56, verbose=False,
                           device=dev)
        loaded = time.perf_counter() - t0
        same = back.cached and all(
            _same(getattr(back, k), getattr(s, k))
            for k in ("sk", "pk", "rlk", "pt", "ct1", "ct2"))
        if not same:
            raise RuntimeError("limb setup: the loaded setup differs from "
                               "the fresh one")
        print(f"limb setup: cache blob {blob} bytes ({blob / 2**20:.1f} "
              f"MiB) on disk; loaded in {loaded:.2f} s (context build "
              f"{back.times['context']:.2f} s, load "
              f"{back.times['load']:.2f} s), bit-equal to the fresh setup "
              f"[{card}]")
        del back
    finally:
        if old is None:
            os.environ.pop(benchcache.ENV, None)
        else:
            os.environ[benchcache.ENV] = old
        shutil.rmtree(cache, ignore_errors=True)
    ctx, rlk, c1, c2 = s.ctx, s.rlk, s.ct1, s.ct2
    tmp = _init_nccl_world1(dev)
    try:
        mesh = make_mesh()
        step = sharded_mul_relin_rescale_step(ctx, c1, c2, rlk, mesh)
        b1, b2 = (shard_ciphertext_data(c.data[None], mesh)
                  for c in (c1, c2))
        label = "limb-sharded step"

        def counters():
            return {f"{k} {w}": getattr(ls.collectives, w).get(k, 0)
                    for k in LIMB_KINDS for w in ("calls", "bytes")}
        ls.collectives.reset()
        out, got, more = _count_named(named, label, lambda: step(b1, b2),
                                      EXPECTED[label], counters)
        for name in launches64:
            launches64[name] += got[name]
        local = ev.rescale_to_next(ctx, ev.multiply_and_relin(ctx, c1, c2,
                                                              rlk))
        if out.shape[0] != 1 or not torch.equal(out[0], local.data):
            raise RuntimeError(f"{label}: differs from the local kernel step")
        if not torch.equal(out, step(b1, b2, ksw.PLAIN64)):
            raise RuntimeError(f"{label}: differs from the limb step on "
                               "the plain versions")
        err = float(np.abs(s.enc.decode(keys.decrypt64(ctx, s.sk, local))
                           - s.values ** 2).max())
        print(f"{label}: W={mesh.world} dp={mesh.dp} limb={mesh.limb} over "
              f"{dist.get_backend()}: {tuple(out.shape)} bit-equal to the "
              "local kernel step (multiply_and_relin + rescale_to_next) and "
              "to the limb step on the plain versions; collectives a step: "
              + ", ".join(f"{k} {more[f'{k} calls']} ("
                          f"{more[f'{k} bytes'] / 1e6:.1f} MB received)"
                          for k in LIMB_KINDS)
              + f"; decoded within {err:.3e} of values^2 (bound {U64_TOL}) "
              f"[{card}]")
        if not err <= U64_TOL:
            raise RuntimeError(f"{label}: error {err} > {U64_TOL}")
        k = c1.data.shape[1]
        q_last = ctx.key_q[k - 1]
        limb_one = launch.limb_chain(step, b2, q_last, mesh)

        def chain(route):
            def run(count):
                a = b1 if route == "limb W=1" else c1.data
                for _ in range(count):
                    a = (limb_one(a) if route == "limb W=1" else
                         remix(ev.rescale_to_next(ctx, ev.multiply_and_relin(
                             ctx, c1.replace(data=a), c2, rlk)).data, q_last))
                return a
            return run
        finals = _chain_timing(("local", "limb W=1", "limb W=1", "local"),
                               chain, SHARDED_CHAIN_STEPS, card,
                               label + " against the local step")
        if not torch.equal(finals["local"].reshape(-1),
                           finals["limb W=1"].reshape(-1)):
            raise RuntimeError(f"{label}: chained outputs differ")
        aa = [b1]

        def prof_step():
            aa[0] = limb_one(aa[0])
        _profile(prof_step, PROFILE_STEPS, card, label + ", W = 1")
        del step, out, local, finals, aa, b1, b2
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    del s, ctx, rlk, c1, c2
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    for world, dp in LIMB_WORLDS:
        if world > cards:
            print(f"limb-sharded step at W = {world}, dp = {dp}: not run "
                  f"({cards} card{'s' if cards > 1 else ''} here)")
            continue
        t0 = time.time()
        res = launch.run(launch.limb_full_width, world, timeout=600,
                         args=(SHARDED_CHAIN_STEPS,), dp=dp, layout="limb")
        for per_rank in zip(*res):
            for r in per_rank:
                print(f"{launch.describe(r)} [{card}]")
                if not r["equal"]:
                    raise RuntimeError(f"limb step at W = {world}, rank "
                                       f"{r['rank']}: differs from the "
                                       "local step")
        print(f"limb-sharded step at W = {world}, dp = {dp} through the "
              f"launcher in {time.time() - t0:.1f} s")


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
    calls = sys.argv[1:2] == ["--calls"]
    if not calls:  # K7's, U1's and U2's registers and spills, beside the
        # library's build
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        ptxas = [(start_ptxas_report(src, os.path.join(
            _build.BUILD_DIR, src + ".ptxas.o")), kernels)
            for src, kernels in PTXAS_REPORTS]
    path = _build.build()
    _build.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s")
    if calls:
        calls_only(card, dev, sys.argv[2:] == ["u64"])
        return 0
    imma = {}
    for counts in sass_by_function(path, "fold_matmul_kernel",
                                   ("IMMA",)).values():
        for ins, k in counts.items():
            imma[ins] = imma.get(ins, 0) + k
    if not imma:
        raise RuntimeError("K5: no IMMA instruction in fold_matmul_kernel")
    print(f"sass: K5 fold_matmul_kernel issues {sum(imma.values())} int8 "
          f"tensor-core instructions ({', '.join(sorted(imma))})")
    syms = _cuobjdump(path, "-symbols")
    stale = [k for k in STALE_KERNELS if k in syms]
    missing = [k for k in CORE_KERNELS if k not in syms]
    if stale or missing:
        raise RuntimeError(f"build: stale kernels {stale} in the library, "
                           f"core kernels {missing} not")
    use = resource_usage(path, CORE_KERNELS)
    print(f"symbols: none of {', '.join(STALE_KERNELS)}; resources: "
          + "; ".join(f"{k} {v}" for k, v in use.items()))
    for proc, kernels in ptxas:
        print("ptxas: " + "; ".join(f"{k} {v}" for k, v in ptxas_report(
            proc, kernels).items()))

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
    since = {name: 0 for name in PROBE_NAMES}
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
    torch.cuda.empty_cache()

    # 34-36. the CKKS application path: F1, the device encoder, the MLP
    _app_phases(card, probes, wrappers, launches, dev, path)
    _print_calls(probes, card, since)
    torch.cuda.empty_cache()

    # 37-40. the roll engine and the xla-bconv moddown
    _roll_phases(card, wrappers, launches, dev)
    torch.cuda.empty_cache()

    # 41-43. the u64 evaluator on U1-U4
    launches64 = {name: 0 for name, *_ in U64_KERNELS}
    probes64, per_call = _u64_phases(card, launches64, dev, path)
    # 44-47. BFV on the u64 evaluator, each multiplication technique
    _u64_bfv_phases(card, probes64, launches64, dev)
    torch.cuda.empty_cache()
    # 48-50. the u64 application layer: F1's wide forms, the golden files,
    # the u64 MLP + Chebyshev circuit
    _u64_app_phases(card, probes64, launches, launches64, dev)
    torch.cuda.empty_cache()
    # 51-54. the runtime and utils layer: S1, the wire path, the
    # StreamExecutor, examples 4 and 5
    s1_probe, s1_launches = _runtime_utils_phases(card, wrappers, launches,
                                                  dev)
    torch.cuda.empty_cache()
    # 55. the coefficient-sharded steps over torch.distributed (P1)
    p1_probe, p1_launches = _parallel_phase(card, dev)
    torch.cuda.empty_cache()
    # 56. the bench setup cache and the limb-sharded step (U1-U4)
    _limb_phase(card, dev, launches64)

    def summed(name, calls, library_ms=None):
        if not calls:
            raise RuntimeError(f"{name}: not probed")
        return dict(
            max_abs_err=max(c["err"] for c in calls),
            ms=round(sum(c["ms"] for c in calls), 5),
            plain_ms=round(sum(c["plain_ms"] for c in calls), 5),
            bound_ms=round(sum(c["bound_ms"] for c in calls), 5),
            bound_by=max(("bytes", "operations"), key=lambda b: sum(
                c["bound_ms"] for c in calls if c["bound_by"] == b)),
            library_ms=library_ms,
            calls=len(calls),
            dev_ms=round(sum(c["dev_ms"] for c in calls), 5),
            dev_ms_a_call=round(sum(c["dev_ms"] for c in calls)
                                / len(calls), 5),
            **({} if "host_ms" not in calls[0] else dict(
                host_ms_a_call=round(float(np.mean([
                    c["host_ms"] for c in calls])), 5))))

    def probed(probe):
        return summed(probe.name, probe.calls,
                      getattr(probe, "library_ms", None))

    rows = []
    for (name, attr, src, repl), probe in zip(KERNELS, probes):
        rows.append(dict(name=f"{name} {attr}", route="cuda", source=src,
                         replaces=repl, launches=launches[name],
                         **probed(probe)))
    # F1's fused forms, 32-bit and wide: the same kernels and launch count,
    # probed apart
    rows[-1]["forms"] = [
        dict(name=f"{F1_FORMS[f]} {f}", **probed(getattr(probes, f)))
        for f in F1_FORMS] + [
        dict(name=f"{name} {f}64", **probed(getattr(probes64, f)))
        for f, name in U64_F1_FORMS.items()]
    for name, attr, src, repl in U64_KERNELS:
        mine = [p for p in probes64 if p.name.split()[0] == name]
        calls = [c for p in mine for c in p.calls]
        rows.append(dict(name=f"{name} {attr}", route="cuda", source=src,
                         replaces=repl, launches=launches64[name],
                         **summed(name, calls)))
        if name in per_call:  # kernel launches a call (one: U1, U2)
            rows[-1]["launches_per_call"] = per_call[name]
        if len(mine) > 1:
            rows[-1]["forms"] = [dict(name=p.name, **probed(p))
                                 for p in mine if p.calls]
        if name == "U2":  # U2's forms, by the form each call took
            forms = {}
            for c in calls:
                forms.setdefault(c["form"], []).append(c)
            rows[-1]["forms"] = [
                dict(name=f"U2 {form}", **summed(f"U2 {form}", cs))
                for form, cs in forms.items()]
    rows.append(dict(name="S1 sample", route="cuda", source=S1_SOURCE,
                     replaces=S1_REPLACES, launches=s1_launches,
                     **summed("S1", s1_probe.calls)))
    rows[-1]["forms"] = [
        dict(name=f"S1 {form}", **summed(f"S1 {form}", [
            c for c in s1_probe.calls if c["form"] == form]))
        for form in SALSA_FORMS]
    rows.append(dict(name="P1 ntt_phase", route="cuda", source=P1_SOURCE,
                     replaces=P1_REPLACES, launches=p1_launches,
                     **summed("P1", p1_probe.calls)))
    rows[-1]["forms"] = [
        dict(name=f"P1 {form}", **summed(f"P1 {form}", cs)) for form, cs in
        {c["form"]: [d for d in p1_probe.calls if d["form"] == c["form"]]
         for c in p1_probe.calls}.items()]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

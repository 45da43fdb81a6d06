"""Encrypted logistic-regression inference on the u64 evaluator (the port
of the JAX package's examples/10_logistic_inference.py).

Batched scores sigmoid(w . x_j + b) under CKKS: the samples packed d
slots each, the plaintext weights' dot product by a plain product and the
blocked rotate-and-sum (Galois keys for d/2, ..., 1), then the degree-3
sigmoid 0.5 + C1 z + C3 z^3 down the rescale chain, the scales managed by
hand as in the JAX example.  Keys and the encryption draw from a
torch.Generator; values go in and out through the CKKSDeviceEncoder.
Checked against numpy evaluating the same pipeline, at the JAX example's
tolerance.

    python phantom_tpu_torch/examples/logistic_inference.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phantom_tpu_torch import (CKKSDeviceEncoder,  # noqa: E402
                               EncryptionParameters, make_context)
from phantom_tpu_torch.host import numth  # noqa: E402
from phantom_tpu_torch.schemes import evaluate, keys  # noqa: E402

C1, C3 = 0.197, -0.004  # the degree-3 odd sigmoid fit on [-4, 4]
SCALE_BITS = 30
TOLERANCE = 1e-2  # the JAX example's


def logistic_demo(n=2048, d=8, samples=32, device=None, seed=17):
    """The scores of `samples` samples of d features at ring degree n;
    returns the largest error against numpy."""
    print(f"[logistic] n={n}: {samples} samples x {d} features")
    qs = numth.get_primes(2 * n, 40, 2)
    rs = numth.get_primes(2 * n, SCALE_BITS, 4)
    ctx = make_context(EncryptionParameters.create(n, qs[:1] + rs, qs[1:]),
                       device)
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    rlk = keys.gen_relin_key64(ctx, sk, gen)
    steps = [d >> (i + 1) for i in range(d.bit_length() - 1)]  # d/2 .. 1
    glk = keys.create_galois_keys64(ctx, sk, gen, steps=steps)
    enc = CKKSDeviceEncoder(ctx)
    scale = 2.0 ** SCALE_BITS

    rg = np.random.default_rng(5)
    X = rg.standard_normal((samples, d))
    w = rg.standard_normal(d) * 0.5
    b = 0.3
    packed = np.zeros(enc.slots)
    packed[:samples * d] = X.ravel()
    wrep = np.zeros(enc.slots)
    wrep[:samples * d] = np.tile(w, samples)
    ct = keys.encrypt_asymmetric64(ctx, pk, enc.encode(packed, scale), gen)

    def rescale_forced(c):
        return evaluate.rescale_to_next(ctx, c).replace(scale=scale)

    def const(value, c):
        return enc.encode(np.full(enc.slots, value), c.scale, c.chain_index)

    # z_j = w . x_j + b in slot j d of each block
    z = rescale_forced(evaluate.multiply_plain(ctx, ct,
                                               enc.encode(wrep, scale)))
    for s in steps:
        z = evaluate.add(ctx, z, evaluate.rotate_vector(ctx, z, s, glk))
    z = evaluate.add_plain(ctx, z, const(b, z))
    # sigmoid(z) ~ 0.5 + C1 z + C3 z^3
    z2 = rescale_forced(evaluate.multiply_and_relin(ctx, z, z, rlk))
    c3z = rescale_forced(evaluate.multiply_plain(ctx, z, const(C3, z)))
    t3 = rescale_forced(evaluate.multiply_and_relin(ctx, c3z, z2, rlk))
    c1z = rescale_forced(evaluate.multiply_plain(ctx, z, const(C1, z)))
    acc = evaluate.add(ctx, t3, evaluate.mod_switch_to(ctx, c1z,
                                                       t3.chain_index))
    acc = evaluate.add_plain(ctx, acc, const(0.5, acc))
    got = enc.decode(keys.decrypt64(ctx, sk, acc)).real
    scores = got[np.arange(samples) * d]
    zs = X @ w + b
    want = 0.5 + C1 * zs + C3 * zs ** 3
    err = float(np.max(np.abs(scores - want)))
    if not err < TOLERANCE:
        raise AssertionError(f"logistic scores mismatch (max err {err})")
    agree = np.mean((scores > 0.5) == (1 / (1 + np.exp(-zs)) > 0.5))
    print(f"  encrypted scores: ok (max err {err:.2e}; decision agreement "
          f"with the true sigmoid {agree:.0%}) on {ctx.key_q.device}")
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--n", type=int, default=1024, help="ring degree")
    a = ap.parse_args()
    logistic_demo(a.n, device=a.device)
    print("all logistic-inference examples passed")

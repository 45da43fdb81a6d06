"""CKKS polynomial evaluation on the u64 evaluator (the port of the JAX
package's examples/8_poly_eval.py): a degree-7 sigmoid approximation down
a four-level chain of 40-bit primes under a 50-bit q0.

As in the JAX example, the scales are managed by hand: the powers x^2 and
x^4 by squaring, the odd terms with plain-multiplied coefficients, every
operand mod-switched to the common level and each rescale's scale forced
back to 2^40; then the sigmoid's Chebyshev series by poly_eval_cheb,
which manages the scales itself, on a chain with room for it.  Keys and
encryptions draw from a torch.Generator; values go in and out through
the CKKSDeviceEncoder, and poly_eval_cheb's constants through the host
CKKSEncoder (it encodes some at the square of the scale, past the device
encoder's 2^62).  Checked against numpy evaluating the same polynomial
(the fit's distance from the sigmoid is printed, not checked).

    python phantom_tpu_torch/examples/poly_eval.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phantom_tpu_torch import (CKKSDeviceEncoder,  # noqa: E402
                               CKKSEncoder, EncryptionParameters,
                               chebyshev_fit,
                               make_context, poly_eval_cheb)
from phantom_tpu_torch.host import numth  # noqa: E402
from phantom_tpu_torch.schemes import evaluate, keys  # noqa: E402

SCALE_BITS = 40
TOLERANCE = 1e-2  # the JAX example's


def fit_sigmoid_deg7():
    """Least-squares odd degree-7 fit of sigmoid(x) - 1/2 on [-4, 4]."""
    xs = np.linspace(-4.0, 4.0, 2001)
    ys = 1.0 / (1.0 + np.exp(-xs)) - 0.5
    basis = np.stack([xs, xs ** 3, xs ** 5, xs ** 7], axis=1)
    c, *_ = np.linalg.lstsq(basis, ys, rcond=None)
    return c  # (c1, c3, c5, c7)


def _setup(n, levels, device, seed):
    """A chain q0 of 50 bits, `levels` primes of SCALE_BITS, a special
    prime of 51; keys from a generator."""
    qs = numth.get_primes(2 * n, 50, 1) + numth.get_primes(
        2 * n, SCALE_BITS, levels)
    ctx = make_context(EncryptionParameters.create(
        n, qs, numth.get_primes(2 * n, 51, 1)), device)
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    rlk = keys.gen_relin_key64(ctx, sk, gen)
    return ctx, gen, sk, pk, rlk, CKKSDeviceEncoder(ctx)


def poly_eval_demo(n=1024, device=None, seed=42):
    """The manual evaluation; returns its error against numpy."""
    print(f"[poly] n={n} degree-7 sigmoid approx, depth-4 chain")
    ctx, gen, sk, pk, rlk, enc = _setup(n, 4, device, seed)
    scale = 2.0 ** SCALE_BITS
    x = np.random.default_rng(3).uniform(-4.0, 4.0, enc.slots)
    ct_x = keys.encrypt_asymmetric64(ctx, pk, enc.encode(x, scale), gen)
    c1, c3, c5, c7 = fit_sigmoid_deg7()

    def rescale_forced(ct):
        """Rescale and force the scale back to 2^SCALE_BITS (the prime is
        only about 2^SCALE_BITS)."""
        return evaluate.rescale_to_next(ctx, ct).replace(scale=scale)

    def cmul(ct, coeff):
        """coeff ct at ct's level, rescaled once."""
        pt = enc.encode(np.full(enc.slots, coeff), scale, ct.chain_index)
        return rescale_forced(evaluate.multiply_plain(ctx, ct, pt))

    def align(ct, target):
        return (evaluate.mod_switch_to(ctx, ct, target.chain_index)
                if ct.chain_index != target.chain_index else ct)

    def mul(a, b):
        return rescale_forced(evaluate.multiply_and_relin(ctx, a, b, rlk))

    x2 = mul(ct_x, ct_x)                           # level 1
    x4 = mul(x2, x2)                               # level 2
    t1 = cmul(ct_x, c1)
    t3 = mul(align(cmul(ct_x, c3), x2), x2)
    t5 = mul(align(cmul(ct_x, c5), x4), x4)
    t7 = mul(align(mul(align(cmul(ct_x, c7), x2), x2), x4), x4)
    acc = evaluate.add(ctx, evaluate.add(ctx, align(t1, t7), align(t3, t7)),
                       evaluate.add(ctx, align(t5, t7), t7))
    acc = evaluate.add_plain(ctx, acc, enc.encode(
        np.full(enc.slots, 0.5), acc.scale, acc.chain_index))
    got = enc.decode(keys.decrypt64(ctx, sk, acc)).real
    want = 0.5 + c1 * x + c3 * x ** 3 + c5 * x ** 5 + c7 * x ** 7
    err = float(np.max(np.abs(got - want)))
    if not err < TOLERANCE:
        raise AssertionError(f"poly eval mismatch (max err {err})")
    sig = float(np.max(np.abs(got - 1.0 / (1.0 + np.exp(-x)))))
    print(f"  homomorphic deg-7 eval: ok (arith err {err:.2e}, sigmoid "
          f"approx err {sig:.2e})")
    return err


def cheb_demo(n=1024, degree=7, device=None, seed=43):
    """The sigmoid's Chebyshev series on [-4, 4] by poly_eval_cheb (its
    interval map, the power ladder, the scales); returns the error
    against numpy's evaluation of the series."""
    print(f"[poly] n={n} degree-{degree} Chebyshev sigmoid by "
          "poly_eval_cheb")
    ctx, gen, sk, pk, rlk, enc = _setup(n, 6, device, seed)
    scale = 2.0 ** SCALE_BITS
    x = np.random.default_rng(4).uniform(-4.0, 4.0, enc.slots)
    ct = keys.encrypt_asymmetric64(ctx, pk, enc.encode(x, scale), gen)
    cc = chebyshev_fit(lambda v: 1.0 / (1.0 + np.exp(-v)), degree,
                       (-4.0, 4.0))
    y = evaluate.rescale_to_next(ctx, poly_eval_cheb(
        ctx, ct, cc, rlk, CKKSEncoder(ctx), interval=(-4.0, 4.0)))
    got = enc.decode(keys.decrypt64(ctx, sk, y)).real
    err = float(np.max(np.abs(
        got - np.polynomial.chebyshev.chebval(x / 4.0, cc))))
    if not err < TOLERANCE:
        raise AssertionError(f"poly_eval_cheb mismatch (max err {err})")
    print(f"  poly_eval_cheb: ok (err {err:.2e}, chain index "
          f"{y.chain_index}) on {ctx.key_q.device}")
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--n", type=int, default=1024, help="ring degree")
    a = ap.parse_args()
    poly_eval_demo(a.n, device=a.device)
    cheb_demo(a.n, device=a.device)
    print("all poly-eval examples passed")

"""Encrypted matrix-vector product on the u64 evaluator (the port of the
JAX package's examples/6_encrypted_matmul.py): CKKS over 40- and 30-bit
primes, so every residue is a u64 word and every kernel is U1-U4 (and F1
in the device encoder).

The Halevi-Shoup diagonal method, y = sum_k diag_k(M) rot(x, k), first as
the JAX example writes it (a rotation and a plain product per diagonal),
then as LinearTransform.apply (baby-step/giant-step rotations sharing one
modup).  Keys and the encryption draw from a torch.Generator; x goes in
and y comes out through the CKKSDeviceEncoder.  Raises beyond the JAX
example's tolerance.

    python phantom_tpu_torch/examples/encrypted_matmul.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phantom_tpu_torch import (CKKSDeviceEncoder, CKKSEncoder,  # noqa: E402
                               EncryptionParameters, LinearTransform,
                               make_context)
from phantom_tpu_torch.host import numth  # noqa: E402
from phantom_tpu_torch.schemes import evaluate, keys  # noqa: E402

TOLERANCE = 1e-2  # the JAX example's


def encrypted_matvec(ctx, glk, enc, ct_x, M, scale):
    """M (d, d) on the first d slots of ct_x, which repeats x over its
    first 2d slots: a rotation and a plain product per diagonal."""
    d = M.shape[0]
    acc = None
    for k in range(d):
        vec = np.zeros(enc.slots)
        vec[:d] = [M[i, (i + k) % d] for i in range(d)]
        rot = evaluate.rotate_vector(ctx, ct_x, k, glk) if k else ct_x
        term = evaluate.multiply_plain(ctx, rot, enc.encode(vec, scale))
        acc = term if acc is None else evaluate.add(ctx, acc, term)
    return evaluate.rescale_to_next(ctx, acc)


def demo(n=2048, d=8, device=None, seed=0):
    """Both forms at ring degree n and width d; returns the larger
    error against numpy."""
    print(f"[encrypted matvec] n={n}, matrix {d}x{d}")
    qs = numth.get_primes(2 * n, 40, 2) + numth.get_primes(2 * n, 30, 2)
    ctx = make_context(EncryptionParameters.create(
        n, [qs[0], qs[2], qs[3]], [qs[1]]), device)
    rg = np.random.default_rng(seed)
    M = rg.standard_normal((d, d)) * 0.3
    x = rg.standard_normal(d) * 0.3
    lt = LinearTransform(M)
    steps = sorted(set(range(1, d)) | set(lt.steps_required()))
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    glk = keys.create_galois_keys64(ctx, sk, gen, steps=steps)
    enc = CKKSDeviceEncoder(ctx)
    scale = 2.0 ** 30
    want = M @ x

    ct_x = keys.encrypt_asymmetric64(ctx, pk, enc.encode(
        np.resize(x, 2 * d), scale), gen)
    ct_y = encrypted_matvec(ctx, glk, enc, ct_x, M, scale)
    got = enc.decode(keys.decrypt64(ctx, sk, ct_y)).real[:d]
    err = float(np.abs(got - want).max())
    if not err < TOLERANCE:
        raise AssertionError(f"encrypted matvec mismatch (max err {err})")
    print(f"  diagonal by diagonal: ok (max err {err:.2e})")

    # the BSGS form: x tiled d-periodically, the diagonals over QlP
    lt.prepare(CKKSEncoder(ctx), scale)
    ct_t = keys.encrypt_asymmetric64(ctx, pk, lt.encode_input(enc, x, scale),
                                     gen)
    got = enc.decode(keys.decrypt64(ctx, sk, lt.apply(ctx, ct_t,
                                                      glk))).real[:d]
    err_lt = float(np.abs(got - want).max())
    if not err_lt < TOLERANCE:
        raise AssertionError(f"LinearTransform.apply mismatch (max err "
                             f"{err_lt})")
    print(f"  LinearTransform.apply (bs {lt.bs}, gs {lt.gs}): ok (max err "
          f"{err_lt:.2e}) on {ctx.key_q.device}")
    return max(err, err_lt)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--n", type=int, default=2048, help="ring degree")
    a = ap.parse_args()
    demo(a.n, device=a.device)
    print("all encrypted-matmul examples passed")

"""CKKS on the u64 evaluator (the port of the JAX package's
examples/3_ckks.py): 40- and 30-bit primes, so every residue is a u64
word and every kernel is U1-U4.

Keys and encryptions draw from a torch.Generator; encode, encrypt,
multiply + relinearize + rescale, rotate, decrypt and decode, then the
N = 2048 single-level case (encrypt, add, decrypt).  Raises on a wrong
decryption, with the JAX example's tolerances.

    python phantom_tpu_torch/examples/ckks.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phantom_tpu_torch import (CKKSEncoder, EncryptionParameters,  # noqa: E402
                               make_context)
from phantom_tpu_torch.host import numth  # noqa: E402
from phantom_tpu_torch.schemes import evaluate, keys  # noqa: E402


def _check(got, want, atol: float, what: str) -> float:
    err = float(np.max(np.abs(got - want)))
    if not err <= atol:
        raise AssertionError(f"{what}: max err {err} > {atol}")
    return err


def ckks_demo(n=1024, scale_bits=30, device=None, seed=0):
    print(f"[CKKS u64] n={n}")
    qs = numth.get_primes(2 * n, 40, 2) + numth.get_primes(2 * n,
                                                           scale_bits, 2)
    ctx = make_context(EncryptionParameters.create(
        n, [qs[0], qs[2], qs[3]], [qs[1]]), device)
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    rlk = keys.gen_relin_key64(ctx, sk, gen)
    glk = keys.create_galois_keys64(ctx, sk, gen, steps=[1])
    enc = CKKSEncoder(ctx)
    scale = 2.0 ** scale_bits
    rg = np.random.default_rng(seed)
    x = rg.standard_normal(enc.slots)
    y = rg.standard_normal(enc.slots)
    ct_x = keys.encrypt_asymmetric64(ctx, pk, enc.encode(x, scale), gen)
    ct_y = keys.encrypt_asymmetric64(ctx, pk, enc.encode(y, scale), gen)
    ct = evaluate.rescale_to_next(
        ctx, evaluate.multiply_and_relin(ctx, ct_x, ct_y, rlk))
    err = _check(enc.decode(keys.decrypt64(ctx, sk, ct)).real, x * y, 1e-2,
                 "multiply")
    print(f"  mul+relin+rescale: ok (max err {err:.3e})")
    rot = evaluate.rotate_vector(ctx, ct_x, 1, glk)
    _check(enc.decode(keys.decrypt64(ctx, sk, rot)).real, np.roll(x, -1),
           1e-3, "rotate_vector")
    print(f"  rotate_vector(1): ok on {ctx.key_q.device}")


def ckks_small_param_demo(device=None, seed=5):
    n = 2048
    print(f"[CKKS u64] small-param n={n}")
    qs = numth.get_primes(2 * n, 40, 2)
    ctx = make_context(EncryptionParameters.create(n, qs[:1], qs[1:]),
                       device)
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    enc = CKKSEncoder(ctx)
    x = np.random.default_rng(7).standard_normal(enc.slots)
    ct = keys.encrypt_asymmetric64(ctx, pk, enc.encode(x, 2.0 ** 30), gen)
    got = enc.decode(keys.decrypt64(ctx, sk, evaluate.add(ctx, ct, ct)))
    _check(got.real, 2 * x, 1e-4, "small-param add")
    print("  enc/add/dec at n=2048: ok")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    dev = ap.parse_args().device
    ckks_demo(device=dev)
    ckks_small_param_demo(device=dev)
    print("all CKKS u64 examples passed")

"""BFV on the u64 evaluator (the port of the JAX package's
examples/1_bfv.py): four 40-bit primes, t the 20-bit batching prime, at
n = 1024, under each multiplication technique.

Encrypt and decrypt (with the noise budget), multiply + relinearize
(slot i -> i^2), rotate the rows by 3.  Raises on a wrong decryption.

    python phantom_tpu_torch/examples/bfv.py [--device cpu] [--mul-tech hps]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phantom_tpu_torch import (  # noqa: E402
    BatchEncoder, EncryptionParameters, make_context)
from phantom_tpu_torch.host.modulus import (CoeffModulus,  # noqa: E402
                                            PlainModulus)
from phantom_tpu_torch.schemes import evaluate, keys  # noqa: E402
from phantom_tpu_torch.schemes.params import MUL_TECHS  # noqa: E402


def _check(got, want, what: str) -> None:
    if not np.array_equal(np.asarray(got, dtype=object),
                          np.asarray(want, dtype=object)):
        raise AssertionError(f"{what}: wrong decryption")


def bfv_demo(n=1024, mul_tech="hps", device=None, seed=0):
    print(f"[BFV u64] n={n}, mul_tech={mul_tech}")
    coeff = CoeffModulus.create(n, [40, 40, 40, 40])
    t = PlainModulus.batching(n, 20)
    ctx = make_context(EncryptionParameters.create(
        n, coeff[:3], coeff[3:], "bfv", t, mul_tech=mul_tech), device)
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    rlk = keys.gen_relin_key64(ctx, sk, gen)
    glk = keys.create_galois_keys64(ctx, sk, gen, steps=[3])
    enc = BatchEncoder(ctx)
    vals = np.arange(n, dtype=np.int64) % t
    ct = keys.encrypt_asymmetric64(ctx, pk, enc.encode(vals), gen)
    _check(enc.decode(keys.decrypt64(ctx, sk, ct)), vals, "enc/dec")
    print(f"  enc/dec roundtrip: ok (noise budget "
          f"{keys.invariant_noise_budget64(ctx, sk, ct)} bits)")
    sq = evaluate.multiply_and_relin(ctx, ct, ct, rlk)
    _check(enc.decode(keys.decrypt64(ctx, sk, sq)),
           vals.astype(object) ** 2 % t, "multiply+relin")
    print(f"  multiply+relin (slot i -> i^2): ok (noise budget "
          f"{keys.invariant_noise_budget64(ctx, sk, sq)} bits)")
    rot = evaluate.rotate_rows(ctx, ct, 3, glk)
    _check(enc.decode(keys.decrypt64(ctx, sk, rot)),
           np.roll(vals.reshape(2, n // 2), -3, axis=1).ravel(),
           "rotate_rows")
    print("  rotate_rows(3): ok")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--mul-tech", choices=MUL_TECHS, action="append",
                    help="a multiplication technique (repeatable; default: "
                    "each of them)")
    args = ap.parse_args()
    for mt in args.mul_tech or MUL_TECHS:
        bfv_demo(1024, mt, args.device)
    print("all BFV u64 examples passed")

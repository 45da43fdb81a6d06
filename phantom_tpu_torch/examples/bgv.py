"""BGV on the u64 evaluator (the port of the JAX package's
examples/2_bgv.py): four 40-bit primes, t the 20-bit batching prime.

Encode, encrypt, multiply + relinearize, modulus switch (the plaintext
picks up the correction factor q_last^-1 mod t, which decryption takes
out), then an add of operands with unequal correction factors (balanced
first).  Raises on a wrong decryption.

    python phantom_tpu_torch/examples/bgv.py [--device cpu]
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


def _check(got, want, what: str) -> None:
    if not np.array_equal(np.asarray(got, dtype=object),
                          np.asarray(want, dtype=object)):
        raise AssertionError(f"{what}: wrong decryption")


def bgv_demo(n=1024, device=None, seed=0):
    print(f"[BGV u64] n={n}")
    coeff = CoeffModulus.create(n, [40, 40, 40, 40])
    t = PlainModulus.batching(n, 20)
    ctx = make_context(EncryptionParameters.create(
        n, coeff[:3], coeff[3:], "bgv", t), device)
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    rlk = keys.gen_relin_key64(ctx, sk, gen)
    enc = BatchEncoder(ctx)
    rg = np.random.default_rng(seed)
    a = rg.integers(0, t, n, dtype=np.int64)
    b = rg.integers(0, t, n, dtype=np.int64)
    ct_a = keys.encrypt_asymmetric64(ctx, pk, enc.encode(a), gen)
    ct_b = keys.encrypt_asymmetric64(ctx, pk, enc.encode(b), gen)
    ct = evaluate.mod_switch_to_next(
        ctx, evaluate.multiply_and_relin(ctx, ct_a, ct_b, rlk))
    ab = a.astype(object) * b.astype(object) % t
    _check(enc.decode(keys.decrypt64(ctx, sk, ct)), ab, "mul+relin+modswitch")
    print(f"  mul+relin+modswitch: ok (correction factor "
          f"{ct.correction_factor})")
    ms_a = evaluate.mod_switch_to_next(ctx, ct_a)
    prod = evaluate.multiply_and_relin(
        ctx, ms_a, evaluate.mod_switch_to_next(ctx, ct_b), rlk)
    s = evaluate.add(ctx, prod, ms_a)
    _check(enc.decode(keys.decrypt64(ctx, sk, s)), (ab + a) % t,
           "balanced add")
    print(f"  add with unequal correction factors: ok on "
          f"{ctx.key_q.device}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    bgv_demo(device=ap.parse_args().device)
    print("all BGV u64 examples passed")

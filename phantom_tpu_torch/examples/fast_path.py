"""The u32 fast path end to end: Fast32 runs every verb on the card
(the port of the JAX package's examples/7_fast_path.py).

Build the context once, wrap it in Fast32, and run encrypt -> (multiply
+ relin -> rescale)^2 -> rotate -> hoisted matvec -> decrypt without
leaving 32-bit residues.  Values go in and out through the
CKKSDeviceEncoder, the hoisted weights over QlP through the host
encoder's encode_extended; keys and encryption draw from a
torch.Generator.  Raises on a wrong decryption, with the JAX example's
tolerances.

    python phantom_tpu_torch/examples/fast_path.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phantom_tpu_torch import (CKKSDeviceEncoder, CKKSEncoder,  # noqa: E402
                               EncryptionParameters, Fast32, encode_extended,
                               make_context)
from phantom_tpu_torch.host import numth  # noqa: E402


def _check(got, want, atol: float, what: str) -> float:
    err = float(np.max(np.abs(got - want)))
    if not err <= atol:
        raise AssertionError(f"{what}: max err {err} > {atol}")
    return err


def fast_path_demo(n=2048, scale_bits=27, device=None, seed=0):
    print(f"[Fast32] CKKS n={n}, 32-bit residues")
    qs = numth.get_primes(2 * n, 28, 5)
    ps = numth.get_primes(2 * n, 29, 2)
    ctx = make_context(EncryptionParameters.create(n, qs, ps), device)
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    ev = Fast32(ctx)
    sk = ev.gen_secret_key(gen)
    pk = ev.gen_public_key(sk, gen)
    ev = Fast32(ctx, rlk=ev.gen_relin_key(sk, gen),
                glk=ev.create_galois_keys(sk, gen, steps=[1, 2]))
    enc = CKKSDeviceEncoder(ctx)
    scale = 2.0 ** scale_bits
    rg = np.random.default_rng(0)
    x = rg.standard_normal(enc.slots) * 0.5

    c = ev.encrypt_asymmetric(pk, enc.encode(x, scale), gen)
    # depth 2: (x^2)^2
    c = ev.rescale_to_next(ev.multiply_and_relin(c, c))
    c = ev.rescale_to_next(ev.multiply_and_relin(c, c))
    err = _check(enc.decode(ev.decrypt(sk, c)).real, x ** 4, 3e-2,
                 "depth-2 chain")
    print(f"  depth-2 square chain: ok (max err {err:.3e})")

    r = ev.rotate(c, 1)
    _check(enc.decode(ev.decrypt(sk, r)).real, np.roll(x ** 4, -1), 3e-2,
           "rotate")
    print(f"  rotate at chain index {r.chain_index}: ok")

    # the hoisted weighted rotation sum (the matvec primitive)
    c1 = ev.encrypt_asymmetric(pk, enc.encode(x, scale), gen)
    steps = [0, 1, 2]
    ws = [rg.standard_normal(enc.slots) * 0.5 for _ in steps]
    host = CKKSEncoder(ctx)
    pts = [encode_extended(host, w, scale, c1.chain_index) for w in ws]
    m = ev.rescale_to_next(ev.hoisted_linear_combo(c1, steps, pts, scale))
    want = sum(w * np.roll(x, -s) for w, s in zip(ws, steps))
    _check(enc.decode(ev.decrypt(sk, m)).real, want, 1e-2, "hoisted combo")
    print(f"  hoisted weighted rotation sum: ok on {ctx.key_q.device}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    fast_path_demo(device=ap.parse_args().device)
    print("all fast-path examples passed")

"""High-precision CKKS on 32-bit residues: paired-prime rescaling (the
port of the JAX package's examples/9_hiprec_ckks.py).

Every residue stays one 32-bit word (q < 2^30); precision comes from the
scale instead: about 2^44, each multiplication rescaled by a pair of
22-bit primes (two chain levels per multiplicative level), or 2^54 with
pairs of 27-bit primes (bench.py --hiprec's construction).  Raises unless
x^2 at 2^44 is within 1e-6, x^4 within 1e-5 and x^2 at 2^54 within
1e-9, the JAX example's bounds.  Values go in and out through the host
CKKSEncoder, as in the JAX example: the device decoder multiplies by the
f32 word of 1/scale, which after a rescale by a prime is off by up to
2^-24 relative, more than the 2^54 bound allows.

    python phantom_tpu_torch/examples/hiprec_ckks.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phantom_tpu_torch import (CKKSEncoder,  # noqa: E402
                               EncryptionParameters, Fast32, make_context)
from phantom_tpu_torch.host import numth  # noqa: E402


def _setup(n, data, special, device, seed):
    ctx = make_context(EncryptionParameters.create(n, data, special), device)
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    ev = Fast32(ctx)
    sk = ev.gen_secret_key(gen)
    pk = ev.gen_public_key(sk, gen)
    ev = Fast32(ctx, rlk=ev.gen_relin_key(sk, gen))
    return ev, sk, pk, gen, CKKSEncoder(ctx)


def _square_twice_rescaled(ev, c):
    c = ev.multiply_and_relin(c, c)
    return ev.rescale_to_next(ev.rescale_to_next(c))


def _check(err: float, bound: float, what: str) -> None:
    if not err < bound:
        raise AssertionError(f"{what}: err {err} >= {bound}")


def hiprec_demo(n=8192, device=None):
    print(f"[hiprec] CKKS n={n}, scale 2^44 on 32-bit residues (paired "
          "22-bit rescale primes)")
    # the product before each double rescale is at scale 2^88, so the
    # data modulus keeps 88 bits above q0 at every multiplicative level:
    # q0 + 6 x 22 = 160 -> 116 -> 72 bits over the two levels
    qs28 = numth.get_primes(2 * n, 28, 3)   # q0 and the two special primes
    rs = numth.get_primes(2 * n, 22, 6)     # three pairs
    ev, sk, pk, gen, enc = _setup(n, qs28[:1] + rs, qs28[1:], device, 9)
    x = np.random.default_rng(1).uniform(-1.0, 1.0, enc.slots)
    c = ev.encrypt_asymmetric(pk, enc.encode(x, 2.0 ** 44), gen)
    c = _square_twice_rescaled(ev, c)
    err = float(np.max(np.abs(enc.decode(ev.decrypt(sk, c)).real - x ** 2)))
    _check(err, 1e-6, "x^2 at scale 2^44")
    print(f"  x^2 @ 2^44, double rescale: ok (max err {err:.2e})")
    c = _square_twice_rescaled(ev, c)
    err4 = float(np.max(np.abs(enc.decode(ev.decrypt(sk, c)).real - x ** 4)))
    _check(err4, 1e-5, "x^4 at scale ~2^44")
    print(f"  x^4 @ ~2^44, second paired rescale: ok (max err {err4:.2e})")


def hiprec54_demo(n=8192, device=None):
    """The bench.py --hiprec construction: 27-bit pairs at scale 2^54 (the
    N = 2^16 prime pool has no 22-bit NTT-friendly primes)."""
    print(f"[hiprec54] CKKS n={n}, scale 2^54 (paired 27-bit primes)")
    q0 = numth.get_primes(2 * n, 28, 1)
    rs = numth.get_primes(2 * n, 27, 4)     # two pairs
    ps = numth.get_primes(2 * n, 29, 2)
    ev, sk, pk, gen, enc = _setup(n, q0 + rs, ps, device, 11)
    x = np.random.default_rng(3).uniform(-1.0, 1.0, enc.slots)
    c = ev.encrypt_asymmetric(pk, enc.encode(x, 2.0 ** 54), gen)
    c = _square_twice_rescaled(ev, c)
    err = float(np.max(np.abs(enc.decode(ev.decrypt(sk, c)).real - x ** 2)))
    _check(err, 1e-9, "x^2 at scale 2^54")
    print(f"  x^2 @ 2^54, double 27-bit rescale: ok (max err {err:.2e}) on "
          f"{enc.ctx.key_q.device}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--n", type=int, default=8192)
    a = ap.parse_args()
    hiprec_demo(a.n, a.device)
    hiprec54_demo(a.n, a.device)
    print("all high-precision examples passed")

"""Encrypted MLP inference: LinearTransform layers down the chain (the
port of the JAX package's examples/11_mlp_inference.py).

A two-layer network y = W2 @ (W1 @ x)^2 under CKKS: each layer is a
`LinearTransform` (Halevi-Shoup diagonals, BSGS rotations, one shared
modup per layer), the square activation one relinearized multiply.  x
goes in and y comes out through the CKKSDeviceEncoder; keys and
encryption draw from a torch.Generator.  `mlp_demo` runs it on Fast32;
`mlp_u64_demo` runs it on the u64 evaluator (`LinearTransform.apply`,
the chain built with make_context(..., u64=True)) and on Fast32 from the
same generator state, and asserts the two outputs bit-identical, as the
JAX example does.  The decoded output is checked against numpy's
float64 evaluation (raises beyond TOLERANCE).

    python phantom_tpu_torch/examples/mlp_inference.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phantom_tpu_torch import (CKKSDeviceEncoder, CKKSEncoder,  # noqa: E402
                               EncryptionParameters, Fast32, LinearTransform,
                               make_context)
from phantom_tpu_torch.host import numth  # noqa: E402
from phantom_tpu_torch.schemes import evaluate, keys  # noqa: E402

SCALE = 2.0 ** 26
TOLERANCE = 1e-2  # the JAX example's


def mlp_demo(n=1024, d=16, device=None, seed=23):
    """The network at ring degree n and width d; returns the largest error
    of the decoded output against numpy."""
    print(f"[mlp] n={n}: {d}->{d}->{d} network, square activation")
    # three levels (layer 1, the square, layer 2): q0 q1 q2 q3 | p
    qs = numth.get_primes(2 * n, 28, 5)
    ctx = make_context(EncryptionParameters.create(n, qs[:4], qs[4:]),
                       device)
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    ev = Fast32(ctx)
    sk = ev.gen_secret_key(gen)
    pk = ev.gen_public_key(sk, gen)
    rlk = ev.gen_relin_key(sk, gen)

    rg = np.random.default_rng(7)
    W1 = rg.standard_normal((d, d)) * 0.3
    W2 = rg.standard_normal((d, d)) * 0.3
    W2[rg.random((d, d)) < 0.3] = 0.0     # a sparse head
    x = rg.standard_normal(d) * 0.5
    lt1, lt2 = LinearTransform(W1), LinearTransform(W2)
    steps = sorted(set(lt1.steps_required()) | set(lt2.steps_required()))
    ev = Fast32(ctx, rlk=rlk, glk=ev.create_galois_keys(sk, gen, steps))
    # layer 1 at chain index 1, the square at 2, layer 2 at 3; the
    # weights go over QlP through the host encoder
    host = CKKSEncoder(ctx)
    lt1.prepare(host, SCALE, chain_index=1)
    lt2.prepare(host, SCALE, chain_index=3)
    enc = CKKSDeviceEncoder(ctx)
    ct = ev.encrypt_asymmetric(pk, lt1.encode_input(enc, x, SCALE), gen)

    h = lt1.apply_fast32(ev, ct)
    h = ev.rescale_to_next(ev.square_and_relin(h))
    y = lt2.apply_fast32(ev, h)
    got = enc.decode(ev.decrypt(sk, y)).real
    want = W2 @ (W1 @ x) ** 2
    err = float(np.max(np.abs(got[:d] - want)))
    if not err < TOLERANCE:
        raise AssertionError(f"MLP output mismatch (max err {err})")
    # the output stays d-periodic, so it composes into a next layer
    per = float(np.max(np.abs(got[d:2 * d] - got[:d])))
    if not per < TOLERANCE:
        raise AssertionError(f"output not d-periodic (max diff {per})")
    print(f"  fast32 path: ok (max err {err:.2e}; {len(steps)} Galois keys "
          f"for {2 * d} diagonals) on {ctx.key_q.device}")
    return err


def mlp_u64_demo(n=1024, d=16, device=None, seed=23):
    """The network on the u64 evaluator and on Fast32, bit-identical;
    returns the largest error of the decoded output against numpy."""
    print(f"[mlp] n={n}: {d}->{d}->{d} network on the u64 evaluator")
    qs = numth.get_primes(2 * n, 28, 5)
    params = EncryptionParameters.create(n, qs[:4], qs[4:])
    ctx, ctx64 = (make_context(params, device, u64=u64)
                  for u64 in (False, True))
    rg = np.random.default_rng(7)
    W1 = rg.standard_normal((d, d)) * 0.3
    W2 = rg.standard_normal((d, d)) * 0.3
    W2[rg.random((d, d)) < 0.3] = 0.0
    x = rg.standard_normal(d) * 0.5
    want = W2 @ (W1 @ x) ** 2
    outs = []
    for c in (ctx64, ctx):
        lt1, lt2 = LinearTransform(W1), LinearTransform(W2)
        steps = sorted(set(lt1.steps_required())
                       | set(lt2.steps_required()))
        host = CKKSEncoder(c)
        lt1.prepare(host, SCALE, chain_index=1)
        lt2.prepare(host, SCALE, chain_index=3)
        enc = CKKSDeviceEncoder(c)
        pt = lt1.encode_input(enc, x, SCALE)
        gen = torch.Generator(device=c.key_q.device).manual_seed(seed)
        if c is ctx64:
            sk = keys.gen_secret_key64(c, gen)
            pk = keys.gen_public_key64(c, sk, gen)
            rlk = keys.gen_relin_key64(c, sk, gen)
            glk = keys.create_galois_keys64(c, sk, gen, steps=steps)
            ct = keys.encrypt_asymmetric64(c, pk, pt, gen)
            h = lt1.apply(c, ct, glk)
            h = evaluate.rescale_to_next(
                c, evaluate.multiply_and_relin(c, h, h, rlk))
            y = lt2.apply(c, h, glk)
            got = enc.decode(keys.decrypt64(c, sk, y)).real
        else:
            ev = Fast32(c)
            sk = ev.gen_secret_key(gen)
            pk = ev.gen_public_key(sk, gen)
            ev = Fast32(c, rlk=ev.gen_relin_key(sk, gen),
                        glk=ev.create_galois_keys(sk, gen, steps))
            ct = ev.encrypt_asymmetric(pk, pt, gen)
            h = ev.rescale_to_next(ev.square_and_relin(lt1.apply_fast32(
                ev, ct)))
            y = lt2.apply_fast32(ev, h)
            got = enc.decode(ev.decrypt(sk, y)).real
        err = float(np.max(np.abs(got[:d] - want)))
        if not err < TOLERANCE:
            raise AssertionError(f"MLP output mismatch (max err {err})")
        outs.append((y, err))
    (y64, err), (y32, _) = outs
    if not (torch.equal(y64.data, y32.data.long())
            and (y64.scale, y64.chain_index) == (y32.scale,
                                                 y32.chain_index)):
        raise AssertionError("Fast32 MLP output differs from the u64 "
                             "evaluator's")
    print(f"  u64 path: ok (max err {err:.2e}); fast32 path bit-identical "
          f"to it on {ctx.key_q.device}")
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    a = ap.parse_args()
    mlp_demo(1024, device=a.device)
    mlp_u64_demo(1024, device=a.device)
    print("all mlp-inference examples passed")

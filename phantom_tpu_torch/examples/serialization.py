"""Serialization on the u64 evaluator (the port of the JAX package's
examples/4_serialization.py, reference examples/serialization.cu:201-456):
BFV at n = 1024, three 40-bit primes, t the 16-bit batching prime.

A public-key encryption through the package's own format (`PTCT`) and
back, a seed-compressed symmetric encryption (`PTCS`: c0 and a 64-byte
seed, c1 regenerated by the reference's Salsa20 sampler, S1 on the card),
and the same ciphertext, the keys and a plaintext through the reference's
wire format.  Raises on a wrong decryption or a byte that does not
survive.

    python phantom_tpu_torch/examples/serialization.py [--device cpu]
"""

import argparse
import io
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
from phantom_tpu_torch.schemes import keys  # noqa: E402
from phantom_tpu_torch.utils import refformat as ref  # noqa: E402
from phantom_tpu_torch.utils import serialize as ser  # noqa: E402


def _check(ctx, sk, enc, ct, vals, what: str) -> None:
    got = enc.decode(keys.decrypt64(ctx, sk, ct))
    if not np.array_equal(got, vals):
        raise AssertionError(f"{what}: wrong decryption")


def demo(n=1024, device=None, seed=0):
    print(f"[serialization] n={n}")
    coeff = CoeffModulus.create(n, [40, 40, 40])
    t = PlainModulus.batching(n, 16)
    ctx = make_context(EncryptionParameters.create(
        n, coeff[:2], coeff[2:], "bfv", t), device)
    gen = torch.Generator(device=ctx.key_q.device).manual_seed(seed)
    sk = keys.gen_secret_key64(ctx, gen)
    pk = keys.gen_public_key64(ctx, sk, gen)
    enc = BatchEncoder(ctx)
    vals = np.arange(n, dtype=np.uint64) % t

    ct = keys.encrypt_asymmetric64(ctx, pk, enc.encode(vals), gen)
    blob = ser.to_bytes(ct)
    _check(ctx, sk, enc, ser.from_bytes(blob, ctx), vals, "PTCT")
    print(f"  ciphertext roundtrip: ok ({len(blob)} bytes)")

    ct_s, seed_words = ser.encrypt_symmetric_compressed(
        ctx, sk, enc.encode(vals), gen)
    buf = io.BytesIO()
    ser.save_ciphertext_symmetric(ct_s, seed_words, buf)
    back = ser.from_bytes(buf.getvalue(), ctx)
    if not torch.equal(back.data, ct_s.data):
        raise AssertionError("PTCS: c1 not regenerated bit for bit")
    _check(ctx, sk, enc, back, vals, "PTCS")
    print(f"  seed-compressed symmetric: ok ({buf.tell()} bytes, "
          f"{buf.tell() * 100 // len(blob)}% of full)")

    buf = io.BytesIO()
    ref.save_ciphertext_symmetric_ref(ct_s, ser.seed_bytes(seed_words), buf)
    buf.seek(0)
    back = ref.load_ciphertext_symmetric_ref(ctx, buf)
    if not torch.equal(back.data, ct_s.data):
        raise AssertionError("reference format: seed-compressed load differs")
    for save, load, obj in ((ref.save_secret_key_ref, ref.load_secret_key_ref,
                             sk),
                            (ref.save_public_key_ref, ref.load_public_key_ref,
                             pk)):
        buf = io.BytesIO()
        save(obj, buf)
        buf.seek(0)
        if not torch.equal(load(buf, ctx.key_q.device), obj):
            raise AssertionError(f"reference format: {save.__name__}")
    print("  reference wire format (seeded ciphertext, secret and public "
          "keys): ok")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    demo(device=ap.parse_args().device)
    print("all serialization examples passed")

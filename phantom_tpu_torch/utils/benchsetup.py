"""The bench setup: context, keys and ciphertexts, disk-cached
(counterpart of phantom_tpu/utils/benchsetup.py).

`setup_bench` builds the parameter set exactly as the JAX package's does
(`bench_params`: the same primes, plain modulus, multiplication
technique, scale and high-precision chain; `chain_primes` is the one
copy of the chain's primes that chip_smoke.chain_params and
parallel/launch.step_params use too), encodes the same `values`
(numpy's default_rng(seed)), so the parameters and the plaintext are
bit-equal to the JAX package's, and makes the keys and two encryptions
on the u64 evaluator (schemes/keys.py's *64 functions, U1-U4 on the
card) from seeded torch.Generators, one a stream as the JAX package
splits its PRNG key: secret, public, relin, Galois, ct1, ct2.  The port
cannot draw JAX's threefry bits, so its keys and ciphertexts differ from
the JAX package's; decryption holds them.  The arrays go to the port's
own cache (utils/benchcache.py); a later call with the same
configuration rebuilds the context and loads them (`_rebuild`, which
takes the JAX package's uint64 cache arrays as well).

Every chain runs on the u64 evaluator (make_context(..., u64=True)), as
the JAX package's generic evaluator does, 28-bit primes included.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import List, Tuple

import numpy as np
import torch

from . import benchcache

_CT_META = ("chain_index", "is_ntt_form", "scale", "correction_factor",
            "noise_scale_deg")
# the JAX package's multech names -> the port's mul_tech
MULTECH = {"hps": "hps", "behz": "behz", "overq": "hps_overq",
           "leveled": "hps_overq_leveled"}
# one torch.Generator a stream, seeded seed * STREAMS + stream
STREAMS = ("sk", "pk", "rlk", "glk", "ct1", "ct2")


def chain_primes(n: int, limbs: int, alpha: int, bits: int = 28,
                 hiprec: bool = False) -> Tuple[List[int], List[int]]:
    """(data primes, special primes) as the JAX bench builds them: `limbs`
    data primes of `bits` bits and `alpha` special primes of bits + 1; or
    (hiprec) one 28-bit q0, limbs - 1 primes of 27 bits (the rescale's
    pairs) and alpha special primes of 29 bits."""
    from ..host import numth
    if hiprec:
        if (limbs - 1) % 2:
            raise ValueError("hiprec: limbs = q0 + prime pairs")
        return (numth.get_primes(2 * n, 28, 1)
                + numth.get_primes(2 * n, 27, limbs - 1),
                numth.get_primes(2 * n, 29, alpha))
    qs = numth.get_primes(2 * n, bits, limbs + 1)
    return qs[:limbs], numth.get_primes(2 * n, bits + 1, alpha)


def bench_params(scheme: str, n: int, limbs: int, alpha: int, bits: int,
                 multech: str = "hps", hiprec: bool = False):
    """The EncryptionParameters of the JAX bench's configuration: BFV and
    BGV take the largest max(16, log2 n + 3)-bit prime == 1 mod 2n as t,
    BFV multiplies by `multech`."""
    from ..host.modulus import PlainModulus
    from ..schemes.params import EncryptionParameters
    if scheme not in ("ckks", "bfv", "bgv"):
        raise ValueError(f"scheme {scheme!r} not in ckks, bfv, bgv")
    if hiprec and scheme != "ckks":
        raise ValueError("hiprec is a CKKS mode")
    qs, ps = chain_primes(n, limbs, alpha, bits, hiprec)
    if scheme == "ckks":
        return EncryptionParameters.create(n, qs, ps)
    tbits = max(16, n.bit_length() + 3)
    return EncryptionParameters.create(
        n, qs, ps, scheme, PlainModulus.batching(n, tbits),
        mul_tech=MULTECH[multech] if scheme == "bfv" else "hps")


def _gen(device: torch.device, seed: int, stream: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed * len(STREAMS) + STREAMS.index(stream))
    return g


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A cache array on `device`: unsigned words (the JAX package's
    uint64) as the int64 tensor of their bits, the port's own as they
    are."""
    from ..convert import words
    t = words(a) if a.dtype.kind == "u" else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(device)


def _rebuild(ctx, arrays: dict, meta: dict, device) -> dict:
    """A cache entry's arrays and metadata -> the port's objects on
    `device`: sk (K, N), pk (2, K, N), rlk (dnum, 2, K, N) tensors, glk
    (keys.GaloisKeys, where the entry has one), pt (Plaintext), ct1, ct2
    (Ciphertext).  The entry may be the port's (int64 or int32 arrays) or
    the JAX package's (uint64 arrays, convert.py's words)."""
    from ..schemes.ciphertext import Ciphertext, Plaintext
    from ..schemes.keys import GaloisKeys
    ctx.require_u64("the bench setup")
    out = {k: _tensor(arrays[k], device) for k in ("sk", "pk", "rlk")}
    out["glk"] = (GaloisKeys(_tensor(arrays["glk"], device),
                             tuple(int(e) for e in meta["glk_elts"]))
                  if "glk" in arrays else None)
    p = meta["pt"]
    out["pt"] = Plaintext(data=_tensor(arrays["pt"], device),
                          chain_index=int(p["chain_index"]),
                          is_ntt_form=bool(p["is_ntt_form"]),
                          scale=float(p["scale"]))
    for name in ("ct1", "ct2"):
        m = meta[name]
        out[name] = Ciphertext(
            data=_tensor(arrays[name], device),
            chain_index=int(m["chain_index"]),
            is_ntt_form=bool(m["is_ntt_form"]), scale=float(m["scale"]),
            correction_factor=int(m["correction_factor"]),
            noise_scale_deg=int(m["noise_scale_deg"]))
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def setup_bench(scheme: str = "ckks", n: int = 65536, limbs: int = 28,
                alpha: int = 14, bits: int = 28, multech: str = "hps",
                galois_steps=(), seed: int = 0, verbose: bool = True,
                hiprec: bool = False, device=None) -> SimpleNamespace:
    """Build (or load) the bench setup on `device` (default the CUDA
    device; without one, pass device="cpu").

    Returns a SimpleNamespace with params, ctx, sk, pk, rlk, glk (None
    unless galois_steps), pt, ct1, ct2, enc, values (the encoded
    payload), scale (CKKS; 1.0 otherwise), cached (bool), path (the cache
    blob), and times: seconds of the context build ("context"), and of
    keygen, encryption and the blob's save ("keys", "encrypt", "save") on
    a fresh setup or of the load ("load") on a cached one (device work
    synchronized).
    """
    from ..schemes import keys
    from ..schemes.batch_encoder import BatchEncoder
    from ..schemes.ckks_encoder import CKKSEncoder
    from ..schemes.context import make_context, resolve_device

    def log(msg):
        if verbose:
            print(msg, file=sys.stderr, flush=True)

    dev = resolve_device(device)
    times = {}
    t0 = time.perf_counter()
    params = bench_params(scheme, n, limbs, alpha, bits, multech, hiprec)
    ctx = make_context(params, device=dev, u64=True)
    _sync(dev)
    times["context"] = time.perf_counter() - t0
    log(f"# context built in {times['context']:.1f}s (scheme={scheme}, "
        f"n={n}, L={limbs}, alpha={alpha}, {dev.type})")

    if scheme == "ckks":
        enc = CKKSEncoder(ctx)
        scale = 2.0 ** 54 if hiprec else 2.0 ** (bits - 6)
        values = np.random.default_rng(seed).standard_normal(enc.slots)
    else:
        enc = BatchEncoder(ctx)
        scale = 1.0
        values = np.random.default_rng(seed).integers(
            0, params.plain_modulus, n, dtype=np.uint64)

    cfg = dict(scheme=scheme, n=n, limbs=limbs, alpha=alpha,
               bits=(27 if hiprec else bits),
               multech=(multech if scheme == "bfv" else
                        "hiprec" if hiprec else ""),
               galois_steps=list(galois_steps), seed=seed, device=dev.type)
    path = benchcache.cache_path(**cfg)
    done = dict(params=params, ctx=ctx, enc=enc, values=values, scale=scale,
                path=path, times=times)
    t0 = time.perf_counter()
    hit = benchcache.load_setup(verbose, **cfg)
    if hit is not None:
        objs = _rebuild(ctx, *hit, dev)
        _sync(dev)
        times["load"] = time.perf_counter() - t0
        log(f"# keys+encrypt loaded from cache in {times['load']:.2f}s "
            f"({path})")
        return SimpleNamespace(**objs, **done, cached=True)

    t0 = time.perf_counter()
    sk = keys.gen_secret_key64(ctx, _gen(dev, seed, "sk"))
    pk = keys.gen_public_key64(ctx, sk, _gen(dev, seed, "pk"))
    rlk = keys.gen_relin_key64(ctx, sk, _gen(dev, seed, "rlk"))
    glk = None
    if galois_steps:
        glk = keys.create_galois_keys64(ctx, sk, _gen(dev, seed, "glk"),
                                        steps=list(galois_steps))
    _sync(dev)
    times["keys"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pt = enc.encode(values, scale) if scheme == "ckks" else enc.encode(values)
    ct1, ct2 = (keys.encrypt_asymmetric64(ctx, pk, pt, _gen(dev, seed, s))
                for s in ("ct1", "ct2"))
    _sync(dev)
    times["encrypt"] = time.perf_counter() - t0
    log(f"# keys generated in {times['keys']:.1f}s, encode + two "
        f"encryptions in {times['encrypt']:.1f}s")

    arrays = {"sk": sk, "pk": pk, "rlk": rlk, "pt": pt.data,
              "ct1": ct1.data, "ct2": ct2.data}
    meta = {"pt": {"chain_index": pt.chain_index,
                   "is_ntt_form": pt.is_ntt_form, "scale": pt.scale},
            "ct1": {f: getattr(ct1, f) for f in _CT_META},
            "ct2": {f: getattr(ct2, f) for f in _CT_META}}
    if glk is not None:
        arrays["glk"] = glk.data
        meta["glk_elts"] = list(glk.elts)
    t0 = time.perf_counter()
    benchcache.save_setup({k: _numpy(v) for k, v in arrays.items()}, meta,
                          **cfg)
    times["save"] = time.perf_counter() - t0
    return SimpleNamespace(sk=sk, pk=pk, rlk=rlk, glk=glk, pt=pt, ct1=ct1,
                           ct2=ct2, **done, cached=False)


def ensure_galois(s, scheme: str, n: int, limbs: int, alpha: int,
                  bits: int = 28, steps=(1,), seed: int = 0,
                  verbose: bool = True):
    """Load or make the Galois keys of `steps` for a setup_bench result `s`
    (an entry of its own, so the main setup is reused when a bench later
    needs rotation keys); sets and returns s.glk."""
    from ..schemes import keys
    from ..schemes.keys import GaloisKeys
    ctx = s.ctx
    dev = ctx.key_q.device
    elts = keys.galois_elts(ctx, list(steps))
    if s.glk is not None and tuple(s.glk.elts) == elts:
        return s.glk
    cfg = dict(kind="glk", scheme=scheme, n=n, limbs=limbs, alpha=alpha,
               bits=bits, steps=list(steps), seed=seed, device=dev.type)
    hit = benchcache.load_setup(verbose, **cfg)
    if hit is not None:
        arrays, meta = hit
        s.glk = GaloisKeys(_tensor(arrays["glk"], dev),
                           tuple(int(e) for e in meta["glk_elts"]))
        if verbose:
            print("# galois keys loaded from cache", file=sys.stderr)
        return s.glk
    t0 = time.perf_counter()
    glk = keys.create_galois_keys64(ctx, s.sk, _gen(dev, seed, "glk"),
                                    steps=list(steps))
    _sync(dev)
    if verbose:
        print(f"# galois keys generated in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
    benchcache.save_setup({"glk": _numpy(glk.data)},
                          {"glk_elts": list(glk.elts)}, **cfg)
    s.glk = glk
    return glk

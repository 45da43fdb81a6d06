"""The package's own binary format for plaintexts, ciphertexts and keys
(counterpart of phantom_tpu/utils/serialize.py): a 4-byte magic, a
version byte, little-endian header fields, then each array as its rank,
its shape and its u64 words; plus seed-compressed symmetric ciphertexts
(`PTCS`) that store c0 and a seed and regenerate c1 = uniform(seed) on
load (reference: save_symmetric / load_symmetric,
include/ciphertext.h:216-307).

For the same arrays the port writes the JAX writers' bytes for `PTCT`,
`PTPT` and `PTKY`.  Keys are the port's tensors (the secret key (K, N),
the public key (2, K, N), the relin key (dnum, 2, K, N), told apart by
their rank) and `keys.GaloisKeys`; the kind byte is the JAX package's.

`PTCS` differs.  The JAX package stores its threefry key (2 words) and
draws c1 from it; the port draws from `torch.Generator`, whose CPU and
CUDA streams differ, so neither can stand for a portable seed.  The port
draws a 64-byte seed from the caller's generator, makes c1 from it with
the reference's Salsa20 uniform sampler (S1 on the card,
utils/salsa20.py), and stores its 16 words in the format's
`seed_len`-prefixed field.  A JAX-written `PTCS` blob (seed_len 2) is
refused with a ValueError that says so.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO

import numpy as np
import torch

from ..schemes.ciphertext import Ciphertext, Plaintext
from ..schemes.keyswitch import KERNELS64, Kernels64
from . import refformat, salsa20

_MAGIC_CT = b"PTCT"
_MAGIC_PT = b"PTPT"
_MAGIC_KEY = b"PTKY"
_MAGIC_CTS = b"PTCS"  # seed-compressed symmetric ciphertext
_VERSION = 1
SEED_WORDS = salsa20.SEED_BYTES // 4  # the port's PTCS seed: 16 u32 words
JAX_SEED_WORDS = 2  # the JAX package's PTCS seed: a threefry key
KEY_KINDS = ("secret", "public", "relin", "galois")


def _w(f: BinaryIO, fmt: str, *vals):
    f.write(struct.pack("<" + fmt, *vals))


def _r(f: BinaryIO, fmt: str):
    size = struct.calcsize("<" + fmt)
    raw = f.read(size)
    if len(raw) != size:
        raise ValueError("truncated header")
    return struct.unpack("<" + fmt, raw)


def _magic(f: BinaryIO, want: bytes, what: str) -> None:
    got = f.read(4)
    if got != want:
        raise ValueError(f"bad {what} magic {got!r} (want {want!r})")
    _r(f, "B")  # version


def _write_array(f: BinaryIO, x: torch.Tensor):
    _w(f, "B", x.dim())
    for d in x.shape:
        _w(f, "q", d)
    refformat.write_words(f, x)


def _read_array(f: BinaryIO, device) -> torch.Tensor:
    (ndim,) = _r(f, "B")
    shape = tuple(_r(f, "q")[0] for _ in range(ndim))
    count = int(np.prod(shape)) if shape else 1
    return refformat.read_words(f, count, device).view(shape)


def _ct_fields(f: BinaryIO, ct: Ciphertext) -> None:
    _w(f, "qBdqq", ct.chain_index, int(ct.is_ntt_form), ct.scale,
       ct.correction_factor, ct.noise_scale_deg)


# -- ciphertext -------------------------------------------------------------

def save_ciphertext(ct: Ciphertext, f: BinaryIO):
    f.write(_MAGIC_CT)
    _w(f, "B", _VERSION)
    _ct_fields(f, ct)
    _write_array(f, ct.data)


def load_ciphertext(f: BinaryIO, device=None) -> Ciphertext:
    _magic(f, _MAGIC_CT, "ciphertext")
    chain_index, ntt_form, scale, corr, nsd = _r(f, "qBdqq")
    data = _read_array(f, refformat.load_device(device))
    return Ciphertext(data=data, chain_index=int(chain_index),
                      is_ntt_form=bool(ntt_form), scale=float(scale),
                      correction_factor=int(corr), noise_scale_deg=int(nsd))


# -- seed-compressed symmetric ciphertext -----------------------------------

def seed_bytes(seed) -> bytes:
    """A PTCS seed (16 u32 words) as the sampler's 64 bytes."""
    s = np.asarray(seed, dtype=np.uint32).ravel()
    if s.size != SEED_WORDS:
        raise ValueError(f"a seed of {s.size} words; the port's PTCS seed "
                         f"has {SEED_WORDS}")
    return s.astype("<u4").tobytes()


def encrypt_symmetric_compressed(ctx, sk: torch.Tensor, plain: Plaintext,
                                 gen: torch.Generator,
                                 ops: Kernels64 = KERNELS64):
    """Symmetric encryption returning (ciphertext, seed): a 64-byte seed
    drawn from `gen` (16 u32 words, numpy), c1 the reference's Salsa20
    uniform sample of it (S1), the noise drawn from `gen` after the seed
    (refformat.encrypt_symmetric_seeded).  Only c0 and the 64 bytes
    travel (reference: encrypt_zero_symmetric's seed path,
    secretkey.cu:232)."""
    words = torch.randint(0, 1 << 32, (SEED_WORDS,), generator=gen,
                          device=gen.device).cpu().numpy().astype(np.uint32)
    ct = refformat.encrypt_symmetric_seeded(ctx, sk, plain,
                                            seed_bytes(words), gen, ops)
    return ct, words


def save_ciphertext_symmetric(ct: Ciphertext, seed, f: BinaryIO):
    """Store c0 and the seed only."""
    f.write(_MAGIC_CTS)
    _w(f, "B", _VERSION)
    _ct_fields(f, ct)
    s = np.asarray(seed, dtype=np.uint32).ravel()
    _w(f, "B", s.size)
    f.write(s.astype("<u4").tobytes())
    _write_array(f, ct.data[0])


def load_ciphertext_symmetric(f: BinaryIO, ctx,
                              ops: Kernels64 = KERNELS64) -> Ciphertext:
    """c1 = the Salsa20 uniform sample of the seed over the ciphertext's
    level (S1, NTT form; U1's inverse out of NTT form), on the context's
    device."""
    _magic(f, _MAGIC_CTS, "compressed-ciphertext")
    chain_index, ntt_form, scale, corr, nsd = _r(f, "qBdqq")
    (seed_len,) = _r(f, "B")
    if seed_len == JAX_SEED_WORDS:
        raise ValueError(
            "a PTCS blob with a 2-word seed was written by the JAX package: "
            "its seed is a threefry key, from which the port cannot "
            "regenerate c1 (the port's PTCS seed is 16 words for the "
            "reference's Salsa20 sampler)")
    if seed_len != SEED_WORDS:
        raise ValueError(f"a PTCS seed of {seed_len} words; the port's has "
                         f"{SEED_WORDS}")
    raw = f.read(4 * seed_len)
    if len(raw) != 4 * seed_len:
        raise ValueError("truncated seed")
    ctx.require_u64("load_ciphertext_symmetric")
    c0 = _read_array(f, ctx.key_q.device)
    cd = ctx.get_context_data(int(chain_index))
    if c0.shape != (cd.size_ql, ctx.params.n):
        raise ValueError(f"c0 {tuple(c0.shape)} against chain index "
                         f"{chain_index}'s ({cd.size_ql}, {ctx.params.n})")
    a = refformat.regenerate_c1(ctx, cd, raw, bool(ntt_form), ops)
    return Ciphertext(data=torch.stack([c0, a]), chain_index=int(chain_index),
                      is_ntt_form=bool(ntt_form), scale=float(scale),
                      correction_factor=int(corr), noise_scale_deg=int(nsd))


# -- plaintext --------------------------------------------------------------

def save_plaintext(pt: Plaintext, f: BinaryIO):
    f.write(_MAGIC_PT)
    _w(f, "B", _VERSION)
    _w(f, "qBd", pt.chain_index, int(pt.is_ntt_form), pt.scale)
    _write_array(f, pt.data)


def load_plaintext(f: BinaryIO, device=None) -> Plaintext:
    _magic(f, _MAGIC_PT, "plaintext")
    chain_index, ntt_form, scale = _r(f, "qBd")
    data = _read_array(f, refformat.load_device(device))
    return Plaintext(data=data, chain_index=int(chain_index),
                     is_ntt_form=bool(ntt_form), scale=float(scale))


# -- keys -------------------------------------------------------------------

def key_kind(key_obj) -> int:
    """The JAX package's kind byte: 0 secret (K, N), 1 public (2, K, N),
    2 relin (dnum, 2, K, N), 3 Galois (keys.GaloisKeys)."""
    from ..schemes.keys import GaloisKeys
    if isinstance(key_obj, GaloisKeys):
        return 3
    if isinstance(key_obj, torch.Tensor) and 2 <= key_obj.dim() <= 4:
        return key_obj.dim() - 2
    raise ValueError("a key is a (K, N), (2, K, N) or (dnum, 2, K, N) "
                     "tensor or a GaloisKeys")


def save_key(key_obj, f: BinaryIO):
    """Secret, public, relin or Galois key: the kind, the Galois elements
    (Galois keys), the key's array (reference: secretkey.h:85-389)."""
    f.write(_MAGIC_KEY)
    _w(f, "B", _VERSION)
    kind = key_kind(key_obj)
    _w(f, "B", kind)
    if kind == 3:
        _w(f, "q", len(key_obj.elts))
        for e in key_obj.elts:
            _w(f, "q", e)
        key_obj = key_obj.data
    _write_array(f, key_obj)


def load_key(f: BinaryIO, device=None):
    """The key's tensor, or a GaloisKeys."""
    from ..schemes.keys import GaloisKeys
    _magic(f, _MAGIC_KEY, "key")
    (kind,) = _r(f, "B")
    if kind >= len(KEY_KINDS):
        raise ValueError(f"unknown key kind {kind}")
    elts = ()
    if kind == 3:
        (num,) = _r(f, "q")
        elts = tuple(_r(f, "q")[0] for _ in range(num))
    data = _read_array(f, refformat.load_device(device))
    if data.dim() != kind + 2:
        raise ValueError(f"a {KEY_KINDS[kind]} key of rank {data.dim()}")
    return GaloisKeys(data, elts) if kind == 3 else data


# -- bytes convenience ------------------------------------------------------

def save(obj, f: BinaryIO) -> None:
    """A ciphertext, plaintext or key, by its type."""
    if isinstance(obj, Ciphertext):
        save_ciphertext(obj, f)
    elif isinstance(obj, Plaintext):
        save_plaintext(obj, f)
    else:
        save_key(obj, f)


def to_bytes(obj) -> bytes:
    buf = io.BytesIO()
    save(obj, buf)
    return buf.getvalue()


def from_bytes(data: bytes, ctx=None, device=None):
    """Any blob of this format; a PTCS blob needs `ctx`.  Tensors go to
    `device`, else the context's, else the CUDA device."""
    buf = io.BytesIO(data)
    magic = data[:4]
    if magic == _MAGIC_CTS:
        if ctx is None:
            raise ValueError("a seed-compressed ciphertext needs a context")
        return load_ciphertext_symmetric(buf, ctx)
    dev = refformat.load_device(
        device if device is not None or ctx is None else ctx.key_q.device)
    if magic == _MAGIC_CT:
        return load_ciphertext(buf, dev)
    if magic == _MAGIC_PT:
        return load_plaintext(buf, dev)
    return load_key(buf, dev)

"""The reference's (PhantomFHE) binary wire format: save and load of
plaintexts, ciphertexts (seed-compressed symmetric ones too) and keys
(counterpart of phantom_tpu/utils/refformat.py, byte for byte).

The reference's raw-struct stream format:
  ciphertext header + payload    include/ciphertext.h:173-214
  seed-compressed symmetric      include/ciphertext.h:216-307 (c0 and the
                                 64-byte Salsa20 seed; c1 regenerated by
                                 the reference's sampler, utils/salsa20.py)
  plaintext                      include/plaintext.h:69-98
  secret key                     include/secretkey.h:347-389
  public key (a ct save)         include/secretkey.h:85-96
  relin key (dnum x pk)          include/secretkey.h:129-162
  galois key (G x rlk)           include/secretkey.h:194-219

Integers are little-endian, size_t 8 bytes, bool 1 byte (x86-64).  The
port's objects are the u64 evaluator's: a Ciphertext or Plaintext of
(.., L, N) int64 residues (int32 ones, the 32-bit paths', are written as
the same u64 words), the secret key a (K, N) tensor, the public key (2,
K, N), the relin key (dnum, 2, K, N) and `keys.GaloisKeys`.  Each JAX
function has its counterpart here under the same name; where the JAX one
returns a key object, this one returns the key's tensor.  Loads put their
tensors on `device` (default: the CUDA device), the seed-compressed load
on the context's; it regenerates c1 with S1 and, for a ciphertext out of
NTT form (BFV), runs U1's inverse.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np
import torch

from ..schemes.ciphertext import Ciphertext, Plaintext
from ..schemes.keyswitch import KERNELS64, Kernels64
from . import salsa20

SEED_BYTES = salsa20.SEED_BYTES

# chain_index, size, N, L (size_t x4), scale (double), correction (u64),
# noiseScaleDeg (size_t), is_ntt_form, is_asymmetric (bool x2)
_CT_HEADER = struct.Struct("<QQQQdQQ??")
_PT_HEADER = struct.Struct("<QQQd")  # chain_index, N, L, scale
_SK_HEADER = struct.Struct("<QQQ")   # sk_max_power, N, L


def write_words(f: BinaryIO, x: torch.Tensor) -> None:
    """A tensor of residues (int64 u64 bit patterns, or int32) written as
    little-endian u64 words, from the host copy itself."""
    a = x.detach().long().cpu().numpy().astype("<i8", copy=False)
    f.write(memoryview(np.ascontiguousarray(a)).cast("B"))


def read_words(f: BinaryIO, count: int, device) -> torch.Tensor:
    """`count` little-endian u64 words -> an int64 tensor on `device`,
    read straight into the host array."""
    a = np.empty(count, dtype="<i8")
    got = f.readinto(memoryview(a).cast("B"))
    if got != count * 8:
        raise ValueError(f"truncated payload: {got} of {count * 8} bytes")
    return torch.from_numpy(a.astype(np.int64, copy=False)).to(device)


def load_device(device):
    """The device a load puts its tensors on: `device`, else the CUDA
    device (schemes.context.resolve_device)."""
    from ..schemes.context import resolve_device
    return resolve_device(device)


def _read(f: BinaryIO, header: struct.Struct):
    raw = f.read(header.size)
    if len(raw) != header.size:
        raise ValueError("truncated header")
    return header.unpack(raw)


# -- ciphertext -------------------------------------------------------------

def save_ciphertext_ref(ct: Ciphertext, f: BinaryIO,
                        is_asymmetric: bool = True) -> None:
    size, num_l, n = ct.data.shape
    f.write(_CT_HEADER.pack(ct.chain_index, size, n, num_l, ct.scale,
                            ct.correction_factor, ct.noise_scale_deg,
                            ct.is_ntt_form, is_asymmetric))
    write_words(f, ct.data)


def load_ciphertext_ref(f: BinaryIO, device=None) -> Ciphertext:
    (chain_index, size, n, num_l, scale, corr, nsd, is_ntt,
     _is_asym) = _read(f, _CT_HEADER)
    data = read_words(f, size * num_l * n, load_device(device))
    return Ciphertext(data=data.view(size, num_l, n),
                      chain_index=int(chain_index), is_ntt_form=bool(is_ntt),
                      scale=float(scale), correction_factor=int(corr),
                      noise_scale_deg=int(nsd))


def save_ciphertext_symmetric_ref(ct: Ciphertext, seed: bytes,
                                  f: BinaryIO) -> None:
    """Seed-compressed save: c0 and the 64-byte Salsa20 seed that made c1
    (reference: save_symmetric, ciphertext.h:216-245).  The ciphertext
    must come from encrypt_symmetric_seeded with the same seed."""
    if len(seed) != SEED_BYTES:
        raise ValueError("seed must be 64 bytes")
    size, num_l, n = ct.data.shape
    if size != 2:
        raise ValueError("only 2-polynomial ciphertexts")
    f.write(_CT_HEADER.pack(ct.chain_index, size, n, num_l, ct.scale,
                            ct.correction_factor, ct.noise_scale_deg,
                            ct.is_ntt_form, False))
    write_words(f, ct.data[0])
    f.write(bytes(seed))


def regenerate_c1(ctx, cd, seed: bytes, is_ntt: bool,
                  ops: Kernels64 = KERNELS64) -> torch.Tensor:
    """c1 of a seed-compressed ciphertext at `cd`'s level: the Salsa20
    uniform sample of `seed` over the level's moduli (S1, NTT form), then
    U1's inverse where the ciphertext is not in NTT form.  Both formats'
    loads regenerate c1 here."""
    c1 = salsa20.sample("uniform", seed, cd.u64.mv, ctx.params.n)
    if not is_ntt:
        c1 = ops.ntt_inverse(c1, ctx.ntt64, ctx.rows_qp[:cd.size_ql])
    return c1


def load_ciphertext_symmetric_ref(ctx, f: BinaryIO,
                                  ops: Kernels64 = KERNELS64) -> Ciphertext:
    """c1 regenerated from the stored seed by S1 (NTT form), then U1's
    inverse where the ciphertext is not in NTT form (reference:
    load_symmetric, ciphertext.h:247-307); on the context's device."""
    ctx.require_u64("load_ciphertext_symmetric_ref")
    (chain_index, size, n, num_l, scale, corr, nsd, is_ntt,
     is_asym) = _read(f, _CT_HEADER)
    if is_asym:
        raise ValueError("asymmetric ciphertext has no seed")
    if size != 2:
        raise ValueError("only 2-polynomial ciphertexts")
    cd = ctx.get_context_data(ctx.first_data_index)
    if cd.size_ql != num_l:
        raise ValueError("only ciphertexts without modulus switching")
    if n != ctx.params.n:
        raise ValueError(f"N={n} against the context's {ctx.params.n}")
    c0 = read_words(f, num_l * n, ctx.key_q.device).view(num_l, n)
    seed = f.read(SEED_BYTES)
    if len(seed) != SEED_BYTES:
        raise ValueError("truncated seed")
    c1 = regenerate_c1(ctx, cd, seed, is_ntt, ops)
    return Ciphertext(data=torch.stack([c0, c1]),
                      chain_index=int(chain_index), is_ntt_form=bool(is_ntt),
                      scale=float(scale), correction_factor=int(corr),
                      noise_scale_deg=int(nsd))


def encrypt_symmetric_seeded(ctx, sk: torch.Tensor, plain: Plaintext,
                             seed: bytes, gen: torch.Generator,
                             ops: Kernels64 = KERNELS64) -> Ciphertext:
    """Symmetric encryption whose c1 comes from the reference's Salsa20
    sampler (S1), so the ciphertext survives a seed-compressed save and
    load in both implementations (reference: encrypt_zero_symmetric,
    secretkey.cu:232 with the stored seed); the noise e from `gen`, then
    keys.encrypt_symmetric_core64 (U1, U4)."""
    from ..ops import sampling as smp
    from ..schemes import keys
    ctx.require_u64("encrypt_symmetric_seeded")
    ci = (plain.chain_index if ctx.params.scheme == "ckks"
          else ctx.first_data_index)
    cd = ctx.get_context_data(ci)
    a = salsa20.sample("uniform", seed, cd.u64.mv, ctx.params.n)
    e = smp.sample_error_cbd(gen, ctx.params.n)
    return keys.encrypt_symmetric_core64(ctx, sk, plain, a, e, ops)


# -- plaintext --------------------------------------------------------------

def save_plaintext_ref(pt: Plaintext, f: BinaryIO) -> None:
    data = pt.data
    if data.dim() == 1:
        data = data.unsqueeze(0)
    num_l, n = data.shape
    f.write(_PT_HEADER.pack(pt.chain_index, n, num_l, pt.scale))
    write_words(f, data)


def load_plaintext_ref(f: BinaryIO, device=None) -> Plaintext:
    chain_index, n, num_l, scale = _read(f, _PT_HEADER)
    data = read_words(f, num_l * n, load_device(device)).view(num_l, n)
    return Plaintext(data=data, chain_index=int(chain_index),
                     scale=float(scale))


# -- keys -------------------------------------------------------------------

def save_secret_key_ref(sk: torch.Tensor, f: BinaryIO) -> None:
    """Written with sk_max_power = 1 (the reference accepts any max power
    >= 1)."""
    num_l, n = sk.shape
    f.write(_SK_HEADER.pack(1, n, num_l))
    write_words(f, sk)


def load_secret_key_ref(f: BinaryIO, device=None) -> torch.Tensor:
    """The secret key (K, N): power 1 of the stored powers."""
    max_power, n, num_l = _read(f, _SK_HEADER)
    data = read_words(f, max_power * num_l * n, load_device(device))
    return data.view(max_power, num_l, n)[0].clone()


def _save_pk_ct(data: torch.Tensor, f: BinaryIO) -> None:
    """A public key is stored as its ciphertext of zero's save
    (secretkey.h:85-96): chain index 0 (key level), NTT form."""
    size, num_l, n = data.shape
    f.write(_CT_HEADER.pack(0, size, n, num_l, 1.0, 1, 1, True, True))
    write_words(f, data)


def _load_pk_ct(f: BinaryIO, device) -> torch.Tensor:
    (_ci, size, n, num_l, _scale, _corr, _nsd, _ntt,
     _asym) = _read(f, _CT_HEADER)
    return read_words(f, size * num_l * n, device).view(size, num_l, n)


def save_public_key_ref(pk: torch.Tensor, f: BinaryIO) -> None:
    _save_pk_ct(pk, f)


def load_public_key_ref(f: BinaryIO, device=None) -> torch.Tensor:
    return _load_pk_ct(f, load_device(device))


def save_relin_key_ref(rlk: torch.Tensor, f: BinaryIO) -> None:
    """rlk: (dnum, 2, K, N)."""
    f.write(struct.pack("<Q", rlk.shape[0]))
    for d in range(rlk.shape[0]):
        _save_pk_ct(rlk[d], f)


def _read_count(f: BinaryIO) -> int:
    return _read(f, struct.Struct("<Q"))[0]


def load_relin_key_ref(f: BinaryIO, device=None) -> torch.Tensor:
    dev = load_device(device)
    dnum = _read_count(f)
    return torch.stack([_load_pk_ct(f, dev) for _ in range(dnum)])


def save_galois_key_ref(glk, f: BinaryIO) -> None:
    """glk: keys.GaloisKeys, data (G, dnum, 2, K, N)."""
    data = glk.data
    f.write(struct.pack("<Q", data.shape[0]))
    for g in range(data.shape[0]):
        save_relin_key_ref(data[g], f)


def load_galois_key_ref(f: BinaryIO, elts=(), device=None):
    """`elts` are not part of the reference wire format (the reference
    keys them by construction order): pass the generating element list."""
    from ..schemes.keys import GaloisKeys
    dev = load_device(device)
    gnum = _read_count(f)
    return GaloisKeys(torch.stack([load_relin_key_ref(f, dev)
                                   for _ in range(gnum)]), tuple(elts))

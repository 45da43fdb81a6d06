"""The reference's Salsa20 sampler, its plain torch version and S1, its
CUDA kernel (counterpart of phantom_tpu/utils/salsa20.py).

The reference draws all device randomness from a nonstandard Salsa20
core (src/prng.cu:17-133): the 16-word state holds key words at
positions 0-7 and 10-15 (56 bytes of the 64-byte seed; bytes 56-64 are
unused) and a 64-bit nonce at words 8-9, with no sigma constants and no
block counter.  Each call makes one 64-byte block; the samplers make one
block per output element (ternary, error) or per 8 residues (uniform),
with nonces derived from the thread index (prng.cu:142-244).  The port
needs it bit for bit to load the reference's seed-compressed ciphertexts
(c1 is regenerated from the seed) and for its own (utils/serialize.py).

A keystream word is an int64 tensor value in [0, 2^32); a u64 lane the
int64 tensor of its bit pattern.  The three samplers, each (L, N) int64
residues in [0, q):

  uniform   one block per (limb, group of 8 residues), nonce tid = limb x
            N / 8 + group; lane k is block word pair (2k, 2k + 1), little
            end first.  A lane above the largest multiple of q below 2^64
            rejects: the whole block is made again at nonce tid + tries N
            L, that lane and every later one take the new block, earlier
            lanes keep theirs, and the check repeats (prng.cu:194-199).
            Then each lane mod q.
  ternary   one block per coefficient (nonce i): its first byte mod 3,
            less 1, the same vector in every limb.
  error     one block per coefficient: popcounts of bytes 0, 1 and the low
            5 bits of 2, less those of bytes 3, 4 and the low 5 bits of 5
            (a centered binomial over 21 bit pairs), the same in every
            limb.

`sample` runs S1 (csrc/salsa20.cu) on a CUDA modulus tensor and the plain
version on a CPU one; both count nothing else.  It replaces no TPU
kernel: the JAX package samples on the host, in numpy or its native C++
library (phantom_tpu/native/host_math.cpp:252, 292, 308).  The plain
uniform version makes every first block at once and then loops only over
the groups that still hold a rejected lane (about 2^-14 a lane at 50-bit
primes, up to 1/8 at 61-bit ones).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..ops import modmath as mm
from ..ops.rns_host import ModulusVec, modulus_vec

SEED_BYTES = 64   # prng_seed_byte_count (reference host/globals.h:20-21)
KEY_WORDS = 14    # the seed's words the state holds
FORMS = ("uniform", "ternary", "error")
LANES = 8         # u64 lanes of one block
DOUBLE_ROUNDS = 10
_M32 = 0xFFFFFFFF
_U64_MAX = (1 << 64) - 1
# the quarter-round steps of one double round: x[a] ^= rotl(x[b] + x[c], r)
# (prng.cu:63-97; columns, then rows)
_STEPS = ((4, 0, 12, 7), (8, 4, 0, 9), (12, 8, 4, 13), (0, 12, 8, 18),
          (9, 5, 1, 7), (13, 9, 5, 9), (1, 13, 9, 13), (5, 1, 13, 18),
          (14, 10, 6, 7), (2, 14, 10, 9), (6, 2, 14, 13), (10, 6, 2, 18),
          (3, 15, 11, 7), (7, 3, 15, 9), (11, 7, 3, 13), (15, 11, 7, 18),
          (1, 0, 3, 7), (2, 1, 0, 9), (3, 2, 1, 13), (0, 3, 2, 18),
          (6, 5, 4, 7), (7, 6, 5, 9), (4, 7, 6, 13), (5, 4, 7, 18),
          (11, 10, 9, 7), (8, 11, 10, 9), (9, 8, 11, 13), (10, 9, 8, 18),
          (12, 15, 14, 7), (13, 12, 15, 9), (14, 13, 12, 13),
          (15, 14, 13, 18))


def seed_words(seed: bytes) -> list:
    """The 14 little-endian key words of a seed of at least 56 bytes."""
    if len(seed) < KEY_WORDS * 4:
        raise ValueError("phantom salsa20 needs a >=56-byte seed")
    return [int(w) for w in np.frombuffer(bytes(seed[:KEY_WORDS * 4]),
                                          dtype="<u4")]


def _rotl(x: torch.Tensor, c: int) -> torch.Tensor:
    return ((x << c) | (x >> (32 - c))) & _M32


def _block_words(kw: Sequence[int], nonces: torch.Tensor) -> torch.Tensor:
    """(M,) int64 nonces (u64 bit patterns) -> (M, 16) keystream words.
    State per prng.cu:28-45: words 0-7 the key's first 8, words 8-9 the
    nonce (low word first), words 10-15 the key's last 6."""
    lo = nonces & _M32
    hi = mm.srl(nonces, 32)
    j = [torch.full_like(nonces, kw[w]) for w in range(8)] + [lo, hi] + [
        torch.full_like(nonces, kw[w]) for w in range(8, KEY_WORDS)]
    x = list(j)
    for _ in range(DOUBLE_ROUNDS):
        for a, b, c, r in _STEPS:
            x[a] = x[a] ^ _rotl((x[b] + x[c]) & _M32, r)
    return torch.stack([(a + b) & _M32 for a, b in zip(x, j)], dim=1)


def _nonce_tensor(nonces, device=None) -> torch.Tensor:
    if isinstance(nonces, torch.Tensor):
        return nonces.to(torch.int64).reshape(-1)
    a = np.asarray(nonces, dtype=np.uint64).reshape(-1)
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def phantom_salsa20_block_words(seed: bytes, nonces,
                                device=None) -> torch.Tensor:
    """One block per nonce, as (M, 16) int64 words in [0, 2^32); `nonces`
    a sequence of integers below 2^64 or an int64 tensor of their bit
    patterns (whose device it keeps)."""
    return _block_words(seed_words(seed), _nonce_tensor(nonces, device))


def phantom_salsa20_block(seed: bytes, nonces, device=None) -> torch.Tensor:
    """(M, 64) uint8 keystream blocks, one per nonce."""
    w = phantom_salsa20_block_words(seed, nonces, device)
    shifts = torch.arange(0, 32, 8, device=w.device)
    return ((w.unsqueeze(-1) >> shifts) & 0xFF).to(torch.uint8).reshape(
        w.shape[0], 64)


def _lanes(words: torch.Tensor) -> torch.Tensor:
    """(M, 16) words -> (M, 8) u64 lanes: word pairs, low word first."""
    lo, hi = words[:, 0::2], words[:, 1::2]
    # hi as a signed 32-bit word times 2^32: the u64 bit pattern, no
    # signed overflow
    return (hi - ((hi >> 31) << 32)) * (1 << 32) + lo


def _max_multiple(q: Sequence[int]) -> list:
    """Per modulus the largest accepted lane: 2^64 - 1 - (2^64 - 1) mod q
    - 1, as an int64 bit pattern."""
    out = []
    for v in q:
        m = _U64_MAX - (_U64_MAX % v) - 1
        out.append(m - (1 << 64) if m >= 1 << 63 else m)
    return out


def _uniform_plain(kw, mv: ModulusVec, n: int,
                   stats: Optional[Dict[str, int]] = None) -> torch.Tensor:
    num_l = mv.q.shape[0]
    groups = n // LANES
    total = num_l * groups
    stride = n * num_l  # the retry nonce's stride
    dev = mv.q.device
    qs = [int(v) for v in mv.q.tolist()]
    maxm = torch.tensor(_max_multiple(qs), dtype=torch.int64,
                        device=dev).repeat_interleave(groups).view(-1, 1)
    tid = torch.arange(total, dtype=torch.int64, device=dev)
    vals = _lanes(_block_words(kw, tid))
    pending = torch.nonzero(mm.lt_u(maxm, vals).any(1)).view(-1)
    tries = 1
    blocks = total
    lane = torch.arange(LANES, device=dev)
    while pending.numel():
        sub = vals[pending]
        first = mm.lt_u(maxm[pending], sub).int().argmax(1, keepdim=True)
        fresh = _lanes(_block_words(kw, tid[pending] + tries * stride))
        sub = torch.where(lane >= first, fresh, sub)
        vals[pending] = sub
        blocks += pending.numel()
        pending = pending[mm.lt_u(maxm[pending], sub).any(1)]
        tries += 1
    if stats is not None:
        stats["blocks"] = blocks
        stats["tries"] = tries
    out = mm.barrett_reduce_u64(vals.view(num_l, n), mv.q.view(-1, 1),
                                mv.ratio_hi.view(-1, 1))
    return out


def _coefficient_bytes(kw, n: int, device) -> torch.Tensor:
    """(n, 8) int64: the first 8 bytes of the block of each coefficient."""
    w = _block_words(kw, torch.arange(n, dtype=torch.int64, device=device))
    shifts = torch.arange(0, 32, 8, device=device)
    return ((w[:, :2].unsqueeze(-1) >> shifts) & 0xFF).reshape(n, 8)


def _popcount8(b: torch.Tensor) -> torch.Tensor:
    bits = torch.arange(8, device=b.device)
    return ((b.unsqueeze(-1) >> bits) & 1).sum(-1)


def _small_plain(form: str, kw, q: torch.Tensor, n: int) -> torch.Tensor:
    b = _coefficient_bytes(kw, n, q.device)
    if form == "ternary":
        v = b[:, 0] % 3 - 1
    else:
        pop = _popcount8(b[:, :6])
        v = (pop[:, 0] + pop[:, 1] + _popcount8(b[:, 2] & 0x1F)
             - pop[:, 3] - pop[:, 4] - _popcount8(b[:, 5] & 0x1F))
    return torch.remainder(v.unsqueeze(0), q.view(-1, 1))


def sample_plain(form: str, seed: bytes, mv: ModulusVec, n: int,
                 stats: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """S1's plain version: (L, n) int64 residues of mv's moduli on mv's
    device.  `stats`, where given, receives the uniform form's count of
    blocks made ("blocks", retries included) and its longest chain
    ("tries")."""
    kw = seed_words(seed)
    if form == "uniform":
        return _uniform_plain(kw, mv, n, stats)
    return _small_plain(form, kw, mv.q, n)


def sample(form: str, seed: bytes, mv: ModulusVec, n: int) -> torch.Tensor:
    """S1 on CUDA tensors; the plain version on CPU tensors.  `form` one of
    FORMS; mv the moduli (L,) with their Barrett words; n a multiple of 8
    for the uniform form.  Returns (L, n) int64 residues in [0, q) on mv's
    device; one launch."""
    if form not in FORMS:
        raise ValueError(f"form {form!r} not in {FORMS}")
    if form == "uniform" and (n % LANES or n < LANES):
        raise ValueError(f"the uniform form takes N a multiple of {LANES}, "
                         f"not {n}")
    if _build.is_plain(mv.q, "salsa20"):
        return sample_plain(form, seed, mv, n)
    from ..ops.ntt import check_words
    check_words(mv.q, mv.ratio_hi)
    num_l = mv.q.shape[0]
    kw = (ctypes.c_uint32 * KEY_WORDS)(*seed_words(seed))
    out = torch.empty((num_l, n), dtype=torch.int64, device=mv.q.device)
    _build.check_aligned(out)
    with torch.cuda.device(out.device):
        err = _build.library().ptk_salsa20(
            FORMS.index(form), out.data_ptr(), mv.q.data_ptr(),
            mv.ratio_hi.data_ptr(), ctypes.addressof(kw), num_l, n,
            _build.stream(out))
    _build.check(err, "salsa20")
    sample.launches += 1
    return out


sample.launches = 0


def _moduli(moduli, device) -> ModulusVec:
    from ..schemes.context import resolve_device
    return modulus_vec([int(q) for q in moduli], resolve_device(device))


def sample_ternary_ref(seed: bytes, moduli, n: int,
                       device=None) -> torch.Tensor:
    """The reference's sample_ternary_poly (prng.cu:142-163): (L, n) int64
    on `device` (default: the CUDA device, S1)."""
    return sample("ternary", seed, _moduli(moduli, device), n)


def sample_error_ref(seed: bytes, moduli, n: int,
                     device=None) -> torch.Tensor:
    """The reference's sample_error_poly (prng.cu:224-244)."""
    return sample("error", seed, _moduli(moduli, device), n)


def sample_uniform_ref(seed: bytes, moduli, n: int,
                       device=None) -> torch.Tensor:
    """The reference's sample_uniform_poly (prng.cu:174-205): (L, n) int64
    residues, NTT form by construction."""
    return sample("uniform", seed, _moduli(moduli, device), n)

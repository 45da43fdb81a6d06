"""The JAX package's state, as numpy arrays, into the port's tensors.

Takes numpy arrays only (call `np.asarray` on a JAX array first), so this
module, like the rest of the port, never imports JAX.  Residues are below
2^30, so u64 and u32 words both become int32 tensors with the same bits:
`residues` carries ciphertexts (CKKS and BGV in NTT form, BFV in
coefficient form), secret keys and plaintexts; the relin key becomes a
level's evk (`relin_evk`) or a whole BFV or BGV step (`bfv_pipeline`,
`bfv_behz_pipeline`, `bfv_leveled_pipeline`, `bgv_pipeline`).  A BGV
ciphertext's correction factor is a host integer: the caller carries it
beside the residues.

The JAX package's key, plaintext and ciphertext objects (any object with
their fields: the module reads `.data` through `np.asarray`, and never
imports JAX) carry across whole, onto the context's device: `secret_key`,
`public_key` and `relin_key` to tensors, `galois_key_set` to
keys.GaloisKeys, `plaintext` and `ciphertext` (a Ciphertext or a Fast32
Ct32) to the port's, with all their metadata.  On a context with a prime
of 2^30 or more (the u64 evaluator's) the same functions carry u64 words
(`words`: numpy uint64 -> the int64 tensor of their bit patterns).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.bfv32 import (BFVBehz32, BFVLeveled32, BFVPipeline32,
                        build_bfv32, build_bfv_behz32, build_bfv_leveled32)
from .ops.bgv32 import BGVPipeline32, build_bgv32
from .ops.pipeline32 import DEFAULT_ENGINE, Galois32, convert_key32
from .schemes.ciphertext import Ciphertext, Plaintext
from .schemes.context import Context
from .schemes.keys import GaloisKeys


def residues(a: np.ndarray) -> torch.Tensor:
    """Unsigned residues below 2^30 (u32 or u64 array) -> int32 tensor:
    Ciphertext.data, SecretKey.data, plaintexts, keys."""
    if not isinstance(a, np.ndarray):
        raise TypeError(f"expected a numpy array, got {type(a).__name__}")
    if a.dtype.kind != "u" or (a.size and int(a.max()) >= 1 << 30):
        raise ValueError("expected unsigned residues below 2^30")
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32)))


def words(a: np.ndarray) -> torch.Tensor:
    """Unsigned words below 2^64 (a numpy uint array) -> the int64 tensor
    of their bit patterns: the u64 evaluator's residues."""
    if not isinstance(a, np.ndarray):
        raise TypeError(f"expected a numpy array, got {type(a).__name__}")
    if a.dtype.kind != "u":
        raise ValueError("expected unsigned words")
    return torch.from_numpy(np.ascontiguousarray(
        a.astype(np.uint64)).view(np.int64))


def relin_evk(ctx: Context, rlk_data: np.ndarray,
              chain_index: int = 1) -> torch.Tensor:
    """RelinKey.data (dnum, 2, K, N) -> the level's evk
    (beta, 2, size_qlp, N), through the rows of qlp_rows."""
    return convert_key32(ctx, residues(rlk_data), chain_index)


def galois_keys(ctx: Context, glk_data: np.ndarray, elts,
                chain_index: int = 1) -> Galois32:
    """GaloisKeys.data (n_elts, dnum, 2, K, N) with its elements -> the
    level's rotation state, on the context's device."""
    return Galois32(ctx, residues(glk_data), elts, chain_index).to(
        ctx.key_q.device)


def bfv_pipeline(ctx: Context, rlk_data: np.ndarray, chain_index: int = 1,
                 engine: str = DEFAULT_ENGINE,
                 lift: str = "xla") -> BFVPipeline32:
    """A BFV context's RelinKey.data (dnum, 2, K, N) -> the HPS (and
    HPSoverQ) step at this level on `engine` with HPS's `lift`, on the
    context's device."""
    return build_bfv32(ctx, residues(rlk_data).to(ctx.key_q.device),
                       chain_index, engine, ctx.key_q.device, lift)


def bfv_behz_pipeline(ctx: Context, rlk_data: np.ndarray,
                      chain_index: int = 1,
                      engine: str = DEFAULT_ENGINE) -> BFVBehz32:
    """A "behz" BFV context's RelinKey.data -> the BEHZ step at this level
    on `engine`, on the context's device."""
    return build_bfv_behz32(ctx, residues(rlk_data).to(ctx.key_q.device),
                            chain_index, engine, ctx.key_q.device)


def bfv_leveled_pipeline(ctx: Context, rlk_data: np.ndarray,
                         noise_scale_deg: int = 1,
                         engine: str = DEFAULT_ENGINE,
                         force_lvl: int = None) -> BFVLeveled32:
    """A BFV context's RelinKey.data -> the HPSoverQ-leveled step at the
    noise model's drop for `noise_scale_deg` (or `force_lvl`) on `engine`,
    on the context's device."""
    return build_bfv_leveled32(ctx, residues(rlk_data).to(ctx.key_q.device),
                               noise_scale_deg, engine, ctx.key_q.device,
                               force_lvl)


def bgv_pipeline(ctx: Context, rlk_data: np.ndarray, chain_index: int = 1,
                 modup: str = "auto") -> BGVPipeline32:
    """A BGV context's RelinKey.data (dnum, 2, K, N) -> the mult + relin +
    modswitch step at this level on the `modup` route, on the context's
    device."""
    return build_bgv32(ctx, residues(rlk_data).to(ctx.key_q.device),
                       chain_index, ctx.key_q.device, modup=modup)


def _on(ctx: Context, obj) -> torch.Tensor:
    a = np.asarray(obj.data)
    return (words(a) if ctx.wide else residues(a)).to(ctx.key_q.device)


def secret_key(ctx: Context, sk) -> torch.Tensor:
    """SecretKey -> (K, N)."""
    return _on(ctx, sk)


def public_key(ctx: Context, pk) -> torch.Tensor:
    """PublicKey -> (2, K, N)."""
    return _on(ctx, pk)


def relin_key(ctx: Context, rlk) -> torch.Tensor:
    """RelinKey -> (dnum, 2, K, N)."""
    return _on(ctx, rlk)


def galois_key_set(ctx: Context, glk) -> GaloisKeys:
    """GaloisKeys -> keys.GaloisKeys (data (n_elts, dnum, 2, K, N),
    elts)."""
    return GaloisKeys(_on(ctx, glk), tuple(int(e) for e in glk.elts))


def plaintext(ctx: Context, pt) -> Plaintext:
    return Plaintext(data=_on(ctx, pt), chain_index=int(pt.chain_index),
                     is_ntt_form=bool(pt.is_ntt_form), scale=float(pt.scale))


def ciphertext(ctx: Context, ct) -> Ciphertext:
    """A Ciphertext or a Fast32 Ct32 (u64 or u32 residues)."""
    return Ciphertext(data=_on(ctx, ct), chain_index=int(ct.chain_index),
                      is_ntt_form=bool(ct.is_ntt_form), scale=float(ct.scale),
                      correction_factor=int(ct.correction_factor),
                      noise_scale_deg=int(ct.noise_scale_deg))

"""CKKS encoders: complex slot vectors <-> RNS plaintext polynomials
(counterpart of phantom_tpu/schemes/ckks_encoder.py: CKKSEncoder,
CKKSDeviceEncoder and encode_extended).

The canonical embedding evaluates the plaintext polynomial at the odd
powers zeta^(5^j) of a primitive 2N-th root; as in the JAX package that
is a twisted length-N DFT, p(zeta^(2k+1)) = DFT_k(p_j zeta^j), with the
generator-5 slot permutation on the evaluation vector.  The float stage
is the JAX package's numpy float64 FFT on the host, copied as it is, so
the rounded integers are the same; the budget check compares integers.
The exact stages: the rounded coefficients reduce into each prime on the
host, then the forward NTT over the level's rows (K2 on the card);
decode takes the inverse NTT (K1) and composes the CRT exactly on the
host.  On a context with primes of 2^30 or more (the u64 evaluator's)
the residues are u64 words and both transforms are U1 (ops/ntt.py); the
`ops` given map to KERNELS64 or, for pipeline32.PLAIN, PLAIN64.

CKKSDeviceEncoder is the JAX package's device encoder, on its u32 path
(every prime below 2^30) and on its wide one (the u64 evaluator's primes,
up to 2^61): the float stage is the double-float special FFT
(ops/ckks_fft.py, F1 on the card), and the exact stages stay on the
device.  Encode copies the slot values to the device as they are and runs
F1's encode form (the scatter at the scale, the inverse FFT, the rounding
to int64 and the reduction into the level's primes in one call), then
the forward NTT (K2; U1 on a wide context, over ntt64's rows); decode
takes the inverse NTT (K1; U1) of the first two limbs only and F1's
decode form (the centered value composed from them by Garner, valid
while |value| < q0 q1 / 2 and, on the wide path, below 2^63, so it
never overflows where the host decode's exact CRT raises, then the
forward FFT and the slots).  The JAX package transforms every limb
before its wide decode; the transform works row by row, so the answer
is the same.  On a wide context F1's wide forms take int64 words
(Kernels64's ckks_fft_encode and ckks_fft_decode; the `ops` given map
as for the host encoder).  Its f32 arithmetic is the JAX package's
evaluated op by op; the jitted JAX encoder's XLA fusions round some
double-float words differently on the CPU, so its residues may differ by
one in a coefficient.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.ckks_fft import CKKSFFTTables, round_coeffs, scatter_plain
from ..ops.pipeline32 import KERNELS, PLAIN, Kernels
from .ciphertext import Plaintext
from .context import Context, qlp_rows
from .keyswitch import KERNELS64, PLAIN64, Kernels64


def _rns(coeffs: np.ndarray, moduli, wide: bool = False) -> np.ndarray:
    """Round the real coefficients to integers and reduce them mod each
    prime: (len(moduli), N) int32, or int64 words for a wide context.
    Coefficients of 2^62 or more take exact Python integers, the others
    int64 (a constant at a large scale has one such coefficient)."""
    small = np.abs(coeffs) < 2 ** 62
    ints64 = np.round(np.where(small, coeffs, 0.0)).astype(np.int64)
    big = np.flatnonzero(~small)
    rns = np.stack([ints64 % np.int64(q) for q in moduli])
    ints = [int(round(c)) for c in coeffs[big]]
    for row, q in zip(rns, moduli):
        row[big] = [x % q for x in ints]
    return rns if wide else rns.astype(np.int32)


def _ops64(ops) -> Kernels64:
    """The u64 kernels for `ops`: itself, or PLAIN64 for pipeline32.PLAIN,
    else KERNELS64."""
    if isinstance(ops, Kernels64):
        return ops
    return PLAIN64 if ops is PLAIN else KERNELS64


def _transform(ctx: Context, ops, inverse: bool):
    """(transform, tables) over the context's words: ops' K2 / K1 on a
    32-bit context, U1 on a wide one."""
    if ctx.wide:
        ops64 = _ops64(ops)
        fn = ops64.ntt_inverse if inverse else ops64.ntt_forward
        return fn, ctx.ntt64
    return (ops.ntt_inverse if inverse else ops.ntt_forward), ctx.ntt


def _check_budget(max_coeff: float, moduli) -> None:
    total = 1
    for q in moduli:
        total *= q
    if int(2 * max_coeff) >= total:
        raise ValueError("encoded values are too large for parms at this "
                         "level (scale out of bounds)")


class CKKSEncoder:
    def __init__(self, ctx: Context):
        if ctx.params.scheme != "ckks":
            raise ValueError("CKKSEncoder requires a CKKS context")
        self.ctx = ctx
        n = ctx.params.n
        self.slots = n // 2
        m = 2 * n
        # slot j <-> evaluation at zeta^(5^j); exponent e = 2k + 1 -> k
        pos = 1
        idx1 = np.zeros(self.slots, dtype=np.int64)
        idx2 = np.zeros(self.slots, dtype=np.int64)
        for j in range(self.slots):
            idx1[j] = (pos - 1) >> 1
            idx2[j] = (m - pos - 1) >> 1
            pos = (pos * 5) % m
        self._idx1, self._idx2 = idx1, idx2
        self._twist = np.exp(1j * np.pi * np.arange(n) / n)

    # -- float stage (host float64) ---------------------------------------
    def _embed_inverse(self, z: np.ndarray) -> np.ndarray:
        """slots (N/2 complex) -> real coefficients (N,), unscaled."""
        n = self.ctx.params.n
        ev = np.zeros(n, dtype=np.complex128)
        ev[self._idx1] = z
        ev[self._idx2] = np.conj(z)
        p_twisted = np.fft.fft(ev) / n
        return np.real(p_twisted * np.conj(self._twist))

    def _embed_forward(self, coeffs: np.ndarray) -> np.ndarray:
        """real coefficients (N,) -> slots (N/2 complex)."""
        n = self.ctx.params.n
        ev = n * np.fft.ifft(coeffs * self._twist)
        return ev[self._idx1]

    def _coeffs(self, values, scale: float) -> np.ndarray:
        z = np.zeros(self.slots, dtype=np.complex128)
        v = np.asarray(values, dtype=np.complex128).ravel()
        if v.shape[0] > self.slots:
            raise ValueError("too many values for slot count")
        z[:v.shape[0]] = v
        return self._embed_inverse(z) * scale

    # -- public API ---------------------------------------------------------
    def encode(self, values: Sequence, scale: float,
               chain_index: Optional[int] = None,
               ops: Kernels = KERNELS) -> Plaintext:
        """Complex or real slot values at `scale` -> the NTT-form plaintext
        (k, N) at `chain_index` (default the first data level), on the
        context's device."""
        ctx = self.ctx
        ci = ctx.first_data_index if chain_index is None else chain_index
        cd = ctx.get_context_data(ci)
        coeffs = self._coeffs(values, scale)
        max_coeff = float(np.max(np.abs(coeffs))) if coeffs.size else 0.0
        _check_budget(max_coeff, cd.moduli)
        rns = torch.from_numpy(_rns(coeffs, cd.moduli, ctx.wide)).to(
            ctx.key_q.device)
        fwd, tables = _transform(ctx, ops, False)
        data = fwd(rns, tables, ctx.rows_qp[:cd.size_ql])
        return Plaintext(data=data, chain_index=ci, is_ntt_form=True,
                         scale=scale)

    def decode(self, plain: Plaintext, ops: Kernels = KERNELS) -> np.ndarray:
        """NTT-form plaintext -> complex slot values (N/2,)."""
        ctx = self.ctx
        cd = ctx.get_context_data(plain.chain_index)
        k = cd.size_ql
        inv, tables = _transform(ctx, ops, True)
        coeffs_rns = inv(plain.data.contiguous(), tables,
                         ctx.rows_qp[:k]).cpu().numpy()
        moduli = list(cd.moduli)
        total = 1
        for q in moduli:
            total *= q
        punct = [total // q for q in moduli]
        inv = [pow(p % q, -1, q) for p, q in zip(punct, moduli)]
        acc = np.zeros(ctx.params.n, dtype=object)
        for row, q, p, i in zip(coeffs_rns, moduli, punct, inv):
            acc += (row.astype(object) * i) % q * p
        acc %= total
        centered = np.where(acc > total // 2, acc - total, acc)
        return self._embed_forward((centered / plain.scale).astype(
            np.float64))


def encode_extended(enc: CKKSEncoder, values, scale: float,
                    chain_index: int = 1,
                    ops: Kernels = KERNELS) -> torch.Tensor:
    """Slot values over the extended base QlP in NTT form, (size_qlp, N):
    the weights of the hoisted linear combination, which multiply key
    switch products that still live over QlP."""
    ctx = enc.ctx
    rows = qlp_rows(ctx, ctx.get_context_data(chain_index).size_ql)
    moduli = [ctx.params.coeff_modulus[r] for r in rows]
    coeffs = enc._coeffs(values, scale)
    max_coeff = float(np.max(np.abs(coeffs))) if coeffs.size else 0.0
    _check_budget(max_coeff, moduli)
    dev = ctx.key_q.device
    rns = torch.from_numpy(_rns(coeffs, moduli, ctx.wide)).to(dev)
    fwd, tables = _transform(ctx, ops, False)
    return fwd(rns, tables, torch.tensor(rows, dtype=torch.int32,
                                         device=dev))


class CKKSDeviceEncoder:
    """Encode and decode on the context's device through F1's fused forms,
    the JAX package's CKKSDeviceEncoder.  Every method takes `ops`, the
    kernels it calls: F1's forms, K1, K2 (pipeline32.PLAIN for the plain
    versions); on a wide context F1's wide forms and U1 (Kernels64, or
    the mapping of _ops64)."""

    def __init__(self, ctx: Context):
        if ctx.params.scheme != "ckks":
            raise ValueError("CKKSDeviceEncoder requires a CKKS context")
        self.ctx = ctx
        self.slots = ctx.params.n // 2
        self.tables = CKKSFFTTables(ctx.params.n).to(ctx.key_q.device)

    def _slots(self, values, scale: float) -> torch.Tensor:
        """The slot values as an (m, 2) float64 (re, im) tensor on the
        host, m <= N/2.  Raises where a coefficient could reach 2^62 (each
        is at most scale max |value|): the double-float path rounds to
        int64, the host CKKSEncoder encodes such constants exactly."""
        v = np.asarray(values, dtype=np.complex128).ravel()
        if v.shape[0] > self.slots:
            raise ValueError("too many values for slot count")
        if v.size and scale * float(np.abs(v).max()) >= 2.0 ** 62:
            raise ValueError("CKKSDeviceEncoder: scale x |value| reaches "
                             "2^62; encode with the host CKKSEncoder")
        return torch.from_numpy(v.view(np.float64).reshape(-1, 2))

    def encode_ints(self, values, scale: float,
                    ops: Kernels = KERNELS) -> torch.Tensor:
        """The rounded coefficients (N,) int64: the bare inverse FFT of the
        scattered slots, then round(hi) + round(lo + (hi - round(hi)))
        (half to even)."""
        z = self._slots(values, scale).to(self.ctx.key_q.device)
        c = ops.ckks_fft(scatter_plain(z, scale, self.tables), self.tables,
                         inverse=True)
        return round_coeffs(c[0], c[1])

    def encode(self, values, scale: float,
               chain_index: Optional[int] = None,
               ops: Kernels = KERNELS) -> Plaintext:
        """Complex or real slot values at `scale` -> the NTT-form plaintext
        (k, N) at `chain_index` (default the first data level)."""
        ctx = self.ctx
        ci = ctx.first_data_index if chain_index is None else chain_index
        k = ctx.get_context_data(ci).size_ql
        z = self._slots(values, scale).to(ctx.key_q.device)
        if ctx.wide:
            ops = _ops64(ops)
        rns = ops.ckks_fft_encode(z, scale, ctx.key_q[:k], self.tables)
        fwd, tables = _transform(ctx, ops, False)
        data = fwd(rns, tables, ctx.rows_qp[:k])
        return Plaintext(data=data, chain_index=ci, is_ntt_form=True,
                         scale=scale)

    def decode(self, plain: Plaintext, ops: Kernels = KERNELS) -> np.ndarray:
        """NTT-form plaintext -> complex slot values (N/2,): the inverse
        NTT of the first two limbs (the only ones Garner reads; the
        transform is row by row), then the decode form."""
        ctx = self.ctx
        moduli = ctx.get_context_data(plain.chain_index).moduli[:2]
        r = len(moduli)
        if ctx.wide:
            ops = _ops64(ops)
        inv, tables = _transform(ctx, ops, True)
        x = inv(plain.data[:r].contiguous(), tables, ctx.rows_qp[:r])
        out = ops.ckks_fft_decode(x, moduli, plain.scale, self.tables)
        return torch.view_as_complex(out).cpu().numpy()

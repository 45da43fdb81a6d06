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
host.

CKKSDeviceEncoder is the JAX package's device encoder on its u32 path
(every prime below 2^30): the float stage is the double-float special FFT
(ops/ckks_fft.py, F1 on the card), and the exact stages stay on the
device: encode rounds the double-float coefficients to int64, reduces
them into the level's primes and takes the forward NTT (K2); decode takes
the inverse NTT (K1), composes the centered value from the first two
limbs by Garner (valid while |value| < q0 q1 / 2, so it never overflows
where the host decode's exact CRT raises) and runs the forward FFT.  Its
f32 arithmetic is the JAX package's evaluated op by op; the jitted JAX
encoder's XLA fusions round some double-float words differently on the
CPU, so its residues may differ by one in a coefficient.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.ckks_fft import CKKSFFTTables, df_from_f64
from ..ops.pipeline32 import KERNELS, Kernels
from .ciphertext import Plaintext
from .context import Context, qlp_rows


def _rns(coeffs: np.ndarray, moduli, max_coeff: float) -> np.ndarray:
    """Round the real coefficients to integers and reduce them mod each
    prime: (len(moduli), N) int32."""
    if max_coeff < 2 ** 62:
        ints64 = np.round(coeffs).astype(np.int64)
        rns = np.stack([ints64 % np.int64(q) for q in moduli])
    else:
        ints = [int(round(c)) for c in coeffs]
        rns = np.stack([np.array([x % q for x in ints], dtype=np.int64)
                        for q in moduli])
    return rns.astype(np.int32)


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
        rns = torch.from_numpy(_rns(coeffs, cd.moduli, max_coeff)).to(
            ctx.key_q.device)
        data = ops.ntt_forward(rns, ctx.ntt, ctx.rows_qp[:cd.size_ql])
        return Plaintext(data=data, chain_index=ci, is_ntt_form=True,
                         scale=scale)

    def decode(self, plain: Plaintext, ops: Kernels = KERNELS) -> np.ndarray:
        """NTT-form plaintext -> complex slot values (N/2,)."""
        ctx = self.ctx
        cd = ctx.get_context_data(plain.chain_index)
        k = cd.size_ql
        coeffs_rns = ops.ntt_inverse(plain.data.contiguous(), ctx.ntt,
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
    rns = torch.from_numpy(_rns(coeffs, moduli, max_coeff)).to(dev)
    return ops.ntt_forward(rns, ctx.ntt, torch.tensor(rows, dtype=torch.int32,
                                                      device=dev))


class CKKSDeviceEncoder:
    """Encode and decode on the context's device through the double-float
    FFT (F1), the JAX package's CKKSDeviceEncoder on its u32 path.  Every
    method takes `ops`, the kernels it calls (F1, K1, K2; pipeline32.PLAIN
    for the plain versions)."""

    def __init__(self, ctx: Context):
        if ctx.params.scheme != "ckks":
            raise ValueError("CKKSDeviceEncoder requires a CKKS context")
        if max(ctx.params.coeff_modulus) >= 1 << 30:
            raise ValueError(
                "CKKSDeviceEncoder runs the u32 path only (every prime below "
                "2^30); wider primes wait for the u64 evaluator (ROADMAP.md "
                "section 1, item 8)")
        self.ctx = ctx
        self.slots = ctx.params.n // 2
        tables = CKKSFFTTables(ctx.params.n)
        self._slot_pos = tables.slot_pos.numpy()
        self._slot_conj = tables.slot_conj.numpy()
        self.tables = tables.to(ctx.key_q.device)

    def _scatter(self, values, scale: float) -> torch.Tensor:
        """The slots times `scale` (float64 on the host) at their positions
        in the evaluation vector, conjugates mirrored, as (4, N) f32
        double-float planes on the device."""
        n = self.ctx.params.n
        v = np.asarray(values, dtype=np.complex128).ravel()
        if v.shape[0] > self.slots:
            raise ValueError("too many values for slot count")
        z = np.zeros(self.slots, dtype=np.complex128)
        z[:v.shape[0]] = v
        z = z * scale
        ev_re = np.zeros(n, dtype=np.float64)
        ev_im = np.zeros(n, dtype=np.float64)
        ev_re[self._slot_pos] = z.real
        ev_im[self._slot_pos] = z.imag
        ev_re[self._slot_conj] = z.real
        ev_im[self._slot_conj] = -z.imag
        planes = np.stack(df_from_f64(ev_re) + df_from_f64(ev_im))
        return torch.from_numpy(planes).to(self.ctx.key_q.device)

    def encode_ints(self, values, scale: float,
                    ops: Kernels = KERNELS) -> torch.Tensor:
        """The rounded coefficients (N,) int64: the inverse FFT, then
        round(hi) + round(lo + (hi - round(hi))) (half to even)."""
        coeffs = ops.ckks_fft(self._scatter(values, scale), self.tables,
                              inverse=True)
        hi, lo = coeffs[0], coeffs[1]
        a = torch.round(hi).long()
        return a + torch.round(lo + (hi - a.float())).long()

    def encode(self, values, scale: float,
               chain_index: Optional[int] = None,
               ops: Kernels = KERNELS) -> Plaintext:
        """Complex or real slot values at `scale` -> the NTT-form plaintext
        (k, N) at `chain_index` (default the first data level)."""
        ctx = self.ctx
        ci = ctx.first_data_index if chain_index is None else chain_index
        k = ctx.get_context_data(ci).size_ql
        ints = self.encode_ints(values, scale, ops)
        rns = (ints % ctx.key_q[:k].long().view(-1, 1)).int()
        data = ops.ntt_forward(rns, ctx.ntt, ctx.rows_qp[:k])
        return Plaintext(data=data, chain_index=ci, is_ntt_form=True,
                         scale=scale)

    def _centered(self, plain: Plaintext,
                        ops: Kernels = KERNELS) -> torch.Tensor:
        """The plaintext's centered coefficients (N,) int64, composed from
        its first two limbs by Garner."""
        ctx = self.ctx
        moduli = ctx.get_context_data(plain.chain_index).moduli
        k = len(moduli)
        x = ops.ntt_inverse(plain.data.contiguous(), ctx.ntt,
                            ctx.rows_qp[:k]).long()
        q0 = moduli[0]
        if k == 1:
            return torch.where(x[0] > q0 // 2, x[0] - q0, x[0])
        q1 = moduli[1]
        t = (x[1] - x[0] % q1) % q1 * pow(q0 % q1, -1, q1) % q1
        return x[0] + q0 * torch.where(t > q1 // 2, t - q1, t)

    def decode(self, plain: Plaintext, ops: Kernels = KERNELS) -> np.ndarray:
        """NTT-form plaintext -> complex slot values (N/2,): the centered
        coefficients split into f32 (hi, lo), times the f32 1/scale, the
        forward FFT, the slots gathered and summed in float64."""
        m = self._centered(plain, ops)
        hi = m.float()
        lo = (m - hi.long()).float()
        inv = float(np.float32(1.0 / plain.scale))
        zero = torch.zeros_like(hi)
        ev = ops.ckks_fft(torch.stack([hi * inv, lo * inv, zero, zero]),
                          self.tables)
        g = ev[:, self.tables.slot_pos].double()
        out = torch.complex(g[0] + g[1], g[2] + g[3])
        return out.cpu().numpy()

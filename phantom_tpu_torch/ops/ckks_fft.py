"""The CKKS special FFT in double-float (two-f32) arithmetic, its tables
and F1, its CUDA kernel (counterpart of phantom_tpu/ops/ckks_fft.py), with
the device encoder's two fused forms of it.

The transform is the negacyclic evaluation map of the NTT engine with
complex entries,

    out[k] = p(psi^(2 rev(k) + 1)),  psi = exp(i pi / n),

run with the same Cooley-Tukey (forward) and Gentleman-Sande (inverse)
stages over bit-reversed twiddle tables.  Each real is a double-float
(hi, lo) pair of f32 words, about 48 mantissa bits; the primitives are
the error-free transformations of Dekker and Knuth without FMA (Veltkamp
splitting by 4097 keeps the 12 x 12-bit partial products exact).  The
rounding of these f32 operations defines the encoded integers of
schemes/ckks_encoder.CKKSDeviceEncoder, so the plain versions here
evaluate op by op in f32, one torch operation each, and equal the JAX
package's eager evaluation word for word.

F1 (csrc/ckks_fft.cu) runs on the card and equals the plain versions bit
for bit, in three forms that share one launch count (`ckks_fft.launches`):

  ckks_fft         the bare transform: (4, N) f32 planes re_hi, re_lo,
                   im_hi, im_lo in and out;
  ckks_fft_encode  slot values in, residues out: the slots times the scale
                   in float64 at their positions (scatter_plain), split
                   into double-floats, the inverse transform, the rounding
                   (round_coeffs) and the floor modulus by each prime;
  ckks_fft_decode  the first two coefficient-form limbs in, slot values
                   out: the centered value by Garner (garner_centered),
                   split and scaled in f32, the forward transform, the
                   slots gathered and summed in float64;
  ckks_fft_encode64, ckks_fft_decode64
                   the same two forms on 64-bit words for the u64
                   evaluator's primes (up to 2^61): int64 residues, each
                   rounded coefficient x as x mod q in [0, q) (the JAX
                   package's reduce_i64_centered, for |x| < 2^62); int64
                   limbs composed by the wide Garner step
                   (garner_centered64).

It is not a TPU kernel: the JAX package runs this transform as XLA
fusions and the scatter in numpy on the host.  The plain transforms take
and return the JAX package's nested tuples ((re_hi, re_lo), (im_hi,
im_lo)).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from .. import _build
from ..host.ntt_tables import bit_reverse_indices
from . import modmath as mm

_SPLIT = 4097.0  # 2^12 + 1, the Veltkamp split for f32


# -- double-float primitives ----------------------------------------------

def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_add(x, y):
    """(xh, xl) + (yh, yl) -> a double-float."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return quick_two_sum(s, e)


def df_neg(x):
    return (-x[0], -x[1])


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return quick_two_sum(p, e)


def df_from_f64(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


# complex double-float: (re, im), each a (hi, lo) pair
def cdf_add(a, b):
    return (df_add(a[0], b[0]), df_add(a[1], b[1]))


def cdf_sub(a, b):
    return (df_sub(a[0], b[0]), df_sub(a[1], b[1]))


def cdf_mul(a, b):
    re = df_sub(df_mul(a[0], b[0]), df_mul(a[1], b[1]))
    im = df_add(df_mul(a[0], b[1]), df_mul(a[1], b[0]))
    return (re, im)


# -- tables -----------------------------------------------------------------

class CKKSFFTTables(nn.Module):
    """The bit-reversed psi powers as complex double-float planes, (4, N)
    f32 each (re_hi, re_lo, im_hi, im_lo): `fwd` holds psi^rev(i), `inv`
    psi^-rev(i); and the slot indices, (N/2,) int64: `slot_pos[j]` is the
    position of slot j in the evaluation vector, `slot_conj[j]` that of
    its conjugate (the generator-5 order composed with the rev order of
    the evaluation domain).  The two are disjoint and cover the N
    positions; `slot_of`, (N,) int32, inverts them for F1's forms:
    slot_of[slot_pos[j]] = j, slot_of[slot_conj[j]] = ~j = -1 - j."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n
        rev = bit_reverse_indices(n.bit_length() - 1)
        ang = np.pi * rev / n
        m = 2 * n
        inv_rev = np.zeros(n, dtype=np.int64)
        inv_rev[rev] = np.arange(n)
        slot_pos = np.zeros(n // 2, dtype=np.int64)
        slot_conj = np.zeros(n // 2, dtype=np.int64)
        pos = 1
        for j in range(n // 2):
            slot_pos[j] = inv_rev[(pos - 1) >> 1]
            slot_conj[j] = inv_rev[(m - pos - 1) >> 1]
            pos = (pos * 5) % m

        def planes(c):
            return torch.from_numpy(np.stack(
                df_from_f64(c.real) + df_from_f64(c.imag)))

        self.register_buffer("fwd", planes(np.exp(1j * ang)))
        self.register_buffer("inv", planes(np.exp(-1j * ang)))
        self.register_buffer("slot_pos", torch.from_numpy(slot_pos))
        self.register_buffer("slot_conj", torch.from_numpy(slot_conj))
        slot_of = np.zeros(n, dtype=np.int32)
        slot_of[slot_pos] = np.arange(n // 2)
        slot_of[slot_conj] = ~np.arange(n // 2)
        self.register_buffer("slot_of", torch.from_numpy(slot_of))


def make_fft_tables(n: int, device=None) -> CKKSFFTTables:
    return CKKSFFTTables(n).to(device)


def _table_w(t: CKKSFFTTables, forward: bool, m: int):
    sl = [p[m:2 * m].reshape(m, 1) for p in (t.fwd if forward else t.inv)]
    return ((sl[0], sl[1]), (sl[2], sl[3]))


def _halves(x, m: int, half: int):
    xr = [[p.reshape(m, 2, half) for p in comp] for comp in x]
    u = ((xr[0][0][:, 0], xr[0][1][:, 0]), (xr[1][0][:, 0], xr[1][1][:, 0]))
    v = ((xr[0][0][:, 1], xr[0][1][:, 1]), (xr[1][0][:, 1], xr[1][1][:, 1]))
    return u, v


def _join(a, b, n: int):
    return tuple(tuple(torch.stack([a[c][p], b[c][p]], dim=1).reshape(n)
                       for p in range(2)) for c in range(2))


# -- transforms (plain versions) ------------------------------------------

def fft_forward(x, t: CKKSFFTTables):
    """Coefficients -> evaluations at psi^(2 rev(k) + 1).

    x: complex double-float ((re_hi, re_lo), (im_hi, im_lo)), each (N,)
    f32."""
    n = t.n
    m, half = 1, n >> 1
    while m < n:
        u, v = _halves(x, m, half)
        wv = cdf_mul(v, _table_w(t, True, m))
        x = _join(cdf_add(u, wv), cdf_sub(u, wv), n)
        m <<= 1
        half >>= 1
    return x


def fft_inverse(x, t: CKKSFFTTables):
    """Evaluations -> coefficients, the 1/n scale included."""
    n = t.n
    m, half = n >> 1, 1
    while m >= 1:
        u, v = _halves(x, m, half)
        s = cdf_add(u, v)
        d = cdf_mul(cdf_sub(u, v), _table_w(t, False, m))
        x = _join(s, d, n)
        m >>= 1
        half <<= 1
    inv_n = float(np.float32(1.0 / n))
    return tuple(tuple(p * inv_n for p in comp) for comp in x)


def _nest(x: torch.Tensor):
    return ((x[0], x[1]), (x[2], x[3]))


def ckks_fft_plain(x: torch.Tensor, t: CKKSFFTTables,
                   inverse: bool = False) -> torch.Tensor:
    """F1's plain version: x (4, N) f32 planes -> (4, N)."""
    f = fft_inverse if inverse else fft_forward
    out = f(_nest(x), t)
    return torch.stack([out[0][0], out[0][1], out[1][0], out[1][1]])


# -- the encoder's fused forms (plain versions) -----------------------------

def scatter_plain(z: torch.Tensor, scale: float,
                  t: CKKSFFTTables) -> torch.Tensor:
    """The slots z, (m, 2) float64 (re, im) with m <= N/2, the rest zero,
    times `scale` at their positions in the evaluation vector, conjugates
    mirrored, as (4, N) f32 double-float planes.  Evaluated as numpy's
    complex128 z * scale is, (re s - im 0, re 0 + im s), so that every
    signed zero is numpy's, then split as df_from_f64."""
    n = t.n
    zz = torch.zeros((n // 2, 2), dtype=torch.float64, device=z.device)
    zz[:z.shape[0]] = z
    re = zz[:, 0] * scale - zz[:, 1] * 0.0
    im = zz[:, 0] * 0.0 + zz[:, 1] * scale
    ev = torch.empty((2, n), dtype=torch.float64, device=z.device)
    ev[0, t.slot_pos] = re
    ev[1, t.slot_pos] = im
    ev[0, t.slot_conj] = re
    ev[1, t.slot_conj] = -im
    hi = ev.float()
    lo = (ev - hi.double()).float()
    return torch.stack([hi[0], lo[0], hi[1], lo[1]])


def round_coeffs(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Double-float coefficients to int64: round(hi) + round(lo + (hi -
    round(hi))), each round half to even."""
    a = torch.round(hi).long()
    return a + torch.round(lo + (hi - a.float())).long()


def ckks_fft_encode_plain(z: torch.Tensor, scale: float, q: torch.Tensor,
                          t: CKKSFFTTables) -> torch.Tensor:
    """The encode form's plain version: slots z (m, 2) float64 -> the
    rounded coefficients of their inverse transform modulo each prime of
    q, (k,) int32: (k, N) int32 (a floor modulus, in [0, q))."""
    c = ckks_fft_plain(scatter_plain(z, scale, t), t, inverse=True)
    return (round_coeffs(c[0], c[1]) % q.long().view(-1, 1)).int()


def garner_centered(x: torch.Tensor, moduli) -> torch.Tensor:
    """The centered value (N,) int64 of coefficient-form residues x, (r,
    N) int32 with r = len(moduli) of 1 or 2 (the first limbs), composed
    by Garner: valid while |value| < q0 q1 / 2."""
    x = x.long()
    q0 = moduli[0]
    if len(moduli) == 1:
        return torch.where(x[0] > q0 // 2, x[0] - q0, x[0])
    q1 = moduli[1]
    u = (x[1] - x[0] % q1) % q1 * pow(q0 % q1, -1, q1) % q1
    return x[0] + q0 * torch.where(u > q1 // 2, u - q1, u)


def ckks_fft_decode_plain(x: torch.Tensor, moduli, scale: float,
                          t: CKKSFFTTables) -> torch.Tensor:
    """The decode form's plain version: the first limbs x (r, N) int32 in
    coefficient form -> the slot values (N/2, 2) float64 (re, im): the
    centered coefficients split into f32 (hi, lo), times the f32 1/scale,
    the forward transform, the slots gathered and hi + lo in float64."""
    return _decode_tail(garner_centered(x, moduli), scale, t)


def _decode_tail(m: torch.Tensor, scale: float,
                 t: CKKSFFTTables) -> torch.Tensor:
    """The centered coefficients m (N,) int64 -> the slot values."""
    hi = m.float()
    lo = (m - hi.long()).float()
    inv = float(np.float32(1.0 / scale))
    zero = torch.zeros_like(hi)
    ev = ckks_fft_plain(torch.stack([hi * inv, lo * inv, zero, zero]), t)
    g = ev[:, t.slot_pos].double()
    return torch.stack([g[0] + g[1], g[2] + g[3]], dim=1)


def ckks_fft_encode64_plain(z: torch.Tensor, scale: float, q: torch.Tensor,
                            t: CKKSFFTTables) -> torch.Tensor:
    """The wide encode form's plain version: as ckks_fft_encode_plain, into
    (k, N) int64 words modulo q, (k,) int64 primes below 2^61: each
    rounded coefficient x (|x| < 2^62) as x mod q in [0, q)."""
    c = ckks_fft_plain(scatter_plain(z, scale, t), t, inverse=True)
    return torch.remainder(round_coeffs(c[0], c[1]), q.view(-1, 1))


def _i64(v: int) -> int:
    """A word below 2^64 as the int64 of its bit pattern."""
    return v - (1 << 64) if v >= 1 << 63 else v


def garner_constants(moduli) -> tuple:
    """(q0, q1, q0^-1 mod q1, its Shoup word floor(q0^-1 2^64 / q1),
    floor(2^64 / q1)) of the first two moduli, as Python ints; (q0, 1, 0,
    0, 0) for one."""
    q0 = int(moduli[0])
    if len(moduli) == 1:
        return q0, 1, 0, 0, 0
    q1 = int(moduli[1])
    inv = pow(q0 % q1, -1, q1)
    return q0, q1, inv, (inv << 64) // q1, (1 << 64) // q1


def garner_centered64(x: torch.Tensor, moduli) -> torch.Tensor:
    """The centered value (N,) int64 of the first limbs x, (r, N) int64
    words with r = len(moduli) of 1 or 2, by the wide Garner step: x0 mod
    q1 first (q0 may pass q1), t = (x1 - x0) q0^-1 mod q1, centered
    against q1 / 2, then m = x0 + q0 t_c in int64: exact for |value| <=
    q0 (q1 - 1) / 2 below 2^63, wrapping as the JAX package's int64 does
    beyond."""
    q0, q1, inv, inv_shoup, _ = garner_constants(moduli)
    x0 = x[0]
    if len(moduli) == 1:
        return torch.where(x0 > q0 // 2, x0 - q0, x0)
    d = mm.sub_mod(x[1], torch.remainder(x0, q1), q1)
    u = mm.mul_mod_shoup(d, inv, torch.tensor(_i64(inv_shoup),
                                              device=x.device), q1)
    return x0 + q0 * torch.where(u > q1 // 2, u - q1, u)


def ckks_fft_decode64_plain(x: torch.Tensor, moduli, scale: float,
                            t: CKKSFFTTables) -> torch.Tensor:
    """The wide decode form's plain version: as ckks_fft_decode_plain on
    int64 limbs x (r, N), the centered value by garner_centered64."""
    return _decode_tail(garner_centered64(x, moduli), scale, t)


# -- F1 ---------------------------------------------------------------------

_MAX_LOGN = 22  # the two passes hold at most 2^11 words a subproblem


def _check_n(n: int, name: str) -> None:
    if n < 2 or n & (n - 1) or n > 1 << _MAX_LOGN:
        raise ValueError(f"{name}: N = {n} is not a power of two in [2, "
                         f"2^{_MAX_LOGN}]")


def ckks_fft(x: torch.Tensor, t: CKKSFFTTables,
             inverse: bool = False) -> torch.Tensor:
    """F1 on a CUDA tensor, the plain version on a CPU tensor: x (4, N)
    f32 planes (re_hi, re_lo, im_hi, im_lo) -> the forward transform, or
    with inverse=True the inverse with its 1/n, as a new (4, N) tensor
    bit-equal to ckks_fft_plain."""
    if _build.is_plain(x, "ckks_fft"):
        return ckks_fft_plain(x, t, inverse)
    n = t.n
    if (x.shape != (4, n) or x.dtype != torch.float32
            or not x.is_contiguous() or t.fwd.device != x.device):
        raise ValueError(f"ckks_fft: x must be a contiguous (4, {n}) "
                         f"float32 tensor on the tables' device")
    _check_n(n, "ckks_fft")
    _build.check_aligned(x)
    out = torch.empty_like(x)
    table = t.inv if inverse else t.fwd
    with torch.cuda.device(x.device):
        err = _build.library().ptk_ckks_fft(
            x.data_ptr(), table.data_ptr(), out.data_ptr(), n, int(inverse),
            _build.stream(x))
    _build.check(err, "ckks_fft")
    ckks_fft.launches += 1
    return out


ckks_fft.launches = 0


def ckks_fft_encode(z: torch.Tensor, scale: float, q: torch.Tensor,
                    t: CKKSFFTTables) -> torch.Tensor:
    """F1's encode form on a CUDA tensor, its plain version on a CPU one:
    the slots z, (m, 2) float64 with m <= N/2 (the rest zero), at
    `scale` -> (k, N) int32 residues modulo q, (k,) int32 moduli below
    2^30, bit-equal to ckks_fft_encode_plain.  Counts in
    ckks_fft.launches."""
    if _build.is_plain(z, "ckks_fft_encode"):
        return ckks_fft_encode_plain(z, scale, q, t)
    n = t.n
    if (z.dim() != 2 or z.shape[1] != 2 or z.shape[0] > n // 2
            or z.dtype != torch.float64 or not z.is_contiguous()
            or t.fwd.device != z.device):
        raise ValueError(f"ckks_fft_encode: z must be a contiguous (m, 2) "
                         f"float64 tensor, m <= {n // 2}, on the tables' "
                         f"device")
    _check_n(n, "ckks_fft_encode")
    _build.check_operands(q)
    if q.dim() != 1 or q.device != z.device:
        raise ValueError("ckks_fft_encode: q must be a (k,) int32 tensor")
    _build.check_aligned(z)
    k = q.shape[0]
    out = torch.empty((k, n), dtype=torch.int32, device=z.device)
    scratch = torch.empty((4, n), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        err = _build.library().ptk_ckks_fft_encode(
            z.data_ptr(), z.shape[0], float(scale), q.data_ptr(), k,
            t.slot_of.data_ptr(), t.inv.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), n, _build.stream(z))
    _build.check(err, "ckks_fft_encode")
    ckks_fft.launches += 1
    return out


def ckks_fft_decode(x: torch.Tensor, moduli, scale: float,
                    t: CKKSFFTTables) -> torch.Tensor:
    """F1's decode form on a CUDA tensor, its plain version on a CPU one:
    the first limbs x, (r, N) int32 in coefficient form with r =
    len(moduli) of 1 or 2, at `scale` -> the slot values (N/2, 2) float64,
    bit-equal to ckks_fft_decode_plain.  Counts in ckks_fft.launches."""
    if _build.is_plain(x, "ckks_fft_decode"):
        return ckks_fft_decode_plain(x, moduli, scale, t)
    n = t.n
    r = len(moduli)
    _build.check_operands(x)
    if r not in (1, 2) or x.shape != (r, n) or t.fwd.device != x.device:
        raise ValueError(f"ckks_fft_decode: x must be ({r}, {n}) on the "
                         f"tables' device, with one or two moduli")
    _check_n(n, "ckks_fft_decode")
    _build.check_aligned(x)
    q0 = int(moduli[0])
    q1 = int(moduli[1]) if r == 2 else 1
    inv = pow(q0 % q1, -1, q1) if r == 2 else 0
    out = torch.empty((n // 2, 2), dtype=torch.float64, device=x.device)
    scratch = torch.empty((4, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().ptk_ckks_fft_decode(
            x.data_ptr(), r, q0, q1, inv, float(np.float32(1.0 / scale)),
            t.slot_of.data_ptr(), t.fwd.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), n, _build.stream(x))
    _build.check(err, "ckks_fft_decode")
    ckks_fft.launches += 1
    return out


def ckks_fft_encode64(z: torch.Tensor, scale: float, q: torch.Tensor,
                      t: CKKSFFTTables) -> torch.Tensor:
    """F1's wide encode form on a CUDA tensor, its plain version on a CPU
    one: the slots z, (m, 2) float64 with m <= N/2, at `scale` -> (k, N)
    int64 residues modulo q, (k,) int64 primes below 2^61, bit-equal to
    ckks_fft_encode64_plain.  Counts in ckks_fft.launches."""
    if _build.is_plain(z, "ckks_fft_encode64"):
        return ckks_fft_encode64_plain(z, scale, q, t)
    n = t.n
    if (z.dim() != 2 or z.shape[1] != 2 or z.shape[0] > n // 2
            or z.dtype != torch.float64 or not z.is_contiguous()
            or t.fwd.device != z.device):
        raise ValueError(f"ckks_fft_encode64: z must be a contiguous (m, 2) "
                         f"float64 tensor, m <= {n // 2}, on the tables' "
                         f"device")
    _check_n(n, "ckks_fft_encode64")
    if (q.dim() != 1 or q.dtype != torch.int64 or not q.is_contiguous()
            or q.device != z.device):
        raise ValueError("ckks_fft_encode64: q must be a contiguous (k,) "
                         "int64 tensor on z's device")
    _build.check_aligned(z)
    k = q.shape[0]
    out = torch.empty((k, n), dtype=torch.int64, device=z.device)
    scratch = torch.empty((4, n), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        err = _build.library().ptk_ckks_fft_encode64(
            z.data_ptr(), z.shape[0], float(scale), q.data_ptr(), k,
            t.slot_of.data_ptr(), t.inv.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), n, _build.stream(z))
    _build.check(err, "ckks_fft_encode64")
    ckks_fft.launches += 1
    return out


def ckks_fft_decode64(x: torch.Tensor, moduli, scale: float,
                      t: CKKSFFTTables) -> torch.Tensor:
    """F1's wide decode form on a CUDA tensor, its plain version on a CPU
    one: the first limbs x, (r, N) int64 words in coefficient form with r
    = len(moduli) of 1 or 2, at `scale` -> the slot values (N/2, 2)
    float64, bit-equal to ckks_fft_decode64_plain.  Counts in
    ckks_fft.launches."""
    if _build.is_plain(x, "ckks_fft_decode64"):
        return ckks_fft_decode64_plain(x, moduli, scale, t)
    n = t.n
    r = len(moduli)
    if (r not in (1, 2) or x.shape != (r, n) or x.dtype != torch.int64
            or not x.is_contiguous() or t.fwd.device != x.device):
        raise ValueError(f"ckks_fft_decode64: x must be a contiguous ({r}, "
                         f"{n}) int64 tensor on the tables' device, with "
                         f"one or two moduli")
    _check_n(n, "ckks_fft_decode64")
    _build.check_aligned(x)
    out = torch.empty((n // 2, 2), dtype=torch.float64, device=x.device)
    scratch = torch.empty((4, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().ptk_ckks_fft_decode64(
            x.data_ptr(), r, *garner_constants(moduli),
            float(np.float32(1.0 / scale)), t.slot_of.data_ptr(),
            t.fwd.data_ptr(), scratch.data_ptr(), out.data_ptr(), n,
            _build.stream(x))
    _build.check(err, "ckks_fft_decode64")
    ckks_fft.launches += 1
    return out

"""The CKKS special FFT in double-float (two-f32) arithmetic, its tables
and F1, its CUDA kernel (counterpart of phantom_tpu/ops/ckks_fft.py).

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

F1 (`ckks_fft`, csrc/ckks_fft.cu) runs the whole transform on the card
and equals the plain version bit for bit.  It is not a TPU kernel: the
JAX package runs this transform as XLA fusions.  A ciphertext-free
vector is held as one (4, N) f32 tensor, the planes re_hi, re_lo,
im_hi, im_lo; the plain transforms take and return the JAX package's
nested tuples ((re_hi, re_lo), (im_hi, im_lo)).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from .. import _build
from ..host.ntt_tables import bit_reverse_indices

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
    the evaluation domain)."""

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
    if n < 2 or n & (n - 1):
        raise ValueError(f"ckks_fft: N = {n} is not a power of two")
    out = x.clone()
    table = t.inv if inverse else t.fwd
    with torch.cuda.device(x.device):
        err = _build.library().ptk_ckks_fft(
            out.data_ptr(), table.data_ptr(), n, int(inverse),
            _build.stream(x))
    _build.check(err, "ckks_fft")
    ckks_fft.launches += 1
    return out


ckks_fft.launches = 0

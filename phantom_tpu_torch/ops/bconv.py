"""U2: fast RNS base conversion over u64 primes, its plain version and
its CUDA kernel's wrapper (counterpart of phantom_tpu/ops/bconv.py:30-184,
which the JAX package runs as XLA fusions: a scan over the input limbs
with a 128-bit accumulator, no pallas_call).

    y_i   = [x_i (Q/q_i)^-1]_{q_i}                     (scale_by_qhat_inv)
    raw_j = [sum_i y_i [Q/q_i]_{p_j}]_{p_j}            (matmul_reduce)
    out_j = [raw_j - v [Q]_{p_j}]_{p_j},  v = floor(sum_i y_i / q_i)

`bconv_approx` stops at raw (an overshoot of up to k_in Q), `bconv_exact`
subtracts v Q, with v from `floor_sum_div`: the JAX package's exact
2^-128 fixed-point cascade, whose truncation (< k_in 2^-128) the port
keeps, so v flips exactly where the JAX package's does.  The sum is an
exact 128-bit accumulator (k_in <= 63) reduced once by
`reduce_u128_any`, which reduces the high word first and so serves any
output prime, the small t of BGV's P -> {t} conversion included.  The
JAX package's MXU digit-plane accumulation (:186-251) is a TPU
workaround and has no counterpart.

U2 (csrc/u64_bconv.cu) computes one of four forms per launch ("approx",
"reduce": raw from y given, as the fused modup's pre-scaled iNTT hands it
over, "exact", and "scale_round": BFV's exact scale-and-round, below) on
(k_in, M) columns, M any count: the key switch passes one digit, or the P
rows of one half, at a time.  One launch a call and no scratch tensor: a
block holds y for 64 columns in shared memory (see there).

"scale_round" is the JAX package's scaleround.scale_and_round_exact
(phantom_tpu/ops/scaleround.py:224), round((num / den) x) from ibase to
obase where every output prime divides G = num prod(ibase) / den: with
y_i = [x_i (I/d_i)^-1]_{d_i} and G = omega_i d_i + rho_i,

    out_j = [sum_i y_i [omega_i]_{p_j} + F]_{p_j},
    F = sum_i g_i + floor((E + 2^127) / 2^64),  g_i, r_i = divmod(y_i rho_i,
        d_i),  E = sum_i floor(r_i 2^64 / d_i)

(the 128-bit words of its fixed-point cascade).  Its constants are a
scaleround.ExactScaleRoundConsts; its plain version is
`scale_round_plain`, operation for operation the JAX function.

Every form sums at most 63 input rows (MAX_ROWS): the 128-bit sum of
products of 61-bit words is exact only so far, and the JAX package
asserts the same bound (phantom_tpu/ops/bconv.py:75).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from . import modmath as mm
from .ntt import _ptr, check_words
from .rns_host import ModulusVec, i64_tensor, modulus_vec

FORMS = ("approx", "reduce", "exact", "scale_round")
MAX_ROWS = 63


def check_rows(k_in: int, what: str) -> None:
    """ValueError where a sum would take more than MAX_ROWS input rows."""
    if k_in > MAX_ROWS:
        raise ValueError(
            f"{what}: {k_in} input rows; a base conversion or scale-and-round"
            f" sums at most {MAX_ROWS} (its 128-bit sum of 61-bit products "
            "is exact only so far; the JAX package asserts the same bound, "
            "phantom_tpu/ops/bconv.py:75)")


class BaseConvConsts(NamedTuple):
    """One ibase -> obase conversion's constants (int64 words)."""

    ibase: ModulusVec           # (k_in,)
    obase: ModulusVec           # (k_out,)
    qhat_inv: torch.Tensor      # (k_in,) (Q/q_i)^-1 mod q_i
    qhat_inv_shoup: torch.Tensor
    qhat_mod_p: torch.Tensor    # (k_out, k_in)
    q_mod_p: torch.Tensor       # (k_out,)
    pow64_mod_p: torch.Tensor   # (k_out,) 2^64 mod p_j
    U: torch.Tensor             # (k_in,) floor(2^64 / q_i)
    V: torch.Tensor             # (k_in,) 2^64 mod q_i

    def to(self, device) -> "BaseConvConsts":
        return BaseConvConsts(*(x.to(device) for x in self))

    def kernel_words(self):
        """U2's per-call words in its ABI's order: QhatInv, its Shoup
        word, U, V, the (k_out, k_in) matrix, 2^64 mod p, Q mod p."""
        return (self.qhat_inv, self.qhat_inv_shoup, self.U, self.V,
                self.qhat_mod_p, self.pow64_mod_p, self.q_mod_p)


def consts_from_host(conv, device=None) -> BaseConvConsts:
    """A host BaseConverter (host/rns.py) -> its u64 constants."""
    ib, ob = conv.ibase, conv.obase
    qi, po = ib.moduli, ob.moduli
    return BaseConvConsts(
        ibase=modulus_vec(qi, device), obase=modulus_vec(po, device),
        qhat_inv=i64_tensor(ib.qhat_inv_mod_qi, device),
        qhat_inv_shoup=i64_tensor([(v << 64) // q for v, q in zip(
            ib.qhat_inv_mod_qi, qi)], device),
        qhat_mod_p=i64_tensor(conv.qhat_mod_p, device),
        q_mod_p=i64_tensor(conv.q_mod_p, device),
        pow64_mod_p=i64_tensor([(1 << 64) % p for p in po], device),
        U=i64_tensor([(1 << 64) // q for q in qi], device),
        V=i64_tensor([(1 << 64) % q for q in qi], device))


def scale_by_qhat_inv(x: torch.Tensor, c: BaseConvConsts) -> torch.Tensor:
    return mm.mul_mod_shoup(x, c.qhat_inv.view(-1, 1),
                            c.qhat_inv_shoup.view(-1, 1),
                            c.ibase.q.view(-1, 1))


def accumulate_matmul_128(y: torch.Tensor, mat: torch.Tensor):
    """sum_i y[i] mat[:, i], exact over 128 bits: (hi, lo) (k_out, M);
    y (k_in, M) and mat (k_out, k_in) below 2^61, k_in <= 63."""
    k_in = y.shape[0]
    check_rows(k_in, "accumulate_matmul_128")
    if mat.shape[1] != k_in:
        raise ValueError(f"accumulate_matmul_128: k_in={k_in}, mat "
                         f"{tuple(mat.shape)}")
    hi = lo = None
    for i in range(k_in):
        h, l_ = mm.mul_wide(y[i].unsqueeze(0), mat[:, i:i + 1])
        hi, lo = (h, l_) if hi is None else mm.add_wide(hi, lo, h, l_)
    return hi, lo


def reduce_u128_any(x_hi, x_lo, p, ratio_lo, ratio_hi, pow64_mod_p):
    """(x_hi 2^64 + x_lo) mod p for any 128-bit x and any p < 2^61."""
    hi_red = mm.barrett_reduce_u64(x_hi, p, ratio_hi)
    lo_red = mm.barrett_reduce_u64(x_lo, p, ratio_hi)
    hi_term = mm.mul_mod(hi_red, pow64_mod_p, p, ratio_lo, ratio_hi)
    return mm.add_mod(hi_term, lo_red, p)


def floor_sum_div_arrays(y: torch.Tensor, mv: ModulusVec, U: torch.Tensor,
                         V: torch.Tensor) -> torch.Tensor:
    """v = floor(sum_i y_i / q_i) in exact 2^-128 fixed point (the JAX
    package's cascade): with 2^64 = U q + V, y 2^64 = (y U + q1) q + r1
    and r1 2^64 = s2 q + r2, so sum y_i / q_i = (S1 2^64 + S2 + e) / 2^128
    with S1 = sum (y U + q1), S2 = sum s2, 0 <= e < k.  Returns (M,)."""
    q, rlo, rhi = mv.col()
    yU = y * U.view(-1, 1)
    h, l_ = mm.mul_wide(y, V.view(-1, 1))
    q1, r1 = mm.barrett_div_mod_u128(h, l_, q, rlo, rhi)
    s2, _ = mm.barrett_div_mod_u128(r1, torch.zeros_like(r1), q, rlo, rhi)
    z = torch.zeros_like(y[0])
    s1_hi, s1_lo, s2_hi, s2_lo = z, z, z, z
    for i in range(y.shape[0]):
        s1_lo, cr = mm.add_u64_carry(s1_lo, yU[i])
        s1_hi = s1_hi + cr
        s1_lo, cr = mm.add_u64_carry(s1_lo, q1[i])
        s1_hi = s1_hi + cr
        s2_lo, cr = mm.add_u64_carry(s2_lo, s2[i])
        s2_hi = s2_hi + cr
    _, cr = mm.add_u64_carry(s1_lo, s2_hi)
    return s1_hi + cr


def floor_sum_div(y: torch.Tensor, c: BaseConvConsts) -> torch.Tensor:
    return floor_sum_div_arrays(y, c.ibase, c.U, c.V)


def matmul_reduce(y: torch.Tensor, c: BaseConvConsts) -> torch.Tensor:
    hi, lo = accumulate_matmul_128(y, c.qhat_mod_p)
    p, rlo, rhi = c.obase.col()
    return reduce_u128_any(hi, lo, p, rlo, rhi, c.pow64_mod_p.view(-1, 1))


def scale_round_plain(x: torch.Tensor, c) -> torch.Tensor:
    """The "scale_round" form's plain version: x (k_in, M) residues of
    c.ibase -> (k_out, M) residues of round((num / den) x) over c.obase (c
    a scaleround.ExactScaleRoundConsts), operation for operation the JAX
    package's scale_and_round_exact."""
    d_q, d_rlo, d_rhi = c.ibase.col()
    y = mm.mul_mod_shoup(x, c.ihat_inv.view(-1, 1),
                         c.ihat_inv_shoup.view(-1, 1), d_q)
    hi, lo = accumulate_matmul_128(y, c.omega_mod_out)
    out_q, out_rlo, out_rhi = c.obase.col()
    pow64 = c.pow64_mod_out.view(-1, 1)
    int_part = reduce_u128_any(hi, lo, out_q, out_rlo, out_rhi, pow64)
    ph, plv = mm.mul_wide(y, c.rho.view(-1, 1))
    g, r = mm.barrett_div_mod_u128(ph, plv, d_q, d_rlo, d_rhi)
    f2, _ = mm.barrett_div_mod_u128(r, torch.zeros_like(r), d_q, d_rlo,
                                    d_rhi)
    z = torch.zeros_like(y[0])
    g_hi, g_lo, e_hi, e_lo = z, z, z, z
    for i in range(y.shape[0]):
        g_lo, cr = mm.add_u64_carry(g_lo, g[i])
        g_hi = g_hi + cr
        e_lo, cr = mm.add_u64_carry(e_lo, f2[i])
        e_hi = e_hi + cr
    _, c3 = mm.add_u64_carry(e_lo, torch.full_like(e_lo, mm.SIGN))
    g_lo, cr = mm.add_u64_carry(g_lo, e_hi + c3)
    g_hi = g_hi + cr
    frac_part = reduce_u128_any(g_hi.unsqueeze(0), g_lo.unsqueeze(0), out_q,
                                out_rlo, out_rhi, pow64)
    return mm.add_mod(int_part, frac_part, out_q)


def bconv_plain(x: torch.Tensor, c: BaseConvConsts,
                form: str = "approx") -> torch.Tensor:
    """x (k_in, M) -> (k_out, M) in [0, p): `form` one of FORMS (c an
    ExactScaleRoundConsts for "scale_round")."""
    if form == "scale_round":
        return scale_round_plain(x, c)
    y = x if form == "reduce" else scale_by_qhat_inv(x, c)
    raw = matmul_reduce(y, c)
    if form != "exact":
        return raw
    p, rlo, rhi = c.obase.col()
    corr = mm.mul_mod(floor_sum_div(y, c).unsqueeze(0),
                      c.q_mod_p.view(-1, 1), p, rlo, rhi)
    return mm.sub_mod(raw, corr, p)


def bconv(x: torch.Tensor, c: BaseConvConsts,
          form: str = "approx") -> torch.Tensor:
    """U2 on CUDA tensors; the plain version on CPU tensors.  x (k_in, M)
    int64 residues of c.ibase (the pre-scaled y for "reduce") -> (k_out,
    M) in [0, p); c an ExactScaleRoundConsts for "scale_round"."""
    if form not in FORMS:
        raise ValueError(f"form {form!r} not in {FORMS}")
    check_rows(x.shape[0], "bconv64")
    if _build.is_plain(x, "bconv64"):
        return bconv_plain(x, c, form)
    x = x.contiguous()
    k_in, m = x.shape
    k_out = c.obase.q.shape[0]
    if c.ibase.q.shape[0] != k_in:
        raise ValueError(f"bconv64: {k_in} input rows against a base of "
                         f"{c.ibase.q.shape[0]}")
    words = c.kernel_words()
    check_words(x, *c.ibase, *c.obase, *words)
    out = torch.empty((k_out, m), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().ptk_u64_bconv(
            out.data_ptr(), x.data_ptr(), *(v.data_ptr() for v in c.ibase),
            *(_ptr(w) for w in words[:5]),
            *(v.data_ptr() for v in c.obase), *(_ptr(w) for w in words[5:]),
            k_in, k_out, m, FORMS.index(form), _build.stream(x))
    _build.check(err, "u64_bconv")
    bconv.launches += 1
    return out


bconv.launches = 0


def bconv_approx(x, c: BaseConvConsts, op=bconv) -> torch.Tensor:
    """The overshooting conversion (reference bConv_BEHZ)."""
    return op(x, c, "approx")


def bconv_exact(x, c: BaseConvConsts, op=bconv) -> torch.Tensor:
    """[x mod Q]_{p_j}, v corrected (reference bConv_HPS)."""
    return op(x, c, "exact")

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's CKKS key switching on one NVIDIA GPU and
check it.

    python3 chip_smoke.py          # from the repo root, one CUDA device

Two configurations, both N = 2^16 with 43 data primes of 28 bits from
chain index 1, primes as phantom_tpu/utils/benchsetup.py builds them:
  headline  22 special primes of 29 bits (dnum 2, the last digit 21 rows):
            the multiply + relinearize + rescale step on the xla-split
            modup (K1, K2, K5, K9) through each epilogue: the pair (K1,
            K3, then the rescale's K1 and K3), K8 with 8 rows per block
            (then the rescale), K7 (moddown and rescale in one);
  alpha 8   8 special primes of 29 bits (dnum 6, the last digit 3 rows):
            rotations, hoisted rotations (K9 per step) and the step on the
            fused modup (K1, K3, K4), as the JAX package's default dispatch
            runs them at alpha <= 8.
Phases, one line each or more; any failure exits non-zero:

  1. device    card name and power limit, CUDA, nvcc, triton, device count
  2. build     the kernels of phantom_tpu_torch/csrc, built from source
  3. golden    the step (n = 1024, alpha = 2) through each epilogue on both
               routes, and the rotation golden file (rotation, key switch,
               both hoisted forms, moddown, the step through each
               epilogue) through the kernels, bit-equal to the JAX
               package's outputs
  4. kernels   every kernel call of one headline step through each
               epilogue is bit-equal to its plain torch version on the
               same inputs, and both are timed
  5. step      keys from a seeded generator, two encryptions of small
               integer polynomials times 2^22 (coefficient encoding), the
               step through the kernels bit-equal to the step through the
               plain versions and through the other two epilogues, the
               launch counts, and a decryption equal to the exact
               negacyclic product m1 m2
  6. timing    a chain of steps, each output re-padded into the next input
               (as bench.py does), kernel path against plain path in turns,
               then the three epilogues in turns (pair, K8, K7, K7, K8,
               pair), timed with CUDA events; K8 alone at 1, 2, 4 and 8
               rows per block
  7. profile   torch.profiler over a few chained kernel-path steps: the
               device-busy time, the idle share and the top device kernels
  8. alpha-8 setup   the secret key, the relin key, Galois keys for steps
               1..7 and two encryptions, from a seeded generator
  9. alpha-8 kernels one rotation, one hoisting_sum32, one
               hoisted_linear_combo32 and the step on both routes and
               through the K8 and K7 epilogues, with every kernel call
               bit-equal to its plain version, and timed
 10. rotate    rotate32(., 1): kernels = plain, launch counts, decryption
               equal to sigma_g(m1)
 11. hoist     hoisting_sum32 over steps 1..7 and hoisted_linear_combo32
               over steps 0..7 with weights in [-3, 3]: kernels = plain,
               launch counts, decryptions equal to sum sigma(m1) and
               sum w_s sigma_s(m1)
 12. alpha-8 step  the K4 route = the plain path = the xla-split route =
               the K8 and K7 epilogues, launch counts, decryption equal to
               m1 m2
 13. alpha-8 timing  chained steps on both routes in turns, chained
               rotations, hoisting_sum32, hoisted_linear_combo32, peak
               memory
Then a {"kernels": [...]} line: per kernel its launches over the counted
path runs (EXPECTED), its largest error against plain, and the summed time
of the probed calls (phases 4 and 9) through the kernel and the plain
version beside their bound.  The bound of
a call is the larger of its bytes (each input, the NTT tables' rows
included, read once, each output written once) at 3.35 TB/s and its 32-bit
integer multiplies (a Shoup product 3, a Barrett product 8, a 32x32->64
product 2, the floor-sum cascade 20 per word; a sum of products reduced
once, by a 64-bit Barrett reduction 6 where the operands' range keeps it
below 2^64, else by a 128-bit reduction 20) at 132 SMs x 64 lanes x
1.98 GHz = 16.7 T/s.  No single PyTorch call computes
a modular NTT or a modular product-sum, so library_ms is null.  Last
comes {"ok": true, "device": ...}.  Without a CUDA device, or without the
repo around it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
GOLDEN = os.path.join(FIXTURES, "ckks_step_n1024.npz")
ROTATE_GOLDEN = os.path.join(FIXTURES, "rotate_n1024.npz")
HEADLINE = dict(n=1 << 16, limbs=43, alpha=22, bits=28)
ALPHA8 = dict(n=1 << 16, limbs=43, alpha=8, bits=28)
STEPS = tuple(range(1, 8))
DELTA_BITS = 22
SEED = 2026
CHAIN_STEPS = 20
CHAIN8_STEPS = 10
PROFILE_STEPS = 5
REPS = 10
KERNELS = [  # name, wrapper attribute, source, the TPU kernel it replaces
    ("K1", "ntt_inverse", "phantom_tpu_torch/csrc/ntt.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:434"),
    ("K2", "ntt_forward", "phantom_tpu_torch/csrc/ntt.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:371"),
    ("K3", "bconv_ntt_forward", "phantom_tpu_torch/csrc/bconv_ntt.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:635"),
    ("K5", "fold_matmul", "phantom_tpu_torch/csrc/bconv.cu",
     "phantom_tpu/ops/bconv_pallas.py:97"),
    ("K4", "modup_ip", "phantom_tpu_torch/csrc/modup_ip.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:1427"),
    ("K9", "inner_product", "phantom_tpu_torch/csrc/ip.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:1378"),
    ("K8", "moddown_rows", "phantom_tpu_torch/csrc/moddown_rows.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:877"),
    ("K7", "moddown_rescale", "phantom_tpu_torch/csrc/moddown_rescale.cu",
     "phantom_tpu/ops/ntt_mxu_pallas.py:1101"),
]


def _launches(**kw):
    return {name: kw.get(name, 0) for name, *_ in KERNELS}


EXPECTED = {  # launches per path run
    "headline step": _launches(K1=3, K2=1, K3=2, K5=2, K9=1),
    "headline step, K8 epilogue": _launches(K1=3, K2=1, K3=1, K5=2, K9=1,
                                            K8=1),
    "headline step, K7 epilogue": _launches(K1=2, K2=1, K5=2, K9=1, K7=1),
    "rotation": _launches(K1=2, K3=1, K4=1),
    "hoisting_sum32": _launches(K1=2, K3=2, K9=7),
    "hoisted_linear_combo32": _launches(K1=2, K3=2, K9=7),
    "alpha-8 step": _launches(K1=3, K3=2, K4=1),
    "alpha-8 step, K8 epilogue": _launches(K1=3, K3=1, K4=1, K8=1),
    "alpha-8 step, K7 epilogue": _launches(K1=2, K4=1, K7=1),
    "alpha-8 xla-split step": _launches(K1=3, K2=1, K3=2, K5=6, K9=1),
}
EPILOGUES = {  # the CKKS step's epilogues, by the kernel each adds
    "pair": {}, "K8": {"moddown_rows": 8}, "K7": {"merged_epilogue": True}}
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 132 * 64 * 1.98e9


# ---------------------------------------------------------------------------
# helpers (also driven on the CPU by tests/test_torch_pipeline.py and
# tests/test_torch_rotate.py)
# ---------------------------------------------------------------------------

def chain_params(n: int, limbs: int, alpha: int, bits: int = 28):
    """Primes as utils/benchsetup.py builds them: `limbs` data primes of
    `bits` bits, `alpha` special primes of bits + 1."""
    from phantom_tpu_torch import EncryptionParameters
    from phantom_tpu_torch.host import numth
    qs = numth.get_primes(2 * n, bits, limbs + 1)
    ps = numth.get_primes(2 * n, bits + 1, alpha)
    return EncryptionParameters.create(n, qs[:limbs], ps)


def encode_coeffs(ctx, m: np.ndarray, delta_bits: int, rows=None):
    """Integer polynomial m (N,) times 2^delta_bits -> NTT-form plaintext
    over the table rows `rows` (default all data primes), int32."""
    import torch
    from phantom_tpu_torch.ops import ntt_kernels, sampling
    if rows is None:
        rows = ctx.ntt.all_rows()[:ctx.params.size_q]
    e = torch.as_tensor(m.astype(np.int64) << delta_bits,
                        device=ctx.key_q.device)
    return ntt_kernels.ntt_forward(
        sampling.lift_signed(e, ctx.ntt.q[rows.long()]), ctx.ntt, rows)


def negacyclic_product(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """m1 m2 mod X^N + 1 for small integer polynomials, exactly."""
    n = m1.shape[0]
    f = np.fft.rfft(m1.astype(np.float64), 2 * n) * np.fft.rfft(
        m2.astype(np.float64), 2 * n)
    full = np.fft.irfft(f, 2 * n)
    exact = np.rint(full).astype(np.int64)
    if np.abs(full - exact).max() >= 0.25:
        raise RuntimeError("negacyclic_product: FFT not exact")
    return exact[:n] - exact[n:]


def galois_coeffs(m: np.ndarray, elt: int) -> np.ndarray:
    """sigma_elt on an integer polynomial: coefficient i moves to i elt mod
    2N and is negated when it lands at N or above."""
    n = m.shape[0]
    dst = np.arange(n, dtype=np.int64) * elt % (2 * n)
    out = np.zeros_like(m)
    out[dst % n] = np.where(dst >= n, -m, m)
    return out


def make_step_inputs(ctx, seed: int, delta_bits: int, device):
    """Keys on `device` from a seeded generator and two encryptions of
    random polynomials with coefficients in [-3, 3]."""
    import torch
    from phantom_tpu_torch.ops.pipeline32 import build_pipeline32
    from phantom_tpu_torch.schemes import keys
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sk = keys.gen_secret_key(ctx, gen)
    pipe = build_pipeline32(ctx, keys.gen_relin_key(ctx, sk, gen),
                            device=device)
    rng = np.random.default_rng(seed)
    m1, m2 = (rng.integers(-3, 4, ctx.params.n) for _ in range(2))
    d1, d2 = (keys.encrypt_symmetric(ctx, sk, encode_coeffs(
        ctx, m, delta_bits), gen) for m in (m1, m2))
    return sk, pipe, d1, d2, m1, m2


def make_galois(ctx, sk, seed: int, steps, device):
    """Galois keys for `steps` from a seeded generator -> Galois32."""
    import torch
    from phantom_tpu_torch.ops.pipeline32 import build_galois32
    from phantom_tpu_torch.schemes import keys
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    return build_galois32(ctx, keys.create_galois_keys(ctx, sk, gen, steps),
                          device=device)


def decrypt_coeffs(ctx, sk, ct, scale: float) -> np.ndarray:
    """Decrypt, CRT the first two limbs to the centred value, divide by
    `scale`: float64 (N,)."""
    from phantom_tpu_torch.ops import ntt_kernels
    from phantom_tpu_torch.schemes import keys
    pt = keys.decrypt(ctx, sk, ct)
    x = ntt_kernels.ntt_inverse(pt[:2].contiguous(), ctx.ntt,
                                ctx.ntt.all_rows()[:2]).cpu().numpy()
    q0, q1 = ctx.params.data_moduli[:2]
    r0, r1 = x[0].astype(np.int64), x[1].astype(np.int64)
    t = (r1 - r0) % q1 * pow(q0, -1, q1) % q1
    val = r0 + q0 * t
    val = np.where(val > q0 * q1 // 2, val - q0 * q1, val)
    return val.astype(np.float64) / scale


def check_coeffs(est: np.ndarray, want: np.ndarray, what: str) -> float:
    """Raise unless est rounds to want in every coefficient; return the
    largest distance before rounding."""
    got = np.rint(est).astype(np.int64)
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)
        raise RuntimeError(f"{what}: {bad.size} coefficients differ, first "
                           f"at {bad[0]}: {got[bad[0]]} != {want[bad[0]]}")
    return float(np.abs(est - want).max())


def check_decrypt(ctx, sk, out, m1, m2, delta_bits: int) -> float:
    """The step's output (scale 2^(2 delta_bits) / q_last) decrypts to
    m1 m2 in every coefficient; returns the largest distance before
    rounding."""
    qlast = ctx.params.data_moduli[out.shape[1]]
    return check_coeffs(decrypt_coeffs(ctx, sk, out,
                                       2.0 ** (2 * delta_bits) / qlast),
                        negacyclic_product(m1, m2), "decrypt")


def encode_weights(ctx, ks, w: np.ndarray):
    """Integer polynomial w (N,) -> NTT-form (size_qlp, N) weights over
    QlP, for hoisted_linear_combo32."""
    return encode_coeffs(ctx, w, 0, ks.rows_qlp)


def remix(out, q):
    """A step output (2, k-1, N) -> a full (2, k, N) input: the dropped
    limb is row 0 reduced into its modulus (bench.py's re-pad)."""
    import torch
    row0 = out[:, :1]
    pad = torch.where(row0 >= q, row0 - q, row0)
    return torch.cat([out, pad], dim=1)


def rotate_golden_state(device, path: str = ROTATE_GOLDEN):
    """The rotation golden file on `device`: (the file, its context, the
    key-switch tables, its Galois keys, its tensors d1, d2, pts,
    moddown_in)."""
    from phantom_tpu_torch import convert, make_context
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    g = np.load(path)
    ctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist()), device=device)
    ks = pp.build_keyswitch32(ctx, device=device)
    gal = convert.galois_keys(ctx, g["glk"], g["elts"].tolist())
    t = {k: convert.residues(g[k]).to(device)
         for k in ("d1", "d2", "pts", "moddown_in")}
    return g, ctx, ks, gal, t


def rotate_golden(device, path: str = ROTATE_GOLDEN):
    """The rotation golden file through the port on `device`: returns
    {name: (port output, JAX output)} for the rotation, the key switch,
    both hoisted forms, moddown32 and the step through each epilogue of
    EPILOGUES (K8's last block of rows at k = 5 masks three)."""
    from phantom_tpu_torch import convert
    from phantom_tpu_torch.ops import pipeline32 as pp
    g, ctx, ks, gal, t = rotate_golden_state(device, path)
    rlk = convert.residues(g["rlk"]).to(device)
    d1 = t["d1"]
    kidx = gal.key_index(int(g["elts"][0]))
    out = {
        "rotate": (pp.rotate32(ks, gal, d1, 1), g["rotate"]),
        "keyswitch": (pp.keyswitch_from_ntt32(ks, d1[1], gal.evks[kidx]),
                      g["keyswitch"]),
        "hoisting_sum": (pp.hoisting_sum32(ks, gal, d1,
                                           g["hoist_steps"].tolist()),
                         g["hoist"]),
        "linear_combo": (pp.hoisted_linear_combo32(
            ks, gal, d1, g["combo_steps"].tolist(), list(t["pts"])),
            g["combo"]),
        "moddown": (pp.moddown32(ks, t["moddown_in"]), g["moddown"]),
    }
    for name, kw in EPILOGUES.items():
        pipe = pp.build_pipeline32(ctx, rlk, device=device, **kw)
        out["step" if name == "pair" else f"step_{name}"] = (
            pipe(d1, t["d2"]), g["step"])
    return out


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for one kernel call
# ---------------------------------------------------------------------------

def _n(x) -> int:
    return 0 if x is None else x.numel()


def _ntt_ops(rows: int, n: int) -> int:
    return rows * (n // 2) * (n.bit_length() - 1) * 3


def _max(x) -> int:
    """The largest word of an int32 residue tensor (every modulus is below
    2^31, so no word is negative)."""
    return int(x.max())


def _reduce_ops(terms: int, a_max: int, b_max: int) -> int:
    """Multiplies that reduce a sum of `terms` products a b with a <= a_max,
    b <= b_max: a 64-bit Barrett reduction (6) when the sum cannot leave 64
    bits, else a 128-bit one (20)."""
    return 6 if terms * a_max * b_max < 1 << 64 else 20


def _table_bytes(t, rows, num_l: int) -> int:
    """The twiddle table rows a call reads, with their Shoup words."""
    used = num_l if rows is None else len(set(rows.tolist()))
    return used * t.root_powers.shape[1] * 8


def call_bound(name: str, a: dict, out):
    """(bytes, 32-bit multiplies) of one call from its bound arguments."""
    w = 4
    if name == "K5":
        k_out, k_in = a["mat"].shape
        n = a["y"].shape[1]
        return (w * (_n(a["y"]) + _n(a["mat"]) + _n(out)),
                k_out * n * (2 * k_in + _reduce_ops(k_in, _max(a["y"]),
                                                    _max(a["mat"]))))
    if name in ("K1", "K2"):
        x = a["x"]
        n, num_l = x.shape[-1], x.shape[-2]
        rows_n = x.numel() // n
        out0 = out[0] if isinstance(out, tuple) else out
        byt = w * (x.numel() + out0.numel()) + _table_bytes(
            a["t"], a["rows"], num_l)
        ops = _ntt_ops(rows_n, n)
        if name == "K1":
            ops += 3 * x.numel()
            if a["mul_by"] is not None:
                byt += w * a["mul_by"].numel()
                ops += 8 * x.numel()
            if a["emit_floor_div"] is not None:
                byt += w * _n(out[1])
                ops += 20 * x.numel()
        else:
            if a["sub_from"] is not None:
                byt += w * a["sub_from"].numel()
                ops += 3 * x.numel()
            if a["tensor_add"] is not None:
                byt += w * sum(_n(d) for d in a["tensor_add"])
                ops += 9 * x.numel()
        return byt, ops
    if name in ("K3", "K8"):
        y, mat = a["y"], a["mat"]
        g_, alpha, n = y.shape
        k_out = mat.shape[-2]  # K8's (k, alpha) serves both halves
        self_n = 0
        if name == "K3" and a["self_rows"] is not None:
            kd = g_ * alpha if a["k_data"] is None else a["k_data"]
            self_n = sum(max(0, min((g + 1) * alpha, kd, k_out) - g * alpha)
                         for g in range(g_))
        conv = g_ * k_out - self_n
        byt = w * (y.numel() + mat.numel() + _n(out) + self_n * n
                   + _n(a["v"]) + _n(a["sub_from"])
                   + sum(_n(d) for d in a["tensor_add"] or ())) + \
            _table_bytes(a["t"], a["rows"], k_out)
        ops = conv * n * (2 * alpha + _reduce_ops(alpha, _max(y), _max(mat)))
        ops += _ntt_ops(conv, n)
        ops += 8 * conv * n if a["v"] is not None else 0
        ops += 3 * _n(a["sub_from"])
        ops += 9 * _n(out) if a["tensor_add"] is not None else 0
        return byt, ops
    if name == "K9":
        t, evk = a["t"], a["evk"]
        beta, k_out, n = t.shape
        byt = w * (t.numel() + evk.numel() + _n(out) + _n(a["perm"]))
        return byt, (4 * beta * k_out * n + 2 * k_out * n * _reduce_ops(
            beta, _max(t), _max(evk)))
    if name == "K7":
        y, mat = a["y"], a["mat"]
        _, alpha, n = y.shape
        k = mat.shape[0]
        byt = w * (y.numel() + mat.numel() + _n(a["v"]) + _n(a["sub_from"])
                   + sum(_n(d) for d in a["tensor_add"]) + _n(out)) + \
            _table_bytes(a["t"], a["rows"], k) + 8 * n  # + the last iNTT row
        # per word: the conversion and v (as K3), the forward NTT of every
        # row; the last limb's iNTT, n^-1 and its epilogue (s - x) P^-1 +
        # c_g (12); the other rows' delta P^-1, xl mod q_j, s P^-1, c_g and
        # q_last^-1 (26)
        ops = 2 * k * n * (2 * alpha + _reduce_ops(alpha, _max(y), _max(mat))
                           + 8)
        ops += _ntt_ops(2 * k, n) + _ntt_ops(2, n) + 3 * 2 * n
        ops += 12 * 2 * n + 26 * 2 * (k - 1) * n
        return byt, ops
    if name == "K4":
        y, mats, c2, evk = a["y"], a["mats"], a["c2"], a["evk"]
        beta, k_out, alpha = mats.shape
        n = y.shape[-1]
        kd = beta * alpha if a["k_data"] is None else a["k_data"]
        pairs = c2 if isinstance(c2, tuple) else (c2,)
        conv = beta * k_out - kd
        byt = w * (y.numel() + mats.numel() + len(pairs) * kd * n
                   + evk.numel() + _n(out)) + _table_bytes(
                       a["t"], a["rows"], k_out)
        # T_d[j] < q_j: the digit sum's products are below max q times evk
        rows = a["rows"]
        q_out = a["t"].q[:k_out] if rows is None else a["t"].q[rows.long()]
        ops = (conv * n * (2 * alpha + _reduce_ops(alpha, _max(y),
                                                   _max(mats)))
               + _ntt_ops(conv, n) + (8 * kd * n if len(pairs) == 2 else 0)
               + beta * k_out * n * 4
               + 2 * k_out * n * _reduce_ops(beta, _max(q_out) - 1,
                                             _max(evk)))
        return byt, ops
    raise ValueError(name)


def bound_ms(byt: int, ops: int):
    t_b, t_o = byt / HBM_BYTES_PER_S, ops / INT_MULS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _cmd(args):
    try:
        r = subprocess.run(args, capture_output=True, text=True, timeout=60)
        return (r.stdout or r.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def _time(fn, reps: int) -> float:
    """Milliseconds per call, CUDA events around `reps` calls after one
    warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(_max_err(x, y) for x, y in zip(a, b))
    return int((a.long() - b.long()).abs().max())


class _Probe:
    """Stands in for one kernel wrapper: runs the kernel, holds it against
    the plain version on the same inputs, times both, and computes the
    call's bound."""

    def __init__(self, name, kernel, plain, reps: int):
        self.name, self.kernel, self.plain, self.reps = (name, kernel, plain,
                                                         reps)
        self.sig = inspect.signature(plain)
        self.calls = []

    def __call__(self, *args, **kw):
        import torch
        out = self.kernel(*args, **kw)
        ref = self.plain(*args, **kw)
        torch.cuda.synchronize()
        shape = tuple(args[0].shape)
        err = _max_err(out, ref)
        if err:
            raise RuntimeError(f"{self.name}: kernel differs from plain at "
                               f"{shape}: max_abs_err {err}")
        ba = self.sig.bind(*args, **kw)
        ba.apply_defaults()
        byt, ops = call_bound(self.name, ba.arguments, out)
        b_ms, b_by = bound_ms(byt, ops)
        self.calls.append(dict(
            shape=shape, err=err, bound_ms=b_ms, bound_by=b_by, bytes=byt,
            ops=ops, ms=_time(lambda: self.kernel(*args, **kw), self.reps),
            plain_ms=_time(lambda: self.plain(*args, **kw), self.reps)))
        return out


def _probes(pp, wrappers):
    return pp.Kernels(*(_Probe(name, k, p, REPS) for (name, *_), k, p
                        in zip(KERNELS, wrappers, pp.PLAIN)))


def _print_calls(probes, card, since):
    for (name, *_), probe in zip(KERNELS, probes):
        for c in probe.calls[since[name]:]:
            print(f"kernel {name} {c['shape']}: bit-equal to plain; "
                  f"{c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} ms, bound "
                  f"{c['bound_ms']:.4f} ms by {c['bound_by']} "
                  f"({c['bytes'] / 1e6:.1f} MB, {c['ops'] / 1e9:.3f} G mul)"
                  f" [{card}]")
        since[name] = len(probe.calls)


def _count(wrappers, what: str, fn, launches: dict):
    """Run fn with every launch count set to 0 just before and read just
    after; check them against EXPECTED[what] and add them to launches."""
    import torch
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    got = {name: w.launches for (name, *_), w in zip(KERNELS, wrappers)}
    print(f"launches, {what}: " + ", ".join(f"{k}={v}"
                                            for k, v in got.items()))
    if got != EXPECTED[what]:
        raise RuntimeError(f"{what}: launches {got} != {EXPECTED[what]}")
    for k, v in got.items():
        launches[k] += v
    return out


def _chain_timing(runs, make_chain, steps: int, card: str, what: str):
    """Time make_chain(route) per route in the order given (e.g. A, B, B,
    A), with the peak device memory of each route; returns the final
    outputs per route."""
    import torch
    times, finals, peaks = {}, {}, {}
    for route in runs:
        chain = make_chain(route)
        chain(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        finals[route] = chain(steps)
        end.record()
        torch.cuda.synchronize()
        times.setdefault(route, []).append(start.elapsed_time(end) / steps)
        peaks[route] = max(peaks.get(route, 0),
                           torch.cuda.max_memory_allocated())
    for route, ts in times.items():
        ms = float(np.mean(ts))
        print(f"timing {what}, {route}: {ms:.3f} ms/op, {1000 / ms:.1f} "
              f"ops/s ({steps} chained, runs "
              f"{', '.join(f'{t:.3f}' for t in ts)} ms); "
              f"max_memory_allocated {peaks[route] / 2**20:.1f} MiB [{card}]")
    return finals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from phantom_tpu_torch import _build, make_context
    from phantom_tpu_torch.ops import bconv_kernels, ip_kernels
    from phantom_tpu_torch.ops import moddown_kernels, modup_ip_kernels
    from phantom_tpu_torch.ops import ntt_kernels
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes import galois
    from phantom_tpu_torch.schemes.params import EncryptionParameters

    dev = torch.device("cuda")
    card = _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    print(card)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
          f", CUDA {torch.version.cuda}; triton {triton_v}; "
          f"devices {torch.cuda.device_count()}")
    print("nvcc: " + _cmd([_build.nvcc_path(), "--version"]).splitlines()[-1])

    # 2. build
    t0 = time.time()
    path = _build.build()
    _build.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s")

    # 3. golden files from the JAX package
    g = np.load(GOLDEN)
    gctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist()))
    grlk = torch.as_tensor(g["rlk"].view(np.int32), device=dev)
    gd = [torch.as_tensor(g[k].view(np.int32), device=dev)
          for k in ("d1", "d2")]
    for name, kw in EPILOGUES.items():
        gpipe = pp.build_pipeline32(gctx, grlk, **kw)
        for route, gout in (("K4", gpipe(*gd)), ("xla-split", pp.
                            _mult_relin_rescale_split(gpipe, *gd))):
            if not np.array_equal(gout.cpu().numpy().view(np.uint32),
                                  g["out"]):
                raise RuntimeError(f"golden: step ({name} epilogue, {route} "
                                   "route) differs from the JAX output")
        print(f"golden: step, {name} epilogue, K4 and xla-split routes, "
              f"bit-equal to the JAX package's output {tuple(g['out'].shape)}")
    for name, (got, want) in rotate_golden(dev).items():
        if not np.array_equal(got.cpu().numpy().view(np.uint32), want):
            raise RuntimeError(f"golden: {name} differs from the JAX output")
        print(f"golden: {name} bit-equal to the JAX package's output "
              f"{tuple(want.shape)}")

    # 4-5. headline step
    t0 = time.time()
    params = chain_params(**HEADLINE)
    ctx = make_context(params)
    sk, pipe, d1, d2, m1, m2 = make_step_inputs(ctx, SEED, DELTA_BITS, dev)
    torch.cuda.synchronize()
    print(f"setup: N={params.n} L={params.size_q} alpha={params.size_p} "
          f"dnum={pipe.ks.beta}, keys and encryptions in "
          f"{time.time() - t0:.1f} s")

    wrappers = [ntt_kernels.ntt_inverse, ntt_kernels.ntt_forward,
                ntt_kernels.bconv_ntt_forward, bconv_kernels.fold_matmul,
                modup_ip_kernels.modup_ip, ip_kernels.inner_product,
                moddown_kernels.moddown_rows, moddown_kernels.moddown_rescale]
    probes = _probes(pp, wrappers)
    since = {name: 0 for name, *_ in KERNELS}
    # the same relin key through each epilogue
    pipes = {name: pp.CKKSPipeline32(ctx, pipe.evk, **kw).to(dev) if kw
             else pipe for name, kw in EPILOGUES.items()}
    for p in pipes.values():
        p(d1, d2, probes)
    _print_calls(probes, card, since)

    launches = {name: 0 for name, *_ in KERNELS}
    out = _count(wrappers, "headline step", lambda: pipe(d1, d2), launches)
    out_plain = pipe(d1, d2, pp.PLAIN)
    if not torch.equal(out, out_plain):
        raise RuntimeError("step: kernel path differs from plain path")
    print(f"step: kernel path bit-equal to plain path {tuple(out.shape)}")
    for name in ("K8", "K7"):
        got = _count(wrappers, f"headline step, {name} epilogue",
                     lambda: pipes[name](d1, d2), launches)
        if not torch.equal(got, out):
            raise RuntimeError(f"step: the {name} epilogue differs from the "
                               "pair")
    print(f"step: the K8 (R = {EPILOGUES['K8']['moddown_rows']}) and K7 "
          "epilogues bit-equal to the pair")
    dist = check_decrypt(ctx, sk, out, m1, m2, DELTA_BITS)
    print(f"decrypt: equals m1*m2 in all {params.n} coefficients; largest "
          f"distance before rounding {dist:.3e}")

    # 6. timing: chained steps, plain and kernel paths in turns
    q_pad = ctx.key_q[params.size_q - 1:params.size_q].view(1, 1, 1)

    def step_chain(route):
        ops = pp.PLAIN if route == "plain path" else pp.KERNELS

        def run(steps):
            d = d1
            for _ in range(steps):
                d = remix(pipe(d, d2, ops), q_pad)
            return d
        return run

    finals = _chain_timing(("plain path", "kernel path", "kernel path",
                            "plain path"), step_chain, CHAIN_STEPS, card,
                           "headline step")
    if not torch.equal(finals["plain path"], finals["kernel path"]):
        raise RuntimeError("timing: chained outputs differ")

    def epilogue_chain(route):
        def run(steps):
            d = d1
            for _ in range(steps):
                d = remix(pipes[route](d, d2), q_pad)
            return d
        return run

    finals = _chain_timing(("pair", "K8", "K7", "K7", "K8", "pair"),
                           epilogue_chain, CHAIN_STEPS, card,
                           "headline step by epilogue")
    if not all(torch.equal(f, finals["pair"]) for f in finals.values()):
        raise RuntimeError("timing: chained outputs differ by epilogue")
    # K8 alone on the step's operands at each R (the epilogue's R is fixed)
    k8_args = []

    def keep_args(*a):
        k8_args.extend(a)
        return moddown_kernels.moddown_rows(*a)

    pipes["K8"](d1, d2, pp.KERNELS._replace(moddown_rows=keep_args))
    times = {r: _time(lambda: moddown_kernels.moddown_rows(*k8_args[:-1], r),
                      REPS) for r in (1, 2, 4, 8)}
    print("timing K8 per call by rows per block: " + ", ".join(
        f"R={r} {ms:.4f} ms" for r, ms in times.items()) + f" [{card}]")

    # 7. profile: where one chained kernel-path step's device time goes
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    d = d1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            d = remix(pipe(d, d2), q_pad)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / (
        PROFILE_STEPS)
    if busy_ms == 0:
        print(f"profile: device time not measured (no CUDA events) [{card}]")
    else:
        print(f"profile: {busy_ms:.3f} ms device-busy of {wall_ms:.3f} ms "
              f"wall per step, idle share {1 - busy_ms / wall_ms:.3f} "
              f"[{card}]")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            ms = e.self_device_time_total / 1e3 / PROFILE_STEPS
            print(f"profile   {ms:8.4f} ms/step "
                  f"{e.count // PROFILE_STEPS:4d}x  {e.key[:90]}")
    del sk, pipe, pipes, d1, d2, out, out_plain, finals, d, prof
    torch.cuda.empty_cache()

    # 8. alpha = 8 setup
    t0 = time.time()
    params8 = chain_params(**ALPHA8)
    ctx8 = make_context(params8)
    t_ctx = time.time() - t0
    sk8, pipe8, e1, e2, n1, n2 = make_step_inputs(ctx8, SEED, DELTA_BITS,
                                                   dev)
    gal = make_galois(ctx8, sk8, SEED, STEPS, dev)
    ks8 = pipe8.ks
    rng = np.random.default_rng(SEED + 2)
    weights = [rng.integers(-3, 4, params8.n) for _ in range(8)]
    pts = [encode_weights(ctx8, ks8, w) for w in weights]
    torch.cuda.synchronize()
    print(f"alpha-8 setup: N={params8.n} L={params8.size_q} "
          f"alpha={params8.size_p} dnum={ks8.beta}; context (host tables of "
          f"{params8.size_qp} moduli) {t_ctx:.1f} s, keys (relin + "
          f"{len(STEPS)} Galois) and encryptions {time.time() - t0:.1f} s")

    # 9. alpha = 8 kernels under the probes
    rot = lambda ops: pp.rotate32(ks8, gal, e1, 1, ops)
    hoist = lambda ops: pp.hoisting_sum32(ks8, gal, e1, STEPS, ops)
    combo = lambda ops: pp.hoisted_linear_combo32(ks8, gal, e1,
                                                  range(8), pts, ops)
    step8 = lambda ops: pipe8(e1, e2, ops)
    split8 = lambda ops: pp._mult_relin_rescale_split(pipe8, e1, e2, ops)
    pipes8 = {name: pp.CKKSPipeline32(ctx8, pipe8.evk, **kw).to(dev)
              for name, kw in EPILOGUES.items() if kw}
    for fn in (rot, hoist, combo, step8, split8):
        fn(probes)
    for p in pipes8.values():
        p(e1, e2, probes)
    _print_calls(probes, card, since)

    # 10-12. each path: launch counts, kernels = plain, decryption
    m1s = {0: n1, **{s: galois_coeffs(n1, galois.get_elt_from_step(
        s, params8.n)) for s in STEPS}}
    scale = 2.0 ** DELTA_BITS
    checks = [
        ("rotation", rot, m1s[1]),
        ("hoisting_sum32", hoist, sum(m1s[s] for s in STEPS)),
        ("hoisted_linear_combo32", combo,
         sum(negacyclic_product(w, m1s[s]) for s, w in enumerate(weights))),
    ]
    for what, fn, want in checks:
        got = _count(wrappers, what, lambda: fn(pp.KERNELS), launches)
        if not torch.equal(got, fn(pp.PLAIN)):
            raise RuntimeError(f"{what}: kernel path differs from plain")
        dist = check_coeffs(decrypt_coeffs(ctx8, sk8, got, scale), want, what)
        print(f"{what}: kernel path bit-equal to plain path "
              f"{tuple(got.shape)}; decrypts to the expected polynomial in "
              f"all {params8.n} coefficients, largest distance before "
              f"rounding {dist:.3e}")
    out8 = _count(wrappers, "alpha-8 step", lambda: step8(pp.KERNELS),
                  launches)
    if not torch.equal(out8, step8(pp.PLAIN)):
        raise RuntimeError("alpha-8 step: kernel path differs from plain")
    out_split = _count(wrappers, "alpha-8 xla-split step",
                       lambda: split8(pp.KERNELS), launches)
    if not torch.equal(out8, out_split):
        raise RuntimeError("alpha-8 step: K4 route differs from xla-split")
    for name, p in pipes8.items():
        got = _count(wrappers, f"alpha-8 step, {name} epilogue",
                     lambda: p(e1, e2), launches)
        if not torch.equal(got, out8):
            raise RuntimeError(f"alpha-8 step: the {name} epilogue differs "
                               "from the pair")
    dist = check_decrypt(ctx8, sk8, out8, n1, n2, DELTA_BITS)
    print(f"alpha-8 step: K4 route bit-equal to the plain path, to the "
          f"xla-split route (K5/K2/K9) and through the K8 and K7 epilogues "
          f"{tuple(out8.shape)}; decrypts to m1*m2 in all {params8.n} "
          f"coefficients, largest distance {dist:.3e}")

    # 13. alpha = 8 timing
    q8 = ctx8.key_q[params8.size_q - 1:params8.size_q].view(1, 1, 1)

    def step8_chain(route):
        step = (pipe8 if route == "K4 route" else
                lambda a, b: pp._mult_relin_rescale_split(pipe8, a, b))

        def run(steps):
            d = e1
            for _ in range(steps):
                d = remix(step(d, e2), q8)
            return d
        return run

    finals = _chain_timing(("K4 route", "xla-split route", "xla-split route",
                            "K4 route"), step8_chain, CHAIN8_STEPS, card,
                           "alpha-8 step")
    if not torch.equal(finals["K4 route"], finals["xla-split route"]):
        raise RuntimeError("alpha-8 timing: chained outputs differ")

    def rot_chain(_):
        def run(steps):
            d = e1
            for _ in range(steps):
                d = pp.rotate32(ks8, gal, d, 1)
            return d
        return run

    _chain_timing(("kernel path",), rot_chain, CHAIN8_STEPS, card,
                  "rotation (chained)")
    torch.cuda.reset_peak_memory_stats()
    print(f"timing hoisting_sum32 over {len(STEPS)} steps: "
          f"{_time(lambda: hoist(pp.KERNELS), REPS):.3f} ms [{card}]")
    print(f"timing hoisted_linear_combo32 over 8 steps: "
          f"{_time(lambda: combo(pp.KERNELS), REPS):.3f} ms; both hoisted "
          f"forms max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]")

    rows = []
    for (name, attr, src, repl), probe in zip(KERNELS, probes):
        if not probe.calls:
            raise RuntimeError(f"{name}: not probed")
        rows.append(dict(
            name=f"{name} {attr}", route="cuda", source=src, replaces=repl,
            launches=launches[name],
            max_abs_err=max(c["err"] for c in probe.calls),
            ms=round(sum(c["ms"] for c in probe.calls), 5),
            plain_ms=round(sum(c["plain_ms"] for c in probe.calls), 5),
            bound_ms=round(sum(c["bound_ms"] for c in probe.calls), 5),
            bound_by=max(("bytes", "operations"), key=lambda b: sum(
                c["bound_ms"] for c in probe.calls if c["bound_by"] == b)),
            library_ms=None))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""F1's anatomy on the card: what each part of the double-float FFT costs.

Builds the kernel library and, beside it, one probe library per entry of
PROBES, each from a copy of phantom_tpu_torch/csrc/ckks_fft.cu with a few
lines patched.  The probes are wrong by design (no stages, no residues,
one pass alone, ...): only their times are read.  F1's four forms (forward,
inverse, encode over 43 primes, decode) run at N = 2^16 on chip_smoke.py's
seeded inputs, device time, each library in turns (base, probes, probes
reversed, base); the base library is first held bit-equal to the plain
versions.  Needs one CUDA card:

    python3 f1_anatomy.py

A patch that no longer matches the source raises: update it with the
source.  chip_smoke.py is the check; this script only measures.

    python3 f1_anatomy.py --sass-against <an earlier tree's ckks_fft.cu>

instead compiles both sources and compares the SASS of every F1 kernel
function the two hold (names and bodies with the anonymous namespace's
hash taken out), printing how many are the same instruction for
instruction and which are new.
"""
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

import chip_smoke as cs

# the parts: without the stages or their barriers, encode without its
# residue stores or without their reduction, the column pass moving
# contiguous words in place of its strided ones, the forward's first pass
# launched under PDL as the second is, the first pass alone, the second
_STAGES = "  run_stages<Inv>("
_RESIDUES = ("      for (int i = 0; i < a.k; ++i) {\n"
             "        const uint32_t q = qs[i];")
_SECOND = "  return Inv ? launch(ckks_fft_col_kernel<InB, OutB, Inv>"
_FIRST = ("  cudaError_t e =\n"
          "      Inv ? launch(ckks_fft_row_kernel<InA, OutA, Inv>")
PROBES = {
    "no stages": [(_STAGES, "  if (a.count < -1) run_stages<Inv>(")],
    "no stage barriers": [("      bs[3 * ps + iv_s] = v.im.lo;\n    }\n"
                           "    __syncthreads();\n",
                           "      bs[3 * ps + iv_s] = v.im.lo;\n    }\n")],
    "no residues": [(_RESIDUES, _RESIDUES.replace(
        "i < a.k;", "i < a.k * (a.count < 0);"))],
    "residues unreduced": [(
        "        const uint32_t r0 = reduce(u0, q, mu[i]), r1 = reduce(u1, q, "
        "mu[i]);", "        const uint32_t r0 = static_cast<uint32_t>(u0) ^ q, "
        "r1 = static_cast<uint32_t>(u1);")],
    "column pass moving contiguous words": [
        ("          a.x + p * n + c0 + (static_cast<int64_t>(j) << a.lr)));",
         "          a.x + p * n + 2 * (c0 * (c / 2) + j)));"),
        ("      *reinterpret_cast<float2*>(a.y + p * n + c0 +\n"
         "                                 (static_cast<int64_t>(j) << a.lr))"
         " = v;", "      *reinterpret_cast<float2*>(a.y + p * n + 2 * (c0 * "
         "(c / 2) + j)) = v;")],
    "forward's first pass under PDL": [(
        "          : launch(ckks_fft_col_kernel<InA, OutA, Inv>, col_blocks, "
        "cw, false,\n                   false,",
        "          : launch(ckks_fft_col_kernel<InA, OutA, Inv>, col_blocks, "
        "cw, false,\n                   true,")],
    "first pass alone": [(_SECOND, "  if (a.count >= 0) return e;\n"
                          + _SECOND)],
    "second pass alone": [(_FIRST, _FIRST.replace(
        "e =\n", "e = cudaSuccess;\n  if (a.count < 0) e =\n"))]}
F1_ENTRIES = ("ptk_ckks_fft", "ptk_ckks_fft_encode", "ptk_ckks_fft_decode")


def start_probes() -> dict:
    """Start nvcc on each probe's patched source: {name: (library path,
    (command, process))}."""
    from phantom_tpu_torch import _build
    with open(os.path.join(_build.CSRC, "ckks_fft.cu")) as fh:
        src = fh.read()
    d = os.path.join(_build.BUILD_DIR, "f1_probes")
    os.makedirs(d, exist_ok=True)
    out = {}
    for name, patches in PROBES.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"F1 probe {name!r}: no {old!r}")
            text = text.replace(old, new)
        stem = os.path.join(d, name.replace(" ", "_").replace("'", ""))
        with open(stem + ".cu", "w") as fh:
            fh.write(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
               stem + ".so", stem + ".cu"]
        out[name] = (stem + ".so", (cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return out


def _f1_sass(src: str, tmp: str) -> dict:
    """{function: its SASS lines} of every F1 kernel function of one
    ckks_fft.cu, compiled with the library's flags, each function named
    by its mangled name from ckks_fft_row_kernel or ckks_fft_col_kernel
    on (the anonymous namespace's hash before it left out), without the
    instructions' addresses, blanks collapsed (cuobjdump pads a file's
    columns to a width of its own)."""
    from phantom_tpu_torch import _build
    so = os.path.join(tmp, f"f1_{len(os.listdir(tmp))}.so")
    _build._run([([], subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
    out, name = {}, None
    for line in cs._cuobjdump(so, "-sass").splitlines():
        if "Function :" in line:
            m = re.search(r"ckks_fft_(?:row|col)_kernel\w*", line)
            name = m and m.group(0)
            if name:
                out[name] = []
        elif name and line.strip():
            out[name].append(" ".join(
                re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split()))
    return out


def sass_against(other: str) -> int:
    """Compare the SASS of this tree's F1 kernel functions with those that
    `other`, an earlier tree's ckks_fft.cu, compiles to."""
    from phantom_tpu_torch import _build
    with tempfile.TemporaryDirectory() as tmp:
        mine = _f1_sass(os.path.join(_build.CSRC, "ckks_fft.cu"), tmp)
        theirs = _f1_sass(other, tmp)
    both = sorted(set(mine) & set(theirs))
    same = [f for f in both if mine[f] == theirs[f]]
    print(f"F1 SASS against {other}: {len(same)} of {len(both)} functions "
          f"both hold the same instruction for instruction"
          + "".join(f"; differs: {f}" for f in both if f not in same)
          + f"; {len(set(mine) - set(theirs))} new, "
          f"{len(set(theirs) - set(mine))} gone")
    for f in sorted(set(mine) - set(theirs)):
        print(f"F1 SASS new: {f}")
    return 0


class _ProbeLib:
    """The kernel library with F1's entry points taken from a probe."""

    def __init__(self, f1, base):
        self.f1, self.base = f1, base

    def __getattr__(self, name):
        return getattr(self.f1 if name in F1_ENTRIES else self.base, name)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("f1_anatomy: no CUDA device", file=sys.stderr)
        return 1
    from phantom_tpu_torch import _build, make_context
    from phantom_tpu_torch.ops import ckks_fft as cf
    card = cs._cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    print(card)
    if sys.argv[1:2] == ["--sass-against"]:
        return sass_against(sys.argv[2])
    started = start_probes()
    _build.build()
    base = _build.library()
    libs = {}
    for name, (so, job) in started.items():
        _build._run([job])
        lib = ctypes.CDLL(so)
        for fn in F1_ENTRIES:
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = \
                _build._SIGNATURES[fn]
        libs[name] = _ProbeLib(lib, base)
    dev = torch.device("cuda")
    ctx = make_context(cs.chain_params(**cs.HEADLINE))
    t = cf.make_fft_tables(cs.HEADLINE["n"], dev)
    a = cs._f1_inputs(dev, t, ctx)
    calls = {
        "forward": (lambda: cf.ckks_fft(a["fwd"], t),
                    lambda: cf.ckks_fft_plain(a["fwd"], t)),
        "inverse": (lambda: cf.ckks_fft(a["inv"], t, inverse=True),
                    lambda: cf.ckks_fft_plain(a["inv"], t, inverse=True)),
        "encode": (lambda: cf.ckks_fft_encode(a["z"], 2.0 ** 28, a["q"], t),
                   lambda: cf.ckks_fft_encode_plain(a["z"], 2.0 ** 28,
                                                    a["q"], t)),
        "decode": (lambda: cf.ckks_fft_decode(a["limbs"], a["moduli"],
                                              2.0 ** 28, t),
                   lambda: cf.ckks_fft_decode_plain(a["limbs"], a["moduli"],
                                                    2.0 ** 28, t))}
    for what, (fn, plain) in calls.items():
        if cs._max_err(fn(), plain()):
            raise RuntimeError(f"F1 {what} differs from its plain version")
    times = {}
    try:
        for name in ["base", *libs, *reversed(libs), "base"]:
            lib = base if name == "base" else libs[name]
            _build.library = lambda lib=lib: lib
            for what, (fn, _) in calls.items():
                times.setdefault(what, {}).setdefault(name, []).append(
                    cs._device_ms(fn, cs.REPS))
    finally:
        _build.library = lambda: base
    for what, by in times.items():
        b = float(np.mean(by["base"]))
        print(f"F1 anatomy {what}, N = {t.n}: base {b:.5f} ms device; "
              + "; ".join(f"{name} {np.mean(ms):.5f} ({np.mean(ms) - b:+.5f})"
                          for name, ms in by.items() if name != "base")
              + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""P1's anatomy on the card: what each part of the sharded NTT's local
phases costs.

Builds the kernel library and, beside it, one probe library per entry of
PROBES, each from a copy of phantom_tpu_torch/csrc/ntt_phase.cu with a few
lines patched.  The probes are wrong by design (no radix passes, no
butterfly arithmetic, no twiddle loads): only their times are read.  P1
runs each word, phase and direction at N = 2^16, W = 1, on the call shapes
of the sharded steps (130 folded limbs, 43, 2) with seeded inputs, device
time, each library in turns (base, probes, probes reversed, base); the
base library is first held bit-equal to the plain version.  Beside each
call: aten's clone and transpose of the same words (the layout change a
phase makes at W = 1, without its arithmetic) and the bound
(chip_smoke._p1_work).  Needs one CUDA card:

    python3 p1_anatomy.py
    python3 p1_anatomy.py --base    # the library alone, no probes

A copy of this script run with --base inside an earlier tree's git archive
times that tree's P1 the same way.  A patch that no longer matches the
source raises: update it with the source.  chip_smoke.py is the check;
this script only measures.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np

import chip_smoke as cs

# the parts: the radix passes (the inverse keeps its last, which writes
# the output), the butterflies' arithmetic (their twiddles still loaded),
# the twiddle loads (phase B's from device memory, phase A's from the
# block's shared copy; their index in their place)
PROBES = {
    "no passes": [("    for (int p = 0; p < np; ++p) {",
                   "    for (int p = 0; p < 0; ++p) {"),
                  ("    for (int p = np - 1; p > 0; --p) {",
                   "    for (int p = np - 1; p > np; --p) {")],
    "no butterfly arithmetic": [
        ("        gs_lazy(x[k], x[k + half], w[b], ws[b], q, q2);",
         "        x[k] ^= w[b] ^ ws[b];"),
        ("        ct_lazy(x[k], x[k + half], w[b], ws[b], q, q2);",
         "        x[k] ^= w[b] ^ ws[b];")],
    "no twiddle loads": [
        ("        w[(1 << s) - 1 + b] = ldg_w(tw + o);",
         "        w[(1 << s) - 1 + b] = o;"),
        ("        ws[(1 << s) - 1 + b] = ldg_w(tws + o);",
         "        ws[(1 << s) - 1 + b] = o + 1;"),
        ("        w[(1 << s) - 1 + b] = pair.x;",
         "        w[(1 << s) - 1 + b] = idx;"),
        ("        ws[(1 << s) - 1 + b] = pair.y;",
         "        ws[(1 << s) - 1 + b] = idx + 1;")]}
ROWS = 65  # the steps' table rows: 43 data primes and 22 special
LIMBS = {"130 folded": lambda: np.tile(np.arange(ROWS), 2),
         "43": lambda: np.arange(43), "2": lambda: np.arange(2)}
FORMS = (("A", False), ("B", False), ("B", True), ("A", True))


def start_probes() -> dict:
    """Start nvcc on each probe's patched source: {name: (library path,
    (command, process))}."""
    from phantom_tpu_torch import _build
    with open(os.path.join(_build.CSRC, "ntt_phase.cu")) as fh:
        src = fh.read()
    d = os.path.join(_build.BUILD_DIR, "p1_probes")
    os.makedirs(d, exist_ok=True)
    out = {}
    for name, patches in PROBES.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"P1 probe {name!r}: no {old!r}")
            text = text.replace(old, new)
        stem = os.path.join(d, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as fh:
            fh.write(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
               "-shared", "-o", stem + ".so", stem + ".cu"]
        out[name] = (stem + ".so", (cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return out


def _tables(dev):
    """Sharded u32 and u64 tables of ROWS primes at N = 2^16, by word."""
    from phantom_tpu_torch.host import numth
    from phantom_tpu_torch.host.ntt_tables import make_rns_ntt_tables
    from phantom_tpu_torch.ops import ntt as ntt64
    from phantom_tpu_torch.ops import ntt32
    from phantom_tpu_torch.parallel import ntt_sharded as ns
    n = 1 << 16
    t32 = ntt32.NTTTables32(make_rns_ntt_tables(
        n, numth.get_primes(2 * n, 28, ROWS))).to(dev)
    t64 = ntt64.NTTTables64(make_rns_ntt_tables(
        n, numth.get_primes(2 * n, 50, ROWS))).to(dev)
    return {4: ns.prepare_sharded_tables32(t32),
            8: ns.prepare_sharded_tables(t64)}


def _calls(dev):
    """(label, call, plain call, P1's arguments) of every timed call, its
    input seeded in the phase's range."""
    import torch
    from phantom_tpu_torch.parallel import ntt_sharded as ns
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    out = []
    for word, t in _tables(dev).items():
        for limbs, rows_of in LIMBS.items():
            rows = torch.as_tensor(rows_of(), dtype=torch.int32, device=dev)
            q = t.q[rows.long()].long() & ((1 << 8 * word) - 1)
            for phase, inverse in FORMS:
                shape = ns.phase_layout(t, phase, inverse, rows.numel(),
                                        1)[2]
                shp = [1] * len(shape)
                shp[-3 if len(shape) == 3 else 1] = rows.numel()
                span = (1 if (phase == "A" and not inverse)
                        else (2 if inverse else 4))
                x = torch.randint(0, 1 << 62, shape, generator=gen,
                                  device=dev) % (span * q.view(shp))
                if word == 4:
                    x = torch.where(x >= 1 << 31, x - (1 << 32), x).int()
                args = dict(x=x, t=t, rows=rows, phase=phase,
                            inverse=inverse, world=1)
                label = (f"u{8 * word} {phase} "
                         f"{'inverse' if inverse else 'forward'} "
                         f"{tuple(shape)}")
                out.append((label, lambda a=args: ns.ntt_phase(
                    a["x"], a["t"], a["rows"], a["phase"], a["inverse"], 1),
                    lambda a=args: ns.ntt_phase_plain(
                        a["x"], a["t"], a["rows"], a["phase"], a["inverse"],
                        1), args))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("p1_anatomy: no CUDA device", file=sys.stderr)
        return 1
    from phantom_tpu_torch import _build
    card = cs._cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    print(card)
    started = {} if "--base" in sys.argv[1:] else start_probes()
    _build.build()
    base = _build.library()
    libs = {}
    for name, (so, job) in started.items():
        _build._run([job])
        lib = ctypes.CDLL(so)
        lib.ptk_ntt_phase.argtypes, lib.ptk_ntt_phase.restype = \
            _build._SIGNATURES["ptk_ntt_phase"]
        libs[name] = lib
    dev = torch.device("cuda")
    calls = _calls(dev)
    for label, fn, plain, _ in calls:
        if not torch.equal(fn(), plain()):
            raise RuntimeError(f"P1 {label} differs from its plain version")
    times = {}
    try:
        for name in ["base", *libs, *reversed(libs), "base"]:
            lib = base if name == "base" else libs[name]
            _build.library = lambda lib=lib: lib
            for label, fn, _, _ in calls:
                times.setdefault(label, {}).setdefault(name, []).append(
                    cs._device_ms(fn, cs.REPS))
    finally:
        _build.library = lambda: base
    for label, fn, _, args in calls:
        by = times[label]
        b = float(np.mean(by["base"]))
        xs = args["x"].reshape(-1, *args["x"].shape[-2:])
        clone = cs._device_ms(xs.clone, cs.REPS)
        tr = cs._device_ms(lambda: xs.transpose(1, 2).contiguous(), cs.REPS)
        bound, by_what = cs.bound_ms(*cs._p1_work(args, fn()))
        print(f"P1 anatomy {label}: base {b:.4f} ms device"
              + "".join(f"; {name} {np.mean(ms):.4f} ({np.mean(ms) - b:+.4f})"
                        for name, ms in by.items() if name != "base")
              + f"; aten clone {clone:.4f}, transpose {tr:.4f}; bound "
              f"{bound:.4f} by {by_what}: {b / bound:.2f}x [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

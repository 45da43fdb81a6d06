"""Build the CUDA kernels in `csrc/`, bind them with ctypes, launch them.

All `csrc/*.cu` files compile with nvcc into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes), for `sm_90a`: one nvcc per source, all started together, then
one link, so a first build takes as long as its slowest source however
many kernels are added (chip_smoke.py builds from scratch inside a fixed
time limit).  The library goes to `build/phantom_tpu_torch/`
beside the package, named by a hash of the sources and flags, at the
first kernel launch; a failed build raises with nvcc's stderr.  Every C
entry point returns `cudaGetLastError()`, which `check` turns into an
exception.  Pointers and the stream pass as `c_void_p` (a bare int would
be cut to 32 bits).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "phantom_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# bytes of shared memory one block can opt into on sm_90 (above 48 KB only
# as dynamic shared memory, after cudaFuncSetAttribute)
SMEM_OPTIN = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptk_error_string": ([_I], ctypes.c_char_p),
    "ptk_ntt_forward": ([_P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _P, _P, _P, _P, _P, _I, _P], _I),
    "ptk_ntt_inverse": ([_P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P, _I, _P], _I),
    "ptk_bconv_ntt_forward": ([_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                               _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                               _I, _I, _P], _I),
    "ptk_fold_matmul_smem": ([_I, _I], _I),
    "ptk_fold_matmul": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "ptk_modup_ip": ([_P] * 6 + [_I] * 4 + [_P] * 4 + [_I] * 3 + [_P], _I),
    "ptk_inner_product": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "ptk_moddown_rows": ([_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                          _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "ptk_moddown_rescale": ([_P] * 14 + [_I, _I, _I] + [_P] * 8
                            + [_I, _I, _I, _P], _I),
    "ptk_ntt_roll": ([_P] * 6 + [_I] * 4 + [_P] * 5 + [_I, _P], _I),
}

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libptk_{h.hexdigest()[:16]}.so")


def _run(procs) -> None:
    """Wait for every (command, process); raise on the first that
    failed."""
    errs = [(cmd, p.communicate()[1], p.returncode) for cmd, p in procs]
    for cmd, err, rc in errs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{err}")


def build() -> str:
    """Compile the library unless a build of these sources exists; returns
    its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(obj)
        _run(procs)
        so = os.path.join(tmp, "lib.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-shared", "-o", so, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(so, path)
    return path


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().ptk_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def is_plain(x: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the wrapper takes its plain version), False
    for a CUDA tensor (it launches its kernel); other devices raise."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return False


def stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on x's device, for a launch."""
    return torch.cuda.current_stream(x.device).cuda_stream


def check_operands(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous int32 "
                             f"tensors on {dev}")


def check_aligned(*tensors) -> None:
    """The kernels read and write these (None skipped) with 16-byte
    vectors."""
    for x in tensors:
        if x is not None and x.data_ptr() % 16:
            raise ValueError("kernel operand not 16-byte aligned")

"""The PyTorch port imports without JAX and loads no file of the JAX
package, its build functions go to the CUDA device unless told "cpu", and
its kernel wrappers refuse devices they have no kernel for."""

import os
import subprocess
import sys

import pytest
import torch

from phantom_tpu_torch import make_context

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
from phantom_tpu_torch.ops import (bconv_kernels, ip_kernels, moddown_kernels,
                                   modup_ip_kernels, ntt_kernels)

_NO_JAX = """
import os, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import chip_smoke
import phantom_tpu_torch as pt
from phantom_tpu_torch import convert, host
from phantom_tpu_torch.schemes import keys
n = 128
params = pt.EncryptionParameters.create(
    n, host.numth.get_primes(2 * n, 28, 5), host.numth.get_primes(2 * n, 29, 2))
ctx = pt.make_context(params, device="cpu")
assert ctx.ntt.root_powers.shape == (7, n), ctx.ntt.root_powers.shape
assert len(ctx.chain) == 3
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m in sys.modules if sys.modules[m] is not None)
ref = os.path.join(os.path.abspath("."), "phantom_tpu") + os.sep
loaded = [m for m, mod in list(sys.modules.items())
          if os.path.abspath(getattr(mod, "__file__", None) or "").startswith(
              ref)]
assert not loaded, loaded
print("ok")
"""


def test_import_without_jax():
    """phantom_tpu_torch and chip_smoke import, and a context builds, with
    JAX blocked; no module in sys.modules has a file under phantom_tpu/."""
    r = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_entry_points_need_cuda_or_cpu(monkeypatch):
    """Without a CUDA device the entry points raise unless given "cpu"."""
    from phantom_tpu_torch.host import numth
    from phantom_tpu_torch.ops import pipeline32 as pp
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 128
    params = EncryptionParameters.create(n, numth.get_primes(2 * n, 28, 2),
                                         numth.get_primes(2 * n, 29, 1))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        make_context(params)
    ctx = make_context(params, device="cpu")
    assert ctx.key_q.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pp.build_keyswitch32(ctx)
    assert pp.build_keyswitch32(ctx, device="cpu").rows_ql.device.type == \
        "cpu"


@pytest.fixture(scope="module")
def meta_args():
    from phantom_tpu_torch.host import numth
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    n = 1024
    ctx = make_context(EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, 2), numth.get_primes(2 * n, 29, 1)),
        device="cpu")
    x = torch.empty((3, n), dtype=torch.int32, device="meta")
    return ctx.ntt, x


@pytest.mark.parametrize("kernel", ["ntt_forward", "ntt_inverse",
                                    "bconv_ntt_forward", "fold_matmul",
                                    "modup_ip", "inner_product",
                                    "moddown_rows", "moddown_rescale"])
def test_meta_tensor_raises(meta_args, kernel):
    t, x = meta_args

    def m(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    md = (m(2, 1, 1024), m(1, 1), m(2, 1024), m(1), m(2, 1, 1024),
          (m(2, 1, 1024), m(2, 1, 1024)), t, None, m(1), m(1))
    calls = {
        "ntt_forward": lambda: ntt_kernels.ntt_forward(x, t),
        "ntt_inverse": lambda: ntt_kernels.ntt_inverse(x, t),
        "bconv_ntt_forward": lambda: ntt_kernels.bconv_ntt_forward(
            x.view(1, 3, -1), torch.empty((1, 3, 3), dtype=torch.int32,
                                          device="meta"), t),
        "fold_matmul": lambda: bconv_kernels.fold_matmul(
            x, torch.empty((2, 3), dtype=torch.int32, device="meta"),
            torch.empty((2,), dtype=torch.int32, device="meta")),
        "modup_ip": lambda: modup_ip_kernels.modup_ip(
            x[:2], torch.empty((1, 3, 2), dtype=torch.int32, device="meta"),
            x[:2], torch.empty((1, 2, 3, 1024), dtype=torch.int32,
                               device="meta"), t),
        "inner_product": lambda: ip_kernels.inner_product(
            m(1, 1, 1024), m(1, 2, 1, 1024), m(1)),
        "moddown_rows": lambda: moddown_kernels.moddown_rows(*md),
        "moddown_rescale": lambda: moddown_kernels.moddown_rescale(
            *md, 1, m(0), m(0), m(0)),
    }
    with pytest.raises(ValueError, match="no kernel for device meta"):
        calls[kernel]()

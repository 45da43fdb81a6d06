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
                                   modup_ip_kernels, ntt_kernels,
                                   ntt_roll_kernels)

_NO_JAX = """
import os, sys
import torch
sys.modules["jax"] = None
sys.modules["flax"] = None
import chip_smoke
import phantom_tpu_torch as pt
from phantom_tpu_torch import convert, host
from phantom_tpu_torch.ops import (bfv32, bgv32, modup_ip_kernels,
                                   ntt_roll_kernels, scaleround32)
from phantom_tpu_torch.schemes import keys
n = 128
params = pt.EncryptionParameters.create(
    n, host.numth.get_primes(2 * n, 28, 5), host.numth.get_primes(2 * n, 29, 2))
ctx = pt.make_context(params, device="cpu")
assert ctx.ntt.root_powers.shape == (7, n), ctx.ntt.root_powers.shape
assert len(ctx.chain) == 6 and ctx.first_data_index == 1
bfv = pt.make_context(pt.EncryptionParameters.create(
    n, params.data_moduli, params.special_moduli, "bfv",
    host.modulus.PlainModulus.batching(n, 16)), device="cpu")
assert bfv.ntt.root_powers.shape == (7 + 6, n), bfv.ntt.root_powers.shape
assert bfv.get_context_data(1).bfv.rows_d == (0, 1, 2, 3, 4) + tuple(
    range(7, 13))
bgv = pt.make_context(pt.EncryptionParameters.create(
    n, params.data_moduli, params.special_moduli, "bgv",
    host.modulus.PlainModulus.batching(n, 16)), device="cpu")
assert bgv.get_context_data(2).bgv.qlast_mod_qi is not None
assert pt.build_keyswitch32(bgv, device="cpu").bgv
from phantom_tpu_torch.ops import behz32
from phantom_tpu_torch.host import globals_, hestd, noise
behz = pt.make_context(pt.EncryptionParameters.create(
    n, params.data_moduli, params.special_moduli, "bfv",
    host.modulus.PlainModulus.batching(n, 16), mul_tech="behz"),
    device="cpu")
assert len(behz.bsk_moduli) == 6
assert behz.get_context_data(1).behz.rows_bsk == tuple(range(13, 18)) + (18,)
assert bfv32.build_bfv_leveled32(behz, torch.zeros(
    (3, 2, 7, n), dtype=torch.int32), device="cpu").lvl == 0
assert len(globals_.default_coeff_modulus_128(4096)) == 3
assert hestd.max_coeff_modulus_bits(n, 0) and noise.SIGMA == 3.2
from phantom_tpu_torch import fast32
from phantom_tpu_torch.schemes import batch_encoder, ciphertext, ckks_encoder
import numpy as np
gen = torch.Generator()
ev = pt.Fast32(ctx)
sk = ev.gen_secret_key(gen)
enc = pt.CKKSEncoder(ctx)
c = ev.encrypt_asymmetric(ev.gen_public_key(sk, gen), enc.encode(
    np.full(enc.slots, 0.5), 2.0 ** 20), gen)
assert np.abs(enc.decode(ev.decrypt(sk, c)) - 0.5).max() < 1e-3
assert pt.BatchEncoder(bgv).decode(pt.BatchEncoder(bgv).encode([5])).tolist(
    )[:2] == [5, 0]
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


def test_bfv_entry_points_need_cuda_or_cpu(monkeypatch):
    """The BFV context and build_bfv32 go to the CUDA device by default and
    raise without one unless given "cpu"."""
    from phantom_tpu_torch import build_bfv32
    from phantom_tpu_torch.host import numth
    from phantom_tpu_torch.host.modulus import PlainModulus
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 128
    params = EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, 2), numth.get_primes(2 * n, 29, 1),
        "bfv", PlainModulus.batching(n, 16))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        make_context(params)
    ctx = make_context(params, device="cpu")
    rlk = torch.zeros((2, 2, 3, n), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bfv32(ctx, rlk)
    p = build_bfv32(ctx, rlk, device="cpu")
    assert p.rows_d.device.type == "cpu" and p.ks.engine == "mxu-pallas"


def test_bgv_entry_points_need_cuda_or_cpu(monkeypatch):
    """build_bgv32 goes to the CUDA device by default and raises without
    one unless given "cpu"."""
    from phantom_tpu_torch import build_bgv32
    from phantom_tpu_torch.host import numth
    from phantom_tpu_torch.host.modulus import PlainModulus
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 128
    params = EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, 2), numth.get_primes(2 * n, 29, 1),
        "bgv", PlainModulus.batching(n, 16))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        make_context(params)
    ctx = make_context(params, device="cpu")
    rlk = torch.zeros((2, 2, 3, n), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bgv32(ctx, rlk)
    p = build_bgv32(ctx, rlk, device="cpu")
    assert p.ks.bgv and p.ks.modup == "kernel"


def test_fast32_entry_points_need_cuda_or_cpu(monkeypatch):
    """Fast32, the encoders and encrypt_asymmetric run on the context's
    device: without a CUDA device a context builds only with device="cpu",
    where they run; on a device without kernels (meta) they raise rather
    than fall back to the CPU."""
    from phantom_tpu_torch import BatchEncoder, CKKSEncoder, Fast32
    from phantom_tpu_torch.host import numth
    from phantom_tpu_torch.host.modulus import PlainModulus
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.schemes.ciphertext import Ciphertext
    from phantom_tpu_torch.schemes.params import EncryptionParameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 1024
    qs, ps = numth.get_primes(2 * n, 28, 3), numth.get_primes(2 * n, 29, 1)
    params = EncryptionParameters.create(n, qs, ps, "bgv",
                                         PlainModulus.batching(n, 16))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        make_context(params)
    ctx = make_context(params, device="cpu")
    gen = torch.Generator()
    ev = Fast32(ctx)
    sk = ev.gen_secret_key(gen)
    pk = ev.gen_public_key(sk, gen)
    pt = BatchEncoder(ctx).encode([1, 2, 3])
    for c in (ev.encrypt_asymmetric(pk, pt, gen),
              keys.encrypt_asymmetric(ctx, pk, pt, gen)):
        assert c.data.device.type == "cpu" and c.chain_index == 1
    meta = make_context(params, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        BatchEncoder(meta).encode([1, 2, 3])
    ckks = make_context(EncryptionParameters.create(n, qs, ps),
                        device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        CKKSEncoder(ckks).encode([0.5], 2.0 ** 20)
    ev = Fast32(meta, rlk=torch.empty((3, 2, 4, n), dtype=torch.int32,
                                      device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        keys.encrypt_asymmetric_core(
            meta, ev.keyswitch_at(1), torch.empty(
                (2, 4, n), dtype=torch.int32, device="meta"),
            pt.replace(data=pt.data.to("meta")),
            torch.zeros(n, dtype=torch.int64, device="meta"),
            torch.zeros((2, n), dtype=torch.int64, device="meta"))
    ct = Ciphertext(torch.empty((2, 3, n), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ev.multiply_and_relin(ct, ct)


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
                                    "moddown_rows", "moddown_rescale",
                                    "modup_ip_coeff", "ntt_forward_roll",
                                    "ntt_inverse_roll", "modup_ip_preconv"])
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
        "modup_ip_coeff": lambda: modup_ip_kernels.modup_ip_coeff(
            x[:2], m(1, 3, 2), m(1, 2, 3, 1024), t),
        "ntt_forward_roll": lambda: ntt_roll_kernels.ntt_forward_roll(x, t),
        "ntt_inverse_roll": lambda: ntt_roll_kernels.ntt_inverse_roll(x, t),
        "modup_ip_preconv": lambda: modup_ip_kernels.modup_ip_preconv(
            m(1, 3, 1024), x[:2], m(1, 2, 3, 1024), t, alpha=2),
    }
    with pytest.raises(ValueError, match="no kernel for device meta"):
        calls[kernel]()


@pytest.mark.parametrize("n,cluster", [(1024, 3), (1024, 2), (1 << 16, 1),
                                       (1 << 16, 16)],
                         ids=["not-a-power-of-two", "share-below-1024",
                              "share-past-shared-memory", "past-8"])
@pytest.mark.parametrize("kernel", ["ntt_forward", "moddown_rows",
                                    "moddown_rescale", "ntt_forward_roll",
                                    "ntt_inverse_roll"])
def test_cluster_refused(meta_args, monkeypatch, kernel, n, cluster):
    """K2, K6 (both directions), K7 and K8 on the card path (meta tensors:
    no data, no launch) refuse a cluster size that is not a power of two up
    to 8 whose share of N is at least 1024 words and fits a block's shared
    memory."""
    from phantom_tpu_torch import _build
    t, _ = meta_args
    monkeypatch.setattr(_build, "is_plain", lambda x, name: False)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))

    def m(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    with pytest.raises(ValueError, match=f"cluster={cluster} at N={n}"):
        if kernel == "ntt_forward":
            ntt_kernels.ntt_forward(m(3, n), t, cluster=cluster)
        elif kernel == "moddown_rows":
            moddown_kernels.moddown_rows(
                m(2, 2, n), m(3, 2), m(2, n), m(3), m(2, 3, n), None, t,
                None, m(3), m(3), 8, cluster)
        elif kernel == "moddown_rescale":
            moddown_kernels.moddown_rescale(
                m(2, 2, n), m(3, 2), m(2, n), m(3), m(2, 3, n),
                (m(2, 3, n), m(2, 3, n)), t, None, m(3), m(3), 1, m(2),
                m(2), m(2), cluster=cluster)
        else:
            getattr(ntt_roll_kernels, kernel)(m(3, n), t, cluster=cluster)


@pytest.mark.parametrize("logn", range(10, 18))
def test_k8_held_rows(logn):
    """K8's rows held per block: at least one, their shares and MAX_ROWS
    rows' constants within a block's shared memory, all R where they fit,
    and as few rounds as fit; a cluster size the core refuses raises."""
    from phantom_tpu_torch import _build
    n = 1 << logn
    for c in range(1, 9):
        share = ntt_kernels.share_bytes(n // c)
        try:
            ntt_kernels.check_cluster(n, c)
        except ValueError:
            with pytest.raises(ValueError):
                moddown_kernels.held_rows(8, n, c)
            continue
        room = _build.SMEM_OPTIN - moddown_kernels.MAX_ROWS * \
            moddown_kernels.ROW_CONST_BYTES
        for r in range(1, moddown_kernels.MAX_ROWS + 1):
            held = moddown_kernels.held_rows(r, n, c)
            assert 1 <= held <= r and held * share <= room
            fit = room // share
            if r <= fit:
                assert held == r
            assert -(-r // held) == -(-r // min(r, fit))
    if logn == 16:
        assert moddown_kernels.held_rows(8, n, 8) == 4
        assert moddown_kernels.held_rows(6, n, 8) == 6
        assert moddown_kernels.held_rows(8, n, 2) == 1

"""The port's bench setup and its disk cache (phantom_tpu_torch/utils/
benchsetup.py, benchcache.py) on the CPU against the JAX package's
setup_bench: the golden file benchsetup_n1024.npz holds, for CKKS (50-bit
primes), BGV and BFV (HPS, 28-bit primes) at n = 1024, the JAX package's
cache entry (keys, plaintext, two encryptions, metadata), the encoded
values and the primes."""

import json
import os

import numpy as np
import pytest
import torch

from phantom_tpu_torch.schemes import keys
from phantom_tpu_torch.utils import (benchcache, cache_path, ensure_galois,
                                     load_setup, save_setup, setup_bench)
from phantom_tpu_torch.utils.benchsetup import _rebuild

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "torch_port", "benchsetup_n1024.npz")
N, SEED = 1024, 7  # the generator's
CASES = {"ckks": dict(limbs=2, alpha=2, bits=50),
         "bgv": dict(limbs=2, alpha=2, bits=28),
         "bfv": dict(limbs=2, alpha=2, bits=28, multech="hps")}
ENTRY = ("sk", "pk", "rlk", "pt", "ct1", "ct2")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv(benchcache.ENV, str(tmp_path))
    return tmp_path


def _values_of(s, ct):
    """The decrypted, decoded slots of ct under the setup's secret key."""
    return s.enc.decode(keys.decrypt64(s.ctx, s.sk, ct))


def _check_values(scheme, got, want):
    if scheme == "ckks":
        assert np.max(np.abs(got - want)) < 1e-2
    else:
        np.testing.assert_array_equal(got, want)


def _meta(obj) -> dict:
    return {k: v for k, v in vars(obj).items() if k != "data"}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64).view(np.uint64)


@pytest.mark.parametrize("scheme", CASES)
def test_setup_against_jax(cache, golden, scheme):
    """Params and pt bit-equal to the JAX package's; the fresh setup
    decrypts to `values`; loaded back it is bit-equal to the fresh one;
    the JAX package's own cache entry, through _rebuild, decrypts to the
    same values with its own secret key."""
    kw = CASES[scheme]
    s = setup_bench(scheme, n=N, seed=SEED, verbose=False, device="cpu",
                    **kw)
    assert not s.cached and set(s.times) == {"context", "keys", "encrypt",
                                          "save"}
    g = {k[len(scheme) + 1:]: golden[k] for k in golden.files
         if k.startswith(scheme + "_")}
    assert s.params.data_moduli == tuple(g["data"].tolist())
    assert s.params.special_moduli == tuple(g["special"].tolist())
    assert s.params.plain_modulus == int(g["t"])
    np.testing.assert_array_equal(s.values, g["values"])
    np.testing.assert_array_equal(_bits(s.pt.data), g["pt"])
    for ct in (s.ct1, s.ct2):
        _check_values(scheme, _values_of(s, ct), s.values)
    assert os.path.exists(s.path)
    t = setup_bench(scheme, n=N, seed=SEED, verbose=False, device="cpu",
                    **kw)
    assert t.cached and set(t.times) == {"context", "load"}
    for name in ("sk", "pk", "rlk"):
        assert torch.equal(getattr(t, name), getattr(s, name))
    for name in ("pt", "ct1", "ct2"):
        a, b = getattr(t, name), getattr(s, name)
        assert torch.equal(a.data, b.data) and a.data.dtype == b.data.dtype
        assert _meta(a) == _meta(b)
    meta = json.loads(str(g["meta"]))
    jax = _rebuild(s.ctx, {k: g[k] for k in ENTRY}, meta, "cpu")
    assert jax["ct1"].chain_index == meta["ct1"]["chain_index"]
    np.testing.assert_array_equal(_bits(jax["pt"].data), g["pt"])
    for ct in (jax["ct1"], jax["ct2"]):
        _check_values(scheme, s.enc.decode(keys.decrypt64(
            s.ctx, jax["sk"], ct)), s.values)


def test_cache_semantics(cache, capsys):
    """A missing blob is a miss, a truncated one too (the reason on stderr
    with verbose) and is rewritten by the next setup; the key carries the
    port's name, so the JAX package's key names no port blob; "0"
    disables the cache; ensure_galois writes an entry of its own."""
    from phantom_tpu.utils import benchcache as jax_cache
    cfg = dict(scheme="ckks", n=N, limbs=2, alpha=2, bits=50)
    assert load_setup(**cfg) is None
    save_setup({"x": np.arange(3)}, {"m": 1}, **cfg)
    arrays, meta = load_setup(**cfg)
    assert arrays["x"].tolist() == [0, 1, 2] and meta == {"m": 1}
    assert [f.name for f in cache.iterdir()] == [
        os.path.basename(cache_path(**cfg))]
    assert os.path.basename(jax_cache.cache_path(**cfg)) != \
        os.path.basename(cache_path(**cfg))
    s = setup_bench("ckks", n=N, seed=SEED, verbose=False, device="cpu",
                    **CASES["ckks"])
    with open(s.path, "r+b") as fh:
        fh.truncate(100)
    t = setup_bench("ckks", n=N, seed=SEED, verbose=True, device="cpu",
                    **CASES["ckks"])
    assert not t.cached and "unreadable" in capsys.readouterr().err
    assert torch.equal(t.ct1.data, s.ct1.data)
    assert setup_bench("ckks", n=N, seed=SEED, verbose=False, device="cpu",
                       **CASES["ckks"]).cached
    before = set(os.listdir(cache))
    glk = ensure_galois(t, "ckks", N, 2, 2, 50, steps=(1,), seed=SEED,
                        verbose=False)
    assert t.glk is glk and glk.data.shape[:2] == (1, 1)
    assert len(set(os.listdir(cache)) - before) == 1
    t.glk = None
    again = ensure_galois(t, "ckks", N, 2, 2, 50, steps=(1,), seed=SEED,
                          verbose=False)
    assert torch.equal(again.data, glk.data) and again.elts == glk.elts
    os.environ[benchcache.ENV] = "0"
    assert not setup_bench("ckks", n=N, seed=SEED, verbose=False,
                           device="cpu", **CASES["ckks"]).cached


def test_cache_default_follows_tmpdir(tmp_path, monkeypatch):
    """With PHANTOM_TORCH_SETUP_CACHE unset the cache lives under the
    process's own temporary directory, so two checkouts run with their
    own TMPDIR never share blobs."""
    import tempfile
    monkeypatch.delenv(benchcache.ENV, raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg = dict(scheme="ckks", n=N, limbs=2, alpha=2, bits=50)
    want = tmp_path / benchcache.DIR_NAME
    assert os.path.dirname(cache_path(**cfg)) == str(want)
    save_setup({"x": np.arange(2)}, **cfg)
    assert [f.name for f in want.iterdir()] == [
        os.path.basename(cache_path(**cfg))]
    assert load_setup(**cfg)[0]["x"].tolist() == [0, 1]

"""The port's plain NTTs against the JAX package's: ops/ntt32.py (the JAX
side's jitted outputs in the golden file ntt32_n128.npz), and the K1 / K2
kernels (ntt_inverse_mxu_pallas / ntt_forward_mxu_pallas) run in Pallas
interpret mode, for every option the port's wrappers take.  n = 128, L <=
4, inputs from numpy; bit-exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_tpu.host import numth
from phantom_tpu.host.modulus import Modulus
from phantom_tpu.host.ntt_tables import make_rns_ntt_tables
from phantom_tpu.ops import ntt as ntt64
from phantom_tpu.ops import ntt32 as jntt32
from phantom_tpu.ops import ntt_mxu
from phantom_tpu.ops import ntt_mxu_pallas as nmp
from phantom_tpu.ops.modmath32 import compute_shoup32
from phantom_tpu_torch import host as thost
from phantom_tpu_torch.ops import ntt32 as tntt32
from phantom_tpu_torch.ops import ntt_kernels as nk

N = 128
RNG = np.random.default_rng(31)


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def tabs():
    qs = numth.get_primes(2 * N, 28, 3) + numth.get_primes(2 * N, 29, 1)
    host = make_rns_ntt_tables(N, [Modulus(q) for q in qs])
    j32 = jntt32.tables32_from_tables64(ntt64.tables_from_host(host))
    jmxu = ntt_mxu.prepare_mxu_tables(j32, fused_kernel=True)
    q = np.array(qs, dtype=np.uint32)[:, None]
    return j32, jmxu, tntt32.NTTTables32(thost.make_rns_ntt_tables(N, qs)), q


def _res(q, shape, lazy=False):
    hi = 2 * q.astype(np.int64) if lazy else q.astype(np.int64)
    return (RNG.integers(0, 1 << 40, shape) % hi).astype(np.uint32)


def _scale(q):
    sc = np.array([RNG.integers(1, v) for v in q[:, 0]], dtype=np.uint32)
    scs = np.array([compute_shoup32(int(s), int(v))
                    for s, v in zip(sc, q[:, 0])], dtype=np.uint32)
    return sc, scs


def test_tables_match(tabs):
    """The port's own host tables against the JAX package's."""
    j32, _, tt, _ = tabs
    for name in ("q", "root_powers", "root_powers_shoup", "inv_root_powers",
                 "inv_root_powers_shoup", "inv_degree", "inv_degree_shoup"):
        np.testing.assert_array_equal(u32(getattr(tt, name)),
                                      np.asarray(getattr(j32, name)), name)


@pytest.mark.parametrize("n,bits,count", [(1 << 16, 28, 44),
                                          (1 << 16, 29, 22), (1 << 12, 30, 3)])
def test_host_copy_matches(n, bits, count):
    """The port's prime search and, at full width, NTT tables of a few of
    the primes, against the JAX package's host code."""
    qs = numth.get_primes(2 * n, bits, count)
    assert thost.numth.get_primes(2 * n, bits, count) == qs
    ref = make_rns_ntt_tables(n, [Modulus(q) for q in qs[:2]])
    got = thost.make_rns_ntt_tables(n, qs[:2])
    for name in ("root_powers", "root_powers_shoup", "inv_root_powers",
                 "inv_root_powers_shoup", "inv_degree", "inv_degree_shoup"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)), name)


@pytest.mark.parametrize("lazy", [False, True])
def test_plain_vs_ntt32(tabs, lazy):
    """ntt32's forward takes [0, q) and its inverse [0, 2q): the port
    against the JAX functions' outputs on the same inputs (golden)."""
    _, _, tt, q = tabs
    g = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "torch_port", "ntt32_n128.npz"))
    assert g["moduli"].tolist() == q[:, 0].tolist()
    x, xi = g[f"x_{int(lazy)}"], g[f"xi_{int(lazy)}"]
    assert (xi < (1 + lazy) * q.astype(np.int64)[None]).all()
    np.testing.assert_array_equal(u32(tntt32.ntt_forward32(t32(x), tt)),
                                  g[f"fwd_{int(lazy)}"])
    np.testing.assert_array_equal(u32(tntt32.ntt_inverse32(t32(xi), tt)),
                                  g[f"inv_{int(lazy)}"])


@pytest.mark.parametrize("option", ["lazy", "epilogue", "tensor_add"])
def test_forward_vs_k2(tabs, option):
    _, jm, tt, q = tabs
    x = _res(q, (2, 4, N), lazy=option == "lazy")
    kw = {}
    if option in ("epilogue", "tensor_add"):
        sc, scs = _scale(q)
        kw = dict(sub_from=_res(q, (2, 4, N)), epi_scale=sc,
                  epi_scale_shoup=scs)
    if option == "tensor_add":
        kw["tensor_add"] = (_res(q, (2, 4, N)), _res(q, (2, 4, N)))
    ref = np.asarray(nmp.ntt_forward_mxu_pallas(
        jnp.asarray(x), jm, interpret=True,
        **{k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
               else jnp.asarray(v)) for k, v in kw.items()}))
    got = nk.ntt_forward(t32(x), tt, **{
        k: (tuple(t32(a) for a in v) if isinstance(v, tuple) else t32(v))
        for k, v in kw.items()})
    np.testing.assert_array_equal(u32(got), ref)


def test_forward_repeated_rows(tabs):
    """K2 with `rows` picking repeated moduli (modup's complement rows)
    against K2 on gathered tables."""
    _, jm, tt, q = tabs
    rows = [3, 0, 3, 1, 0]
    x = _res(q[rows], (len(rows), N))
    ref = np.asarray(nmp.ntt_forward_mxu_pallas(
        jnp.asarray(x), jm.limb_slice(rows), interpret=True))
    got = nk.ntt_forward(t32(x), tt, torch.tensor(rows, dtype=torch.int32))
    np.testing.assert_array_equal(u32(got), ref)


@pytest.mark.parametrize("option", ["lazy", "scale", "mul_by",
                                    "emit_floor_div"])
def test_inverse_vs_k1(tabs, option):
    _, jm, tt, q = tabs
    x = _res(q, (2, 4, N), lazy=option in ("lazy", "mul_by"))
    jkw, tkw = {}, {}
    if option in ("scale", "emit_floor_div"):
        sc, scs = _scale(q)
        jkw.update(scale=sc, scale_shoup=scs)
        tkw.update(scale=t32(sc), scale_shoup=t32(scs))
    if option == "mul_by":
        m = _res(q, (2, 4, N), lazy=True)
        jkw["mul_by"] = jnp.asarray(m)
        tkw["mul_by"] = t32(m)
    if option == "emit_floor_div":
        u = np.array([(1 << 32) // int(v) for v in q[:, 0]], dtype=np.uint32)
        v = np.array([(1 << 32) % int(v) for v in q[:, 0]], dtype=np.uint32)
        jkw["emit_floor_div"] = (u, v)
        tkw["emit_floor_div"] = (t32(u), t32(v))
    ref = nmp.ntt_inverse_mxu_pallas(jnp.asarray(x), jm, interpret=True,
                                     **jkw)
    got = nk.ntt_inverse(t32(x), tt, **tkw)
    if option == "emit_floor_div":
        np.testing.assert_array_equal(u32(got[1]), np.asarray(ref[1]))
        got, ref = got[0], ref[0]
    np.testing.assert_array_equal(u32(got), np.asarray(ref))

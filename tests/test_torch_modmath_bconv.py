"""The port's ops/modmath32.py and ops/bconv32.py against the JAX package's,
on the same numpy inputs; bit-exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phantom_tpu.host import numth
from phantom_tpu.host.rns import BaseConverter, RNSBase
from phantom_tpu.ops import bconv32 as jbc
from phantom_tpu.ops import modmath32 as jm
from phantom_tpu_torch import host as thost
from phantom_tpu_torch.ops import bconv32 as tbc
from phantom_tpu_torch.ops import modmath32 as tm

RNG = np.random.default_rng(23)
N = 256


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def u32(t):
    return (t.long() & 0xFFFFFFFF).numpy().astype(np.uint32)


@pytest.fixture(scope="module")
def mod():
    qs = numth.get_primes(2 * 1024, 28, 3) + numth.get_primes(2 * 1024, 29, 1)
    q = np.array(qs, dtype=np.uint32)[:, None]
    a = (RNG.integers(0, 1 << 40, (4, N)) % q).astype(np.uint32)
    b = (RNG.integers(0, 1 << 40, (4, N)) % q).astype(np.uint32)
    a[:, :2] = 0
    a[:, 2:4] = q - 1
    b[:, 3] = q[:, 0] - 1
    return q, a, b


def test_add_sub_neg_csub(mod):
    q, a, b = mod
    qt = torch.from_numpy(q.astype(np.int64))
    for jf, tf in ((jm.add_mod32, tm.add_mod32), (jm.sub_mod32, tm.sub_mod32)):
        np.testing.assert_array_equal(u32(tf(t32(a), t32(b).long(), qt)),
                                      np.asarray(jf(a, b, q)))
    np.testing.assert_array_equal(u32(tm.neg_mod32(t32(a), qt)),
                                  np.asarray(jm.neg_mod32(jnp.asarray(a), q)))
    lazy = (a.astype(np.uint64) + q).astype(np.uint32)
    np.testing.assert_array_equal(u32(tm.csub32(t32(lazy).long(), qt)),
                                  np.asarray(jm.csub32(lazy, q)))


def test_mul_mod_barrett(mod):
    q, a, b = mod
    qt = torch.from_numpy(q.astype(np.int64))
    rh, rl = (np.array([[jm.ratio32(int(v))[i]] for v in q[:, 0]],
                       dtype=np.uint32) for i in (0, 1))
    np.testing.assert_array_equal(
        u32(tm.mul_mod32(t32(a), t32(b).long(), qt)),
        np.asarray(jm.mul_mod32(a, b, q, rh, rl)))
    x = RNG.integers(0, 1 << 32, (4, N), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(u32(tm.barrett_reduce_u32(t32(x), qt)),
                                  np.asarray(jm.barrett_reduce_u32(x, q, rh)))
    hi = (RNG.integers(0, 1 << 40, (4, N)) % q).astype(np.uint32)
    np.testing.assert_array_equal(
        u32(tm.barrett_reduce_u64_32(t32(hi), t32(x), qt)),
        np.asarray(jm.barrett_reduce_u64_32(hi, x, q, rh, rl)))


def test_shoup(mod):
    q, a, b = mod
    qt = torch.from_numpy(q.astype(np.int64))
    ws = np.array([[tm.compute_shoup32(int(w), int(v))]
                   for w, v in zip(b[:, 5], q[:, 0])], dtype=np.uint64)
    assert (ws == np.array([[jm.compute_shoup32(int(w), int(v))]
                            for w, v in zip(b[:, 5], q[:, 0])])).all()
    w = b[:, 5:6]
    x = RNG.integers(0, 1 << 32, (4, N), dtype=np.uint64).astype(np.uint32)
    for jf, tf in ((jm.mul_mod_shoup_lazy32, tm.mul_mod_shoup_lazy32),
                   (jm.mul_mod_shoup32, tm.mul_mod_shoup32)):
        got = tf(t32(x), torch.from_numpy(w.astype(np.int64)),
                 t32(ws.astype(np.uint32)), qt)
        np.testing.assert_array_equal(
            u32(got), np.asarray(jf(x, w, ws.astype(np.uint32), q)))


@pytest.fixture(scope="module")
def conv():
    """Digit -> complement converter of a short last digit (3 of alpha=4):
    the JAX package's host converter, and the port's own copy of it."""
    qs = numth.get_primes(2 * 1024, 28, 7)
    ps = numth.get_primes(2 * 1024, 29, 4)
    host = BaseConverter(RNSBase(qs[4:7]), RNSBase(qs[:4] + ps))
    port = thost.BaseConverter(thost.RNSBase(qs[4:7]),
                               thost.RNSBase(qs[:4] + ps))
    return host, jbc.consts32_from_host(host), tbc.consts32_from_host(port)


def test_consts_match(conv):
    _, jc, tc = conv
    for name in ("qhat_inv", "qhat_inv_shoup", "qhat_mod_p", "q_mod_p", "U",
                 "V"):
        np.testing.assert_array_equal(u32(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)), name)
    for base in ("ibase", "obase"):
        np.testing.assert_array_equal(u32(getattr(tc, base).q),
                                      np.asarray(getattr(jc, base).q), base)


def _digit_input(host, edge):
    q = np.array(host.ibase.moduli, dtype=np.uint64)[:, None]
    y = (RNG.integers(0, 1 << 40, (len(q), N)) % q).astype(np.uint32)
    if edge:
        y[:, :3] = 0                          # all-zero rows
        y[:, 3:6] = (q - 1).astype(np.uint32)  # rows of q - 1
    return y


@pytest.mark.parametrize("edge", [False, True])
def test_conversions(conv, edge):
    host, jc, tc = conv
    y = _digit_input(host, edge)
    ty, jy = t32(y), jnp.asarray(y)
    np.testing.assert_array_equal(u32(tbc.scale_by_qhat_inv32(ty, tc)),
                                  np.asarray(jbc.scale_by_qhat_inv32(jy, jc)))
    np.testing.assert_array_equal(u32(tbc.matmul_reduce32(ty, tc)),
                                  np.asarray(jbc.matmul_reduce32(jy, jc)))
    np.testing.assert_array_equal(u32(tbc.floor_sum_div32(ty, tc)),
                                  np.asarray(jbc.floor_sum_div32(jy, jc)))
    np.testing.assert_array_equal(u32(tbc.bconv_exact32(ty, tc)),
                                  np.asarray(jbc.bconv_exact32(jy, jc)))


def test_floor_sum_div_blocked_trailing_shape(conv):
    """floor_sum_div32 takes any trailing data shape, as the JAX one."""
    host, jc, tc = conv
    y = _digit_input(host, True).reshape(-1, 16, N // 16)
    np.testing.assert_array_equal(u32(tbc.floor_sum_div32(t32(y), tc)),
                                  np.asarray(jbc.floor_sum_div32(
                                      jnp.asarray(y), jc)))

"""K4: the port's plain modup + evk inner product (modup_ip_plain, the CPU
path of modup_ip) against the JAX package's Pallas kernel
modup_ip_mxu_pallas in interpret mode, on the same numpy inputs, n = 256;
bit-exact.  Cases: the NTT-form passthrough, the self_mul passthrough (a b
mod q), a short last digit (k = 5, alpha = 2, zero pad row) and beta = 6;
the coefficient form (modup_ip_coeff_plain against c2_ntt=None) with
even digits and with a short last one; and the preconv form
(modup_ip_preconv_plain against preconv=True) with even digits, a short
last digit, and garbage in the delta rows the kernel must not read."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_tpu.host import numth
from phantom_tpu.host.modulus import Modulus
from phantom_tpu.host.ntt_tables import make_rns_ntt_tables as jax_tables
from phantom_tpu.ops import ntt as ntt64
from phantom_tpu.ops import ntt32 as jntt32
from phantom_tpu.ops import ntt_mxu
from phantom_tpu.ops import ntt_mxu_pallas as nmp
from phantom_tpu_torch.host import make_rns_ntt_tables
from phantom_tpu_torch.ops import modup_ip_kernels as mk
from phantom_tpu_torch.ops import ntt32 as tntt32

N = 256
CASES = {  # alpha, beta, k_data, k_out, self_mul
    "passthrough": (2, 2, 4, 6, False),
    "self_mul": (2, 2, 4, 6, True),
    "short_digit": (2, 3, 5, 7, False),
    "beta6_self_mul": (1, 6, 6, 7, True),
}


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_k4_plain_vs_pallas(case):
    alpha, beta, k_data, k_out, self_mul = CASES[case]
    k = alpha * beta
    qs = numth.get_primes(2 * N, 28, k_out)
    j32 = jntt32.tables32_from_tables64(ntt64.tables_from_host(
        jax_tables(N, [Modulus(q) for q in qs])))
    jm = ntt_mxu.prepare_mxu_tables(j32, fused_kernel=True)
    tt = tntt32.NTTTables32(make_rns_ntt_tables(N, qs))
    rng = np.random.default_rng(sum(map(ord, case)))
    qc = np.array(qs[:k], dtype=np.int64)[:, None]
    y = rng.integers(0, 1 << 29, (k, N)).astype(np.uint32)
    mats = rng.integers(0, 1 << 29, (beta, k_out, alpha)).astype(np.uint32)
    c2 = [(rng.integers(0, 1 << 40, (k, N)) % qc).astype(np.uint32)
          for _ in range(2 if self_mul else 1)]
    if k_data < k:  # the short last digit: zero pad rows and columns
        y[k_data:] = 0
        mats[-1, :, k_data - (beta - 1) * alpha:] = 0
        for c in c2:
            c[k_data:] = 0
    evk = rng.integers(0, 1 << 29, (beta, 2, k_out, N)).astype(np.uint32)
    jc2 = tuple(map(jnp.asarray, c2)) if self_mul else jnp.asarray(c2[0])
    s0, s1 = nmp.modup_ip_mxu_pallas(
        jnp.asarray(y), jnp.asarray(mats), jc2, jnp.asarray(evk), jm,
        k_data=k_data, interpret=True)
    tc2 = tuple(map(t32, c2)) if self_mul else t32(c2[0])
    got = mk.modup_ip(t32(y), t32(mats), tc2, t32(evk), tt, k_data=k_data)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.stack([np.asarray(s0), np.asarray(s1)]))


@pytest.mark.parametrize("alpha,beta,k_data", [(2, 2, 4), (2, 3, 5)],
                         ids=["even", "uneven"])
def test_k4_coeff_plain_vs_pallas(alpha, beta, k_data):
    k, k_out = alpha * beta, k_data + alpha
    qs = numth.get_primes(2 * N, 28, k_out)
    j32 = jntt32.tables32_from_tables64(ntt64.tables_from_host(
        jax_tables(N, [Modulus(q) for q in qs])))
    jm = ntt_mxu.prepare_mxu_tables(j32, fused_kernel=True)
    tt = tntt32.NTTTables32(make_rns_ntt_tables(N, qs))
    rng = np.random.default_rng(k_data)
    y = rng.integers(0, 1 << 29, (k, N)).astype(np.uint32)
    mats = rng.integers(0, 1 << 29, (beta, k_out, alpha)).astype(np.uint32)
    y[k_data:] = 0
    mats[-1, :, k_data - (beta - 1) * alpha:] = 0
    evk = rng.integers(0, 1 << 29, (beta, 2, k_out, N)).astype(np.uint32)
    s0, s1 = nmp.modup_ip_mxu_pallas(jnp.asarray(y), jnp.asarray(mats), None,
                                     jnp.asarray(evk), jm, interpret=True)
    got = mk.modup_ip_coeff(t32(y), t32(mats), t32(evk), tt)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.stack([np.asarray(s0), np.asarray(s1)]))


PRECONV_CASES = {  # alpha, beta, k_data, k_out, self_mul, garbage
    "even": (2, 2, 4, 6, False, False),
    "short_digit": (2, 3, 5, 7, True, False),
    "garbage_digit_rows": (2, 3, 5, 7, True, True),
}


@pytest.mark.parametrize("case", list(PRECONV_CASES))
def test_k4p_preconv_plain_vs_pallas(case):
    """K4p: the JAX kernel reads delta with zeros at each digit's own rows
    (modup_delta_xla32's layout); the port's gets the same delta, or with
    garbage there, which it must never read."""
    alpha, beta, k_data, k_out, self_mul, garbage = PRECONV_CASES[case]
    k = alpha * beta
    qs = numth.get_primes(2 * N, 28, k_out)
    j32 = jntt32.tables32_from_tables64(ntt64.tables_from_host(
        jax_tables(N, [Modulus(q) for q in qs])))
    jm = ntt_mxu.prepare_mxu_tables(j32, fused_kernel=True)
    tt = tntt32.NTTTables32(make_rns_ntt_tables(N, qs))
    rng = np.random.default_rng(sum(map(ord, case)))
    qo = np.array(qs, dtype=np.int64)[:, None]
    delta = (rng.integers(0, 1 << 40, (beta, k_out, N)) % qo).astype(
        np.uint32)
    own = np.zeros((beta, k_out), dtype=bool)
    for d in range(beta):
        own[d, d * alpha:min((d + 1) * alpha, k_data)] = True
    delta[own] = 0
    c2 = [(rng.integers(0, 1 << 40, (k, N)) % qo[:k]).astype(np.uint32)
          for _ in range(2 if self_mul else 1)]
    for c in c2:
        c[k_data:] = 0
    evk = (rng.integers(0, 1 << 40, (beta, 2, k_out, N))
           % qo).astype(np.uint32)
    jc2 = tuple(map(jnp.asarray, c2)) if self_mul else jnp.asarray(c2[0])
    s0, s1 = nmp.modup_ip_mxu_pallas(
        jnp.asarray(delta.reshape(beta, k_out, jm.n1, jm.n2)), None, jc2,
        jnp.asarray(evk), jm, k_data=k_data, preconv=True, alpha=alpha,
        interpret=True)
    want = np.stack([np.asarray(s0), np.asarray(s1)]).reshape(2, k_out, N)
    if garbage:
        delta[own] = rng.integers(0, 1 << 32, (int(own.sum()), N),
                                  dtype=np.uint64).astype(np.uint32)
    tc2 = tuple(map(t32, c2)) if self_mul else t32(c2[0])
    got = mk.modup_ip_preconv(t32(delta), tc2, t32(evk), tt, k_data=k_data,
                              alpha=alpha)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)

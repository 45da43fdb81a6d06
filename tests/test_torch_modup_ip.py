"""K4: the port's plain modup + evk inner product (modup_ip_plain, the CPU
path of modup_ip) against the JAX package's Pallas kernel
modup_ip_mxu_pallas in interpret mode, on the same numpy inputs, n = 256;
bit-exact.  Cases: the NTT-form passthrough, the self_mul passthrough (a b
mod q), a short last digit (k = 5, alpha = 2, zero pad row) and beta = 6."""

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

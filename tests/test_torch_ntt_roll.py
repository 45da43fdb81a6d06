"""K6: the port's plain twins of the one-pass NTT (ntt_forward_roll and
ntt_inverse_roll on CPU tensors: ntt_forward_plain / ntt_inverse_plain)
against the JAX package's roll/select Pallas kernels in interpret mode, on
the same numpy inputs, n = 256: the forward, the fused moddown epilogue,
the scaled inverse, and a batched leading dimension with a repeated table
row; bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_tpu.host import numth
from phantom_tpu.host.modulus import Modulus
from phantom_tpu.host.ntt_tables import make_rns_ntt_tables as jax_tables
from phantom_tpu.ops import ntt as ntt64
from phantom_tpu.ops import ntt32 as jntt32
from phantom_tpu.ops import ntt_pallas_roll as ntr
from phantom_tpu.ops.modmath32 import compute_shoup32
from phantom_tpu_torch.host import make_rns_ntt_tables
from phantom_tpu_torch.ops import ntt32 as tntt32
from phantom_tpu_torch.ops import ntt_roll_kernels as rk

N = 256
ROWS = [2, 0, 2]  # the port's table row of each limb; JAX's tables per limb


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


@pytest.fixture(scope="module")
def tabs():
    qs = numth.get_primes(2 * N, 28, 3)
    limb_qs = [qs[r] for r in ROWS]
    j32 = jntt32.tables32_from_tables64(ntt64.tables_from_host(
        jax_tables(N, [Modulus(q) for q in limb_qs])))
    tt = tntt32.NTTTables32(make_rns_ntt_tables(N, qs))
    q = np.array(limb_qs, dtype=np.int64)[:, None]
    rng = np.random.default_rng(6)
    sc = np.array([rng.integers(1, v) for v in q[:, 0]], dtype=np.uint32)
    scs = np.array([compute_shoup32(int(s), int(v))
                    for s, v in zip(sc, q[:, 0])], dtype=np.uint32)
    return ntr.prepare_roll_tables(j32), tt, q, rng, sc, scs


@pytest.mark.parametrize("case", ["forward", "fused", "inverse_scaled",
                                  "batched"])
def test_k6_plain_vs_pallas(tabs, case):
    jr, tt, q, rng, sc, scs = tabs
    rows = torch.tensor(ROWS, dtype=torch.int32)
    lead = (2,) if case == "batched" else ()
    lazy = 2 if case == "inverse_scaled" else 1  # the inverse takes [0, 2q)
    x = (rng.integers(0, 1 << 40, lead + (len(ROWS), N)) % (lazy * q)
         ).astype(np.uint32)
    if case == "inverse_scaled":
        want = ntr.ntt_inverse_roll(jnp.asarray(x), jr, scale=jnp.asarray(sc),
                                    scale_shoup=jnp.asarray(scs),
                                    interpret=True)
        got = rk.ntt_inverse_roll(t32(x), tt, rows, t32(sc), t32(scs))
    elif case == "fused":
        sub = (rng.integers(0, 1 << 40, x.shape) % q).astype(np.uint32)
        want = ntr.ntt_forward_roll(jnp.asarray(x), jr,
                                    sub_from=jnp.asarray(sub),
                                    epi_scale=jnp.asarray(sc),
                                    epi_scale_shoup=jnp.asarray(scs),
                                    interpret=True)
        got = rk.ntt_forward_roll(t32(x), tt, rows, sub_from=t32(sub),
                                  epi_scale=t32(sc), epi_scale_shoup=t32(scs))
    else:
        want = ntr.ntt_forward_roll(jnp.asarray(x), jr, interpret=True)
        got = rk.ntt_forward_roll(t32(x), tt, rows)
        if case == "batched":
            back = rk.ntt_inverse_roll(got, tt, rows)
            np.testing.assert_array_equal(back.numpy().view(np.uint32), x)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))

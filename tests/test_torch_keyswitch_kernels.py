"""K9, K8 and K7: the port's plain key-switch inner product and moddown
epilogues (the CPU paths of inner_product, moddown_rows and
moddown_rescale) against the JAX package's Pallas kernels ip_mxu_pallas,
moddown_mxu_bconv_pallas and moddown_rescale_mxu_pallas in interpret mode,
on the same numpy inputs in the kernels' blocked (n1, n2) layout, n = 256;
bit-exact.  The constants (conversion matrix, P^-1, the rescale's) are the
port's, which tests/test_torch_pipeline.py holds equal to the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_tpu.host import numth
from phantom_tpu.host.modulus import Modulus
from phantom_tpu.host.ntt_tables import make_rns_ntt_tables as jax_tables
from phantom_tpu.ops import bconv32 as jbc32
from phantom_tpu.ops import ntt as ntt64
from phantom_tpu.ops import ntt32 as jntt32
from phantom_tpu.ops import ntt_mxu
from phantom_tpu.ops import ntt_mxu_pallas as nmp
from phantom_tpu_torch import make_context
from phantom_tpu_torch.ops import ip_kernels as ik
from phantom_tpu_torch.ops import moddown_kernels as mdk
from phantom_tpu_torch.ops import pipeline32 as tpp
from phantom_tpu_torch.schemes.params import EncryptionParameters

N = 256
K, ALPHA = 5, 2  # an odd k: K8 at R = 2 pads a tail row


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def mxu_tables(qs):
    return ntt_mxu.prepare_mxu_tables(jntt32.tables32_from_tables64(
        ntt64.tables_from_host(jax_tables(N, [Modulus(q) for q in qs]))),
        fused_kernel=True)


def residues(rng, shape, qs):
    """Uniform residues, the modulus varying along axis -2."""
    q = np.array(qs, dtype=np.int64)[:, None]
    return (rng.integers(0, 1 << 40, shape) % q).astype(np.uint32)


@pytest.mark.parametrize("beta,perm", [(2, False), (6, False), (6, True)],
                         ids=["beta2", "beta6", "beta6_perm"])
def test_k9_plain_vs_pallas(beta, perm):
    """The twin with a gather index equals the Pallas kernel on the
    gathered modup tensor."""
    k_out = 7
    qs = numth.get_primes(2 * N, 29, k_out)
    jm = mxu_tables(qs)
    rng = np.random.default_rng(beta + perm)
    t = residues(rng, (beta, k_out, N), qs)
    evk = residues(rng, (beta, 2, k_out, N), qs)
    t[..., :4] = np.array(qs, dtype=np.uint32)[:, None] - 1
    evk[..., :4] = np.array(qs, dtype=np.uint32)[:, None] - 1
    p = rng.permutation(N).astype(np.int32) if perm else None
    tg = t[:, :, p] if perm else t
    s0, s1 = nmp.ip_mxu_pallas(
        jnp.asarray(tg.reshape(beta, k_out, jm.n1, jm.n2)), jnp.asarray(evk),
        jbc32.modulus_vec32(qs), jm, interpret=True)
    got = ik.inner_product(t32(t), t32(evk), t32(qs),
                           None if p is None else torch.from_numpy(p))
    want = np.stack([np.asarray(s0), np.asarray(s1)]).reshape(2, k_out, N)
    np.testing.assert_array_equal(u32(got), want)


@pytest.fixture(scope="module")
def moddown():
    """The port's key-switch and rescale constants at k = 5, alpha = 2,
    the JAX package's MXU tables over Ql, and random operands: y over P,
    a small floor correction v, sub, d1, d2 over Ql."""
    qs = numth.get_primes(2 * N, 28, K)
    ps = numth.get_primes(2 * N, 29, ALPHA)
    ctx = make_context(EncryptionParameters.create(N, qs, ps), device="cpu")
    pipe = tpp.CKKSPipeline32(ctx, torch.zeros(1, dtype=torch.int32))
    rng = np.random.default_rng(3)
    ops = dict(
        y=np.stack([residues(rng, (ALPHA, N), ps) for _ in range(2)]),
        v=rng.integers(0, ALPHA + 1, (2, N)).astype(np.uint32),
        sub=np.stack([residues(rng, (K, N), qs) for _ in range(2)]),
        d1=np.stack([residues(rng, (K, N), qs) for _ in range(2)]),
        d2=np.stack([residues(rng, (K, N), qs) for _ in range(2)]))
    return pipe, mxu_tables(qs), qs, ops


def _common(pipe, jm, ops):
    """(JAX arguments, port arguments) up to the epilogue scale: y, mat,
    v, vmul, sub_from, tensor_add (the port's also t and rows)."""
    ks = pipe.ks
    n1, n2 = jm.n1, jm.n2
    blk = {k: jnp.asarray(a.reshape(*a.shape[:-1], n1, n2))
           for k, a in ops.items()}
    mat, vmul = u32(ks.p_to_q.qhat_mod_p), u32(ks.p_to_q.q_mod_p)
    jargs = (blk["y"], jnp.asarray(mat), blk["v"], jnp.asarray(vmul),
             blk["sub"], (blk["d1"], blk["d2"]))
    targs = (t32(ops["y"]), ks.p_to_q.qhat_mod_p, t32(ops["v"]),
             ks.p_to_q.q_mod_p, t32(ops["sub"]),
             (t32(ops["d1"]), t32(ops["d2"])), ks.ntt, ks.rows_ql)
    return jargs, targs


def test_k8_plain_vs_pallas(moddown):
    """R = 2 rows per program at k = 5 (the JAX function repeats the last
    limb into a sixth row and slices it off), tensor adds on both
    halves."""
    pipe, jm, qs, ops = moddown
    ks = pipe.ks
    jargs, targs = _common(pipe, jm, ops)
    pw, pws = jbc32.pow2_tables(qs)
    want = nmp.moddown_mxu_bconv_pallas(
        *jargs, jm, pw, pws, jnp.asarray(u32(ks.pinv)),
        jnp.asarray(u32(ks.pinv_shoup)), rows_per_program=2, interpret=True)
    got = mdk.moddown_rows(*targs, ks.pinv, ks.pinv_shoup, 2)
    np.testing.assert_array_equal(u32(got),
                                  np.asarray(want).reshape(2, K, N))


def test_k7_plain_vs_pallas(moddown):
    """Both halves with the tensor adds: rows [0, k-1) rescaled, row k-1
    the moddown output."""
    pipe, jm, _, ops = moddown
    ks = pipe.ks
    jargs, targs = _common(pipe, jm, ops)
    consts = (ks.pinv, ks.pinv_shoup)
    resc = (pipe.half_mod_q, pipe.qlast_inv, pipe.qlast_inv_shoup)
    want = nmp.moddown_rescale_mxu_pallas(
        *jargs, jm, *(jnp.asarray(u32(c)) for c in consts), pipe.half,
        *(jnp.asarray(u32(c)) for c in resc), interpret=True)
    got = mdk.moddown_rescale(*targs, *consts, pipe.half, *resc)
    np.testing.assert_array_equal(u32(got),
                                  np.asarray(want).reshape(2, K, N))

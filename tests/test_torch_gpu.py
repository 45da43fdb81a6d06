"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu` and skipped without a CUDA device.  The repo's conftest
imports JAX, which the port does not need; where JAX is not installed,
run these with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Every kernel at several sizes, with every option of its wrapper; the
tables are real NTT tables and the inputs seeded; bit-exact.
"""

import pytest
import torch

from phantom_tpu_torch import make_context
from phantom_tpu_torch.host import numth
from phantom_tpu_torch.ops import bconv_kernels as bk
from phantom_tpu_torch.ops import ip_kernels as ik
from phantom_tpu_torch.ops import moddown_kernels as mdk
from phantom_tpu_torch.ops import modup_ip_kernels as mk
from phantom_tpu_torch.ops import ntt_kernels as nk
from phantom_tpu_torch.ops import pipeline32 as pp
from phantom_tpu_torch.schemes.params import EncryptionParameters

pytestmark = pytest.mark.gpu

LOGNS = [10, 12, 13, 16, 17]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(dev, logn):
    n = 1 << logn
    ctx = make_context(EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, 5),
        numth.get_primes(2 * n, 29, 2)), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn)
    rows = torch.tensor([6, 0, 6, 2], dtype=torch.int32, device=dev)
    q = ctx.ntt.q[rows.long()].long()

    def res(shape, lazy=False):
        r = torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
        return (r % ((2 if lazy else 1) * q.view(-1, 1))).int()

    sc = (res((4, 1)).view(4).long() % (q - 1) + 1).int()
    scs = ((sc.long() << 32) // q).int()
    return ctx.ntt, rows, q, res, sc, scs, gen


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        assert torch.equal(x, y), (x != y).nonzero()[:5].tolist()


@pytest.mark.parametrize("logn", LOGNS)
def test_k2_forward(dev, logn):
    t, rows, q, res, sc, scs, _ = _setup(dev, logn)
    x = res((2, 4, 1 << logn), lazy=True)
    _same(nk.ntt_forward(x, t, rows), nk.ntt_forward_plain(x, t, rows))
    kw = dict(sub_from=res((2, 4, 1 << logn)), epi_scale=sc,
              epi_scale_shoup=scs,
              tensor_add=(res((2, 4, 1 << logn)), res((2, 4, 1 << logn))))
    _same(nk.ntt_forward(x, t, rows, **kw),
          nk.ntt_forward_plain(x, t, rows, **kw))


@pytest.mark.parametrize("logn", LOGNS)
def test_k1_inverse(dev, logn):
    t, rows, q, res, sc, scs, _ = _setup(dev, logn)
    x = res((2, 4, 1 << logn), lazy=True)
    u = ((1 << 32) // q).int()
    v = ((1 << 32) % q).int()
    for kw in (dict(), dict(scale=sc, scale_shoup=scs,
                            mul_by=res((2, 4, 1 << logn), lazy=True)),
               dict(scale=sc, scale_shoup=scs, emit_floor_div=(u, v))):
        _same(nk.ntt_inverse(x, t, rows, **kw),
              nk.ntt_inverse_plain(x, t, rows, **kw))


@pytest.mark.parametrize("logn", LOGNS)
def test_k3_bconv_forward(dev, logn):
    t, rows, q, res, sc, scs, gen = _setup(dev, logn)
    n = 1 << logn
    y = torch.randint(0, 1 << 29, (2, 3, n), generator=gen, device=dev).int()
    mat = torch.randint(0, 1 << 29, (2, 4, 3), generator=gen,
                        device=dev).int()
    full = dict(v=torch.randint(0, 1 << 31, (2, n), generator=gen,
                                device=dev).int(),
                vmul=res((4, 1)).view(4), post_sub=res((4, 1)).view(4),
                sub_from=res((2, 4, n)), epi_scale=sc, epi_scale_shoup=scs,
                tensor_add=(res((2, 4, n)), res((2, 4, n))))
    selfr = dict(self_rows=torch.randint(0, 268000000, (6, n), generator=gen,
                                         device=dev).int(), k_data=5)
    for kw in (dict(), full, selfr):
        _same(nk.bconv_ntt_forward(y, mat, t, rows, **kw),
              nk.bconv_ntt_forward_plain(y, mat, t, rows, **kw))


@pytest.mark.parametrize("k_in,k_out", [(22, 43), (21, 44), (3, 5), (63, 4)])
@pytest.mark.parametrize("logn", [10, 16])
def test_k5_fold_matmul(dev, logn, k_in, k_out):
    n = 1 << logn
    gen = torch.Generator(device=dev)
    gen.manual_seed(k_in)
    y = torch.randint(0, 1 << 30, (k_in, n), generator=gen, device=dev).int()
    mat = torch.randint(0, 1 << 30, (k_out, k_in), generator=gen,
                        device=dev).int()
    q = torch.tensor(numth.get_primes(2 * n, 29, k_out), dtype=torch.int32,
                     device=dev)
    _same(bk.fold_matmul(y, mat, q), bk.fold_matmul_plain(y, mat, q))


@pytest.mark.parametrize("self_mul", [False, True], ids=["pass", "self_mul"])
@pytest.mark.parametrize("alpha,beta,k_data", [(2, 2, 4), (8, 6, 43)])
@pytest.mark.parametrize("logn", [10, 16])
def test_k4_modup_ip(dev, logn, alpha, beta, k_data, self_mul):
    """K4 at the alpha = 8 slice's shapes (beta = 6, a short last digit of
    3 rows, k_out = 51) and a small one, both passthrough variants."""
    n = 1 << logn
    k_out = k_data + alpha
    ctx = make_context(EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, k_data),
        numth.get_primes(2 * n, 29, alpha)), device=dev)
    t = ctx.ntt
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn + beta)
    q = t.q.long().view(-1, 1)
    k = alpha * beta

    def res(shape, rows):
        return (torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
                % q[:rows]).int()

    y = torch.zeros((k, n), dtype=torch.int32, device=dev)
    y[:k_data] = res((k_data, n), k_data)
    mats = torch.randint(0, 1 << 30, (beta, k_out, alpha), generator=gen,
                         device=dev).int()
    a = torch.zeros_like(y)
    a[:k_data] = res((k_data, n), k_data)
    c2 = (a, a.roll(1, 1).contiguous()) if self_mul else a
    evk = torch.stack([torch.stack([res((k_out, n), k_out)
                                    for _ in range(2)])
                       for _ in range(beta)])
    before = mk.modup_ip.launches
    got = mk.modup_ip(y, mats, c2, evk, t, k_data=k_data)
    assert mk.modup_ip.launches == before + 1
    _same(got, mk.modup_ip_plain(y, mats, c2, evk, t, k_data=k_data))


@pytest.mark.parametrize("beta,k_out,perm", [(2, 65, False), (6, 51, False),
                                             (6, 51, True)],
                         ids=["beta2", "beta6", "beta6_perm"])
@pytest.mark.parametrize("logn", [10, 16])
def test_k9_inner_product(dev, logn, beta, k_out, perm):
    """K9 at the headline's shapes (beta = 2, k_out = 65) and the hoisted
    forms' (beta = 6, k_out = 51, with and without the gather index),
    residues up to q - 1."""
    n = 1 << logn
    q = torch.tensor(numth.get_primes(2 * n, 29, k_out), dtype=torch.int32,
                     device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn + beta)

    def res(shape):
        r = torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
        r = (r % q.long().view(-1, 1)).int()
        r[..., :4] = (q - 1).view(-1, 1)
        return r

    t, evk = res((beta, k_out, n)), res((beta, 2, k_out, n))
    p = (torch.randperm(n, generator=gen, device=dev).int() if perm
         else None)
    before = ik.inner_product.launches
    got = ik.inner_product(t, evk, q, p)
    assert ik.inner_product.launches == before + 1
    _same(got, ik.inner_product_plain(t, evk, q, p))


def _moddown_operands(dev, logn, k, alpha):
    """The moddown epilogues' operands at (k, alpha): the port's constants,
    seeded residues for y (over P), sub, d1, d2 (over Ql) and a small v."""
    n = 1 << logn
    ctx = make_context(EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, k),
        numth.get_primes(2 * n, 29, alpha)), device=dev)
    pipe = pp.CKKSPipeline32(ctx, torch.zeros(1, dtype=torch.int32)).to(dev)
    ks = pipe.ks
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn + k + alpha)

    def res(shape, q):
        return (torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
                % q.long().view(-1, 1)).int()

    y = res((2, alpha, n), ks.mv_qlp.q[k:])
    v = torch.randint(0, alpha + 1, (2, n), generator=gen, device=dev).int()
    sub, d1, d2 = (res((2, k, n), ks.mv_ql.q) for _ in range(3))
    return pipe, (y, ks.p_to_q.qhat_mod_p, v, ks.p_to_q.q_mod_p, sub,
                  (d1, d2), ks.ntt, ks.rows_ql, ks.pinv, ks.pinv_shoup)


MODDOWN_SHAPES = [(43, 22), (43, 8), (5, 2)]  # headline, alpha 8, small


@pytest.mark.parametrize("rows_per_block", [8, 2, 1])
@pytest.mark.parametrize("k,alpha", MODDOWN_SHAPES)
@pytest.mark.parametrize("logn", [10, 16])
def test_k8_moddown_rows(dev, logn, k, alpha, rows_per_block):
    """K8 with and without the tensor adds; k % R != 0 masks a tail."""
    _, args = _moddown_operands(dev, logn, k, alpha)
    before = mdk.moddown_rows.launches
    got = mdk.moddown_rows(*args, rows_per_block)
    assert mdk.moddown_rows.launches == before + 1
    _same(got, mdk.moddown_rows_plain(*args, rows_per_block))
    bare = args[:5] + (None,) + args[6:]
    _same(mdk.moddown_rows(*bare, rows_per_block),
          mdk.moddown_rows_plain(*bare, rows_per_block))


@pytest.mark.parametrize("k,alpha", MODDOWN_SHAPES + [(2, 3)])
@pytest.mark.parametrize("logn", [10, 16])
def test_k7_moddown_rescale(dev, logn, k, alpha):
    pipe, args = _moddown_operands(dev, logn, k, alpha)
    args += (pipe.half, pipe.half_mod_q, pipe.qlast_inv,
             pipe.qlast_inv_shoup)
    before = mdk.moddown_rescale.launches
    got = mdk.moddown_rescale(*args)
    assert mdk.moddown_rescale.launches == before + 1
    _same(got, mdk.moddown_rescale_plain(*args))


def test_launch_counts(dev):
    t, rows, q, res, *_ = _setup(dev, 12)
    before = nk.ntt_forward.launches
    nk.ntt_forward(res((4, 1 << 12)), t, rows)
    assert nk.ntt_forward.launches == before + 1

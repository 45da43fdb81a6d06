"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu` and skipped without a CUDA device.  The repo's conftest
imports JAX, which the port does not need; where JAX is not installed,
run these with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Every kernel at several sizes, with every option of its wrapper; the
tables are real NTT tables and the inputs seeded; bit-exact.  The BFV step
on both engines, BFV's other techniques and the fused lift, and the BGV
step on each modup route against the plain path and the golden files.
"""

import os

import numpy as np

import pytest
import torch

import chip_smoke
from phantom_tpu_torch import make_context
from phantom_tpu_torch.host import numth
from phantom_tpu_torch.ops import bconv_kernels as bk
from phantom_tpu_torch.ops import ip_kernels as ik
from phantom_tpu_torch import convert
from phantom_tpu_torch.ops import moddown_kernels as mdk
from phantom_tpu_torch.ops import modup_ip_kernels as mk
from phantom_tpu_torch.ops import ntt_kernels as nk
from phantom_tpu_torch.ops import ntt_roll_kernels as rk
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


K2_CASES = ([pytest.param(logn, None, "options", id=str(logn))
             for logn in LOGNS]
            + [pytest.param(16, c, "options", id=f"16-C{c}")
               for c in (1, 2, 4, 8)]
            + [pytest.param(logn, None, case, id=f"{logn}-{case}")
               for logn in (10, 16)
               for case in ("two-rows", "repeated-rows", "extremes")])


@pytest.mark.parametrize("logn,cluster,case", K2_CASES)
def test_k2_forward(dev, logn, cluster, case):
    """K2 on the cluster core: each size at the default cluster size and,
    at 2^16, at each (C = 1 refused, as for K1); the (2, 1, N) rows of a
    mod switch; BFV's D forward, (2, 2, 87, N) with repeated table rows;
    x at 2q - 1 with every epilogue operand at q - 1.  Each with no
    epilogue, with (sub_from - .) epi_scale, with the tensor adds and with
    both.  A misaligned x is refused."""
    t, rows, q, res, sc, scs, gen = _setup(dev, logn)
    n = 1 << logn
    if case == "options" and cluster == 1 and logn == 16:
        with pytest.raises(ValueError):
            nk.ntt_forward(res((2, 4, n), lazy=True), t, rows, cluster=1)
        return

    def epilogues(shape, r, qr, sub=None, d=None):
        """No epilogue, each alone and both, on (2, L, N) operands over
        table rows r with moduli qr."""
        def rand():
            return (torch.randint(0, 1 << 62, shape, generator=gen,
                                  device=dev) % qr.view(-1, 1)).int()
        s_ = rand() if sub is None else sub
        ta = (rand(), rand()) if d is None else d
        e = (torch.randint(0, 1 << 62, qr.shape, generator=gen, device=dev)
             % (qr.long() - 1) + 1).int()
        es = ((e.long() << 32) // qr.long()).int()
        sub_kw = dict(sub_from=s_, epi_scale=e, epi_scale_shoup=es)
        return [dict(), sub_kw, dict(tensor_add=ta),
                dict(sub_kw, tensor_add=ta)]

    calls = []
    if case == "options":
        x = res((2, 4, n), lazy=True)
        calls = [(x, rows, kw) for kw in epilogues((2, 4, n), rows, q)]
        buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=dev)
        bad = buf[1:].view(x.shape)
        bad.copy_(x)
        with pytest.raises(ValueError, match="aligned"):
            nk.ntt_forward(bad, t, rows, cluster=cluster)
    elif case == "two-rows":
        x = res((2, 4, n), lazy=True)[:, 1:2].contiguous()
        calls = [(x, rows[1:2], kw)
                 for kw in epilogues((2, 1, n), rows[1:2], q[1:2])]
    elif case == "repeated-rows":
        r87 = torch.randint(0, t.q.shape[0], (87,), generator=gen,
                            device=dev).int()
        q87 = t.q[r87.long()].long().view(-1, 1)
        x = (torch.randint(0, 1 << 62, (2, 2, 87, n), generator=gen,
                           device=dev) % (2 * q87)).int()
        calls = [(x, r87, dict())] + [
            (x[0].contiguous(), r87, kw)
            for kw in epilogues((2, 87, n), r87, q87.view(-1))[1:]]
    else:  # extremes
        x = (2 * q.view(-1, 1) - 1).int().expand(2, 4, n).contiguous()
        top = (q.view(-1, 1) - 1).int().expand(2, 4, n).contiguous()
        calls = [(x, rows, kw) for kw in epilogues(
            (2, 4, n), rows, q, sub=top, d=(top, top.clone()))]
    for xx, rr, kw in calls:
        before = nk.ntt_forward.launches
        got = nk.ntt_forward(xx, t, rr, cluster=cluster, **kw)
        assert nk.ntt_forward.launches == before + 1
        _same(got, nk.ntt_forward_plain(xx, t, rr, **kw))


K1_CASES = ([pytest.param(logn, None, "options", id=str(logn))
             for logn in range(10, 18)]
            + [pytest.param(16, c, "options", id=f"16-C{c}")
               for c in (1, 2, 4, 8)]
            + [pytest.param(logn, None, case, id=f"{logn}-{case}")
               for logn in (10, 16)
               for case in ("two-rows", "repeated-rows", "extremes",
                            "floor30")])


@pytest.mark.parametrize("logn,cluster,case", K1_CASES)
def test_k1_inverse(dev, logn, cluster, case):
    """K1 on the cluster core: every option at each size, at the default
    cluster size and, at 2^16, at each (C = 1: a 2^16-word share does not
    fit a block's shared memory, so the wrapper refuses it); the rescale's
    and mod switch's (2, 1, N); 87 rows whose table rows repeat (BFV's D
    inverse); x and mul_by at 2q - 1; the floor sum over 22 rows of 30-bit
    primes with y at q - 1, where the cascade's sums are largest."""
    t, rows, q, res, sc, scs, gen = _setup(dev, logn)
    n = 1 << logn
    u = ((1 << 32) // q).int()
    v = ((1 << 32) % q).int()
    if case == "options" and cluster == 1 and logn == 16:
        with pytest.raises(ValueError):
            nk.ntt_inverse(res((2, 4, n), lazy=True), t, rows, cluster=1)
        return
    calls = []
    if case == "options":
        x = res((2, 4, n), lazy=True)
        calls = [(x, t, rows, kw) for kw in (
            dict(), dict(scale=sc, scale_shoup=scs,
                         mul_by=res((2, 4, n), lazy=True)),
            dict(scale=sc, scale_shoup=scs, emit_floor_div=(u, v)))]
    elif case == "two-rows":
        x = res((2, 4, n), lazy=True)[:, 1:2].contiguous()
        calls = [(x, t, rows[1:2], dict(scale=sc[1:2], scale_shoup=scs[1:2],
                                        **kw))
                 for kw in (dict(), dict(emit_floor_div=(u[1:2], v[1:2])))]
    elif case == "repeated-rows":
        r87 = torch.randint(0, t.q.shape[0], (87,), generator=gen,
                            device=dev).int()
        q87 = t.q[r87.long()].long().view(-1, 1)
        x = (torch.randint(0, 1 << 62, (3, 87, n), generator=gen,
                           device=dev) % (2 * q87)).int()
        calls = [(x, t, r87, dict())]
    elif case == "extremes":
        x = (2 * q.view(-1, 1) - 1).int().expand(2, 4, n).contiguous()
        calls = [(x, t, rows, dict(scale=sc, scale_shoup=scs,
                                   mul_by=x.clone()))]
    else:  # floor30
        t30 = _tables30(dev, n, 22)
        q30 = t30.q.long()
        y = (q30.view(1, 22, 1) - 1).expand(2, 22, n).contiguous().int()
        x = nk.ntt_forward_plain(y, t30)
        fd = dict(emit_floor_div=(((1 << 32) // q30).int(),
                                  ((1 << 32) % q30).int()))
        assert torch.equal(nk.ntt_inverse_plain(x, t30, **fd)[0], y)
        calls = [(x, t30, None, fd)]
    for xx, tt, rr, kw in calls:
        before = nk.ntt_inverse.launches
        got = nk.ntt_inverse(xx, tt, rr, cluster=cluster, **kw)
        assert nk.ntt_inverse.launches == before + 1
        _same(got, nk.ntt_inverse_plain(xx, tt, rr, **kw))


K3_CASES = ([pytest.param(logn, None, "options", id=str(logn))
             for logn in LOGNS]
            + [pytest.param(16, c, "options", id=f"16-C{c}")
               for c in (2, 4, 8)]
            + [pytest.param(logn, None, case, id=f"{logn}-{case}")
               for logn in (10, 16)
               for case in ("alpha1", "unpadded", "extremes", "carry")])


def _tables30(dev, n, k):
    """NTT tables over k primes of 30 bits, the largest the port takes."""
    from phantom_tpu_torch.host import make_rns_ntt_tables
    from phantom_tpu_torch.ops.ntt32 import NTTTables32
    return NTTTables32(make_rns_ntt_tables(
        n, numth.get_primes(2 * n, 30, k))).to(dev)


@pytest.mark.parametrize("logn,cluster,case", K3_CASES)
def test_k3_bconv_forward(dev, logn, cluster, case):
    """K3 on the cluster core: every option at each size and, at 2^16,
    each cluster size; alpha 1 with post_sub and the moddown epilogue (the
    rescale's shape); y unpadded with a short last group and self rows
    (the fused modup); residues at q - 1 and matrix words at 2^30 - 1; and
    alpha 24 over 30-bit primes, past the 64-bit sum, so the carry path
    runs."""
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
    calls = []
    if case == "options":
        calls = [(y, mat, t, rows, kw) for kw in (dict(), full, selfr)]
    elif case == "alpha1":
        y1 = y[:, :1].contiguous()
        kw = dict(post_sub=full["post_sub"], sub_from=full["sub_from"],
                  epi_scale=sc, epi_scale_shoup=scs)
        calls = [(y1, mat[:, :, :1].contiguous(), t, rows, kw),
                 (y1, mat[:, :, :1].contiguous(), t, rows, selfr)]
    elif case == "unpadded":
        calls = [(y.view(6, n)[:5].contiguous(), mat, t, rows, selfr),
                 (y.view(6, n)[:4].contiguous(), mat, t, rows,
                  dict(selfr, k_data=4))]
    elif case == "extremes":
        ym = y.clone()
        ym[..., ::2] = (q.max() - 1).int()
        mm = torch.full_like(mat, (1 << 30) - 1)
        calls = [(ym, mm, t, rows, dict(full, sub_from=(q - 1).int().view(
            1, 4, 1).expand(2, 4, n).contiguous()))]
    else:  # carry
        t30 = _tables30(dev, n, 4)
        assert not nk.sum_fits_64(24, t30)
        q30 = t30.q.long()
        yc = (q30[0] - 1).repeat(2, 24, n).int()
        yc[:, :, 1::3] = torch.randint(0, 1 << 30, (2, 24, n),
                                       generator=gen, device=dev).int()[
            :, :, 1::3] % (q30[0] - 1).int()
        mc = torch.full((2, 4, 24), (1 << 30) - 1, dtype=torch.int32,
                        device=dev)
        calls = [(yc, mc, t30, None, dict())]
    for yy, mm, tt, rr, kw in calls:
        before = nk.bconv_ntt_forward.launches
        got = nk.bconv_ntt_forward(yy, mm, tt, rr, cluster=cluster, **kw)
        assert nk.bconv_ntt_forward.launches == before + 1
        _same(got, nk.bconv_ntt_forward_plain(yy, mm, tt, rr, **kw))


@pytest.mark.parametrize("k_in,k_out,case", [
    (22, 43, "random"), (21, 44, "random"), (3, 5, "random"),
    (63, 4, "random"), (87, 44, "random"), (44, 43, "random"),
    (87, 44, "extremes"), (bk.MAX_K_IN, 44, "random"), (22, 1, "random")])
@pytest.mark.parametrize("logn", [10, 16])
def test_k5_fold_matmul(dev, logn, k_in, k_out, case):
    """K5 on the int8 tensor cores: the main path's shapes, y = mat =
    2^30 - 1 (every plane full), the largest k_in the wrapper takes (one
    more raises), one output row; the launch counter moves by one."""
    n = 1 << logn
    gen = torch.Generator(device=dev)
    gen.manual_seed(k_in)
    y = torch.randint(0, 1 << 30, (k_in, n), generator=gen, device=dev).int()
    mat = torch.randint(0, 1 << 30, (k_out, k_in), generator=gen,
                        device=dev).int()
    if case == "extremes":
        y.fill_((1 << 30) - 1)
        mat.fill_((1 << 30) - 1)
    q = torch.tensor(numth.get_primes(2 * n, 29, k_out), dtype=torch.int32,
                     device=dev)
    before = bk.fold_matmul.launches
    got = bk.fold_matmul(y, mat, q)
    assert bk.fold_matmul.launches == before + 1
    _same(got, bk.fold_matmul_plain(y, mat, q))
    if k_in == bk.MAX_K_IN:
        y1 = torch.zeros((k_in + 1, n), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError):
            bk.fold_matmul(y1, torch.zeros((k_out, k_in + 1),
                                           dtype=torch.int32, device=dev), q)


@pytest.mark.parametrize("self_mul", [False, True], ids=["pass", "self_mul"])
@pytest.mark.parametrize("alpha,beta,k_data", [(2, 2, 4), (8, 6, 43),
                                               (22, 2, 43)])
@pytest.mark.parametrize("logn", [10, 16, 17])
def test_k4_modup_ip(dev, logn, alpha, beta, k_data, self_mul):
    """K4 at the alpha = 8 slice's shapes (beta = 6, a short last digit of
    3 rows, k_out = 51), at alpha 22 (beta 2, a short last digit of 21
    rows, k_out 65) and a small one, both passthrough variants; y and c2
    unpadded (k_data rows) and zero-padded to beta alpha rows, residues at
    q - 1 in some columns."""
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
        r = (torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
             % q[:rows]).int()
        r[..., :8] = (q[:rows] - 1).int()
        return r

    y = res((k_data, n), k_data)
    mats = torch.randint(0, 1 << 30, (beta, k_out, alpha), generator=gen,
                         device=dev).int()
    a = res((k_data, n), k_data)
    c2 = (a, a.roll(1, 1).contiguous()) if self_mul else a
    evk = torch.stack([torch.stack([res((k_out, n), k_out)
                                    for _ in range(2)])
                       for _ in range(beta)])

    def padded(x):
        return torch.cat([x, x.new_zeros((k - k_data, n))])

    for yy, cc in ((y, c2), (padded(y), tuple(map(padded, c2))
                             if self_mul else padded(c2))):
        before = mk.modup_ip.launches
        got = mk.modup_ip(yy, mats, cc, evk, t, k_data=k_data)
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


def _k8(args, rows_per_block, cluster=None):
    """K8 against its plain version, with and without the tensor adds."""
    before = mdk.moddown_rows.launches
    got = mdk.moddown_rows(*args, rows_per_block, cluster)
    assert mdk.moddown_rows.launches == before + 1
    _same(got, mdk.moddown_rows_plain(*args, rows_per_block))
    bare = args[:5] + (None,) + args[6:]
    _same(mdk.moddown_rows(*bare, rows_per_block, cluster),
          mdk.moddown_rows_plain(*bare, rows_per_block))


@pytest.mark.parametrize("rows_per_block", [8, 7, 6, 5, 2, 1])
@pytest.mark.parametrize("k,alpha", MODDOWN_SHAPES)
@pytest.mark.parametrize("logn", [10, 16])
def test_k8_moddown_rows(dev, logn, k, alpha, rows_per_block):
    """K8 with and without the tensor adds; k % R != 0 masks a tail; at
    2^16 R = 7 and 8 run in two rounds (6 rows fit a block at C = 8)."""
    _, args = _moddown_operands(dev, logn, k, alpha)
    _k8(args, rows_per_block)


@pytest.mark.parametrize("cluster", [8, 4, 2])
@pytest.mark.parametrize("rows_per_block", [8, 5])
def test_k8_clusters(dev, cluster, rows_per_block):
    """K8 at the headline moddown's shape, N = 2^16, at 8, 4 and 2 blocks
    per row: 6, 3 and 1 rows fit a block, so R = 5 and 8 run in one to
    eight rounds."""
    _, args = _moddown_operands(dev, 16, 43, 22)
    held, fit = mdk.held_rows(rows_per_block, 1 << 16, cluster), {
        8: 6, 4: 3, 2: 1}[cluster]
    assert held <= fit and -(-rows_per_block // held) == -(
        -rows_per_block // min(rows_per_block, fit))
    _k8(args, rows_per_block, cluster)


@pytest.mark.parametrize("rows_per_block", [4, 3, 1])
@pytest.mark.parametrize("logn", [10, 16])
def test_k8_carry(dev, logn, rows_per_block):
    """K8 over 30-bit primes with alpha 24, past the 64-bit sum (the carry
    path), y at q - 1 in two columns of three and every matrix word at
    2^30 - 1."""
    n = 1 << logn
    k, alpha = 4, 24
    t = _tables30(dev, n, k)
    assert not nk.sum_fits_64(alpha, t)
    q = t.q.long()
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn + rows_per_block)

    def res(shape):
        return (torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
                % q.view(-1, 1)).int()

    y = (q[0] - 1).repeat(2, alpha, n).int()
    y[:, :, 1::3] = torch.randint(0, 1 << 30, (2, alpha, n), generator=gen,
                                  device=dev).int()[:, :, 1::3] % (
                                      q[0] - 1).int()
    mat = torch.full((k, alpha), (1 << 30) - 1, dtype=torch.int32,
                     device=dev)
    v = torch.randint(0, alpha + 1, (2, n), generator=gen, device=dev).int()
    sc = (res((k, 1)).view(k).long() % (q - 1) + 1).int()
    args = (y, mat, v, res((k, 1)).view(k), res((2, k, n)),
            (res((2, k, n)), res((2, k, n))), t, None, sc,
            ((sc.long() << 32) // q).int())
    _k8(args, rows_per_block)


def _k7_args(dev, logn, k, alpha):
    """K7's operands: the moddown's and the pipeline's rescale constants."""
    pipe, args = _moddown_operands(dev, logn, k, alpha)
    return args + (pipe.half, pipe.half_mod_q, pipe.qlast_inv,
                   pipe.qlast_inv_shoup)


def _k7(args, cluster=None):
    """K7 against its plain version: one launch per call."""
    before = mdk.moddown_rescale.launches
    got = mdk.moddown_rescale(*args, cluster=cluster)
    assert mdk.moddown_rescale.launches == before + 1
    _same(got, mdk.moddown_rescale_plain(*args))


@pytest.mark.parametrize("k,alpha", MODDOWN_SHAPES + [(2, 3)])
@pytest.mark.parametrize("logn", [10, 16])
def test_k7_moddown_rescale(dev, logn, k, alpha):
    """K7, the last limb's launch and the other rows' under PDL, at the
    headline and alpha-8 shapes, a small one and k = 2 (one other row per
    half); a misaligned y is refused before any launch."""
    args = _k7_args(dev, logn, k, alpha)
    _k7(args)
    y = args[0]
    bad = torch.empty(y.numel() + 1, dtype=torch.int32, device=dev)[1:]
    bad = bad.view(y.shape)
    bad.copy_(y)
    before = mdk.moddown_rescale.launches
    with pytest.raises(ValueError, match="aligned"):
        mdk.moddown_rescale(bad, *args[1:])
    assert mdk.moddown_rescale.launches == before


@pytest.mark.parametrize("cluster", [8, 4, 2])
def test_k7_clusters(dev, cluster):
    """K7 at the headline shape, N = 2^16, at 8, 4 and 2 blocks per row."""
    _k7(_k7_args(dev, 16, 43, 22), cluster)


@pytest.mark.parametrize("logn", [10, 16])
def test_k7_carry(dev, logn):
    """K7 over 30-bit primes with alpha 24, past the 64-bit sum (the carry
    path), y at q - 1 in two columns of three and every matrix word at
    2^30 - 1; the rescale's constants from the primes."""
    n = 1 << logn
    k, alpha = 4, 24
    t = _tables30(dev, n, k)
    assert not nk.sum_fits_64(alpha, t)
    q = t.q.long()
    qs = [int(x) for x in t.q.tolist()]
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn + 7)

    def res(shape):
        return (torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
                % q.view(-1, 1)).int()

    def shoup(w, mods):
        return ((w.long() << 32) // mods).int()

    y = (q[0] - 1).repeat(2, alpha, n).int()
    y[:, :, 1::3] = torch.randint(0, 1 << 30, (2, alpha, n), generator=gen,
                                  device=dev).int()[:, :, 1::3] % (
                                      q[0] - 1).int()
    mat = torch.full((k, alpha), (1 << 30) - 1, dtype=torch.int32,
                     device=dev)
    v = torch.randint(0, alpha + 1, (2, n), generator=gen, device=dev).int()
    pinv = (res((k, 1)).view(k).long() % (q - 1) + 1).int()
    half = qs[-1] // 2
    hmq = torch.tensor([half % m for m in qs[:-1]], device=dev).int()
    qinv = torch.tensor([pow(qs[-1], -1, m) for m in qs[:-1]],
                        device=dev).int()
    args = (y, mat, v, res((k, 1)).view(k), res((2, k, n)),
            (res((2, k, n)), res((2, k, n))), t, None, pinv,
            shoup(pinv, q), half, hmq, qinv, shoup(qinv, q[:-1]))
    _k7(args)


def test_launch_counts(dev):
    t, rows, q, res, *_ = _setup(dev, 12)
    before = nk.ntt_forward.launches
    nk.ntt_forward(res((4, 1 << 12)), t, rows)
    assert nk.ntt_forward.launches == before + 1


@pytest.mark.parametrize("logn", [10, 12, 13, 14, 15, 16])
def test_k6_one_pass(dev, logn):
    """K6 (K2's and K1's kernels) against its plain twins at the default
    cluster size and every size whose share of 512 words or more fits a
    block: the core refuses shares below 1024 words (logn 10 at 2 blocks,
    12 at 8), the wrapper raises before any launch; the fused epilogue and
    the scaled inverse; lazy [0, 2q) inputs."""
    n = 1 << logn
    t, rows, q, res, sc, scs, _ = _setup(dev, logn)
    x = res((2, 4, n), lazy=True)
    sizes = [None] + [c for c in (1, 2, 4, 8)
                      if n // c * 4 <= 232448 and n // c >= 512]
    for c in sizes:
        before = rk.ntt_forward_roll.launches
        if c is not None and n // c < nk.MIN_SHARE:
            with pytest.raises(ValueError, match=f"cluster={c} at N={n}"):
                rk.ntt_forward_roll(x, t, rows, cluster=c)
            with pytest.raises(ValueError, match=f"cluster={c} at N={n}"):
                rk.ntt_inverse_roll(x, t, rows, cluster=c)
            assert rk.ntt_forward_roll.launches == before
            continue
        _same(rk.ntt_forward_roll(x, t, rows, cluster=c),
              nk.ntt_forward_plain(x, t, rows))
        assert rk.ntt_forward_roll.launches == before + 1
        before = rk.ntt_inverse_roll.launches
        _same(rk.ntt_inverse_roll(x, t, rows, cluster=c),
              nk.ntt_inverse_plain(x, t, rows))
        assert rk.ntt_inverse_roll.launches == before + 1
    sub = res((2, 4, n))
    kw = dict(sub_from=sub, epi_scale=sc, epi_scale_shoup=scs)
    _same(rk.ntt_forward_roll(x, t, rows, **kw),
          nk.ntt_forward_plain(x, t, rows, **kw))
    _same(rk.ntt_inverse_roll(x, t, rows, sc, scs),
          nk.ntt_inverse_plain(x, t, rows, sc, scs))


@pytest.mark.parametrize("alpha,beta,k_data", [(2, 3, 5), (22, 2, 43),
                                               (1, 17, 17)])
@pytest.mark.parametrize("logn", [10, 16])
def test_k4_coeff(dev, logn, alpha, beta, k_data):
    """K4's coefficient form at the BFV headline's shape (beta 2, k_out 65,
    alpha 22, a short last digit), a small one, and beta 17 over 30-bit
    primes with every transformed row and evk word at q - 1, whose digit
    sums pass 2^64; y unpadded (k_data rows) and zero-padded."""
    n = 1 << logn
    k_out = k_data + alpha
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn + alpha)
    if beta == 17:
        t = _tables30(dev, n, k_out)
        assert not nk.sum_fits_64(beta, t)
        q = t.q.long()
        y = torch.ones((k_data, n), dtype=torch.int32, device=dev)
        mats = (q - 1).view(1, k_out, 1).expand(beta, k_out, 1).int()
        evk = (q - 1).view(1, 1, k_out, 1).expand(beta, 2, k_out, n).int()
        mats, evk = mats.contiguous(), evk.contiguous()
    else:
        t = make_context(EncryptionParameters.create(
            n, numth.get_primes(2 * n, 28, k_data),
            numth.get_primes(2 * n, 29, alpha)), device=dev).ntt
        y = torch.randint(0, 1 << 28, (k_data, n), generator=gen,
                          device=dev).int()
        mats = torch.randint(0, 1 << 29, (beta, k_out, alpha), generator=gen,
                             device=dev).int()
        evk = (torch.randint(0, 1 << 62, (beta, 2, k_out, n), generator=gen,
                             device=dev) % t.q.long().view(-1, 1)).int()
    yp = torch.cat([y, y.new_zeros((alpha * beta - k_data, n))])
    want = mk.modup_ip_coeff_plain(y, mats, evk, t)
    for yy in (y, yp):
        before = mk.modup_ip_coeff.launches
        got = mk.modup_ip_coeff(yy, mats, evk, t)
        assert mk.modup_ip_coeff.launches == before + 1
        _same(got, want)


@pytest.mark.parametrize("engine", ["mxu-pallas", "pallas-roll"])
def test_bfv_step(dev, engine):
    """The BFV golden file's step and key switch on each engine: the kernel
    path equals the plain path and the JAX package's output."""
    from phantom_tpu_torch import make_context as mc
    g = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "torch_port", "bfv_step_n1024.npz"))
    ctx = mc(EncryptionParameters.create(
        g["d1"].shape[-1], g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), "bfv", int(g["t"])), device=dev)
    p = convert.bfv_pipeline(ctx, g["rlk"], engine=engine)
    d1, d2 = (convert.residues(g[k]).to(dev) for k in ("d1", "d2"))
    got = p(d1, d2)
    _same(got, p(d1, d2, pp.PLAIN))
    assert np.array_equal(got.cpu().numpy().view(np.uint32), g["out"])
    ks = pp.keyswitch32(p.ks, d1[1], p.evk)
    assert np.array_equal(ks.cpu().numpy().view(np.uint32), g["keyswitch"])


@pytest.mark.parametrize("logn", [10, 16])
def test_k3_fused_lift(dev, logn):
    """K3 at the BFV fused lift's shape (43 data primes, D = Ql u Rl of 87
    rows): y (4, 43, N) scaled by QhatInv, mat (4, 87, 43), the floor sums
    v (4, N) and vmul (87,); 43 products pass one 64-bit word, so the
    carry path runs.  Bit-equal to its plain version and to the xla lift
    (K5 per poly) followed by K2."""
    from phantom_tpu_torch.ops import bfv32
    n = 1 << logn
    ctx = make_context(chip_smoke.mod_t_params(n, 43, 22), device=dev)
    p = bfv32.BFVPipeline32(ctx, torch.zeros(1, dtype=torch.int32, device=dev),
                            lift="kernel").to(dev)
    assert not nk.sum_fits_64(43, ctx.ntt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn)
    q = ctx.key_q[:43].long().view(-1, 1)
    polys = (torch.randint(0, 1 << 62, (4, 43, n), generator=gen,
                           device=dev) % q).int()
    polys[0, :, :2] = (q - 1).int()  # the largest residues
    calls = []

    def keep(*a, **kw):
        calls.append((a, kw))
        return nk.bconv_ntt_forward(*a, **kw)

    before = nk.bconv_ntt_forward.launches
    got = bfv32._lift_ntt_fused(p, polys, pp.KERNELS._replace(
        bconv_ntt_forward=keep))
    assert nk.bconv_ntt_forward.launches == before + 1
    (a, kw), = calls
    assert tuple(a[0].shape) == (4, 43, n) and tuple(a[1].shape) == (4, 87, 43)
    assert tuple(kw["v"].shape) == (4, n) and tuple(kw["vmul"].shape) == (87,)
    _same(got, nk.bconv_ntt_forward_plain(*a, **kw))
    lifted = torch.cat([bfv32._lift(p, polys[:2], pp.KERNELS),
                        bfv32._lift(p, polys[2:], pp.KERNELS)])
    _same(got, nk.ntt_forward(lifted, ctx.ntt, p.rows_d))


@pytest.mark.parametrize("engine", ["mxu-pallas", "pallas-roll"])
def test_bfv_techniques_golden(dev, engine):
    """bfv_multech_n1024.npz through the kernels on each engine (BEHZ,
    HPSoverQ, leveled at two drops, the fused lift, decryptions, noise
    budgets) bit-equal to the JAX package's outputs and to the plain
    path."""
    res = chip_smoke.bfv_multech_golden(dev, (engine,))
    plain = chip_smoke.bfv_multech_golden(dev, (engine,), pp.PLAIN)
    for name, (got, want) in res.items():
        assert np.array_equal(got, want), name
        assert np.array_equal(got, plain[name][0]), name


@pytest.mark.parametrize("self_mul", [False, True], ids=["pass", "self_mul"])
@pytest.mark.parametrize("alpha,beta,k_data", [(2, 3, 5), (22, 2, 43)])
@pytest.mark.parametrize("logn", [10, 16])
def test_k4p_preconv(dev, logn, alpha, beta, k_data, self_mul):
    """K4's preconv form at the CKKS headline's shape (beta 2, k_out 65,
    alpha 22, a short last digit) and a small one, with garbage in the
    digit-own delta rows, which the kernel must not read, lazy [0, 2q)
    delta rows elsewhere (some words at 2q - 1) and the pair unpadded."""
    n = 1 << logn
    k_out = k_data + alpha
    ctx = make_context(EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, k_data),
        numth.get_primes(2 * n, 29, alpha)), device=dev)
    t = ctx.ntt
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn + alpha + self_mul)
    q = t.q.long().view(-1, 1)

    def res(shape, rows, lazy=1):
        return (torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
                % (lazy * q[:rows])).int()

    delta = torch.stack([res((k_out, n), k_out, 2) for _ in range(beta)])
    delta[..., :8] = (2 * q - 1).int()
    ref = delta.clone()
    for d in range(beta):
        lo, hi = d * alpha, min((d + 1) * alpha, k_data)
        delta[d, lo:hi] = torch.randint(-(1 << 31), 1 << 31, (hi - lo, n),
                                        generator=gen, device=dev).int()
    a = res((k_data, n), k_data)
    c2 = (a, a.roll(1, 1).contiguous()) if self_mul else a
    evk = torch.stack([torch.stack([res((k_out, n), k_out)
                                    for _ in range(2)])
                       for _ in range(beta)])
    before = mk.modup_ip_preconv.launches
    got = mk.modup_ip_preconv(delta, c2, evk, t, k_data=k_data, alpha=alpha)
    assert mk.modup_ip_preconv.launches == before + 1
    _same(got, mk.modup_ip_preconv_plain(ref, c2, evk, t, k_data=k_data,
                                         alpha=alpha))


@pytest.mark.parametrize("modup", ["auto", "xla-split"])
def test_bgv_step(dev, modup):
    """The BGV golden file's step on a modup route: the kernel path equals
    the plain path and the JAX package's output."""
    g = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "torch_port", "bgv_step_n1024.npz"))
    ctx = make_context(EncryptionParameters.create(
        g["d1"].shape[-1], g["data_moduli"].tolist(),
        g["special_moduli"].tolist(), "bgv", int(g["t"])), device=dev)
    p = convert.bgv_pipeline(ctx, g["rlk"], modup=modup)
    d1, d2 = (convert.residues(g[k]).to(dev) for k in ("d1", "d2"))
    got = p(d1, d2)
    _same(got, p(d1, d2, pp.PLAIN))
    assert np.array_equal(got.cpu().numpy().view(np.uint32), g["out"])


@pytest.mark.parametrize("case", ["ckks_chain", "bgv_chain", "encrypt_bfv",
                                  "combo", "verbs_ckks", "verbs_bfv",
                                  "verbs_bgv", "keygen_bgv"])
def test_fast32_golden(dev, case):
    """A Fast32 golden file (n = 1024) through the kernels and through the
    plain versions, both bit-equal to the JAX package's outputs."""
    got = chip_smoke.fast32_golden(dev, (case,))
    plain = chip_smoke.fast32_golden(dev, (case,), pp.PLAIN)
    for name, (x, want) in got.items():
        assert np.array_equal(x, want), name
        assert np.array_equal(plain[name][0], want), name


@pytest.mark.parametrize("scheme", ["ckks", "bgv", "bfv"])
def test_fast32_full_width_level(dev, scheme):
    """At N = 2^16, 43 data primes, alpha 22, chain index 1: keygen,
    encode, encrypt_asymmetric and every verb that runs a kernel, through
    the kernels bit-equal to the plain path (the generator's state
    replayed for the draws)."""
    from phantom_tpu_torch import BatchEncoder, CKKSEncoder, Fast32
    params = (chip_smoke.chain_params(**chip_smoke.HEADLINE)
              if scheme == "ckks" else
              chip_smoke.mod_t_params(**chip_smoke.BFV, scheme=scheme))
    ctx = make_context(params, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def both(fn, draws=False):
        state = gen.get_state()
        out = fn(pp.KERNELS)
        after = gen.get_state()
        if draws:
            gen.set_state(state)
        ref = fn(pp.PLAIN)
        gen.set_state(after)
        assert chip_smoke._same(out, ref)
        return out

    ev = Fast32(ctx)
    sk = both(lambda ops: ev.gen_secret_key(gen, ops), True)
    pk = both(lambda ops: ev.gen_public_key(sk, gen, ops), True)
    rlk = both(lambda ops: ev.gen_relin_key(sk, gen, ops), True)
    glk = both(lambda ops: ev.create_galois_keys(sk, gen, [1], ops=ops),
               True)
    ev = Fast32(ctx, rlk=rlk, glk=glk)
    rng = np.random.default_rng(7)
    if scheme == "ckks":
        enc = CKKSEncoder(ctx)
        z = chip_smoke.unit_disc(rng, enc.slots)
        pt = both(lambda ops: enc.encode(z, 2.0 ** 28, ops=ops))
    else:
        enc = BatchEncoder(ctx)
        vals = rng.integers(0, params.plain_modulus, params.n)
        pt = both(lambda ops: enc.encode(vals, ops))
    c = both(lambda ops: ev.encrypt_asymmetric(pk, pt, gen, ops), True)
    verbs = [lambda ops: ev.multiply_and_relin(c, c, ops),
             lambda ops: ev.square_and_relin(c, ops),
             lambda ops: ev.rotate(c, 1, ops),
             lambda ops: ev.mod_switch_to_next(c, ops),
             lambda ops: ev.relinearize(ev.multiply(c, c, ops), ops),
             lambda ops: ev.decrypt(sk, c, ops)]
    if scheme != "ckks":
        verbs.append(lambda ops: ev.multiply_plain(c, pt, ops))
    else:
        verbs.append(lambda ops: ev.rescale_to_next(c, ops))
    for fn in verbs:
        both(fn)
    both(lambda ops: enc.decode(ev.decrypt(sk, c, ops), ops))


@pytest.mark.parametrize("logn", [10, 16])
def test_fast32_coeff_rotation_k4c(dev, logn):
    """A BFV rotation in coefficient form launches K4c once and equals the
    plain path."""
    from phantom_tpu_torch import Ciphertext, Fast32
    from phantom_tpu_torch.host.modulus import PlainModulus
    n = 1 << logn
    ctx = make_context(EncryptionParameters.create(
        n, numth.get_primes(2 * n, 28, 5), numth.get_primes(2 * n, 29, 2),
        "bfv", PlainModulus.batching(n, 20)), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn)
    ev = Fast32(ctx)
    sk = ev.gen_secret_key(gen)
    ev = Fast32(ctx, glk=ev.create_galois_keys(sk, gen, [1, -3]))
    q = ctx.key_q[:5].long().view(-1, 1)
    c = Ciphertext((torch.randint(0, 1 << 62, (2, 5, n), generator=gen,
                                  device=dev) % q).int())
    for step in (1, -3):
        before = mk.modup_ip_coeff.launches
        got = ev.rotate(c, step)
        assert mk.modup_ip_coeff.launches == before + 1
        _same(got.data, ev.rotate(c, step, pp.PLAIN).data)

"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu` and skipped without a CUDA device.  The repo's conftest
imports JAX, which the port does not need; where JAX is not installed,
run these with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Every kernel at several sizes, with every option of its wrapper; the
tables are real NTT tables and the inputs seeded; bit-exact.  The u64
kernels U1-U4 at N = 2 to 2^17 with 50- and 61-bit primes (U2's
scale_round form at 1 to 63 input rows), the u64 golden files (BFV's
too) through them, and the roll engine's and the xla-bconv moddown's
golden file.  The BFV step
on both engines, BFV's other techniques and the fused lift, and the BGV
step on each modup route against the plain path and the golden files.
S1 (the reference's Salsa20 sampler) in its three forms, the wire
formats' golden file on the card and the StreamExecutor against direct
calls.
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


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("logn", [1, 3, 10, 11, 12, 16, 17])
def test_f1_fft(dev, logn, inverse):
    """F1 against the plain double-float FFT, word for word, on every split
    of the transform: all local (N <= 2^11), and 1 to 6 wide stages."""
    from phantom_tpu_torch.ops import ckks_fft as cf
    n = 1 << logn
    t = cf.make_fft_tables(n, dev)
    rng = np.random.default_rng(logn)
    v = rng.standard_normal((2, n)) * 2.0 ** rng.integers(-20, 50)
    x = torch.from_numpy(np.stack(cf.df_from_f64(v[0]) + cf.df_from_f64(
        v[1]))).to(dev)
    before = cf.ckks_fft.launches
    got = cf.ckks_fft(x, t, inverse)
    assert cf.ckks_fft.launches == before + 1
    want = cf.ckks_fft_plain(x, t, inverse)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _f1_primes(k: int):
    # 28-bit primes; get_primes needs 2N | q - 1, so take them for 2^17
    return torch.tensor(numth.get_primes(1 << 18, 28, k), dtype=torch.int32)


@pytest.mark.parametrize("logn", [1, 3, 10, 11, 12, 13, 16, 17])
def test_f1_encode_form(dev, logn):
    """F1's encode form against its plain version, word for word: full,
    partial and empty slot vectors with signed zeros, 43 primes (the
    headline chain's count) and 1; one launch a call."""
    from phantom_tpu_torch.ops import ckks_fft as cf
    n = 1 << logn
    t = cf.make_fft_tables(n, dev)
    rng = np.random.default_rng(logn)
    z = rng.standard_normal((n // 2, 2)) * 2.0 ** rng.integers(-10, 20)
    z[:3] = [[-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0]][:n // 2]
    for k in (43, 1):
        q = _f1_primes(k).to(dev)
        for count in sorted({n // 2, max(n // 3, 1), 0}):
            x = torch.from_numpy(z[:count].copy()).to(dev)
            before = cf.ckks_fft.launches
            got = cf.ckks_fft_encode(x, 2.0 ** 40, q, t)
            assert cf.ckks_fft.launches == before + 1
            want = cf.ckks_fft_encode_plain(x, 2.0 ** 40, q, t)
            assert torch.equal(got, want), (k, count)


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("logn", [1, 3, 10, 11, 12, 13, 16, 17])
def test_f1_decode_form(dev, logn, rows):
    """F1's decode form against its plain version, word for word, on
    uniform residues of one or two limbs; one launch a call."""
    from phantom_tpu_torch.ops import ckks_fft as cf
    n = 1 << logn
    t = cf.make_fft_tables(n, dev)
    moduli = _f1_primes(rows).tolist()
    rng = np.random.default_rng(logn + rows)
    x = torch.from_numpy(np.stack([rng.integers(0, q, n) for q in moduli])
                         ).int().to(dev)
    before = cf.ckks_fft.launches
    got = cf.ckks_fft_decode(x, moduli, 2.0 ** 30, t)
    assert cf.ckks_fft.launches == before + 1
    want = cf.ckks_fft_decode_plain(x, moduli, 2.0 ** 30, t)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize("form", ["forward", "inverse", "encode", "decode",
                                  "encode64", "decode64"])
@pytest.mark.parametrize("logn", [1, 11, 12, 16, 17])
def test_f1_grids(dev, logn, form):
    """The blocks of F1's CUDA launches as the library records them: one
    block up to N = 2^11; above, the column pass's 2^(lr-1) blocks and the
    row pass's 2^(lc-1), in the direction's order."""
    from phantom_tpu_torch.ops import ckks_fft as cf
    n = 1 << logn
    t = cf.make_fft_tables(n, dev)
    x = torch.zeros((4, n), device=dev)
    q = _f1_primes(3).to(dev)
    limbs = torch.zeros((2, n), dtype=torch.int32, device=dev)
    calls = {
        "forward": lambda: cf.ckks_fft(x, t),
        "inverse": lambda: cf.ckks_fft(x, t, inverse=True),
        "encode": lambda: cf.ckks_fft_encode(
            torch.zeros((n // 2, 2), dtype=torch.float64, device=dev),
            2.0 ** 30, q, t),
        "decode": lambda: cf.ckks_fft_decode(limbs, q[:2].tolist(),
                                             2.0 ** 30, t),
        "encode64": lambda: cf.ckks_fft_encode64(
            torch.zeros((n // 2, 2), dtype=torch.float64, device=dev),
            2.0 ** 30, q.long(), t),
        "decode64": lambda: cf.ckks_fft_decode64(limbs.long(), q[:2].tolist(),
                                                 2.0 ** 30, t)}
    want = [1]
    if logn > 11:
        lr = logn // 2
        want = [1 << (lr - 1), 1 << (logn - lr - 1)]  # columns, rows
        if form in ("inverse", "encode", "encode64"):
            want.reverse()
    assert chip_smoke.f1_grids(calls[form]) == want


def test_f1_golden(dev):
    for name, (got, want) in chip_smoke.fft_golden(dev).items():
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_f1_refuses_bad_operands(dev):
    from phantom_tpu_torch.ops import ckks_fft as cf
    t = cf.make_fft_tables(1024, dev)
    for x in (torch.zeros((4, 512), device=dev),
              torch.zeros((4, 1024), dtype=torch.float64, device=dev),
              torch.zeros((1024, 4), device=dev).t()):
        with pytest.raises(ValueError):
            cf.ckks_fft(x, t)


def test_device_encoder_golden(dev):
    """The device encoder through F1, K1 and K2 equals the JAX package's
    eager evaluation and holds the jitted one to +-1 and 1e-10."""
    exact, jitted = chip_smoke.encoder_golden(dev)
    for name, (got, want) in exact.items():
        np.testing.assert_array_equal(got, want, err_msg=name)
    for where, worst, dec in jitted.values():
        assert worst <= 1 and dec < 1e-10


@pytest.mark.parametrize("ci", [1, 7])
def test_device_encoder_full_width(dev, ci):
    """At N = 2^16 over 43 28-bit primes: the kernel path equals the plain
    path, encode at 2^28 is within +-1 of the host encoder and decodes
    within 1e-9 of the host decode; a round trip at 2^30 within 1e-6 (at
    2^28 the rounding alone leaves about 1e-6 in a slot)."""
    from phantom_tpu_torch import CKKSDeviceEncoder, CKKSEncoder
    ctx = make_context(chip_smoke.chain_params(**chip_smoke.HEADLINE),
                       device=dev)
    enc, host = CKKSDeviceEncoder(ctx), CKKSEncoder(ctx)
    z = chip_smoke.unit_disc(np.random.default_rng(ci), enc.slots)
    pt = enc.encode(z, 2.0 ** 28, ci)
    assert torch.equal(pt.data, enc.encode(z, 2.0 ** 28, ci,
                                           ops=pp.PLAIN).data)
    k = ctx.get_context_data(ci).size_ql
    c = [nk.ntt_inverse(p.data, ctx.ntt, ctx.rows_qp[:k])[0].cpu().numpy()
         for p in (pt, host.encode(z, 2.0 ** 28, ci))]
    assert chip_smoke._centered_diff(c[0], c[1],
                                     ctx.params.data_moduli[0]).max() <= 1
    dec = enc.decode(pt)
    np.testing.assert_array_equal(dec, enc.decode(pt, pp.PLAIN))
    assert np.abs(dec - host.decode(pt)).max() < 1e-9
    assert np.abs(enc.decode(enc.encode(z, 2.0 ** 30, ci)) - z).max() < 1e-6


def test_linear_and_poly_golden(dev):
    for got in (chip_smoke.linear_golden(dev), chip_smoke.poly_golden(dev)):
        for name, (a, b) in got.items():
            np.testing.assert_array_equal(a, b, err_msg=name)


def _f1_wide_primes(bits: int, k: int) -> list:
    # get_primes needs 2N | q - 1: take them for 2^17
    return numth.get_primes(1 << 18, bits, k)


@pytest.mark.parametrize("bits", [31, 50, 61])
@pytest.mark.parametrize("logn", [10, 11, 12, 13, 16, 17])
def test_f1_encode64_form(dev, logn, bits):
    """F1's wide encode form against its plain version, word for word, over
    1, 43 and 65 primes: random slots at scales that take the coefficients
    near 2^62, of both signs; constant slots that put coefficient 0 at 0,
    +-1, about +-(q - 1), +-q and +-(2^62 - 2^40); partial and empty slot
    vectors; one launch a call."""
    from phantom_tpu_torch.ops import ckks_fft as cf
    n = 1 << logn
    t = cf.make_fft_tables(n, dev)
    qs = _f1_wide_primes(bits, 65)
    rng = np.random.default_rng(logn + bits)
    z = rng.uniform(-1, 1, (n // 2, 2))
    ones = np.ones((n // 2, 2)) * [1.0, 0.0]
    cases = [(z, 2.0 ** 61), (z[:n // 3], 2.0 ** 61), (z[:0], 2.0 ** 61),
             (z, 2.0 ** 30)]
    for scale in (1.0, float(qs[0] - 1), float(qs[0]), 2.0 ** 62 - 2.0 ** 40):
        cases += [(ones, scale), (-ones, scale)]
    cases.append((0 * ones, 1.0))
    for k in (1, 43, 65):
        q = torch.tensor(qs[:k], dtype=torch.int64, device=dev)
        for vals, scale in cases:
            x = torch.from_numpy(np.ascontiguousarray(vals)).to(dev)
            before = cf.ckks_fft.launches
            got = cf.ckks_fft_encode64(x, scale, q, t)
            assert cf.ckks_fft.launches == before + 1
            want = cf.ckks_fft_encode64_plain(x, scale, q, t)
            assert torch.equal(got, want), (k, scale, len(vals))


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("bits", [(31, 31), (40, 30), (50, 50), (61, 61)])
@pytest.mark.parametrize("logn", [10, 11, 12, 13, 16, 17])
def test_f1_decode64_form(dev, logn, bits, rows):
    """F1's wide decode form against its plain version, word for word, on
    the residues of centered values of both signs up to Garner's range
    (2^62 for 61-bit primes), one limb or two; uniform residues decode
    without raising; one launch a call."""
    from phantom_tpu_torch.ops import ckks_fft as cf
    n = 1 << logn
    t = cf.make_fft_tables(n, dev)
    moduli = [_f1_wide_primes(bits[0], 1)[0],
              _f1_wide_primes(bits[1], 2)[-1]][:rows]
    top = moduli[0] // 2 if rows == 1 else min(
        moduli[0] * (moduli[1] - 1) // 2, 1 << 62)
    rng = np.random.default_rng(logn + bits[0] + rows)
    m = [int(v) * top // (1 << 62) for v in rng.integers(
        -(1 << 62), 1 << 62, n)]
    m[:4] = [top, -top, 0, -1]
    x = torch.tensor([[v % q for v in m] for q in moduli], dtype=torch.int64,
                     device=dev)
    before = cf.ckks_fft.launches
    got = cf.ckks_fft_decode64(x, moduli, 2.0 ** 40, t)
    assert cf.ckks_fft.launches == before + 1
    want = cf.ckks_fft_decode64_plain(x, moduli, 2.0 ** 40, t)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    q = torch.tensor(moduli, dtype=torch.int64, device=dev).view(-1, 1)
    junk = torch.randint(0, 1 << 62, (rows, n), device=dev) % q
    assert cf.ckks_fft_decode64(junk, moduli, 2.0 ** 40, t).shape == (
        n // 2, 2)


def test_wide_encoder_golden_on_the_card(dev):
    """ckks_fft_wide.npz through F1's wide forms and U1 on the card, bit
    for bit."""
    for name, (got, want) in chip_smoke.wide_encoder_golden(dev).items():
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("fname", chip_smoke.U64_APP_GOLDEN)
def test_u64_app_golden_on_the_card(dev, fname):
    """LinearTransform.apply, poly_eval and poly_eval_cheb on the u64
    evaluator through U1-U4 on the card, bit-equal to the JAX package's."""
    fn = (chip_smoke.u64_linear_golden if "linear" in fname
          else chip_smoke.u64_poly_golden)
    assert fn(dev) == (14 if "linear" in fname else 6)


# ---------------------------------------------------------------------------
# the u64 kernels U1-U4, the u64 golden files, the roll engine and the
# xla-bconv moddown
# ---------------------------------------------------------------------------

U64_LOGNS = [1, 10, 11, 12, 13, 16, 17]
PLAIN_T = 1179649  # a 21-bit prime == 1 mod 2^17: BGV's conversion to {t}


def _u64_setup(dev, logn, bits):
    """Tables of two primes of `bits` bits and one of 50, seeded u64
    inputs (in [0, q) or [0, 2q))."""
    from phantom_tpu_torch.host import ntt_tables
    from phantom_tpu_torch.ops import ntt as u1
    from phantom_tpu_torch.ops.rns_host import i64_tensor, modulus_vec
    n = 1 << logn
    qs = numth.get_primes(max(2 * n, 2048), bits, 2) + numth.get_primes(
        max(2 * n, 2048), 50, 1)
    t = u1.NTTTables64(ntt_tables.make_rns_ntt_tables(n, qs)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn * 100 + bits)
    q = i64_tensor(qs, dev).view(-1, 1)

    def res(lead, lazy=False):
        r = torch.randint(0, 1 << 62, lead + (3, n), generator=gen,
                          device=dev)
        return r % ((2 if lazy else 1) * q)
    return qs, t, res, modulus_vec(qs, dev)


@pytest.mark.parametrize("bits", [50, 61])
@pytest.mark.parametrize("logn", U64_LOGNS)
def test_u1_ntt(dev, logn, bits):
    from phantom_tpu_torch.ops import ntt as u1
    from phantom_tpu_torch.ops.rns_host import i64_tensor
    qs, t, res, _ = _u64_setup(dev, logn, bits)
    x, xi = res((2,)), res((2,), lazy=True)
    assert torch.equal(u1.ntt_forward(x, t), u1.ntt_forward_plain(x, t))
    assert torch.equal(u1.ntt_inverse(xi, t), u1.ntt_inverse_plain(xi, t))
    rows = torch.tensor([2, 0, 1], dtype=torch.int32, device=dev)
    sc = i64_tensor([3, 5, 7], dev)
    scs = i64_tensor([(s << 64) // qs[r] for s, r in zip((3, 5, 7),
                                                          (2, 0, 1))], dev)
    xr = xi[:, [2, 0, 1]].contiguous()  # limb l's words in [0, 2 q_rows[l])
    assert torch.equal(u1.ntt_inverse(xr, t, rows, sc, scs),
                       u1.ntt_inverse_plain(xr, t, rows, sc, scs))
    assert torch.equal(u1.ntt_forward(x[:, [2, 0, 1]].contiguous(), t, rows),
                       u1.ntt_forward(x, t)[:, [2, 0, 1]])


@pytest.mark.parametrize("logn", range(1, 18))
def test_u1_every_n(dev, logn):
    """U1 both ways at every N from 2 to 2^17 (each geometry of
    ops/ntt.py u64_geometry: one block up to 2^13, then 2, 4, 8 blocks a
    row), 61-bit primes."""
    from phantom_tpu_torch.ops import ntt as u1
    _, t, res, _ = _u64_setup(dev, logn, 61)
    x, xi = res((2,)), res((2,), lazy=True)
    assert torch.equal(u1.ntt_forward(x, t), u1.ntt_forward_plain(x, t))
    assert torch.equal(u1.ntt_inverse(xi, t), u1.ntt_inverse_plain(xi, t))


@pytest.mark.parametrize("form", ["approx", "reduce", "exact"])
@pytest.mark.parametrize("bits", [50, 61])
@pytest.mark.parametrize("logn", [10, 16])
def test_u2_bconv(dev, logn, bits, form):
    from phantom_tpu_torch import host
    from phantom_tpu_torch.ops import bconv as u2
    n = 1 << logn
    ib = numth.get_primes(2 * n, bits, 22)
    ob = numth.get_primes(2 * n, 50, 43) + [PLAIN_T]
    conv = u2.consts_from_host(host.BaseConverter(
        host.RNSBase(ib), host.RNSBase(ob)), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn)
    x = torch.randint(0, 1 << 62, (22, n), generator=gen, device=dev) \
        % conv.ibase.q.view(-1, 1)
    assert torch.equal(u2.bconv(x, conv, form), u2.bconv_plain(x, conv, form))


@pytest.mark.parametrize("form", ["approx", "reduce", "exact"])
@pytest.mark.parametrize("k_in, k_out, m", [
    (63, 44, 1 << 12),   # the largest 128-bit sum: 63 products of 61 bits
    (63, 1, 3 * 1000),   # to {t} alone, a ragged M
    (22, 1, 3 * 1000),
    (22, 43, 3 * 1000),
    (1, 3, 65)])
def test_u2_bconv_shapes(dev, k_in, k_out, m, form):
    """U2 at k_in = 63 with 61-bit primes, at k_out = 1 (BGV's {t}) and
    at an M that is not a multiple of the kernel's 64-column tile, in
    every form; the columns of all q_i - 1 and of zeros included."""
    from phantom_tpu_torch import host
    from phantom_tpu_torch.ops import bconv as u2
    ib = numth.get_primes(2048, 61, k_in)
    ob = numth.get_primes(2048, 50, k_out - 1) + [PLAIN_T]
    conv = u2.consts_from_host(host.BaseConverter(
        host.RNSBase(ib), host.RNSBase(ob)), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(k_in * 1000 + m)
    q = conv.ibase.q.view(-1, 1)
    x = torch.randint(0, 1 << 62, (k_in, m), generator=gen, device=dev) % q
    x[:, :7] = q - 1
    x[:, 7:9] = 0
    assert torch.equal(u2.bconv(x, conv, form), u2.bconv_plain(x, conv, form))


def test_u2_refuses_64_rows(dev):
    """k_in = 64 could wrap the 128-bit sum: the wrapper raises."""
    from phantom_tpu_torch import host
    from phantom_tpu_torch.ops import bconv as u2
    conv = u2.consts_from_host(host.BaseConverter(
        host.RNSBase(numth.get_primes(2048, 61, 64)),
        host.RNSBase([PLAIN_T])), dev)
    x = torch.zeros((64, 128), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        u2.bconv(x, conv, "approx")


def _scale_round(dev, k_in, k_out, m, seed):
    """A v-free scale-and-round from k_in 61-bit primes to k_out others
    (num = their product, den = the first half of the input primes') and
    seeded input words, the first columns all d_i - 1 and zeros."""
    from phantom_tpu_torch.ops import scaleround
    primes = numth.get_primes(1 << 18, 61, k_in + k_out)
    ib, ob = primes[:k_in], primes[k_in:]
    num = den = 1
    for p in ob:
        num *= p
    for d in ib[:k_in // 2]:
        den *= d
    c = scaleround.make_exact_scale_round(ib, num, den, ob, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = c.ibase.q.view(-1, 1)
    x = torch.randint(0, 1 << 62, (k_in, m), generator=gen, device=dev) % q
    x[:, :min(m, 3)] = q - 1
    x[:, 3:5] = 0
    return c, x


@pytest.mark.parametrize("k_out", [1, 31, 32])
@pytest.mark.parametrize("k_in", [1, 2, 17, 31, 62, 63])
@pytest.mark.parametrize("logn", [1, 6, 10, 13, 16, 17])
def test_u2_scale_round(dev, logn, k_in, k_out):
    """U2's scale_round form bit-equal to its plain version at N = 2 to
    2^17 columns, 1 to 63 input rows of 61-bit primes, 1, 31 and 32
    output rows."""
    from phantom_tpu_torch.ops import bconv as u2
    c, x = _scale_round(dev, k_in, k_out, 1 << logn, logn * 100 + k_in)
    assert torch.equal(u2.bconv(x, c, "scale_round"),
                       u2.bconv_plain(x, c, "scale_round"))


def test_u2_approx_to_mtilde(dev):
    """U2's approximate form to the modulus 2^32 (BEHZ's m_tilde, not a
    prime: Barrett words 2^32 and 0, 2^64 mod 2^32 = 0) and to Bsk, at
    the BFV u64 width (31 rows of 50 bits), bit-equal to plain."""
    from phantom_tpu_torch import host
    from phantom_tpu_torch.ops import bconv as u2
    ib = numth.get_primes(1 << 17, 50, 31)
    for ob in ([1 << 32], numth.get_primes(1 << 17, 61, 32)):
        conv = u2.consts_from_host(host.BaseConverter(
            host.RNSBase(ib), host.RNSBase(ob)), dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(len(ob))
        q = conv.ibase.q.view(-1, 1)
        x = torch.randint(0, 1 << 62, (31, 1 << 16), generator=gen,
                          device=dev) % q
        x[:, :3] = q - 1
        assert torch.equal(u2.bconv(x, conv, "approx"),
                           u2.bconv_plain(x, conv, "approx"))


def test_u2_scale_round_one_launch_refuses_64_rows(dev):
    """Each scale_round call is one kernel launch (the library's count);
    64 input rows are refused before any launch."""
    from phantom_tpu_torch import _build
    from phantom_tpu_torch.ops import bconv as u2
    from phantom_tpu_torch.ops import scaleround
    lib = _build.library()
    c, x = _scale_round(dev, 63, 32, 1 << 16, 7)
    before, calls = lib.ptk_u64_bconv_launches(), u2.bconv.launches
    for _ in range(3):
        scaleround.scale_and_round_exact(x, c)
    torch.cuda.synchronize()
    assert lib.ptk_u64_bconv_launches() - before == 3
    assert u2.bconv.launches - calls == 3
    primes = numth.get_primes(1 << 11, 61, 65)
    c = scaleround.make_exact_scale_round(primes[:64], primes[64], 1,
                                          primes[64:], dev)
    with pytest.raises(ValueError, match="at most 63"):
        scaleround.scale_and_round_exact(
            torch.zeros((64, 128), dtype=torch.int64, device=dev), c)
    assert u2.bconv.launches - calls == 3


@pytest.mark.parametrize("fname", chip_smoke.U64_BFV_GOLDEN)
def test_u64_bfv_golden_on_the_card(dev, fname):
    """Every output of a BFV u64 golden file through U1-U4 on the card."""
    assert chip_smoke.u64_bfv_golden(dev, fname) >= 45


@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("bits", [50, 61])
@pytest.mark.parametrize("logn", [10, 16])
def test_u3_inner_product(dev, logn, bits, perm):
    from phantom_tpu_torch.schemes import keyswitch as ksw
    qs, _, res, mv = _u64_setup(dev, logn, bits)
    t, evk = res((2,)), res((2, 2))
    pow64 = torch.tensor([((1 << 64) % q) for q in qs], device=dev)
    pm = (torch.randperm(1 << logn, device=dev).int() if perm else None)
    assert torch.equal(
        ksw.inner_product_evk_kernel(t, evk, *mv, pow64, pm),
        ksw.inner_product_evk_plain(t, evk, *mv, pow64, pm))


@pytest.mark.parametrize("bits", [50, 61])
@pytest.mark.parametrize("logn", [1, 10, 16, 17])
def test_u4_products(dev, logn, bits):
    """Every U4 form bit-equal to its plain version: the products (b
    broadcast and whole), the m x n product, the Shoup form with and
    without s and c (a and c strided, into an out slot), a (..., 1, N) row
    of any words into 1 and 63 limbs, and the rescale's and BGV's row
    forms."""
    from phantom_tpu_torch.ops import polyops as u4
    from phantom_tpu_torch.ops.rns_host import i64_tensor
    qs, _, res, mv = _u64_setup(dev, logn, bits)
    n = 1 << logn
    a, b, c = res((2,)), res((2,)), res((2,))
    a[..., :1] = mv.q.view(-1, 1) - 1
    assert torch.equal(u4.mul_rns(a, b, mv), u4.mul_rns_plain(a, b, mv))
    assert torch.equal(u4.mul_rns(a, b[0], mv),
                       u4.mul_rns_plain(a, b[0], mv))
    assert torch.equal(u4.fma_rns(a, b, c, mv),
                       u4.fma_rns_plain(a, b, c, mv))
    assert torch.equal(u4.tensor_prod_2x2(a, b, mv),
                       u4.tensor_prod_2x2_plain(a, b, mv))
    assert torch.equal(u4.tensor_square_2x2(a, mv),
                       u4.tensor_square_2x2_plain(a, mv))
    for m, k in ((3, 2), (3, 3), (2, 3)):
        x, y = res((m,)), res((k,))
        assert torch.equal(u4.tensor_prod_mxn(x, y, mv),
                           u4.tensor_prod_mxn_plain(x, y, mv))
    # one row of any 64-bit words read for every limb, times w and mod q
    lw = u4.limbs(qs, w=[q // 3 for q in qs], device=dev)
    x = (a[:, :1] << 3) ^ b[:, 2:]
    for lx in (lw, u4.limbs(qs, device=dev)):
        got = u4.shoup_rns(x, lx)
        assert got.shape == a.shape
        assert torch.equal(got, u4.shoup_rns_plain(x, lx))
    # (a - s) w + c, a and c read in place from (2, 6, N) tensors
    wide = torch.cat([res((2,)), res((2,))], 1)
    for aa in (a, wide[:, 3:]):
        for s in (None, b):
            for cc in (None, c, wide[:, :3]):
                assert torch.equal(u4.shoup_rns(aa, lw, s, cc),
                                   u4.shoup_rns_plain(aa, lw, s, cc))
    out = torch.empty((2, 3, n), dtype=torch.int64, device=dev)
    assert u4.shoup_rns(a[0], lw, b[0], c[0], out[1]).data_ptr() == \
        out[1].data_ptr()
    assert torch.equal(out[1], u4.shoup_rns_plain(a[0], lw, b[0], c[0]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(logn + bits)
    t = PLAIN_T
    for num_l in (1, 63):
        qr = numth.get_primes(max(2 * n, 2048), bits, num_l + 1)
        qlast, qr = qr[-1], qr[:-1]
        q = i64_tensor(qr, dev).view(-1, 1)
        row = torch.randint(-(1 << 62), 1 << 62, (2, 1, n), generator=gen,
                            device=dev) * 3
        xl = row.abs() % qlast
        lr = u4.limbs(qr, w=[v // 5 for v in qr], e=[v // 3 for v in qr],
                      scalars=(qlast, qlast >> 1), device=dev)
        assert torch.equal(u4.shoup_rns(row, lr), u4.shoup_rns_plain(row, lr))
        assert torch.equal(u4.rescale_delta(xl, lr),
                           u4.rescale_delta_plain(xl, lr))
        nq = 4321 % t
        lm = u4.limbs(qr, w=[qlast % v for v in qr],
                      scalars=(t, nq, (nq << 64) // t), device=dev)
        assert torch.equal(u4.modswitch_delta(row, lm),
                           u4.modswitch_delta_plain(row, lm))
        ld = u4.limbs(qr, w=[v // 7 for v in qr], e=[v // 11 for v in qr],
                      scalars=(t, 999, nq, (nq << 64) // t), device=dev)
        dq = torch.randint(0, 1 << 62, (num_l, n), generator=gen,
                           device=dev) % q
        dt = torch.randint(0, t, (1, n), generator=gen, device=dev)
        assert torch.equal(u4.moddown_delta(dq, dt, ld),
                           u4.moddown_delta_plain(dq, dt, ld))


def test_u4_one_launch_a_call(dev):
    """Each U4 wrapper call is one kernel launch (the library's count)."""
    from phantom_tpu_torch import _build
    from phantom_tpu_torch.ops import polyops as u4
    qs, _, res, mv = _u64_setup(dev, 12, 61)
    a, b = res((2,)), res((2,))
    lw = u4.limbs(qs, device=dev)
    lib = _build.library()
    before, calls = lib.ptk_u64_polyops_launches(), u4.mul_rns.launches
    u4.tensor_prod_2x2(a, b, mv)
    u4.shoup_rns(a, lw, b, a)
    u4.rescale_delta(a[:, :1], u4.limbs(qs[:2], scalars=(qs[2], 5),
                                        device=dev))
    torch.cuda.synchronize()
    assert lib.ptk_u64_polyops_launches() - before == 3
    assert u4.mul_rns.launches - calls == 3


def test_u4_refuses_bad_layout(dev):
    """U4 refuses an operand whose rows are not contiguous, a misaligned
    one and groups that are not one stride; nothing launches."""
    from phantom_tpu_torch.ops import polyops as u4
    qs, _, res, mv = _u64_setup(dev, 10, 50)
    a = res((2,))
    lw = u4.limbs(qs, device=dev)
    wide = torch.cat([a, a], -1)
    odd = torch.empty(2 * 3 * 1024 + 1, dtype=torch.int64,
                      device=dev)[1:].view(2, 3, 1024)
    launches = u4.mul_rns.launches
    for bad in (lambda: u4.mul_rns(wide[..., ::2], a, mv),
                lambda: u4.mul_rns(a, wide[..., ::2], mv),
                lambda: u4.fma_rns(a, a, wide[..., ::2], mv),
                lambda: u4.shoup_rns(a, lw, wide[..., ::2]),
                lambda: u4.shoup_rns(odd, lw),
                lambda: u4.tensor_square_2x2(a.transpose(0, 1), mv),
                lambda: u4.shoup_rns(
                    torch.cat([res((3, 2)), res((3, 2))], 1)[:, :2], lw)):
        with pytest.raises(ValueError):
            bad()
    assert u4.mul_rns.launches == launches


@pytest.mark.parametrize("fname", chip_smoke.U64_GOLDEN)
def test_u64_golden_on_the_card(dev, fname):
    """Every output of the u64 golden file through U1-U4 on the card."""
    assert chip_smoke.u64_golden(dev, fname) > 40


def test_roll_and_xla_moddown_golden_on_the_card(dev):
    """roll_n1024.npz through K6, K5, K9 (roll engine) and K1, K5, K2
    (the xla-bconv moddown) on the card."""
    for name, (got, want) in chip_smoke.roll_golden(dev).items():
        np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# the runtime and utils layer: S1, the wire formats, the StreamExecutor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", chip_smoke.SALSA_FORMS)
@pytest.mark.parametrize("bits", chip_smoke.SALSA_BITS)
@pytest.mark.parametrize("logn,limbs", [(3, 1), (10, 5), (16, 43)])
def test_s1_forms(dev, logn, limbs, bits, form):
    """S1's three forms against the plain version on the card, bit for
    bit, at N = 8 to 2^16 over 28-, 50- and 61-bit primes (the 61-bit ones
    reject about one lane in nine); one launch a call."""
    from phantom_tpu_torch.ops.rns_host import modulus_vec
    from phantom_tpu_torch.utils import salsa20
    n = 1 << logn
    qs = (chip_smoke.rejecting_primes(max(n, 8), limbs) if bits == 61
          else numth.get_primes(2 * max(n, 512), bits, limbs))
    mv = modulus_vec(qs, dev)
    seed = bytes(range(logn, logn + 64))
    launches = salsa20.sample.launches
    got = salsa20.sample(form, seed, mv, n)
    torch.cuda.synchronize()
    assert salsa20.sample.launches == launches + 1
    assert got.shape == (limbs, n) and got.device.type == "cuda"
    assert torch.equal(got, salsa20.sample_plain(form, seed, mv, n))


def test_s1_refuses_bad_operands(dev):
    """The uniform form refuses N not a multiple of 8; int32 moduli are
    refused; nothing launches."""
    from phantom_tpu_torch.ops.rns_host import ModulusVec, modulus_vec
    from phantom_tpu_torch.utils import salsa20
    mv = modulus_vec(numth.get_primes(2048, 50, 2), dev)
    launches = salsa20.sample.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        salsa20.sample("uniform", bytes(64), mv, 1020)
    with pytest.raises(ValueError, match="int64"):
        salsa20.sample("ternary", bytes(64), ModulusVec(
            mv.q.int(), mv.ratio_lo, mv.ratio_hi.int()), 1024)
    assert salsa20.sample.launches == launches


def test_wire_golden_on_the_card(dev):
    """refformat_n1024.npz on the card: the JAX package's Salsa20 samples
    through S1, and its blobs loaded (seeded ones through S1 and U1),
    saved again byte for byte, hashed in the port's own format, decrypted
    and multiplied, bit-equal."""
    assert chip_smoke.salsa_golden(dev) == 9
    assert chip_smoke.wire_golden(dev) == 9


def test_executor_against_direct_calls(dev):
    """StreamExecutor on the side CUDA stream: the CKKS step over 7 items in
    batches of 3 (a tail of 1) bit-equal, in order, to direct calls, and
    the outputs usable on the caller's stream after result()."""
    from phantom_tpu_torch.runtime import StreamExecutor
    ctx = make_context(chip_smoke.chain_params(1024, 5, 2), device=dev)
    sk, pipe, d1, d2, _, _ = chip_smoke.make_step_inputs(ctx, 5, 20, dev)
    pairs = [(d1, d2), (d2, d1), (d1, d1)] * 2 + [(d2, d2)]
    want = [pp.mult_relin_rescale32(pipe, a, b) for a, b in pairs]
    ex = StreamExecutor(pp.mult_relin_rescale32, pipe, batch=3)
    handles = [ex.submit(a, b) for a, b in pairs]
    ex.flush()
    outs = [h.result() for h in handles]
    total = sum(o.long().sum() for o in outs)  # on the caller's stream
    torch.cuda.synchronize()
    assert all(torch.equal(o, w) for o, w in zip(outs, want))
    assert int(total) == int(sum(w.long().sum() for w in want))
    assert (ex.stats.items, ex.stats.batches, ex.stats.padded_lanes) == (
        7, 3, 0)
    assert ex.throughput() > 0


def test_executor_against_jax_golden(dev):
    """ckks_step_n1024.npz's d1, d2 and relin key on the card: six items
    in batches of 4 (a tail of 2) through a StreamExecutor and through
    pipeline_map, both on the one shared side stream, each output
    bit-equal to the JAX package's."""
    from phantom_tpu_torch.runtime import StreamExecutor, pipeline_map
    from phantom_tpu_torch.runtime.executor import side_stream
    g = np.load(chip_smoke.GOLDEN)
    ctx = make_context(EncryptionParameters.create(
        int(g["d1"].shape[-1]), g["data_moduli"].tolist(),
        g["special_moduli"].tolist()), device=dev)
    pipe = pp.build_pipeline32(ctx, convert.residues(g["rlk"]).to(dev))
    d1, d2 = (convert.residues(g[k]).to(dev) for k in ("d1", "d2"))
    pairs = [(d1, d2)] * 6
    ex = StreamExecutor(pp.mult_relin_rescale32, pipe, batch=4)
    outs = ex.map(pairs) + pipeline_map(pp.mult_relin_rescale32, pipe,
                                        pairs, batch=4)
    torch.cuda.synchronize()
    assert side_stream(d1.device) is side_stream(d1.device)
    for o in outs:
        np.testing.assert_array_equal(o.cpu().numpy().view(np.uint32),
                                      g["out"])


# ---------------------------------------------------------------------------
# P1 and the coefficient-sharded steps (phantom_tpu_torch.parallel)
# ---------------------------------------------------------------------------

P1_ROWS = 65
P1_LOGN = (10, 13, 16)


@pytest.fixture(scope="module")
def p1_tables():
    """Sharded u32 and u64 tables of 65 primes (28 and 50 bits) at N =
    2^10, 2^13 (n1 = 64, n2 = 128) and 2^16, on the card, by (word,
    log2 N)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phantom_tpu_torch.host.ntt_tables import make_rns_ntt_tables
    from phantom_tpu_torch.ops import ntt as ntt64
    from phantom_tpu_torch.ops import ntt32
    from phantom_tpu_torch.parallel import ntt_sharded as ns
    dev = torch.device("cuda")
    out = {}
    for logn in P1_LOGN:
        n = 1 << logn
        t32 = ntt32.NTTTables32(make_rns_ntt_tables(
            n, numth.get_primes(2 * n, 28, P1_ROWS))).to(dev)
        t64 = ntt64.NTTTables64(make_rns_ntt_tables(
            n, numth.get_primes(2 * n, 50, P1_ROWS))).to(dev)
        out[4, logn] = ns.prepare_sharded_tables32(t32)
        out[8, logn] = ns.prepare_sharded_tables(t64)
    return out


def _p1_case(t, rows, word, phase, inverse, world, seed):
    """P1 against its plain version on seeded inputs over the phase's
    whole range ([0, q) into the forward, [0, 4q) between its phases,
    [0, 2q) into the inverse), on the layouts of a rank of `world` (col0
    of rank world // 2); the inverse's last phase with N^-1 and with a
    caller's scale.  One launch a call."""
    from phantom_tpu_torch.parallel import ntt_sharded as ns
    dev = rows.device
    num_l = rows.numel()
    _, _, shape, _ = ns.phase_layout(t, phase, inverse, num_l, world)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = t.q[rows.long()].long() & ((1 << 8 * word) - 1)
    span = 1 if (phase == "A" and not inverse) else (2 if inverse else 4)
    shp = [1] * len(shape)
    shp[-3 if len(shape) == 3 else 1] = num_l
    x = torch.randint(0, 1 << 62, shape, generator=gen, device=dev) % (
        span * q.view(shp))
    if word == 4:
        x = torch.where(x >= 1 << 31, x - (1 << 32), x).int()
    col0 = (world // 2) * (t.n1 // world)
    scales = [None]
    if inverse and phase == "A":  # a caller's factor and its Shoup word
        from phantom_tpu_torch.ops.ntt32 import u32_tensor
        from phantom_tpu_torch.ops.rns_host import i64_tensor
        rng = np.random.default_rng(word)
        qs = [int(v) for v in q.cpu()]
        sc = [int(rng.integers(1, v)) for v in qs]
        scs = [(a << 8 * word) // v for a, v in zip(sc, qs)]
        conv = u32_tensor if word == 4 else i64_tensor
        scales.append((conv(sc).to(dev), conv(scs).to(dev)))
    for s in scales:
        kw = {} if s is None else dict(scale=s[0], scale_shoup=s[1])
        launches = ns.ntt_phase.launches
        got = ns.ntt_phase(x, t, rows, phase, inverse, world, col0, **kw)
        assert ns.ntt_phase.launches == launches + 1
        want = ns.ntt_phase_plain(x, t, rows, phase, inverse, world, col0,
                                  **kw)
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("logn", P1_LOGN)
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("inverse", [False, True],
                         ids=["forward", "inverse"])
@pytest.mark.parametrize("phase", ["A", "B"])
@pytest.mark.parametrize("word", [4, 8], ids=["u32", "u64"])
def test_p1_ntt_phase(dev, p1_tables, word, phase, inverse, world, logn):
    """P1 against its plain version on 65 rows (their table rows
    permuted), each word, phase and direction, at N = 2^10 (R = 32, down
    to 8 columns a rank), 2^13 (n1 != n2) and 2^16, on the layouts of one
    rank, of a rank of two and of a rank of four."""
    rows = ((torch.arange(P1_ROWS) * 7) % P1_ROWS).int().to(dev)
    _p1_case(p1_tables[word, logn], rows, word, phase, inverse, world,
             word * 100 + world * 10 + logn)


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("inverse", [False, True],
                         ids=["forward", "inverse"])
@pytest.mark.parametrize("phase", ["A", "B"])
@pytest.mark.parametrize("word", [4, 8], ids=["u32", "u64"])
@pytest.mark.parametrize("limbs", ["folded", "small"])
def test_p1_ntt_phase_rows(dev, p1_tables, limbs, word, phase, inverse,
                           world):
    """P1 at N = 2^16 on the calls of the sharded steps that differ from
    test_p1_ntt_phase's: folded groups, two polynomials of 65 limbs
    whose table rows repeat (130 limbs, ntt_sharded._fold), and the
    rescale's small call of two limbs, which takes narrower tiles
    (ntt_phase_kernels.tile_cols)."""
    rows = (torch.arange(P1_ROWS).repeat(2) if limbs == "folded"
            else torch.tensor([P1_ROWS - 1, 0])).int().to(dev)
    _p1_case(p1_tables[word, 16], rows, word, phase, inverse, world,
             word * 10 + world)


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world of one over NCCL (a FileStore under tmp_path) and its
    mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from phantom_tpu_torch.parallel import make_coeff_mesh
    torch.cuda.set_device(0)
    path = str(tmp_path_factory.mktemp("nccl") / "store")
    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    try:
        yield make_coeff_mesh()
    finally:
        dist.destroy_process_group()


SHARDED_SMALL = {"u32 CKKS": dict(scheme="ckks", limbs=5, alpha=2, bits=28),
                 "u64 CKKS": dict(scheme="ckks", limbs=5, alpha=2, bits=50),
                 "u64 BGV": dict(scheme="bgv", limbs=5, alpha=2, bits=50),
                 "u64 BFV": dict(scheme="bfv", limbs=5, alpha=2, bits=50)}


@pytest.mark.parametrize("logn", [12, 16])
@pytest.mark.parametrize("what", list(SHARDED_SMALL))
def test_sharded_step_nccl(nccl_mesh, what, logn):
    """Each batched sharded step (build_sharded_step32 or
    build_sharded_step, a batch of one) at W = 1 over NCCL (P1, the
    all-to-alls through NCCL, K5 and K9 or U2-U4) bit-equal to the local
    kernel step and to the sharded step on the plain versions, on seeded
    uniform operands (five data primes, alpha 2, a short last digit)."""
    from phantom_tpu_torch.ops import pipeline32 as pp_
    from phantom_tpu_torch.parallel import launch, ntt_sharded as ns
    from phantom_tpu_torch.parallel.mesh import shard_coeff
    from phantom_tpu_torch.schemes import keyswitch as ksw
    ctx, step, local, d1, d2, b1, b2 = launch.step_setup(
        what, nccl_mesh, logn, 1 << logn, SHARDED_SMALL[what])
    plain = ksw.PLAIN64 if ctx.wide else pp_.PLAIN
    launches, calls = ns.ntt_phase.launches, ns.exchange.calls
    got = step(b1, b2)
    assert ns.ntt_phase.launches - launches == 12
    assert ns.exchange.calls - calls == 12
    assert got.shape[0] == 1
    assert torch.equal(got[0], shard_coeff(local(d1, d2), nccl_mesh))
    assert torch.equal(got, step(b1, b2, plain))


# ---------------------------------------------------------------------------
# the ("dp", "limb") layout and the bench setup (phantom_tpu_torch.parallel,
# phantom_tpu_torch.utils)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_limb_mesh(nccl_mesh):
    """The limb mesh of the same world of one over NCCL."""
    from phantom_tpu_torch.parallel import make_mesh
    return make_mesh()


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_limb_golden_nccl(nccl_limb_mesh, route):
    """limb_n1024.npz (the JAX package's limb-sharded step on dp 2 x limb
    4, alpha 4 and 3) replayed at W = 1 over NCCL, both items on the rank:
    bit-equal through U1-U4 (which launch) and through PLAIN64 (which
    launch none)."""
    from phantom_tpu_torch.ops import ntt
    from phantom_tpu_torch.schemes import keyswitch as ksw
    ops = ksw.KERNELS64 if route == "kernels" else ksw.PLAIN64
    before = ntt.ntt_forward.launches
    out = chip_smoke.limb_golden(nccl_limb_mesh, ops)
    launched = ntt.ntt_forward.launches - before
    assert launched == (30 if route == "kernels" else 0)  # 7 a step at
    # alpha 4 (two digits), 8 at alpha 3 (three), two items each
    for alpha, (got, want) in out.items():
        np.testing.assert_array_equal(got, want, err_msg=f"alpha {alpha}")


def test_setup_bench_card(dev, tmp_path, monkeypatch):
    """setup_bench on the card at n = 1024 (CKKS, two data primes of 50
    bits, two special of 51): fresh, then loaded from its cache entry,
    bit-equal; the encryptions decrypt to the values within 1e-2."""
    from phantom_tpu_torch.schemes import keys
    from phantom_tpu_torch.utils import benchcache, setup_bench
    monkeypatch.setenv(benchcache.ENV, str(tmp_path))
    kw = dict(n=1024, limbs=2, alpha=2, bits=50, seed=7, verbose=False,
              device=dev)
    s = setup_bench("ckks", **kw)
    t = setup_bench("ckks", **kw)
    assert not s.cached and t.cached and s.ct1.data.is_cuda
    for name in ("sk", "pk", "rlk", "pt", "ct1", "ct2"):
        assert chip_smoke._same(getattr(t, name), getattr(s, name)), name
    for ct in (s.ct1, s.ct2):
        got = s.enc.decode(keys.decrypt64(s.ctx, s.sk, ct))
        assert np.abs(got - s.values).max() < 1e-2

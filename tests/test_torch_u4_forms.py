"""U4's fused forms (phantom_tpu_torch/ops/polyops.py) on the CPU: each
plain version equals, bit for bit, the composition of the plain calls it
replaces in the u64 evaluator (the moddown's (x - delta) P^-1 plus its
addend, the rescale's rounding correction, BGV's moddown and
modulus-switch deltas, the strided rescale operand, the hoisted forms'
multiply-adds), at n = 1024 over the u64 golden files' primes, with the
context's tables; tensor_prod_mxn against Python integers and against
the JAX package's (tests/fixtures/torch_port/u64_mxn_n1024.npz).  The
kernel itself is held against these plain versions on the card
(tests/test_torch_gpu.py::test_u4_products)."""

import functools
import os

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu_torch import make_context
from phantom_tpu_torch.host import numth
from phantom_tpu_torch.ops import modmath as mm
from phantom_tpu_torch.ops import polyops as po
from phantom_tpu_torch.ops.rns_host import i64_tensor, modulus_vec
from phantom_tpu_torch.schemes.params import EncryptionParameters

N = 1024


def _col(v):
    return v.view(-1, 1)


def _shoup_words(ws, qs):
    return i64_tensor([(int(w) << 64) // int(q) for w, q in zip(ws, qs)])


def _old_shoup(a, w, ws, q, s=None):
    """The evaluator's former Shoup call, sub_mul_shoup_plain: (a - s) w
    mod q, w and ws (L,), q (L,); a (..., 1, N) row stands for every
    limb."""
    x = a if s is None else mm.sub_mod(a, s, _col(q))
    return mm.mul_mod_shoup(x, _col(w), _col(ws), _col(q))


def _old_rows_mod(x, q, ratio_hi):
    """Its rows_times(x, None, ...): x mod each q by Shoup with w = 1."""
    return _old_shoup(x, torch.ones_like(q), ratio_hi, q)


FILES = ["u64_ckks_b50.npz", "u64_bgv_b60.npz"]


@functools.lru_cache(maxsize=None)
def _level(fname):
    """(context data at chain index 1, its Level64, seeded words) over a
    golden file's primes."""
    g = np.load(os.path.join(chip_smoke.FIXTURES, fname))
    scheme = "ckks" if "ckks" in fname else "bgv"
    ctx = make_context(EncryptionParameters.create(
        N, g["data_moduli"].tolist(), g["special_moduli"].tolist(), scheme,
        int(g["t"])), device="cpu")
    cd = ctx.get_context_data(1)
    gen = torch.Generator().manual_seed(len(fname))
    q = _col(cd.u64.mv.q)

    def words(lead, mod=q):
        return torch.randint(0, 1 << 62, lead + (mod.shape[0], N),
                             generator=gen) % mod
    return cd, cd.u64, words


@pytest.mark.parametrize("fname", FILES)
def test_moddown_with_addend(fname):
    """(x - delta) P^-1 + c, into an out slot: the Shoup call, then
    add_rns, as the evaluator composed them."""
    cd, lv, words = _level(fname)
    ks = cd.ks
    x, delta, c = words(()), words(()), words(())
    pinv = i64_tensor(ks.pinv_mod_q)
    old = po.add_rns(_old_shoup(
        x, pinv, _shoup_words(ks.pinv_mod_q, cd.moduli), lv.mv.q, delta), c,
        lv.mv)
    out = torch.empty((2,) + x.shape, dtype=torch.int64)
    got = po.shoup_rns_plain(x, lv.ks.pinv, delta, c, out[1])
    assert got.data_ptr() == out[1].data_ptr()
    assert torch.equal(out[1], old)
    assert torch.equal(po.shoup_rns_plain(x, lv.ks.pinv, delta),
                       _old_shoup(x, pinv,
                                  _shoup_words(ks.pinv_mod_q, cd.moduli),
                                  lv.mv.q, delta))


@pytest.mark.parametrize("fname", FILES)
def test_rescale(fname):
    """The rounding correction of the last limb for every other limb, and
    (x - delta) q_last^-1 on x[..., :k-1, :] read in place."""
    cd, lv, words = _level(fname)
    rc, k = cd.rescale, cd.size_ql
    rest = lv.mv.slice(0, k - 1)
    qlast = lv.mv.q[k - 1]
    x = words((2,))
    xl = x[..., k - 1:k, :]
    red = _old_rows_mod(mm.add_mod(xl, rc.half, qlast), rest.q,
                        rest.ratio_hi)
    old = mm.sub_mod(red, _col(i64_tensor(rc.half_mod_q)), _col(rest.q))
    assert torch.equal(po.rescale_delta_plain(xl, lv.rescale), old)
    delta = old.flip(-1)
    want = _old_shoup(x[..., :k - 1, :].contiguous(),
                      i64_tensor(rc.qlast_inv),
                      i64_tensor(rc.qlast_inv_shoup), rest.q, delta)
    assert torch.equal(po.shoup_rns_plain(x[..., :k - 1, :], lv.rescale,
                                          delta), want)


def test_bgv_deltas():
    """BGV's moddown delta (dq - phalf + [-(dt - phalf_t) P^-1]_t P) and
    modulus-switch delta (c mod q_i + [-c q_last^-1]_t q_last), against
    the five and four plain calls they replace."""
    cd, lv, words = _level(FILES[1])
    ks, bgv, k = cd.ks, cd.bgv, cd.size_ql
    t = cd._params.plain_modulus
    t_mv = modulus_vec([t])
    tq = t_mv.q[0]
    dq = words(())
    dt = torch.randint(0, t, (1, N),
                       generator=torch.Generator().manual_seed(5))
    q = _col(lv.mv.q)
    u = _old_shoup(mm.sub_mod(dt, ks.phalf_mod_t, tq),
                   i64_tensor([ks.neg_pinv_mod_t]),
                   _shoup_words([ks.neg_pinv_mod_t], [t]), t_mv.q)
    old = mm.add_mod(
        mm.sub_mod(dq, _col(i64_tensor(ks.phalf_mod_q)), q),
        _old_shoup(u, i64_tensor(ks.bigp_mod_q),
                   _shoup_words(ks.bigp_mod_q, cd.moduli), lv.mv.q), q)
    assert torch.equal(po.moddown_delta_plain(dq, dt, lv.ks.delta), old)
    rest = lv.mv.slice(0, k - 1)
    c_last = words((2,))[..., k - 1:k, :] * 3  # any 64-bit words
    nqi = bgv.neg_qlast_inv_mod_t
    u = _old_shoup(c_last, i64_tensor([nqi]), _shoup_words([nqi], [t]),
                   t_mv.q)
    old = mm.add_mod(
        _old_rows_mod(c_last, rest.q, rest.ratio_hi),
        _old_shoup(u, i64_tensor(bgv.qlast_mod_qi),
                   _shoup_words(bgv.qlast_mod_qi, cd.moduli[:-1]), rest.q),
        _col(rest.q))
    assert torch.equal(po.modswitch_delta_plain(c_last, lv.bgv.modswitch),
                       old)


@pytest.mark.parametrize("fname", FILES)
def test_fma_is_mul_then_add(fname):
    """The hoisted forms' acc + a b: fma_rns against mul_rns then add_rns,
    b broadcast and whole."""
    cd, lv, words = _level(fname)
    a, b, acc = words((2,)), words((2,)), words((2,))
    for bb in (b, b[0]):
        assert torch.equal(po.fma_rns_plain(a, bb, acc, lv.mv),
                           po.add_rns(acc, po.mul_rns_plain(a, bb, lv.mv),
                                      lv.mv))


@pytest.mark.parametrize("fname", FILES)
def test_limbs_tables(fname):
    """A Limbs table holds its moduli's Barrett words as modulus_vec
    builds them, the Shoup words of w and the scalars; ModulusVec.words
    packs q and its Barrett words."""
    cd, lv, _ = _level(fname)
    for name, v in zip(("q", "ratio_lo", "ratio_hi"), lv.mv):
        assert torch.equal(lv.ks.pinv.row(name), v)
    assert torch.equal(lv.ks.pinv.row("w"), i64_tensor(cd.ks.pinv_mod_q))
    assert torch.equal(lv.ks.pinv.row("w_shoup"),
                       i64_tensor(cd.ks.pinv_shoup))
    assert lv.rescale.scalar(0).item() == cd.moduli[-1]
    assert lv.rescale.scalar(1).item() == cd.rescale.half
    assert torch.equal(lv.mv.words, torch.cat(tuple(lv.mv)))


def _mxn_exact(a, b, qs):
    m, n = len(a), len(b)
    return [[[sum(a[i][l][c] * b[k - i][l][c]
                  for i in range(max(0, k - n + 1), min(m, k + 1))) % q
              for c in range(len(a[0][0]))] for l, q in enumerate(qs)]
            for k in range(m + n - 1)]


@pytest.mark.parametrize("m,n", [(3, 2), (3, 3)])
@pytest.mark.parametrize("bits", [50, 61])
def test_mxn_against_integers(bits, m, n):
    """tensor_prod_mxn's plain version against Python integers, the
    columns of all q - 1 included."""
    qs = numth.get_primes(2048, bits, 2)
    mv = modulus_vec(qs)
    rng = np.random.default_rng(bits + m + n)
    vals = [[[[int(v) % q for v in rng.integers(0, 1 << 62, 16)]
              for q in qs] for _ in range(s)] for s in (m, n)]
    for ct in vals:
        for part in ct:
            for l, q in enumerate(qs):
                part[l][0] = part[l][1] = q - 1
    got = po.tensor_prod_mxn_plain(i64_tensor(vals[0]), i64_tensor(vals[1]),
                                   mv)
    assert got.numpy().view(np.uint64).tolist() == _mxn_exact(*vals, qs)


def test_mxn_golden():
    """u64_mxn_n1024.npz: every (m, n) case on the 50- and 61-bit chains
    bit-equal to the JAX package's tensor_prod_mxn (digests)."""
    assert chip_smoke.u64_mxn_golden(torch.device("cpu")) == 8


def test_layout_refusals():
    """U4's operand check: rows must be contiguous, even and 16-byte
    aligned, and the leading dimensions one stride; a strided x[..., :k-1,
    :] passes with its group stride."""
    x = torch.zeros((2, 5, 8), dtype=torch.int64)
    assert po._layout(x[..., :4, :], "a") == (2, 40)
    assert po._layout(x[1], "a") == (1, 40)
    for bad in (x.transpose(1, 2), x[..., 1:], x[..., ::2],
                x.view(-1)[1:79].view(2, 3, 13)):
        with pytest.raises(ValueError, match="U4"):
            po._layout(bad, "a")
    with pytest.raises(ValueError, match="one stride"):
        po._layout(torch.zeros((3, 4, 2, 8), dtype=torch.int64)[:, :2], "a")

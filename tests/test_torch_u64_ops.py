"""The port's u64 arithmetic and its plain kernels (ops/modmath.py,
host/ntt_tables.py's wide path, ops/ntt.py, bconv.py, polyops.py,
schemes/keyswitch.py's inner product) against exact Python integers and
the JAX package's host tables, on words up to 64 bits and primes up to
61 bits.  The kernels' functions against the JAX package's outputs are
the u64 golden files' (tests/test_torch_u64_evaluator.py); every kernel
runs its plain version on the CPU."""

import numpy as np
import pytest
import torch

from phantom_tpu.host import ntt_tables as jtables
from phantom_tpu.host.modulus import Modulus
from phantom_tpu_torch.host import ntt_tables, numth
from phantom_tpu_torch.ops import bconv as bc
from phantom_tpu_torch.ops import modmath as mm
from phantom_tpu_torch.ops import ntt as nttmod
from phantom_tpu_torch.ops import polyops as po
from phantom_tpu_torch.ops.rns_host import i64_tensor, modulus_vec
from phantom_tpu_torch.schemes import keyswitch as ksw

M64 = (1 << 64) - 1
EDGES = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63, M64 - 1,
         M64]


def _words(rng, count, bits=64):
    vals = [int(v) for v in rng.integers(0, 1 << 63, count, dtype=np.uint64)]
    vals = [(v << 1 | (v & 1)) & ((1 << bits) - 1) for v in vals]
    return EDGES + vals


def _t(vals):
    return i64_tensor(vals)


def _u(x):
    return [int(v) for v in x.numpy().view(np.uint64)]


def test_wide_products_and_carries():
    """mul_wide, mul_hi, add_wide, add_u64_carry and lt_u on words that
    fill all 64 bits, the sign bit's edges included."""
    rng = np.random.default_rng(1)
    a, b = _words(rng, 200), _words(rng, 200)[::-1]
    hi, lo = mm.mul_wide(_t(a), _t(b))
    assert [(h << 64) | l_ for h, l_ in zip(_u(hi), _u(lo))] == [
        x * y for x, y in zip(a, b)]
    s, c = mm.add_u64_carry(_t(a), _t(b))
    assert _u(s) == [(x + y) & M64 for x, y in zip(a, b)]
    assert c.tolist() == [int(x + y > M64) for x, y in zip(a, b)]
    h2, l2 = mm.add_wide(hi, lo, hi, lo)
    assert [(h << 64) | l_ for h, l_ in zip(_u(h2), _u(l2))] == [
        2 * x * y % (1 << 128) for x, y in zip(a, b)]
    assert mm.lt_u(_t(a), _t(b)).tolist() == [x < y for x, y in zip(a, b)]
    assert _u(mm.srl(_t(a), 7)) == [x >> 7 for x in a]


@pytest.mark.parametrize("bits", [30, 50, 60, 61])
def test_modular_reductions(bits):
    """Barrett (64- and 128-bit, with the exact quotient), the Barrett and
    Shoup products, the lazy Shoup product's range, fma and the centered
    lift, against Python integers."""
    rng = np.random.default_rng(bits)
    q = numth.get_primes(1 << 11, bits, 1)[0]
    mv = modulus_vec([q])
    qt, rlo, rhi = mv.q, mv.ratio_lo, mv.ratio_hi
    x = _words(rng, 300)
    assert _u(mm.barrett_reduce_u64(_t(x), qt, rhi)) == [v % q for v in x]
    r = [v % q for v in _words(rng, 300)]
    s = [v % q for v in _words(rng, 300)[::-1]]
    assert _u(mm.mul_mod(_t(r), _t(s), qt, rlo, rhi)) == [
        a * b % q for a, b in zip(r, s)]
    big = [(a * b + c) for a, b, c in zip(r, s, r[::-1])]
    big = [v for v in big if v < q << 64]
    hi, lo = _t([v >> 64 for v in big]), _t([v & M64 for v in big])
    assert _u(mm.barrett_reduce_u128(hi, lo, qt, rlo, rhi)) == [
        v % q for v in big]
    quo, rem = mm.barrett_div_mod_u128(hi, lo, qt, rlo, rhi)
    assert _u(quo) == [v // q & M64 for v in big]
    assert _u(rem) == [v % q for v in big]
    w = r[7]
    ws = _t([(w << 64) // q])
    lazy = _u(mm.mul_mod_shoup_lazy(_t(x), _t([w]), ws, qt))
    assert all(v % q == a * w % q and v < 2 * q for v, a in zip(lazy, x))
    assert _u(mm.mul_mod_shoup(_t(x), _t([w]), ws, qt)) == [
        a * w % q for a in x]
    assert _u(mm.fma_mod(_t(r), _t(s), _t(s), qt, rlo, rhi)) == [
        (a * b + c) % q for a, b, c in zip(r, s, s)]
    e = [-5, -1, 0, 3, -(1 << 40)]
    assert _u(mm.reduce_i64_centered(torch.tensor(e), qt)) == [
        v % q for v in e]
    assert _u(mm.sub_mod(_t(r), _t(s), qt)) == [
        (a - b) % q for a, b in zip(r, s)]
    assert _u(mm.neg_mod(_t(r), qt)) == [-a % q for a in r]


@pytest.mark.parametrize("bits", [31, 50, 60, 61])
def test_ntt_tables_match_the_jax_host(bits):
    """The wide tables (primes of 31 bits or more) equal the JAX package's
    host tables word for word."""
    n = 256
    qs = numth.get_primes(2 * n, bits, 2) + numth.get_primes(2 * n, 28, 1)
    mine = ntt_tables.make_rns_ntt_tables(n, qs)
    ref = jtables.make_rns_ntt_tables(n, [Modulus(q) for q in qs])
    for f in ("root_powers", "root_powers_shoup", "inv_root_powers",
              "inv_root_powers_shoup", "inv_degree", "inv_degree_shoup"):
        np.testing.assert_array_equal(np.asarray(getattr(mine, f)),
                                      np.asarray(getattr(ref, f)), f)


def _negacyclic(a, b, q):
    n = len(a)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                out[k] += a[i] * b[j]
            else:
                out[k - n] -= a[i] * b[j]
    return [v % q for v in out]


@pytest.mark.parametrize("bits", [50, 61])
def test_ntt_negacyclic_product(bits):
    """Forward, pointwise Barrett product, inverse is the negacyclic
    product; the inverse takes lazy [0, 2q) input, with a custom scale."""
    n = 32
    qs = numth.get_primes(2 * n, bits, 2)
    t = nttmod.NTTTables64(ntt_tables.make_rns_ntt_tables(n, qs))
    rng = np.random.default_rng(bits)
    a = [[int(v) % q for v in rng.integers(0, 1 << 62, n)] for q in qs]
    b = [[int(v) % q for v in rng.integers(0, 1 << 62, n)] for q in qs]
    fa = nttmod.ntt_forward(_t(a).view(2, n), t)
    fb = nttmod.ntt_forward(_t(b).view(2, n), t)
    mv = modulus_vec(qs)
    prod = nttmod.ntt_inverse(po.mul_rns(fa, fb, mv), t)
    want = [_negacyclic(x, y, q) for x, y, q in zip(a, b, qs)]
    assert [_u(r) for r in prod] == want
    lazy = fa + torch.tensor(qs).view(2, 1) * (fa[:, :1] % 2)
    back = nttmod.ntt_inverse(lazy, t)
    assert [_u(r) for r in back] == a
    sc = [3, 5]
    scaled = nttmod.ntt_inverse(
        fa, t, None, _t(sc), _t([(s << 64) // q for s, q in zip(sc, qs)]))
    # the scale replaces N^-1: the output is N a s
    assert [_u(r) for r in scaled] == [[v * n * s % q for v in x]
                                        for x, s, q in zip(a, sc, qs)]
    rows = torch.tensor([1, 0], dtype=torch.int32)
    swapped = nttmod.ntt_forward(_t(a[::-1]).view(2, n), t, rows)
    assert torch.equal(swapped, fa.flip(0))


def test_bconv_exact_against_the_crt():
    """bconv_exact is the exact conversion [X]_p of X in [0, Q): with two
    60-bit input primes 1/Q > k 2^-128, so the cascade's truncation never
    flips the floor, even at X = 1 and Q - 1; bconv_approx is X + v Q with
    0 <= v < k, "reduce" the approx form from the pre-scaled rows."""
    from phantom_tpu_torch import host
    ib = numth.get_primes(1 << 11, 60, 2)
    ob = numth.get_primes(1 << 11, 50, 4) + [65537]
    conv = bc.consts_from_host(host.BaseConverter(host.RNSBase(ib),
                                                  host.RNSBase(ob)))
    big_q = ib[0] * ib[1]
    rng = np.random.default_rng(3)
    xs = [0, 1, big_q - 1, big_q // 2] + [
        int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62))
        * int(rng.integers(0, 1 << 62)) % big_q for _ in range(60)]
    x = _t([[v % q for v in xs] for q in ib])
    exact = bc.bconv_exact(x, conv)
    assert [_u(r) for r in exact] == [[v % p for v in xs] for p in ob]
    approx = [_u(r) for r in bc.bconv_approx(x, conv)]
    for j, p in enumerate(ob):
        for c, v in enumerate(xs):
            assert any((v + k * big_q) % p == approx[j][c] for k in range(3))
    y = bc.scale_by_qhat_inv(x, conv)
    assert torch.equal(bc.bconv_plain(y, conv, "reduce"),
                       bc.bconv_approx(x, conv))
    with pytest.raises(ValueError, match="form"):
        bc.bconv(x, conv, "mxu")


def test_products_and_inner_product():
    """U4's forms and U3's sum against Python integers: mul (b broadcast),
    fma, the tensor product and square, (a - s) w; the evk inner product
    with and without a gather index."""
    qs = numth.get_primes(1 << 11, 61, 2)
    mv = modulus_vec(qs)
    rng = np.random.default_rng(9)
    n = 16

    def rand(lead):
        return [[[int(v) % q for v in rng.integers(0, 1 << 62, n)]
                 for q in qs] for _ in range(lead)]

    a, b, c = rand(2), rand(2), rand(2)
    A, B, C = _t(a), _t(b), _t(c)

    def lists(x):
        return [[_u(r) for r in g] for g in x]

    q = qs
    assert lists(po.mul_rns(A, B[0], mv)) == [
        [[u * v % q[l] for u, v in zip(a[g][l], b[0][l])] for l in range(2)]
        for g in range(2)]
    assert lists(po.fma_rns(A, B, C, mv)) == [
        [[(u * v + w) % q[l] for u, v, w in zip(a[g][l], b[g][l], c[g][l])]
         for l in range(2)] for g in range(2)]
    tp = lists(po.tensor_prod_2x2(A, B, mv))
    sq = lists(po.tensor_square_2x2(A, mv))
    for l in range(2):
        for i in range(n):
            a0, a1, b0, b1 = a[0][l][i], a[1][l][i], b[0][l][i], b[1][l][i]
            assert [tp[k][l][i] for k in range(3)] == [
                a0 * b0 % q[l], (a0 * b1 + a1 * b0) % q[l], a1 * b1 % q[l]]
            assert [sq[k][l][i] for k in range(3)] == [
                a0 * a0 % q[l], 2 * a0 * a1 % q[l], a1 * a1 % q[l]]
    w = [a[0][0][0], a[0][1][0]]
    assert lists(po.shoup_rns(A, po.limbs(q, w=w), s=B)) == [
        [[(u - v) * w[l] % q[l] for u, v in zip(a[g][l], b[g][l])]
         for l in range(2)] for g in range(2)]
    beta = 3
    t_ = rand(beta)
    evk = [rand(2) for _ in range(beta)]
    pow64 = _t([(1 << 64) % p for p in q])
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    for pm in (None, perm):
        src = list(range(n)) if pm is None else pm.tolist()
        got = lists(ksw.inner_product_evk_kernel(
            _t(t_), _t(evk), mv.q, mv.ratio_lo, mv.ratio_hi, pow64, pm))
        assert got == [[[sum(t_[d][l][src[i]] * evk[d][h][l][i]
                             for d in range(beta)) % q[l] for i in range(n)]
                        for l in range(2)] for h in range(2)]

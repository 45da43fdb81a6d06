"""The port's double-float CKKS FFT and CKKSDeviceEncoder against the JAX
package's, on the golden file tests/fixtures/torch_port/ckks_fft.npz
(made by tests/fixtures/gen_torch_port_fixtures.py).

Two oracles, as the file records both.  The JAX package evaluated op by
op (eager) is the bit oracle: the tables, the double-float primitives,
both transforms at n = 256 and 1024, the rounded encode integers, the
encoded residues and the decoded slots are equal word for word.  The
jitted JAX encoder (how the JAX package runs it) is held to a stated
tolerance, because XLA's fusions on the CPU round some double-float
words differently: its encoded coefficients within one of the port's
(each differing coefficient listed), its decoded slots within 1e-10.
Every F1 call takes its plain version on the CPU.

F1's fused forms are held to what they replace: the encode form's plain
version against the JAX package's numpy scatter (CKKSDeviceEncoder.
_scatter) followed by the plain inverse FFT, the rounding and the floor
modulus, bit for bit; the decode form's against the composition the
device decoder ran before them (Garner over the first limbs, the split,
the forward FFT, the gather), bit for bit."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
import f1_anatomy
from phantom_tpu_torch import (CKKSDeviceEncoder, CKKSEncoder, Plaintext,
                               make_context)
from phantom_tpu_torch.ops import ckks_fft as cf
from phantom_tpu_torch.ops import pipeline32 as tpp
from phantom_tpu_torch.schemes.params import EncryptionParameters
from phantom_tpu.ops import ckks_fft as jax_cf
from phantom_tpu.schemes.ckks_encoder import \
    CKKSDeviceEncoder as JaxDeviceEncoder

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(f"{chip_smoke.FIXTURES}/ckks_fft.npz")


@pytest.fixture(scope="module")
def fft_results():
    return chip_smoke.fft_golden(CPU)


@pytest.fixture(scope="module")
def encoder_results():
    return chip_smoke.encoder_golden(CPU)


@pytest.mark.parametrize("n", [256, 1024])
def test_tables_bit_match(fft_results, n):
    for name in ("table fwd", "table inv", "slot_pos", "slot_conj"):
        got, want = fft_results[f"{name} {n}"]
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_transform_bit_match_eager(fft_results, golden, n, direction):
    """The plain transforms equal the JAX package's eager evaluation word
    for word; against its jitted evaluation only hi + lo agrees, within
    2^-44 of the largest output (the count of differing words is what
    the jitted fusions change)."""
    got, want = fft_results[f"{direction} {n}"]
    np.testing.assert_array_equal(got, want)
    jit = golden[f"{direction}_jit_{n}"]
    print(f"{direction} n={n}: {np.count_nonzero(got != jit.view(np.uint32))}"
          f" of {got.size} words differ from the jitted JAX evaluation")
    jit = jit.astype(np.float64)
    mine = got.view(np.float32).astype(np.float64)
    val = lambda p: np.stack([p[0] + p[1], p[2] + p[3]])  # noqa: E731
    assert np.abs(val(mine) - val(jit)).max() <= 2.0 ** -44 * np.abs(
        val(jit)).max()


def test_primitives_bit_match(golden):
    a, b, c, d = (torch.from_numpy(v) for v in golden["prim_in"])
    x, y = ((a, b), (c, d)), ((c, a), (d, b))
    got = dict(two_sum=cf.two_sum(a, b), quick_two_sum=cf.quick_two_sum(a, b),
               two_prod=cf.two_prod(a, b), df_add=cf.df_add((a, b), (c, d)),
               df_sub=cf.df_sub((a, b), (c, d)),
               df_mul=cf.df_mul((a, b), (c, d)),
               cdf_add=sum(cf.cdf_add(x, y), ()),
               cdf_sub=sum(cf.cdf_sub(x, y), ()),
               cdf_mul=sum(cf.cdf_mul(x, y), ()))
    for name, r in got.items():
        np.testing.assert_array_equal(
            torch.stack(list(r)).numpy().view(np.uint32),
            golden[f"prim_{name}"].view(np.uint32), err_msg=name)


def test_round_trip():
    """inverse(forward(p)) within 1e-10 of p, as the JAX package's
    tests/test_ckks_device_encoder.py holds its own (far below f32)."""
    n = 256
    t = cf.make_fft_tables(n, CPU)
    p = np.random.default_rng(2).standard_normal(n)
    hi, lo = cf.df_from_f64(p)
    x = torch.from_numpy(np.stack([hi, lo, np.zeros_like(hi),
                                   np.zeros_like(hi)]))
    back = cf.ckks_fft(cf.ckks_fft(x, t), t, inverse=True).double()
    assert float((back[0] + back[1] - torch.from_numpy(p)).abs().max()) < 1e-10


@pytest.mark.parametrize("ci", [1, 3])
def test_encoder_bit_match_eager(encoder_results, ci):
    exact, _ = encoder_results
    for name in ("ints", "residues", "decoded"):
        got, want = exact[f"{name} {ci}"]
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("ci", [1, 3])
def test_encoder_against_jitted(encoder_results, golden, ci):
    """Residues within +-1 of the jitted JAX encoder's in every coefficient
    (the JAX package's own bound for its device encoder against its host
    encoder, tests/test_ckks_device_encoder.py:40); decode within 1e-10
    of the jitted JAX decoder and within 1e-6 of the input."""
    exact, jitted = encoder_results
    where, worst, dec_err = jitted[ci]
    print(f"chain index {ci}: coefficients differing from the jitted JAX "
          f"encoder: {where.tolist()} (largest {worst})")
    assert worst <= 1
    assert dec_err < 1e-10
    assert np.abs(exact[f"decoded {ci}"][0] - golden["z"]).max() < 1e-6


@pytest.fixture(scope="module")
def small():
    g = np.load(f"{chip_smoke.FIXTURES}/ckks_fft.npz")
    ctx = make_context(EncryptionParameters.create(
        1024, g["data_moduli"].tolist(), g["special_moduli"].tolist()),
        device="cpu")
    return ctx, CKKSDeviceEncoder(ctx), CKKSEncoder(ctx)


def test_device_decodes_host_encoding(small):
    """Each encoder decodes the other's plaintext within 1e-6."""
    ctx, dev, host = small
    z = np.random.default_rng(5).standard_normal(dev.slots) * 0.5
    scale = 2.0 ** 28
    assert np.abs(dev.decode(host.encode(z, scale)) - z).max() < 1e-6
    assert np.abs(host.decode(dev.encode(z, scale)) - z).max() < 1e-6


def test_kernels_equal_plain_on_cpu(small):
    ctx, dev, _ = small
    z = np.random.default_rng(6).standard_normal(dev.slots)
    a = dev.encode(z, 2.0 ** 26, 2)
    b = dev.encode(z, 2.0 ** 26, 2, ops=tpp.PLAIN)
    assert torch.equal(a.data, b.data) and a.chain_index == 2
    np.testing.assert_array_equal(dev.decode(a), dev.decode(b, tpp.PLAIN))


def test_decode_of_uniform_residues_does_not_raise(small):
    """Where the host decode's exact CRT raises OverflowError at full
    width (ROADMAP.md section 3, item 4), the two-limb Garner compose
    returns values (finite or not) for any residues."""
    ctx, dev, _ = small
    q = ctx.key_q[:5].long().view(-1, 1)
    data = (torch.randint(0, 1 << 62, (5, 1024),
                          generator=torch.Generator().manual_seed(7)) % q)
    out = dev.decode(Plaintext(data=data.int(), chain_index=1,
                               is_ntt_form=True, scale=2.0 ** 28))
    assert out.shape == (512,)


def test_wide_primes_and_bad_operands_raise():
    """A context with primes of 2^30 and more (the u64 evaluator's) builds
    a working encoder: encode and decode round-trip through F1's wide
    forms' plain versions and U1; a bad operand raises."""
    from phantom_tpu_torch.host import numth
    n = 64
    wide = make_context(EncryptionParameters.create(
        n, numth.get_primes(2 * n, 50, 2), numth.get_primes(2 * n, 51, 1)),
        device=CPU)
    enc = CKKSDeviceEncoder(wide)
    z = np.random.default_rng(3).uniform(-1, 1, enc.slots)
    pt = enc.encode(z, 2.0 ** 40)
    assert pt.data.dtype == torch.int64 and pt.data.shape == (2, n)
    np.testing.assert_allclose(enc.decode(pt), z, atol=1e-9)
    t = cf.make_fft_tables(n, "meta")
    with pytest.raises(ValueError):
        cf.ckks_fft(torch.zeros(4, n, device="meta"), t)


@pytest.mark.parametrize("n", [2, 4, 256, 1024, 1 << 16])
def test_slot_positions_partition(n):
    """slot_pos and slot_conj are disjoint and cover the N positions, and
    slot_of inverts them (~j marks a conjugate)."""
    t = cf.make_fft_tables(n, CPU)
    pos, conj = t.slot_pos.numpy(), t.slot_conj.numpy()
    assert np.intersect1d(pos, conj).size == 0
    np.testing.assert_array_equal(np.sort(np.concatenate([pos, conj])),
                                  np.arange(n))
    j = np.arange(n // 2)
    np.testing.assert_array_equal(t.slot_of.numpy()[pos], j)
    np.testing.assert_array_equal(t.slot_of.numpy()[conj], ~j)


def _values(case: str, n: int):
    """(values, scale) of one encode case, seeded."""
    rng = np.random.default_rng(len(case))
    z = rng.standard_normal(n // 2) + 1j * rng.standard_normal(n // 2)
    if case == "partial":
        return z[:n // 2 - 37], 2.0 ** 40
    if case == "real":
        return rng.standard_normal(n // 3), 2.0 ** 30
    if case == "signed_zeros":
        v = np.zeros(n // 2, dtype=np.complex128)
        v[1::4] = complex(-0.0, 0.0)
        v[2::4] = complex(0.0, -0.0)
        v[3::4] = complex(-0.0, -0.0)
        v[:8] = z[:8]
        return v, 2.0 ** 28
    # large and negative, past 2^53 after the scale
    return -np.abs(z) * 2.0 ** 20 + 1j * z.imag * 2.0 ** 21, 2.0 ** 35


@pytest.mark.parametrize("case", ["full", "partial", "real",
                                  "signed_zeros", "large_negative"])
def test_encode_form_against_numpy_scatter(golden, case):
    """The encode form's plain version equals the JAX package's numpy
    scatter (signed zeros included) followed by the plain inverse FFT,
    the rounding and the floor modulus, word for word."""
    n = 256
    t = cf.make_fft_tables(n, CPU)
    values, scale = _values(case, n)
    fake = type("Enc", (), {})()
    fake.ctx = type("Ctx", (), {})()
    fake.ctx.params = type("Params", (), {"n": n})()
    fake.slots, fake.tables = n // 2, jax_cf.make_fft_tables(n)
    re, im = JaxDeviceEncoder._scatter(fake, values, scale)
    want_planes = np.stack([np.asarray(p) for p in re + im])
    v = np.asarray(values, dtype=np.complex128).ravel()
    z = torch.from_numpy(v.view(np.float64).reshape(-1, 2))
    planes = cf.scatter_plain(z, scale, t)
    np.testing.assert_array_equal(planes.numpy().view(np.uint32),
                                  want_planes.view(np.uint32))
    q = torch.tensor(golden["data_moduli"].tolist(), dtype=torch.int32)
    c = cf.ckks_fft_plain(torch.from_numpy(want_planes), t, inverse=True)
    hi, lo = c[0], c[1]
    a = torch.round(hi).long()
    ints = a + torch.round(lo + (hi - a.float())).long()
    want = (ints % q.long().view(-1, 1)).int()
    got = cf.ckks_fft_encode_plain(z, scale, q, t)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


@pytest.mark.parametrize("k", [1, 2, 5])
def test_decode_form_against_composition(golden, k):
    """The decode form's plain version on the first min(k, 2) limbs equals
    the composition it replaces (Garner over limbs 0-1, or the centered
    limb 0 for k = 1; the f32 split times the f32 1/scale; the forward
    FFT; the gather and hi + lo in float64), word for word."""
    n = 256
    t = cf.make_fft_tables(n, CPU)
    moduli = golden["data_moduli"].tolist()[:k]
    rng = np.random.default_rng(k)
    x = torch.from_numpy(np.stack([rng.integers(0, q, n) for q in moduli])
                         ).int()
    xl = x.long()
    q0 = moduli[0]
    if k == 1:
        m = torch.where(xl[0] > q0 // 2, xl[0] - q0, xl[0])
    else:
        q1 = moduli[1]
        u = (xl[1] - xl[0] % q1) % q1 * pow(q0 % q1, -1, q1) % q1
        m = xl[0] + q0 * torch.where(u > q1 // 2, u - q1, u)
    scale = 2.0 ** 27
    hi = m.float()
    lo = (m - hi.long()).float()
    inv = float(np.float32(1.0 / scale))
    zero = torch.zeros_like(hi)
    ev = cf.ckks_fft_plain(torch.stack([hi * inv, lo * inv, zero, zero]), t)
    g = ev[:, t.slot_pos].double()
    want = torch.complex(g[0] + g[1], g[2] + g[3])
    got = cf.ckks_fft_decode_plain(x[:2], moduli[:2], scale, t)
    np.testing.assert_array_equal(
        torch.view_as_complex(got).numpy().view(np.uint64),
        want.numpy().view(np.uint64))


def test_decode_reads_two_limbs(small):
    """K1's plain version on the first two rows equals its first two rows
    over all k (the NTT is row by row), so decode from two limbs equals
    decode from every limb."""
    ctx, dev, _ = small
    z = np.random.default_rng(8).standard_normal(dev.slots)
    pt = dev.encode(z, 2.0 ** 30, 1)
    k = ctx.get_context_data(1).size_ql
    every = tpp.PLAIN.ntt_inverse(pt.data, ctx.ntt, ctx.rows_qp[:k])
    two = tpp.PLAIN.ntt_inverse(pt.data[:2].contiguous(), ctx.ntt,
                                ctx.rows_qp[:2])
    assert torch.equal(every[:2], two)
    moduli = ctx.get_context_data(1).moduli[:2]
    got = dev.decode(pt, tpp.PLAIN)
    full = torch.view_as_complex(cf.ckks_fft_decode_plain(
        every[:2], moduli, pt.scale, dev.tables)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), full.view(np.uint64))


@pytest.mark.parametrize("probe", sorted(f1_anatomy.PROBES))
def test_anatomy_patches_match_source(probe):
    """Each of f1_anatomy.py's probes patches lines that csrc/ckks_fft.cu
    holds, and changes the source."""
    with open(os.path.join(os.path.dirname(chip_smoke.__file__),
                           "phantom_tpu_torch", "csrc", "ckks_fft.cu")) as fh:
        src = fh.read()
    text = src
    for old, new in f1_anatomy.PROBES[probe]:
        assert old in src, old
        text = text.replace(old, new)
    assert text != src

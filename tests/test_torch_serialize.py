"""The port's wire formats (phantom_tpu_torch/utils/refformat.py and
serialize.py) on the u64 evaluator on the CPU, against the JAX package's.

- The port writes the JAX writers' bytes for every object kind in both
  formats (PTCS apart): the JAX objects' arrays (made by
  gen_torch_port_fixtures.py) through the port's writers and the JAX
  package's, compared whole.
- The independent byte-golden blobs of tests/fixtures/refformat/ (n =
  256, written field by field from the reference's headers) load, save
  again byte for byte, and decrypt, relinearize and encrypt as the JAX
  package's tests/test_refformat_golden.py checks, on the port's u64 BFV
  path.
- refformat_n1024.npz (JAX blobs at n = 1024; chip_smoke.wire_golden, the
  same on the card) replays.
- The port's own PTCS round-trips, c1 regenerated bit for bit, and a JAX
  PTCS blob is refused.
Each comparison is bit-equality."""

import io
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu.schemes import ciphertext as jct
from phantom_tpu.schemes import keys as jkeys
from phantom_tpu.utils import refformat as jref
from phantom_tpu.utils import serialize as jser
from phantom_tpu_torch import BatchEncoder, make_context
from phantom_tpu_torch.schemes import evaluate, keys
from phantom_tpu_torch.schemes.ciphertext import Ciphertext, Plaintext
from phantom_tpu_torch.schemes.params import EncryptionParameters
from phantom_tpu_torch.utils import refformat as ref
from phantom_tpu_torch.utils import serialize as ser

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "refformat")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Every tensor here is small (n <= 1024): one intra-op thread runs
    them faster than a pool whose threads spin between ops."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _blob(name):
    with open(os.path.join(FIX, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def golden():
    """The independent blobs' BFV context on the port's u64 evaluator
    (its primes are below 2^30: u64=True)."""
    with open(os.path.join(FIX, "expected.json")) as f:
        meta = json.load(f)
    k = meta["special_modulus_size"]
    qs = meta["coeff_modulus"]
    ctx = make_context(EncryptionParameters.create(
        meta["n"], qs[:-k], qs[-k:], "bfv", meta["plain_modulus"]),
        device="cpu", u64=True)
    sk = ref.load_secret_key_ref(io.BytesIO(_blob("sk.bin")), CPU)
    return ctx, meta, sk


@pytest.fixture(scope="module")
def g1024():
    return np.load(chip_smoke.REF_GOLDEN)


def _bytes(save, *args):
    buf = io.BytesIO()
    save(*args, buf)
    return buf.getvalue()


def _t(a):
    """A numpy u64 array as the port's int64 tensor."""
    return torch.from_numpy(np.array(a, dtype=np.uint64).view(np.int64))


def _objects(g):
    """JAX and port objects over the same arrays: the golden file's JAX
    blobs read back by the JAX package."""
    o = {}
    o["sk"] = jref.load_secret_key_ref(io.BytesIO(g["ref_sk"].tobytes()))
    o["pk"] = jref.load_public_key_ref(io.BytesIO(g["ref_pk"].tobytes()))
    o["rlk"] = jref.load_relin_key_ref(io.BytesIO(g["ref_rlk"].tobytes()))
    o["glk"] = jref.load_galois_key_ref(io.BytesIO(g["ref_glk"].tobytes()),
                                        tuple(g["glk_elts"].tolist()))
    o["ct"] = jref.load_ciphertext_ref(io.BytesIO(g["ref_ct"].tobytes()))
    o["pt"] = jref.load_plaintext_ref(io.BytesIO(g["ref_pt"].tobytes()))
    return o


def _port(name, j):
    """The port's counterpart of a JAX object."""
    if name in ("sk", "pk", "rlk"):
        return _t(j.data)
    if name == "glk":
        return keys.GaloisKeys(_t(j.data), tuple(j.elts))
    if name == "ct":
        return Ciphertext(_t(j.data), j.chain_index, j.is_ntt_form, j.scale,
                          j.correction_factor, j.noise_scale_deg)
    return Plaintext(_t(j.data), j.chain_index, j.is_ntt_form, j.scale)


REF_WRITERS = {"sk": "save_secret_key_ref", "pk": "save_public_key_ref",
               "rlk": "save_relin_key_ref", "glk": "save_galois_key_ref",
               "ct": "save_ciphertext_ref", "pt": "save_plaintext_ref"}


@pytest.mark.parametrize("name", list(REF_WRITERS))
def test_bytes_equal_jax_writers(g1024, name):
    """The same arrays through each format's writer: the port's bytes are
    the JAX package's (refformat; serialize's PTCT, PTPT, PTKY), and the
    port reads them back equal."""
    j = _objects(g1024)[name]
    p = _port(name, j)
    fn = REF_WRITERS[name]
    assert _bytes(getattr(ref, fn), p) == _bytes(getattr(jref, fn), j)
    assert ser.to_bytes(p) == jser.to_bytes(j)
    back = ser.from_bytes(jser.to_bytes(j), device=CPU)
    assert chip_smoke._same(back, p)


def test_ciphertext_flags_and_seeded_bytes(g1024):
    """A ciphertext's fields (chain index, scale, factors, NTT form) and
    the seed-compressed form written as the JAX package writes them."""
    j = _objects(g1024)["ct"]
    j = jct.Ciphertext(data=j.data, chain_index=2, is_ntt_form=True,
                       scale=2.0 ** 40 + 0.5, correction_factor=7,
                       noise_scale_deg=3)
    p = _port("ct", j)
    seed = bytes(range(64))
    for asym in (False, True):
        assert _bytes(lambda c, f: ref.save_ciphertext_ref(c, f, asym), p) \
            == _bytes(lambda c, f: jref.save_ciphertext_ref(c, f, asym), j)
    assert _bytes(lambda c, f: ref.save_ciphertext_symmetric_ref(c, seed, f),
                  p) == _bytes(lambda c, f: jref.save_ciphertext_symmetric_ref(
                      c, seed, f), j)
    assert ser.to_bytes(p) == jser.to_bytes(j)
    assert chip_smoke._same(ser.from_bytes(ser.to_bytes(p), device=CPU), p)


def test_golden_n1024(g1024):
    """refformat_n1024.npz replayed on the CPU (chip_smoke.wire_golden):
    loads, saves again, serialize's hashes, the seeded loads, the PTCS
    refusal, the decryptions and the loaded relin key's product."""
    assert chip_smoke.wire_golden(CPU) == 9


def test_independent_blobs_resave(golden):
    """The independent writer's blobs load in the port and save again
    byte for byte (both directions of the format pinned)."""
    ctx, meta, sk = golden
    cases = (("sk.bin", ref.load_secret_key_ref, ref.save_secret_key_ref),
             ("pk.bin", ref.load_public_key_ref, ref.save_public_key_ref),
             ("rlk.bin", ref.load_relin_key_ref, ref.save_relin_key_ref),
             ("ct1.bin", ref.load_ciphertext_ref, ref.save_ciphertext_ref),
             ("pt1.bin", ref.load_plaintext_ref, ref.save_plaintext_ref))
    for name, load, save in cases:
        obj = load(io.BytesIO(_blob(name)), CPU)
        assert _bytes(save, obj) == _blob(name), name
    seed = bytes.fromhex(meta["seed_hex"])
    ct = ref.load_ciphertext_symmetric_ref(ctx, io.BytesIO(
        _blob("ct_sym_seeded.bin")))
    assert _bytes(lambda c, f: ref.save_ciphertext_symmetric_ref(
        c, seed, f), ct) == _blob("ct_sym_seeded.bin")


def test_independent_blobs_decrypt(golden):
    """ct1 and the seed-compressed ciphertext (c1 regenerated by the
    Salsa20 sampler, then U1's inverse) decrypt to vals1."""
    ctx, meta, sk = golden
    enc = BatchEncoder(ctx)
    want = np.array(meta["vals1"], dtype=np.uint64)
    ct1 = ref.load_ciphertext_ref(io.BytesIO(_blob("ct1.bin")), CPU)
    sym = ref.load_ciphertext_symmetric_ref(ctx, io.BytesIO(
        _blob("ct_sym_seeded.bin")))
    for ct in (ct1, sym):
        np.testing.assert_array_equal(
            enc.decode(keys.decrypt64(ctx, sk, ct)), want)


def test_independent_rlk_relinearizes(golden):
    """multiply_and_relin driven by the loaded relin key decrypts to
    vals1 * vals2 mod t."""
    ctx, meta, sk = golden
    rlk = ref.load_relin_key_ref(io.BytesIO(_blob("rlk.bin")), CPU)
    ct1 = ref.load_ciphertext_ref(io.BytesIO(_blob("ct1.bin")), CPU)
    ct2 = ref.load_ciphertext_ref(io.BytesIO(_blob("ct2.bin")), CPU)
    prod = evaluate.multiply_and_relin(ctx, ct1, ct2, rlk)
    t = meta["plain_modulus"]
    v1 = np.array(meta["vals1"], dtype=object)
    v2 = np.array(meta["vals2"], dtype=object)
    np.testing.assert_array_equal(
        BatchEncoder(ctx).decode(keys.decrypt64(ctx, sk, prod)),
        (v1 * v2 % t).astype(np.uint64))


def test_independent_pk_encrypts(golden):
    ctx, meta, sk = golden
    pk = ref.load_public_key_ref(io.BytesIO(_blob("pk.bin")), CPU)
    enc = BatchEncoder(ctx)
    vals = np.arange(meta["n"], dtype=np.uint64) % 31
    gen = torch.Generator().manual_seed(9)
    ct = keys.encrypt_asymmetric64(ctx, pk, enc.encode(vals), gen)
    np.testing.assert_array_equal(
        enc.decode(keys.decrypt64(ctx, sk, ct)), vals)


@pytest.mark.parametrize("scheme", ["bfv", "ckks"])
def test_ptcs_round_trip(golden, scheme):
    """The port's seed-compressed symmetric ciphertext: 16 seed words
    drawn from the generator, c0 and the seed on the wire (the refformat
    form too), c1 regenerated bit for bit, the decryption right."""
    ctx, meta, sk = golden
    gen = torch.Generator().manual_seed(4)
    if scheme == "ckks":
        from phantom_tpu_torch.host import numth
        n = 256
        ctx = make_context(EncryptionParameters.create(
            n, numth.get_primes(2 * n, 50, 2), numth.get_primes(2 * n, 51, 1)),
            device="cpu")
        sk = keys.gen_secret_key64(ctx, gen)
        from phantom_tpu_torch import CKKSEncoder
        enc = CKKSEncoder(ctx)
        z = np.linspace(-1, 1, n // 2)
        pt = enc.encode(z, 2.0 ** 40)
    else:
        enc = BatchEncoder(ctx)
        vals = np.arange(meta["n"], dtype=np.uint64) % 97
        pt = enc.encode(vals)
    ct, seed = ser.encrypt_symmetric_compressed(ctx, sk, pt, gen)
    assert seed.dtype == np.uint32 and seed.shape == (ser.SEED_WORDS,)
    buf = io.BytesIO()
    ser.save_ciphertext_symmetric(ct, seed, buf)
    blob = buf.getvalue()
    assert len(blob) < len(ser.to_bytes(ct)) // 2 + 100
    back = ser.from_bytes(blob, ctx)
    assert chip_smoke._same(back, ct)
    seeded = _bytes(lambda c, f: ref.save_ciphertext_symmetric_ref(
        c, ser.seed_bytes(seed), f), ct)
    assert chip_smoke._same(ref.load_ciphertext_symmetric_ref(
        ctx, io.BytesIO(seeded)), ct)
    dec = keys.decrypt64(ctx, sk, back)
    if scheme == "ckks":
        assert np.abs(enc.decode(dec) - z).max() < 1e-6
    else:
        np.testing.assert_array_equal(enc.decode(dec), vals)


def test_jax_ptcs_refused(golden, g1024):
    """A PTCS blob the JAX package wrote (its seed a 2-word threefry key)
    raises a ValueError that says why; so does a seed of another
    length."""
    ctx, _, _ = golden
    blob = g1024["ser_cts"].tobytes()
    with pytest.raises(ValueError, match="JAX package.*threefry"):
        ser.from_bytes(blob, ctx)
    bad = bytearray(blob)
    bad[5 + 33] = 5  # the seed_len byte after magic, version and fields
    with pytest.raises(ValueError, match="5 words"):
        ser.from_bytes(bytes(bad), ctx)
    with pytest.raises(ValueError, match="needs a context"):
        ser.from_bytes(blob)


def test_malformed_blobs_raise(golden):
    ctx, _, sk = golden
    blob = ser.to_bytes(sk)
    with pytest.raises(ValueError, match="truncated"):
        ser.from_bytes(blob[:-8], device=CPU)
    with pytest.raises(ValueError, match="bad ciphertext magic"):
        ser.load_ciphertext(io.BytesIO(blob), CPU)
    with pytest.raises(ValueError, match="a key is"):
        ser.to_bytes(torch.zeros(3))
    with pytest.raises(ValueError, match="truncated"):
        ref.load_ciphertext_ref(io.BytesIO(_blob("ct1.bin")[:100]), CPU)


def test_jax_keys_classes_match_ranks():
    """The port tells key kinds apart by rank; the JAX classes' data
    ranks are the same (secret 2, public 3, relin 4, Galois 5)."""
    import jax.numpy as jnp
    z = jnp.zeros
    for kind, obj in enumerate((jkeys.SecretKey(z((2, 4))),
                                jkeys.PublicKey(z((2, 2, 4))),
                                jkeys.RelinKey(z((1, 2, 2, 4))),
                                jkeys.GaloisKeys(z((1, 1, 2, 2, 4)), (3,)))):
        blob = jser.to_bytes(obj)
        assert blob[5] == kind
        port = ser.from_bytes(blob, device=CPU)
        assert ser.key_kind(port) == kind
        assert ser.to_bytes(port) == blob


def test_serialization_example():
    """examples/serialization.py (JAX examples/4_serialization.py) on the
    CPU: it raises on a wrong decryption or a byte that does not
    survive."""
    import runpy
    path = os.path.join(ROOT, "phantom_tpu_torch", "examples",
                        "serialization.py")
    runpy.run_path(path)["demo"](device="cpu")

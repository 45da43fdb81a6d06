"""Fast32: the user-facing evaluator over every level of the chain.

Counterpart of phantom_tpu/fast32.py: a per-context wrapper that builds
each chain level's state on first use (the key-switch tables, the relin
evk, the rotation state, the rescale, BFV and BGV pipelines of
ops/pipeline32.py, bfv32.py and bgv32.py) and runs the evaluator's verbs
on int32 ciphertexts: keygen, public-key encryption, add, sub, negate,
the plain ops, multiply, relinearize, square, rescale and modulus switch
level by level, rotations and both hoisted forms, decryption.  Every verb
is bit-equal to the JAX package's Fast32 on the same inputs
(tests/test_torch_fast32.py).

The port holds every ciphertext as int32 residues, so Fast32's `Ct32` is
the port's Ciphertext (schemes/ciphertext.py); keys are tensors (the
secret (K, N), the public (2, K, N), the relin key (dnum, 2, K, N)) and
keys.GaloisKeys.  Randomness comes from an explicit `torch.Generator`.
Each verb that runs a kernel takes `ops`, the kernels it calls
(pipeline32.KERNELS, the default, or PLAIN).  Everything runs on the
context's device: the CUDA device unless the context was built with
device="cpu", where each kernel wrapper takes its plain version.

Usage:
    ctx = make_context(params)                   # on the CUDA device
    ev = Fast32(ctx)
    sk = ev.gen_secret_key(gen)
    pk = ev.gen_public_key(sk, gen)
    ev = Fast32(ctx, rlk=ev.gen_relin_key(sk, gen),
                glk=ev.create_galois_keys(sk, gen, steps=[1]))
    c = ev.encrypt_asymmetric(pk, CKKSEncoder(ctx).encode(z, scale), gen)
    c = ev.rescale_to_next(ev.multiply_and_relin(c, c))
    c = ev.rotate(c, 1)
    z2 = CKKSEncoder(ctx).decode(ev.decrypt(sk, c))

Engines: "mxu-pallas" (the default) and "pallas-roll" (every transform
K6, the modup on the xla-split structure, the CKKS tensor terms added
after the moddown pair), as the ops run them; the JAX package's
butterfly ("xla", use_pallas=False) and einsum ("mxu") engines have no
counterpart and raise. BFV multiplies by the context's `mul_tech`, as
the JAX package's Fast32 does: "hps", "behz", "hps_overq" or
"hps_overq_leveled" (ops/bfv32.py); the leveled technique's pipeline is
built at the drop the noise model gives for noise_scale_deg 1, at the
full level, and adds 1 to the product's noise_scale_deg. """

from __future__ import annotations

import math
from typing import Sequence

import torch

from .ops import bfv32, bgv32
from .ops import pipeline32 as pp
from .ops.modmath32 import u32
from .ops.pipeline32 import KERNELS, Kernels
from .schemes import keys
from .schemes.ciphertext import Ciphertext, Plaintext
from .schemes.context import Context

Ct32 = Ciphertext
# BFV's multiply and multiply + relinearize per mul_tech
_BFV_MULT = {
    "hps": (bfv32.bfv_mult32, bfv32.bfv_mult_relin32),
    "behz": (bfv32.bfv_mult_behz32, bfv32.bfv_mult_relin_behz32),
    "hps_overq": (bfv32.bfv_mult_hps_overq32, bfv32.bfv_mult_relin_overq32),
    "hps_overq_leveled": (bfv32.bfv_mult_leveled32,
                          bfv32.bfv_mult_relin_leveled32),
}


def _qcol(q: torch.Tensor) -> torch.Tensor:
    return u32(q).view(-1, 1)


def _pad_to(data: torch.Tensor, size: int) -> torch.Tensor:
    if data.shape[0] == size:
        return data
    return torch.cat([data, data.new_zeros((size - data.shape[0],)
                                           + tuple(data.shape[1:]))])


def _balance_factors(f1: int, f2: int, t: int):
    """BGV's common correction factor: (f, e1, e2) with e1 f1 == e2 f2 == f
    (mod t), gcd(e1, t) == 1 and |e1| + |e2| (centered mod t) least over
    the extended-Euclid convergents of f2 / f1 mod t (the JAX package's
    evaluate._balance_factors)."""
    half = t // 2

    def bal_abs(x):
        return t - x if x > half else x

    ratio = pow(f1 % t, -1, t) * f2 % t
    e1, e2 = ratio, 1
    best = bal_abs(e1) + bal_abs(e2)
    prev_a, a = t, ratio
    prev_b, b = 0, 1
    while a != 0:
        quo = prev_a // a
        prev_a, a = a, prev_a - quo * a
        prev_b, b = b, prev_b - quo * b
        a_mod, b_mod = a % t, b % t
        if a_mod != 0 and math.gcd(a_mod, t) == 1:
            s = bal_abs(a_mod) + bal_abs(b_mod)
            if s < best:
                best, e1, e2 = s, a_mod, b_mod
    return e1 * f1 % t, e1, e2


class Fast32:
    """Per-context evaluator with per-level caches, on the context's
    device.  rlk: the relin key (dnum, 2, K, N); glk: keys.GaloisKeys;
    engine: pipeline32.ENGINES; modup: the key switch's modup route
    (pipeline32.MODUP_ROUTES; "auto" on "pallas-roll")."""

    def __init__(self, ctx: Context, rlk=None, glk=None,
                 engine: str = pp.DEFAULT_ENGINE, modup: str = "auto"):
        if engine not in pp.ENGINES:
            raise ValueError(
                f"engine {engine!r}: the port runs {pp.ENGINES}; the JAX "
                "package's butterfly (use_pallas=False) and einsum (\"mxu\")"
                " engines have no counterpart")
        ctx.require_u32("Fast32")
        if modup not in pp.MODUP_ROUTES:
            raise ValueError(f"modup {modup!r} not in {pp.MODUP_ROUTES}")
        self.ctx = ctx
        self.rlk = rlk
        self.glk = glk
        self.engine = engine
        self.modup = modup
        self.scheme = ctx.params.scheme
        self.device = ctx.key_q.device
        self._ks = {}       # chain_index -> KeySwitch32
        self._evk = {}      # chain_index -> relin evk
        self._galois = {}   # chain_index -> Galois32
        self._ckks = {}     # chain_index -> CKKSPipeline32 (its rescale)
        self._bfv = {}      # chain_index -> BFVPipeline32
        self._bgv = {}      # chain_index -> BGVPipeline32

    # -- conversions --------------------------------------------------------
    def from_ciphertext(self, ct: Ciphertext) -> Ct32:
        """A Ciphertext on the context's device (Ct32 is Ciphertext)."""
        return ct.replace(data=ct.data.to(self.device))

    def to_ciphertext(self, c: Ct32) -> Ciphertext:
        return c

    # -- per-level caches ----------------------------------------------------
    def prebuild(self, ci: int) -> "Fast32":
        """Build every cache this level can need now, not on first use."""
        self.keyswitch_at(ci)
        if self.rlk is not None:
            self.evk_at(ci)
            if self.scheme == "bfv":
                self._bfv_at(ci)
            elif self.scheme == "bgv":
                if ci + 1 < len(self.ctx.chain):
                    self._bgv_at(ci)
        if self.scheme == "ckks" and ci + 1 < len(self.ctx.chain):
            self._ckks_at(ci)
        if self.glk is not None:
            self.galois_at(ci)
        return self

    def keyswitch_at(self, ci: int) -> pp.KeySwitch32:
        if ci not in self._ks:
            self._ks[ci] = pp.KeySwitch32(self.ctx, ci, self.engine,
                                          self.modup).to(self.device)
        return self._ks[ci]

    def evk_at(self, ci: int) -> torch.Tensor:
        if ci not in self._evk:
            if self.rlk is None:
                raise ValueError("no relinearization key")
            self._evk[ci] = pp.convert_key32(self.ctx, self.rlk, ci)
        return self._evk[ci]

    def galois_at(self, ci: int) -> pp.Galois32:
        if ci not in self._galois:
            if self.glk is None:
                raise ValueError("no Galois keys")
            self._galois[ci] = pp.Galois32(self.ctx, self.glk.data,
                                           self.glk.elts, ci).to(self.device)
        return self._galois[ci]

    def _ckks_at(self, ci: int) -> pp.CKKSPipeline32:
        if ci not in self._ckks:
            self._ckks[ci] = pp.CKKSPipeline32(
                self.ctx, None, ci, modup=self.modup,
                ks=self.keyswitch_at(ci)).to(self.device)
        return self._ckks[ci]

    def _bfv_at(self, ci: int):
        """The level's BFV pipeline for the context's mul_tech: BFVBehz32,
        BFVLeveled32 (at the full level) or BFVPipeline32 (HPS and
        HPSoverQ)."""
        if ci not in self._bfv:
            mt = self.ctx.params.mul_tech
            if mt == "behz":
                p = bfv32.BFVBehz32(self.ctx, self.evk_at(ci), ci,
                                    self.engine, ks=self.keyswitch_at(ci))
            elif mt == "hps_overq_leveled":
                p = bfv32.BFVLeveled32(
                    self.ctx, self.evk_at(1), bfv32.levels_to_drop(self.ctx),
                    self.engine, ks=self.keyswitch_at(1))
            else:
                p = bfv32.BFVPipeline32(self.ctx, self.evk_at(ci), ci,
                                        self.engine, ks=self.keyswitch_at(ci))
            self._bfv[ci] = p.to(self.device)
        return self._bfv[ci]

    def _bfv_mult(self, c1: Ct32, c2: Ct32, relin: bool,
                  ops: Kernels) -> Ct32:
        """BFV multiply (+ relinearize) by the context's mul_tech."""
        p = self._bfv_at(c1.chain_index)
        mt = self.ctx.params.mul_tech
        fn = _BFV_MULT[mt][relin]
        nsd = max(c1.noise_scale_deg, c2.noise_scale_deg) + (
            1 if mt == "hps_overq_leveled" else 0)
        return c1.replace(data=fn(p, c1.data, c2.data, ops),
                          noise_scale_deg=nsd)

    def _bgv_at(self, ci: int) -> bgv32.BGVPipeline32:
        if ci not in self._bgv:
            evk = None if self.rlk is None else self.evk_at(ci)
            self._bgv[ci] = bgv32.BGVPipeline32(
                self.ctx, evk, ci, self.engine, self.modup,
                ks=self.keyswitch_at(ci)).to(self.device)
        return self._bgv[ci]

    # -- elementwise verbs --------------------------------------------------
    def _q(self, ci: int) -> torch.Tensor:
        """(size_ql, 1) int64 moduli of the level."""
        return _qcol(self.ctx.key_q[:self.ctx.get_context_data(ci).size_ql])

    def add(self, c1: Ct32, c2: Ct32) -> Ct32:
        if self.scheme == "bgv" and c1.correction_factor != \
                c2.correction_factor:
            c1, c2 = self._balance(c1, c2)
        size = max(c1.size, c2.size)
        out = (_pad_to(c1.data, size).long() + _pad_to(c2.data, size)) % \
            self._q(c1.chain_index)
        return c1.replace(data=out.int())

    def sub(self, c1: Ct32, c2: Ct32) -> Ct32:
        if self.scheme == "bgv" and c1.correction_factor != \
                c2.correction_factor:
            c1, c2 = self._balance(c1, c2)
        size = max(c1.size, c2.size)
        out = (_pad_to(c1.data, size).long() - _pad_to(c2.data, size)) % \
            self._q(c1.chain_index)
        return c1.replace(data=out.int())

    def negate(self, c: Ct32) -> Ct32:
        return c.replace(data=(-c.data.long() % self._q(c.chain_index)).int())

    def _balance(self, c1: Ct32, c2: Ct32):
        """Bring two BGV ciphertexts to one correction factor, each times
        its centered multiplier."""
        t = self.ctx.params.plain_modulus
        f, m1, m2 = _balance_factors(c1.correction_factor,
                                     c2.correction_factor, t)
        q = self._q(c1.chain_index)

        def scale(c, m):
            if m == 1:
                return c.replace(correction_factor=f)
            neg = m > t // 2
            out = c.data.long() * (t - m if neg else m) % q
            if neg:
                out = -out % q
            return c.replace(data=out.int(), correction_factor=f)

        return scale(c1, m1), scale(c2, m2)

    def _plain_rns(self, ci: int, plain: Plaintext, ops: Kernels):
        """A plaintext as residues in the ciphertext's domain: BFV
        round(Ql m / t) in coefficient form, CKKS its NTT residues, BGV the
        centered lift in NTT form."""
        if self.scheme == "bfv":
            return keys.scale_plain_up(self.ctx, plain.data[0], ci)
        if self.scheme == "ckks":
            return plain.data.long()
        return keys.bgv_lift_plain_ntt(
            self.ctx, plain.data[0], self.ctx.get_context_data(ci).size_ql,
            ops).long()

    def _bgv_scaled(self, c: Ct32, plain: Plaintext) -> Plaintext:
        """BGV: the plaintext times the ciphertext's correction factor mod
        t, so that it enters at the ciphertext's factor."""
        if self.scheme != "bgv":
            return plain
        t = self.ctx.params.plain_modulus
        f = c.correction_factor % t
        if f == 1:
            return plain
        return plain.replace(data=(plain.data.long() * f % t).int())

    def add_plain(self, c: Ct32, plain: Plaintext,
                  ops: Kernels = KERNELS) -> Ct32:
        plain = self._bgv_scaled(c, plain)
        q = self._q(c.chain_index)
        c0 = (c.data[0].long() + self._plain_rns(c.chain_index, plain, ops)
              ) % q
        return c.replace(data=torch.cat([c0.int()[None], c.data[1:]]))

    def sub_plain(self, c: Ct32, plain: Plaintext,
                  ops: Kernels = KERNELS) -> Ct32:
        plain = self._bgv_scaled(c, plain)
        q = self._q(c.chain_index)
        c0 = (c.data[0].long() - self._plain_rns(c.chain_index, plain, ops)
              ) % q
        return c.replace(data=torch.cat([c0.int()[None], c.data[1:]]))

    def multiply_plain(self, c: Ct32, plain: Plaintext,
                       ops: Kernels = KERNELS) -> Ct32:
        ci = c.chain_index
        q = self._q(ci)
        if self.scheme == "bfv":
            # coefficient form: the centered lift of m and the ciphertext in
            # one forward NTT, the dyadic product, the inverse
            ks = self.keyswitch_at(ci)
            m = keys.lift_plain_centered(self.ctx, plain.data[0], ks.size_ql)
            x = pp._fwd(ks, torch.cat([m[None], c.data]), ks.rows_ql,
                        ops).long()
            prod = (x[1:] * x[:1] % q).int()
            return c.replace(data=pp._inv(ks, prod, ks.rows_ql, ops))
        prod = (c.data.long() * self._plain_rns(ci, plain, ops) % q).int()
        if self.scheme == "ckks":
            return c.replace(data=prod, scale=c.scale * plain.scale)
        return c.replace(data=prod)

    # -- multiply / relinearize ---------------------------------------------
    def _relin_ckks(self, c: Ct32, d1: torch.Tensor, d2: torch.Tensor,
                    ops: Kernels) -> torch.Tensor:
        """CKKS: c2 = d1[1] d2[1] key-switched, the moddown pair adding the
        tensor terms c0, c1 in its epilogue (on "pallas-roll" after it, in
        plain torch)."""
        ci = c.chain_index
        ks = self.keyswitch_at(ci)
        q = self._q(ci)
        c2 = (d1[1].long() * d2[1].long() % q).int()
        s0, s1 = pp.modup_ip32(ks, c2, self.evk_at(ci), ops)
        if ks.engine == pp.ROLL_ENGINE:
            c0, c1, _ = pp._tensor_2x2(q, d1, d2)
            m0, m1 = pp.moddown32_pair(ks, s0, s1, ops=ops)
            return torch.stack([(c0 + m0) % q, (c1 + m1) % q]).int()
        return torch.stack(pp.moddown32_pair(ks, s0, s1, (d1, d2), ops))

    def multiply_and_relin(self, c1: Ct32, c2: Ct32,
                           ops: Kernels = KERNELS) -> Ct32:
        ci = c1.chain_index
        if self.scheme == "ckks":
            return c1.replace(data=self._relin_ckks(c1, c1.data, c2.data, ops),
                              scale=c1.scale * c2.scale)
        if self.scheme == "bfv":
            return self._bfv_mult(c1, c2, True, ops)
        out = bgv32.bgv_mult_relin32(self._bgv_at(ci), c1.data, c2.data, ops)
        t = self.ctx.params.plain_modulus
        return c1.replace(data=out, correction_factor=(
            c1.correction_factor * c2.correction_factor) % t)

    def multiply(self, c1: Ct32, c2: Ct32, ops: Kernels = KERNELS) -> Ct32:
        """The unrelinearized product, a size-3 ciphertext."""
        ci = c1.chain_index
        if self.scheme == "bfv":
            return self._bfv_mult(c1, c2, False, ops)
        out = torch.stack(pp._tensor_2x2(self._q(ci), c1.data,
                                         c2.data)).int()
        if self.scheme == "ckks":
            return c1.replace(data=out, scale=c1.scale * c2.scale)
        t = self.ctx.params.plain_modulus
        return c1.replace(data=out, correction_factor=(
            c1.correction_factor * c2.correction_factor) % t)

    def relinearize(self, c: Ct32, ops: Kernels = KERNELS) -> Ct32:
        """Size 3 -> size 2 through the relin key."""
        if c.size != 3:
            raise ValueError("relinearize expects a size-3 ciphertext")
        ci = c.chain_index
        ks = self.keyswitch_at(ci)
        evk = self.evk_at(ci)
        if c.is_ntt_form:
            sw = pp.keyswitch_from_ntt32(ks, c.data[2], evk, ops)
        else:
            sw = pp._inv(ks, pp.keyswitch32(ks, c.data[2], evk, ops),
                         ks.rows_ql, ops)
        out = (c.data[:2].long() + sw) % self._q(ci)
        return c.replace(data=out.int())

    def square_and_relin(self, c: Ct32, ops: Kernels = KERNELS) -> Ct32:
        ci = c.chain_index
        if self.scheme == "ckks":
            return c.replace(data=self._relin_ckks(c, c.data, c.data, ops),
                             scale=c.scale * c.scale)
        if self.scheme == "bgv":
            q = self._q(ci)
            t0, t1, t2 = pp._tensor_square_2x2(q, c.data)
            sw = pp.keyswitch_from_ntt32(self.keyswitch_at(ci), t2.int(),
                                         self.evk_at(ci), ops)
            out = torch.stack([(t0 + sw[0]) % q, (t1 + sw[1]) % q]).int()
            t = self.ctx.params.plain_modulus
            return c.replace(data=out,
                             correction_factor=c.correction_factor ** 2 % t)
        return self.multiply_and_relin(c, c, ops)

    # -- rescale / modulus switch -----------------------------------------
    def rescale_to_next(self, c: Ct32, ops: Kernels = KERNELS) -> Ct32:
        if self.scheme != "ckks":
            raise ValueError("rescale is CKKS-only")
        p = self._ckks_at(c.chain_index)
        qlast = self.ctx.params.data_moduli[p.ks.size_ql - 1]
        return c.replace(data=pp._rescale(p, c.data, ops),
                         chain_index=c.chain_index + 1,
                         scale=c.scale / qlast)

    def mod_switch_to_next(self, c: Ct32, ops: Kernels = KERNELS) -> Ct32:
        ci = c.chain_index
        k = self.ctx.get_context_data(ci).size_ql
        if self.scheme == "ckks":
            return c.replace(data=c.data[..., :k - 1, :].contiguous(),
                             chain_index=ci + 1)
        if self.scheme == "bgv":
            out = bgv32.bgv_mod_switch32(self._bgv_at(ci), c.data, ops)
            t = self.ctx.params.plain_modulus
            qlast = self.ctx.params.data_moduli[k - 1]
            return c.replace(data=out, chain_index=ci + 1,
                             correction_factor=c.correction_factor * pow(
                                 qlast % t, -1, t) % t)
        # BFV: round(x / q_last) in coefficient form
        rc = self.ctx.get_context_data(ci).rescale
        q = self._q(ci)
        xl = (c.data[..., k - 1:k, :].long() + rc.half) % q[k - 1]
        rest = q[:k - 1]
        delta = (xl % rest - torch.tensor(rc.half_mod_q, device=self.device
                                          ).view(-1, 1)) % rest
        diff = (c.data[..., :k - 1, :].long() - delta) % rest
        qinv = torch.tensor(rc.qlast_inv, device=self.device).view(-1, 1)
        return c.replace(data=(diff * qinv % rest).int(), chain_index=ci + 1)

    # -- rotations ------------------------------------------------------------
    def rotate(self, c: Ct32, step: int, ops: Kernels = KERNELS) -> Ct32:
        ci = c.chain_index
        return c.replace(data=pp.rotate32(
            self.keyswitch_at(ci), self.galois_at(ci), c.data, step, ops,
            is_ntt_form=c.is_ntt_form))

    def apply_galois(self, c: Ct32, elt: int, ops: Kernels = KERNELS) -> Ct32:
        ci = c.chain_index
        f = pp.apply_galois32 if c.is_ntt_form else pp.apply_galois_coeff32
        return c.replace(data=f(self.keyswitch_at(ci), self.galois_at(ci),
                                c.data, elt, ops))

    def hoisting(self, c: Ct32, steps: Sequence[int],
                 ops: Kernels = KERNELS) -> Ct32:
        """sum_s rotate(c, s) with one modup (NTT form)."""
        ci = c.chain_index
        return c.replace(data=pp.hoisting_sum32(
            self.keyswitch_at(ci), self.galois_at(ci), c.data, steps, ops))

    def hoisted_linear_combo(self, c: Ct32, steps: Sequence[int], pts_qlp,
                             pts_scale: float = 1.0,
                             ops: Kernels = KERNELS) -> Ct32:
        """sum_s pt_s * rotate(c, s) with one modup and one moddown (the
        CKKS matvec primitive); pts_qlp: per step the (size_qlp, N) weights
        of ckks_encoder.encode_extended."""
        ci = c.chain_index
        out = pp.hoisted_linear_combo32(
            self.keyswitch_at(ci), self.galois_at(ci), c.data, steps,
            [p.to(self.device) for p in pts_qlp], ops)
        return c.replace(data=out, scale=c.scale * pts_scale)

    # -- key generation -------------------------------------------------------
    def gen_secret_key(self, gen: torch.Generator,
                       ops: Kernels = KERNELS) -> torch.Tensor:
        return keys.gen_secret_key(self.ctx, gen, ops)

    def gen_public_key(self, sk: torch.Tensor, gen: torch.Generator,
                       ops: Kernels = KERNELS) -> torch.Tensor:
        return keys.gen_public_key(self.ctx, sk, gen, ops)

    def gen_relin_key(self, sk: torch.Tensor, gen: torch.Generator,
                      ops: Kernels = KERNELS) -> torch.Tensor:
        return keys.gen_relin_key(self.ctx, sk, gen, ops)

    def create_galois_keys(self, sk: torch.Tensor, gen: torch.Generator,
                           steps=None, elts=None,
                           ops: Kernels = KERNELS) -> keys.GaloisKeys:
        return keys.create_galois_keys(self.ctx, sk, gen, steps, elts, ops)

    # -- encrypt / decrypt ----------------------------------------------------
    def encrypt_asymmetric(self, pk: torch.Tensor, plain: Plaintext,
                           gen: torch.Generator,
                           ops: Kernels = KERNELS) -> Ct32:
        ci = (plain.chain_index if self.scheme == "ckks"
              else self.ctx.first_data_index)
        return keys.encrypt_asymmetric(self.ctx, pk, plain, gen,
                                       self.keyswitch_at(ci), ops)

    def decrypt(self, sk: torch.Tensor, c: Ct32,
                ops: Kernels = KERNELS) -> Plaintext:
        """CKKS: the NTT-form plaintext at the ciphertext's level and
        scale; BFV and BGV: the message (1, N) mod t (BGV's divided by the
        correction factor)."""
        data = c.data
        if self.scheme == "ckks" and not c.is_ntt_form:
            ks = self.keyswitch_at(c.chain_index)
            data = pp._fwd(ks, data, ks.rows_ql, ops)
        m = keys.decrypt(self.ctx, sk, data, c.correction_factor, ops)
        if self.scheme == "ckks":
            return Plaintext(data=m, chain_index=c.chain_index,
                             is_ntt_form=True, scale=c.scale)
        return Plaintext(data=m.int().view(1, -1), chain_index=c.chain_index)

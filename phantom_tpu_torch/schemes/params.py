"""Encryption parameters (counterpart of phantom_tpu/schemes/params.py).

The port runs the reference's three schemes: CKKS, BFV and BGV.  A
parameter set is a power-of-two degree n, the data primes, the special
primes of hybrid key switching (alpha of them) and, for BFV and BGV, the
plain modulus t, a prime == 1 mod 2n below every data prime (batching).
`mul_tech` names BFV's multiplication technique as the JAX package's
MulTech does (MUL_TECHS), `sec_level` the HE-standard security level the
coefficient modulus must meet (128, 192 or 256 bits; 0, the default,
checks nothing), and `galois_elts` the Galois elements whose keys
create_galois_keys makes by default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from ..host import hestd

SCHEMES = ("ckks", "bfv", "bgv")
# the JAX package's MulTech: BEHZ, HPS, HPS_OVERQ, HPS_OVERQ_LEVELED
MUL_TECHS = ("behz", "hps", "hps_overq", "hps_overq_leveled")


@dataclass(frozen=True)
class EncryptionParameters:
    n: int
    data_moduli: Tuple[int, ...]
    special_moduli: Tuple[int, ...]
    scheme: str = "ckks"
    plain_modulus: int = 0
    mul_tech: str = "hps"
    sec_level: int = 0
    galois_elts: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.n < 2 or self.n & (self.n - 1):
            raise ValueError("poly_modulus_degree must be a power of two")
        if not self.data_moduli or not self.special_moduli:
            raise ValueError("need at least one data and one special prime")
        if self.scheme not in SCHEMES:
            raise ValueError(f"scheme {self.scheme!r} not in {SCHEMES}")
        if self.scheme in ("bfv", "bgv"):
            t = self.plain_modulus
            if t < 2 or (t - 1) % (2 * self.n):
                raise ValueError("plain modulus must support batching "
                                 "(== 1 mod 2N)")
            if t >= min(self.data_moduli):
                raise ValueError("plain modulus must be below every data "
                                 "prime")
        elif self.plain_modulus:
            raise ValueError("CKKS takes no plain modulus")
        if self.mul_tech not in MUL_TECHS:
            raise ValueError(f"mul_tech {self.mul_tech!r} not in {MUL_TECHS}")
        total_bits = sum(q.bit_length() for q in self.coeff_modulus)
        if self.sec_level and total_bits > hestd.max_coeff_modulus_bits(
                self.n, self.sec_level):
            raise ValueError(
                f"coeff modulus ({total_bits} bits) exceeds HE-std budget for "
                f"N={self.n} at {self.sec_level}-bit security")

    @staticmethod
    def create(n: int, data_moduli: Sequence[int],
               special_moduli: Sequence[int], scheme: str = "ckks",
               plain_modulus: int = 0, *, mul_tech: str = "hps",
               sec_level: int = 0,
               galois_elts: Sequence[int] = ()) -> "EncryptionParameters":
        return EncryptionParameters(
            n=int(n), data_moduli=tuple(int(q) for q in data_moduli),
            special_moduli=tuple(int(p) for p in special_moduli),
            scheme=scheme, plain_modulus=int(plain_modulus),
            mul_tech=mul_tech, sec_level=int(sec_level),
            galois_elts=tuple(int(e) for e in galois_elts))

    @property
    def coeff_modulus(self) -> Tuple[int, ...]:
        return self.data_moduli + self.special_moduli

    @property
    def size_q(self) -> int:
        return len(self.data_moduli)

    @property
    def size_p(self) -> int:
        return len(self.special_moduli)

    @property
    def size_qp(self) -> int:
        return self.size_q + self.size_p

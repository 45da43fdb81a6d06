"""RNS bases and base converters (exact integers).

The port's copy of what it uses of phantom_tpu/host/rns.py: the punctured
products Q/q_i with their inverses, and the cross-base matrix
[Q/q_i mod p_j] with Q mod p_j.
"""

from __future__ import annotations

from math import gcd
from typing import List, Sequence

from .numth import invert_mod


class RNSBase:
    """An ordered RNS base {q_0 .. q_{k-1}} with its CRT constants."""

    def __init__(self, moduli: Sequence[int]):
        self.moduli: List[int] = [int(m) for m in moduli]
        k = len(self.moduli)
        if k == 0:
            raise ValueError("empty RNS base")
        for i in range(k):
            for j in range(i + 1, k):
                if gcd(self.moduli[i], self.moduli[j]) != 1:
                    raise ValueError("RNS moduli must be pairwise coprime")
        self.prod = 1
        for q in self.moduli:
            self.prod *= q
        self.punctured = [self.prod // q for q in self.moduli]
        self.qhat_mod_qi = [p % q for p, q in zip(self.punctured, self.moduli)]
        self.qhat_inv_mod_qi = [invert_mod(h, q)
                                for h, q in zip(self.qhat_mod_qi, self.moduli)]


class BaseConverter:
    """Constants to convert from ibase to obase:
      y_i   = [x_i (Q/q_i)^-1]_{q_i}
      out_j = [sum_i y_i (Q/q_i) - v Q]_{p_j},  v = floor(sum_i y_i / q_i)."""

    def __init__(self, ibase: RNSBase, obase: RNSBase):
        self.ibase = ibase
        self.obase = obase
        # (k_out, k_in) punctured products mod p_j
        self.qhat_mod_p = [[h % p for h in ibase.punctured]
                           for p in obase.moduli]
        self.q_mod_p = [ibase.prod % p for p in obase.moduli]

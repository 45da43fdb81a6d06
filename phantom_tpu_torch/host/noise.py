"""BFV noise-growth model for leveled HPS multiplication.

The port's copy of phantom_tpu/host/noise.py, verbatim.  Host-side
equivalent of the reference's FindLevelsToDrop
(src/evaluate.cu:550-643), itself derived from the OpenFHE BFV noise
estimator (Kim-Polyakov-Zucca, ePrint 2021/204 Appendix D): estimates how
many RNS limbs can be dropped before a multiplication while preserving
correctness, given the multiplicative depth consumed so far.
"""

from __future__ import annotations

import math

SIGMA = 3.2           # error distribution parameter (hestdparms sigma)
ALPHA_ASSURANCE = 36  # assurance measure (reference: assuranceMeasure)


def find_levels_to_drop(n: int, size_q: int, size_p: int, num_part_q: int,
                        plain_modulus: int, dcrt_bits: float,
                        multiplicative_depth: int, is_key_switch: bool,
                        is_asymmetric: bool) -> int:
    """Return the number of RNS limbs that can safely be dropped."""
    p = float(plain_modulus)
    k = size_p
    bkey = 1.0  # ternary key, single party
    berr = SIGMA * math.sqrt(ALPHA_ASSURANCE)

    def delta(nn):
        return 2.0 * math.sqrt(nn)

    def vnorm(nn):
        if is_asymmetric:
            return (1.0 + delta(nn) * bkey) / 2.0
        return berr * (1.0 + 2.0 * delta(nn) * bkey)

    def noise_ks(nn):
        return k * (num_part_q * delta(nn) * berr + delta(nn) * bkey
                    + 1.0) / 2.0

    def c1(nn):
        return delta(nn) * delta(nn) * p * bkey

    def c2(nn):
        return (delta(nn) * delta(nn) * bkey * bkey / 2.0 + noise_ks(nn))

    def logq_bfv(nn):
        if multiplicative_depth > 0:
            return (math.log(4 * p)
                    + (multiplicative_depth - 1) * math.log(c1(nn))
                    + math.log(c1(nn) * vnorm(nn)
                               + multiplicative_depth * c2(nn)))
        return math.log(p * 4 * vnorm(nn))

    logq = logq_bfv(n)  # fixed point of the reference's iteration
    loge = logq / math.log(2) - 2 - math.log2(p)
    log_extra = (math.log2(noise_ks(n)) if is_key_switch
                 else math.log2(delta(n)))
    levels = math.floor(
        (loge - 2 * multiplicative_depth - 16 - log_extra) / dcrt_bits)
    return max(0, min(levels, size_q - 1))

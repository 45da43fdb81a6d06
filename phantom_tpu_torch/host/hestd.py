"""HomomorphicEncryption.org standard security tables (the port's copy of
phantom_tpu/host/hestd.py).

Maximum total coefficient-modulus bit counts per ring dimension and security
level, for ternary-secret distributions (the only secret distribution the
reference supports).  Equivalent of include/host/hestdparms.h:14-153.
These are the published HE-standard constants.
"""

from __future__ import annotations

# n -> max log2(Q), ternary secrets, classical security
# (reference: he_std_parms_{128,192,256}_tc, hestdparms.h:14-75)
_TABLE_128 = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438,
              32768: 881, 65536: 1777, 131072: 3576}
_TABLE_192 = {1024: 19, 2048: 37, 4096: 75, 8192: 151, 16384: 304,
              32768: 611, 65536: 1229, 131072: 2469}
_TABLE_256 = {1024: 14, 2048: 29, 4096: 58, 8192: 118, 16384: 237,
              32768: 476, 65536: 955, 131072: 1918}
# quantum security variants (he_std_parms_*_tq, hestdparms.h:82-148)
_TABLE_128Q = {1024: 25, 2048: 51, 4096: 101, 8192: 204, 16384: 410,
               32768: 826, 65536: 1664, 131072: 3349}
_TABLE_192Q = {1024: 17, 2048: 35, 4096: 70, 8192: 141, 16384: 284,
               32768: 570, 65536: 1145, 131072: 2302}
_TABLE_256Q = {1024: 13, 2048: 27, 4096: 54, 8192: 109, 16384: 220,
               32768: 443, 65536: 889, 131072: 1784}

_TABLES = {0: None, 128: _TABLE_128, 192: _TABLE_192, 256: _TABLE_256}
_TABLES_QUANTUM = {128: _TABLE_128Q, 192: _TABLE_192Q, 256: _TABLE_256Q}

HE_STD_PARMS_ERROR_STD_DEV = 3.2  # reference: hestdparms.h noise sigma


def max_coeff_modulus_bits(poly_modulus_degree: int,
                           sec_level: int = 128) -> int:
    """Largest allowed log2(prod q_i) for the given N and security level.

    sec_level = 0 disables enforcement (returns a huge bound), matching the
    reference's sec_level_type::none behavior.
    """
    if sec_level == 0:
        return 1 << 20
    table = _TABLES.get(sec_level)
    if table is None:
        raise ValueError(f"unsupported security level {sec_level}")
    if poly_modulus_degree in table:
        return table[poly_modulus_degree]
    return 0


def max_coeff_modulus_bits_quantum(poly_modulus_degree: int,
                                   sec_level: int = 128) -> int:
    """Quantum-security variant (reference: he_std_parms_*_tq)."""
    table = _TABLES_QUANTUM.get(sec_level)
    if table is None:
        raise ValueError(f"unsupported security level {sec_level}")
    return table.get(poly_modulus_degree, 0)

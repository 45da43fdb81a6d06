"""Plaintext and Ciphertext containers (counterpart of
phantom_tpu/schemes/ciphertext.py).

Dataclasses over int32 tensors of residues below 2^30, with the JAX
package's bookkeeping fields: `chain_index`, `is_ntt_form`, the CKKS
`scale`, the BGV `correction_factor` and BFV's `noise_scale_deg`.  Layout:
a Ciphertext is (size, L, N); a Plaintext is (L, N) NTT residues for CKKS
(or (size_qlp, N) from encode_extended) and (1, N) coefficients mod t for
BFV and BGV.  `replace` returns a copy with some fields changed, as the
JAX package's flax dataclasses do.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Plaintext:
    data: torch.Tensor
    chain_index: int = 0
    is_ntt_form: bool = False
    scale: float = 1.0

    def replace(self, **kw) -> "Plaintext":
        return dataclasses.replace(self, **kw)

    @property
    def poly_modulus_degree(self) -> int:
        return self.data.shape[-1]


@dataclass(frozen=True)
class Ciphertext:
    data: torch.Tensor
    chain_index: int = 1
    is_ntt_form: bool = False
    scale: float = 1.0
    correction_factor: int = 1
    noise_scale_deg: int = 1

    def replace(self, **kw) -> "Ciphertext":
        return dataclasses.replace(self, **kw)

    @property
    def size(self) -> int:
        return self.data.shape[0]

    @property
    def coeff_modulus_size(self) -> int:
        return self.data.shape[1]

    @property
    def poly_modulus_degree(self) -> int:
        return self.data.shape[2]

"""Random polynomials from an explicit `torch.Generator`.

Counterpart of phantom_tpu/ops/sampling.py:36-121, with the same
distributions but not the same bits (JAX draws from threefry):
  - uniform: independent per limb, two 62-bit draws (hi, lo) per residue
    read as hi 2^62 + lo, a 124-bit integer, reduced mod q (statistical
    distance < q / 2^124 < 2^-94 from uniform per residue; the reference
    reduces 128 bits, phantom_tpu/ops/sampling.py:36-52);
  - ternary: one vector in {-1, 0, 1}, lifted to every limb;
  - error: centered binomial over 21 bit pairs (sigma = sqrt(42)/2 ~ 3.24),
    one vector lifted to every limb.
Draws land on the generator's device.  The arithmetic that uses them
(keygen, encryption: schemes/keys.py) takes the drawn tensors, so tests
can feed it the JAX package's own draws.
"""

from __future__ import annotations

import torch

from .modmath32 import mul_mod_shoup32, u32

CBD_BITS = 21
DRAW_BITS = 62  # bits of one uniform draw, below int64's sign bit


def sample_uniform_rns(gen: torch.Generator, n: int,
                       q: torch.Tensor) -> torch.Tensor:
    """(L, N) int32, row l uniform in [0, q[l]): (hi 2^62 + lo) mod q for
    two draws hi, lo (hi's (L, N) first), as ((hi mod q) (2^62 mod q) + lo
    mod q) mod q, whose int64 products stay below 2^60."""
    shape = (q.shape[0], n)
    hi = torch.randint(0, 1 << DRAW_BITS, shape, generator=gen,
                       device=gen.device)
    lo = torch.randint(0, 1 << DRAW_BITS, shape, generator=gen,
                       device=gen.device)
    qc = u32(q).view(-1, 1)
    return (((hi % qc) * ((1 << DRAW_BITS) % qc) + lo % qc) % qc).int()


def sample_ternary_vec(gen: torch.Generator, n: int) -> torch.Tensor:
    """(N,) int64 in {-1, 0, 1}: the secret's and encryption's u, one
    vector lifted to every limb."""
    return torch.randint(0, 3, (n,), generator=gen, device=gen.device) - 1


def sample_error_cbd(gen: torch.Generator, n: int) -> torch.Tensor:
    """(N,) int64 centered binomial noise."""
    bits = torch.randint(0, 2, (2, CBD_BITS, n), generator=gen,
                         device=gen.device)
    return bits[0].sum(0) - bits[1].sum(0)


def lift_signed_to_rns32(e: torch.Tensor, q: torch.Tensor, multiplier=None,
                         multiplier_shoup=None) -> torch.Tensor:
    """Signed (..., N) small integers -> (..., L, N) int32 residues mod each
    q[l], times the per-limb `multiplier` (L,) with its 32-bit Shoup word
    (BGV's t e noise) when given."""
    qc = u32(q).view(-1, 1)
    r = e.long().unsqueeze(-2) % qc
    if multiplier is not None:
        r = mul_mod_shoup32(r, u32(multiplier).view(-1, 1),
                            u32(multiplier_shoup).view(-1, 1), qc)
    return r.int()

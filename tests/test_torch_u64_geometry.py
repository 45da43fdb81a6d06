"""U1's launch geometry (ops/ntt.py u64_geometry) and the timing probes of
the cluster core it shares with K1-K8, on the CPU: the kernels themselves
run only on the card (tests/test_torch_gpu.py)."""

import os

import pytest

import chip_smoke
from phantom_tpu_torch import _build
from phantom_tpu_torch.ops import ntt


@pytest.mark.parametrize("logn", range(1, ntt.U64_MAX_LOGN + 1))
def test_u1_geometry_fits(logn):
    """Every N from 2 to 2^17 has a geometry: C = 2^logc <= 8 blocks a
    row, a share of S = N / C >= 2 words (the 16-byte loads take two),
    dynamic shared memory for S words and one pad word per 16, within the
    232,448 bytes a block can opt into, and whole warps of threads."""
    n = 1 << logn
    g = ntt.u64_geometry(n)
    s = n >> g.logc
    assert 0 <= g.logc <= 3 and s >= 2
    assert 8 * (s + (s >> 4)) <= g.smem <= _build.SMEM_OPTIN
    assert 32 <= g.threads <= 256 and g.threads % 32 == 0
    if logn == 16:  # the u64 step's rows: eight 68 KiB shares a row
        assert (g.logc, g.smem) == (3, 69632)


@pytest.mark.parametrize("n", [1, 3, 1 << 18])
def test_u1_geometry_refuses(n):
    with pytest.raises(ValueError):
        ntt.u64_geometry(n)


def test_core_probe_patches_match_source():
    """Each of phase 26's probe patches (chip_smoke.ANATOMY) finds its text
    in csrc/, the generic core's included: a patch that no longer matches
    would stop the smoke on the card."""
    for name, patches in chip_smoke.ANATOMY.items():
        for f, old, _ in patches:
            with open(os.path.join(_build.CSRC, f)) as fh:
                assert old in fh.read(), (name, f)

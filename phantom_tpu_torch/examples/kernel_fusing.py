"""Kernel fusing (the port of the JAX package's examples/5_kernel_fusing.py,
reference examples/4_kernel_fusing.cu:430): U1's inverse NTT with the
scale n^-1 s fused in, against U1's inverse followed by U4's Shoup
product by s; four 50-bit primes at n = 4096.  Both are held equal and
timed with OpTimer's CSV rows.

    python phantom_tpu_torch/examples/kernel_fusing.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phantom_tpu_torch.host import make_rns_ntt_tables, numth  # noqa: E402
from phantom_tpu_torch.host.modulus import compute_shoup  # noqa: E402
from phantom_tpu_torch.ops import ntt as nttmod  # noqa: E402
from phantom_tpu_torch.ops import polyops as po  # noqa: E402
from phantom_tpu_torch.ops.rns_host import i64_tensor  # noqa: E402
from phantom_tpu_torch.schemes.context import resolve_device  # noqa: E402
from phantom_tpu_torch.utils.timer import (OpTimer,  # noqa: E402
                                           print_timer_banner)


def demo(n=4096, device=None, trials=20):
    dev = resolve_device(device)
    qs = numth.get_primes(2 * n, 50, 4)
    tables = nttmod.NTTTables64(make_rns_ntt_tables(n, qs)).to(dev)
    rng = np.random.default_rng(0)
    x = i64_tensor(np.stack([rng.integers(0, q, n, dtype=np.uint64)
                             for q in qs]), dev)
    s_vals = [12345 % q for q in qs]
    ninv_s = [(numth.invert_mod(n, q) * s) % q for s, q in zip(s_vals, qs)]
    scale = i64_tensor(ninv_s, dev)
    scale_shoup = i64_tensor([compute_shoup(v, q)
                              for v, q in zip(ninv_s, qs)], dev)
    by_s = po.limbs(qs, w=s_vals, device=dev)

    def fused(v):
        return nttmod.ntt_inverse(v, tables, scale=scale,
                                  scale_shoup=scale_shoup)

    def separate(v):
        return po.shoup_rns(nttmod.ntt_inverse(v, tables), by_s)

    print_timer_banner()
    t1 = OpTimer("intt_fused_scale", trials=trials)
    r1 = t1.run(fused, x)
    t1.print_csv()
    t2 = OpTimer("intt_then_scale", trials=trials)
    r2 = t2.run(separate, x)
    t2.print_csv()
    if not torch.equal(r1, r2):
        raise AssertionError("fusing changed results")
    print(f"  speedup from fusing: {t2.median_us / t1.median_us:.2f}x")
    return t1.median_us, t2.median_us


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    demo(device=ap.parse_args().device)
    print("kernel fusing example passed")

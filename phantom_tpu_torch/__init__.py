"""phantom_tpu_torch — the PyTorch/CUDA port of phantom_tpu.

A second package beside the JAX one, which stays the reference the port
is tested against.  So far it carries CKKS hybrid key switching: the
multiply + relinearize + rescale step on the three modup routes and with
its three epilogues, rotations and hoisted rotations (ops/pipeline32.py);
the BFV HPS multiply + relinearize step on two engines (ops/bfv32.py);
the BGV multiply + relinearize + modulus-switch step with the
t-corrected moddown (ops/bgv32.py); hand-written CUDA kernels for Hopper
(sm_90a) for its NTTs (two-pass, and one-pass in a thread-block
cluster), base conversions, the fused modup + key inner product (NTT,
coefficient and pre-converted form), the key inner product and the
moddown epilogues (csrc/); keygen (relin and Galois keys), symmetric
encryption and decryption for the three schemes.  It imports torch and numpy
and never JAX, and keeps its own copy of the host math (host/).  Its
entry points build on the CUDA device unless given device="cpu".
"""

__version__ = "0.5.0"

from .schemes.context import Context, make_context  # noqa: F401
from .schemes.keys import create_galois_keys  # noqa: F401
from .schemes.params import EncryptionParameters  # noqa: F401
from .ops.bfv32 import (BFVPipeline32, bfv_mult_relin32,  # noqa: F401
                        build_bfv32)
from .ops.bgv32 import (BGVPipeline32,  # noqa: F401
                        bgv_mult_relin_modswitch32, build_bgv32)
from .ops.pipeline32 import (CKKSPipeline32, Galois32,  # noqa: F401
                             build_galois32, build_keyswitch32,
                             build_pipeline32, hoisted_linear_combo32,
                             hoisting_sum32, keyswitch32,
                             keyswitch_from_ntt32, mult_relin_rescale32,
                             rotate32)

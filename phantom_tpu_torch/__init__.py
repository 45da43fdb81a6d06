"""phantom_tpu_torch — the PyTorch/CUDA port of phantom_tpu.

A second package beside the JAX one, which stays the reference the port
is tested against.  Its user-facing evaluator is `Fast32` (fast32.py):
CKKS, BFV (by the parameters' multiplication technique: HPS, BEHZ,
HPSoverQ or HPSoverQ-leveled) and BGV over every level of the modulus
chain, with keygen (secret, public, relin and Galois keys), public-key
and symmetric encryption, the plain ops, multiply and relinearize,
square, rescale and modulus switch, rotations in NTT and coefficient
form, both hoisted forms and decryption; `BatchEncoder` and
`CKKSEncoder` carry values in and out.  Below it, the ops: hybrid key
switching, the CKKS multiply + relinearize + rescale step on three modup
routes and with three epilogues, rotations and hoisted rotations
(ops/pipeline32.py), the BFV multiply + relinearize by each technique on
two engines (ops/bfv32.py, ops/behz32.py) and the BGV multiply +
relinearize + modulus switch (ops/bgv32.py).  They run on hand-written
CUDA kernels for Hopper (sm_90a, csrc/): the NTTs, all on one one-pass
radix-8 core that holds each row in a thread-block cluster, the base
conversions (on the int8 tensor cores), the fused modup + key inner
product (NTT, coefficient and pre-converted form), the key inner product
and the moddown epilogues.  It imports torch and numpy and never JAX,
and keeps its own copy of the host math (host/).  Its entry points run
on the CUDA device unless the context was built with device="cpu", where
each kernel wrapper takes its plain torch version.
"""

__version__ = "0.7.0"

from .schemes.context import Context, make_context  # noqa: F401
from .schemes.ciphertext import Ciphertext, Plaintext  # noqa: F401
from .schemes.batch_encoder import BatchEncoder  # noqa: F401
from .schemes.ckks_encoder import CKKSEncoder, encode_extended  # noqa: F401
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
from .fast32 import Ct32, Fast32  # noqa: F401

"""phantom_tpu_torch — the PyTorch/CUDA port of phantom_tpu.

A second package beside the JAX one, which stays the reference the port
is tested against.  Its user-facing evaluator is `Fast32` (fast32.py):
CKKS, BFV (by the parameters' multiplication technique: HPS, BEHZ,
HPSoverQ or HPSoverQ-leveled) and BGV over every level of the modulus
chain, with keygen (secret, public, relin and Galois keys), public-key
and symmetric encryption, the plain ops, multiply and relinearize,
square, rescale and modulus switch, rotations in NTT and coefficient
form, both hoisted forms and decryption; `BatchEncoder`, `CKKSEncoder`
(host) and `CKKSDeviceEncoder` (the double-float FFT on the card) carry
values in and out.  On Fast32 sit `LinearTransform` (BSGS matrix-vector
products with one shared modup per layer) and polynomial evaluation in
the monomial and Chebyshev bases (`poly_eval_fast32`,
`poly_eval_cheb_fast32`).  Below it, the ops: hybrid key
switching, the CKKS multiply + relinearize + rescale step on two engines,
three modup routes, two moddown routes and with three epilogues,
rotations and hoisted rotations (ops/pipeline32.py), the BFV multiply +
relinearize by each technique on two engines (ops/bfv32.py,
ops/behz32.py) and the BGV multiply + relinearize + modulus switch on
two engines (ops/bgv32.py).  Primes of 2^30 and more, up to 61 bits,
take the u64 evaluator (schemes/evaluate.py, the JAX package's generic
path) for CKKS, BFV and BGV: every verb, with keygen, encryption and
decryption (schemes/keys.py's u64 half), both CKKS encoders (the device
encoder on F1's wide forms), `LinearTransform.apply`, `poly_eval` and
`poly_eval_cheb`, on u64 words held as int64 tensors and four kernels of
its own, U1-U4 (the NTT, the base conversion, the key inner product and
the Barrett-128 products).  They run on hand-written
CUDA kernels for Hopper (sm_90a, csrc/): the NTTs, all on one one-pass
radix-8 core that holds each row in a thread-block cluster, the base
conversions (on the int8 tensor cores), the fused modup + key inner
product (NTT, coefficient and pre-converted form), the key inner product
and the moddown epilogues; F1, the encoder's double-float FFT; and the
u64 evaluator's U1-U4; and S1, the reference's Salsa20 sampler.  Beside
them sit the wire formats (utils/refformat.py, the reference's, with
seed-compressed ciphertexts; utils/serialize.py, the package's own),
OpTimer, the range sanitizer and a batched StreamExecutor on its own
CUDA stream (runtime/).  It
imports torch and numpy and never JAX, and keeps its own copy of the
host math (host/).  Its entry points run
on the CUDA device unless the context was built with device="cpu", where
each kernel wrapper takes its plain torch version.
"""

__version__ = "0.9.0"

from .schemes.context import Context, make_context  # noqa: F401
from .schemes.ciphertext import Ciphertext, Plaintext  # noqa: F401
from .schemes.batch_encoder import BatchEncoder  # noqa: F401
from .schemes.ckks_encoder import (CKKSDeviceEncoder,  # noqa: F401
                                   CKKSEncoder, encode_extended)
from .schemes.linear import LinearTransform  # noqa: F401
from .schemes.poly import (chebyshev_fit, poly_eval,  # noqa: F401
                           poly_eval_cheb, poly_eval_cheb_fast32,
                           poly_eval_fast32)
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

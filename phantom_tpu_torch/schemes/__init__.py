"""Scheme layer: parameters, context chain, keys, encoders, the linear
transform and polynomial evaluation."""

from .params import EncryptionParameters  # noqa: F401
from .context import Context, make_context  # noqa: F401
from .ciphertext import Ciphertext, Plaintext  # noqa: F401
from . import keys  # noqa: F401
from .batch_encoder import BatchEncoder  # noqa: F401
from .ckks_encoder import (CKKSDeviceEncoder, CKKSEncoder,  # noqa: F401
                           encode_extended)
from .linear import LinearTransform  # noqa: F401
from .poly import (chebyshev_fit, poly_eval_cheb_fast32,  # noqa: F401
                   poly_eval_fast32)

"""Host math of the port: primes, NTT tables, RNS bases and base
converters, in exact integers and numpy.  The port's own copy of what it
needs from phantom_tpu/host/ (which it never loads); the JAX package's
native C++ fast path has no counterpart here."""

from . import modulus, ntt_tables, numth, rns  # noqa: F401
from .modulus import compute_shoup  # noqa: F401
from .ntt_tables import make_rns_ntt_tables  # noqa: F401
from .rns import BaseConverter, RNSBase  # noqa: F401

"""Wire formats, the reference's Salsa20 sampler (S1), timers, the range
sanitizer and the bench setup with its disk cache (counterpart of
phantom_tpu/utils/)."""

from .benchcache import cache_path, load_setup, save_setup  # noqa: F401
from .benchsetup import ensure_galois, setup_bench  # noqa: F401

"""Runtime sanitizer: range checks at the pipeline's seams (counterpart of
phantom_tpu/utils/debug.py).

The failure class that occurs in this arithmetic is a value leaving its
proven range: a residue escaping [0, q), or a lazy value escaping [0, 2q)
after a missed conditional subtraction.  `check_range` asserts it where
the sanitizer is enabled:

    from phantom_tpu_torch.utils import debug
    debug.enable()
    out = debug.checked_call(pp.mult_relin_rescale32, pipe, d1, d2)

Disabled (the default), the seams cost one Python flag test: no tensor op
and no host synchronization (each seam tests `enabled()` before it builds
its bound).  Enabled, a check outside `checked_call` raises at once (one
host synchronization a check); inside `checked_call` the checks are
queued as device flags and read once when the call returns, and the
first violated one raises `SanitizerError` with its label, as the JAX
package's checkify error does.  A word is compared as an unsigned one:
an int32 0xFFFFFFFF (-1) is out of range, as it is for the JAX package's
uint32 words.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

_ENABLED = False
_PENDING: List[List[Tuple[torch.Tensor, str]]] = []


class SanitizerError(RuntimeError):
    """A value out of its proven range."""


def enable(flag: bool = True) -> None:
    """Turn the range checks on or off (module-global)."""
    global _ENABLED
    _ENABLED = flag


def enabled() -> bool:
    return _ENABLED


def _message(label: str) -> str:
    return f"phantom sanitizer: {label}: value out of range"


def check_range(x: torch.Tensor, bound, label: str) -> None:
    """Assert 0 <= x < bound (unsigned) where the sanitizer is enabled; a
    no-op otherwise.  `bound` broadcasts against x (e.g. an (L, 1)
    modulus column)."""
    if not _ENABLED:
        return
    bad = ((x < 0) | (x >= bound)).any()
    if _PENDING:
        _PENDING[-1].append((bad, label))
    elif bool(bad):
        raise SanitizerError(_message(label))


def _first_violation(pending) -> Optional[str]:
    if not pending:
        return None
    dev = pending[0][0].device
    flags = torch.stack([b.to(dev) for b, _ in pending]).tolist()
    for flag, (_, label) in zip(flags, pending):
        if flag:
            return label
    return None


def checked_call(fn, *args, **kwargs):
    """Run fn with its checks queued, then raise the first violated one
    (one host synchronization), or return fn's output."""
    _PENDING.append([])
    try:
        out = fn(*args, **kwargs)
    finally:
        pending = _PENDING.pop()
    label = _first_violation(pending)
    if label is not None:
        raise SanitizerError(_message(label))
    return out


def checked(fn):
    """Decorator form of checked_call."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return checked_call(fn, *args, **kwargs)
    return wrapper

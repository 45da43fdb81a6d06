"""Disk cache of the bench setup's keys and ciphertexts (counterpart of
phantom_tpu/utils/benchcache.py).

Keygen and encryption at a full-width configuration cost seconds to
minutes a process; they are a deterministic function of the parameter set
and the seeds, so utils/benchsetup.py keeps their arrays in one .npz a
configuration under PHANTOM_TORCH_SETUP_CACHE (default
phantom_torch_setup_cache under the process's temporary directory, which
follows TMPDIR; "0" disables the cache).  The port's
cache lives apart from the JAX package's (PHANTOM_SETUP_CACHE), and its
key carries "port": "torch" beside _VERSION, so that a JAX blob is never
read as the port's by its configuration (their words and draws differ).

Bump _VERSION whenever keygen or encryption changes what it draws: the
version is part of the key, so stale blobs are never loaded.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
from typing import Optional, Tuple

import numpy as np

_VERSION = 1
ENV = "PHANTOM_TORCH_SETUP_CACHE"
DIR_NAME = "phantom_torch_setup_cache"


def _cache_dir() -> str:
    return os.environ.get(ENV) or os.path.join(tempfile.gettempdir(),
                                               DIR_NAME)


def cache_path(**config) -> str:
    """The blob's path for `config` (any JSON-able keywords)."""
    blob = json.dumps({"v": _VERSION, "port": "torch", **config},
                      sort_keys=True)
    h = hashlib.sha256(blob.encode()).hexdigest()[:24]
    return os.path.join(_cache_dir(), f"setup_{h}.npz")


def load_setup(verbose: bool = False,
               **config) -> Optional[Tuple[dict, dict]]:
    """(arrays, meta): a dict of numpy arrays and the JSON-decoded
    metadata, or None on a miss (no blob, an unreadable one, or the cache
    disabled); with `verbose` the reason an existing blob missed goes to
    stderr."""
    if _cache_dir() == "0":
        return None
    path = cache_path(**config)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = (json.loads(str(z["__meta__"]))
                    if "__meta__" in z.files else {})
            return arrays, meta
    except Exception as e:  # noqa: BLE001 - any unreadable blob is a miss
        if verbose:
            print(f"# setup cache: {path} unreadable ({type(e).__name__}: "
                  f"{e}), rebuilding", file=sys.stderr, flush=True)
        return None


def save_setup(arrays: dict, meta: Optional[dict] = None, **config) -> None:
    """Write the blob for `config`: to a temporary name, then an atomic
    replace, so that a reader never sees half a blob."""
    if _cache_dir() == "0":
        return
    os.makedirs(_cache_dir(), exist_ok=True)
    path = cache_path(**config)
    tmp = path[:-len(".npz")] + f".{os.getpid()}.tmp.npz"
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    # a unicode array keeps allow_pickle=False on the load side
    payload["__meta__"] = np.asarray(json.dumps(meta or {}))
    np.savez(tmp, **payload)
    os.replace(tmp, path)

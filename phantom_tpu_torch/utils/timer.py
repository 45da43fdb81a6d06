"""Benchmark timers with the reference's CSV contract (counterpart of
phantom_tpu/utils/timer.py).

The reference's CUDATimer / ChronoTimer (include/cuda_wrapper.cuh:191-283,
include/util.cuh:38-127) time each op over trials and print
`function,trials,median,mean` rows in microseconds.  Here a trial is the
host clock around one call that ends in `torch.cuda.synchronize()` where
the output holds a CUDA tensor (the JAX package's block_until_ready), so a
sample includes the host's launch overhead; a CPU output needs no
synchronize.
"""

from __future__ import annotations

import time
from typing import Callable, List

import numpy as np
import torch


def print_timer_banner():
    print("function,trials,median time (us),mean time (us)")


def tensors(out) -> List[torch.Tensor]:
    """The tensors of an output: a tensor, a nest of tuples, lists and
    dicts of them, or an object with tensor fields (a Ciphertext)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    elif not isinstance(out, (tuple, list)):
        out = list(vars(out).values()) if hasattr(out, "__dict__") else []
    return [t for v in out for t in tensors(v)]


def block_until_ready(out):
    """Wait for the device work behind every CUDA tensor in `out`."""
    for dev in {t.device for t in tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


class OpTimer:
    """Times a callable returning tensors (or nests of them)."""

    def __init__(self, name: str, trials: int = 100, warmup: int = 2):
        self.name = name
        self.trials = trials
        self.warmup = warmup
        self.samples_us: List[float] = []

    def run(self, fn: Callable, *args, **kwargs):
        for _ in range(self.warmup):
            block_until_ready(fn(*args, **kwargs))
        out = None
        for _ in range(self.trials):
            t0 = time.perf_counter()
            out = block_until_ready(fn(*args, **kwargs))
            self.samples_us.append((time.perf_counter() - t0) * 1e6)
        return out

    @property
    def median_us(self) -> float:
        return float(np.median(self.samples_us))

    @property
    def mean_us(self) -> float:
        return float(np.mean(self.samples_us))

    def print_csv(self):
        print(f"{self.name},{len(self.samples_us)},{self.median_us:.2f},"
              f"{self.mean_us:.2f}")


def time_op(name: str, fn: Callable, *args, trials: int = 100,
            **kwargs) -> float:
    """Time fn, print the CSV row, return the median in microseconds."""
    t = OpTimer(name, trials=trials)
    t.run(fn, *args, **kwargs)
    t.print_csv()
    return t.median_us

"""Batched stream executor for FHE verb pipelines (counterpart of
phantom_tpu/runtime/executor.py, with its public contract: submit, flush,
map, result() flushing a partial batch, throughput(), pipeline_map).

Design on the card, against the JAX package's one vmapped, jitted
executable a batch:

- **A batch axis written out.**  Each batch's inputs are stacked along a
  new leading axis, one (B, ...) tensor an argument, and the per-item step
  runs over that axis, item by item, on the batch's slices.  The step
  needs no batched form; each item launches what a direct call launches.
- **A side CUDA stream.**  A batch is enqueued on the device's side
  stream (`side_stream`: one a device, shared by every executor), so the
  caller's thread returns once the launches are queued and assembles
  the next batch while the card runs this one.  The inputs
  are stacked on the caller's current stream, which the side stream then
  waits for (`wait_stream`), so the stack sees everything the caller
  queued before it and nothing after; the stacked copy is recorded on the
  side stream (`record_stream`) so the allocator keeps it until the batch
  is done.  Each batch records an event; `result()` makes the caller's
  current stream wait on its own batch's event alone (no host wait) and
  records each output tensor on that stream.
- **No padding.**  The JAX package pads a tail batch to B lanes only to
  keep one XLA executable; the port runs a tail of k items as k steps, so
  `padded_lanes` stays 0.
- **donate.**  Kept for the JAX package's signature.  The port's stacked
  copies are the executor's own and are freed as each batch is enqueued
  (the allocator holds them until the side stream is done, by
  record_stream) whatever `donate` says; the caller's tensors are never
  written or freed.  So `donate` changes nothing in the port.

The caching allocator keeps freed blocks per stream; sharing one side
stream lets a new executor, and every `pipeline_map` call, reuse the
blocks that earlier batches freed.  On CPU tensors there is no stream:
each batch runs at once, in order.
An item's inputs must not be written in place between `submit` and its
batch's dispatch (a full batch dispatches at once; `flush` the rest).

Typical use (the headline CKKS step)::

    pipe = pipeline32.build_pipeline32(ctx, rlk)
    ex = StreamExecutor(pipeline32.mult_relin_rescale32, pipe, batch=8)
    handles = [ex.submit(d1, d2) for d1, d2 in pairs]
    ex.flush()
    outs = [h.result() for h in handles]
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch

from ..utils.timer import tensors


_SIDE_STREAMS: dict = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream on `device` that every executor enqueues on, made
    on first use."""
    s = _SIDE_STREAMS.get(device)
    if s is None:
        s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return s


@dataclass
class ExecutorStats:
    items: int = 0
    batches: int = 0
    padded_lanes: int = 0       # always 0 in the port: no padding
    dispatch_s: float = 0.0     # host time spent assembling + enqueueing
    first_batch_s: float = 0.0  # the first batch's, with first-use builds


class BatchHandle:
    """Result handle for one submitted item.

    `result()` returns the item's output; it waits only on the batch that
    holds this item (and flushes that batch if it is still partial).
    """

    def __init__(self, executor: "StreamExecutor"):
        self._executor = executor
        self._out: Any = None
        self._event: Optional[torch.cuda.Event] = None
        self._device: Optional[torch.device] = None
        self._done = False

    def _resolve(self, out: Any, event, device) -> None:
        self._out = out
        self._event = event
        self._device = device
        self._done = True

    def result(self) -> Any:
        if not self._done:
            self._executor.flush()
        if self._event is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(self._event)
            for t in tensors(self._out):
                if t.is_cuda:
                    t.record_stream(cur)
        return self._out


class StreamExecutor:
    """Fixed-batch streaming executor for a per-item step.

    Parameters
    ----------
    step_fn : callable ``(consts, *item_args) -> output``
        The per-item computation (e.g. ``mult_relin_rescale32``).  Every
        item argument is a tensor; the output a tensor, a tuple of them or
        an object with tensor fields.
    consts : object
        Passed to every call unbatched (a pipeline: tables, evk, ...).
    batch : int
        Items a batch, B.
    donate : bool
        The JAX package's input donation; changes nothing in the port (see
        the module's docstring).
    """

    def __init__(self, step_fn: Callable, consts: Any, batch: int = 8,
                 donate: bool = True):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.batch = int(batch)
        self.consts = consts
        self.stats = ExecutorStats()
        self._step_fn = step_fn
        self._pending_args: List[tuple] = []
        self._pending_handles: List[BatchHandle] = []
        self._last_event: Optional[torch.cuda.Event] = None

    # -- internal -----------------------------------------------------

    def _stack(self, args: List[tuple]) -> List[torch.Tensor]:
        """One tensor an argument: the items' stacked along a new leading
        axis."""
        return [torch.stack([a[i] for a in args])
                for i in range(len(args[0]))]

    def _steps(self, inputs: List[torch.Tensor], k: int) -> List[Any]:
        """The step over the batch axis, one call an item."""
        return [self._step_fn(self.consts, *(x[j] for x in inputs))
                for j in range(k)]

    def _dispatch(self) -> None:
        """Stack the pending items and enqueue one batch."""
        if not self._pending_args:
            return
        t0 = time.perf_counter()
        args, handles = self._pending_args, self._pending_handles
        self._pending_args, self._pending_handles = [], []
        dev = args[0][0].device
        event = None
        inputs = self._stack(args)  # on the caller's current stream
        if dev.type == "cuda":
            side = side_stream(dev)
            for x in inputs:
                x.record_stream(side)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                outs = self._steps(inputs, len(args))
            event = torch.cuda.Event()
            event.record(side)
            self._last_event = event
        else:
            outs = self._steps(inputs, len(args))
        for h, out in zip(handles, outs):
            h._resolve(out, event, dev)
        dt = time.perf_counter() - t0
        if self.stats.batches == 0:
            self.stats.first_batch_s = dt
        self.stats.batches += 1
        self.stats.items += len(handles)
        self.stats.dispatch_s += dt

    # -- public -------------------------------------------------------

    def submit(self, *item_args) -> BatchHandle:
        """Queue one item; dispatches automatically when B items are
        pending.  Returns a handle whose `result()` yields the output."""
        h = BatchHandle(self)
        self._pending_args.append(tuple(item_args))
        self._pending_handles.append(h)
        if len(self._pending_args) == self.batch:
            self._dispatch()
        return h

    def flush(self, handles: Optional[Sequence[BatchHandle]] = None):
        """Dispatch any pending partial batch.  Returns `handles` (or
        None) for fluent use."""
        self._dispatch()
        return handles

    def map(self, items: Sequence[Sequence[Any]]) -> List[Any]:
        """Submit every item, flush, and gather results in order."""
        handles = [self.submit(*it) for it in items]
        self.flush()
        return [h.result() for h in handles]

    def throughput(self) -> float:
        """Items/s over host dispatch time, after waiting for everything
        dispatched so far."""
        if self._last_event is not None:
            self._last_event.synchronize()
        if self.stats.dispatch_s <= 0:
            return 0.0
        return self.stats.items / self.stats.dispatch_s


def pipeline_map(step_fn: Callable, consts: Any,
                 items: Sequence[Sequence[Any]], batch: int = 8,
                 donate: bool = True) -> List[Any]:
    """One-shot convenience: run `items` through a new StreamExecutor
    (on the shared side stream, so repeated calls reuse its cached
    blocks)."""
    ex = StreamExecutor(step_fn, consts, batch=batch, donate=donate)
    return ex.map(items)

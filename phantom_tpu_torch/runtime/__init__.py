"""Serving runtime: sustained-throughput execution of FHE op streams
(counterpart of phantom_tpu/runtime/).

The reference is a single-request CUDA library (every verb one launch
sequence on cudaStreamPerThread, include/cuda_wrapper.cuh:47-63); a
server wants batched, pipelined dispatch: the host assembles batch k + 1
while the card runs batch k on a side CUDA stream.
"""

from .executor import BatchHandle, ExecutorStats, StreamExecutor, pipeline_map

__all__ = ["StreamExecutor", "BatchHandle", "ExecutorStats", "pipeline_map"]

"""Tracing, profiling and observability hooks.

Counterpart of ``gptorch_tpu/profiling.py``:

* :func:`trace` -- context manager around ``torch.profiler.profile`` (CPU
  and, where a card is present, CUDA activity) that writes a trace
  TensorBoard can load into ``log_dir``;
* :func:`annotate` -- ``torch.profiler.record_function``, so a Gram,
  Cholesky or solve phase shows as a named range in that trace;
* :class:`StepMetrics` -- per-step training metrics (loss, step time)
  collected as a fit callback;
* :func:`device_memory_stats` -- live and peak memory of the current CUDA
  device.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with profiling.trace("/tmp/tb"): step()``.

    The trace is written into ``log_dir`` (a ``*.pt.trace.json`` file, which
    TensorBoard's profile plugin and Chrome's trace viewer load) when the
    block ends.  Yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` summarises the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))
    ) as prof:
        yield prof


def annotate(name: str):
    """A named range in the trace:

    >>> with profiling.annotate("gram"):
    ...     K = kernel.K(x)
    """
    return torch.profiler.record_function(name)


@dataclass
class StepMetrics:
    """Accumulates per-step scalars during a fit loop.

    Use as a callback for :meth:`GPModel.optimize`:

    >>> metrics = StepMetrics()
    >>> model.optimize(method="Adam", callback=metrics)
    >>> metrics.losses, metrics.step_times
    """

    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    _last: Optional[float] = None

    def __call__(self, step: int, loss: float):
        now = time.perf_counter()
        if self._last is not None:
            self.step_times.append(now - self._last)
        self._last = now
        self.losses.append(float(loss))

    def summary(self) -> dict:
        return {
            "steps": len(self.losses),
            "final_loss": self.losses[-1] if self.losses else None,
            "best_loss": min(self.losses) if self.losses else None,
            "mean_step_time_s": float(np.mean(self.step_times)) if self.step_times else None,
        }


def device_memory_stats(device=None) -> dict:
    """Live and peak memory of a CUDA device (default: the current one):
    ``bytes_in_use`` and ``peak_bytes_in_use`` as PyTorch's caching
    allocator counts them (``torch.cuda.memory_stats``; the peak is
    ``torch.cuda.max_memory_allocated``) and ``bytes_limit``, the card's
    total memory (``torch.cuda.mem_get_info``).  ``{}`` where no CUDA
    device exists, as the JAX package returns for a backend that reports
    nothing."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.mem_get_info(device)[1],
    }

"""What the example twins share: the device they run on, a clock that waits
for the card, and the port's counterpart of a compiled JAX call (one CUDA
graph on the card, the eager call on the CPU)."""

from __future__ import annotations

import contextlib
import time

import torch

from gptorch_tpu_torch import settings


def add_device_argument(parser):
    parser.add_argument(
        "--device", default="cuda",
        help="where the port runs (default: the CUDA card; with none present the script raises)",
    )


@contextlib.contextmanager
def on_device(name):
    """Resolves ``name`` (raising when it names a card that is absent) and
    makes it the port's default device inside the block."""
    device = settings.resolve_device(name)
    with settings.override(device=str(device)):
        yield device


def clock(device):
    """``time.perf_counter()`` once the card's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def mechanism(device):
    """How :class:`Compiled` runs a call on ``device``."""
    return "one captured CUDA graph" if device.type == "cuda" else "one eager loop"


class Compiled:
    """``fn(*tensors)`` (a tuple or one tensor out), with no autograd, run as
    one CUDA graph on the card -- captured once from ``example``, replayed
    with each call's inputs copied into its own -- and called eagerly on the
    CPU.  A call returns clones, so a later replay leaves earlier results as
    they were.

    The capture runs under the ``"none"`` jitter policy: a captured call
    cannot hold the adaptive policy's host probe, and ``"none"`` factors as
    the adaptive policy does when its first attempt succeeds."""

    def __init__(self, fn, *example):
        self.fn = torch.no_grad()(fn)
        self.graph = None
        device = example[0].device
        if device.type != "cuda":
            return
        self.inputs = [t.clone() for t in example]
        with settings.override(jitter_policy="none"):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self.fn(*self.inputs)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = self.fn(*self.inputs)

    def __call__(self, *tensors):
        if self.graph is None:
            return self.fn(*tensors)
        for static, t in zip(self.inputs, tensors):
            static.copy_(t)
        self.graph.replay()
        if isinstance(self.outputs, torch.Tensor):
            return self.outputs.clone()
        return tuple(o.clone() for o in self.outputs)

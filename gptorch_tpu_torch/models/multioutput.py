"""Multi-output models: so far only the kernel container they share.

Counterpart of the start of ``gptorch_tpu/models/multioutput.py``: the
:class:`_KernelList` that SKI's product kernel (one factor per input
dimension) is held in.  The ICM and LMC models come later.
"""

from __future__ import annotations

from ..module import Module


class _KernelList(Module):
    """A list of kernels registered as the attributes k0, k1, ..., so their
    Params have the JAX package's paths (``kernel.k0.variance``, ...)."""

    def __init__(self, kernels):
        super().__init__()
        self.n = len(kernels)
        for i, k in enumerate(kernels):
            setattr(self, f"k{i}", k)

    def __len__(self):
        return self.n

    def __iter__(self):
        return (getattr(self, f"k{i}") for i in range(self.n))

    def __getitem__(self, i):
        return getattr(self, f"k{int(i)}")

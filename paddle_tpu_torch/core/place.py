"""Device placement (counterpart of paddle_tpu/core/place.py).

A Place resolves to an explicit ``torch.device``. ``CUDAPlace(i)`` takes
the role the JAX package gives ``TPUPlace``. The default place is
``CUDAPlace(0)``: on a host without a card, constructing it raises, so
an entry point never runs on the CPU unless the caller passed
``CPUPlace()``.
"""

from __future__ import annotations


import torch

from .enforce import EnforceError


class Place:
    """Base class for device placements."""

    _kind = "base"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((self._kind, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    """Host CPU placement."""

    _kind = "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """One NVIDIA card. Raises when the card is not visible."""

    _kind = "cuda"

    def __init__(self, device_id: int = 0):
        super().__init__(device_id)
        if not torch.cuda.is_available():
            raise EnforceError(
                "CUDAPlace(%d): no CUDA device is visible to torch; pass "
                "CPUPlace() to run on the host" % self.device_id)
        if self.device_id >= torch.cuda.device_count():
            raise EnforceError(
                "CUDAPlace(%d): only %d CUDA device(s) visible"
                % (self.device_id, torch.cuda.device_count()))

    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.device_id)


def default_place() -> Place:
    """``CUDAPlace(0)``; raises on a host without a card."""
    return CUDAPlace(0)

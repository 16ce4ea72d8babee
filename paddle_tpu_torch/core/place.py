"""Device placement (counterpart of paddle_tpu/core/place.py).

A Place resolves to an explicit ``torch.device``. ``CUDAPlace(i)`` takes
the role the JAX package gives ``TPUPlace``. The default place is
``CUDAPlace(0)``: on a host without a card, constructing it raises, so
an entry point never runs on the CPU unless the caller passed
``CPUPlace()`` — or the process called :func:`force_cpu`, which makes
the CPU the default place from then on.

``TPUPlace`` is ``CUDAPlace`` (the JAX package's accelerator place is
this package's card), ``CUDAPinnedPlace`` is page-locked host memory
(Fluid's meaning: tensors put there live on the CPU, pinned, so copies
to a card run asynchronously), and ``is_compiled_with_tpu()`` is
False: this package drives no TPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .enforce import EnforceError, enforce


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


class CUDAPinnedPlace(Place):
    """Page-locked host memory. Tensors on this place are CPU tensors
    in pinned memory (:func:`put`). Raises when no card is visible:
    pinning needs the CUDA driver."""

    _kind = "pinned"
    pinned = True

    def __init__(self, device_id: int = 0):
        super().__init__(device_id)
        if not torch.cuda.is_available():
            raise EnforceError(
                "CUDAPinnedPlace(%d): pinned host memory needs a CUDA "
                "device visible to torch; pass CPUPlace() to run on the "
                "host" % self.device_id)

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


TPUPlace = CUDAPlace

_FORCED_CPU = False


def put(tensor: torch.Tensor, place: Place) -> torch.Tensor:
    """``tensor`` on ``place``: moved to its device, and pinned when the
    place is :class:`CUDAPinnedPlace`."""
    t = tensor.to(place.torch_device())
    if getattr(place, "pinned", False) and not t.is_pinned():
        t = t.pin_memory()
    return t


def is_compiled_with_tpu() -> bool:
    """False: this package runs on NVIDIA cards and the CPU, never on a
    TPU."""
    return False


def force_cpu(n_devices: int = 1) -> None:
    """Make the CPU the default place of this process: entry points
    that take no place run on the host from now on, even where a card
    is visible. ``n_devices`` is accepted for the JAX package's
    signature: the CPU is one device here (several CPU ranks are a
    ``torch.distributed`` world of processes, ``tools.launch``)."""
    global _FORCED_CPU
    enforce(int(n_devices) >= 1, "force_cpu: n_devices must be >= 1")
    _FORCED_CPU = True


def default_place() -> Place:
    """``CUDAPlace(0)`` (which raises on a host without a card), or
    ``CPUPlace()`` after :func:`force_cpu`."""
    return CPUPlace() if _FORCED_CPU else CUDAPlace(0)


def place_to_device(place: Optional[Place]) -> torch.device:
    """The ``torch.device`` of ``place`` (None: the default place)."""
    return (place if place is not None else default_place()).torch_device()

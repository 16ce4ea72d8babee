"""Device-memory knobs and introspection (counterpart of
paddle_tpu/core/memory.py: the same names and fields).

Reference: paddle/fluid/memory/ — a buddy allocator per device whose chunk
growth is governed by ``FLAGS_fraction_of_gpu_memory_to_use``
(memory/detail/buddy_allocator.h:34, system_allocator.h:29-59) plus
``memory::Copy``/pinned-memory APIs.

On a card PyTorch's caching allocator owns device memory, so the two
capabilities sit at its boundary:

* ``set_memory_fraction(f)`` — the reference's fraction knob, as the
  allocator's per-process fraction
  (``torch.cuda.set_per_process_memory_fraction``). It takes effect at
  once: an allocation past the cap raises ``torch.OutOfMemoryError``
  from then on (the JAX package's knob is read by PJRT once, at client
  creation).
* ``preallocate(enable)`` — ``True`` reserves the capped arena up front
  (one allocation the size of the fraction, returned to the allocator's
  cache, which keeps it reserved); ``False`` returns the cached,
  unused blocks, so the arena grows chunk by chunk again.
* ``memory_usage(device)`` / ``DeviceMemoryStats`` — live device-memory
  introspection from ``torch.cuda.memory_stats`` (bytes allocated to
  tensors, their peak, and the cap). The default device is the card; a
  CPU device reports zeros and no limit, as the JAX package's CPU
  backend does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .enforce import enforce

__all__ = ["set_memory_fraction", "preallocate", "memory_usage",
           "DeviceMemoryStats"]

# the JAX package's default arena share when preallocating with no
# fraction set (XLA_PYTHON_CLIENT_MEM_FRACTION's default)
_DEFAULT_FRACTION = 0.75
# card index -> the fraction set on it
_fractions: Dict[int, float] = {}


def _device(device=None) -> torch.device:
    """``device`` (a Place, torch.device, str or card index) as a
    torch.device; None is the card (``CUDAPlace(0)``, which raises on a
    host without one)."""
    if device is None:
        from .place import default_place

        return default_place().torch_device()
    if hasattr(device, "torch_device"):
        return device.torch_device()
    if isinstance(device, int):
        return torch.device("cuda", device)
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def set_memory_fraction(fraction: float, device=None) -> None:
    """Cap this process's allocations on ``device`` (default the card)
    at ``fraction`` of its memory (reference:
    FLAGS_fraction_of_gpu_memory_to_use,
    memory/detail/buddy_allocator.h:34). Takes effect at once."""
    enforce(0.0 < fraction <= 1.0,
            f"memory fraction must be in (0, 1], got {fraction}")
    d = _device(device)
    enforce(d.type == "cuda", "set_memory_fraction caps a card's memory; "
            "got device %s" % d)
    torch.cuda.set_per_process_memory_fraction(float(fraction), d)
    _fractions[d.index] = float(fraction)


def preallocate(enable: bool = True, device=None) -> None:
    """Reserve the arena up front (``True``: the fraction set by
    :func:`set_memory_fraction`, else 75 % of the card, allocated once
    and kept in the allocator's cache) or return the cached blocks so
    it grows chunk by chunk (``False``; reference: the buddy allocator
    grows its pool when the fraction flag is small)."""
    d = _device(device)
    if d.type != "cuda":
        return
    if not enable:
        torch.cuda.empty_cache()
        return
    total = torch.cuda.get_device_properties(d).total_memory
    want = int(total * _fractions.get(d.index, _DEFAULT_FRACTION))
    # less one 2 MiB segment: the allocator rounds a block up to it, and
    # a block past the fraction's cap would not be granted
    extra = want - torch.cuda.memory_reserved(d) - (2 << 20)
    if extra > 0:
        block = torch.empty(extra, dtype=torch.uint8, device=d)
        del block  # back to the cache, still reserved


@dataclass
class DeviceMemoryStats:
    """Device-memory usage snapshot for one device (the caching
    allocator's stats)."""

    bytes_in_use: int
    peak_bytes_in_use: int
    bytes_limit: Optional[int]
    device: str = ""

    @property
    def fraction_in_use(self) -> Optional[float]:
        if not self.bytes_limit:
            return None
        return self.bytes_in_use / self.bytes_limit


def memory_usage(device=None) -> DeviceMemoryStats:
    """Live device-memory introspection (reference capability:
    buddy-allocator usage accounting / the FLAGS-governed budget):
    bytes allocated to tensors now and at their peak, and the cap (the
    card's memory times its fraction). A CPU device reports 0, 0 and
    None."""
    d = _device(device)
    if d.type != "cuda":
        return DeviceMemoryStats(bytes_in_use=0, peak_bytes_in_use=0,
                                 bytes_limit=None, device=str(d))
    stats = torch.cuda.memory_stats(d)
    total = torch.cuda.get_device_properties(d).total_memory
    return DeviceMemoryStats(
        bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
        peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)),
        bytes_limit=int(total * _fractions.get(d.index, 1.0)),
        device=str(d))

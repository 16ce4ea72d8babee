"""Functional reader combinators and the input pipeline (counterpart of
paddle_tpu/reader).

Same contract as the reference's reader package (reference:
python/paddle/reader/decorator.py:29-337): a *reader* is a zero-arg
callable returning an iterable of samples; a *reader creator* builds
readers. These compose the host-side data path feeding ``DataFeeder``;
the device side is ``prefetch_to_device`` / ``DataLoader``, which copy
batches to the card on a CUDA stream of their own from pinned host
memory while the card runs the current step (the double_buffer reader's
role, operators/reader/buffered_reader.cc).
"""

from .decorator import (map_readers, buffered, compose, chain, shuffle,
                        firstn, xmap_readers, cache, multiprocess_reader,
                        PipeReader, bucket_by_length)
from .prefetch import prefetch_to_device, batch
from .dataloader import DataLoader, PipelineMetrics
from .dispatch import shard_reader, CheckpointableReader

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle", "firstn",
    "xmap_readers", "cache", "multiprocess_reader", "PipeReader",
    "bucket_by_length",
    "prefetch_to_device", "batch",
    "DataLoader", "PipelineMetrics",
]

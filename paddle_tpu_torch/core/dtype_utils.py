"""Dtype conversions between the Program's symbol table and torch.

The symbol table keeps numpy dtypes, as the JAX package's does, so the
two packages build equal tables from the same builder calls. bfloat16,
which numpy lacks, is stored as ``torch.bfloat16``. Token ids keep the
reference's int64 contract at run time too: torch indexes with int64
natively, so there is no 32-bit mode to canonicalize against (the JAX
package's ``index_dtype``).
"""

from __future__ import annotations

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype("float32"): torch.float32,
    np.dtype("float64"): torch.float64,
    np.dtype("float16"): torch.float16,
    np.dtype("int64"): torch.int64,
    np.dtype("int32"): torch.int32,
    np.dtype("int16"): torch.int16,
    np.dtype("int8"): torch.int8,
    np.dtype("uint8"): torch.uint8,
    np.dtype("bool"): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def normalize_dtype(dtype):
    """Symbol-table dtype: a numpy dtype, or ``torch.bfloat16``."""
    if dtype is None:
        return np.dtype("float32")
    if dtype is torch.bfloat16 or (isinstance(dtype, str)
                                   and dtype == "bfloat16"):
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)


def to_torch(dtype) -> torch.dtype:
    """The torch dtype of a symbol-table dtype."""
    dtype = normalize_dtype(dtype)
    if dtype is torch.bfloat16:
        return dtype
    return _NP_TO_TORCH[dtype]


def name(dtype) -> str:
    """Canonical dtype name ("float32", "bfloat16", ...)."""
    dtype = normalize_dtype(dtype)
    return "bfloat16" if dtype is torch.bfloat16 else dtype.name

""".npy/.npz members as the JAX package writes them, for torch tensors.

numpy has no bfloat16. The JAX package hands numpy an ml_dtypes
bfloat16 array, which ``np.save`` records as a raw two-byte member
(descr ``'<V2'``): the bytes survive and the dtype's name does not. The
port writes its bfloat16 tensors the same way, so the files stay in the
JAX package's format, and reads a two-byte raw member back as bfloat16
only where something names the dtype: an elastic manifest, the
program's variable, or the scope's tensor. Where nothing does, the read
raises.

Host values are numpy arrays; a bfloat16 one is its bits, ``'V2'``.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from . import dtype_utils
from .enforce import EnforceError

RAW16 = np.dtype("V2")


def is_raw16(a) -> bool:
    """A two-byte raw member: bfloat16 bits without the dtype's name."""
    return isinstance(a, np.ndarray) and a.dtype == RAW16


def host_array(value) -> np.ndarray:
    """A host numpy copy of ``value`` that shares no memory with it (a
    state tensor may be updated in place after this returns); bfloat16
    (torch or ml_dtypes) as its bits, dtype ``'V2'``."""
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(RAW16)
        return t.numpy()
    a = np.array(value, copy=True)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16).view(RAW16)
    return a


def dtype_name(a) -> str:
    """The dtype name of a host value or tensor; ``'void16'`` for a raw
    two-byte member."""
    if isinstance(a, torch.Tensor):
        return dtype_utils.name(a.dtype)
    return np.asarray(a).dtype.name


def to_tensor(a, dtype=None, device=None, name: str = "value"
              ) -> torch.Tensor:
    """A torch tensor of host value ``a`` on ``device``. ``dtype``
    (symbol-table or torch dtype, optional) converts it; a raw two-byte
    member needs ``dtype`` bfloat16 and raises EnforceError without it."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        if is_raw16(a) or a.dtype.name == "bfloat16":
            want = None if dtype is None else dtype_utils.to_torch(dtype)
            if is_raw16(a) and want is not torch.bfloat16:
                raise EnforceError(
                    "%s is a two-byte raw member (bfloat16 bits written "
                    "without the dtype's name) and nothing names its dtype "
                    "(%s): record it in a manifest, declare the variable, or "
                    "give the scope a bfloat16 tensor of that name"
                    % (name, "no dtype given" if dtype is None
                       else "asked for %s" % dtype_utils.name(dtype)))
            t = torch.from_numpy(_c_order(a).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(dtype_utils.to_torch(dtype))
    if device is not None:
        t = t.to(device)
    return t


def _c_order(a: np.ndarray) -> np.ndarray:
    # np.ascontiguousarray would turn a 0-d array into a 1-d one
    return a if a.flags.c_contiguous else a.copy(order="C")


def _write_npy(f, a: np.ndarray) -> None:
    a = _c_order(a)
    if is_raw16(a):
        # the JAX package's header for a bfloat16 array
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(a.reshape(-1).view(np.uint8).data)
    else:
        np.lib.format.write_array(f, a, allow_pickle=False)


def savez(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """``np.savez(path, **arrays)`` with raw two-byte members written as
    ``'<V2'`` (the JAX package's bytes). Returns the file's path."""
    if not path.endswith(".npz"):
        path += ".npz"
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, a in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                _write_npy(f, np.asarray(a))
    return path


def save(path: str, a: np.ndarray) -> None:
    """``np.save(path, a)`` with a raw two-byte member written as
    ``'<V2'``."""
    with open(path, "wb") as f:
        _write_npy(f, np.asarray(a))


def npy_path(dirname: str, name: str) -> str:
    return os.path.join(dirname, name + ".npy")


def declared_dtype(name: str, program=None, scope=None) -> Optional[object]:
    """The dtype something names for ``name``: the scope's tensor first,
    then the program's variable; None when neither has one."""
    if scope is not None:
        cur = scope.find_var(name)
        if isinstance(cur, torch.Tensor):
            return cur.dtype
    if program is not None:
        v = program.global_block()._find_var_recursive(name)
        if v is not None and v.dtype is not None:
            return v.dtype
    return None

"""The elastic manifest format (``format: "elastic"``, manifest v2;
counterpart of paddle_tpu/ckpt/manifest.py, the same files and fields).

The on-disk record of one checkpoint serial::

    checkpoint_<serial>/
        shards_<pid>.npz        # one payload per writing process
        manifest_<pid>.json     # per-tensor index + payload integrity
        trainer_args_<tid>.json # optional host-side resume state
        meta.json               # published LAST; names the serial valid

Each ``manifest_<pid>.json`` records, for every tensor: the GLOBAL shape
and dtype name (``"bfloat16"`` for a bfloat16 tensor, whose npz member
holds raw two-byte bits, ``'<V2'``, as the JAX package writes it), the
``PartitionSpec`` and mesh axes it was saved under (null for a whole
value), and one record per shard (the npz member key, the payload file,
the global index it covers); plus sha256 + byte size of every payload
file. A serial is valid only when every manifest parses and every
payload matches its sha256 and size — every process of the save having
written its part.

A rank of a sharded run holds blocks of some tensors: it hands a writer
each block as a :class:`Shard` (the block, the whole tensor's shape, its
spec and its mesh; ``spmd.held_state`` builds them), and writes only the
blocks it owns — replica 0 of each, the rank at index 0 of every mesh
axis the spec does not split — while whole values are process 0's, as
the JAX package's replica-0 shards and host values. A single-process
save builds the whole serial in a hidden temp dir and publishes it with
ONE ``os.rename`` (first-publisher-wins); a multi-process save writes
per-process files with atomic replaces into a shared serial dir and
process 0 lands ``meta.json`` last. The legacy sharded format (md5
manifests) reads through :func:`legacy_sharded_index`. The writers fire
the ``ckpt.publish`` and ``ckpt.payload`` fault points.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple


from ..core import npz
from .base import (_META_FILE, _TRAINER_PREFIX, _digest_cached,
                   _serial_dir, _sha256)

ELASTIC_FORMAT = 2


def _index_to_json(index, shape) -> List[List[int]]:
    out = []
    for sl, dim in zip(index, shape):
        out.append([0 if sl.start is None else int(sl.start),
                    int(dim) if sl.stop is None else int(sl.stop)])
    return out


class Shard:
    """This rank's block of a tensor held sharded over a mesh: ``data``
    the block, ``shape`` the whole tensor's, ``spec`` the cleaned spec
    the block was cut under, ``mesh`` the live mesh."""

    __slots__ = ("data", "shape", "spec", "mesh")

    def __init__(self, data, shape, spec, mesh):
        self.data = data
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec)
        self.mesh = mesh

    def index(self):
        """The block's global index, one slice per dimension."""
        from ..sharding.comm import local_slices

        return local_slices(self.shape, self.spec, self.mesh)

    def owned(self) -> bool:
        """Replica 0 of the block: this rank sits at index 0 of every
        mesh axis the spec does not split."""
        from ..sharding.comm import _axes

        used = {a for e in self.spec for a in _axes(e)}
        coord = self.mesh.coordinate()
        return all(i == 0 for a, i in coord.items() if a not in used)


def _spec_to_json(spec) -> list:
    out = []
    for e in spec:
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append([str(a) for a in e])
        else:
            out.append(str(e))
    return out


def _process_index() -> int:
    """This process's rank in the ``torch.distributed`` world, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def snapshot_state(state: Dict[str, Any],
                   process_index: Optional[int] = None) -> Dict[str, Any]:
    """Device→host snapshot of what THIS process owns of ``state`` (name
    -> torch tensor, host value or :class:`Shard`): one host copy per
    value, made on the caller's thread before this returns, so no later
    step — which updates the scope's tensors in place under
    ``memory_optimize`` and ``run_steps``' graphs — can reach the bytes a
    writer serializes. The copy of a card tensor is queued on the
    current stream, behind the steps that wrote it. A :class:`Shard`
    contributes its block when this rank owns it, with its global
    index, spec and mesh axes; whole values are process 0's. ``None``
    values (names a scope only reserved) are skipped."""
    pid = _process_index() if process_index is None else process_index
    entries: Dict[str, Any] = {}
    for name, val in state.items():
        if val is None:
            continue
        if isinstance(val, Shard):
            if not val.owned():
                continue
            arr = npz.host_array(val.data)
            entries[name] = {
                "shape": list(val.shape),
                "dtype": npz.dtype_name(val.data),
                "spec": _spec_to_json(val.spec),
                "mesh": {str(a): int(n)
                         for a, n in val.mesh.shape.items()},
                "shards": [{"index": _index_to_json(val.index(),
                                                    val.shape),
                            "data": arr}]}
            continue
        if pid != 0:
            continue
        arr = npz.host_array(val)
        entries[name] = {
            "shape": [int(s) for s in arr.shape],
            "dtype": npz.dtype_name(val),
            "spec": None, "mesh": None,
            "shards": [{"index": _index_to_json(
                (slice(None),) * arr.ndim, arr.shape), "data": arr}]}
    return entries


def _atomic_write_json(d: str, name: str, obj: dict) -> None:
    tmp = os.path.join(d, f".tmp_{name}")
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, os.path.join(d, name))


def write_process_files(d: str, pid: int, entries: Dict[str, Any],
                        trainer_id: Optional[int] = None,
                        trainer_args: Optional[dict] = None) -> None:
    """Write one process's payload + manifest (+ trainer args) into the
    serial dir ``d`` with per-file atomic replaces."""
    payload, man_vars = {}, {}
    shard_file = f"shards_{pid}.npz"
    for name, e in entries.items():
        recs = []
        for i, srec in enumerate(e["shards"]):
            key = f"{name}::{i}"
            payload[key] = srec["data"]
            recs.append({"key": key, "file": shard_file,
                         "index": srec["index"]})
        man_vars[name] = {"shape": e["shape"], "dtype": e["dtype"],
                          "spec": e.get("spec"), "mesh": e.get("mesh"),
                          "shards": recs}
    tmp = os.path.join(d, f".tmp_{shard_file}")
    npz.savez(tmp, payload)
    digest, size = _sha256(tmp), os.path.getsize(tmp)
    # digest recorded — an injected corruption here yields an invalid
    # serial that restore's newest-valid fallback must skip
    from ..resilience import faults

    faults.fire("ckpt.payload", tmp)
    os.replace(tmp, os.path.join(d, shard_file))
    _atomic_write_json(d, f"manifest_{pid}.json", {
        "format": ELASTIC_FORMAT, "process_index": pid,
        "payloads": {shard_file: {"sha256": digest, "size": size}},
        "vars": man_vars})
    if trainer_args is not None:
        tid = pid if trainer_id is None else trainer_id
        _atomic_write_json(d, f"{_TRAINER_PREFIX}_{tid}.json", trainer_args)


def write_meta(d: str, serial: int, process_count: int,
               names, extra_meta: Optional[dict] = None) -> None:
    meta = {"format": "elastic", "manifest_version": ELASTIC_FORMAT,
            "serial": serial, "process_count": int(process_count),
            "names": sorted(names)}
    meta.update(extra_meta or {})
    _atomic_write_json(d, _META_FILE, meta)


def publish_serial(root: str, serial: int, entries: Dict[str, Any],
                   trainer_id: Optional[int] = None,
                   trainer_args: Optional[dict] = None,
                   extra_meta: Optional[dict] = None) -> bool:
    """Single-process publish: build the COMPLETE serial in a hidden
    temp dir, then one ``os.rename``. Returns False when another writer
    published this serial first (the loser's temp dir is discarded) —
    readers either see nothing or a complete, verifiable directory."""
    os.makedirs(root, exist_ok=True)
    final_dir = _serial_dir(root, serial)
    if os.path.isdir(final_dir):
        return False
    tmp_dir = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=root)
    try:
        # fired once the temp dir exists: an injected crash orphans it
        # for ckpt.sweep_orphans, a delay widens the preemption window
        from ..resilience import faults

        faults.fire("ckpt.publish")
        write_process_files(tmp_dir, 0, entries, trainer_id=trainer_id,
                            trainer_args=trainer_args)
        write_meta(tmp_dir, serial, 1, entries, extra_meta)
        os.rename(tmp_dir, final_dir)  # atomic publish
        return True
    except OSError:
        if os.path.isdir(final_dir):  # lost the race: first wins
            shutil.rmtree(tmp_dir, ignore_errors=True)
            return False
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise


def read_manifests(d: str, meta: dict) -> List[dict]:
    """Every process manifest of an elastic serial (raises on a corrupt
    one — callers guard with validity or handle OSError/ValueError)."""
    out = []
    for p in range(int(meta.get("process_count", 1))):
        with open(os.path.join(d, f"manifest_{p}.json")) as f:
            out.append(json.load(f))
    return out


def verify_serial(d: str, meta: dict) -> bool:
    """Elastic validity: every process manifest parses and every payload
    file it records matches its sha256 AND size."""
    try:
        manifests = read_manifests(d, meta)
    except (OSError, ValueError):
        return False
    for man in manifests:
        if man.get("format") != ELASTIC_FORMAT:
            return False
        payloads = man.get("payloads", {})
        if not payloads:
            return False
        for fname, rec in payloads.items():
            p = os.path.join(d, fname)
            try:
                if os.path.getsize(p) != int(rec.get("size", -1)):
                    return False
                if _digest_cached(p, "sha256") != rec.get("sha256"):
                    return False
            except OSError:
                return False
    return True


def read_index(d: str, meta: dict) -> Tuple[Dict[str, list],
                                            Dict[str, tuple],
                                            Dict[str, str],
                                            Dict[str, Optional[list]]]:
    """The restore index of an elastic serial:
    ``(index, shapes, dtypes, specs)`` where ``index[name]`` is a list of
    ``(npz_key, [[start, stop], ...], npz_path)`` shard records and
    ``dtypes[name]`` the recorded dtype NAME (numpy has no bfloat16)."""
    index: Dict[str, list] = {}
    shapes: Dict[str, tuple] = {}
    dtypes: Dict[str, str] = {}
    specs: Dict[str, Optional[list]] = {}
    for man in read_manifests(d, meta):
        for name, rec in man["vars"].items():
            shapes[name] = tuple(rec["shape"])
            dtypes[name] = str(rec["dtype"])
            specs[name] = rec.get("spec")
            index.setdefault(name, []).extend(
                (s["key"], s["index"], os.path.join(d, s["file"]))
                for s in rec["shards"])
    return index, shapes, dtypes, specs


def _npz_headers(path: str, dtypes: Optional[Dict[str, str]] = None
                 ) -> Dict[str, tuple]:
    """{member: (shape, dtype name)} of an npz WITHOUT loading payload
    bytes — only the npy headers are parsed. A raw two-byte member reads
    as the dtype ``dtypes`` records for it (a manifest's), else as
    ``"void16"``: the bytes of a bfloat16 array whose name was lost."""
    import zipfile

    from numpy.lib import format as npformat

    dtypes = dtypes or {}
    out: Dict[str, tuple] = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            name = info.filename
            if name.endswith(".npy"):
                name = name[:-4]
            with zf.open(info) as f:
                version = npformat.read_magic(f)
                if version == (1, 0):
                    shape, _, dtype = npformat.read_array_header_1_0(f)
                else:
                    shape, _, dtype = npformat.read_array_header_2_0(f)
            dname = dtype.name
            if dtype == npz.RAW16 and name in dtypes:
                dname = dtypes[name]
            out[name] = (tuple(shape), dname)
    return out


def legacy_sharded_index(d: str, meta: dict) -> Tuple[Dict[str, list],
                                                      Dict[str, tuple],
                                                      Dict[str, str]]:
    """Restore index of a legacy md5 sharded serial, in the same
    ``(index, shapes, dtypes)`` shape as :func:`read_index` — the ONE
    walk of the per-process manifests (restore and the lint both derive
    from it)."""
    index: Dict[str, list] = {}
    shapes: Dict[str, tuple] = {}
    dtypes: Dict[str, str] = {}
    for p in range(int(meta.get("process_count", 1))):
        with open(os.path.join(d, f"manifest_{p}.json")) as f:
            man = json.load(f)
        npz_path = os.path.join(d, f"shards_{p}.npz")
        for name, rec in man["vars"].items():
            shapes[name] = tuple(rec["shape"])
            dtypes[name] = str(rec["dtype"])
            index.setdefault(name, []).extend(
                (s["key"], s["index"], npz_path) for s in rec["shards"])
    return index, shapes, dtypes


def manifest_entries(root: str, serial: int) -> Dict[str, tuple]:
    """{name: (global shape tuple, dtype name)} of one serial, for the
    restore-lint (analysis.check_restore_state) — every format (dense
    serials read npz headers, no payload load)."""
    from .base import read_meta

    meta = read_meta(root, serial)
    d = _serial_dir(root, serial)
    if meta is None:
        return {}
    if meta.get("format") == "elastic":
        _, shapes, dtypes, _ = read_index(d, meta)
        return {n: (shapes[n], dtypes[n]) for n in shapes}
    if meta.get("format") == "sharded":
        _, shapes, dtypes = legacy_sharded_index(d, meta)
        return {n: (shapes[n], dtypes[n]) for n in shapes}
    return _npz_headers(os.path.join(d, "state.npz"))

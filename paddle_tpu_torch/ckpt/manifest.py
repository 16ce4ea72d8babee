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
``PartitionSpec`` and mesh axes it was saved under (null here: the port
saves from one process and one device), and one record per shard (the
npz member key, the payload file, the global index it covers); plus
sha256 + byte size of every payload file. A serial is valid only when
every manifest parses and every payload matches its sha256 and size.

The port writes and reads the single-process format: the whole serial
is built in a hidden temp dir and published with ONE ``os.rename``
(first-publisher-wins). Multi-process saves and the legacy sharded
format wait for multi-GPU support (ROADMAP Queue A 9). The writers fire
the ``ckpt.publish`` and ``ckpt.payload`` fault points.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple


from ..core import npz
from ..core.enforce import not_ported
from .base import (_META_FILE, _TRAINER_PREFIX, _digest_cached,
                   _serial_dir, _sha256)

ELASTIC_FORMAT = 2


def _index_to_json(index, shape) -> List[List[int]]:
    out = []
    for sl, dim in zip(index, shape):
        out.append([0 if sl.start is None else int(sl.start),
                    int(dim) if sl.stop is None else int(sl.stop)])
    return out


def snapshot_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Device→host snapshot of ``state`` (name -> torch tensor or host
    value): one host copy per value, made on the caller's thread before
    this returns, so no later step — which updates the scope's tensors
    in place under ``memory_optimize`` and ``run_steps``' graphs — can
    reach the bytes a writer serializes. The copy of a card tensor is
    queued on the current stream, behind the steps that wrote it.
    ``None`` values (names a scope only reserved) are skipped."""
    entries: Dict[str, Any] = {}
    for name, val in state.items():
        if val is None:
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
        raise _sharded_not_ported()
    return _npz_headers(os.path.join(d, "state.npz"))


def _sharded_not_ported() -> NotImplementedError:
    return not_ported("reading the legacy sharded checkpoint format "
                      "(per-process shards of a device mesh)",
                      "Queue A 9, multi-GPU")

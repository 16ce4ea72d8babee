"""Fleet replica workers: role-typed handles over DecodeSessions plus
the newline-JSON wire that makes a replica a separate process
(counterpart of paddle_tpu/fleet/worker.py; the wire format and the
handshake are the JAX package's, field for field).

Three layers, smallest surface first:

* :class:`PrefillWorker` — the PREFILL role: no batcher, no queue. One
  call admits a prompt against its own KV pool, runs the
  prefill/extend executable, commits the prefix, EXPORTS the committed
  chain-key blocks through its :class:`~paddle_tpu_torch.fleet.BlockMigrator`
  and releases the reservation — the first generated token is
  discarded (the decode-role replica produces the stream). Pure cache
  warming: disaggregation is "prefill publishes, decode restores",
  never a KV wire protocol.
* :class:`LocalReplica` — an in-process replica handle (the unit the
  router schedules): ``submit`` / ``health`` / ``prefill`` / ``drain``
  over a live :class:`~paddle_tpu_torch.decoding.DecodeSession` or
  :class:`PrefillWorker`. The ``fleet.replica_death`` fault point
  fires per submit: a ``raise`` rule kills THIS replica in place
  (non-drain shutdown → every in-flight stream flushes with the typed
  ``GenerationInterruptedError`` + partial tokens, exactly what the
  router needs to resume on a survivor) — the in-process analog of a
  SIGKILLed worker. ``kill()`` stops the session's thread between two
  engine calls (each ends with a synchronize of its stream, so no
  replay is left in flight on a stream a survivor shares), then frees
  the replica's captured graphs and KV pools.
* :class:`ReplicaServer` / :class:`RemoteReplica` — the cross-process
  pair: a tiny newline-delimited-JSON TCP server (ephemeral
  ``port=0`` bind, one connection per request, streamed ``{"tok": t}``
  lines) and its client handle. Discovery follows the ckpt publish
  idiom: each server writes a handshake file
  ``<fleet_dir>/<name>.json`` (temp + atomic rename) carrying
  ``{name, role, host, port, pid, metrics_port, record_dir}`` — the
  metrics port comes from :func:`paddle_tpu_torch.obs.metrics.http_endpoint`
  so N replicas on one host never collide, and ``record_dir`` is where
  the router collects a dead replica's flight-recorder bundle.

Typed errors cross the wire by NAME (``serving.errors`` classes with
``retry_after_s`` / partial ``tokens`` preserved), so
``is_retriable`` and the router's resume path behave identically for
local and remote replicas. A connection that dies mid-stream becomes
``GenerationInterruptedError(tokens=streamed)`` — a SIGKILLed replica
and a preempted sequence look the same to the router, which is what
makes cross-replica resume one code path.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import tempfile
import threading
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..core.enforce import enforce
from ..decoding.cache import KVCacheManager
from ..decoding.sampling import SamplingParams
from ..resilience import faults
from ..resilience.faults import InjectedFault
from ..serving import errors as serving_errors
from ..serving.errors import (GenerationInterruptedError, ServerClosedError,
                              ServingError)

HANDSHAKE_SUFFIX = ".json"


# ---------------------------------------------------------------------------
# wire helpers
# ---------------------------------------------------------------------------


def _sampling_to_wire(p) -> Optional[dict]:
    if p is None:
        return None
    return {"temperature": p.temperature, "top_k": p.top_k,
            "top_p": p.top_p, "seed": p.seed}


def _sampling_from_wire(d) -> Optional[SamplingParams]:
    if not d:
        return None
    return SamplingParams(temperature=d.get("temperature", 0.0),
                          top_k=d.get("top_k", 0),
                          top_p=d.get("top_p", 1.0),
                          seed=d.get("seed", 0))


def _error_to_wire(exc: BaseException) -> dict:
    """Serialize via ``ServingError.to_wire`` (the stable contract in
    ``serving.errors``); non-serving exceptions get the same shape so
    the peer can at least surface name + message."""
    if isinstance(exc, ServingError):
        return exc.to_wire()
    return {"error": type(exc).__name__, "message": str(exc)}


_error_from_wire = serving_errors.from_wire


def write_handshake(fleet_dir: str, info: dict) -> str:
    """Publish one replica's discovery record atomically (temp file +
    rename — a reader never sees a torn handshake)."""
    os.makedirs(fleet_dir, exist_ok=True)
    path = os.path.join(fleet_dir, info["name"] + HANDSHAKE_SUFFIX)
    fd, tmp = tempfile.mkstemp(dir=fleet_dir, prefix=".tmp-hs-")
    with os.fdopen(fd, "w") as f:
        json.dump(info, f, sort_keys=True)
    os.rename(tmp, path)
    return path


def discover(fleet_dir: str) -> List[dict]:
    """Every published handshake in a fleet dir (sorted by name);
    unparseable files are skipped, never fatal."""
    out = []
    try:
        names = sorted(os.listdir(fleet_dir))
    except OSError:
        return out
    for fn in names:
        if fn.startswith(".") or not fn.endswith(HANDSHAKE_SUFFIX):
            continue
        try:
            with open(os.path.join(fleet_dir, fn)) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            continue
    return out


# ---------------------------------------------------------------------------
# prefill role
# ---------------------------------------------------------------------------


class PrefillWorker:
    """The disaggregated PREFILL role over one DecodeEngine.

    ``prefill(prompt)`` = admit → prefill/extend → commit → export →
    release; the produced first token is discarded. Its pool is a
    scratch cache: under pressure, admission failure drops the whole
    local prefix cache and retries once — a prefill replica's pool
    holds nothing a live stream depends on.
    """

    role = "prefill"

    def __init__(self, engine, migrator,
                 kv: Optional[KVCacheManager] = None):
        enforce(engine.cache_config.prefix_cache,
                "PrefillWorker needs CacheConfig(prefix_cache=True) — "
                "without chain keys there is nothing to export")
        self.engine = engine
        self.kv = kv or KVCacheManager(engine.cache_config)
        self.migrator = migrator
        migrator.export_on_commit = True
        self.prefills_total = 0
        self._lock = threading.Lock()

    def prefill(self, prompt: Sequence[int]) -> dict:
        """Warm the migration store with this prompt's cacheable span.
        Returns ``{"exported": n, "cached": tokens}``; a prompt with no
        full cacheable block (or no bucket) is a no-op, never an
        error."""
        tokens = [int(t) for t in np.asarray(prompt).reshape(-1)]
        with self._lock:  # one engine, one executor: serialize callers
            return self._prefill_locked(tokens)

    def _prefill_locked(self, tokens: List[int]) -> dict:
        kv = self.kv
        if kv._cacheable_blocks(len(tokens)) <= 0 \
                or self.engine.prompt_bucket_for(len(tokens)) is None:
            return {"exported": 0, "cached": 0}
        keys = kv.prefix_keys(tokens)
        if all(self.migrator.store.contains(k) for k in keys):
            return {"exported": 0, "cached": len(tokens)}
        adm = kv.admit_tokens(tokens, 1, keys=keys)
        if adm is None:
            kv.drop_prefix_cache()  # scratch pool: nothing precious
            adm = kv.admit_tokens(tokens, 1, keys=keys)
            if adm is None:
                return {"exported": 0, "cached": 0}
        sid, cached = adm
        row = kv.table_row(sid)
        params = [None] if self.engine.sampling else None
        try:
            if cached:
                self.engine.extend_prefill(
                    [np.asarray(tokens[cached:])], row[None, :],
                    np.asarray([cached], np.int32),
                    params=params, steps=[0])
            else:
                self.engine.prefill(
                    [np.asarray(tokens)], row[None, :],
                    np.asarray([len(tokens)], np.int32),
                    params=params, steps=[0])
            kv.commit_prefix(sid)
            exported = self.migrator.export_prefix(kv, tokens)
        finally:
            kv.release(sid)
        self.prefills_total += 1
        return {"exported": exported, "cached": cached}

    def health(self) -> dict:
        kv = self.kv
        return {"status": "serving", "role": self.role,
                "pressure": round(
                    1.0 - kv.reclaimable_blocks
                    / max(1, kv.config.num_blocks), 4),
                "prefills_total": self.prefills_total,
                "migration": self.migrator.stats()}

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Nothing to drain (stateless between calls). ``drain=False``
        (a kill) waits for a prefill in flight, then frees the engine's
        graphs and pools."""
        if not drain:
            with self._lock:
                self.engine.release()


# ---------------------------------------------------------------------------
# in-process replica handle
# ---------------------------------------------------------------------------


class LocalReplica:
    """One in-process replica the router schedules: a named, role-typed
    handle over a DecodeSession (decode role) or PrefillWorker."""

    def __init__(self, name: str, target, role: str = "decode",
                 migrator=None, record_dir: Optional[str] = None):
        self.name = str(name)
        self.target = target
        self.role = str(role)
        self.migrator = migrator
        self.record_dir = record_dir
        self._dead = False
        if migrator is not None and hasattr(target, "batcher"):
            target.batcher.migrator = migrator

    # -- liveness ------------------------------------------------------
    @property
    def dead(self) -> bool:
        return self._dead

    def kill(self) -> None:
        """The in-process analog of SIGKILL: mark dead and abort the
        session non-drain — every in-flight stream flushes with
        ``GenerationInterruptedError(tokens=partial)`` for the router
        to resume elsewhere — then free the replica's graphs and KV
        pools once its worker thread has stopped."""
        if self._dead:
            return
        self._dead = True
        try:
            self.target.shutdown(drain=False, timeout=30)
        except Exception:
            pass
        worker = getattr(self.target, "_worker", None)
        if worker is None or worker.is_alive():
            # a prefill worker freed its engine in shutdown; a session
            # still inside an engine call keeps its pools
            return
        for name in ("engine", "draft_engine"):
            engine = getattr(self.target, name, None)
            if engine is not None and hasattr(engine, "release"):
                engine.release()

    # -- the router-facing surface ------------------------------------
    def submit(self, payload: dict,
               on_token: Optional[Callable[[int], None]] = None
               ) -> Future:
        if self._dead:
            raise ServerClosedError("replica %r is dead" % self.name)
        try:
            faults.fire("fleet.replica_death", self.name.encode())
        except InjectedFault:
            self.kill()
            raise ServerClosedError(
                "replica %r killed by fault injection" % self.name
            ) from None
        return self.target.submit(
            payload["prompt"],
            max_new_tokens=payload.get("max_new_tokens"),
            eos_id=payload.get("eos_id"),
            deadline_ms=payload.get("deadline_ms"),
            sampling=_sampling_from_wire(payload.get("sampling")),
            priority=payload.get("priority"),
            resume_tokens=payload.get("resume_tokens"),
            on_token=on_token)

    def health(self) -> Optional[dict]:
        if self._dead:
            return None
        try:
            out = dict(self.target.health())
        except Exception:
            return None
        out.setdefault("role", self.role)
        out["name"] = self.name
        if self.record_dir:
            out["record_dir"] = self.record_dir
        if self.migrator is not None:
            out["migration"] = self.migrator.stats()
        return out

    def prefill(self, prompt) -> Optional[dict]:
        if self._dead or not hasattr(self.target, "prefill"):
            return None
        try:
            return self.target.prefill(prompt)
        except Exception:
            return None  # cache warming is best-effort by contract

    def drain(self, timeout: Optional[float] = None) -> None:
        self._dead = True
        self.target.shutdown(drain=True, timeout=timeout)

    def close(self) -> None:
        self.drain()


# ---------------------------------------------------------------------------
# cross-process: server + client handle
# ---------------------------------------------------------------------------


class _ReplicaHandler(socketserver.StreamRequestHandler):
    def handle(self):
        server: "ReplicaServer" = self.server.replica  # type: ignore
        try:
            line = self.rfile.readline()
            if not line:
                return
            req = json.loads(line.decode())
        except Exception:
            self._send({"error": "ProtocolError",
                        "message": "unparseable request line"})
            return
        op = req.get("op")
        try:
            if op == "submit":
                self._op_submit(server, req)
            elif op == "health":
                h = server.replica_handle.health()
                self._send({"ok": h is not None, "health": h})
            elif op == "prefill":
                out = server.replica_handle.prefill(
                    req.get("prompt") or [])
                self._send({"ok": out is not None, "result": out})
            elif op == "drain":
                self._send({"ok": True})
                server.shutdown_target(drain=True)
            elif op == "stop":
                self._send({"ok": True})
                server.shutdown_target(drain=False)
            else:
                self._send({"error": "ProtocolError",
                            "message": "unknown op %r" % (op,)})
        except BrokenPipeError:
            pass
        except Exception as e:
            try:
                self._send(_error_to_wire(e))
            except Exception:
                pass

    def _send(self, obj: dict) -> None:
        self.wfile.write((json.dumps(obj) + "\n").encode())
        self.wfile.flush()

    def _op_submit(self, server: "ReplicaServer", req: dict) -> None:
        lock = threading.Lock()  # token writes come from the worker

        def stream(tok: int) -> None:
            with lock:
                self.wfile.write(
                    (json.dumps({"tok": int(tok)}) + "\n").encode())
                self.wfile.flush()

        fut = server.replica_handle.submit(req, on_token=stream)
        try:
            tokens = fut.result(timeout=req.get("timeout") or 600)
        except Exception as e:
            with lock:
                self._send(_error_to_wire(e))
            return
        with lock:
            self._send({"done": True,
                        "tokens": [int(t) for t in tokens]})


class _TCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class ReplicaServer:
    """Serve one replica over newline-JSON TCP and publish its
    handshake. Wraps any :class:`LocalReplica`-shaped handle."""

    def __init__(self, replica_handle, fleet_dir: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.replica_handle = replica_handle
        self._tcp = _TCPServer((host, port), _ReplicaHandler)
        self._tcp.replica = self  # type: ignore[attr-defined]
        self.host, self.port = self._tcp.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self.handshake_path = None
        if fleet_dir:
            from ..obs import metrics as obs_metrics

            endpoint = obs_metrics.http_endpoint()
            self.handshake_path = write_handshake(fleet_dir, {
                "name": replica_handle.name,
                "role": replica_handle.role,
                "host": self.host, "port": self.port,
                "pid": os.getpid(),
                "metrics_port": endpoint[1] if endpoint else None,
                "record_dir": getattr(replica_handle, "record_dir",
                                      None),
            })

    def start(self) -> "ReplicaServer":
        self._thread = threading.Thread(
            target=self._tcp.serve_forever,
            name="pdtpu-fleet-replica", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Foreground serve (worker processes): blocks until a drain/
        stop op (or :meth:`stop`) shuts the replica down."""
        self.start()
        self._stopping.wait()

    def shutdown_target(self, drain: bool) -> None:
        try:
            if drain:
                self.replica_handle.drain(timeout=120)
            else:
                self.replica_handle.kill()
        finally:
            self.stop()

    def stop(self) -> None:
        self._stopping.set()
        try:
            self._tcp.shutdown()
            self._tcp.server_close()
        except Exception:
            pass


class RemoteReplica:
    """Client handle over a :class:`ReplicaServer` (one connection per
    request), constructed from a discovery handshake dict."""

    def __init__(self, handshake: dict, timeout_s: float = 600.0):
        self.name = handshake["name"]
        self.role = handshake.get("role", "decode")
        self.host = handshake.get("host", "127.0.0.1")
        self.port = int(handshake["port"])
        self.pid = handshake.get("pid")
        self.record_dir = handshake.get("record_dir")
        self.metrics_port = handshake.get("metrics_port")
        self.timeout_s = float(timeout_s)
        self._dead = False

    @property
    def dead(self) -> bool:
        return self._dead

    def kill(self) -> None:
        self._dead = True  # the process's own death is out of band

    def _connect(self, timeout: float) -> socket.socket:
        return socket.create_connection((self.host, self.port),
                                        timeout=timeout)

    def _rpc(self, obj: dict, timeout: float) -> Optional[dict]:
        try:
            with self._connect(timeout) as sk:
                f = sk.makefile("rwb")
                f.write((json.dumps(obj) + "\n").encode())
                f.flush()
                line = f.readline()
            return json.loads(line.decode()) if line else None
        except (OSError, ValueError):
            return None

    def submit(self, payload: dict,
               on_token: Optional[Callable[[int], None]] = None
               ) -> Future:
        if self._dead:
            raise ServerClosedError("replica %r is dead" % self.name)
        payload = dict(payload)
        payload["op"] = "submit"
        fut: Future = Future()
        try:
            sk = self._connect(self.timeout_s)
        except OSError:
            self._dead = True
            raise ServerClosedError(
                "replica %r is unreachable" % self.name) from None

        def reader() -> None:
            streamed: List[int] = []
            try:
                f = sk.makefile("rwb")
                f.write((json.dumps(payload) + "\n").encode())
                f.flush()
                for raw in f:
                    msg = json.loads(raw.decode())
                    if "tok" in msg:
                        streamed.append(int(msg["tok"]))
                        if on_token is not None:
                            try:
                                on_token(int(msg["tok"]))
                            except Exception:
                                pass
                        continue
                    if msg.get("done"):
                        fut.set_result([int(t) for t in msg["tokens"]])
                        return
                    fut.set_exception(_error_from_wire(msg))
                    return
                raise OSError("stream closed before completion")
            except Exception:
                # the process died mid-stream (SIGKILL, cut socket):
                # surface the partial stream exactly like a preemption
                self._dead = True
                fut.set_exception(GenerationInterruptedError(
                    "replica %r connection lost mid-stream"
                    % self.name, tokens=streamed))
            finally:
                try:
                    sk.close()
                except OSError:
                    pass

        threading.Thread(target=reader, daemon=True,
                         name="pdtpu-fleet-stream").start()
        return fut

    def health(self, timeout: float = 2.0) -> Optional[dict]:
        if self._dead:
            return None
        out = self._rpc({"op": "health"}, timeout)
        if out is None or not out.get("ok"):
            return None
        return out.get("health")

    def prefill(self, prompt, timeout: float = 120.0) -> Optional[dict]:
        if self._dead:
            return None
        out = self._rpc({"op": "prefill",
                         "prompt": [int(t) for t in prompt]}, timeout)
        if out is None or not out.get("ok"):
            return None
        return out.get("result")

    def drain(self, timeout: Optional[float] = None) -> None:
        self._rpc({"op": "drain"}, timeout or 120.0)
        self._dead = True

    def close(self) -> None:
        self.drain()


def serve_replica(target, name: str, role: str = "decode",
                  fleet_dir: Optional[str] = None, migrator=None,
                  host: str = "127.0.0.1", port: int = 0,
                  start_metrics: bool = True) -> ReplicaServer:
    """Worker-process entry point: wrap ``target`` (DecodeSession or
    PrefillWorker) as a named replica, start the opt-in /metrics server
    on an ephemeral port, publish the handshake, and return the started
    :class:`ReplicaServer` (call ``serve_forever()`` to block)."""
    record_dir = os.environ.get("PDTPU_RECORD_DIR")
    if start_metrics:
        from ..obs import metrics as obs_metrics

        if obs_metrics.http_endpoint() is None:
            obs_metrics.start_http_server(port=0)
    handle = LocalReplica(name, target, role=role, migrator=migrator,
                          record_dir=record_dir)
    return ReplicaServer(handle, fleet_dir=fleet_dir, host=host,
                         port=port).start()

"""Worker for tests/test_torch_fleet.py's cross-process fleet coverage
(the port's counterpart of tests/_fleet_worker.py; imports only the
port and runs on the CPU).

Usage: python _torch_fleet_worker.py <spec_json> <out_json>

``spec_json`` is one JSON object:

* ``mode: "replica"`` — build the seeded LM (``build_lm``: every float
  parameter is PURE seeded noise, so any process with the same seed
  holds bit-identical weights), serve it as a fleet replica over the
  newline-JSON wire (``fleet.serve_replica`` — handshake published to
  ``fleet_dir``, /metrics on an ephemeral port), print WORKER_READY
  and block until a drain/stop op. ``role`` picks decode (a full
  DecodeSession) or prefill (a PrefillWorker warming the shared
  MigrationStore at ``store_root``). ``kill_after_tokens > 0`` arms
  the SIGKILL trap: after that many streamed tokens TOTAL the process
  kills itself mid-stream with no cleanup — the abrupt replica death
  the router must survive.
* ``mode: "oracle"`` — run every request in ``requests`` sequentially
  on ONE plain single-replica session in an identical worker env and
  write the streams to ``out_json`` — the bit-identity oracle.
"""

import json
import os
import signal
import sys
import threading

VOCAB = 23


def build_lm(seed, layers=1, d=16):
    """A tiny causal LM on the CPU whose float params are pure seeded
    noise (the JAX worker's draws, in its order) — the same weights in
    every process and in either package."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.convert import seeded_state
    from paddle_tpu_torch.models.causal_lm import causal_lm

    place = fluid.CPUPlace()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens, logits = causal_lm(vocab_size=VOCAB, n_layer=layers,
                                   n_head=2, d_model=d,
                                   d_inner_hid=2 * d)
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    seeded_state(main, scope, place, seed, 0.1)
    return main, scope, logits


def _config(spec):
    from paddle_tpu_torch.decoding import CacheConfig, DecodingConfig

    return DecodingConfig(
        cache=CacheConfig(prefix_cache=True, **spec["cache"]),
        decode_buckets=tuple(spec.get("decode_buckets", (1, 2, 4))),
        max_new_tokens=int(spec.get("max_new_tokens", 16)),
        sampling=True)


def build_session(spec):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding import serve_decoding

    main, scope, logits = build_lm(spec["seed"])
    return serve_decoding(main, "tokens", logits.name, scope=scope,
                          config=_config(spec), place=fluid.CPUPlace())


def build_engine(spec):
    """A bare DecodeEngine (no session/queue thread) — prefill role."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.decoding.engine import DecodeEngine

    main, scope, logits = build_lm(spec["seed"])
    return DecodeEngine(main, "tokens", logits.name, scope=scope,
                        config=_config(spec), place=fluid.CPUPlace())


class _KillAfter:
    """Session proxy arming the SIGKILL trap: counts streamed tokens
    across ALL submissions and kills the process the instant the n-th
    one has been flushed to the client — a mid-stream death with the
    partial stream already on the wire."""

    def __init__(self, target, n):
        self._t, self._n = target, int(n)
        self._count = 0
        self._lock = threading.Lock()

    def submit(self, prompt, **kw):
        inner = kw.pop("on_token", None)

        def tap(tok):
            if inner is not None:
                inner(tok)  # flush to the client FIRST, then die
            with self._lock:
                self._count += 1
                if self._count >= self._n:
                    os.kill(os.getpid(), signal.SIGKILL)

        return self._t.submit(prompt, on_token=tap, **kw)

    def __getattr__(self, name):
        return getattr(self._t, name)


def run_replica(spec, out_json):
    from paddle_tpu_torch import fleet

    store = fleet.MigrationStore(spec["store_root"])
    if spec.get("role") == "prefill":
        eng = build_engine(spec)
        mig = fleet.BlockMigrator(store, eng, export=True)
        target = fleet.PrefillWorker(eng, mig)
        srv = fleet.serve_replica(target, spec["name"], role="prefill",
                                  fleet_dir=spec["fleet_dir"])
    else:
        sess = build_session(spec)
        mig = fleet.BlockMigrator(store, sess.engine)
        target = sess
        if spec.get("kill_after_tokens"):
            target = _KillAfter(sess, spec["kill_after_tokens"])
        srv = fleet.serve_replica(target, spec["name"], role="decode",
                                  fleet_dir=spec["fleet_dir"],
                                  migrator=mig)
    print("WORKER_READY", flush=True)
    srv.serve_forever()
    with open(out_json, "w") as f:
        json.dump({"ok": True}, f)
    print("WORKER_DONE", flush=True)


def run_oracle(spec, out_json):
    from paddle_tpu_torch.decoding import SamplingParams

    sess = build_session(spec)
    streams = []
    try:
        for r in spec["requests"]:
            sp = r.get("sampling")
            toks = sess.generate(
                r["prompt"],
                max_new_tokens=r.get("max_new_tokens"),
                sampling=SamplingParams(**sp) if sp else None,
                priority=r.get("priority"))
            streams.append([int(t) for t in toks])
    finally:
        sess.shutdown(drain=True, timeout=60)
    with open(out_json, "w") as f:
        json.dump({"streams": streams}, f)
    print("WORKER_DONE", flush=True)


def main():
    spec_json, out_json = sys.argv[1], sys.argv[2]
    with open(spec_json) as f:
        spec = json.load(f)

    import torch

    torch.set_num_threads(1)
    if spec["mode"] == "oracle":
        run_oracle(spec, out_json)
    else:
        run_replica(spec, out_json)


if __name__ == "__main__":
    main()

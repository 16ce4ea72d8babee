"""paddle_tpu_torch.fleet — multi-replica decode serving (counterpart of
paddle_tpu/fleet).

Several decode processes (or in-process replicas) behind one router:

* :class:`Router` / :class:`FleetConfig` — prefix-affinity scheduling
  over replica handles, pressure spillover, typed fleet-wide overload,
  cross-replica resume of interrupted streams;
* :class:`PrefillWorker`, :class:`LocalReplica`,
  :class:`RemoteReplica`, :class:`ReplicaServer`,
  :func:`serve_replica`, :func:`discover` — disaggregated
  prefill/decode roles, in-process and newline-JSON-TCP replica
  handles, handshake-file discovery;
* :class:`MigrationStore` / :class:`BlockMigrator` — content-addressed
  KV-block migration (first publisher wins, verify on read, evict and
  never crash), restored into the device pools in place;
* :class:`FleetMetrics`, :func:`relabel_exposition`,
  :func:`aggregate_scrape` — one ``pdtpu_fleet_*`` scrape surface with
  per-replica labels.

Everything is off by default: with no fleet object constructed nothing
changes anywhere — stamps, fingerprints and streams are byte-identical.
Replicas run on the card unless their engines were built with
``place=CPUPlace()``; ``python -m paddle_tpu_torch.tools.fleet serve``
starts one as a process.
"""

from .metrics import (FleetMetrics, aggregate_scrape,
                      relabel_exposition, scrape_replica)
from .migrate import BlockMigrator, MigrationStore
from .router import FleetConfig, Router
from .worker import (LocalReplica, PrefillWorker, RemoteReplica,
                     ReplicaServer, discover, serve_replica,
                     write_handshake)

__all__ = [
    "FleetConfig", "Router",
    "PrefillWorker", "LocalReplica", "RemoteReplica", "ReplicaServer",
    "serve_replica", "discover", "write_handshake",
    "MigrationStore", "BlockMigrator",
    "FleetMetrics", "relabel_exposition", "scrape_replica",
    "aggregate_scrape",
]

"""The single-host serving plane: a port of ``tse1m_tpu/serve``'s daemon,
TCP transport and SLO layer.

A single-writer ingest daemon (``daemon.ServeDaemon``) over one signature
store, lock-free queries over atomically swapped
``cluster.incremental.LiveClusterIndex`` snapshots, admission control
(``slo``), and a JSON-over-TCP transport (``server``/``client``) whose
bytes are the JAX package's.  ``python -m tse1m_tpu_torch serve`` runs it.
The router, the read replica and shard mode are not ported yet
(ROADMAP.md Queue 1, "Serve plane").
"""

from .client import Backpressure, ServeClient, ServeError
from .daemon import IngestRejected, ServeDaemon
from .server import ServeServer
from .slo import AdmissionController, SloPolicy, SloTracker

__all__ = ["AdmissionController", "Backpressure", "IngestRejected",
           "ServeClient", "ServeDaemon", "ServeError", "ServeServer",
           "SloPolicy", "SloTracker"]

"""The serving plane: a port of ``tse1m_tpu/serve``.

A single-writer ingest daemon (``daemon.ServeDaemon``) over one signature
store, lock-free queries over atomically swapped
``cluster.incremental.LiveClusterIndex`` snapshots, admission control
(``slo``), and a JSON-over-TCP transport (``server``/``client``) whose
bytes are the JAX package's.  ``python -m tse1m_tpu_torch serve`` runs it.

Scale-out on one card: ``router.ShardRouter`` fans the same verbs over N
digest-range shard daemons (each a ``ServeDaemon`` over one
``range_NNNN/`` slice, fenced by an epoch lease) with durable-once ingest
acks, and ``replicate.ServeReplica`` serves stale-bounded reads from a
streamed store copy; ``ServeClient`` works unchanged against each of the
three topologies (``serve --root/--range``, ``serve-router``,
``serve-replica``).
"""

from .client import Backpressure, ServeClient, ServeError
from .daemon import IngestRejected, ServeDaemon
from .replicate import (ReplicationPuller, ServeReplica, replica_staleness,
                        stream_shards)
from .router import LocalTransport, RouterServer, ShardRouter, TcpTransport
from .server import ServeServer
from .slo import AdmissionController, SloPolicy, SloTracker

__all__ = ["AdmissionController", "Backpressure", "IngestRejected",
           "LocalTransport", "ReplicationPuller", "RouterServer",
           "ServeClient", "ServeDaemon", "ServeError", "ServeReplica",
           "ServeServer", "ShardRouter", "SloPolicy", "SloTracker",
           "TcpTransport", "replica_staleness", "stream_shards"]

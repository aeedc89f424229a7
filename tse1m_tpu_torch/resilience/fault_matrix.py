"""The port's fault-seat inventory, read by graftlint's
``fault-seat-drift`` pass (``lint/interproc.py``).

Every ``fault_point(...)`` seat in the port's code has an entry here,
naming the fault kinds exercised against it and the tests that cover it,
and every entry corresponds to a live seat.  Adding a seat without an
entry, leaving a dead entry behind, or listing a kind that
``resilience/faults.py`` does not implement fails lint.  The JAX package
keeps its own inventory (``tests/ci_fault_matrix.py``) for its own seats.

A literal dict of literals: the lint reads it as source, never imports
it.
"""

from __future__ import annotations

PRODUCTION_SEATS = {
    "http.fetch": {
        "kinds": ("raise", "connection_drop", "delay"),
        "covered_by": "tests/test_torch_io_resilience.py (HttpFetcher "
                      "retry and Retry-After under injected faults, the "
                      "GCS pager's CSV equal to a fault-free run's)"},
    "db.connect": {
        "kinds": ("raise", "connection_drop"),
        "covered_by": "tests/test_torch_io_resilience.py (connect retried "
                      "and reconnect on a drop, `all` under DB faults)"},
    "db.execute": {
        "kinds": ("raise", "connection_drop", "delay"),
        "covered_by": "tests/test_torch_io_resilience.py (statement retry, "
                      "reconnect, transaction units, ingest and restore "
                      "equal to fault-free runs)"},
    "checkpoint.csv.flush": {
        "kinds": ("torn_write", "kill"),
        "covered_by": "tests/test_torch_io_resilience.py (torn batch "
                      "writes, SIGKILL mid-batch then resume)"},
    "pglib.exec": {
        "kinds": ("connection_drop",),
        "covered_by": "not driven by a port test: the port runs no "
                      "Postgres server (tests/test_torch_pg.py holds the "
                      "protocol layer without one)"},
    "checkpoint.cluster.save": {
        "kinds": ("torn_write", "kill"),
        "covered_by": "tests/test_torch_checkpoint.py (SIGKILL of the "
                      "cluster command, resume) + "
                      "tests/test_torch_resilience.py (torn write)"},
    "store.sig.save": {
        "kinds": ("connection_drop", "torn_write"),
        "covered_by": "tests/test_torch_resilience.py + "
                      "tests/test_torch_scrub.py (torn shard found and "
                      "quarantined)"},
    "store.compact.save": {
        "kinds": ("kill", "raise"),
        "covered_by": "tests/test_torch_resilience.py + "
                      "tests/test_torch_scrub.py (failed compaction "
                      "leaves the store readable)"},
    "store.state.save": {
        "kinds": ("stall", "torn_write"),
        "covered_by": "tests/test_torch_resilience.py + "
                      "tests/test_torch_scrub.py"},
    "pipeline.h2d": {
        "kinds": ("raise", "stall", "delay", "kill", "hostloss", "zombie"),
        "covered_by": "tests/test_torch_degradation.py (OOM ladder, stall "
                      "retry) + tests/test_torch_pod.py (kill, zombie)"},
    "pipeline.compute": {
        "kinds": ("stall", "delay"),
        "covered_by": "tests/test_torch_degradation.py (compute-stall "
                      "cancel and retry)"},
    "serve.ingest.commit": {
        "kinds": ("kill",),
        "covered_by": "tests/test_torch_serve_chaos.py (SIGKILL "
                      "mid-ingest: zero lost acknowledged rows)"},
    "backend.device.call": {
        "kinds": ("raise",),
        "covered_by": "tests/test_torch_backend_auto.py (host re-run and "
                      "device demotion)"},
    "serve.router.forward": {
        "kinds": ("connection_drop",),
        "covered_by": "tests/test_torch_router.py (dropped ack replayed "
                      "by request id: full ack, zero double-absorb)"},
    "serve.replica.stream": {
        "kinds": ("raise",),
        "covered_by": "tests/test_torch_replica.py (a pull dying before "
                      "the manifest commit leaves the replica on its "
                      "generation)"},
}

__all__ = ["PRODUCTION_SEATS"]

"""tail_idle_ms (ms; layer: LSH tail; moves cluster_rows_per_s).

Device idle a clustering call inside the program's ``tse1m.lsh`` region
(the LSH tail: band re-shard, hub election, edge checks, propagation and
its convergence tests) and outside its ``tse1m.mesh.*`` regions, which
``mesh_idle_ms`` reads.  None where the trace holds no ``tse1m.lsh`` or
no device event (a run on the CPU).
"""

from benchmark.harness.regions import (idle_in, mesh_region, minus,
                                        regions)


def read(view):
    tail = regions(view, lambda name: name == "tse1m.lsh")
    if not view.calls or not view.device or not tail:
        return None
    return idle_in(view, minus(tail, regions(view, mesh_region))) \
        / view.calls * 1e-3

"""scan_edge_idle_ms (ms; layer: entry, feed, mesh; moves
scan_pairs_per_s).

Device idle a scan pass inside the program's ``tse1m.scan.prepare``
(queries padded and uploaded, state and chunk scratch allocated) and
``tse1m.scan.finalize`` (the answers' fetch) regions: the pass's edges,
where no chunk is in flight.  None where the trace holds neither, or no
device event (a run on the CPU).
"""

from benchmark.harness.regions import idle_in, regions

EDGES = ("tse1m.scan.prepare", "tse1m.scan.finalize")


def read(view):
    edges = regions(view, lambda name: name in EDGES)
    if not view.calls or not view.device or not edges:
        return None
    return idle_in(view, edges) / view.calls * 1e-3

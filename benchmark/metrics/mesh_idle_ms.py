"""mesh_idle_ms (ms; layer: entry, feed, mesh; moves cluster_rows_per_s).

Device idle a clustering call inside the program's ``tse1m.mesh.*``
regions: each collective of ``parallel/mesh.py:Mesh._run`` with the two
device syncs around it.  None where the trace holds no such region or
no device event (a run on the CPU).
"""

from benchmark.harness.regions import idle_in, mesh_region, regions


def read(view):
    mesh = regions(view, mesh_region)
    if not view.calls or not view.device or not mesh:
        return None
    return idle_in(view, mesh) / view.calls * 1e-3

"""launches_per_call.cluster (launches; layer: entry, feed, mesh; moves
cluster_rows_per_s).

Kernels, copies and fills the profiler sees on the device a clustering
call: each is a launch from the host.
"""


def read(view):
    if not view.calls or not view.device:
        return None
    return len(view.device) / view.calls

"""topk_roofline_pct (%; layer: top-k kernel; moves scan_pairs_per_s).

The least time one scan pass needs, from the cell's shapes
(``harness/peaks.py:topk_bound``: Q x N x H compares and adds on two
integer pipes, or the queries, the store and the state read once),
over the device time a pass of the kernels listed in ``KERNELS``.
"""

from benchmark.harness.peaks import topk_bound

# The top-k kernel's count pass and select pass.
KERNELS = ("topk_count_kernel", "topk_select_kernel")


def read(view):
    s = view.shapes
    us = view.device_us(lambda e: e.cat == "kernel" and e.short in KERNELS)
    if not view.calls or not us or "queries" not in s:
        return None
    bound_ms, _ = topk_bound(s["queries"], s["store_rows"], s["n_hashes"])
    return 100.0 * bound_ms * view.calls / (us * 1e-3)

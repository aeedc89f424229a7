"""signature_roofline_pct (%; layer: signature kernels; moves
cluster_rows_per_s).

The least time the signature stage of one call needs, from the cell's
shapes (``harness/peaks.py``: K-permutation signatures and band keys, or
the one-permutation bin minima), over the device time a call of the
kernels listed in ``KERNELS``.  None where none of them ran.
"""

from benchmark.harness.peaks import cminhash_bound, minhash_bound

# The signature stage's kernels: the fused MinHash and band-key kernel
# (raw ids or byte-packed), and the one-permutation bin-min kernel.
KERNELS = ("minhash_keys_kernel", "cminhash_binmin_kernel")


def read(view):
    s = view.shapes
    us = view.device_us(lambda e: e.cat == "kernel" and e.short in KERNELS)
    if not view.calls or not us or "rows" not in s:
        return None
    if s["scheme"] == "kminhash":
        bound_ms, _ = minhash_bound(s["rows"], s["set_size"], s["n_hashes"],
                                    s["n_bands"])
    else:
        bound_ms, _ = cminhash_bound(s["rows"], s["set_size"], s["n_hashes"])
    return 100.0 * bound_ms * view.calls / (us * 1e-3)

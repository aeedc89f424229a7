"""lsh_device_ms (ms; layer: LSH tail; moves cluster_rows_per_s).

Device time a clustering call of every kernel, copy and fill except the
signature kernels and the device-to-host copies (the label fetch): the
band re-shard and gather, hub election, edge checks and label
propagation.  None outside a clustering cell.
"""

SIGNATURE_KERNELS = ("minhash_keys_kernel", "cminhash_binmin_kernel")


def read(view):
    if not view.calls or "rows" not in view.shapes:
        return None
    us = view.device_us(lambda e: e.short not in SIGNATURE_KERNELS
                        and not e.name.startswith("Memcpy DtoH"))
    return us / view.calls * 1e-3 if us else None

"""scan_h2d_ms (ms; layer: scan staging; moves scan_pairs_per_s).

Device time a scan pass of the host-to-device copies: the store's chunks
and the queries staged from pinned host buffers.
"""


def read(view):
    if not view.calls or "queries" not in view.shapes:
        return None
    us = view.device_us(lambda e: e.name.startswith("Memcpy HtoD"))
    return us / view.calls * 1e-3 if us else None

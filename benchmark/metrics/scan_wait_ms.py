"""scan_wait_ms (ms; layer: scan staging; moves scan_pairs_per_s).

Device idle a scan pass inside the program's ``tse1m.scan.wait``
regions: the calling thread blocked on the staging thread's next chunk
(``cluster/kernels/score.py:_staged``) while no kernel, copy or fill ran.
The regions' own host time is no measure of a stall: the staging thread
waits for the card to release a buffer before it refills it, so the
calling thread waits there for most of a pass while the card is busy.
The staging thread's own work is not in the trace, so this is how
staging shows.  None where the trace holds no such region or no device
event (a run on the CPU).
"""

from benchmark.harness.regions import idle_in, regions


def read(view):
    wait = regions(view, lambda name: name == "tse1m.scan.wait")
    if not view.calls or not view.device or not wait:
        return None
    return idle_in(view, wait) / view.calls * 1e-3

"""What the region metrics read (``metrics/propagate_steps.py``,
``mesh_idle_ms``, ``tail_idle_ms``, ``scan_wait_ms``,
``scan_edge_idle_ms``): the program's profiler regions (``tse1m.*``, the
port's ``observability/tracing.py:region``) among a ``TraceView``'s host
events, as sorted disjoint (start, end) intervals in microseconds, and the
device's idle time inside them.

A region nested in another of the same selection counts once: the
selection's intervals are merged before anything is measured.
"""

from .trace import gaps_us


def regions(view, pred) -> list:
    """The union of the host spans whose name ``pred`` accepts, clipped
    to the window."""
    out: list = []
    for s, e, _ in sorted(h for h in view.host if pred(h[2])):
        s, e = max(s, view.t0), min(e, view.t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def intersect(a: list, b: list) -> list:
    """Both sorted and disjoint; so is the result."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(a: list, b: list) -> list:
    """The parts of ``a`` outside ``b`` (both sorted and disjoint)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def idle_in(view, intervals: list) -> float:
    """Microseconds of the window in ``intervals`` that no kernel, copy
    or fill covers."""
    return length(intersect(gaps_us(view.intervals(), view.t0, view.t1),
                            intervals))


def mesh_region(name: str) -> bool:
    return name.startswith("tse1m.mesh.")

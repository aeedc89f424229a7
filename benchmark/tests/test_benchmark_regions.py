"""The region metrics (``propagate_steps``, ``mesh_idle_ms``,
``tail_idle_ms``, ``scan_wait_ms``, ``scan_edge_idle_ms``) on synthetic
traces with known gaps and regions, and the interval arithmetic of
``harness/regions.py`` against a microsecond grid."""

import numpy as np
import pytest

from benchmark.harness import cells, regions
from benchmark.harness.trace import TraceView

CLUSTER_METRICS = ("propagate_steps", "mesh_idle_ms", "tail_idle_ms")
SCAN_METRICS = ("scan_wait_ms", "scan_edge_idle_ms")


def _x(name, cat, ts, end):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts,
            "args": {}}


def _view(device, host):
    """A window of 1,000 us, two calls, kernels at ``device`` and
    user annotations ``host`` ((name, start, end))."""
    events = [_x("bench.window", "user_annotation", 0, 1000),
              _x("bench.call", "user_annotation", 0, 500),
              _x("bench.call", "user_annotation", 500, 1000)]
    events += [_x("k", "kernel", s, e) for s, e in device]
    events += [_x(n, "user_annotation", s, e) for n, s, e in host]
    return TraceView(events, {})


def _cluster_view():
    """Device idle over [100, 200], [300, 600] and [700, 900]."""
    return _view(
        [(0, 100), (200, 300), (600, 700), (900, 1000)],
        [("tse1m.lsh", 50, 450), ("tse1m.lsh", 60, 440),  # nested: once
         ("tse1m.lsh", 550, 950),
         ("tse1m.lsh.step", 110, 400), ("tse1m.lsh.step", 400, 440),
         ("tse1m.lsh.step", 700, 800),
         # Overlapping mesh regions count once: [120, 190] has 70 idle.
         ("tse1m.mesh.pmin", 120, 180), ("tse1m.mesh.all_gather", 150, 190),
         ("tse1m.mesh.pmin", 320, 380), ("tse1m.mesh.pmin", 710, 760),
         ("aten::sort", 100, 200)])


def _scan_view():
    """Device idle over [0, 100], [450, 600] and [950, 1000]."""
    return _view(
        [(100, 450), (600, 950)],
        [("tse1m.scan.prepare", 0, 120), ("tse1m.scan.prepare", 10, 60),
         ("tse1m.scan.prepare", 480, 560),
         ("tse1m.scan.finalize", 440, 470), ("tse1m.scan.finalize", 940,
                                             1000),
         ("tse1m.scan.chunk", 120, 440), ("tse1m.scan.chunk", 590, 930),
         ("tse1m.scan.wait", 90, 150), ("tse1m.scan.wait", 140, 160),
         ("tse1m.scan.wait", 590, 640)])


def _read(name, view):
    return cells.metric(name).read(view)


def test_cluster_metrics_read_the_known_values():
    view = _cluster_view()
    assert _read("propagate_steps", view) == pytest.approx(1.5)
    # (70 + 60 + 50) us over 2 calls.
    assert _read("mesh_idle_ms", view) == pytest.approx(0.090)
    # Idle in tse1m.lsh: 100 + 150 + 50 + 200 us, less the mesh's 180.
    assert _read("tail_idle_ms", view) == pytest.approx(0.160)


def test_scan_metrics_read_the_known_values():
    view = _scan_view()
    # Waits [90, 160] and [590, 640]: their idle, [90, 100] and
    # [590, 600], is 20 us over 2 passes; the busy rest counts nothing.
    assert _read("scan_wait_ms", view) == pytest.approx(0.010)
    # Idle in the edges: 100 + 80 + 20 + 50 us over 2 passes.
    assert _read("scan_edge_idle_ms", view) == pytest.approx(0.125)


@pytest.mark.parametrize("name", CLUSTER_METRICS)
def test_cluster_metrics_are_none_in_the_scan_cell(name):
    assert _read(name, _scan_view()) is None


@pytest.mark.parametrize("name", SCAN_METRICS)
def test_scan_metrics_are_none_in_the_cluster_cell(name):
    assert _read(name, _cluster_view()) is None


@pytest.mark.parametrize("name", ("mesh_idle_ms", "tail_idle_ms",
                                  "scan_wait_ms", "scan_edge_idle_ms"))
def test_idle_metrics_are_none_without_device_events(name):
    host = [(n, 0, 1000) for n in ("tse1m.lsh", "tse1m.mesh.pmin",
                                   "tse1m.scan.wait", "tse1m.scan.prepare")]
    assert _read(name, _view([], host)) is None


def test_mesh_and_tail_idle_fit_in_the_idle_a_call():
    view = _cluster_view()
    idle_ms = (view.window_s - view.busy_s) * 1e3 / view.calls
    assert _read("mesh_idle_ms", view) + _read("tail_idle_ms", view) \
        <= idle_ms


@pytest.mark.parametrize("seed", range(6))
def test_interval_arithmetic_against_a_grid(seed):
    rng = np.random.default_rng(seed)

    def spans(n):
        s = rng.integers(0, 200, size=n)
        return [(int(a), int(a + d)) for a, d in
                zip(s, rng.integers(1, 40, size=n))]

    device, ra, rb = spans(12), spans(8), spans(8)
    view = _view(device, [("a", s, e) for s, e in ra]
                 + [("b", s, e) for s, e in rb])
    grid = np.zeros((3, 1000), bool)
    for row, sp in enumerate((device, ra, rb)):
        for s, e in sp:
            grid[row, s:e] = True
    a = regions.regions(view, lambda n: n == "a")
    b = regions.regions(view, lambda n: n == "b")
    assert all(x[1] < y[0] for x, y in zip(a, a[1:]))
    assert regions.length(a) == grid[1].sum()
    assert regions.length(regions.intersect(a, b)) == \
        (grid[1] & grid[2]).sum()
    assert regions.length(regions.minus(a, b)) == (grid[1] & ~grid[2]).sum()
    assert regions.idle_in(view, regions.minus(a, b)) == \
        (grid[1] & ~grid[2] & ~grid[0]).sum()

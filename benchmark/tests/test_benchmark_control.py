"""The control comes out not correct, at a size a test run holds.

The control is the reference put in the program's place with one
guarantee broken by a narrower type, the step that would tempt a later
change: band keys of 16 bits instead of 32 for the clustering cell, and
signature values compared on their low 16 bits for the scan cell.  The
full-size control runs on the card (``benchmark/control.py``).

At 1M sessions 16-bit keys put about 15 sessions in each bucket of a band.
The clustering test keeps that crowding at its 4,000 sessions with 8-bit
keys (about 16 a bucket); 16-bit keys would crowd 4,000 sessions far
less than the cell's 1M.
"""

import pytest

from benchmark.harness import cells

SEED = 2**31 + 9


def _cell(name: str, n: int, params: dict):
    wl = cells.workload(name)
    cfg = cells.config(wl["config"])
    cfg["n_sessions"] = n
    p = dict(wl["params"], **params)
    cell = cells.driver(wl["driver"]).Cell(cfg, p, SEED, "cpu", "")
    cell.make_inputs()
    return cell, wl["limits"]


def _fails(verdict: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in verdict["numbers"].items())


def test_cluster_control_with_narrow_keys_fails():
    cell, limits = _cell("cluster.kminhash.resident", 4000,
                         {"control": {"key_bits": 8}})
    verdict = cell.control()
    assert _fails(verdict, limits), verdict


@pytest.mark.parametrize("low_bits", [16])
def test_scan_control_with_low_bits_fails(low_bits):
    cell, limits = _cell("scan.cminhash.q32k", 3000,
                         {"queries": 256, "sample_per_pass": 32,
                          "control": {"low_bits": low_bits}})
    verdict = cell.control()
    assert _fails(verdict, limits), verdict


def test_the_reference_judged_against_itself_passes():
    cell, limits = _cell("cluster.kminhash.resident", 4000,
                         {"control": {"key_bits": 32}})
    assert not _fails(cell.control(), limits)
    cell, limits = _cell("scan.cminhash.q32k", 3000,
                         {"queries": 256, "control": {"low_bits": 32}})
    assert not _fails(cell.control(), limits)

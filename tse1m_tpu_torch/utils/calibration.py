"""Read-only view of the machine calibration file.

A trimmed copy of ``tse1m_tpu/utils/calibration.py``: the file's location,
its schema check and its TTL, as the JAX package reads them.  The cluster
pipeline reads one entry, ``wire.quant_bits``: the degraded wire width an
earlier run's out-of-memory quant-drop persisted, which storeless runs
clamp to (``cluster/pipeline.py:_quant_bits``).  This package never writes
the file; the JAX package's degradation rungs do.

Location: ``TSE1M_ROUTER_CAL`` (empty = none), else the ``[FRAMEWORK]
router_cal_path`` key of the INI at ``TSE1M_ENVFILE`` or
``program/envFile.ini``.
"""

from __future__ import annotations

import configparser
import json
import os
import time

from ..config import ini_path

SCHEMA_VERSION = 2
_DEFAULT_TTL_S = 6 * 3600.0


def ttl_s() -> float:
    return float(os.environ.get("TSE1M_ROUTER_CAL_TTL_S", _DEFAULT_TTL_S))


def load_calibration(path: str | None) -> dict:
    """Fresh (schema-matching, within-TTL) calibration state:
    ``{"cost_per_row": {key: float}, "wire": {key: value}}``, with empty
    sections when the file is absent, unreadable, of another schema or
    entirely stale."""
    out: dict = {"cost_per_row": {}, "wire": {}}
    if not path or not os.path.exists(path):
        return out
    try:
        with open(path, encoding="utf-8") as f:
            saved = json.load(f)
    except (OSError, ValueError):
        return out
    if saved.get("schema_version") != SCHEMA_VERSION:
        return out
    horizon = time.time() - ttl_s()
    for section in ("cost_per_row", "wire"):
        for key, entry in (saved.get(section) or {}).items():
            if not isinstance(entry, dict) or "value" not in entry:
                continue
            if float(entry.get("ts", 0.0)) < horizon:
                continue
            out[section][key] = entry["value"]
    return out


def calibration_path() -> str | None:
    """The configured calibration file; None = none."""
    env = os.environ.get("TSE1M_ROUTER_CAL")
    if env is not None:
        return env or None
    ini = ini_path()
    if ini is None:
        return None
    parser = configparser.ConfigParser()
    try:
        parser.read(ini)
    except configparser.Error:
        # As in the JAX package: a broken INI means no calibration, not a
        # failed run.
        return None
    return parser.get("FRAMEWORK", "router_cal_path", fallback=None) or None


def degraded_quant_floor() -> int:
    """The persisted degraded wire width (0 = none)."""
    v = load_calibration(calibration_path())["wire"].get("quant_bits")
    return int(v) if v else 0


__all__ = ["SCHEMA_VERSION", "calibration_path", "degraded_quant_floor",
           "load_calibration", "ttl_s"]

"""The machine calibration file: a copy of ``tse1m_tpu/utils/calibration.py``.

One JSON file of measurements this machine made, which the next process
starts from.  The cluster pipeline's degradation ladder
(``cluster/ladder.py``) writes and reads its ``wire`` section:

- ``chunk_bytes``: the chunk size that survived out-of-memory halving, so
  the next run's stream plan starts below the ceiling
  (``pipeline._apply_calibrated_step``);
- ``quant_bits``: the wire width an out-of-memory quant drop left, which
  storeless runs clamp to until a clean run at that width clears it
  (``pipeline._quant_bits``, ``_restore_quant_bits``);
- ``h2d_MBps``: a measured link rate, seeding the stage watchdog's H2D
  budget (``pipeline._make_watchdog``).

The layout is the JAX package's (schema version 2, each entry a value and
its wall-clock ``ts``), so either package reads and writes the other's
file.  Entries older than ``TSE1M_ROUTER_CAL_TTL_S`` (6 h) are dropped at
load; a file of another schema is ignored whole.  Writes are
read-merge-write through ``atomic_write``; an entry kept from the file
keeps its timestamp, and ``None`` deletes one.

Location: ``TSE1M_ROUTER_CAL`` (empty = none), else the ``[FRAMEWORK]
router_cal_path`` key of the INI at ``TSE1M_ENVFILE`` or
``program/envFile.ini``.
"""

from __future__ import annotations

import configparser
import json
import logging
import os
import time

from ..config import ini_path
from .atomic import atomic_write

log = logging.getLogger("tse1m_tpu_torch.calibration")

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


def update_calibration(path: str | None, cost_per_row: dict | None = None,
                       wire: dict | None = None) -> None:
    """Merge new measurements into the file, each stamped with now; still
    fresh entries stay with their own timestamps (re-stamping them would
    defeat the TTL); a ``None`` value deletes its entry.  No-op without a
    path; a failed write is logged, never raised."""
    if not path:
        return
    current = load_calibration(path)
    now = time.time()
    payload = {"schema_version": SCHEMA_VERSION,
               "cost_per_row": {k: {"value": v, "ts": now}
                                for k, v in current["cost_per_row"].items()},
               "wire": {k: {"value": v, "ts": now}
                        for k, v in current["wire"].items()}}
    try:
        with open(path, encoding="utf-8") as f:
            prior = json.load(f)
        if prior.get("schema_version") == SCHEMA_VERSION:
            for section in ("cost_per_row", "wire"):
                for k, entry in (prior.get(section) or {}).items():
                    if k in payload[section] and isinstance(entry, dict) \
                            and "ts" in entry:
                        payload[section][k]["ts"] = entry["ts"]
    except (OSError, ValueError):
        pass
    for k, v in (cost_per_row or {}).items():
        if v is None:
            payload["cost_per_row"].pop(k, None)
        else:
            payload["cost_per_row"][k] = {"value": float(v), "ts": now}
    for k, v in (wire or {}).items():
        if v is None:
            payload["wire"].pop(k, None)
        else:
            payload["wire"][k] = {"value": v, "ts": now}
    try:
        with atomic_write(path) as f:
            json.dump(payload, f, indent=2)
    except OSError as e:
        log.warning("could not persist calibration to %s (%s)", path, e)


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


__all__ = ["SCHEMA_VERSION", "calibration_path", "load_calibration",
           "ttl_s", "update_calibration"]

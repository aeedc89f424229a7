"""The native host layer: C++ built with g++ at first use, a copy of the
JAX package's ``native`` loader and sources.

- :func:`fetch_table` (``decode.cc``): a sqlite query streamed into typed
  numpy columns in one C++ pass, the GIL released during the scan (the
  study extraction of ``data/columnar.py``).
- :func:`group_delta` (``encode.cc``): the grouping pass of the
  base-delta wire encoding (``cluster/encode.py``), ``rep_of`` equal to
  the numpy ``_group_rows``'s.
- :func:`parse_copy_binary` and :func:`fetch_table_pg` (``pg_decode.cc``):
  a Postgres ``COPY ... TO STDOUT (FORMAT binary)`` stream into the same
  columns.

Each library builds into ``build/tse1m_tpu_torch/native/`` under the
repository root, never beside its source: through a temp file renamed into
place, so a concurrent first caller never imports a half-written object,
and again whenever a source is newer than the library.  This is host
code, not a device kernel, and it is a throughput lever: when g++ or a
library is missing each function returns None and the caller takes its
numpy path, as the JAX package does.  :func:`loaded` says whether a
library came up, so a caller that must not fall back can check.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sysconfig
import tempfile
import threading

log = logging.getLogger("tse1m_tpu_torch.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "tse1m_tpu_torch", "native")

# Module name -> (source, -std flags to try in order, link flags, headers).
# C++20 first (string_view lookups in the scan's maps); g++ < 11 retries
# C++17, where columns.h compiles a std::string-temporary lookup.
_LIBS = {
    "_tse1m_torch_decode": ("decode.cc", ("-std=c++20", "-std=c++17"),
                            ("-l:libsqlite3.so.0",), ("columns.h",)),
    "_tse1m_torch_encode": ("encode.cc", ("-std=c++17",), (), ()),
    "_tse1m_torch_pgdecode": ("pg_decode.cc", ("-std=c++20", "-std=c++17"),
                              ("-l:libpq.so.5",), ("columns.h",)),
}

_lock = threading.Lock()
_modules: dict = {}


def _compile(name: str, so: str) -> bool:
    """g++ ``name``'s source into ``so`` through a temp file; False (and a
    warning naming every attempt's error) when no attempt builds."""
    import numpy as np

    src, stds, link_flags, _ = _LIBS[name]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        errors = []
        for std in stds:
            proc = subprocess.run(
                ["g++", "-O2", std, "-shared", "-fPIC",
                 "-I" + sysconfig.get_paths()["include"],
                 "-I" + np.get_include(), os.path.join(_DIR, src),
                 *link_flags, "-o", tmp],
                capture_output=True, text=True, timeout=300)
            if proc.returncode == 0:
                os.replace(tmp, so)
                return True
            lines = proc.stderr.strip().splitlines()
            errors.append(f"{std}: {lines[-1] if lines else proc.returncode}")
        log.warning("native %s build failed; using the numpy path: %s",
                    name, " | ".join(errors))
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(name: str):
    """The extension module ``name`` (built when absent or stale), or None
    when it cannot be built or imported.  Tried once per process."""
    with _lock:
        if name in _modules:
            return _modules[name]
        mod = None
        src, _, _, deps = _LIBS[name]
        so = os.path.join(BUILD_DIR, name + ".so")
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            newest = max(os.path.getmtime(os.path.join(_DIR, f))
                         for f in (src, *deps))
            fresh = os.path.exists(so) and os.path.getmtime(so) >= newest
            if fresh or _compile(name, so):
                spec = importlib.util.spec_from_file_location(name, so)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                log.info("native %s loaded (%s)", name, so)
        except (OSError, ImportError, subprocess.SubprocessError) as e:
            log.warning("native %s unavailable (%s); using the numpy path",
                        name, e)
            mod = None
        _modules[name] = mod
        return mod


def loaded(which: str) -> bool:
    """Whether the ``decode``, ``encode`` or ``pgdecode`` library loads
    (building it first when needed)."""
    return _load(f"_tse1m_torch_{which}") is not None


def fetch_table(db_path: str, sql: str, params, spec: str, key_values):
    """Run ``sql`` against the sqlite file ``db_path`` and decode its
    columns per ``spec`` (one character a column, see decode.cc: p t f s c
    u b o).  A tuple of numpy arrays, or None without the library; raises
    RuntimeError on data the strict parsers reject, such as a timestamp
    with a timezone suffix (the caller then takes the numpy path)."""
    mod = _load("_tse1m_torch_decode")
    if mod is None:
        return None
    return mod.fetch_table(db_path, sql, tuple(params), spec,
                           list(key_values))


def group_delta(items, max_diffs: int, n_probes: int):
    """rep_of [N] int64 of the base-delta grouping over [N, S] uint32
    rows (-1 = full lane), or None without the library."""
    mod = _load("_tse1m_torch_encode")
    if mod is None:
        return None
    return mod.group_delta(items, int(max_diffs), int(n_probes))


def parse_copy_binary(data: bytes, spec: str, key_values):
    """Decode a Postgres COPY-binary stream per ``spec``, or None without
    the library; RuntimeError on a malformed stream."""
    mod = _load("_tse1m_torch_pgdecode")
    if mod is None:
        return None
    return mod.parse_copy_binary(data, spec, list(key_values))


def fetch_table_pg(conninfo: str, copy_sql: str, spec: str, key_values):
    """Run ``copy_sql`` (``COPY ... TO STDOUT (FORMAT binary)``) against
    the server ``conninfo`` names and decode per ``spec``: a tuple of
    numpy arrays, or None without the library; RuntimeError on a stream
    the strict parsers reject."""
    mod = _load("_tse1m_torch_pgdecode")
    if mod is None:
        return None
    return mod.fetch_table_pg(conninfo, copy_sql, spec, list(key_values))


__all__ = ["BUILD_DIR", "fetch_table", "fetch_table_pg", "group_delta",
           "loaded", "parse_copy_binary"]

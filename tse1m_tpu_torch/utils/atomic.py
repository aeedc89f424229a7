"""Atomic file writes: a copy of ``tse1m_tpu/utils/atomic.py``.

    with atomic_write(path, newline="") as f:
        csv.writer(f).writerows(rows)

The file is written to a temp file beside ``path`` (named for the
process and thread, so two writers of one path never share it) and
renamed over ``path`` only when the block exits cleanly; on an exception
the temp file is removed and the previous ``path`` (if any) is untouched.
"""

from __future__ import annotations

import contextlib
import os
import threading


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w", encoding: str | None = "utf-8",
                 newline: str | None = None):
    """Open a temp file beside ``path`` for writing; rename onto ``path``
    on clean exit, delete the temp file on failure.  Text modes default to
    UTF-8; binary modes ("wb") pass encoding/newline through as None."""
    if "b" in mode:
        encoding = newline = None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    f = open(tmp, mode, encoding=encoding, newline=newline)
    try:
        yield f
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
    else:
        f.close()
        os.replace(tmp, path)


__all__ = ["atomic_write"]

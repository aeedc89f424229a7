"""SQL identifier validation/quoting, a copy of ``tse1m_tpu/db/ident.py``:
the single seat for interpolating a table or column NAME into SQL text.

Values are always bound as parameters (db/connection.py qmark style);
identifiers can't be bound, so everywhere the schema is dynamic (the
ingest upsert builder, the dump restorer's COPY header, the CLI's table
inventory) previously interpolated raw strings.  Those came from our own
CSVs/dumps today, but a hostile dump header like
``COPY t ("name); DROP TABLE issues; --") FROM stdin`` would have walked
straight into an f-string.
"""

from __future__ import annotations

import re
from typing import Sequence

# Conservative unquoted-identifier grammar, valid on sqlite AND Postgres:
# leading letter/underscore, then word chars, within Postgres's NAMEDATALEN
# limit.  Anything outside it is rejected rather than quoted-through —
# every identifier this codebase generates is schema-controlled, so an
# exotic name is an attack or a bug, not a use case.
_IDENT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_MAX_LEN = 63


class InvalidIdentifier(ValueError):
    """An identifier failed validation (injection attempt or schema bug)."""


def validate_ident(name: str) -> str:
    """Return ``name`` unchanged iff it is a safe bare SQL identifier."""
    if not isinstance(name, str) or not name or len(name) > _MAX_LEN \
            or not _IDENT_RE.match(name):
        raise InvalidIdentifier(f"unsafe SQL identifier: {name!r}")
    return name


def quote_ident(name: str) -> str:
    """Validate and return the identifier ready for interpolation.

    Validation already restricts to the bare-identifier grammar, so no
    quoting characters are ever needed — returning the bare name keeps
    generated SQL byte-identical to the pre-ident.py output (golden
    artifacts, dump round-trips)."""
    return validate_ident(name)


def col_list(names: Sequence[str]) -> str:
    """``"a, b, c"`` with every element validated — the column-list form
    the upsert/restore builders interpolate."""
    return ", ".join(validate_ident(n) for n in names)


__all__ = ["InvalidIdentifier", "col_list", "quote_ident", "validate_ident"]

"""The committed spec mutations — the checker's own test corpus.

Each mutant is a deliberate single-decision reordering of one protocol
spec, reproducing a bug class the chaos tests guard dynamically; the
``spec mutants`` self-test (and ``all``'s graftspec step) requires the
model checker to produce a violation WITH a replayable counterexample
for every one of them, proving the specs + checker actually encode the
design decisions they claim to:

- ``ack-before-journal``  (ingest_ack): the shard answers before the
  journal entry is durable — a dropped ack's retry double-absorbs.
- ``fence-after-append``  (lease): the commit appends before checking
  the lease epoch — a zombie writes with a stale view.
- ``manifest-first``      (replica): the manifest streams before the
  files it references — a crash freezes a torn view.
"""

from __future__ import annotations

from . import ingest_ack, lease, replica

MUTANT_BUILDERS = {
    "ack-before-journal":
        lambda: ingest_ack.build(mutant="ack-before-journal"),
    "fence-after-append":
        lambda: lease.build(mutant="fence-after-append"),
    "manifest-first":
        lambda: replica.build(mutant="manifest-first"),
}

__all__ = ["MUTANT_BUILDERS"]

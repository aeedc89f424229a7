"""The serve plane's verb alphabets, as the specs know them.

These tuples are the spec-side source of truth the
``verb-dispatch-drift`` lint pass holds the code to: the server
dispatch table (``ServeServer._dispatch_op``), the router dispatch
table (``RouterServer._dispatch_op``), the client method set
(``ServeClient``'s ``self.request(<verb>, ...)`` calls) and the
router's shard-forwarding set (``LocalTransport.__call__``) must each
agree EXACTLY with their alphabet here — a verb added to any one
surface without the others (and without the spec) fails lint.

Sorted tuples, string literals only: the lint graph reads them as
module constants, so no computed values.
"""

from __future__ import annotations

# Every verb the single-daemon front end answers (and the client can
# issue — the two surfaces are intentionally identical).
SERVER_VERBS = ("ingest", "metrics", "ping", "profile", "query",
                "quiesce", "shutdown", "slowlog", "status", "topk",
                "trace")

CLIENT_VERBS = ("ingest", "metrics", "ping", "profile", "query",
                "quiesce", "shutdown", "slowlog", "status", "topk",
                "trace")

# The router front end: no slowlog/profile (those are per-daemon
# diagnostics; the router aggregates metrics/trace instead).
ROUTER_VERBS = ("ingest", "metrics", "ping", "query", "quiesce",
                "shutdown", "status", "topk", "trace")

# What the router forwards to shard daemons in-process.
FORWARD_VERBS = ("ingest", "ping", "query", "quiesce", "status",
                 "topk")

__all__ = ["CLIENT_VERBS", "FORWARD_VERBS", "ROUTER_VERBS",
           "SERVER_VERBS"]

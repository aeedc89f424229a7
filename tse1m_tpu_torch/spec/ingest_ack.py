"""Protocol spec: durable-once ingest acks through the router
(serve/router.py fan-out + serve/daemon.py journal replay).

The model: ``n_rids`` client requests, each fanned out by the router
to ``n_shards`` shard daemons under the per-shard request id.  A shard
commit journals the rid at the durability seat
(``fault_point("serve.ingest.commit")``) and answers; the answer can
die in the lost-ack window (``fault_point("serve.router.forward")``),
a shard can crash with requests in flight (journal survives, channel
does not), and the router retries the SAME rid — a retry of a
journaled rid is answered by **replay** (ack from the journal, no
second absorb).

Bounded scope (defaults): 2 shards x 1 in-flight rid, 1 dropped ack,
1 crash, 3 sends per channel (sends >= drops + crashes + 1, so the
adversary cannot exhaust retries).  Shards are symmetric: the checker
quotients over shard-id permutations.

Safety: a row batch is absorbed at most ONCE per shard however many
retries race the journal (durable-once), and every ack — shard-level
or client-level — is backed by a journal entry.  Liveness: every
client request is eventually acked.

The committed mutation ``ack-before-journal`` answers the client
before the journal write survives: the dropped ack's retry finds no
journal entry and absorbs AGAIN — the checker produces the minimal
double-absorb schedule.
"""

from __future__ import annotations

from .dsl import Action, Invariant, Liveness, Spec, tupset, upd

SPEC_NAME = "ingest_ack"

MUTANTS = ("ack-before-journal",)

_ABSORB_SAT = 2  # saturating absorb counter: 2 already violates


def _ch(s: dict, var: str, r: int, sh: int):
    return s[var][r][sh]


def _chset(s: dict, var: str, r: int, sh: int, value) -> dict:
    return upd(s, **{var: tupset(s[var], r,
                                 tupset(s[var][r], sh, value))})


def _send(r: int, sh: int):
    def guard(s):
        return (s["client"][r] == "waiting"
                and not _ch(s, "done", r, sh)
                and not _ch(s, "msg", r, sh)
                and not _ch(s, "ack", r, sh)
                and _ch(s, "sends", r, sh) < s["max_sends"])

    def effect(s):
        s = _chset(s, "msg", r, sh, True)
        return _chset(s, "sends", r, sh, _ch(s, "sends", r, sh) + 1)
    return guard, effect


def _commit(r: int, sh: int, mutant: str | None):
    def guard(s):
        return _ch(s, "msg", r, sh) and not _ch(s, "journal", r, sh)

    def effect(s):
        s = _chset(s, "absorbed", r, sh,
                   min(_ch(s, "absorbed", r, sh) + 1, _ABSORB_SAT))
        if mutant != "ack-before-journal":
            s = _chset(s, "journal", r, sh, True)
        # BUG under test (mutant): the ack leaves without the journal
        # entry, so a retried rid cannot be recognized as a replay.
        s = _chset(s, "msg", r, sh, False)
        return _chset(s, "ack", r, sh, True)
    return guard, effect


def _replay(r: int, sh: int):
    def guard(s):
        return _ch(s, "msg", r, sh) and _ch(s, "journal", r, sh)

    def effect(s):
        s = _chset(s, "msg", r, sh, False)
        return _chset(s, "ack", r, sh, True)
    return guard, effect


def _drop(r: int, sh: int):
    def guard(s):
        return _ch(s, "ack", r, sh) and s["drops"] < s["max_drops"]

    def effect(s):
        s = _chset(s, "ack", r, sh, False)
        return upd(s, drops=s["drops"] + 1)
    return guard, effect


def _collect(r: int, sh: int):
    def guard(s):
        return _ch(s, "ack", r, sh)

    def effect(s):
        s = _chset(s, "ack", r, sh, False)
        return _chset(s, "done", r, sh, True)
    return guard, effect


def _crash(sh: int, n_rids: int):
    def guard(s):
        return (s["crashes"] < s["max_crashes"]
                and any(_ch(s, "msg", r, sh) for r in range(n_rids)))

    def effect(s):
        for r in range(n_rids):
            s = _chset(s, "msg", r, sh, False)
        return upd(s, crashes=s["crashes"] + 1)
    return guard, effect


def _client_ack(r: int, n_shards: int):
    def guard(s):
        return (s["client"][r] == "waiting"
                and all(_ch(s, "done", r, sh)
                        for sh in range(n_shards)))

    def effect(s):
        return upd(s, client=tupset(s["client"], r, "acked"))
    return guard, effect


def build(n_shards: int = 2, n_rids: int = 1, max_drops: int = 1,
          max_crashes: int = 1, max_sends: int = 3,
          mutant: str | None = None) -> Spec:
    if mutant is not None and mutant not in MUTANTS:
        raise ValueError(f"unknown ingest_ack mutant {mutant!r}")
    zeros = tuple((0,) * n_shards for _ in range(n_rids))
    falses = tuple((False,) * n_shards for _ in range(n_rids))
    init = {"client": ("waiting",) * n_rids,
            "msg": falses, "ack": falses, "done": falses,
            "journal": falses, "absorbed": zeros, "sends": zeros,
            "drops": 0, "crashes": 0,
            "max_drops": max_drops, "max_crashes": max_crashes,
            "max_sends": max_sends}
    actions = []
    for r in range(n_rids):
        for sh in range(n_shards):
            g, e = _send(r, sh)
            actions.append(Action(f"send_r{r}s{sh}", g, e,
                                  seat="verb:ingest", fair=True))
            g, e = _commit(r, sh, mutant)
            actions.append(Action(
                f"commit_r{r}s{sh}", g, e,
                seat="fault:serve.ingest.commit", fair=True))
            g, e = _replay(r, sh)
            actions.append(Action(f"replay_r{r}s{sh}", g, e,
                                  seat="verb:ingest", fair=True))
            g, e = _drop(r, sh)
            actions.append(Action(
                f"drop_r{r}s{sh}", g, e,
                seat="fault:serve.router.forward"))
            g, e = _collect(r, sh)
            actions.append(Action(f"collect_r{r}s{sh}", g, e,
                                  seat="call:_forward", fair=True))
        g, e = _client_ack(r, n_shards)
        actions.append(Action(f"client_ack_r{r}", g, e,
                              seat="verb:ingest", fair=True))
    for sh in range(n_shards):
        g, e = _crash(sh, n_rids)
        actions.append(Action(f"crash_s{sh}", g, e, seat="model:crash"))

    def _durable_once(s):
        return all(_ch(s, "absorbed", r, sh) <= 1
                   for r in range(n_rids) for sh in range(n_shards))

    def _ack_implies_journal(s):
        return all((not _ch(s, "ack", r, sh)
                    and not _ch(s, "done", r, sh))
                   or _ch(s, "journal", r, sh)
                   for r in range(n_rids) for sh in range(n_shards))

    def _acked_implies_durable(s):
        return all(s["client"][r] != "acked"
                   or all(_ch(s, "journal", r, sh)
                          for sh in range(n_shards))
                   for r in range(n_rids))

    def _all_acked(s):
        return all(c == "acked" for c in s["client"])

    def _symmetry(s, perm):
        out = dict(s)
        for var in ("msg", "ack", "done", "journal", "absorbed",
                    "sends"):
            out[var] = tuple(tuple(row[perm[i]]
                                   for i in range(n_shards))
                             for row in s[var])
        return out

    invariants = (Invariant("durable-once", _durable_once),)
    if mutant != "ack-before-journal":
        # The mutant acks before journaling BY DESIGN, so these two
        # would fire trivially at the first commit; dropping them makes
        # the checker exhibit the consequential bug — the retried rid
        # double-absorbs (durable-once) — as the counterexample.
        invariants += (
            Invariant("ack-implies-journal", _ack_implies_journal),
            Invariant("acked-implies-durable", _acked_implies_durable),
        )

    return Spec(
        name="ingest_ack" if mutant is None
        else f"ingest_ack[{mutant}]",
        init=init,
        actions=tuple(actions),
        invariants=invariants,
        liveness=(Liveness("every-request-acked", _all_acked),),
        symmetry=_symmetry,
        n_symmetric=n_shards,
        scope={"n_shards": n_shards, "n_rids": n_rids,
               "max_drops": max_drops, "max_crashes": max_crashes,
               "max_sends": max_sends},
    )


__all__ = ["MUTANTS", "SPEC_NAME", "build"]

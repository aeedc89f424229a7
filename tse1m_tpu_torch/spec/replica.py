"""Protocol spec: read-replica streaming with manifest-last commit and
generation adoption (serve/replicate.py).

The model: a writer advances its committed generation; a puller
streams the writer's tree to the replica in the code's fixed order —
CRC-framed shard files, then the cluster state, then the manifest
LAST (the atomicity point, ``fault_point("serve.replica.stream")``
sits just before it).  A crash mid-stream leaves whatever files were
copied (a torn mix of generations) but never a manifest pointing past
them; the replica adopts a view only when the manifest's generation
advances (``refresh``).

Bounded scope (defaults): 2 writer generations, 1 mid-stream crash.
A few dozen states.

Safety: the manifest never references a generation the copied files
do not fully have, and the replica never adopts past the manifest —
so a reader can never observe a torn view.  Liveness (weak fairness
on the pull/adopt steps): the replica converges to the writer's final
generation.

The committed mutation ``manifest-first`` streams the manifest before
the file copies: the checker immediately exhibits the torn window
(manifest ahead of the state file) a crash would freeze forever.
"""

from __future__ import annotations

from .dsl import Action, Invariant, Liveness, Spec, upd

SPEC_NAME = "replica"

MUTANTS = ("manifest-first",)


def build(max_gen: int = 2, max_crashes: int = 1,
          mutant: str | None = None) -> Spec:
    if mutant is not None and mutant not in MUTANTS:
        raise ValueError(f"unknown replica mutant {mutant!r}")
    init = {"writer_gen": 0, "shards_gen": 0, "state_gen": 0,
            "manifest_gen": 0, "adopted": 0, "pull": "idle",
            "crashes": 0, "max_gen": max_gen,
            "max_crashes": max_crashes}

    def writer_commit(s):
        return upd(s, writer_gen=s["writer_gen"] + 1)

    def pull_shards(s):
        out = upd(s, shards_gen=s["writer_gen"], pull="shards")
        if mutant == "manifest-first":
            # BUG under test: the manifest is streamed before the
            # files it references are copied.
            out = upd(out, manifest_gen=s["writer_gen"])
        return out

    def pull_state(s):
        return upd(s, state_gen=s["shards_gen"], pull="state")

    def pull_manifest(s):
        out = upd(s, pull="idle")
        if mutant != "manifest-first":
            out = upd(out, manifest_gen=s["shards_gen"])
        return out

    def crash_pull(s):
        return upd(s, pull="idle", crashes=s["crashes"] + 1)

    def adopt(s):
        return upd(s, adopted=s["manifest_gen"])

    actions = (
        Action("writer_commit",
               lambda s: s["writer_gen"] < s["max_gen"],
               writer_commit, seat="verb:ingest"),
        Action("pull_shards",
               lambda s: s["pull"] == "idle"
               and s["manifest_gen"] < s["writer_gen"],
               pull_shards, seat="call:stream_shards", fair=True),
        Action("pull_state",
               lambda s: s["pull"] == "shards",
               pull_state, seat="call:stream_shards", fair=True),
        Action("pull_manifest",
               lambda s: s["pull"] == "state",
               pull_manifest, seat="fault:serve.replica.stream",
               fair=True),
        Action("crash_pull",
               lambda s: s["pull"] != "idle"
               and s["crashes"] < s["max_crashes"],
               crash_pull, seat="model:crash"),
        Action("adopt",
               lambda s: s["manifest_gen"] > s["adopted"],
               adopt, seat="call:refresh", fair=True),
    )

    def _manifest_within_files(s):
        return (s["manifest_gen"] <= s["shards_gen"]
                and s["manifest_gen"] <= s["state_gen"])

    def _adopted_within_manifest(s):
        return s["adopted"] <= s["manifest_gen"]

    def _converged(s):
        return s["adopted"] == s["writer_gen"]

    return Spec(
        name="replica" if mutant is None else f"replica[{mutant}]",
        init=init,
        actions=actions,
        invariants=(
            Invariant("manifest-within-files", _manifest_within_files),
            Invariant("adopted-within-manifest",
                      _adopted_within_manifest),
        ),
        liveness=(Liveness("replica-converges", _converged),),
        scope={"max_gen": max_gen, "max_crashes": max_crashes},
    )


__all__ = ["MUTANTS", "SPEC_NAME", "build"]

"""Warm-path label merge for the signature store (host numpy): a copy of
``tse1m_tpu/cluster/incremental.py``.

A continuous-fuzzing re-run is the previous run's rows plus a short
appended tail.  The banded-LSH edge structure makes that tail cheap to
absorb EXACTLY:

- Bucket hubs are elected by *minimum original index*
  (`lsh.bucket_representatives`), and appended rows only ever have
  larger indices — so adding rows never changes the hub of any bucket
  that already had members.  Every old row's verified edge set is
  therefore untouched, and the old labels (each the min index of its
  component) summarise them losslessly.
- A new row's hub per band is either the stored bucket table's rep (the
  band key already existed) or the minimum-index *new* row sharing the
  key (the key is novel).  Verifying those candidate edges with the
  exact signature-agreement rule the device uses, then running a host
  union-find over {old component labels} ∪ {new row indices} with
  union-by-min, reproduces the cold batch run's label vector
  elementwise — including the case where one new row bridges two
  previously separate old components.

So a ≤1%-novel warm run never rebuilds full band tables: it probes the
stored per-band (key -> rep) tables, unions, and appends only the novel
keys.  All arrays here are host numpy; `cluster/pipeline.py` owns every
device transfer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

# LSM delta layer for the live band tables: past this many delta runs
# an absorb consolidates them into the base arrays.  Mirrors the store's
# probe-index delta layer (store._ProbeIndex): with runs, an absorb
# touches O(batch log batch) per band instead of an O(Kb) sorted insert
# into every band's full table, and the rare consolidation pays the big
# memcpy.
_DELTA_RUNS_DEFAULT = 8


def _delta_max_runs() -> int:
    try:
        return max(1, int(os.environ.get("TSE1M_LIVE_DELTA_RUNS",
                                         _DELTA_RUNS_DEFAULT)))
    except ValueError:
        return _DELTA_RUNS_DEFAULT


@dataclass
class LshState:
    """The last completed run's LSH state, as persisted by
    `store.SignatureStore.save_state`."""

    n_rows: int
    labels: np.ndarray              # [n_rows] int32 min-orig-index labels
    locator: np.ndarray             # [n_rows, 2] int32 (shard, row) in store
    band_keys_sorted: list          # per band: [Kb] uint32 distinct keys
    band_reps: list                 # per band: [Kb] int32 min index per key
    prefix_digest: str              # digests_fingerprint of the run's rows

    def matches_prefix(self, digests: np.ndarray) -> bool:
        """True when this state's rows are exactly the first n_rows of
        the current input (the accretion pattern the merge requires)."""
        from .store import digests_fingerprint

        if digests.shape[0] < self.n_rows:
            return False
        return (digests_fingerprint(digests[:self.n_rows])
                == self.prefix_digest)


def build_band_tables(keys: np.ndarray) -> tuple[list, list]:
    """[N, B] uint32 band keys (original row order) -> per-band sorted
    distinct keys + the min row index holding each ([Kb] uint32,
    [Kb] int32)."""
    n, n_bands = keys.shape
    ks_list, rep_list = [], []
    for b in range(n_bands):
        order = np.argsort(keys[:, b], kind="stable")
        ks = keys[order, b]
        first = np.empty(n, bool)
        if n:
            first[0] = True
            np.not_equal(ks[1:], ks[:-1], out=first[1:])
        ks_list.append(np.ascontiguousarray(ks[first]))
        rep_list.append(order[first].astype(np.int32))
    return ks_list, rep_list


def extend_band_tables(band_keys_sorted: list, band_reps: list,
                       new_keys: np.ndarray, base_index: int
                       ) -> tuple[list, list]:
    """Append the new rows' novel band keys (rep = min new row's global
    index, ``base_index`` + row position).  Existing keys keep their
    reps — new rows have larger indices by construction."""
    ks_out, rep_out = [], []
    k = new_keys.shape[0]
    for b, (ks, reps) in enumerate(zip(band_keys_sorted, band_reps)):
        kb = new_keys[:, b]
        pos = np.searchsorted(ks, kb)
        inb = pos < ks.shape[0]
        hit = np.zeros(k, bool)
        hit[inb] = ks[pos[inb]] == kb[inb]
        rest = np.flatnonzero(~hit)
        if rest.size == 0:
            ks_out.append(ks)
            rep_out.append(reps)
            continue
        order = rest[np.argsort(kb[rest], kind="stable")]
        ks2 = kb[order]
        first = np.empty(order.size, bool)
        first[0] = True
        np.not_equal(ks2[1:], ks2[:-1], out=first[1:])
        add_k = ks2[first]
        add_r = (order[first] + base_index).astype(np.int32)
        # Sorted-insert merge (both sides sorted, no ties — novel keys
        # are by construction absent from ks): O(Kb) memcpy instead of a
        # full re-sort, which matters when this runs once per serving
        # ingest batch rather than once per warm run.
        ins = np.searchsorted(ks, add_k)
        ks_out.append(np.insert(ks, ins, add_k))
        rep_out.append(np.insert(reps, ins, add_r))
    return ks_out, rep_out


def candidate_edges(band_keys_sorted: list, band_reps: list,
                    new_keys: np.ndarray, base_index: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Unverified candidate edges (u, v) for the appended rows, in global
    original indices — exactly the edges the cold run would add: per
    band, each new row points at its bucket hub (stored rep for an
    existing key, min-index new row for a novel key).  Self-edges are
    dropped, like the device verifier's caller does."""
    k, n_bands = new_keys.shape
    idx = np.arange(k, dtype=np.int64) + base_index
    us, vs = [], []
    for b in range(n_bands):
        kb = new_keys[:, b]
        ks, reps = band_keys_sorted[b], band_reps[b]
        pos = np.searchsorted(ks, kb)
        inb = pos < ks.shape[0]
        hit = np.zeros(k, bool)
        hit[inb] = ks[pos[inb]] == kb[inb]
        if hit.any():
            us.append(idx[hit])
            vs.append(reps[pos[hit]].astype(np.int64))
        rest = np.flatnonzero(~hit)
        if rest.size:
            order = rest[np.argsort(kb[rest], kind="stable")]
            ks2 = kb[order]
            first = np.empty(order.size, bool)
            first[0] = True
            np.not_equal(ks2[1:], ks2[:-1], out=first[1:])
            grp = np.cumsum(first) - 1
            us.append(idx[order])
            vs.append(idx[order[np.flatnonzero(first)][grp]])
    if not us:
        e = np.empty(0, np.int64)
        return e, e.copy()
    u = np.concatenate(us)
    v = np.concatenate(vs)
    keep = u != v
    return u[keep], v[keep]


def verify_edges(u: np.ndarray, v: np.ndarray, new_sigs: np.ndarray,
                 base_index: int, gather_old_sigs, n_hashes: int,
                 threshold: float) -> np.ndarray:
    """The device verifier's exact rule on host: accept an edge iff the
    fraction of agreeing MinHash rows (float32, like
    `lsh.estimated_jaccard`) reaches ``threshold``.  ``gather_old_sigs``
    maps unique old row indices to their stored [*, H] signatures."""
    if u.size == 0:
        return np.zeros(0, bool)
    sig_u = new_sigs[u - base_index]
    sig_v = np.empty_like(sig_u)
    old = v < base_index
    if old.any():
        uniq, inv = np.unique(v[old], return_inverse=True)
        sig_v[old] = gather_old_sigs(uniq)[inv]
    new = ~old
    if new.any():
        sig_v[new] = new_sigs[v[new] - base_index]
    agree = (sig_u == sig_v).sum(axis=1)
    est = agree.astype(np.float32) / np.float32(n_hashes)
    return est >= np.float32(threshold)


def merge_labels(old_labels: np.ndarray, u: np.ndarray, v: np.ndarray,
                 n_old: int, n_new: int) -> np.ndarray:
    """Union the verified new edges into the old labeling; returns
    [n_old + n_new] int32 labels equal elementwise to a cold batch run
    over the union.

    Nodes are old component labels (< n_old, each already the min index
    of its component) and new row indices (>= n_old); union-by-min keeps
    every root the minimum original index of its merged component, so a
    new row that bridges two old components relabels both to the smaller
    component's label — exactly what min-label propagation converges to.
    """
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        root = x
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(x, x) != root:
            parent[x], x = root, parent[x]
        return root

    for u_, v_ in zip(u.tolist(), v.tolist()):
        cu = find(u_)
        cv = find(int(old_labels[v_]) if v_ < n_old else v_)
        if cu == cv:
            continue
        if cu > cv:
            cu, cv = cv, cu
        parent[cv] = cu
        parent.setdefault(cu, cu)

    new_lab = np.arange(n_old, n_old + n_new, dtype=np.int64)
    for i in range(n_new):
        j = n_old + i
        if j in parent:
            new_lab[i] = find(j)
    out_old = old_labels.astype(np.int64, copy=True)
    remap = {lab: r for lab in parent if lab < n_old
             for r in (find(lab),) if r != lab}
    if remap:
        lk = np.fromiter(remap.keys(), np.int64, len(remap))
        lv = np.fromiter(remap.values(), np.int64, len(remap))
        order = np.argsort(lk)
        lk, lv = lk[order], lv[order]
        pos = np.searchsorted(lk, out_old)
        inb = pos < lk.size
        match = np.zeros(n_old, bool)
        match[inb] = lk[pos[inb]] == out_old[inb]
        out_old[match] = lv[pos[match]]
    return np.concatenate([out_old, new_lab]).astype(np.int32)


# ---------------------------------------------------------------------------
# Live index: the serving-plane view of the same extend-never-rebuild
# machinery.  A LiveClusterIndex is an IMMUTABLE snapshot of one ingest
# generation — labels, band tables, store locator, and (optionally) a
# sorted digest -> row map for membership lookups.  `absorb` returns a
# NEW snapshot sharing every unchanged array with its parent (the band
# tables are copy-on-extend already), so a serving daemon can swap the
# snapshot reference atomically per ingest batch and concurrent queries
# never observe a half-updated table.  The batch warm path
# (cluster/pipeline._store_warm_merge) is a client of this same object:
# one merge implementation serving both shapes.


@dataclass(frozen=True)
class LiveClusterIndex:
    """One ingest generation of the online cluster-membership index."""

    # graftlint snapshot-publish: published snapshots are never mutated —
    # frozen blocks attribute stores at runtime; the static pass also
    # proves no in-place array op (labels[i] = ..., band list .append)
    # ever targets a published instance.  (The marker is redundant with
    # frozen=True but keeps the discipline grep-able.)
    __immutable_after_publish__ = True

    generation: int
    n_rows: int
    labels: np.ndarray              # [n_rows] int32 min-orig-index labels
    locator: np.ndarray             # [n_rows, 2] int32 (shard, row) in store
    band_keys_sorted: list          # BASE per band: [Kb] uint32 distinct keys
    band_reps: list                 # BASE per band: [Kb] int32 min index
    # Sorted 128-bit digest map (membership lookups).  Optional: the
    # batch warm path never queries by digest and skips building it.
    digest_keys: np.ndarray | None = field(default=None, repr=False)
    digest_rows: np.ndarray | None = field(default=None, repr=False)
    # LSM delta runs over the band tables: each run is one absorbed
    # generation's novel keys, (ks_per_band, reps_per_band) with every
    # per-band array sorted; keys are distinct ACROSS runs and the base
    # (a key is added only when no earlier source holds it).  Probes
    # search base + runs; absorb appends a run instead of re-writing
    # the base arrays, and consolidates past _delta_max_runs().
    band_deltas: tuple = field(default=(), repr=False)

    # -- constructors --------------------------------------------------------

    @classmethod
    def empty(cls, n_bands: int) -> "LiveClusterIndex":
        e32 = np.empty(0, np.uint32)
        return cls(generation=0, n_rows=0,
                   labels=np.empty(0, np.int32),
                   locator=np.empty((0, 2), np.int32),
                   band_keys_sorted=[e32.copy() for _ in range(n_bands)],
                   band_reps=[np.empty(0, np.int32) for _ in range(n_bands)],
                   digest_keys=_empty_digest_struct(),
                   digest_rows=np.empty(0, np.int32))

    @classmethod
    def from_state(cls, state: LshState,
                   digests: np.ndarray | None = None) -> "LiveClusterIndex":
        """Adopt a persisted LSH state (store.SignatureStore.load_state)
        as generation 0.  ``digests`` ([n_rows, 2] uint64, row order)
        enables the digest-membership map; None skips it (batch path)."""
        dk = dr = None
        if digests is not None:
            dk, dr = _sorted_digest_map(digests)
        return cls(generation=0, n_rows=state.n_rows,
                   labels=state.labels.astype(np.int32, copy=True),
                   locator=state.locator, digest_keys=dk, digest_rows=dr,
                   band_keys_sorted=list(state.band_keys_sorted),
                   band_reps=list(state.band_reps))

    # -- band-table probing (base + LSM delta runs) --------------------------

    def _band_sources(self, b: int):
        yield self.band_keys_sorted[b], self.band_reps[b]
        for run_ks, run_reps in self.band_deltas:
            yield run_ks[b], run_reps[b]

    def _probe_band(self, b: int, kb: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """(hit [K] bool, rep [K] int32): binary-search the base table,
        then each delta run — a key lives in exactly one source."""
        k = kb.shape[0]
        hit = np.zeros(k, bool)
        rep = np.zeros(k, np.int32)
        for ks, reps in self._band_sources(b):
            if ks.shape[0] == 0:
                continue
            todo = np.flatnonzero(~hit)
            if todo.size == 0:
                break
            q = kb[todo]
            pos = np.searchsorted(ks, q)
            inb = pos < ks.shape[0]
            m = np.zeros(todo.size, bool)
            m[inb] = ks[pos[inb]] == q[inb]
            if m.any():
                sel = todo[m]
                hit[sel] = True
                rep[sel] = reps[pos[m]]
        return hit, rep

    def _probe_new_keys(self, new_keys: np.ndarray, base_index: int):
        """One pass per band over an appended batch: the candidate edge
        list (exactly candidate_edges' semantics, against base+deltas)
        AND the batch's novel-key delta run."""
        k, n_bands = new_keys.shape
        idx = np.arange(k, dtype=np.int64) + base_index
        us, vs = [], []
        run_ks, run_reps = [], []
        for b in range(n_bands):
            kb = new_keys[:, b]
            hit, rep = self._probe_band(b, kb)
            if hit.any():
                us.append(idx[hit])
                vs.append(rep[hit].astype(np.int64))
            rest = np.flatnonzero(~hit)
            if rest.size:
                order = rest[np.argsort(kb[rest], kind="stable")]
                ks2 = kb[order]
                first = np.empty(order.size, bool)
                first[0] = True
                np.not_equal(ks2[1:], ks2[:-1], out=first[1:])
                grp = np.cumsum(first) - 1
                us.append(idx[order])
                vs.append(idx[order[np.flatnonzero(first)][grp]])
                run_ks.append(np.ascontiguousarray(ks2[first]))
                run_reps.append((order[np.flatnonzero(first)]
                                 + base_index).astype(np.int32))
            else:
                run_ks.append(np.empty(0, np.uint32))
                run_reps.append(np.empty(0, np.int32))
        if not us:
            e = np.empty(0, np.int64)
            u, v = e, e.copy()
        else:
            u = np.concatenate(us)
            v = np.concatenate(vs)
            keep = u != v
            u, v = u[keep], v[keep]
        return u, v, run_ks, run_reps

    def band_tables(self) -> tuple[list, list]:
        """Fully consolidated (band_keys_sorted, band_reps) — what the
        persistence layer commits (store.save_state's format predates
        the delta runs and stays one sorted array per band).  Pure; the
        snapshot keeps its runs."""
        if not self.band_deltas:
            return list(self.band_keys_sorted), list(self.band_reps)
        return self._consolidated()

    def _consolidated(self) -> tuple[list, list]:
        bk, br = [], []
        for b in range(len(self.band_keys_sorted)):
            parts = list(self._band_sources(b))
            ks = np.concatenate([p[0] for p in parts])
            reps = np.concatenate([p[1] for p in parts])
            order = np.argsort(ks, kind="stable")
            bk.append(np.ascontiguousarray(ks[order]))
            br.append(np.ascontiguousarray(reps[order]))
        return bk, br

    # -- ingest --------------------------------------------------------------

    def absorb(self, new_keys: np.ndarray, new_sigs: np.ndarray,
               gather_old_sigs, n_hashes: int, threshold: float,
               new_locator: np.ndarray | None = None,
               new_digests: np.ndarray | None = None
               ) -> "LiveClusterIndex":
        """Absorb an appended tail of rows into a NEW snapshot.

        Exactly the batch warm merge: candidate edges from the stored
        band tables, verified with the device's signature-agreement
        rule, merged with union-by-min — labels elementwise-equal to a
        cold batch run over the union (see module docstring).  The
        parent snapshot is untouched; the base band arrays are SHARED
        with the parent (the batch's novel keys land in a new LSM delta
        run) until the run count crosses the consolidation threshold.
        """
        n_old = self.n_rows
        k = int(new_keys.shape[0])
        if k == 0:
            return self
        u, v, run_ks, run_reps = self._probe_new_keys(new_keys, n_old)
        ok = verify_edges(u, v, new_sigs, n_old, gather_old_sigs,
                          n_hashes, threshold)
        labels = merge_labels(self.labels, u[ok], v[ok], n_old, k)
        deltas = self.band_deltas
        if any(a.size for a in run_ks):
            deltas = deltas + ((run_ks, run_reps),)
        locator = self.locator
        if new_locator is not None:
            locator = np.concatenate(
                [locator, np.ascontiguousarray(new_locator, np.int32)])
        dk, dr = self.digest_keys, self.digest_rows
        if dk is not None and new_digests is not None:
            dk, dr = _merge_digest_map(dk, dr, new_digests, n_old)
        out = LiveClusterIndex(
            generation=self.generation + 1, n_rows=n_old + k,
            labels=labels, locator=locator,
            band_keys_sorted=self.band_keys_sorted,
            band_reps=self.band_reps, digest_keys=dk, digest_rows=dr,
            band_deltas=deltas)
        if len(deltas) >= _delta_max_runs():
            bk, br = out._consolidated()
            out = LiveClusterIndex(
                generation=out.generation, n_rows=out.n_rows,
                labels=out.labels, locator=out.locator,
                band_keys_sorted=bk, band_reps=br, digest_keys=dk,
                digest_rows=dr, band_deltas=())
        return out

    # -- queries (read-only; safe from any thread on one snapshot) ----------

    def lookup_digests(self, digests: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
        """[N, 2] uint64 digests -> (hit [N] bool, row [N] int32; -1 on
        miss).  Requires the digest map (built with ``new_digests``)."""
        if self.digest_keys is None:
            raise RuntimeError("this LiveClusterIndex was built without a "
                               "digest map (batch merge shape); membership "
                               "lookups need from_state(digests=...)")
        n = digests.shape[0]
        row = np.full(n, -1, np.int32)
        if n == 0 or self.digest_keys.shape[0] == 0:
            return np.zeros(n, bool), row
        q = _digest_struct(digests)
        pos = np.searchsorted(self.digest_keys, q)
        inb = pos < self.digest_keys.shape[0]
        hit = np.zeros(n, bool)
        hit[inb] = self.digest_keys[pos[inb]] == q[inb]
        row[hit] = self.digest_rows[pos[hit]]
        return hit, row

    def candidate_hubs(self, keys: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Per-band bucket hubs for query vectors that are NOT index rows:
        [K, B] band keys -> (q [E], hub_row [E]) pairs — the rows a cold
        run would test these vectors' signatures against.  Probes the
        base tables AND every LSM delta run (a key lives in exactly one
        source, so the union of hits is the consolidated answer)."""
        k, n_bands = keys.shape
        qs, hubs = [], []
        for b in range(n_bands):
            hit, rep = self._probe_band(b, keys[:, b])
            if hit.any():
                qs.append(np.flatnonzero(hit))
                hubs.append(rep[hit].astype(np.int64))
        if not qs:
            e = np.empty(0, np.int64)
            return e, e.copy()
        return np.concatenate(qs), np.concatenate(hubs)

    def query_labels(self, sigs: np.ndarray, keys: np.ndarray,
                     gather_sigs, n_hashes: int, threshold: float
                     ) -> np.ndarray:
        """Cluster membership for novel vectors (no mutation): each
        vector's candidate hubs are verified with the exact signature-
        agreement rule; the answer is the minimum label over verified
        hubs — the component a cold run would union this vector into —
        or -1 (a new singleton cluster).  ``gather_sigs`` maps unique
        index row ids -> their stored [*, H] signatures."""
        k = int(sigs.shape[0])
        out = np.full(k, -1, np.int64)
        q, hub = self.candidate_hubs(keys)
        if q.size == 0:
            return out
        uniq, inv = np.unique(hub, return_inverse=True)
        hub_sigs = gather_sigs(uniq)
        if hub_sigs is None:          # store raced (eviction): all miss
            return out
        agree = (sigs[q] == hub_sigs[inv]).sum(axis=1)
        ok = agree.astype(np.float32) / np.float32(n_hashes) \
            >= np.float32(threshold)
        if not ok.any():
            return out
        hub_lab = self.labels[hub[ok]].astype(np.int64)
        sentinel = np.int64(2**62)
        acc = np.full(k, sentinel, np.int64)
        np.minimum.at(acc, q[ok], hub_lab)
        return np.where(acc == sentinel, np.int64(-1), acc)

    def topk(self, sigs: np.ndarray, keys: np.ndarray, gather_sigs,
             k: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-query top-k index rows by exact signature agreement over
        the band-candidate set (the serve ``topk`` verb's low-latency
        host path): probe every band's bucket for hub rows, gather their
        stored signatures, rank by (-agreement count, ascending index
        row).  Returns (counts [Q, k] int32, rows [Q, k] int32), both
        ``-1``-padded past the candidate count.

        Candidates are bucket REPRESENTATIVES (one hub per distinct
        band key), so recall is bounded by the hub structure — the
        exact-recall surface is the full store scan
        (`cluster.kernels.score.bulk_topk_store`)."""
        nq = int(sigs.shape[0])
        k = int(k)
        counts_out = np.full((nq, k), -1, np.int32)
        rows_out = np.full((nq, k), -1, np.int32)
        if nq == 0 or k == 0:
            return counts_out, rows_out
        q, hub = self.candidate_hubs(keys)
        if q.size == 0:
            return counts_out, rows_out
        # One hub can hit a query in several bands: dedupe the pairs so
        # a row is ranked once per query.
        pair = q * np.int64(self.n_rows + 1) + hub
        sel = np.unique(pair, return_index=True)[1]
        q, hub = q[sel], hub[sel]
        uniq, inv = np.unique(hub, return_inverse=True)
        hub_sigs = gather_sigs(uniq)
        if hub_sigs is None:          # store raced (eviction): all miss
            return counts_out, rows_out
        agree = (sigs[q] == hub_sigs[inv]).sum(axis=1).astype(np.int32)
        # (-agreement, ascending row) within each query — the scorer
        # kernels' selection order exactly.
        order = np.lexsort((hub, -agree, q))
        qs, ag, hb = q[order], agree[order], hub[order]
        first = np.flatnonzero(np.r_[True, qs[1:] != qs[:-1]])
        runs = np.diff(np.r_[first, qs.size])
        rank = np.arange(qs.size) - np.repeat(first, runs)
        keep = rank < k
        counts_out[qs[keep], rank[keep]] = ag[keep]
        rows_out[qs[keep], rank[keep]] = hb[keep].astype(np.int32)
        return counts_out, rows_out


def _empty_digest_struct() -> np.ndarray:
    return np.empty(0, np.dtype([("a", "<u8"), ("b", "<u8")]))


def _digest_struct(digests: np.ndarray) -> np.ndarray:
    from .store import _as_struct

    return _as_struct(digests)


def _sorted_digest_map(digests: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
    d = _digest_struct(digests)
    order = np.argsort(d, kind="stable").astype(np.int32)
    return d[order].copy(), order


def _merge_digest_map(keys: np.ndarray, rows: np.ndarray,
                      new_digests: np.ndarray, base_index: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    nd = _digest_struct(new_digests)
    norder = np.argsort(nd, kind="stable")
    nk = nd[norder]
    nr = (norder + base_index).astype(np.int32)
    pos = np.searchsorted(nk, keys)
    merged_k = np.insert(nk, pos, keys)
    merged_r = np.insert(nr, pos, rows)
    return merged_k, merged_r


__all__ = ["LiveClusterIndex", "LshState", "build_band_tables",
           "candidate_edges", "extend_band_tables", "merge_labels",
           "verify_edges"]

"""Chunk checkpoints of the cluster pipeline: a copy of
``tse1m_tpu/cluster/checkpoint.py``.

``pipeline.cluster_sessions_resumable`` persists each streamed chunk's
(signatures, band keys) shard under a directory as it completes; a killed
run re-invoked with the same directory recomputes only the chunks without
a good shard, then goes on to the LSH tail.

- ``manifest.json``: the run's meta (a blake2b fingerprint of every byte
  of the items the shards hold, the shape-affecting parameters, the chunk
  step, and extras such as the wire width or the delta encoder's lane
  split), ``chunks_done`` and each shard's CRC frame (``chunk_crcs``).  A
  manifest of another run refuses, whichever side has a key the other
  lacks; the meta holds nothing only one package writes, so a checkpoint
  either package left resumes in the other.
- ``shard_NNNNN.npz``: one chunk's ``sig`` and ``keys``, uint32, written
  to ``shard_NNNNN.npz.tmp.npz`` and renamed.  A shard that is missing,
  torn, fails its frame (``store.file_crc``) or does not load reads as not
  done, and its chunk recomputes.

Writes retry transient ``OSError`` (``utils/retry.py``) under the
``checkpoint.cluster.save`` fault seat.  ``cleanup`` removes the shards,
the manifest and any orphaned temp file after a completed run.
"""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os

import numpy as np

from ..resilience.faults import fault_point
from ..utils.retry import io_retry_policy, retry_call
from .store import file_crc

log = logging.getLogger("tse1m_tpu_torch.checkpoint")

_MANIFEST = "manifest.json"


def _items_fingerprint(items: np.ndarray) -> str:
    """Shape, dtype and every byte: a sampled hash would let a resume mix
    shards of a changed study into wrong labels."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((items.shape, str(items.dtype))).encode())
    h.update(np.ascontiguousarray(items).tobytes())
    return h.hexdigest()


class ClusterCheckpoint:
    """Per-chunk signature and key shards and their manifest under
    ``directory``."""

    def __init__(self, directory: str, items: np.ndarray, params,
                 step: int, extra: dict | None = None,
                 n_chunks: int | None = None) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.meta = {
            "fingerprint": _items_fingerprint(items),
            "n": int(items.shape[0]),
            "set_size": int(items.shape[1]),
            "n_hashes": params.n_hashes,
            "n_bands": params.n_bands,
            "seed": params.seed,
            "scheme": params.scheme,
            "step": int(step),
            **(extra or {}),
        }
        if n_chunks is not None:
            self.meta["n_chunks"] = int(n_chunks)
        self._manifest_path = os.path.join(directory, _MANIFEST)
        prior = self._load_manifest()
        if prior is not None:
            prior_meta = {k: v for k, v in prior.items()
                          if k not in ("chunks_done", "chunk_crcs")}
            # A manifest from before the schemes holds kminhash shards.
            prior_meta.setdefault("scheme", "kminhash")
            if prior_meta != self.meta:
                diff = {k: (prior_meta.get(k), self.meta.get(k))
                        for k in set(prior_meta) | set(self.meta)
                        if prior_meta.get(k) != self.meta.get(k)}
                raise ValueError(
                    f"checkpoint at {directory} belongs to a different "
                    "run (items or params changed); use a fresh directory "
                    f"or delete it. mismatched (have, want): {diff}")
            self.done = set(prior["chunks_done"])
            self.chunk_crcs = {str(k): int(v) for k, v in
                               (prior.get("chunk_crcs") or {}).items()}
            log.info("resuming cluster run: %d/%d chunks already done",
                     len(self.done), self.n_chunks)
        else:
            self.done = set()
            self.chunk_crcs = {}
            self._write_manifest()

    @property
    def n_chunks(self) -> int:
        if "n_chunks" in self.meta:
            return self.meta["n_chunks"]
        return -(-self.meta["n"] // self.meta["step"])

    @staticmethod
    def peek_meta(directory: str) -> dict | None:
        """The existing manifest (or None), read before planning: a resume
        under the auto wire policy adopts the width its shards hold."""
        try:
            with open(os.path.join(directory, _MANIFEST)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _load_manifest(self) -> dict | None:
        if not os.path.exists(self._manifest_path):
            return None
        with open(self._manifest_path) as f:
            return json.load(f)

    def _write_manifest(self) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({**self.meta, "chunks_done": sorted(self.done),
                       "chunk_crcs": self.chunk_crcs}, f)
        os.replace(tmp, self._manifest_path)

    def _shard_path(self, index: int) -> str:
        return os.path.join(self.directory, f"shard_{index:05d}.npz")

    def chunk_done(self, index: int) -> bool:
        return index in self.done and self._shard_ok(index)

    def _shard_ok(self, index: int) -> bool:
        """The shard exists, passes its CRC frame and loads."""
        path = self._shard_path(index)
        if not os.path.exists(path):
            return False
        want = self.chunk_crcs.get(str(index))
        if want is not None:
            try:
                got = file_crc(path)
            except OSError:
                return False
            if int(got) != int(want):
                log.warning("shard %s failed its CRC frame (stored %d, "
                            "computed %d); will recompute", path, want, got)
                return False
        try:
            with np.load(path) as z:
                return "sig" in z.files and "keys" in z.files
        except Exception as e:  # graftlint: disable=broad-except -- a torn shard must read as not-done whatever the failure mode
            log.warning("shard %s unreadable (%s); will recompute", path, e)
            return False

    def save_chunk(self, index: int, sig: np.ndarray,
                   keys: np.ndarray) -> None:
        """Write one chunk's shard (temp file, CRC frame, rename), then
        mark it done in the manifest: a crash before the rename leaves the
        chunk not done."""
        path = self._shard_path(index)
        tmp = path + ".tmp.npz"
        crc = {}

        def write_shard() -> None:
            np.savez(tmp, sig=sig, keys=keys)
            crc["v"] = file_crc(tmp)  # frame the exact published bytes
            fault_point("checkpoint.cluster.save", path=tmp)
            os.replace(tmp, path)

        retry_call(write_shard, policy=io_retry_policy(),
                   site="checkpoint.cluster.save")
        self.done.add(index)
        self.chunk_crcs[str(index)] = crc["v"]
        self._write_manifest()

    def load_chunk(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        with np.load(self._shard_path(index)) as z:
            return z["sig"], z["keys"]

    def load_chunk_or_none(self, index: int):
        """(sig, keys), or None when the shard is missing or torn: the
        chunk then recomputes."""
        try:
            with np.load(self._shard_path(index)) as z:
                return z["sig"], z["keys"]
        except Exception as e:  # graftlint: disable=broad-except -- a torn shard must read as not-done whatever the failure mode
            log.warning("shard %d unreadable at load (%s); recomputing",
                        index, e)
            self.done.discard(index)
            return None

    def cleanup(self) -> None:
        """Remove the shards, any orphaned ``.tmp.npz`` and the
        manifest."""
        for p in glob.glob(os.path.join(self.directory,
                                        "shard_*.npz.tmp.npz")):
            os.remove(p)
        for i in range(self.n_chunks):
            p = self._shard_path(i)
            if os.path.exists(p):
                os.remove(p)
        if os.path.exists(self._manifest_path):
            os.remove(self._manifest_path)


__all__ = ["ClusterCheckpoint"]

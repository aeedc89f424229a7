"""Starting a world and feeding it, and the pod plane's file exchange: a
port of ``tse1m_tpu/parallel/multihost.py``.

One process a rank.  ``initialize_from_env`` reads the JAX package's
variables (``TSE1M_COORDINATOR``, ``TSE1M_NUM_PROCESSES``,
``TSE1M_PROCESS_ID``) and starts a ``torch.distributed`` world with a
bounded timeout, so that a dead rank fails the world's collectives
instead of hanging them; ``init_world`` starts one from explicit values.
Rank r runs on card ``r % device_count``, or on the CPU when the caller
asks for it.  The backend follows placement: NCCL when every rank has a
card of its own, gloo when ranks share a card (NCCL refuses two ranks on
one card) or run on the CPU.

Data is fed process-locally: a process materialises only
``local_row_range(n)`` of the global rows and ``put_process_local`` puts
that block on its device as a ``ShardedRows``, the counterpart of JAX's
pre-sharded ``jax.Array``.

The pod path (``cluster_sessions_pod``) starts no world: its processes
take their identity from the environment (``pod_process_env``), deal rows
by ``pod_row_range`` and swap their novel tails through ``fs_exchange``,
atomic npz files under the shared store root that either package reads.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device, u32_tensor
from .mesh import Mesh, _set_world_device, make_mesh

log = logging.getLogger("tse1m_tpu_torch.multihost")

_ENV_COORD = "TSE1M_COORDINATOR"      # host:port of process 0, or a URL
_ENV_NPROC = "TSE1M_NUM_PROCESSES"
_ENV_PID = "TSE1M_PROCESS_ID"

# A collective that waits longer than this for a peer fails the world.
TIMEOUT_S = 600.0


def init_world(n_processes: int, process_id: int, init_method: str,
               device: str | torch.device = "cuda") -> torch.device:
    """Start this process's rank of a world of ``n_processes`` and return
    its device: card ``process_id % device_count`` (raises without a card
    unless ``device`` is "cpu").  ``init_method``: ``tcp://host:port`` or
    ``file://path``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", process_id % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if n_processes <= cards else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=n_processes,
        rank=process_id, timeout=timedelta(seconds=TIMEOUT_S),
        device_id=dev if backend == "nccl" else None)
    _set_world_device(dev)
    log.info("torch.distributed up: rank %d/%d on %s over %s", process_id,
             n_processes, dev, backend)
    return dev


def initialize_from_env(device: str | torch.device = "cuda",
                        init_method: str | None = None) -> bool:
    """Start the world the ``TSE1M_*`` variables describe.

    Returns True when a world of more than one process is (already or
    newly) up, False with no variables set or a world of one.  Rendezvous
    at ``init_method`` when given (the tests' ``file://``; then
    ``TSE1M_COORDINATOR`` may be unset), else at
    ``TSE1M_COORDINATOR`` (``host:port``, rank 0's store; a ``tcp://`` or
    ``file://`` URL is taken as it is).  A second call is a no-op."""
    coord = os.environ.get(_ENV_COORD)
    nproc = os.environ.get(_ENV_NPROC)
    if not (coord or init_method) or not nproc or int(nproc) <= 1:
        return dist.is_initialized() and dist.get_world_size() > 1
    pid_raw = os.environ.get(_ENV_PID)
    if not pid_raw:  # unset, or an unsubstituted template variable
        # A silent 0 would register every such process as rank 0.
        raise RuntimeError(
            f"{_ENV_COORD} and {_ENV_NPROC}={nproc} are set but {_ENV_PID} "
            "is not; every process must export its unique id (0..n-1)")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None:
        init_method = (coord if coord.startswith(("tcp://", "file://"))
                       else f"tcp://{coord}")
    init_world(int(nproc), int(pid_raw), init_method, device)
    return True


def shutdown() -> None:
    """Wait for every rank, then take the world down (no-op without
    one)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def pod_process_env() -> tuple[int, int]:
    """(n_processes, process_id) from the environment without starting a
    world (the CLI's route decision reads it); else the started world's;
    else (1, 0)."""
    nproc = os.environ.get(_ENV_NPROC)
    pid = os.environ.get(_ENV_PID)
    if nproc and int(nproc) > 1:
        if not pid:
            raise RuntimeError(
                f"{_ENV_NPROC}={nproc} is set but {_ENV_PID} is not; "
                "every pod process must export its unique id (0..n-1)")
        return int(nproc), int(pid)
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(axis: str = "data") -> Mesh:
    """The mesh over every rank of the world."""
    return make_mesh(axis=axis)


def local_row_range(n_rows: int) -> tuple[int, int]:
    """[start, stop) of the global rows this process materialises: a
    contiguous ceil deal, one device a process (JAX's device-aligned deal
    with one local device)."""
    size, rank = _world()
    per = -(-n_rows // size)
    start = min(rank * per, n_rows)
    return start, min(start + per, n_rows)


def padded_row_count(n_rows: int, mesh: Mesh | None = None) -> int:
    """n_rows rounded up to a multiple of the mesh size (the world's
    without a mesh): the pad contract of pre-sharded feeds."""
    k = mesh.size if mesh is not None else _world()[0]
    return -(-n_rows // k) * k


@dataclass(frozen=True)
class ShardedRows:
    """This rank's block of a row-sharded global array, on its device
    (uint32 values as int32 bits), and the global row count."""

    rows: torch.Tensor
    n_rows: int


def put_process_local(local_rows: np.ndarray, n_global_rows: int,
                      mesh: Mesh, axis: str = "data") -> ShardedRows:
    """This process's ``local_row_range(n_global_rows)`` slice, put on its
    device.  No process holds another's rows."""
    lo, hi = local_row_range(n_global_rows)
    if local_rows.shape[0] != hi - lo:
        raise ValueError(
            f"process {mesh.rank} must feed rows [{lo}, {hi}) "
            f"({hi - lo} rows), got {local_rows.shape[0]}")
    if local_rows.dtype == np.uint32:
        rows = u32_tensor(local_rows, mesh.device)
    else:
        # graftlint: disable=wire-layer -- the multi-host feed seat: no single host holds all rows, so the single-host wire layer cannot carry this put
        rows = torch.from_numpy(np.ascontiguousarray(local_rows)).to(
            mesh.device)
    return ShardedRows(rows=rows, n_rows=int(n_global_rows))


def put_process_local_padded(local_rows: np.ndarray, n_logical_rows: int,
                             mesh: Mesh, axis: str = "data"
                             ) -> tuple[ShardedRows, int]:
    """``put_process_local`` for any row count: the global rows pad to
    ``padded_row_count(n_logical_rows)``, and the owner of the tail block
    grows it with zero rows.  ``local_rows`` are this process's logical
    rows, the part of ``local_row_range(padded)`` below n_logical_rows.
    Returns (rows, n_padded); consumers slice results to
    ``[:n_logical_rows]``."""
    if mesh.size != _world()[0]:
        raise ValueError(
            f"put_process_local_padded requires the global mesh "
            f"({_world()[0]} ranks), got a {mesh.size}-rank mesh")
    n_pad = padded_row_count(n_logical_rows, mesh)
    lo, hi = local_row_range(n_pad)
    want_logical = min(hi, n_logical_rows) - min(lo, n_logical_rows)
    if local_rows.shape[0] != want_logical:
        raise ValueError(
            f"process {mesh.rank} must feed rows "
            f"[{lo}, {min(hi, n_logical_rows)}) of the logical array "
            f"({want_logical} rows), got {local_rows.shape[0]}")
    missing = (hi - lo) - local_rows.shape[0]
    if missing:
        block = np.zeros((missing,) + local_rows.shape[1:],
                         dtype=local_rows.dtype)
        local_rows = np.concatenate([local_rows, block], axis=0)
    return put_process_local(local_rows, n_pad, mesh, axis), n_pad


def all_processes_ready(tag: str = "barrier") -> None:
    """Barrier across the world (no-op in a single process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        log.debug("barrier %s", tag)
        dist.barrier()


def pod_row_range(n_rows: int, n_processes: int,
                  process_id: int) -> tuple[int, int]:
    """[start, stop) of the rows this process materialises on the pod
    path: a contiguous ceil deal over processes.  A pure function of its
    arguments, so a failover survivor knows which rows a lost process
    held."""
    per = -(-int(n_rows) // max(1, int(n_processes)))
    start = min(int(process_id) * per, int(n_rows))
    return start, min(start + per, int(n_rows))


def fs_exchange(xch_dir: str, tag: str, payload: dict,
                monitor=None, timeout_s: float = 600.0,
                n_processes: int | None = None,
                process_id: int | None = None) -> list:
    """All-to-all exchange over the shared filesystem: write this
    process's arrays to ``{tag}.p{pid:03d}.npz`` (tmp, then
    ``os.replace``, so a peer never reads a torn file), wait for every
    peer's, return the payloads in process order.  Returning implies
    every process reached ``tag``.

    The wait polls ``monitor`` (``resilience.coordinator.PeerMonitor``)
    between sleeps, so a peer that stops beating raises ``HostLostError``
    here instead of hanging; ``timeout_s`` is the backstop without one.
    The pinned trace id rides the file as ``__trace__``, which readers
    drop.  ``xch_dir`` must be this run's (``coordinator.exchange_dir``):
    the names carry no run identity.  Identity defaults to the started
    world's; the pod plane passes it explicitly."""
    from ..observability.tracing import pinned_trace, span
    from ..resilience.watchdog import deadline_clock

    size, rank = _world()
    nproc = int(n_processes) if n_processes is not None else size
    pid = int(process_id) if process_id is not None else rank
    os.makedirs(xch_dir, exist_ok=True)

    def _path(p: int) -> str:
        return os.path.join(xch_dir, f"{tag}.p{p:03d}.npz")

    wire = {k: np.ascontiguousarray(v) for k, v in payload.items()}
    trace = pinned_trace()
    if trace and "__trace__" not in wire:
        wire["__trace__"] = np.frombuffer(bytes.fromhex(trace),
                                          dtype=np.uint8)
    tmp = _path(pid) + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **wire)
    os.replace(tmp, _path(pid))
    out: dict[int, dict] = {pid: {k: np.ascontiguousarray(v)
                                  for k, v in payload.items()}}
    deadline = deadline_clock() + float(timeout_s)
    pending = set(range(nproc)) - {pid}
    with span(f"pod.exchange.{tag}", peers=nproc - 1):
        while pending:
            for p in sorted(pending):
                if os.path.exists(_path(p)):
                    with np.load(_path(p)) as z:
                        out[p] = {k: z[k] for k in z.files
                                  if k != "__trace__"}
                    pending.discard(p)
            if not pending:
                break
            if monitor is not None:
                monitor.check(site=f"pod.exchange:{tag}")
            if deadline_clock() > deadline:
                raise TimeoutError(
                    f"pod exchange '{tag}': no payload from process(es) "
                    f"{sorted(pending)} within {timeout_s:.0f}s")
            time.sleep(0.1)
    return [out[p] for p in range(nproc)]


__all__ = ["ShardedRows", "TIMEOUT_S", "all_processes_ready", "fs_exchange",
           "global_mesh", "init_world", "initialize_from_env",
           "local_row_range", "padded_row_count", "pod_process_env",
           "pod_row_range", "put_process_local", "put_process_local_padded",
           "shutdown"]

"""The 1-D data mesh over a ``torch.distributed`` world.

A port of ``tse1m_tpu/parallel/mesh.py:22-74``.  JAX's mesh is
single-controller: one process drives d devices through ``shard_map``.
This package follows PyTorch's SPMD idiom instead: one process a rank,
each on its own device, every rank calling the same function with the
same host arrays and computing its block; the collectives below take the
place of ``psum``, ``pmin``, ``all_gather`` and ``all_to_all``.

The process group's backend follows placement and is chosen when the
world starts (``multihost.init_world``): NCCL when every rank has a card
of its own, gloo when ranks share a card or run on the CPU.  The gloo
build this package runs against takes CUDA tensors for every collective
used here (all_reduce SUM and MIN on int32 and int64, all_to_all_single,
all_gather_into_tensor; probed by ``chip_smoke.py`` phase 3g), so no
collective is staged through host memory by this module.

``Mesh``'s methods are the only place the package calls a
``torch.distributed`` collective.  Each one records its calls, bytes and
seconds in ``Mesh.stats`` (the seconds between two device
synchronisations around the call, so they hold the collective's own time
on either backend).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..observability.tracing import region

# The device this process's world was started for (multihost.init_world):
# the process group itself is process-global state of torch.distributed.
_world_device: dict = {}


def _set_world_device(device: torch.device) -> None:
    _world_device["device"] = device


@dataclass(eq=False)
class Mesh:
    """A 1-D ``data`` mesh: this rank's view of an initialized world.

    ``group``: the process group; ``size``/``rank``: the world's size and
    this process's rank in it; ``device``: this rank's device;
    ``backend``: "nccl" or "gloo".  ``stats`` maps each collective
    ("psum", "pmin", "all_gather", "all_to_all") to its calls, bytes and
    seconds on this rank; ``reset_stats`` clears it.  Under a profiler each
    collective, with its two syncs, is the region ``tse1m.mesh.<name>``."""

    group: object
    size: int
    rank: int
    device: torch.device
    backend: str
    axis: str = "data"
    stats: dict = field(default_factory=dict)

    def reset_stats(self) -> None:
        self.stats.clear()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, name: str, nbytes: int, fn) -> None:
        with region("tse1m.mesh." + name):
            self._sync()
            t0 = time.perf_counter()
            fn()
            self._sync()
            t1 = time.perf_counter()
        s = self.stats.setdefault(name, {"calls": 0, "bytes": 0,
                                         "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["seconds"] += t1 - t0

    def _check(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"tensor on {t.device}, mesh on {self.device}")

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, in place; returns ``t``."""
        self._check(t)
        self._run("psum", t.numel() * t.element_size(), lambda: dist.all_reduce(
            t, op=dist.ReduceOp.SUM, group=self.group))
        return t

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum over the ranks, in place; returns ``t``."""
        self._check(t)
        self._run("pmin", t.numel() * t.element_size(), lambda: dist.all_reduce(
            t, op=dist.ReduceOp.MIN, group=self.group))
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[n, ...] blocks of equal shape -> [size * n, ...], the ranks'
        blocks in rank order (JAX's ``all_gather(tiled=True)``, axis 0)."""
        self._check(t)
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        self._run("all_gather", out.numel() * out.element_size(),
                  lambda: dist.all_gather_into_tensor(out, t,
                                                      group=self.group))
        return out

    def all_to_all_cols(self, t: torch.Tensor) -> torch.Tensor:
        """[n, C] with C divisible by ``size`` -> [size * n, C / size]:
        column block j goes to rank j, and the row blocks received come
        back concatenated in rank order (JAX's ``all_to_all(split_axis=1,
        concat_axis=0, tiled=True)``).  Sent as one contiguous
        [size, n, C / size] tensor through ``all_to_all_single``."""
        self._check(t)
        n, c = t.shape
        if c % self.size:
            raise ValueError(f"{c} columns do not split over {self.size} "
                             "ranks")
        b = c // self.size
        send = t.reshape(n, self.size, b).permute(1, 0, 2).contiguous()
        recv = torch.empty_like(send)
        self._run("all_to_all", send.numel() * send.element_size(),
                  lambda: dist.all_to_all_single(recv, send,
                                                 group=self.group))
        return recv.reshape(self.size * n, b)

    def block(self, x: np.ndarray) -> np.ndarray:
        """This rank's block of rows of a host array whose row count is a
        multiple of ``size``."""
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} rows do not split over "
                             f"{self.size} ranks")
        per = x.shape[0] // self.size
        return x[self.rank * per:(self.rank + 1) * per]


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """A ``Mesh`` over the initialized world (``multihost.init_world`` or
    ``initialize_from_env``).  ValueError when no world is initialized or
    when ``n_devices`` asks for another number of ranks than the world
    has (JAX's ``requested n devices, have m`` when it asks for more)."""
    if not dist.is_initialized():
        raise ValueError("no torch.distributed world is initialized: start "
                         "one with parallel.multihost.initialize_from_env "
                         "or init_world")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n != world:
        raise ValueError(f"a mesh spans the whole world: requested {n} of "
                         f"{world} ranks")
    device = _world_device.get("device")
    if device is None:
        raise ValueError("the world was not started by parallel.multihost, "
                         "so its device is unknown")
    return Mesh(group=dist.group.WORLD, size=world, rank=dist.get_rank(),
                device=device, backend=str(dist.get_backend()), axis=axis)


def pad_to_devices(x: np.ndarray, mesh: Mesh, fill=0) -> tuple[np.ndarray, int]:
    """Rows padded with ``fill`` to a multiple of the mesh size: JAX's
    padding, so that the padded rows take part in a clustering alike."""
    pad = (-x.shape[0]) % mesh.size
    if pad:
        fill_block = np.full((pad,) + x.shape[1:], fill, dtype=x.dtype)
        x = np.concatenate([x, fill_block], axis=0)
    return x, pad


def detection_hist_sharded(iterations, max_iter: int, mesh: Mesh,
                           axis: str = "data") -> torch.Tensor:
    """Per-iteration event histogram as a mesh collective.

    ``iterations``: [Q] 1-based iteration index per event (0 = unlinked,
    ignored), the same full array on every rank.  Each rank bincounts its
    block and ``psum`` merges the partials.  Returns the replicated
    [max_iter] int32 histogram on the rank's device."""
    it, _ = pad_to_devices(np.asarray(iterations, dtype=np.int64), mesh)
    # graftlint: disable=wire-layer -- a rank's block of the event array goes to its device; JAX's counterpart stages it inside shard_map through jnp, which the rule does not see
    shard = torch.from_numpy(np.ascontiguousarray(mesh.block(it))).to(
        mesh.device)
    in_range = (shard >= 1) & (shard <= max_iter)
    local = torch.bincount(torch.where(in_range, shard, 0),
                           minlength=max_iter + 1)[:max_iter + 1]
    return mesh.psum(local[1:].to(torch.int32).contiguous())


__all__ = ["Mesh", "detection_hist_sharded", "make_mesh", "pad_to_devices"]

"""Executor → device placement and the rank-ordered global fold.  Port of
``repro/core/placement.py``.

A :class:`DevicePlacement` pins each executor to one device (round-robin
when K exceeds the device count); the executor then keeps its stacked-batch
caches, client states and ``LocalAggregator`` accumulator on that device,
and ships its flat partial through the comm layer with no host round trip.
On one card every executor pins to ``cuda:0``; the placement is what the
server's gang dispatch (``executor.run_queues_ganged``) keys on.

The server-side fold of the K partials is where devices meet.
``global_fold`` copies each fp32 group buffer onto ``server_device`` (a
device-to-device copy only where the devices differ) and reduces the K
buffers with ONE launch of the fold kernel's rows form,
``agg_weighted_sum(acc=b0, rows=[b1, …, b_{K−1}], weights=[1.0]*(K−1))``.
The kernel computes ``s = fmaf(1, x, s)`` in row order, which is exactly
``s + x``: the fold equals the host path's left fold ``b0 + b1 + …`` bit for
bit, on the card and (through the plain version) on the CPU.  Starting from
``b0`` itself, not from a zero accumulator, keeps a ``-0.0`` in ``b0`` as
the host fold keeps it.  The JAX package's mesh and its ``shard_map``/
``psum`` have no counterpart: the ordered :meth:`devices` list and this
rank-ordered reduce take their role.

Failure handling mirrors the engines' elastic membership: ``release`` drops
a dead executor's pin, ``pin`` re-pins a restarted one on the least-loaded
live device, and ``fail_device`` re-pins every executor of a dead device
round-robin onto the live ones (the executor drops its device caches in
``SequentialExecutor.set_device``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import tree
from repro_torch.core.aggregation import reduce_flat_partials
from repro_torch.core.flat import is_flat_partial
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


def local_devices() -> List[torch.device]:
    """The devices a placement may pin executors to: every CUDA device of
    the process (none without a card)."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class DevicePlacement:
    """Executor id → device map.

    ``devices=None`` takes every local CUDA device; a single-device
    placement is valid (K executors on one card).  ``server`` names the
    device where folded aggregates land (default: the first placement
    device)."""

    def __init__(self, executor_ids: Sequence[int],
                 devices: Optional[Sequence[Any]] = None,
                 server: Optional[Any] = None):
        devices = ([resolve_device(d) for d in devices]
                   if devices is not None else local_devices())
        if not devices:
            raise ValueError("DevicePlacement needs at least one device "
                             "(pass devices=['cpu'] on the CPU)")
        self._devices = devices
        self._map: Dict[int, torch.device] = {
            k: devices[i % len(devices)]
            for i, k in enumerate(sorted(executor_ids))}
        self.server_device = (resolve_device(server) if server is not None
                              else devices[0])
        # steady-state gang-wave costs, shared by the ganged executors
        # (executor.run_queues_ganged): (sig, B_pad, K) -> seconds
        self._gang_cost: Dict[Tuple, float] = {}

    @classmethod
    def from_pins(cls, pins: Dict[int, Any],
                  server: Optional[Any] = None) -> "DevicePlacement":
        """Adopt an existing executor→device map (executors constructed
        with explicit ``device=`` pins)."""
        pins = {k: resolve_device(d) for k, d in pins.items()}
        devs: List[torch.device] = []
        for k in sorted(pins):
            if pins[k] not in devs:
                devs.append(pins[k])
        self = cls(sorted(pins), devices=devs, server=server)
        self._map = pins
        return self

    # ------------------------------------------------------------------
    def device(self, executor: int) -> torch.device:
        return self._map[executor]

    def executors(self) -> List[int]:
        return sorted(self._map)

    def devices(self) -> List[torch.device]:
        """Distinct pinned devices, in first-pinned order."""
        out: List[torch.device] = []
        for k in sorted(self._map):
            if self._map[k] not in out:
                out.append(self._map[k])
        return out

    @property
    def n_devices(self) -> int:
        return len(set(self._map.values()))

    def assign(self, executors: Sequence[Any]) -> None:
        """Pin a set of ``SequentialExecutor``s to their mapped devices."""
        for ex in executors:
            ex.set_device(self._map[ex.id])

    # ------------------------------------------------------------------
    def release(self, executor: int) -> None:
        """Drop a dead executor's pin (elastic K shrink)."""
        self._map.pop(executor, None)

    def pin(self, executor: int) -> torch.device:
        """Pin a (re)joining executor to the least-loaded live device (ties
        break on placement order, so a crashed executor's restart re-pins
        reproducibly on resume).  Returns the device; the caller pushes it
        into the executor with ``SequentialExecutor.set_device``."""
        if not self._devices:
            raise RuntimeError("no live devices to pin onto")
        load = {d: 0 for d in self._devices}
        for d in self._map.values():
            load[d] = load.get(d, 0) + 1
        dev = min(self._devices, key=lambda d: load[d])
        self._map[executor] = dev
        return dev

    def rebalance(self, queues, horizons, models, comm_cost=None):
        """Throughput-driven re-pinning at queue granularity: re-pack every
        undispatched task across the executor set from the current fitted
        per-executor models, seeding each lane with its busy horizon
        (``scheduler.rebalance_queues``).  Returns ``(assignment,
        moved)``."""
        from repro_torch.core.scheduler import rebalance_queues
        return rebalance_queues(queues, horizons, models, comm_cost)

    def fail_device(self, device: Any) -> List[int]:
        """A device died: re-pin its executors round-robin onto the live
        devices.  Returns the re-pinned executor ids (the caller pushes the
        new pins into the executors with ``assign``)."""
        dead = torch.device(device)
        live = [d for d in self._devices if d != dead]
        if not live:
            raise RuntimeError("no live devices left")
        self._devices = live
        moved = sorted(k for k, d in self._map.items() if d == dead)
        for i, k in enumerate(moved):
            self._map[k] = live[i % len(live)]
        return moved

    # ------------------------------------------------------------------
    def global_fold(self, partials: List[Dict[str, Any]],
                    ops: Dict[str, Any]) -> Dict[str, Any]:
        """``GlobalAggregate`` over the K flat partials, reduced onto
        ``server_device`` by :func:`rank_ordered_reduce` (one fold-kernel
        launch a fp32 weight group), bit for bit the host path's left
        fold.  The aggregate lands on ``server_device``."""
        if not all(is_flat_partial(p) for p in partials):
            raise ValueError("the port aggregates flat partials only")
        target = self.server_device
        out = reduce_flat_partials(
            partials, ops, lambda bufs: rank_ordered_reduce(bufs, target))
        return {name: tree.map(lambda x: colocate_to(x, target), v)
                for name, v in out.items()}


def rank_ordered_reduce(bufs: List[torch.Tensor],
                        target: torch.device) -> torch.Tensor:
    """``b0 + b1 + … + b_{K−1}`` in rank order on ``target``.

    fp32 buffers fold with one launch of the fold kernel's rows form for
    every ``MAX_FOLD_ROWS`` rows past ``b0`` (weights 1.0: ``fmaf(1, x, s)``
    is ``s + x``, so the sum is the host left fold bit for bit); any other
    dtype keeps the host left fold.  No buffer is written."""
    bufs = [colocate_to(b, target) for b in bufs]
    total = bufs[0]
    if total.dtype is not torch.float32:
        for b in bufs[1:]:
            total = total + b
        return total
    rest = [b.contiguous() for b in bufs[1:]]
    total = total.contiguous()
    for i in range(0, len(rest), kops.MAX_FOLD_ROWS):
        rows = rest[i:i + kops.MAX_FOLD_ROWS]
        total = kops.agg_weighted_sum(total, rows, [1.0] * len(rows))
    return total


def colocate_to(x: Any, device: torch.device) -> Any:
    """``x`` on ``device`` (a device-to-device copy only when it lies
    elsewhere; non-tensors pass through)."""
    if isinstance(x, torch.Tensor) and x.device != device:
        return x.to(device)
    return x


def colocate(x: Any, like: Any) -> Any:
    """Return ``x`` placed so it can combine with ``like`` (a copy only
    when their devices differ; no-op otherwise)."""
    if not isinstance(like, torch.Tensor):
        return x
    return colocate_to(x, like.device)

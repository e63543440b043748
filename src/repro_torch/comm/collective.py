"""Collective realisation of the hierarchical global aggregate.  Port of
``repro/comm/collective.py``.

In the JAX package ``GlobalAggregate`` over the K executors of a TPU mesh
is ONE ``psum`` over the data-parallel axes, not a message exchange.  The
port has no mesh: the K partials are reduced in rank order onto one device
by the fold kernel (``core.placement.rank_ordered_reduce``: one launch a
fp32 weight group, equal to the host path's left fold bit for bit).  A flat
partial reduces with ONE launch a weight group — the whole multi-entry
partial is one contiguous ``(n,)`` buffer — instead of one reduction an
entry or leaf.

``CollectiveComm`` adapts the same mechanism to the Communicator
interface: its inbox holds payloads by reference (a partial on the card
ships with no host round trip), and it bills a partial at the bytes one
all-reduce moves per device (2·(n−1)/n · s_a ≈ 2·s_a), not K·s_a — the
wire-level form of the paper's Table-1 saving.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.comm.base import Communicator


def _payload_bytes(x):
    # lazy import (repro_torch.core.round -> repro_torch.comm: a cycle
    # otherwise)
    from repro_torch.core.aggregation import payload_bytes
    return payload_bytes(x)


def spmd_global_aggregate(partials: List[Dict], ops: Dict[str, Any],
                          devices: Optional[Sequence[Any]] = None
                          ) -> Dict[str, Any]:
    """GlobalAggregate as one rank-ordered reduction a weight group (flat
    partials) or an entry (nested ``{entry: tree}`` partials).

    The reduction lands on ``devices[0]`` (default: the device of the first
    partial's first buffer); buffers elsewhere are copied there first."""
    from repro_torch.core import tree
    from repro_torch.core.aggregation import Op, reduce_flat_partials
    from repro_torch.core.flat import is_flat_partial
    from repro_torch.core.placement import rank_ordered_reduce
    from repro_torch.device import resolve_device

    def target(first: torch.Tensor) -> torch.device:
        return (resolve_device(devices[0]) if devices else first.device)

    if partials and all(is_flat_partial(p) for p in partials):
        return reduce_flat_partials(
            partials, ops, lambda bufs: rank_ordered_reduce(
                bufs, target(bufs[0])))

    out: Dict[str, Any] = {}
    for name, op in ops.items():
        if op is Op.COLLECT:
            coll: List[Any] = []
            for p in partials:
                coll.extend(p["collected"].get(name, []))
            out[name] = coll
            continue
        if not any(name in p["sums"] for p in partials):
            continue
        total = tree.map(
            lambda *xs: torch.stack(
                [x.to(target(xs[0])) for x in xs]).sum(dim=0),
            *[p["sums"][name] for p in partials])
        if op is Op.SUM:
            out[name] = total
        elif op is Op.AVG:
            n = sum(p["counts"].get(name, 0) for p in partials)
            out[name] = tree.map(lambda a: a / max(n, 1), total)
        else:  # WEIGHTED_AVG
            wtot = sum(p["weights"].get(name, 0.0) for p in partials)
            out[name] = tree.map(lambda a: a / max(wtot, 1e-12), total)
    return out


class CollectiveComm(Communicator):
    """Communicator whose server-side receive path feeds the collective
    aggregate.

    Broadcast is one replicated push, billed once; an executor's partial is
    billed at twice its sums' bytes (what one all-reduce moves per device,
    independent of K).  Payloads stay in the inbox by reference."""

    def __init__(self):
        super().__init__()
        self._inbox: Dict[tuple, Any] = {}

    def broadcast(self, payload, executors, tag):
        nb = _payload_bytes(payload)
        for k in executors:
            self._inbox[(k, tag)] = payload
        self.stats.add(tag, nb, trips=1)      # one replicated push

    def send_to_executor(self, executor, payload, tag):
        self._inbox[(executor, tag)] = payload
        self.stats.add(tag, _payload_bytes(payload), trips=1)

    def recv_from_executor(self, executor, tag):
        return self._inbox.pop(("srv", executor, tag))

    def executor_send(self, executor, payload, tag):
        self._inbox[("srv", executor, tag)] = payload
        # all-reduce wire cost per device ~ 2 x payload, independent of K
        self.stats.add(tag, 2 * _payload_bytes(payload.get("sums", payload))
                       if isinstance(payload, dict) else
                       2 * _payload_bytes(payload), trips=1)

    def executor_recv(self, executor, tag):
        return self._inbox.pop((executor, tag))

    def poll(self, executor, tag):
        # the inbox holds at most one in-flight payload per (executor, tag):
        # the engines drain each chunk partial before the executor's next
        # chunk is dispatched, so a single slot is enough
        return self._inbox.pop(("srv", executor, tag), None)

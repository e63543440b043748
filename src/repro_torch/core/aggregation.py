"""Hierarchical (local → global) aggregation with OP-typed parameters
(paper §3.2, §4.2) on a flatten-once flat-buffer layout.  Port of the main-
path part of ``repro/core/aggregation.py``.

Users declare, per communicated entry, an aggregation OP:

  WEIGHTED_AVG — Σ w_m x_m / Σ w_m        (model params/deltas; FedAvg etc.)
  AVG          — simple mean over clients
  SUM          — Σ x_m                    (counters, control-variate deltas)
  COLLECT      — concatenated per-client values ("Special Params."; cannot be
                 reduced, comm size stays O(s_e · M_p) — paper §4.2)

Executors fold their clients into a running partial (``LocalAggregator``),
the server combines the K partials (``global_aggregate``).

The fold (fp32 ``acc += Σ w · x`` over every model parameter for every
simulated client) is the memory-bound hot spot of the simulator.  Every fold
goes through ``kernels.ops``: a CUDA tensor launches the hand-written Hopper
kernel, a CPU tensor takes its plain version.  Unlike the JAX package there
is no ``use_kernel`` switch, and the final micro-batch flush is not padded
to B with zero-weight rows: the kernel takes any row count C <= 64 with no
per-shape compile, so padding would only move bytes.

The partial's wire format is flat: ``{"sums": {"__flat__": True,
"buffers": {group: (n,) fp32}}, "layout": FlatLayout, ...}``.  Behind a
compressor a group buffer may arrive in compressed wire form
(``core/compression.py``); the server-side folds consume it directly.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.compression import (CompressedTensor, densify_buffer,
                                          fold_buffer_into, scale_buffer)
from repro_torch.core.flat import (FlatLayout, flat_sums, is_compressed_buffer,
                                   is_flat_partial)
from repro_torch.kernels import ops as kops


class Op(enum.Enum):
    WEIGHTED_AVG = "weighted_avg"
    AVG = "avg"
    SUM = "sum"
    COLLECT = "collect"


@dataclass(frozen=True)
class ClientResult:
    """What one simulated client returns to its executor.

    ``payload`` maps entry name -> tree; ``ops`` maps entry name -> Op;
    ``weight`` is the client's aggregation weight (typically N_m).
    """
    payload: Dict[str, Any]
    ops: Dict[str, Op]
    weight: float
    metrics: Dict[str, float] = field(default_factory=dict)


def _first_device(payload: Any) -> torch.device:
    for leaf in tree.leaves(payload):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class LocalAggregator:
    """Per-executor running aggregate (``LocalAggregate`` in Algorithm 2).

    Memory is O(s_a) plus the staged micro-batch (at most ``micro_batch``
    client buffers) regardless of how many clients the executor simulates —
    the paper's memory claim for sequential training.

    ``micro_batch`` (B) controls how many client buffers are staged before
    ONE multi-client fold at C=B.  ``device`` is where the accumulators live
    (None: the device of the first folded payload).
    """

    def __init__(self, ops: Dict[str, Op], micro_batch: int = 16,
                 layout: Optional[FlatLayout] = None,
                 device: Optional[torch.device] = None):
        self.ops = dict(ops)
        self.micro_batch = max(1, int(micro_batch))
        self.layout = layout
        self.device = device
        self._acc: Optional[Dict[str, torch.Tensor]] = None
        self._staged: Dict[str, List[torch.Tensor]] = {}
        self._staged_w: Dict[str, List[float]] = {}
        # acc tensors escaped via partial(): later folds must not write them
        # in place
        self._exposed = False
        self._weights: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._collected: Dict[str, List[Any]] = {}
        self.n_clients = 0

    def fold(self, result: ClientResult) -> None:
        self.n_clients += 1
        payload = result.payload
        for name in payload:
            op = self.ops[name]
            if op is Op.COLLECT:
                self._collected.setdefault(name, []).append(
                    (result.weight, payload[name]))
                continue
            w = result.weight if op is Op.WEIGHTED_AVG else 1.0
            self._weights[name] = self._weights.get(name, 0.0) + w
            self._counts[name] = self._counts.get(name, 0) + 1
        self._ensure_acc(payload)
        for g, buf in self.layout.flatten(payload, self.device).items():
            self._staged[g].append(buf)
            self._staged_w[g].append(
                result.weight if g == "weighted" else 1.0)
        if any(len(s) >= self.micro_batch for s in self._staged.values()):
            self._flush()

    def _ensure_acc(self, template_payload: Dict[str, Any]) -> None:
        """Lazily build the layout (from one un-batched template payload)
        and the per-group accumulators / staging lists."""
        if self.layout is None:
            self.layout = FlatLayout.build(self.ops, template_payload)
        if self.device is None:
            self.device = _first_device(template_payload)
        if self._acc is None:
            self._acc = self.layout.zeros(self.device)
            self._staged = {g: [] for g in self._acc}
            self._staged_w = {g: [] for g in self._acc}

    def fold_block(self, stacked: Dict[str, Any],
                   weights: List[float]) -> None:
        """Fold a whole vmapped client block at once.

        ``stacked`` maps entry name -> tree with a leading (B, ...) client
        axis — what ``ClientStepEngine.run_block`` emits — and ``weights``
        holds the B per-client aggregation weights.  Each group's reducible
        leaves fold straight into the accumulator with ONE leaves-form
        launch (``ops.agg_fold_leaves``, ``FlatLayout.batch_segments``): no
        (B, n) buffer is built.  COLLECT entries are sliced out per
        client."""
        B = len(weights)
        self.n_clients += B
        for name in stacked:
            op = self.ops[name]
            if op is Op.COLLECT:
                rows = stacked[name]
                lst = self._collected.setdefault(name, [])
                for i in range(B):
                    lst.append((weights[i], tree.map(lambda x: x[i], rows)))
                continue
            wtot = float(sum(weights)) if op is Op.WEIGHTED_AVG else float(B)
            self._weights[name] = self._weights.get(name, 0.0) + wtot
            self._counts[name] = self._counts.get(name, 0) + B
        if self.layout is None or self._acc is None:
            self._ensure_acc({name: tree.map(lambda x: x[0], val)
                              for name, val in stacked.items()})
        cap = kops.MAX_FOLD_ROWS
        for g, segs in self.layout.batch_segments(
                stacked, self.device, readable=kops.FOLD_DTYPES).items():
            w = weights if g == "weighted" else [1.0] * B
            # a block of more clients than one fold takes folds in parts:
            # the same sums in the same order
            for i in range(0, B, cap):
                part = segs if B <= cap else [(leaf[i:i + cap], off)
                                              for leaf, off in segs]
                self._acc[g] = kops.agg_fold_leaves(
                    self._acc[g], part, w[i:i + cap],
                    inplace=i > 0 or not self._exposed)
        self._exposed = False

    def _flush(self) -> None:
        """Fold the staged micro-batch: ONE launch per group, the staged
        buffers read through the kernel's pointer array (no stack).  Unlike
        ``fold_block``, this path keeps flattening each payload into a
        staged buffer of its own: a staged payload is folded later, and
        nothing guarantees that its leaves are not written before the
        flush, so the copy is what makes the fold see the values of the
        moment ``fold`` was called."""
        for g, staged in self._staged.items():
            if not staged:
                continue
            self._acc[g] = kops.agg_fold_batch(
                self._acc[g], staged, self._staged_w[g],
                inplace=not self._exposed)
            self._staged[g] = []
            self._staged_w[g] = []
        self._exposed = False

    def partial(self) -> Dict[str, Any]:
        """The G_k message sent to the server: one trip, O(s_a K) total —
        one flat fp32 buffer per group instead of a nested dict of leaves."""
        if any(self._staged.values()):
            self._flush()
        self._exposed = True    # returned tensors must survive further folds
        return {
            "sums": flat_sums(dict(self._acc) if self._acc is not None else {}),
            "layout": self.layout,
            "weights": dict(self._weights),
            "counts": dict(self._counts),
            "collected": {k: list(v) for k, v in self._collected.items()},
            "n_clients": self.n_clients,
        }


def merge_partials(acc: Optional[Dict[str, Any]],
                   partial: Dict[str, Any]) -> Dict[str, Any]:
    """Fold one flat partial into a running partial-of-partials (same wire
    format), so a server-side buffer stays O(s_a) however many partials
    land.  ``acc=None`` starts the accumulator (copied shallowly so later
    merges never mutate an executor's live buffers).  Compressed wire
    buffers decode into the dense accumulator as they fold."""
    if not is_flat_partial(partial):
        raise ValueError("the port merges flat partials only")
    if acc is None:
        out = dict(partial)
        out["sums"] = flat_sums(
            {g: (densify_buffer(b) if is_compressed_buffer(b) else b)
             for g, b in partial["sums"]["buffers"].items()})
        out["weights"] = dict(partial.get("weights", {}))
        out["counts"] = dict(partial.get("counts", {}))
        out["collected"] = {k: list(v)
                            for k, v in partial.get("collected", {}).items()}
        return out
    la, lp = acc.get("layout"), partial.get("layout")
    if la is not None and lp is not None \
            and la.signature() != lp.signature():
        raise ValueError("flat partials built under different layouts")
    bufs = acc["sums"]["buffers"]
    for g, b in partial["sums"]["buffers"].items():
        if g not in bufs:
            bufs[g] = densify_buffer(b) if is_compressed_buffer(b) else b
        elif is_compressed_buffer(b):
            # fused decompress-into-fold: no dense copy of the partial
            bufs[g] = fold_buffer_into(bufs[g], b)
        else:
            bufs[g] = bufs[g] + b.to(bufs[g].device)
    for field_ in ("weights", "counts"):
        dst = acc[field_]
        for k, v in partial.get(field_, {}).items():
            dst[k] = dst.get(k, 0) + v
    for k, v in partial.get("collected", {}).items():
        acc["collected"].setdefault(k, []).extend(v)
    acc["n_clients"] = acc.get("n_clients", 0) + partial.get("n_clients", 0)
    return acc


def tree_reduce_partials(partials: List[Dict[str, Any]],
                         fan_in: int = 8) -> List[Dict[str, Any]]:
    """Hierarchical aggregation tree (executor → group → server): reduce a
    wide partial list level by level, left-folding contiguous groups of
    ``fan_in`` partials with :func:`merge_partials` until at most ``fan_in``
    remain.  A list already at or below ``fan_in`` is returned as-is."""
    if fan_in < 2:
        raise ValueError(f"fan_in must be >= 2 (got {fan_in})")
    level = list(partials)
    while len(level) > fan_in:
        nxt = []
        for i in range(0, len(level), fan_in):
            acc: Optional[Dict[str, Any]] = None
            for p in level[i:i + fan_in]:
                acc = merge_partials(acc, p)
            nxt.append(acc)
        level = nxt
    return level


def staleness_weight(staleness: float, lam: float) -> float:
    """Bounded-staleness discount γ = 1 / (1 + λ·s): a partial computed
    against a model ``s`` server versions old contributes with weight γ."""
    return 1.0 / (1.0 + lam * max(float(staleness), 0.0))


def scale_partial(partial: Dict[str, Any], gamma: float) -> Dict[str, Any]:
    """Scale a flat partial's *contribution* by ``gamma`` on the wire format.

    Numerators (the group buffers, compressed ones without decoding) and
    denominators (per-entry weights and counts) scale together, so a
    γ-scaled partial enters WEIGHTED_AVG / AVG entries with relative weight
    γ versus fresh partials, SUM entries are discounted to γ·Σ, and COLLECT
    entries keep their values with γ-scaled client weights.  ``gamma == 1``
    returns the partial unchanged (no copy)."""
    if gamma == 1.0:
        return partial
    if not is_flat_partial(partial):
        raise ValueError("the port scales flat partials only")
    g32 = float(np.float32(gamma))     # an fp32 factor, as on the JAX side
    out = dict(partial)
    out["sums"] = flat_sums(
        {g: (scale_buffer(b, gamma) if is_compressed_buffer(b)
             else b * g32)
         for g, b in partial["sums"]["buffers"].items()})
    out["weights"] = {k: v * gamma
                      for k, v in partial.get("weights", {}).items()}
    out["counts"] = {k: v * gamma
                     for k, v in partial.get("counts", {}).items()}
    out["collected"] = {k: [(w * gamma, v) for w, v in lst]
                        for k, lst in partial.get("collected", {}).items()}
    return out


# ---------------------------------------------------------------------------
# global aggregate
# ---------------------------------------------------------------------------

def _sum_buffers(bufs: List[torch.Tensor]) -> torch.Tensor:
    total = bufs[0]
    for b in bufs[1:]:
        total = total + b.to(total.device)
    return total


def reduce_flat_partials(partials: List[Dict[str, Any]], ops: Dict[str, Op],
                         reduce_fn: Callable[[List[torch.Tensor]],
                                             torch.Tensor]
                         ) -> Dict[str, Any]:
    """Combine flat partials: ``reduce_fn`` sums the per-group buffers (K-1
    adds), then each entry is sliced, divided per its OP, and unflattened
    once."""
    layout = next((p.get("layout") for p in partials
                   if p.get("layout") is not None), None)
    if layout is not None:
        sig = layout.signature()
        for p in partials:
            other = p.get("layout")
            if other is not None and other.signature() != sig:
                raise ValueError("flat partials built under different layouts")
    totals: Dict[str, torch.Tensor] = {}
    for g in (layout.group_sizes if layout is not None else {}):
        bufs = [p["sums"]["buffers"][g] for p in partials
                if g in p["sums"]["buffers"]]
        if not bufs:
            continue
        if any(is_compressed_buffer(b) for b in bufs):
            # compressed wire buffers: order-preserving fused
            # decompress-into-fold (reduce_fn takes dense buffers)
            total = (densify_buffer(bufs[0])
                     if is_compressed_buffer(bufs[0]) else bufs[0])
            for b in bufs[1:]:
                total = (fold_buffer_into(total, b)
                         if is_compressed_buffer(b)
                         else total + b.to(total.device))
            totals[g] = total
        else:
            totals[g] = reduce_fn(bufs)
    out: Dict[str, Any] = {}
    for name, op in ops.items():
        if op is Op.COLLECT:
            coll: List[Any] = []
            for p in partials:
                coll.extend(p["collected"].get(name, []))
            out[name] = coll
            continue
        span = layout.spans.get(name) if layout is not None else None
        if span is None or span.group not in totals:
            continue
        seg = totals[span.group][span.offset:span.offset + span.size]
        if op is Op.AVG:
            n = sum(p["counts"].get(name, 0) for p in partials)
            seg = seg / max(n, 1)
        elif op is Op.WEIGHTED_AVG:
            wtot = sum(p["weights"].get(name, 0.0) for p in partials)
            seg = seg / max(wtot, 1e-12)
        out[name] = layout.unflatten_entry(name, seg)
    return out


def global_aggregate(partials: List[Dict[str, Any]],
                     ops: Dict[str, Op]) -> Dict[str, Any]:
    """``GlobalAggregate`` in Algorithm 2: combine the K flat partials (K-1
    buffer adds per group at the server instead of M_p-1)."""
    if not all(is_flat_partial(p) for p in partials):
        raise ValueError("the port aggregates flat partials only")
    return reduce_flat_partials(partials, ops, _sum_buffers)


def flat_aggregate(results: List[ClientResult],
                   ops: Dict[str, Op]) -> Dict[str, Any]:
    """Reference original-FL aggregation (server folds every client) used to
    verify exactness of the hierarchical scheme."""
    agg = LocalAggregator(ops)
    for r in results:
        agg.fold(r)
    return global_aggregate([agg.partial()], ops)


def payload_bytes(obj: Any) -> int:
    """Wire size of a payload/partial: tensors and arrays at numel x
    itemsize (flat group buffers included), compressed tensors at their
    data arrays' bytes, Python scalars at 8; layout metadata is free."""
    total = 0
    for a in tree.leaves(obj):
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif isinstance(a, (np.ndarray, np.generic)):
            total += int(a.nbytes)
        elif isinstance(a, CompressedTensor):
            total += a.nbytes
        elif isinstance(a, (int, float, bool)):
            total += 8
    return total


def wire_bytes(payload: Any) -> int:
    """Achieved wire size of a payload: a compressed partial (compressors
    stamp ``_wire_bytes`` on the sums they shrank) counts its compressed
    sums plus the uncompressed rest; everything else is ``payload_bytes``.
    This is the size the comm layer accounts."""
    if isinstance(payload, dict) and "_wire_bytes" in payload:
        rest = {k: v for k, v in payload.items()
                if k not in ("sums", "_wire_bytes")}
        return int(payload["_wire_bytes"]) + payload_bytes(rest)
    return payload_bytes(payload)

"""Flatten-once parameter layout for batched multi-client aggregation.
Port of ``repro/core/flat.py``.

A :class:`FlatLayout` computes, once per round, the mapping

    entry name -> (group, offset, size)        per communicated entry
    leaf       -> (offset, size, shape, dtype) per tree leaf

so a client's whole reducible payload becomes ONE contiguous 1-D buffer per
*weight group*:

  ``weighted`` — entries aggregated as Σ w_m x_m (``Op.WEIGHTED_AVG``)
  ``unit``     — entries aggregated with unit weight (``Op.AVG``/``Op.SUM``)

``Op.COLLECT`` entries are excluded (they ride the partial as a per-client
list).  Entries are laid out in the payload's *insertion* order, and the
leaves of one entry in ``jax.tree`` order (sorted dict keys, see
``core/tree.py``): the same two rules as the JAX package, so both packages
produce the same buffers element for element.

The group buffer dtype is the promotion of the member leaf dtypes: an
all-bf16 delta stays bf16 on the wire into the fold (halving bytes moved);
mixed bf16/fp32 promotes to fp32.  Accumulators and unflattened aggregates
are always fp32.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.device import as_tensor

GROUPS = ("weighted", "unit")


@dataclass(frozen=True)
class LeafSpec:
    """One tree leaf's home in its group buffer."""
    entry: str
    index: int                 # leaf index within the entry's tree
    offset: int                # into the group buffer
    size: int
    shape: Tuple[int, ...]
    dtype: torch.dtype         # the leaf's original dtype


@dataclass(frozen=True)
class EntrySpan:
    """One entry's contiguous span in its group buffer."""
    group: str
    offset: int
    size: int


def _group_of(op: Any) -> str:
    return "weighted" if getattr(op, "name", None) == "WEIGHTED_AVG" else "unit"


def _as_tensor(leaf: Any, device: Optional[torch.device] = None
               ) -> torch.Tensor:
    """A leaf as a tensor (a Python float becomes fp32, as ``jnp.asarray``
    makes it with x64 off)."""
    if isinstance(leaf, float):
        return torch.tensor(leaf, dtype=torch.float32, device=device)
    return as_tensor(leaf, device)


class FlatLayout:
    """Leaf names -> offsets/shapes/dtypes, computed once from the
    algorithm's ops plus one template payload."""

    def __init__(self, specs: Dict[str, Tuple[LeafSpec, ...]],
                 spans: Dict[str, EntrySpan],
                 treedefs: Dict[str, Any],
                 group_sizes: Dict[str, int],
                 group_dtypes: Dict[str, torch.dtype],
                 entry_order: Dict[str, Tuple[str, ...]]):
        self.specs = specs                  # group -> LeafSpecs in offset order
        self.spans = spans                  # entry  -> EntrySpan
        self.treedefs = treedefs            # entry  -> tree structure
        self.group_sizes = group_sizes      # group  -> total element count
        self.group_dtypes = group_dtypes    # group  -> buffer dtype
        self.entry_order = entry_order      # group  -> entry names in order

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, ops: Dict[str, Any], payload: Dict[str, Any]) -> "FlatLayout":
        """Compute the layout from the OP registry and a template payload.
        COLLECT entries and entries absent from the payload are skipped."""
        specs: Dict[str, List[LeafSpec]] = {g: [] for g in GROUPS}
        spans: Dict[str, EntrySpan] = {}
        treedefs: Dict[str, Any] = {}
        order: Dict[str, List[str]] = {g: [] for g in GROUPS}
        cursor = {g: 0 for g in GROUPS}
        for name, value in payload.items():      # insertion order
            op = ops.get(name)
            if op is None or getattr(op, "name", None) == "COLLECT":
                continue
            g = _group_of(op)
            leaves, treedef = tree.flatten(value)  # sorted dict keys
            treedefs[name] = treedef
            order[g].append(name)
            start = cursor[g]
            for i, leaf in enumerate(leaves):
                t = _as_tensor(leaf)
                shape = tuple(t.shape)
                size = int(np.prod(shape)) if shape else 1
                specs[g].append(LeafSpec(name, i, cursor[g], size, shape,
                                         t.dtype))
                cursor[g] += size
            spans[name] = EntrySpan(g, start, cursor[g] - start)
        sizes = {g: cursor[g] for g in GROUPS if cursor[g]}
        dtypes = {g: functools.reduce(torch.promote_types,
                                      [s.dtype for s in specs[g]])
                  for g in sizes}
        return cls({g: tuple(specs[g]) for g in sizes}, spans, treedefs,
                   sizes, dtypes, {g: tuple(order[g]) for g in sizes})

    # ------------------------------------------------------------------
    def flatten(self, payload: Dict[str, Any],
                device: Optional[torch.device] = None
                ) -> Dict[str, torch.Tensor]:
        """One contiguous 1-D buffer per group from a client payload
        (on ``device`` when given)."""
        out: Dict[str, torch.Tensor] = {}
        for g, entries in self.entry_order.items():
            dtype = self.group_dtypes[g]
            parts = [_as_tensor(leaf, device).reshape(-1).to(dtype)
                     for name in entries
                     for leaf in tree.leaves(payload[name])]
            out[g] = parts[0].contiguous() if len(parts) == 1 \
                else torch.cat(parts)
        return out

    def flatten_batch(self, payload: Dict[str, Any],
                      device: Optional[torch.device] = None
                      ) -> Dict[str, torch.Tensor]:
        """(B, n) group buffers from a payload with a leading client axis —
        one ``torch.cat`` of the (B, -1) leaf views in layout order, ready
        for a single C=B fold."""
        out: Dict[str, torch.Tensor] = {}
        for g, entries in self.entry_order.items():
            dtype = self.group_dtypes[g]
            parts = []
            for name in entries:
                for leaf in tree.leaves(payload[name]):
                    t = _as_tensor(leaf, device)
                    parts.append(t.reshape(t.shape[0], -1).to(dtype))
            out[g] = parts[0].contiguous() if len(parts) == 1 \
                else torch.cat(parts, dim=1)
        return out

    def zeros(self, device: Optional[torch.device] = None
              ) -> Dict[str, torch.Tensor]:
        """Fresh fp32 accumulators, one per group (the O(s_a) partial)."""
        return {g: torch.zeros((n,), dtype=torch.float32, device=device)
                for g, n in self.group_sizes.items()}

    def entry_slice(self, name: str, buffers: Dict[str, torch.Tensor]
                    ) -> torch.Tensor:
        """The entry's contiguous 1-D segment of its group buffer."""
        span = self.spans[name]
        return buffers[span.group][span.offset:span.offset + span.size]

    def unflatten_entry(self, name: str, segment: torch.Tensor) -> Any:
        """Rebuild one entry's tree (fp32 leaves) from its 1-D segment."""
        span = self.spans[name]
        leaves = []
        for s in self.specs[span.group]:
            if s.entry != name:
                continue
            rel = s.offset - span.offset
            leaves.append(segment[rel:rel + s.size].reshape(s.shape))
        return tree.unflatten(self.treedefs[name], leaves)

    def unflatten(self, buffers: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """entry name -> tree for every entry present in ``buffers``."""
        return {name: self.unflatten_entry(name, self.entry_slice(name, buffers))
                for name, span in self.spans.items()
                if span.group in buffers}

    def signature(self) -> Tuple:
        """Structural identity: partials folded under equal signatures can be
        combined buffer-wise."""
        return tuple(sorted((name, sp.group, sp.offset, sp.size)
                            for name, sp in self.spans.items()))


# ---------------------------------------------------------------------------
# module-level helpers (the partial wire format)
# ---------------------------------------------------------------------------

def flat_sums(buffers: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The wire form of a flat partial's sums: one tensor per group."""
    return {"__flat__": True, "buffers": buffers}


def is_flat_sums(sums: Any) -> bool:
    return isinstance(sums, dict) and bool(sums.get("__flat__"))


def is_flat_partial(partial: Dict[str, Any]) -> bool:
    return isinstance(partial, dict) and is_flat_sums(partial.get("sums"))

"""Client-training engine — the simulator's hot path.  Port of
``repro/core/client_step.py``.

``ClientStepEngine`` runs each algorithm's pure ``(carry, batch, mask) ->
carry`` step (``FLAlgorithm.local_step``) over all tau = local_epochs x
n_batches local steps as a Python loop, and ``torch.func.vmap``s that loop
over a block of B same-shape clients, producing stacked ``(B, ...)`` deltas
that feed the flat aggregator directly (``LocalAggregator.fold_block``).

Shape discipline: per-client batch counts and block sizes are padded up to
the next power of two — batches with repeats of the client's first batch
plus a 0/1 step mask, blocks with replicas of the first client whose
outputs are sliced off.  A masked step multiplies the update by zero, so
padding is *exact*, and blocks group exactly as the JAX package groups
them.

PyTorch runs eagerly, so there is no compile to count.  ``compile_events``
counts the first sight of each ``(signature, padded B)`` block shape per
engine instead — where the JAX engine compiles — so the executor's
first-block re-measure keeps its meaning (the first run of a shape pays
one-off costs: the vmap set-up, library handles, the allocator's growth).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.aggregation import ClientResult
from repro_torch.core.algorithms import ClientData, FLAlgorithm
from repro_torch.device import as_tensor

Pytree = Any

# Process-wide count of first-seen block shapes (see the module docstring).
_compile_events = 0


def compile_events() -> int:
    """Monotonic count of first-seen (signature, padded B) shapes."""
    return _compile_events


def _bucket(n: int) -> int:
    """Next power of two >= n (n >= 1) — the step-count / block bucket."""
    return 1 << max(n - 1, 0).bit_length()


def _leaf_sig(leaf: Any) -> Tuple:
    return (tuple(np.shape(leaf)), str(getattr(leaf, "dtype", "?")))


def batch_signature(data: ClientData) -> Optional[Tuple]:
    """Hashable grouping key for cross-client blocking: clients with equal
    signatures stack into one vmapped loop.  The batch count enters through
    its power-of-two bucket (mask padding makes unequal counts compatible).
    Returns None when the client's batches are ragged (eager fallback)."""
    bs = data.batches
    if not bs:
        return None
    leaves, treedef = tree.flatten(bs[0])
    shapes = tuple(_leaf_sig(l) for l in leaves)
    for b in bs[1:]:
        bl, bdef = tree.flatten(b)
        if bdef != treedef or tuple(_leaf_sig(l) for l in bl) != shapes:
            return None
    return (_bucket(len(bs)), treedef, shapes)


def stack_batches(data: ClientData, *, assume_uniform: bool = False
                  ) -> Optional[Tuple[Any, np.ndarray]]:
    """One leading-axis batch tree + 0/1 step mask for a client (numpy),
    padded to the power-of-two bucket with repeats of the first batch (finite
    data, so the masked zero-update is exact).  None when the batches are
    ragged.  ``assume_uniform=True`` skips the ragged check when the caller
    already grouped clients by :func:`batch_signature`."""
    if not assume_uniform and batch_signature(data) is None:
        return None
    bs = data.batches
    n, n_pad = len(bs), _bucket(len(bs))
    padded = list(bs) + [bs[0]] * (n_pad - n)
    stacked = tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                       *padded)
    mask = np.zeros((n_pad,), np.float32)
    mask[:n] = 1.0
    return stacked, mask


def place_prep(prep: Tuple[Any, Any], device: torch.device
               ) -> Tuple[Any, torch.Tensor]:
    """A numpy (batches, mask) pair as tensors on ``device``."""
    batches, mask = prep
    return (tree.map(lambda x: as_tensor(x, device), batches),
            as_tensor(mask, device))


class ClientStepEngine:
    """The local-SGD loop of one algorithm on one device, for one client
    (:meth:`run_client`) or a vmapped block (:meth:`run_block`)."""

    def __init__(self, algorithm: FLAlgorithm, device: torch.device):
        self.algorithm = algorithm
        self.device = device
        self._seen: set = set()     # first-seen shapes (compile_events)

    def _note_shape(self, key: Tuple) -> None:
        global _compile_events
        if key not in self._seen:
            self._seen.add(key)
            _compile_events += 1

    # ------------------------------------------------------------------
    def _run_one(self, payload: Dict, state: Optional[Pytree], batches: Any,
                 mask: torch.Tensor
                 ) -> Tuple[Dict[str, Any], Optional[Pytree]]:
        """The whole local update: init carry, tau steps, finalize.
        ``batches`` and ``mask`` carry a leading (n_pad,) step axis."""
        algo = self.algorithm
        carry = algo.init_carry(payload, state)
        n_pad = mask.shape[0]
        for _ in range(algo.local_epochs):
            for t in range(n_pad):
                carry = algo.local_step(
                    carry, tree.map(lambda x: x[t], batches), mask[t])
        return algo.finalize(carry, payload, state, batches, mask)

    # ------------------------------------------------------------------
    def run_client(self, payload: Dict, data: ClientData,
                   state: Optional[Pytree] = None, *,
                   assume_uniform: bool = False,
                   prep: Optional[Tuple[Any, Any]] = None
                   ) -> Tuple[ClientResult, Optional[Pytree]]:
        """Drop-in for ``algorithm.client_update`` through the step form
        (eager fallback on ragged batches).  ``prep`` supplies a
        pre-stacked (batches, mask) pair already on the device — typically
        from the executor's stacked-batch cache."""
        if prep is None:
            host = stack_batches(data, assume_uniform=assume_uniform)
            if host is None:
                return self.algorithm.client_update(payload, data, state)
            prep = place_prep(host, self.device)
        batches, mask = prep
        self._note_shape(("client", tuple(_leaf_sig(l) for l in
                                          tree.leaves(batches))))
        out_payload, new_state = self._run_one(payload, state, batches, mask)
        return (ClientResult(out_payload, self.algorithm.ops(),
                             weight=float(data.n_samples)), new_state)

    def run_block(self, payload: Dict, datas: Sequence[ClientData],
                  states: Optional[Sequence[Pytree]] = None,
                  preps: Optional[Sequence[Tuple[Any, Any]]] = None
                  ) -> Tuple[Dict[str, Any], Optional[List[Pytree]]]:
        """One vmapped loop over a block of B same-signature clients (the
        caller groups by :func:`batch_signature`).  Returns the stacked
        result payload (leading B axis, ready for
        ``LocalAggregator.fold_block``) and the per-client new states.

        The block is padded to the power-of-two bucket with replicas of the
        first client; padded rows are sliced off before returning."""
        B = len(datas)
        B_pad = _bucket(B)
        if preps is None:
            preps = [place_prep(stack_batches(d, assume_uniform=True),
                                self.device) for d in datas]
        preps = list(preps) + [preps[0]] * (B_pad - B)
        try:
            batches = tree.map(lambda *xs: torch.stack(xs),
                               *[p[0] for p in preps])
            mask = torch.stack([p[1] for p in preps])
        except RuntimeError as e:
            raise ValueError("ragged or mixed-shape client batches cannot "
                             "be blocked; group by batch_signature() first"
                             ) from e
        sstates = None
        if states is not None:
            padded = list(states) + [states[0]] * (B_pad - B)
            sstates = tree.map(lambda *xs: torch.stack(xs), *padded)
        self._note_shape(("block", B_pad, tuple(
            _leaf_sig(l) for l in tree.leaves(batches))))
        if sstates is None:
            out_payload = torch.func.vmap(
                lambda p, b, m: self._run_one(p, None, b, m)[0],
                in_dims=(None, 0, 0))(payload, batches, mask)
            new_states = None
        else:
            out_payload, new_states = torch.func.vmap(
                self._run_one, in_dims=(None, 0, 0, 0))(
                    payload, sstates, batches, mask)
        if B_pad > B:
            out_payload = tree.map(lambda x: x[:B], out_payload)
        if states is None:
            return out_payload, None
        # clone each client's slice: a view would keep (and pickle) the
        # whole block's storage once the state manager holds it
        return out_payload, [tree.map(lambda x: x[i].clone(), new_states)
                             for i in range(B)]


def engine_for(algorithm: FLAlgorithm,
               device: torch.device) -> ClientStepEngine:
    """The algorithm instance's engine for ``device`` (executors sharing
    the algorithm *and* the device share one engine)."""
    cache = getattr(algorithm, "_step_engines", None)
    if cache is None:
        cache = algorithm._step_engines = {}
    eng = cache.get(device)
    if eng is None:
        eng = cache[device] = ClientStepEngine(algorithm, device=device)
    return eng

"""Public wrappers around the port's kernels (port of
``repro/kernels/ops.py``, the aggregation fold part).

A wrapper picks the kernel or its plain version by the device of the tensor
it is given, and by nothing else: a CPU tensor takes the plain PyTorch
version; a CUDA tensor launches the hand-written Hopper kernel or raises.
There is no fallback from a failed build or launch.

Two plain-integer counters stand in for ``agg_dispatch_count``:

* :data:`agg_dispatches` — every call of a fold wrapper, either route;
* :data:`agg_launches` — CUDA kernel launches only, incremented exactly
  where the kernel is launched (``chip_smoke.py`` reads it to show that the
  main path went through the kernel).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.kernels import agg_weighted_sum as _agg

agg_dispatches = 0
agg_launches = 0


def reset_agg_counts() -> None:
    global agg_dispatches, agg_launches
    agg_dispatches = 0
    agg_launches = 0


def _weights(weights) -> list:
    """Host fp32 weights as Python floats (the kernel takes them by value;
    rounding through fp32 keeps the plain version on the same values)."""
    if isinstance(weights, torch.Tensor):
        if weights.device.type != "cpu":
            raise ValueError("fold weights must be host values (a sequence "
                             "of floats or a CPU tensor)")
        return weights.to(torch.float32).tolist()
    return torch.tensor(list(weights), dtype=torch.float32).tolist()


def _check(acc: torch.Tensor, rows, w: list, out: torch.Tensor) -> None:
    C = len(rows)
    if acc.dtype != torch.float32 or acc.dim() != 1 \
            or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous 1-D float32 tensor")
    if out.dtype != torch.float32 or out.shape != acc.shape \
            or not out.is_contiguous() or out.device != acc.device:
        raise ValueError("out must be a contiguous float32 tensor like acc")
    if not 1 <= C <= _agg.MAX_ROWS:
        raise ValueError(f"fold takes 1..{_agg.MAX_ROWS} rows, got {C}")
    if len(w) != C:
        raise ValueError(f"{len(w)} weights for {C} rows")
    dt = rows[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fold rows must be float32 or bfloat16, got {dt}")
    for r in rows:
        if r.dtype != dt or r.shape != acc.shape or not r.is_contiguous() \
                or r.device != acc.device:
            raise ValueError("every row must be a contiguous (n,) tensor of "
                             "one dtype on acc's device")


def agg_weighted_sum(acc: torch.Tensor,
                     deltas: Union[torch.Tensor, Sequence[torch.Tensor]],
                     weights, *, inplace: bool = False) -> torch.Tensor:
    """acc: (n,) fp32; deltas: (C, n) tensor or C (n,) tensors, fp32 or
    bf16; weights: C host floats -> acc + Σ_c w_c·deltas[c] in fp32.

    One call folds C clients, both for the stacked (B, n) block the client
    engine emits (``LocalAggregator.fold_block``) and for B separately
    staged buffers (``agg_fold_batch``).  ``inplace=True`` writes the result
    into ``acc`` (the counterpart of the TPU path's donated accumulator);
    only pass it when no other reference to ``acc`` must keep its value."""
    global agg_dispatches, agg_launches
    agg_dispatches += 1
    w = _weights(weights)
    rows = list(deltas) if not isinstance(deltas, torch.Tensor) \
        else [deltas[c] for c in range(deltas.shape[0])]
    if acc.device.type == "cpu":
        res = _agg.agg_weighted_sum_plain(acc, rows, w)
        if inplace:
            acc.copy_(res)
            return acc
        return res
    if acc.device.type != "cuda":
        raise ValueError(f"no fold kernel for device {acc.device}")
    out = acc if inplace else torch.empty_like(acc)
    _check(acc, rows, w, out)
    _agg.agg_weighted_sum_cuda(acc, rows, w, out)
    agg_launches += 1
    return out


def agg_fold_batch(acc: torch.Tensor, staged: Sequence[torch.Tensor],
                   weights, *, inplace: bool = False) -> torch.Tensor:
    """Fused micro-batch flush: fold B staged (n,) client buffers into the
    fp32 accumulator with ONE kernel launch.  The kernel reads the buffers
    through its pointer array, so they are never stacked."""
    return agg_weighted_sum(acc, list(staged), weights, inplace=inplace)


def agg_fold(acc: torch.Tensor, delta: torch.Tensor,
             weight: float) -> torch.Tensor:
    """Fold a single client delta (any leaf shape) into the fp32
    accumulator, returning a new tensor: the per-leaf C=1 fold, for ad-hoc
    use."""
    flat_acc = acc.reshape(-1).to(torch.float32).contiguous()
    out = agg_weighted_sum(flat_acc, [delta.reshape(-1).contiguous()],
                           [weight])
    return out.reshape(acc.shape)

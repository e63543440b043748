"""Optimizers: client-side SGD(+momentum)/AdamW and server-side federated
optimizers (Reddi et al., 2021 — FedAvgM / FedAdam / FedYogi).  Port of
``repro/optim/optimizers.py``.

Functional style over nested dicts of tensors: ``init(params) -> state``;
``update(grads, state, params) -> (updates, state)``; apply with
:func:`apply_updates`.  The state keeps the JAX package's tree: ``()`` for
plain SGD, the fp32 momentum tree for SGD with momentum, and ``{"m", "v",
"t"}`` for AdamW and its server forms, with ``t`` a Python int.  Every
update is computed in fp32 (bias corrections included) and added to the
parameter in fp32 before the cast back to its dtype.  Server optimizers
treat the aggregated client delta as a pseudo-gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.core import tree

Pytree = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Pytree], Any]
    update: Callable[[Pytree, Any, Pytree], Tuple[Pytree, Any]]


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def apply_updates(params: Pytree, updates: Pytree) -> Pytree:
    return tree.map(lambda p, u: (_f32(p) + u).to(p.dtype), params, updates)


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree.map(_zeros_f32, params)

    def update(grads, state, params):
        if momentum == 0.0:
            return tree.map(lambda g: -lr * _f32(g), grads), state
        new_m = tree.map(lambda m, g: momentum * m + _f32(g), state, grads)
        if nesterov:
            upd = tree.map(lambda m, g: -lr * (momentum * m + _f32(g)),
                           new_m, grads)
        else:
            upd = tree.map(lambda m: -lr * m, new_m)
        return upd, new_m

    return Optimizer(init, update)


def _bias(beta: float, t: int) -> torch.Tensor:
    """``1 - beta ** t`` in fp32 (JAX raises beta to the fp32 step)."""
    return 1 - beta ** torch.tensor(float(t), dtype=torch.float32)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree.map(_zeros_f32, params)
        return {"m": z, "v": tree.map(torch.zeros_like, z), "t": 0}

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree.map(lambda m, g: b1 * m + (1 - b1) * _f32(g),
                     state["m"], grads)
        v = tree.map(lambda v, g: b2 * v + (1 - b2) * torch.square(_f32(g)),
                     state["v"], grads)
        c1, c2 = _bias(b1, t), _bias(b2, t)
        mh = tree.map(lambda m: m / c1, m)
        vh = tree.map(lambda v: v / c2, v)
        upd = tree.map(
            lambda mh, vh, p: -lr * (mh / (torch.sqrt(vh) + eps)
                                     + weight_decay * _f32(p)),
            mh, vh, params)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# server optimizers (pseudo-gradient = aggregated delta)
# ---------------------------------------------------------------------------

class ServerOptimizer:
    """Wraps an Optimizer so FL server updates are ``params ⊕ opt(-delta)``
    (delta is a descent *step*, so the pseudo-gradient is its negation)."""

    def __init__(self, opt: Optimizer):
        self.opt = opt
        self.state = None

    def init(self, params):
        self.state = self.opt.init(params)
        return self.state

    def step(self, params, delta):
        pseudo_grad = tree.map(lambda d: -d, delta)
        upd, self.state = self.opt.update(pseudo_grad, self.state, params)
        return apply_updates(params, upd)


def fedavgm(lr: float = 1.0, momentum: float = 0.9) -> ServerOptimizer:
    return ServerOptimizer(sgd(lr, momentum=momentum))


def fedadam(lr: float = 0.01, b1: float = 0.9, b2: float = 0.99,
            eps: float = 1e-3) -> ServerOptimizer:
    return ServerOptimizer(adamw(lr, b1, b2, eps))


def fedyogi(lr: float = 0.01, b1: float = 0.9, b2: float = 0.99,
            eps: float = 1e-3) -> ServerOptimizer:
    base = adamw(lr, b1, b2, eps)

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree.map(lambda m, g: b1 * m + (1 - b1) * _f32(g),
                     state["m"], grads)
        # yogi: v grows only toward g^2 (sign-controlled)
        v = tree.map(
            lambda v, g: v - (1 - b2) * torch.square(_f32(g))
            * torch.sign(v - torch.square(_f32(g))),
            state["v"], grads)
        upd = tree.map(lambda m, v: -lr * m / (torch.sqrt(torch.abs(v))
                                               + eps), m, v)
        return upd, {"m": m, "v": v, "t": t}

    return ServerOptimizer(Optimizer(base.init, update))

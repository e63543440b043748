"""FL algorithms (paper §5.1): FedAvg, FedProx, FedNova, Mime (stateless);
SCAFFOLD, FedDyn (stateful clients).  Port of ``repro/core/algorithms.py``.

Each algorithm declares OP types for everything it communicates (paper §3.2)
and plugs into the Parrot round engine unchanged.  The algorithms are
generic over the model: they receive a ``grad_fn(params, batch) -> (loss,
grads)`` written in PyTorch (for example :func:`value_and_grad` of a
functional loss) and operate on nested dicts of tensors.

Client batches stay numpy (``data/synthetic.py``), so both packages train on
byte-identical data; each batch becomes tensors on the parameters' device
right before the gradient call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.aggregation import ClientResult, Op
from repro_torch.device import as_tensor

Pytree = Any
GradFn = Callable[[Pytree, Any], Tuple[torch.Tensor, Pytree]]


def value_and_grad(loss_fn: Callable[[Pytree, Any], torch.Tensor]) -> GradFn:
    """``(params, batch) -> (loss, grads)`` from a functional loss (the
    counterpart of ``jax.value_and_grad``; composes with ``torch.func.vmap``
    in the client engine)."""
    gv = torch.func.grad_and_value(loss_fn)

    def fn(params, batch):
        grads, loss = gv(params, batch)
        return loss, grads

    return fn


def tree_add(a, b, scale=1.0):
    return tree.map(lambda x, y: x + scale * y, a, b)


def tree_sub(a, b):
    return tree.map(lambda x, y: x - y, a, b)


def tree_scale(a, s):
    return tree.map(lambda x: x * s, a)


def tree_zeros_like(a):
    return tree.map(torch.zeros_like, a)


def device_of(params: Pytree) -> torch.device:
    """The device of a parameter tree (its first tensor leaf)."""
    for leaf in tree.leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("parameter tree holds no tensor")


def batch_to(batch: Any, device: torch.device) -> Any:
    """A numpy batch as tensors on ``device`` (tensors pass through)."""
    return tree.map(lambda x: as_tensor(x, device)
                    if isinstance(x, np.ndarray) else x, batch)


@dataclass
class ClientData:
    """One client's local data: an iterable of batches (repeated E epochs by
    the algorithm) plus its sample count N_m (the scheduling signal)."""
    batches: List[Any]
    n_samples: int


class FLAlgorithm:
    name: str = "base"
    stateful: bool = False

    def __init__(self, grad_fn: GradFn, lr: float, local_epochs: int = 1,
                 server_lr: float = 1.0, **kw):
        self.grad_fn = grad_fn
        self.lr = lr
        self.local_epochs = local_epochs
        self.server_lr = server_lr

    # --- interface -------------------------------------------------------
    def ops(self) -> Dict[str, Op]:
        raise NotImplementedError

    def broadcast_payload(self, params: Pytree, server_state: Dict) -> Dict:
        """Θ^r — what the server sends to every executor each round."""
        return {"params": params}

    def client_init_state(self, params: Pytree) -> Optional[Pytree]:
        return None

    def client_update(self, payload: Dict, data: ClientData,
                      state: Optional[Pytree]
                      ) -> Tuple[ClientResult, Optional[Pytree]]:
        raise NotImplementedError

    def server_init(self, params: Pytree) -> Dict:
        return {}

    def server_update(self, params: Pytree, agg: Dict, server_state: Dict,
                      n_total_clients: int) -> Tuple[Pytree, Dict]:
        raise NotImplementedError

    # --- shared local-SGD loop --------------------------------------------
    def _local_sgd(self, params0: Pytree, data: ClientData,
                   grad_hook: Optional[Callable] = None) -> Tuple[Pytree, int]:
        """Plain local SGD with an optional per-step gradient correction.
        Returns (final params, number of local steps tau_m)."""
        dev = device_of(params0)
        w = params0
        tau = 0
        for _ in range(self.local_epochs):
            for batch in data.batches:
                _, g = self.grad_fn(w, batch_to(batch, dev))
                if grad_hook is not None:
                    g = grad_hook(w, g)
                w = tree_add(w, g, -self.lr)
                tau += 1
        return w, tau

    # --- pure per-step form (client engine; core/client_step.py) ----------
    #
    # Each algorithm re-expresses its local update as a pure
    # ``(carry, batch, mask) -> carry`` function over an explicit carry tree
    # (params plus whatever the steps read).  ``mask`` is 1.0 for real steps
    # and 0.0 for the padding steps the engine appends to bucket step
    # counts — a masked step multiplies the update by zero, so padding is
    # exact.  The engine loops ``local_step`` over all tau = local_epochs x
    # n_batches steps and ``torch.func.vmap``s the loop over blocks of
    # clients; ``client_update`` above stays as the eager reference path
    # (used by ``run_flat_reference``).

    def init_carry(self, payload: Dict, state: Optional[Pytree]) -> Pytree:
        return {"w": payload["params"]}

    def step_correction(self, carry: Pytree, g: Pytree) -> Pytree:
        """Per-step gradient correction (the pure analogue of grad_hook)."""
        return g

    def local_step(self, carry: Pytree, batch: Any,
                   mask: torch.Tensor) -> Pytree:
        _, g = self.grad_fn(carry["w"], batch)
        g = self.step_correction(carry, g)
        # mask is cast to each leaf's dtype (0/1 are exact in any float
        # dtype): an f32 mask would promote a bf16 carry
        w = tree.map(lambda ww, gg: ww - self.lr * mask.to(ww.dtype) * gg,
                     carry["w"], g)
        return dict(carry, w=w)

    def finalize(self, carry: Pytree, payload: Dict, state: Optional[Pytree],
                 batches: Any, mask: torch.Tensor
                 ) -> Tuple[Dict[str, Any], Optional[Pytree]]:
        """(result payload, new client state) from the final carry — pure;
        the aggregation weight is applied by the caller."""
        raise NotImplementedError

    def _tau(self, mask: torch.Tensor) -> torch.Tensor:
        """Real local-step count tau_m = E x n_batches (mask sums the
        un-padded batches), floored at 1 like the eager ``max(tau, 1)``."""
        return torch.clamp(self.local_epochs * mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Stateless algorithms
# ---------------------------------------------------------------------------

class FedAvg(FLAlgorithm):
    name = "fedavg"

    def ops(self):
        return {"delta": Op.WEIGHTED_AVG}

    def client_update(self, payload, data, state):
        w, tau = self._local_sgd(payload["params"], data)
        delta = tree_sub(w, payload["params"])
        return ClientResult({"delta": delta}, self.ops(),
                            weight=float(data.n_samples)), None

    def server_update(self, params, agg, server_state, n_total_clients):
        return tree_add(params, agg["delta"], self.server_lr), server_state

    def finalize(self, carry, payload, state, batches, mask):
        return {"delta": tree_sub(carry["w"], payload["params"])}, None


class FedProx(FedAvg):
    name = "fedprox"

    def __init__(self, *a, mu: float = 0.01, **kw):
        super().__init__(*a, **kw)
        self.mu = mu

    def client_update(self, payload, data, state):
        anchor = payload["params"]

        def hook(w, g):  # g + mu * (w - w_global)
            return tree.map(lambda gg, ww, aa: gg + self.mu * (ww - aa),
                            g, w, anchor)

        w, tau = self._local_sgd(anchor, data, hook)
        delta = tree_sub(w, anchor)
        return ClientResult({"delta": delta}, self.ops(),
                            weight=float(data.n_samples)), None

    def init_carry(self, payload, state):
        return {"w": payload["params"], "anchor": payload["params"]}

    def step_correction(self, carry, g):  # g + mu * (w - w_global)
        return tree.map(lambda gg, ww, aa: gg + self.mu * (ww - aa),
                        g, carry["w"], carry["anchor"])


class FedNova(FLAlgorithm):
    """Normalised averaging (Wang et al., 2020): clients return the
    step-normalised delta plus an aggregation weight tau."""
    name = "fednova"

    def ops(self):
        return {"norm_delta": Op.WEIGHTED_AVG, "tau": Op.WEIGHTED_AVG}

    def client_update(self, payload, data, state):
        w, tau = self._local_sgd(payload["params"], data)
        delta = tree_sub(w, payload["params"])
        norm_delta = tree_scale(delta, 1.0 / max(tau, 1))
        return ClientResult(
            {"norm_delta": norm_delta,
             "tau": torch.tensor(float(tau), dtype=torch.float32,
                                 device=device_of(w))},
            self.ops(), weight=float(data.n_samples)), None

    def server_update(self, params, agg, server_state, n_total_clients):
        tau_eff = agg["tau"]
        new = tree_add(params, tree_scale(agg["norm_delta"], tau_eff),
                       self.server_lr)
        return new, server_state

    def finalize(self, carry, payload, state, batches, mask):
        tau = self._tau(mask)     # f32: cast back to the leaf dtype
        delta = tree_sub(carry["w"], payload["params"])
        return {"norm_delta": tree.map(lambda d: (d / tau).to(d.dtype),
                                       delta),
                "tau": tau.to(torch.float32)}, None


class Mime(FLAlgorithm):
    """Mime (Karimireddy et al., 2020a): the server momentum is broadcast and
    applied — but not updated — during local steps; clients additionally
    return a full-batch gradient at the *global* params, a Special Param
    (collected, not averaged)."""
    name = "mime"

    def __init__(self, *a, beta: float = 0.9, **kw):
        super().__init__(*a, **kw)
        self.beta = beta

    def ops(self):
        return {"delta": Op.WEIGHTED_AVG, "full_grad": Op.COLLECT}

    def broadcast_payload(self, params, server_state):
        return {"params": params, "momentum": server_state["momentum"]}

    def server_init(self, params):
        return {"momentum": tree_zeros_like(params)}

    def client_update(self, payload, data, state):
        mom = payload["momentum"]

        def hook(w, g):  # momentum-corrected step, momentum frozen locally
            return tree.map(
                lambda gg, mm: (1 - self.beta) * gg + self.beta * mm, g, mom)

        w, tau = self._local_sgd(payload["params"], data, hook)
        # full-batch gradient at the global params (server momentum update)
        dev = device_of(payload["params"])
        gs = None
        n = 0
        for batch in data.batches:
            _, g = self.grad_fn(payload["params"], batch_to(batch, dev))
            gs = g if gs is None else tree_add(gs, g)
            n += 1
        full_grad = tree_scale(gs, 1.0 / max(n, 1))
        delta = tree_sub(w, payload["params"])
        return ClientResult({"delta": delta, "full_grad": full_grad},
                            self.ops(), weight=float(data.n_samples)), None

    def server_update(self, params, agg, server_state, n_total_clients):
        grads = agg["full_grad"]                  # list of (weight, tree)
        dev = device_of(params)
        ws = torch.tensor([w for w, _ in grads], dtype=torch.float32,
                          device=dev)
        ws = ws / torch.clamp(ws.sum(), min=1e-12)
        gavg = tree.map(
            lambda *leaves: torch.tensordot(
                ws, torch.stack([x.to(dev) for x in leaves]), dims=1),
            *[g for _, g in grads])
        # cast back to the momentum dtype: the f32 tensordot must not
        # promote a bf16 momentum
        mom = tree.map(
            lambda m, g: (self.beta * m + (1 - self.beta) * g).to(m.dtype),
            server_state["momentum"], gavg)
        new = tree_add(params, agg["delta"], self.server_lr)
        return new, {"momentum": mom}

    def init_carry(self, payload, state):
        return {"w": payload["params"], "momentum": payload["momentum"]}

    def step_correction(self, carry, g):  # momentum frozen locally
        return tree.map(lambda gg, mm: (1 - self.beta) * gg + self.beta * mm,
                        g, carry["momentum"])

    def finalize(self, carry, payload, state, batches, mask):
        params0 = payload["params"]
        gsum = tree_zeros_like(params0)
        for t in range(mask.shape[0]):   # full-batch gradient at params0
            _, g = self.grad_fn(params0, tree.map(lambda x: x[t], batches))
            m = mask[t]
            gsum = tree.map(lambda s, gg: s + m.to(s.dtype) * gg, gsum, g)
        n = torch.clamp(mask.sum(), min=1.0)
        full_grad = tree.map(lambda s: (s / n).to(s.dtype), gsum)
        return {"delta": tree_sub(carry["w"], params0),
                "full_grad": full_grad}, None


# ---------------------------------------------------------------------------
# Stateful algorithms
# ---------------------------------------------------------------------------

class Scaffold(FLAlgorithm):
    """SCAFFOLD (Karimireddy et al., 2020b): client control variates c_m are
    client state held by the state manager; the server variate c is
    broadcast."""
    name = "scaffold"
    stateful = True

    def ops(self):
        return {"delta": Op.WEIGHTED_AVG, "delta_c": Op.AVG}

    def broadcast_payload(self, params, server_state):
        return {"params": params, "c": server_state["c"]}

    def server_init(self, params):
        return {"c": tree_zeros_like(params)}

    def client_init_state(self, params):
        return {"c_m": tree_zeros_like(params)}

    def client_update(self, payload, data, state):
        c, c_m = payload["c"], state["c_m"]

        def hook(w, g):  # g - c_m + c
            return tree.map(lambda gg, cm, cc: gg - cm + cc, g, c_m, c)

        anchor = payload["params"]
        w, tau = self._local_sgd(anchor, data, hook)
        # option II update of the client variate
        c_m_new = tree.map(
            lambda cm, cc, aa, ww: cm - cc + (aa - ww) / (tau * self.lr),
            c_m, c, anchor, w)
        delta = tree_sub(w, anchor)
        delta_c = tree_sub(c_m_new, c_m)
        return ClientResult({"delta": delta, "delta_c": delta_c}, self.ops(),
                            weight=float(data.n_samples)), {"c_m": c_m_new}

    def server_update(self, params, agg, server_state, n_total_clients):
        new = tree_add(params, agg["delta"], self.server_lr)
        # c += (M_p / M) * avg(delta_c); M_p folded in by the AVG op count
        frac = agg.get("_n_selected", 0) / max(n_total_clients, 1)
        c = tree_add(server_state["c"], agg["delta_c"], frac)
        return new, {"c": c}

    def init_carry(self, payload, state):
        return {"w": payload["params"], "c": payload["c"],
                "c_m": state["c_m"]}

    def step_correction(self, carry, g):  # g - c_m + c
        return tree.map(lambda gg, cm, cc: gg - cm + cc,
                        g, carry["c_m"], carry["c"])

    def finalize(self, carry, payload, state, batches, mask):
        anchor, w = payload["params"], carry["w"]
        c, c_m = carry["c"], carry["c_m"]
        tau = self._tau(mask)     # f32: cast back to the leaf dtype
        c_m_new = tree.map(
            lambda cm, cc, aa, ww:
                (cm - cc + (aa - ww) / (tau * self.lr)).to(cm.dtype),
            c_m, c, anchor, w)
        return ({"delta": tree_sub(w, anchor),
                 "delta_c": tree_sub(c_m_new, c_m)}, {"c_m": c_m_new})


class FedDyn(FLAlgorithm):
    """FedDyn (Acar et al., 2021): clients keep the gradient of their local
    regularised objective as state; the server keeps a drift corrector h."""
    name = "feddyn"
    stateful = True

    def __init__(self, *a, alpha: float = 0.1, **kw):
        super().__init__(*a, **kw)
        self.alpha = alpha

    def ops(self):
        return {"delta": Op.WEIGHTED_AVG}

    def server_init(self, params):
        return {"h": tree_zeros_like(params)}

    def client_init_state(self, params):
        return {"grad_corr": tree_zeros_like(params)}

    def client_update(self, payload, data, state):
        anchor = payload["params"]
        gc = state["grad_corr"]

        def hook(w, g):  # g + alpha * (w - anchor) - grad_corr
            return tree.map(
                lambda gg, ww, aa, hh: gg + self.alpha * (ww - aa) - hh,
                g, w, anchor, gc)

        w, tau = self._local_sgd(anchor, data, hook)
        gc_new = tree.map(lambda hh, ww, aa: hh - self.alpha * (ww - aa),
                          gc, w, anchor)
        delta = tree_sub(w, anchor)
        return ClientResult({"delta": delta}, self.ops(),
                            weight=float(data.n_samples)), {"grad_corr": gc_new}

    def server_update(self, params, agg, server_state, n_total_clients):
        # h^{r+1} = h^r - alpha * frac * delta_avg;
        # theta^{r+1} = theta^r + delta_avg * (1 + frac)   (telescoped form)
        frac = agg.get("_n_selected", 0) / max(n_total_clients, 1)
        h = tree_add(server_state["h"], agg["delta"], -self.alpha * frac)
        new = tree_add(params, agg["delta"], self.server_lr * (1.0 + frac))
        return new, {"h": h}

    def init_carry(self, payload, state):
        return {"w": payload["params"], "anchor": payload["params"],
                "grad_corr": state["grad_corr"]}

    def step_correction(self, carry, g):  # g + alpha * (w - anchor) - h
        return tree.map(
            lambda gg, ww, aa, hh: gg + self.alpha * (ww - aa) - hh,
            g, carry["w"], carry["anchor"], carry["grad_corr"])

    def finalize(self, carry, payload, state, batches, mask):
        anchor, w = payload["params"], carry["w"]
        gc_new = tree.map(lambda hh, ww, aa: hh - self.alpha * (ww - aa),
                          state["grad_corr"], w, anchor)
        return {"delta": tree_sub(w, anchor)}, {"grad_corr": gc_new}


ALGORITHMS = {
    "fedavg": FedAvg,
    "fedprox": FedProx,
    "fednova": FedNova,
    "mime": Mime,
    "scaffold": Scaffold,
    "feddyn": FedDyn,
}


def make_algorithm(name: str, grad_fn: GradFn, lr: float, **kw) -> FLAlgorithm:
    return ALGORITHMS[name](grad_fn, lr, **kw)

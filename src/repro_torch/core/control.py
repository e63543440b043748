"""Adaptive control plane: self-tuning scheduler knobs (DESIGN.md §12).
Port of ``repro/core/control.py``: host floats only, in the JAX package's
expression order, so every controller trajectory equals the JAX package's
to the bit.

The engines run on fixed knobs — a constant async ``staleness_lambda``, a
constant semi-sync ``deadline_frac``, comm serialized into every span — and
the scheduler only reacts to heterogeneity through the fitted workload
models.  A :class:`ControlPlane` attached to the server
(``ParrotServer(control=...)``) closes the loop:

* :class:`AsyncLambdaController` — instead of a fixed λ, target an
  *effective trust* for stale folds: pick λ so the bounded-staleness weight
  γ = 1/(1+λ·s̄) equals ``target_gamma`` at the EWMA of the observed
  per-window mean staleness.  Updated once per server commit.
* :class:`DeadlineController` — tune semi-sync ``deadline_frac`` from the
  observed landed/selected ratio: folding more of the selection than the
  target quantile means the deadline is looser than it needs to be
  (multiplicative tighten); folding less means carry churn (loosen).
* Boolean levers consumed by the engines: ``window_fit`` (selection skips
  clients whose availability window can't fit their predicted span + comm),
  ``overlap_comm`` (payload downloads overlap earlier compute instead of
  serializing into each span), ``gang_waves`` (semi-sync/async dispatch
  aligned chunk waves as one client-step dispatch via
  ``executor.run_queues_ganged``: on one card, one ``(K·B, …)`` vmap a
  wave) and ``rebalance`` (async re-packs undispatched queues at each
  commit via ``scheduler.rebalance_queues``, or the placement's
  ``rebalance``; semi-sync steals the predicted straggler's queue tail into
  a drained lane via ``scheduler.pick_steal_victim`` — stolen chunks still
  face the deadline check, and the round reports
  ``extra["rebalanced_tasks"]``).

Any non-None control plane also turns on oracle tracking: every engine
collects its realized (n_samples, time, executor, comm) jobs and reports
``extra["oracle_makespan"]`` — the hindsight-optimal LPT schedule of the
work that actually folded (``scheduler.oracle_makespan``).

``ControlPlane.observer()`` is the measurement-only mode: oracle tracking
on, every controller and lever off — behaviour (params AND makespan
history) is bit-identical to ``control=None``.  Controller state is plain
data and rides the checkpoint blob (``checkpoint/manager.py`` key
``"control"``) so a resumed run replays the same λ / deadline trajectory
bit-exactly.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional


def _ewma(prev: Optional[float], x: float, alpha: float) -> float:
    return x if prev is None else (1.0 - alpha) * prev + alpha * x


class AsyncLambdaController:
    """γ-targeting λ: λ = (1/target_gamma − 1) / EWMA(mean staleness).

    ``current(fallback)`` returns the λ the engine should fold with (the
    engine's static ``staleness_lambda`` until the first update);
    ``update(mean_staleness)`` runs once per server commit with the closed
    window's mean observed staleness.  Clipped to ``[lam_min, lam_max]``
    (at s̄ → 0 any λ gives γ → 1, so the clip is inert where it binds).
    """

    def __init__(self, target_gamma: float = 0.6, alpha: float = 0.3,
                 lam_min: float = 0.05, lam_max: float = 4.0):
        if not (0.0 < target_gamma < 1.0):
            raise ValueError("target_gamma must be in (0, 1)")
        self.target_gamma = float(target_gamma)
        self.alpha = float(alpha)
        self.lam_min = float(lam_min)
        self.lam_max = float(lam_max)
        self.value: Optional[float] = None
        self._ewma: Optional[float] = None

    def current(self, fallback: float) -> float:
        return fallback if self.value is None else self.value

    def update(self, mean_staleness: float) -> float:
        self._ewma = _ewma(self._ewma, float(mean_staleness), self.alpha)
        s = max(self._ewma, 1e-6)
        lam = (1.0 / self.target_gamma - 1.0) / s
        self.value = min(max(lam, self.lam_min), self.lam_max)
        return self.value

    def state_dict(self) -> Dict[str, Any]:
        return {"value": self.value, "ewma": self._ewma}

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        if not state:
            return
        self.value = state.get("value")
        self._ewma = state.get("ewma")


class DeadlineController:
    """Semi-sync ``deadline_frac`` from the observed landed/selected ratio.

    ``target_ratio=None`` targets ``1/over_select`` (fold exactly the
    nominal cohort's weight, let the over-selected slack absorb the tail) —
    the engine passes that default per update.  The frac moves
    multiplicatively, ``frac ·= exp(−gain · (EWMA(ratio) − target))``,
    clipped to ``[frac_min, frac_max]``: folding above target tightens the
    deadline, folding below loosens it.
    """

    def __init__(self, target_ratio: Optional[float] = None,
                 gain: float = 0.6, alpha: float = 0.4,
                 frac_min: float = 0.3, frac_max: float = 1.0):
        self.target_ratio = None if target_ratio is None \
            else float(target_ratio)
        self.gain = float(gain)
        self.alpha = float(alpha)
        self.frac_min = float(frac_min)
        self.frac_max = float(frac_max)
        self.value: Optional[float] = None
        self._ewma: Optional[float] = None

    def current(self, fallback: float) -> float:
        return fallback if self.value is None else self.value

    def update(self, landed: int, selected: int, fallback_frac: float,
               default_target: float) -> float:
        if selected <= 0:
            return self.current(fallback_frac)
        target = self.target_ratio if self.target_ratio is not None \
            else float(default_target)
        self._ewma = _ewma(self._ewma, landed / selected, self.alpha)
        if self.value is None:
            self.value = float(fallback_frac)
        err = self._ewma - target
        self.value = min(max(self.value * math.exp(-self.gain * err),
                             self.frac_min), self.frac_max)
        return self.value

    def state_dict(self) -> Dict[str, Any]:
        return {"value": self.value, "ewma": self._ewma}

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        if not state:
            return
        self.value = state.get("value")
        self._ewma = state.get("ewma")


class ControlPlane:
    """The knob bundle the engines consult (``getattr(srv, "control")``).

    Everything defaults off; a bare ``ControlPlane()`` (== ``observer()``)
    only enables oracle tracking and is behaviour-identical to
    ``control=None``.  ``adaptive()`` turns the full control plane on.
    """

    def __init__(self, *,
                 async_lambda: Optional[AsyncLambdaController] = None,
                 deadline: Optional[DeadlineController] = None,
                 window_fit: bool = False,
                 overlap_comm: bool = False,
                 gang_waves: bool = False,
                 rebalance: bool = False):
        self.async_lambda = async_lambda
        self.deadline = deadline
        self.window_fit = bool(window_fit)
        self.overlap_comm = bool(overlap_comm)
        self.gang_waves = bool(gang_waves)
        self.rebalance = bool(rebalance)
        # wired by ParrotServer when telemetry is attached (DESIGN.md §13):
        # controller moves land on the "control" lane via note(); pure
        # recording, never consulted for behaviour and not checkpointed
        # here (the Telemetry bundle owns its own state)
        self.telemetry: Optional[Any] = None

    def note(self, name: str, value: float, t: float) -> None:
        """Record one controller move (an instant on the ``control`` lane
        plus a ``control/<name>`` gauge).  No-op without telemetry."""
        if self.telemetry is not None:
            self.telemetry.control_event(name, value, t)

    @classmethod
    def observer(cls) -> "ControlPlane":
        """Oracle tracking only — bit-identical behaviour to control=None
        (the benchmarks' baseline cells, so both sides report a gap)."""
        return cls()

    @classmethod
    def adaptive(cls, *, target_gamma: float = 0.6,
                 target_ratio: Optional[float] = None,
                 window_fit: bool = True, overlap_comm: bool = True,
                 gang_waves: bool = True,
                 rebalance: bool = True) -> "ControlPlane":
        """Every controller and lever on (the benchmarks' adaptive cells)."""
        return cls(async_lambda=AsyncLambdaController(target_gamma),
                   deadline=DeadlineController(target_ratio),
                   window_fit=window_fit, overlap_comm=overlap_comm,
                   gang_waves=gang_waves, rebalance=rebalance)

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "async_lambda": (self.async_lambda.state_dict()
                             if self.async_lambda is not None else None),
            "deadline": (self.deadline.state_dict()
                         if self.deadline is not None else None),
        }

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        if not state:
            return
        if self.async_lambda is not None:
            self.async_lambda.load_state_dict(state.get("async_lambda"))
        if self.deadline is not None:
            self.deadline.load_state_dict(state.get("deadline"))

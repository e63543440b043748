"""Parrot server — Algorithm 2 (``Server_Executes``) on the BSP round
engine.  Port of ``repro/core/round.py``.

One ``ParrotServer`` owns the FL algorithm, the heterogeneity-aware
scheduler + workload estimator, K sequential executors, the client state
managers and a Communicator.  A round: select clients → Task_Schedule
(Alg. 3) → broadcast Θ^r + queues → Device_Executes on each executor →
collect K partials (one trip each) → GlobalAggregate → server update.
Round time is ``max_k Σ_{m∈M_k} T̂_{m,k}`` — the makespan the scheduler
minimises.

Executor failures mid-round re-run the dead executor's remaining work on
the survivors and K shrinks for subsequent rounds (elastic membership).

Knobs of later slices raise ``NotImplementedError`` naming their ROADMAP
item rather than being ignored.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.comm.base import Communicator
from repro_torch.comm.local import LocalComm
from repro_torch.core import tree
from repro_torch.core.aggregation import (flat_aggregate, global_aggregate,
                                          is_flat_partial,
                                          tree_reduce_partials)
from repro_torch.core.algorithms import ClientData, FLAlgorithm
from repro_torch.core.engine import make_engine
from repro_torch.core.executor import SequentialExecutor
from repro_torch.core.population import ClientPopulation, as_population
from repro_torch.core.scheduler import ClientTask, ParrotScheduler, Schedule
from repro_torch.core.workload import WorkloadEstimator
from repro_torch.device import resolve_device

# knob -> the ROADMAP.md item (modules queue) that ports it
_LATER_KNOBS = {
    "compressor": "item 12 (compression)",
    "checkpoint_manager": "item 11 (checkpoints)",
    "network": "item 13 (network and faults)",
    "availability": "item 13 (network and faults)",
    "faults": "item 13 (network and faults)",
    "retry": "item 13 (network and faults)",
    "placement": "item 15 (placement and gang dispatch)",
    "parallel_dispatch": "item 15 (placement and gang dispatch)",
    "control": "item 16 (control and telemetry)",
    "telemetry": "item 16 (control and telemetry)",
}


@dataclass
class RoundMetrics:
    round: int
    makespan: float               # BSP round time (max executor virtual time)
    wall_time: float
    schedule_time: float
    estimate_time: float
    predicted_makespan: float
    comm_bytes: int
    comm_trips: int
    n_clients: int
    n_executors: int
    estimation_error: float = float("nan")
    failures: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


class ParrotServer:
    def __init__(self, *, params: Any, algorithm: FLAlgorithm,
                 executors: Sequence[SequentialExecutor],
                 data_by_client: Dict[int, ClientData],
                 clients_per_round: int,
                 scheduler_policy: str = "parrot",
                 time_window: int = 0,
                 warmup_rounds: int = 1,
                 comm: Optional[Communicator] = None,
                 overlap_scheduling: bool = False,
                 backup_fraction: float = 0.0,
                 round_engine: str = "bsp",
                 engine_opts: Optional[Dict[str, Any]] = None,
                 fold_fan_in: int = 16,
                 seed: int = 0,
                 device: Optional[Any] = None,
                 **later_knobs: Any):
        for knob, val in later_knobs.items():
            if knob not in _LATER_KNOBS:
                raise TypeError(f"unexpected keyword argument {knob!r}")
            if val:
                raise NotImplementedError(
                    f"{knob} is not ported yet (ROADMAP.md, modules queue "
                    f"{_LATER_KNOBS[knob]})")
        self.device = resolve_device(device)
        self.params = tree.map(lambda t: t.to(self.device), params)
        self.algorithm = algorithm
        self.executors: Dict[int, SequentialExecutor] = {e.id: e for e in executors}
        self.population: ClientPopulation = as_population(data_by_client)
        self.data_by_client = self.population
        self.clients_per_round = clients_per_round
        # partial lists wider than this fold through a fan-in tree of
        # merge_partials levels (server buffers stay O(fan_in), not O(K));
        # 0 disables the tree
        self.fold_fan_in = int(fold_fan_in)
        # previous cumulative state-manager counters (per-round deltas for
        # RoundMetrics.extra["state_manager"])
        self._sm_stats_prev: Dict[str, float] = {}
        self.estimator = WorkloadEstimator(time_window=time_window)
        self.scheduler = ParrotScheduler(self.estimator,
                                         warmup_rounds=warmup_rounds,
                                         policy=scheduler_policy)
        self.comm = comm or LocalComm()
        # cumulative simulated time across rounds
        self.virtual_now = 0.0
        self.overlap_scheduling = overlap_scheduling
        self.backup_fraction = backup_fraction
        self._next_tasks: Optional[List[ClientTask]] = None
        self.server_state = algorithm.server_init(self.params)
        self.rng = np.random.default_rng(seed)
        self.round = 0
        self.history: List[RoundMetrics] = []
        self._pending_schedule: Optional[Schedule] = None
        self.engine = make_engine(round_engine, **(engine_opts or {}))

    # ------------------------------------------------------------------
    def select_clients(self, n: Optional[int] = None,
                       exclude: Optional[Any] = None) -> List[ClientTask]:
        """Sample the round's cohort without replacement (rng-identical to
        the JAX package).  ``n`` overrides ``clients_per_round``;
        ``exclude`` removes clients already in flight."""
        ids = self.population.sample(
            self.rng, self.clients_per_round if n is None else n,
            exclude=exclude)
        n_of = self.population.n_samples
        return [ClientTask(c, n_of(c)) for c in ids]

    # ------------------------------------------------------------------
    def _plan_backups(self, schedule: Schedule
                      ) -> Tuple[Dict[int, Set[int]], int]:
        """Speculative backup tasks (tail mitigation): duplicate the tail of
        the predicted-slowest queue onto the predicted-fastest executor and
        tell the slow executor to skip those clients — each client still
        folds exactly once."""
        if self.backup_fraction <= 0 or len(self.executors) < 2:
            return {}, 0
        models = self.estimator.last_fit

        def load(k: int) -> float:
            m = models.get(k)
            q = schedule.queue(k)
            if m is not None:
                return sum(m.predict(t.n_samples) for t in q)
            return float(sum(t.n_samples for t in q))

        ks = list(self.executors)
        slow = max(ks, key=load)
        fast = min(ks, key=load)
        queue = schedule.queue(slow)
        if slow == fast or not queue:
            return {}, 0
        n = min(len(queue), max(1, int(round(self.backup_fraction
                                             * len(queue)))))
        tail = queue[-n:]
        schedule.assignment.setdefault(fast, []).extend(tail)
        return {slow: {t.client for t in tail}}, len(tail)

    def global_fold(self, partials: List[Dict]) -> Dict[str, Any]:
        """``GlobalAggregate``: partial lists wider than ``fold_fan_in``
        first reduce through the hierarchical fan-in tree; at or below the
        fan-in this is the flat left-fold."""
        ops = self.algorithm.ops()
        if (self.fold_fan_in > 1 and len(partials) > self.fold_fan_in
                and all(is_flat_partial(p) for p in partials)):
            partials = tree_reduce_partials(partials, self.fold_fan_in)
        return global_aggregate(partials, ops)

    def _state_manager_extra(self) -> Optional[Dict[str, Any]]:
        """Per-round client-state cache observability: cumulative counters
        (deduped across executors sharing one manager) diffed against the
        previous round, plus the current tier byte gauges."""
        managers = {}
        for ex in self.executors.values():
            sm = getattr(ex, "state_manager", None)
            if sm is not None and hasattr(sm, "stats_snapshot"):
                managers[id(sm)] = sm
        if not managers or not self.algorithm.stateful:
            return None
        total: Dict[str, float] = {}
        for sm in managers.values():
            for key, val in sm.stats_snapshot().items():
                total[key] = total.get(key, 0) + val
        out: Dict[str, float] = {}
        for key, val in total.items():
            if key.endswith("_bytes"):
                out[key] = val                               # gauge
            else:
                out[key] = val - self._sm_stats_prev.get(key, 0)
        self._sm_stats_prev = total
        return out

    def _drop_executor(self, k: int) -> None:
        """Elastic K shrink: drop a dead executor."""
        self.executors.pop(k, None)

    # ------------------------------------------------------------------
    def run_round(self) -> RoundMetrics:
        """One BSP server round (see ``core/engine.py``)."""
        return self.engine.run_round(self)

    def run(self, n_rounds: int) -> List[RoundMetrics]:
        return [self.run_round() for _ in range(n_rounds)]


def run_flat_reference(params, algorithm: FLAlgorithm,
                       data_by_client: Dict[int, ClientData],
                       clients_per_round: int, n_rounds: int, seed: int = 0,
                       state_store: Optional[Dict[int, Any]] = None):
    """Single-process original-FL reference (SP scheme): the ground truth the
    hierarchical scheme must match.  Runs on the device ``params`` live on."""
    rng = np.random.default_rng(seed)
    server_state = algorithm.server_init(params)
    state_store = {} if state_store is None else state_store
    for rnd in range(n_rounds):
        ids = rng.choice(sorted(data_by_client),
                         size=min(clients_per_round, len(data_by_client)),
                         replace=False)
        results = []
        for c in ids:
            c = int(c)
            state = state_store.get(c)
            if algorithm.stateful and state is None:
                state = algorithm.client_init_state(params)
            payload = algorithm.broadcast_payload(params, server_state)
            res, new_state = algorithm.client_update(
                payload, data_by_client[c], state)
            if algorithm.stateful and new_state is not None:
                state_store[c] = new_state
            results.append(res)
        agg = flat_aggregate(results, algorithm.ops())
        agg["_n_selected"] = len(results)
        params, server_state = algorithm.server_update(
            params, agg, server_state, len(data_by_client))
    return params, server_state

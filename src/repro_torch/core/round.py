"""Parrot server — Algorithm 2 (``Server_Executes``) on a pluggable round
engine (BSP, semi-sync or async; ``core/engine.py``).  Port of
``repro/core/round.py``.

One ``ParrotServer`` owns the FL algorithm, the heterogeneity-aware
scheduler + workload estimator, K sequential executors, the client state
managers and a Communicator.  A round: select clients → Task_Schedule
(Alg. 3) → broadcast Θ^r + queues → Device_Executes on each executor →
collect K partials (one trip each) → GlobalAggregate → server update.
Round time is ``max_k Σ_{m∈M_k} T̂_{m,k}`` — the makespan the scheduler
minimises.

Executor failures mid-round re-run the dead executor's remaining work on
the survivors and K shrinks for subsequent rounds (elastic membership).
A ``compressor`` (an object, or "topk" / "int8" / "powersgd") shrinks each
partial before it crosses the comm layer (``core/compression.py``).  A
``network`` prices uploads and downloads on the virtual clock at the
partials' achieved wire size, an ``availability`` model filters offline
clients, and a ``faults`` plan with its ``retry`` policy injects crashes,
restarts, dropouts, corrupt payloads, blackouts and slowdowns
(``core/network.py``, ``core/faults.py``, DESIGN.md §9–§10).

A ``placement`` (``core/placement.py``, DESIGN.md §8) pins the executors
to devices, routes the global fold through its rank-ordered reduce on the
fold kernel, and lets a BSP round gang its aligned block waves
(``gang_dispatch``); ``parallel_dispatch`` runs the BSP executors in
threads instead, each on its own CUDA stream.  Unlike the JAX package, no
placement is derived from the executors' pins: every port executor carries
a device, so a derived placement would gang every run.

A ``control`` plane (``core/control.py``, DESIGN.md §12) tunes the async
λ and the semi-sync deadline from what each round observed, filters the
selection by availability-window fit, overlaps downloads with earlier
compute, gangs the DES engines' aligned chunk waves and rebalances queues;
any control plane reports the hindsight ``oracle_makespan``.
``telemetry`` (``core/telemetry.py``, DESIGN.md §13; ``True`` builds a
``Telemetry()``) records every executor's busy and upload spans, the
engines', faults' and controllers' instants and a metrics registry on the
virtual axis, and attaches each round's per-executor utilization to
``metrics.extra["utilization"]``.  Neither changes a param or a makespan
unless a lever is on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import math
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.comm.base import Communicator
from repro_torch.comm.local import LocalComm
from repro_torch.core import tree
from repro_torch.core.aggregation import (flat_aggregate, global_aggregate,
                                          is_flat_partial,
                                          tree_reduce_partials)
from repro_torch.core.algorithms import ClientData, FLAlgorithm
from repro_torch.core.compression import make_compressor
from repro_torch.core.control import ControlPlane
from repro_torch.core.engine import make_engine
from repro_torch.core.executor import SequentialExecutor
from repro_torch.core.faults import FaultInjector, FaultPlan, RetryPolicy
from repro_torch.core.network import ClientAvailability, NetworkModel
from repro_torch.core.placement import DevicePlacement
from repro_torch.core.population import ClientPopulation, as_population
from repro_torch.core.scheduler import ClientTask, ParrotScheduler, Schedule
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.workload import WorkloadEstimator, fleet_average
from repro_torch.device import resolve_device


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
                 compressor: Optional[Any] = None,
                 mode: str = "parrot",
                 placement: Optional[DevicePlacement] = None,
                 gang_dispatch: bool = True,
                 parallel_dispatch: bool = False,
                 seed: int = 0,
                 device: Optional[Any] = None,
                 checkpoint_manager: Optional[Any] = None,
                 network: Optional[NetworkModel] = None,
                 availability: Optional[ClientAvailability] = None,
                 faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None,
                 control: Optional[ControlPlane] = None,
                 telemetry: Optional[Any] = None):
        self.device = resolve_device(device)
        self.params = tree.map(lambda t: t.to(self.device), params)
        self.algorithm = algorithm
        self.executors: Dict[int, SequentialExecutor] = {e.id: e for e in executors}
        # device placement (DESIGN.md §8): pins the executors here; the
        # aggregate lands on its server device, which must be the server's
        if placement is not None:
            if placement.server_device != self.device:
                raise ValueError(
                    f"the placement folds onto {placement.server_device} "
                    f"but the server runs on {self.device}")
            placement.assign(executors)
        self.placement = placement
        # dead executors parked for a restart or a restore to revive
        self._retired: Dict[int, SequentialExecutor] = {}
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
        if isinstance(compressor, str):
            # compressor="topk"/"int8"/"powersgd" builds the compiled default
            compressor = make_compressor(compressor)
        self.compressor = compressor
        self.mode = mode
        # gang dispatch of gangable BSP rounds (a no-op without a
        # placement; see engine.BSPEngine._dispatch)
        self.gang_dispatch = bool(gang_dispatch)
        if parallel_dispatch and any(
                ex.nonblocking and ex.device.type == "cuda"
                for ex in executors):
            # each thread runs on its own stream: a block left in flight
            # could read client state another stream has freed
            raise ValueError("parallel_dispatch needs nonblocking=False "
                             "executors on CUDA devices")
        self.parallel_dispatch = bool(parallel_dispatch)
        # trace-driven network & availability simulation (DESIGN.md §9):
        # None for both keeps every engine on its comm-free code path
        self.network = network
        self.availability = availability
        # fault injection (DESIGN.md §10): None keeps every engine on its
        # fault-free code path; an empty plan behaves identically to None
        self.faults: Optional[FaultInjector] = (
            FaultInjector(faults, retry) if faults is not None
            or retry is not None else None)
        # adaptive control plane (DESIGN.md §12): None keeps every engine
        # on its control-free path; ControlPlane.observer() only adds the
        # oracle keys and behaves as None does
        self.control = control
        # virtual-time telemetry (DESIGN.md §13): None is consulted nowhere;
        # True builds a default bundle.  The one object is shared with the
        # fault injector and the control plane so their events land on the
        # common lanes
        if telemetry is True:
            telemetry = Telemetry()
        self.telemetry: Optional[Telemetry] = telemetry or None
        if self.telemetry is not None:
            if self.faults is not None:
                self.faults.telemetry = self.telemetry
                self.telemetry.trace_plan(self.faults.plan)
            if control is not None:
                control.telemetry = self.telemetry
        # cumulative simulated time across rounds — the availability axis
        # (BSP and semi-sync advance it by each round's makespan; async pins
        # it to its persistent clock)
        self.virtual_now = 0.0
        self._last_payload_nbytes = 0    # comm-cost estimates (round r-1's)
        self._wire_ratio = 1.0           # achieved wire/raw compression ratio
        self.overlap_scheduling = overlap_scheduling
        self.backup_fraction = backup_fraction
        self._next_tasks: Optional[List[ClientTask]] = None
        self.server_state = algorithm.server_init(self.params)
        self.rng = np.random.default_rng(seed)
        self.round = 0
        self.history: List[RoundMetrics] = []
        self._pending_schedule: Optional[Schedule] = None
        self.engine = make_engine(round_engine, **(engine_opts or {}))
        self.checkpoint_manager = checkpoint_manager
        if self.engine.mode != "bsp":
            # BSP-specific knobs would silently no-op under the DES engines
            # (which serialize execution and mitigate tails by deadline
            # carry-over and work stealing instead)
            for knob, val in (("backup_fraction", backup_fraction),
                              ("parallel_dispatch", parallel_dispatch),
                              ("overlap_scheduling", overlap_scheduling)):
                if val:
                    raise ValueError(
                        f"{knob} only applies to round_engine='bsp' "
                        f"(got {self.engine.mode!r})")

    # ------------------------------------------------------------------
    def select_clients(self, n: Optional[int] = None,
                       exclude: Optional[Any] = None) -> List[ClientTask]:
        """Sample the round's cohort without replacement (rng-identical to
        the JAX package).  ``n`` overrides ``clients_per_round``;
        ``exclude`` removes clients already in flight.  With an availability
        model, clients offline at the current virtual time are filtered
        before sampling; with a fault plan, clients inside a dropout window
        too."""
        filters = []
        if self.availability is not None:
            av, now = self.availability, self.virtual_now
            filters.append(lambda c: av.available(c, now))
            ctrl = self.control
            if ctrl is not None and ctrl.window_fit:
                # window-fit selection (DESIGN.md §12): skip clients whose
                # availability window can't hold their predicted span (+
                # comm round-trip), priced by the fleet-average model (the
                # client is not scheduled yet); inert before the first fit
                avg = fleet_average(self.estimator.last_fit)
                if avg is not None:
                    n_of = self.population.n_samples
                    net, down = self.network, self._last_payload_nbytes
                    up = int(down * self._wire_ratio)

                    def _fits(c, av=av, now=now, avg=avg, n_of=n_of,
                              net=net, down=down, up=up):
                        dur = avg.predict(n_of(c))
                        if net is not None:
                            dur += net.client_comm_time(c, down, up)
                        return av.fits(c, now, dur)

                    filters.append(_fits)
        if self.faults is not None:
            fi, now = self.faults, self.virtual_now
            filters.append(lambda c: not fi.client_down(c, now))
        ids = self.population.sample(
            self.rng, self.clients_per_round if n is None else n,
            exclude=exclude, filters=filters)
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
        fan-in this is the flat left-fold.  Under a placement the final
        reduce is its rank-ordered fold on the fold kernel (bit for bit the
        same sum), landing on the server device."""
        ops = self.algorithm.ops()
        if (self.fold_fan_in > 1 and len(partials) > self.fold_fan_in
                and all(is_flat_partial(p) for p in partials)):
            partials = tree_reduce_partials(partials, self.fold_fan_in)
        if self.placement is not None:
            return self.placement.global_fold(partials, ops)
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

    def _maybe_compress(self, partial: Dict,
                        executor: Optional[int] = None) -> Dict:
        if self.compressor is None:
            return partial
        # key stateful compressor state (top-k error-feedback residuals) by
        # the sending executor: each executor owns its residual stream, so
        # compressed values don't depend on cross-executor ship order
        return self.compressor.compress_partial(
            partial, key=None if executor is None else f"exec{executor}")

    def _maybe_decompress(self, partial: Dict) -> Dict:
        if self.compressor is None:
            return partial
        return self.compressor.decompress_partial(partial)

    def _drop_executor(self, k: int) -> None:
        """Elastic K shrink: retire a dead executor and release its device
        pin.  The object parks in ``_retired`` so a restart or a restore can
        rejoin it later — its measured block costs survive the outage."""
        ex = self.executors.pop(k, None)
        if ex is not None:
            self._retired[k] = ex
        if self.placement is not None:
            self.placement.release(k)

    def _revive_executor(self, k: int) -> bool:
        """A retired executor rejoins (a fault plan's restart event, or a
        restore of a pre-crash topology): it is re-pinned through the
        placement's deterministic least-loaded choice and subsequent
        schedules see K grow again.  False if ``k`` is not revivable."""
        ex = self._retired.pop(k, None)
        if ex is None or k in self.executors:
            return False
        if self.placement is not None:
            ex.set_device(self.placement.pin(k))
        self.executors[k] = ex
        # canonical live order: plain insertion would park the revived k at
        # the dict's tail, making round iteration (dispatch and fold order)
        # depend on the process's crash history — a resumed process rebuilds
        # the dict in constructor order and would fold in a different order,
        # breaking bit-exact auto-resume
        if list(self.executors) != sorted(self.executors):
            self.executors = {j: self.executors[j]
                              for j in sorted(self.executors)}
        return True

    # ------------------------------------------------------------------
    # network/availability plumbing (no-ops when both are None)
    def _sched_comm_cost(self):
        """Per-task comm-cost closure for the scheduler's Eq. 4 (None when
        no network is modelled).  Prices one client round-trip at the last
        broadcast's size and the compressor's last achieved wire ratio —
        round 0 prices latency only (no payload has been sized yet), which
        the uniform warmup schedule ignores anyway."""
        if self.network is None:
            return None
        net, down = self.network, self._last_payload_nbytes
        up = int(down * self._wire_ratio)
        return lambda task: net.client_comm_time(task.client, down, up)

    def _next_available_time(self, exclude: Optional[Any] = None) -> float:
        """Earliest virtual time any selectable client comes online (inf if
        never) — the engines fast-forward an empty round to it."""
        if self.availability is None:
            return self.virtual_now
        ex = {int(c) for c in (exclude or ())}
        return min((self.availability.next_available(int(c), self.virtual_now)
                    for c in self.population.ids_array()
                    if int(c) not in ex), default=float("inf"))

    def _next_availability_change(self, exclude: Optional[Any] = None
                                  ) -> float:
        """Earliest FUTURE instant any selectable client's availability
        flips: window start for offline clients, window *end* for online
        ones.  The fast-forward target when a round made zero progress even
        though clients are nominally online — every dropped client was
        predicted to expire mid-chunk, and within its current window that
        prediction can only get worse."""
        if self.availability is None:
            return float("inf")
        t = self.virtual_now
        best = float("inf")
        ex = {int(c) for c in (exclude or ())}
        for c in self.population.ids_array():
            c = int(c)
            if c in ex:
                continue
            if self.availability.available(c, t):
                r = self.availability.remaining(c, t)
                if math.isfinite(r) and r > 0:
                    best = min(best, t + r)
            else:
                nxt = self.availability.next_available(c, t)
                if nxt > t:
                    best = min(best, nxt)
        return best

    def _commit_metrics(self, metrics: RoundMetrics, t0: float) -> None:
        """Round-boundary commit: every engine routes its finished
        RoundMetrics through here with the round window's virtual start
        ``t0``.  With telemetry the round's extra is ingested into the
        registry and per-executor busy/comm/idle fractions over ``[t0, t0 +
        makespan]`` land in ``metrics.extra["utilization"]`` BEFORE the
        metrics join history (so checkpointed history carries them);
        without it this is exactly ``history.append``."""
        if self.telemetry is not None:
            self.telemetry.on_round(self, metrics, t0)
        self.history.append(metrics)

    # ------------------------------------------------------------------
    def run_round(self) -> RoundMetrics:
        """One server round under the configured engine: a full BSP barrier,
        a deadline-bounded semi-sync round, or one bounded-staleness update
        window (see ``core/engine.py``)."""
        return self.engine.run_round(self)

    def run(self, n_rounds: int,
            auto_resume: bool = False) -> List[RoundMetrics]:
        """Run rounds.  With ``auto_resume=True``, first restore the newest
        valid checkpoint (walking past torn/corrupt ones) and then run until
        ``n_rounds`` TOTAL rounds have completed — the crash-recovery entry
        point: after a mid-round kill, a fresh server constructed with the
        same configuration resumes from the last durable round boundary and
        replays deterministically (params digest matches the uninterrupted
        run).  Without it, ``n_rounds`` more rounds from wherever the server
        stands."""
        if not auto_resume:
            return [self.run_round() for _ in range(n_rounds)]
        if self.checkpoint_manager is None:
            raise ValueError("auto_resume needs a checkpoint_manager")
        from repro_torch.checkpoint.manager import restore_latest
        restore_latest(self, self.checkpoint_manager.directory)
        while self.round < n_rounds:
            self.run_round()
        return list(self.history[:n_rounds])


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

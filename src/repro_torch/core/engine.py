"""Round engines: BSP, semi-sync and async.  Port of
``repro/core/engine.py``.

``ParrotServer.run_round`` delegates to a :class:`RoundEngine`.  All three
engines speak the same vocabulary — executor *chunks* complete as events on
a :class:`~repro_torch.core.clock.VirtualClock`, failures are events,
partials cross the comm layer on the flat wire format — and differ only in
*when the server folds and updates* (DESIGN.md §3):

``bsp``
    The paper's Algorithm 2: every executor drains its whole queue, the
    round barrier collects the K partials in executor order, round time is
    ``max_k Σ T̂``.  Failures re-run the dead executor's remaining clients
    on the survivors and shrink K (elastic membership); speculative backup
    tasks duplicate the predicted-slowest tail; ``quorum_frac < 1.0``
    commits a degraded round instead of re-running when the surviving
    reports already cover enough of the selected clients.

``semi-sync``
    Over-selects clients, derives a virtual-time deadline from the fitted
    workload model, folds whatever chunk partials have landed by the
    deadline and carries unfinished tasks into the next round's pool.

``async``
    No barrier: executors emit a partial per chunk as they complete; the
    server folds each one as it lands, discounted by the bounded-staleness
    weight γ = 1/(1+λ·s) where s is the number of server updates since the
    chunk's payload was broadcast.  A model update fires every ``goal``
    folded clients; idle executors steal chunks from the predicted-slowest
    queue.

The semi-sync and async engines run a deterministic discrete-event
simulation: chunks execute lazily at their virtual dispatch time, so event
order is a pure function of the per-chunk virtual durations, and the fold
order (float summation is not associative) follows the events' (time, seq)
order exactly as in the JAX package.

The engines are comm-free and fault-free.  The branches of the JAX
engines that read a network model, a fault plan, the control plane,
telemetry or a device placement are left out, each with a comment naming
the ROADMAP.md item (modules queue) that ports it; ``ParrotServer`` refuses
those knobs, so none of them can be reached.  A checkpoint manager saves at
each engine's commit point; the engines' cross-round state round-trips
through ``state_dict`` / ``load_state_dict``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from repro_torch.core import tree
from repro_torch.core.aggregation import (merge_partials, scale_partial,
                                          staleness_weight)
from repro_torch.core.clock import VirtualClock
from repro_torch.core.executor import ExecutorFailure, ExecutorReport
from repro_torch.core.scheduler import (ClientTask, Schedule,
                                        pick_steal_victim, predict_remaining,
                                        predict_span, prefetch_ids)
from repro_torch.core.state_manager import _host_tree
from repro_torch.core.workload import RunRecord


def _tasks_of(srv, clients) -> List[ClientTask]:
    """Rebuild ClientTasks from client ids (the sample counts come from the
    population registry, so no client batches materialise here)."""
    n_of = srv.population.n_samples
    return [ClientTask(int(c), n_of(int(c))) for c in clients]


def _host_report(rep: ExecutorReport) -> ExecutorReport:
    """Host-side copy of an in-flight chunk report (CPU tensors; the
    partial's FlatLayout and floats pass through)."""
    return dataclasses.replace(rep, partial=_host_tree(rep.partial),
                               records=list(rep.records),
                               completed_clients=list(rep.completed_clients))


def _on(state: Any, device: Optional[torch.device]) -> Any:
    """Every tensor of ``state`` on ``device`` (None: left where it is)."""
    if device is None:
        return state
    return tree.map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, state)


@dataclass
class _ExecState:
    """Per-executor bookkeeping inside the discrete-event simulation."""
    queue: List[ClientTask] = field(default_factory=list)
    t: float = 0.0            # virtual time of the last completed chunk
    busy_until: float = 0.0   # completion time of the in-flight chunk
    inflight: bool = False
    offset: int = 0           # cumulative dispatched-task index (fail_at)
    stopped: bool = False     # semi-sync: hit the deadline, queue carried
    dead: bool = False        # failure event pushed but not yet processed


@dataclass
class QuorumCounters:
    """The round's degraded-commit accounting (the part of the JAX
    ``FaultCounters`` an engine without a fault plan can move)."""
    dropped_clients: int = 0
    quorum_commits: int = 0


class RoundEngine:
    """One synchronization mode; a server owns exactly one engine (the
    async engine keeps state across rounds)."""

    mode: str = "?"

    def run_round(self, srv) -> "RoundMetrics":
        raise NotImplementedError

    # Engines with cross-round state implement ``state_dict`` /
    # ``load_state_dict`` (plain data, every tensor a CPU tensor) so the
    # checkpoint manager can save and deterministically resume them
    # mid-pipeline; ``device`` is where the restored tensors go.
    def state_dict(self) -> Optional[Dict]:
        return None                 # stateless between rounds (BSP)

    def load_state_dict(self, state: Optional[Dict],
                        device: Optional[torch.device] = None) -> None:
        if state:
            raise ValueError(f"engine {self.mode!r} cannot restore state")

    def _check_mode(self, state: Dict) -> None:
        if state.get("mode") != self.mode:
            raise ValueError(f"checkpointed engine state is "
                             f"{state.get('mode')!r}, not {self.mode!r}")

    # -- shared plumbing ---------------------------------------------------
    def _chunk_size(self, srv, override: Optional[int]) -> int:
        if override:
            return max(1, int(override))
        return max(e.client_block for e in srv.executors.values())

    def _wire(self, srv, executor: int, partial: Dict) -> Dict:
        """One partial across the comm layer: compress -> send -> poll (->
        blocking recv on transports without immediate local delivery) ->
        decompress.  The copy that reaches aggregation is the one that
        crossed the wire, keeping error-feedback residuals in sync."""
        srv.comm.executor_send(executor,
                               srv._maybe_compress(partial, executor),
                               tag="partial")
        wire = srv.comm.poll(executor, tag="partial")
        if wire is None:
            wire = srv.comm.recv_from_executor(executor, tag="partial")
        return srv._maybe_decompress(wire)

    def _chunk_record(self, srv, rnd: int, rep: ExecutorReport
                      ) -> Optional[RunRecord]:
        """Per-chunk timing record: one (N_total, T̂) pair per chunk — what
        the engines' chunk-granular predictions consume."""
        if rep.n_tasks == 0:
            return None
        n = sum(srv.population.n_samples(c)
                for c in rep.completed_clients)
        return RunRecord(round=rnd, client=rep.completed_clients[0],
                         executor=rep.executor, n_samples=n,
                         time=rep.virtual_time, n_tasks=rep.n_tasks)

    def _fail_over(self, srv, states: Dict[int, _ExecState], dead: int,
                   remaining: List[ClientTask]) -> List[int]:
        """Elastic failure as an engine event: drop the dead executor
        (K shrink), append its unfinished tasks round-robin onto the
        survivors' queues.  Tasks assigned to the dead executor *after* its
        failure event was pushed (an async refill can land in between) are
        still parked on its queue and re-home too.  Returns survivor ids."""
        srv._drop_executor(dead)
        dead_state = states.pop(dead, None)
        if dead_state is not None and dead_state.queue:
            remaining = list(remaining) + dead_state.queue
        survivors = sorted(states)
        if not survivors:
            raise RuntimeError("all executors failed")
        for i, t in enumerate(remaining):
            states[survivors[i % len(survivors)]].queue.append(t)
        return survivors

    @staticmethod
    def _quorum_extra(extra: Dict[str, float],
                      counters: QuorumCounters) -> None:
        """A degraded commit's keys under the JAX engines' unified fault
        schema (``_fault_extra``); with no fault plan, retries and corrupt
        payloads stay 0 (the fault plan is ROADMAP.md item 13)."""
        extra["retries"] = 0.0
        extra["corrupt_payloads"] = 0.0
        extra["dropped_clients"] = float(counters.dropped_clients)
        extra["quorum_commits"] = float(counters.quorum_commits)


def make_engine(mode: str, **opts) -> RoundEngine:
    modes = {"bsp": BSPEngine, "semi-sync": SemiSyncEngine,
             "semi_sync": SemiSyncEngine, "async": AsyncEngine}
    if mode not in modes:
        raise ValueError(f"unknown round engine {mode!r}; "
                         f"choose from {sorted(set(modes))}")
    return modes[mode](**opts)


# ---------------------------------------------------------------------------
# BSP
# ---------------------------------------------------------------------------

class BSPEngine(RoundEngine):
    """Algorithm 2 as an event flow.

    BSP is a barrier: every queue completion lands *at* the barrier, so all
    events carry virtual time 0 and pop in push order (executor-dict
    order), which fixes the partial/fold order — float summation is not
    associative; order is part of the result."""

    mode = "bsp"

    def __init__(self, quorum_frac: float = 1.0):
        if not (0.0 < quorum_frac <= 1.0):
            raise ValueError("quorum_frac must be in (0, 1]")
        self.quorum_frac = float(quorum_frac)

    def run_round(self, srv):
        from repro_torch.core.round import RoundMetrics
        rnd = srv.round
        t_wall = time.perf_counter()
        counters = QuorumCounters()
        if srv._next_tasks is not None:
            tasks, srv._next_tasks = srv._next_tasks, None
        else:
            tasks = srv.select_clients()

        # compute-comm overlap: the schedule for this round may have been
        # prepared while the previous round's global reduce was in flight;
        # an executor lost since then still owns a queue -> re-map it
        remapped = 0
        if srv._pending_schedule is not None:
            schedule, overlapped = srv._pending_schedule, True
            srv._pending_schedule = None
            remapped = schedule.remap(list(srv.executors))
        else:
            schedule, overlapped = srv.scheduler.schedule(
                rnd, tasks, list(srv.executors)), False

        payload = srv.algorithm.broadcast_payload(srv.params,
                                                  srv.server_state)
        skip_map, n_backups = srv._plan_backups(schedule)
        reports, n_failed = self._dispatch(srv, rnd, schedule, payload,
                                           skip_map, counters=counters,
                                           n_total=len(tasks))
        makespan = max((r.virtual_time for r in reports), default=0.0)
        base = srv.virtual_now        # the barrier's absolute start
        srv.virtual_now += makespan

        # overlap: prepare round r+1's schedule "while the reduce is in
        # flight" (before the global aggregate below consumes the partials)
        if srv.overlap_scheduling:
            srv.estimator.record_many(
                [rec for r in reports for rec in r.records])
            srv._next_tasks = srv.select_clients()
            srv._pending_schedule = srv.scheduler.schedule(
                rnd + 1, srv._next_tasks, list(srv.executors))

        partials = [r.partial for r in reports]
        if partials:
            agg = srv.global_fold(partials)
            agg["_n_selected"] = sum(r.n_tasks for r in reports)
            srv.params, srv.server_state = srv.algorithm.server_update(
                srv.params, agg, srv.server_state, len(srv.data_by_client))

        records = [rec for r in reports for rec in r.records]
        err = float("nan")
        if srv.estimator.last_fit:
            err = srv.estimator.estimation_error(srv.estimator.last_fit,
                                                 records)
        if not srv.overlap_scheduling:  # overlap path already recorded them
            srv.estimator.record_many(records)
        stats = srv.comm.stats.reset()
        extra = {"backup_tasks": float(n_backups)}
        if remapped:
            extra["remapped_tasks"] = float(remapped)
        if counters.quorum_commits:
            self._quorum_extra(extra, counters)
        sm_extra = srv._state_manager_extra()
        if sm_extra is not None:
            extra["state_manager"] = sm_extra
        metrics = RoundMetrics(
            round=rnd, makespan=makespan,
            wall_time=time.perf_counter() - t_wall,
            schedule_time=0.0 if overlapped else schedule.schedule_time_s,
            estimate_time=0.0 if overlapped else schedule.estimate_time_s,
            predicted_makespan=schedule.predicted_makespan,
            comm_bytes=stats.bytes_sent, comm_trips=stats.trips,
            n_clients=len(tasks), n_executors=len(srv.executors),
            estimation_error=err, failures=n_failed, extra=extra)
        srv._commit_metrics(metrics, base)
        srv.round += 1
        if srv.checkpoint_manager is not None:
            srv.checkpoint_manager.maybe_save(srv)
        return metrics

    # ------------------------------------------------------------------
    def _dispatch(self, srv, rnd: int, schedule: Schedule, payload: Dict,
                  skip_map: Optional[Dict[int, Set[int]]] = None,
                  counters: Optional[QuorumCounters] = None,
                  n_total: int = 0
                  ) -> Tuple[List[ExecutorReport], int]:
        live = list(srv.executors)
        srv.comm.broadcast(payload, live, tag="broadcast")
        clock = VirtualClock()
        reports: List[ExecutorReport] = []
        failed: List[int] = []
        done_clients: set = set()

        # barrier semantics: every outcome lands at t=0; seq order keeps the
        # executor order
        for k in live:
            try:
                clock.push(0.0, "queue_done", srv.executors[k].run_queue(
                    rnd, schedule.queue(k), payload, srv.data_by_client,
                    skip_clients=(skip_map or {}).get(k)))
            except ExecutorFailure:
                clock.push(0.0, "executor_failed", k)
        for ev in clock.drain():
            if ev.kind == "queue_done":
                reports.append(ev.data)
            else:
                failed.append(ev.data)

        # ---- failures: re-run failed queues on the survivors -------------
        if failed:
            for rep in reports:
                done_clients.update(rep.completed_clients)
            survivors = [k for k in live if k not in failed]
            if not survivors:
                raise RuntimeError("all executors failed")
            # dedup by client: with backup duplicates a task can sit in two
            # failed queues at once and must still re-run (and fold) once
            leftovers: List[ClientTask] = []
            for k in failed:
                for t in schedule.queue(k):
                    if t.client not in done_clients:
                        done_clients.add(t.client)
                        leftovers.append(t)
                srv._drop_executor(k)          # elastic K shrink
            # quorum-degraded commit: when the surviving reports already
            # cover >= quorum_frac of the selected clients, skip the re-runs
            if self.quorum_frac < 1.0 and leftovers \
                    and counters is not None:
                folded = sum(r.n_tasks for r in reports)
                if folded >= self.quorum_frac * max(n_total, 1):
                    counters.dropped_clients += len(leftovers)
                    counters.quorum_commits += 1
                    leftovers = []
            for i, t in enumerate(leftovers):  # round-robin retry placement
                k = survivors[i % len(survivors)]
                reports.append(srv.executors[k].run_queue(
                    rnd, [t], payload, srv.data_by_client))

        # the partial that reaches aggregation is the one that crossed the
        # comm layer: compress once, ship, and aggregate the decompressed
        # copy (error-feedback residuals and the aggregated values stay in
        # sync)
        for rep in reports:
            rep.partial = self._wire(srv, rep.executor, rep.partial)
        return reports, len(failed)


# ---------------------------------------------------------------------------
# semi-sync
# ---------------------------------------------------------------------------

class SemiSyncEngine(RoundEngine):
    """Deadline-bounded rounds with over-selection and task carry-over.

    ``over_select`` inflates the per-round selection (so the deadline cut
    still folds ~``clients_per_round`` results); the deadline is
    ``deadline_frac ×`` the schedule's chunk-granular predicted makespan (∞
    during warmup, when no workload model exists — the round then
    degenerates to BSP).  An executor dispatches its next chunk only if the
    fitted model predicts it lands before the deadline; everything it does
    not dispatch — plus a dead executor's re-homed tasks that miss the
    deadline on the survivors — carries into the next round's selection
    pool.  Every executor gets its first chunk unconditionally, so a round
    always makes progress.  ``quorum_frac < 1.0`` commits the round early
    once ≥ that fraction of the selected tasks has folded — remaining
    queues drain into the carry pool and the round's makespan is the
    commit time.
    """

    mode = "semi-sync"

    def __init__(self, over_select: float = 1.5, deadline_frac: float = 0.75,
                 chunk_size: Optional[int] = None,
                 quorum_frac: float = 1.0):
        if not (0.0 < quorum_frac <= 1.0):
            raise ValueError("quorum_frac must be in (0, 1]")
        self.over_select = float(over_select)
        self.deadline_frac = float(deadline_frac)
        self.chunk_size = chunk_size
        self.quorum_frac = float(quorum_frac)
        self._carry: List[ClientTask] = []

    # -- checkpointing: the carry pool is the only cross-round state -------
    def state_dict(self) -> Dict:
        return {"mode": self.mode, "carry": list(self._carry)}

    def load_state_dict(self, state: Optional[Dict],
                        device: Optional[torch.device] = None) -> None:
        if not state:
            return
        self._check_mode(state)
        self._carry = list(state["carry"])

    def run_round(self, srv):
        from repro_torch.core.round import RoundMetrics
        rnd = srv.round
        t_wall = time.perf_counter()
        counters = QuorumCounters()
        # fault-plan crashes and restarts at the round boundary: item 13

        target = max(1, math.ceil(self.over_select * srv.clients_per_round))
        carried, self._carry = self._carry, []
        # carried clients re-checked against the availability model: item 13
        n_fresh = max(0, target - len(carried))
        fresh = srv.select_clients(
            n=n_fresh, exclude=[t.client for t in carried])
        tasks = carried + fresh
        # an empty cohort fast-forwards to the next available client: item 13
        schedule = srv.scheduler.schedule(rnd, tasks, list(srv.executors),
                                          comm_cost=srv._sched_comm_cost())
        payload = srv.algorithm.broadcast_payload(srv.params,
                                                  srv.server_state)
        live = list(srv.executors)
        srv.comm.broadcast(payload, live, tag="broadcast")

        models = dict(srv.estimator.last_fit)
        chunk = self._chunk_size(srv, self.chunk_size)
        abs0 = srv.virtual_now    # the round's anchor on the absolute axis
        # the deadline lives in the units the executors accrue: the
        # chunk-granular predicted makespan of this schedule.  No models yet
        # (warmup) -> ∞ -> a full BSP round.  Fault-scaled models and comm
        # predictions join it with item 13, the deadline controller with
        # item 16.
        pm = max((predict_remaining(models.get(k), schedule.queue(k), chunk)
                  for k in live), default=0.0)
        deadline = self.deadline_frac * pm if pm > 0.0 else float("inf")

        clock = VirtualClock()
        states = {k: _ExecState(queue=list(schedule.queue(k))) for k in live}
        partials: List[Dict] = []
        records: List[RunRecord] = []
        n_landed = 0
        n_failed = 0
        committed = False       # quorum reached: queues drained to carry
        quorum_t = 0.0
        # the first wave's gang dispatch (ctrl.gang_waves): items 15 and 16
        for k in live:
            self._dispatch_next(srv, rnd, k, states, clock, payload, models,
                                deadline, chunk)
        while clock:
            ev = clock.pop()
            if ev.kind == "chunk_done":
                k, rep = ev.data
                es = states[k]
                es.t, es.inflight = ev.time, False
                if rep.n_tasks:
                    if committed:
                        # landed after the quorum commit: carry, not fold
                        self._carry.extend(
                            _tasks_of(srv, rep.completed_clients))
                    else:
                        # the fault plan's corrupt-payload check: item 13
                        partials.append(self._wire(srv, k, rep.partial))
                        rec = self._chunk_record(srv, rnd, rep)
                        if rec is not None:
                            records.append(rec)
                        n_landed += rep.n_tasks
                self._dispatch_next(srv, rnd, k, states, clock, payload,
                                    models, deadline, chunk)
            # "chunk_arrived" and "upload_lost" come with the network: item 13
            else:  # executor_failed
                dead, remaining = ev.data
                n_failed += 1
                survivors = self._fail_over(srv, states, dead, remaining)
                for j in survivors:
                    if states[j].stopped:
                        # already past the deadline: re-homed tasks carry
                        # over instead of silently parking on a stopped queue
                        self._carry.extend(states[j].queue)
                        states[j].queue = []
                    elif not states[j].inflight:  # wake finished survivors
                        self._dispatch_next(srv, rnd, j, states, clock,
                                            payload, models, deadline, chunk)
            if not committed and self.quorum_frac < 1.0 and tasks \
                    and n_landed >= self.quorum_frac * len(tasks):
                # quorum-degraded commit: enough of the selected weight has
                # folded — the round closes here; everything still queued
                # (or landing later) re-enters through the carry pool
                committed, quorum_t = True, ev.time
                counters.quorum_commits += 1
                for es in states.values():
                    if es.queue:
                        self._carry.extend(es.queue)
                        es.queue = []
                    es.stopped = True

        if partials:
            agg = srv.global_fold(partials)
            agg["_n_selected"] = n_landed
            srv.params, srv.server_state = srv.algorithm.server_update(
                srv.params, agg, srv.server_state, len(srv.data_by_client))

        err = float("nan")
        if srv.estimator.last_fit:
            err = srv.estimator.estimation_error(srv.estimator.last_fit,
                                                 records)
        srv.estimator.record_many(records)
        makespan = max((es.t for es in states.values()), default=0.0)
        if committed:
            # the round committed at quorum: in-flight stragglers finished
            # after the commit carried over instead of counting
            makespan = quorum_t
        stats = srv.comm.stats.reset()
        extra = {"landed_clients": float(n_landed),
                 "carried_tasks": float(len(self._carry)),
                 "deadline": deadline}
        # controller and oracle keys: item 16; comm and idle keys: item 13
        if counters.quorum_commits:
            self._quorum_extra(extra, counters)
        sm_extra = srv._state_manager_extra()
        if sm_extra is not None:
            extra["state_manager"] = sm_extra
        metrics = RoundMetrics(
            round=rnd, makespan=makespan,
            wall_time=time.perf_counter() - t_wall,
            schedule_time=schedule.schedule_time_s,
            estimate_time=schedule.estimate_time_s,
            predicted_makespan=schedule.predicted_makespan,
            comm_bytes=stats.bytes_sent, comm_trips=stats.trips,
            n_clients=len(tasks), n_executors=len(srv.executors),
            estimation_error=err, failures=n_failed,
            extra=extra)
        srv._commit_metrics(metrics, abs0)
        srv.virtual_now += makespan
        srv.round += 1
        if srv.checkpoint_manager is not None:
            srv.checkpoint_manager.maybe_save(srv)
        return metrics

    # ------------------------------------------------------------------
    def _dispatch_next(self, srv, rnd, k, states, clock, payload, models,
                       deadline, chunk) -> None:
        es = states[k]
        # deadline-aware work stealing (ctrl.rebalance): item 16
        if not es.queue or es.stopped or es.dead:
            return
        next_chunk = es.queue[:chunk]
        start = max(es.t, clock.now)
        pred = predict_span(models.get(k), next_chunk)
        if es.t > 0.0 and start + pred > deadline:
            # predicted to miss the deadline: stop here, carry the rest
            # (first chunk is exempt — a round always makes progress)
            es.stopped = True
            self._carry.extend(es.queue)
            es.queue = []
            return
        es.queue = es.queue[chunk:]
        # fault-plan crashes, mid-compute dropout and availability dropout
        # at dispatch: item 13
        try:
            rep = srv.executors[k].run_queue(
                rnd, next_chunk, payload, srv.data_by_client,
                task_offset=es.offset)
        except ExecutorFailure:
            # the failing chunk never folded: every one of its clients must
            # re-home along with the rest of the queue.  The executor is
            # dead the moment the event is pushed — nothing may dispatch on
            # it while the event waits in the queue.
            clock.push(start, "executor_failed", (k, next_chunk + es.queue))
            es.queue = []
            es.dead = True
            return
        es.offset += len(next_chunk)
        es.inflight = True
        if es.queue and srv.algorithm.stateful:
            # schedule-keyed prefetch: stage the next chunk's state shards
            # while this chunk's span elapses on the virtual clock
            sm = srv.executors[k].state_manager
            if sm is not None:
                sm.prefetch(prefetch_ids(es.queue, chunk))
        # the comm-priced chunk (download + compute, upload as its own
        # event) comes with the network model: item 13
        es.busy_until = start + rep.virtual_time
        clock.push(es.busy_until, "chunk_done", (k, rep))


# ---------------------------------------------------------------------------
# async (bounded staleness)
# ---------------------------------------------------------------------------

class AsyncEngine(RoundEngine):
    """Continuous bounded-staleness federation.

    The engine persists across ``run_round`` calls: executor virtual clocks,
    queues and in-flight chunks carry over, so "round r" is just the span
    between server updates r and r+1 on the shared virtual axis.  Each
    folded chunk is discounted by γ = 1/(1+λ·s) where s counts the server
    updates since the chunk's dispatch; the server updates after ``goal``
    (default ``clients_per_round``) clients have folded, then broadcasts the
    new payload, re-schedules a fresh selection on the live executors with
    the current workload models, and wakes any idle executor.  An executor
    with an empty queue steals the tail chunk of the predicted-slowest
    queue before going idle.
    """

    mode = "async"

    def __init__(self, staleness_lambda: float = 0.5,
                 chunk_size: Optional[int] = None,
                 pipeline_depth: float = 2.0,
                 goal: Optional[int] = None):
        self.staleness_lambda = float(staleness_lambda)
        self.chunk_size = chunk_size
        self.pipeline_depth = float(pipeline_depth)
        self.goal = goal
        self._states: Optional[Dict[int, _ExecState]] = None
        self._clock = VirtualClock()
        self._in_system: Set[int] = set()
        self._last_update_t = 0.0
        self._last_sched: Optional[Schedule] = None
        self._payload: Optional[Dict] = None
        self._reset_window()

    def _reset_window(self) -> None:
        """Clear the per-update accumulators (one 'round' = one window).
        The fault counters join with item 13, the control plane's oracle
        jobs and rebalance count with item 16."""
        self._buffer: Optional[Dict] = None
        self._n_folded = 0
        self._records: List[RunRecord] = []
        self._n_failed = 0
        self._steals = 0
        self._stale_folds = 0
        self._stale_sum = 0.0

    # -- checkpointing of the in-flight pipeline ---------------------------
    # The engine persists across rounds, so a checkpoint taken at an update
    # boundary still has a live pipeline: undispatched queues, in-flight
    # chunk completions sitting in the clock (their partials already
    # computed and folded into nothing yet), the payload version executors
    # are training against, and the window accumulators.  All of it is
    # serialised host-side (CPU tensors) as plain data; restore moves the
    # tensors back onto the server's device and rebuilds the clock heap
    # with the exact (time, seq) ordering, so the resumed run pops the same
    # events in the same order and stays bit-deterministic.  (Client states
    # and the server blob ride the normal checkpoint path; the executor
    # topology must match on restore.)  The fault counters join with item
    # 13, the control plane's payload anchor, oracle jobs and rebalance
    # count with item 16.
    # Known gap (as in JAX): params/makespans are bit-exact, but the first
    # resumed round's comm_bytes metric omits the round-end broadcast that
    # the original process sent just before the checkpoint (comm stats are
    # not part of the blob) — metrics accounting only.
    def state_dict(self) -> Dict:
        if self._states is None:
            return {"mode": self.mode, "initialized": False}
        clock = self._clock.state_dict()

        def host_event(kind, data):
            if kind == "chunk_done":
                return (data[0], _host_report(data[1]), data[2])
            # "chunk_arrived" (an in-flight upload) comes with the network
            # model: item 13
            return data

        clock["events"] = [(t, seq, kind, host_event(kind, data))
                           for (t, seq, kind, data) in clock["events"]]
        return {
            "mode": self.mode, "initialized": True,
            "states": {k: dict(queue=list(es.queue), t=es.t,
                               busy_until=es.busy_until, inflight=es.inflight,
                               offset=es.offset, stopped=es.stopped,
                               dead=es.dead)
                       for k, es in self._states.items()},
            "clock": clock,
            "in_system": sorted(self._in_system),
            "last_update_t": self._last_update_t,
            "payload": _host_tree(self._payload),
            "buffer": _host_tree(self._buffer),
            "n_folded": self._n_folded,
            "records": list(self._records),
            "n_failed": self._n_failed,
            "steals": self._steals,
            "stale_folds": self._stale_folds,
            "stale_sum": self._stale_sum,
            "last_sched": self._last_sched,
        }

    def load_state_dict(self, state: Optional[Dict],
                        device: Optional[torch.device] = None) -> None:
        if not state:
            return
        self._check_mode(state)
        if not state.get("initialized"):
            return

        def device_event(t, seq, kind, data):
            if kind == "chunk_done":
                k, rep, version = data
                data = (k, dataclasses.replace(
                    rep, partial=_on(rep.partial, device)), version)
            return (t, seq, kind, data)

        clock = dict(state["clock"])
        clock["events"] = [device_event(*ev) for ev in clock["events"]]
        self._states = {k: _ExecState(**es)
                        for k, es in state["states"].items()}
        self._clock = VirtualClock.from_state_dict(clock)
        self._in_system = set(state["in_system"])
        self._last_update_t = state["last_update_t"]
        self._payload = _on(state["payload"], device)
        self._buffer = _on(state["buffer"], device)
        self._n_folded = state["n_folded"]
        self._records = list(state["records"])
        self._n_failed = state["n_failed"]
        self._steals = state["steals"]
        self._stale_folds = state["stale_folds"]
        self._stale_sum = state["stale_sum"]
        self._last_sched = state["last_sched"]

    # ------------------------------------------------------------------
    def _ensure_init(self, srv) -> None:
        if self._states is not None:
            return
        srv.virtual_now = self._clock.now
        self._payload = srv.algorithm.broadcast_payload(srv.params,
                                                        srv.server_state)
        live = list(srv.executors)
        srv.comm.broadcast(self._payload, live, tag="broadcast")
        n0 = max(1, math.ceil(self.pipeline_depth * srv.clients_per_round))
        tasks = srv.select_clients(n=n0)
        schedule = srv.scheduler.schedule(srv.round, tasks, live,
                                          comm_cost=srv._sched_comm_cost())
        self._last_sched = schedule
        self._states = {k: _ExecState(queue=list(schedule.queue(k)))
                        for k in live}
        self._in_system = {t.client for t in tasks}
        # the first wave's gang dispatch (ctrl.gang_waves): items 15 and 16
        for k in live:
            self._dispatch_next(srv, k)

    def _refill(self, srv) -> None:
        """Top the pool back up with a fresh selection, re-scheduled onto
        the live executors under the *current* workload models (clients
        already in the system are excluded — a client must fold before it
        can be picked again, which keeps stateful algorithms race-free)."""
        # an executor whose failure event is still in flight gets no new
        # work (it would only need re-homing when the event pops)
        live = [k for k in srv.executors if not self._states[k].dead]
        srv.virtual_now = self._clock.now
        fresh = srv.select_clients(n=srv.clients_per_round,
                                   exclude=self._in_system)
        if not fresh or not live:
            return
        schedule = srv.scheduler.schedule(srv.round, fresh, live,
                                          comm_cost=srv._sched_comm_cost())
        self._last_sched = schedule
        for k in live:
            # offset is NOT reset: fail_at's task index counts tasks
            # dispatched by this executor cumulatively, so every index is
            # reachable and no (round, index) coordinate repeats
            self._states[k].queue.extend(schedule.queue(k))
        self._in_system.update(t.client for t in fresh)

    # ------------------------------------------------------------------
    def _dispatch_next(self, srv, k: int) -> None:
        es = self._states[k]
        if es.dead:
            return
        chunk = self._chunk_size(srv, self.chunk_size)
        if not es.queue:
            # work stealing: grab the tail chunk of the predicted-slowest
            # queue (its owner was never going to reach it soon anyway)
            victim = pick_steal_victim(
                {j: s.queue for j, s in self._states.items()},
                {j: (s.busy_until if s.inflight else s.t)
                 for j, s in self._states.items()},
                srv.estimator.last_fit, k, chunk)
            if victim is None:
                return        # nothing anywhere: idle until refill
            vq = self._states[victim].queue
            es.queue, self._states[victim].queue = vq[-chunk:], vq[:-chunk]
            self._steals += 1
        tasks, es.queue = es.queue[:chunk], es.queue[chunk:]
        start = max(es.t, self._clock.now)
        # fault-plan crashes, mid-compute dropout and availability dropout
        # at dispatch: item 13
        rnd = srv.round
        try:
            rep = srv.executors[k].run_queue(
                rnd, tasks, self._payload, srv.data_by_client,
                task_offset=es.offset)
        except ExecutorFailure:
            self._clock.push(start, "executor_failed", (k, tasks + es.queue))
            es.queue = []
            es.dead = True   # no re-dispatch while the event is in flight
            return
        es.offset += len(tasks)
        es.inflight = True
        if es.queue and srv.algorithm.stateful:
            # schedule-keyed prefetch: the next chunk's state shards stage
            # while this chunk's span elapses on the virtual clock
            sm = srv.executors[k].state_manager
            if sm is not None:
                sm.prefetch(prefetch_ids(es.queue, chunk))
        # the comm-priced chunk (download + compute, upload as its own
        # event) comes with the network model: item 13
        es.busy_until = start + rep.virtual_time
        self._clock.push(es.busy_until, "chunk_done", (k, rep, rnd))

    # ------------------------------------------------------------------
    def run_round(self, srv):
        from repro_torch.core.round import RoundMetrics
        t_wall = time.perf_counter()
        # fault-plan restarts at the window boundary: item 13
        self._ensure_init(srv)
        rnd = srv.round
        goal = self.goal or srv.clients_per_round

        while self._n_folded < goal:
            if not self._clock:
                if self._n_folded > 0:
                    break          # drained: update with what we have
                self._refill(srv)
                for k in list(self._states):
                    if not self._states[k].inflight:
                        self._dispatch_next(srv, k)
                if not self._clock:
                    # waking at the next availability window: item 13
                    raise RuntimeError("async engine starved: no runnable "
                                       "clients on any executor")
                continue
            ev = self._clock.pop()
            srv.virtual_now = self._clock.now
            if ev.kind == "chunk_done":
                k, rep, version = ev.data
                es = self._states[k]
                es.t, es.inflight = ev.time, False
                if rep.n_tasks:
                    # the fault plan's corrupt-payload check: item 13
                    wire = self._wire(srv, k, rep.partial)
                    s = srv.round - version
                    # the controller's λ (ctrl.async_lambda): item 16
                    gamma = staleness_weight(s, self.staleness_lambda)
                    self._buffer = merge_partials(
                        self._buffer, scale_partial(wire, gamma))
                    self._n_folded += rep.n_tasks
                    if s > 0:
                        self._stale_folds += 1
                    self._stale_sum += s
                    rec = self._chunk_record(srv, version, rep)
                    if rec is not None:
                        self._records.append(rec)
                    self._in_system.difference_update(rep.completed_clients)
                self._dispatch_next(srv, k)
            # "chunk_arrived", "upload_lost" and "wake" come with the
            # network and availability models: item 13
            else:  # executor_failed
                dead, remaining = ev.data
                self._n_failed += 1
                survivors = self._fail_over(srv, self._states, dead,
                                            remaining)
                for j in survivors:
                    if not self._states[j].inflight:
                        self._dispatch_next(srv, j)

        # ---- server update (one bounded-staleness window == one round) ---
        agg = srv.global_fold([self._buffer])
        agg["_n_selected"] = self._n_folded
        srv.params, srv.server_state = srv.algorithm.server_update(
            srv.params, agg, srv.server_state, len(srv.data_by_client))

        err = float("nan")
        if srv.estimator.last_fit:
            err = srv.estimator.estimation_error(srv.estimator.last_fit,
                                                 self._records)
        srv.estimator.record_many(self._records)
        win0 = self._last_update_t    # the window's absolute start
        makespan = self._clock.now - self._last_update_t
        self._last_update_t = self._clock.now
        srv.virtual_now = self._clock.now
        stats = srv.comm.stats.reset()
        sched = self._last_sched
        n_folds = max(len(self._records), 1)
        extra = {"steals": float(self._steals),
                 "stale_folds": float(self._stale_folds),
                 "mean_staleness": self._stale_sum / n_folds,
                 "in_system": float(len(self._in_system))}
        # controller and oracle keys: item 16; comm and fault keys: item 13
        sm_extra = srv._state_manager_extra()
        if sm_extra is not None:
            extra["state_manager"] = sm_extra
        metrics = RoundMetrics(
            round=rnd, makespan=makespan,
            wall_time=time.perf_counter() - t_wall,
            schedule_time=sched.schedule_time_s if sched else 0.0,
            estimate_time=sched.estimate_time_s if sched else 0.0,
            predicted_makespan=(sched.predicted_makespan if sched
                                else float("nan")),
            comm_bytes=stats.bytes_sent, comm_trips=stats.trips,
            n_clients=self._n_folded, n_executors=len(srv.executors),
            estimation_error=err, failures=self._n_failed,
            extra=extra)
        srv._commit_metrics(metrics, win0)
        srv.round += 1
        self._reset_window()

        # new version: broadcast Θ^{r+1} (counted in the next window's comm
        # stats), top the pool up, wake idle executors
        self._payload = srv.algorithm.broadcast_payload(srv.params,
                                                        srv.server_state)
        srv.comm.broadcast(self._payload, list(srv.executors),
                           tag="broadcast")
        self._refill(srv)
        # the commit-tail queue rebalance (ctrl.rebalance): item 16; the
        # wave's gang dispatch (ctrl.gang_waves): items 15 and 16
        for k in list(self._states):
            if not self._states[k].inflight:
                self._dispatch_next(srv, k)
        if srv.checkpoint_manager is not None:
            srv.checkpoint_manager.maybe_save(srv)
        return metrics

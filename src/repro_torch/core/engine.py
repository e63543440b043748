"""Round engines.  Port of the BSP part of ``repro/core/engine.py``.

``bsp`` is the paper's Algorithm 2: every executor drains its whole queue,
the round barrier collects the K partials in executor order, round time is
``max_k Σ T̂``.  Failures re-run the dead executor's remaining clients on
the survivors and shrink K (elastic membership); speculative backup tasks
duplicate the predicted-slowest tail; ``quorum_frac < 1.0`` commits a
degraded round instead of re-running when the surviving reports already
cover enough of the selected clients.

The semi-sync and async engines come with a later slice (ROADMAP item 10),
as do the network, fault-plan, control-plane and telemetry branches of the
BSP round (items 13 and 16): ``ParrotServer`` refuses those knobs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.clock import VirtualClock
from repro_torch.core.executor import ExecutorFailure, ExecutorReport
from repro_torch.core.scheduler import ClientTask, Schedule


@dataclass
class QuorumCounters:
    """The round's degraded-commit accounting (the part of the JAX
    ``FaultCounters`` a BSP round without a fault plan can move)."""
    dropped_clients: int = 0
    quorum_commits: int = 0


class RoundEngine:
    """One synchronization mode; a server owns exactly one engine."""

    mode: str = "?"

    def run_round(self, srv) -> "RoundMetrics":
        raise NotImplementedError


def make_engine(mode: str, **opts) -> RoundEngine:
    if mode == "bsp":
        return BSPEngine(**opts)
    if mode in ("semi-sync", "semi_sync", "async"):
        raise NotImplementedError(
            f"round_engine={mode!r} is not ported yet (ROADMAP.md, modules "
            f"queue item 10: DES engines)")
    raise ValueError(f"unknown round engine {mode!r}; choose from "
                     f"['async', 'bsp', 'semi-sync', 'semi_sync']")


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
            # the JAX engine's unified fault schema for a degraded commit
            extra["retries"] = 0.0
            extra["corrupt_payloads"] = 0.0
            extra["dropped_clients"] = float(counters.dropped_clients)
            extra["quorum_commits"] = float(counters.quorum_commits)
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
        srv.history.append(metrics)
        srv.round += 1
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
        # comm layer
        for rep in reports:
            srv.comm.executor_send(rep.executor, rep.partial, tag="partial")
            rep.partial = srv.comm.recv_from_executor(rep.executor,
                                                      tag="partial")
        return reports, len(failed)

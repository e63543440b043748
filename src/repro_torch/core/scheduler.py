"""Heterogeneity-aware task scheduling (paper §4.4, Algorithm 3); port of
``repro/core/scheduler.py`` (pure Python, so schedules are identical).

Greedy LPT (longest-processing-time-first) assignment minimising the
estimated round makespan

    min_{M_1..M_K}  max_k  Σ_{m in M_k} T_{m,k}            (Eq. 3)

For each task (descending N_m) the executor chosen is

    k* = argmin_k ( w_k + N_m t_k^sample + b_k )            (Eq. 4)

— O(K · M_p) with a linear argmin per task (a heap does not apply directly
because T_{m,k} depends on k through both slope and offset).

Schedulers:
  parrot   — Algorithm 3 with the fitted workload model (warmup: uniform)
  uniform  — uniformly split |M^r| across executors (paper warmup / ablation)
  none     — arrival-order round-robin (emulates unscheduled FA-Dist)

Chunk granularity (event-driven engines, DESIGN.md §3): the semi-sync and
async engines execute queues in *chunks* of a few tasks and re-schedule at
chunk completion events — :func:`split_chunks` cuts a queue,
:func:`predict_span` / :func:`predict_remaining` price a chunk / a queue
under a fitted model, :func:`pick_steal_victim` picks the queue an idle
executor steals from, and :func:`rebalance_queues` re-packs undispatched
work.  All of it stays in Python floats, so deadline tests and victim
choices are the JAX package's bit for bit.  :meth:`Schedule.remap` re-homes
queues that a pre-computed (overlapped) schedule assigned to an executor
that has since died — without it those clients would silently never run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.workload import (DEFAULT_MODEL, WorkloadEstimator,
                                 WorkloadModel, fleet_average)

#: predicted comm seconds for a chunk's client ids (engines bind a
#: NetworkModel + the round's payload size into one of these; None = the
#: pre-network behaviour, comm is free)
ChunkCommCost = Callable[[Sequence[int]], float]


@dataclass(frozen=True)
class ClientTask:
    client: int
    n_samples: int


@dataclass
class Schedule:
    assignment: Dict[int, List[ClientTask]]      # executor -> tasks
    predicted_makespan: float
    schedule_time_s: float
    estimate_time_s: float

    def queue(self, executor: int) -> List[ClientTask]:
        return self.assignment.get(executor, [])

    @property
    def max_queue_len(self) -> int:
        return max((len(v) for v in self.assignment.values()), default=0)

    def remap(self, live: Sequence[int]) -> int:
        """Re-home queues assigned to executors not in ``live``.

        A schedule computed ahead of time (compute-comm overlap) can outlive
        its executor set: an executor that died after the schedule was built
        still owns a queue here, and the dispatch loop — which iterates live
        executors only — would silently drop those clients.  Orphaned tasks
        are appended round-robin onto the live queues (deterministic: orphan
        ids and live ids both in sorted order).  Returns the number of tasks
        re-homed.
        """
        live = sorted(live)
        orphans = sorted(k for k in self.assignment if k not in set(live))
        if not orphans or not live:
            return 0
        moved = 0
        for dead in orphans:
            for t in self.assignment.pop(dead):
                self.assignment.setdefault(live[moved % len(live)],
                                           []).append(t)
                moved += 1
        return moved


def _uniform(tasks: Sequence[ClientTask], executors: Sequence[int]) -> Dict[int, List[ClientTask]]:
    assignment: Dict[int, List[ClientTask]] = {k: [] for k in executors}
    for i, t in enumerate(tasks):
        assignment[executors[i % len(executors)]].append(t)
    return assignment


class ParrotScheduler:
    """Algorithm 3.  Stateless given the estimator — this is what makes
    elastic membership trivial: the executor set is an argument per round."""

    def __init__(self, estimator: WorkloadEstimator, warmup_rounds: int = 1,
                 policy: str = "parrot"):
        self.estimator = estimator
        self.warmup_rounds = warmup_rounds
        self.policy = policy

    def schedule(self, rnd: int, tasks: Sequence[ClientTask],
                 executors: Sequence[int],
                 comm_cost: Optional[Callable[[ClientTask], float]] = None
                 ) -> Schedule:
        """``comm_cost`` (network-aware runs) prices one task's round-trip
        comm — download the payload, upload the update on the client's link
        (Eq. 4's offset becomes payload- and bandwidth-aware).  The addend
        is executor-independent so it never flips a single argmin, but it
        accumulates into ``w[k]``: an executor whose queue holds slow-link
        clients looks fuller, and later tasks route around it — LPT then
        balances compute *plus* comm."""
        t0 = time.perf_counter()
        executors = list(executors)
        if self.policy == "none":
            assignment = _uniform(list(tasks), executors)
            return Schedule(assignment, float("nan"),
                            time.perf_counter() - t0, 0.0)
        if self.policy == "uniform" or rnd < self.warmup_rounds:
            assignment = _uniform(sorted(tasks, key=lambda t: -t.n_samples),
                                  executors)
            return Schedule(assignment, float("nan"),
                            time.perf_counter() - t0, 0.0)

        models = self.estimator.fit(rnd)
        est_time = self.estimator.fit_time_s
        t0 = time.perf_counter()
        assignment = {k: [] for k in executors}
        w = {k: 0.0 for k in executors}
        # executors with no history yet (fresh/elastic joiners) default to
        # the fleet average — a pessimistic default would starve them of
        # work forever (found by the hypothesis property suite)
        avg = fleet_average(models) or DEFAULT_MODEL
        mdl = {k: models.get(k, avg) for k in executors}
        for task in sorted(tasks, key=lambda t: -t.n_samples):   # LPT order
            t_comm = comm_cost(task) if comm_cost is not None else 0.0
            best_k, best_w = None, float("inf")
            for k in executors:                                   # Eq. 4
                cand = w[k] + mdl[k].predict(task.n_samples) + t_comm
                if cand < best_w:
                    best_k, best_w = k, cand
            assignment[best_k].append(task)
            w[best_k] = best_w
        return Schedule(assignment, max(w.values(), default=0.0),
                        time.perf_counter() - t0, est_time)


# ---------------------------------------------------------------------------
# chunk-granular helpers (event-driven engines)
# ---------------------------------------------------------------------------

def split_chunks(tasks: Sequence[ClientTask],
                 chunk_size: int) -> List[List[ClientTask]]:
    """Cut a queue into chunks of at most ``chunk_size`` tasks (queue order
    preserved — chunks are the engines' unit of dispatch, fold and steal)."""
    chunk_size = max(1, int(chunk_size))
    tasks = list(tasks)
    return [tasks[i:i + chunk_size] for i in range(0, len(tasks), chunk_size)]


def prefetch_ids(queue: Sequence[ClientTask], chunk_size: int) -> List[int]:
    """Client ids of a queue's NEXT dispatch chunk — the schedule-keyed
    hint the engines hand to ``ClientStateManager.prefetch`` right after
    dispatching the current chunk, so the following chunk's state shards
    stream into the RAM tier while this one computes."""
    return [t.client for t in queue[:max(1, int(chunk_size))]]


def predict_span(model: Optional[WorkloadModel],
                 tasks: Sequence[ClientTask],
                 comm: Optional[ChunkCommCost] = None) -> float:
    """Predicted virtual duration of one chunk run on an executor: Eq. 2 at
    the chunk's total sample count (chunk records fit b per chunk, so one
    offset per span — not one per task), plus the chunk's predicted comm
    time when a ``comm`` cost is bound (records stay compute-only, so the
    network term is added analytically, never fitted).  No model yet ->
    0.0, i.e. always optimistic during warmup — comm included, otherwise a
    warmup deadline would be pure comm and carry every chunk."""
    if model is None or not tasks:
        return 0.0
    out = model.predict(sum(t.n_samples for t in tasks))
    if comm is not None:
        out += comm([t.client for t in tasks])
    return out


def predict_remaining(model: Optional[WorkloadModel],
                      tasks: Sequence[ClientTask], chunk_size: int,
                      comm: Optional[ChunkCommCost] = None) -> float:
    """Predicted time to drain a queue chunk-by-chunk."""
    return sum(predict_span(model, c, comm)
               for c in split_chunks(tasks, chunk_size))


def pick_steal_victim(queues: Dict[int, List[ClientTask]],
                      avail: Dict[int, float],
                      models: Dict[int, WorkloadModel],
                      thief: int, chunk_size: int,
                      comm: Optional[ChunkCommCost] = None) -> Optional[int]:
    """The executor an idle ``thief`` should steal a chunk from: the one
    whose *predicted completion time* (availability + remaining queue under
    its fitted model, comm included when priced) is largest — the predicted
    straggler.  Ties break on the lower executor id (deterministic).
    Returns None when nobody has stealable work."""
    best_k, best_t = None, -float("inf")
    for k in sorted(queues):
        if k == thief or not queues[k]:
            continue
        done_at = avail.get(k, 0.0) + predict_remaining(
            models.get(k), queues[k], chunk_size, comm)
        if done_at > best_t:
            best_k, best_t = k, done_at
    return best_k


def makespan(assignment: Dict[int, List[ClientTask]],
             models: Dict[int, WorkloadModel]) -> float:
    """Predicted makespan of an assignment under given workload models."""
    out = 0.0
    for k, q in assignment.items():
        m = models.get(k, DEFAULT_MODEL)
        out = max(out, sum(m.predict(t.n_samples) for t in q))
    return out


# ---------------------------------------------------------------------------
# control plane (DESIGN.md §12): hindsight oracle + mid-run queue re-packing
# ---------------------------------------------------------------------------

#: one realized unit of folded work: (n_samples, time, executor, comm_s).
#: BSP collects one per task record, the DES engines one per folded chunk.
OracleJob = Tuple[float, float, int, float]


def oracle_makespan(jobs: Sequence[OracleJob],
                    executors: Sequence[int]) -> float:
    """Hindsight-optimal LPT makespan of the work that actually folded.

    From the realized jobs, derive each executor's *achieved* per-sample
    rate t_k = Σtime / Σn_samples (executors that ran nothing take the mean
    rate — they were available, the oracle may use them), then greedily
    re-pack the same jobs LPT onto the executor set: job ``j`` goes to
    ``argmin_k (w_k + n_j·t_k + comm_j)``.  Comm is executor-independent
    (a client's link doesn't change with placement) and priced serially
    into the lane, so an engine that overlaps comm with compute can beat
    this oracle — the gap can legitimately go negative.

    This is the denominator of the benchmarks' ``gap_to_oracle_pct``: what
    a scheduler with perfect knowledge of the realized spans would have
    achieved, with no estimation error, no deadline misses, and no idle
    lanes.  Deterministic: pure arithmetic over the jobs, no rng."""
    executors = sorted(set(executors))
    if not jobs or not executors:
        return 0.0
    tot_n = {k: 0.0 for k in executors}
    tot_t = {k: 0.0 for k in executors}
    for n, t, k, _c in jobs:
        if k in tot_n:
            tot_n[k] += float(n)
            tot_t[k] += float(t)
    rates = {k: tot_t[k] / tot_n[k] for k in executors if tot_n[k] > 0.0}
    if not rates:
        # every job ran on a since-dead executor: fleet rate from all jobs
        n_all = sum(float(n) for n, *_ in jobs)
        fleet = (sum(float(t) for _n, t, *_ in jobs) / n_all
                 if n_all > 0 else 0.0)
        rates = {}
    else:
        fleet = sum(rates.values()) / len(rates)
    t_k = {k: rates.get(k, fleet) for k in executors}
    w = {k: 0.0 for k in executors}
    order = sorted(range(len(jobs)),
                   key=lambda i: (-float(jobs[i][0]), i))   # LPT, stable
    for i in order:
        n, _t, _k0, comm = jobs[i]
        best_k, best_w = None, float("inf")
        for k in executors:
            cand = w[k] + float(n) * t_k[k] + float(comm)
            if cand < best_w:
                best_k, best_w = k, cand
        w[best_k] = best_w
    return max(w.values(), default=0.0)


def rebalance_queues(queues: Dict[int, List[ClientTask]],
                     horizons: Dict[int, float],
                     models: Dict[int, WorkloadModel],
                     comm_cost: Optional[Callable[[ClientTask], float]] = None
                     ) -> Tuple[Dict[int, List[ClientTask]], int]:
    """Re-pack every *undispatched* task across the executor set.

    The async engine's queues are built incrementally (one refill schedule
    per commit, each against the models of its moment), so under drifting
    device speeds the aggregate backlog goes stale.  This pools all queued
    tasks and re-runs the Eq. 4 LPT argmin over the CURRENT models, seeding
    each executor's load with its busy ``horizon`` (completion time of the
    in-flight chunk) — a busy-slow executor starts deep and sheds work to
    idle-fast ones.  In-flight work never moves, so nothing
    double-executes.  The async engine calls it at each commit under the
    control plane's ``rebalance`` lever (through ``DevicePlacement.rebalance``
    when the server has a placement).

    Deterministic: pool order is (executor, queue position), LPT ties break
    on that order.  Returns the new assignment (same keys as ``queues``)
    and the number of tasks whose executor changed."""
    keys = sorted(queues)
    pool: List[Tuple[int, ClientTask]] = [
        (k, t) for k in keys for t in queues[k]]
    if not pool:
        return {k: [] for k in keys}, 0
    avg = fleet_average(models) or DEFAULT_MODEL
    mdl = {k: models.get(k, avg) for k in keys}
    base = min(horizons.get(k, 0.0) for k in keys)
    w = {k: max(horizons.get(k, 0.0) - base, 0.0) for k in keys}
    assignment: Dict[int, List[ClientTask]] = {k: [] for k in keys}
    moved = 0
    order = sorted(range(len(pool)),
                   key=lambda i: (-pool[i][1].n_samples, i))
    for i in order:
        home, task = pool[i]
        t_comm = comm_cost(task) if comm_cost is not None else 0.0
        best_k, best_w = None, float("inf")
        for k in keys:
            cand = w[k] + mdl[k].predict(task.n_samples) + t_comm
            if cand < best_w:
                best_k, best_w = k, cand
        assignment[best_k].append(task)
        w[best_k] = best_w
        if best_k != home:
            moved += 1
    return assignment, moved

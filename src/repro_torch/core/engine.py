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

With a :class:`~repro_torch.core.network.NetworkModel` or a
``ClientAvailability`` on the server (DESIGN.md §9) the same event queue
carries comm: a chunk is busy for ``download + compute``, its upload ships
as a ``chunk_arrived`` :class:`~repro_torch.core.network.CommEvent` priced
``latency + wire_bytes/uplink`` at the partial's *achieved* (compressed)
size — under a top-k codec, the size of the top-k kernel's output — and
folds only when that event pops.  Under a fault plan (DESIGN.md §10)
crashes, restarts, dropouts, corrupt payloads, blackouts and slowdowns are
virtual-time events routed through each engine's re-run path.  With
neither (the defaults) every engine keeps its comm-free, fault-free path.

Under a device placement a BSP round whose queues plan into aligned block
waves runs each wave as one gang dispatch
(``executor.run_queues_ganged``); ``parallel_dispatch`` runs the BSP
executors in threads, each on its own CUDA stream.  With a control plane
(DESIGN.md §12) the DES engines gang their aligned chunk waves too
(``gang_waves``), semi-sync's deadline fraction and async's λ follow their
controllers, semi-sync steals into drained lanes and async re-packs its
queues at each commit (``rebalance``), downloads overlap earlier compute
(``overlap_comm``), and every engine reports the hindsight
``oracle_makespan``.  With telemetry (DESIGN.md §13) every engine records
its busy and upload spans and its fold, commit, steal and fault instants
on the virtual axis; recording reads values already computed, so it moves
no param and no makespan.  A checkpoint manager saves at each engine's
commit point; the engines' cross-round state round-trips through
``state_dict`` / ``load_state_dict``.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from repro_torch.core import tree
from repro_torch.core.aggregation import (merge_partials, payload_bytes,
                                          scale_partial, staleness_weight,
                                          wire_bytes)
from repro_torch.core.clock import VirtualClock
from repro_torch.core.executor import (ExecutorFailure, ExecutorReport,
                                       run_queues_ganged)
from repro_torch.core.faults import FaultCounters, scale_report
from repro_torch.core.network import CommEvent
from repro_torch.core.scheduler import (ClientTask, Schedule,
                                        oracle_makespan, pick_steal_victim,
                                        predict_remaining, predict_span,
                                        prefetch_ids, rebalance_queues)
from repro_torch.core.state_manager import _host_tree
from repro_torch.core.workload import RunRecord


def _ship_partial(srv, executor: int, compressed: Dict) -> Dict:
    """One partial across the comm layer: send -> poll (-> blocking recv on
    transports without immediate local delivery) -> decompress.  The copy
    that reaches aggregation is the one that crossed the wire, keeping
    error-feedback residuals in sync — the single definition both the
    comm-free fold path and the network pricer go through."""
    srv.comm.executor_send(executor, compressed, tag="partial")
    wire = srv.comm.poll(executor, tag="partial")
    if wire is None:
        wire = srv.comm.recv_from_executor(executor, tag="partial")
    return srv._maybe_decompress(wire)


def _run_parallel(srv, live: List[int], run) -> List[Tuple[str, Any]]:
    """BSP's parallel dispatch: ``run(k)`` for every live executor in a
    thread of its own, outcomes in completion order as ``("queue_done",
    report)`` or ``("executor_failed", k)``.

    An executor on a CUDA device runs on a stream of its own, which first
    waits for the server's stream (the round's payload); its timed spans
    wait for that stream alone (``device.synchronize``), so the threads'
    blocks can overlap on the card and a span holds no other thread's
    device work (its host issue still shares the GIL).  After the threads
    the server's stream waits for each executor stream, and every partial
    tensor is marked as used on the server's stream (``record_stream``), so
    the caching allocator cannot hand its memory out again while the
    global fold still reads it."""
    streams = {}
    for k in live:
        dev = srv.executors[k].device
        if dev.type == "cuda":
            streams[k] = torch.cuda.Stream(dev)
            streams[k].wait_stream(torch.cuda.current_stream(dev))

    def on_stream(k: int) -> ExecutorReport:
        if k not in streams:
            return run(k)
        with torch.cuda.stream(streams[k]):
            return run(k)

    out: List[Tuple[str, Any]] = []
    with cf.ThreadPoolExecutor(max_workers=len(live)) as pool:
        futs = {pool.submit(on_stream, k): k for k in live}
        for fut in cf.as_completed(futs):
            try:
                out.append(("queue_done", fut.result()))
            except ExecutorFailure:
                out.append(("executor_failed", futs[fut]))
    for s in streams.values():
        torch.cuda.current_stream(s.device).wait_stream(s)
    for kind, rep in out:
        if kind == "queue_done" and rep.executor in streams:
            for t in tree.leaves(rep.partial):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))
    return out


def _tasks_of(srv, clients) -> List[ClientTask]:
    """Rebuild ClientTasks from client ids (fault re-run pools carry ids —
    the sample counts come from the population registry, so no client
    batches materialise here)."""
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


def _trace_chunk(tele, k: int, t0: float, t1: float, rnd: int,
                 rep: ExecutorReport, down_s: float, **args) -> None:
    """Telemetry of one executor chunk (DESIGN.md §13): a busy span on
    ``exec:{k}`` covering the executor's whole occupancy ``[t0, t1]`` on the
    absolute virtual axis (``down_s``: its non-compute share, download and
    in-span wait), and the first-seen shapes it paid under ``host/``.
    Pure recording; a no-op without telemetry."""
    if tele is None:
        return
    if rep.n_tasks:
        tele.tracer.span(f"exec:{k}", "chunk", t0, t1, cat="busy",
                         args={"round": rnd, "n_tasks": rep.n_tasks,
                               "down_s": down_s, **args})
    if rep.compiles:
        tele.registry.counter(f"host/exec{k}/compiles").inc(rep.compiles)


def _trace_upload(tele, k: int, t0: float, t1: float, rnd: int,
                  wire_bytes: int, billed: float, **args) -> None:
    """One upload span on ``exec:{k}:up`` (uploads may overlap each other
    and the lane's next chunk); ``billed``: the bytes billed for it,
    timeout re-sends included."""
    if tele is not None:
        tele.tracer.span(f"exec:{k}:up", "upload", t0, t1, cat="comm",
                         args={"round": rnd, "wire_bytes": wire_bytes,
                               "billed_bytes": float(billed), **args})


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


class _NetSim:
    """Per-round comm/availability pricing (DESIGN.md §9).

    Created only when the server carries a :class:`NetworkModel` or a
    :class:`ClientAvailability` — the engines keep their comm-free code
    paths otherwise.  ``t0`` anchors this round's local event times on the
    server's cumulative virtual axis (``srv.virtual_now``); the async
    engine's clock is already cumulative, so it anchors at 0.  Byte counts
    come from shapes and dtypes (``wire_bytes``), never from a device sync.
    """

    def __init__(self, srv, t0: float):
        self.srv = srv
        self.net = srv.network
        self.avail = srv.availability
        self.t0 = t0
        self.payload_nbytes = srv._last_payload_nbytes
        self.time_up = 0.0
        self.time_down = 0.0
        self.bytes_up = 0
        self.dropped = 0

    def set_payload(self, payload: Dict) -> None:
        """Size the round's broadcast (what downloads are priced at)."""
        self.payload_nbytes = payload_bytes(payload)
        self.srv._last_payload_nbytes = self.payload_nbytes

    # -- pricing -----------------------------------------------------------
    def down(self, clients) -> float:
        """Price one model download to a chunk's clients (accounted)."""
        if self.net is None:
            return 0.0
        t = self.net.download_time(clients, self.payload_nbytes)
        self.time_down += t
        return t

    def up(self, clients, nbytes: int) -> float:
        """Price one partial upload at its achieved wire size (accounted:
        every re-send bills again)."""
        if self.net is None:
            return 0.0
        t = self.net.upload_time(clients, nbytes)
        self.time_up += t
        self.bytes_up += int(nbytes)
        return t

    def comm_pred(self, clients) -> float:
        """Predicted chunk comm span: broadcast down + upload estimated at
        the compressor's last achieved wire ratio."""
        if self.net is None:
            return 0.0
        return self.net.chunk_comm_time(
            clients, self.payload_nbytes,
            int(self.payload_nbytes * self.srv._wire_ratio))

    def ship(self, executor: int, partial: Dict) -> Tuple[Dict, int]:
        """Compress (the top-k kernel on the card under a top-k codec),
        measure the achieved wire size (what the upload is priced at),
        update the server's compression ratio for future predictions, then
        cross the wire via ``_ship_partial``."""
        srv = self.srv
        comp = srv._maybe_compress(partial, executor)
        nb = wire_bytes(comp)
        raw = wire_bytes(partial)
        if raw > 0:
            srv._wire_ratio = nb / raw
        return _ship_partial(srv, executor, comp), nb

    def push_chunk(self, clock: VirtualClock, rep: ExecutorReport,
                   start: float, done_data, record, version: int,
                   fi=None, counters: Optional[FaultCounters] = None,
                   overlap_from: Optional[float] = None) -> float:
        """Push one completed chunk's comm-priced event pair: ``chunk_done``
        at download+compute (the executor frees; ``done_data`` is the
        engine's handler payload) and — when the chunk did work — a
        ``chunk_arrived`` :class:`CommEvent` at +upload carrying the wire
        partial.  The single definition both DES engines dispatch through.
        Returns the compute-done time (the executor's ``busy_until``).

        With a :class:`FaultInjector` (``fi``) the upload leg additionally
        sees blackout pauses and the chunk timeout with backed-off re-sends
        (each re-send re-priced through the network model), then mid-upload
        client dropout; a payload lost in transit surfaces as an
        ``upload_lost`` event so each engine routes the clients into its
        own re-run pool.

        ``overlap_from`` (DESIGN.md §12, the control plane's
        ``overlap_comm``): the virtual time the chunk's payload version was
        broadcast.  The clients' download then overlaps whatever the
        executor computed since — the chunk starts at ``max(start,
        overlap_from + download)`` instead of serializing the download into
        its span.  ``None`` prices the download serially (the ``down`` read
        is accounted identically either way).  With telemetry, the chunk's
        busy span and its upload span (or lost upload) are recorded."""
        down_s = self.down(rep.completed_clients)
        if overlap_from is None:
            t_c = start + down_s + rep.virtual_time
        else:
            t_c = max(start, overlap_from + down_s) + rep.virtual_time
        clock.push(t_c, "chunk_done", done_data)
        tele = self.srv.telemetry
        _trace_chunk(tele, rep.executor, self.t0 + start, self.t0 + t_c,
                     version, rep, max(t_c - rep.virtual_time - start, 0.0))
        if rep.n_tasks:
            wirep, nb = self.ship(rep.executor, rep.partial)
            rep.wire_bytes = nb
            b_up0 = self.bytes_up
            up_s = self.up(rep.completed_clients, nb)
            if fi is None:
                t_arr = t_c + up_s
            else:
                # fault queries run on the absolute axis: t0 anchors this
                # round's local event times on srv.virtual_now
                t_abs = fi.price_upload(self.t0 + t_c, up_s, self,
                                        rep.completed_clients, nb, counters,
                                        executor=rep.executor)
                if t_abs is not None and fi.upload_lost(
                        rep.completed_clients, self.t0 + t_c, t_abs):
                    t_abs = None
                if t_abs is None:
                    _trace_upload(tele, rep.executor, self.t0 + t_c,
                                  self.t0 + t_c + up_s, version, nb,
                                  self.bytes_up - b_up0, lost=True)
                    clock.push(t_c, "upload_lost",
                               (rep.executor,
                                tuple(rep.completed_clients)))
                    return t_c
                t_arr = t_abs - self.t0
            _trace_upload(tele, rep.executor, self.t0 + t_c, self.t0 + t_arr,
                          version, nb, self.bytes_up - b_up0)
            clock.push(t_arr, "chunk_arrived", CommEvent(
                executor=rep.executor, partial=wirep, record=record,
                n_tasks=rep.n_tasks,
                completed_clients=tuple(rep.completed_clients),
                wire_bytes=nb, version=version, t_sent=t_c))
        return t_c

    # -- availability ------------------------------------------------------
    def split_available(self, tasks: List[ClientTask], start_local: float,
                        pred_dur: float
                        ) -> Tuple[List[ClientTask], List[ClientTask]]:
        """(runnable, dropped) at absolute time ``t0 + start_local``: a
        task drops when its client is offline now, or its remaining window
        is predicted too short for the chunk (mid-chunk expiry)."""
        if self.avail is None:
            return list(tasks), []
        t = self.t0 + start_local
        kept, dropped = [], []
        for task in tasks:
            if (self.avail.available(task.client, t)
                    and self.avail.remaining(task.client, t) >= pred_dur):
                kept.append(task)
            else:
                dropped.append(task)
        self.dropped += len(dropped)
        return kept, dropped

    def extra(self) -> Dict[str, float]:
        """Per-round comm-time/bytes + dropout metrics."""
        return {"comm_time_up": self.time_up,
                "comm_time_down": self.time_down,
                "comm_wire_bytes": float(self.bytes_up),
                "dropped_clients": float(self.dropped)}

    def reset_counters(self) -> None:
        """Start a new accounting window (the async engine keeps ONE pricer
        across rounds: chunks dispatched in a round's tail — after its
        metrics were read — bill the next window instead of vanishing)."""
        self.time_up = self.time_down = 0.0
        self.bytes_up = 0
        self.dropped = 0


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
    def _netsim(self, srv, t0: float) -> Optional[_NetSim]:
        """The round's comm/availability pricer, or None for the (default)
        comm-transparent configuration — in which case every engine takes
        its comm-free code path."""
        if srv.network is None and srv.availability is None:
            return None
        return _NetSim(srv, t0)

    def _fast_forward_empty(self, srv, reselect):
        """Nobody is selectable right now (availability gap): advance the
        server's virtual clock to the next time any client comes online and
        re-select.  Returns (tasks, idle_seconds)."""
        t_next = srv._next_available_time()
        if not math.isfinite(t_next):
            raise RuntimeError("availability trace leaves no client ever "
                               "available again")
        if t_next <= srv.virtual_now:
            return [], 0.0
        idle = t_next - srv.virtual_now
        srv.virtual_now = t_next
        return reselect(), idle

    def _advance_past_gap(self, srv) -> float:
        """Zero-progress round (every task dropped — offline, or online but
        predicted to expire mid-chunk): advance the server's virtual clock
        past the next availability boundary (window start for offline
        clients, window *end* for online ones) or the next round would
        repeat verbatim.  Returns the idle seconds added (0 if no jump)."""
        t_next = srv._next_available_time()
        if not (math.isfinite(t_next) and t_next > srv.virtual_now):
            t_next = srv._next_availability_change()
        if math.isfinite(t_next) and t_next > srv.virtual_now:
            idle = t_next - srv.virtual_now
            srv.virtual_now = t_next
            return idle
        return 0.0

    def _chunk_size(self, srv, override: Optional[int]) -> int:
        if override:
            return max(1, int(override))
        return max(e.client_block for e in srv.executors.values())

    def _wire(self, srv, executor: int, partial: Dict) -> Dict:
        """Ship one partial through the comm layer (compress → send → poll →
        decompress); see ``_ship_partial``."""
        return _ship_partial(srv, executor,
                             srv._maybe_compress(partial, executor))

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

    @staticmethod
    def _ctrl(srv):
        """The server's control plane (DESIGN.md §12), or None — in which
        case every controller hook below is skipped."""
        return srv.control

    def _gang_wave(self, srv, rnd: int, states: Dict[int, _ExecState],
                   clock: VirtualClock, payload: Dict, chunk: int,
                   candidates: List[int], mk_done,
                   t_base: float = 0.0) -> Set[int]:
        """Gang dispatch of one aligned DES chunk wave (DESIGN.md §12, the
        control plane's ``gang_waves``): when every idle candidate owns a
        head chunk and the wave gangs (``run_queues_ganged``'s gates: a
        placement, one shared device or K distinct ones, aligned block
        signatures), the wave runs as one client-step dispatch — on one
        card one ``(K·B_pad, …)`` vmap — and each report is consumed
        immediately: the chunk's ``chunk_done`` event is pushed here,
        exactly as the serial ``_dispatch_next`` would, so later queue
        mutations (steals, failures) can never orphan a pre-executed
        report.  Returns the ganged ids — the caller's serial dispatch loop
        skips them.  Gated to the comm-transparent fault-free
        configuration; under a ``TickTimer`` the ganged reports equal the
        serial path's.  On one shared device each lane is charged the
        whole wave (``run_queues_ganged``), so its busy span is the
        wave's."""
        if not (srv.gang_dispatch and srv.placement is not None
                and srv.faults is None):
            return set()
        ready = [k for k in candidates
                 if not states[k].inflight and not states[k].dead
                 and not states[k].stopped and states[k].queue]
        if len(ready) < 2:
            return set()
        heads = {k: states[k].queue[:chunk] for k in ready}
        reports = run_queues_ganged(srv.executors, rnd, heads, payload,
                                    srv.data_by_client, srv.placement)
        if reports is None:
            return set()
        ganged: Set[int] = set()
        for k in ready:
            es, rep = states[k], reports[k]
            es.queue = es.queue[len(heads[k]):]
            start = max(es.t, clock.now)
            es.offset += len(heads[k])
            es.inflight = True
            if es.queue and srv.algorithm.stateful:
                sm = srv.executors[k].state_manager
                if sm is not None:
                    sm.prefetch(prefetch_ids(es.queue, chunk))
            es.busy_until = start + rep.virtual_time
            clock.push(es.busy_until, "chunk_done", mk_done(k, rep))
            _trace_chunk(srv.telemetry, k, t_base + start,
                         t_base + es.busy_until, rnd, rep, 0.0, ganged=True)
            ganged.add(k)
        return ganged

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

    def _lifecycle(self, srv, t: float, counters: FaultCounters) -> None:
        """Fault-plan executor lifecycle at a round boundary: fire crashes
        that are due at absolute time ``t`` (retiring the executor until
        the paired restart), then revive executors whose restart came due.
        No-op without an active plan."""
        fi = srv.faults
        if fi is None:
            return
        for k in sorted(srv.executors):
            if fi.crash_due(k, t) is not None and fi.fire_crash(k, t):
                srv._drop_executor(k)
                counters.crashes += 1
        for k in fi.restarts_due(t):
            if srv._revive_executor(k):
                counters.restarts += 1
                if srv.telemetry is not None:
                    srv.telemetry.tracer.instant(f"exec:{k}", "restart", t,
                                                 cat="fault")
        if not srv.executors:
            raise RuntimeError("all executors failed")

    @staticmethod
    def _fault_extra(extra: Dict[str, float],
                     counters: FaultCounters) -> None:
        """Fold the round's fault accounting into ``extra`` under the
        unified schema every engine emits: ``retries``,
        ``corrupt_payloads`` and ``dropped_clients`` are always present
        (merging with any availability dropouts the netsim counted);
        lifecycle/timeout/quorum keys appear when they fired."""
        extra["retries"] = float(counters.retries)
        extra["corrupt_payloads"] = float(counters.corrupt_payloads)
        extra["dropped_clients"] = (extra.get("dropped_clients", 0.0)
                                    + float(counters.dropped_clients))
        if counters.crashes:
            extra["fault_crashes"] = float(counters.crashes)
        if counters.restarts:
            extra["fault_restarts"] = float(counters.restarts)
        if counters.timeouts:
            extra["chunk_timeouts"] = float(counters.timeouts)
        if counters.quorum_commits:
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
    associative; order is part of the result.

    With a network model the barrier waits on comm too: executor k's round
    span becomes ``download(queue) + Σ compute + upload(partial)``, the
    upload at the partial's *achieved* wire size — the fold order (and
    therefore the params) stays identical to the comm-free path; only the
    makespan moves.  With an availability model, offline clients are
    filtered at selection and clients predicted to leave before their queue
    position completes are dropped at dispatch.

    Under an active :class:`FaultPlan`: crashes due at the round boundary
    retire the executor before scheduling; a crash inside a queue's span
    discards its report and re-runs the clients on the survivors; slowdown
    windows stretch report spans; corrupted partials are detected after the
    ship and their clients re-run round-robin until the retry budget
    drains; with a network model the upload leg additionally sees
    blackouts, chunk timeouts with backed-off re-sends, and mid-upload
    dropout — a payload whose every re-send is exhausted loses its
    contribution for the round.  Re-runs themselves are not fault-checked.
    """

    mode = "bsp"

    def __init__(self, quorum_frac: float = 1.0):
        if not (0.0 < quorum_frac <= 1.0):
            raise ValueError("quorum_frac must be in (0, 1]")
        self.quorum_frac = float(quorum_frac)

    def run_round(self, srv):
        from repro_torch.core.round import RoundMetrics
        rnd = srv.round
        t_wall = time.perf_counter()
        counters = FaultCounters()
        self._lifecycle(srv, srv.virtual_now, counters)
        if srv._next_tasks is not None:
            tasks, srv._next_tasks = srv._next_tasks, None
        else:
            tasks = srv.select_clients()
        netsim = self._netsim(srv, srv.virtual_now)
        idle = 0.0
        if not tasks and netsim is not None:
            tasks, idle = self._fast_forward_empty(srv, srv.select_clients)
            netsim.t0 = srv.virtual_now
            # an overlapped schedule prepared for the pre-jump EMPTY cohort
            # is stale — the reselected clients must be scheduled fresh
            srv._pending_schedule = None

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
                rnd, tasks, list(srv.executors),
                comm_cost=srv._sched_comm_cost()), False

        payload = srv.algorithm.broadcast_payload(srv.params,
                                                  srv.server_state)
        if netsim is not None:
            netsim.set_payload(payload)
        skip_map, n_backups = srv._plan_backups(schedule)
        dropped: Set[int] = set()
        if netsim is not None and netsim.avail is not None:
            drop_map, dropped = self._plan_drops(srv, schedule, netsim)
            for k, s in drop_map.items():
                skip_map.setdefault(k, set()).update(s)
        reports, n_failed = self._dispatch(srv, rnd, schedule, payload,
                                           skip_map, netsim, dropped,
                                           counters=counters,
                                           n_total=len(tasks))

        # round span — computed before the overlap selection below, which
        # must see the server's virtual clock at this round's END
        fi = srv.faults
        ctrl = self._ctrl(srv)
        tele = srv.telemetry
        base = srv.virtual_now        # the barrier's absolute start
        kept = reports
        if netsim is None:
            makespan = max((r.virtual_time for r in reports), default=0.0)
            for r in reports:
                _trace_chunk(tele, r.executor, base, base + r.virtual_time,
                             rnd, r, 0.0)
        elif fi is None:
            if ctrl is not None and ctrl.overlap_comm:
                # comm/compute overlap (DESIGN.md §12): each client's
                # download runs concurrently with the lane's earlier
                # compute — task j starts at max(t_{j-1}, down_j)
                makespan = self._overlap_span(netsim, reports, tele=tele,
                                              base=base, rnd=rnd)
            else:
                # the barrier waits on comm events: each executor's span is
                # broadcast-download + compute + partial-upload (the upload
                # at the achieved wire size measured when the partial
                # shipped), in the JAX package's (d + vt) + u grouping
                makespan = 0.0
                for r in reports:
                    d = netsim.down(r.completed_clients)
                    u = netsim.up(r.completed_clients, r.wire_bytes)
                    end = d + r.virtual_time + u
                    _trace_chunk(tele, r.executor, base,
                                 base + (d + r.virtual_time), rnd, r, d)
                    if r.n_tasks:
                        _trace_upload(tele, r.executor,
                                      base + (d + r.virtual_time),
                                      base + end, rnd, r.wire_bytes,
                                      r.wire_bytes)
                    makespan = max(makespan, end)
        else:
            # fault-priced upload leg: blackout pauses + chunk timeout with
            # backed-off re-sends, then mid-upload dropout.  A payload that
            # never lands loses its round contribution (BSP has no carry
            # pool) but its compute still gates the barrier.
            spans: List[float] = []
            lost: Set[int] = set()
            for i, r in enumerate(reports):
                t_c = (netsim.t0 + netsim.down(r.completed_clients)
                       + r.virtual_time)
                b_up0 = netsim.bytes_up
                up_s = netsim.up(r.completed_clients, r.wire_bytes)
                _trace_chunk(tele, r.executor, base, t_c, rnd, r,
                             max(t_c - base - r.virtual_time, 0.0))
                if not r.n_tasks:
                    spans.append(t_c + up_s - netsim.t0)
                    continue
                t_abs = fi.price_upload(t_c, up_s, netsim,
                                        r.completed_clients, r.wire_bytes,
                                        counters, executor=r.executor)
                if t_abs is not None and fi.upload_lost(
                        r.completed_clients, t_c, t_abs):
                    t_abs = None
                if t_abs is None:
                    lost.add(i)
                    counters.dropped_clients += len(r.completed_clients)
                    spans.append(t_c - netsim.t0)
                    _trace_upload(tele, r.executor, t_c, t_c + up_s, rnd,
                                  r.wire_bytes, netsim.bytes_up - b_up0,
                                  lost=True)
                else:
                    spans.append(t_abs - netsim.t0)
                    _trace_upload(tele, r.executor, t_c, t_abs, rnd,
                                  r.wire_bytes, netsim.bytes_up - b_up0)
            makespan = max(spans, default=0.0)
            if lost:
                kept = [r for i, r in enumerate(reports) if i not in lost]
            fi.clear_retries(
                [c for r in kept for c in r.completed_clients])
        srv.virtual_now += makespan

        # overlap: prepare round r+1's schedule "while the reduce is in
        # flight" (before the global aggregate below consumes the partials)
        if srv.overlap_scheduling:
            srv.estimator.record_many(
                [rec for r in reports for rec in r.records])
            srv._next_tasks = srv.select_clients()
            srv._pending_schedule = srv.scheduler.schedule(
                rnd + 1, srv._next_tasks, list(srv.executors),
                comm_cost=srv._sched_comm_cost())

        partials = [r.partial for r in kept]      # already the wire copies
        if partials:   # every report lost in transit -> no update this round
            if tele is not None:
                tele.tracer.instant(
                    "server", "global_fold", base + makespan, cat="server",
                    args={"round": rnd, "n_partials": len(partials)})
            agg = srv.global_fold(partials)
            agg["_n_selected"] = sum(r.n_tasks for r in kept)
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
        if ctrl is not None:
            # hindsight-optimal repack of the realized per-task spans; comm
            # priced per client off the network model, unaccounted
            jobs = []
            for r in reports:
                for rec in r.records:
                    c = 0.0
                    if netsim is not None and netsim.net is not None:
                        c = netsim.net.client_comm_time(
                            rec.client, netsim.payload_nbytes,
                            int(netsim.payload_nbytes * srv._wire_ratio))
                    jobs.append((rec.n_samples, rec.time, rec.executor, c))
            extra["oracle_makespan"] = oracle_makespan(
                jobs, list(srv.executors))
        if remapped:
            extra["remapped_tasks"] = float(remapped)
        if netsim is not None:
            extra.update(netsim.extra())
            if makespan <= 0.0 and not any(r.n_tasks for r in reports):
                idle += self._advance_past_gap(srv)
        if idle:
            extra["idle_time"] = idle
        if srv.faults is not None or counters.quorum_commits:
            self._fault_extra(extra, counters)
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
    @staticmethod
    def _overlap_span(netsim: _NetSim, reports: List[ExecutorReport],
                      tele=None, base: float = 0.0, rnd: int = 0) -> float:
        """Barrier span with per-client downloads overlapping the lane's
        earlier compute (DESIGN.md §12; the control plane's
        ``overlap_comm`` selects it): task j starts at
        ``max(t_{j-1}, down_j)`` — the fold over the report's per-task
        records — then the partial's upload closes the lane.  The serial
        branch's accounted ``netsim.down`` call is preserved once per
        report (the per-client reads here are unaccounted), so
        ``comm_time_down`` matches the serial branch exactly; only the
        makespan moves."""
        span = 0.0
        for r in reports:
            d_acc = netsim.down(r.completed_clients)   # accounting parity
            if r.n_tasks and netsim.net is not None:
                t = 0.0
                for rec in r.records:
                    d = netsim.net.download_time([rec.client],
                                                 netsim.payload_nbytes)
                    t = max(t, d) + rec.time
            else:
                t = d_acc + r.virtual_time
            u = netsim.up(r.completed_clients, r.wire_bytes)
            _trace_chunk(tele, r.executor, base, base + t, rnd, r,
                         max(t - r.virtual_time, 0.0))
            if r.n_tasks:
                _trace_upload(tele, r.executor, base + t, base + (t + u),
                              rnd, r.wire_bytes, r.wire_bytes)
            span = max(span, t + u)
        return span

    def _plan_drops(self, srv, schedule: Schedule, netsim: _NetSim
                    ) -> Tuple[Dict[int, Set[int]], Set[int]]:
        """Clients predicted to leave before their queue position completes
        (cumulative span under the fitted model; optimistic during warmup,
        when no model exists).  They are skipped at dispatch via the same
        ``skip_clients`` hook the backup replicas use, and excluded from
        failure re-runs — the round loses their contribution, exactly as a
        real deployment would."""
        models = srv.estimator.last_fit
        avail, t0 = netsim.avail, netsim.t0
        skip: Dict[int, Set[int]] = {}
        dropped: Set[int] = set()
        for k in list(srv.executors):
            queue = schedule.queue(k)
            if not queue:
                continue
            m = models.get(k)
            t_off = 0.0
            if netsim.net is not None:
                t_off = netsim.net.download_time(
                    [t.client for t in queue], netsim.payload_nbytes)
            for task in queue:
                dur = m.predict(task.n_samples) if m is not None else 0.0
                if (not avail.available(task.client, t0)
                        or avail.remaining(task.client, t0) < t_off + dur):
                    skip.setdefault(k, set()).add(task.client)
                    dropped.add(task.client)
                else:
                    t_off += dur
        netsim.dropped += len(dropped)
        return skip, dropped

    # ------------------------------------------------------------------
    def _dispatch(self, srv, rnd: int, schedule: Schedule, payload: Dict,
                  skip_map: Optional[Dict[int, Set[int]]] = None,
                  netsim: Optional[_NetSim] = None,
                  dropped: Optional[Set[int]] = None,
                  counters: Optional[FaultCounters] = None,
                  n_total: int = 0
                  ) -> Tuple[List[ExecutorReport], int]:
        live = list(srv.executors)
        srv.comm.broadcast(payload, live, tag="broadcast")
        clock = VirtualClock()
        reports: List[ExecutorReport] = []
        failed: List[int] = []
        done_clients: set = set()

        def run(k: int) -> ExecutorReport:
            return srv.executors[k].run_queue(
                rnd, schedule.queue(k), payload, srv.data_by_client,
                skip_clients=(skip_map or {}).get(k))

        # gang dispatch (DESIGN.md §8): under a placement, a round whose
        # queues plan into aligned block waves runs each wave as one
        # client-step dispatch; the reports come back in executor order
        # with the content the serial path gives them
        ganged = None
        if srv.gang_dispatch and not srv.parallel_dispatch:
            ganged = run_queues_ganged(
                srv.executors, rnd, {k: schedule.queue(k) for k in live},
                payload, srv.data_by_client, srv.placement, skip_map)
        # barrier semantics: every outcome lands at t=0; seq order keeps the
        # executor order (completion order under parallel dispatch)
        if ganged is not None:
            for k in live:
                clock.push(0.0, "queue_done", ganged[k])
        elif srv.parallel_dispatch:
            for kind, data in _run_parallel(srv, live, run):
                clock.push(0.0, kind, data)
        else:
            for k in live:
                try:
                    clock.push(0.0, "queue_done", run(k))
                except ExecutorFailure:
                    clock.push(0.0, "executor_failed", k)
        for ev in clock.drain():
            if ev.kind == "queue_done":
                reports.append(ev.data)
            else:
                failed.append(ev.data)
                if srv.telemetry is not None:
                    srv.telemetry.tracer.instant(
                        f"exec:{ev.data}", "executor_failed",
                        srv.virtual_now, cat="fault")

        # ---- fault plan: slowdown windows + crashes inside the span ------
        fi = srv.faults
        if fi is not None:
            t0 = srv.virtual_now
            surviving: List[ExecutorReport] = []
            for rep in reports:
                scale_report(rep, fi.slowdown(rep.executor, t0))
                hit = (fi.crash_in(rep.executor, t0, t0 + rep.virtual_time)
                       if rep.n_tasks else None)
                if hit is not None:
                    # the executor died mid-queue: its report never reaches
                    # the server — the clients re-run through the failure
                    # path below
                    fi.fire_crash(rep.executor, hit[1])
                    if counters is not None:
                        counters.crashes += 1
                    failed.append(rep.executor)
                else:
                    surviving.append(rep)
            reports = surviving

        # ---- failures: re-run failed queues on the survivors -------------
        if failed:
            for rep in reports:
                done_clients.update(rep.completed_clients)
            survivors = [k for k in live if k not in failed]
            if not survivors:
                raise RuntimeError("all executors failed")
            # dedup by client: with backup duplicates a task can sit in two
            # failed queues at once and must still re-run (and fold) once.
            # Availability-dropped clients never re-run (they're offline).
            leftovers: List[ClientTask] = []
            for k in failed:
                for t in schedule.queue(k):
                    if t.client not in done_clients and \
                            t.client not in (dropped or ()):
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
        # sync).  Under a network model the achieved wire size is measured
        # here — it prices the upload leg of the barrier.
        for rep in reports:
            if netsim is not None:
                rep.partial, rep.wire_bytes = netsim.ship(rep.executor,
                                                          rep.partial)
            else:
                rep.partial = self._wire(srv, rep.executor, rep.partial)

        # ---- corruption: detect-and-re-run until the retry budget drains;
        # a corrupt partial is discarded before any fold -----------------
        if fi is not None and counters is not None:
            pending, checked, rr = list(reports), [], 0
            while pending:
                rep = pending.pop(0)
                if rep.n_tasks and fi.take_corrupt(
                        rep.executor, srv.virtual_now + rep.virtual_time):
                    counters.corrupt_payloads += 1
                    retryc, give_up = fi.charge_retry(rep.completed_clients)
                    counters.retries += len(retryc)
                    counters.dropped_clients += len(give_up)
                    live_ks = sorted(srv.executors)
                    for c in retryc:   # round-robin re-run, re-ship, re-check
                        k = live_ks[rr % len(live_ks)]
                        rr += 1
                        nrep = srv.executors[k].run_queue(
                            rnd, _tasks_of(srv, [c]), payload,
                            srv.data_by_client)
                        if netsim is not None:
                            nrep.partial, nrep.wire_bytes = netsim.ship(
                                k, nrep.partial)
                        else:
                            nrep.partial = self._wire(srv, k, nrep.partial)
                        pending.append(nrep)
                else:
                    checked.append(rep)
            reports = checked
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
    always makes progress.

    Under an active :class:`FaultPlan` every fault routes through the carry
    pool: crashes at dispatch or inside a chunk's span push the executor's
    failure event; mid-compute dropouts leave the chunk before it runs;
    corrupted / lost-in-transit partials charge the clients' retry budget
    and carry the survivors; slowdown windows stretch chunk spans AND the
    deadline's span predictions.  ``quorum_frac < 1.0`` commits the round
    early once ≥ that fraction of the selected tasks has folded — remaining
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
        self._round_steals = 0      # within-round only (ctrl.rebalance)

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
        counters = FaultCounters()
        self._lifecycle(srv, srv.virtual_now, counters)
        fi = srv.faults
        netsim = self._netsim(srv, srv.virtual_now)

        target = max(1, math.ceil(self.over_select * srv.clients_per_round))
        carried, self._carry = self._carry, []
        if netsim is not None and netsim.avail is not None and carried:
            # carried tasks bypass selection, so re-check them here: a
            # client still offline stays in the carry pool for later rounds
            online: List[ClientTask] = []
            for t in carried:
                (online if netsim.avail.available(t.client, srv.virtual_now)
                 else self._carry).append(t)
            carried = online
        n_fresh = max(0, target - len(carried))
        fresh = srv.select_clients(
            n=n_fresh, exclude=[t.client for t in carried])
        tasks = carried + fresh
        idle = 0.0
        if not tasks and netsim is not None:
            # exclude the carry pool: an offline carried client whose window
            # opens at the jump target must not ALSO be selected fresh (its
            # pending task would fold twice — once now, once from the carry)
            tasks, idle = self._fast_forward_empty(
                srv, lambda: srv.select_clients(
                    n=target, exclude=[t.client for t in self._carry]))
            netsim.t0 = srv.virtual_now
        schedule = srv.scheduler.schedule(rnd, tasks, list(srv.executors),
                                          comm_cost=srv._sched_comm_cost())
        payload = srv.algorithm.broadcast_payload(srv.params,
                                                  srv.server_state)
        if netsim is not None:
            netsim.set_payload(payload)
        live = list(srv.executors)
        srv.comm.broadcast(payload, live, tag="broadcast")

        models = dict(srv.estimator.last_fit)
        chunk = self._chunk_size(srv, self.chunk_size)
        # the round's anchor on the server's absolute virtual axis (fault
        # windows are declared in absolute time; local event times add abs0)
        abs0 = srv.virtual_now
        # the deadline lives in the units the executors accrue: the
        # chunk-granular predicted makespan of this schedule, comm delay
        # included when priced.  No models yet (warmup) -> ∞ -> a full BSP
        # round.
        comm_pred = netsim.comm_pred if netsim is not None else None
        pm = max((predict_remaining(
                      models.get(k) if fi is None
                      else fi.scaled_model(models.get(k), k, abs0),
                      schedule.queue(k), chunk, comm_pred)
                  for k in live), default=0.0)
        ctrl = self._ctrl(srv)
        frac = self.deadline_frac
        if ctrl is not None and ctrl.deadline is not None:
            # self-tuned deadline fraction (DESIGN.md §12): the controller
            # converges the landed/selected ratio to its target quantile
            frac = ctrl.deadline.current(self.deadline_frac)
        deadline = frac * pm if pm > 0.0 else float("inf")

        clock = VirtualClock()
        states = {k: _ExecState(queue=list(schedule.queue(k))) for k in live}
        partials: List[Dict] = []
        records: List[RunRecord] = []
        oracle_jobs: List[Tuple[float, float, int, float]] = []
        n_landed = 0
        n_failed = 0
        self._round_steals = 0
        committed = False       # quorum reached: queues drained to carry
        quorum_t = 0.0
        t_hi = 0.0              # latest processed event (network makespan)
        ganged: Set[int] = set()
        if ctrl is not None and ctrl.gang_waves and netsim is None:
            # first-wave gang: at round start every first chunk is exempt
            # from the deadline check, matching the serial dispatch exactly
            ganged = self._gang_wave(srv, rnd, states, clock, payload,
                                     chunk, live, lambda k, rep: (k, rep),
                                     t_base=abs0)
        for k in live:
            if k not in ganged:
                self._dispatch_next(srv, rnd, k, states, clock, payload,
                                    models, deadline, chunk, netsim,
                                    counters)
        while clock:
            ev = clock.pop()
            t_hi = max(t_hi, ev.time)
            if ev.kind == "chunk_done":
                k, rep = ev.data
                es = states[k]
                es.t, es.inflight = ev.time, False
                if netsim is None and rep.n_tasks:
                    if committed:
                        # landed after the quorum commit: carry, not fold
                        self._carry.extend(
                            _tasks_of(srv, rep.completed_clients))
                    elif fi is not None and fi.take_corrupt(
                            k, abs0 + ev.time):
                        # corrupt: discarded before it reaches the fold
                        counters.corrupt_payloads += 1
                        retryc, give_up = fi.charge_retry(
                            rep.completed_clients)
                        counters.retries += len(retryc)
                        counters.dropped_clients += len(give_up)
                        self._carry.extend(_tasks_of(srv, retryc))
                    else:
                        if srv.telemetry is not None:
                            srv.telemetry.tracer.instant(
                                "server", "fold", abs0 + ev.time,
                                cat="server",
                                args={"round": rnd, "executor": k,
                                      "n_tasks": rep.n_tasks})
                        partials.append(self._wire(srv, k, rep.partial))
                        rec = self._chunk_record(srv, rnd, rep)
                        if rec is not None:
                            records.append(rec)
                        n_landed += rep.n_tasks
                        if fi is not None:
                            fi.clear_retries(rep.completed_clients)
                self._dispatch_next(srv, rnd, k, states, clock, payload,
                                    models, deadline, chunk, netsim,
                                    counters)
            elif ev.kind == "chunk_arrived":
                # the chunk's upload landed: fold the wire copy it carried
                ce = ev.data
                if committed:
                    self._carry.extend(_tasks_of(srv, ce.completed_clients))
                elif fi is not None and fi.take_corrupt(
                        ce.executor, abs0 + ev.time):
                    counters.corrupt_payloads += 1
                    retryc, give_up = fi.charge_retry(ce.completed_clients)
                    counters.retries += len(retryc)
                    counters.dropped_clients += len(give_up)
                    self._carry.extend(_tasks_of(srv, retryc))
                else:
                    if srv.telemetry is not None:
                        srv.telemetry.tracer.instant(
                            "server", "fold", abs0 + ev.time, cat="server",
                            args={"round": rnd, "executor": ce.executor,
                                  "n_tasks": ce.n_tasks})
                        srv.telemetry.registry.histogram(
                            "hist/upload_delay").observe(
                                max(ev.time - ce.t_sent, 0.0))
                    partials.append(ce.partial)
                    if ce.record is not None:
                        records.append(ce.record)
                        if ctrl is not None:
                            oracle_jobs.append((
                                ce.record.n_samples, ce.record.time,
                                ce.record.executor,
                                netsim.net.chunk_comm_time(
                                    list(ce.completed_clients),
                                    netsim.payload_nbytes, ce.wire_bytes)
                                if netsim.net is not None else 0.0))
                    n_landed += ce.n_tasks
                    if fi is not None:
                        fi.clear_retries(ce.completed_clients)
            elif ev.kind == "upload_lost":
                # every re-send timed out, or a client dropped mid-upload:
                # the partial never reached the server — charge the budget,
                # carry the clients that may retry
                _k, lost_clients = ev.data
                retryc, give_up = fi.charge_retry(lost_clients)
                counters.retries += len(retryc)
                counters.dropped_clients += len(give_up)
                self._carry.extend(_tasks_of(srv, retryc))
            else:  # executor_failed
                dead, remaining = ev.data
                n_failed += 1
                if srv.telemetry is not None:
                    srv.telemetry.tracer.instant(
                        f"exec:{dead}", "executor_failed", abs0 + ev.time,
                        cat="fault")
                survivors = self._fail_over(srv, states, dead, remaining)
                for j in survivors:
                    if states[j].stopped:
                        # already past the deadline: re-homed tasks carry
                        # over instead of silently parking on a stopped queue
                        self._carry.extend(states[j].queue)
                        states[j].queue = []
                    elif not states[j].inflight:  # wake finished survivors
                        self._dispatch_next(srv, rnd, j, states, clock,
                                            payload, models, deadline, chunk,
                                            netsim, counters)
            if not committed and self.quorum_frac < 1.0 and tasks \
                    and n_landed >= self.quorum_frac * len(tasks):
                # quorum-degraded commit: enough of the selected weight has
                # folded — the round closes here; everything still queued
                # (or landing later) re-enters through the carry pool
                committed, quorum_t = True, ev.time
                counters.quorum_commits += 1
                if srv.telemetry is not None:
                    srv.telemetry.tracer.instant(
                        "server", "quorum_commit", abs0 + ev.time,
                        cat="server",
                        args={"round": rnd, "n_landed": n_landed})
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
        if netsim is not None:
            # the round is not over until the last counted upload landed
            makespan = max(makespan, t_hi)
        if committed:
            # the round committed at quorum: in-flight stragglers finished
            # after the commit carried over instead of counting
            makespan = quorum_t
        stats = srv.comm.stats.reset()
        extra = {"landed_clients": float(n_landed),
                 "carried_tasks": float(len(self._carry)),
                 "deadline": deadline}
        if ctrl is not None:
            extra["deadline_frac"] = frac
            if netsim is None:
                # comm-transparent folds all land at chunk_done: the round's
                # records ARE the realized jobs (comm = 0)
                oracle_jobs = [(r.n_samples, r.time, r.executor, 0.0)
                               for r in records]
            extra["oracle_makespan"] = oracle_makespan(
                oracle_jobs, list(srv.executors))
            if ctrl.rebalance:
                extra["rebalanced_tasks"] = float(self._round_steals)
            if ctrl.deadline is not None and deadline != float("inf"):
                # one controller step per round from this round's observed
                # landed/selected ratio (applies from the NEXT round);
                # warmup rounds (deadline ∞, everything lands) carry no
                # signal and are skipped
                new_frac = ctrl.deadline.update(n_landed, len(tasks),
                                                self.deadline_frac,
                                                1.0 / self.over_select)
                ctrl.note("deadline_frac", new_frac, abs0 + makespan)
        if netsim is not None:
            extra.update(netsim.extra())
            if makespan <= 0.0 and n_landed == 0:
                idle += self._advance_past_gap(srv)
        if idle:
            extra["idle_time"] = idle
        if fi is not None or counters.quorum_commits:
            self._fault_extra(extra, counters)
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
                       deadline, chunk, netsim=None, counters=None) -> None:
        fi = srv.faults
        abs0 = netsim.t0 if netsim is not None else srv.virtual_now
        es = states[k]
        ctrl = self._ctrl(srv)
        while True:
            if not es.queue and not es.stopped and not es.dead \
                    and ctrl is not None and ctrl.rebalance:
                # deadline-aware work stealing (DESIGN.md §12): a drained
                # lane takes the predicted-straggler's tail chunk instead
                # of idling out the deadline; the stolen chunk still faces
                # the per-chunk deadline check below on the thief's clock
                self._steal_next(srv, k, states, models, chunk, netsim,
                                 clock, abs0)
            if not es.queue or es.stopped or es.dead:
                return
            next_chunk = es.queue[:chunk]
            start = max(es.t, clock.now)
            comm_pred = netsim.comm_pred if netsim is not None else None
            model = models.get(k)
            if fi is not None:
                model = fi.scaled_model(model, k, abs0 + start)
            pred = predict_span(model, next_chunk, comm_pred)
            if es.t > 0.0 and start + pred > deadline:
                # predicted to miss the deadline: stop here, carry the rest
                # (first chunk is exempt — a round always makes progress)
                es.stopped = True
                self._carry.extend(es.queue)
                es.queue = []
                return
            es.queue = es.queue[chunk:]
            if fi is not None:
                if fi.crash_due(k, abs0 + start) is not None:
                    # crash due before this chunk dispatches: the executor
                    # is dead now, the chunk and queue re-home
                    fi.fire_crash(k, abs0 + start)
                    if counters is not None:
                        counters.crashes += 1
                    clock.push(start, "executor_failed",
                               (k, next_chunk + es.queue))
                    es.queue = []
                    es.dead = True
                    return
                # mid-compute dropout: clients whose window opens inside
                # the predicted span leave the chunk and carry over
                next_chunk, f_drop = fi.split_up(next_chunk, abs0 + start,
                                                 pred)
                if f_drop:
                    if counters is not None:
                        counters.dropped_clients += len(f_drop)
                    self._carry.extend(f_drop)
                if not next_chunk:
                    continue        # whole chunk dropped: try the next one
            if netsim is not None:
                # availability dropout: offline / predicted-to-expire
                # clients leave the chunk and re-enter through the carry
                # pool (the deadline path's re-run mechanism)
                next_chunk, av_dropped = netsim.split_available(
                    next_chunk, start, pred)
                self._carry.extend(av_dropped)
                if not next_chunk:
                    continue        # whole chunk offline: try the next one
            try:
                rep = srv.executors[k].run_queue(
                    rnd, next_chunk, payload, srv.data_by_client,
                    task_offset=es.offset)
            except ExecutorFailure:
                # the failing chunk never folded: every one of its clients
                # must re-home along with the rest of the queue.  The
                # executor is dead the moment the event is pushed — nothing
                # may dispatch on it while the event waits in the queue.
                clock.push(start, "executor_failed",
                           (k, next_chunk + es.queue))
                es.queue = []
                es.dead = True
                return
            es.offset += len(next_chunk)
            es.inflight = True
            if es.queue and srv.algorithm.stateful:
                # schedule-keyed prefetch: stage the next chunk's state
                # shards while this chunk's span elapses on the virtual clock
                sm = srv.executors[k].state_manager
                if sm is not None:
                    sm.prefetch(prefetch_ids(es.queue, chunk))
            if fi is not None:
                scale_report(rep, fi.slowdown(k, abs0 + start))
                # crash inside the chunk's span (download + compute; the
                # download read off the network model UNACCOUNTED — the
                # real billing happens in push_chunk, this is a window
                # bound): the chunk is lost, the queue re-homes at the
                # crash time
                down_un = 0.0
                if netsim is not None and netsim.net is not None \
                        and rep.n_tasks:
                    down_un = netsim.net.download_time(
                        rep.completed_clients, netsim.payload_nbytes)
                hit = fi.crash_in(k, abs0 + start,
                                  abs0 + start + down_un + rep.virtual_time)
                if hit is not None:
                    fi.fire_crash(k, hit[1])
                    if counters is not None:
                        counters.crashes += 1
                    clock.push(hit[1] - abs0, "executor_failed",
                               (k, next_chunk + es.queue))
                    es.queue = []
                    es.dead = True
                    return
            if netsim is None:
                es.busy_until = start + rep.virtual_time
                clock.push(es.busy_until, "chunk_done", (k, rep))
                _trace_chunk(srv.telemetry, k, abs0 + start,
                             abs0 + es.busy_until, rnd, rep, 0.0)
                return
            # comm-priced chunk: the executor is busy for download +
            # compute, then free — the upload overlaps its next chunk and
            # lands as its own arrival event, which is when the fold counts
            es.busy_until = netsim.push_chunk(
                clock, rep, start, (k, rep),
                self._chunk_record(srv, rnd, rep), version=rnd,
                fi=fi, counters=counters,
                # the round's payload was broadcast at local t=0: with
                # overlap_comm on, the download runs concurrently with the
                # lane's earlier chunks instead of serializing into this one
                overlap_from=(0.0 if ctrl is not None and ctrl.overlap_comm
                              else None))
            return

    def _steal_next(self, srv, k, states, models, chunk, netsim,
                    clock, abs0) -> None:
        """Move the predicted-straggler's tail chunk onto drained lane
        ``k`` (``ctrl.rebalance``; the async engine's victim policy).
        Deterministic: victim choice and the moved slice depend only on the
        queues and fitted models."""
        queues = {j: es.queue for j, es in states.items()
                  if not es.stopped and not es.dead}
        avail = {j: max(states[j].t, states[j].busy_until) for j in queues}
        victim = pick_steal_victim(
            queues, avail, models, k, chunk,
            netsim.comm_pred if netsim is not None else None)
        if victim is None:
            return
        vq = states[victim].queue
        take = max(1, min(chunk, len(vq)))
        states[k].queue = vq[-take:]
        states[victim].queue = vq[:-take]
        self._round_steals += 1
        if srv.telemetry is not None:
            srv.telemetry.tracer.instant(
                f"exec:{k}", "steal", abs0 + clock.now, cat="sched",
                args={"victim": victim, "n_tasks": take})


# ---------------------------------------------------------------------------
# async (bounded staleness)
# ---------------------------------------------------------------------------

class AsyncEngine(RoundEngine):
    """Continuous bounded-staleness federation.

    The engine persists across ``run_round`` calls: executor virtual clocks,
    queues and in-flight chunks carry over, so "round r" is just the span
    between server updates r and r+1 on the shared virtual axis.  Each
    folded chunk is discounted by γ = 1/(1+λ·s) where s counts the server
    updates since the chunk's dispatch (its arrival, under a network); the
    server updates after ``goal`` (default ``clients_per_round``) clients
    have folded, then broadcasts the new payload, re-schedules a fresh
    selection on the live executors with the current workload models, and
    wakes any idle executor.  An executor with an empty queue steals the
    tail chunk of the predicted-slowest queue before going idle.
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
        self._pricer: Optional[_NetSim] = None   # persists across rounds
        self._clock = VirtualClock()
        self._in_system: Set[int] = set()
        self._last_update_t = 0.0
        self._last_sched: Optional[Schedule] = None
        self._payload: Optional[Dict] = None
        # virtual time the live payload version was broadcast (the comm
        # overlap anchor: a chunk's download can start no earlier)
        self._payload_t = 0.0
        self._reset_window()

    def _reset_window(self) -> None:
        """Clear the per-update accumulators (one 'round' = one window)."""
        self._buffer: Optional[Dict] = None
        self._n_folded = 0
        self._records: List[RunRecord] = []
        self._n_failed = 0
        self._steals = 0
        self._stale_folds = 0
        self._stale_sum = 0.0
        self._counters = FaultCounters()
        # control-plane accumulators (inert without a control plane): the
        # window's realized (n, t, executor, comm) jobs for the oracle, and
        # tasks moved by the commit-tail queue rebalance
        self._oracle_jobs: List[Tuple[float, float, int, float]] = []
        self._rebalance_moved = 0

    # -- checkpointing of the in-flight pipeline ---------------------------
    # The engine persists across rounds, so a checkpoint taken at an update
    # boundary still has a live pipeline: undispatched queues, in-flight
    # chunk completions and uploads sitting in the clock (their partials
    # already computed and folded into nothing yet), the payload version
    # executors are training against, and the window accumulators.  All of
    # it is serialised host-side (CPU tensors) as plain data; restore moves
    # the tensors back onto the server's device and rebuilds the clock heap
    # with the exact (time, seq) ordering, so the resumed run pops the same
    # events in the same order and stays bit-deterministic.  (Client states
    # and the server blob ride the normal checkpoint path; the executor
    # topology must match on restore.)
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
            if kind == "chunk_arrived":    # in-flight upload (CommEvent)
                return dataclasses.replace(data,
                                           partial=_host_tree(data.partial))
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
            "counters": vars(self._counters).copy(),
            "last_sched": self._last_sched,
            "payload_t": self._payload_t,
            "oracle_jobs": [tuple(j) for j in self._oracle_jobs],
            "rebalance_moved": self._rebalance_moved,
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
            elif kind == "chunk_arrived":
                data = dataclasses.replace(
                    data, partial=_on(data.partial, device))
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
        self._counters = FaultCounters(**state.get("counters", {}))
        self._last_sched = state["last_sched"]
        # control-plane state (absent in checkpoints written without it)
        self._payload_t = state.get("payload_t", 0.0)
        self._oracle_jobs = [tuple(j) for j in state.get("oracle_jobs", [])]
        self._rebalance_moved = state.get("rebalance_moved", 0)

    # ------------------------------------------------------------------
    def _ensure_init(self, srv, netsim: Optional[_NetSim] = None) -> None:
        if self._states is not None:
            return
        srv.virtual_now = self._clock.now
        self._payload = srv.algorithm.broadcast_payload(srv.params,
                                                        srv.server_state)
        if netsim is not None:
            netsim.set_payload(self._payload)
        live = list(srv.executors)
        srv.comm.broadcast(self._payload, live, tag="broadcast")
        self._payload_t = self._clock.now
        n0 = max(1, math.ceil(self.pipeline_depth * srv.clients_per_round))
        tasks = srv.select_clients(n=n0)
        schedule = srv.scheduler.schedule(srv.round, tasks, live,
                                          comm_cost=srv._sched_comm_cost())
        self._last_sched = schedule
        self._states = {k: _ExecState(queue=list(schedule.queue(k)))
                        for k in live}
        self._in_system = {t.client for t in tasks}
        ctrl = self._ctrl(srv)
        ganged: Set[int] = set()
        if ctrl is not None and ctrl.gang_waves and netsim is None:
            chunk = self._chunk_size(srv, self.chunk_size)
            ganged = self._gang_wave(
                srv, srv.round, self._states, self._clock, self._payload,
                chunk, live, lambda k, rep: (k, rep, srv.round))
        for k in live:
            if k not in ganged:
                self._dispatch_next(srv, k, netsim)

    def _refill(self, srv) -> None:
        """Top the pool back up with a fresh selection, re-scheduled onto
        the live executors under the *current* workload models (clients
        already in the system are excluded — a client must fold before it
        can be picked again, which keeps stateful algorithms race-free)."""
        # an executor whose failure event is still in flight gets no new
        # work (it would only need re-homing when the event pops)
        live = [k for k in srv.executors if not self._states[k].dead]
        srv.virtual_now = self._clock.now   # availability filter anchor
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
    def _lambda(self, srv) -> float:
        """The staleness λ folds discount with: the controller's current
        value when an :class:`AsyncLambdaController` is attached (DESIGN.md
        §12), else the engine's static ``staleness_lambda`` — which is also
        the controller's fallback before its first update."""
        ctrl = self._ctrl(srv)
        if ctrl is not None and ctrl.async_lambda is not None:
            return ctrl.async_lambda.current(self.staleness_lambda)
        return self.staleness_lambda

    def _dispatch_next(self, srv, k: int,
                       netsim: Optional[_NetSim] = None) -> None:
        es = self._states[k]
        if es.dead:
            return
        fi = srv.faults    # async clock is absolute: fault times are local
        chunk = self._chunk_size(srv, self.chunk_size)
        comm_pred = netsim.comm_pred if netsim is not None else None
        while True:
            if not es.queue:
                # work stealing: grab the tail chunk of the predicted-
                # slowest queue (its owner was never going to reach it soon
                # anyway)
                victim = pick_steal_victim(
                    {j: s.queue for j, s in self._states.items()},
                    {j: (s.busy_until if s.inflight else s.t)
                     for j, s in self._states.items()},
                    srv.estimator.last_fit, k, chunk, comm_pred)
                if victim is None:
                    return        # nothing anywhere: idle until refill
                vq = self._states[victim].queue
                es.queue, self._states[victim].queue = \
                    vq[-chunk:], vq[:-chunk]
                self._steals += 1
                if srv.telemetry is not None:
                    srv.telemetry.tracer.instant(
                        f"exec:{k}", "steal", self._clock.now, cat="sched",
                        args={"victim": victim, "n_tasks": len(es.queue)})
            tasks, es.queue = es.queue[:chunk], es.queue[chunk:]
            start = max(es.t, self._clock.now)
            if fi is not None and fi.crash_due(k, start) is not None:
                # crash due before this chunk dispatches: dead now, the
                # chunk and queue re-home through the failure event
                fi.fire_crash(k, start)
                self._counters.crashes += 1
                self._clock.push(start, "executor_failed",
                                 (k, tasks + es.queue))
                es.queue = []
                es.dead = True
                return
            if netsim is not None or fi is not None:
                model = srv.estimator.last_fit.get(k)
                if fi is not None:
                    model = fi.scaled_model(model, k, start)
                pred = predict_span(model, tasks, comm_pred)
            if fi is not None:
                # mid-compute dropout: dropped clients leave the system so
                # a later refill can re-select them once their window ends
                tasks, f_drop = fi.split_up(tasks, start, pred)
                if f_drop:
                    self._counters.dropped_clients += len(f_drop)
                    self._in_system.difference_update(
                        t.client for t in f_drop)
                if not tasks:
                    continue      # whole chunk dropped: try the next one
            if netsim is not None:
                # availability dropout: dropped clients leave the system so
                # a later refill can re-select them once they're back — the
                # async re-run path
                tasks, av_dropped = netsim.split_available(tasks, start,
                                                           pred)
                self._in_system.difference_update(
                    t.client for t in av_dropped)
                if not tasks:
                    continue      # whole chunk offline: try the next one
            rnd = srv.round
            try:
                rep = srv.executors[k].run_queue(
                    rnd, tasks, self._payload, srv.data_by_client,
                    task_offset=es.offset)
            except ExecutorFailure:
                self._clock.push(start, "executor_failed",
                                 (k, tasks + es.queue))
                es.queue = []
                es.dead = True   # no re-dispatch while the event is in flight
                return
            es.offset += len(tasks)
            es.inflight = True
            if es.queue and srv.algorithm.stateful:
                # schedule-keyed prefetch: the next chunk's state shards
                # stage while this chunk's span elapses on the virtual clock
                sm = srv.executors[k].state_manager
                if sm is not None:
                    sm.prefetch(prefetch_ids(es.queue, chunk))
            if fi is not None:
                scale_report(rep, fi.slowdown(k, start))
                down_un = 0.0   # unaccounted read: push_chunk does billing
                if netsim is not None and netsim.net is not None \
                        and rep.n_tasks:
                    down_un = netsim.net.download_time(
                        rep.completed_clients, netsim.payload_nbytes)
                hit = fi.crash_in(k, start,
                                  start + down_un + rep.virtual_time)
                if hit is not None:
                    # died inside the chunk's span: chunk lost, queue
                    # re-homes at the crash time
                    fi.fire_crash(k, hit[1])
                    self._counters.crashes += 1
                    self._clock.push(hit[1], "executor_failed",
                                     (k, tasks + es.queue))
                    es.queue = []
                    es.dead = True
                    return
            if netsim is None:
                es.busy_until = start + rep.virtual_time
                self._clock.push(es.busy_until, "chunk_done", (k, rep, rnd))
                _trace_chunk(srv.telemetry, k, start, es.busy_until, rnd,
                             rep, 0.0)
                return
            # comm-priced chunk: busy for download + compute; the upload
            # overlaps the next chunk and folds when its arrival event pops
            # (staleness then counts server updates across the comm delay)
            ctrl = self._ctrl(srv)
            es.busy_until = netsim.push_chunk(
                self._clock, rep, start, (k, rep, rnd),
                self._chunk_record(srv, rnd, rep), version=rnd,
                fi=fi, counters=self._counters,
                # the live payload was broadcast at _payload_t: with
                # overlap_comm on, the download overlaps the lane's earlier
                # compute instead of serializing into this chunk's span
                overlap_from=(self._payload_t
                              if ctrl is not None and ctrl.overlap_comm
                              else None))
            return

    def _fold(self, srv, wire: Dict, version: int, t: float,
              executor: int, n_tasks: int,
              upload_delay: Optional[float] = None) -> None:
        """Fold one landed partial into the window's buffer at virtual time
        ``t``, discounted by the staleness accrued since its payload
        version under the controller's λ (``_lambda``).  With telemetry:
        the fold instant and the staleness (and upload-delay)
        histograms."""
        s = srv.round - version
        if srv.telemetry is not None:
            srv.telemetry.tracer.instant(
                "server", "fold", t, cat="server",
                args={"round": srv.round, "executor": executor,
                      "n_tasks": n_tasks, "staleness": s})
            reg = srv.telemetry.registry
            reg.histogram("hist/staleness").observe(s)
            if upload_delay is not None:
                reg.histogram("hist/upload_delay").observe(upload_delay)
        gamma = staleness_weight(s, self._lambda(srv))
        self._buffer = merge_partials(self._buffer,
                                      scale_partial(wire, gamma))
        if s > 0:
            self._stale_folds += 1
        self._stale_sum += s

    def _discard_corrupt(self, fi, clients) -> None:
        """A corrupt partial is discarded before it reaches the buffer;
        clients with retry budget left leave the system so the next refill
        re-selects them (the async re-run path)."""
        self._counters.corrupt_payloads += 1
        retryc, give_up = fi.charge_retry(clients)
        self._counters.retries += len(retryc)
        self._counters.dropped_clients += len(give_up)
        fi.clear_retries(give_up)
        self._in_system.difference_update(clients)

    # ------------------------------------------------------------------
    def run_round(self, srv):
        from repro_torch.core.round import RoundMetrics
        t_wall = time.perf_counter()
        # ONE pricer for the engine's whole life (the pipeline crosses
        # round boundaries, so tail dispatches must bill the next window);
        # the async clock is already absolute, so it anchors at t0=0
        if self._pricer is None:
            self._pricer = self._netsim(srv, 0.0)
        netsim = self._pricer
        # fault lifecycle at the window boundary: revive executors whose
        # restart came due (crashes fire at dispatch granularity inside
        # _dispatch_next — the async clock never jumps a round at a time)
        fi = srv.faults
        if fi is not None:
            for k in fi.restarts_due(self._clock.now):
                if srv._revive_executor(k):
                    self._counters.restarts += 1
                    if srv.telemetry is not None:
                        srv.telemetry.tracer.instant(
                            f"exec:{k}", "restart", self._clock.now,
                            cat="fault")
                    if self._states is not None:
                        self._states[k] = _ExecState(t=self._clock.now)
        self._ensure_init(srv, netsim)
        rnd = srv.round
        goal = self.goal or srv.clients_per_round

        futile_wakes = 0   # boundary-jumps without a single dispatch
        while self._n_folded < goal:
            if not self._clock:
                if self._n_folded > 0:
                    break          # drained: update with what we have
                self._refill(srv)
                for k in list(self._states):
                    if not self._states[k].inflight:
                        self._dispatch_next(srv, k, netsim)
                if not self._clock:
                    if netsim is not None and netsim.avail is not None:
                        # nobody dispatchable: sleep until the next client
                        # comes online — or, if clients are online but every
                        # dispatch predicted a mid-chunk expiry, until an
                        # availability window flips
                        t_next = srv._next_available_time(
                            exclude=self._in_system)
                        if t_next <= self._clock.now:
                            t_next = srv._next_availability_change(
                                exclude=self._in_system)
                        futile_wakes += 1
                        if math.isfinite(t_next) and futile_wakes <= 256:
                            self._clock.push(
                                max(t_next, self._clock.now + 1e-9),
                                "wake", None)
                            continue
                        if futile_wakes > 256:
                            raise RuntimeError(
                                "async engine starved: every availability "
                                "window is predicted too short for a chunk "
                                "(256 futile window-boundary jumps)")
                    raise RuntimeError("async engine starved: no runnable "
                                       "clients on any executor")
                continue
            ev = self._clock.pop()
            srv.virtual_now = self._clock.now
            if ev.kind != "wake":
                futile_wakes = 0          # real progress resets the bound
            if ev.kind == "chunk_done":
                k, rep, version = ev.data
                es = self._states[k]
                es.t, es.inflight = ev.time, False
                if netsim is None and rep.n_tasks:
                    if fi is not None and fi.take_corrupt(k, ev.time):
                        self._discard_corrupt(fi, rep.completed_clients)
                    else:
                        self._fold(srv, self._wire(srv, k, rep.partial),
                                   version, ev.time, k, rep.n_tasks)
                        self._n_folded += rep.n_tasks
                        rec = self._chunk_record(srv, version, rep)
                        if rec is not None:
                            self._records.append(rec)
                            if self._ctrl(srv) is not None:
                                self._oracle_jobs.append(
                                    (rec.n_samples, rec.time,
                                     rec.executor, 0.0))
                        self._in_system.difference_update(
                            rep.completed_clients)
                        if fi is not None:
                            fi.clear_retries(rep.completed_clients)
                self._dispatch_next(srv, k, netsim)
            elif ev.kind == "chunk_arrived":
                # the upload landed: fold it, discounted by the staleness
                # accrued across compute AND comm delay
                ce = ev.data
                if fi is not None and fi.take_corrupt(ce.executor, ev.time):
                    self._discard_corrupt(fi, ce.completed_clients)
                else:
                    self._fold(srv, ce.partial, ce.version, ev.time,
                               ce.executor, ce.n_tasks,
                               upload_delay=max(ev.time - ce.t_sent, 0.0))
                    self._n_folded += ce.n_tasks
                    if ce.record is not None:
                        self._records.append(ce.record)
                        if self._ctrl(srv) is not None:
                            self._oracle_jobs.append((
                                ce.record.n_samples, ce.record.time,
                                ce.record.executor,
                                netsim.net.chunk_comm_time(
                                    list(ce.completed_clients),
                                    netsim.payload_nbytes, ce.wire_bytes)
                                if netsim.net is not None else 0.0))
                    self._in_system.difference_update(ce.completed_clients)
                    if fi is not None:
                        fi.clear_retries(ce.completed_clients)
            elif ev.kind == "upload_lost":
                # every re-send timed out, or a client dropped mid-upload:
                # charge the budget and release the clients so a later
                # refill can re-select the retryable ones
                _k, lost_clients = ev.data
                retryc, give_up = fi.charge_retry(lost_clients)
                self._counters.retries += len(retryc)
                self._counters.dropped_clients += len(give_up)
                fi.clear_retries(give_up)
                self._in_system.difference_update(lost_clients)
            elif ev.kind == "wake":
                self._refill(srv)
                for k in list(self._states):
                    if not self._states[k].inflight:
                        self._dispatch_next(srv, k, netsim)
            else:  # executor_failed
                dead, remaining = ev.data
                self._n_failed += 1
                if srv.telemetry is not None:
                    srv.telemetry.tracer.instant(
                        f"exec:{dead}", "executor_failed", ev.time,
                        cat="fault")
                survivors = self._fail_over(srv, self._states, dead,
                                            remaining)
                for j in survivors:
                    if not self._states[j].inflight:
                        self._dispatch_next(srv, j, netsim)

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
        ctrl = self._ctrl(srv)
        if ctrl is not None:
            extra["oracle_makespan"] = oracle_makespan(
                self._oracle_jobs, list(srv.executors))
            extra["staleness_lambda"] = self._lambda(srv)
            if self._rebalance_moved:
                extra["rebalanced_tasks"] = float(self._rebalance_moved)
            if ctrl.async_lambda is not None:
                # one controller step per commit, from the closed window's
                # mean observed staleness (applies from the next fold on)
                new_lam = ctrl.async_lambda.update(
                    self._stale_sum / n_folds)
                ctrl.note("staleness_lambda", new_lam, self._clock.now)
        if netsim is not None:
            extra.update(netsim.extra())
            # tail dispatches below happen after this window's metrics were
            # read: their comm bills the NEXT window on the shared pricer
            netsim.reset_counters()
        if fi is not None:
            self._fault_extra(extra, self._counters)
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
        if srv.telemetry is not None:
            srv.telemetry.tracer.instant(
                "server", "commit", self._clock.now, cat="server",
                args={"round": rnd, "n_folded": self._n_folded,
                      "mean_staleness": self._stale_sum / n_folds})
            for k in sorted(self._states):
                srv.telemetry.registry.histogram(
                    "hist/queue_depth").observe(len(self._states[k].queue))
        srv._commit_metrics(metrics, win0)
        srv.round += 1
        self._reset_window()

        # new version: broadcast Θ^{r+1} (counted in the next window's comm
        # stats), top the pool up, wake idle executors
        self._payload = srv.algorithm.broadcast_payload(srv.params,
                                                        srv.server_state)
        if netsim is not None:
            netsim.set_payload(self._payload)
        srv.comm.broadcast(self._payload, list(srv.executors),
                           tag="broadcast")
        self._payload_t = self._clock.now
        self._refill(srv)
        if ctrl is not None and ctrl.rebalance and srv.estimator.last_fit:
            # commit-tail rebalance (DESIGN.md §12): pool every
            # undispatched task and re-pack LPT under the CURRENT models,
            # seeding each lane with its busy horizon — in-flight chunks
            # never move, so nothing double-executes
            live_r = [k for k in srv.executors if not self._states[k].dead]
            if len(live_r) >= 2:
                horizons = {
                    k: (self._states[k].busy_until
                        if self._states[k].inflight
                        else max(self._states[k].t, self._clock.now))
                    for k in live_r}
                reb = (srv.placement.rebalance if srv.placement is not None
                       else rebalance_queues)
                assignment, moved = reb(
                    {k: self._states[k].queue for k in live_r}, horizons,
                    srv.estimator.last_fit, srv._sched_comm_cost())
                for k in live_r:
                    self._states[k].queue = assignment[k]
                self._rebalance_moved += moved
                if moved and srv.telemetry is not None:
                    srv.telemetry.tracer.instant(
                        "server", "rebalance", self._clock.now,
                        cat="sched", args={"moved": moved})
        ganged: Set[int] = set()
        if ctrl is not None and ctrl.gang_waves and netsim is None:
            chunk = self._chunk_size(srv, self.chunk_size)
            ganged = self._gang_wave(
                srv, srv.round, self._states, self._clock, self._payload,
                chunk, list(self._states),
                lambda k, rep: (k, rep, srv.round))
        for k in list(self._states):
            if k not in ganged and not self._states[k].inflight:
                self._dispatch_next(srv, k, netsim)
        if srv.checkpoint_manager is not None:
            srv.checkpoint_manager.maybe_save(srv)
        return metrics

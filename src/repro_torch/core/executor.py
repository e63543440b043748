"""Executors: sequential client simulation on a device (Algorithm 2,
``Device_Executes``).  Port of ``repro/core/executor.py``.

``SequentialExecutor`` loads client state, runs the algorithm's local
update, saves state, and folds results into the local aggregator —
measuring per-task wall time for the workload estimator.

``speed_model`` implements the paper's Appendix-A protocol for benchmarking
scheduling under heterogeneous / unstable devices on homogeneous hardware: a
per-(executor, round) slowdown ratio η_k(r) scales the *reported* task
time, accounted in virtual time rather than slept, so the round engine's
BSP round time is max_k Σ_task time.

Client training runs through ``core.client_step``: ``run_queue`` groups
same-signature clients into blocks of ``client_block`` and runs one vmapped
local-SGD loop per block, folding the stacked (B, ...) deltas straight into
the flat aggregator (``fold_block``; a block of one client folds the
same way).  Virtual time for a block is
attributed per client (block time / B, scaled by η).  The eager per-task
path is kept for ``use_compiled_steps=False``, for ragged clients, and for
rounds with a pending ``fail_at`` injection (task-index granularity must
stay exact there).

Every executor runs on one device: ``device=None`` means ``cuda:0``, and a
CUDA request without a card raises (pass ``device="cpu"`` for the CPU).  A
timed span on the card synchronizes before it reads the timer, the
counterpart of ``jax.block_until_ready`` in the JAX executor; each span
makes exactly the timer calls the JAX executor makes, so makespans under a
``TickTimer`` equal the JAX package's.

Device placement (DESIGN.md §8, ``core/placement.py``): ``set_device``
re-pins an executor and drops its device caches.  ``nonblocking=True``
dispatches *steady-state* blocks without the synchronize: once a
(signature, B) block cost has been measured, the cached cost stands in for
the measurement and the block is left in flight (the span still makes its
one closing timer call, so a ``TickTimer`` sees the same calls).  It is off
unless asked for: the JAX executor turns it on for every pinned executor,
and every port executor carries a device.

Gang dispatch (:func:`run_queues_ganged`): under a placement, a BSP round
whose executor queues plan into aligned block waves runs each wave as one
client-step dispatch (``ClientStepEngine.run_blocks_ganged``) — one
``(K·B_pad, …)`` vmap when the K executors share a device — with folds,
state IO and records kept per executor, in executor order.

Stacked-batch cache: ``batch_cache_bytes`` bounds an LRU cache of per-client
stacked (batches, mask) tensors on the executor's device, so steady-state
rounds re-use them instead of restacking and re-copying every round.
"""
from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import client_step, tree
from repro_torch.core.aggregation import LocalAggregator, merge_partials
from repro_torch.core.algorithms import ClientData, FLAlgorithm
from repro_torch.core.scheduler import ClientTask, split_chunks
from repro_torch.core.state_manager import ClientStateManager
from repro_torch.core.workload import RunRecord
from repro_torch.device import resolve_device, synchronize

SpeedModel = Callable[[int, int], float]   # (executor, round) -> eta >= 0


def homogeneous(executor: int, rnd: int) -> float:
    return 0.0


def hetero_gpus(ratios: Dict[int, float]) -> SpeedModel:
    """Fixed per-executor slowdown ratios η_k (paper Appendix A, Hete. GPU)."""
    return lambda k, r: ratios.get(k, 0.0)


def dynamic_env(n_executors: int, total_rounds: int) -> SpeedModel:
    """Unstable devices: η_k(r) = 1 + cos(3.14 r / R + k) (paper Appendix A)."""
    import math

    def eta(k: int, r: int) -> float:
        return 1.0 + math.cos(3.14 * r / max(total_rounds, 1) + k)

    return eta


@dataclass
class ExecutorReport:
    executor: int
    partial: Dict[str, Any]
    records: List[RunRecord]
    virtual_time: float          # Σ per-task simulated time (BSP makespan input)
    wall_time: float
    n_tasks: int
    completed_clients: List[int] = field(default_factory=list)
    # achieved wire size of the shipped partial (set by the engines when a
    # NetworkModel prices uploads; 0 = not measured)
    wire_bytes: int = 0
    # first-seen block shapes while this report ran (client_step's
    # compile_events): host-side cost attribution only
    compiles: int = 0


class SequentialExecutor:
    """One Parrot device (a GPU in the paper)."""

    def __init__(self, executor_id: int, algorithm: FLAlgorithm,
                 state_manager: Optional[ClientStateManager] = None,
                 speed_model: SpeedModel = homogeneous,
                 agg_micro_batch: int = 16,
                 use_compiled_steps: bool = True,
                 client_block: int = 8,
                 fail_at: Optional[Tuple[int, int]] = None,
                 timer: Optional[Callable[[], float]] = None,
                 device: Optional[Any] = None,
                 nonblocking: bool = False,
                 batch_cache_bytes: int = 128 << 20):
        self.id = executor_id
        self.algorithm = algorithm
        self.state_manager = state_manager
        self.speed_model = speed_model
        self.agg_micro_batch = agg_micro_batch
        self.use_compiled_steps = use_compiled_steps
        self.client_block = max(1, int(client_block))
        self.device = resolve_device(device)
        # leave steady-state blocks in flight (see the module docstring)
        self.nonblocking = bool(nonblocking)
        # LRU cache of per-client stacked (batches, mask) on the device;
        # 0 disables
        self.batch_cache_bytes = int(batch_cache_bytes)
        self._batch_cache: "OrderedDict[int, Tuple[Any, Any, Any, int]]" = \
            OrderedDict()
        self._batch_cache_used = 0
        # whole-block stacks for the gang path (repeated cohorts re-use the
        # assembled (B, ...) tensors; shares the byte budget above)
        self._block_stack_cache: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._payload_cache = client_step.PlacedCache()
        # injectable wall-clock source (core/clock.py): a TickTimer makes
        # measured durations a pure function of the code path taken
        self.timer = timer or time.perf_counter
        self._layout_cache = None   # FlatLayout, computed once, reused per round
        # steady-state block cost per (signature, B): running minimum of
        # clean measurements
        self._block_cost: Dict[Any, float] = {}
        # per-client batch signature, keyed on the ClientData identity
        self._sig_cache: Dict[int, Tuple[Any, Any]] = {}
        # fault-injection hook: (round, task_index) at which this executor
        # dies; round -1 is a wildcard (any round)
        self.fail_at = fail_at

    def fail_pending(self, rnd: int) -> bool:
        """A ``fail_at`` injection is armed for round ``rnd`` (round -1
        wildcards to every round)."""
        return self.fail_at is not None and self.fail_at[0] in (rnd, -1)

    # ------------------------------------------------------------- device
    def set_device(self, device: Any) -> None:
        """Re-pin the executor (a placement's assignment, or its re-pin
        after a restart or a device failure).  Device-resident caches are
        dropped; measured block costs survive (they describe the
        computation, not the device it ran on)."""
        device = resolve_device(device)
        if device == self.device:
            return
        self.device = device
        self._batch_cache.clear()
        self._block_stack_cache.clear()
        self._batch_cache_used = 0
        self._payload_cache.clear()

    def _place_payload(self, payload: Dict) -> Dict:
        """The broadcast payload on the executor's device, placed ONCE per
        payload object (one object per round)."""
        return self._payload_cache.get(
            (payload,), lambda: client_step.place_tree(payload, self.device))

    def _prep_batches(self, client: int, data: ClientData) -> Tuple[Any, Any]:
        """The client's stacked (batches, mask) on the device, served from
        the LRU cache (capped at ``batch_cache_bytes``)."""
        hit = self._batch_cache.get(client)
        if hit is not None and hit[0]() is data:
            self._batch_cache.move_to_end(client)
            return hit[1], hit[2]
        stacked, mask = client_step.place_prep(
            client_step.stack_batches(data, assume_uniform=True), self.device)
        if self.batch_cache_bytes <= 0:
            return stacked, mask
        nbytes = int(mask.nbytes) + sum(
            int(x.nbytes) for x in tree.leaves(stacked))
        if hit is not None:          # stale entry (dataset swapped)
            self._batch_cache_used -= self._batch_cache.pop(client)[3]
        self._batch_cache[client] = (weakref.ref(data), stacked, mask, nbytes)
        self._batch_cache_used += nbytes
        self._evict_to_budget()
        return stacked, mask

    def _evict_to_budget(self) -> None:
        """Shrink the shared byte budget across both stacked-batch caches:
        block stacks go first (a cohort that never repeats is dead weight,
        and per-client entries can rebuild them), then per-client LRU
        entries down to the last one."""
        while self._batch_cache_used > self.batch_cache_bytes:
            if self._block_stack_cache:
                self._batch_cache_used -= \
                    self._block_stack_cache.popitem(last=False)[1][3]
            elif len(self._batch_cache) > 1:
                self._batch_cache_used -= \
                    self._batch_cache.popitem(last=False)[1][3]
            else:
                break

    def _prep_block_stack(self, block: List[ClientTask],
                          data_by_client: Dict[int, ClientData],
                          B_pad: int) -> Tuple[Any, Any]:
        """The block's padded (B_pad, ...) stacked batches and masks on the
        device, cached by cohort: repeated schedules (full participation,
        stable LPT splits) re-dispatch the identical block every round, so
        the assembled tensors are served again instead of restacked."""
        key = (tuple(t.client for t in block), B_pad)
        if self.batch_cache_bytes > 0:
            hit = self._block_stack_cache.get(key)
            if hit is not None and all(
                    w() is data_by_client[c]
                    for c, w in zip(key[0], hit[0])):
                self._block_stack_cache.move_to_end(key)
                return hit[1], hit[2]
        cp = [self._prep_batches(t.client, data_by_client[t.client])
              for t in block]
        cp = cp + [cp[0]] * (B_pad - len(block))
        stacked = tree.map(lambda *xs: torch.stack(xs), *[p[0] for p in cp])
        mask = torch.stack([p[1] for p in cp])
        if self.batch_cache_bytes > 0:
            nbytes = int(mask.nbytes) + sum(
                int(x.nbytes) for x in tree.leaves(stacked))
            refs = tuple(weakref.ref(data_by_client[c]) for c in key[0])
            if key in self._block_stack_cache:
                self._batch_cache_used -= self._block_stack_cache.pop(key)[3]
            self._block_stack_cache[key] = (refs, stacked, mask, nbytes)
            self._batch_cache_used += nbytes
            self._evict_to_budget()
        return stacked, mask

    def run_queue(self, rnd: int, tasks: List[ClientTask], payload: Dict,
                  data_by_client: Dict[int, ClientData],
                  skip_clients: Optional[set] = None,
                  chunk_size: Optional[int] = None,
                  on_partial: Optional[Callable[["ExecutorReport"], None]]
                  = None,
                  task_offset: int = 0) -> ExecutorReport:
        """Run a task queue (``Device_Executes``).

        ``chunk_size`` switches to chunked *streaming* execution: the queue
        is cut into chunks of at most that many tasks, each chunk runs as
        its own span (own LocalAggregator, so its partial is shippable on
        its own) and is emitted through ``on_partial`` the moment it
        completes.  The returned report merges the chunk reports.  The
        engines call this method once per chunk with ``task_offset``
        instead (their event loop owns the interleaving); both routes run
        the same per-chunk code.

        ``task_offset`` keeps ``fail_at``'s task index global to the
        executor's dispatch stream when the caller passes slices of it."""
        if chunk_size is not None:
            return self._run_chunked(rnd, tasks, payload, data_by_client,
                                     skip_clients, chunk_size, on_partial,
                                     task_offset)
        agg = LocalAggregator(self.algorithm.ops(),
                              micro_batch=self.agg_micro_batch,
                              layout=self._layout_cache,
                              device=self.device)
        payload = self._place_payload(payload)
        records: List[RunRecord] = []
        completed: List[int] = []
        t_start = self.timer()
        c0 = client_step.compile_events()
        eta = self.speed_model(self.id, rnd)
        # fail_at is task-index-granular: a round with a pending injection
        # runs the eager per-task loop so the index semantics stay exact
        # (round -1 is a wildcard: fire at that dispatch index in any round
        # — the async engine's dispatch stream spans update boundaries)
        if self.use_compiled_steps and not self.fail_pending(rnd):
            vtime = self._run_blocked(rnd, tasks, payload, data_by_client,
                                      skip_clients, agg, records, completed,
                                      eta)
        else:
            vtime = self._run_eager(rnd, tasks, payload, data_by_client,
                                    skip_clients, agg, records, completed,
                                    eta, task_offset)
        self._layout_cache = agg.layout     # flatten-once across rounds
        return ExecutorReport(
            executor=self.id, partial=agg.partial(), records=records,
            virtual_time=vtime, wall_time=self.timer() - t_start,
            n_tasks=len(completed), completed_clients=completed,
            compiles=client_step.compile_events() - c0)

    def _run_chunked(self, rnd, tasks, payload, data_by_client, skip_clients,
                     chunk_size, on_partial, task_offset) -> ExecutorReport:
        merged: Optional[Dict] = None
        records: List[RunRecord] = []
        completed: List[int] = []
        vtime = wall = 0.0
        compiles = 0
        offset = task_offset
        for chunk in split_chunks(tasks, chunk_size):
            rep = self.run_queue(rnd, chunk, payload, data_by_client,
                                 skip_clients, task_offset=offset)
            offset += len(chunk)
            if on_partial is not None:
                on_partial(rep)
            merged = merge_partials(merged, rep.partial)
            records.extend(rep.records)
            completed.extend(rep.completed_clients)
            vtime += rep.virtual_time
            wall += rep.wall_time
            compiles += rep.compiles
        return ExecutorReport(
            executor=self.id, partial=merged if merged is not None else
            LocalAggregator(self.algorithm.ops(),
                            device=self.device).partial(),
            records=records, virtual_time=vtime, wall_time=wall,
            n_tasks=len(completed), completed_clients=completed,
            compiles=compiles)

    # ------------------------------------------------------------------
    def _run_eager(self, rnd, tasks, payload, data_by_client, skip_clients,
                   agg, records, completed, eta, task_offset=0) -> float:
        """Per-task reference path (one eager client_update per task; also
        the fault-injection path)."""
        vtime = 0.0
        for i, task in enumerate(tasks, start=task_offset):
            if self.fail_at is not None and self.fail_at[1] == i \
                    and self.fail_pending(rnd):
                raise ExecutorFailure(
                    self.id, rnd, i, device=self.device,
                    chunk=(task_offset, task_offset + len(tasks)),
                    vtime=vtime)
            if skip_clients and task.client in skip_clients:
                continue  # result already produced by a backup replica
            t0 = self.timer()
            state = None
            if self.algorithm.stateful:
                state = self.state_manager.load_many(
                    [task.client], device=self.device)[0]
                if state is None:
                    state = self.algorithm.client_init_state(payload["params"])
            result, new_state = self.algorithm.client_update(
                payload, data_by_client[task.client], state)
            if self.algorithm.stateful and new_state is not None:
                self.state_manager.save(task.client, new_state,
                                        keep_device=True)
            agg.fold(result)
            completed.append(task.client)
            synchronize(self.device)
            measured = self.timer() - t0
            simulated = measured * (1.0 + eta)
            vtime += simulated
            records.append(RunRecord(round=rnd, client=task.client,
                                     executor=self.id,
                                     n_samples=task.n_samples,
                                     time=simulated))
        return vtime

    # ------------------------------------------------------------------
    def _plan_blocks(self, tasks: List[ClientTask],
                     data_by_client: Dict[int, ClientData]
                     ) -> List[Tuple[Tuple, List[ClientTask]]]:
        """Group same-signature clients into blocks of ``client_block``
        (first-seen group order; queue order within a group).  Ragged
        clients get singleton eager blocks."""
        groups: Dict[Any, List[ClientTask]] = {}
        order: List[Any] = []
        for t in tasks:
            data = data_by_client[t.client]
            cached = self._sig_cache.get(t.client)
            if cached is not None and cached[0]() is data:
                sig = cached[1]
            else:
                sig = client_step.batch_signature(data)
                self._sig_cache[t.client] = (weakref.ref(data), sig)
            key = ("eager", t.client) if sig is None else ("block", sig)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(t)
        if len(self._sig_cache) > 4096:
            # an entry whose ClientData is gone can never hit again
            self._sig_cache = {c: v for c, v in self._sig_cache.items()
                               if v[0]() is not None}
        blocks: List[Tuple[Any, List[ClientTask]]] = []
        for key in order:
            q = groups[key]
            if key[0] == "eager":
                blocks.append((key, q))
            else:
                for i in range(0, len(q), self.client_block):
                    blocks.append((key, q[i:i + self.client_block]))
        return blocks

    def _run_blocked(self, rnd, tasks, payload, data_by_client, skip_clients,
                     agg, records, completed, eta) -> float:
        """Engine path: one vmapped local-SGD loop per block, stacked deltas
        folded straight into the flat aggregator.  A nonblocking executor
        leaves steady-state blocks in flight (the cached block cost stands
        in for the measurement)."""
        engine = client_step.engine_for(self.algorithm, self.device)
        todo = [t for t in tasks
                if not (skip_clients and t.client in skip_clients)]
        vtime = 0.0
        blocks = self._plan_blocks(todo, data_by_client)
        for bi, (key, block) in enumerate(blocks):
            kind = key[0]
            if self.algorithm.stateful and self.state_manager is not None \
                    and bi + 1 < len(blocks):
                # schedule-keyed look-ahead: stage the NEXT block's state
                # shards into the manager's RAM tier (outside the timed span)
                self.state_manager.prefetch(
                    [t.client for t in blocks[bi + 1][1]])
            compiles0 = client_step.compile_events()
            states = None
            if self.algorithm.stateful:
                states = self.state_manager.load_many(
                    [t.client for t in block], device=self.device)
                states = [s if s is not None
                          else self.algorithm.client_init_state(
                              payload["params"])
                          for s in states]
            datas = [data_by_client[t.client] for t in block]

            # the timed span is exactly the client compute (stack + engine
            # + sync on the outputs); state IO and the fold stay outside so
            # the first-shape re-measure below reproduces the same span
            preps = None

            def run_engine(sync: bool = True):
                nonlocal preps
                if preps is None:
                    preps = [self._prep_batches(t.client,
                                                data_by_client[t.client])
                             for t in block]
                if len(block) == 1:
                    out = engine.run_client(
                        payload, datas[0], states[0] if states else None,
                        assume_uniform=True, prep=preps[0])
                else:
                    out = engine.run_block(payload, datas, states,
                                           preps=preps)
                if sync:
                    synchronize(self.device)
                return out

            cost_key = (key[1], len(block)) if kind != "eager" else None
            steady = (self.nonblocking and cost_key is not None
                      and cost_key in self._block_cost)
            t0 = self.timer()
            if kind == "eager":           # ragged batches: reference path
                assert len(block) == 1
                result, new_state = self.algorithm.client_update(
                    payload, datas[0], states[0] if states else None)
                new_states = [new_state]
                synchronize(self.device)
                measured = self.timer() - t0
            elif steady:
                # this (signature, B) was measured before: no first-seen
                # cost can hide in the span, so the block stays in flight
                out = run_engine(sync=False)
                self.timer()              # span close (call parity with
                measured = self._block_cost[cost_key]   # the synced path)
            else:
                out = run_engine()
                new_states = None
                measured = self.timer() - t0
                # a first-seen shape paid one-off costs inside the timed
                # span; re-run the (pure) computation once, result
                # discarded, so virtual time and the workload estimator see
                # steady-state throughput
                if client_step.compile_events() > compiles0:
                    t0 = self.timer()
                    run_engine()
                    measured = self.timer() - t0

            if kind == "eager":
                agg.fold(result)
            elif len(block) == 1:
                # a block of one folds through the leaves form as well: one
                # launch straight from the result's leaves, no staged copy
                result, new_state = out
                agg.fold_block(
                    tree.map(lambda x: x.unsqueeze(0), result.payload),
                    [result.weight])
                new_states = [new_state]
            else:
                stacked, new_states = out
                agg.fold_block(stacked,
                               [float(d.n_samples) for d in datas])
                if new_states is None:
                    new_states = [None] * len(block)
            if self.algorithm.stateful:
                self.state_manager.save_many(
                    {t.client: s for t, s in zip(block, new_states)
                     if s is not None}, keep_device=True)
            completed.extend(t.client for t in block)
            if cost_key is not None and not steady:
                # steady-state filter: host-noise spikes would otherwise
                # dominate the BSP makespan
                measured = min(measured,
                               self._block_cost.get(cost_key, measured))
                self._block_cost[cost_key] = measured
            # per-client virtual-time attribution: the block's measured time
            # splits evenly across its B clients, each scaled by η
            simulated = measured * (1.0 + eta)
            per_client = simulated / len(block)
            vtime += simulated
            records.extend(
                RunRecord(round=rnd, client=t.client, executor=self.id,
                          n_samples=t.n_samples, time=per_client)
                for t in block)
        return vtime


def run_queues_ganged(executors: Dict[int, "SequentialExecutor"], rnd: int,
                      queues: Dict[int, List[ClientTask]], payload: Dict,
                      data_by_client: Dict[int, ClientData],
                      placement, skip_map: Optional[Dict[int, set]] = None
                      ) -> Optional[Dict[int, "ExecutorReport"]]:
    """Gang dispatch of a whole BSP round (DESIGN.md §8).

    When every live executor's queue plans into aligned block *waves* —
    wave i holds every executor's i-th block, all in one (signature,
    padded B) bucket — each wave runs as ONE client-step dispatch
    (``ClientStepEngine.run_blocks_ganged``): on one shared device one
    ``(K·B_pad, …)`` vmap, so the host dispatches the client step once a
    wave instead of K times; on K distinct devices K blocks launched back to
    back with no synchronize between them.  Folds, state IO and virtual-time
    accounting stay per executor, in executor order, so the reports carry
    what the per-executor path would.

    Each wave is one timed span on the shared timer: the running minimum
    of its cost per ``(sig, B_pad, K)`` lives in the placement's
    ``_gang_cost``; a wave with every executor nonblocking and its cost
    known stays in flight; a first-seen wave is re-run once for a
    steady-state measurement on the CPU only (as the JAX package does on
    its CPU backend).  Each lane is charged ``measured·(1+η_k)``: the whole
    wave, the time its executor waits for its block to come back.  On K
    devices (JAX's gang) that is each lane's own block; on one shared
    device the wave holds all K lanes' blocks, so under a real timer a
    ganged executor's virtual time and records are those of the K blocks'
    work where the serial dispatch charges each block alone (under a
    ``TickTimer``, one tick a span, the two agree, as they must for the
    parity with JAX's gang).

    Returns executor id -> ExecutorReport, or None when the round is not
    gangable (no placement, K == 1, executors on a mix of shared and
    distinct devices, eager steps, differing algorithms or timers, a
    pending ``fail_at``, unaligned waves or ragged clients) — the caller
    then falls back to the per-executor dispatch.  The JAX package refuses
    executors that share a device; on one card they all do, so the port
    takes one shared device or K distinct ones."""
    if placement is None or len(queues) < 2:
        return None
    live = sorted(queues)
    exs = [executors[k] for k in live]
    devs = [ex.device for ex in exs]
    if len(set(devs)) not in (1, len(devs)):
        return None
    algo = exs[0].algorithm
    timer = exs[0].timer
    for ex in exs:
        if (not ex.use_compiled_steps or ex.algorithm is not algo
                or ex.timer is not timer or ex.fail_pending(rnd)):
            # gang waves are timed once on the shared timer; executors with
            # private timers keep per-executor measurement semantics
            return None

    # ---- plan waves -----------------------------------------------------
    plans = []
    for k, ex in zip(live, exs):
        todo = [t for t in queues[k]
                if not (skip_map and t.client in skip_map.get(k, ()))]
        plans.append(ex._plan_blocks(todo, data_by_client))
    n_waves = len(plans[0])
    if any(len(p) != n_waves for p in plans):
        return None
    for i in range(n_waves):
        keys = {(p[i][0], client_step._bucket(len(p[i][1]))) for p in plans}
        if len(keys) != 1 or next(iter(keys))[0][0] != "block":
            return None

    # ---- run ------------------------------------------------------------
    engine = client_step.engine_for(algo, devs[0])
    gang_c0 = client_step.compile_events()
    rerun_first_seen = all(d.type == "cpu" for d in devs)
    etas = [ex.speed_model(ex.id, rnd) for ex in exs]
    aggs, placed = [], []
    for ex in exs:
        aggs.append(LocalAggregator(algo.ops(),
                                    micro_batch=ex.agg_micro_batch,
                                    layout=ex._layout_cache,
                                    device=ex.device))
        placed.append(ex._place_payload(payload))
    records: List[List[RunRecord]] = [[] for _ in exs]
    completed: List[List[int]] = [[] for _ in exs]
    vtimes = [0.0] * len(exs)
    walls = [0.0] * len(exs)
    gang_cost = placement._gang_cost

    for i in range(n_waves):
        blocks = [p[i][1] for p in plans]
        sig = plans[0][i][0][1]
        B_pad = client_step._bucket(max(len(b) for b in blocks))
        if algo.stateful and i + 1 < n_waves:
            # stage wave i+1's state shards while wave i computes
            for j, ex in enumerate(exs):
                if ex.state_manager is not None:
                    ex.state_manager.prefetch(
                        [t.client for t in plans[j][i + 1][1]])
        preps = []
        states = [] if algo.stateful else None
        for j, ex in enumerate(exs):
            block = blocks[j]
            preps.append(ex._prep_block_stack(block, data_by_client, B_pad))
            if algo.stateful:
                st = ex.state_manager.load_many(
                    [t.client for t in block], device=ex.device)
                st = [s if s is not None
                      else algo.client_init_state(placed[j]["params"])
                      for s in st]
                st = st + [st[0]] * (B_pad - len(block))
                states.append(tree.map(lambda *xs: torch.stack(xs), *st))

        cost_key = (sig, B_pad, len(live))
        steady = all(ex.nonblocking for ex in exs) and cost_key in gang_cost
        compiles0 = client_step.compile_events()
        t0 = timer()
        outs = engine.run_blocks_ganged(payload, preps, states)
        if steady:
            timer()                         # span close (call parity)
            measured = gang_cost[cost_key]
        else:
            for d in set(devs):
                synchronize(d)
            measured = timer() - t0
            if client_step.compile_events() > compiles0 \
                    and rerun_first_seen:
                # a first-seen wave paid its one-off costs in the span:
                # re-run it once for a steady-state measurement
                t0 = timer()
                engine.run_blocks_ganged(payload, preps, states)
                measured = timer() - t0
            measured = min(measured, gang_cost.get(cost_key, measured))
            gang_cost[cost_key] = measured

        for j, (k, ex) in enumerate(zip(live, exs)):
            block = blocks[j]
            out_payload, new_states = outs[j]
            if B_pad > len(block):
                out_payload = tree.map(lambda x: x[:len(block)], out_payload)
            aggs[j].fold_block(out_payload,
                               [float(t.n_samples) for t in block])
            if algo.stateful and new_states is not None:
                # clone each client's slice: a view would keep the whole
                # wave's storage once the state manager holds it
                ex.state_manager.save_many(
                    {t.client: tree.map(lambda x: x[b].clone(), new_states)
                     for b, t in enumerate(block)}, keep_device=True)
            completed[j].extend(t.client for t in block)
            # the whole wave to every lane (on one shared device: all K
            # blocks' work; see the docstring)
            simulated = measured * (1.0 + etas[j])
            vtimes[j] += simulated
            walls[j] += measured
            per_client = simulated / len(block)
            records[j].extend(
                RunRecord(round=rnd, client=t.client, executor=k,
                          n_samples=t.n_samples, time=per_client)
                for t in block)

    reports = {}
    for j, (k, ex) in enumerate(zip(live, exs)):
        ex._layout_cache = aggs[j].layout
        reports[k] = ExecutorReport(
            executor=k, partial=aggs[j].partial(), records=records[j],
            virtual_time=vtimes[j], wall_time=walls[j],
            n_tasks=len(completed[j]), completed_clients=completed[j],
            # a wave runs once for the whole gang: its first-seen shapes
            # are charged to the first lane (host-side accounting only)
            compiles=(client_step.compile_events() - gang_c0
                      if j == 0 else 0))
    return reports


class ExecutorFailure(RuntimeError):
    """An executor died mid-dispatch: where (device), what was in flight
    (the chunk's global task range) and when (virtual seconds into the
    chunk's span)."""

    def __init__(self, executor: int, rnd: int, task_index: int,
                 device: Optional[Any] = None,
                 chunk: Optional[Tuple[int, int]] = None,
                 vtime: Optional[float] = None):
        device = str(device) if device is not None else None
        msg = f"executor {executor} failed at round {rnd}, task {task_index}"
        detail = []
        if device is not None:
            detail.append(f"device={device}")
        if chunk is not None:
            detail.append(f"chunk=[{chunk[0]},{chunk[1]})")
        if vtime is not None:
            detail.append(f"t={vtime:.6g}s")
        if detail:
            msg += " (" + ", ".join(detail) + ")"
        super().__init__(msg)
        self.executor = executor
        self.rnd = rnd
        self.task_index = task_index
        self.device = device
        self.chunk = chunk
        self.vtime = vtime

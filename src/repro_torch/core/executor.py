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
the flat aggregator (``fold_block``).  Virtual time for a block is
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

from repro_torch.core import client_step, tree
from repro_torch.core.aggregation import LocalAggregator
from repro_torch.core.algorithms import ClientData, FLAlgorithm
from repro_torch.core.scheduler import ClientTask
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
                 batch_cache_bytes: int = 128 << 20):
        self.id = executor_id
        self.algorithm = algorithm
        self.state_manager = state_manager
        self.speed_model = speed_model
        self.agg_micro_batch = agg_micro_batch
        self.use_compiled_steps = use_compiled_steps
        self.client_block = max(1, int(client_block))
        self.device = resolve_device(device)
        # LRU cache of per-client stacked (batches, mask) on the device;
        # 0 disables
        self.batch_cache_bytes = int(batch_cache_bytes)
        self._batch_cache: "OrderedDict[int, Tuple[Any, Any, Any, int]]" = \
            OrderedDict()
        self._batch_cache_used = 0
        self._placed: Optional[Tuple[Dict, Dict]] = None  # (payload, copy)
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
    def _place_payload(self, payload: Dict) -> Dict:
        """The broadcast payload on the executor's device, placed ONCE per
        payload object (one object per round)."""
        if self._placed is None or self._placed[0] is not payload:
            self._placed = (payload, tree.map(
                lambda t: t.to(self.device) if hasattr(t, "to") else t,
                payload))
        return self._placed[1]

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
        while self._batch_cache_used > self.batch_cache_bytes \
                and len(self._batch_cache) > 1:
            self._batch_cache_used -= \
                self._batch_cache.popitem(last=False)[1][3]
        return stacked, mask

    def run_queue(self, rnd: int, tasks: List[ClientTask], payload: Dict,
                  data_by_client: Dict[int, ClientData],
                  skip_clients: Optional[set] = None) -> ExecutorReport:
        """Run a task queue (``Device_Executes``)."""
        agg = LocalAggregator(self.algorithm.ops(),
                              micro_batch=self.agg_micro_batch,
                              layout=self._layout_cache,
                              device=self.device)
        payload = self._place_payload(payload)
        records: List[RunRecord] = []
        completed: List[int] = []
        t_start = self.timer()
        eta = self.speed_model(self.id, rnd)
        # fail_at is task-index-granular: a round with a pending injection
        # runs the eager per-task loop so the index semantics stay exact
        if self.use_compiled_steps and not self.fail_pending(rnd):
            vtime = self._run_blocked(rnd, tasks, payload, data_by_client,
                                      skip_clients, agg, records, completed,
                                      eta)
        else:
            vtime = self._run_eager(rnd, tasks, payload, data_by_client,
                                    skip_clients, agg, records, completed,
                                    eta)
        self._layout_cache = agg.layout     # flatten-once across rounds
        return ExecutorReport(
            executor=self.id, partial=agg.partial(), records=records,
            virtual_time=vtime, wall_time=self.timer() - t_start,
            n_tasks=len(completed), completed_clients=completed)

    # ------------------------------------------------------------------
    def _run_eager(self, rnd, tasks, payload, data_by_client, skip_clients,
                   agg, records, completed, eta) -> float:
        """Per-task reference path (one eager client_update per task; also
        the fault-injection path)."""
        vtime = 0.0
        for i, task in enumerate(tasks):
            if self.fail_at is not None and self.fail_at[1] == i \
                    and self.fail_pending(rnd):
                raise ExecutorFailure(
                    self.id, rnd, i, device=self.device,
                    chunk=(0, len(tasks)),
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
        folded straight into the flat aggregator."""
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

            def run_engine():
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
                synchronize(self.device)
                return out

            cost_key = (key[1], len(block)) if kind != "eager" else None
            t0 = self.timer()
            if kind == "eager":           # ragged batches: reference path
                assert len(block) == 1
                result, new_state = self.algorithm.client_update(
                    payload, datas[0], states[0] if states else None)
                new_states = [new_state]
                synchronize(self.device)
                measured = self.timer() - t0
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
                result, new_state = out
                agg.fold(result)
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
            if cost_key is not None:
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

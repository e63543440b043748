"""Parrot core on PyTorch — the round main path:

  scheduler.py / workload.py — heterogeneity-aware task scheduling (Alg. 3)
  aggregation.py             — hierarchical local→global aggregation (§4.2)
  compression.py             — partial compression (top-k error feedback,
                               int8, PowerSGD) and the compressed wire
  flat.py                    — flatten-once layout for batched folds
  state_manager.py           — client state manager for stateful FL (§3.4)
  algorithms.py              — 6 FL algorithms over nested dicts (§5.1)
  client_step.py             — client-training engine (local-SGD loop,
                               torch.func.vmap over client blocks)
  executor.py / round.py     — sequential executors + Parrot server (Alg. 2)
  engine.py / clock.py       — round engines (BSP / semi-sync / async) on
                               the virtual clock
  population.py              — client populations (eager and streamed)
                               and cohort sampling
  network.py                 — trace-driven network & availability
                               simulation (comm-priced virtual time)
  faults.py                  — fault injection & recovery (seeded chaos
                               plans, retries, crashes and restarts)
  placement.py               — executor→device pinning + the rank-ordered
                               global fold on the fold kernel
  tree.py                    — nested-container helpers in jax.tree order
"""
from repro_torch.core.aggregation import (ClientResult, LocalAggregator, Op,
                                          flat_aggregate, global_aggregate,
                                          merge_partials, scale_partial,
                                          staleness_weight, wire_bytes)
from repro_torch.core.algorithms import (ALGORITHMS, ClientData, FLAlgorithm,
                                         make_algorithm, value_and_grad)
from repro_torch.core.client_step import ClientStepEngine, engine_for
from repro_torch.core.clock import TickTimer, VirtualClock
from repro_torch.core.compression import (CompressedTensor, Int8Compressor,
                                          PowerSGDCompressor, TopKCompressor,
                                          make_compressor)
from repro_torch.core.engine import (AsyncEngine, BSPEngine, RoundEngine,
                                     SemiSyncEngine, make_engine)
from repro_torch.core.executor import (ExecutorFailure, SequentialExecutor,
                                       dynamic_env, hetero_gpus, homogeneous)
from repro_torch.core.faults import (FaultEvent, FaultInjector, FaultPlan,
                                     RetryPolicy)
from repro_torch.core.flat import FlatLayout
from repro_torch.core.network import (ClientAvailability, CommEvent,
                                      LinkProfile, NetworkModel)
from repro_torch.core.placement import DevicePlacement
from repro_torch.core.population import (ClientPopulation, EagerPopulation,
                                         LazyPopulation, as_population)
from repro_torch.core.round import (ParrotServer, RoundMetrics,
                                    run_flat_reference)
from repro_torch.core.scheduler import (ClientTask, ParrotScheduler, Schedule,
                                        oracle_makespan, predict_span,
                                        rebalance_queues, split_chunks)
from repro_torch.core.state_manager import ClientStateManager, owner_host
from repro_torch.core.workload import (RunRecord, WorkloadEstimator,
                                       WorkloadModel, fleet_average)

__all__ = [
    "ALGORITHMS", "AsyncEngine", "BSPEngine", "ClientAvailability",
    "ClientData", "ClientPopulation",
    "ClientResult", "ClientStateManager", "ClientStepEngine", "ClientTask",
    "CommEvent", "CompressedTensor", "DevicePlacement", "EagerPopulation",
    "ExecutorFailure",
    "FLAlgorithm", "FaultEvent", "FaultInjector", "FaultPlan",
    "FlatLayout", "Int8Compressor", "LazyPopulation", "LinkProfile",
    "LocalAggregator", "NetworkModel", "Op",
    "ParrotScheduler", "ParrotServer", "PowerSGDCompressor", "RoundEngine",
    "RetryPolicy", "RoundMetrics", "RunRecord", "Schedule", "SemiSyncEngine",
    "SequentialExecutor",
    "TickTimer", "TopKCompressor", "VirtualClock", "WorkloadEstimator",
    "WorkloadModel", "as_population", "dynamic_env", "engine_for",
    "flat_aggregate", "fleet_average", "global_aggregate", "hetero_gpus",
    "homogeneous", "make_algorithm", "make_compressor", "make_engine",
    "merge_partials", "oracle_makespan", "owner_host", "predict_span",
    "rebalance_queues", "run_flat_reference", "scale_partial", "split_chunks",
    "staleness_weight", "value_and_grad", "wire_bytes",
]

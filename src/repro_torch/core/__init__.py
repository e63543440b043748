"""Parrot core on PyTorch — the BSP round main path:

  scheduler.py / workload.py — heterogeneity-aware task scheduling (Alg. 3)
  aggregation.py             — hierarchical local→global aggregation (§4.2)
  flat.py                    — flatten-once layout for batched folds
  state_manager.py           — client state manager for stateful FL (§3.4)
  algorithms.py              — 6 FL algorithms over nested dicts (§5.1)
  client_step.py             — client-training engine (local-SGD loop,
                               torch.func.vmap over client blocks)
  executor.py / round.py     — sequential executors + Parrot server (Alg. 2)
  engine.py / clock.py       — the BSP round engine on the virtual clock
  population.py              — client population and cohort sampling
  tree.py                    — nested-container helpers in jax.tree order
"""
from repro_torch.core.aggregation import (ClientResult, LocalAggregator, Op,
                                          flat_aggregate, global_aggregate)
from repro_torch.core.algorithms import (ALGORITHMS, ClientData, FLAlgorithm,
                                         make_algorithm, value_and_grad)
from repro_torch.core.client_step import ClientStepEngine, engine_for
from repro_torch.core.clock import TickTimer, VirtualClock
from repro_torch.core.engine import BSPEngine, RoundEngine, make_engine
from repro_torch.core.executor import (ExecutorFailure, SequentialExecutor,
                                       dynamic_env, hetero_gpus, homogeneous)
from repro_torch.core.flat import FlatLayout
from repro_torch.core.population import (ClientPopulation, EagerPopulation,
                                         as_population)
from repro_torch.core.round import (ParrotServer, RoundMetrics,
                                    run_flat_reference)
from repro_torch.core.scheduler import (ClientTask, ParrotScheduler, Schedule,
                                        oracle_makespan, predict_span,
                                        split_chunks)
from repro_torch.core.state_manager import ClientStateManager, owner_host
from repro_torch.core.workload import (RunRecord, WorkloadEstimator,
                                       WorkloadModel, fleet_average)

__all__ = [
    "ALGORITHMS", "BSPEngine", "ClientData", "ClientPopulation",
    "ClientResult", "ClientStateManager", "ClientStepEngine", "ClientTask",
    "EagerPopulation", "ExecutorFailure", "FLAlgorithm", "FlatLayout",
    "LocalAggregator", "Op", "ParrotScheduler", "ParrotServer",
    "RoundEngine", "RoundMetrics", "RunRecord", "Schedule",
    "SequentialExecutor", "TickTimer", "VirtualClock", "WorkloadEstimator",
    "WorkloadModel", "as_population", "dynamic_env", "engine_for",
    "flat_aggregate", "fleet_average", "global_aggregate", "hetero_gpus",
    "homogeneous", "make_algorithm", "make_engine", "oracle_makespan",
    "owner_host", "predict_span", "run_flat_reference", "split_chunks",
    "value_and_grad",
]

"""Trace a heterogeneous round on all three engines (DESIGN.md §13).  Port
of ``examples/trace_round.py``.

Runs a few rounds of the same heterogeneous workload — ``dynamic_env``
compute drift plus a constrained uniform uplink — under BSP, semi-sync and
async with ``telemetry=True``, exports one Chrome-trace/Perfetto JSON per
engine (open it in https://ui.perfetto.dev or chrome://tracing), checks
each with ``validate_trace`` and prints the per-executor busy/comm/idle
fractions the span tracer derived: the paper's "computing utility" in one
table.  The BSP barrier idles every fast lane until the straggler lands;
semi-sync's deadline and async's pipeline reclaim that time.

  python -m repro_torch.launch.trace_round [--rounds N] [--out DIR]
      [--device cuda:0]

Runs on the card unless asked for the CPU (``--device cpu``), under a
``TickTimer`` as the JAX example does, so the traces' virtual times equal
the JAX example's.  Exits non-zero if a trace fails validation.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

import torch

from repro_torch.core import (ClientStateManager, NetworkModel,
                              ParrotServer, SequentialExecutor, TickTimer,
                              dynamic_env, make_algorithm, validate_trace,
                              value_and_grad)
from repro_torch.data import make_classification_clients
from repro_torch.device import resolve_device

K = 4
ENGINES = [
    ("bsp", "bsp", {}),
    ("semi-sync", "semi-sync", {"deadline_frac": 0.7, "over_select": 1.2,
                                "chunk_size": 4}),
    ("async", "async", {"staleness_lambda": 0.5, "chunk_size": 4}),
]


def _loss_fn(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


def build(engine: str, opts, rounds: int, device) -> ParrotServer:
    """The JAX example's server: 60 clients (dim 16, 4 classes), 16 a
    round, 4 executors under ``dynamic_env(4, rounds)``, a 2e5 / 1e6 B/s
    link with 0.05 s latency, telemetry on."""
    params = {"w": torch.zeros(16, 4), "b": torch.zeros(4)}
    data = make_classification_clients(60, dim=16, n_classes=4,
                                       mean_samples=40, batch_size=10,
                                       seed=1)
    algo = make_algorithm("fedavg", value_and_grad(_loss_fn), lr=0.1)
    sm = ClientStateManager(tempfile.mkdtemp(prefix="trace_round_"))
    execs = [SequentialExecutor(k, algo, state_manager=sm,
                                speed_model=dynamic_env(K, rounds),
                                timer=TickTimer(1.0), device=device)
             for k in range(K)]
    net = NetworkModel.uniform(uplink_bps=2e5, downlink_bps=1e6,
                               latency_s=0.05)
    return ParrotServer(params=params, algorithm=algo, executors=execs,
                        data_by_client=data, clients_per_round=16,
                        round_engine=engine, engine_opts=opts,
                        network=net, telemetry=True, seed=7, device=device)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="trace output directory (default: a temp dir)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = args.out or tempfile.mkdtemp(prefix="parrot_traces_")
    os.makedirs(out, exist_ok=True)

    bad = 0
    print(f"{'engine':<10} {'exec':>4} {'busy':>7} {'comm':>7} {'idle':>7}")
    for name, engine, opts in ENGINES:
        srv = build(engine, opts, args.rounds, device)
        for _ in range(args.rounds):
            m = srv.run_round()
        path = os.path.join(out, f"trace_{name.replace('-', '_')}.json")
        srv.telemetry.tracer.export(path)
        errors = validate_trace(path)
        bad += len(errors)
        for k, u in sorted(m.extra["utilization"].items()):
            tag = name if k == 0 else ""
            print(f"{tag:<10} {k:>4} {u['busy_frac']:>6.1%} "
                  f"{u['comm_frac']:>6.1%} {u['idle_frac']:>6.1%}")
        status = "ok" if not errors else f"{len(errors)} violations"
        print(f"{'':<10} trace -> {path} ({status}, "
              f"{len(srv.telemetry.tracer.spans)} spans, "
              f"{len(srv.telemetry.tracer.instants)} instants)")
    print(f"\ndevice {device}; open the traces in https://ui.perfetto.dev "
          f"or chrome://tracing")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

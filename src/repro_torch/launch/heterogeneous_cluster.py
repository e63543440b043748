"""Heterogeneous and unstable devices (paper Figs. 6, 9, 11 setting).  Port
of ``examples/heterogeneous_cluster.py``.

Simulates the Appendix-A protocol: fixed slowdown ratios (Hete. GPU) and
cosine-drift instability (Dyn. GPU), then compares round makespans under
  (a) no scheduling, (b) Parrot all-history, (c) Parrot Time-Window,
then the round-engine modes (DESIGN.md §3): BSP scheduling can only work
*around* stragglers; semi-sync and async hide them.  The final section
prices communication from a FedScale-style bandwidth trace (DESIGN.md §9):
a constrained lognormal uplink population makes the rounds comm-bound, and
top-k delta compression buys most of the makespan back.

  python -m repro_torch.launch.heterogeneous_cluster [--rounds 10]
      [--device cuda:0]

Runs on the card unless asked for the CPU (``--device cpu``).  The example
times real work with the executors' default ``perf_counter`` timer; ``run``
and ``cells`` take a ``timer`` (shared by the 8 executors) so a caller can
pass a ``TickTimer`` and get the JAX example's virtual makespans.  With
fewer than 5 rounds, the mean makespan skips fewer than the example's 3
warm-up rounds (the last round always counts).
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import (ClientStateManager, NetworkModel,
                              ParrotServer, SequentialExecutor, dynamic_env,
                              make_algorithm, value_and_grad)
from repro_torch.core.compression import make_compressor
from repro_torch.core.executor import hetero_gpus
from repro_torch.data import (make_classification_clients,
                              synthesize_capacity_trace)
from repro_torch.device import resolve_device

ROUNDS = 10
WARMUP = 3


def loss_fn(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


def run(name, policy, speed, window=0, engine="bsp", engine_opts=None,
        clients_per_round=40, network=None, compressor=None, *,
        rounds: int = ROUNDS, device=None, timer=None,
        verbose: bool = True) -> Dict[str, Any]:
    """One cell of the example: 200 clients (dim 32, 10 classes, quantity
    skew 5.0), FedAvg lr 0.05, 8 executors under ``speed``, ``rounds``
    rounds.  Returns the cell's makespans, its mean after the warm-up, the
    estimation errors of the rounds that have one and their mean, and the
    final params."""
    dev = resolve_device(device)
    params = {"w": torch.zeros(32, 10), "b": torch.zeros(10)}
    data = make_classification_clients(200, dim=32, n_classes=10,
                                       partition="quantity_skew",
                                       partition_arg=5.0, seed=0)
    algo = make_algorithm("fedavg", value_and_grad(loss_fn), lr=0.05)
    with tempfile.TemporaryDirectory(prefix="hetero_cluster_") as state_dir:
        sm = ClientStateManager(state_dir)
        execs = [SequentialExecutor(k, algo, state_manager=sm,
                                    speed_model=speed, timer=timer,
                                    device=dev) for k in range(8)]
        srv = ParrotServer(params=params, algorithm=algo, executors=execs,
                           data_by_client=data,
                           clients_per_round=clients_per_round,
                           scheduler_policy=policy, time_window=window,
                           round_engine=engine, engine_opts=engine_opts,
                           network=network, compressor=compressor, seed=0,
                           device=dev)
        ms = [srv.run_round().makespan for _ in range(rounds)]
    err = [h.estimation_error for h in srv.history
           if np.isfinite(h.estimation_error)]
    mean = float(np.mean(ms[min(WARMUP, rounds - 1):]))
    est = float(np.mean(err)) if err else float("nan")
    if verbose:
        print(f"{name:28s} mean_makespan={mean:.4f}s est_err={est:.3f}")
    return {"makespans": ms, "mean_makespan": mean,
            "estimation_errors": err, "est_err": est, "params": srv.params}


def cells(rounds: int = ROUNDS) -> List[tuple]:
    """The example's cells in its order: (section, name, ``run`` args,
    ``run`` keyword args)."""
    hete = hetero_gpus({k: [0.0, 0.5, 1.0, 3.0][k % 4] for k in range(8)})
    dyn = dynamic_env(8, rounds)
    net = NetworkModel.from_trace(synthesize_capacity_trace(
        200, seed=7, dist="lognormal", median_uplink_kbps=40.0))
    return [
        ("hete", "unscheduled", ("none", hete), {}),
        ("hete", "parrot", ("parrot", hete), {}),
        ("dyn", "unscheduled", ("none", dyn), {}),
        ("dyn", "parrot all-history", ("parrot", dyn), {"window": 0}),
        ("dyn", "parrot time-window(2)", ("parrot", dyn), {"window": 2}),
        ("engines", "bsp barrier", ("parrot", dyn),
         {"clients_per_round": 96}),
        ("engines", "semi-sync (deadline 0.55)", ("parrot", dyn),
         {"engine": "semi-sync", "clients_per_round": 96,
          "engine_opts": {"deadline_frac": 0.55, "over_select": 1.2,
                          "chunk_size": 4}}),
        ("engines", "async (lambda=0.5)", ("parrot", dyn),
         {"engine": "async", "clients_per_round": 96,
          "engine_opts": {"staleness_lambda": 0.5, "chunk_size": 8}}),
        ("network", "comm-free (no network)", ("parrot", hete), {}),
        ("network", "constrained uplink", ("parrot", hete),
         {"network": net}),
        ("network", "constrained + topk(5%)", ("parrot", hete),
         {"network": net, "compressor": make_compressor("topk", 0.05)}),
    ]


HEADERS = {
    "hete": "== Hete. GPU (fixed ratios 0/0.5/1/3) ==",
    "dyn": "\n== Dyn. GPU (cosine drift) ==",
    "engines": "\n== Round engines under Dyn. GPU (same scheduler, "
               "96/round) ==",
    "network": "\n== Bandwidth trace (lognormal uplinks, median 40 kbps) ==",
}


def run_all(rounds: int = ROUNDS, device=None, timer=None,
            sections=None, verbose: bool = True) -> Dict[str, Dict]:
    """Every cell of the listed ``sections`` (all by default), in the
    example's order: {section: {name: ``run``'s result}}, with the
    example's summary lines printed after each section."""
    out: Dict[str, Dict] = {}
    for section, name, args, kw in cells(rounds):
        if sections is not None and section not in sections:
            continue
        if section not in out:
            out[section] = {}
            if verbose:
                print(HEADERS[section])
        out[section][name] = run(name, *args, rounds=rounds, device=device,
                                 timer=timer, verbose=verbose, **kw)
        if verbose:
            _summary(section, out[section])
    return out


def _summary(section, res) -> None:
    m = {k: v["mean_makespan"] for k, v in res.items()}
    if section == "hete" and len(m) == 2:
        print(f"speedup: {m['unscheduled'] / m['parrot']:.2f}x")
    elif section == "engines" and len(m) == 3:
        print(f"async hides the straggler tail: "
              f"{m['bsp barrier'] / m['async (lambda=0.5)']:.2f}x shorter "
              f"rounds")
    elif section == "network" and len(m) == 3:
        e, f = m["comm-free (no network)"], m["constrained uplink"]
        g = m["constrained + topk(5%)"]
        print(f"comm turns makespan {f / max(e, 1e-12):.0f}x worse; "
              f"topk wins {f / max(g, 1e-12):.2f}x of it back")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (cpu on request)")
    args = ap.parse_args(argv)
    run_all(args.rounds, resolve_device(args.device))


if __name__ == "__main__":
    main()

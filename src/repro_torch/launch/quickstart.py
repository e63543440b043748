"""Quickstart: simulate 100 federated clients on 4 executors with Parrot.
Port of ``examples/quickstart.py``.

A model is params and a grad function; pick an FL algorithm, build the
executors, run rounds.  Hierarchical aggregation, scheduling and state
management are on by default.

  python -m repro_torch.launch.quickstart [--device cpu] [--rounds 10]

The example's wiring: a 32 x 10 softmax model from zeros, 100 clients at
dim 32 and 10 classes (``natural`` partition, seed 0), FedAvg at lr 0.05
with 2 local epochs, 4 executors sharing a ``ClientStateManager``, 20
clients a round.  It runs on the card unless asked for the CPU; on the card
every fold runs through the ``agg_weighted_sum`` kernel.  The example times
real work with the executors' ``perf_counter``; ``run`` takes a ``timer``
(shared by the executors) so a caller can pass a ``TickTimer`` and get the
JAX example's virtual makespans.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core import (ClientStateManager, ParrotServer,
                              SequentialExecutor, make_algorithm,
                              value_and_grad)
from repro_torch.data import make_classification_clients
from repro_torch.device import resolve_device

ROUNDS = 10


def loss_fn(params, batch):
    """Softmax regression's mean cross-entropy."""
    logits = batch["x"] @ params["w"] + params["b"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


def run(device=None, rounds: int = ROUNDS, timer=None,
        state_dir: Optional[str] = None, verbose: bool = False
        ) -> Tuple[List[Any], Any]:
    """``rounds`` rounds of the example on ``device``; returns the round
    history and the final params.  ``state_dir``: where the state manager
    spills (a temporary directory when None); ``verbose`` prints the
    example's line a round."""
    dev = resolve_device(device)
    params = {"w": torch.zeros(32, 10), "b": torch.zeros(10)}
    data = make_classification_clients(100, dim=32, n_classes=10,
                                       partition="natural", seed=0)
    algo = make_algorithm("fedavg", value_and_grad(loss_fn), lr=0.05,
                          local_epochs=2)
    with tempfile.TemporaryDirectory(prefix="quickstart_") as tmp:
        sm = ClientStateManager(state_dir or tmp)
        executors = [SequentialExecutor(k, algo, state_manager=sm,
                                        timer=timer, device=dev)
                     for k in range(4)]
        server = ParrotServer(params=params, algorithm=algo,
                              executors=executors, data_by_client=data,
                              clients_per_round=20, seed=0, device=dev)
        for _ in range(rounds):
            m = server.run_round()
            if verbose:
                print(f"round {m.round}: makespan={m.makespan:.3f}s "
                      f"comm={m.comm_bytes / 1e3:.1f}KB "
                      f"trips={m.comm_trips}")
    return server.history, server.params


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (cpu on request)")
    args = ap.parse_args(argv)
    _, params = run(args.device, args.rounds, verbose=True)
    print("final |w|:", float(torch.linalg.norm(params["w"])))


if __name__ == "__main__":
    main()

"""Stateful FL at scale: SCAFFOLD over 1000 clients with a memory-bounded
client state manager (paper §3.4), fault injection, checkpoint + resume.
Port of ``examples/stateful_scaffold.py``.

Shows:
  - control variates held by the tiered state store (watch the spill stats)
  - an executor failing mid-round and the system recovering (elastic K)
  - checkpoint/restart producing the identical model

  python -m repro_torch.launch.stateful_scaffold [--device cpu]

The example's wiring: a 16 x 8 softmax model from zeros, 1000 clients at
dim 16 and 8 classes with 30 samples on average (seed 0), SCAFFOLD at lr
0.1, a state manager whose budget holds about 8 states (8 x 2048 bytes:
the rest spill to disk), 8 executors, executor 5 failing in round 3 at its
third client, 50 clients a round, a checkpoint every 2 rounds, 6 rounds.
Then the restart: a fresh server on 7 executors with a new state manager,
``restore_latest``, and 2 more rounds.  It runs on the card unless asked
for the CPU; on the card every fold runs through the ``agg_weighted_sum``
kernel.  ``run`` takes a ``timer`` (shared by every executor of both
servers) so a caller can pass a ``TickTimer`` and get the JAX example's
virtual makespans.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.core import (ClientStateManager, ParrotServer,
                              SequentialExecutor, make_algorithm,
                              value_and_grad)
from repro_torch.data import make_classification_clients
from repro_torch.device import resolve_device
from repro_torch.launch.quickstart import loss_fn

ROUNDS = 6
MORE_ROUNDS = 2
BUDGET = 8 * 2048


def _server(algo, executors, data, dev, ckpt=None) -> ParrotServer:
    return ParrotServer(params={"w": torch.zeros(16, 8),
                                "b": torch.zeros(8)},
                        algorithm=algo, executors=executors,
                        data_by_client=data, clients_per_round=50,
                        checkpoint_manager=ckpt, seed=0, device=dev)


def run(device=None, rounds: int = ROUNDS, more_rounds: int = MORE_ROUNDS,
        timer=None, work: Optional[str] = None,
        verbose: bool = False) -> Dict[str, Any]:
    """The example on ``device``: ``rounds`` rounds with the failure and the
    checkpoints, then the restart for ``more_rounds``.  ``work``: the
    directory of the state and the checkpoints (a temporary one when None);
    ``verbose`` prints the example's lines.  Returns both servers' round
    histories and params, the restored round and the first state manager's
    stats, memory and disk bytes."""
    dev = resolve_device(device)
    grad_fn = value_and_grad(loss_fn)
    data = make_classification_clients(1000, dim=16, n_classes=8,
                                       mean_samples=30, seed=0)
    with tempfile.TemporaryDirectory(prefix="parrot_scaffold_") as tmp:
        work = work or tmp
        algo = make_algorithm("scaffold", grad_fn, lr=0.1)
        sm = ClientStateManager(os.path.join(work, "state"),
                                memory_budget_bytes=BUDGET)
        executors = [SequentialExecutor(k, algo, state_manager=sm,
                                        timer=timer, device=dev)
                     for k in range(8)]
        executors[5].fail_at = (3, 2)      # executor 5 dies in round 3
        server = _server(algo, executors, data, dev,
                         CheckpointManager(os.path.join(work, "ckpt"),
                                           every_rounds=2))
        for _ in range(rounds):
            m = server.run_round()
            if verbose:
                print(f"round {m.round}: K={m.n_executors} "
                      f"failures={m.failures} "
                      f"state_mem={sm.memory_bytes / 1e3:.0f}KB "
                      f"state_disk={sm.disk_bytes() / 1e6:.1f}MB "
                      f"spills={sm.stats['spills']}")
        stats = {"stats": dict(sm.stats), "memory_bytes": sm.memory_bytes,
                 "disk_bytes": sm.disk_bytes()}

        if verbose:
            print("\nsimulating a crash + restart ...")
        algo2 = make_algorithm("scaffold", grad_fn, lr=0.1)
        sm2 = ClientStateManager(os.path.join(work, "state2"),
                                 memory_budget_bytes=BUDGET)
        execs2 = [SequentialExecutor(k, algo2, state_manager=sm2,
                                     timer=timer, device=dev)
                  for k in range(7)]
        server2 = _server(algo2, execs2, data, dev)
        restored = restore_latest(server2, os.path.join(work, "ckpt"))
        if verbose:
            print(f"restored at round {restored}; continuing "
                  f"{more_rounds} more rounds")
        for _ in range(more_rounds):
            m = server2.run_round()
            if verbose:
                print(f"round {m.round}: K={m.n_executors}")
    if verbose:
        print("diff vs pre-crash params:",
              float(torch.max(torch.abs(server2.params["w"]
                                        - server.params["w"]))))
    return {"history": server.history, "params": server.params,
            "restored": restored, "history2": server2.history,
            "params2": server2.params, **stats}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (cpu on request)")
    args = ap.parse_args(argv)
    run(args.device, verbose=True)


if __name__ == "__main__":
    main()

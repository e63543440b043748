"""End-to-end Parrot FL training CLI.  Port of ``repro/launch/train.py``.

Runs Algorithm 2 with K sequential executors over a synthetic federated
dataset, any of the 6 FL algorithms, heterogeneity-aware scheduling, state
management, checkpointing and auto-resume.  The client model is either a
registry LM (``--model lm --arch ...``) or a small MLP (``--model mlp``,
the default, mirroring the paper's FEMNIST setting).

  python -m repro_torch.launch.train --device cpu --algorithm scaffold
  python -m repro_torch.launch.train --device cpu --compression topk
  python -m repro_torch.launch.train --device cpu --ckpt-dir DIR \\
      --ckpt-every 2 --rounds 4
  python -m repro_torch.launch.train --device cpu --ckpt-dir DIR --resume \\
      --rounds 6
  python -m repro_torch.launch.train --model lm --arch qwen2-0.5b \\
      --full-config --clients 8 --clients-per-round 4 --rounds 1

It runs on the card unless asked for the CPU.  On the card every fold runs
through the ``agg_weighted_sum`` kernel, ``--compression topk`` through the
``topk_compress`` kernel, and ``--model lm`` under ``--attention-impl
pallas`` (the default here) runs every attention layer and every norm
forward and backward through the hand-written kernels (the scan too, for a
hymba or xlstm arch).  The int8 codec has no kernel in either package.

Intended differences from the JAX CLI: the params come from a
``torch.Generator`` seeded with 0 (JAX draws them with ``jax.random``): the
MLP's on the CPU, then moved to the device, the LM's on the device;
``--device`` picks the device (default ``cuda:0``);
``--full-config`` trains the full-width config (JAX always takes the reduced
one); ``--attention-impl`` picks the attention route (JAX's configs default
to ``chunked``); an embedding-input arch embeds its clients' token ids
through the token table (``fl_train_lm.client_loss``); and ``run`` returns
the round history and the server (``main`` prints what JAX's prints).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import shutil
import tempfile
import weakref
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.core import (ClientStateManager, ParrotServer,
                              SequentialExecutor, make_algorithm,
                              value_and_grad)
from repro_torch.core.compression import make_compressor
from repro_torch.data import make_classification_clients, make_lm_clients
from repro_torch.device import resolve_device

MLP_DIMS = [32, 64, 10]


def lm_config(arch: str, full_config: bool = False,
              attention_impl: str = "pallas"):
    """The registry config of ``arch``: reduced unless ``full_config``, on
    the ``attention_impl`` route."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(arch)
    if not full_config:
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, attention_impl=attention_impl)


def mlp_loss(p, batch):
    """The MLP's mean cross-entropy: ReLU between layers."""
    x = batch["x"]
    n = len(MLP_DIMS) - 1
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    lse = torch.logsumexp(x, dim=-1)
    gold = torch.gather(x, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


def build_grad_fn(model: str, arch: Optional[str], lr: float, *,
                  device, full_config: bool = False,
                  attention_impl: str = "pallas") -> Tuple[Any, Any]:
    """Returns (grad_fn, params0) for the chosen client model, the params on
    ``device``.  ``lr`` is unused, as in the JAX CLI.  The MLP's weights
    are drawn by a CPU ``torch.Generator`` seeded with 0 and moved to
    ``device``, so a run starts from the same MLP on the card and on the
    CPU (a CUDA generator draws other numbers); the LM's by one on
    ``device``, as ``fl_train_lm`` draws them."""
    if model == "mlp":
        gen = torch.Generator().manual_seed(0)
        params = {f"w{i}": (torch.randn(a, b, generator=gen)
                            / math.sqrt(a)).to(device)
                  for i, (a, b) in enumerate(zip(MLP_DIMS[:-1],
                                                 MLP_DIMS[1:]))}
        params.update({f"b{i}": torch.zeros(b, device=device)
                       for i, b in enumerate(MLP_DIMS[1:])})
        return value_and_grad(mlp_loss), params

    from repro_torch.launch.fl_train_lm import client_loss
    from repro_torch.models import lm
    cfg = lm_config(arch, full_config, attention_impl)
    params = lm.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg)

    def loss_fn(p, batch):
        return client_loss(p, batch, cfg)

    return value_and_grad(loss_fn), params


def parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, choices and defaults, then the port's three."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algorithm", default="fedavg",
                    choices=["fedavg", "fedprox", "fednova", "mime",
                             "scaffold", "feddyn"])
    ap.add_argument("--model", default="mlp", choices=["mlp", "lm"])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--clients-per-round", type=int, default=20)
    ap.add_argument("--executors", type=int, default=4)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--scheduler", default="parrot",
                    choices=["parrot", "uniform", "none"])
    ap.add_argument("--time-window", type=int, default=0)
    ap.add_argument("--partition", default="natural")
    ap.add_argument("--compression", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0",
                    help="torch device to train on (cpu on request)")
    ap.add_argument("--full-config", action="store_true",
                    help="--model lm: the full (not reduced) config")
    ap.add_argument("--attention-impl", default="pallas",
                    choices=("pallas", "chunked", "dense"),
                    help="--model lm: pallas = the Hopper kernels")
    return ap


def build_server(args: argparse.Namespace, params, grad_fn, device,
                 timer=None) -> ParrotServer:
    """The JAX CLI's server: the data by model, one state manager shared
    by the K executors, a checkpoint manager when ``--ckpt-dir`` is given.
    ``timer``: the executors' timer (their ``perf_counter`` when None).
    Without ``--ckpt-dir`` the state lives in a fresh temporary directory,
    as in the JAX CLI, removed here once the server is collected."""
    if args.model == "mlp":
        data = make_classification_clients(
            args.clients, dim=32, n_classes=10, partition=args.partition,
            seed=args.seed)
    else:
        cfg = lm_config(args.arch, args.full_config, args.attention_impl)
        data = make_lm_clients(args.clients, vocab=cfg.vocab_size,
                               partition=args.partition, seed=args.seed)

    algo = make_algorithm(args.algorithm, grad_fn, args.lr,
                          local_epochs=args.local_epochs)
    state_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="parrot_state_")
    sm = ClientStateManager(os.path.join(state_dir, "client_state"))
    executors = [SequentialExecutor(k, algo, state_manager=sm, timer=timer,
                                    device=device)
                 for k in range(args.executors)]
    ckpt = CheckpointManager(os.path.join(state_dir, "ckpt"),
                             every_rounds=args.ckpt_every) \
        if args.ckpt_dir else None
    server = ParrotServer(
        params=params, algorithm=algo, executors=executors,
        data_by_client=data, clients_per_round=args.clients_per_round,
        scheduler_policy=args.scheduler, time_window=args.time_window,
        compressor=make_compressor(args.compression),
        checkpoint_manager=ckpt, seed=args.seed, device=device)
    if not args.ckpt_dir:
        weakref.finalize(server, shutil.rmtree, state_dir, True)
    return server


def run(argv: Optional[List[str]] = None, timer=None
        ) -> Tuple[List[Any], ParrotServer]:
    """Parse ``argv``, build the server, resume if asked, run the rounds up
    to ``--rounds`` printing one line each.  Returns the server's round
    history (restored rounds included) and the server."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    grad_fn, params = build_grad_fn(
        args.model, args.arch, args.lr, device=dev,
        full_config=args.full_config, attention_impl=args.attention_impl)
    server = build_server(args, params, grad_fn, dev, timer)

    start = 0
    if args.resume and args.ckpt_dir:
        restored = restore_latest(server, os.path.join(args.ckpt_dir, "ckpt"))
        if restored is not None:
            start = restored
            print(f"[train] resumed from round {restored}")

    for _ in range(start, args.rounds):
        m = server.run_round()
        print(f"[round {m.round:4d}] makespan={m.makespan:.3f}s "
              f"sched={m.schedule_time*1e3:.2f}ms "
              f"comm={m.comm_bytes/1e6:.2f}MB trips={m.comm_trips} "
              f"K={m.n_executors} est_err={m.estimation_error:.3f}")
    print("[train] done")
    return server.history, server


def main(argv: Optional[List[str]] = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()

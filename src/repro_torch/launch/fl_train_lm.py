"""End-to-end run: federated training of an LM through Parrot, with any
registry architecture as the client model.  Port of
``examples/fl_train_lm.py``.

  python -m repro_torch.launch.fl_train_lm --device cpu [--arch qwen2-0.5b]
      [--rounds 8] [--algorithm fedavg]
  python -m repro_torch.launch.fl_train_lm --full-config --rounds 2

The example's wiring: ``make_lm_clients(60, seq_len=32, batch_size=4,
mean_samples=8, seed=0)`` at the config's vocabulary, 12 clients a round, 4
``SequentialExecutor``s sharing a ``ClientStateManager``, ``make_algorithm(
--algorithm, value_and_grad(loss), lr=0.1, local_epochs=1)``, and the eval
loss on a fixed batch of 8 sequences printed after each round.  It runs on
the card unless asked for the CPU; on the card every norm, every SSD and
mLSTM scan (hymba-1.5b, xlstm-125m) and, under ``--attention-impl pallas``
(the default here), every attention layer runs forward and backward through
the hand-written kernels, and the sLSTM recomputes each time chunk in its
backward.  The MoE archs (grok-1-314b, llama4-scout-17b-a16e) add their
routers' auxiliary loss to the client loss:

  python -m repro_torch.launch.fl_train_lm --arch xlstm-125m --full-config
  python -m repro_torch.launch.fl_train_lm --arch hymba-1.5b --full-config

Intended differences from the JAX example: the eval batch comes from
``numpy.random.default_rng(0)`` (JAX draws it with ``jax.random``), the
params from a ``torch.Generator`` seeded with 0 on the target device,
``--attention-impl`` defaults to ``pallas`` (as ``launch/serve.py``), and
``--full-config`` runs the full-width config (the JAX example always takes
the reduced one), and an embedding-input arch (llama4-scout-17b-a16e, whose
early-fusion frontend is a stub) takes its clients' token ids through the
token table, as ``launch/serve.py``'s decode does (the JAX example feeds it
the ids as embeddings, which fails).
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import (ClientStateManager, ParrotServer,
                              SequentialExecutor, make_algorithm,
                              value_and_grad)
from repro_torch.data import make_lm_clients
from repro_torch.device import as_tensor, resolve_device
from repro_torch.models import lm

N_CLIENTS = 60
PER_ROUND = 12
K = 4
SEQ_LEN = 32


def lm_data(cfg) -> Dict[int, Any]:
    """The example's clients at the config's vocabulary."""
    return make_lm_clients(N_CLIENTS, vocab=cfg.vocab_size, seq_len=SEQ_LEN,
                           batch_size=4, mean_samples=8, seed=0)


def client_loss(params, batch, cfg):
    """``lm.loss_and_aux`` on a client's token batch; an embedding-input
    arch embeds the ids through the token table first."""
    if cfg.input_kind == "embeddings":
        batch = dict(batch, inputs=params["embed"]["w"][batch["inputs"]
                                                       .long()])
    return lm.loss_and_aux(params, batch, cfg)


def build(cfg, params, device, state_dir: str, algorithm: str = "fedavg",
          data: Optional[Dict[int, Any]] = None, timer=None
          ) -> ParrotServer:
    """The example's server on ``device`` (``timer``: the executors' timer,
    their default ``perf_counter`` when None)."""
    def loss_fn(p, batch):
        return client_loss(p, batch, cfg)

    algo = make_algorithm(algorithm, value_and_grad(loss_fn), lr=0.1,
                          local_epochs=1)
    sm = ClientStateManager(state_dir)
    execs = [SequentialExecutor(k, algo, state_manager=sm, device=device,
                                timer=timer) for k in range(K)]
    return ParrotServer(params=params, algorithm=algo, executors=execs,
                        data_by_client=lm_data(cfg) if data is None else data,
                        clients_per_round=PER_ROUND, seed=0, device=device)


def eval_batch(cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """8 sequences of 32 random tokens and 32 random labels, int32."""
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, size=(8, SEQ_LEN),
                            dtype=np.int32) for k in ("inputs", "labels")}


def eval_loss(params, batch, cfg) -> float:
    """The mean token loss of ``batch`` (numpy) under ``params``."""
    dev = params["embed"]["w"].device
    with torch.no_grad():
        loss = client_loss(
            params, {k: as_tensor(v, dev) for k, v in batch.items()}, cfg)
    return float(loss)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--algorithm", default="fedavg")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device to train on (cpu on request)")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--attention-impl", default="pallas",
                    choices=("pallas", "chunked", "dense"),
                    help="attention: pallas = the Hopper kernels")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_arch

    cfg = get_arch(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    dev = resolve_device(args.device)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = eval_batch(cfg)
    with tempfile.TemporaryDirectory(prefix="fl_train_lm_") as state_dir:
        server = build(cfg, params, dev, state_dir, args.algorithm)
        for _ in range(args.rounds):
            m = server.run_round()
            loss = eval_loss(server.params, batch, cfg)
            print(f"round {m.round}: clients={m.n_clients} "
                  f"makespan={m.makespan:.2f}s eval_loss={loss:.4f}")
    print(f"done — federated LM training via Parrot on {cfg.name} "
          f"({dev}, attention={cfg.attention_impl})")


if __name__ == "__main__":
    main()

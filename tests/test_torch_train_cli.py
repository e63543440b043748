"""``repro_torch.launch.train`` against the JAX CLI ``repro.launch.train``
on the CPU.

The JAX CLI's ``main`` takes no timer, so ``_jax_server`` below restates
its server wiring (``src/repro/launch/train.py:86-119``) with a
``TickTimer`` shared by the executors; the port's side is
``train.build_server`` with JAX's params carried over
(``params_from_jax``) and a ``TickTimer`` of its own.  Both packages get
the same flags.  Held exactly: makespans, each round's selected clients,
``n_executors``, ``comm_bytes`` and ``comm_trips``; params within 1e-5 (the
MLP) or 1e-5 / 1e-4 relative (the reduced LM, with its loss within 1e-5, as
``tests/test_torch_lm_train.py``).  The resume case holds the port to itself
by ``params_digest``.

Cuts for time (the JAX side compiles its client step for each block shape,
which takes most of it): every MLP parity case runs 3 rounds of 40
clients, 8 a round (the CLI's defaults: 10 rounds of 100 clients, 20 a
round), the algorithm and codec cases under ``--partition dirichlet``
(near-equal client sizes: fewer block shapes), the scheduler cases under
the default ``natural`` sizes the policies act on; the resume case 40
clients, 8 a round; the LM case 2 rounds of 4 clients, all 4 a round, one
local epoch (2 by default).
``chip_smoke.py`` phase 17 runs the algorithm and codec cases at the
CLI's defaults but 3 rounds, card against CPU.
"""
import argparse
import os
import re

import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core.compression import make_compressor as jmake_compressor
from repro.data import make_classification_clients as jclassification
from repro.data import make_lm_clients as jlm_clients
from repro.launch import train as jtrain
import repro_torch.core as T
from repro_torch.checkpoint import params_digest
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.kernels import ops
from repro_torch.launch import train

ALGOS = ["fedavg", "fedprox", "fednova", "mime", "scaffold", "feddyn"]
ROUNDS = 3
CUT = ["--clients", "40", "--clients-per-round", "8", "--rounds", str(ROUNDS)]
SIZES = ["--partition", "dirichlet"]
LM_FLAGS = ["--model", "lm", "--arch", "qwen2-0.5b", "--clients", "4",
            "--clients-per-round", "4", "--local-epochs", "1",
            "--rounds", "2"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the models' ops are small, and the suite
    runs six workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_server(args, params, grad_fn, timer, state_dir):
    """``src/repro/launch/train.py:86-119`` with ``timer`` on the executors
    (``state_dir`` in place of its ``mkdtemp`` when no ``--ckpt-dir``)."""
    if args.model == "mlp":
        data = jclassification(args.clients, dim=32, n_classes=10,
                               partition=args.partition, seed=args.seed)
    else:
        from repro.configs.registry import get_arch
        cfg = get_arch(args.arch).reduced()
        data = jlm_clients(args.clients, vocab=cfg.vocab_size,
                           partition=args.partition, seed=args.seed)
    algo = J.make_algorithm(args.algorithm, grad_fn, args.lr,
                            local_epochs=args.local_epochs)
    state_dir = args.ckpt_dir or state_dir
    sm = J.ClientStateManager(os.path.join(state_dir, "client_state"))
    executors = [J.SequentialExecutor(k, algo, state_manager=sm, timer=timer)
                 for k in range(args.executors)]
    ckpt = JCheckpointManager(os.path.join(state_dir, "ckpt"),
                              every_rounds=args.ckpt_every) \
        if args.ckpt_dir else None
    return J.ParrotServer(
        params=params, algorithm=algo, executors=executors,
        data_by_client=data, clients_per_round=args.clients_per_round,
        scheduler_policy=args.scheduler, time_window=args.time_window,
        compressor=jmake_compressor(args.compression),
        checkpoint_manager=ckpt, seed=args.seed)


def _record_cohorts(monkeypatch, cls):
    """Each ``select_clients`` call's client ids, in call order."""
    seen, inner = [], cls.select_clients

    def select(self, *a, **kw):
        tasks = inner(self, *a, **kw)
        seen.append([t.client for t in tasks])
        return tasks

    monkeypatch.setattr(cls, "select_clients", select)
    return seen


def _rows(history):
    return [(m.round, m.makespan, m.n_clients, m.n_executors, m.comm_bytes,
             m.comm_trips, m.failures) for m in history]


def _both(argv, monkeypatch, tmp_path):
    """The JAX wiring and the port's ``build_server`` on the same flags and
    JAX's params, each under its own ``TickTimer(1.0)``, for ``--rounds``
    rounds.  Returns (JAX server, port server, JAX cohorts, port cohorts,
    JAX grad_fn, port grad_fn)."""
    args = train.parser().parse_args(argv + ["--device", "cpu"])
    jsel = _record_cohorts(monkeypatch, J.ParrotServer)
    tsel = _record_cohorts(monkeypatch, T.ParrotServer)
    jgrad, jparams = jtrain.build_grad_fn(args.model, args.arch, args.lr)
    js = _jax_server(args, jparams, jgrad, J.TickTimer(1.0),
                     str(tmp_path / "jax"))
    tgrad, _ = train.build_grad_fn(args.model, args.arch, args.lr,
                                   device="cpu",
                                   attention_impl=args.attention_impl)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    ts = train.build_server(args, tparams, tgrad, torch.device("cpu"),
                            T.TickTimer(1.0))
    for _ in range(args.rounds):
        js.run_round()
        ts.run_round()
    return js, ts, jsel, tsel, jgrad, tgrad


def _hold_to_jax(js, ts, jsel, tsel, atol=1e-5, rtol=0.0):
    assert tsel == jsel and len(tsel) == len(ts.history)
    assert _rows(ts.history) == _rows(js.history)
    tl, jl = tree.leaves(ts.params), jax.tree.leaves(js.params)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(j, np.float32), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_algorithm_matches_jax(algorithm, monkeypatch, tmp_path):
    js, ts, jsel, tsel, _, _ = _both(["--algorithm", algorithm] + CUT
                                     + SIZES, monkeypatch, tmp_path)
    _hold_to_jax(js, ts, jsel, tsel)
    assert [m.n_executors for m in ts.history] == [4] * ROUNDS


@pytest.mark.parametrize("flags", [
    ["--compression", "topk"] + SIZES, ["--compression", "int8"] + SIZES,
    ["--scheduler", "uniform"], ["--scheduler", "none"],
    ["--time-window", "2"]], ids=lambda f: "-".join(f[:2]).lstrip("-"))
def test_codecs_and_schedulers_match_jax(flags, monkeypatch, tmp_path):
    js, ts, jsel, tsel, _, _ = _both(flags + CUT, monkeypatch, tmp_path)
    _hold_to_jax(js, ts, jsel, tsel)


def test_reduced_lm_matches_jax(monkeypatch, tmp_path):
    """The reduced qwen2-0.5b client model: the port on the kernel route
    (``pallas``: the flash and norm Functions with their plain versions on
    the CPU), JAX on its configs' ``chunked`` route."""
    ops.reset_flash_counts()
    ops.reset_rmsnorm_counts()
    js, ts, jsel, tsel, jgrad, tgrad = _both(LM_FLAGS, monkeypatch,
                                             tmp_path)
    _hold_to_jax(js, ts, jsel, tsel, atol=1e-5, rtol=1e-4)
    # every attention layer and norm went forward and backward through its
    # Function (the plain versions on the CPU; no launch)
    assert ops.flash_dispatches > 0 and ops.rmsnorm_dispatches > 0
    assert (ops.flash_bwd_dispatches, ops.rmsnorm_bwd_dispatches) == \
        (ops.flash_dispatches, ops.rmsnorm_dispatches)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    # the loss of the final params on one client batch, in both packages
    batch = jlm_clients(4, vocab=256, seed=0)[0].batches[0]
    jl, _ = jgrad(js.params, batch)
    tl, _ = tgrad(ts.params, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=0)


def test_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    """SCAFFOLD, so client state crosses the checkpoint: 2 rounds with a
    checkpoint at round 2, then a fresh ``run`` with ``--resume`` up to
    round 4: the same params (by ``params_digest``) and the same makespans
    as 4 rounds run straight through."""
    base = ["--device", "cpu", "--algorithm", "scaffold", "--ckpt-every", "2",
            "--clients", "40", "--clients-per-round", "8"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    train.run(base + ["--ckpt-dir", a, "--rounds", "2"],
              timer=T.TickTimer(1.0))
    hist, srv = train.run(base + ["--ckpt-dir", a, "--resume",
                                  "--rounds", "4"], timer=T.TickTimer(1.0))
    assert "[train] resumed from round 2" in capsys.readouterr().out
    want_hist, want = train.run(base + ["--ckpt-dir", b, "--rounds", "4"],
                                timer=T.TickTimer(1.0))
    assert params_digest(srv.params) == params_digest(want.params)
    assert [m.round for m in hist] == [0, 1, 2, 3]
    assert [(m.round, m.makespan) for m in hist] == \
        [(m.round, m.makespan) for m in want_hist]


def _numbers_out(text):
    """The printed lines with every number replaced by ``N``."""
    return re.sub(r"nan|-?\d+(\.\d+)?", "N", text).splitlines()


def test_run_prints_the_jax_cli_s_lines(capsys):
    jtrain.main(["--rounds", "2", "--clients", "20",
                 "--clients-per-round", "4"])
    want = capsys.readouterr().out
    hist, _ = train.run(["--device", "cpu", "--rounds", "2", "--clients",
                         "20", "--clients-per-round", "4"])
    got = capsys.readouterr().out
    assert _numbers_out(got) == _numbers_out(want)
    assert got.splitlines()[-1] == "[train] done"
    assert len(hist) == 2 and got.count("[round ") == 2
    assert re.match(r"\[round    0\] makespan=\d+\.\d{3}s sched=\d+\.\d{2}ms "
                    r"comm=\d+\.\d{2}MB trips=\d+ K=4 est_err=nan$",
                    got.splitlines()[0])


def _jax_parser():
    """The parser the JAX CLI's ``main`` builds (caught at its
    ``parse_args``)."""
    caught = []
    real = argparse.ArgumentParser.parse_args

    def parse_args(self, *a, **kw):
        caught.append(self)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(SystemExit):
            jtrain.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught[0]


def _flags(ap):
    return {a.dest: (tuple(a.option_strings), a.default,
                     None if a.choices is None else tuple(a.choices),
                     a.type, type(a).__name__)
            for a in ap._actions if a.dest != "help"}


def test_flags_are_the_jax_cli_s_plus_three():
    want, got = _flags(_jax_parser()), _flags(train.parser())
    added = {k: got.pop(k) for k in ("device", "full_config",
                                     "attention_impl")}
    assert got == want
    assert added["device"][1] == "cuda:0"
    assert added["full_config"][1] is False
    assert added["attention_impl"][1:3] == ("pallas",
                                            ("pallas", "chunked", "dense"))


def test_mlp_params_are_torch_seeded():
    """The MLP's params: a CPU generator seeded with 0 (the same numbers
    whatever the device), normal / sqrt(fan-in) weights, zero biases."""
    _, p = train.build_grad_fn("mlp", None, 0.05, device="cpu")
    gen = torch.Generator().manual_seed(0)
    w0 = torch.randn(32, 64, generator=gen) / np.sqrt(32)
    w1 = torch.randn(64, 10, generator=gen) / np.sqrt(64)
    assert sorted(p) == ["b0", "b1", "w0", "w1"]
    assert torch.equal(p["w0"], w0) and torch.equal(p["w1"], w1)
    assert torch.equal(p["b0"], torch.zeros(64))
    assert torch.equal(p["b1"], torch.zeros(10))
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in p.values())


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train.run(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.run(["--device", "cuda:0", "--rounds", "1"])

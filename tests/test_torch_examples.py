"""The port's twins of ``examples/quickstart.py`` and
``examples/stateful_scaffold.py`` (``repro_torch.launch.quickstart``,
``repro_torch.launch.stateful_scaffold``) against the examples' wiring
rebuilt with the JAX package under a ``TickTimer`` on the CPU.

The examples run when imported and time with ``perf_counter``, so
``_jax_quickstart`` and ``_jax_scaffold`` below restate them with a timer
(one ``TickTimer(1.0)`` shared by every executor, as each twin's ``timer``
is) and a round count.  Held exactly: each round's makespan, selected
clients, ``n_executors``, failures, ``comm_bytes`` and ``comm_trips``, the
restored round and the state manager's spill count; params within 1e-5.

Cut for time: the quickstart runs 5 of its 10 rounds; the stateful example
runs 4 rounds before the restart (it runs 6): executor 5 still fails in
round 3 and the restart restores the checkpoint of round 4 (the
example's: 6).  ``chip_smoke.py`` phase 17 runs the quickstart's 10 rounds,
card against CPU.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as J
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import restore_latest as jrestore_latest
from repro.data import make_classification_clients as jclassification
import repro_torch.core as T
from repro_torch.core import tree
from repro_torch.launch import quickstart, stateful_scaffold
from test_torch_train_cli import _one_torch_thread  # noqa: F401 (fixture)
from test_torch_train_cli import _record_cohorts, _rows

QUICKSTART_ROUNDS = 5
SCAFFOLD_ROUNDS = 4


def _jax_loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lse = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, batch["y"][:, None].astype(jnp.int32),
                               axis=-1)[:, 0]
    return jnp.mean(lse - gold)


_JAX_GRAD = jax.jit(jax.value_and_grad(_jax_loss))


def _close(got, want):
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def _jax_quickstart(rounds, timer, state_dir):
    """``examples/quickstart.py`` with ``timer`` on its executors."""
    params = {"w": jnp.zeros((32, 10)), "b": jnp.zeros((10,))}
    data = jclassification(100, dim=32, n_classes=10, partition="natural",
                           seed=0)
    algo = J.make_algorithm("fedavg", _JAX_GRAD, lr=0.05, local_epochs=2)
    sm = J.ClientStateManager(state_dir)
    executors = [J.SequentialExecutor(k, algo, state_manager=sm, timer=timer)
                 for k in range(4)]
    server = J.ParrotServer(params=params, algorithm=algo,
                            executors=executors, data_by_client=data,
                            clients_per_round=20, seed=0)
    for _ in range(rounds):
        server.run_round()
    return server


def test_quickstart_matches_the_jax_example(monkeypatch, tmp_path):
    jsel = _record_cohorts(monkeypatch, J.ParrotServer)
    tsel = _record_cohorts(monkeypatch, T.ParrotServer)
    js = _jax_quickstart(QUICKSTART_ROUNDS, J.TickTimer(1.0), str(tmp_path))
    hist, params = quickstart.run("cpu", QUICKSTART_ROUNDS, T.TickTimer(1.0))
    assert len(hist) == QUICKSTART_ROUNDS and tsel == jsel
    assert _rows(hist) == _rows(js.history)
    _close(params, js.params)


def test_quickstart_main_prints_the_example_s_lines(capsys):
    quickstart.main(["--device", "cpu", "--rounds", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("round 0: makespan=")
    assert "KB trips=" in lines[1] and lines[2].startswith("final |w|: ")


def _jax_scaffold(rounds, more_rounds, timer, work):
    """``examples/stateful_scaffold.py`` with ``timer`` on every executor
    and its round counts as arguments."""
    params = {"w": jnp.zeros((16, 8)), "b": jnp.zeros((8,))}
    data = jclassification(1000, dim=16, n_classes=8, mean_samples=30,
                           seed=0)
    algo = J.make_algorithm("scaffold", _JAX_GRAD, lr=0.1)
    sm = J.ClientStateManager(os.path.join(work, "state"),
                              memory_budget_bytes=8 * 2048)
    executors = [J.SequentialExecutor(k, algo, state_manager=sm, timer=timer)
                 for k in range(8)]
    executors[5].fail_at = (3, 2)
    server = J.ParrotServer(
        params=params, algorithm=algo, executors=executors,
        data_by_client=data, clients_per_round=50,
        checkpoint_manager=JCheckpointManager(os.path.join(work, "ckpt"),
                                              every_rounds=2),
        seed=0)
    for _ in range(rounds):
        server.run_round()
    spills = sm.stats["spills"]
    algo2 = J.make_algorithm("scaffold", _JAX_GRAD, lr=0.1)
    sm2 = J.ClientStateManager(os.path.join(work, "state2"),
                               memory_budget_bytes=8 * 2048)
    execs2 = [J.SequentialExecutor(k, algo2, state_manager=sm2, timer=timer)
              for k in range(7)]
    server2 = J.ParrotServer(params=params, algorithm=algo2,
                             executors=execs2, data_by_client=data,
                             clients_per_round=50, seed=0)
    restored = jrestore_latest(server2, os.path.join(work, "ckpt"))
    for _ in range(more_rounds):
        server2.run_round()
    return server, server2, restored, spills


def test_stateful_scaffold_matches_the_jax_example(monkeypatch, capsys):
    jsel = _record_cohorts(monkeypatch, J.ParrotServer)
    tsel = _record_cohorts(monkeypatch, T.ParrotServer)
    with tempfile.TemporaryDirectory() as work:
        js, js2, jrestored, jspills = _jax_scaffold(
            SCAFFOLD_ROUNDS, 2, J.TickTimer(1.0), work)
    got = stateful_scaffold.run("cpu", SCAFFOLD_ROUNDS, 2, T.TickTimer(1.0),
                                verbose=True)
    out = capsys.readouterr().out
    assert tsel == jsel and len(tsel) == SCAFFOLD_ROUNDS + 2
    assert _rows(got["history"]) == _rows(js.history)
    assert _rows(got["history2"]) == _rows(js2.history)
    assert got["restored"] == jrestored == SCAFFOLD_ROUNDS
    _close(got["params"], js.params)
    _close(got["params2"], js2.params)
    # executor 5 fails in round 3 and the run goes on with 7; the restart
    # on 7 executors retires the failed one and runs with 6
    ks = [(m.n_executors, m.failures) for m in got["history"]]
    assert ks == [(8, 0)] * 3 + [(7, 1)] + [(7, 0)] * (SCAFFOLD_ROUNDS - 4)
    assert [m.n_executors for m in got["history2"][SCAFFOLD_ROUNDS:]] == \
        [6, 6]
    assert got["stats"]["spills"] == jspills > 0
    assert got["disk_bytes"] > 0
    assert "round 3: K=7 failures=1 " in out
    assert f"restored at round {SCAFFOLD_ROUNDS}; continuing 2 more rounds" \
        in out and "diff vs pre-crash params:" in out

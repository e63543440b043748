"""``repro_torch.launch.heterogeneous_cluster`` against the JAX example
``examples/heterogeneous_cluster.py`` on the CPU: every cell (Hete. GPU,
Dyn. GPU, the three round engines, the bandwidth trace with and without
top-k) at 3 rounds under a ``TickTimer`` in both packages.  The makespans
and the estimation errors must be equal exactly, the params after the last
round within 1e-5.

The example runs its cells when imported, so ``_jax_run`` below restates
its ``run`` with the timer and round count as arguments.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.compression import make_compressor as jmake_compressor
from repro.core.executor import dynamic_env as jdynamic_env
from repro.core.executor import hetero_gpus as jhetero_gpus
from repro.data import make_classification_clients as jclients
from repro.data import synthesize_capacity_trace as jtrace
import repro_torch.core as T
from repro_torch.core import tree
from repro_torch.launch import heterogeneous_cluster as hc

ROUNDS = 3
CELLS = [(s, n) for s, n, _, _ in hc.cells(ROUNDS)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the reduced models' ops are small, and
    the suite runs six workers on the machine's cores (spinning thread
    pools made these tests many times slower under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lse = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, batch["y"][:, None].astype(jnp.int32),
                               axis=-1)[:, 0]
    return jnp.mean(lse - gold)


# one jitted function for every cell, as the example's module-level grad_fn
_JAX_GRAD = jax.jit(jax.value_and_grad(_jax_loss))


def _jax_cells(rounds):
    """The example's speed models, network and compressor, by cell name."""
    hete = jhetero_gpus({k: [0.0, 0.5, 1.0, 3.0][k % 4] for k in range(8)})
    dyn = jdynamic_env(8, rounds)
    net = J.NetworkModel.from_trace(jtrace(
        200, seed=7, dist="lognormal", median_uplink_kbps=40.0))
    port = {(s, n): (args, kw) for s, n, args, kw in hc.cells(rounds)}
    out = {}
    for key, ((policy, speed), kw) in port.items():
        kw = dict(kw)
        if "network" in kw:
            kw["network"] = net
        if "compressor" in kw:
            kw["compressor"] = jmake_compressor("topk", 0.05)
        out[key] = (policy, hete if key[0] in ("hete", "network") else dyn,
                    kw)
    return out


def _jax_run(policy, speed, window=0, engine="bsp", engine_opts=None,
             clients_per_round=40, network=None, compressor=None, *,
             rounds, timer):
    """``examples/heterogeneous_cluster.py``'s ``run`` with a timer."""
    params = {"w": jnp.zeros((32, 10)), "b": jnp.zeros((10,))}
    data = jclients(200, dim=32, n_classes=10, partition="quantity_skew",
                    partition_arg=5.0, seed=0)
    algo = J.make_algorithm("fedavg", _JAX_GRAD, lr=0.05)
    with tempfile.TemporaryDirectory() as state_dir:
        sm = J.ClientStateManager(state_dir)
        execs = [J.SequentialExecutor(k, algo, state_manager=sm,
                                      speed_model=speed, timer=timer)
                 for k in range(8)]
        srv = J.ParrotServer(params=params, algorithm=algo, executors=execs,
                             data_by_client=data,
                             clients_per_round=clients_per_round,
                             scheduler_policy=policy, time_window=window,
                             round_engine=engine, engine_opts=engine_opts,
                             network=network, compressor=compressor, seed=0)
        ms = [srv.run_round().makespan for _ in range(rounds)]
    err = [h.estimation_error for h in srv.history
           if np.isfinite(h.estimation_error)]
    return ms, err, srv.params


@pytest.mark.parametrize("section,name", CELLS)
def test_cell_matches_the_jax_example(section, name):
    args, kw = {(s, n): (a, k) for s, n, a, k in hc.cells(ROUNDS)}[
        (section, name)]
    policy, speed, jkw = _jax_cells(ROUNDS)[(section, name)]
    want_ms, want_err, jparams = _jax_run(policy, speed, rounds=ROUNDS,
                                          timer=J.TickTimer(1.0), **jkw)
    got = hc.run(name, *args, rounds=ROUNDS, device="cpu",
                 timer=T.TickTimer(1.0), verbose=False, **kw)
    assert got["makespans"] == want_ms
    assert got["estimation_errors"] == want_err
    assert got["mean_makespan"] == float(np.mean(want_ms[ROUNDS - 1:]))
    for a, b in zip(tree.leaves(got["params"]),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


def test_cells_are_the_example_s_eleven(capsys):
    assert [n for _, n in CELLS] == [
        "unscheduled", "parrot", "unscheduled", "parrot all-history",
        "parrot time-window(2)", "bsp barrier", "semi-sync (deadline 0.55)",
        "async (lambda=0.5)", "comm-free (no network)", "constrained uplink",
        "constrained + topk(5%)"]
    res = hc.run_all(rounds=2, device="cpu", timer=T.TickTimer(1.0),
                     sections=("hete",))
    out = capsys.readouterr().out
    assert "== Hete. GPU (fixed ratios 0/0.5/1/3) ==" in out
    assert "speedup: " in out and list(res) == ["hete"]
    assert all(len(r["makespans"]) == 2 for r in res["hete"].values())

"""The port's collective comm (``repro_torch.comm.collective``) against the
JAX package's: ``spmd_global_aggregate`` equals the host aggregate (the
cases of ``tests/test_collective_comm.py``), and ``CollectiveComm``'s
inbox and byte accounting equal JAX's ``CollectiveComm`` on the same
partials and in the same BSP rounds under a ``TickTimer``.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.comm.collective import CollectiveComm as JCollectiveComm
from repro.comm.collective import spmd_global_aggregate as jspmd
from repro.data import make_classification_clients as jclients
from repro_torch.comm import CollectiveComm, LocalComm, spmd_global_aggregate
from repro_torch.core.flat import flat_sums
from repro_torch.data import make_classification_clients as tclients
from repro_torch.kernels import ops


def _jloss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lse = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(
        logits, batch["y"][:, None].astype(jnp.int32), axis=-1)[:, 0]
    return jnp.mean(lse - gold)


def _tloss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


JGRAD = jax.jit(jax.value_and_grad(_jloss))
TGRAD = T.value_and_grad(_tloss)


def _client_results(K, seed):
    """K executors' worth of (delta (6, 2), count, weight) draws."""
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=(6, 2)).astype(np.float32),
              float(rng.integers(1, 50))) for _ in range(3)]
            for _ in range(K)]


def _partials(pkg, K=4, seed=0):
    """The same flat partials in either package (LocalAggregator folds)."""
    ops_ = {"delta": pkg.Op.WEIGHTED_AVG, "count": pkg.Op.SUM}
    arr = (jnp.asarray if pkg is J else torch.from_numpy)
    parts = []
    for draws in _client_results(K, seed):
        agg = (pkg.LocalAggregator(ops_) if pkg is J
               else pkg.LocalAggregator(ops_, device="cpu"))
        for delta, w in draws:
            agg.fold(pkg.ClientResult(
                {"delta": {"w": arr(delta)},
                 "count": arr(np.ones((), np.float32))}, ops_, weight=w))
        parts.append(agg.partial())
    return parts, ops_


def test_spmd_aggregate_matches_host():
    parts, ops_ = _partials(T)
    host = T.global_aggregate(parts, ops_)
    ops.reset_agg_counts()
    spmd = spmd_global_aggregate(parts, ops_)
    assert ops.agg_dispatches == 2               # one a weight group
    assert torch.equal(host["delta"]["w"], spmd["delta"]["w"])
    assert float(host["count"]) == float(spmd["count"])
    jparts, jops = _partials(J)
    jref = jspmd(jparts, jops, mesh=None)
    np.testing.assert_allclose(spmd["delta"]["w"].numpy(),
                               np.asarray(jref["delta"]["w"]), rtol=1e-6)
    assert float(spmd["count"]) == float(jref["count"])


def test_spmd_aggregate_onto_named_devices():
    parts, ops_ = _partials(T, K=3)
    host = T.global_aggregate(parts, ops_)
    spmd = spmd_global_aggregate(parts, ops_, devices=["cpu"])
    assert torch.equal(host["delta"]["w"], spmd["delta"]["w"])
    assert spmd["delta"]["w"].device.type == "cpu"


def _nested(pkg, K=3, seed=1):
    """Legacy nested partials ``{"sums": {entry: tree}, ...}``."""
    rng = np.random.default_rng(seed)
    arr = (jnp.asarray if pkg is J else torch.from_numpy)
    parts = []
    for k in range(K):
        parts.append({
            "sums": {"delta": {"w": arr(rng.normal(size=(4, 3))
                                        .astype(np.float32))},
                     "mean": arr(rng.normal(size=(5,)).astype(np.float32)),
                     "n": arr(np.array(k + 1, np.float32))},
            "weights": {"delta": 3.0 + k},
            "counts": {"mean": 2},
            "collected": {"tags": [(1.0, k)]}})
    ops_ = {"delta": pkg.Op.WEIGHTED_AVG, "mean": pkg.Op.AVG,
            "n": pkg.Op.SUM, "tags": pkg.Op.COLLECT}
    return parts, ops_


def test_spmd_aggregate_nested_partials_match_jax():
    """Nested partials stack and sum per entry, with JAX's AVG and
    WEIGHTED_AVG divisions and COLLECT concatenation."""
    tp, tops = _nested(T)
    jp, jops = _nested(J)
    got = spmd_global_aggregate(tp, tops)
    want = jspmd(jp, jops)
    np.testing.assert_allclose(got["delta"]["w"].numpy(),
                               np.asarray(want["delta"]["w"]), rtol=1e-6)
    np.testing.assert_allclose(got["mean"].numpy(), np.asarray(want["mean"]),
                               rtol=1e-6)
    assert float(got["n"]) == float(want["n"])
    assert got["tags"] == want["tags"]


def test_collective_comm_ships_by_reference_one_slot():
    buf = torch.arange(8.0)
    partial = {"sums": flat_sums({"weighted": buf}), "collected": {}}
    comm = CollectiveComm()
    comm.executor_send(1, partial, tag="partial")
    got = comm.poll(1, tag="partial")
    assert got is partial and got["sums"]["buffers"]["weighted"] is buf
    assert comm.poll(1, tag="partial") is None
    comm.executor_send(2, partial, tag="partial")
    comm.executor_send(2, {"sums": {}}, tag="partial")   # a single slot
    assert comm.recv_from_executor(2, "partial") == {"sums": {}}
    comm.broadcast(partial, [0, 1], tag="b")
    assert comm.executor_recv(0, "b") is partial
    assert comm.executor_recv(1, "b") is partial


@pytest.mark.parametrize("K", [1, 4])
def test_collective_comm_bytes_match_jax(K):
    """Broadcast billed once whatever K; a partial billed at twice its
    sums' bytes; a send to one executor at its bytes — as JAX's."""
    tc, jc = CollectiveComm(), JCollectiveComm()
    tparts, _ = _partials(T, K=K)
    jparts, _ = _partials(J, K=K)
    payload_t = {"params": {"w": torch.zeros(6, 2)}, "lr": 0.1}
    payload_j = {"params": {"w": jnp.zeros((6, 2))}, "lr": 0.1}
    tc.broadcast(payload_t, list(range(K)), "broadcast")
    jc.broadcast(payload_j, list(range(K)), "broadcast")
    for k in range(K):
        tc.executor_send(k, tparts[k], "partial")
        jc.executor_send(k, jparts[k], "partial")
    tc.send_to_executor(0, payload_t, "one")
    jc.send_to_executor(0, payload_j, "one")
    assert tc.stats.by_tag == jc.stats.by_tag
    assert (tc.stats.bytes_sent, tc.stats.trips) == \
        (jc.stats.bytes_sent, jc.stats.trips)
    lc = LocalComm()
    lc.broadcast(payload_t, list(range(K)), "broadcast")
    assert tc.stats.by_tag["broadcast"] * K == lc.stats.by_tag["broadcast"]


def _bsp(pkg, comm, rounds=3):
    make, grad = (jclients, JGRAD) if pkg is J else (tclients, TGRAD)
    zeros = jnp.zeros if pkg is J else torch.zeros
    dev = {} if pkg is J else {"device": "cpu"}
    data = make(40, dim=16, n_classes=4, mean_samples=40, seed=0)
    algo = pkg.make_algorithm("fedavg", grad, lr=0.05)
    timer = pkg.TickTimer(1.0)
    sm = pkg.ClientStateManager(tempfile.mkdtemp())
    execs = [pkg.SequentialExecutor(k, algo, state_manager=sm, timer=timer,
                                    **dev) for k in range(4)]
    srv = pkg.ParrotServer(params={"w": zeros((16, 4)), "b": zeros((4,))},
                           algorithm=algo, executors=execs,
                           data_by_client=data, clients_per_round=12,
                           seed=0, comm=comm, **dev)
    return srv, [srv.run_round() for _ in range(rounds)]


def test_bsp_rounds_under_collective_comm_match_jax():
    """Under ``CollectiveComm`` the BSP rounds bill the broadcast once plus
    twice each partial, exactly as JAX's; params equal the ``LocalComm``
    run bit for bit (the transport moves references only)."""
    tsrv, th = _bsp(T, CollectiveComm())
    jsrv, jh = _bsp(J, JCollectiveComm())
    lsrv, lh = _bsp(T, LocalComm())
    assert [(m.makespan, m.comm_bytes, m.comm_trips) for m in th] == \
        [(m.makespan, m.comm_bytes, m.comm_trips) for m in jh]
    assert [m.makespan for m in th] == [m.makespan for m in lh]
    for k in tsrv.params:
        assert torch.equal(tsrv.params[k], lsrv.params[k])
        np.testing.assert_allclose(tsrv.params[k].numpy(),
                                   np.asarray(jsrv.params[k]),
                                   atol=1e-5, rtol=1e-5)

"""The port's semi-sync and async round engines against the JAX package's,
window by window on the CPU under a ``TickTimer``: the configurations of
``tests/test_round_engine.py`` (deadline carry-over, quorum commits,
bounded-staleness folds, work stealing, executor failures at and across
update boundaries, the flat reference and BSP), plus one async run with a
top-k codec.

Both packages get the same numpy clients, zero params, seeds, timer and
speed model.  Selections, queues, makespans, ``failures``, ``n_clients``
and every ``extra`` key must be *exactly* equal after every window (event
order and virtual time are pure functions of the timer calls each chunk
makes); params are allclose at 1e-5 (fp32 sums in another order).
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import executor as jexec
from repro.data import make_classification_clients as jclients
from repro_torch.core import executor as texec
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
DIM, N_CLASSES = 32, 10


def _speed(kind):
    """The same speed model in each package: (JAX, port)."""
    if kind is None:
        return jexec.homogeneous, texec.homogeneous
    name, arg = kind
    return (getattr(jexec, name)(*arg), getattr(texec, name)(*arg))


def _servers(engine, opts, *, n_clients=40, per_round=10, K=4, speed=None,
             fail_at=None, warmup_rounds=1, policy="parrot",
             compressor=None, data_seed=0, dim=DIM, n_classes=N_CLASSES):
    """The same configuration built in both packages: (JAX, port)."""
    out = []
    builds = ((J, jclients, JGRAD, {"w": jnp.zeros((dim, n_classes)),
                                    "b": jnp.zeros((n_classes,))}, {}),
              (T, tclients, TGRAD, {"w": torch.zeros(dim, n_classes),
                                    "b": torch.zeros(n_classes)},
               {"device": "cpu"}))
    for (pkg, make, grad, params, dev), sp in zip(builds, _speed(speed)):
        data = make(n_clients, dim=dim, n_classes=n_classes,
                    mean_samples=30, batch_size=10, seed=data_seed)
        algo = pkg.make_algorithm("fedavg", grad, lr=0.1)
        sm = pkg.ClientStateManager(tempfile.mkdtemp())
        timer = pkg.TickTimer(1.0)
        execs = [pkg.SequentialExecutor(k, algo, state_manager=sm,
                                        speed_model=sp, timer=timer, **dev)
                 for k in range(K)]
        if fail_at is not None:
            execs[fail_at[0]].fail_at = fail_at[1]
        out.append(pkg.ParrotServer(
            params=params, algorithm=algo, executors=execs,
            data_by_client=data, clients_per_round=per_round, seed=7,
            round_engine=engine, engine_opts=dict(opts),
            warmup_rounds=warmup_rounds, scheduler_policy=policy,
            compressor=compressor, **dev))
    return out


def _record_schedules(srv):
    """Wrap the scheduler to keep every (round, tasks, queues) it hands
    out, in the order the engine asked."""
    seen = []
    inner = srv.scheduler.schedule

    def schedule(rnd, tasks, executors, **kw):
        s = inner(rnd, tasks, executors, **kw)
        seen.append((rnd, [t.client for t in tasks],
                     {k: [t.client for t in q]
                      for k, q in s.assignment.items()}))
        return s

    srv.scheduler.schedule = schedule
    return seen


def _window(m):
    return (m.round, m.makespan, m.comm_bytes, m.comm_trips, m.n_clients,
            m.n_executors, m.failures, m.extra)


def _assert_params_close(tp, jp, atol=1e-5, rtol=1e-5):
    for k in jp:
        np.testing.assert_allclose(np.asarray(tp[k]), np.asarray(jp[k]),
                                   atol=atol, rtol=rtol, err_msg=k)


def _run_pair(js, ts, windows):
    """Run both servers window by window; everything but the params must
    agree exactly after each window.  Returns the port's metrics."""
    jsel, tsel = _record_schedules(js), _record_schedules(ts)
    out = []
    for w in range(windows):
        jm, tm = js.run_round(), ts.run_round()
        assert tsel == jsel, f"window {w}: selections or queues differ"
        assert _window(tm) == _window(jm), f"window {w}"
        assert ts.virtual_now == js.virtual_now
        assert sorted(ts.executors) == sorted(js.executors)
        _assert_params_close(ts.params, js.params)
        out.append(tm)
    return out


def _eval_loss(params, data):
    tot, n = 0.0, 0
    for d in data.values():
        for b in d.batches:
            tb = {k: torch.as_tensor(v) for k, v in b.items()}
            tot += float(_tloss(params, tb)) * len(b["y"])
            n += len(b["y"])
    return tot / n


SEMI = {"deadline_frac": 0.5, "over_select": 1.5, "chunk_size": 2}
ASYNC = {"staleness_lambda": 0.5, "chunk_size": 2}


def test_semi_sync_warmup_lands_the_whole_cohort_like_jax():
    js, ts = _servers("semi-sync", SEMI)
    [m] = _run_pair(js, ts, 1)
    assert m.extra["carried_tasks"] == 0.0
    assert m.extra["landed_clients"] == m.n_clients == 15   # ceil(1.5 × 10)
    assert m.extra["deadline"] == float("inf")


def test_semi_sync_deadline_carry_matches_jax():
    js, ts = _servers("semi-sync", SEMI,
                      speed=("hetero_gpus", ({3: 18.0},)))
    ms = _run_pair(js, ts, 8)
    carried = [m.extra["carried_tasks"] for m in ms]
    assert sum(carried) > 0, carried
    r = next(i for i, c in enumerate(carried) if c > 0)
    assert ms[r + 1].n_clients == 15       # carried + fresh
    assert ms[r + 1].extra["landed_clients"] > 0


def test_semi_sync_failure_shrinks_k_like_jax():
    js, ts = _servers("semi-sync", SEMI, fail_at=(2, (1, 1)),
                      warmup_rounds=2)
    ms = _run_pair(js, ts, 4)
    assert sum(m.failures for m in ms) == 1
    assert sorted(ts.executors) == [0, 1, 3]
    assert ms[-1].n_executors == 3
    assert ms[-1].extra["landed_clients"] > 0


def test_semi_sync_quorum_commit_matches_jax():
    js, ts = _servers("semi-sync", dict(SEMI, quorum_frac=0.6),
                      speed=("hetero_gpus", ({3: 18.0},)))
    ms = _run_pair(js, ts, 6)
    commits = [m.extra.get("quorum_commits", 0.0) for m in ms]
    assert sum(commits) > 0, commits
    assert all(m.extra["carried_tasks"] >= 0 for m in ms)


def test_async_stale_folds_match_jax():
    js, ts = _servers("async", ASYNC)
    ms = _run_pair(js, ts, 8)
    assert sum(m.extra["stale_folds"] for m in ms) > 0
    assert all(m.extra["mean_staleness"] >= 0 for m in ms)


def test_async_stale_folds_of_a_topk_wire_match_jax():
    """γ-scaled compressed buffers (``scale_buffer``) fold as in JAX."""
    js, ts = _servers("async", ASYNC, compressor="topk")
    ops.reset_topk_counts()
    ms = _run_pair(js, ts, 6)
    assert sum(m.extra["stale_folds"] for m in ms) > 0
    assert ops.topk_dispatches > 0          # every chunk crossed the codec


def test_async_work_stealing_matches_jax():
    js, ts = _servers("async", ASYNC, n_clients=60,
                      speed=("hetero_gpus", ({0: 15.0},)), policy="none")
    ms = _run_pair(js, ts, 6)
    assert sum(m.extra["steals"] for m in ms) > 0


def test_async_failure_shrinks_k_like_jax():
    js, ts = _servers("async", ASYNC, fail_at=(1, (0, 1)))
    ms = _run_pair(js, ts, 5)
    assert sum(m.failures for m in ms) == 1
    assert sorted(ts.executors) == [0, 2, 3]


def test_async_failure_at_update_boundary_does_not_resurrect():
    """A failure event pending when a goal-2 window closes keeps its
    executor dead (``es.dead`` blocks the post-update re-dispatch), its
    refill tasks re-home, and the engine keeps folding."""
    js, ts = _servers("async", {"chunk_size": 2}, K=3, per_round=2,
                      fail_at=(1, (-1, 3)))
    ms = _run_pair(js, ts, 8)
    assert sum(m.failures for m in ms) == 1
    assert sorted(ts.executors) == [0, 2]
    assert ms[-1].n_clients > 0


def test_async_fail_at_index_is_cumulative_across_refills():
    js, ts = _servers("async", {"chunk_size": 2}, per_round=8,
                      fail_at=(1, (-1, 9)))
    ms = _run_pair(js, ts, 6)
    assert sum(m.failures for m in ms) == 1
    assert len(ts.executors) == 3


def test_async_tracks_the_flat_reference_like_jax():
    """20 windows land within 10 % of the 20-round flat reference's loss,
    at the JAX test's own problem (8 features, 4 classes)."""
    js, ts = _servers("async", ASYNC, n_clients=60, data_seed=3, dim=8,
                      n_classes=4)
    _run_pair(js, ts, 20)
    data = tclients(60, dim=8, n_classes=4, mean_samples=30, batch_size=10,
                    seed=3)
    zeros = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}
    flat, _ = T.run_flat_reference(
        zeros, T.make_algorithm("fedavg", TGRAD, lr=0.1), data,
        clients_per_round=10, n_rounds=20, seed=7)
    loss0 = _eval_loss(zeros, data)
    loss_flat, loss_async = _eval_loss(flat, data), _eval_loss(ts.params,
                                                                data)
    assert loss_async < loss0
    assert abs(loss_async - loss_flat) / loss_flat < 0.10


def test_async_makespan_beats_bsp_like_jax():
    """Both engines under dynamic heterogeneity: the port's makespans equal
    the JAX package's, and async hides the stragglers BSP waits for."""
    kw = dict(n_clients=80, per_round=32, warmup_rounds=2,
              speed=("dynamic_env", (4, 10)))
    means = {}
    for mode, opts in (("bsp", {}), ("async", {"chunk_size": 8})):
        js, ts = _servers(mode, opts, **kw)
        ms = _run_pair(js, ts, 10)
        means[mode] = float(np.mean([m.makespan for m in ms[3:]]))
    assert means["async"] < 0.75 * means["bsp"], means


@pytest.mark.parametrize("engine", ["semi-sync", "semi_sync", "async"])
def test_des_cohort_excludes_clients_in_flight_like_jax(engine):
    """The exclude set (a carry list, or the async in-flight set) reaches
    ``population.sample`` deduplicated and sorted, so the refill cohorts
    are the JAX package's id for id."""
    js, ts = _servers(engine, SEMI if "semi" in engine else ASYNC,
                      speed=("hetero_gpus", ({3: 18.0},)))
    seen = {"jax": [], "port": []}
    for key, srv in (("jax", js), ("port", ts)):
        inner = srv.select_clients

        def select(n=None, exclude=None, inner=inner, out=seen[key]):
            got = inner(n=n, exclude=exclude)
            out.append((sorted(exclude or ()), [t.client for t in got]))
            return got

        srv.select_clients = select
    _run_pair(js, ts, 5)
    assert seen["port"] == seen["jax"]
    assert any(ex for ex, _ in seen["port"])     # a refill excluded clients
    for ex, picked in seen["port"]:
        assert not set(ex) & set(picked)

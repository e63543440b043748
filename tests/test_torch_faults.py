"""The port's fault model (``core/faults.py``) and the engines' fault paths
against the JAX package, on the CPU under a ``TickTimer``.

Units run the same calls on both packages' injectors and compare results
exactly: ``FaultPlan.random`` event lists, the one-shot crash / restart /
corrupt lifecycle and ``state_dict``, the dropout split, blackout pauses,
``price_upload``'s timeout, backoff and give-up, and slowdown scaling.
The engine cases run a seeded chaos plan (every fault kind, a network so
the blackout and retry pricing runs) under BSP, semi-sync and async at
``quorum_frac`` 1.0 and 0.7 in both packages: selections, queues,
makespans and every ``extra`` key (``retries``, ``corrupt_payloads``,
``dropped_clients``, ``fault_crashes``, ``fault_restarts``,
``chunk_timeouts``, ``quorum_commits``, the comm keys) exactly equal window
by window, params allclose at 1e-5.  Within the port an empty plan equals
``faults=None`` bit for bit, and a restart event revives its executor.
"""
import dataclasses
import math
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.faults as JF
import repro_torch.core as T
import repro_torch.core.faults as TF
from repro.data import make_classification_clients as jclients
from repro_torch.checkpoint import params_digest
from repro_torch.data import make_classification_clients as tclients


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
DIM, N_CLASSES, N_CLIENTS = 8, 4, 30

# (JAX core, JAX faults module), (port core, port faults module)
PKGS = ((J, JF), (T, TF))


def _both(fn):
    """fn(core, faults) on each package: (JAX result, port result)."""
    return tuple(fn(c, f) for c, f in PKGS)


def _events(plan):
    return [dataclasses.astuple(e) for e in plan]


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 11, 12])
def test_random_plan_draws_the_same_events(seed):
    kw = dict(horizon=100.0, executors=[3, 0, 1, 2],
              clients=list(range(20))[::-1], crash_rate=0.05,
              restart_delay=4.0, dropout_rate=0.05, corrupt_rate=0.03,
              blackout_rate=0.02, slowdown_rate=0.02, spare=2)
    j, t = _both(lambda C, F: _events(F.FaultPlan.random(seed=seed, **kw)))
    assert t == j and t
    plan = TF.FaultPlan.random(seed=seed, **kw)
    crashed = [e.executor for e in plan.of_kind(TF.CRASH)]
    assert all(k >= 2 for k in crashed)                # the spares survive
    assert sorted(crashed) == sorted(e.executor
                                     for e in plan.of_kind(TF.RESTART))


def test_plan_validates_and_sorts_like_jax():
    for F in (JF, TF):
        with pytest.raises(ValueError):
            F.FaultEvent(time=0.0, kind="meteor")
        with pytest.raises(ValueError):
            F.FaultPlan([F.FaultEvent(time=1.0, kind=F.CRASH)])
        with pytest.raises(ValueError):
            F.FaultPlan([F.FaultEvent(time=1.0, kind=F.DROPOUT)])
    j, t = _both(lambda C, F: _events(F.FaultPlan([
        F.FaultEvent(time=5.0, kind=F.RESTART, executor=1),
        F.FaultEvent(time=1.0, kind=F.CRASH, executor=1),
        F.FaultEvent(time=1.0, kind=F.BLACKOUT, duration=2.0),
        F.FaultEvent(time=1.0, kind=F.CRASH, executor=0)])))
    assert t == j


def _lifecycle_calls(C, F):
    fi = F.FaultInjector(F.FaultPlan([
        F.FaultEvent(time=2.0, kind=F.CRASH, executor=1),
        F.FaultEvent(time=6.0, kind=F.RESTART, executor=1),
        F.FaultEvent(time=1.0, kind=F.CORRUPT, executor=0)]),
        F.RetryPolicy(max_retries=1))
    out = [fi.crash_due(1, 1.9), fi.crash_due(1, 2.5),
           fi.crash_in(1, 0.0, 5.0), fi.fire_crash(1, 2.5),
           fi.crash_due(1, 2.5), fi.fire_crash(1, 99.0),
           fi.restarts_due(5.0), fi.restarts_due(6.0), fi.restarts_due(6.0),
           fi.take_corrupt(0, 0.5), fi.take_corrupt(0, 2.0),
           fi.take_corrupt(0, 2.0), fi.charge_retry([7, 7, 8])]
    blob = pickle.loads(pickle.dumps(fi.state_dict()))
    fj = F.FaultInjector(fi.plan, fi.retry)
    fj.load_state_dict(blob)
    out += [blob, fj.take_corrupt(0, 2.0), fj.charge_retry([7])]
    fj.clear_retries([7])
    out += [fj.charge_retry([7]), fj.state_dict()]
    return out


def test_injector_one_shot_lifecycle_and_state_dict_equal_jax():
    j, t = _both(_lifecycle_calls)
    assert t == j
    assert t[3] is True and t[4] is None and t[7] == [1] and t[8] == []


def _dropout_calls(C, F):
    fi = F.FaultInjector(F.FaultPlan([
        F.FaultEvent(time=10.0, kind=F.DROPOUT, client=3, duration=5.0),
        F.FaultEvent(time=12.0, kind=F.DROPOUT, client=4, duration=1.0)]))
    tasks = [C.ClientTask(3, 10), C.ClientTask(4, 10), C.ClientTask(5, 7)]
    out = [fi.client_down(c, t) for c in (3, 4, 5)
           for t in (9.9, 10.0, 12.5, 14.9, 15.0)]
    for t0, dur in ((8.0, 1.0), (8.0, 3.0), (8.0, 4.5), (11.0, 0.0)):
        up, down = fi.split_up(tasks, t0, dur)
        out.append(([t.client for t in up], [t.client for t in down]))
    out += [fi.upload_lost([3], 9.0, 11.0), fi.upload_lost([3], 16.0, 20.0),
            fi.upload_lost([5, 4], 11.5, 12.0)]
    return out


def test_dropout_windows_and_split_equal_jax():
    j, t = _both(_dropout_calls)
    assert t == j


def _blackout_calls(C, F):
    fi = F.FaultInjector(F.FaultPlan([
        F.FaultEvent(time=4.0, kind=F.BLACKOUT, duration=2.0),
        F.FaultEvent(time=8.0, kind=F.BLACKOUT, duration=1.0, executor=1)]))
    out = [fi.xfer_end(0.0, 3.0), fi.xfer_end(0.0, 5.0),
           fi.xfer_end(4.5, 0.0), fi.xfer_end(7.5, 1.0, executor=1),
           fi.xfer_end(7.5, 1.0, executor=0), fi.xfer_end(3.0, 6.25, 1)]
    # price_upload: the link dark for 100 s -> every attempt times out
    dark = F.FaultInjector(
        F.FaultPlan([F.FaultEvent(time=0.0, kind=F.BLACKOUT,
                                  duration=100.0)]),
        F.RetryPolicy(timeout_s=2.0, max_retries=2, backoff_s=1.0,
                      backoff_mult=2.0))
    c = F.FaultCounters()
    out += [dark.price_upload(0.0, 1.0, None, [5], 10, c),
            dataclasses.astuple(c)]
    # a short blackout: the first attempt times out, the re-send (priced
    # again through the network) lands after the backoff
    short = F.FaultInjector(
        F.FaultPlan([F.FaultEvent(time=1.0, kind=F.BLACKOUT, duration=3.0)]),
        F.RetryPolicy(timeout_s=2.5, max_retries=2, backoff_s=0.5))
    net = type("NS", (), {})()
    net.net = C.NetworkModel.uniform(1_000.0, latency_s=0.1)
    net.up = lambda clients, nbytes: net.net.upload_time(clients, nbytes)
    c2 = F.FaultCounters()
    out += [short.price_upload(0.5, 1.25, net, [1, 2], 900, c2),
            dataclasses.astuple(c2),
            F.FaultInjector(F.FaultPlan(()), F.RetryPolicy(
                timeout_s=2.0)).price_upload(5.0, 1.5, None, [5], 10),
            [F.RetryPolicy(backoff_s=0.5).backoff(a) for a in range(4)]]
    return out


def test_blackout_pause_and_price_upload_retries_equal_jax():
    j, t = _both(_blackout_calls)
    assert t == j
    assert t[6] is None and t[7][5] == 3 and t[7][0] == 2  # timeouts, retries
    assert t[9][0] == 1 and t[9][5] == 1                   # one re-send


def _slowdown_calls(C, F):
    fi = F.FaultInjector(F.FaultPlan([
        F.FaultEvent(time=0.0, kind=F.SLOWDOWN, executor=0, duration=10.0,
                     factor=2.0),
        F.FaultEvent(time=5.0, kind=F.SLOWDOWN, executor=0, duration=10.0,
                     factor=3.0)]))
    m = C.WorkloadModel(t_sample=0.5, b=1.0)
    out = [fi.slowdown(0, t) for t in (2.0, 7.0, 12.0, 20.0)]
    out += [fi.slowdown(1, 7.0), dataclasses.astuple(fi.scaled_model(m, 0,
                                                                     7.0)),
            fi.scaled_model(m, 0, 50.0) is m, fi.scaled_model(None, 0, 7.0)]
    from importlib import import_module
    ex = import_module(C.__name__ + ".executor")
    wl = import_module(C.__name__ + ".workload")
    rep = ex.ExecutorReport(
        executor=0, partial=None, records=[
            wl.RunRecord(round=0, client=c, executor=0, n_samples=10,
                         time=0.75 * c) for c in (1, 2)],
        virtual_time=2.25, wall_time=0.0, n_tasks=2)
    F.scale_report(rep, fi.slowdown(0, 7.0))
    out += [rep.virtual_time, [r.time for r in rep.records]]
    return out


def test_slowdown_scaling_equals_jax():
    j, t = _both(_slowdown_calls)
    assert t == j
    assert t[1] == 6.0 and t[5] == (3.0, 6.0)


# ---------------------------------------------------------------------------
# engines under a seeded chaos plan
# ---------------------------------------------------------------------------

def _chaos(C, F):
    return F.FaultPlan.random(seed=3, horizon=80.0, executors=[0, 1, 2],
                              clients=list(range(N_CLIENTS)),
                              crash_rate=0.05, restart_delay=5.0,
                              dropout_rate=0.1, dropout_duration=4.0,
                              corrupt_rate=0.05,
                              blackout_rate=0.03, blackout_duration=1.0,
                              slowdown_rate=0.03, slowdown_duration=6.0)


def _pair(engine, opts, knobs, K=3):
    """The same server in both packages: (JAX, port); ``knobs(core,
    faults)`` builds the fault / network kwargs from each package's own
    classes."""
    out = []
    builds = ((J, JF, jclients, JGRAD, {"w": jnp.zeros((DIM, N_CLASSES)),
                                        "b": jnp.zeros((N_CLASSES,))}, {}),
              (T, TF, tclients, TGRAD, {"w": torch.zeros(DIM, N_CLASSES),
                                        "b": torch.zeros(N_CLASSES)},
               {"device": "cpu"}))
    for C, F, make, grad, params, dev in builds:
        data = make(N_CLIENTS, dim=DIM, n_classes=N_CLASSES,
                    mean_samples=30, batch_size=10, seed=1)
        algo = C.make_algorithm("fedavg", grad, lr=0.1, local_steps=2)
        sm = C.ClientStateManager(tempfile.mkdtemp())
        timer = C.TickTimer(1.0)
        execs = [C.SequentialExecutor(k, algo, state_manager=sm,
                                      timer=timer, **dev) for k in range(K)]
        out.append(C.ParrotServer(
            params=params, algorithm=algo, executors=execs,
            data_by_client=data, clients_per_round=8, seed=7,
            round_engine=engine, engine_opts=dict(opts),
            **knobs(C, F), **dev))
    return out


def _record_schedules(srv):
    seen, inner = [], srv.scheduler.schedule

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


def _run_pair(js, ts, windows):
    jsel, tsel = _record_schedules(js), _record_schedules(ts)
    for w in range(windows):
        jm, tm = js.run_round(), ts.run_round()
        assert tsel == jsel, f"window {w}: selections or queues differ"
        assert _window(tm) == _window(jm), f"window {w}"
        assert ts.virtual_now == js.virtual_now
        assert sorted(ts.executors) == sorted(js.executors)
        assert ts.faults.state_dict() == js.faults.state_dict()
        for k in js.params:
            np.testing.assert_allclose(np.asarray(ts.params[k]),
                                       np.asarray(js.params[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    return ts.history


def _chaos_knobs(C, F):
    return {"faults": _chaos(C, F),
            "retry": F.RetryPolicy(timeout_s=3.0, max_retries=2,
                                   backoff_s=0.5),
            "network": C.NetworkModel.uniform(8e6, 16e6, latency_s=0.05)}


def _tot(hist, key):
    return sum(m.extra.get(key, 0.0) for m in hist)


CHAOS_WINDOWS = {"bsp": 10, "semi-sync": 10, "async": 12}


@pytest.mark.parametrize("engine,quorum", [
    ("bsp", 1.0), ("bsp", 0.7), ("semi-sync", 1.0), ("semi-sync", 0.7),
    ("async", None)])
def test_seeded_chaos_windows_equal_jax(engine, quorum):
    """``quorum`` None: the async engine, which has no quorum."""
    opts = {} if engine == "bsp" else {"chunk_size": 2}
    if quorum is not None:
        opts["quorum_frac"] = quorum
    hist = _run_pair(*_pair(engine, opts, _chaos_knobs),
                     CHAOS_WINDOWS[engine])
    for m in hist:                       # the unified fault schema
        assert {"retries", "corrupt_payloads", "dropped_clients"} \
            <= set(m.extra)
    assert _tot(hist, "fault_crashes") >= 1
    assert _tot(hist, "corrupt_payloads") >= 1
    assert _tot(hist, "retries") >= 1


def test_chunk_timeout_retries_then_drops_like_jax():
    def knobs(C, F):
        return {"faults": F.FaultPlan([F.FaultEvent(
                    time=0.0, kind=F.BLACKOUT, duration=500.0)]),
                "retry": F.RetryPolicy(timeout_s=1.0, max_retries=2,
                                       backoff_s=0.5),
                "network": C.NetworkModel.uniform(8e6, 16e6,
                                                  latency_s=0.05)}

    hist = _run_pair(*_pair("bsp", {}, knobs), 2)
    assert _tot(hist, "chunk_timeouts") >= 3
    assert _tot(hist, "retries") >= 2
    assert _tot(hist, "dropped_clients") >= 1


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["bsp", "semi-sync", "async"])
def test_empty_plan_equals_no_plan(engine):
    """An empty plan (the injector consulted, nothing scheduled) leaves
    params and makespans identical to faults=None."""
    opts = {} if engine == "bsp" else {"chunk_size": 2}
    a = _pair(engine, opts, lambda C, F: {})[1]
    b = _pair(engine, opts, lambda C, F: {
        "faults": F.FaultPlan(()),
        "retry": F.RetryPolicy(timeout_s=math.inf)})[1]
    a.run(5)
    b.run(5)
    assert params_digest(a.params) == params_digest(b.params)
    assert [m.makespan for m in a.history] == \
        [m.makespan for m in b.history]
    assert [m.n_clients for m in a.history] == \
        [m.n_clients for m in b.history]


@pytest.mark.parametrize("engine", ["bsp", "semi-sync", "async"])
def test_restart_event_revives_the_crashed_executor(engine):
    """A crash retires executor 2; its paired restart reaches
    ``_revive_executor`` and the executor schedules again."""
    opts = {} if engine == "bsp" else {"chunk_size": 2}

    def knobs(C, F):
        return {"faults": F.FaultPlan([
            F.FaultEvent(time=0.5, kind=F.CRASH, executor=2),
            F.FaultEvent(time=6.0, kind=F.RESTART, executor=2)])}

    srv = _pair(engine, opts, knobs)[1]
    revived, inner = [], srv._revive_executor

    def revive(k):
        ok = inner(k)
        revived.append((k, ok))
        return ok

    srv._revive_executor = revive
    srv.run(6)
    assert (2, True) in revived
    assert _tot(srv.history, "fault_crashes") == 1
    assert _tot(srv.history, "fault_restarts") == 1
    assert sorted(srv.executors) == [0, 1, 2]

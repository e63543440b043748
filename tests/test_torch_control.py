"""The port's adaptive control plane (``repro_torch.core.control``) and the
engine branches it steers, against the JAX package on the CPU under a
``TickTimer``.

Units run the same calls on both packages' controllers, oracle and queue
rebalance and compare the results exactly (host floats in the same
expression order).  The engine cases give both packages the same numpy
clients, zero params, seeds, links and fault plans and compare every
window: selections and queues, makespans, ``virtual_now`` and every
``extra`` key (``oracle_makespan``, ``rebalanced_tasks``,
``deadline_frac``, ``staleness_lambda``, ``utilization``, ...) exactly,
params within 1e-5.  Within the port, ``ControlPlane.observer()`` equals
``control=None`` bit for bit, and a run killed mid-round under adaptive
control, telemetry, a network and a chaos plan resumes bit for bit.  The
DES engines' gang wave is held against the JAX package's 4-device gang,
run in a child process with four forced host devices — this file itself,
as ``python tests/test_torch_control.py --jax-child OUT.npz``.
"""
import json
import math
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import repro_torch.core as T                                  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,        # noqa: E402
                                    params_digest)
from repro_torch.data import make_classification_clients as tclients  # noqa

DIM, N_CLASSES, N_CLIENTS = 8, 4, 40
CPU = torch.device("cpu")


def _tloss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


TGRAD = T.value_and_grad(_tloss)


def _jax():
    """The JAX package's core, client maker, grad and zero params (imported
    on first use: the ``--jax-child`` process sets its device count before
    JAX starts)."""
    import jax
    import jax.numpy as jnp
    import repro.core as J
    from repro.data import make_classification_clients as jclients

    def loss(params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(
            logits, batch["y"][:, None].astype(jnp.int32), axis=-1)[:, 0]
        return jnp.mean(lse - gold)

    return (J, jclients, jax.jit(jax.value_and_grad(loss)),
            {"w": jnp.zeros((DIM, N_CLASSES)), "b": jnp.zeros((N_CLASSES,))})


def _port():
    return (T, tclients, TGRAD, {"w": torch.zeros(DIM, N_CLASSES),
                                 "b": torch.zeros(N_CLASSES)})


def build(pkg, engine, opts, knobs, *, n_clients=N_CLIENTS, per_round=10,
          K=4, local_steps=1, shared_timer=True, ckpt=None, devices=None,
          **server_kw):
    """One server of package ``pkg`` (``_jax()`` or ``_port()``):
    ``knobs(core)`` builds the control / telemetry / network / fault
    kwargs from that package's own classes.  ``devices``: pin executor k
    to ``devices[k]`` under a placement (the gang's configuration; the
    port's placement pins all four to the one CPU device)."""
    C, make, grad, params = pkg
    is_port = C is T
    data = make(n_clients, dim=DIM, n_classes=N_CLASSES, mean_samples=30,
                batch_size=10, seed=1)
    algo = C.make_algorithm("fedavg", grad, lr=0.1, local_steps=local_steps)
    sm = C.ClientStateManager(tempfile.mkdtemp(prefix="tctrl_"))
    dev = {"device": "cpu"} if is_port else {}
    timer = C.TickTimer(1.0)
    execs = []
    for k in range(K):
        kw = dict(dev)
        if devices is not None and not is_port:
            kw["device"] = devices[k]
        execs.append(C.SequentialExecutor(
            k, algo, state_manager=sm,
            timer=timer if shared_timer else C.TickTimer(1.0), **kw))
    if devices is not None:
        server_kw["placement"] = (
            C.DevicePlacement(range(K), devices=["cpu"]) if is_port
            else C.DevicePlacement(range(K)))
    if ckpt is not None:
        ck = (CheckpointManager if is_port else
              __import__("repro.checkpoint.manager",
                         fromlist=["x"]).CheckpointManager)
        server_kw["checkpoint_manager"] = ck(ckpt, every_rounds=1, keep=10)
    return C.ParrotServer(
        params=params, algorithm=algo, executors=execs, data_by_client=data,
        clients_per_round=per_round, seed=7, round_engine=engine,
        engine_opts=dict(opts or {}), **knobs(C), **server_kw, **dev)


def pair(engine, opts, knobs, **kw):
    """The same server in both packages: (JAX, port)."""
    return build(_jax(), engine, opts, knobs, **kw), \
        build(_port(), engine, opts, knobs, **kw)


def record_schedules(srv):
    seen, inner = [], srv.scheduler.schedule

    def schedule(rnd, tasks, executors, **kw):
        s = inner(rnd, tasks, executors, **kw)
        seen.append((rnd, [int(t.client) for t in tasks],
                     {int(k): [int(t.client) for t in q]
                      for k, q in s.assignment.items()}))
        return s

    srv.scheduler.schedule = schedule
    return seen


def window(m):
    return (m.round, m.makespan, m.comm_bytes, m.comm_trips, m.n_clients,
            m.n_executors, m.failures, m.extra)


def trajectory(history):
    return [(m.extra.get("staleness_lambda"), m.extra.get("deadline_frac"))
            for m in history]


def no_host(reg):
    return reg.snapshot(exclude=("host/",))


def run_pair(js, ts, windows):
    """Both servers window by window: everything but the params exactly
    equal after each window, params within 1e-5; then the traces and
    registries (without ``host/``) when telemetry is on."""
    jsel, tsel = record_schedules(js), record_schedules(ts)
    out = []
    for w in range(windows):
        jm, tm = js.run_round(), ts.run_round()
        assert tsel == jsel, f"window {w}: selections or queues differ"
        assert window(tm) == window(jm), f"window {w}"
        assert ts.virtual_now == js.virtual_now
        assert sorted(ts.executors) == sorted(js.executors)
        for k in js.params:
            np.testing.assert_allclose(np.asarray(ts.params[k]),
                                       np.asarray(js.params[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
        out.append(tm)
    if ts.telemetry is not None:
        assert ts.telemetry.tracer.spans == js.telemetry.tracer.spans
        assert ts.telemetry.tracer.instants == js.telemetry.tracer.instants
        assert no_host(ts.telemetry.registry) == \
            no_host(js.telemetry.registry)
    return out


ENGINES = [("bsp", None),
           ("semi-sync", {"chunk_size": 2, "deadline_frac": 0.7}),
           ("async", {"chunk_size": 2})]
IDS = ["bsp", "semi-sync", "async"]


# ---------------------------------------------------------------------------
# controller units: the same calls on both packages' objects
# ---------------------------------------------------------------------------

def _both(fn):
    return fn(_jax()[0]), fn(T)


def _lambda_calls(C):
    out = []
    for kw in ({}, {"target_gamma": 0.8, "alpha": 0.5},
               {"lam_min": 0.05, "lam_max": 4.0}):
        c = C.AsyncLambdaController(**kw)
        out.append(c.current(1.23))
        for s in (2.0, 0.0, 0.37, 1e9, 3.5, 0.0):
            out.append((c.update(s), c.current(0.0), c.state_dict()))
    return out


def _deadline_calls(C):
    out = []
    for kw in ({"target_ratio": 0.5, "gain": 0.6, "alpha": 1.0},
               {"target_ratio": None, "alpha": 1.0}, {}):
        c = C.DeadlineController(**kw)
        out.append(c.current(0.8))
        for landed, sel in ((10, 10), (0, 10), (5, 10), (7, 12), (0, 0),
                            *[(10, 10)] * 50):
            out.append((c.update(landed, sel, 0.8, 0.5), c.state_dict()))
    return out


@pytest.mark.parametrize("calls", [_lambda_calls, _deadline_calls],
                         ids=["async_lambda", "deadline"])
def test_controller_trajectories_equal_jax(calls):
    j, t = _both(calls)
    assert t == j


def test_controller_clips_and_refusals_like_jax():
    for C in (_jax()[0], T):
        assert C.AsyncLambdaController().update(1e9) == 0.05
        assert C.AsyncLambdaController().update(0.0) == 4.0
        for g in (0.0, 1.0):
            with pytest.raises(ValueError):
                C.AsyncLambdaController(target_gamma=g)
        d = C.DeadlineController(target_ratio=0.5, alpha=1.0)
        for _ in range(50):
            v = d.update(10, 10, 0.8, 0.5)
        assert v == pytest.approx(d.frac_min)


def test_control_plane_levers_and_state_equal_jax():
    def calls(C):
        cp = C.ControlPlane.adaptive()
        cp.async_lambda.update(2.0)
        cp.deadline.update(6, 10, 0.8, 0.5)
        fresh = C.ControlPlane.adaptive(target_gamma=0.7, window_fit=False)
        fresh.load_state_dict(cp.state_dict())
        obs = C.ControlPlane.observer()
        obs.load_state_dict(cp.state_dict())
        fresh.load_state_dict(None)
        return [(p.window_fit, p.overlap_comm, p.gang_waves, p.rebalance,
                 p.state_dict(), p.telemetry)
                for p in (cp, fresh, obs, C.ControlPlane())]

    j, t = _both(calls)
    assert t == j
    assert t[2][4] == {"async_lambda": None, "deadline": None}
    # a controller state the JAX package wrote loads into the port's
    cp = _jax()[0].ControlPlane.adaptive()
    cp.async_lambda.update(0.25)
    tp = T.ControlPlane.adaptive()
    tp.load_state_dict(cp.state_dict())
    assert tp.state_dict() == cp.state_dict()


# oracle and queue-rebalance cases of tests/test_control.py that
# tests/test_torch_scheduler.py does not hold
ORACLE_CASES = {
    "empty": ([], [0, 1]),
    "no_executors": ([(10.0, 5.0, 0, 0.0)], []),
    "single": ([(10.0, 5.0, 0, 2.5)], [0]),
    "rates": ([(10.0, 10.0, 0, 0.0), (10.0, 20.0, 1, 0.0)], [0, 1]),
    "serial_pile": ([(10.0, 10.0, 0, 0.0)] * 4, [0, 1]),
    "fleet_fallback": ([(10.0, 10.0, 0, 0.0)] * 2, [0, 1]),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracle_edge_cases_equal_jax(case):
    jobs, execs = ORACLE_CASES[case]
    j, t = _both(lambda C: C.oracle_makespan(jobs, execs))
    assert t == j


def _rebalance_calls(C):
    from importlib import import_module
    wl = import_module(C.__name__ + ".workload")
    mk = C.ClientTask
    tasks = [mk(c, 10 + (c % 3)) for c in range(6)]
    unit = {0: wl.WorkloadModel(1.0, 0.0), 1: wl.WorkloadModel(1.0, 0.0)}
    fast = {0: wl.WorkloadModel(1.0, 0.0), 1: wl.WorkloadModel(0.1, 0.0)}
    out = []
    for queues, hz, models, cost in (
            ({0: list(tasks), 1: []}, {0: 0.0, 1: 0.0}, unit, None),
            ({0: list(tasks), 1: []}, {0: 0.0, 1: 1e6}, unit, None),
            ({0: list(tasks), 1: []}, {0: 0.0, 1: 0.0}, fast, None),
            ({0: tasks[:3], 1: tasks[3:]}, {0: 2.0, 1: 0.0}, fast,
             lambda t: 100.0)):
        a, moved = C.rebalance_queues(queues, hz, models, cost)
        out.append(({k: [t.client for t in q] for k, q in a.items()},
                    moved))
        pl = C.DevicePlacement([0, 1], devices=["cpu"]) if C is T else \
            C.DevicePlacement([0, 1])
        a2, m2 = pl.rebalance(queues, hz, models, cost)
        out.append(({k: [t.client for t in q] for k, q in a2.items()}, m2))
    return out


def test_rebalance_and_placement_rebalance_equal_jax():
    j, t = _both(_rebalance_calls)
    assert t == j
    assert t[0][1] == 3 and t[2][1] == 0


# ---------------------------------------------------------------------------
# window-fit selection
# ---------------------------------------------------------------------------

_SHORT = {c: ([(0.0, 5.0)] if c < 10 else [(0.0, 1e9)]) for c in range(20)}


@pytest.mark.parametrize("lever", ["window_fit", "observer"])
@pytest.mark.parametrize("net", [False, True], ids=["no_net", "uniform"])
def test_window_fit_selection_equals_jax(lever, net):
    """One fitted model: the fleet average prices each client's span (+
    its comm round-trip under a network) against its remaining window; the
    lever drops the short-window clients, the observer does not."""
    def knobs(C):
        kw = {"availability": C.ClientAvailability(_SHORT, period=None),
              "control": (C.ControlPlane(window_fit=True)
                          if lever == "window_fit"
                          else C.ControlPlane.observer())}
        if net:
            kw["network"] = C.NetworkModel.uniform(1e6, 1e6, 0.01)
        return kw

    picks = []
    for srv in pair("bsp", None, knobs, n_clients=20, per_round=12):
        wl = __import__(type(srv).__module__.replace(".round", ".workload"),
                        fromlist=["x"])
        srv.estimator.last_fit = {0: wl.WorkloadModel(t_sample=1.0, b=0.0)}
        srv.virtual_now = 4.0
        srv._last_payload_nbytes = 1000
        picks.append([t.client for t in srv.select_clients()])
    assert picks[1] == picks[0]
    if lever == "window_fit":
        assert picks[1] and all(c >= 10 for c in picks[1])
    else:
        assert any(c < 10 for c in picks[1])


def test_window_fit_inert_before_first_fit():
    def knobs(C, fit):
        return {"availability": C.ClientAvailability(
                    {c: [(0.0, 5.0)] for c in range(20)}, period=None),
                "control": C.ControlPlane(window_fit=True) if fit else None}

    a = build(_port(), "bsp", None, lambda C: knobs(C, True), n_clients=20)
    b = build(_port(), "bsp", None, lambda C: knobs(C, False), n_clients=20)
    j = build(_jax(), "bsp", None, lambda C: knobs(C, True), n_clients=20)
    got = [[t.client for t in s.select_clients()] for s in (a, b, j)]
    assert got[0] == got[1] == got[2]


# ---------------------------------------------------------------------------
# observer ≡ None; the controllers against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_observer_is_bit_identical_to_none(engine, opts):
    a = build(_port(), engine, opts, lambda C: {})
    b = build(_port(), engine, opts,
              lambda C: {"control": C.ControlPlane.observer()})
    ha = [a.run_round() for _ in range(4)]
    hb = [b.run_round() for _ in range(4)]
    assert params_digest(a.params) == params_digest(b.params)
    assert [m.makespan for m in ha] == [m.makespan for m in hb]
    assert all("oracle_makespan" not in m.extra for m in ha)
    assert all(m.extra["oracle_makespan"] > 0.0 for m in hb)
    if engine == "semi-sync":
        assert all(m.extra["deadline_frac"] == 0.7 for m in hb)
    if engine == "async":
        assert all(m.extra["staleness_lambda"] == 0.5 for m in hb)


@pytest.mark.parametrize("engine,ctrl", [
    ("semi-sync", lambda C: C.ControlPlane(deadline=C.DeadlineController(
        target_ratio=0.5, alpha=1.0))),
    ("async", lambda C: C.ControlPlane(
        async_lambda=C.AsyncLambdaController(target_gamma=0.6)))],
    ids=["deadline", "async_lambda"])
def test_controllers_move_like_jax(engine, ctrl):
    """The deadline fraction and λ follow their controllers window by
    window exactly as in JAX: the fallback first, warmup rounds skipped,
    then the controller's trajectory."""
    opts = {"chunk_size": 2, "deadline_frac": 0.9} if engine == "semi-sync" \
        else {"chunk_size": 2, "staleness_lambda": 0.5}
    ms = run_pair(*pair(engine, opts, lambda C: {"control": ctrl(C)}), 4)
    traj = [t for pair_ in trajectory(ms) for t in pair_ if t is not None]
    assert traj[0] == (0.9 if engine == "semi-sync" else 0.5)
    assert len(set(traj)) > 1


_NET = {c: (100.0, 50.0, 0.2) for c in range(N_CLIENTS)}


@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_overlap_comm_equals_jax_and_prices_only(engine, opts):
    """Downloads overlapped with earlier compute: window by window equal to
    JAX; within the port the params equal the observer's bit for bit and
    the makespans never grow."""
    def knobs(lever):
        return lambda C: {
            "network": C.NetworkModel(
                {c: C.LinkProfile(*v) for c, v in _NET.items()}),
            "control": (C.ControlPlane(overlap_comm=True) if lever
                        else C.ControlPlane.observer())}

    hb = run_pair(*pair(engine, opts, knobs(True)), 4)
    a = build(_port(), engine, opts, knobs(False))
    ha = [a.run_round() for _ in range(4)]
    b = build(_port(), engine, opts, knobs(True))
    for _ in range(4):
        b.run_round()
    assert params_digest(a.params) == params_digest(b.params)
    assert sum(m.makespan for m in hb) <= sum(m.makespan for m in ha) + 1e-9


def test_bsp_overlap_span_hides_a_slow_downlink_like_jax():
    def calls(C):
        from importlib import import_module
        eng = import_module(C.__name__ + ".engine")
        net = C.NetworkModel({0: C.LinkProfile(1e6, 1e6, 0.0),
                              1: C.LinkProfile(1e6, 100.0, 0.0)})
        srv = type("S", (), {"network": net, "availability": None,
                             "_last_payload_nbytes": 150,
                             "_wire_ratio": 1.0})()
        rep = eng.ExecutorReport(
            executor=0, partial={},
            records=[eng.RunRecord(0, 0, 0, 30, 2.0),
                     eng.RunRecord(0, 1, 0, 30, 2.0)],
            virtual_time=4.0, wall_time=0.0, n_tasks=2,
            completed_clients=[0, 1])
        sim, sim2 = eng._NetSim(srv, 0.0), eng._NetSim(srv, 0.0)
        overlap = eng.BSPEngine._overlap_span(sim, [rep])
        serial = (sim2.down(rep.completed_clients) + rep.virtual_time
                  + sim2.up(rep.completed_clients, rep.wire_bytes))
        return overlap, serial, sim.time_down, sim2.time_down

    j, t = _both(calls)
    assert t == j
    assert t[0] < t[1] and t[0] == pytest.approx(150.0 / 1e6 + 4.0)
    assert t[2] == t[3]


# ---------------------------------------------------------------------------
# adaptive control under a network and a chaos plan
# ---------------------------------------------------------------------------

def chaos_knobs(control=True, telemetry=True, net=True):
    def knobs(C):
        kw = {"faults": C.FaultPlan.random(
                  seed=3, horizon=80.0, executors=[0, 1, 2],
                  clients=list(range(30)), crash_rate=0.05,
                  restart_delay=5.0, dropout_rate=0.1,
                  dropout_duration=4.0, corrupt_rate=0.05,
                  slowdown_rate=0.03, slowdown_duration=6.0),
              "retry": C.RetryPolicy(max_retries=2, timeout_s=4.0)}
        if control:
            kw["control"] = C.ControlPlane.adaptive()
        if telemetry:
            kw["telemetry"] = True
        if net:
            kw["network"] = C.NetworkModel.uniform(2_000.0, 8_000.0,
                                                   latency_s=0.05)
        return kw
    return knobs


CHAOS = dict(n_clients=30, per_round=8, K=3, local_steps=2,
             shared_timer=False)


def chaos_opts(engine):
    return {"chunk_size": 2} if engine != "bsp" else None


@pytest.mark.parametrize("engine", IDS)
def test_adaptive_under_chaos_equals_jax(engine):
    """Adaptive control, telemetry, a uniform link and the seeded chaos
    plan of tests/test_control.py: every window, trace and registry equal
    to JAX's."""
    ms = run_pair(*pair(engine, chaos_opts(engine), chaos_knobs(), **CHAOS),
                  6)
    assert any(m.failures or m.extra.get("retries") for m in ms)


_KILL_AFTER = {"bsp": 4, "semi-sync": 10, "async": 9}


def kill_and_resume(engine, tmp_path, knobs, n=8):
    """An uninterrupted ``n``-round reference, the same server killed in
    mid-round by a ``run_queue`` that raises ``KeyboardInterrupt``, and a
    fresh server's ``run(n, auto_resume=True)``: (reference, resumed)."""
    opts = chaos_opts(engine)
    ref = build(_port(), engine, opts, knobs, ckpt=str(tmp_path / "ref"),
                **CHAOS)
    ref.run(n)
    d = str(tmp_path / "ck")
    victim = build(_port(), engine, opts, knobs, ckpt=d, **CHAOS)
    ex0 = victim.executors[0]
    real, calls = ex0.run_queue, [0]

    def dying(*a, **kw):
        calls[0] += 1
        if calls[0] >= _KILL_AFTER[engine]:
            raise KeyboardInterrupt
        return real(*a, **kw)

    ex0.run_queue = dying
    with pytest.raises(KeyboardInterrupt):
        victim.run(n)
    assert 1 <= victim.round < n
    resumed = build(_port(), engine, opts, knobs, ckpt=d, **CHAOS)
    resumed.run(n, auto_resume=True)
    assert resumed.round == n
    return ref, resumed


@pytest.mark.parametrize("engine", IDS)
def test_adaptive_kill_then_auto_resume_is_bit_exact(engine, tmp_path):
    """Under adaptive control, telemetry, a network and the chaos plan: the
    controller trajectories, makespans, ``params_digest``, trace and
    registry (without ``host/``) of the resumed run equal the
    uninterrupted run's."""
    ref, res = kill_and_resume(engine, tmp_path, chaos_knobs())
    assert params_digest(res.params) == params_digest(ref.params)
    assert trajectory(res.history) == trajectory(ref.history)
    assert [m.makespan for m in res.history] == \
        [m.makespan for m in ref.history]
    assert res.control.state_dict() == ref.control.state_dict()
    assert res.telemetry.tracer.state_dict() == \
        ref.telemetry.tracer.state_dict()
    got, want = no_host(res.telemetry.registry), \
        no_host(ref.telemetry.registry)
    if engine == "async":
        # the async engine's known gap: the first resumed window's
        # comm_bytes omits the round-end broadcast sent before the save
        for d_ in (got["counters"], want["counters"]):
            d_.pop("total/comm_bytes", None)
    assert got == want


# ---------------------------------------------------------------------------
# the DES engines' gang wave against JAX's 4-device gang
# ---------------------------------------------------------------------------

GANG_ENGINES = {"semi-sync": {"chunk_size": 2, "over_select": 1.5,
                              "deadline_frac": 0.7},
                "async": {"chunk_size": 2}}
GANG_LEVERS = {"gang": lambda C: C.ControlPlane(gang_waves=True),
               "adaptive": lambda C: C.ControlPlane.adaptive()}
GANG_ROUNDS = 4


def gang_data(n=24, samples=20, batch=10, seed=0):
    """Equal-size clients: every executor's head chunk plans into the same
    block signature, so a wave gangs."""
    rng = np.random.default_rng(seed)
    out = {}
    for c in range(n):
        xs = rng.normal(size=(samples, DIM)).astype(np.float32)
        ys = rng.integers(0, N_CLASSES, size=samples).astype(np.int32)
        out[c] = [{"x": xs[i:i + batch], "y": ys[i:i + batch]}
                  for i in range(0, samples, batch)]
    return out


def gang_server(pkg, engine, lever, devices):
    C, _, grad, params = pkg

    def make(n, **_):
        return {c: C.ClientData(batches=b, n_samples=20)
                for c, b in gang_data(n).items()}

    return build((C, make, grad, params), engine, GANG_ENGINES[engine],
                 lambda C_: {"control": GANG_LEVERS[lever](C_)},
                 n_clients=24, per_round=8, devices=devices)


def dispatch_log(srv, gang_mod):
    """Spy on every chunk dispatch of ``srv``: a gang wave (round, lanes,
    head lengths, timer calls, client-step dispatches) or a serial
    ``run_queue`` (executor, round, clients, timer calls, dispatches).
    ``gang_mod`` is the module whose ``run_queues_ganged`` the engine
    calls.  Dispatches are summed over the algorithm's engines (one a
    device)."""
    log, timer = [], srv.executors[0].timer

    def dispatches():
        engines = getattr(srv.algorithm, "_step_engines", {})
        return sum(e.n_dispatches for e in engines.values())

    inner = gang_mod.run_queues_ganged

    def gang(executors, rnd, queues, *a, **kw):
        t0, d0 = timer.now, dispatches()
        out = inner(executors, rnd, queues, *a, **kw)
        log.append(["gang", int(rnd), sorted(int(k) for k in queues),
                    [len(q) for _, q in sorted(queues.items())],
                    out is not None, timer.now - t0, dispatches() - d0])
        return out

    gang_mod.run_queues_ganged = gang
    for ex in srv.executors.values():
        def run_queue(rnd, tasks, *a, _inner=ex.run_queue, _k=ex.id, **kw):
            t0, d0 = timer.now, dispatches()
            out = _inner(rnd, tasks, *a, **kw)
            log.append(["serial", int(_k), int(rnd),
                        [int(t.client) for t in tasks], timer.now - t0,
                        dispatches() - d0])
            return out
        ex.run_queue = run_queue
    return log, lambda: setattr(gang_mod, "run_queues_ganged", inner)


def _jax_child(out_path):
    """The JAX side: 4 host devices, one executor each, the DES engines
    under ``gang_waves``; writes schedules, makespans, every extra, the
    dispatch log, timer calls and params of every (engine, lever) cell."""
    import jax
    import repro.core.executor as jex
    pkg = _jax()
    assert len(jax.devices()) == 4, jax.devices()
    meta, arrays = {}, {}
    for engine in GANG_ENGINES:
        for lever in GANG_LEVERS:
            srv = gang_server(pkg, engine, lever, jax.devices())
            sched = record_schedules(srv)
            log, undo = dispatch_log(srv, jex)
            hist = [srv.run_round() for _ in range(GANG_ROUNDS)]
            undo()
            key = f"{engine}/{lever}"
            meta[key] = {"schedules": sched,
                         "makespans": [m.makespan for m in hist],
                         "extra": [dict(m.extra) for m in hist],
                         "log": log,
                         "timer_calls": srv.executors[0].timer.now}
            for p, v in srv.params.items():
                arrays[f"{key}/{p}"] = np.asarray(v)
    np.savez(out_path, meta=json.dumps(meta), **arrays)


@pytest.fixture(scope="module")
def jax_gang(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_des_gang") / "gang.npz")
    env = dict(os.environ)
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   env.get("XLA_FLAGS", ""))
    env["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4"
                        ).strip()
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--jax-child", out], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    z = np.load(out)
    return json.loads(str(z["meta"])), {k: z[k] for k in z.files
                                        if k != "meta"}


def _json(x):
    """``x`` as the child's JSON carries it (tuples become lists, int keys
    strings)."""
    return json.loads(json.dumps(x))


def net_of_reruns(log):
    """Each logged dispatch with its first-seen re-runs taken out: a serial
    chunk here is one block, so every dispatch past the first is a re-run
    of a first-seen shape, two timer calls each."""
    out = []
    for e in log:
        if e[0] == "serial":
            reruns = e[5] - 1
            out.append(e[:4] + [e[4] - 2 * reruns])
        else:
            out.append(list(e))
    return out


@pytest.mark.parametrize("lever", sorted(GANG_LEVERS))
@pytest.mark.parametrize("engine", sorted(GANG_ENGINES))
def test_des_gang_wave_matches_jax_four_device_gang(jax_gang, engine,
                                                    lever):
    """The port's ganged DES waves (one CPU device, four executors, one
    vmap a wave) equal the JAX package's 4-device gang: schedules,
    makespans and every extra key exactly; each gang wave's lanes, timer
    calls and client-step dispatches (its first-seen re-run included)
    exactly; params within 1e-5.  The serial chunks between waves make the
    same timer calls once the first-seen re-runs are taken out: JAX
    compiles a shape once on each of its four devices, the port's one
    device once for all four executors (ROADMAP faults item 2)."""
    meta, arrays = jax_gang
    ref = meta[f"{engine}/{lever}"]
    srv = gang_server(_port(), engine, lever, [CPU] * 4)
    sched = record_schedules(srv)
    import repro_torch.core.engine as tengine
    log, undo = dispatch_log(srv, tengine)
    try:
        hist = [srv.run_round() for _ in range(GANG_ROUNDS)]
    finally:
        undo()
    assert _json(sched) == ref["schedules"]
    assert [m.makespan for m in hist] == ref["makespans"]
    assert _json([dict(m.extra) for m in hist]) == ref["extra"]
    log = _json(log)
    waves = [e for e in log if e[0] == "gang"]
    assert waves == [e for e in ref["log"] if e[0] == "gang"]
    assert waves and all(w[4] for w in waves)
    assert net_of_reruns(log) == net_of_reruns(ref["log"])
    reruns = [sum(e[5] - 1 for e in lg if e[0] == "serial")
              for lg in (log, ref["log"])]
    assert srv.executors[0].timer.now == \
        ref["timer_calls"] - 2 * (reruns[1] - reruns[0])
    for p, v in srv.params.items():
        np.testing.assert_allclose(v.numpy(), arrays[f"{engine}/{lever}/{p}"],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("engine", sorted(GANG_ENGINES))
def test_des_gang_wave_equals_serial_and_fires(engine):
    """Within the port on the CPU the ganged waves equal the serial
    dispatch bit for bit, makespans equal, and the first wave of every
    window is one client-step dispatch (plus the first-seen re-run)."""
    gang = gang_server(_port(), engine, "gang", [CPU] * 4)
    serial = gang_server(_port(), engine, "gang", [CPU] * 4)
    serial.gang_dispatch = False
    calls = []
    inner = T.ClientStepEngine.run_blocks_ganged

    def spy(self, *a, **kw):
        calls.append(len(a[1]))
        return inner(self, *a, **kw)

    T.ClientStepEngine.run_blocks_ganged = spy
    try:
        hg = [gang.run_round() for _ in range(GANG_ROUNDS)]
    finally:
        T.ClientStepEngine.run_blocks_ganged = inner
    hs = [serial.run_round() for _ in range(GANG_ROUNDS)]
    assert [m.makespan for m in hg] == [m.makespan for m in hs]
    for p in gang.params:
        assert torch.equal(gang.params[p], serial.params[p]), p
    # the first wave gangs all four lanes; a later async wave gangs the
    # lanes idle at the commit (two or more)
    assert calls and calls[0] == 4 and all(n >= 2 for n in calls)
    assert not math.isnan(hg[-1].extra["oracle_makespan"])


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-child":
        _jax_child(sys.argv[2])
    else:
        sys.exit("usage: test_torch_control.py --jax-child OUT.npz")

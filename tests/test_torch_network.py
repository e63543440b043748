"""The port's network and availability model (``core/network.py``,
``data/traces.py``) and the engines' comm-priced paths against the JAX
package, on the CPU under a ``TickTimer``.

Units run the same calls on both packages' objects and compare the results
exactly (the pricing is host float math in the same expression order).
The engine cases give both packages the same numpy clients, zero params,
seeds and links, then compare every window: selections and queues,
makespans, ``virtual_now`` and every ``extra`` key (``comm_time_up``,
``comm_time_down``, ``comm_wire_bytes``, ``dropped_clients``, ...) exactly;
params allclose at 1e-5 (a ``chunk_arrived`` fold lands in the same order,
but fp32 sums differ by package).  Within the port, a free network and an
always-available model equal the knob-less run bit for bit, and a run
checkpointed under a network resumes bit for bit.
"""
import dataclasses
import math
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.data.traces as JD
import repro_torch.core as T
import repro_torch.data.traces as TD
from repro.data import make_classification_clients as jclients
from repro_torch.checkpoint import CheckpointManager, params_digest
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
DIM, N_CLASSES, N_CLIENTS = 8, 4, 40

# (JAX core, JAX traces), (port core, port traces)
PKGS = ((J, JD), (T, TD))


# ---------------------------------------------------------------------------
# units: the same calls on both packages' objects
# ---------------------------------------------------------------------------

def _both(fn):
    """fn(core, traces) on each package: (JAX result, port result)."""
    return tuple(fn(c, d) for c, d in PKGS)


def _link_calls(C, _D):
    net = C.NetworkModel({0: C.LinkProfile(100.0, 1000.0, 0.5),
                          1: C.LinkProfile(50.0, 2000.0, 0.1),
                          2: C.LinkProfile(0.0, 3e5, 0.0)})
    out = [net.upload_time([0], 1000), net.upload_time([0, 1], 1000),
           net.download_time([0, 1], 1000), net.upload_time([99], 10**9),
           net.upload_time([], 1000), net.upload_time([0], 0),
           net.upload_time([2], 7), net.client_comm_time(1, 2000, 50),
           net.chunk_comm_time([0, 1, 99], 1320, 357)]
    s = net.scaled(4.0)
    out += [dataclasses.astuple(s.link(k)) for k in (0, 1, 2, 99)]
    u = C.NetworkModel.uniform(12e6, latency_s=0.03)
    out += [u.upload_time([3, 4], 38_638_176), u.download_time([5], 1)]
    return out


def test_link_pricing_and_scaled_equal_jax():
    j, t = _both(_link_calls)
    assert t == j
    assert t[3] == 0.0 and t[6] == math.inf         # free link; no uplink


def _avail_calls(C, _D):
    avs = [C.ClientAvailability({0: [(2.0, 5.0)],
                                 1: [(0.0, 1.0), (6.0, 8.0)]}, period=10.0),
           C.ClientAvailability({0: [(0.0, 1.0)]}, period=None),
           C.ClientAvailability({0: []}, period=10.0),
           C.ClientAvailability.always(),
           C.ClientAvailability({0: [(1.0, 3.0)]}, default=False)]
    out = []
    for av in avs:
        for c in (0, 1, 42):
            for t in (0.0, 1.0, 1.5, 2.0, 3.0, 5.0, 9.0, 12.5, 1e9):
                out.append((av.available(c, t), av.remaining(c, t),
                            av.next_available(c, t), av.fits(c, t, 1.5)))
    return out


def test_availability_windows_periods_and_never_again_equal_jax():
    j, t = _both(_avail_calls)
    assert t == j
    av = T.ClientAvailability({0: [(0.0, 1.0)]}, period=None)
    assert av.next_available(0, 2.0) == math.inf
    assert T.ClientAvailability({0: []}, period=10.0).next_available(
        0, 3.0) == math.inf


@pytest.mark.parametrize("dist", ["lognormal", "uniform"])
def test_trace_synthesis_draws_the_same_rows(dist):
    j, t = _both(lambda C, D: [
        dataclasses.astuple(r) for r in D.synthesize_capacity_trace(
            64, seed=13, dist=dist, median_uplink_kbps=40.0)]
        + [dataclasses.astuple(r) for r in D.synthesize_behavior_trace(
            16, seed=5, period_s=100.0)])
    assert t == j


@pytest.mark.parametrize("suffix", ["json", "csv"])
def test_trace_files_cross_package_round_trip(suffix, tmp_path):
    jcap = JD.synthesize_capacity_trace(16, seed=3)
    tcap = TD.synthesize_capacity_trace(16, seed=3)
    p = str(tmp_path / f"cap_j.{suffix}")
    JD.save_capacity_trace(p, jcap)
    assert TD.load_capacity_trace(p) == tcap
    q = str(tmp_path / f"cap_t.{suffix}")
    TD.save_capacity_trace(q, tcap)
    assert JD.load_capacity_trace(q) == jcap
    if suffix == "json":
        jb = JD.synthesize_behavior_trace(8, seed=5, period_s=100.0)
        tb = TD.synthesize_behavior_trace(8, seed=5, period_s=100.0)
        JD.save_behavior_trace(str(tmp_path / "b_j.json"), jb)
        TD.save_behavior_trace(str(tmp_path / "b_t.json"), tb)
        assert TD.load_behavior_trace(str(tmp_path / "b_j.json")) == tb
        assert [dataclasses.astuple(r) for r in JD.load_behavior_trace(
            str(tmp_path / "b_t.json"))] == \
            [dataclasses.astuple(r) for r in tb]


def test_from_trace_units_and_constructors_equal_jax():
    rows = [dict(client_id=0, uplink_kbps=8.0, downlink_kbps=16.0,
                 latency_ms=250.0)]

    def calls(C, D):
        net = C.NetworkModel.from_trace(rows)
        lg = C.NetworkModel.lognormal(20, seed=4, median_uplink_kbps=300.0)
        ft = C.NetworkModel.from_trace(D.synthesize_capacity_trace(20, 4))
        di = C.ClientAvailability.diurnal(20, period_s=400.0, seed=22)
        return ([dataclasses.astuple(net.link(0))]
                + [dataclasses.astuple(lg.link(c)) for c in range(21)]
                + [dataclasses.astuple(ft.link(c)) for c in range(21)]
                + [(di.period, di.available(c, 150.0),
                    di.next_available(c, 150.0)) for c in range(21)])

    j, t = _both(calls)
    assert t == j
    assert t[0] == (1000.0, 2000.0, 0.25)          # 8 kbps = 1000 B/s


def test_comm_event_in_the_clock_never_compares_its_partial():
    """Two arrivals at one virtual time pop in push order; the heap orders
    by (time, seq) and never compares the tensors the events carry."""
    clock = T.VirtualClock()
    ev = [T.CommEvent(executor=k, partial={"x": torch.ones(3) * k},
                      record=None, n_tasks=1, completed_clients=(k,),
                      wire_bytes=12) for k in range(3)]
    for e in ev:
        clock.push(5.0, "chunk_arrived", e)
    assert [clock.pop().data.executor for _ in range(3)] == [0, 1, 2]


# ---------------------------------------------------------------------------
# engines: both packages window by window
# ---------------------------------------------------------------------------

def _pair(engine, opts, knobs, *, compressor=None, per_round=10, K=4,
          n_clients=N_CLIENTS, **server_kw):
    """The same server in both packages: (JAX, port).  ``knobs(core,
    traces)`` builds the network / availability / fault kwargs from each
    package's own classes."""
    out = []
    builds = ((J, JD, jclients, JGRAD, {"w": jnp.zeros((DIM, N_CLASSES)),
                                        "b": jnp.zeros((N_CLASSES,))}, {}),
              (T, TD, tclients, TGRAD, {"w": torch.zeros(DIM, N_CLASSES),
                                        "b": torch.zeros(N_CLASSES)},
               {"device": "cpu"}))
    for C, D, make, grad, params, dev in builds:
        data = make(n_clients, dim=DIM, n_classes=N_CLASSES,
                    mean_samples=30, batch_size=10, seed=1)
        algo = C.make_algorithm("fedavg", grad, lr=0.1)
        sm = C.ClientStateManager(tempfile.mkdtemp())
        timer = C.TickTimer(1.0)
        execs = [C.SequentialExecutor(k, algo, state_manager=sm,
                                      timer=timer, **dev)
                 for k in range(K)]
        out.append(C.ParrotServer(
            params=params, algorithm=algo, executors=execs,
            data_by_client=data, clients_per_round=per_round, seed=7,
            round_engine=engine, engine_opts=dict(opts or {}),
            compressor=compressor, **knobs(C, D), **server_kw, **dev))
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
    """Both servers window by window: everything but the params exactly
    equal after each window, params allclose at 1e-5."""
    jsel, tsel = _record_schedules(js), _record_schedules(ts)
    out = []
    for w in range(windows):
        jm, tm = js.run_round(), ts.run_round()
        assert tsel == jsel, f"window {w}: selections or queues differ"
        assert _window(tm) == _window(jm), f"window {w}"
        assert ts.virtual_now == js.virtual_now
        assert ts._wire_ratio == js._wire_ratio
        assert ts._last_payload_nbytes == js._last_payload_nbytes
        assert sorted(ts.executors) == sorted(js.executors)
        for k in js.params:
            np.testing.assert_allclose(np.asarray(ts.params[k]),
                                       np.asarray(js.params[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
        out.append(tm)
    return out


ENGINES = [("bsp", None),
           ("semi-sync", {"chunk_size": 2, "deadline_frac": 0.7}),
           ("async", {"chunk_size": 2})]
IDS = ["bsp", "semi-sync", "async"]


def _uniform(C, D):
    return {"network": C.NetworkModel.uniform(2_000.0, 8_000.0,
                                              latency_s=0.05)}


def _lognormal(C, D):
    return {"network": C.NetworkModel.from_trace(D.synthesize_capacity_trace(
        N_CLIENTS, seed=13, dist="lognormal", median_uplink_kbps=40.0))}


def _diurnal(C, D):
    return {"availability": C.ClientAvailability.diurnal(
        N_CLIENTS, period_s=60.0, duty_mean=0.6, seed=22)}


@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_uniform_network_windows_equal_jax(engine, opts):
    ms = _run_pair(*_pair(engine, opts, _uniform), 4)
    assert all(m.extra["comm_time_up"] > 0 for m in ms)
    assert all(m.extra["comm_wire_bytes"] > 0 for m in ms)


@pytest.mark.parametrize("comp", [None, "topk", "int8"])
@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_lognormal_trace_windows_equal_jax(engine, opts, comp):
    ops.reset_topk_counts()
    ms = _run_pair(*_pair(engine, opts, _lognormal, compressor=comp), 4)
    assert all(m.extra["comm_time_up"] > 0 for m in ms)
    if comp == "topk":
        assert ops.topk_dispatches > 0


@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_diurnal_availability_windows_equal_jax(engine, opts):
    js, ts = _pair(engine, opts, _diurnal)
    av = ts.availability
    picked = []
    inner = ts.select_clients

    def select(*a, **kw):
        tasks = inner(*a, **kw)
        picked.append([(t.client, ts.virtual_now) for t in tasks])
        return tasks

    ts.select_clients = select
    _run_pair(js, ts, 5)
    assert picked and all(av.available(c, now) for sel in picked
                          for c, now in sel)


# availability gaps: everyone offline, a late window, windows too short
# for a chunk (tests/test_network.py's configurations)
GAPS = {
    "half_offline": lambda C: C.ClientAvailability(
        {c: [] for c in range(20)}, period=None),
    "late_window": lambda C: C.ClientAvailability(
        {c: [(30.0, 1e9)] for c in range(N_CLIENTS)}, period=None),
    "short_windows": lambda C: C.ClientAvailability(
        {c: [(0.0, 2.0)] for c in range(N_CLIENTS)}, period=50.0),
}


@pytest.mark.parametrize("gap", sorted(GAPS))
@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_availability_gaps_equal_jax(engine, opts, gap):
    """Idle fast-forwards, async wakes at the next window and expiry drops
    that advance virtual time, window by window as in JAX."""
    ms = _run_pair(*_pair(engine, opts,
                          lambda C, D: {"availability": GAPS[gap](C)}), 4)
    if gap == "late_window" and engine != "async":
        assert ms[0].extra["idle_time"] == 30.0


def test_overlap_scheduling_across_an_availability_gap_equals_jax():
    """BSP's overlap schedule prepared for an empty cohort is dropped after
    the fast-forward, as in JAX."""
    js, ts = _pair("bsp", None, lambda C, D: {
        "availability": C.ClientAvailability(
            {c: [(0.0, 5.0)] for c in range(N_CLIENTS)}, period=100.0)},
        overlap_scheduling=True)
    ms = _run_pair(js, ts, 6)
    assert any(m.extra.get("idle_time", 0.0) > 0 for m in ms)


def test_semi_sync_fast_forward_excludes_the_carry_like_jax():
    js, ts = _pair("semi-sync", {"chunk_size": 2}, lambda C, D: {
        "availability": C.ClientAvailability(
            {c: [(10.0, 1e9)] for c in range(12)}, period=None)},
        K=2, n_clients=12)
    for srv, C in ((js, J), (ts, T)):
        srv.engine._carry = [C.ClientTask(0, srv.population.n_samples(0))]
    [m] = _run_pair(js, ts, 1)
    assert m.extra["landed_clients"] == 11.0
    assert [t.client for t in ts.engine._carry] == [0]


def test_async_impossible_windows_raise_not_spin():
    srv = _pair("async", {"chunk_size": 2}, lambda C, D: {
        "availability": C.ClientAvailability(
            {c: [(0.0, 2.0)] for c in range(N_CLIENTS)}, period=50.0)},
        scheduler_policy="uniform")[1]
    srv.run_round()
    srv.estimator.last_fit = {k: T.WorkloadModel(t_sample=10.0, b=100.0)
                              for k in srv.executors}
    with pytest.raises(RuntimeError, match="starved"):
        for _ in range(8):
            srv.run_round()


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------

def _port(engine, opts, knobs, compressor=None):
    return _pair(engine, opts, knobs, compressor=compressor)[1]


def _history(srv):
    return [(m.makespan, m.n_clients, m.failures,
             {k: v for k, v in m.extra.items()
              if not k.startswith("comm_") and k != "dropped_clients"})
            for m in srv.history]


@pytest.mark.parametrize("comp", [None, "topk"])
@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_free_network_equals_no_network(engine, opts, comp):
    a = _port(engine, opts, lambda C, D: {}, comp)
    b = _port(engine, opts, lambda C, D: {
        "network": C.NetworkModel({})}, comp)
    a.run(4)
    b.run(4)
    assert params_digest(a.params) == params_digest(b.params)
    assert _history(a) == _history(b)
    assert all(m.extra["comm_time_up"] == 0.0 for m in b.history)


@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_always_available_equals_none(engine, opts):
    a = _port(engine, opts, lambda C, D: {})
    b = _port(engine, opts, lambda C, D: {
        "availability": C.ClientAvailability.always()})
    a.run(4)
    b.run(4)
    assert params_digest(a.params) == params_digest(b.params)
    assert _history(a) == _history(b)


@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_resume_with_network_is_bit_exact(engine, opts, tmp_path):
    """Checkpoint at round 2 under a bandwidth trace and diurnal churn,
    restore into a fresh server, run on: params and makespans equal the
    uninterrupted run's (virtual_now, the payload size and the wire ratio
    ride the blob)."""
    def knobs(C, D):
        return {"network": C.NetworkModel.from_trace(
                    D.synthesize_capacity_trace(N_CLIENTS, seed=21,
                                                median_uplink_kbps=300.0)),
                "availability": C.ClientAvailability.diurnal(
                    N_CLIENTS, period_s=400.0, duty_mean=0.8, seed=22)}

    d = str(tmp_path / "ck")
    a = _port(engine, opts, knobs, compressor="topk")
    a.checkpoint_manager = CheckpointManager(d, every_rounds=1, keep=10)
    for _ in range(5):
        a.run_round()
    b = _port(engine, opts, knobs, compressor="topk")
    CheckpointManager(d).restore(b, os.path.join(d, "step_%08d" % 2))
    assert b.round == 2 and b.virtual_now > 0.0
    assert b._last_payload_nbytes > 0 and b._wire_ratio < 1.0
    for _ in range(3):
        b.run_round()
    assert params_digest(a.params) == params_digest(b.params)
    assert [m.makespan for m in a.history[2:]] == \
        [m.makespan for m in b.history[2:]]
    assert [m.extra for m in a.history[2:]] == \
        [m.extra for m in b.history[2:]]


def test_async_state_dict_round_trips_inflight_comm():
    """An in-flight upload's partial goes to the host in the state and
    comes back onto the server's device; the resumed clock holds the same
    (time, seq, kind) events and the run continues as the original."""
    knobs = lambda C, D: {"network": C.NetworkModel.uniform(  # noqa: E731
        2_000.0, 1e8, 0.01)}
    srv = _port("async", {"chunk_size": 2}, knobs)
    srv.run_round()
    state = pickle.loads(pickle.dumps(srv.engine.state_dict()))
    kinds = [e[2] for e in state["clock"]["events"]]
    assert state["initialized"] and "chunk_arrived" in kinds
    arrived = [e[3] for e in state["clock"]["events"]
               if e[2] == "chunk_arrived"]
    assert all(isinstance(ce, T.CommEvent) for ce in arrived)
    eng = T.AsyncEngine(chunk_size=2)
    eng.load_state_dict(state, device=torch.device("cpu"))
    again = eng.state_dict()
    assert [(e[0], e[1], e[2]) for e in again["clock"]["events"]] \
        == [(e[0], e[1], e[2]) for e in state["clock"]["events"]]
    for a, b in zip(again["clock"]["events"], state["clock"]["events"]):
        if a[2] == "chunk_arrived":
            assert dataclasses.replace(a[3], partial=None) == \
                dataclasses.replace(b[3], partial=None)
            for x, y in zip(torch.utils._pytree.tree_leaves(a[3].partial),
                            torch.utils._pytree.tree_leaves(b[3].partial)):
                if isinstance(x, torch.Tensor):
                    assert x.device.type == "cpu" and torch.equal(x, y)
    assert again["counters"] == state["counters"]


def test_overlap_span_equals_jax():
    """The barrier span the control plane's overlap_comm selects (BSP's
    ``_overlap_span``), on the same reports in both packages."""
    def calls(C, D):
        from importlib import import_module
        eng = import_module(C.__name__.replace(".core", ".core.engine"))
        srv = type("S", (), {})()
        srv.network = C.NetworkModel.from_trace(
            D.synthesize_capacity_trace(8, seed=3, median_uplink_kbps=50.0))
        srv.availability, srv._last_payload_nbytes = None, 5_000
        srv._wire_ratio = 0.5
        ns = eng._NetSim(srv, 0.0)
        rec = eng.RunRecord
        reps = [eng.ExecutorReport(
            executor=k, partial=None, records=[
                rec(round=0, client=c, executor=k, n_samples=10,
                    time=0.25 * (c + 1)) for c in cl],
            virtual_time=0.25 * sum(c + 1 for c in cl), wall_time=0.0,
            n_tasks=len(cl), completed_clients=list(cl),
            wire_bytes=1_000 * (k + 1))
            for k, cl in enumerate([[0, 3], [1, 4, 6], [], [2]])]
        span = eng.BSPEngine._overlap_span(ns, reps)
        return span, ns.extra()

    j, t = _both(calls)
    assert t == j and t[0] > 0.0

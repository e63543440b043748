"""The port's virtual-time telemetry (``repro_torch.core.telemetry``)
against the JAX package on the CPU.

Units run the same calls on both packages' registries, histograms and
tracers and compare the results exactly; traces exported by either package
pass both packages' ``validate_trace``.  The engine cases run both
packages on the same numpy clients, seeds, links and fault plans under a
``TickTimer`` and hold ``tracer.spans``, ``tracer.instants`` and
``registry.snapshot(exclude=("host/",))`` equal exactly, window by window
as ``tests/test_torch_control.py``'s ``run_pair`` does.  Within the port,
``telemetry=True`` equals ``telemetry=None`` bit for bit, and a run killed
mid-round resumes with the uninterrupted run's trace and registry.
"""
import json

import numpy as np
import pytest

import repro_torch.core as T
import repro_torch.core.telemetry as TT
from repro_torch.checkpoint import params_digest
from test_torch_control import (CHAOS, ENGINES, IDS, N_CLIENTS, _jax,
                                _port, build, chaos_knobs, chaos_opts,
                                kill_and_resume, no_host, pair, run_pair)


def _J():
    return _jax()[0]


def _both(fn):
    """fn(core, telemetry module) on each package: (JAX, port)."""
    import repro.core.telemetry as JT
    return fn(_J(), JT), fn(T, TT)


# ---------------------------------------------------------------------------
# registry, histogram and tracer units
# ---------------------------------------------------------------------------

def _registry_calls(C, M):
    reg = C.MetricsRegistry()
    reg.counter("total/x").inc()
    reg.counter("total/x").inc(2.5)
    reg.gauge("round/y").set(7.0)
    out = [reg.value("total/x"), reg.value("round/y"), reg.value("missing")]
    h = M.Histogram(bounds=(1.0, 5.0))
    for v in (0.5, 0.5, 3.0, 10.0, 1.0, 5.0):
        h.observe(v)
    out += [h.counts, h.count, h.mean, h.vmin, h.vmax, h.state_dict(),
            M.Histogram.from_state_dict(h.state_dict()).state_dict(),
            M.Histogram().mean, M.DEFAULT_BOUNDS]
    reg.ingest_extra({"retries": 2, "deadline_frac": 0.7,
                      "carried_tasks": 3, "comm_wire_bytes": 100,
                      "unknown_key": 5, "flag": True, "nested": {"a": 1.0},
                      "state_manager": {"hits": 3, "tier0_bytes": 9},
                      "utilization": {0: {"busy_frac": 0.5}},
                      "deadline": float("inf"), "idle_time": float("inf")})
    reg.ingest_extra({"retries": 3, "deadline_frac": 0.8})
    reg.counter("host/wall").inc(9)
    reg.histogram("hist/h").observe(3.0)
    out += [reg.extra_last("deadline_frac"), reg.extra_total("retries"),
            reg.extra_last("absent", -1.0), reg.snapshot(),
            reg.snapshot(exclude=("host/",)), reg.state_dict()]
    fresh = C.MetricsRegistry()
    fresh.load_state_dict(reg.state_dict())
    fresh.load_state_dict(None)
    out += [fresh.state_dict(), [M._extra_kind(k) for k in (
        "retries", "deadline", "state_manager/x_bytes", "state_manager/n",
        "new")], M.EXTRA_SCHEMA]
    return out


def test_registry_histogram_and_ingest_extra_equal_jax():
    j, t = _both(_registry_calls)
    assert t == j
    assert t[0] == 3.5 and t[3] == [3, 2, 1]    # <= 1, (1, 5], > 5


def _tracer(C):
    tr = C.Tracer()
    tr.span("exec:0", "chunk", 0.0, 2.0, cat="busy", args={"round": 1})
    tr.span("exec:0:up", "upload", 2.0, 3.0, cat="comm",
            args={"wire_bytes": 10})
    tr.span("exec:0:up", "upload", 2.5, 3.5, cat="comm",
            args={"wire_bytes": 12})
    tr.span("server", "round", 0.0, 3.0, cat="server")
    tr.span("server", "fold", 1.0, 2.0, cat="server")
    tr.instant("server", "fold", 3.0, cat="server")
    tr.instant("control", "deadline_frac", 3.0, cat="control",
               args={"value": 0.6})
    return tr


def test_tracer_export_chrome_schema_equal_jax(tmp_path):
    j, t = _both(lambda C, M: (_tracer(C).to_chrome(), _tracer(C).lanes(),
                               _tracer(C).state_dict()))
    assert t == j
    doc = t[0]
    assert doc["displayTimeUnit"] == "ms"
    phases = [e["ph"] for e in doc["traceEvents"]]
    assert phases.count("M") == 4 and phases.count("b") == 2 \
        and phases.count("e") == 2 and phases.count("i") == 2
    path = _tracer(T).export(str(tmp_path / "t.json"))
    with open(path) as f:
        assert json.load(f) == doc
    fresh = T.Tracer()
    fresh.load_state_dict(_tracer(T).state_dict())
    assert fresh.spans == _tracer(T).spans
    assert fresh.instants == _tracer(T).instants


def _bad_tracers(C):
    out = []
    for spans in ([("exec:0", "chunk", 2.0, 1.0, "busy", None)],
                  [("exec:0", "chunk", -1.0, 1.0, "busy", None)],
                  [("exec:0", "chunk", 0.0, 2.0, "busy", None),
                   ("exec:0", "chunk", 1.0, 3.0, "busy", None)],
                  [("exec:0:up", "upload", 0.0, 1.0, "comm",
                    {"wire_bytes": -5})],
                  [("exec:0", "chunk", 0.0, float("nan"), "busy", None)]):
        tr = C.Tracer()
        for s in spans:
            tr.span(*s[:4], cat=s[4], args=s[5])
        out.append(tr)
    tr = C.Tracer()
    tr.instant("server", "fold", -2.0)
    out.append(tr)
    return out


def test_validate_trace_flags_the_same_violations_as_jax():
    j, t = _both(lambda C, M: [C.validate_trace(tr)
                               for tr in _bad_tracers(C)])
    assert t == j
    assert all(t)


@pytest.mark.parametrize("src", ["tracer", "state_dict", "chrome", "file"])
def test_validate_trace_on_every_source_kind_across_packages(src,
                                                             tmp_path):
    """Each package's trace, in every source kind, passes both packages'
    ``validate_trace``; a file either package exported reads back into
    the same spans and instants in the other."""
    import repro.core.telemetry as JT
    for C, name in ((_J(), "jax"), (T, "port")):
        tr = _tracer(C)
        path = tr.export(str(tmp_path / f"{name}.json"))
        source = {"tracer": tr, "state_dict": tr.state_dict(),
                  "chrome": tr.to_chrome(), "file": path}[src]
        if src == "tracer":
            # a Tracer object is read by its own package's validate_trace
            assert C.validate_trace(source) == []
            continue
        assert T.validate_trace(source) == []
        assert _J().validate_trace(source) == []
        assert TT._spans_from(source) == JT._spans_from(source)


# ---------------------------------------------------------------------------
# utilization
# ---------------------------------------------------------------------------

def _util_calls(C, M):
    tele = C.Telemetry(tracer=_tracer(C))
    tele.tracer.span("exec:1", "chunk", 0.5, 4.0, cat="busy",
                     args={"down_s": 0.75})
    tele.tracer.span("exec:x", "chunk", 0.5, 4.0)
    return [tele.utilization(5.0, 5.0, executors=(0,)),
            tele.utilization(0.0, 3.0, executors=(0, 2)),
            tele.utilization(1.0, 2.5), tele.utilization(0.0, 10.0)]


def test_utilization_equals_jax():
    j, t = _both(_util_calls)
    assert t == j
    assert t[0][0] == {"busy_frac": 0.0, "comm_frac": 0.0, "idle_frac": 1.0}


@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_utilization_sums_to_one(engine, opts):
    srv = build(_port(), engine, opts, _net_knobs)
    m = srv.run_round()
    util = m.extra["utilization"]
    assert set(util) == set(srv.executors)
    for k, u in util.items():
        assert all(0.0 <= v <= 1.0 for v in u.values())
        assert sum(u.values()) == pytest.approx(1.0, abs=1e-9)
        assert srv.telemetry.registry.value(
            f"util/exec{k}/busy_frac") == u["busy_frac"]


# ---------------------------------------------------------------------------
# telemetry on ≡ None within the port
# ---------------------------------------------------------------------------

def _net(C):
    return C.NetworkModel({c: C.LinkProfile(100.0 + 10.0 * c, 50.0, 0.2)
                           for c in range(N_CLIENTS)})


def _net_knobs(C):
    return {"network": _net(C), "telemetry": True}


@pytest.mark.parametrize("net", [False, True], ids=["no_net", "net"])
@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_enabled_is_bit_identical_to_none(engine, opts, net):
    def knobs(on):
        return lambda C: {**({"network": _net(C)} if net else {}),
                          "telemetry": True if on else None}

    a = build(_port(), engine, opts, knobs(False))
    b = build(_port(), engine, opts, knobs(True))
    ha = [a.run_round() for _ in range(4)]
    hb = [b.run_round() for _ in range(4)]
    assert params_digest(a.params) == params_digest(b.params)
    assert [m.makespan for m in ha] == [m.makespan for m in hb]
    assert b.telemetry.tracer.spans
    assert all("utilization" not in m.extra for m in ha)
    assert a.telemetry is None


# ---------------------------------------------------------------------------
# traces equal JAX's, 3 engines x 4 settings
# ---------------------------------------------------------------------------

def _lognormal_topk(C):
    traces = __import__(C.__name__.replace(".core", ".data.traces"),
                        fromlist=["x"])
    return {"network": C.NetworkModel.from_trace(
                traces.synthesize_capacity_trace(
                    N_CLIENTS, seed=13, dist="lognormal",
                    median_uplink_kbps=40.0)),
            "compressor": "topk", "telemetry": True}


SETTINGS = {
    "no_net": (lambda C: {"telemetry": True}, {}),
    "uniform": (lambda C: {"network": C.NetworkModel.uniform(
        2_000.0, 8_000.0, latency_s=0.05), "telemetry": True}, {}),
    "lognormal_topk": (_lognormal_topk, {}),
    "chaos": (chaos_knobs(control=False), CHAOS),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("engine,opts", ENGINES, ids=IDS)
def test_traces_equal_jax(engine, opts, setting):
    knobs, kw = SETTINGS[setting]
    if setting == "chaos":
        opts = chaos_opts(engine)
    js, ts = pair(engine, opts, knobs, **kw)
    ms = run_pair(js, ts, 5 if setting == "chaos" else 3)
    tr = ts.telemetry.tracer
    assert T.validate_trace(tr) == []
    assert _J().validate_trace(tr.state_dict()) == []
    lanes = {s[0] for s in tr.spans}
    assert {f"exec:{k}" for k in range(4 if setting != "chaos" else 3)} \
        & lanes and "rounds" in lanes
    if setting != "no_net":
        assert any(lane.endswith(":up") for lane in lanes)
        up = sum(s[5]["billed_bytes"] for s in tr.spans
                 if s[0].endswith(":up"))
        billed = sum(m.extra.get("comm_wire_bytes", 0.0) for m in ms)
        if engine != "async":
            # async tail dispatches bill the NEXT window's extra
            assert up == billed
    if setting == "chaos":
        assert "faults" in lanes and any(
            i[3] == "fault" for i in tr.instants)


def test_async_histograms_and_round_gauges_equal_jax():
    js, ts = pair("async", {"chunk_size": 2}, _net_knobs)
    run_pair(js, ts, 4)
    reg = ts.telemetry.registry
    for h in ("hist/staleness", "hist/queue_depth", "hist/upload_delay"):
        assert reg.histogram(h).count > 0
    assert reg.value("total/rounds") == 4
    assert reg.value("round/makespan") == ts.history[-1].makespan
    assert reg.value("host/wall_s") > 0 and \
        reg.value("host/round_wall_s") > 0
    assert reg.value("host/compiles") is not None


def test_control_notes_land_on_the_control_lane_like_jax():
    def knobs(C):
        return {"control": C.ControlPlane(deadline=C.DeadlineController(
                    target_ratio=0.5, alpha=1.0)), "telemetry": True}

    js, ts = pair("semi-sync", {"chunk_size": 2, "deadline_frac": 0.9},
                  knobs)
    run_pair(js, ts, 4)
    notes = [i for i in ts.telemetry.tracer.instants if i[0] == "control"]
    assert notes and all(i[3] == "control" for i in notes)
    assert ts.telemetry.registry.value("control/deadline_frac") == \
        notes[-1][4]["value"]


def test_fault_plan_spans_on_the_faults_lane_like_jax():
    js, ts = pair("bsp", None, chaos_knobs(control=False, net=False),
                  **CHAOS)
    assert ts.telemetry.tracer.spans == js.telemetry.tracer.spans
    lanes = {s[0] for s in ts.telemetry.tracer.spans}
    assert lanes == {"faults"}
    assert {s[4] for s in ts.telemetry.tracer.spans} == {"fault"}


def test_compiles_reported_per_executor_in_host():
    srv = build(_port(), "bsp", None, lambda C: {"telemetry": True})
    srv.run_round()
    reg = srv.telemetry.registry
    vals = [reg.value(f"host/exec{k}/compiles") for k in srv.executors]
    assert any(v is not None and v >= 1 for v in vals)
    assert all(k.startswith("host/") for k in
               set(reg.snapshot()["counters"])
               - set(reg.snapshot(exclude=("host/",))["counters"]))


@pytest.mark.parametrize("engine", IDS)
def test_kill_then_auto_resume_reproduces_the_trace(engine, tmp_path):
    """Telemetry and the chaos plan, no control: a fresh server's
    ``run(N, auto_resume=True)`` reproduces the uninterrupted run's trace
    (construction-time plan spans replaced by the blob's), registry
    without ``host/`` and ``params_digest``."""
    ref, res = kill_and_resume(engine, tmp_path,
                               chaos_knobs(control=False, net=False))
    assert params_digest(res.params) == params_digest(ref.params)
    assert res.telemetry.tracer.state_dict() == \
        ref.telemetry.tracer.state_dict()
    got, want = no_host(res.telemetry.registry), \
        no_host(ref.telemetry.registry)
    if engine == "async":
        for d_ in (got["counters"], want["counters"]):
            d_.pop("total/comm_bytes", None)
    assert got == want
    assert T.validate_trace(res.telemetry.tracer) == []
    assert np.isfinite([m.makespan for m in res.history]).all()


def test_trace_round_driver_writes_the_jax_examples_traces(tmp_path):
    """``python -m repro_torch.launch.trace_round --device cpu`` writes
    three traces, each accepted by both packages' ``validate_trace`` and
    byte for byte the file ``examples/trace_round.py`` writes."""
    import importlib.util
    import os
    from repro_torch.launch import trace_round
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert trace_round.main(["--device", "cpu", "--rounds", "2",
                             "--out", str(port)]) == 0
    spec = importlib.util.spec_from_file_location(
        "jax_trace_round", os.path.join(os.path.dirname(__file__), "..",
                                        "examples", "trace_round.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    os.makedirs(ref)
    for name, engine, opts in ex.ENGINES:
        srv = ex.build(engine, opts, 2)
        for _ in range(2):
            srv.run_round()
        srv.telemetry.tracer.export(
            str(ref / f"trace_{name.replace('-', '_')}.json"))
    files = sorted(os.listdir(port))
    assert files == sorted(os.listdir(ref)) and len(files) == 3
    for f in files:
        assert T.validate_trace(str(port / f)) == []
        assert _J().validate_trace(str(port / f)) == []
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f

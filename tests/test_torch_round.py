"""The port's BSP round main path against the JAX package's, end to end on
the CPU under a ``TickTimer``: the quickstart configuration, stateful
SCAFFOLD/FedDyn with state spilled to disk, executor failures, backups and
overlapped scheduling — plus the port's own reference, device defaults and
the knobs of later slices.

Selections, schedules and makespan histories must be *exactly* equal
(virtual time is a pure function of the timer calls each span makes);
params are allclose at 1e-5 (fp32 sums in another order on each side).
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.data import make_classification_clients as jclients
from repro_torch.core.state_manager import ClientStateManager
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


def _servers(name, *, n_clients=100, dim=32, n_classes=10, mean_samples=64,
             K=4, per_round=20, lr=0.05, local_epochs=2, budget=1 << 28,
             fail_at=None, server_kw=None, exec_kw=None, jax_too=True):
    """The same configuration built in both packages: [(JAX), port]."""
    out = []
    builds = [(T, tclients, TGRAD,
               {"w": torch.zeros(dim, n_classes), "b": torch.zeros(n_classes)},
               {"device": "cpu"})]
    if jax_too:
        builds.insert(0, (J, jclients, JGRAD,
                          {"w": jnp.zeros((dim, n_classes)),
                           "b": jnp.zeros((n_classes,))}, {}))
    for pkg, make, grad, params, dev in builds:
        data = make(n_clients, dim=dim, n_classes=n_classes,
                    mean_samples=mean_samples, seed=0)
        algo = pkg.make_algorithm(name, grad, lr=lr,
                                  local_epochs=local_epochs)
        sm = pkg.ClientStateManager(tempfile.mkdtemp(),
                                    memory_budget_bytes=budget)
        timer = pkg.TickTimer(1.0)
        execs = [pkg.SequentialExecutor(k, algo, state_manager=sm,
                                        timer=timer, **(exec_kw or {}), **dev)
                 for k in range(K)]
        if fail_at is not None:
            execs[fail_at[0]].fail_at = fail_at[1]
        srv = pkg.ParrotServer(params=params, algorithm=algo,
                               executors=execs, data_by_client=data,
                               clients_per_round=per_round, seed=0,
                               **(server_kw or {}), **dev)
        out.append((srv, sm))
    return out


def _record_schedules(srv):
    """Wrap the scheduler to keep every (round, queues) it hands out."""
    seen = []
    inner = srv.scheduler.schedule

    def schedule(rnd, tasks, executors, **kw):
        s = inner(rnd, tasks, executors, **kw)
        seen.append((rnd, sorted(t.client for t in tasks),
                     {k: [t.client for t in q]
                      for k, q in s.assignment.items()}))
        return s

    srv.scheduler.schedule = schedule
    return seen


def _assert_params_close(tp, jp, atol=1e-5, rtol=1e-5):
    for k in jp:
        np.testing.assert_allclose(np.asarray(tp[k]), np.asarray(jp[k]),
                                   atol=atol, rtol=rtol)


def _history(srv):
    return [(m.round, m.makespan, m.comm_bytes, m.comm_trips, m.n_clients,
             m.n_executors, m.failures) for m in srv.history]


def test_quickstart_matches_jax_exactly():
    (js, _), (ts, _) = _servers("fedavg")
    jsel, tsel = _record_schedules(js), _record_schedules(ts)
    ops.reset_agg_counts()
    for _ in range(10):
        js.run_round()
        ts.run_round()
    assert tsel == jsel                       # selections and schedules
    assert _history(ts) == _history(js)       # makespans, comm, K, failures
    assert [m.extra for m in ts.history] == [m.extra for m in js.history]
    _assert_params_close(ts.params, js.params)
    assert ops.agg_dispatches > 0             # every fold went through ops


@pytest.mark.parametrize("name", ["scaffold", "feddyn"])
def test_stateful_rounds_spill_and_match_jax(name):
    (js, jsm), (ts, tsm) = _servers(
        name, n_clients=120, dim=16, n_classes=8, mean_samples=30, K=8,
        per_round=30, lr=0.1, local_epochs=1, budget=8 * 2048)
    for _ in range(3):
        js.run_round()
        ts.run_round()
    assert _history(ts) == _history(js)
    assert tsm.stats["spills"] > 0 and tsm.stats["disk_writes"] > 0
    assert tsm.stats == jsm.stats
    sm_t = [m.extra["state_manager"] for m in ts.history]
    sm_j = [m.extra["state_manager"] for m in js.history]
    for a, b in zip(sm_t, sm_j):
        assert {k: v for k, v in a.items() if not k.endswith("bytes")} == \
            {k: v for k, v in b.items() if not k.endswith("bytes")}
    _assert_params_close(ts.params, js.params)
    for key in ("c", "h"):
        if key in js.server_state:
            _assert_params_close(ts.server_state[key], js.server_state[key])


@pytest.mark.parametrize("quorum", [1.0, 0.5])
def test_executor_failure_reruns_and_shrinks_k_like_jax(quorum):
    kw = {"engine_opts": {"quorum_frac": quorum}}
    (js, _), (ts, _) = _servers("fedavg", fail_at=(2, (1, 1)), server_kw=kw,
                                n_clients=60, per_round=16, local_epochs=1)
    for _ in range(3):
        js.run_round()
        ts.run_round()
    assert _history(ts) == _history(js)
    assert [m.extra for m in ts.history] == [m.extra for m in js.history]
    assert ts.history[1].failures == 1
    assert [m.n_executors for m in ts.history] == [4, 3, 3]
    assert 2 not in ts.executors
    if quorum < 1.0:
        assert ts.history[1].extra["quorum_commits"] == 1.0
    _assert_params_close(ts.params, js.params)


def test_backups_and_overlapped_scheduling_match_jax():
    kw = {"backup_fraction": 0.25, "overlap_scheduling": True}
    (js, _), (ts, _) = _servers("fedprox", server_kw=kw, n_clients=60,
                                per_round=16, local_epochs=1)
    jsel, tsel = _record_schedules(js), _record_schedules(ts)
    for _ in range(4):
        js.run_round()
        ts.run_round()
    assert tsel == jsel
    assert _history(ts) == _history(js)
    assert ts.history[2].extra["backup_tasks"] > 0
    _assert_params_close(ts.params, js.params)


def test_eager_path_matches_blocked_path():
    [(blocked, _)] = _servers("scaffold", exec_kw={"client_block": 4},
                              jax_too=False)
    [(eager, _)] = _servers("scaffold", exec_kw={"use_compiled_steps": False},
                            jax_too=False)
    for _ in range(3):
        blocked.run_round()
        eager.run_round()
    for k in blocked.params:
        torch.testing.assert_close(blocked.params[k], eager.params[k],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["fedavg", "fednova", "mime", "scaffold"])
def test_hierarchical_equals_flat_reference(name):
    """The port's hierarchical rounds equal its own single-process
    original-FL reference (same cohorts: both draw from seed 0)."""
    data = tclients(30, dim=8, n_classes=4, mean_samples=20, seed=1)
    params = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}
    algo = T.make_algorithm(name, TGRAD, lr=0.1)
    ref, _ = T.run_flat_reference(params, algo, data, 10, 3, seed=0)
    algo2 = T.make_algorithm(name, TGRAD, lr=0.1)
    sm = ClientStateManager(tempfile.mkdtemp())
    execs = [T.SequentialExecutor(k, algo2, state_manager=sm, device="cpu")
             for k in range(3)]
    srv = T.ParrotServer(params=params, algorithm=algo2, executors=execs,
                         data_by_client=data, clients_per_round=10, seed=0,
                         device="cpu")
    srv.run(3)
    for k in ref:
        torch.testing.assert_close(srv.params[k], ref[k], atol=1e-5,
                                   rtol=1e-5)


def test_entry_points_default_to_the_card():
    algo = T.make_algorithm("fedavg", TGRAD, lr=0.1)
    if torch.cuda.is_available():
        assert T.SequentialExecutor(0, algo).device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="cuda"):
        T.SequentialExecutor(0, algo)
    with pytest.raises(RuntimeError, match="cuda"):
        T.ParrotServer(params={"w": torch.zeros(2)}, algorithm=algo,
                       executors=[], data_by_client={}, clients_per_round=1)
    from repro_torch.convert import params_from_jax
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    assert T.SequentialExecutor(0, algo, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("knob", [
    "checkpoint_manager", "network", "availability", "faults", "retry",
    "placement", "parallel_dispatch", "control", "telemetry"])
def test_later_slice_knobs_raise(knob):
    """Each knob of a later slice raises naming its ROADMAP item; the
    checkpoint manager (item 11), the network, availability, fault plan
    and retry policy (item 13), and the placement and parallel dispatch
    (item 15) are ported and are taken as they are."""
    algo = T.make_algorithm("fedavg", TGRAD, lr=0.1)
    kw = dict(params={"w": torch.zeros(2)}, algorithm=algo, executors=[],
              data_by_client={}, clients_per_round=1, device="cpu")
    ported = {"checkpoint_manager": (object(), lambda s: s.checkpoint_manager),
              "network": (T.NetworkModel({}), lambda s: s.network),
              "availability": (T.ClientAvailability.always(),
                               lambda s: s.availability),
              "faults": (T.FaultPlan(()), lambda s: s.faults.plan),
              "retry": (T.RetryPolicy(), lambda s: s.faults.retry),
              "placement": (T.DevicePlacement([], devices=["cpu"]),
                            lambda s: s.placement),
              "parallel_dispatch": (True, lambda s: s.parallel_dispatch)}
    if knob in ported:
        val, read = ported[knob]
        assert read(T.ParrotServer(**kw, **{knob: val})) is val
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.ParrotServer(**kw, **{knob: object()})


@pytest.mark.parametrize("kw", [
    {"mode": "parrot"},
    {"mode": "parrot", "gang_dispatch": True},
    {"mode": "parrot", "gang_dispatch": False}])
def test_mode_and_gang_dispatch_stored_like_jax(kw):
    (jsrv, _), (tsrv, _) = _servers("fedavg", n_clients=20, per_round=8,
                                    K=2, server_kw=kw)
    assert (tsrv.mode, tsrv.gang_dispatch) == (jsrv.mode, jsrv.gang_dispatch)
    assert tsrv.gang_dispatch is kw.get("gang_dispatch", True)
    # a no-op on one device: the round matches the JAX package's
    jsrv.run(1)
    tsrv.run(1)
    _assert_params_close(tsrv.params, jsrv.params)
    assert _history(tsrv) == _history(jsrv)


@pytest.mark.parametrize("engine", ["semi-sync", "async"])
@pytest.mark.parametrize("knob", ["backup_fraction", "overlap_scheduling",
                                  "parallel_dispatch"])
def test_bsp_only_knobs_rejected_by_des_engines(engine, knob):
    """Both packages refuse a BSP-only knob under a DES engine."""
    kw = {"round_engine": engine,
          knob: {"backup_fraction": 0.2, "overlap_scheduling": True,
                 "parallel_dispatch": True}[knob]}
    with pytest.raises(ValueError, match=knob):
        _servers("fedavg", n_clients=8, per_round=2, K=2, server_kw=kw,
                 jax_too=False)
    with pytest.raises(ValueError, match=knob):
        J.ParrotServer(params={"w": jnp.zeros(2)},
                       algorithm=J.make_algorithm("fedavg", JGRAD, 0.1),
                       executors=[], data_by_client={}, clients_per_round=1,
                       **kw)


@pytest.mark.parametrize("engine", ["semi-sync", "async"])
def test_des_engines_refuse_the_left_out_knobs(engine):
    """Under a DES engine the knobs of later slices still raise, naming
    their item (the network and fault plan, item 13, and the placement,
    item 15, are taken); the engines' checkpoint state (item 11)
    round-trips and a state of another engine is refused."""
    algo = T.make_algorithm("fedavg", TGRAD, lr=0.1)
    items = {"control": "item 16", "telemetry": "item 16"}
    for knob, val in (("network", T.NetworkModel({})),
                      ("faults", T.FaultPlan(())),
                      ("placement", T.DevicePlacement([], devices=["cpu"]))):
        srv = T.ParrotServer(params={"w": torch.zeros(2)}, algorithm=algo,
                             executors=[], data_by_client={},
                             clients_per_round=1, device="cpu",
                             round_engine=engine, **{knob: val})
        assert srv.engine.mode == engine
    for knob, item in items.items():
        with pytest.raises(NotImplementedError, match=item):
            T.ParrotServer(params={"w": torch.zeros(2)}, algorithm=algo,
                           executors=[], data_by_client={},
                           clients_per_round=1, device="cpu",
                           round_engine=engine, **{knob: object()})
    eng = T.make_engine(engine)
    state = eng.state_dict()
    assert state["mode"] == engine
    eng.load_state_dict(state)
    other = "async" if engine == "semi-sync" else "semi-sync"
    with pytest.raises(ValueError, match=other):
        eng.load_state_dict({"mode": other})


def _chunk_setup(pkg, make, grad, params, n):
    data = make(12, dim=8, n_classes=4, mean_samples=30, batch_size=10,
                seed=1)
    algo = pkg.make_algorithm("fedavg", grad, 0.1)
    tasks = [pkg.ClientTask(c, data[c].n_samples) for c in sorted(data)[:n]]
    payload = algo.broadcast_payload(params, algo.server_init(params))
    return data, algo, tasks, payload


def test_chunked_run_queue_emits_and_merges():
    data, algo, tasks, payload = _chunk_setup(
        T, tclients, TGRAD, {"w": torch.zeros(8, 4), "b": torch.zeros(4)},
        10)
    whole = T.SequentialExecutor(0, algo, device="cpu").run_queue(
        0, tasks, payload, data)
    seen = []
    chunked = T.SequentialExecutor(1, algo, device="cpu").run_queue(
        0, tasks, payload, data, chunk_size=3, on_partial=seen.append)
    assert [r.n_tasks for r in seen] == [3, 3, 3, 1]
    # same clients complete (order differs: signature-blocking is per-chunk)
    assert sorted(chunked.completed_clients) == \
        sorted(whole.completed_clients)
    assert chunked.virtual_time == sum(r.virtual_time for r in seen)
    ops_ = algo.ops()
    a = T.global_aggregate([whole.partial], ops_)
    # the merged chunk partials, and the chunk partials folded one by one,
    # aggregate to the one-span result
    for parts in ([chunked.partial], [r.partial for r in seen]):
        b = T.global_aggregate(parts, ops_)
        for k in a["delta"]:
            torch.testing.assert_close(b["delta"][k], a["delta"][k],
                                       atol=1e-6, rtol=1e-6)
    # and to the JAX package's chunked run
    jdata, jalgo, jtasks, jpayload = _chunk_setup(
        J, jclients, JGRAD, {"w": jnp.zeros((8, 4)), "b": jnp.zeros((4,))},
        10)
    jrep = J.SequentialExecutor(1, jalgo).run_queue(
        0, jtasks, jpayload, jdata, chunk_size=3)
    c = J.global_aggregate([jrep.partial], jalgo.ops())
    _assert_params_close(a["delta"], c["delta"])
    assert chunked.completed_clients == jrep.completed_clients


def test_chunked_fail_at_uses_global_task_index():
    data, algo, tasks, payload = _chunk_setup(
        T, tclients, TGRAD, {"w": torch.zeros(8, 4), "b": torch.zeros(4)}, 8)
    ex = T.SequentialExecutor(0, algo, fail_at=(0, 5), device="cpu")
    seen = []
    with pytest.raises(T.ExecutorFailure) as ei:
        ex.run_queue(0, tasks, payload, data, chunk_size=2,
                     on_partial=seen.append)
    assert ei.value.task_index == 5
    assert ei.value.chunk == (4, 6)
    assert len(seen) == 2          # chunks [0,1] and [2,3] completed first
    # an engine's call with the offset of its dispatch stream
    with pytest.raises(T.ExecutorFailure) as ei:
        ex.run_queue(0, tasks[:2], payload, data, task_offset=4)
    assert ei.value.task_index == 5


def test_state_manager_keeps_bf16_through_disk(tmp_path):
    sm = ClientStateManager(str(tmp_path), memory_budget_bytes=40,
                            shard_clients=1, shard_cache_bytes=30)
    states = {c: {"c_m": {"w": torch.full((4,), 1.5 + c,
                                          dtype=torch.bfloat16),
                          "b": torch.arange(3, dtype=torch.float32) + c}}
              for c in range(6)}
    for c, s in states.items():
        sm.save(c, s)
    assert sm.stats["disk_writes"] > 0
    got = sm.load_many(range(6), device=torch.device("cpu"))
    for c, s in enumerate(got):
        assert s["c_m"]["w"].dtype == torch.bfloat16
        torch.testing.assert_close(s["c_m"]["w"], states[c]["c_m"]["w"],
                                   atol=0, rtol=0)
        torch.testing.assert_close(s["c_m"]["b"], states[c]["c_m"]["b"],
                                   atol=0, rtol=0)
    # re-saving byte-identical state never rewrites it
    for c in range(6):
        sm.save(c, states[c])
    sm.save(99, states[0])
    assert sm.stats["skipped_rewrites"] > 0
    snap = sm.stats_snapshot()
    assert {"mem_bytes", "shard_ram_bytes", "disk_bytes"} <= set(snap)


@pytest.mark.parametrize("fail", [False, True])
def test_parallel_dispatch_matches_serial(fail):
    """Executors in threads (each on its own stream on a card) give the
    serial dispatch's round within 1e-5 (the JAX package's bar,
    ``tests/test_system.py``), an executor failure included."""
    kw = dict(n_clients=40, per_round=12, jax_too=False,
              fail_at=(1, (0, 2)) if fail else None)
    (par, _), = _servers("fedavg", server_kw={"parallel_dispatch": True},
                         **kw)
    (ser, _), = _servers("fedavg", **kw)
    hp, hs = par.run(3), ser.run(3)
    assert [m.n_clients for m in hp] == [m.n_clients for m in hs]
    assert [m.failures for m in hp] == [m.failures for m in hs]
    assert sorted(par.executors) == sorted(ser.executors)
    _assert_params_close(par.params, ser.params)


def test_parallel_dispatch_refuses_nonblocking_cuda_executors():
    algo = T.make_algorithm("fedavg", TGRAD, lr=0.1)
    ex = T.SequentialExecutor(0, algo, device="cpu", nonblocking=True)
    srv = T.ParrotServer(params={"w": torch.zeros(2)}, algorithm=algo,
                         executors=[ex], data_by_client={},
                         clients_per_round=1, device="cpu",
                         parallel_dispatch=True)
    assert srv.parallel_dispatch            # CPU executors: no streams
    ex.device = torch.device("cuda", 0)     # as a card's executor carries
    with pytest.raises(ValueError, match="nonblocking"):
        T.ParrotServer(params={"w": torch.zeros(2)}, algorithm=algo,
                       executors=[ex], data_by_client={},
                       clients_per_round=1, device="cpu",
                       parallel_dispatch=True)


def test_fault_plan_restart_repins_through_the_placement():
    """A fault plan's crash releases executor 2's pin and its restart
    re-pins it through the placement, on the device index the JAX
    package's placement picks; the windows equal JAX's."""
    def plan(pkg):
        from importlib import import_module
        F = import_module(pkg.__name__ + ".faults")
        return F.FaultPlan([F.FaultEvent(time=0.5, kind=F.CRASH, executor=2),
                            F.FaultEvent(time=6.0, kind=F.RESTART,
                                         executor=2)])

    (js, _), (ts, _) = _servers(
        "fedavg", n_clients=40, per_round=8, K=3,
        server_kw={"faults": None})
    builds = []
    for pkg, srv, devs in ((J, js, jax.devices()), (T, ts, ["cpu"])):
        execs = [srv.executors[k] for k in sorted(srv.executors)]
        pl = pkg.DevicePlacement(range(3), devices=devs)
        new = pkg.ParrotServer(
            params=srv.params, algorithm=srv.algorithm, executors=execs,
            data_by_client=srv.data_by_client, clients_per_round=8, seed=0,
            faults=plan(pkg), placement=pl,
            **({} if pkg is J else {"device": "cpu"}))
        pins, inner = [], pl.pin

        def pin(k, _inner=inner, _pins=pins, _devs=pl.devices()):
            d = _inner(k)
            _pins.append((k, _devs.index(d)))
            return d

        pl.pin = pin
        released, rel = [], pl.release
        pl.release = lambda k, _rel=rel, _r=released: (_r.append(k),
                                                       _rel(k))[1]
        builds.append((new, pins, released))
    (jn, jpins, jrel), (tn, tpins, trel) = builds
    for _ in range(6):
        jm, tm = jn.run_round(), tn.run_round()
        assert (tm.makespan, tm.n_executors, tm.failures, tm.extra) == \
            (jm.makespan, jm.n_executors, jm.failures, jm.extra)
    assert trel == jrel == [2]
    assert tpins == jpins == [(2, 0)]
    assert tn.executors[2].device == tn.placement.device(2)
    assert tn.placement.executors() == [0, 1, 2]
    _assert_params_close(tn.params, jn.params)

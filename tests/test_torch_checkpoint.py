"""The port's round checkpoints (``repro_torch.checkpoint``), the engines'
in-flight state and the state manager's checkpoint, restore and re-hashing,
against the JAX package (``tests/test_engine_checkpoint.py``,
``tests/test_state_manager.py``) on the CPU.

Cross-package: ``params_digest`` gives the same hex digest for the same
fp32 and bf16 params in both packages; an uninterrupted checkpointed run
under a ``TickTimer`` has JAX's makespans and cohorts exactly and its
params within 1e-5 (fp32 sums in another order); the state manager's
checkpoint/restore and rebalance load JAX's values.  Within the port: a
restore at round 2 into a fresh server, and a kill mid-round followed by
``run(N, auto_resume=True)``, reproduce the uninterrupted run bit for bit
(params, makespans), under every engine and codec.
"""
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.checkpoint.manager import params_digest as jdigest
from repro.core.state_manager import ClientStateManager as JSM
from repro.core.state_manager import owner_host as jowner
from repro.data import make_classification_clients as jclients
from repro_torch.checkpoint import (CheckpointManager, params_digest,
                                   restore_latest)
from repro_torch.core import tree
from repro_torch.core.state_manager import ClientStateManager as TSM
from repro_torch.data import make_classification_clients as tclients

DIM, HIDDEN, CLASSES = 16, 24, 10


def _jloss(params, batch):
    h = jax.nn.relu(batch["x"] @ params["w0"] + params["b0"])
    logits = h @ params["w1"] + params["b1"]
    lse = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(
        logits, batch["y"][:, None].astype(jnp.int32), axis=-1)[:, 0]
    return jnp.mean(lse - gold)


def _tloss(params, batch):
    h = torch.relu(batch["x"] @ params["w0"] + params["b0"])
    logits = h @ params["w1"] + params["b1"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


JGRAD = jax.jit(jax.value_and_grad(_jloss))
TGRAD = T.value_and_grad(_tloss)


def _np_params():
    rng = np.random.default_rng(0)
    return {"w0": (rng.normal(size=(DIM, HIDDEN)) / np.sqrt(DIM))
            .astype(np.float32),
            "b0": np.zeros(HIDDEN, np.float32),
            "w1": (rng.normal(size=(HIDDEN, CLASSES)) / np.sqrt(HIDDEN))
            .astype(np.float32),
            "b1": np.zeros(CLASSES, np.float32)}


def _build(engine, ckpt_dir=None, compressor=None, pkg=T, n_exec=3,
           **knobs):
    """tests/test_engine_checkpoint.py's ``_build`` in either package."""
    jax_side = pkg is J
    data = (jclients if jax_side else tclients)(
        24, dim=DIM, n_classes=CLASSES, partition="natural",
        partition_arg=5.0, mean_samples=40, batch_size=20, seed=0)
    algo = pkg.make_algorithm("scaffold", JGRAD if jax_side else TGRAD,
                              0.05, local_epochs=1)
    sm = pkg.ClientStateManager(tempfile.mkdtemp(prefix="engckpt_"))
    timer = pkg.TickTimer()
    dev = {} if jax_side else {"device": "cpu"}
    execs = [pkg.SequentialExecutor(k, algo, state_manager=sm, timer=timer,
                                    **dev) for k in range(n_exec)]
    mgr = JCheckpointManager if jax_side else CheckpointManager
    cm = mgr(ckpt_dir, every_rounds=1, keep=10) if ckpt_dir else None
    opts = {"chunk_size": 3} if engine != "bsp" else None
    params = {k: (jnp.asarray(v) if jax_side else torch.from_numpy(v))
              for k, v in _np_params().items()}
    return pkg.ParrotServer(params=params, algorithm=algo, executors=execs,
                            data_by_client=data, clients_per_round=8,
                            round_engine=engine, engine_opts=opts,
                            checkpoint_manager=cm, compressor=compressor,
                            seed=0, **knobs, **dev)


def _bits_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _step(d, rnd):
    return os.path.join(d, "step_%08d" % rnd)


# ---------------------------------------------------------------------------
# the cross-package witness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_digest_equals_jax(dtype):
    """The same params give the same hex digest in both packages: each leaf
    tagged with numpy's dtype name and the shape tuple over its raw bytes,
    in tree order (sorted keys, list order), a 0-d leaf included."""
    rng = np.random.default_rng(3)
    host = {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32),
            "s": np.float32(0.25).reshape(()),
            "blocks": [rng.normal(size=(2, 2)).astype(np.float32),
                       rng.normal(size=(7,)).astype(np.float32)]}
    jt = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), host)
    tt = tree.map(lambda a: torch.from_numpy(np.array(a)).to(
        getattr(torch, dtype)), host)
    assert params_digest(tt) == jdigest(jt)
    # numpy leaves digest as JAX's too
    if dtype == "float32":
        assert params_digest(host) == jdigest(jt)
    # one flipped bit changes it
    tt["b"] = tt["b"].clone()
    tt["b"].view(torch.int16 if dtype == "bfloat16" else torch.int32)[0] ^= 1
    assert params_digest(tt) != jdigest(jt)


@pytest.mark.parametrize("engine", ["bsp", "semi-sync", "async"])
def test_checkpointed_run_matches_jax(engine, tmp_path):
    """The uninterrupted checkpointed run under a TickTimer: JAX's cohorts,
    queues and makespans exactly, params within 1e-5; both packages write
    a step a round with the same layout."""
    runs = {}
    for name, pkg in (("jax", J), ("torch", T)):
        srv = _build(engine, str(tmp_path / name), pkg=pkg)
        seen = []
        inner = srv.scheduler.schedule

        def schedule(rnd, tasks, executors, inner=inner, seen=seen, **kw):
            s = inner(rnd, tasks, executors, **kw)
            seen.append((rnd, [t.client for t in tasks],
                         {k: [t.client for t in q]
                          for k, q in s.assignment.items()}))
            return s

        srv.scheduler.schedule = schedule
        hist = srv.run(4)
        runs[name] = (srv, seen, [m.makespan for m in hist],
                      sorted(os.listdir(tmp_path / name)))
    (js, jseen, jms, jdir), (ts, tseen, tms, tdir) = runs["jax"], \
        runs["torch"]
    assert tseen == jseen
    assert tms == jms
    assert tdir == jdir
    for k in jdir:
        if k.startswith("step_"):
            assert sorted(os.listdir(tmp_path / "torch" / k)) == \
                sorted(os.listdir(tmp_path / "jax" / k))
    for k in js.params:
        np.testing.assert_allclose(ts.params[k].numpy(),
                                   np.asarray(js.params[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# resume within the port, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["async", "semi-sync"])
def test_resume_mid_pipeline_is_bit_exact(engine, tmp_path):
    """Run 5 rounds with per-round checkpoints; restore at round 2 into a
    FRESH server+engine and run the remaining 3 — params and makespans
    must match the uninterrupted run bit for bit (the async restore resumes
    with chunks in flight and a partially-filled fold buffer); the
    estimator's records and fitted models come back as saved."""
    d = str(tmp_path / "ck")
    a = _build(engine, ckpt_dir=d)
    for _ in range(5):
        a.run_round()
    b = _build(engine)
    CheckpointManager(d).restore(b, _step(d, 2))
    assert b.round == 2
    with open(os.path.join(_step(d, 2), "server.pkl"), "rb") as f:
        blob = pickle.load(f)
    assert dict(b.estimator._records) == blob["estimator_records"]
    assert b.estimator.last_fit == blob["estimator_fit"]
    for _ in range(3):
        b.run_round()
    _bits_equal(a.params, b.params)
    _bits_equal(a.server_state["c"], b.server_state["c"])
    assert [m.makespan for m in a.history[2:]] == \
        [m.makespan for m in b.history[2:]]
    assert [m.n_clients for m in a.history] == \
        [m.n_clients for m in b.history]


@pytest.mark.parametrize("engine,comp", [("bsp", "topk"),
                                         ("semi-sync", "topk"),
                                         ("async", "topk"),
                                         ("async", "powersgd")])
def test_resume_under_compression_is_bit_exact(engine, comp, tmp_path):
    """Compressor state (top-k error-feedback residuals / PowerSGD P-Q warm
    starts) rides in the checkpoint blob: a restore-at-round-2 resume must
    match the uninterrupted run bit for bit under a stateful compressor,
    and without the blob's entry the resumed run diverges."""
    def mk():
        return T.make_compressor(comp, 0.25, rank=2)

    d = str(tmp_path / "ck")
    a = _build(engine, ckpt_dir=d, compressor=mk())
    for _ in range(5):
        a.run_round()
    b = _build(engine, compressor=mk())
    CheckpointManager(d).restore(b, _step(d, 2))
    assert b.round == 2
    for _ in range(3):
        b.run_round()
    _bits_equal(a.params, b.params)
    # the same restore with the codec's state dropped: residuals restart
    # from zero and the params no longer match
    c = _build(engine, compressor=mk())
    CheckpointManager(d).restore(c, _step(d, 2))
    c.compressor.load_state_dict(None)
    for _ in range(3):
        c.run_round()
    assert any(not torch.equal(a.params[k], c.params[k]) for k in a.params)


def test_async_state_dict_captures_pipeline():
    srv = _build("async")
    srv.run_round()
    state = srv.engine.state_dict()
    assert state["initialized"] and state["mode"] == "async"
    # something is genuinely in flight at an update boundary
    assert state["clock"]["events"]
    assert any(es["inflight"] for es in state["states"].values())
    assert any(kind == "chunk_done"
               for _, _, kind, _ in state["clock"]["events"])
    # host-resident: every tensor in the blob is a CPU tensor, and the
    # partials are copies, not the live buffers
    live = {id(t) for _, _, kind, data in
            srv.engine._clock.state_dict()["events"] if kind == "chunk_done"
            for t in tree.leaves(data[1].partial)
            if isinstance(t, torch.Tensor)}
    tensors = []
    for _, _, kind, data in state["clock"]["events"]:
        if kind == "chunk_done":
            tensors += [t for t in tree.leaves(data[1].partial)
                        if isinstance(t, torch.Tensor)]
    tensors += [t for t in tree.leaves(state["payload"])
                if isinstance(t, torch.Tensor)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    assert not live & {id(t) for t in tensors}
    pickle.loads(pickle.dumps(state))


def test_mode_mismatch_rejected():
    a = _build("async")
    a.run_round()
    b = _build("semi-sync")
    with pytest.raises(ValueError):
        b.engine.load_state_dict(a.engine.state_dict())
    with pytest.raises(ValueError):
        a.engine.load_state_dict(b.engine.state_dict())


def test_bsp_engine_state_is_none_and_restores():
    srv = _build("bsp")
    assert srv.engine.state_dict() is None
    srv.engine.load_state_dict(None)        # no-op
    with pytest.raises(ValueError):
        srv.engine.load_state_dict({"mode": "async", "initialized": True})


# ---------------------------------------------------------------------------
# crash-consistent auto-resume: kill the process mid-round, then
# ``run(N, auto_resume=True)`` on a fresh server must land on the
# uninterrupted run's exact params, without and under a fault plan
# ---------------------------------------------------------------------------

def _lin_loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


LIN_GRAD = T.value_and_grad(_lin_loss)


def _kill_build(engine, ckpt_dir, **knobs):
    data = tclients(30, dim=8, n_classes=4, mean_samples=30, batch_size=10,
                    seed=1)
    algo = T.make_algorithm("fedavg", grad_fn=LIN_GRAD, lr=0.1,
                            local_steps=2)
    sm = T.ClientStateManager(tempfile.mkdtemp(prefix="killckpt_"))
    execs = [T.SequentialExecutor(k, algo, state_manager=sm,
                                  timer=T.TickTimer(1.0), device="cpu")
             for k in range(3)]
    opts = {"chunk_size": 2} if engine != "bsp" else None
    return T.ParrotServer(params={"w": torch.zeros(8, 4),
                                  "b": torch.zeros(4)},
                          algorithm=algo, executors=execs,
                          data_by_client=data, clients_per_round=8, seed=7,
                          round_engine=engine, engine_opts=opts,
                          device="cpu", **knobs,
                          checkpoint_manager=CheckpointManager(
                              ckpt_dir, every_rounds=1, keep=10))


def _kill_and_resume(engine, tmp_path, N, knobs=dict):
    """An uninterrupted N-round reference, the same run killed mid-round,
    and a fresh server's ``run(N, auto_resume=True)``: (ref, resumed,
    the resumed run's history).  ``knobs()`` builds each server's
    network / fault kwargs afresh."""
    ref = _kill_build(engine, str(tmp_path / "ref"), **knobs())
    ex0 = ref.executors[0]
    real, calls = ex0.run_queue, [0]

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    ex0.run_queue = counting
    ref.run(N)

    # the same run, killed mid-round: executor 0's run_queue raises
    # KeyboardInterrupt at 5/8 of its calls, after some durable
    # checkpoints exist — a process kill between two saves
    kill_at = calls[0] * 5 // 8
    d = str(tmp_path / "ck")
    victim = _kill_build(engine, d, **knobs())
    ex0 = victim.executors[0]
    real, calls = ex0.run_queue, [0]

    def dying(*a, **kw):
        calls[0] += 1
        if calls[0] >= kill_at:
            raise KeyboardInterrupt
        return real(*a, **kw)

    ex0.run_queue = dying
    with pytest.raises(KeyboardInterrupt):
        victim.run(N)
    assert 1 <= victim.round < N        # the kill landed mid-run

    resumed = _kill_build(engine, d, **knobs())
    hist = resumed.run(N, auto_resume=True)
    assert resumed.round == N
    assert params_digest(resumed.params) == params_digest(ref.params)
    assert len(hist) == N
    assert [m.makespan for m in hist] == [m.makespan for m in ref.history]
    assert [m.n_clients for m in hist] == [m.n_clients for m in ref.history]
    return ref, resumed, hist


@pytest.mark.parametrize("engine", ["bsp", "semi-sync", "async"])
def test_kill_mid_round_then_auto_resume_is_bit_exact(engine, tmp_path):
    _kill_and_resume(engine, tmp_path, 8)


def _chaos_knobs(pkg=T):
    """tests/test_engine_checkpoint.py:176's plan, a network and a retry
    policy: every fault kind, and restarts that revive crashed executors."""
    return {"faults": pkg.FaultPlan.random(
                seed=3, horizon=80.0, executors=[0, 1, 2],
                clients=list(range(30)), crash_rate=0.05, restart_delay=5.0,
                dropout_rate=0.1, dropout_duration=4.0, corrupt_rate=0.05,
                blackout_rate=0.03, blackout_duration=1.0,
                slowdown_rate=0.03, slowdown_duration=6.0),
            "retry": pkg.RetryPolicy(timeout_s=3.0, max_retries=2,
                                     backoff_s=0.5),
            "network": pkg.NetworkModel.uniform(8e6, 16e6, latency_s=0.05)}


_FAULT_KEYS = ("retries", "corrupt_payloads", "dropped_clients",
               "fault_crashes", "fault_restarts", "chunk_timeouts",
               "comm_time_up", "comm_time_down", "comm_wire_bytes")


@pytest.mark.parametrize("engine", ["bsp", "semi-sync", "async"])
def test_kill_under_a_fault_plan_then_auto_resume_is_bit_exact(engine,
                                                               tmp_path):
    """The kill and auto-resume under a seeded chaos plan with a network:
    params digest, makespans, cohorts, fault counters and comm keys equal
    the uninterrupted run's, and the plan's restarts revived executors."""
    ref, resumed, hist = _kill_and_resume(engine, tmp_path, 10,
                                          _chaos_knobs)
    assert [{k: m.extra.get(k) for k in _FAULT_KEYS} for m in hist] == \
        [{k: m.extra.get(k) for k in _FAULT_KEYS} for m in ref.history]
    assert resumed.faults.state_dict() == ref.faults.state_dict()
    assert resumed.virtual_now == ref.virtual_now
    assert sum(m.extra.get("fault_restarts", 0.0) for m in ref.history) >= 1
    assert sum(m.extra.get("fault_crashes", 0.0) for m in ref.history) >= 1


def test_blob_carries_the_fault_and_network_entries(tmp_path):
    """The blob's ``faults`` (the injector's state), ``last_payload_nbytes``
    and ``wire_ratio`` equal the JAX package's blob after the same rounds,
    and restore onto a fresh server as the JAX package restores them."""
    blobs, servers = [], []
    for pkg in (J, T):
        d = str(tmp_path / pkg.__name__)
        srv = _build("async", d, "topk", pkg, **_chaos_knobs(pkg))
        srv.run(4)
        with open(os.path.join(_step(d, 4), "server.pkl"), "rb") as f:
            blobs.append(pickle.load(f))
        servers.append(srv)
    (jb, tb), srv = blobs, servers[1]
    for key in ("faults", "last_payload_nbytes", "wire_ratio",
                "virtual_now"):
        assert tb[key] == jb[key], key
    assert tb["faults"] == srv.faults.state_dict() and tb["faults"]["fired"]
    assert tb["last_payload_nbytes"] > 0 and tb["wire_ratio"] < 1.0
    d = str(tmp_path / T.__name__)
    fresh = _build("async", None, "topk", T, **_chaos_knobs(T))
    CheckpointManager(d).restore(fresh, _step(d, 4))
    assert fresh.faults.state_dict() == srv.faults.state_dict()
    assert fresh._last_payload_nbytes == srv._last_payload_nbytes
    assert fresh._wire_ratio == srv._wire_ratio
    state = fresh.engine.state_dict()
    assert state["counters"] == srv.engine.state_dict()["counters"]


def test_auto_resume_needs_a_checkpoint_manager():
    srv = _build("bsp")
    with pytest.raises(ValueError, match="checkpoint_manager"):
        srv.run(2, auto_resume=True)


# ---------------------------------------------------------------------------
# integrity: torn and corrupt steps
# ---------------------------------------------------------------------------

def test_torn_step_is_skipped(tmp_path):
    d = str(tmp_path / "ck")
    srv = _build("bsp", ckpt_dir=d)
    srv.run(3)
    # the newest step lost its manifest (a crash before the last write)
    os.unlink(os.path.join(_step(d, 3), "MANIFEST.json"))
    fresh = _build("bsp")
    assert restore_latest(fresh, d) == 2
    assert fresh.round == 2


def test_restore_rejects_corrupt_blob_and_walks_back(tmp_path):
    d = str(tmp_path / "ck")
    srv = _build("bsp", ckpt_dir=d)
    srv.run(3)
    want = params_digest(srv.params)
    newest = _step(d, 3)
    blob_path = os.path.join(newest, "server.pkl")
    with open(blob_path, "rb") as f:
        blob = pickle.load(f)
    blob["params"] = {k: v + 1.0 for k, v in blob["params"].items()}
    with open(blob_path, "wb") as f:
        pickle.dump(blob, f)
    # a direct restore refuses and leaves the server untouched
    fresh = _build("bsp")
    before = params_digest(fresh.params)
    with pytest.raises(ValueError, match="integrity"):
        CheckpointManager(d).restore(fresh, newest)
    assert params_digest(fresh.params) == before and fresh.round == 0
    # restore_latest walks back to the newest valid step (round 2) ...
    assert restore_latest(fresh, d) == 2
    # ... and replaying the final round reproduces the uninterrupted run
    fresh.run_round()
    assert params_digest(fresh.params) == want


def test_keep_bounds_the_steps_and_latest_names_the_newest(tmp_path):
    d = str(tmp_path / "ck")
    srv = _build("bsp")
    srv.checkpoint_manager = CheckpointManager(d, every_rounds=2, keep=2)
    srv.run(7)
    assert sorted(s for s in os.listdir(d) if s.startswith("step_")) == \
        ["step_00000004", "step_00000006"]
    assert open(os.path.join(d, "LATEST")).read() == "step_00000006"


# ---------------------------------------------------------------------------
# examples/stateful_scaffold.py: restore an 8-executor checkpoint into a
# 7-executor server after executor 5 failed
# ---------------------------------------------------------------------------

def _scaffold_server(n_exec, work, tag, ckpt=None, fail=False):
    data = tclients(1000, dim=16, n_classes=8, mean_samples=30, seed=0)
    algo = T.make_algorithm("scaffold", LIN_GRAD, lr=0.1)
    sm = T.ClientStateManager(os.path.join(work, tag),
                              memory_budget_bytes=8 * 2048)
    timer = T.TickTimer(1.0)
    execs = [T.SequentialExecutor(k, algo, state_manager=sm, timer=timer,
                                  device="cpu") for k in range(n_exec)]
    if fail:
        execs[5].fail_at = (3, 2)      # executor 5 dies in round 3
    cm = CheckpointManager(ckpt, every_rounds=2) if ckpt else None
    return T.ParrotServer(params={"w": torch.zeros(16, 8),
                                  "b": torch.zeros(8)},
                          algorithm=algo, executors=execs,
                          data_by_client=data, clients_per_round=50, seed=0,
                          device="cpu", checkpoint_manager=cm), sm


def test_stateful_scaffold_restores_into_seven_executors(tmp_path):
    work, ckpt = str(tmp_path), str(tmp_path / "ckpt")
    srv, sm = _scaffold_server(8, work, "state", ckpt, fail=True)
    hist = srv.run(6)
    assert hist[3].failures == 1 and hist[4].n_executors == 7
    assert sm.stats["spills"] > 0
    assert sorted(srv.executors) == [0, 1, 2, 3, 4, 6, 7]
    srv2, sm2 = _scaffold_server(7, work, "state2")
    assert restore_latest(srv2, ckpt) == 6
    # 5 retired (failed at save time); 7 cannot be conjured
    assert sorted(srv2.executors) == [0, 1, 2, 3, 4, 6]
    assert sorted(srv2._retired) == [5]
    assert sm2.known_clients() == sm.known_clients()
    for c in sm.known_clients()[:20]:
        for x, y in zip(tree.leaves(sm.load(c)), tree.leaves(sm2.load(c))):
            assert torch.equal(x, y)
    _bits_equal(srv2.params, srv.params)
    h2 = srv2.run(2)
    assert [m.n_executors for m in h2] == [6, 6]
    assert all(torch.isfinite(v).all() for v in srv2.params.values())


def test_revived_executor_rejoins_in_sorted_order():
    """A retired executor revived later sits in its canonical place in the
    live order (dispatch and fold order must not depend on crash
    history); an unknown or live id is not revivable."""
    srv = _build("bsp", n_exec=4)
    assert list(srv.executors) == [0, 1, 2, 3]
    srv._drop_executor(1)
    srv._drop_executor(2)
    assert list(srv.executors) == [0, 3] and sorted(srv._retired) == [1, 2]
    assert srv._revive_executor(2)
    assert list(srv.executors) == [0, 2, 3]
    assert srv._revive_executor(1)
    assert list(srv.executors) == [0, 1, 2, 3] and not srv._retired
    assert not srv._revive_executor(1) and not srv._revive_executor(9)
    srv.run(1)                              # the revived set runs


# ---------------------------------------------------------------------------
# the state manager's checkpoint, restore and rebalance against JAX's
# (tests/test_state_manager.py:73 and :95)
# ---------------------------------------------------------------------------

def _state(i, size=100):
    rng = np.random.default_rng(i)
    return {"c": rng.normal(size=(size,)).astype(np.float32),
            "step": np.int32(i)}


def _tstate(i):
    return {k: torch.from_numpy(np.array(v)) for k, v in _state(i).items()}


def test_state_checkpoint_restore_roundtrip_matches_jax(tmp_path):
    got = {}
    for name, mk, st in (("jax", JSM, _state), ("torch", TSM, _tstate)):
        sm = mk(str(tmp_path / name / "a"), memory_budget_bytes=2 * 420)
        for i in range(8):
            sm.save(i, st(i))
        ck = str(tmp_path / name / "ck")
        sm.checkpoint(ck)
        with open(os.path.join(ck, "state_manifest_0.json")) as f:
            manifest = f.read()
        sm2 = mk(str(tmp_path / name / "b"))
        assert sm2.restore(ck) == 8
        got[name] = (manifest, [np.asarray(sm2.load(i)["c"])
                                for i in range(8)],
                     sorted(os.listdir(ck)))
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][2] == got["jax"][2]
    for a, b in zip(got["torch"][1], got["jax"][1]):
        np.testing.assert_array_equal(a, b)


def test_state_checkpoint_is_incremental_and_restores_in_place(tmp_path):
    """A second checkpoint hard-links the clean shards (no rewrite of
    byte-identical state); a restore into the same spill directory, where
    source and destination are one inode, keeps every state; a later
    round's leftovers are dropped (adopt exactly)."""
    spill = str(tmp_path / "spill")
    sm = TSM(spill, memory_budget_bytes=2 * 420, shard_clients=4)
    for i in range(12):
        sm.save(i, _tstate(i))
    ck1 = str(tmp_path / "ck1")
    sm.checkpoint(ck1)
    writes = sm.stats["disk_writes"]
    ck2 = str(tmp_path / "ck2")
    sm.checkpoint(ck2)                   # nothing dirty: links only
    assert sm.stats["disk_writes"] == writes
    for f in os.listdir(ck2):
        if f.startswith("shard_"):
            assert os.path.samefile(os.path.join(ck1, f),
                                    os.path.join(ck2, f))
    sm.save(20, _tstate(20))             # a leftover after the checkpoint
    assert sm.restore(ck1) == 12
    assert sm.load(20) is None
    for i in range(12):
        np.testing.assert_array_equal(sm.load(i)["c"].numpy(),
                                      _state(i)["c"])


def test_rebalance_moves_states_like_jax(tmp_path):
    moved = {}
    for name, mk, st in (("jax", JSM, _state), ("torch", TSM, _tstate)):
        d = tmp_path / name
        mgrs = {h: mk(f"{d}/h{h}", host=h, n_hosts=2) for h in range(2)}
        for c in range(40):
            mgrs[jowner(c, 2)].save(c, st(c))
        for h in (2, 3):
            mgrs[h] = mk(f"{d}/h{h}", host=h, n_hosts=4)
        moved[name] = [mgrs[h].rebalance(4, mgrs) for h in (0, 1)]
        for c in range(40):
            got = mgrs[jowner(c, 4)].load(c)
            assert got is not None
            np.testing.assert_array_equal(np.asarray(got["c"]),
                                          _state(c)["c"])
        moved[name].append([sorted(mgrs[h].known_clients())
                            for h in range(4)])
    assert moved["torch"] == moved["jax"]
    assert sum(moved["torch"][:2]) > 0

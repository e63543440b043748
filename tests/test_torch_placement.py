"""Device placement, gang dispatch and the rank-ordered global fold of the
port (``repro_torch.core.placement``, ``executor.run_queues_ganged``)
against the JAX package's.

The placement bookkeeping, the global fold, the device-keyed caches and the
gang's refusals run in-process on the CPU (the CPU and the ``meta`` device
stand in for two devices where only the map is exercised).  The parity
matrix needs the JAX gang on four devices, and the device count is frozen
when JAX starts its backend, so the JAX side runs in a child process with
``--xla_force_host_platform_device_count=4`` — this file itself, as
``python tests/test_torch_placement.py --jax-child OUT.npz`` — while the
port runs the same rounds in-process on one CPU device, four executors
ganged into one vmap a wave, under a ``TickTimer``.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import repro_torch.core as T                                  # noqa: E402
from repro_torch.core import client_step, tree                # noqa: E402
from repro_torch.core.executor import run_queues_ganged       # noqa: E402
from repro_torch.core.flat import FlatLayout, flat_sums       # noqa: E402
from repro_torch.core.placement import (colocate,             # noqa: E402
                                        rank_ordered_reduce)
from repro_torch.kernels import ops                           # noqa: E402

CPU = torch.device("cpu")
META = torch.device("meta")

# ---------------------------------------------------------------------------
# shared workload: numpy data and params, one MLP loss in each package
# ---------------------------------------------------------------------------

ALGOS = ("fedavg", "fedprox", "scaffold")
# (scheduler policy, speed ratios, clients a round, client block): LPT with
# homogeneous executors, and a uniform split under fixed slowdowns with two
# waves an executor (the makespans then differ by executor)
CONFIGS = {"lpt": ("parrot", None, 8, 8),
           "hetero": ("uniform", {0: 0.0, 1: 0.5, 2: 1.0, 3: 3.0}, 16, 2)}
ROUNDS = 4


def _data(n=24, samples=40, batch=20, dim=16, seed=0):
    """Equal-size clients: every executor's queue plans into aligned
    block waves."""
    rng = np.random.default_rng(seed)
    out = {}
    for c in range(n):
        ys = rng.integers(0, 10, size=samples).astype(np.int32)
        xs = rng.normal(size=(samples, dim)).astype(np.float32)
        out[c] = [{"x": xs[i:i + batch], "y": ys[i:i + batch]}
                  for i in range(0, samples, batch)]
    return out


def _params_np(dim=16, hidden=32, classes=10, seed=1):
    rng = np.random.default_rng(seed)
    return {"w0": (rng.normal(size=(dim, hidden)) / 4).astype(np.float32),
            "b0": np.zeros(hidden, np.float32),
            "w1": (rng.normal(size=(hidden, classes)) / 6).astype(np.float32),
            "b1": np.zeros(classes, np.float32)}


def _tloss(params, batch):
    h = torch.relu(batch["x"] @ params["w0"] + params["b0"])
    logits = h @ params["w1"] + params["b1"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


TGRAD = T.value_and_grad(_tloss)


def _port_server(name, config, *, placement=True, nonblocking=False,
                 **server_kw):
    policy, ratios, per_round, block = CONFIGS[config]
    algo = T.make_algorithm(name, TGRAD, 0.05, local_epochs=1)
    sm = T.ClientStateManager(tempfile.mkdtemp(prefix="tplace_"))
    timer = T.TickTimer()
    speed = T.hetero_gpus(ratios) if ratios else T.homogeneous
    execs = [T.SequentialExecutor(k, algo, state_manager=sm, timer=timer,
                                  speed_model=speed, client_block=block,
                                  nonblocking=nonblocking, device="cpu")
             for k in range(4)]
    data = {c: T.ClientData(batches=b, n_samples=40)
            for c, b in _data().items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in _params_np().items()}
    pl = T.DevicePlacement(range(4), devices=["cpu"]) if placement else None
    return T.ParrotServer(params=params, algorithm=algo, executors=execs,
                          data_by_client=data, clients_per_round=per_round,
                          scheduler_policy=policy, seed=0, device="cpu",
                          placement=pl, **server_kw)


def _record_schedules(srv):
    seen = []
    inner = srv.scheduler.schedule

    def schedule(rnd, tasks, executors, **kw):
        s = inner(rnd, tasks, executors, **kw)
        seen.append([[int(t.client) for t in s.assignment.get(k, [])]
                     for k in sorted(s.assignment)])
        return s

    srv.scheduler.schedule = schedule
    return seen


def _jax_child(out_path):
    """The JAX side of the parity matrix: 4 host devices, one executor
    each, the gang on; writes schedules, makespans, timer calls, gang
    dispatches and params of every (algorithm, config) cell."""
    import jax
    import jax.numpy as jnp
    import repro.core as J
    from repro.core import client_step as jcs

    assert len(jax.devices()) == 4, jax.devices()

    def loss(params, batch):
        h = jax.nn.relu(batch["x"] @ params["w0"] + params["b0"])
        logits = h @ params["w1"] + params["b1"]
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(
            logits, batch["y"][:, None].astype(jnp.int32), axis=-1)[:, 0]
        return jnp.mean(lse - gold)

    grad = jax.jit(jax.value_and_grad(loss))
    meta, arrays = {}, {}
    for name in ALGOS:
        for config, (policy, ratios, per_round, block) in CONFIGS.items():
            algo = J.make_algorithm(name, grad, 0.05, local_epochs=1)
            sm = J.ClientStateManager(tempfile.mkdtemp(prefix="jplace_"))
            timer = J.TickTimer()
            speed = (J.executor.hetero_gpus(ratios) if ratios
                     else J.executor.homogeneous)
            execs = [J.SequentialExecutor(
                k, algo, state_manager=sm, timer=timer, speed_model=speed,
                client_block=block, device=jax.devices()[k])
                for k in range(4)]
            data = {c: J.ClientData(batches=b, n_samples=40)
                    for c, b in _data().items()}
            srv = J.ParrotServer(
                params={k: jnp.asarray(v) for k, v in _params_np().items()},
                algorithm=algo, executors=execs, data_by_client=data,
                clients_per_round=per_round, scheduler_policy=policy,
                seed=0, placement=J.DevicePlacement(range(4)))
            sched = _record_schedules(srv)
            hist = [srv.run_round() for _ in range(ROUNDS)]
            key = f"{name}/{config}"
            meta[key] = {"schedules": sched,
                         "makespans": [m.makespan for m in hist],
                         "timer_calls": timer.now,
                         "gang_dispatches": jcs.engine_for(algo).n_dispatches}
            for p, v in srv.params.items():
                arrays[f"{key}/{p}"] = np.asarray(v)
    np.savez(out_path, meta=json.dumps(meta), **arrays)


@pytest.fixture(scope="module")
def jax_gang(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_gang") / "gang.npz")
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


# ---------------------------------------------------------------------------
# the parity matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", ALGOS)
def test_gang_matches_jax_four_device_gang(jax_gang, name, config):
    """The port's ganged BSP rounds (one CPU device, four executors, one
    vmap a wave) equal the JAX package's 4-device gang: schedules,
    makespans and timer calls exactly, params within 1e-5."""
    meta, arrays = jax_gang
    ref = meta[f"{name}/{config}"]
    srv = _port_server(name, config)
    sched = _record_schedules(srv)
    eng = client_step.engine_for(srv.algorithm, CPU)
    hist = [srv.run_round() for _ in range(ROUNDS)]
    timer = srv.executors[0].timer
    assert sched == ref["schedules"]
    assert [m.makespan for m in hist] == ref["makespans"]
    assert timer.now == ref["timer_calls"]      # a wave's calls, re-run too
    # the gang fired every wave on both sides: one dispatch a wave plus one
    # first-seen re-run
    assert eng.n_dispatches == ref["gang_dispatches"]
    for p, v in srv.params.items():
        np.testing.assert_allclose(v.numpy(), arrays[f"{name}/{config}/{p}"],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", ALGOS)
def test_gang_equals_serial_bit_for_bit_on_the_cpu(name, config):
    """Within the port on the CPU the gang is bit-exact against the
    per-executor dispatch (one (K·B)-client vmap gives each client the
    bits of a B-client vmap), makespans equal; the gang makes one
    client-step dispatch a wave where the serial path makes one a
    block."""
    gang, serial = _port_server(name, config), _port_server(
        name, config, gang_dispatch=False)
    eng_g = client_step.engine_for(gang.algorithm, CPU)
    eng_s = client_step.engine_for(serial.algorithm, CPU)
    hg = [gang.run_round() for _ in range(ROUNDS)]
    hs = [serial.run_round() for _ in range(ROUNDS)]
    assert [m.makespan for m in hg] == [m.makespan for m in hs]
    for p in gang.params:
        assert torch.equal(gang.params[p], serial.params[p]), p
    _, _, per_round, block = CONFIGS[config]
    waves = ROUNDS * -(-(per_round // 4) // block)
    assert eng_g.n_dispatches == waves + 1           # + the first re-run
    assert eng_s.n_dispatches > eng_g.n_dispatches


@pytest.mark.parametrize("gang", [True, False])
def test_nonblocking_executors_match_blocking(gang):
    """Nonblocking executors (cached block or wave costs, the work left in
    flight) make the same timer calls, makespans and params as blocking
    ones, ganged or not."""
    a = _port_server("fedprox", "hetero", gang_dispatch=gang)
    b = _port_server("fedprox", "hetero", gang_dispatch=gang,
                     nonblocking=True)
    ha = [a.run_round() for _ in range(ROUNDS)]
    hb = [b.run_round() for _ in range(ROUNDS)]
    assert [m.makespan for m in ha] == [m.makespan for m in hb]
    assert a.executors[0].timer.now == b.executors[0].timer.now
    for p in a.params:
        assert torch.equal(a.params[p], b.params[p])
    if gang:
        assert b.placement._gang_cost     # the steady waves' cached cost
    else:
        assert all(ex._block_cost for ex in b.executors.values())


def test_nonblocking_defaults_off():
    algo = T.make_algorithm("fedavg", TGRAD, 0.1)
    assert T.SequentialExecutor(0, algo, device="cpu").nonblocking is False
    assert T.SequentialExecutor(0, algo, device="cpu",
                                nonblocking=True).nonblocking is True


# ---------------------------------------------------------------------------
# gang refusals
# ---------------------------------------------------------------------------

def _gang_setup(K=4, n_batches=None, **exec_kw):
    algo = T.make_algorithm("fedavg", TGRAD, 0.05)
    timer = T.TickTimer()
    execs = {k: T.SequentialExecutor(k, algo, timer=timer, device="cpu",
                                     **exec_kw) for k in range(K)}
    raw = _data()
    if n_batches is not None:
        raw = {c: b[:n_batches.get(c, len(b))] for c, b in raw.items()}
    data = {c: T.ClientData(batches=b, n_samples=20 * len(b))
            for c, b in raw.items()}
    queues = {k: [T.ClientTask(c, data[c].n_samples)
                  for c in (2 * k, 2 * k + 1)] for k in range(K)}
    params = {k: torch.from_numpy(v) for k, v in _params_np().items()}
    payload = algo.broadcast_payload(params, algo.server_init(params))
    placement = T.DevicePlacement(range(K), devices=["cpu"])
    return execs, queues, payload, data, placement


def test_gang_runs_on_aligned_waves():
    execs, queues, payload, data, pl = _gang_setup()
    reps = run_queues_ganged(execs, 0, queues, payload, data, pl)
    assert reps is not None and sorted(reps) == [0, 1, 2, 3]
    assert [reps[k].completed_clients for k in range(4)] == \
        [[2 * k, 2 * k + 1] for k in range(4)]
    assert reps[0].compiles >= 1 and reps[1].compiles == 0


@pytest.mark.parametrize("case", [
    "no_placement", "one_executor", "ragged_client", "fail_at",
    "private_timers", "mixed_devices", "unaligned_waves", "two_algorithms",
    "eager_steps"])
def test_gang_refusals_return_none(case):
    """Each gate of ``run_queues_ganged`` refuses the round (the caller
    then dispatches per executor)."""
    execs, queues, payload, data, pl = _gang_setup()
    if case == "no_placement":
        pl = None
    elif case == "one_executor":
        queues = {0: queues[0]}
    elif case == "ragged_client":
        c = queues[1][0].client
        data[c] = T.ClientData(batches=[data[c].batches[0],
                                        {k: v[:7] for k, v in
                                         data[c].batches[1].items()}],
                               n_samples=27)
    elif case == "fail_at":
        execs[2].fail_at = (0, 1)
    elif case == "private_timers":
        execs[3].timer = T.TickTimer()
    elif case == "mixed_devices":
        execs[3].set_device(META)
    elif case == "unaligned_waves":
        queues[1] = queues[1] + [T.ClientTask(20, 40)]
    elif case == "two_algorithms":
        execs[1].algorithm = T.make_algorithm("fedavg", TGRAD, 0.05)
    elif case == "eager_steps":
        execs[0].use_compiled_steps = False
    assert run_queues_ganged(execs, 0, queues, payload, data, pl) is None


def test_gang_refuses_mismatched_buckets():
    """Waves whose blocks fall in different padded-B buckets are not
    aligned (LPT's uneven queue lengths)."""
    execs, queues, payload, data, pl = _gang_setup()
    for k in execs:
        execs[k].client_block = 8
    queues[0] = queues[0] + [T.ClientTask(c, 40) for c in (16, 17, 18)]
    assert run_queues_ganged(execs, 0, queues, payload, data, pl) is None


def test_engine_refuses_a_device_mix():
    algo = T.make_algorithm("fedavg", TGRAD, 0.05)
    eng = client_step.engine_for(algo, CPU)
    b = {"x": torch.zeros(1, 2, 3)}
    preps = [(b, torch.zeros(1, 2)), (b, torch.zeros(1, 2)),
             ({"x": torch.zeros(1, 2, 3, device=META)},
              torch.zeros(1, 2, device=META))]
    with pytest.raises(ValueError, match="mix"):
        eng.run_blocks_ganged({}, preps)


# ---------------------------------------------------------------------------
# placement bookkeeping against the JAX package (fake JAX devices by id)
# ---------------------------------------------------------------------------

def _jax_placement(ids, n_dev):
    from repro.core.placement import DevicePlacement as JP
    devs = [types.SimpleNamespace(id=i) for i in range(n_dev)]
    return JP(ids, devices=devs), devs


def _index_map(pl, devs, key):
    return {k: [key(d) for d in devs].index(key(pl.device(k)))
            for k in pl.executors()}


def test_placement_bookkeeping_matches_jax():
    """Round robin, release, least-loaded pin (ties on placement order) and
    round-robin ``fail_device`` pick the same device index in both
    packages."""
    tdevs = [CPU, META]
    tp = T.DevicePlacement(range(5), devices=tdevs)
    jp, jdevs = _jax_placement(range(5), 2)
    tkey, jkey = (lambda d: d), (lambda d: d.id)
    steps = [("release", 1), ("pin", 7), ("pin", 1), ("release", 0),
             ("release", 2), ("pin", 0), ("fail", 0), ("pin", 9)]
    for op, arg in steps:
        if op == "release":
            tp.release(arg)
            jp.release(arg)
        elif op == "pin":
            assert tdevs.index(tp.pin(arg)) == jdevs.index(jp.pin(arg))
        else:
            assert tp.fail_device(tdevs[arg]) == jp.fail_device(jdevs[arg])
        assert _index_map(tp, tdevs, tkey) == _index_map(jp, jdevs, jkey)
        assert tp.n_devices == jp.n_devices
        assert [tdevs.index(d) for d in tp.devices()] == \
            [jdevs.index(d) for d in jp.devices()]


def test_placement_round_robin_and_release():
    pl = T.DevicePlacement(range(5), devices=["cpu", "meta"])
    for k in range(5):
        assert pl.device(k) == [CPU, META][k % 2]
    assert pl.server_device == CPU
    pl.release(0)
    assert 0 not in pl.executors()
    assert pl.devices() == [META, CPU]        # first-pinned order


def test_placement_from_pins_preserves_map():
    pl = T.DevicePlacement.from_pins({7: "cpu", 3: "meta"})
    assert pl.device(7) == CPU and pl.device(3) == META
    assert pl.executors() == [3, 7]
    assert pl.devices() == [META, CPU] and pl.server_device == META


def test_fail_device_repins_or_raises():
    pl = T.DevicePlacement(range(4), devices=["cpu"])
    with pytest.raises(RuntimeError):
        pl.fail_device(CPU)
    pl = T.DevicePlacement(range(4), devices=["cpu", "meta"])
    assert pl.fail_device(META) == [1, 3]
    assert all(pl.device(k) == CPU for k in range(4))


def test_placement_needs_a_device_and_resolves_cuda():
    with pytest.raises(ValueError):
        T.DevicePlacement(range(2), devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            T.DevicePlacement(range(2), devices=["cuda"])
        with pytest.raises(ValueError):            # no CUDA device: no pin
            T.DevicePlacement(range(2))


def test_colocate_moves_only_when_needed():
    a = torch.ones(3)
    assert colocate(a, a) is a
    moved = colocate(a, torch.ones(1, device=META))
    assert moved.device == META
    assert colocate(3.0, a) == 3.0


# ---------------------------------------------------------------------------
# the global fold
# ---------------------------------------------------------------------------

def _flat_partials(K, seed=0, neg_zero=False):
    from repro.core.aggregation import Op as JOp
    ops_t = {"delta": T.Op.WEIGHTED_AVG, "count": T.Op.SUM}
    ops_j = {"delta": JOp.WEIGHTED_AVG, "count": JOp.SUM}
    layout = FlatLayout.build(ops_t, {"delta": {"w": torch.zeros(12)},
                                      "count": torch.zeros(())})
    rng = np.random.default_rng(seed)
    bufs = []
    for i in range(K):
        w = (rng.standard_normal(12) * 11).astype(np.float32)
        if neg_zero:
            w[:4] = -0.0              # a -0.0 in every row: the left fold
        bufs.append({"weighted": w,   # keeps it, a zero start would not
                     "unit": rng.standard_normal(1).astype(np.float32)})
    parts = [{"sums": flat_sums({g: torch.from_numpy(b) for g, b in
                                 buf.items()}),
              "layout": layout, "weights": {"delta": 2.0 + i},
              "counts": {"delta": 2, "count": 1}, "collected": {},
              "n_clients": 2} for i, buf in enumerate(bufs)]
    return parts, ops_t, ops_j, bufs


@pytest.mark.parametrize("K,neg_zero", [(1, False), (4, False), (4, True),
                                        (70, False)])
def test_global_fold_matches_host_aggregate(K, neg_zero):
    """The placement's fold equals the host left fold bit for bit (one
    fold dispatch a weight group, 64 rows a call past ``b0``), keeps a -0.0
    of ``b0``, and equals the JAX package's host aggregate."""
    from repro.core.aggregation import global_aggregate as jglobal
    from repro.core.flat import FlatLayout as JLayout, flat_sums as jflat
    parts, ops_t, ops_j, bufs = _flat_partials(K, neg_zero=neg_zero)
    pl = T.DevicePlacement(range(K), devices=["cpu"])
    ops.reset_agg_counts()
    folded = pl.global_fold(parts, ops_t)
    groups = 2
    calls = -(-(K - 1) // ops.MAX_FOLD_ROWS)
    assert ops.agg_dispatches == groups * calls
    ref = T.global_aggregate(parts, ops_t)
    for name in ("delta", "count"):
        got = folded[name]["w"] if name == "delta" else folded[name]
        want = ref[name]["w"] if name == "delta" else ref[name]
        assert torch.equal(got, want) and got.device == CPU
        assert torch.equal(torch.signbit(got), torch.signbit(want))
    jl = JLayout.build(ops_j, {"delta": {"w": np.zeros(12, np.float32)},
                               "count": np.zeros((), np.float32)})
    jparts = [dict(p, layout=jl, sums=jflat(b)) for p, b in zip(parts, bufs)]
    jref = jglobal(jparts, ops_j)
    np.testing.assert_array_equal(folded["delta"]["w"].numpy(),
                                  np.asarray(jref["delta"]["w"]))
    np.testing.assert_array_equal(folded["count"].numpy(),
                                  np.asarray(jref["count"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_rank_ordered_reduce_is_the_left_fold(dtype):
    g = torch.Generator().manual_seed(3)
    bufs = [torch.randn(33, generator=g).to(dtype) for _ in range(5)]
    want = bufs[0]
    for b in bufs[1:]:
        want = want + b
    got = rank_ordered_reduce(bufs, CPU)
    assert got.dtype == dtype and torch.equal(got, want)
    assert rank_ordered_reduce(bufs[:1], CPU) is bufs[0]


def test_server_global_fold_routes_through_the_placement():
    srv = _port_server("fedavg", "lpt")
    calls = []
    inner = srv.placement.global_fold
    srv.placement.global_fold = lambda p, o: calls.append(len(p)) or \
        inner(p, o)
    srv.run_round()
    assert calls == [4]
    with pytest.raises(ValueError, match="folds onto"):
        T.ParrotServer(params={"w": torch.zeros(2)}, algorithm=srv.algorithm,
                       executors=[], data_by_client={}, clients_per_round=1,
                       device="cpu",
                       placement=T.DevicePlacement([], devices=["meta"]))


# ---------------------------------------------------------------------------
# device-keyed caches
# ---------------------------------------------------------------------------

def _client(n_batches=2, seed=0):
    rng = np.random.default_rng(seed)
    bs = [{"x": rng.standard_normal((4, 16)).astype(np.float32),
           "y": rng.integers(0, 10, 4).astype(np.int32)}
          for _ in range(n_batches)]
    return T.ClientData(batches=bs, n_samples=4 * n_batches)


def _executor(**kw):
    algo = T.make_algorithm("fedavg", TGRAD, 0.1)
    kw.setdefault("device", "cpu")
    return T.SequentialExecutor(0, algo, **kw)


def test_engine_for_keys_on_device():
    algo = T.make_algorithm("fedavg", TGRAD, 0.1)
    eng = client_step.engine_for(algo, CPU)
    assert client_step.engine_for(algo, CPU) is eng
    other = client_step.engine_for(algo, META)
    assert other is not eng and other.device == META and eng.device == CPU


def test_set_device_drops_device_caches_keeps_costs():
    ex = _executor()
    data = {1: _client(), 2: _client(seed=2)}
    ex._prep_batches(1, data[1])
    ex._prep_block_stack([T.ClientTask(1, 8), T.ClientTask(2, 8)], data, 2)
    ex._place_payload({"params": {"w": torch.zeros(2)}})
    ex._block_cost[("sig", 4)] = 0.5
    ex.set_device("cpu")                    # same device: nothing drops
    assert ex._batch_cache and ex._block_stack_cache
    ex.set_device(META)
    assert ex.device == META
    assert not ex._batch_cache and not ex._block_stack_cache
    assert ex._batch_cache_used == 0 and ex._payload_cache._key is None
    assert ex._block_cost == {("sig", 4): 0.5}


def test_payload_placed_once_per_object():
    ex = _executor()
    p = {"params": {"w": torch.zeros(2)}}
    a = ex._place_payload(p)
    assert ex._place_payload(p) is a
    assert ex._place_payload(dict(p)) is not a


def test_batch_cache_hit_and_identity():
    ex = _executor()
    data = _client()
    s1, m1 = ex._prep_batches(1, data)
    s2, m2 = ex._prep_batches(1, data)
    assert s1 is s2 and m1 is m2


def test_batch_cache_lru_eviction_respects_budget():
    data = {i: _client(seed=i) for i in range(8)}
    s, m = _executor()._prep_batches(0, data[0])
    per_client = sum(int(x.nbytes) for x in tree.leaves(s)) + int(m.nbytes)
    ex = _executor(batch_cache_bytes=3 * per_client)
    for i in range(8):
        ex._prep_batches(i, data[i])
    assert set(ex._batch_cache) == {5, 6, 7}
    assert ex._batch_cache_used <= ex.batch_cache_bytes
    ex._prep_batches(5, data[5])
    ex._prep_batches(0, data[0])
    assert set(ex._batch_cache) == {7, 5, 0}


def test_batch_cache_invalidates_on_swapped_dataset():
    ex = _executor()
    d1, d2 = _client(seed=1), _client(seed=2)
    s1, _ = ex._prep_batches(1, d1)
    s2, _ = ex._prep_batches(1, d2)
    assert s1 is not s2
    np.testing.assert_array_equal(s2["x"][0].numpy(), d2.batches[0]["x"])


def test_batch_cache_disabled_with_zero_budget():
    ex = _executor(batch_cache_bytes=0)
    data = {1: _client(), 2: _client(seed=2)}
    ex._prep_batches(1, data[1])
    ex._prep_block_stack([T.ClientTask(1, 8), T.ClientTask(2, 8)], data, 2)
    assert not ex._batch_cache and not ex._block_stack_cache


def test_block_stack_cache_serves_a_repeated_cohort():
    """The gang's whole-block stack is served again for the same cohort,
    padded with the first client, and block stacks are evicted before
    per-client entries."""
    ex = _executor()
    data = {c: _client(seed=c) for c in range(3)}
    block = [T.ClientTask(0, 8), T.ClientTask(1, 8), T.ClientTask(2, 8)]
    s1, m1 = ex._prep_block_stack(block, data, 4)
    s2, m2 = ex._prep_block_stack(block, data, 4)
    assert s1 is s2 and m1 is m2
    assert s1["x"].shape[0] == 4 and torch.equal(s1["x"][3], s1["x"][0])
    data[1] = _client(seed=9)               # a swapped dataset re-stacks
    s3, _ = ex._prep_block_stack(block, data, 4)
    assert s3 is not s1
    ex.batch_cache_bytes = ex._batch_cache_used - 1
    ex._evict_to_budget()
    assert not ex._block_stack_cache and len(ex._batch_cache) == 3


def test_placed_cache_is_identity_keyed():
    cache = client_step.PlacedCache()
    a, b = object(), object()
    v1 = cache.get((a,), lambda: [1])
    assert cache.get((a,), lambda: [2]) is v1
    assert cache.get((b,), lambda: [3]) == [3]
    assert cache.get((a,), lambda: [5]) == [5]    # one slot: a re-placed
    cache.clear()
    assert cache.get((b,), lambda: [4]) == [4]



def test_timer_and_counters_are_thread_safe():
    """What parallel dispatch shares across its threads — the
    ``TickTimer``, the fold counters, the shape counter and the engine
    cache — loses no update under a short switch interval."""
    import threading
    timer = T.TickTimer()
    algo = T.make_algorithm("fedavg", TGRAD, 0.1)
    acc, row = torch.zeros(4), torch.ones(4)
    n_threads, calls = 8, 400
    ops.reset_agg_counts()
    c0 = client_step.compile_events()
    engines = []

    def work(i):
        eng = client_step.engine_for(algo, CPU)
        engines.append(eng)
        for j in range(calls):
            timer()
            ops.agg_weighted_sum(acc, [row], [1.0])
            eng._note_shape(("thread", i, j))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * calls
    assert timer.now == total
    assert ops.agg_dispatches == total
    assert client_step.compile_events() - c0 == total
    assert len({id(e) for e in engines}) == 1
    assert engines[0].n_dispatches == total


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-child":
        _jax_child(sys.argv[2])
    else:
        sys.exit("usage: test_torch_placement.py --jax-child OUT.npz")

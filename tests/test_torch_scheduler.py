"""The port's pure-Python and numpy parts against the JAX package's: the
Eq. 2 fit, Alg. 3 schedules, chunk pricing, the hindsight oracle, cohort
sampling and the synthetic clients' bytes.  Everything here is exact."""
import numpy as np
import pytest

from repro.core import population as jpop
from repro.core import scheduler as jsch
from repro.core import workload as jwl
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro_torch.core import population as tpop
from repro_torch.core import scheduler as tsch
from repro_torch.core import workload as twl
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn


def _records(mod, rng, rounds=4, K=4):
    recs = []
    for r in range(rounds):
        for k in range(K):
            for c in range(6):
                n = int(rng.integers(10, 200))
                t = n * (0.01 * (k + 1)) + 0.3 + float(rng.normal()) * 0.01
                recs.append(mod.RunRecord(round=r, client=c, executor=k,
                                          n_samples=n, time=t))
    return recs


def _assignment(sched):
    return {k: [(t.client, t.n_samples) for t in q]
            for k, q in sched.assignment.items()}


@pytest.mark.parametrize("policy", ["parrot", "uniform", "none"])
@pytest.mark.parametrize("window", [0, 2])
def test_schedules_identical(policy, window):
    rng = np.random.default_rng(0)
    sizes = rng.integers(5, 300, size=40)
    outs = []
    for wl, sch in ((jwl, jsch), (twl, tsch)):
        est = wl.WorkloadEstimator(time_window=window)
        est.record_many(_records(wl, np.random.default_rng(1)))
        s = sch.ParrotScheduler(est, warmup_rounds=1, policy=policy)
        tasks = [sch.ClientTask(i, int(n)) for i, n in enumerate(sizes)]
        sched = s.schedule(4, tasks, [0, 1, 2, 3, 5])
        fits = {k: (m.t_sample, m.b) for k, m in est.last_fit.items()}
        outs.append((_assignment(sched), sched.predicted_makespan, fits))
    (ja, jm, jf), (ta, tm, tf) = outs
    assert ta == ja
    assert tf == jf
    assert (np.isnan(tm) and np.isnan(jm)) or tm == jm


def test_predict_span_split_chunks_and_oracle_identical():
    rng = np.random.default_rng(2)
    tasks = [(i, int(n)) for i, n in enumerate(rng.integers(1, 99, 13))]
    jt = [jsch.ClientTask(*t) for t in tasks]
    tt = [tsch.ClientTask(*t) for t in tasks]
    jm, tm = jwl.WorkloadModel(0.02, 0.5), twl.WorkloadModel(0.02, 0.5)
    comm = lambda ids: 0.001 * sum(ids)   # noqa: E731
    assert tsch.predict_span(tm, tt, comm) == jsch.predict_span(jm, jt, comm)
    assert tsch.predict_span(None, tt) == jsch.predict_span(None, jt) == 0.0
    assert [[t.client for t in c] for c in tsch.split_chunks(tt, 4)] == \
        [[t.client for t in c] for c in jsch.split_chunks(jt, 4)]
    jobs = [(float(n), float(n) * 0.01 * (1 + i % 3), i % 3, 0.1)
            for i, n in tasks]
    assert tsch.oracle_makespan(jobs, [0, 1, 2, 3]) == \
        jsch.oracle_makespan(jobs, [0, 1, 2, 3])
    js = jsch.Schedule({0: jt[:3], 9: jt[3:]}, 0.0, 0.0, 0.0)
    ts = tsch.Schedule({0: tt[:3], 9: tt[3:]}, 0.0, 0.0, 0.0)
    assert ts.remap([0, 1]) == js.remap([0, 1])
    assert _assignment(ts) == _assignment(js)


def test_fleet_average_and_estimation_error_identical():
    rng = np.random.default_rng(3)
    jest, test = jwl.WorkloadEstimator(), twl.WorkloadEstimator()
    jest.record_many(_records(jwl, rng))
    test.record_many(_records(twl, np.random.default_rng(3)))
    jf, tf = jest.fit(5), test.fit(5)
    ja, ta = jwl.fleet_average(jf), twl.fleet_average(tf)
    assert (ta.t_sample, ta.b) == (ja.t_sample, ja.b)
    recs = _records(twl, np.random.default_rng(4), rounds=1)
    jrecs = _records(jwl, np.random.default_rng(4), rounds=1)
    assert test.estimation_error(tf, recs) == \
        jest.estimation_error(jf, jrecs)


@pytest.mark.parametrize("exclude", [None, [3, 7, 8, 40, 99]])
def test_population_sample_is_rng_identical(exclude):
    data = {c: None for c in range(0, 200, 2)}
    jp, tp = jpop.as_population(dict(data)), tpop.as_population(dict(data))
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(5):
        assert tp.sample(tr, 17, exclude=exclude) == \
            jp.sample(jr, 17, exclude=exclude)
    assert tp.sample(tr, 1000) == jp.sample(jr, 1000)   # k > pool
    assert 4 in tp and 5 not in tp and len(tp) == 100


@pytest.mark.parametrize("partition", ["natural", "dirichlet",
                                       "quantity_skew"])
def test_synthetic_clients_are_byte_identical(partition):
    jd = jsyn.make_classification_clients(12, dim=6, n_classes=4,
                                          partition=partition,
                                          partition_arg=0.5, seed=3)
    td = tsyn.make_classification_clients(12, dim=6, n_classes=4,
                                          partition=partition,
                                          partition_arg=0.5, seed=3)
    assert list(td) == list(jd)
    for c in jd:
        assert td[c].n_samples == jd[c].n_samples
        assert len(td[c].batches) == len(jd[c].batches)
        for tb, jb in zip(td[c].batches, jd[c].batches):
            for k in ("x", "y"):
                assert tb[k].dtype == jb[k].dtype
                assert tb[k].tobytes() == jb[k].tobytes()
    np.testing.assert_array_equal(
        tpart.partition_sizes(partition, 30, 0.5, 50, 1),
        jpart.partition_sizes(partition, 30, 0.5, 50, 1))

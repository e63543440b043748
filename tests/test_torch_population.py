"""The port's streamed population (``LazyPopulation``,
``make_classification_population``) against the JAX package's
(``tests/test_population.py``) on the CPU: cohorts id for id from the same
seeded rng, batches byte-identical in any access order, the fetch cache's
bound and stats, and a lazy run equal to its ``materialize()`` eager twin
bit for bit under every engine.
"""
import tempfile

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro.core.algorithms import ClientData as JClientData
from repro.core.population import LazyPopulation as JLazy
from repro.data import make_classification_population as jpopulation
from repro_torch.core.population import EagerPopulation, LazyPopulation
from repro_torch.data import (make_classification_clients,
                              make_classification_population)


def _sparse_ids(seed=0, n=200):
    rng = np.random.default_rng(seed)
    return sorted(int(c) for c in rng.choice(10_000, size=n, replace=False))


def _lazy(cls, data_cls, n=30, cache=1 << 20, ids=None, batch=dict):
    sizes = [10 + (c % 7) for c in range(n)]
    calls = []

    def factory(c):
        calls.append(c)
        x = np.full((4, 2), float(c), np.float32)
        b = {"x": x} if batch is dict else (x,)
        return data_cls(batches=[b], n_samples=10 + (c % 7))

    return cls(sizes, factory, ids=ids, fetch_cache_bytes=cache), calls


@pytest.mark.parametrize("ids_kind", ["implicit", "explicit"])
@pytest.mark.parametrize("with_exclude", [False, True])
def test_lazy_sample_matches_jax_id_for_id(ids_kind, with_exclude):
    """Sequential draws from one seed give JAX's cohorts, id for id and in
    order, with implicit (0..M-1) or explicit sparse ids, and with the
    in-flight clients excluded."""
    ids = None if ids_kind == "implicit" else \
        list(reversed(_sparse_ids(n=200)))      # unsorted on purpose
    n = 200
    tp, _ = _lazy(LazyPopulation, T.ClientData, n=n, ids=ids)
    jp, _ = _lazy(JLazy, JClientData, n=n, ids=ids)
    assert np.array_equal(tp.ids_array(), jp.ids_array())
    pool = list(tp.ids_array())
    trng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    exclude = None
    for k in (8, 25, 1, 60, 200, 0):
        if with_exclude:
            exclude = pool[::7] + [pool[3], 123_456]
        got = tp.sample(trng, k, exclude=exclude)
        assert got == jp.sample(jrng, k, exclude=exclude)
        assert len(set(got)) == len(got)
        if exclude:
            assert not set(got) & set(exclude)
    assert trng.bit_generator.state == jrng.bit_generator.state


def test_lazy_registry_reads_never_fetch():
    pop, calls = _lazy(LazyPopulation, T.ClientData, n=50)
    assert len(pop) == 50
    assert pop.n_samples(13) == 10 + 13 % 7
    assert 49 in pop and 50 not in pop and "x" not in pop
    with pytest.raises(KeyError):
        pop[50]
    assert calls == []
    d = pop[7]
    assert d.n_samples == pop.n_samples(7) and calls == [7]
    assert pop[7] is d and calls == [7]          # cached: stable identity
    with pytest.raises(ValueError):
        LazyPopulation([1, 2], lambda c: None, ids=[3, 3])
    with pytest.raises(ValueError):
        LazyPopulation([1, 2], lambda c: None, ids=[3])


@pytest.mark.parametrize("batch", [tuple, dict])
def test_fetch_cache_is_bounded_with_jax_stats(batch):
    """The cache never holds more than its budget, counting each batch's
    array bytes (one client's batch is 32 B).  With tuple batches the same
    accesses give JAX's fetch, hit and eviction counts; a dict batch counts
    its 32 B here, where JAX counts 64 B for it (one opaque leaf)."""
    tp, tcalls = _lazy(LazyPopulation, T.ClientData, cache=100, batch=batch)
    jp, jcalls = _lazy(JLazy, JClientData, cache=100, batch=batch)
    order = list(range(30)) + [29, 28, 0, 5, 5, 29]
    for c in order:
        tp[c]
        jp[c]
        assert tp.cache_bytes <= 100
        assert tp.cache_bytes == 32 * len(tp._cache)
    assert tp.stats["evictions"] > 0 and tp.stats["cache_hits"] > 0
    if batch is tuple:
        assert tp.stats == jp.stats and tcalls == jcalls
        assert tp.cache_bytes == jp.cache_bytes
    else:
        assert jp.cache_bytes == 64 * len(jp._cache)
    np.testing.assert_array_equal(tp[0].batches[0][0 if batch is tuple
                                                   else "x"],
                                  np.zeros((4, 2), np.float32))


@pytest.mark.parametrize("partition", ["natural", "dirichlet"])
def test_streamed_batches_are_byte_identical_to_jax(partition):
    """make_classification_population: the registry equals JAX's and every
    client's batches are byte-identical to JAX's, read in a shuffled order
    against JAX's forward order; ``materialize()`` is the same data."""
    kw = dict(dim=6, n_classes=4, partition=partition, partition_arg=0.5,
              mean_samples=12, batch_size=5, seed=3)
    tp = make_classification_population(40, fetch_cache_bytes=2048, **kw)
    jp = jpopulation(40, **kw)
    assert np.array_equal(tp.ids_array(), jp.ids_array())
    order = np.random.default_rng(5).permutation(40)
    jdata = {c: jp[c] for c in range(40)}
    for c in order:
        c = int(c)
        assert tp.n_samples(c) == jp.n_samples(c)
        tb, jb = tp[c].batches, jdata[c].batches
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            for key in ("x", "y"):
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()
    assert tp.stats["evictions"] > 0          # the small cache cycled
    twin = tp.materialize()
    assert sorted(twin) == list(range(40))
    for c in (0, 17, 39):
        assert twin[c].batches[0]["x"].tobytes() == \
            jdata[c].batches[0]["x"].tobytes()


def test_eager_generator_still_matches_its_own_draws():
    """make_classification_clients now builds each client through the
    shared ``_build_classification_client``: the same bytes as the
    sequential draw it replaced (one rng, mixture then labels then x)."""
    data = make_classification_clients(12, dim=4, n_classes=3,
                                       mean_samples=10, batch_size=5,
                                       partition="dirichlet",
                                       partition_arg=0.3, seed=2)
    from repro.data import make_classification_clients as jclients
    ref = jclients(12, dim=4, n_classes=3, mean_samples=10, batch_size=5,
                   partition="dirichlet", partition_arg=0.3, seed=2)
    for c in ref:
        for a, b in zip(data[c].batches, ref[c].batches):
            assert a["x"].tobytes() == b["x"].tobytes()
            assert a["y"].tobytes() == b["y"].tobytes()


def _loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


def _run(engine, data_or_pop, rounds=3):
    algo = T.make_algorithm("scaffold", T.value_and_grad(_loss), 0.05,
                            local_epochs=1)
    sm = T.ClientStateManager(tempfile.mkdtemp(prefix="pop_"),
                              memory_budget_bytes=1 << 14, shard_clients=8)
    execs = [T.SequentialExecutor(k, algo, state_manager=sm,
                                  timer=T.TickTimer(1.0), device="cpu")
             for k in range(3)]
    srv = T.ParrotServer(params={"w": torch.zeros(6, 3),
                                 "b": torch.zeros(3)},
                         algorithm=algo, executors=execs,
                         data_by_client=data_or_pop, clients_per_round=8,
                         round_engine=engine, seed=7, device="cpu")
    hist = [srv.run_round() for _ in range(rounds)]
    return srv.params, [m.makespan for m in hist]


@pytest.mark.parametrize("engine", ["bsp", "semi-sync", "async"])
def test_lazy_run_equals_its_eager_twin(engine):
    """A streamed population replays the eager run bit for bit (selection,
    scheduling, folds and virtual time) even with a fetch cache small
    enough to evict mid-round."""
    def pop():
        return make_classification_population(
            20, dim=6, n_classes=3, mean_samples=12, batch_size=5, seed=2,
            fetch_cache_bytes=1 << 10)

    twin = pop().materialize()
    eager_params, eager_ms = _run(engine, twin)
    lazy = pop()
    lazy_params, lazy_ms = _run(engine, lazy)
    assert lazy.stats["evictions"] > 0
    for k in eager_params:
        assert torch.equal(eager_params[k], lazy_params[k]), k
    assert eager_ms == lazy_ms
    assert isinstance(T.as_population(twin), EagerPopulation)
    assert T.as_population(lazy) is lazy

"""The six FL algorithms in the port against the JAX package: one eager
``client_update`` and one vmapped ``run_block`` each, on the same numpy
clients and weights, plus the bf16 carry dtype."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.client_step import engine_for as jengine_for
from repro_torch.core import tree
from repro_torch.core.client_step import (batch_signature, engine_for,
                                          stack_batches)
from repro_torch.convert import params_from_jax

ALGOS = ["fedavg", "fedprox", "fednova", "mime", "scaffold", "feddyn"]


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


def _params_np(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(8, 4)) * 0.1).astype(dtype),
            "b": (rng.normal(size=(4,)) * 0.1).astype(dtype)}


def _client(n_batches, bs=6, seed=0, xdtype=np.float32):
    rng = np.random.default_rng(seed)
    batches = [{"x": rng.normal(size=(bs, 8)).astype(xdtype),
                "y": rng.integers(0, 4, size=(bs,)).astype(np.int32)}
               for _ in range(n_batches)]
    return (J.ClientData(batches=batches, n_samples=n_batches * bs),
            T.ClientData(batches=batches, n_samples=n_batches * bs))


def _setup(name, params_np=None, local_epochs=2):
    p = params_np if params_np is not None else _params_np()
    ja = J.make_algorithm(name, JGRAD, 0.1, local_epochs=local_epochs)
    ta = T.make_algorithm(name, TGRAD, 0.1, local_epochs=local_epochs)
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_jax(p, "cpu")
    jss, tss = ja.server_init(jp), ta.server_init(tp)
    if name == "mime":   # a non-zero momentum exercises the correction
        mom = _params_np(seed=7, dtype=p["w"].dtype)
        jss = {"momentum": jax.tree.map(jnp.asarray, mom)}
        tss = {"momentum": params_from_jax(mom, "cpu")}
    if name == "scaffold":
        c = _params_np(seed=8, dtype=p["w"].dtype)
        jss = {"c": jax.tree.map(jnp.asarray, c)}
        tss = {"c": params_from_jax(c, "cpu")}
    jpay, tpay = ja.broadcast_payload(jp, jss), ta.broadcast_payload(tp, tss)
    jst = ja.client_init_state(jp) if ja.stateful else None
    tst = ta.client_init_state(tp) if ta.stateful else None
    return ja, ta, jpay, tpay, jst, tst


def _close(t_tree, j_tree, atol=1e-6, rtol=1e-5):
    tl, jl = tree.leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for x, y in zip(tl, jl):
        np.testing.assert_allclose(
            np.asarray(x.float() if isinstance(x, torch.Tensor) else x),
            np.asarray(y, np.float32), atol=atol, rtol=rtol)


# tolerance (all fp32 cases): the same steps, with each matrix product and
# sum taken in another order by XLA and by PyTorch's CPU kernels
@pytest.mark.parametrize("name", ALGOS)
def test_client_update_matches_jax(name):
    ja, ta, jpay, tpay, jst, tst = _setup(name)
    jd, td = _client(3, seed=1)
    jr, jns = ja.client_update(jpay, jd, jst)
    tr, tns = ta.client_update(tpay, td, tst)
    assert tr.weight == jr.weight
    assert list(tr.payload) == list(jr.payload)
    for entry in jr.payload:
        _close(tr.payload[entry], jr.payload[entry])
    if ja.stateful:
        _close(tns, jns)
    else:
        assert tns is None


@pytest.mark.parametrize("name", ALGOS)
def test_run_block_matches_jax(name):
    """A block of 3 clients (padded to 4) with 3 batches each (padded to
    4 masked steps): the vmapped port against the vmapped JAX scan."""
    ja, ta, jpay, tpay, jst, tst = _setup(name)
    pairs = [_client(3, seed=10 + i) for i in range(3)]
    jstates = [jst] * 3 if ja.stateful else None
    tstates = [tst] * 3 if ta.stateful else None
    jout, jns = jengine_for(ja).run_block(jpay, [p[0] for p in pairs],
                                          jstates)
    tout, tns = engine_for(ta, torch.device("cpu")).run_block(
        tpay, [p[1] for p in pairs], tstates)
    assert set(tout) == set(jout)
    for entry in jout:
        _close(tout[entry], jout[entry])
    if ja.stateful:
        assert len(tns) == 3
        for a, b in zip(tns, jns):
            _close(a, b)


@pytest.mark.parametrize("name", ["fednova", "scaffold"])
def test_run_client_matches_eager(name):
    """The single-client step form equals the port's own eager path."""
    _, ta, _, tpay, _, tst = _setup(name)
    _, td = _client(3, seed=2)
    er, es = ta.client_update(tpay, td, tst)
    cr, cs = engine_for(ta, torch.device("cpu")).run_client(tpay, td, tst)
    for entry in er.payload:
        for x, y in zip(tree.leaves(cr.payload[entry]),
                        tree.leaves(er.payload[entry])):
            torch.testing.assert_close(x, y.to(x.dtype), atol=1e-6,
                                       rtol=1e-5)


@pytest.mark.parametrize("name", ["fedavg", "scaffold", "mime"])
def test_bf16_params_keep_bf16_carry(name):
    """bf16 params through the block form: the step mask is cast to each
    leaf's dtype, so deltas and states stay bf16 (a promoted carry would
    come back fp32).  Values agree with JAX to bf16 precision."""
    import ml_dtypes
    p = _params_np(dtype=ml_dtypes.bfloat16)
    ja, ta, jpay, tpay, jst, tst = _setup(name, params_np=p)
    assert tpay["params"]["w"].dtype == torch.bfloat16
    pairs = [_client(2, seed=20 + i, xdtype=ml_dtypes.bfloat16)
             for i in range(2)]
    tout, tns = engine_for(ta, torch.device("cpu")).run_block(
        tpay, [q[1] for q in pairs], [tst] * 2 if ta.stateful else None)
    jout, jns = jengine_for(ja).run_block(
        jpay, [q[0] for q in pairs], [jst] * 2 if ja.stateful else None)
    assert tout["delta"]["w"].dtype == torch.bfloat16
    if ta.stateful:
        assert all(leaf.dtype == torch.bfloat16
                   for s in tns for leaf in tree.leaves(s))
    # tolerance: bf16 rounds at other places in the two frameworks
    _close(tout["delta"], jout["delta"], atol=2e-2, rtol=5e-2)


def test_stack_batches_and_signature_match_jax():
    from repro.core.client_step import batch_signature as jsig
    from repro.core.client_step import stack_batches as jstack
    jd, td = _client(5, seed=3)
    assert batch_signature(td)[0] == jsig(jd)[0] == 8
    (tb, tm), (jb, jm) = stack_batches(td), jstack(jd)
    np.testing.assert_array_equal(tm, jm)
    for x, y in zip(tree.leaves(tb), jax.tree.leaves(jb)):
        np.testing.assert_array_equal(x, y)
    ragged = T.ClientData(batches=[{"x": np.zeros((2, 8))},
                                   {"x": np.zeros((3, 8))}], n_samples=5)
    assert batch_signature(ragged) is None


def test_params_from_jax_keeps_structure_and_dtypes():
    import ml_dtypes
    p = {"b": np.full(3, 1.5, ml_dtypes.bfloat16),
         "a": [np.arange(4, dtype=np.float32), np.int32(7)]}
    t = params_from_jax(p, "cpu")
    assert list(t) == ["a", "b"]
    assert t["b"].dtype == torch.bfloat16
    assert t["b"].tolist() == [1.5, 1.5, 1.5]
    assert t["a"][0].dtype == torch.float32 and t["a"][1].dtype == torch.int32

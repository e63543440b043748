"""The port's optimizers and LM client data against the JAX package's.

Every optimizer of ``repro/optim/optimizers.py`` runs 5 steps on the same
numpy trees of params and gradients in both packages: fp32 updates,
params and states within 1e-6 (fp32 arithmetic in the same order; XLA
and PyTorch may round ``pow`` and ``sqrt`` to other last bits), and the
state trees in the same structure.  bf16 params go through
``apply_updates`` (the fp32 add, cast back) to the same bits.
``make_lm_clients`` is pure numpy, so its batches are equal byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_lm_clients as jclients
from repro.optim import optimizers as J
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.data import make_lm_clients as tclients
from repro_torch.optim import optimizers as T

TOL = 1e-6
SHAPES = {"a": (7, 5), "b": {"c": (13,), "d": (3, 4, 2)}, "e": ()}


def _tree(rng, dtype=np.float32):
    def make(shape):
        return rng.standard_normal(shape).astype(dtype)
    return {"a": make(SHAPES["a"]),
            "b": {"c": make(SHAPES["b"]["c"]), "d": make(SHAPES["b"]["d"])},
            "e": make(SHAPES["e"])}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tol=TOL):
    gl, gd = tree.flatten(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol)


# name -> (JAX optimizer, port optimizer)
CLIENT = {
    "sgd": (J.sgd(0.1), T.sgd(0.1)),
    "sgd_momentum": (J.sgd(0.1, momentum=0.9), T.sgd(0.1, momentum=0.9)),
    "sgd_nesterov": (J.sgd(0.05, momentum=0.8, nesterov=True),
                     T.sgd(0.05, momentum=0.8, nesterov=True)),
    "adamw": (J.adamw(1e-2), T.adamw(1e-2)),
    "adamw_decay": (J.adamw(3e-3, b1=0.8, b2=0.95, eps=1e-6,
                            weight_decay=0.1),
                    T.adamw(3e-3, b1=0.8, b2=0.95, eps=1e-6,
                            weight_decay=0.1)),
}


@pytest.mark.parametrize("name", sorted(CLIENT))
def test_client_optimizer_matches_jax_over_five_steps(name):
    jopt, topt = CLIENT[name]
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = params_from_jax(p0, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    assert tree.structure(ts) == tree.structure(
        jax.tree.map(np.asarray, js)) or (js == () and ts == ())
    for _ in range(5):
        g = _tree(rng)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(params_from_jax(g, "cpu"), ts, tp)
        _close(tu, ju)
        jp, tp = J.apply_updates(jp, ju), T.apply_updates(tp, tu)
        _close(tp, jp)
    if isinstance(js, dict) and "t" in js:
        assert ts["t"] == int(js["t"]) == 5
        _close(ts["m"], js["m"])
        _close(ts["v"], js["v"])
    elif js != ():
        _close(ts, js)


SERVER = {
    "fedavgm": (J.fedavgm, T.fedavgm, {}),
    "fedavgm_lr": (J.fedavgm, T.fedavgm, {"lr": 0.5, "momentum": 0.7}),
    "fedadam": (J.fedadam, T.fedadam, {}),
    "fedyogi": (J.fedyogi, T.fedyogi, {}),
    "fedyogi_lr": (J.fedyogi, T.fedyogi, {"lr": 0.03, "b2": 0.9}),
}


@pytest.mark.parametrize("name", sorted(SERVER))
def test_server_optimizer_matches_jax_over_five_steps(name):
    jmake, tmake, kw = SERVER[name]
    jopt, topt = jmake(**kw), tmake(**kw)
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = params_from_jax(p0, "cpu")
    jopt.init(jp)
    topt.init(tp)
    for _ in range(5):
        delta = jax.tree.map(lambda x: 0.1 * x, _tree(rng))
        jp = jopt.step(jp, jax.tree.map(jnp.asarray, delta))
        tp = topt.step(tp, params_from_jax(delta, "cpu"))
        _close(tp, jp)
    if isinstance(jopt.state, dict) and "t" in jopt.state:
        assert topt.state["t"] == int(jopt.state["t"]) == 5
        _close(topt.state["m"], jopt.state["m"])
        _close(topt.state["v"], jopt.state["v"])


@pytest.mark.parametrize("opt", ["sgd_momentum", "adamw"])
def test_bf16_params_update_in_fp32_like_jax(opt):
    """bf16 params: the fp32 update is added in fp32 and rounded once to
    bf16, bit for bit the JAX package's."""
    jopt, topt = CLIENT[opt]
    rng = np.random.default_rng(2)
    p0 = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                      _tree(rng))
    jp = jax.tree.map(jnp.asarray, p0)
    tp = params_from_jax(p0, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = _tree(rng)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(params_from_jax(g, "cpu"), ts, tp)
        jp, tp = J.apply_updates(jp, ju), T.apply_updates(tp, tu)
        for t, j in zip(tree.leaves(tp), jax.tree.leaves(jp)):
            assert t.dtype == torch.bfloat16
            want = params_from_jax(np.asarray(j), "cpu")
            assert torch.equal(t, want)


def test_apply_updates_rounds_once_to_the_param_dtype():
    rng = np.random.default_rng(3)
    p = rng.standard_normal(64).astype(np.float32)
    u = (1e-3 * rng.standard_normal(64)).astype(np.float32)
    jp = jnp.asarray(p, jnp.bfloat16)
    want = J.apply_updates({"w": jp}, {"w": jnp.asarray(u)})["w"]
    got = T.apply_updates({"w": params_from_jax(np.asarray(jp), "cpu")},
                          {"w": torch.from_numpy(u)})["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))


@pytest.mark.parametrize("kw", [
    {"n_clients": 12},
    {"n_clients": 30, "vocab": 512, "seq_len": 32, "batch_size": 3,
     "mean_samples": 5, "seed": 4},
    {"n_clients": 8, "partition": "quantity_skew", "seed": 9},
], ids=["default", "example", "quantity_skew"])
def test_make_lm_clients_equals_jax_byte_for_byte(kw):
    j, t = jclients(**kw), tclients(**kw)
    assert sorted(j) == sorted(t)
    for c in j:
        assert t[c].n_samples == j[c].n_samples
        assert len(t[c].batches) == len(j[c].batches)
        for tb, jb in zip(t[c].batches, j[c].batches):
            assert sorted(tb) == sorted(jb) == ["inputs", "labels"]
            for k in tb:
                assert tb[k].dtype == jb[k].dtype == np.int32
                assert tb[k].tobytes() == jb[k].tobytes()

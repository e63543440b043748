"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``) on the CPU.

Both packages get JAX's ``moe_init`` params (``params_from_jax``) and the
same numpy inputs, on the reduced grok-1-314b (8 → 4 experts, top-2) and
llama4-scout-17b-a16e (16 → 4 experts, top-1) configs, under both
``dispatch_impl`` values, at capacity factor 4.0 (the reduced configs',
drop-free) and 1.25 (the full configs', which drops).

Tolerances: selected experts and kept assignments exactly; fp32 outputs
1e-5 (the same sums in another order); bf16 outputs 2e-2 absolute plus
2e-2 relative (the expert products' bf16 intermediates are rounded at other
points: one bf16 ulp of an output of magnitude ~1 is 7.8e-3); the aux loss
1e-6; gradients 1e-5 relative to each leaf's 2-norm (a top-1 router's
leaf: 1e-5 on the aux loss alone, 5e-4 on the whole loss, see
ROUTER_TOP1_RTOL).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import moe as jmoe
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.models import moe

MOE = ["grok-1-314b", "llama4-scout-17b-a16e"]
IMPLS = ["gshard_einsum", "gather"]
CAPACITY = [4.0, 1.25]
F32_TOL = 1e-5
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
AUX_TOL = 1e-6
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the reduced models' ops are small, and
    the suite runs six workers on the machine's cores (spinning thread
    pools made these tests many times slower under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# a top-1 router's gradient is aux's alone analytically: the renormalised
# weight p / p is 1, and the two terms of its backward cancel to a rounding
# residue that each package rounds its own way (JAX's full-loss router
# gradient is 9.6e-5-1.0e-4 from its aux-only one on these inputs)
ROUTER_TOP1_RTOL = 5e-4


def _cfgs(name, impl="gshard_einsum", cf=4.0, dtype="float32", **moe_kw):
    def one(c):
        c = c.reduced()
        return dataclasses.replace(c, dtype=dtype, moe=dataclasses.replace(
            c.moe, dispatch_impl=impl, capacity_factor=cf, **moe_kw))
    return one(JARCHS[name]), one(ARCHS[name])


def _params(jcfg, seed=0, dup=None):
    """JAX's ``moe_init`` params and their port copy; ``dup`` = (a, b)
    copies router column a over column b (a planted tie)."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    if dup is not None:
        a, b = dup
        jp["router"] = jp["router"].at[:, b].set(jp["router"][:, a])
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(B, S, d, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _jax_kept(topk_idx, E, C):
    """JAX's kept assignments, by moe.py:88-94's own expressions."""
    G, S, k = topk_idx.shape
    flat = jax.nn.one_hot(topk_idx, E, dtype=jnp.int32).reshape(G, S * k, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - 1) * flat, axis=-1)
    return np.asarray(pos.reshape(G, S, k) < C)


def _np(t):
    return t.detach().float().numpy()


def _check_out(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=F32_TOL, rtol=0)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=BF16_ATOL, rtol=BF16_RTOL)


def _routing_both(jp, tp, jx, tx, jcfg, tcfg):
    """Each package's (topk_idx, kept) on the same grouped tokens."""
    xg, _ = moe._group(tx, tcfg.moe)
    jxg = jnp.asarray(xg.float().numpy()).astype(jx.dtype)
    _, _, jidx, _ = jax.jit(lambda p, x: jmoe._routing(p, x, jcfg.moe))(
        jp, jxg)
    C = moe.capacity(tcfg.moe, xg.shape[1])
    st = moe.routing_stats(tp, tx, tcfg)
    return (np.asarray(jidx), _jax_kept(jidx, tcfg.moe.n_experts, C),
            st["topk_idx"].numpy(), st["kept"].numpy(), st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_matches_jax(name, impl, cf, dtype):
    jcfg, tcfg = _cfgs(name, impl, cf, dtype)
    jp, tp = _params(jcfg)
    jx, tx = _x(2, 48, tcfg.d_model, dtype)
    want, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg))(jp, jx)
    got, aux = moe.moe_ffn(tp, tx, tcfg)
    assert got.dtype == tx.dtype and tuple(got.shape) == tx.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    _check_out(got, want, dtype)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    jidx, jkept, tidx, tkept, st = _routing_both(jp, tp, jx, tx, jcfg, tcfg)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tkept, jkept)
    assert (st["dropped"] > 0) == (cf == 1.25)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MOE)
def test_dispatches_agree_and_drop_the_same_assignments(name, impl):
    """At capacity 1.25 the two dispatches keep the same assignments, so
    their fp32 outputs agree to rounding."""
    _, tcfg = _cfgs(name, impl, 1.25)
    other = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, dispatch_impl=[i for i in IMPLS if i != impl][0]))
    jcfg, _ = _cfgs(name)
    _, tp = _params(jcfg, seed=2)
    _, tx = _x(2, 48, tcfg.d_model, "float32", seed=3)
    a, aux_a = moe.moe_ffn(tp, tx, tcfg)
    b, aux_b = moe.moe_ffn(tp, tx, other)
    st = moe.routing_stats(tp, tx, tcfg)
    assert st["dropped"] == st["dropped_gather"] > 0
    np.testing.assert_allclose(_np(a), _np(b), atol=F32_TOL, rtol=0)
    assert float(aux_a) == float(aux_b)


def test_top_k_breaks_ties_to_the_lower_index():
    """``jax.lax.top_k``'s rule on equal probabilities (``torch.topk`` gave
    [5, 3] here)."""
    p = np.array([.25, .5, .25, .5, .1, .5, 0, .3], np.float32)
    for k in (1, 2, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(p), k)
        tv, ti = moe.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _, ti = moe.top_k(torch.from_numpy(p), 2)
    assert ti.tolist() == [1, 3]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MOE)
def test_planted_tie_picks_the_lower_index_as_jax(name, impl):
    """Router column 2 copied over column 0 and column 1 over column 3:
    every token's probabilities of experts 0 and 2 (1 and 3) are equal, and
    both packages take the lower index first at bf16 and capacity 1.25."""
    jcfg, tcfg = _cfgs(name, impl, 1.25, "bfloat16")
    jp, tp = _params(jcfg, dup=(2, 0))
    jp["router"] = jp["router"].at[:, 3].set(jp["router"][:, 1])
    tp["router"][:, 3] = tp["router"][:, 1]
    jx, tx = _x(2, 48, tcfg.d_model, "bfloat16", seed=4)
    jidx, jkept, tidx, tkept, st = _routing_both(jp, tp, jx, tx, jcfg, tcfg)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tkept, jkept)
    # on the real tokens (the pad's probabilities are all equal) the top
    # choice is the lower expert of the larger pair, and a top-2 takes the
    # pair's higher expert second
    real = tidx.reshape(-1, tcfg.moe.top_k)[:tx.shape[0] * tx.shape[1]]
    assert set(np.unique(real[:, 0])) <= {0, 1}
    if tcfg.moe.top_k == 2:
        np.testing.assert_array_equal(real[:, 1], real[:, 0] + 2)
    else:
        assert st["boundary_ties"] == tidx.shape[0] * tidx.shape[1]
    want, _ = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg))(jp, jx)
    got, _ = moe.moe_ffn(tp, tx, tcfg)
    _check_out(got, want, "bfloat16")


@pytest.mark.parametrize("shape,pad", [((2, 48), 32), ((2, 128), 0),
                                       ((4, 16), 0), ((3, 40), 8)])
@pytest.mark.parametrize("impl", IMPLS)
def test_token_grouping_matches_jax(impl, shape, pad):
    """group_size 64: S = 48 and 40 neither split nor batch (zero-padded to
    whole groups), S = 128 splits rows, S = 16 batches four rows a group."""
    jcfg, tcfg = _cfgs("grok-1-314b", impl, 1.25)
    jp, tp = _params(jcfg)
    jx, tx = _x(*shape, tcfg.d_model, "float32", seed=5)
    assert moe._group(tx, tcfg.moe)[1] == pad
    want, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg))(jp, jx)
    got, aux = moe.moe_ffn(tp, tx, tcfg)
    _check_out(got, want, "float32")
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MOE)
def test_decode_grouping_matches_jax(name, impl):
    """A decode step's x is (B, 1, d): one group of B tokens; at the full
    configs' capacity factor C = 1, so a second token on an expert drops."""
    jcfg, tcfg = _cfgs(name, impl, 1.25, "bfloat16")
    jp, tp = _params(jcfg)
    jx, tx = _x(4, 1, tcfg.d_model, "bfloat16", seed=6)
    xg, pad = moe._group(tx, tcfg.moe)
    assert tuple(xg.shape) == (1, 4, tcfg.d_model) and pad == 0
    assert moe.capacity(tcfg.moe, 4) == (2 if name == "grok-1-314b" else 1)
    want, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg))(jp, jx)
    got, aux = moe.moe_ffn(tp, tx, tcfg)
    _check_out(got, want, "bfloat16")
    jidx, jkept, tidx, tkept, st = _routing_both(jp, tp, jx, tx, jcfg, tcfg)
    np.testing.assert_array_equal(tkept, jkept)
    assert st["dropped"] > 0


def test_out_of_range_slot_is_a_zero_row_inside_and_outside_vmap():
    idx = np.array([[0, 3, 4, 7], [2, 5, 1, 4]])
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx), 4, dtype=jnp.float32))
    got = moe.one_hot(torch.from_numpy(idx), 4, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    vm = torch.func.vmap(lambda i: moe.one_hot(i, 4, torch.float32))(
        torch.from_numpy(idx))
    np.testing.assert_array_equal(vm.numpy(), want)
    assert not want[0, 2].any() and not want[1, 1].any()


def _loss_jax(jcfg, r):
    def f(p, x):
        out, aux = jmoe.moe_ffn(p, x, jcfg)
        return jnp.sum(out * r) + aux
    return f


def _loss_port(tcfg, r):
    def f(p, x):
        out, aux = moe.moe_ffn(p, x, tcfg)
        return torch.sum(out * r) + aux
    return f


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(_np(got).astype(np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MOE)
def test_gradients_match_jax(name, impl, cf):
    """d(sum(out·r) + aux) / d(params, x) against ``jax.value_and_grad``:
    through the expert products, the combine weights and the router."""
    jcfg, tcfg = _cfgs(name, impl, cf)
    jp, tp = _params(jcfg)
    jx, tx = _x(2, 48, tcfg.d_model, "float32", seed=7)
    r = np.random.default_rng(8).standard_normal(tx.shape).astype(np.float32)
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(_loss_jax(jcfg, r),
                                                argnums=(0, 1)))(jp, jx)
    tl, (tgp, tgx) = torch.func.grad_and_value(
        _loss_port(tcfg, torch.from_numpy(r)), argnums=(0, 1))(tp, tx)[::-1]
    assert abs(float(tl) - float(jl)) <= 1e-4
    assert tree.structure(tgp) == tree.structure(tp)
    top1 = tcfg.moe.top_k == 1
    for key in ("router", "wi", "wg", "wo"):
        tol = ROUTER_TOP1_RTOL if top1 and key == "router" else GRAD_RTOL
        assert _rel(tgp[key], jgp[key]) <= tol, key
    assert _rel(tgx, jgx) <= GRAD_RTOL
    assert float(tgp["router"].abs().sum()) > 0
    # the router through the aux loss alone, at the common tolerance
    ja = jax.jit(jax.grad(lambda p, x: jmoe.moe_ffn(p, x, jcfg)[1]))(jp, jx)
    ta = torch.func.grad(lambda p, x: moe.moe_ffn(p, x, tcfg)[1])(tp, tx)
    assert _rel(ta["router"], ja["router"]) <= GRAD_RTOL


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MOE)
def test_vmap_grad_equals_a_per_client_loop(name, impl):
    """The client engine's form: ``vmap(grad)`` over 3 clients, each with
    its own params and tokens, at capacity 1.25 (drops), equals grad of
    each client alone."""
    _, tcfg = _cfgs(name, impl, 1.25)
    jcfg, _ = _cfgs(name)
    clients = [_params(jcfg, seed=s)[1] for s in range(3)]
    xs = torch.stack([_x(2, 32, tcfg.d_model, "float32", seed=10 + s)[1]
                      for s in range(3)])
    r = torch.from_numpy(np.random.default_rng(9).standard_normal(
        xs.shape[1:]).astype(np.float32))
    grad = torch.func.grad(_loss_port(tcfg, r), argnums=(0, 1))
    stacked = tree.map(lambda *a: torch.stack(a), *clients)
    vg_p, vg_x = torch.func.vmap(grad)(stacked, xs)
    for c in range(3):
        g_p, g_x = grad(clients[c], xs[c])
        for a, b in zip(tree.leaves(vg_p), tree.leaves(g_p)):
            np.testing.assert_allclose(_np(a[c]), _np(b), atol=1e-6,
                                       rtol=1e-5)
        np.testing.assert_allclose(_np(vg_x[c]), _np(g_x), atol=1e-6,
                                   rtol=1e-5)


def test_moe_init_gives_jax_s_tree():
    for name in MOE:
        for dtype in ("float32", "bfloat16"):
            jcfg, tcfg = _cfgs(name, dtype=dtype)
            want = jax.eval_shape(lambda k: jmoe.moe_init(k, jcfg),
                                  jax.random.PRNGKey(0))
            got = moe.moe_init(torch.Generator().manual_seed(0), tcfg)
            assert tree.structure(got) == tree.structure(want)
            for a, b in zip(tree.leaves(want), tree.leaves(got)):
                assert tuple(b.shape) == a.shape
                assert str(b.dtype) == f"torch.{a.dtype}"
            # the draws' scales: router 0.02, wi / wg 1/sqrt(d), wo 1/sqrt(f)
            f32 = moe.moe_init(torch.Generator().manual_seed(0),
                               dataclasses.replace(tcfg, dtype="float32"))
            d, f = tcfg.d_model, tcfg.d_ff
            for key, std in (("router", 0.02), ("wi", d ** -0.5),
                             ("wg", d ** -0.5), ("wo", f ** -0.5)):
                assert abs(float(f32[key].std()) / std - 1) < 0.1, key

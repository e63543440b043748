"""The port's flat wire format and aggregation against the JAX package's:
``FlatLayout`` buffers element for element, the local fold, the global
aggregate, and the tree helper's leaf order that both rest on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.flat import FlatLayout as JLayout
from repro_torch.core import aggregation as tagg
from repro_torch.core import tree
from repro_torch.core.flat import FlatLayout as TLayout


def _payload_np(rng, B=None):
    """A payload whose dicts are NOT in sorted insertion order: a layout
    that walked leaves in insertion order would permute every buffer."""
    lead = () if B is None else (B,)

    def a(*shape):
        return rng.normal(size=lead + shape).astype(np.float32)

    return {
        "delta": {"z": a(3, 2), "a": a(4), "m": {"y": a(2, 2), "b": a(5)}},
        "delta_c": {"k": a(3), "c": [a(2), a(1, 2)]},
        "full_grad": {"q": a(2)},
    }


def _ops(Op):
    return {"delta": Op.WEIGHTED_AVG, "delta_c": Op.AVG,
            "full_grad": Op.COLLECT}


def _to_jax(p):
    return jax.tree.map(jnp.asarray, p)


def _to_torch(p):
    return tree.map(lambda x: torch.from_numpy(np.array(x)), p)


def test_tree_order_is_jax_order():
    rng = np.random.default_rng(0)
    p = _payload_np(rng)
    jl = jax.tree.leaves(p)
    tl = tree.leaves(p)
    assert len(jl) == len(tl)
    for x, y in zip(jl, tl):
        assert x is y
    assert tree.leaves({"b": None, "a": [1, None, (2, 3)]}) == [1, 2, 3]
    mapped = tree.map(lambda x: x, {"b": 1, "a": 2})
    assert list(mapped) == ["a", "b"]        # rebuilt sorted, as JAX does
    leaves, td = tree.flatten(p)
    assert tree.structure(tree.unflatten(td, leaves)) == td


def test_layout_equals_jax_layout():
    rng = np.random.default_rng(1)
    p = _payload_np(rng)
    jl = JLayout.build(_ops(jagg.Op), _to_jax(p))
    tl = TLayout.build(_ops(tagg.Op), _to_torch(p))
    assert tl.group_sizes == jl.group_sizes
    assert tl.entry_order == jl.entry_order
    assert tl.signature() == jl.signature()
    for g in jl.specs:
        assert [(s.entry, s.index, s.offset, s.size, s.shape)
                for s in tl.specs[g]] == \
            [(s.entry, s.index, s.offset, s.size, s.shape)
             for s in jl.specs[g]]


def test_flatten_buffers_equal_jax_elementwise():
    rng = np.random.default_rng(2)
    p = _payload_np(rng)
    jl = JLayout.build(_ops(jagg.Op), _to_jax(p))
    tl = TLayout.build(_ops(tagg.Op), _to_torch(p))
    jb = jl.flatten(_to_jax(p))
    tb = tl.flatten(_to_torch(p))
    assert set(jb) == set(tb) == {"weighted", "unit"}
    for g in jb:
        np.testing.assert_array_equal(tb[g].numpy(), np.asarray(jb[g]))
    back = tl.unflatten(tb)
    for name in ("delta", "delta_c"):
        for x, y in zip(tree.leaves(back[name]), tree.leaves(p[name])):
            np.testing.assert_array_equal(x.numpy(), y)


def test_flatten_batch_equals_jax_elementwise():
    rng = np.random.default_rng(3)
    p1 = _payload_np(np.random.default_rng(9))
    pb = _payload_np(rng, B=3)
    jl = JLayout.build(_ops(jagg.Op), _to_jax(p1))
    tl = TLayout.build(_ops(tagg.Op), _to_torch(p1))
    jb = jl.flatten_batch(_to_jax(pb))
    tb = tl.flatten_batch(_to_torch(pb))
    for g in jb:
        assert tuple(tb[g].shape) == tuple(jb[g].shape)
        np.testing.assert_array_equal(tb[g].numpy(), np.asarray(jb[g]))


@pytest.mark.parametrize("mixed", [False, True])
def test_group_dtype_promotion(mixed):
    """All-bf16 entries keep a bf16 group buffer; bf16 + fp32 promotes to
    fp32 — as ``jnp.result_type`` does."""
    d = {"a": torch.ones(3, dtype=torch.bfloat16),
         "b": torch.ones(2, dtype=torch.float32 if mixed else torch.bfloat16)}
    tl = TLayout.build({"delta": tagg.Op.WEIGHTED_AVG}, {"delta": d})
    jl = JLayout.build({"delta": jagg.Op.WEIGHTED_AVG},
                       {"delta": {"a": jnp.ones(3, jnp.bfloat16),
                                  "b": jnp.ones(2, jnp.float32 if mixed
                                                else jnp.bfloat16)}})
    exp = torch.float32 if mixed else torch.bfloat16
    assert tl.group_dtypes["weighted"] == exp
    assert str(jl.group_dtypes["weighted"]) == str(exp).replace("torch.", "")
    assert tl.flatten({"delta": d})["weighted"].dtype == exp
    assert tl.zeros()["weighted"].dtype == torch.float32


def _results(rng, n):
    out = []
    for i in range(n):
        p = _payload_np(rng)
        out.append((p, float(10 + 3 * i)))
    return out


# tolerance: fp32 sums of the same products, folded in another grouping
# (the JAX side contracts w @ D, the port adds client by client)
def test_fold_and_global_aggregate_match_jax():
    rng = np.random.default_rng(4)
    res = _results(rng, 7)
    jparts, tparts = [], []
    for chunk in (res[:3], res[3:]):
        ja = jagg.LocalAggregator(_ops(jagg.Op), micro_batch=2)
        ta = tagg.LocalAggregator(_ops(tagg.Op), micro_batch=2)
        for p, w in chunk:
            ja.fold(jagg.ClientResult(_to_jax(p), _ops(jagg.Op), w))
            ta.fold(tagg.ClientResult(_to_torch(p), _ops(tagg.Op), w))
        jparts.append(ja.partial())
        tparts.append(ta.partial())
    jout = jagg.global_aggregate(jparts, _ops(jagg.Op))
    tout = tagg.global_aggregate(tparts, _ops(tagg.Op))
    for name in ("delta", "delta_c"):
        for x, y in zip(tree.leaves(tout[name]), jax.tree.leaves(jout[name])):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6,
                                       rtol=1e-5)
    assert len(tout["full_grad"]) == len(jout["full_grad"]) == 7
    assert tagg.payload_bytes(tparts[0]) == jagg.payload_bytes(jparts[0])


def test_fold_block_matches_per_client_folds():
    rng = np.random.default_rng(5)
    pb = _payload_np(rng, B=4)
    ws = [3.0, 5.0, 7.0, 11.0]
    blk = tagg.LocalAggregator(_ops(tagg.Op))
    blk.fold_block(_to_torch(pb), ws)
    one = tagg.LocalAggregator(_ops(tagg.Op), micro_batch=3)
    for i in range(4):
        one.fold(tagg.ClientResult(
            _to_torch(tree.map(lambda x: x[i], pb)), _ops(tagg.Op), ws[i]))
    a, b = blk.partial(), one.partial()
    for g in a["sums"]["buffers"]:
        torch.testing.assert_close(a["sums"]["buffers"][g],
                                   b["sums"]["buffers"][g],
                                   atol=1e-6, rtol=1e-6)
    assert a["weights"] == b["weights"] and a["counts"] == b["counts"]
    assert len(a["collected"]["full_grad"]) == 4


def test_exposed_partial_is_not_overwritten():
    """A partial that escaped through ``partial()`` keeps its values when
    the aggregator folds on (the fold then writes a fresh accumulator)."""
    ops = {"delta": tagg.Op.WEIGHTED_AVG}
    agg = tagg.LocalAggregator(ops, micro_batch=1)
    agg.fold(tagg.ClientResult({"delta": torch.ones(4)}, ops, 2.0))
    first = agg.partial()["sums"]["buffers"]["weighted"].clone()
    held = agg.partial()["sums"]["buffers"]["weighted"]
    agg.fold(tagg.ClientResult({"delta": torch.ones(4)}, ops, 3.0))
    torch.testing.assert_close(held, first)
    torch.testing.assert_close(agg.partial()["sums"]["buffers"]["weighted"],
                               torch.full((4,), 5.0))


def test_merge_and_tree_reduce_match_flat_left_fold():
    rng = np.random.default_rng(6)
    parts = []
    for i in range(5):
        a = tagg.LocalAggregator({"delta": tagg.Op.WEIGHTED_AVG})
        a.fold(tagg.ClientResult(
            {"delta": torch.from_numpy(
                rng.integers(-8, 8, size=6).astype(np.float32))},
            {"delta": tagg.Op.WEIGHTED_AVG}, float(i + 1)))
        parts.append(a.partial())
    ops = {"delta": tagg.Op.WEIGHTED_AVG}
    flat = tagg.global_aggregate(parts, ops)
    tree_out = tagg.global_aggregate(tagg.tree_reduce_partials(parts, 2), ops)
    # integer-valued payloads: exact in any summation order
    torch.testing.assert_close(flat["delta"], tree_out["delta"], atol=0,
                               rtol=0)
    with pytest.raises(ValueError):
        tagg.tree_reduce_partials(parts, 1)

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


def test_tree_helpers_leave_no_reference_cycle():
    """The leaves ``flatten``, ``leaves`` and ``unflatten`` touch are freed
    when the caller drops them, with the cycle collector off: a gradient
    tree passed through them is not held until the next collection (a
    train step's micro-batch gradients piled up so)."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        t = {"b": [torch.zeros(3), (torch.ones(2),)], "a": torch.zeros(1)}
        refs = [weakref.ref(x) for x in tree.leaves(t)]
        leaves, td = tree.flatten(t)
        rebuilt = tree.unflatten(td, leaves)
        del t, leaves, rebuilt
        assert [r() for r in refs] == [None] * 3
    finally:
        gc.enable()


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


# ---------------------------------------------------------------------------
# the block fold straight from the leaves (ops.agg_fold_leaves)
# ---------------------------------------------------------------------------

def _bf16_values(x):
    """fp32 numpy values that bf16 holds exactly (rounded once, by JAX)."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _block_case(case, rng):
    """(ops, stacked numpy payload, bf16 leaf paths, B, padded bucket) for
    a fold_block case: leaves with a leading client axis."""
    B = {"c1": 1, "c64": 64, "padded": 5}.get(case, 4)

    def a(*shape):
        return rng.normal(size=(B,) + shape).astype(np.float32)

    weighted = {"delta": _ops(jagg.Op)["delta"]}
    if case == "mixed":        # fp32 and bf16 leaves in one group
        p = {"delta": {"w": a(5, 4), "b": _bf16_values(a(7)), "s": a()}}
        return weighted, p, {("delta", "b")}, B, 0
    if case == "odd":          # odd sizes and a 0-d leaf a client
        p = {"delta": {"a": a(3, 3), "b": a(1), "c": a(), "d": a(13),
                       "e": a(2, 5, 3)}}
        return weighted, p, set(), B, 0
    if case == "bf16":         # an all-bf16 group stays bf16 into the fold
        p = {"delta": {"w": _bf16_values(a(6, 4)), "b": _bf16_values(a(9))}}
        return weighted, p, {("delta", "w"), ("delta", "b")}, B, 0
    if case == "scaffold":     # SCAFFOLD's unit group beside the weighted
        p = {"delta": {"w": a(4, 3), "b": a(3)},
             "delta_c": {"w": a(4, 3), "b": a(3)}}
        return ({"delta": jagg.Op.WEIGHTED_AVG, "delta_c": jagg.Op.AVG}, p,
                set(), B, 0)
    p = {"delta": {"w": a(8, 6), "b": a(6), "v": a(11)}}
    return weighted, p, set(), B, (8 if case == "padded" else 0)


def _block_to_torch(p, bf16_paths, pad):
    """The stacked payload as torch tensors; with ``pad`` each leaf is the
    ``x[:B]`` slice of a padded bucket whose extra rows hold garbage."""
    out = {}
    for name, entry in p.items():
        out[name] = {}
        for k, v in entry.items():
            t = torch.from_numpy(v.copy())
            if pad:
                big = torch.full((pad,) + tuple(t.shape[1:]), 1e30)
                big[:t.shape[0]] = t
                t = big[:t.shape[0]]
            if (name, k) in bf16_paths:
                t = t.to(torch.bfloat16)
            out[name][k] = t
    return out


def _block_to_jax(p, bf16_paths):
    return {name: {k: jnp.asarray(v, jnp.bfloat16 if (name, k) in bf16_paths
                                  else jnp.float32)
                   for k, v in entry.items()}
            for name, entry in p.items()}


def _t_ops(jops_):
    return {k: tagg.Op[v.name] for k, v in jops_.items()}


# tolerance: the test_kernels.py grid's (atol 1e-4, rtol 1e-4) — the Pallas
# body contracts w @ D, the port adds client by client; against the port's
# own flatten_batch + rows-form fold the bits must agree
@pytest.mark.parametrize("case", ["mixed", "odd", "bf16", "padded",
                                  "scaffold", "c1", "c64"])
def test_leaves_fold_block_matches_jax_and_flatten_path(case):
    rng = np.random.default_rng(11)
    jops_, p, bf16_paths, B, pad = _block_case(case, rng)
    ws = [float(x) for x in rng.uniform(1, 20, size=B).astype(np.float32)]
    ja = jagg.LocalAggregator(jops_, use_kernel=True)
    ja.fold_block(_block_to_jax(p, bf16_paths), ws)
    tstacked = _block_to_torch(p, bf16_paths, pad)
    ta = tagg.LocalAggregator(_t_ops(jops_))
    ta.fold_block(tstacked, ws)
    jpart, tpart = ja.partial(), ta.partial()
    jbufs, tbufs = jpart["sums"]["buffers"], tpart["sums"]["buffers"]
    assert set(jbufs) == set(tbufs)
    flat = ta.layout.flatten_batch(tstacked)
    for g, buf in tbufs.items():
        np.testing.assert_allclose(buf.numpy(), np.asarray(jbufs[g]),
                                   atol=1e-4, rtol=1e-4)
        w = ws if g == "weighted" else [1.0] * B
        ref = tagg.kops.agg_weighted_sum(
            torch.zeros(ta.layout.group_sizes[g]), flat[g], w)
        np.testing.assert_array_equal(buf.numpy().view(np.int32),
                                      ref.numpy().view(np.int32))
    assert tpart["weights"] == jpart["weights"]
    assert tpart["counts"] == jpart["counts"]


def test_batch_segments_tile_the_layout_as_flatten_batch_does():
    """The segments are the leaves in layout order at the spec offsets; a
    leaf the fold does not read (here int32) is cast as flatten_batch casts
    it, so the concatenated segments equal the (B, n) buffer."""
    rng = np.random.default_rng(12)
    p = {"delta": {"w": torch.from_numpy(rng.normal(size=(3, 4, 2))
                                         .astype(np.float32)),
                   "n": torch.from_numpy(rng.integers(-9, 9, size=(3, 5))
                                         .astype(np.int32)),
                   "b": torch.from_numpy(rng.normal(size=(3, 2))
                                         .astype(np.float32))
                   .to(torch.bfloat16)}}
    layout = TLayout.build({"delta": tagg.Op.WEIGHTED_AVG},
                           tree.map(lambda x: x[0], p))
    segs = layout.batch_segments(
        p, readable=(torch.float32, torch.bfloat16))["weighted"]
    specs = layout.specs["weighted"]
    assert [off for _, off in segs] == [s.offset for s in specs]
    assert [leaf.dtype for leaf, _ in segs] == [
        torch.bfloat16, torch.float32, torch.float32]      # b, n (cast), w
    cat = torch.cat([leaf.reshape(3, -1).float() for leaf, _ in segs], 1)
    np.testing.assert_array_equal(
        cat.numpy(), layout.flatten_batch(p)["weighted"].float().numpy())


def test_batch_segments_convert_leaves_that_differ_from_the_layout():
    """A leaf whose runtime dtype differs from the template's is converted
    as flatten_batch converts it (an fp32 leaf in a bf16 group is rounded
    to bf16), a numpy leaf becomes a tensor, a dtype the consumer does not
    read goes to fp32, and a leaf that matches stays the same tensor."""
    rng = np.random.default_rng(14)
    tmpl = {"delta": {"a": torch.zeros(3, dtype=torch.bfloat16),
                      "b": torch.zeros(2, dtype=torch.bfloat16)}}
    layout = TLayout.build({"delta": tagg.Op.WEIGHTED_AVG}, tmpl)
    a = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32)) \
        .to(torch.bfloat16)
    p = {"delta": {"a": a, "b": b}}
    both = (torch.float32, torch.bfloat16)
    segs = layout.batch_segments(p, readable=both)["weighted"]
    assert segs[0][0].dtype == torch.bfloat16           # a: rounded
    assert segs[1][0] is b                              # b: as it is
    cat = torch.cat([leaf.reshape(4, -1) for leaf, _ in segs], 1)
    assert torch.equal(cat, layout.flatten_batch(p)["weighted"])
    p_np = {"delta": {"a": a.numpy(), "b": b}}
    segs = layout.batch_segments(p_np, readable=both)["weighted"]
    assert torch.equal(segs[0][0], cat[:, :3])
    segs = layout.batch_segments(p, readable=(torch.float32,))["weighted"]
    assert [leaf.dtype for leaf, _ in segs] == [torch.float32] * 2
    assert torch.equal(torch.cat([leaf for leaf, _ in segs], 1),
                       cat.float())


def test_fold_block_past_64_clients_folds_in_parts():
    """A block of 70 clients folds as 64 + 6 through the leaves form: the
    same bits as one rows-form fold of the (70, n) buffer."""
    rng = np.random.default_rng(13)
    p = {"delta": {"w": torch.from_numpy(rng.normal(size=(70, 5, 3))
                                         .astype(np.float32)),
                   "b": torch.from_numpy(rng.normal(size=(70, 3))
                                         .astype(np.float32))}}
    ws = [float(x) for x in rng.uniform(1, 5, size=70).astype(np.float32)]
    ops = {"delta": tagg.Op.WEIGHTED_AVG}
    agg = tagg.LocalAggregator(ops)
    tagg.kops.reset_agg_counts()
    agg.fold_block(p, ws)
    assert tagg.kops.agg_dispatches == 2
    got = agg.partial()["sums"]["buffers"]["weighted"]
    ref = tagg.kops.agg_weighted_sum(torch.zeros(18),
                                     agg.layout.flatten_batch(p)["weighted"],
                                     ws)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.numpy().view(np.int32))

"""The port's compressed-wire path against the JAX package's, on the CPU.

The same numpy-made inputs go through both packages:

* the plain fused top-k against both JAX forms (the ``lax.top_k``
  reference and the Pallas kernel in interpret mode), bit for bit, with
  planted ties, ±0 and NaN payloads;
* the codecs (top-k, int8: bit for bit; PowerSGD: allclose, from the JAX
  Q0 handed over through ``load_state_dict``) over three rounds of
  residual accrual on a comp → raw → comp span layout with two groups;
* the wire consumers (``densify_buffer``, ``fold_buffer_into``,
  ``scale_buffer``, ``merge_partials``, ``scale_partial``) and the byte
  accounting (``_wire_bytes``, ``wire_bytes``);
* BSP rounds under a ``TickTimer`` with every compressor: makespans and
  ``comm_bytes`` identical, params allclose.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.aggregation as jagg
import repro.core.compression as jcomp
import repro_torch.core as T
import repro_torch.core.aggregation as tagg
import repro_torch.core.compression as tcomp
from repro.core.flat import FlatLayout as JLayout
from repro.core.flat import flat_sums as jflat_sums
from repro.data import make_classification_clients as jclients
from repro.kernels import topk_compress as jtk
from repro_torch.core.flat import FlatLayout as TLayout
from repro_torch.core.flat import flat_sums as tflat_sums
from repro_torch.core.flat import is_compressed_buffer
from repro_torch.data import make_classification_clients as tclients
from repro_torch.kernels import ops
from repro_torch.kernels.topk_compress import topk_with_residual_plain

# "skip" sits between the targeted "delta" and "aux" spans, so a plan with
# both targeted runs comp -> raw -> comp; "cnt" (SUM) is a second group
JOPS = {"delta": jagg.Op.WEIGHTED_AVG, "skip": jagg.Op.WEIGHTED_AVG,
        "aux": jagg.Op.WEIGHTED_AVG, "cnt": jagg.Op.SUM}
TOPS = {"delta": tagg.Op.WEIGHTED_AVG, "skip": tagg.Op.WEIGHTED_AVG,
        "aux": tagg.Op.WEIGHTED_AVG, "cnt": tagg.Op.SUM}
ENTRIES = ("delta", "aux", "cnt")


def _np_payload(seed):
    r = np.random.default_rng(seed)
    return {"delta": {"w": r.normal(size=(40, 7)).astype(np.float32),
                      "b": r.normal(size=(7,)).astype(np.float32)},
            "skip": r.normal(size=(33,)).astype(np.float32),
            "aux": r.normal(size=(55,)).astype(np.float32),
            "cnt": r.normal(size=(5,)).astype(np.float32)}


def _tree(fn, p):
    return {k: ({kk: fn(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else fn(v)) for k, v in p.items()}


JLAYOUT = JLayout.build(JOPS, _tree(jnp.asarray, _np_payload(0)))
TLAYOUT = TLayout.build(TOPS, _tree(torch.from_numpy, _np_payload(0)))


def _partials(seed, n_clients=1):
    """The same flat partial in both packages: (JAX, port)."""
    p = _np_payload(seed)
    meta = {"weights": {k: 1.0 for k in JOPS}, "counts": {k: 1 for k in JOPS},
            "collected": {}, "n_clients": n_clients}
    jp = dict(meta, sums=jflat_sums(dict(JLAYOUT.flatten(
        _tree(jnp.asarray, p)))), layout=JLAYOUT)
    tp = dict(meta, sums=tflat_sums(dict(TLAYOUT.flatten(
        _tree(torch.from_numpy, p)))), layout=TLAYOUT)
    return jp, tp


def _bits(x):
    """Bytes of an array or tensor: equal bytes is the bitwise claim."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_wires_equal(jbufs, tbufs):
    """Group by group: same segment kinds; raw and top-k/int8 data bit for
    bit, PowerSGD factors compared through their product."""
    assert set(jbufs) == set(tbufs)
    for g, jb in jbufs.items():
        tb = tbufs[g]
        assert jcomp.is_compressed_buffer(jb) == is_compressed_buffer(tb)
        if not is_compressed_buffer(tb):
            assert _bits(jb) == _bits(tb)
            continue
        assert jb["size"] == tb["size"]
        assert [k for k, _ in jb["segments"]] == [k for k, _ in tb["segments"]]
        for (kind, jx), (_, tx) in zip(jb["segments"], tb["segments"]):
            if kind == "raw":
                assert _bits(jx) == _bits(tx)
                continue
            assert jx.kind == tx.kind and tuple(jx.shape) == tuple(tx.shape)
            assert jx.nbytes == tx.nbytes
            if tx.kind == "powersgd":
                np.testing.assert_allclose(
                    np.asarray(jx.data["p"]) @ np.asarray(jx.data["q"]).T,
                    (tx.data["p"] @ tx.data["q"].T).numpy(),
                    atol=1e-5, rtol=1e-5)
            else:
                for key in jx.data:
                    assert _bits(jx.data[key]) == _bits(tx.data[key]), key


# ---------------------------------------------------------------------------
# the fused top-k
# ---------------------------------------------------------------------------

NAN_BITS = np.array([0x7FC00001, 0xFFC00002, 0x7F800003, 0x7FA00000,
                     0xFFFFFFFF], np.uint32)


def _topk_inputs(n, seed):
    """Values quantised to halves (many exact ties), planted -0.0/+0.0,
    NaNs with distinct payloads and signs, an inf, and a residual that is
    zero at half the positions."""
    r = np.random.default_rng(seed)
    x = (np.round(r.normal(size=n) * 2) / 2).astype(np.float32)
    x[r.integers(0, n, size=max(1, n // 50))] = -0.0
    x[r.integers(0, n, size=max(1, n // 50))] = 0.0
    pos = r.choice(n, size=min(n, len(NAN_BITS)), replace=False)
    x[pos] = NAN_BITS[:len(pos)].view(np.float32)
    x[r.integers(0, n)] = -np.inf
    res = np.where(r.random(n) < 0.5, 0.0,
                   np.round(r.normal(size=n) * 2) / 2).astype(np.float32)
    return x, res


@pytest.mark.parametrize("n,k", [(1, 1)] + [(n, k) for n in (300, 1000, 100001)
                                            for k in (1, 7, 64, n)])
def test_plain_topk_matches_both_jax_forms_bitwise(n, k):
    x, res = _topk_inputs(n, seed=n + k)
    jref = jtk.topk_with_residual_reference(jnp.asarray(x), jnp.asarray(res),
                                            k)
    jpal = jtk.topk_with_residual_pallas(jnp.asarray(x), jnp.asarray(res), k,
                                         interpret=True)
    mine = topk_with_residual_plain(torch.from_numpy(x),
                                    torch.from_numpy(res), k)
    for a, b, c in zip(jref, jpal, mine):
        assert _bits(a) == _bits(c)
        assert _bits(b) == _bits(c)
    assert mine[0].dtype == torch.int32 and mine[0].shape == (k,)


def test_topk_tie_rule_lower_index_wins():
    x = torch.tensor([2.0, -2.0, 2.0, 1.0])
    idx, vals, new_res = ops.fused_topk(x, torch.zeros(4), 2)
    assert idx.tolist() == [0, 1] and vals.tolist() == [2.0, -2.0]
    assert new_res.tolist() == [0.0, 0.0, 2.0, 1.0]
    jidx, jvals, _ = jtk.topk_with_residual_reference(
        jnp.asarray(x.numpy()), jnp.zeros(4), 2)
    assert np.asarray(jidx).tolist() == [0, 1]
    # -0.0 ties +0.0: the lower index wins whichever sign it carries
    idx, _, _ = ops.fused_topk(torch.tensor([1.0, 0.0, -0.0, 0.0]),
                               torch.zeros(4), 2)
    assert idx.tolist() == [0, 1]


def test_fused_topk_counts_and_updates_a_residual_view_in_place():
    r = np.random.default_rng(4)
    buf = torch.from_numpy(r.normal(size=50).astype(np.float32))
    res_buf = torch.from_numpy(r.normal(size=50).astype(np.float32))
    x, res = buf[5:37], res_buf[5:37]
    want = topk_with_residual_plain(x, res, 8)
    before = res_buf.clone()
    ops.reset_topk_counts()
    idx, vals, new_res = ops.fused_topk(x, res, 8, inplace=True)
    assert ops.topk_dispatches == 1 and ops.topk_launches == 0   # CPU: plain
    assert new_res.data_ptr() == res.data_ptr()
    for a, b in zip(want, (idx, vals, new_res)):
        assert _bits(a) == _bits(b)
    assert torch.equal(res_buf[:5], before[:5])
    assert torch.equal(res_buf[37:], before[37:])
    assert torch.equal(buf, torch.from_numpy(
        np.random.default_rng(4).normal(size=50).astype(np.float32)))


# ---------------------------------------------------------------------------
# codecs: port against JAX over three rounds of residual accrual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["topk", "int8"])
@pytest.mark.parametrize("compiled", [True, False])
def test_codec_matches_jax_bitwise(kind, compiled):
    """Three rounds: wire bytes, every segment and the decoded buffers."""
    arg = 0.25 if kind == "topk" else None
    jc = jcomp.make_compressor(kind, arg, entries=ENTRIES, compiled=compiled)
    tc = tcomp.make_compressor(kind, arg, entries=ENTRIES, compiled=compiled)
    for rnd in range(3):
        jp, tp = _partials(rnd)
        jw = jc.compress_partial(jp, key="exec0")
        tw = tc.compress_partial(tp, key="exec0")
        assert jw["_wire_bytes"] == tw["_wire_bytes"]
        assert jagg.wire_bytes(jw) == tagg.wire_bytes(tw)
        _assert_wires_equal(jw["sums"]["buffers"], tw["sums"]["buffers"])
        jd = jc.decompress_partial(jw)["sums"]["buffers"]
        td = tc.decompress_partial(tw)["sums"]["buffers"]
        for g in jd:
            jb = jcomp.densify_buffer(jd[g]) \
                if jcomp.is_compressed_buffer(jd[g]) else jd[g]
            tb = tcomp.densify_buffer(td[g]) \
                if is_compressed_buffer(td[g]) else td[g]
            if kind == "topk" and not compiled:
                # the eager decode assigns (keeps -0.0); compare values
                np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
            else:
                assert _bits(jb) == _bits(tb)
    if kind == "topk":
        js, ts = jc.state_dict(), tc.state_dict()
        assert set(js["residual"]) == set(ts["residual"])
        for key in js["residual"]:
            assert _bits(js["residual"][key]) == _bits(ts["residual"][key])


def test_eager_and_compiled_topk_agree_bitwise_within_the_port():
    eager = tcomp.TopKCompressor(0.25, entries=ENTRIES, compiled=False)
    comp = tcomp.make_compressor("topk", 0.25, entries=ENTRIES)
    assert comp.compiled
    for rnd in range(3):
        _, tp = _partials(rnd)
        we = eager.compress_partial(tp, key="exec0")
        wc = comp.compress_partial(tp, key="exec0")
        assert we["_wire_bytes"] == wc["_wire_bytes"]
        for g, be in we["sums"]["buffers"].items():
            bc = wc["sums"]["buffers"][g]
            for (ke, xe), (kc, xc) in zip(be["segments"], bc["segments"]):
                assert ke == kc
                if ke == "raw":
                    assert _bits(xe) == _bits(xc)
                else:
                    assert _bits(xe.data["idx"]) == _bits(xc.data["idx"])
                    assert _bits(xe.data["vals"]) == _bits(xc.data["vals"])
        de = eager.decompress_partial(we)["sums"]["buffers"]
        dc = comp.decompress_partial(wc)["sums"]["buffers"]
        for g in de:
            torch.testing.assert_close(de[g], tcomp.densify_buffer(dc[g]),
                                       atol=0, rtol=0)


def test_topk_state_carries_across_from_jax():
    """Two JAX rounds, then the JAX residuals go into the port through
    ``load_state_dict``: the third round's wires are bit-identical."""
    jc = jcomp.make_compressor("topk", 0.1, entries=ENTRIES)
    tc = tcomp.make_compressor("topk", 0.1, entries=ENTRIES)
    for rnd in range(2):
        jc.compress_partial(_partials(rnd)[0], key="exec1")
    tc.load_state_dict(jc.state_dict())
    jp, tp = _partials(2)
    _assert_wires_equal(jc.compress_partial(jp, key="exec1")["sums"]["buffers"],
                        tc.compress_partial(tp, key="exec1")["sums"]["buffers"])


def _powersgd_pair(rank, keys, layout_sizes, entries=ENTRIES):
    """A JAX and a port PowerSGD compressor starting from the JAX Q0 (the
    port's own Q0 comes from a torch.Generator, a different stream)."""
    jc = jcomp.make_compressor("powersgd", rank=rank, entries=entries)
    tc = tcomp.make_compressor("powersgd", rank=rank, entries=entries)
    state = {}
    for key, sz in zip(keys, layout_sizes):
        _, cols, r = jcomp._psgd_shape(sz, rank)
        state[key] = {"q": np.asarray(jc._init_q(key, cols, r)),
                      "res": np.zeros(sz, np.float32)}
    tc.load_state_dict({"kind": "powersgd", "state": state})
    return jc, tc


def test_powersgd_matches_jax_from_the_jax_q0():
    """Decoded update P Q'ᵀ and residuals allclose 1e-5 over three rounds
    (QR leaves column signs free, so P and Q are not compared alone; the
    matrix products sum in another order on each side)."""
    spans = {n: TLAYOUT.spans[n] for n in ENTRIES}
    keys = [f"exec0/{s.group}/{n}" for n, s in spans.items()]
    jc, tc = _powersgd_pair(2, keys, [s.size for s in spans.values()])
    for rnd in range(3):
        jp, tp = _partials(rnd)
        jw = jc.compress_partial(jp, key="exec0")
        tw = tc.compress_partial(tp, key="exec0")
        assert jw["_wire_bytes"] == tw["_wire_bytes"]
        _assert_wires_equal(jw["sums"]["buffers"], tw["sums"]["buffers"])
        for g, jb in jw["sums"]["buffers"].items():
            np.testing.assert_allclose(
                np.asarray(jcomp.densify_buffer(jb)),
                tcomp.densify_buffer(tw["sums"]["buffers"][g]).numpy(),
                atol=1e-5, rtol=1e-5)
        js, ts = jc.state_dict()["state"], tc.state_dict()["state"]
        for key in keys:
            np.testing.assert_allclose(js[key]["res"], ts[key]["res"],
                                       atol=1e-5, rtol=1e-5)


def test_powersgd_initial_q_is_seeded_per_span_key():
    tc = tcomp.PowerSGDCompressor(rank=2, seed=3)
    a = tc._init_q("exec0/weighted/delta", 5, 2, torch.device("cpu"))
    assert torch.equal(a, tc._init_q("exec0/weighted/delta", 5, 2,
                                     torch.device("cpu")))
    assert not torch.equal(a, tc._init_q("exec1/weighted/delta", 5, 2,
                                         torch.device("cpu")))


# ---------------------------------------------------------------------------
# wire consumers and byte accounting
# ---------------------------------------------------------------------------

def _wire_pair(kind, seed=0):
    """A compressed wire in both packages (PowerSGD from the JAX Q0)."""
    if kind == "powersgd":
        spans = {n: TLAYOUT.spans[n] for n in ENTRIES}
        jc, tc = _powersgd_pair(
            2, [f"exec0/{s.group}/{n}" for n, s in spans.items()],
            [s.size for s in spans.values()])
    else:
        arg = 0.25 if kind == "topk" else None
        jc = jcomp.make_compressor(kind, arg, entries=ENTRIES)
        tc = tcomp.make_compressor(kind, arg, entries=ENTRIES)
    jp, tp = _partials(seed, n_clients=3)
    return (jc.compress_partial(jp, key="exec0"),
            tc.compress_partial(tp, key="exec0"))


@pytest.mark.parametrize("kind", ["topk", "int8", "powersgd"])
def test_wire_consumers_match_jax(kind):
    """densify / fold / scale on the wire, and merge_partials /
    scale_partial over compressed partials.  Top-k is bit for bit (scatter-
    adds of the same values); int8 and PowerSGD folds are allclose 1e-6
    (XLA may contract q·scale + acc into one FMA, and the low-rank product
    sums in another order)."""
    jw, tw = _wire_pair(kind)
    exact = kind == "topk"

    def same(a, b, tol=1e-6):
        if exact:
            assert _bits(a) == _bits(b)
        else:
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=tol,
                                       rtol=tol)

    acc_np = np.random.default_rng(9).normal(size=TLAYOUT.group_sizes[
        "weighted"]).astype(np.float32)
    jb, tb = jw["sums"]["buffers"]["weighted"], tw["sums"]["buffers"][
        "weighted"]
    same(jcomp.densify_buffer(jb), tcomp.densify_buffer(tb))
    t_acc = torch.from_numpy(acc_np.copy())
    same(jcomp.fold_buffer_into(jnp.asarray(acc_np), jb),
         tcomp.fold_buffer_into(t_acc, tb))
    assert torch.equal(t_acc, torch.from_numpy(acc_np))       # acc untouched
    jsb, tsb = jcomp.scale_buffer(jb, 0.3), tcomp.scale_buffer(tb, 0.3)
    same(jcomp.densify_buffer(jsb), tcomp.densify_buffer(tsb))
    if kind != "powersgd":
        _assert_wires_equal({"g": jsb}, {"g": tsb})

    # merge two compressed partials (the second one folds in), then scale
    jw2, tw2 = _wire_pair(kind, seed=1)
    jm = jagg.merge_partials(jagg.merge_partials(None, jw), jw2)
    tm = tagg.merge_partials(tagg.merge_partials(None, tw), tw2)
    assert jm["n_clients"] == tm["n_clients"] == 6
    assert jm["weights"] == tm["weights"] and jm["counts"] == tm["counts"]
    for g in jm["sums"]["buffers"]:
        same(jm["sums"]["buffers"][g], tm["sums"]["buffers"][g], 1e-5)
    js, ts = jagg.scale_partial(jw, 0.5), tagg.scale_partial(tw, 0.5)
    assert js["weights"] == ts["weights"] and js["counts"] == ts["counts"]
    for g, b in js["sums"]["buffers"].items():
        jd = jcomp.densify_buffer(b) if jcomp.is_compressed_buffer(b) else b
        tb2 = ts["sums"]["buffers"][g]
        same(jd, tcomp.densify_buffer(tb2)
             if is_compressed_buffer(tb2) else tb2)
    # a dense partial scales in place of the wire, on the same fp32 factor
    jp, tp = _partials(2)
    for g, b in jagg.scale_partial(jp, 0.3)["sums"]["buffers"].items():
        assert _bits(b) == _bits(
            tagg.scale_partial(tp, 0.3)["sums"]["buffers"][g])
    assert tagg.staleness_weight(3, 0.5) == jagg.staleness_weight(3, 0.5)
    assert tagg.scale_partial(tp, 1.0) is tp


@pytest.mark.parametrize("kind", ["topk", "int8", "powersgd"])
def test_wire_bytes_match_jax(kind):
    jw, tw = _wire_pair(kind)
    assert jcomp._wire_bytes(jw["sums"]) == tcomp._wire_bytes(tw["sums"])
    assert jagg.wire_bytes(jw) == tagg.wire_bytes(tw)
    assert jagg.payload_bytes(jw) == tagg.payload_bytes(tw)
    jp, tp = _partials(0)
    assert jagg.wire_bytes(jp) == tagg.wire_bytes(tp)
    assert tagg.wire_bytes(tw) < tagg.wire_bytes(tp)


def test_codec_dispatches_are_per_group():
    tc = tcomp.make_compressor("topk", 0.25, entries=ENTRIES)
    tcomp.reset_codec_dispatch_count()
    ops.reset_topk_counts()
    _, tp = _partials(0)
    wire = tc.compress_partial(tp, key="exec0")
    assert tcomp.codec_dispatch_count() == 2       # two groups
    assert ops.topk_dispatches == 3                # one per targeted span
    tagg.reduce_flat_partials([wire], TOPS, tagg._sum_buffers)
    assert tcomp.codec_dispatch_count() == 4       # one densify per group


# ---------------------------------------------------------------------------
# BSP rounds against the JAX package
# ---------------------------------------------------------------------------

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

# name -> (algorithm, compressor kind, make_compressor arg/kw, fail_at)
ROUND_CASES = {
    "fedavg-topk": ("fedavg", "topk", {"arg": 0.25}, None),
    "scaffold-topk": ("scaffold", "topk",
                      {"arg": 0.25, "entries": ("delta", "delta_c")}, None),
    "fedavg-int8": ("fedavg", "int8", {}, None),
    "fedavg-powersgd": ("fedavg", "powersgd", {"rank": 2}, None),
    "fedavg-topk-failure": ("fedavg", "topk", {"arg": 0.25}, (2, (1, 1))),
}


def _compressed_servers(case, K=4, dim=16, n_classes=4):
    name, kind, kw, fail_at = ROUND_CASES[case]
    kw = dict(kw)
    arg = kw.pop("arg", None)
    out = []
    for pkg, comp, make, grad, params, dev in (
            (J, jcomp, jclients, JGRAD,
             {"w": jnp.zeros((dim, n_classes)), "b": jnp.zeros((n_classes,))},
             {}),
            (T, tcomp, tclients, TGRAD,
             {"w": torch.zeros(dim, n_classes), "b": torch.zeros(n_classes)},
             {"device": "cpu"})):
        data = make(60, dim=dim, n_classes=n_classes, mean_samples=30, seed=0)
        algo = pkg.make_algorithm(name, grad, lr=0.1, local_epochs=1)
        sm = pkg.ClientStateManager(tempfile.mkdtemp())
        timer = pkg.TickTimer(1.0)
        execs = [pkg.SequentialExecutor(k, algo, state_manager=sm,
                                        timer=timer, **dev) for k in range(K)]
        if fail_at is not None:
            execs[fail_at[0]].fail_at = fail_at[1]
        srv = pkg.ParrotServer(params=params, algorithm=algo,
                               executors=execs, data_by_client=data,
                               clients_per_round=16, seed=0,
                               compressor=comp.make_compressor(kind, arg,
                                                               **kw), **dev)
        out.append(srv)
    js, ts = out
    if kind == "powersgd":
        # hand the JAX Q0 of every (executor, span) to the port
        sz = dim * n_classes + n_classes
        keys = [f"exec{k}/weighted/delta" for k in range(K)]
        _, ts.compressor = _powersgd_pair(kw["rank"], keys, [sz] * K,
                                          js.compressor.entries)
    return js, ts


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_compressed_bsp_rounds_match_jax(case):
    """3 rounds under TickTimer: identical makespans, comm bytes and K;
    params allclose 1e-5 (1e-4 for PowerSGD: the QR and matrix products of
    each power-iteration step sum in another order on each side, and the
    warm start carries the difference from round to round)."""
    js, ts = _compressed_servers(case)
    ops.reset_topk_counts()
    for _ in range(3):
        js.run_round()
        ts.run_round()
    hist = lambda s: [(m.round, m.makespan, m.comm_bytes, m.comm_trips,
                       m.n_executors, m.failures) for m in s.history]
    assert hist(ts) == hist(js)
    assert [m.extra for m in ts.history] == [m.extra for m in js.history]
    tol = 1e-4 if "powersgd" in case else 1e-5
    for k in js.params:
        np.testing.assert_allclose(np.asarray(ts.params[k]),
                                   np.asarray(js.params[k]), atol=tol,
                                   rtol=tol)
    if "topk" in case:
        assert ops.topk_dispatches > 0 and ops.topk_launches == 0
    if "failure" in case:
        assert ts.history[1].failures == 1
        assert [m.n_executors for m in ts.history] == [4, 3, 3]


def test_server_builds_the_compiled_topk_codec_from_a_string():
    algo = T.make_algorithm("fedavg", TGRAD, lr=0.1)
    srv = T.ParrotServer(params={"w": torch.zeros(2)}, algorithm=algo,
                         executors=[], data_by_client={}, clients_per_round=1,
                         device="cpu", compressor="topk")
    assert isinstance(srv.compressor, T.TopKCompressor)
    assert srv.compressor.compiled and srv.compressor.fraction == 0.01
    assert T.ParrotServer(params={"w": torch.zeros(2)}, algorithm=algo,
                          executors=[], data_by_client={},
                          clients_per_round=1, device="cpu",
                          compressor="none").compressor is None
    for knob in ("control", "telemetry"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.ParrotServer(params={"w": torch.zeros(2)}, algorithm=algo,
                           executors=[], data_by_client={},
                           clients_per_round=1, device="cpu",
                           **{knob: object()})


@pytest.mark.parametrize("kind", ["topk", "int8", "powersgd"])
def test_server_takes_a_codec_object_as_is_and_it_runs_compiled(kind):
    """The port's codec objects default to the compiled path, the one that
    runs on the card, and the server keeps the object it was handed."""
    codec = {"topk": lambda: T.TopKCompressor(0.01),
             "int8": lambda: T.Int8Compressor(),
             "powersgd": lambda: T.PowerSGDCompressor(2)}[kind]()
    assert codec.compiled
    algo = T.make_algorithm("fedavg", TGRAD, lr=0.1)
    assert T.ParrotServer(params={"w": torch.zeros(2)}, algorithm=algo,
                          executors=[], data_by_client={},
                          clients_per_round=1, device="cpu",
                          compressor=codec).compressor is codec


def test_eager_topk_refuses_a_tensor_off_the_host():
    """The eager top-k reference works in host numpy: a tensor elsewhere
    (here on the meta device, on a card likewise) is refused, not copied
    to the host."""
    _, tp = _partials(0)
    off_host = dict(tp, sums=tflat_sums(
        {g: b.to("meta") for g, b in tp["sums"]["buffers"].items()}))
    eager = tcomp.TopKCompressor(0.25, entries=ENTRIES, compiled=False)
    with pytest.raises(ValueError, match="eager top-k"):
        eager.compress_partial(off_host, key="exec0")

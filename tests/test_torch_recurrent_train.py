"""Recurrent LM training in the port against the JAX package on the CPU.

* ``ssm_scan_bwd_plain`` -- the plain version of the scan's backward kernel
  -- against ``jax.vjp`` of ``repro.models.ssm.chunked_linear_scan`` (from a
  zero state) and of ``repro.kernels.ref.ssm_scan_ref``: fp32 and bf16, q and
  k shared by the heads (a stride of 0 along H), an fp32 k beside bf16 q and
  v, ``S % chunk != 0``, ``dh`` given and None;
* ``ops.ssm_scan``'s autograd Function (the card's saved tensors and vmap
  rules, with the plain backward in place of the kernel) under
  ``torch.func.vmap`` of ``torch.func.grad`` against a per-client loop;
* the sLSTM's chunk Function (JAX's per-chunk recompute) against
  ``slstm_apply_plain`` and JAX's ``slstm_apply``, values and gradients, at
  S = 48 (3 chunks of 16) and S = 40 (one chunk), and under ``vmap(grad)``;
* ``loss_and_aux`` and its gradients of reduced hymba-1.5b and xlstm-125m
  on the three attention routes against ``jax.value_and_grad``, and
  ``make_train_step`` with 1 and 4 micro-batches.

Tolerances: fp32 2e-5 absolute / 1e-4 relative where a single scan or cell
is compared (the same fp32 math summed in another order); bf16 inputs 2e-2
/ 1e-2 (``tests/test_kernels.py``'s bf16 bound); the models' losses 1e-5,
gradients and params 1e-5 / 1e-4 (as ``tests/test_torch_lm_train.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs.registry import ARCHS as JARCHS
from repro.kernels.ref import ssm_scan_ref
from repro.models import lm as jlm
from repro.models import ssm as jssm

import repro_torch.core as T
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_plain, ssm_scan_plain
from repro_torch.models import lm, ssm, transformer

F32, BF = torch.float32, torch.bfloat16
RECURRENT = ["hymba-1.5b", "xlstm-125m"]
LOSS_TOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4


def _tol(dtype):
    return (2e-5, 1e-4) if dtype == F32 else (2e-2, 1e-2)


def _close(got, want, tol):
    atol, rtol = tol
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _bf16_values(a):
    """numpy fp32 values rounded once to bf16 (by torch)."""
    return torch.from_numpy(a).to(BF).float().numpy()


# ---------------------------------------------------------------------------
# the scan's backward
# ---------------------------------------------------------------------------

# (B, S, H, N, P, chunk, q/v dtype, k dtype, q and k shared by the heads,
# dh given): three chunks with dh; S % chunk != 0 without; bf16 with q and k
# shared; the mLSTM's fp32 k beside bf16 q and v (P = N + 1); fp32 shared at
# a ragged S
SCAN_CASES = [(2, 48, 3, 8, 5, 16, F32, F32, False, True),
              (2, 40, 3, 8, 5, 16, F32, F32, False, False),
              (2, 48, 3, 8, 5, 16, BF, BF, True, False),
              (1, 32, 2, 16, 17, 16, BF, F32, False, True),
              (2, 33, 2, 8, 6, 16, F32, F32, True, True)]


def _scan_case(case, seed):
    """numpy inputs (q and k at one head when shared; bf16 operands rounded
    to bf16 values) and the cotangents."""
    B, S, H, N, P, _, dt, kdt, shared, with_dh = case
    rng = np.random.default_rng(seed)
    Hq = 1 if shared else H
    q = rng.standard_normal((B, S, Hq, N)).astype(np.float32)
    k = (0.3 * rng.standard_normal((B, S, Hq, N))).astype(np.float32)
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dh = rng.standard_normal((B, H, N, P)).astype(np.float32)
    if dt == BF:
        q, v, dy = _bf16_values(q), _bf16_values(v), _bf16_values(dy)
    if kdt == BF:
        k = _bf16_values(k)
    return q, k, v, la, dy, (dh if with_dh else np.zeros_like(dh))


def _jax_scan_vjp(case, q, k, v, la, dy, dh):
    """(dq, dk, dv, dlog_a) of JAX's chunked scan and of the sequential
    oracle, q and k broadcast over the heads inside (so a shared q's
    gradient is the sum over the heads)."""
    B, S, H, N, P, chunk, dt, kdt, _, _ = case
    jdt = {F32: jnp.float32, BF: jnp.bfloat16}
    cast = (lambda a, d: jnp.asarray(a).astype(jdt[d]))
    args = (cast(q, dt), cast(k, kdt), cast(v, dt), jnp.asarray(la))
    cot = (cast(dy, dt), jnp.asarray(dh))

    def chunked(q, k, v, la):
        q, k = (jnp.broadcast_to(t, (B, S, H, N)) for t in (q, k))
        return jssm.chunked_linear_scan(
            q, k, v, la, jnp.zeros((B, H, N, P), jnp.float32), chunk)

    def sequential(q, k, v, la):
        def heads(t):
            t = jnp.broadcast_to(t, (B, S, H) + t.shape[3:])
            return jnp.moveaxis(t, 2, 1).reshape((B * H, S) + t.shape[3:])
        y, h = ssm_scan_ref(heads(q), heads(k), heads(v),
                            jnp.moveaxis(la, 2, 1).reshape(B * H, S),
                            jnp.zeros((B * H, N, P), jnp.float32))
        return (jnp.moveaxis(y.reshape(B, H, S, P), 1, 2),
                h.reshape(B, H, N, P))

    return [jax.vjp(f, *args)[1](cot) for f in (chunked, sequential)]


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_ssm_scan_bwd_plain_matches_jax_vjp(case):
    B, S, H, N, P, chunk, dt, kdt, shared, with_dh = case
    q, k, v, la, dy, dh = _scan_case(case, seed=S + N)
    tq, tk = torch.from_numpy(q).to(dt), torch.from_numpy(k).to(kdt)
    if shared:
        tq, tk = tq.expand(B, S, H, N), tk.expand(B, S, H, N)
    got = ssm_scan_bwd_plain(torch.from_numpy(dy).to(dt),
                             torch.from_numpy(dh) if with_dh else None,
                             tq, tk, torch.from_numpy(v).to(dt),
                             torch.from_numpy(la), chunk)
    for g, ref, want_dt in zip(got, (tq, tk, None, None), (dt, kdt, dt, F32)):
        assert g.dtype == want_dt and g.is_contiguous()
        if ref is not None:
            assert g.shape == ref.shape
    if shared:            # what autograd's expand backward hands on
        got = (got[0].sum(2, keepdim=True), got[1].sum(2, keepdim=True),
               *got[2:])
    for want in _jax_scan_vjp(case, q, k, v, la, dy, dh):
        for g, w, d in zip(got, want, (dt, kdt, dt, F32)):
            _close(g, w, _tol(d) if not shared else
                   (_tol(d)[0] * H, _tol(d)[1]))


def test_scan_bwd_design_keys_on_shape_and_the_wrapper_aligns_rows():
    """The backward's chunk-resident design is chosen by dtypes and shapes
    alone (hymba's all-bf16 N = 16, P = 400; not xlstm's fp32 k, N = 384,
    nor a P that is no multiple of 8), and the wrapper hands it dy and v
    with 16-byte aligned rows: an aligned tensor as it is, a view at an odd
    offset as an aligned copy of the same values."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import bwd_resident
    bf = torch.bfloat16
    assert bwd_resident(bf, bf, bf, 16, 400)
    assert not bwd_resident(bf, F32, bf, 384, 385)
    assert not bwd_resident(bf, bf, bf, 16, 33)
    assert not bwd_resident(F32, F32, F32, 16, 400)
    base = torch.randn(2, 5, 3, 41, generator=torch.Generator().manual_seed(
        0)).to(bf)
    aligned = base[..., :40].contiguous()
    assert ops._rows_aligned(aligned) is aligned
    odd = base[..., 1:]
    assert odd.data_ptr() % 16
    copy = ops._rows_aligned(odd)
    assert copy.data_ptr() % 16 == 0 and copy.is_contiguous()
    assert torch.equal(copy, odd)


def test_ssm_scan_bwd_plain_is_autograd_of_the_plain_forward():
    """At a sequence whose masked decays stay finite (autograd of the plain
    forward differentiates ``exp`` of the masked entries too, so a long
    chunk's gradient is 0·inf there; the written-out backward never forms
    them)."""
    case = SCAN_CASES[0]
    q, k, v, la, dy, dh = map(torch.from_numpy, _scan_case(case, seed=5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, la)]
    y, h = ssm_scan_plain(*leaves, case[5])
    want = torch.autograd.grad((y, h), leaves, (dy, dh))
    got = ssm_scan_bwd_plain(dy, dh, q, k, v, la, case[5])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-4)


def _scan_loss(q, k, v, la, w):
    """A client's loss through ``ops.ssm_scan``: q and k broadcast over
    the heads; the outputs weighted so that every element's gradient
    differs, h_final included."""
    B, S, _, N = q.shape
    H = v.shape[2]
    y, h = ops.ssm_scan(q.expand(B, S, H, N), k.expand(B, S, H, N), v, la,
                        chunk=16)
    return (y * w).sum() + (h ** 2).sum() * 1e-2


def test_scan_function_under_vmap_grad_equals_a_per_client_loop():
    rng = np.random.default_rng(11)
    V, B, S, H, N, P = 3, 2, 40, 2, 8, 5
    q, k = (torch.from_numpy(rng.standard_normal((V, B, S, 1, N))
                             .astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((V, B, S, H, P))
                         .astype(np.float32))
    la = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((V, B, S, H)).astype(np.float32)))
    w = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    grad = torch.func.grad(_scan_loss, argnums=(0, 1, 2, 3))
    ops.reset_ssm_scan_counts()
    block = torch.func.vmap(grad, in_dims=(0, 0, 0, 0, None))(q, k, v, la, w)
    # one forward and one backward for the block, folded into the batch
    assert (ops.ssm_scan_dispatches, ops.ssm_scan_bwd_dispatches) == (1, 1)
    for i in range(V):
        loop = grad(q[i], k[i], v[i], la[i], w)
        for g, want in zip(block, loop):
            assert g[i].shape == want.shape
            torch.testing.assert_close(g[i], want, atol=2e-5, rtol=1e-4)
    # eager autograd takes the same Function
    leaves = [t[0].clone().requires_grad_() for t in (q, k, v, la)]
    _scan_loss(*leaves, w).backward()
    for t, want in zip(leaves, grad(q[0], k[0], v[0], la[0], w)):
        torch.testing.assert_close(t.grad, want, atol=0, rtol=0)
    assert ops.ssm_scan_bwd_dispatches == 1 + V + 2


@pytest.mark.parametrize("with_dh", [True, False])
def test_scan_vjp_under_vmap_of_cotangents_equals_a_loop(with_dh):
    """The forward once outside vmap, its vjp vmapped over V cotangents
    (what ``torch.func.jacrev`` does): the backward's vmap rule gets the
    saved tensors unbatched, and one backward call serves the block."""
    rng = np.random.default_rng(12)
    V, B, S, H, N, P = 3, 2, 40, 2, 8, 5
    q, k = (torch.from_numpy(rng.standard_normal((B, S, 1, N))
                             .astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    la = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H)).astype(np.float32)))
    dys = torch.from_numpy(rng.standard_normal((V, B, S, H, P))
                           .astype(np.float32))
    dhs = torch.from_numpy(rng.standard_normal((V, B, H, N, P))
                           .astype(np.float32)) * float(with_dh)

    def scan(q, k, v, la):
        return ops.ssm_scan(q.expand(B, S, H, N), k.expand(B, S, H, N), v,
                            la, chunk=16)

    ops.reset_ssm_scan_counts()
    _, vjp = torch.func.vjp(scan, q, k, v, la)
    block = torch.func.vmap(vjp)((dys, dhs))
    assert (ops.ssm_scan_dispatches, ops.ssm_scan_bwd_dispatches) == (1, 1)
    for i in range(V):
        for g, want in zip(block, vjp((dys[i], dhs[i]))):
            assert g[i].shape == want.shape
            torch.testing.assert_close(g[i], want, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the sLSTM's chunk Function
# ---------------------------------------------------------------------------

def _slstm(seed=0):
    jcfg = JARCHS["xlstm-125m"].reduced()
    tcfg = ARCHS["xlstm-125m"].reduced()
    jp = jssm.slstm_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


@pytest.mark.parametrize("S,chunks", [(48, 3), (40, 1)])
def test_slstm_chunks_match_plain_and_jax(S, chunks, monkeypatch):
    """Values equal the plain loop's bit for bit; the gradients of the
    params and of x equal autograd of the plain loop and ``jax.vjp`` of
    JAX's ``slstm_apply`` (JAX's chunk rule: 16 | 48 gives 3 chunks, 40
    one)."""
    jcfg, tcfg, jp, tp = _slstm()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    lens = []
    apply = ssm._SlstmChunkFn.apply
    monkeypatch.setattr(ssm._SlstmChunkFn, "apply",
                        lambda *a: lens.append(a[0].shape[1]) or apply(*a))

    def loss(fn):
        def f(p, x):
            y, st = fn(p, x, tcfg)
            return (y * torch.from_numpy(w)).sum() + st["h"].sum() \
                + st["c"].sum() * 1e-2
        return f

    y, st = ssm.slstm_apply(tp, torch.from_numpy(x), tcfg)
    assert lens == [S // chunks] * chunks
    y0, st0 = ssm.slstm_apply_plain(tp, torch.from_numpy(x), tcfg)
    assert torch.equal(y, y0)
    assert all(torch.equal(st[key], st0[key]) for key in "cnhm")
    got = torch.func.grad(loss(ssm.slstm_apply), argnums=(0, 1))(
        tp, torch.from_numpy(x))
    want = torch.func.grad(loss(ssm.slstm_apply_plain), argnums=(0, 1))(
        tp, torch.from_numpy(x))
    for g, wt in zip(tree.leaves(got), tree.leaves(want)):
        torch.testing.assert_close(g, wt, atol=2e-5, rtol=1e-4)

    def jloss(p, x):
        y, st = jssm.slstm_apply(p, x, jcfg)
        return (y * w).sum() + st["h"].sum() + st["c"].sum() * 1e-2

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    for g, wt in zip(tree.leaves(got), jax.tree.leaves(jg)):
        _close(g, wt, (2e-5, 1e-4))


def test_slstm_cell_gradient_splits_a_tie_as_jax_does():
    """At t = 0 from the zero state n == 1 exactly wherever gi >= log_f, and
    a planted gi == log_f ties m's maximum: the chunk Function's gradient is
    JAX's (half to each side) at every tie."""
    jcfg, tcfg, jp, tp = _slstm(seed=3)
    d = tcfg.d_model
    rng = np.random.default_rng(4)
    gx = rng.standard_normal((2, 3, 4 * d)).astype(np.float32)
    # gf = 0 and gi = log_sigmoid(0), the same fp32 value in both packages:
    # at t = 0 (h = m = 0) the maximum's two sides are equal
    log_f0 = float(torch.nn.functional.logsigmoid(torch.zeros(())))
    assert np.float32(jax.nn.log_sigmoid(jnp.float32(0.0))) == log_f0
    gx[:, 0, d:d + d // 2] = 0.0
    gx[:, 0, :d // 2] = log_f0
    wh = tp["wh"]["w"]
    st = ssm.slstm_init_state(tcfg, 2, F32)

    def loss(gx, wh):
        hs, *_ = ssm._SlstmChunkFn.apply(gx, wh, st["c"], st["n"], st["h"],
                                         st["m"])
        return (hs ** 2).sum()

    got = torch.func.grad(loss, argnums=(0, 1))(torch.from_numpy(gx), wh)

    def jcells(gx, wh):
        s = jssm.slstm_init_state(jcfg, 2, jnp.float32)
        out = 0.0
        for t in range(3):     # JAX's cell with the gates handed in
            gates = gx[:, t] + s["h"] @ wh
            gi, gf, gz, go = jnp.split(gates, 4, axis=-1)
            log_f = jax.nn.log_sigmoid(gf)
            m = jnp.maximum(log_f + s["m"], gi)
            i_p, f_p = jnp.exp(gi - m), jnp.exp(log_f + s["m"] - m)
            c = f_p * s["c"] + i_p * jnp.tanh(gz)
            n = f_p * s["n"] + i_p
            h = jax.nn.sigmoid(go) * c / jnp.maximum(n, 1.0)
            s = {"c": c, "n": n, "h": h, "m": m}
            out = out + (h ** 2).sum()
        return out

    want = jax.grad(jcells, argnums=(0, 1))(jnp.asarray(gx),
                                            jnp.asarray(wh.numpy()))
    for g, w in zip(got, want):
        _close(g, w, (2e-5, 1e-4))


def test_slstm_chunks_under_vmap_grad_equal_a_per_client_loop():
    """Each client its own wh (the client engine's vmap over params)."""
    _, tcfg, _, tp = _slstm(seed=1)
    V, S = 3, 48
    rng = np.random.default_rng(9)
    ps = tree.map(lambda t: torch.stack([
        t + 0.05 * torch.from_numpy(rng.standard_normal(t.shape)
                                    .astype(np.float32)) for _ in range(V)]),
        tp)
    x = torch.from_numpy(rng.standard_normal((V, 2, S, tcfg.d_model))
                         .astype(np.float32))

    def loss(p, x):
        y, st = ssm.slstm_apply(p, x, tcfg)
        return (y ** 2).sum() + st["n"].sum()

    grad = torch.func.grad(loss, argnums=(0, 1))
    block = torch.func.vmap(grad)(ps, x)
    for i in range(V):
        loop = grad(tree.map(lambda t: t[i], ps), x[i])
        for g, w in zip(tree.leaves(block), tree.leaves(loop)):
            torch.testing.assert_close(g[i], w, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _cfgs(name, impl="pallas", **kw):
    return (dataclasses.replace(JARCHS[name].reduced(), **kw),
            dataclasses.replace(ARCHS[name].reduced(), attention_impl=impl,
                                **kw))


def _params(jcfg, seed=0):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("inputs", "labels")}


def _close_trees(got, want, atol=ATOL, rtol=RTOL):
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol)


def _scan_layers(cfg):
    """Layers whose mixer runs the scan: every hymba layer (its mamba
    heads), xlstm's mLSTM layers."""
    return transformer.n_rep(cfg) * sum(
        kind in ("hybrid", "mlstm") for kind in transformer.unit_pattern(cfg))


@pytest.mark.parametrize("impl", ["pallas", "chunked", "dense"])
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_loss_and_grads_match_jax(name, impl):
    """S = 48: three scan chunks and three sLSTM chunks of 16."""
    jcfg, tcfg = _cfgs(name, impl)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 2, 48, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_and_aux(p, b, jcfg)))(
            jp, jax.tree.map(jnp.asarray, batch))
    ops.reset_ssm_scan_counts()
    tl, tg = T.value_and_grad(lambda p, b: lm.loss_and_aux(p, b, tcfg))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), atol=LOSS_TOL, rtol=0)
    assert tree.structure(tg) == tree.structure(tp)
    _close_trees(tg, jg)
    # every scan went forward and backward through the scan's Function
    n = _scan_layers(tcfg)
    assert n > 0
    assert (ops.ssm_scan_dispatches, ops.ssm_scan_bwd_dispatches) == (n, n)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


@pytest.mark.parametrize("micro", [1, 4])
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_train_step_matches_jax(name, micro):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 4, 32, seed=3)
    jstep = jax.jit(jlm.make_train_step(jcfg, lr=0.05, micro_batches=micro))
    tstep = lm.make_train_step(tcfg, lr=0.05, micro_batches=micro)
    for _ in range(2):
        jp, jm = jstep(jp, jax.tree.map(jnp.asarray, batch))
        tp, tm = tstep(tp, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=LOSS_TOL, rtol=0)
        _close_trees(tp, jp)

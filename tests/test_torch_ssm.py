"""The port's recurrent mixers (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``, on the same numpy inputs and the same
params (JAX's ``*_init``, carried over with ``params_from_jax``), at the
reduced hymba-1.5b and xlstm-125m configs.

On CPU tensors the prefill scan goes through ``ops.ssm_scan``'s plain
version and every decode step through the plain chunked form; the JAX
side runs its own ``chunked_linear_scan``.

Tolerances: 1e-5 in fp32 (the same fp32 arithmetic summed in another
order; 1e-4 on the scans' states, which sum over whole sequences); in bf16
2e-2, with every output and state in JAX's dtype — the two frameworks
round bf16 at other places (XLA on the CPU keeps fused elementwise chains
in fp32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import ssm as jssm
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm

ATOL = 1e-5
BF16_ATOL = 2e-2
B, S = 2, 48          # three chunks of the reduced configs' 16


def _cfgs(name, **kw):
    return (dataclasses.replace(JARCHS[name].reduced(), **kw),
            dataclasses.replace(ARCHS[name].reduced(), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    t = params_from_jax(np.asarray(a), "cpu")
    return t if dtype is None else t.to(dtype)


def _close(got, want, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _x(shape, seed, bf16=False):
    """numpy normals; with ``bf16`` rounded once to bf16 values (by JAX)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if bf16:
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _mixer(name, kind, dtype="float32", seed=0):
    """(jcfg, tcfg, JAX params, port params) of one mixer."""
    jcfg, tcfg = _cfgs(name, dtype=dtype)
    init = {"mamba": jssm.mamba_init, "mlstm": jssm.mlstm_init,
            "slstm": jssm.slstm_init}[kind]
    jp = init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_np(jp), "cpu")


def _state_close(got, want, atol):
    assert sorted(got) == sorted(want)
    for key in want:
        assert str(got[key].dtype) == f"torch.{want[key].dtype}", key
        _close(got[key], want[key], atol=atol, rtol=1e-4)


# ---------------------------------------------------------------------------
# the shared scan
# ---------------------------------------------------------------------------

def _scan_inputs(S_, H, N, P, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S_, H, N)).astype(np.float32)
    k = (rng.normal(size=(B, S_, H, N)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, S_, H, P)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.normal(size=(B, S_, H))).astype(np.float32)
    h0 = rng.normal(size=(B, H, N, P)).astype(np.float32)
    return q, k, v, la, h0


@pytest.mark.parametrize("S_,chunk", [(64, 16), (40, 16), (1, 16), (12, 16)])
def test_chunked_linear_scan_matches_jax(S_, chunk):
    """With a carried state (the decode route: the plain chunked form) and
    from zero (the prefill route: ``ops.ssm_scan``)."""
    q, k, v, la, h0 = _scan_inputs(S_, 2, 8, 16, S_)
    tq, tk, tv, tla, th0 = map(torch.from_numpy, (q, k, v, la, h0))
    jargs = tuple(map(jnp.asarray, (q, k, v, la)))
    for h_in, jh_in in ((th0, jnp.asarray(h0)),
                        (None, jnp.zeros(h0.shape, jnp.float32))):
        y, h = ssm.chunked_linear_scan(tq, tk, tv, tla, h_in, chunk)
        wy, wh = jssm.chunked_linear_scan(*jargs, jh_in, chunk)
        _close(y, wy, atol=1e-4, rtol=1e-4)
        _close(h, wh, atol=1e-4, rtol=1e-4)


def test_sequential_scan_and_step_match_jax():
    q, k, v, la, h0 = _scan_inputs(10, 2, 8, 16, 1)
    y, h = ssm.sequential_linear_scan(*map(torch.from_numpy,
                                           (q, k, v, la, h0)))
    wy, wh = jssm.sequential_linear_scan(*map(jnp.asarray,
                                              (q, k, v, la, h0)))
    _close(y, wy)
    _close(h, wh)
    a = np.exp(la[:, 0])
    y1, h1 = ssm.linear_scan_step(*map(torch.from_numpy,
                                       (q[:, 0], k[:, 0], v[:, 0], a, h0)))
    wy1, wh1 = jssm.linear_scan_step(*map(jnp.asarray,
                                          (q[:, 0], k[:, 0], v[:, 0], a, h0)))
    _close(y1, wy1)
    _close(h1, wh1)


def test_chunked_scan_matches_the_sequential_recurrence():
    """The port's two forms of one recurrence, from a carried state."""
    q, k, v, la, h0 = map(torch.from_numpy, _scan_inputs(48, 2, 8, 16, 2))
    y, h = ssm.chunked_linear_scan(q, k, v, la, h0, 16)
    ys, hs = ssm.sequential_linear_scan(q, k, v, la, h0)
    _close(y, ys.numpy(), atol=1e-4, rtol=1e-4)
    _close(h, hs.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("stream", [False, True])
def test_causal_conv_matches_jax(stream):
    x = _x((B, 6, 16), 3)
    w = _x((4, 16), 4)
    st = _x((B, 3, 16), 5) if stream else None
    y, new = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              None if st is None else torch.from_numpy(st))
    wy, wnew = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 None if st is None else jnp.asarray(st))
    _close(y, wy)
    if stream:
        _close(new, wnew)
    else:
        assert new is None and wnew is None


# ---------------------------------------------------------------------------
# mixers, fp32
# ---------------------------------------------------------------------------

def test_mamba_apply_and_step_match_jax():
    jcfg, tcfg, jp, tp = _mixer("hymba-1.5b", "mamba")
    x = _x((B, S, tcfg.d_model), 6)
    y, (conv, h) = ssm.mamba_apply(tp, torch.from_numpy(x), tcfg)
    wy, (wconv, wh) = jssm.mamba_apply(jp, jnp.asarray(x), jcfg)
    assert conv is None and wconv is None
    _close(y, wy)
    _close(h, wh, atol=1e-4, rtol=1e-4)
    # a decode step from a random state
    sc = tcfg.ssm
    di = sc.expand * tcfg.d_model
    state = {"conv": _x((B, sc.d_conv - 1, di), 7),
             "h": _x((B, sc.n_heads, sc.d_state, di // sc.n_heads), 8)}
    xt = _x((B, 1, tcfg.d_model), 9)
    y1, st = ssm.mamba_step(tp, torch.from_numpy(xt),
                            {k: torch.from_numpy(v) for k, v in state.items()},
                            tcfg)
    wy1, wst = jssm.mamba_step(jp, jnp.asarray(xt),
                               {k: jnp.asarray(v) for k, v in state.items()},
                               jcfg)
    _close(y1, wy1)
    _state_close(st, wst, ATOL)


def test_mlstm_apply_and_step_match_jax():
    jcfg, tcfg, jp, tp = _mixer("xlstm-125m", "mlstm")
    x = _x((B, S, tcfg.d_model), 10)
    y, h = ssm.mlstm_apply(tp, torch.from_numpy(x), tcfg)
    wy, wh = jssm.mlstm_apply(jp, jnp.asarray(x), jcfg)
    _close(y, wy)
    _close(h, wh, atol=1e-4, rtol=1e-4)
    st0 = jssm.mlstm_init_state(jcfg, B, jnp.float32)
    h0 = _x(st0["h"].shape, 11) * 0.1
    xt = _x((B, 1, tcfg.d_model), 12)
    y1, st = ssm.mlstm_step(tp, torch.from_numpy(xt),
                            {"h": torch.from_numpy(h0)}, tcfg)
    wy1, wst = jssm.mlstm_step(jp, jnp.asarray(xt), {"h": jnp.asarray(h0)},
                               jcfg)
    _close(y1, wy1)
    _state_close(st, wst, ATOL)


def test_slstm_apply_and_step_match_jax():
    jcfg, tcfg, jp, tp = _mixer("xlstm-125m", "slstm")
    x = _x((B, S, tcfg.d_model), 13)
    y, st = ssm.slstm_apply(tp, torch.from_numpy(x), tcfg)
    wy, wst = jssm.slstm_apply(jp, jnp.asarray(x), jcfg)
    _close(y, wy)
    _state_close(st, wst, ATOL)
    xt = _x((B, 1, tcfg.d_model), 14)
    y1, st1 = ssm.slstm_step(tp, torch.from_numpy(xt), st, tcfg)
    wy1, wst1 = jssm.slstm_step(jp, jnp.asarray(xt), wst, jcfg)
    _close(y1, wy1)
    _state_close(st1, wst1, ATOL)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_prefill_state_then_step_equals_the_longer_prefill(kind):
    """The port's own serving invariant: a prefill over S tokens, then one
    step from its state, gives the last output of a prefill over S + 1."""
    name = "hymba-1.5b" if kind == "mamba" else "xlstm-125m"
    _, tcfg, _, tp = _mixer(name, kind, seed=1)
    x = torch.from_numpy(_x((B, S + 1, tcfg.d_model), 15))
    if kind == "mamba":
        K = tcfg.ssm.d_conv
        _, (_, h) = ssm.mamba_apply(tp, x[:, :S], tcfg)
        xs, _ = torch.chunk(x[:, S - K + 1:S] @ tp["in_proj"]["w"], 2, -1)
        y1, _ = ssm.mamba_step(tp, x[:, S:], {"conv": xs, "h": h}, tcfg)
        full, _ = ssm.mamba_apply(tp, x, tcfg)
    elif kind == "mlstm":
        _, h = ssm.mlstm_apply(tp, x[:, :S], tcfg)
        y1, _ = ssm.mlstm_step(tp, x[:, S:], {"h": h}, tcfg)
        full, _ = ssm.mlstm_apply(tp, x, tcfg)
    else:
        _, st = ssm.slstm_apply(tp, x[:, :S], tcfg)
        y1, _ = ssm.slstm_step(tp, x[:, S:], st, tcfg)
        full, _ = ssm.slstm_apply(tp, x, tcfg)
    _close(y1[:, 0], full[:, S].numpy(), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# bf16: dtypes of every output and state, values within 2e-2
# ---------------------------------------------------------------------------

def test_bf16_mixers_keep_jax_dtypes():
    bf = torch.bfloat16
    x = _x((B, S, 64), 16, bf16=True)
    xt = _x((B, 1, 64), 17, bf16=True)
    jx, jxt = jnp.asarray(x, jnp.bfloat16), jnp.asarray(xt, jnp.bfloat16)
    tx, txt = _t(x, bf), _t(xt, bf)

    def same(got, want):
        assert str(got.dtype) == f"torch.{want.dtype}"
        _close(got, want.astype(jnp.float32), atol=BF16_ATOL, rtol=BF16_ATOL)

    jcfg, tcfg, jp, tp = _mixer("hymba-1.5b", "mamba", "bfloat16")
    assert tp["log_neg_a"].dtype == torch.float32
    assert tp["d_skip"].dtype == torch.float32
    y, (_, h) = ssm.mamba_apply(tp, tx, tcfg)
    wy, (_, wh) = jssm.mamba_apply(jp, jx, jcfg)
    same(y, wy)
    same(h, wh)
    wst0 = jssm.mamba_init_state(jcfg, B, jnp.bfloat16)
    st0 = ssm.mamba_init_state(tcfg, B, bf)
    y1, st = ssm.mamba_step(tp, txt, {"conv": _t(_np(wst0["conv"])),
                                      "h": h}, tcfg)
    wy1, wst = jssm.mamba_step(jp, jxt, {"conv": wst0["conv"], "h": wh},
                               jcfg)
    assert {k: v.dtype for k, v in st0.items()} == \
        {k: v.dtype for k, v in st.items()}
    same(y1, wy1)
    for key in wst:
        same(st[key], wst[key])

    jcfg, tcfg, jp, tp = _mixer("xlstm-125m", "mlstm", "bfloat16")
    y, h = ssm.mlstm_apply(tp, tx, tcfg)
    wy, wh = jssm.mlstm_apply(jp, jx, jcfg)
    same(y, wy)
    same(h, wh)
    y1, st = ssm.mlstm_step(tp, txt, {"h": h}, tcfg)
    wy1, wst = jssm.mlstm_step(jp, jxt, {"h": wh}, jcfg)
    same(y1, wy1)
    same(st["h"], wst["h"])

    jcfg, tcfg, jp, tp = _mixer("xlstm-125m", "slstm", "bfloat16")
    y, st = ssm.slstm_apply(tp, tx, tcfg)
    wy, wst = jssm.slstm_apply(jp, jx, jcfg)
    same(y, wy)
    y1, st1 = ssm.slstm_step(tp, txt, st, tcfg)
    wy1, wst1 = jssm.slstm_step(jp, jxt, wst, jcfg)
    same(y1, wy1)
    for key in wst1:
        same(st[key], wst[key])
        same(st1[key], wst1[key])

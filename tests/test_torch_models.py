"""The port's LM layers and attention layer against the JAX package, on the
same numpy inputs and the same params (carried over with
``params_from_jax``).  The JAX ``pallas`` impl runs its Pallas kernel in
interpret mode; the port's runs the kernel's plain version (CPU tensors).

Tolerance: fp32 atol 1e-5 — both sides compute the same fp32 arithmetic,
summed in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models import attention, layers

ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-5)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32) * 3
    g = rng.normal(size=(64,)).astype(np.float32)
    _close(layers.rmsnorm({"g": torch.from_numpy(g)}, torch.from_numpy(x)),
           jlayers.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x)))


def test_rmsnorm_bf16_computes_in_fp32_and_casts_back():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    got = layers.rmsnorm({"g": torch.ones(64, dtype=torch.bfloat16)},
                         torch.from_numpy(xb).to(torch.bfloat16))
    want = jlayers.rmsnorm({"g": jnp.ones(64, jnp.bfloat16)},
                           jnp.asarray(xb, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # the same fp32 values rounded once to bf16: at most one bf16 step
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) + 1.5
    p = {"g": rng.normal(size=(32,)).astype(np.float32),
         "b": rng.normal(size=(32,)).astype(np.float32)}
    _close(layers.layernorm(params_from_jax(p, "cpu"), torch.from_numpy(x)),
           jlayers.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))


@pytest.mark.parametrize("offset", [0, 5, 1000])
def test_apply_rope_matches_jax(offset):
    """Halves rotated (not interleaved pairs), fp32 angles."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + offset
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             10000.0),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def test_rope_freqs_match_jax():
    _close(layers.rope_freqs(64, 500000.0), jlayers.rope_freqs(64, 500000.0))


def test_swiglu_matches_jax():
    rng = np.random.default_rng(4)
    p = jlayers.swiglu_init(jax.random.PRNGKey(0), 64, 128, jnp.float32)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32)
    _close(layers.swiglu(params_from_jax(_np(p), "cpu"), torch.from_numpy(x)),
           jlayers.swiglu(p, jnp.asarray(x)))


def test_dense_with_bias_matches_jax():
    rng = np.random.default_rng(5)
    p = {"w": rng.normal(size=(64, 32)).astype(np.float32),
         "b": rng.normal(size=(32,)).astype(np.float32)}
    x = rng.normal(size=(4, 64)).astype(np.float32)
    _close(layers.dense(params_from_jax(p, "cpu"), torch.from_numpy(x)),
           jlayers.dense(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))


def test_embed_matches_jax():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(256, 64)).astype(np.float32)
    ids = rng.integers(0, 256, size=(3, 11)).astype(np.int32)
    got = layers.embed({"w": torch.from_numpy(w)}, torch.from_numpy(ids))
    want = jlayers.embed({"w": jnp.asarray(w)}, jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------------

B, S = 2, 32


def _attn_setup(impl, window=0):
    """qwen2-0.5b reduced (GQA 4/2 heads, hd 16, QKV bias), random biases,
    in both packages."""
    jcfg = dataclasses.replace(JARCHS["qwen2-0.5b"].reduced(),
                               attention_impl=impl, sliding_window=window)
    tcfg = dataclasses.replace(ARCHS["qwen2-0.5b"].reduced(),
                               attention_impl=impl, sliding_window=window)
    rng = np.random.default_rng(7)
    p = _np(jattn.attn_init(jax.random.PRNGKey(1), jcfg))
    for name in ("wq", "wk", "wv"):
        p[name]["b"] = rng.normal(size=p[name]["b"].shape).astype(np.float32)
    x = rng.normal(size=(B, S + 1, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), params_from_jax(p, "cpu"), x


def _cache_close(tc, jc):
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("impl", ["pallas", "chunked", "dense"])
@pytest.mark.parametrize("mode", ["no cache", "prefill", "decode"])
def test_attention_layer_matches_jax(mode, impl):
    """The layer in all three modes: training (no cache), prefill (cache
    filled, longer than the prompt) and decode (one token over the cache).
    The decode step ignores ``impl``, in both packages."""
    jcfg, tcfg, jp, tp, x = _attn_setup(impl)
    pos = np.arange(S, dtype=np.int32)
    xs = x[:, :S]
    if mode == "no cache":
        want, _ = jattn.attention(jp, jnp.asarray(xs), jcfg,
                                  positions=jnp.asarray(pos))
        got, cache = attention.attention(tp, torch.from_numpy(xs), tcfg,
                                         positions=torch.from_numpy(pos))
        assert cache is None
        _close(got, want)
        return
    jc = jattn.init_cache(jcfg, B, S + 1, jnp.float32)
    tc = attention.init_cache(tcfg, B, S + 1, torch.float32)
    want, jc = jattn.attention(jp, jnp.asarray(xs), jcfg,
                               positions=jnp.asarray(pos), cache=jc,
                               cache_index=0)
    got, tc = attention.attention(tp, torch.from_numpy(xs), tcfg,
                                  positions=torch.from_numpy(pos), cache=tc,
                                  cache_index=0)
    if mode == "decode":
        step = np.array([S], np.int32)
        want, jc = jattn.attention(jp, jnp.asarray(x[:, S:]), jcfg,
                                   positions=jnp.asarray(step), cache=jc,
                                   cache_index=jnp.int32(S))
        got, tc = attention.attention(tp, torch.from_numpy(x[:, S:]), tcfg,
                                      positions=torch.from_numpy(step),
                                      cache=tc, cache_index=S)
    _close(got, want)
    _cache_close(tc, jc)


def test_attention_sliding_window_ring_matches_jax():
    """Window 16 < prompt 32: the prefill writes the tail at its ring
    slots, and three decode steps wrap the ring further."""
    jcfg, tcfg, jp, tp, x = _attn_setup("chunked", window=16)
    pos = np.arange(S, dtype=np.int32)
    jc = jattn.init_cache(jcfg, B, S + 3, jnp.float32)
    tc = attention.init_cache(tcfg, B, S + 3, torch.float32)
    assert tuple(tc["k"].shape) == jc["k"].shape == (B, 16, 2, 16)
    want, jc = jattn.attention(jp, jnp.asarray(x[:, :S]), jcfg,
                               positions=jnp.asarray(pos), cache=jc,
                               cache_index=0)
    got, tc = attention.attention(tp, torch.from_numpy(x[:, :S]), tcfg,
                                  positions=torch.from_numpy(pos), cache=tc,
                                  cache_index=0)
    _close(got, want)
    _cache_close(tc, jc)
    rng = np.random.default_rng(8)
    for t in range(S, S + 3):
        xt = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        step = np.array([t], np.int32)
        want, jc = jattn.attention(jp, jnp.asarray(xt), jcfg,
                                   positions=jnp.asarray(step), cache=jc,
                                   cache_index=jnp.int32(t))
        got, tc = attention.attention(tp, torch.from_numpy(xt), tcfg,
                                      positions=torch.from_numpy(step),
                                      cache=tc, cache_index=t)
        _close(got, want)
        _cache_close(tc, jc)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("chunk", [8, 32])
def test_attention_impls_match_jax(window, chunk):
    """``dense_attention`` and ``chunked_attention`` on (B, S, H, hd)
    against their JAX counterparts, and against each other."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    dense = attention.dense_attention(tq, tk, tv, causal=True, window=window)
    chunked = attention.chunked_attention(tq, tk, tv, causal=True,
                                          window=window, chunk=chunk)
    _close(dense, jattn.dense_attention(jq, jk, jv, causal=True,
                                        window=window))
    _close(chunked, jattn.chunked_attention(jq, jk, jv, causal=True,
                                            window=window, chunk=chunk))
    _close(chunked, dense.numpy())


def test_repeat_kv_matches_jax():
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(
        attention._repeat_kv(torch.from_numpy(k), 3).numpy(),
        np.asarray(jattn._repeat_kv(jnp.asarray(k), 3)))

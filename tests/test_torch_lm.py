"""The port's LM serving path against the JAX package on every reduced
dense arch and the two recurrent ones (hymba-1.5b, xlstm-125m): forward
hidden states, prefill and decode logits, greedy tokens, the sliding-window
ring, and the param trees.

Both packages get the same numpy prompt and the same params (JAX's
``init_params``, carried over with ``params_from_jax``).  With
``attention_impl="pallas"`` the JAX side runs its Pallas kernel in
interpret mode and the port its plain version (CPU tensors).

Tolerance: 2e-4 on logits, the bound of ``tests/test_archs_smoke.py:70``
(fp32 throughout, summed in another order over two layers).  The MoE
archs (grok-1-314b, llama4-scout-17b-a16e): ``tests/test_torch_moe_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import lm as jlm
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.launch.serve import generate, main, make_prompt
from repro_torch.models import lm, transformer

TOL = 2e-4
DENSE = sorted(n for n, c in ARCHS.items()
               if transformer.unit_pattern(c) == ("dense",) and c.moe is None)
RECURRENT = ["hymba-1.5b", "xlstm-125m"]
SERVED = DENSE + RECURRENT
LAUNCH_KEYS = {f"{part}_{k}_launches" for part in ("prefill", "decode")
               for k in ("flash", "flash_bwd", "ssm_scan", "ssm_scan_bwd",
                         "rmsnorm", "rmsnorm_bwd")}
IMPLS = ["pallas", "chunked", "dense"]
# (arch, attention impl): xlstm-125m has no attention, so one impl
SERVED_IMPLS = ([(n, i) for n in DENSE + ["hymba-1.5b"] for i in IMPLS]
                + [("xlstm-125m", "pallas")])
B, S = 2, 32


def _cfgs(name, **kw):
    return (dataclasses.replace(JARCHS[name].reduced(), **kw),
            dataclasses.replace(ARCHS[name].reduced(), **kw))


def _params(jcfg, seed=0):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def _jax_greedy(jcfg, jp, prompt, gen):
    """The JAX serving loop of ``repro/launch/serve.py`` on a given prompt:
    (prefill logits, every decode step's logits, tokens)."""
    Bp, P = prompt.shape[:2]
    prefill = jax.jit(jlm.make_prefill_step(jcfg, Bp, P, cache_len=P + gen))
    decode = jax.jit(jlm.make_decode_step(jcfg))
    logits, caches = prefill(jp, jnp.asarray(prompt))
    toks = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    out, steps = [toks], []
    for i in range(gen - 1):
        step_in = toks
        if jcfg.input_kind == "embeddings":
            step_in = jnp.take(jp["embed"]["w"], toks, axis=0)
        step_logits, caches = decode(jp, step_in, caches, jnp.int32(P + i))
        steps.append(step_logits)
        toks = jnp.argmax(step_logits[:, -1], axis=-1)[:, None]
        out.append(toks)
    return logits, steps, np.asarray(jnp.concatenate(out, axis=1))


def test_dense_archs_are_the_six_dense_family_configs():
    assert DENSE == sorted(["llama3.2-3b", "musicgen-large", "phi-3-vision-4.2b",
                            "phi3-mini-3.8b", "qwen2-0.5b", "qwen2.5-14b"])


@pytest.mark.parametrize("name", SERVED)
def test_forward_hidden_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    inputs = make_prompt(tcfg, B, S, seed=1)
    want, _, _ = jlm.forward(jp, jnp.asarray(inputs), jcfg)
    got, caches, aux = lm.forward(tp, torch.from_numpy(inputs), tcfg)
    assert caches is None and float(aux) == 0.0
    assert tuple(got.shape) == (B, S, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("name,impl", SERVED_IMPLS)
def test_prefill_and_decode_logits_match_jax(name, impl):
    jcfg, tcfg = _cfgs(name, attention_impl=impl)
    jp, tp = _params(jcfg)
    inputs = make_prompt(tcfg, B, S + 1, seed=2)
    prefill = jax.jit(jlm.make_prefill_step(jcfg, B, S, cache_len=S + 1))
    want_p, jc = prefill(jp, jnp.asarray(inputs[:, :S]))
    want_d, _ = jax.jit(jlm.make_decode_step(jcfg))(
        jp, jnp.asarray(inputs[:, S:]), jc, jnp.int32(S))
    with torch.no_grad():
        got_p, tc = lm.make_prefill_step(tcfg, B, S, cache_len=S + 1)(
            tp, torch.from_numpy(inputs[:, :S]))
        got_d, _ = lm.make_decode_step(tcfg)(
            tp, torch.from_numpy(inputs[:, S:]), tc, S)
    assert tuple(got_p.shape) == (B, 1, tcfg.vocab_size)
    _close(got_p, want_p)
    _close(got_d, want_d)


@pytest.mark.parametrize("name", SERVED)
def test_prefill_decode_match_port_forward(name):
    """The serving invariants within the port: prefill's last logit equals
    the full forward at S-1, the decode logit the forward at S."""
    jcfg, tcfg = _cfgs(name, attention_impl="pallas")
    _, tp = _params(jcfg, seed=3)
    inputs = torch.from_numpy(make_prompt(tcfg, B, S + 1, seed=3))
    with torch.no_grad():
        logits_p, caches = lm.make_prefill_step(tcfg, B, S, cache_len=S + 1)(
            tp, inputs[:, :S])
        logits_d, _ = lm.make_decode_step(tcfg)(tp, inputs[:, S:], caches, S)
        h, _, _ = lm.forward(tp, inputs, tcfg)
        full = lm._head(tp, h, tcfg)
    _close(logits_p[:, 0], full[:, S - 1].numpy())
    _close(logits_d[:, 0], full[:, S].numpy())


@pytest.mark.parametrize("name,impl", SERVED_IMPLS)
def test_greedy_tokens_match_jax(name, impl):
    """``generate`` against the JAX serving loop: 8 greedy tokens identical,
    prefill and every decode step's logits within 2e-4."""
    jcfg, tcfg = _cfgs(name, attention_impl=impl)
    jp, tp = _params(jcfg, seed=4)
    prompt = make_prompt(tcfg, B, S, seed=4)
    want_logits, want_steps, want_toks = _jax_greedy(jcfg, jp, prompt, 8)
    toks, logits, timings = generate(tp, prompt, tcfg, 8, "cpu")
    assert toks.shape == (B, 8)
    assert set(timings) == {"prefill_s", "decode_s"} | LAUNCH_KEYS
    # the CPU runs the plain versions: no kernel launch in either part
    assert all(timings[k] == 0 for k in LAUNCH_KEYS)
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    _close(logits, want_logits)
    # replay the port's decode steps to hold their logits too
    with torch.no_grad():
        _, caches = lm.make_prefill_step(tcfg, B, S, cache_len=S + 8)(
            tp, torch.from_numpy(prompt))
        decode = lm.make_decode_step(tcfg)
        for i, want in enumerate(want_steps):
            step_in = toks[:, i:i + 1]
            if tcfg.input_kind == "embeddings":
                step_in = tp["embed"]["w"][step_in]
            got, caches = decode(tp, step_in, caches, S + i)
            _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_sliding_window_decode_ring_wraps(impl):
    """Window 16 below a 24-token prompt: the prefill fills the ring from
    its tail and 8 decode steps wrap it; logits and tokens match JAX and
    the port's own full forward."""
    jcfg, tcfg = _cfgs("qwen2-0.5b", attention_impl=impl, sliding_window=16)
    jp, tp = _params(jcfg, seed=5)
    P = 24
    prompt = make_prompt(tcfg, B, P, seed=5)
    want_logits, want_steps, want_toks = _jax_greedy(jcfg, jp, prompt, 8)
    toks, logits, _ = generate(tp, prompt, tcfg, 8, "cpu")
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    _close(logits, want_logits)
    seq = torch.cat([torch.from_numpy(prompt).long(), toks[:, :-1]], dim=1)
    with torch.no_grad():
        h, _, _ = lm.forward(tp, seq, tcfg)
        full = lm._head(tp, h, tcfg)
    for i, want in enumerate(want_steps):
        _close(full[:, P + i], np.asarray(want)[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_carries_the_lm_tree(dtype):
    """A dict holding a tuple of stacked dicts, leaf for leaf and bit for
    bit, bf16 included."""
    jcfg, _ = _cfgs("qwen2-0.5b", dtype=dtype)
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(6), jcfg))
    tp = params_from_jax(jp, "cpu")
    assert isinstance(tp["blocks"], tuple) and len(tp["blocks"]) == 1
    assert tree.structure(tp) == tree.structure(jp)
    for a, b in zip(tree.leaves(jp), tree.leaves(tp)):
        assert str(b.dtype) == f"torch.{dtype}"
        assert tuple(b.shape) == a.shape
        raw = b.view(torch.int16) if dtype == "bfloat16" else b
        np.testing.assert_array_equal(
            raw.numpy(), a.view(np.int16) if dtype == "bfloat16" else a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SERVED)
def test_init_params_gives_the_jax_tree(name, dtype):
    """Structure, shapes and dtypes of the JAX package's params (the Mamba
    ``log_neg_a`` and ``d_skip`` fp32 in a bf16 tree).  The leaf total is
    JAX's; ``n_params()`` equals it for the dense archs only (it leaves out
    the hybrid's conv and dt leaves and counts the xLSTM's otherwise)."""
    jcfg, tcfg = _cfgs(name, dtype=dtype)
    want = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    got = lm.init_params(torch.Generator().manual_seed(0), tcfg)
    assert tree.structure(got) == tree.structure(want)
    for a, b in zip(tree.leaves(want), tree.leaves(got)):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype) == f"torch.{a.dtype}"
    total = sum(b.numel() for b in tree.leaves(got))
    assert total == sum(a.size for a in tree.leaves(want))
    if name in DENSE:
        assert total == tcfg.n_params()


@pytest.mark.parametrize("name", RECURRENT)
def test_full_width_recurrent_param_count_is_jax_s(name):
    """The full-width leaf totals, from JAX's ``eval_shape``: the numbers
    the chip run's full-width configs are held to."""
    want = jax.eval_shape(lambda k: jlm.init_params(k, JARCHS[name]),
                          jax.random.PRNGKey(0))
    total = sum(a.size for a in tree.leaves(want))
    assert total == {"hymba-1.5b": 1640555968, "xlstm-125m": 172920624}[name]


def test_serve_cli_runs_on_the_cpu(capsys):
    main(["--device", "cpu", "--batch", "2", "--prompt-len", "16",
          "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=qwen2-0.5b B=2 prompt=16 gen=4 device=cpu" in out
    assert "attention=pallas" in out and "sample tokens" in out


@pytest.mark.parametrize("name", RECURRENT)
def test_serve_cli_serves_the_recurrent_archs_on_the_cpu(name, capsys):
    main(["--device", "cpu", "--arch", name, "--batch", "2",
          "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"arch={name} B=2 prompt=16 gen=4 device=cpu" in out
    assert "sample tokens" in out

"""The port's MoE language models (grok-1-314b, llama4-scout-17b-a16e)
against the JAX package on the CPU: serving (hidden states, prefill and
decode logits, greedy tokens), the param trees and full-width counts,
``loss_and_aux`` with the routers' aux term and its gradients,
``make_train_step``, two federated rounds of reduced grok-1-314b under a
``TickTimer``, and the two entry points.

Both packages start from JAX's ``init_params`` (``params_from_jax``) on the
same numpy inputs.  The reduced configs route drop-free (capacity factor
4.0); each serving and training check also runs at the full configs'
1.25, where tokens drop, and under both dispatches.  Tolerances are the
dense archs': logits 2e-4 (``tests/test_torch_lm.py``), the loss 1e-5,
gradients and params 1e-5 absolute / 1e-4 relative
(``tests/test_torch_lm_train.py``).
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs.registry import ARCHS as JARCHS
from repro.data import make_lm_clients as jclients
from repro.models import lm as jlm
import repro_torch.core as T
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import tree
from repro_torch.kernels import ops
from repro_torch.launch import fl_train_lm, serve
from repro_torch.launch.serve import generate, make_prompt
from repro_torch.models import lm, transformer

MOE = ["grok-1-314b", "llama4-scout-17b-a16e"]
IMPLS = ["gshard_einsum", "gather"]
# (dispatch, capacity factor): the reduced configs' drop-free routing and
# the full configs' 1.25 under each dispatch
ROUTES = [(i, cf) for i in IMPLS for cf in (4.0, 1.25)]
# the costlier checks: each dispatch once, the gather at the drops
TWO_ROUTES = [("gshard_einsum", 4.0), ("gather", 1.25)]
TOL = 2e-4
LOSS_TOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the reduced models' ops are small, and
    the suite runs six workers on the machine's cores (spinning thread
    pools made these tests many times slower under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, impl="gshard_einsum", cf=4.0, attn="pallas", **kw):
    def one(c):
        c = c.reduced()
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, dispatch_impl=impl, capacity_factor=cf), **kw)
    return (one(JARCHS[name]),
            dataclasses.replace(one(ARCHS[name]), attention_impl=attn))


def _params(jcfg, seed=0):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


def _close_trees(got, want, atol=ATOL, rtol=RTOL):
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol)


def _batch(cfg, Bn, Sn, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeddings":
        inputs = rng.standard_normal((Bn, Sn, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (Bn, Sn)).astype(np.int32)
    return {"inputs": inputs,
            "labels": rng.integers(0, cfg.vocab_size, (Bn, Sn)).astype(
                np.int32)}


def test_moe_archs_are_the_two_moe_configs():
    assert sorted(n for n, c in ARCHS.items() if c.moe is not None) == MOE
    assert all(transformer.unit_pattern(ARCHS[n]) == ("dense",) for n in MOE)


@pytest.mark.parametrize("impl,cf", ROUTES)
@pytest.mark.parametrize("name", MOE)
def test_forward_hidden_and_aux_match_jax(name, impl, cf):
    jcfg, tcfg = _cfgs(name, impl, cf)
    jp, tp = _params(jcfg)
    inputs = make_prompt(tcfg, B, S, seed=1)
    want, _, jaux = jax.jit(lambda p, x: jlm.forward(p, x, jcfg))(
        jp, jnp.asarray(inputs))
    got, caches, aux = lm.forward(tp, torch.from_numpy(inputs), tcfg)
    assert caches is None and aux.dtype == torch.float32 and aux.shape == ()
    _close(got, want)
    # the aux of both layers, summed over the repetitions
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert float(aux) > 1.0


@pytest.mark.parametrize("impl,cf", TWO_ROUTES)
@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_logits_match_jax(name, impl, cf):
    jcfg, tcfg = _cfgs(name, impl, cf)
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


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MOE)
def test_prefill_decode_match_port_forward(name, impl):
    """Drop-free routing (the reduced configs' capacity 4.0): prefill's last
    logit equals the full forward at S-1, the decode logit the forward at S
    (a token's route does not depend on its group then)."""
    jcfg, tcfg = _cfgs(name, impl)
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


def _jax_greedy(jcfg, jp, prompt, gen):
    Bp, P = prompt.shape[:2]
    prefill = jax.jit(jlm.make_prefill_step(jcfg, Bp, P, cache_len=P + gen))
    decode = jax.jit(jlm.make_decode_step(jcfg))
    logits, caches = prefill(jp, jnp.asarray(prompt))
    toks = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    out = [toks]
    for i in range(gen - 1):
        step_in = toks
        if jcfg.input_kind == "embeddings":
            step_in = jnp.take(jp["embed"]["w"], toks, axis=0)
        step_logits, caches = decode(jp, step_in, caches, jnp.int32(P + i))
        toks = jnp.argmax(step_logits[:, -1], axis=-1)[:, None]
        out.append(toks)
    return logits, np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("impl,cf", TWO_ROUTES)
@pytest.mark.parametrize("name", MOE)
def test_greedy_tokens_match_jax(name, impl, cf):
    """8 greedy tokens identical to the JAX serving loop; each decode step
    is one group of B tokens (capacity 1 at the full configs' 1.25 for
    scout, so a second token on an expert drops, in both packages)."""
    jcfg, tcfg = _cfgs(name, impl, cf)
    jp, tp = _params(jcfg, seed=4)
    prompt = make_prompt(tcfg, 4, 16, seed=4)
    want_logits, want_toks = _jax_greedy(jcfg, jp, prompt, 8)
    toks, logits, t = generate(tp, prompt, tcfg, 8, "cpu")
    _close(logits, want_logits)
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    assert t["prefill_flash_launches"] == 0       # no launch on the CPU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_init_params_gives_the_jax_tree(name, dtype):
    """The stacked {router, wi, wg, wo} FFN leaves of every layer, with
    JAX's shapes and dtypes; the leaf total is ``n_params()``;
    ``params_from_jax`` carries them across."""
    jcfg, tcfg = _cfgs(name, dtype=dtype)
    want = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    got = lm.init_params(torch.Generator().manual_seed(0), tcfg)
    assert tree.structure(got) == tree.structure(want)
    assert sorted(got["blocks"][0]["ffn"]) == ["router", "wg", "wi", "wo"]
    E, L = tcfg.moe.n_experts, tcfg.n_layers
    assert tuple(got["blocks"][0]["ffn"]["wi"].shape) == \
        (L, E, tcfg.d_model, tcfg.d_ff)
    for a, b in zip(tree.leaves(want), tree.leaves(got)):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype) == f"torch.{a.dtype}"
    assert sum(b.numel() for b in tree.leaves(got)) == tcfg.n_params()
    jp, tp = _params(jcfg)
    for a, b in zip(jax.tree.leaves(jp), tree.leaves(tp)):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())


@pytest.mark.parametrize("name", MOE)
def test_full_width_moe_param_count_is_jax_s(name):
    """The full-width leaf totals, from JAX's ``eval_shape`` (the numbers
    the chip run's depth cuts are reckoned from)."""
    want = jax.eval_shape(lambda k: jlm.init_params(k, JARCHS[name]),
                          jax.random.PRNGKey(0))
    total = sum(a.size for a in jax.tree.leaves(want))
    assert total == ARCHS[name].n_params()
    assert total == {"grok-1-314b": 316489340928,
                     "llama4-scout-17b-a16e": 101730063360}[name]


def _jax_grads(jcfg, jp, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_and_aux(p, b,
                                                                  jcfg)))
    return fn(jp, jax.tree.map(jnp.asarray, batch))


@pytest.mark.parametrize("impl,cf", TWO_ROUTES)
@pytest.mark.parametrize("name", MOE)
def test_loss_and_grads_with_the_aux_term_match_jax(name, impl, cf):
    """``loss_and_aux`` adds ``aux_loss_weight · aux``; its value and
    gradients against ``jax.value_and_grad`` (the port on the pallas
    route: the flash and norm Functions with their plain backwards)."""
    jcfg, tcfg = _cfgs(name, impl, cf)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 2, 32, seed=5)
    jl, jg = _jax_grads(jcfg, jp, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tg = T.value_and_grad(lambda p, b: lm.loss_and_aux(p, b, tcfg))(
        tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), atol=LOSS_TOL, rtol=0)
    _close_trees(tg, jg)
    # the aux term is in the loss: without it the loss moves by w·aux
    h, _, aux = lm.forward(tp, tb["inputs"], tcfg)
    xent = lm.chunked_xent(tp, h, tb["labels"], tcfg)
    assert abs(float(tl) - float(xent)
               - tcfg.moe.aux_loss_weight * float(aux)) <= 1e-6
    assert tcfg.moe.aux_loss_weight * float(aux) > 1e-3


@pytest.mark.parametrize("micro", [1, 4])
@pytest.mark.parametrize("name", MOE)
def test_train_step_matches_jax(name, micro):
    jcfg, tcfg = _cfgs(name, cf=1.25)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 4, 32, seed=6)
    jstep = jax.jit(jlm.make_train_step(jcfg, lr=0.05, micro_batches=micro))
    tstep = lm.make_train_step(tcfg, lr=0.05, micro_batches=micro)
    for _ in range(2):
        jp, jm = jstep(jp, jax.tree.map(jnp.asarray, batch))
        tp, tm = tstep(tp, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=LOSS_TOL, rtol=0)
        _close_trees(tp, jp)


def _record_schedules(srv):
    seen = []
    inner = srv.scheduler.schedule

    def schedule(rnd, tasks, executors, **kw):
        s = inner(rnd, tasks, executors, **kw)
        seen.append((rnd, sorted(t.client for t in tasks),
                     {k: [t.client for t in q]
                      for k, q in s.assignment.items()}))
        return s

    srv.scheduler.schedule = schedule
    return seen


def test_two_fl_rounds_of_reduced_grok_match_jax():
    """``examples/fl_train_lm.py``'s wiring under a TickTimer in both
    packages, the port's clients through the engine's ``vmap(grad)`` on the
    gather dispatch (its sort, searchsorted and scatters batched per
    client) at capacity 1.25 (drops): selections, schedules and makespans
    exactly, params after each round within 1e-5 / 1e-4.  The gshard
    dispatch under ``vmap(grad)``: ``tests/test_torch_moe.py``."""
    jcfg, tcfg = _cfgs("grok-1-314b", "gather", 1.25)
    jp, tp = _params(jcfg)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_and_aux(p, b, jcfg)))
    with tempfile.TemporaryDirectory() as jd, \
            tempfile.TemporaryDirectory() as td:
        algo = J.make_algorithm("fedavg", grad_fn, lr=0.1, local_epochs=1)
        sm = J.ClientStateManager(jd)
        timer = J.TickTimer(1.0)
        execs = [J.SequentialExecutor(k, algo, state_manager=sm, timer=timer)
                 for k in range(4)]
        js = J.ParrotServer(
            params=jp, algorithm=algo, executors=execs,
            data_by_client=jclients(60, vocab=jcfg.vocab_size, seq_len=32,
                                    batch_size=4, mean_samples=8, seed=0),
            clients_per_round=12, seed=0)
        ts = fl_train_lm.build(tcfg, tp, "cpu", td, timer=T.TickTimer(1.0))
        jsel, tsel = _record_schedules(js), _record_schedules(ts)
        ops.reset_flash_counts()
        for _ in range(2):
            js.run_round()
            ts.run_round()
            _close_trees(ts.params, js.params)
    assert tsel == jsel
    assert [(m.round, m.makespan, m.n_clients) for m in ts.history] == \
        [(m.round, m.makespan, m.n_clients) for m in js.history]
    assert ops.flash_dispatches == ops.flash_bwd_dispatches > 0
    assert np.isfinite(fl_train_lm.eval_loss(
        ts.params, fl_train_lm.eval_batch(tcfg), tcfg))


@pytest.mark.parametrize("name", MOE)
def test_serve_cli_runs_the_moe_archs_on_the_cpu(name, capsys):
    serve.main(["--device", "cpu", "--arch", name, "--batch", "2",
                "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"arch={name} B=2 prompt=16 gen=4 device=cpu" in out
    assert "sample tokens" in out


def test_fl_train_lm_cli_trains_scout_on_the_cpu(capsys):
    """The embedding-input MoE arch through ``fl_train_lm``'s CLI: a round
    of its clients' ids through the token table, under the engine's
    ``vmap(grad)`` (grok-1-314b's rounds: the JAX parity test above)."""
    name = "llama4-scout-17b-a16e"
    fl_train_lm.main(["--device", "cpu", "--arch", name, "--rounds", "1"])
    out = capsys.readouterr().out
    assert "round 0: clients=12" in out and "eval_loss=" in out
    assert f"via Parrot on {name} (cpu" in out


def test_embedding_arch_clients_take_ids_through_the_token_table():
    """``fl_train_lm.client_loss`` on llama4-scout's token batches: the ids'
    rows of the embedding table are the inputs."""
    _, tcfg = _cfgs("llama4-scout-17b-a16e")
    tp = lm.init_params(torch.Generator().manual_seed(0), tcfg)
    b = {k: torch.from_numpy(v) for k, v in
         fl_train_lm.eval_batch(tcfg).items()}
    want = lm.loss_and_aux(tp, {"inputs": tp["embed"]["w"][b["inputs"]
                                                          .long()],
                                "labels": b["labels"]}, tcfg)
    assert float(fl_train_lm.client_loss(tp, b, tcfg)) == float(want)

"""The gradients of the port's LM kernels on the CPU: each plain backward
(``flash_attention_bwd_plain``, ``rmsnorm_bwd_plain``) against
``torch.autograd`` of its plain forward and against ``jax.vjp`` of the JAX
package's oracle (``repro/kernels/ref.py``), and the
``torch.autograd.Function``s
of ``ops.flash_attention`` and ``ops.rmsnorm`` -- the same
``setup_context``, saved tensors and ``vmap`` rules the card runs, with the
plain versions in place of the kernels -- under ``torch.func.vmap`` of
``torch.func.grad`` against a per-client loop.

Tolerances: fp32 2e-5 absolute / 1e-4 relative (the same fp32 math summed
in another order); bf16 inputs 2e-2 / 1e-2 (``tests/test_kernels.py``'s
bf16 bound: both sides compute in fp32 and round the result to bf16 once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels.ref import flash_attention_ref, rmsnorm_ref

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_fwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_plain,
                                         rmsnorm_grouped_plain,
                                         rmsnorm_plain)
from repro_torch.kernels.ssm_scan import ssm_scan_plain

F32, BF = torch.float32, torch.bfloat16


def _tol(dtype):
    return (2e-5, 1e-4) if dtype == F32 else (2e-2, 1e-2)


def _rand(rng, shape, dtype=F32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


# (B, Sq, Skv, H, KV, hd, causal, window): MHA and GQA at every head dim the
# kernels take, ragged Sq and Skv, windows, non-causal
FLASH_CASES = [(2, 40, 40, 4, 4, 16, True, 0), (1, 33, 33, 4, 2, 32, True, 0),
               (2, 64, 64, 6, 2, 64, True, 9), (1, 30, 50, 2, 1, 96, False, 0),
               (1, 50, 30, 4, 2, 128, True, 0), (1, 20, 20, 2, 2, 192, True, 5),
               (2, 24, 24, 14, 2, 64, True, 0)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [F32, BF])
def test_flash_bwd_plain_matches_autograd_of_plain(case, dtype):
    B, Sq, Skv, H, KV, hd, causal, window = case
    rng = np.random.default_rng(Sq + hd)
    q = _rand(rng, (B, Sq, H, hd), dtype)
    k, v = (_rand(rng, (B, Skv, KV, hd), dtype) for _ in range(2))
    do = _rand(rng, (B, Sq, H, hd), dtype)
    o, lse = flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
    assert torch.equal(o, flash_attention_plain(q, k, v, causal=causal,
                                                window=window))
    assert lse.shape == (B, H, Sq) and lse.dtype == F32
    got = flash_attention_bwd_plain(do, q, k, v, o, lse, causal=causal,
                                    window=window)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention_plain(qq, kk, vv, causal=causal, window=window)
    want = torch.autograd.grad(out, (qq, kk, vv), do)
    atol, rtol = _tol(dtype)
    for g, w, ref in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == ref.shape
        torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                   rtol=rtol)


# (T, d, V): one g row; a table of V rows (a vmapped block); an odd d
RMS_CASES = [(64, 32, 1), (24, 96, 4), (30, 33, 3), (8, 896, 8)]


@pytest.mark.parametrize("case", RMS_CASES, ids=str)
@pytest.mark.parametrize("dtype", [F32, BF])
def test_rmsnorm_bwd_plain_matches_autograd_of_plain(case, dtype):
    T, d, V = case
    rng = np.random.default_rng(T + d)
    x = _rand(rng, (T, d), dtype)
    g = 1.0 + 0.1 * _rand(rng, (V, d), dtype)
    dy = _rand(rng, (T, d), dtype)
    dx, dg = rmsnorm_bwd_plain(dy, x, g, 1e-5)
    xx, gg = x.clone().requires_grad_(), g.clone().requires_grad_()
    y = rmsnorm_grouped_plain(xx, gg, 1e-5)
    if V == 1:
        assert torch.equal(y, rmsnorm_plain(x, g[0]))
    wx, wg = torch.autograd.grad(y, (xx, gg), dy)
    atol, rtol = _tol(dtype)
    assert dx.dtype == dtype and dg.dtype == dtype and dg.shape == (V, d)
    torch.testing.assert_close(dx.float(), wx.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(dg.float(), wg.float(), atol=atol, rtol=rtol)


def _to_jax(t: torch.Tensor):
    """The same values in JAX, in t's dtype (bf16 values are exact in
    fp32)."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == BF else a


def _from_jax(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [F32, BF])
def test_flash_bwd_plain_matches_jax_vjp_of_ref(case, dtype):
    """The yardstick the backward kernels are held to, against the JAX
    package: ``jax.vjp`` of ``flash_attention_ref`` on the same values
    (KV heads repeated for the reference, its dk and dv summed over each
    group)."""
    B, Sq, Skv, H, KV, hd, causal, window = case
    rng = np.random.default_rng(Sq + hd + 1)
    q = _rand(rng, (B, Sq, H, hd), dtype)
    k, v = (_rand(rng, (B, Skv, KV, hd), dtype) for _ in range(2))
    do = _rand(rng, (B, Sq, H, hd), dtype)
    o, lse = flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
    got = flash_attention_bwd_plain(do, q, k, v, o, lse, causal=causal,
                                    window=window)
    rep = H // KV
    kr, vr = (torch.repeat_interleave(t, rep, dim=2) for t in (k, v))
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(
        a, b, c, causal=causal, window=window), *map(_to_jax, (q, kr, vr)))
    dq, dk, dv = (_from_jax(t) for t in vjp(_to_jax(do)))
    dk, dv = (t.reshape(B, Skv, KV, rep, hd).sum(dim=3) for t in (dk, dv))
    atol, rtol = _tol(dtype)
    for g, w, ref in zip(got, (dq, dk, dv), (q, k, v)):
        assert g.dtype == dtype and g.shape == ref.shape
        torch.testing.assert_close(g.float(), w, atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", RMS_CASES, ids=str)
@pytest.mark.parametrize("dtype", [F32, BF])
def test_rmsnorm_bwd_plain_matches_jax_vjp_of_ref(case, dtype):
    """``rmsnorm_bwd_plain`` against ``jax.vjp`` of ``rmsnorm_ref`` on the
    same values, one g row's rows at a time."""
    T, d, V = case
    rng = np.random.default_rng(T + d + 1)
    x = _rand(rng, (T, d), dtype)
    g = 1.0 + 0.1 * _rand(rng, (V, d), dtype)
    dy = _rand(rng, (T, d), dtype)
    dx, dg = rmsnorm_bwd_plain(dy, x, g, 1e-5)
    atol, rtol = _tol(dtype)
    rows = T // V
    for i in range(V):
        part = slice(i * rows, (i + 1) * rows)
        _, vjp = jax.vjp(lambda a, b: rmsnorm_ref(a, b, 1e-5),
                         _to_jax(x[part]), _to_jax(g[i]))
        wx, wg = (_from_jax(t) for t in vjp(_to_jax(dy[part])))
        torch.testing.assert_close(dx[part].float(), wx, atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(dg[i].float(), wg, atol=atol, rtol=rtol)


def _attn_block(wq, g, x, k, v, causal=True, window=0, kernel=True):
    """A client's toy loss through both Functions: q from x and wq, flash
    over grouped k and v, the norm with g."""
    q = torch.einsum("bshd,de->bshe", x, wq)
    fa = ops.flash_attention if kernel else flash_attention_plain
    o = fa(q, k, v, causal=causal, window=window)
    y = (ops.rmsnorm if kernel else rmsnorm_plain)(o, g)
    return torch.sum(y.float() ** 2)


@pytest.mark.parametrize("shared", ["none", "g", "kv"])
@pytest.mark.parametrize("window", [0, 6])
def test_functions_under_vmap_grad_equal_a_per_client_loop(shared, window):
    """Each client's gradient from one vmapped call equals its own
    gradient of the plain expression: per-client g and k, v; one g shared
    by all (in_dim None: its gradient is still per client); one k, v
    shared."""
    rng = np.random.default_rng(5)
    V, B, S, H, KV, hd = 3, 2, 20, 4, 2, 16
    wq = 0.3 * _rand(rng, (V, hd, hd))
    g = 1.0 + 0.1 * _rand(rng, (V, hd))
    x = _rand(rng, (V, B, S, H, hd))
    k, v = (_rand(rng, (V, B, S, KV, hd)) for _ in range(2))
    in_dims = [0, 0, 0, 0, 0]
    if shared == "g":
        g, in_dims[1] = g[0], None
    if shared == "kv":
        k, v, in_dims[3], in_dims[4] = k[0], v[0], None, None
    ops.reset_flash_counts()
    ops.reset_rmsnorm_counts()
    fn = torch.func.grad(lambda *a: _attn_block(*a, window=window),
                         argnums=(0, 1, 2, 3, 4))
    got = torch.func.vmap(fn, in_dims=tuple(in_dims))(wq, g, x, k, v)
    # one forward and one backward call of each for the whole block
    assert (ops.flash_dispatches, ops.flash_bwd_dispatches) == (1, 1)
    assert (ops.rmsnorm_dispatches, ops.rmsnorm_bwd_dispatches) == (1, 1)
    assert (ops.flash_launches, ops.flash_bwd_launches) == (0, 0)
    ref = torch.func.grad(
        lambda *a: _attn_block(*a, window=window, kernel=False),
        argnums=(0, 1, 2, 3, 4))
    for i in range(V):
        args = [a if d is None else a[i]
                for a, d in zip((wq, g, x, k, v), in_dims)]
        want = ref(*args)
        for j, (gt, w) in enumerate(zip(got, want)):
            torch.testing.assert_close(gt[i], w, atol=2e-5, rtol=1e-4,
                                       msg=f"client {i} arg {j}")


def test_functions_under_eager_autograd_and_nested_vmap():
    """Plain ``backward()`` through the Functions, and a vmap of a vmap of
    grad (each rule folding an axis that is already folded once)."""
    rng = np.random.default_rng(6)
    B, S, H, KV, hd = 2, 16, 4, 2, 32
    wq = (0.3 * _rand(rng, (hd, hd))).requires_grad_()
    g = (1.0 + 0.1 * _rand(rng, (hd,))).requires_grad_()
    x = _rand(rng, (B, S, H, hd))
    k, v = (_rand(rng, (B, S, KV, hd)) for _ in range(2))
    _attn_block(wq, g, x, k, v).backward()
    want = torch.func.grad(lambda a, b: _attn_block(a, b, x, k, v,
                                                    kernel=False),
                           argnums=(0, 1))(wq.detach(), g.detach())
    torch.testing.assert_close(wq.grad, want[0], atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(g.grad, want[1], atol=2e-5, rtol=1e-4)

    W = 0.3 * _rand(rng, (2, 3, hd, hd))
    G = 1.0 + 0.1 * _rand(rng, (2, 3, hd))
    fn = torch.func.grad(lambda a, b: _attn_block(a, b, x, k, v),
                         argnums=(0, 1))
    got = torch.func.vmap(torch.func.vmap(fn))(W, G)
    for i in range(2):
        for j in range(3):
            want = torch.func.grad(
                lambda a, b: _attn_block(a, b, x, k, v, kernel=False),
                argnums=(0, 1))(W[i, j], G[i, j])
            torch.testing.assert_close(got[0][i, j], want[0], atol=2e-5,
                                       rtol=1e-4)
            torch.testing.assert_close(got[1][i, j], want[1], atol=2e-5,
                                       rtol=1e-4)


def test_plain_calls_take_the_forward_alone(monkeypatch):
    """Under ``no_grad`` (serving) and on tensors that need no gradient the
    wrappers call the forward without the Function, so flash computes no
    log-sum-exp; with a gradient, the Function's forward asks for it."""
    seen = []
    inner = ops._flash_fwd

    def spy(q, k, v, causal, window, with_lse):
        seen.append(with_lse)
        return inner(q, k, v, causal, window, with_lse)

    monkeypatch.setattr(ops, "_flash_fwd", spy)
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, (1, 8, 2, 16)) for _ in range(3))
    ops.flash_attention(q, k, v)
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, v)
    out = ops.flash_attention(q, k, v)
    assert seen == [False, False, True] and out.grad_fn is not None
    with torch.no_grad():
        assert ops.rmsnorm(q, torch.ones(16, requires_grad=True)).grad_fn \
            is None


def test_ssm_scan_on_the_cpu_stays_differentiable():
    """The scan's CPU route under autograd is its Function with the plain
    backward (``ssm_scan_bwd_plain``): autograd of the plain forward's
    gradient, within fp32 summation order."""
    rng = np.random.default_rng(8)
    B, S, H, N, P = 1, 24, 2, 8, 4
    q, k = (_rand(rng, (B, S, H, N)) for _ in range(2))
    v = _rand(rng, (B, S, H, P))
    la = -torch.rand(B, S, H, generator=torch.Generator().manual_seed(0))
    qq = q.clone().requires_grad_()
    ops.reset_ssm_scan_counts()
    y, _ = ops.ssm_scan(qq, k, v, la, chunk=8)
    (gq,) = torch.autograd.grad(y.sum(), qq)
    assert (ops.ssm_scan_dispatches, ops.ssm_scan_bwd_dispatches) == (1, 1)
    qr = q.clone().requires_grad_()
    (want,) = torch.autograd.grad(ssm_scan_plain(qr, k, v, la, 8)[0].sum(),
                                  qr)
    torch.testing.assert_close(gq, want, atol=2e-5, rtol=1e-4)
    assert bool(gq.abs().sum() > 0)

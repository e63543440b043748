"""The split products of the port's fp32-exact tensor-core backward kernels,
emulated on the CPU.

``csrc/flash_attention_bwd.cu``'s fp32 route (``tf32x3``) runs every
product on the tensor cores as three TF32 passes (``a·b ≈ a_s·b_b + a_b·b_s
+ a_b·b_b``, ``a_b = tf32(a)``, ``a_s = tf32(a − a_b)``: CUTLASS's 3xTF32);
``csrc/ssm_scan_bwd.cu`` splits each fp32 operand into three bf16 terms
(``hi + mid + lo``, each the bf16 rounding of what the terms before it
leave) and sums the cross terms whose orders add up to at most 2 -- one
pass where both operands are exact in bf16, three where one is, six where
neither is.  Here each term's product runs in fp32 (as the tensor cores
accumulate), TF32 rounding is round to nearest with ties away
(``cvt.rna.tf32.f32``: the low 13 mantissa bits), and bf16 rounding is
``.bfloat16()``.

* Each scheme against fp64 on the products' shapes in both kernels: every
  route's scheme lands within 2× fp32's own error; one pass of TF32 and a
  two-way bf16 split do not (which is why the kernels split as they do).
* ``flash_attention_bwd_plain`` with its products done the fp32 route's way
  against ``jax.vjp`` of ``repro/kernels/ref.py:flash_attention_ref`` on
  every fp32 case of ``tests/test_torch_grad_kernels.py``, at that file's
  fp32 tolerance.
* ``ssm_scan_bwd_plain`` with its tensor-core products split three ways
  against ``jax.vjp`` of the chunked scan and of the sequential oracle
  (``tests/test_torch_recurrent_train.py``), dlog_a included, at that
  file's tolerances.  The boundary product ``<G, h_in>``, a sum the kernel
  forms on the CUDA cores, stays fp32.
"""
import contextlib

import numpy as np
import pytest
import torch

import test_torch_grad_kernels as tgk
import test_torch_recurrent_train as trt
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_fwd_plain)
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_plain

F32, BF = torch.float32, torch.bfloat16


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF).float()


def split(x: torch.Tensor, n: int, rnd):
    """x as n terms, each ``rnd`` of what the terms before it leave."""
    terms, rest = [], x.float()
    for _ in range(n):
        t = rnd(rest)
        terms.append(t)
        rest = rest - t
    return terms


def split_product(fn, a, b, rnd, n, max_order):
    """fn(a_i, b_j) summed in fp32 over a's and b's n-term splits, every
    pair whose orders (0 the leading term) add up to at most max_order,
    the smallest first."""
    at, bt = split(a, n, rnd), split(b, n, rnd)
    out = None
    for order in range(max_order, -1, -1):
        for i in range(min(order, n - 1), -1, -1):
            j = order - i
            if j < n:
                term = fn(at[i], bt[j])
                out = term if out is None else out + term
    return out


def matmul_by(scheme):
    """a @ b (fp32 in, fp32 out) by a scheme: the kernels' and the ones
    they rule out."""
    mm = torch.matmul
    return {
        "fp32": lambda a, b: mm(a, b),
        "tf32": lambda a, b: mm(tf32(a), tf32(b)),
        "tf32x3": lambda a, b: split_product(mm, a, b, tf32, 2, 1),
        "bf16x2": lambda a, b: split_product(mm, a, b, bf16, 2, 1),
        "bf16x3": lambda a, b: split_product(mm, a, b, bf16, 3, 2),
    }[scheme]


# (M, K, N, the operand exact in bf16 or None, the route's scheme, the
# scheme it rules out): the fp32 flash backward's tile products over hd and
# a dK sum over 1,024 queries; the scan's bf16-route products with one bf16
# input (dq's dY·h_inᵀ at hymba's P = 400, N = 16; U_cᵀ = dYᵀ·(e^cum Q);
# dv's S̃ᵀ·dY) and its mixed-route products of two fp32 operands at xlstm's
# N = 384, P = 385 (D̃·K, K·G)
PRODUCTS = [(64, 64, 64, None, "tf32x3", "tf32"),
            (64, 1024, 64, None, "tf32x3", "tf32"),
            (64, 400, 16, "a", "bf16x3", "bf16x2"),
            (400, 64, 16, "a", "bf16x3", "bf16x2"),
            (64, 64, 400, "b", "bf16x3", "bf16x2"),
            (64, 64, 384, None, "bf16x3", "bf16x2"),
            (64, 384, 385, None, "bf16x3", "bf16x2")]


@pytest.mark.parametrize("case", PRODUCTS, ids=str)
def test_each_route_keeps_fp32_accuracy_and_the_short_splits_do_not(case):
    M, K, N, exact, scheme, ruled_out = case
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    if exact == "a":
        a = bf16(a)
    elif exact == "b":
        b = bf16(b)
    want = a.double() @ b.double()

    def err(s):
        return float((matmul_by(s)(a, b).double() - want).abs().max())

    fp32 = err("fp32")
    assert err(scheme) <= 2 * fp32
    assert err(ruled_out) > 2 * fp32


def einsum_by(rnd, n, max_order, keep=()):
    """torch.einsum with every two-operand product split as the kernels
    split it, but the equations in ``keep`` (products the kernel forms on
    the CUDA cores in fp32)."""
    plain = torch.einsum

    def einsum(eq, *ops):
        if len(ops) != 2 or eq in keep:
            return plain(eq, *ops)
        a, b = ops
        if a.dtype == torch.float64:
            return plain(eq, a, b)
        return split_product(lambda x, y: plain(eq, x, y), a, b, rnd, n,
                             max_order)

    return einsum


@contextlib.contextmanager
def products(monkeypatch, einsum):
    with monkeypatch.context() as m:
        m.setattr(torch, "einsum", einsum)
        yield


FLASH_F32 = tgk.FLASH_CASES


@pytest.mark.parametrize("case", FLASH_F32, ids=str)
def test_flash_bwd_tf32x3_arithmetic_matches_jax_vjp_of_ref(case,
                                                            monkeypatch):
    """``flash_attention_bwd_plain`` with S = Q·Kᵀ, dP = dO·Vᵀ, dV, dQ and
    dK each three TF32 passes (the fp32 route's products), against the JAX
    package's yardstick at ``tests/test_torch_grad_kernels.py``'s fp32
    tolerance."""
    import jax
    from repro.kernels.ref import flash_attention_ref
    B, Sq, Skv, H, KV, hd, causal, window = case
    rng = np.random.default_rng(Sq + hd + 1)
    q = tgk._rand(rng, (B, Sq, H, hd))
    k, v = (tgk._rand(rng, (B, Skv, KV, hd)) for _ in range(2))
    do = tgk._rand(rng, (B, Sq, H, hd))
    o, lse = flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
    with products(monkeypatch, einsum_by(tf32, 2, 1)):
        got = flash_attention_bwd_plain(do, q, k, v, o, lse, causal=causal,
                                        window=window)
    rep = H // KV
    kr, vr = (torch.repeat_interleave(t, rep, dim=2) for t in (k, v))
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(
        a, b, c, causal=causal, window=window),
        *map(tgk._to_jax, (q, kr, vr)))
    dq, dk, dv = (tgk._from_jax(t) for t in vjp(tgk._to_jax(do)))
    dk, dv = (t.reshape(B, Skv, KV, rep, hd).sum(dim=3) for t in (dk, dv))
    atol, rtol = tgk._tol(F32)
    for g, w in zip(got, (dq, dk, dv)):
        assert g.dtype == F32
        torch.testing.assert_close(g, w, atol=atol, rtol=rtol)


# the scan's bf16 cases of tests/test_torch_recurrent_train.py (the
# all-bf16 route and an fp32 k beside bf16 q and v), and its fp32 cases
SCAN_CASES = trt.SCAN_CASES


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_ssm_scan_bwd_three_way_split_matches_jax_vjp(case, monkeypatch):
    """``ssm_scan_bwd_plain`` with every product the kernel runs on the
    tensor cores split three ways into bf16 terms (one, three or six
    passes, as the operands' dtypes make them), against ``jax.vjp`` of the
    chunked scan and of the sequential oracle, dlog_a included, at the
    tolerances of ``test_ssm_scan_bwd_plain_matches_jax_vjp``."""
    B, S, H, N, P, chunk, dt, kdt, shared, with_dh = case
    q, k, v, la, dy, dh = trt._scan_case(case, seed=S + N)
    tq, tk = torch.from_numpy(q).to(dt), torch.from_numpy(k).to(kdt)
    if shared:
        tq, tk = tq.expand(B, S, H, N), tk.expand(B, S, H, N)
    with products(monkeypatch, einsum_by(bf16, 3, 2,
                                         keep=("bhnp,bhnp->bh",))):
        got = ssm_scan_bwd_plain(torch.from_numpy(dy).to(dt),
                                 torch.from_numpy(dh) if with_dh else None,
                                 tq, tk, torch.from_numpy(v).to(dt),
                                 torch.from_numpy(la), chunk)
    if shared:
        got = (got[0].sum(2, keepdim=True), got[1].sum(2, keepdim=True),
               *got[2:])
    for want in trt._jax_scan_vjp(case, q, k, v, la, dy, dh):
        for g, w, d in zip(got, want, (dt, kdt, dt, F32)):
            trt._close(g, w, trt._tol(d) if not shared else
                       (trt._tol(d)[0] * H, trt._tol(d)[1]))


def test_split_einsum_is_the_plain_einsum_on_bf16_operands():
    """Operands exact in bf16 split into one nonzero term: the emulated
    product is the plain fp32 one, bit for bit (the kernels' one-pass
    products)."""
    rng = np.random.default_rng(3)
    a, b = (bf16(torch.from_numpy(rng.standard_normal((2, 8, 5))
                                  .astype(np.float32))) for _ in range(2))
    eq = "bik,bjk->bij"
    assert torch.equal(einsum_by(bf16, 3, 2)(eq, a, b),
                       torch.einsum(eq, a, b))

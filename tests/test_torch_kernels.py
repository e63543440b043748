"""The port's fold kernel: its plain versions (the rows and the leaves
form) against the JAX package's oracle and Pallas kernel, its call forms,
and its no-fallback rules.

On the CPU the wrapper takes the plain version (the CUDA kernel needs the
card); the card cases are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels.agg_weighted_sum import agg_weighted_sum_plain


def _inputs(n, C, bf16, seed=0):
    """numpy inputs fed to both packages: bf16 rows are rounded once (by
    JAX) and handed to torch as the same values."""
    rng = np.random.default_rng(seed)
    acc = rng.normal(size=(n,)).astype(np.float32)
    deltas = rng.normal(size=(C, n)).astype(np.float32)
    if bf16:
        deltas = np.array(jnp.asarray(deltas, jnp.bfloat16)
                          .astype(jnp.float32))
    w = np.linspace(0.5, 2.0, C).astype(np.float32)
    return acc, deltas, w


def _torch_rows(deltas, bf16):
    t = torch.from_numpy(deltas)
    return t.to(torch.bfloat16) if bf16 else t


def _jax_rows(deltas, bf16):
    return jnp.asarray(deltas, jnp.bfloat16 if bf16 else jnp.float32)


# tolerance: the test_kernels.py grid's (atol 1e-4, rtol 1e-4); the two
# sides sum the same fp32 products in a different order
@pytest.mark.parametrize("n", [1000, 65536, 100001])
@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_fold_matches_jax_ref_and_pallas(n, C, bf16):
    acc, deltas, w = _inputs(n, C, bf16)
    out = ops.agg_weighted_sum(torch.from_numpy(acc),
                               _torch_rows(deltas, bf16), w.tolist())
    exp_ref = jref.agg_weighted_sum_ref(jnp.asarray(acc),
                                        _jax_rows(deltas, bf16),
                                        jnp.asarray(w))
    exp_pallas = jops.agg_weighted_sum(jnp.asarray(acc),
                                       _jax_rows(deltas, bf16),
                                       jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp_ref),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp_pallas),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n", [1000, 100001])
def test_pointer_array_form_matches_jax_fold_batch(n, bf16):
    """B separate staged buffers (no stack on the port's side) against the
    JAX package's stacking ``agg_fold_batch``."""
    acc, deltas, w = _inputs(n, 4, bf16, seed=1)
    staged = [_torch_rows(deltas, bf16)[c].clone() for c in range(4)]
    out = ops.agg_fold_batch(torch.from_numpy(acc), staged, w.tolist())
    exp = jops.agg_fold_batch(jnp.asarray(acc),
                              tuple(_jax_rows(deltas, bf16)),
                              jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp),
                               atol=1e-4, rtol=1e-4)


def test_agg_fold_matches_jax():
    rng = np.random.default_rng(2)
    acc = np.zeros((317, 13), np.float32)
    delta = rng.normal(size=(317, 13)).astype(np.float32)
    out = ops.agg_fold(torch.from_numpy(acc), torch.from_numpy(delta), 2.5)
    exp = jops.agg_fold(jnp.asarray(acc), jnp.asarray(delta), 2.5)
    assert out.shape == (317, 13)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=1e-5,
                               rtol=1e-5)


def test_inplace_writes_acc_and_fresh_leaves_it():
    acc, deltas, w = _inputs(257, 3, False, seed=3)
    a = torch.from_numpy(acc.copy())
    fresh = ops.agg_weighted_sum(a, torch.from_numpy(deltas), w.tolist())
    assert fresh.data_ptr() != a.data_ptr()
    np.testing.assert_array_equal(a.numpy(), acc)
    inplace = ops.agg_weighted_sum(a, torch.from_numpy(deltas), w.tolist(),
                                   inplace=True)
    assert inplace.data_ptr() == a.data_ptr()
    # same arithmetic on both routes of the plain version: exact
    np.testing.assert_array_equal(inplace.numpy(), fresh.numpy())


def test_plain_version_sums_clients_in_order():
    """The plain version is acc + w_0 D_0 + w_1 D_1 + ... in fp32, in client
    order (the order the CUDA kernel accumulates in)."""
    acc, deltas, w = _inputs(1000, 5, False, seed=4)
    out = agg_weighted_sum_plain(torch.from_numpy(acc),
                                 torch.from_numpy(deltas), w.tolist())
    exp = acc.copy()
    for c in range(5):
        exp = (exp + np.float32(w[c]) * deltas[c]).astype(np.float32)
    np.testing.assert_array_equal(out.numpy(), exp)


def test_cpu_fold_counts_dispatch_not_launch():
    ops.reset_agg_counts()
    ops.agg_weighted_sum(torch.zeros(8), torch.ones(2, 8), [1.0, 2.0])
    ops.agg_fold_batch(torch.zeros(8), [torch.ones(8)], [1.0])
    assert ops.agg_dispatches == 2
    assert ops.agg_launches == 0


def test_device_weights_are_refused():
    ops.agg_weighted_sum(torch.zeros(4), torch.ones(2, 4), torch.ones(2))
    with pytest.raises(ValueError):
        ops.agg_weighted_sum(torch.zeros(4), torch.ones(2, 4),
                             torch.ones(2, device="meta"))


def _leaves(shapes, C, bf16=(), seed=5):
    """(numpy acc, torch segments, numpy (C, n) block) for leaves of the
    given per-client shapes; leaves whose index is in ``bf16`` hold
    bf16 values."""
    rng = np.random.default_rng(seed)
    segs, cols, off = [], [], 0
    for i, shape in enumerate(shapes):
        x = rng.normal(size=(C,) + shape).astype(np.float32)
        if i in bf16:
            x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        t = torch.from_numpy(x)
        segs.append((t.to(torch.bfloat16) if i in bf16 else t, off))
        cols.append(x.reshape(C, -1))
        off += cols[-1].shape[1]
    acc = rng.normal(size=(off,)).astype(np.float32)
    return acc, segs, np.concatenate(cols, axis=1)


# shapes a client: odd sizes, 0-d leaves, offsets off every 16-byte phase
LEAF_CASES = {
    "aligned": ([(128, 128), (128,), (128, 400), (400,)], ()),
    "odd": ([(3, 3), (), (13,), (1,), (2, 5, 3), ()], ()),
    "mixed": ([(7, 5), (9,), (), (33,)], (1, 2)),
}


# tolerance: the test_kernels.py grid's, as above; against the rows form on
# the concatenated block the bits must agree
@pytest.mark.parametrize("case", sorted(LEAF_CASES))
@pytest.mark.parametrize("C", [1, 4, 64])
def test_leaves_form_matches_jax_and_rows_form(case, C):
    shapes, bf16 = LEAF_CASES[case]
    acc, segs, block = _leaves(shapes, C, bf16)
    w = np.linspace(0.5, 2.0, C).astype(np.float32)
    out = ops.agg_fold_leaves(torch.from_numpy(acc), segs, w.tolist())
    exp = jops.agg_weighted_sum(jnp.asarray(acc), jnp.asarray(block),
                                jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=1e-4,
                               rtol=1e-4)
    rows = ops.agg_weighted_sum(torch.from_numpy(acc),
                                torch.from_numpy(block), w.tolist())
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  rows.numpy().view(np.int32))


def test_leaves_form_reads_strided_and_sliced_leaves():
    """A transposed leaf (no (C, -1) view), a leaf sliced from a padded
    bucket and a leaf strided along the client axis fold like contiguous
    copies of themselves, in place or fresh."""
    rng = np.random.default_rng(6)
    C = 3
    a = torch.from_numpy(rng.normal(size=(C, 6, 5)).astype(np.float32))
    bucket = torch.from_numpy(rng.normal(size=(8, 7)).astype(np.float32))
    spaced = torch.from_numpy(rng.normal(size=(2 * C, 4)).astype(np.float32))
    leaves = [a.transpose(1, 2), bucket[:C], spaced[::2]]
    segs, off = [], 0
    for t in leaves:
        segs.append((t, off))
        off += t[0].numel()
    acc = torch.from_numpy(rng.normal(size=(off,)).astype(np.float32))
    w = [1.5, -0.25, 3.0]
    ref = ops.agg_fold_leaves(acc, [(t.contiguous(), o) for t, o in segs], w)
    fresh = ops.agg_fold_leaves(acc, segs, w)
    assert fresh.data_ptr() != acc.data_ptr()
    np.testing.assert_array_equal(fresh.numpy(), ref.numpy())
    inplace = ops.agg_fold_leaves(acc, segs, w, inplace=True)
    assert inplace.data_ptr() == acc.data_ptr()
    np.testing.assert_array_equal(inplace.numpy(), ref.numpy())


@pytest.mark.parametrize("bad", ["dtype", "too_many_rows", "no_rows",
                                 "weights", "device", "gap", "overlap",
                                 "short", "clients", "acc"])
def test_leaves_form_refuses_what_the_kernel_does_not_take(bad):
    C = 65 if bad == "too_many_rows" else 0 if bad == "no_rows" else 2
    leaf = torch.ones(C, 4)
    segs = [(leaf, 0), (torch.ones(C, 3), 4)]
    acc = torch.zeros(7)
    w = [1.0] * C
    if bad == "dtype":
        segs[1] = (torch.ones(C, 3, dtype=torch.float16), 4)
    elif bad == "weights":
        w = [1.0] * (C + 1)
    elif bad == "device":
        segs[1] = (torch.ones(C, 3, device="meta"), 4)
    elif bad == "gap":
        segs[1] = (torch.ones(C, 3), 5)
    elif bad == "overlap":
        segs[1] = (torch.ones(C, 3), 3)
    elif bad == "short":
        acc = torch.zeros(8)
    elif bad == "clients":
        segs[1] = (torch.ones(C + 1, 3), 4)
    elif bad == "acc":
        acc = torch.zeros(7, dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.agg_fold_leaves(acc, segs, w)


def test_cpu_leaves_fold_counts_dispatch_not_launch():
    ops.reset_agg_counts()
    ops.agg_fold_leaves(torch.zeros(8), [(torch.ones(2, 8), 0)], [1.0, 2.0])
    assert ops.agg_dispatches == 1
    assert ops.agg_launches == ops.agg_leaves_launches == 0
    assert ops.agg_leaf_copies == 0


def test_weights_round_through_fp32():
    """The host weights reach both routes as fp32 values: a weight fp32
    cannot hold folds as its rounded value."""
    w = 1.0 + 2.0 ** -30
    out = ops.agg_fold_leaves(torch.zeros(1), [(torch.ones(1, 1), 0)], [w])
    assert float(out[0]) == float(np.float32(w)) == 1.0


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No fallback: where there is no nvcc the build raises (a CUDA tensor
    would reach this on first use)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["agg_weighted_sum"])


def test_library_path_is_keyed_by_source():
    p = _build.library_path("agg_weighted_sum")
    assert p.parent == _build.BUILD_DIR
    assert p.name.startswith("agg_weighted_sum-") and p.suffix == ".so"


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402


def _flash_tol(bf16):
    """tests/test_kernels.py's tolerances: (atol, rtol)."""
    return (2e-2, 1e-2) if bf16 else (2e-5, 1e-3)


def _qkv(shape, bf16, seed):
    """numpy q, k, v fed to both packages; bf16 values are rounded once (by
    JAX) and handed to torch as the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        a = rng.normal(size=shape).astype(np.float32)
        if bf16:
            a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        out.append(a)
    return out


def _pair(arrays, bf16):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _assert_flash_close(got, want, bf16):
    atol, rtol = _flash_tol(bf16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,S,H,hd", [(2, 256, 4, 64), (1, 128, 2, 128),
                                      (2, 256, 3, 96), (1, 512, 1, 192)])
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_plain_matches_jax_ref(B, S, H, hd, bf16):
    """The JAX kernel test grid (tests/test_kernels.py), causal, through
    the wrapper on CPU tensors (the plain version)."""
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv((B, S, H, hd), bf16, hd), bf16)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, S, H, hd)
    _assert_flash_close(got, want, bf16)


@pytest.mark.parametrize("window", [32, 64, 128])
def test_flash_plain_sliding_window_matches_jax_ref(window):
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv((1, 256, 2, 64), False, window),
                                       False)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    _assert_flash_close(got, want, False)


def test_flash_plain_non_causal_matches_jax_ref():
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv((2, 128, 2, 64), False, 11),
                                       False)
    got = ops.flash_attention(tq, tk, tv, causal=False)
    want = jref.flash_attention_ref(jq, jk, jv, causal=False)
    _assert_flash_close(got, want, False)


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_plain_matches_jax_pallas_interpret(window, bf16):
    """Against the Pallas kernel itself, run in interpret mode, at
    S = 128 (two 64-row blocks, so the KV loop carries m, l and acc)."""
    (jq, jk, jv), (tq, tk, tv) = _pair(_qkv((1, 128, 2, 64), bf16, 12),
                                       bf16)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                blk_q=64, blk_k=64)
    _assert_flash_close(got, want, bf16)


@pytest.mark.parametrize("window", [0, 64])
def test_flash_plain_matches_port_chunked_attention(window):
    """The kernel's plain version == the model's chunked path (the same
    function, two algorithms)."""
    _, (tq, tk, tv) = _pair(_qkv((2, 256, 4, 64), False, 13), False)
    a = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    b = chunked_attention(tq, tk, tv, causal=True, window=window, chunk=64)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize("H,KV", [(4, 1), (4, 2), (14, 2)])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_kv_heads_in_place_match_jax_pallas_repeated(H, KV, window,
                                                           bf16):
    """k and v at their KV heads (query head h reads KV head h // (H // KV))
    against the Pallas kernel in interpret mode on jnp.repeat'ed heads."""
    rng = np.random.default_rng(100 * H + KV + window)
    arrays = []
    for heads in (H, KV, KV):
        a = rng.normal(size=(1, 128, heads, 64)).astype(np.float32)
        if bf16:
            a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        arrays.append(a)
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, bf16)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    want = jops.flash_attention(jq, jnp.repeat(jk, H // KV, axis=2),
                                jnp.repeat(jv, H // KV, axis=2), causal=True,
                                window=window, blk_q=64, blk_k=64)
    assert got.dtype == tq.dtype and tuple(got.shape) == (1, 128, H, 64)
    _assert_flash_close(got, want, bf16)


def test_cpu_flash_counts_dispatch_not_launch():
    ops.reset_flash_counts()
    q = torch.zeros(1, 8, 2, 16)
    ops.flash_attention(q, q, q)
    ops.flash_attention(q, q, q, window=4)
    assert ops.flash_dispatches == 2
    assert ops.flash_launches == 0


def test_flash_refuses_a_device_mix():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="one device"):
        ops.flash_attention(q, q.to("meta"), q)
    # all on the meta device (the dry run's abstract trace): the plain
    # version, which only propagates the shapes
    m = q.to("meta")
    out = ops.flash_attention(m, m, m)
    assert out.is_meta and out.shape == q.shape


def test_flash_checks_what_the_kernel_takes():
    """The checks a CUDA tensor meets before launch, run on CPU tensors."""
    ok = torch.zeros(2, 64, 4, 64)
    ops._check_flash(ok, ok, ok)
    bad = [
        (torch.zeros(2, 64, 4, 80),) * 3,                      # hd 80
        (torch.zeros(8, 64, 64),) * 3,                         # rank 3
        (ok.half(),) * 3,                                      # fp16
        (ok, ok.bfloat16(), ok),                               # dtype mix
        (ok, torch.zeros(2, 64, 3, 64), torch.zeros(2, 64, 3, 64)),  # H % KV
        (ok, torch.zeros(2, 64, 2, 64), torch.zeros(2, 64, 4, 64)),  # k != v
        (ok.transpose(1, 3).contiguous().transpose(1, 3), ok, ok),   # hd stride
    ]
    for q, k, v in bad:
        with pytest.raises(ValueError):
            ops._check_flash(q, k, v)
    # KV heads that divide H pass
    kv = torch.zeros(2, 64, 2, 64)
    ops._check_flash(ok, kv, kv)
    ops._check_flash(ok.bfloat16(), kv.bfloat16(), kv.bfloat16())


def test_flash_refuses_kv_heads_that_do_not_divide_h():
    """H % KV != 0 has no jnp.repeat order: the wrapper refuses it on the
    card route's checks."""
    q = torch.zeros(1, 16, 6, 32)
    kv = torch.zeros(1, 16, 4, 32)
    with pytest.raises(ValueError, match="H % KV"):
        ops._check_flash(q, kv, kv)


# ---------------------------------------------------------------------------
# ssm scan
# ---------------------------------------------------------------------------

from repro_torch.kernels import ssm_scan as tssm  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_plain  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# tests/test_kernels.py's scan tolerance: fp32 sums in another order
SSM_ATOL, SSM_RTOL = 2e-4, 1e-3


def _scan_inputs(B, S, H, N, P, seed):
    """numpy q, k, v, log_a on the model layout, as tests/test_kernels.py
    draws them (k scaled by 0.1, log_a = -softplus)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, N)).astype(np.float32)
    k = (rng.normal(size=(B, S, H, N)) * 0.1).astype(np.float32)
    v = rng.normal(size=(B, S, H, P)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.normal(size=(B, S, H))).astype(np.float32)
    return q, k, v, la


def _bh(a):
    """(B, S, H, ...) -> (B*H, S, ...), the TPU kernel's layout."""
    a = np.moveaxis(a, 2, 1)
    return a.reshape((-1,) + a.shape[2:])


def _scan_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SSM_ATOL,
                               rtol=SSM_RTOL)


@pytest.mark.parametrize("S,chunk", [(256, 64), (256, 128), (512, 256)])
@pytest.mark.parametrize("N,P", [(16, 32), (8, 64)])
def test_ssm_scan_plain_matches_jax_pallas_interpret(S, chunk, N, P):
    """The JAX kernel grid (tests/test_kernels.py): the port's wrapper on
    CPU tensors (the plain version) against the Pallas kernel in interpret
    mode and the sequential oracle, y and h_final."""
    B, H = 1, 3
    q, k, v, la = _scan_inputs(B, S, H, N, P, S + N)
    y, h = ops.ssm_scan(*map(torch.from_numpy, (q, k, v, la)), chunk=chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(h.shape) == (B, H, N, P)
    jy, jh = jops.ssm_scan(*map(jnp.asarray, map(_bh, (q, k, v, la))),
                           chunk=chunk)
    ry, rh = jref.ssm_scan_ref(*map(jnp.asarray, map(_bh, (q, k, v, la))),
                               jnp.zeros((B * H, N, P)))
    for want_y, want_h in ((jy, jh), (ry, rh)):
        _scan_close(torch.from_numpy(_bh(y.numpy())), want_y)
        _scan_close(h.reshape(B * H, N, P), want_h)


@pytest.mark.parametrize("S,chunk", [(1, 64), (200, 64), (40, 256)])
def test_ssm_scan_plain_ragged_matches_jax_ref(S, chunk):
    """S not a multiple of the chunk (one chunk of the whole sequence, as
    in JAX) and S below the chunk, against the sequential oracle."""
    B, H, N, P = 2, 2, 16, 32
    q, k, v, la = _scan_inputs(B, S, H, N, P, S)
    y, h = ops.ssm_scan(*map(torch.from_numpy, (q, k, v, la)), chunk=chunk)
    ry, rh = jref.ssm_scan_ref(*map(jnp.asarray, map(_bh, (q, k, v, la))),
                               jnp.zeros((B * H, N, P)))
    _scan_close(torch.from_numpy(_bh(y.numpy())), ry)
    _scan_close(h.reshape(B * H, N, P), rh)


def test_ssm_scan_ref_matches_jax_ref():
    """The port's sequential oracle, with a nonzero h0, bf16 v."""
    q, k, v, la = (_bh(a) for a in _scan_inputs(2, 24, 2, 8, 16, 3))
    h0 = np.random.default_rng(4).normal(size=(4, 8, 16)).astype(np.float32)
    vb = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    got_y, got_h = tssm.ssm_scan_ref(
        torch.from_numpy(q), torch.from_numpy(k),
        torch.from_numpy(vb).to(torch.bfloat16), torch.from_numpy(la),
        torch.from_numpy(h0))
    want_y, want_h = jref.ssm_scan_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(vb, jnp.bfloat16),
        jnp.asarray(la), jnp.asarray(h0))
    assert got_y.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.float().numpy(),
                               np.asarray(want_y.astype(jnp.float32)),
                               atol=2e-2, rtol=1e-2)
    _scan_close(got_h, want_h)


def test_cpu_ssm_scan_counts_dispatch_not_launch():
    ops.reset_ssm_scan_counts()
    q, k, v, la = map(torch.from_numpy, _scan_inputs(1, 8, 2, 4, 8, 0))
    ops.ssm_scan(q, k, v, la, chunk=4)
    ops.ssm_scan(q, k, v, la, chunk=8)
    assert ops.ssm_scan_dispatches == 2
    assert ops.ssm_scan_launches == 0


def test_ssm_scan_checks_what_the_kernel_takes():
    """The checks a CUDA tensor meets before launch, run on CPU tensors:
    a head stride of 0, an fp32 k beside bf16 q and v, and a state width
    past the old kernel's 428 (N is tiled now) pass."""
    q, k, v, la = map(torch.from_numpy, _scan_inputs(2, 8, 3, 16, 40, 0))
    ops._check_ssm(q, k, v, la)
    ops._check_ssm(q[:, :, :1].expand(2, 8, 3, 16), k, v, la)
    ops._check_ssm(q.bfloat16(), k, v.bfloat16(), la)
    wide = torch.zeros(1, 4, 1, 512)
    ops._check_ssm(wide, wide, torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1))
    many = torch.zeros(1, 1, 1, 8).expand(1, 1, 70000, 8)      # B*H > 65535
    bad = [
        (q.half(), k, v, la),                                   # fp16
        (q, k, v, la.bfloat16()),                               # log_a dtype
        (q, k[:, :, :2], v, la),                                # k shape
        (q, k, v[:, :4], la),                                   # v's S
        (q, k, v, la[..., :2]),                                 # log_a's H
        (q.transpose(1, 3).contiguous().transpose(1, 3), k, v, la),  # N stride
        (many, many, many, torch.zeros(1, 1, 1).expand(1, 1, 70000)),
        (q[..., :0], k[..., :0], v, la),                        # N = 0
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ops._check_ssm(*args)
    with pytest.raises(ValueError, match="one device"):
        ops.ssm_scan(q, k, v, la.to("meta"), chunk=4)


def test_ssm_scan_smem_fits_both_serving_widths():
    """The kernels' shared memory does not grow with N (the state is tiled
    64 rows at a time; the launcher sets and checks it); the workspace the
    wrapper allocates, which does grow, at the serving shapes: hymba (4,
    1024, 8, 16, 400) and xlstm (4, 512, 4, 384, 385) — the chunk states,
    then a total per (b, h, chunk)."""
    assert tssm.workspace_numel(4, 8, 1024, 16, 400) * 4 == 13107200 + 2048
    # xlstm's P = 385 rows padded to 388
    assert tssm.workspace_numel(4, 4, 512, 384, 385) * 4 == 76283904 + 512
    assert tssm.workspace_numel(1, 1, 1, 8, 8) == 64 + 1    # one ragged chunk
    assert tssm.workspace_numel(1, 1, 65, 8, 8) == 2 * (64 + 1)


def _chunk_parallel_scan(q, k, v, log_a, L):
    """The three-step SSD decomposition the scan kernels follow, in plain
    PyTorch (fp32): (1) every chunk's state S_c = sum_s exp(T_c - cum_s)
    k_s v_s^T at once; (2) the states passed along the chunks, h_in(c) =
    exp(T_{c-1}) h_in(c-1) + S_{c-1}; (3) every chunk's outputs at once,
    y_t = sum_{s<=t} (q_t.k_s) exp(cum_t - cum_s) v_s + exp(cum_t) q_t.h_in.
    log_a is 0 past the ragged end, as the kernels read it."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(a):
        a = torch.nn.functional.pad(a.to(torch.float32),
                                    (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape((B, nc, L) + a.shape[2:])

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    cum = torch.cumsum(chunks(log_a[..., None])[..., 0], dim=2)  # (B,nc,L,H)
    total = cum[:, :, -1]                                         # (B,nc,H)
    kdec = kc * torch.exp(total[:, :, None] - cum)[..., None]
    states = torch.einsum("bclhn,bclhp->bchnp", kdec, vc)         # step 1
    h_in = torch.zeros((B, nc, H, N, P))
    h = torch.zeros((B, H, N, P))
    for c in range(nc):                                            # step 2
        h_in[:, c] = h
        h = torch.exp(total[:, c])[..., None, None] * h + states[:, c]
    scores = torch.einsum("bcthn,bcshn->bchts", qc, kc)            # step 3
    gate = torch.exp(cum[:, :, :, None] - cum[:, :, None, :])      # b c t s h
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool))
    gate = torch.where(mask[None, None, :, :, None], gate,
                       torch.zeros(()))
    y = torch.einsum("bchts,bcshp->bcthp",
                     scores * gate.permute(0, 1, 4, 2, 3), vc)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bcthn,bchnp->bcthp", qc, h_in)
    return y.reshape(B, nc * L, H, P)[:, :S].to(v.dtype), h


@pytest.mark.parametrize("S,L", [(256, 64), (256, 32), (512, 128), (1, 64),
                                 (200, 64), (40, 16), (40, 64)])
@pytest.mark.parametrize("shared", [False, True])
def test_chunk_parallel_scan_matches_jax_ref_and_pallas(S, L, shared):
    """The kernels' algorithm at several chunk lengths, ragged S and with q
    and k shared by the heads (a head stride of 0), against the sequential
    oracle and, where S is a multiple of the JAX kernel's chunk, the Pallas
    kernel in interpret mode (its chunk 64)."""
    B, H, N, P = 2, 3, 16, 32
    q, k, v, la = _scan_inputs(B, S, H, N, P, S + L + shared)
    if shared:
        q = np.broadcast_to(q[:, :, :1], q.shape)
        k = np.broadcast_to(k[:, :, :1], k.shape)
    tq, tk = (torch.from_numpy(np.ascontiguousarray(a[:, :, :1])).expand(
        B, S, H, N) if shared else torch.from_numpy(a) for a in (q, k))
    if shared:
        assert tq.stride(2) == 0 and tk.stride(2) == 0
    y, h = _chunk_parallel_scan(tq, tk, torch.from_numpy(v),
                                torch.from_numpy(la), L)
    args = [jnp.asarray(_bh(np.ascontiguousarray(a))) for a in (q, k, v, la)]
    ry, rh = jref.ssm_scan_ref(*args, jnp.zeros((B * H, N, P)))
    _scan_close(torch.from_numpy(_bh(y.numpy())), ry)
    _scan_close(h.reshape(B * H, N, P), rh)
    if S % 64 == 0:
        jy, jh = jops.ssm_scan(*args, chunk=64)
        _scan_close(torch.from_numpy(_bh(y.numpy())), jy)
        _scan_close(h.reshape(B * H, N, P), jh)


def test_chunk_parallel_scan_wide_state_matches_jax_ref():
    """xlstm's state width, N = 384 (with an odd P), through the
    decomposition and the sequential oracle."""
    B, S, H, N, P = 1, 160, 2, 384, 37
    q, k, v, la = _scan_inputs(B, S, H, N, P, 384)
    y, h = _chunk_parallel_scan(*map(torch.from_numpy, (q, k, v, la)), 64)
    args = [jnp.asarray(_bh(a)) for a in (q, k, v, la)]
    ry, rh = jref.ssm_scan_ref(*args, jnp.zeros((B * H, N, P)))
    _scan_close(torch.from_numpy(_bh(y.numpy())), ry)
    _scan_close(h.reshape(B * H, N, P), rh)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

def _rms_tol(bf16):
    """tests/test_kernels.py's rmsnorm tolerance: (atol, rtol)."""
    return (2e-2, 1e-2) if bf16 else (2e-5, 1e-2)


@pytest.mark.parametrize("T,d", [(100, 64), (1000, 896), (256, 128)])
@pytest.mark.parametrize("bf16", [False, True])
def test_rmsnorm_plain_matches_jax_pallas_interpret(T, d, bf16):
    """The JAX kernel grid, through the wrapper on CPU tensors (the plain
    version), against the Pallas kernel in interpret mode and the oracle."""
    (x, g, _) = _qkv((T, d), bf16, T + d)
    g = g[0]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    got = ops.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (T, d)
    atol, rtol = _rms_tol(bf16)
    for want in (jops.rmsnorm(jnp.asarray(x, jdt), jnp.asarray(g, jdt)),
                 jref.rmsnorm_ref(jnp.asarray(x, jdt), jnp.asarray(g, jdt))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=atol,
                                   rtol=rtol)


def test_rmsnorm_plain_is_the_model_layer_bit_for_bit():
    """The model's norm is the wrapper: on CPU tensors the same bits as the
    plain version, leading axes and an fp32 g beside a bf16 x included."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 7, 64)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    for xx, gg in ((x, g), (x.bfloat16(), g), (x.bfloat16(), g.bfloat16())):
        assert torch.equal(layers.rmsnorm({"g": gg}, xx, 1e-6),
                           rmsnorm_plain(xx, gg, 1e-6))


def test_cpu_rmsnorm_counts_dispatch_not_launch():
    ops.reset_rmsnorm_counts()
    ops.rmsnorm(torch.ones(3, 8), torch.ones(8))
    layers.rmsnorm({"g": torch.ones(8)}, torch.ones(2, 3, 8))
    assert ops.rmsnorm_dispatches == 2
    assert ops.rmsnorm_launches == 0


def test_rmsnorm_checks_what_the_kernel_takes():
    """The checks a CUDA tensor meets before launch, run on CPU tensors:
    the row view the kernel reads, or a ValueError."""
    x = torch.zeros(4, 6, 32)
    assert tuple(ops._check_rmsnorm(x, torch.ones(32)).shape) == (24, 32)
    wide = torch.zeros(8, 64)[:, :32]                # 2-D, row stride 64
    assert ops._check_rmsnorm(wide, torch.ones(32)).stride() == (64, 1)
    bad = [
        (x.half(), torch.ones(32)),                              # fp16
        (x, torch.ones(31)),                                     # g size
        (x, torch.ones(32, 1)),                                  # g rank
        (x.transpose(0, 1), torch.ones(32)),                     # 3-D view
        (torch.zeros(8, 64)[:, ::2], torch.ones(32)),            # d stride
        (torch.zeros(0, 32), torch.ones(32)),                    # empty
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ops._check_rmsnorm(*args)
    with pytest.raises(ValueError, match="one device"):
        ops.rmsnorm(x, torch.ones(32).to("meta"))

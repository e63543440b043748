"""The port's fold kernel: its plain version against the JAX package's
oracle and Pallas kernel, its call forms, and its no-fallback rules.

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

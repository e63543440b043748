"""The port on the card: the CUDA fold kernel against its plain version,
and a main-path run that must go through it.

This file imports neither ``jax`` nor ``repro``, so it also runs on a
machine that has only PyTorch; there, skip ``tests/conftest.py`` (which
imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every test here needs a card and skips without one.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.data import make_classification_clients
from repro_torch.kernels import ops
from repro_torch.kernels.agg_weighted_sum import agg_weighted_sum_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("n", [1000, 100001, 1207440])
@pytest.mark.parametrize("C", [1, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda, n, C, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    acc = torch.randn(n, device=cuda, generator=g)
    D = torch.randn(C, n, device=cuda, generator=g).to(dtype)
    w = np.linspace(0.5, 2.0, C).tolist()
    ref = agg_weighted_sum_plain(acc, D, w)
    scale = acc.abs() + sum(abs(wc) * D[c].float().abs()
                            for c, wc in enumerate(w))
    launches = ops.agg_launches
    for out in (ops.agg_weighted_sum(acc, D, w),
                ops.agg_fold_batch(acc.clone(), [r.clone() for r in D], w,
                                   inplace=True)):
        torch.cuda.synchronize()
        # FMA contraction is the only difference (same client order, fp32)
        assert bool(((out - ref).abs() <= 1e-5 * scale).all())
    assert ops.agg_launches == launches + 2


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    acc = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError):
        ops.agg_weighted_sum(acc, torch.ones(65, 8, device=cuda), [1.0] * 65)
    with pytest.raises(ValueError):
        ops.agg_weighted_sum(acc, torch.ones(2, 8, device=cuda,
                                             dtype=torch.float16), [1.0] * 2)
    with pytest.raises(ValueError):
        ops.agg_weighted_sum(acc, [torch.ones(8, device=cuda),
                                   torch.ones(8)], [1.0, 1.0])


def test_cuda_main_path_goes_through_the_kernel(cuda, tmp_path):
    """A short SCAFFOLD run on the card: every fold launches the kernel,
    and the run matches the same run on the CPU."""
    def run(device):
        def loss(params, batch):
            logits = batch["x"] @ params["w"] + params["b"]
            gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
            return torch.mean(torch.logsumexp(logits, -1) - gold)

        algo = T.make_algorithm("scaffold", T.value_and_grad(loss), lr=0.1)
        sm = T.ClientStateManager(str(tmp_path / str(device)),
                                  memory_budget_bytes=4096)
        timer = T.TickTimer(1.0)
        execs = [T.SequentialExecutor(k, algo, state_manager=sm,
                                      timer=timer, device=device)
                 for k in range(3)]
        srv = T.ParrotServer(
            params={"w": torch.zeros(16, 4), "b": torch.zeros(4)},
            algorithm=algo, executors=execs,
            data_by_client=make_classification_clients(
                60, dim=16, n_classes=4, mean_samples=30, seed=0),
            clients_per_round=15, seed=0, device=device)
        srv.run(3)
        return srv

    ops.reset_agg_counts()
    on_card = run(cuda)
    launches = ops.agg_launches
    on_cpu = run("cpu")
    assert launches > 0
    assert [m.makespan for m in on_card.history] == \
        [m.makespan for m in on_cpu.history]
    for k in on_cpu.params:
        # same clients, schedules and fold order; only sum order differs
        torch.testing.assert_close(on_card.params[k].cpu(), on_cpu.params[k],
                                   atol=1e-5, rtol=1e-5)


def test_executor_defaults_to_the_card(cuda):
    algo = T.make_algorithm("fedavg", lambda p, b: (None, p), lr=0.1)
    assert T.SequentialExecutor(0, algo).device == cuda

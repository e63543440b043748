"""The port on the card: the CUDA kernels (the fold, the fused top-k,
flash attention, the SSD scan and RMSNorm) against their plain versions,
and main-path runs that must go through them.

This file imports neither ``jax`` nor ``repro``, so it also runs on a
machine that has only PyTorch; there, skip ``tests/conftest.py`` (which
imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every test here needs a card and skips without one.
"""
import dataclasses
import os
import pickle
import tempfile

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.checkpoint import (CheckpointManager, params_digest,
                                   restore_latest)
from repro_torch.configs.registry import ARCHS
from repro_torch.core import tree
from repro_torch.data import (make_classification_clients,
                              make_classification_population,
                              synthesize_capacity_trace)
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rms_kernel
from repro_torch.kernels.agg_weighted_sum import agg_weighted_sum_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.kernels.ssm_scan import ssm_scan_plain
from repro_torch.kernels.topk_compress import topk_with_residual_plain
from repro_torch.launch.serve import generate, make_prompt
from repro_torch.models import lm

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


# per-client leaf shapes: the full-width MLP's leaves; odd sizes and 0-d
# leaves (offsets in every 16-byte phase: the scalar edge beside vectors);
# bf16 leaves among fp32 ones; a first leaf of 3 elements that puts every
# later offset off the 16-byte phase
FULL_WIDTH_LEAVES = [(128,)] * 70 + [(400,)] + [(128, 128)] * 70 + \
    [(128, 400)]
CUDA_LEAF_CASES = {
    "full_width": (FULL_WIDTH_LEAVES, ()),
    "odd": ([(3, 3), (), (13,), (1,), (2, 5, 3), (), (1000,), (77, 3)], ()),
    "mixed": ([(7, 5), (9,), (), (33,), (256, 16), (100,)], (1, 2, 4)),
    "misaligned": ([(3,), (4096,), (1,), (517, 9), (64,)], (3,)),
    "many": ([(5,)] * 1000 + [(64,)] * 1000, (7,)),
}


def _cuda_leaves(cuda, shapes, C, bf16, seed=0):
    """Leaves of the given per-client shapes on the card, their segments
    and the (C, n) block they concatenate to (fp32 when every leaf is
    fp32, else bf16 leaves widened: the group buffer flatten_batch
    builds)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    segs, cols, off = [], [], 0
    for i, shape in enumerate(shapes):
        t = torch.randn((C,) + shape, device=cuda, generator=g)
        if i in bf16:
            t = t.to(torch.bfloat16)
        segs.append((t, off))
        cols.append(t.reshape(C, -1).float())
        off += cols[-1].shape[1]
    acc = torch.randn(off, device=cuda, generator=g)
    return acc, segs, torch.cat(cols, 1)


@pytest.mark.parametrize("case", sorted(CUDA_LEAF_CASES))
@pytest.mark.parametrize("C", [1, 4, 64])
def test_cuda_leaves_kernel_matches_rows_kernel_bitwise(cuda, case, C):
    """The leaves form against the rows form (the pointer array) on the
    rows of the concatenated block, bit for bit (same operations in the
    same order), and against the plain version within FMA contraction;
    fresh, in place, and over the (C, n) block as one segment."""
    shapes, bf16 = CUDA_LEAF_CASES[case]
    acc, segs, block = _cuda_leaves(cuda, shapes, C, bf16)
    w = np.linspace(0.5, 2.0, C).tolist()
    rows = ops.agg_fold_batch(acc, list(block), w)
    launches = ops.agg_leaves_launches
    fresh = ops.agg_fold_leaves(acc, segs, w)
    inplace = ops.agg_fold_leaves(acc.clone(), segs, w, inplace=True)
    one_segment = ops.agg_weighted_sum(acc, block, w)
    plain = agg_weighted_sum_plain(acc, block, w)
    torch.cuda.synchronize()
    per_call = -(-len(segs) // 150)            # MAX_SEGMENTS a launch
    assert ops.agg_leaves_launches == launches + 2 * per_call + 1
    for out in (fresh, inplace, one_segment):
        assert torch.equal(_bits(out), _bits(rows))
    scale = acc.abs() + sum(abs(wc) * block[c].abs()
                            for c, wc in enumerate(w))
    assert bool(((fresh - plain).abs() <= 1e-5 * scale).all())


def test_cuda_leaves_kernel_reads_strided_and_sliced_leaves(cuda):
    """A transposed leaf is copied (and counted); a leaf sliced from a
    padded bucket and one strided along the client axis are read in place;
    all give the bits of their contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(3)
    C = 4
    a = torch.randn(C, 60, 50, device=cuda, generator=g)
    bucket = torch.randn(8, 1001, device=cuda, generator=g)
    spaced = torch.randn(2 * C, 4000, device=cuda, generator=g)
    leaves = [a.transpose(1, 2), bucket[:C], spaced[::2]]
    segs, off = [], 0
    for t in leaves:
        segs.append((t, off))
        off += t[0].numel()
    acc = torch.randn(off, device=cuda, generator=g)
    w = [1.5, -0.25, 3.0, 0.5]
    ref = ops.agg_fold_leaves(acc, [(t.contiguous(), o) for t, o in segs], w)
    copies = ops.agg_leaf_copies
    got = ops.agg_fold_leaves(acc, segs, w)
    torch.cuda.synchronize()
    assert ops.agg_leaf_copies == copies + 1
    assert torch.equal(_bits(got), _bits(ref))


def test_cuda_leaves_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    acc = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError):                      # C > 64
        ops.agg_fold_leaves(acc, [(torch.ones(65, 8, device=cuda), 0)],
                            [1.0] * 65)
    with pytest.raises(ValueError):                      # fp16 leaf
        ops.agg_fold_leaves(acc, [(torch.ones(2, 8, device=cuda,
                                              dtype=torch.float16), 0)],
                            [1.0] * 2)
    with pytest.raises(ValueError):                      # a leaf on the CPU
        ops.agg_fold_leaves(acc, [(torch.ones(2, 4, device=cuda), 0),
                                  (torch.ones(2, 4), 4)], [1.0] * 2)
    with pytest.raises(ValueError):                      # a gap
        ops.agg_fold_leaves(acc, [(torch.ones(2, 4, device=cuda), 0),
                                  (torch.ones(2, 3, device=cuda), 5)],
                            [1.0] * 2)


def test_cuda_full_width_fold_block_is_one_kernel_a_group(cuda):
    """One full-width fold_block (the 142-leaf MLP, B = 4) puts exactly one
    CUDA kernel and no copy or memset on the card (torch.profiler over ten
    calls, after a profiled warm-up step), and gives the bits of the
    flatten_batch + rows-form fold (the block's rows as a pointer array)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    g = torch.Generator(device=cuda).manual_seed(4)
    dims = [128] * 71 + [400]
    stacked = {"delta": {}}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        stacked["delta"][f"w{i}"] = torch.randn(4, a, b, device=cuda,
                                                generator=g)
        stacked["delta"][f"b{i}"] = torch.randn(4, b, device=cuda,
                                                generator=g)
    ws = [32.0, 32.0, 16.0, 8.0]
    agg = T.LocalAggregator({"delta": T.Op.WEIGHTED_AVG})
    agg.fold_block(stacked, ws)            # builds the layout and acc
    torch.cuda.synchronize()
    got = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.append(p.key_averages())) \
            as prof:
        for _ in range(2):
            for _ in range(10):
                agg.fold_block(stacked, ws)
            torch.cuda.synchronize()
            prof.step()
    counts = {e.key: e.count for e in got[0]
              if e.device_type == torch.autograd.DeviceType.CUDA and e.count
              and not e.key.startswith("ProfilerStep")}    # the step's span
    assert len(counts) == 1 and sum(counts.values()) == 10, counts
    assert "agg_leaves_kernel" in next(iter(counts)), counts
    flat = agg.layout.flatten_batch(stacked)["weighted"]
    ref = torch.zeros(flat.shape[1], device=cuda)
    for _ in range(21):
        ref = ops.agg_fold_batch(ref, list(flat), ws)
    part = agg.partial()["sums"]["buffers"]["weighted"]
    torch.cuda.synchronize()
    assert torch.equal(_bits(part), _bits(ref))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _topk_fresh_and_in_place(buf, rbuf, n, k):
    """The span [3, 3 + n) of buf and rbuf (an odd offset) through the
    kernel, fresh and in place, against the plain version bit for bit;
    nothing outside the span is written."""
    x, res = buf[3:3 + n], rbuf[3:3 + n]
    want = topk_with_residual_plain(x, res, k)
    got = ops.fused_topk(x, res, k)
    inplace = rbuf.clone()
    got_inplace = ops.fused_topk(x, inplace[3:3 + n], k, inplace=True)
    torch.cuda.synchronize()
    for a, b, c in zip(want, got, got_inplace):
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(a), _bits(c))
    assert torch.equal(_bits(inplace[3:3 + n]), _bits(want[2]))
    assert torch.equal(inplace[:3], rbuf[:3])
    assert torch.equal(inplace[3 + n:], rbuf[3 + n:])


@pytest.mark.parametrize("n", [1, 300, 1000, 100001, 1207440])
@pytest.mark.parametrize("frac", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("ties", [False, True])
def test_cuda_topk_matches_plain_bitwise(cuda, n, frac, ties):
    """Spans at an odd offset of a larger buffer; with ``ties`` the values
    are quantised to halves and carry ±0, NaN and inf."""
    k = max(1, int(n * frac))
    g = torch.Generator(device=cuda).manual_seed(n + k)
    buf = torch.randn(n + 9, device=cuda, generator=g)
    rbuf = torch.randn(n + 9, device=cuda, generator=g)
    if ties:
        buf = torch.round(buf * 2) / 2
        rbuf = torch.round(rbuf * 2) / 2 * (rbuf > 0)
        buf[::37] = -0.0
        buf[1::53] = float("nan")
        buf[2::101] = float("inf")
    launches = ops.topk_launches
    _topk_fresh_and_in_place(buf, rbuf, n, k)
    assert ops.topk_launches == launches + 2


@pytest.mark.parametrize("n", [1000, 100001, 1207440])
@pytest.mark.parametrize("frac", [0.0, 0.01, 0.5, 1.0])
def test_cuda_topk_one_first_digit_bin(cuda, n, frac):
    """|f| in [1.5, 1.5625) with either sign: every key shares the first
    radix digit (exponent and 3 mantissa bits), so every element is a
    candidate and the candidate buffer holds all n."""
    k = max(1, int(n * frac))
    g = torch.Generator(device=cuda).manual_seed(n + k)
    mag = 1.5 + torch.rand(n + 9, device=cuda, generator=g) / 16
    sign = torch.rand(n + 9, device=cuda, generator=g) < 0.5
    buf = torch.where(sign, -mag, mag)
    rbuf = torch.where(torch.rand(n + 9, device=cuda, generator=g) < 0.5,
                       torch.zeros_like(buf), 2.0 ** -20)
    _topk_fresh_and_in_place(buf, rbuf, n, k)


@pytest.mark.parametrize("n", [1, 301, 100001])
@pytest.mark.parametrize("which", ["one", "half", "all"])
def test_cuda_topk_all_equal_keys(cuda, n, which):
    """Every |f| equal (±1.5, ±0 or one NaN payload): the ties go to the
    lowest indices, for k in {1, n/2, n}."""
    k = {"one": 1, "half": max(1, n // 2), "all": n}[which]
    g = torch.Generator(device=cuda).manual_seed(n)
    sign = torch.rand(n + 9, device=cuda, generator=g) < 0.5
    for v in (1.5, 0.0, float("nan")):
        buf = torch.where(sign, -v, v) if v == v else torch.full(
            (n + 9,), v, device=cuda)
        _topk_fresh_and_in_place(buf, torch.zeros_like(buf), n, k)


@pytest.mark.parametrize("frac", [1e-4, 0.01])
def test_cuda_topk_span_of_2_to_the_25(cuda, frac):
    n = 1 << 25
    k = int(n * frac)
    g = torch.Generator(device=cuda).manual_seed(25)
    buf = torch.randn(n + 9, device=cuda, generator=g)
    rbuf = torch.randn(n + 9, device=cuda, generator=g) * 0.1
    _topk_fresh_and_in_place(buf, rbuf, n, k)


def test_cuda_topk_call_is_one_kernel_and_no_memset(cuda):
    """One fused_topk call puts at most two CUDA kernels and no memset on
    the card (torch.profiler over ten calls)."""
    from torch.profiler import ProfilerActivity, profile
    n, k = 1207440, 12074
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(n, device=cuda, generator=g)
    res = torch.randn(n, device=cuda, generator=g)
    ops.fused_topk(x, res, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ops.fused_topk(x, res, k)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    memsets = sum(e.count for e in dev if e.key.startswith("Memset"))
    kernels = sum(e.count for e in dev
                  if not e.key.startswith(("Memset", "Memcpy")))
    assert memsets == 0
    assert 1 <= kernels / 10 <= 2, [(e.key, e.count) for e in dev]


def test_cuda_topk_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.ones(16, device=cuda)
    with pytest.raises(ValueError):                      # not fp32
        ops.fused_topk(x.double(), torch.zeros(16, device=cuda,
                                               dtype=torch.float64), 2)
    with pytest.raises(ValueError):                      # not contiguous
        ops.fused_topk(torch.ones(32, device=cuda)[::2],
                       torch.zeros(16, device=cuda), 2)
    with pytest.raises(ValueError):                      # wrong device
        ops.fused_topk(x, torch.zeros(16), 2)
    with pytest.raises(ValueError):                      # k out of range
        ops.fused_topk(x, torch.zeros(16, device=cuda), 17)


def _loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(torch.logsumexp(logits, -1) - gold)


def _quickstart(compressor, rounds, device=None, speed=T.homogeneous,
                **server_kw):
    """The quickstart's 4 executors and 20 clients a round; ``device=None``
    takes the entry points' default, the card."""
    algo = T.make_algorithm("fedavg", T.value_and_grad(_loss), lr=0.05,
                            local_epochs=2)
    timer = T.TickTimer(1.0)
    execs = [T.SequentialExecutor(k, algo, timer=timer, device=device,
                                  speed_model=speed) for k in range(4)]
    srv = T.ParrotServer(
        params={"w": torch.zeros(32, 10), "b": torch.zeros(10)},
        algorithm=algo, executors=execs,
        data_by_client=make_classification_clients(
            100, dim=32, n_classes=10, partition="natural", seed=0),
        clients_per_round=20, seed=0, device=device, compressor=compressor,
        **server_kw)
    srv.run(rounds)
    return srv


def test_cuda_compressed_quickstart_goes_through_the_topk_kernel(cuda):
    """The quickstart with a top-k codec (fraction 0.1) on the card: every
    executor's partial launches the kernel, and the rounds match the same
    rounds on the CPU (makespans and comm bytes identical)."""
    ops.reset_topk_counts()
    on_card = _quickstart(T.make_compressor("topk", 0.1), 3, cuda)
    launches = ops.topk_launches
    on_cpu = _quickstart(T.make_compressor("topk", 0.1), 3, "cpu")
    assert launches == 3 * 4                 # one span per executor a round
    assert [(m.makespan, m.comm_bytes) for m in on_card.history] == \
        [(m.makespan, m.comm_bytes) for m in on_cpu.history]
    for k in on_cpu.params:
        torch.testing.assert_close(on_card.params[k].cpu(), on_cpu.params[k],
                                   atol=1e-5, rtol=1e-5)


def test_cuda_codec_object_goes_through_the_topk_kernel(cuda):
    """A ``TopKCompressor`` object handed to the server on the default
    device compresses on the card through the kernel; the eager numpy
    reference refuses the card's tensors instead of copying them to the
    host."""
    ops.reset_topk_counts()
    srv = _quickstart(T.TopKCompressor(0.01), 1)
    assert srv.params["w"].device.type == "cuda"
    assert ops.topk_launches == 4            # one span per executor
    with pytest.raises(ValueError, match="eager top-k"):
        _quickstart(T.TopKCompressor(0.01, compiled=False), 1)


def test_cuda_main_path_goes_through_the_kernel(cuda, tmp_path):
    """A short SCAFFOLD run on the card: every fold launches the kernel,
    and the run matches the same run on the CPU."""
    def run(device):
        algo = T.make_algorithm("scaffold", T.value_and_grad(_loss), lr=0.1)
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


# the DES engines at the quickstart size (chip_smoke.py phase 8a's runs)
DES_RUNS = {
    "semi-sync": ({"deadline_frac": 0.5, "over_select": 1.5,
                   "chunk_size": 2}, {3: 18.0}, "parrot"),
    "async": ({"staleness_lambda": 0.5, "chunk_size": 2}, {0: 15.0}, "none"),
}


@pytest.mark.parametrize("engine", sorted(DES_RUNS))
def test_cuda_des_engine_matches_cpu_and_folds_by_leaves(cuda, engine):
    """Three windows of each DES engine on the card against the same on
    the CPU: makespans and ``extra`` identical, params allclose, and every
    fold a launch of the leaves form."""
    opts, ratios, policy = DES_RUNS[engine]

    def run(device):
        return _quickstart(None, 3, device, speed=T.hetero_gpus(ratios),
                           round_engine=engine, engine_opts=opts,
                           scheduler_policy=policy)

    ops.reset_agg_counts()
    on_card = run(cuda)
    torch.cuda.synchronize()
    launches, leaves = ops.agg_launches, ops.agg_leaves_launches
    on_cpu = run("cpu")
    assert launches > 0 and leaves == launches and ops.agg_leaf_copies == 0
    assert [(m.makespan, m.n_clients, m.failures, m.extra)
            for m in on_card.history] == \
        [(m.makespan, m.n_clients, m.failures, m.extra)
         for m in on_cpu.history]
    for k in on_cpu.params:
        torch.testing.assert_close(on_card.params[k].cpu(), on_cpu.params[k],
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints, auto-resume and the streamed population on the card
# ---------------------------------------------------------------------------

def _ckpt_server(device, ckpt_dir, engine, compressor=None, data=None,
                 **knobs):
    """The quickstart's model under SCAFFOLD, 4 executors, a state manager
    holding 4 client states (the rest spill), a TickTimer, a checkpoint
    every round."""
    algo = T.make_algorithm("scaffold", T.value_and_grad(_loss), lr=0.05)
    os.makedirs(ckpt_dir, exist_ok=True)
    sm = T.ClientStateManager(tempfile.mkdtemp(dir=ckpt_dir),
                              memory_budget_bytes=4 * 330 * 4)
    timer = T.TickTimer(1.0)
    execs = [T.SequentialExecutor(k, algo, state_manager=sm, timer=timer,
                                  device=device) for k in range(4)]
    opts = {"chunk_size": 2} if engine != "bsp" else None
    return T.ParrotServer(
        params={"w": torch.zeros(32, 10), "b": torch.zeros(10)},
        algorithm=algo, executors=execs,
        data_by_client=data or make_classification_clients(
            100, dim=32, n_classes=10, partition="natural", seed=0),
        clients_per_round=20, seed=0, device=device, compressor=compressor,
        round_engine=engine, engine_opts=opts, **knobs,
        checkpoint_manager=CheckpointManager(
            os.path.join(ckpt_dir, "ck"), every_rounds=1, keep=10))


def _count_spans(srv):
    """Count the compressed spans the server's codec ships."""
    seen, inner = [0], srv.compressor.compress_partial

    def compress_partial(partial, key=None):
        out = inner(partial, key=key)
        seen[0] += sum(kind == "comp"
                       for buf in out["sums"]["buffers"].values()
                       if isinstance(buf, dict)
                       for kind, _ in buf["segments"])
        return out

    srv.compressor.compress_partial = compress_partial
    return seen


@pytest.mark.parametrize("engine,codec", [("bsp", None),
                                          ("semi-sync", None),
                                          ("async", None),
                                          ("async", "topk")])
def test_cuda_kill_and_auto_resume_is_bit_exact(cuda, tmp_path, engine,
                                                codec):
    """On the card: a run killed mid-round and resumed by a fresh server's
    ``run(N, auto_resume=True)`` ends on the uninterrupted run's params
    bit for bit, every fold after the resume a leaves-form launch and,
    under top-k, one launch for each span shipped; dropping the codec's
    restored residuals changes the result."""
    N = 4

    def codec_():
        return None if codec is None else T.make_compressor(codec, 0.1)

    ref = _ckpt_server(cuda, str(tmp_path / "ref"), engine, codec_())
    ex0, calls = ref.executors[0], [0]
    real = ex0.run_queue

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    ex0.run_queue = counting
    ref.run(N)
    want = params_digest(ref.params)
    kill_at = calls[0] * 5 // 8

    work = str(tmp_path / "run")
    victim = _ckpt_server(cuda, work, engine, codec_())
    ex0, calls = victim.executors[0], [0]
    real = ex0.run_queue

    def dying(*a, **kw):
        calls[0] += 1
        if calls[0] >= kill_at:
            raise KeyboardInterrupt
        return real(*a, **kw)

    ex0.run_queue = dying
    with pytest.raises(KeyboardInterrupt):
        victim.run(N)
    assert 1 <= victim.round < N

    resumed = _ckpt_server(cuda, work, engine, codec_())
    spans = _count_spans(resumed) if codec else [0]
    ops.reset_agg_counts()
    ops.reset_topk_counts()
    hist = resumed.run(N, auto_resume=True)
    torch.cuda.synchronize()
    assert params_digest(resumed.params) == want
    assert [m.makespan for m in hist] == [m.makespan for m in ref.history]
    assert ops.agg_launches > 0
    assert ops.agg_leaves_launches == ops.agg_launches
    assert ops.topk_launches == spans[0]
    if codec:
        assert spans[0] > 0
        # the same resume with the restored residuals dropped (from the
        # step the resume started at: the resumed run saved later ones)
        skip = _ckpt_server(cuda, str(tmp_path / "skip"), engine, codec_())
        CheckpointManager(os.path.join(work, "ck")).restore(
            skip, os.path.join(work, "ck", f"step_{victim.round:08d}"))
        skip.compressor.load_state_dict(None)
        while skip.round < N:
            skip.run_round()
        assert params_digest(skip.params) != want


def test_cuda_checkpoint_is_host_data_and_restores_on_the_cpu(cuda,
                                                              tmp_path):
    """A checkpoint written on the card holds CPU tensors only and restores
    into a server on the CPU with the same params bit for bit; a CPU
    checkpoint restores onto the card."""
    srv = _ckpt_server(cuda, str(tmp_path), "async",
                       T.make_compressor("topk", 0.1))
    srv.run(2)
    step = os.path.join(str(tmp_path), "ck", "step_00000002")
    with open(os.path.join(step, "server.pkl"), "rb") as f:
        blob = pickle.load(f)
    events = blob["engine"]["clock"]["events"]
    found = [t for _, _, kind, d in events if kind == "chunk_done"
             for t in tree.leaves(d[1].partial)
             if isinstance(t, torch.Tensor)]
    for part in ("params", "server_state"):
        found += [t for t in tree.leaves(blob[part])]
    found += [t for t in tree.leaves(blob["engine"]["payload"])
              if isinstance(t, torch.Tensor)]
    assert found and all(t.device.type == "cpu" for t in found)
    cpu_dir = tmp_path / "cpu"
    on_cpu = _ckpt_server("cpu", str(cpu_dir), "async",
                          T.make_compressor("topk", 0.1))
    assert restore_latest(on_cpu, os.path.join(str(tmp_path), "ck")) == 2
    for k, v in srv.params.items():
        assert on_cpu.params[k].device.type == "cpu"
        assert torch.equal(on_cpu.params[k], v.cpu())
    on_cpu.run_round()
    card_dir = tmp_path / "card"
    back = _ckpt_server(cuda, str(card_dir), "async",
                        T.make_compressor("topk", 0.1))
    assert restore_latest(back, str(cpu_dir / "ck")) == 3
    assert all(v.device.type == "cuda" for v in back.params.values())
    assert all(t.device.type == "cuda"
               for _, _, kind, d in back.engine._clock.state_dict()["events"]
               if kind == "chunk_done"
               for t in tree.leaves(d[1].partial)
               if isinstance(t, torch.Tensor))
    back.run_round()


def test_cuda_lazy_population_equals_its_eager_twin(cuda, tmp_path):
    """M = 2,000 streamed clients on the card: the lazy run equals its
    ``materialize()`` eager twin bit for bit, with the fetch cache bounded."""
    def pop():
        return make_classification_population(
            2000, dim=32, n_classes=10, seed=0, fetch_cache_bytes=64 << 10)

    runs = []
    for i, data in enumerate((pop().materialize(), pop())):
        d = tmp_path / str(i)
        srv = _ckpt_server(cuda, str(d), "bsp", data=data)
        srv.checkpoint_manager = None
        srv.run(3)
        runs.append((srv, data))
    (eager, _), (lazy, lp) = runs
    for k in eager.params:
        assert torch.equal(eager.params[k], lazy.params[k])
    assert [m.makespan for m in eager.history] == \
        [m.makespan for m in lazy.history]
    assert lp.cache_bytes <= lp.fetch_cache_bytes
    assert lp.stats["evictions"] > 0


# ---------------------------------------------------------------------------
# the network, availability and fault model on the card
# ---------------------------------------------------------------------------

def _lognormal_net():
    """benchmarks/bench_network.py's constrained uplink over the
    quickstart's 100 clients."""
    return T.NetworkModel.from_trace(synthesize_capacity_trace(
        100, seed=13, dist="lognormal", median_uplink_kbps=40.0))


def _chaos():
    """A dense seeded plan over the quickstart's first ~15 virtual
    seconds: seed 2 crashes, restarts, corrupts and retries under every
    engine in 3 rounds."""
    return T.FaultPlan.random(
        seed=2, horizon=15.0, executors=[0, 1, 2, 3],
        clients=list(range(100)), crash_rate=0.2, restart_delay=3.0,
        dropout_rate=0.5, dropout_duration=4.0, corrupt_rate=0.4,
        blackout_rate=0.2, blackout_duration=1.0, slowdown_rate=0.1,
        slowdown_duration=6.0)


def test_cuda_comm_priced_async_topk_launches_equal_spans_shipped(
        cuda, monkeypatch):
    """Async windows under a lognormal uplink trace with top-k 0.1 and
    corrupt payloads on the card: one top-k launch for each span shipped,
    the re-runs of discarded partials included, and each window's
    ``comm_wire_bytes`` the bytes of the kernel outputs it shipped."""
    from repro_torch.core import engine as eng
    plan = T.FaultPlan([T.FaultEvent(time=0.0, kind="corrupt", executor=k)
                        for k in range(4)])
    billed = {}
    inner = eng._NetSim.ship

    def ship(self, executor, partial):
        out = inner(self, executor, partial)
        rnd = self.srv.round          # a window's tail bills the next one
        billed[rnd] = billed.get(rnd, 0) + out[1]
        return out

    monkeypatch.setattr(eng._NetSim, "ship", ship)
    ops.reset_topk_counts()
    srv = _quickstart(T.make_compressor("topk", 0.1), 0, cuda,
                      round_engine="async", engine_opts={"chunk_size": 2},
                      network=_lognormal_net(), faults=plan)
    spans = _count_spans(srv)
    srv.run(3)
    torch.cuda.synchronize()
    assert spans[0] > 0 and ops.topk_launches == spans[0]
    hist = srv.history
    assert sum(m.extra["corrupt_payloads"] for m in hist) == 4
    assert all(m.extra["comm_time_up"] > 0 for m in hist)
    assert [m.extra["comm_wire_bytes"] for m in hist] == \
        [float(billed[r]) for r in range(3)]


def test_cuda_corrupt_payload_never_reaches_the_global_fold(cuda,
                                                            monkeypatch):
    """BSP on the card with executor 1's first partial corrupt: the
    shipped corrupt wire never enters the global fold, its clients re-run
    and re-ship (through the top-k kernel again), and the round equals its
    CPU twin."""
    from repro_torch.core import engine as eng
    plan = T.FaultPlan([T.FaultEvent(time=0.0, kind="corrupt", executor=1)])

    def run(device):
        shipped, folded = [], []
        inner = eng._NetSim.ship

        def ship(self, executor, partial):
            out = inner(self, executor, partial)
            shipped.append((executor, out[0]))
            return out

        monkeypatch.setattr(eng._NetSim, "ship", ship)
        ops.reset_topk_counts()
        ops.reset_agg_counts()
        srv = _quickstart(T.make_compressor("topk", 0.1), 0, device,
                          network=T.NetworkModel.uniform(2e5, 1e6, 0.01),
                          faults=plan, retry=T.RetryPolicy(max_retries=2))
        gf = srv.global_fold
        srv.global_fold = lambda parts: folded.extend(parts) or gf(parts)
        srv.run(2)
        monkeypatch.setattr(eng._NetSim, "ship", inner)
        return srv, shipped, folded, ops.topk_launches

    on_card, shipped, folded, launches = run(cuda)
    torch.cuda.synchronize()
    assert ops.agg_launches > 0 and ops.agg_leaves_launches == \
        ops.agg_launches
    m0 = on_card.history[0]
    assert m0.extra["corrupt_payloads"] == 1 and m0.extra["retries"] > 0
    corrupt = next(w for k, w in shipped if k == 1)
    assert all(p is not corrupt for p in folded)
    assert len(folded) == len(shipped) - 1
    assert launches == len(shipped)              # one span a partial
    on_cpu, _, _, _ = run("cpu")
    assert [(m.makespan, m.extra) for m in on_card.history] == \
        [(m.makespan, m.extra) for m in on_cpu.history]
    for k in on_cpu.params:
        torch.testing.assert_close(on_card.params[k].cpu(), on_cpu.params[k],
                                   atol=1e-5, rtol=1e-5)


def test_cuda_inflight_upload_saved_from_the_card_restores_onto_it(
        cuda, tmp_path):
    """An async checkpoint under a network holds in-flight ``chunk_arrived``
    partials as CPU tensors; restoring puts them back on the card, and the
    resumed windows equal the uninterrupted ones bit for bit."""
    net = T.NetworkModel.uniform(2_000.0, 1e8, 0.01)
    srv = _ckpt_server(cuda, str(tmp_path / "a"), "async",
                       T.make_compressor("topk", 0.1), network=net)
    srv.run(4)
    step = os.path.join(str(tmp_path / "a"), "ck", "step_00000002")
    with open(os.path.join(step, "server.pkl"), "rb") as f:
        blob = pickle.load(f)
    arrived = [d for _, _, kind, d in blob["engine"]["clock"]["events"]
               if kind == "chunk_arrived"]
    assert arrived
    for ce in arrived:
        assert all(t.device.type == "cpu" for t in tree.leaves(ce.partial)
                   if isinstance(t, torch.Tensor))
    back = _ckpt_server(cuda, str(tmp_path / "b"), "async",
                        T.make_compressor("topk", 0.1), network=net)
    CheckpointManager(os.path.join(str(tmp_path / "a"), "ck")).restore(
        back, step)
    moved = [d for _, _, kind, d in back.engine._clock.state_dict()["events"]
             if kind == "chunk_arrived"]
    assert len(moved) == len(arrived)
    assert all(t.device.type == cuda.type for ce in moved
               for t in tree.leaves(ce.partial)
               if isinstance(t, torch.Tensor))
    back.run_round()
    back.run_round()
    assert params_digest(back.params) == params_digest(srv.params)
    assert [m.makespan for m in back.history[2:]] == \
        [m.makespan for m in srv.history[2:]]


@pytest.mark.parametrize("engine", ["bsp", "semi-sync", "async"])
def test_cuda_fault_plan_run_equals_its_cpu_twin(cuda, engine):
    """Three rounds under a seeded chaos plan with a network and a retry
    policy, on the card and on the CPU under a TickTimer: the same
    makespans and every fault and comm counter, params within 1e-5."""
    opts = {} if engine == "bsp" else {"chunk_size": 2}

    def run(device):
        return _quickstart(
            T.make_compressor("topk", 0.1), 3, device,
            round_engine=engine, engine_opts=opts, faults=_chaos(),
            retry=T.RetryPolicy(timeout_s=1.0, max_retries=2, backoff_s=0.5),
            network=T.NetworkModel.uniform(12e6, 24e6, latency_s=0.03))

    on_card = run(cuda)
    on_cpu = run("cpu")
    for key in ("fault_crashes", "corrupt_payloads", "retries"):
        assert sum(m.extra.get(key, 0.0) for m in on_card.history) > 0, key
    assert [(m.makespan, m.n_clients, m.failures, m.extra)
            for m in on_card.history] == \
        [(m.makespan, m.n_clients, m.failures, m.extra)
         for m in on_cpu.history]
    assert on_card.faults.state_dict() == on_cpu.faults.state_dict()
    for k in on_cpu.params:
        torch.testing.assert_close(on_card.params[k].cpu(), on_cpu.params[k],
                                   atol=1e-5, rtol=1e-5)


def _equal_clients(n=24, samples=40, batch=20, dim=16):
    """Equal-size clients: every executor's queue plans into aligned
    block waves (the gang's gate)."""
    rng = np.random.default_rng(0)
    out = {}
    for c in range(n):
        ys = rng.integers(0, 4, size=samples).astype(np.int32)
        xs = rng.normal(size=(samples, dim)).astype(np.float32)
        out[c] = T.ClientData(
            batches=[{"x": xs[i:i + batch], "y": ys[i:i + batch]}
                     for i in range(0, samples, batch)], n_samples=samples)
    return out


def _placed(device, name="fedprox", rounds=4, **server_kw):
    """Four executors ganged on one device, two waves of two clients an
    executor a round, under a TickTimer."""
    algo = T.make_algorithm(name, T.value_and_grad(_loss), lr=0.05)
    sm = T.ClientStateManager(tempfile.mkdtemp())
    timer = T.TickTimer(1.0)
    execs = [T.SequentialExecutor(k, algo, state_manager=sm, timer=timer,
                                  client_block=2, device=device)
             for k in range(4)]
    srv = T.ParrotServer(
        params={"w": torch.zeros(16, 4), "b": torch.zeros(4)},
        algorithm=algo, executors=execs, data_by_client=_equal_clients(),
        clients_per_round=16, scheduler_policy="uniform", seed=0,
        device=device, placement=T.DevicePlacement(range(4),
                                                   devices=[device]),
        **server_kw)
    eng = T.engine_for(algo, torch.device(device))
    srv.run(rounds)
    return srv, eng


@pytest.mark.parametrize("name", ["fedprox", "scaffold"])
def test_cuda_gang_on_one_card_matches_serial_and_cpu(cuda, name):
    """Four executors on cuda:0 ganged into one vmap a wave: one dispatch
    a wave (no first-seen re-run on the card), the serial dispatch's and
    the CPU gang's makespans, params within 1e-5 of both."""
    gang, eng = _placed(cuda, name)
    assert eng.n_dispatches == 4 * 2            # rounds x waves
    serial, eng_s = _placed(cuda, name, gang_dispatch=False)
    assert eng_s.n_dispatches > eng.n_dispatches
    on_cpu, _ = _placed("cpu", name)
    for other in (serial, on_cpu):
        assert [m.makespan for m in gang.history] == \
            [m.makespan for m in other.history]
        for k in other.params:
            torch.testing.assert_close(gang.params[k].cpu(),
                                       other.params[k].cpu(),
                                       atol=1e-5, rtol=1e-5)


def test_cuda_parallel_dispatch_on_streams_matches_serial(cuda):
    """Executors in threads, each on its own stream, give the serial
    round within 1e-5."""
    par, _ = _placed(cuda, "fedavg", rounds=3, parallel_dispatch=True)
    serial, _ = _placed(cuda, "fedavg", rounds=3, gang_dispatch=False)
    for k in serial.params:
        torch.testing.assert_close(par.params[k], serial.params[k],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("K", [4, 70])
def test_cuda_global_fold_is_one_kernel_a_group_and_the_left_fold(cuda, K):
    """The placement's global fold on the card: one rows-form launch a
    fp32 weight group for every 64 rows past the first, equal bit for bit
    to the host left fold ``b0 + b1 + …`` (a -0.0 of ``b0`` kept)."""
    n = 1_207_440 if K == 4 else 10_001
    ops_ = {"delta": T.Op.WEIGHTED_AVG, "count": T.Op.SUM}
    layout = T.FlatLayout.build(ops_, {"delta": {"w": torch.zeros(n)},
                                       "count": torch.zeros(())})
    g = torch.Generator(device="cuda").manual_seed(7)
    parts = []
    for i in range(K):
        w = torch.randn(n, device=cuda, generator=g) * 11
        w[:5] = -0.0
        parts.append({"sums": {"__flat__": True, "buffers": {
            "weighted": w, "unit": torch.randn(1, device=cuda,
                                               generator=g)}},
            "layout": layout, "weights": {"delta": 2.0 + i},
            "counts": {"delta": 2, "count": 1}, "collected": {},
            "n_clients": 2})
    pl = T.DevicePlacement(range(K), devices=[cuda])
    ops.reset_agg_counts()
    folded = pl.global_fold(parts, ops_)
    torch.cuda.synchronize()
    assert ops.agg_launches == 2 * -(-(K - 1) // ops.MAX_FOLD_ROWS)
    ref = T.global_aggregate(parts, ops_)
    for got, want in ((folded["delta"]["w"], ref["delta"]["w"]),
                      (folded["count"], ref["count"])):
        assert got.device == cuda
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cuda_collective_comm_round_equals_local_comm(cuda):
    """``CollectiveComm`` moves the card's partials by reference: params
    equal the ``LocalComm`` run bit for bit, and a round bills the
    broadcast once plus twice each partial's sums."""
    from repro_torch.comm import CollectiveComm, LocalComm
    from repro_torch.core.aggregation import payload_bytes
    coll, _ = _placed(cuda, "fedavg", rounds=2, comm=CollectiveComm())
    local, _ = _placed(cuda, "fedavg", rounds=2, comm=LocalComm())
    for k in local.params:
        assert torch.equal(coll.params[k], local.params[k])
    algo = coll.algorithm
    payload = algo.broadcast_payload(coll.params, coll.server_state)
    assert coll.history[-1].comm_bytes > payload_bytes(payload)
    assert [m.comm_bytes for m in coll.history] != \
        [m.comm_bytes for m in local.history]


def test_executor_defaults_to_the_card(cuda):
    algo = T.make_algorithm("fedavg", lambda p, b: (None, p), lr=0.1)
    assert T.SequentialExecutor(0, algo).device == cuda


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# (B, S, H, hd, causal, window): the JAX kernel grid (tests/test_kernels.py),
# its windows, a non-causal case, the reduced configs' hd 16 and a ragged
# S, and the qwen2-0.5b serving shape
FLASH_GRID = [(2, 256, 4, 64, True, 0), (1, 128, 2, 128, True, 0),
              (2, 256, 3, 96, True, 0), (1, 512, 1, 192, True, 0),
              (1, 256, 2, 64, True, 32), (1, 256, 2, 64, True, 64),
              (1, 256, 2, 64, True, 128), (2, 256, 4, 64, False, 0),
              (2, 33, 4, 16, True, 0), (1, 200, 2, 32, True, 0),
              (4, 1024, 14, 64, True, 0)]


@pytest.mark.parametrize("case", FLASH_GRID, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_matches_plain(cuda, case, dtype):
    """Tolerances of tests/test_kernels.py: fp32 atol 2e-5 / rtol 1e-3,
    bf16 atol 2e-2 / rtol 1e-2 (the output is rounded to bf16)."""
    B, S, H, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(S + hd)
    q, k, v = (torch.randn(B, S, H, hd, device=cuda, generator=g).to(dtype)
               for _ in range(3))
    launches = ops.flash_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_launches == launches + 1
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = (2e-5, 1e-3) if dtype == torch.float32 else (2e-2, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# (B, Sq, Skv, H, KV, hd, causal, window): every head dim with KV < H,
# ragged Sq and Skv (apart and together), windows, the two serving shapes
FLASH_GQA_GRID = ([(2, 256, 256, 4, 2, hd, True, 0)
                   for hd in (16, 32, 64, 96, 128, 192)]
                  + [(2, 200, 200, 6, 3, 64, True, 0),
                     (1, 100, 130, 4, 1, 128, True, 0),
                     (1, 130, 100, 4, 2, 64, False, 0),
                     (1, 77, 77, 2, 1, 96, True, 20),
                     (2, 256, 256, 4, 1, 64, True, 32),
                     (1, 300, 300, 8, 2, 192, True, 100),
                     (4, 1024, 1024, 14, 2, 64, True, 0),
                     (4, 1024, 1024, 25, 5, 64, True, 1024)])


@pytest.mark.parametrize("case", FLASH_GQA_GRID, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_kv_heads_in_place_match_plain(cuda, case, dtype):
    """k and v at their KV heads: bf16 through the tensor-core kernel,
    fp32 through the CUDA-core kernel, each against the plain version (which
    repeats the heads) at tests/test_kernels.py's tolerances."""
    B, Sq, Skv, H, KV, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(Sq + 7 * hd + KV)
    q = torch.randn(B, Sq, H, hd, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(B, Skv, KV, hd, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    routes = dict(ops.flash_route_launches)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    route = "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"
    routes[route] += 1
    assert ops.flash_route_launches == routes
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = (2e-5, 1e-3) if dtype == torch.float32 else (2e-2, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_cuda_flash_bf16_goes_through_the_tensor_core_kernel(cuda):
    """A bf16 call launches the wgmma kernel and an fp32 call the CUDA-core
    kernel: the per-route counters and the symbol each route binds."""
    from repro_torch.kernels import flash_attention as fa
    ops.reset_flash_counts()
    q = torch.zeros(1, 64, 2, 64, device=cuda)
    ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert ops.flash_route_launches == {"tensor_cores": 1, "cuda_cores": 0}
    ops.flash_attention(q, q, q)
    assert ops.flash_route_launches == {"tensor_cores": 1, "cuda_cores": 1}
    assert ops.flash_launches == 2
    assert fa._launcher("tensor_cores").__name__ == \
        "flash_attention_bf16_launch"
    assert fa._launcher("cuda_cores").__name__ == \
        "flash_attention_fp32_launch"
    ops.reset_flash_counts()
    assert ops.flash_route_launches == {"tensor_cores": 0, "cuda_cores": 0}


def test_cuda_flash_reads_strided_inputs(cuda):
    """q, k, v as views with a unit stride along hd only (a (B, H, S, hd)
    buffer seen as (B, S, H, hd)): both kernels read them in place, the
    bf16 one with KV heads at another stride than q's."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 4, 128, 64, device=cuda, generator=g)
               .transpose(1, 2) for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-3)
    qb = q.bfloat16()                                   # contiguous copy
    kb, vb = (torch.randn(2, 2, 160, 128, device=cuda, generator=g)
              .bfloat16()[:, :, 16:144, 32:96].transpose(1, 2)
              for _ in range(2))                        # (2, 128, 2, 64)
    got = ops.flash_attention(qb, kb, vb, causal=True, window=40)
    want = flash_attention_plain(qb, kb, vb, causal=True, window=40)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=1e-2)


def test_flash_bf16_layouts_tma_cannot_load_are_refused(cuda):
    """The tensor-core launcher loads bf16 tiles with TMA: a (batch, seq,
    head) stride that is not a multiple of 8 elements, or an address off 16
    bytes, is refused with a ValueError and counts no launch; the same
    layout in fp32 (the CUDA-core kernel), a (B, H, S, hd) buffer seen as
    (B, S, H, hd), and an odd stride along a size-1 axis run."""
    g = torch.Generator(device=cuda).manual_seed(3)
    base = torch.randn(1, 16, 3, 64 + 4, device=cuda, generator=g)
    odd = base.bfloat16()[..., :64]                 # head stride 68
    shifted = torch.randn(1 + 16 * 2 * 64, device=cuda,
                          generator=g).bfloat16()[1:].view(1, 16, 2, 64)
    ops.reset_flash_counts()
    for bad in (odd, shifted):
        with pytest.raises(ValueError, match="TMA"):
            ops.flash_attention(bad, bad, bad)
    assert ops.flash_launches == 0
    o32 = base[..., :64]
    torch.testing.assert_close(ops.flash_attention(o32, o32, o32),
                               flash_attention_plain(o32, o32, o32),
                               atol=2e-5, rtol=1e-3)
    bhsd = torch.randn(2, 4, 32, 64, device=cuda,
                       generator=g).bfloat16().transpose(1, 2)
    one = torch.randn(1, 32, 4, 68, device=cuda,
                      generator=g).bfloat16()[:, :, :1, :64]  # head axis 1
    for t in (bhsd, one):
        torch.testing.assert_close(ops.flash_attention(t, t, t).float(),
                                   flash_attention_plain(t, t, t).float(),
                                   atol=2e-2, rtol=1e-2)
    assert ops.flash_route_launches["tensor_cores"] == 2


def test_cuda_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 64, 2, 64, device=cuda)
    with pytest.raises(ValueError):                      # hd 80
        z = torch.zeros(1, 64, 2, 80, device=cuda)
        ops.flash_attention(z, z, z)
    with pytest.raises(ValueError):                      # rank 3
        z = torch.zeros(2, 64, 64, device=cuda)
        ops.flash_attention(z, z, z)
    with pytest.raises(ValueError):                      # CPU/CUDA mix
        ops.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):
        ops.flash_attention(q.cpu(), q, q.cpu())
    with pytest.raises(ValueError):                      # fp16
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):                      # H % KV != 0
        z = torch.zeros(1, 64, 3, 64, device=cuda)
        ops.flash_attention(q.repeat(1, 1, 2, 1), z, z)
    with pytest.raises(ValueError):                      # no TMA layout
        z = torch.zeros(1, 64, 2, 68, device=cuda,
                        dtype=torch.bfloat16)[..., :64]
        ops.flash_attention(z, z, z)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_cuda_reduced_generate_matches_cpu(cuda, impl):
    """qwen2-0.5b reduced (2 layers, hd 16), fp32: the card and the CPU
    give the same 8 tokens and logits within 1e-4; with ``pallas`` the
    prefill launches the kernel once a layer and the decode never."""
    cfg = dataclasses.replace(ARCHS["qwen2-0.5b"].reduced(),
                              attention_impl=impl)
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    prompt = make_prompt(cfg, 2, 64, seed=0)
    ops.reset_flash_counts()
    toks, logits, t = generate(params, prompt, cfg, 8, cuda)
    total = ops.flash_launches
    want_toks, want_logits, _ = generate(
        tree.map(lambda a: a.cpu(), params), prompt, cfg, 8, "cpu")
    expect = cfg.n_layers if impl == "pallas" else 0
    assert (t["prefill_flash_launches"], t["decode_flash_launches"],
            total) == (expect, 0, expect)
    assert torch.equal(toks.cpu(), want_toks)
    torch.testing.assert_close(logits.cpu(), want_logits, atol=1e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# ssm scan
# ---------------------------------------------------------------------------

BF = torch.bfloat16
F32 = torch.float32
# (B, S, H, N, P, chunk, q/v dtype, k dtype, q and k shared by the heads):
# a JAX grid point, ragged S (1, 200), the reduced configs' N = 8 and 32,
# hymba's serving shape (q, k broadcast over 8 heads) and xlstm's (N = 384,
# P = 385, an fp32 k beside bf16 q and v); on the tensor cores (all bf16):
# ragged S and P with shared heads, S = 1, N = 384 and 400 wide, and an N
# past the old kernel's limit in fp32
SCAN_GRID = [(2, 256, 3, 16, 32, 64, F32, F32, False),
             (2, 512, 3, 8, 64, 256, F32, F32, False),
             (2, 1, 3, 16, 32, 64, F32, F32, False),
             (2, 200, 3, 16, 32, 64, F32, F32, False),
             (2, 48, 4, 32, 33, 16, F32, F32, False),
             (4, 1024, 8, 16, 400, 256, BF, BF, True),
             (1, 1024, 8, 16, 400, 256, F32, F32, True),
             (4, 512, 4, 384, 385, 256, BF, F32, False),
             (2, 200, 3, 16, 33, 64, BF, BF, True),
             (2, 1, 3, 8, 70, 64, BF, BF, False),
             (1, 300, 2, 384, 400, 256, BF, BF, False),
             (1, 130, 2, 512, 65, 64, F32, F32, True)]


def _scan_tol(dtype):
    """tests/test_kernels.py's scan tolerance in fp32; in bf16 its bf16
    tolerance, since y is rounded once to bf16 (a rounding of either side
    can flip one bf16 step)."""
    return (2e-4, 1e-3) if dtype == F32 else (2e-2, 1e-2)


def _scan_inputs(case, device, seed):
    B, S, H, N, P, chunk, dt, kdt, shared = case
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device=device, generator=g)

    Hq = 1 if shared else H
    q = rnd(B, S, Hq, N).to(dt).expand(B, S, H, N)
    k = (rnd(B, S, Hq, N) * (0.05 if N > 100 else 0.3)).to(kdt) \
        .expand(B, S, H, N)
    v = rnd(B, S, H, P).to(dt)
    la = -torch.nn.functional.softplus(rnd(B, S, H))
    return q, k, v, la, chunk


@pytest.mark.parametrize("case", SCAN_GRID, ids=str)
def test_cuda_ssm_scan_matches_plain(cuda, case):
    q, k, v, la, chunk = _scan_inputs(case, cuda, case[1] + case[3])
    launches = ops.ssm_scan_launches
    y, h = ops.ssm_scan(q, k, v, la, chunk=chunk)
    wy, wh = ssm_scan_plain(q, k, v, la, chunk)
    torch.cuda.synchronize()
    assert ops.ssm_scan_launches == launches + 1
    assert y.dtype == v.dtype and h.dtype == F32
    assert y.shape == v.shape and h.shape == wh.shape
    atol, rtol = _scan_tol(v.dtype)
    torch.testing.assert_close(y.float(), wy.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(h, wh, atol=2e-4, rtol=1e-3)


def test_cuda_ssm_scan_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, la, _ = _scan_inputs(SCAN_GRID[0], cuda, 0)
    with pytest.raises(ValueError):                      # fp16
        ops.ssm_scan(q.half(), k, v, la, chunk=64)
    with pytest.raises(ValueError):                      # bf16 log_a
        ops.ssm_scan(q, k, v, la.bfloat16(), chunk=64)
    with pytest.raises(ValueError):                      # B*H > 65535
        z = torch.zeros(1, 8, 1, 16, device=cuda).expand(1, 8, 70000, 16)
        ops.ssm_scan(z, z, z, torch.zeros(1, 8, 1, device=cuda)
                     .expand(1, 8, 70000), chunk=8)
    with pytest.raises(ValueError):                      # CPU/CUDA mix
        ops.ssm_scan(q, k, v.cpu(), la, chunk=64)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

# (rows, d): tests/test_kernels.py's grid, an odd d (the scalar path), the
# hymba prefill and decode shapes
RMS_GRID = [(100, 64), (1000, 896), (256, 128), (7, 33), (4096, 1600),
            (4, 1600)]


@pytest.mark.parametrize("T,d", RMS_GRID)
@pytest.mark.parametrize("dtype", [F32, BF])
def test_cuda_rmsnorm_matches_plain(cuda, T, d, dtype):
    """tests/test_kernels.py's tolerances: fp32 atol 2e-5, bf16 2e-2,
    rtol 1e-2."""
    g = torch.Generator(device=cuda).manual_seed(T + d)
    x = torch.randn(T, d, device=cuda, generator=g).to(dtype)
    w = torch.randn(d, device=cuda, generator=g).to(dtype)
    launches = ops.rmsnorm_launches
    got = ops.rmsnorm(x, w)
    want = rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    assert ops.rmsnorm_launches == launches + 1
    assert got.dtype == dtype and got.shape == x.shape
    atol = 2e-5 if dtype == F32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=1e-2)


def test_cuda_rmsnorm_takes_leading_axes_strided_rows_and_mixed_g(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 5, 96, device=cuda, generator=g)
    w = torch.randn(96, device=cuda, generator=g)
    rows = torch.randn(6, 200, device=cuda, generator=g)[:, 8:104]
    for xx, ww in ((x, w), (x.bfloat16(), w), (x, w.bfloat16()),
                   (rows, w), (rows.bfloat16(), w.bfloat16())):
        got = ops.rmsnorm(xx, ww, 1e-6)
        want = rmsnorm_plain(xx, ww, 1e-6)
        atol = 2e-5 if xx.dtype == F32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=1e-2)


def _rms_check(x, w, eps=1e-5):
    """The kernel against plain at tests/test_kernels.py's tolerances;
    returns the route the launch took."""
    launches = ops.rmsnorm_launches
    got = ops.rmsnorm(x, w, eps)
    want = rmsnorm_plain(x, w, eps)
    torch.cuda.synchronize()
    assert ops.rmsnorm_launches == launches + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    atol = 2e-5 if x.dtype == F32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=1e-2)
    x2 = x.reshape(-1, x.shape[-1]) if x.is_contiguous() else x
    return rms_kernel.route(x2, w, got.view(-1, x.shape[-1]))


@pytest.mark.parametrize("T", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [896, 1600])
@pytest.mark.parametrize("dtype", [F32, BF])
def test_cuda_rmsnorm_decode_rows_take_the_few_rows_route(cuda, T, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(T * d)
    x = torch.randn(T, d, device=cuda, generator=g).to(dtype)
    w = torch.randn(d, device=cuda, generator=g).to(dtype)
    assert _rms_check(x, w) == "few_rows"


@pytest.mark.parametrize("T,d,route", [
    (4, 3072, "few_rows"), (300, 3072, "rows"), (4, 5120, "few_rows"),
    (300, 5120, "rows"), (300, 16400, "looped"), (4, 40000, "looped")])
@pytest.mark.parametrize("dtype", [F32, BF])
def test_cuda_rmsnorm_long_rows(cuda, T, d, route, dtype):
    """The registry's 3072 and 5120 held in registers by a group of warps,
    and rows past what registers hold (16,400 and 40,000) on the looped
    route."""
    g = torch.Generator(device=cuda).manual_seed(T + d)
    x = torch.randn(T, d, device=cuda, generator=g).to(dtype)
    w = torch.randn(d, device=cuda, generator=g).to(dtype)
    assert _rms_check(x, w) == route


@pytest.mark.parametrize("T", [4, 300])
@pytest.mark.parametrize("d", [33, 899, 1001])
@pytest.mark.parametrize("dtype", [F32, BF])
def test_cuda_rmsnorm_d_not_a_multiple_of_8(cuda, T, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(T + d)
    x = torch.randn(T, d, device=cuda, generator=g).to(dtype)
    w = torch.randn(d, device=cuda, generator=g).to(dtype)
    assert _rms_check(x, w) == "scalar"


@pytest.mark.parametrize("T,d,route", [(4, 896, "few_rows"),
                                       (300, 896, "rows"),
                                       (300, 16400, "looped")])
def test_cuda_rmsnorm_strided_rows_and_mixed_g_on_every_route(cuda, T, d,
                                                             route):
    """Rows read through their stride (a column window of a wider buffer,
    16-byte aligned) and g in either dtype whatever x is."""
    g = torch.Generator(device=cuda).manual_seed(T + d)
    wide = torch.randn(T, d + 24, device=cuda, generator=g)
    w = torch.randn(d, device=cuda, generator=g)
    for xdt in (F32, BF):
        rows = wide.to(xdt)[:, 8:8 + d]
        assert rows.stride(0) == d + 24 and not rows.is_contiguous()
        for wdt in (F32, BF):
            assert _rms_check(rows, w.to(wdt), 1e-6) == route


def test_cuda_rmsnorm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(4, 32, device=cuda)
    with pytest.raises(ValueError):                      # fp16
        ops.rmsnorm(x.half(), torch.ones(32, device=cuda).half())
    with pytest.raises(ValueError):                      # g size
        ops.rmsnorm(x, torch.ones(31, device=cuda))
    with pytest.raises(ValueError):                      # d stride
        ops.rmsnorm(torch.zeros(4, 64, device=cuda)[:, ::2],
                    torch.ones(32, device=cuda))
    with pytest.raises(ValueError):                      # CPU/CUDA mix
        ops.rmsnorm(x, torch.ones(32))


# ---------------------------------------------------------------------------
# the recurrent serving path
# ---------------------------------------------------------------------------

def _reset_lm_counts():
    ops.reset_flash_counts()
    ops.reset_ssm_scan_counts()
    ops.reset_rmsnorm_counts()


@pytest.mark.parametrize("name", ["hymba-1.5b", "xlstm-125m"])
def test_cuda_reduced_recurrent_generate_matches_cpu(cuda, name):
    """Reduced hymba-1.5b and xlstm-125m, fp32, prompt 48 (three chunks):
    the card and the CPU give the same 8 tokens and logits within 1e-4;
    the prefill launches the scan once for each Mamba or mLSTM layer and
    the norm once for each norm, the decode steps only the norm."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), attention_impl="pallas")
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    prompt = make_prompt(cfg, 2, 48, seed=0)
    _reset_lm_counts()
    toks, logits, t = generate(params, prompt, cfg, 8, cuda)
    want_toks, want_logits, _ = generate(
        tree.map(lambda a: a.cpu(), params), prompt, cfg, 8, "cpu")
    hybrid = cfg.family == "hybrid"
    n_norms = cfg.n_layers * (2 if hybrid else 1) + 1
    n_scans = cfg.n_layers if hybrid else cfg.n_layers // 2
    assert (t["prefill_flash_launches"], t["prefill_ssm_scan_launches"],
            t["prefill_rmsnorm_launches"]) == \
        (cfg.n_layers if hybrid else 0, n_scans, n_norms)
    assert (t["decode_flash_launches"], t["decode_ssm_scan_launches"],
            t["decode_rmsnorm_launches"]) == (0, 0, 7 * n_norms)
    assert torch.equal(toks.cpu(), want_toks)
    torch.testing.assert_close(logits.cpu(), want_logits, atol=1e-4, rtol=0)


def test_cuda_hymba_prefill_state_seeds_the_decode(cuda):
    """hymba-1.5b at full width cut to 2 layers, fp32: the decode logit
    after a prefill through the kernels (whose h_final and conv tail seed
    the decode state) equals a full forward over the prompt and that token
    within 2e-4."""
    cfg = dataclasses.replace(ARCHS["hymba-1.5b"], n_layers=2,
                              dtype="float32", attention_impl="pallas")
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    prompt = torch.from_numpy(make_prompt(cfg, 1, 300, seed=1)).to(cuda)
    with torch.no_grad():
        logits_p, caches = lm.make_prefill_step(cfg, 1, 300, cache_len=301)(
            params, prompt)
        nxt = torch.argmax(logits_p[:, -1], dim=-1)[:, None]
        logits_d, _ = lm.make_decode_step(cfg)(params, nxt, caches, 300)
        h, _, _ = lm.forward(params, torch.cat([prompt, nxt], dim=1), cfg)
        full = lm._head(params, h[:, -1:], cfg)
    torch.testing.assert_close(logits_d, full, atol=2e-4, rtol=0)


def _ctrl_server(device, engine, ckpt=None, faults=False, **server_kw):
    """The quickstart under ``ControlPlane.adaptive()``, telemetry and a
    uniform link (with ``faults``: the chaos plan and a retry policy) under
    a TickTimer."""
    opts = {} if engine == "bsp" else {"chunk_size": 2}
    if faults:
        server_kw.update(faults=_chaos(), retry=T.RetryPolicy(
            timeout_s=1.0, max_retries=2, backoff_s=0.5))
    if ckpt is not None:
        server_kw["checkpoint_manager"] = CheckpointManager(
            ckpt, every_rounds=1, keep=10)
    algo = T.make_algorithm("fedavg", T.value_and_grad(_loss), lr=0.05,
                            local_epochs=2)
    timer = T.TickTimer(1.0)
    execs = [T.SequentialExecutor(k, algo, timer=timer, device=device)
             for k in range(4)]
    return T.ParrotServer(
        params={"w": torch.zeros(32, 10), "b": torch.zeros(10)},
        algorithm=algo, executors=execs,
        data_by_client=make_classification_clients(
            100, dim=32, n_classes=10, partition="natural", seed=0),
        clients_per_round=20, seed=0, device=device, round_engine=engine,
        engine_opts=opts, control=T.ControlPlane.adaptive(), telemetry=True,
        network=T.NetworkModel.uniform(2e5, 1e6, latency_s=0.05),
        **server_kw)


def _trace_state(srv):
    tele = srv.telemetry
    return (tele.tracer.state_dict(),
            tele.registry.snapshot(exclude=("host/",)),
            [(m.extra.get("staleness_lambda"), m.extra.get("deadline_frac"))
             for m in srv.history], srv.control.state_dict())


@pytest.mark.parametrize("engine", ["semi-sync", "async"])
def test_cuda_des_trace_and_registry_equal_cpu(cuda, engine):
    """A DES engine under adaptive control, telemetry and a network, 4
    windows on the card and on the CPU under a TickTimer: the trace, the
    registry without ``host/`` and the controller trajectories equal, params
    within 1e-5, every fold a leaves-form launch."""
    ops.reset_agg_counts()
    on_card = _ctrl_server(cuda, engine)
    on_card.run(4)
    torch.cuda.synchronize()
    assert ops.agg_launches > 0
    assert ops.agg_leaves_launches == ops.agg_launches
    on_cpu = _ctrl_server("cpu", engine)
    on_cpu.run(4)
    assert _trace_state(on_card) == _trace_state(on_cpu)
    assert T.validate_trace(on_card.telemetry.tracer) == []
    for k in on_cpu.params:
        torch.testing.assert_close(on_card.params[k].cpu(), on_cpu.params[k],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("engine", ["bsp", "semi-sync", "async"])
def test_cuda_adaptive_kill_and_auto_resume_reproduces_trace(cuda, tmp_path,
                                                             engine):
    """On the card under adaptive control, telemetry, a network and the
    chaos plan: a run killed mid-round and resumed by a fresh server's
    ``run(N, auto_resume=True)`` reproduces the uninterrupted run's trace,
    registry without ``host/``, controller trajectories and
    ``params_digest``."""
    N = 4
    ref = _ctrl_server(cuda, engine, str(tmp_path / "ref"), faults=True)
    ex0, calls = ref.executors[0], [0]
    real = ex0.run_queue

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    ex0.run_queue = counting
    ref.run(N)
    kill_at = max(2, calls[0] * 5 // 8)
    work = str(tmp_path / "run")
    victim = _ctrl_server(cuda, engine, work, faults=True)
    ex0, calls = victim.executors[0], [0]
    real = ex0.run_queue

    def dying(*a, **kw):
        calls[0] += 1
        if calls[0] >= kill_at:
            raise KeyboardInterrupt
        return real(*a, **kw)

    ex0.run_queue = dying
    with pytest.raises(KeyboardInterrupt):
        victim.run(N)
    assert 1 <= victim.round < N
    resumed = _ctrl_server(cuda, engine, work, faults=True)
    resumed.run(N, auto_resume=True)
    assert params_digest(resumed.params) == params_digest(ref.params)
    got, want = _trace_state(resumed), _trace_state(ref)
    if engine == "async":
        # the async engine's known gap: the first resumed window's
        # comm_bytes omits the broadcast sent before the save
        for st in (got, want):
            st[1]["counters"].pop("total/comm_bytes", None)
    assert got == want


def test_cuda_ganged_semi_sync_first_wave_is_one_dispatch(cuda):
    """Semi-sync under ``gang_waves`` and a one-device placement on the
    card: each window's first wave is one client-step dispatch (no
    first-seen re-run on the card) and one fold launch for each group the
    four lanes fold; makespans equal the serial dispatch's, params within
    1e-5."""
    from repro_torch.core import engine as eng_mod

    def run(gang):
        algo = T.make_algorithm("fedprox", T.value_and_grad(_loss),
                                lr=0.05)
        timer = T.TickTimer(1.0)
        execs = [T.SequentialExecutor(k, algo, timer=timer, client_block=2,
                                      device=cuda) for k in range(4)]
        srv = T.ParrotServer(
            params={"w": torch.zeros(16, 4), "b": torch.zeros(4)},
            algorithm=algo, executors=execs,
            data_by_client=_equal_clients(), clients_per_round=8, seed=0,
            device=cuda, round_engine="semi-sync",
            engine_opts={"chunk_size": 2, "over_select": 1.5},
            placement=T.DevicePlacement(range(4), devices=[cuda]),
            control=T.ControlPlane(gang_waves=gang))
        return srv, T.engine_for(algo, cuda)

    srv, eng = run(True)
    waves = []
    inner_gang, inner_fold = eng_mod.run_queues_ganged, \
        T.LocalAggregator.fold_block
    groups = [0]

    def fold_block(agg, stacked, weights):
        inner_fold(agg, stacked, weights)
        groups[0] += len(agg._acc)

    def gang(*a, **kw):
        d0, f0, g0 = eng.n_dispatches, ops.agg_launches, groups[0]
        reps = inner_gang(*a, **kw)
        torch.cuda.synchronize()
        waves.append((reps is not None, eng.n_dispatches - d0,
                      ops.agg_launches - f0, groups[0] - g0))
        return reps

    eng_mod.run_queues_ganged = gang
    T.LocalAggregator.fold_block = fold_block
    try:
        srv.run(3)
    finally:
        eng_mod.run_queues_ganged = inner_gang
        T.LocalAggregator.fold_block = inner_fold
    assert len(waves) == 3 and all(w[0] for w in waves)
    assert all(w[1] == 1 for w in waves)
    assert all(w[2] == w[3] > 0 for w in waves)
    serial, _ = run(False)
    serial.run(3)
    assert [m.makespan for m in srv.history] == \
        [m.makespan for m in serial.history]
    for k in serial.params:
        torch.testing.assert_close(srv.params[k], serial.params[k],
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# LM training: the backward kernels and gradients through them
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, KV, hd, causal, window): every head dim with KV < H,
# windows, non-causal, ragged Sq and Skv, the training shape; then the
# tensor-core tiling's edges at qwen2's heads: a ragged last key and query
# tile (200; 1000 near the training length), one key tile and half a dQ
# tile (64), a window of two tiles, 13(c)'s folded block of 4 clients
FLASH_BWD_CASES = [(2, 256, 256, 4, 2, hd, True, 0)
                   for hd in (16, 32, 64, 96, 128, 192)] + [
    (1, 77, 77, 2, 1, 96, True, 20), (2, 130, 100, 4, 2, 64, False, 0),
    (1, 100, 130, 4, 1, 128, True, 0), (1, 300, 300, 8, 2, 192, True, 100),
    (4, 1024, 1024, 14, 2, 64, True, 0),
    (1, 200, 200, 14, 2, 64, True, 0), (2, 64, 64, 14, 2, 64, True, 0),
    (1, 300, 300, 14, 2, 64, True, 128),
    (3, 1000, 1000, 14, 2, 64, True, 0), (16, 32, 32, 14, 2, 64, True, 0)]


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [F32, BF])
def test_cuda_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    """The backward kernel against ``flash_attention_bwd_plain`` on the
    same (q, k, v, o, dO, lse), and the forward's log-sum-exp against the
    plain one, at tests/test_kernels.py's tolerances; one launch a call, on
    the route ``bwd_route`` names (bf16 on the tensor cores at hd <= 128,
    fp32 as three TF32 passes at hd <= 64, the rest on the CUDA cores)."""
    from repro_torch.kernels.flash_attention import (
        bwd_route, flash_attention_bwd_plain, flash_attention_fwd_plain)
    B, Sq, Skv, H, KV, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(Sq + hd + KV)
    q = torch.randn(B, Sq, H, hd, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(B, Skv, KV, hd, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    do = torch.randn(B, Sq, H, hd, device=cuda, generator=g).to(dtype)
    o, lse = ops._flash_fwd(q, k, v, causal, window, True)
    _, want_lse = flash_attention_fwd_plain(q, k, v, causal=causal,
                                            window=window)
    launches = ops.flash_bwd_launches
    routes = dict(ops.flash_bwd_route_launches)
    got = ops._flash_bwd(do, q, k, v, o, lse, causal, window)
    want = flash_attention_bwd_plain(do, q, k, v, o, lse, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert ops.flash_bwd_launches == launches + 1
    routes[bwd_route(dtype, hd)] += 1
    assert ops.flash_bwd_route_launches == routes
    assert bwd_route(dtype, hd) == (
        "tensor_cores" if dtype == BF and hd <= 128
        else "tf32x3" if dtype == F32 and hd <= 64 else "cuda_cores")
    atol, rtol = (2e-5, 1e-3) if dtype == F32 else (2e-2, 1e-2)
    torch.testing.assert_close(lse, want_lse, atol=atol, rtol=rtol)
    for a, w, ref in zip(got, want, (q, k, v)):
        assert a.dtype == dtype and a.shape == ref.shape
        torch.testing.assert_close(a.float(), w.float(), atol=atol,
                                   rtol=rtol)


# (rows, d, g rows): the forward routes' shapes, odd d, g tables of a
# vmapped block (negative: one row shared at a stride of 0)
RMS_BWD_CASES = [(100, 64, 1), (7, 33, 1), (4096, 896, 1), (4, 1600, 1),
                 (4, 40000, 1), (1000, 896, 4), (4096, 896, 8),
                 (300, 5120, 3), (512, 896, -4), (4097, 896, 1),
                 (130, 896, 2)]


@pytest.mark.parametrize("case", RMS_BWD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [F32, BF])
def test_cuda_rmsnorm_bwd_kernel_matches_plain(cuda, case, dtype):
    """The norm's forward with a g table and its backward kernel against
    the plain versions; one launch a call.  The last two cases' rows do not
    split into whole 32-row chunks (4097 rows; 65 a g row)."""
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_plain,
                                             rmsnorm_grouped_plain)
    T_, d, V = case
    g = torch.Generator(device=cuda).manual_seed(T_ + d)
    x = torch.randn(T_, d, device=cuda, generator=g).to(dtype)
    dy = torch.randn(T_, d, device=cuda, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(abs(V), d, device=cuda, generator=g)).to(dtype)
    if V < 0:
        w = w[:1].expand(-V, d)
    launches = ops.rmsnorm_bwd_launches
    y = ops._rms_fwd(x, w, 1e-5)
    dx, dg = ops._rms_bwd(dy, x, w, 1e-5)
    torch.cuda.synchronize()
    assert ops.rmsnorm_bwd_launches == launches + 1
    wx, wg = rmsnorm_bwd_plain(dy, x, w, 1e-5)
    atol = 2e-5 if dtype == F32 else 2e-2
    for a, b in ((y, rmsnorm_grouped_plain(x, w, 1e-5)), (dx, wx), (dg, wg)):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=1e-2)


def _scan_bwd_inputs(cuda, case, seed):
    """dy, dh (or None), q, k, v, log_a of a SCAN_BWD_CASES-style case, q
    and k expanded over the heads where shared."""
    B, S, H, N, P, chunk, dt, kdt, shared, with_dh = case
    g = torch.Generator(device=cuda).manual_seed(seed)
    Hq = 1 if shared else H
    q = torch.randn(B, S, Hq, N, device=cuda, generator=g).to(dt)
    k = (0.3 * torch.randn(B, S, Hq, N, device=cuda, generator=g)).to(kdt)
    v = torch.randn(B, S, H, P, device=cuda, generator=g).to(dt)
    la = -torch.nn.functional.softplus(
        torch.randn(B, S, H, device=cuda, generator=g))
    dy = torch.randn(B, S, H, P, device=cuda, generator=g).to(dt)
    dh = (torch.randn(B, H, N, P, device=cuda, generator=g) if with_dh
          else None)
    return dy, dh, q.expand(B, S, H, N), k.expand(B, S, H, N), v, la


# the scan backward of each route at a training shape: hymba's all-bf16
# (the chunk-resident design) and xlstm's fp32 k (the tiled one)
SCAN_BWD_ROUTE_CASES = {
    "bf16": (4, 1024, 8, 16, 400, 256, BF, BF, True, False),
    "mixed": (4, 1024, 4, 384, 385, 256, BF, F32, False, False)}


@pytest.mark.parametrize("dtype", [F32, BF])
def test_cuda_bwd_kernels_repeat_bit_for_bit(cuda, dtype):
    """Each backward kernel, called twice on the same inputs at qwen2's
    training shape (the scan's at the training shape of the route the dtype
    names: bf16 hymba's, fp32 xlstm's fp32 k), gives the same bits: nothing
    is summed in an order that depends on timing (no atomics); and the
    norm's backward takes its one-pass route there."""
    g = torch.Generator(device=cuda).manual_seed(24)
    B, S, H, KV, hd = 4, 1024, 14, 2, 64
    q = torch.randn(B, S, H, hd, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(B, S, KV, hd, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    do = torch.randn(B, S, H, hd, device=cuda, generator=g).to(dtype)
    o, lse = ops._flash_fwd(q, k, v, True, 0, True)
    first = ops._flash_bwd(do, q, k, v, o, lse, True, 0)
    second = ops._flash_bwd(do, q, k, v, o, lse, True, 0)
    x, dy = (torch.randn(S * B, H * hd, device=cuda, generator=g).to(dtype)
             for _ in range(2))
    w = (1 + 0.1 * torch.randn(1, H * hd, device=cuda, generator=g)
         ).to(dtype)
    n1 = ops._rms_bwd(dy, x, w, 1e-5)
    n2 = ops._rms_bwd(dy, x, w, 1e-5)
    case = SCAN_BWD_ROUTE_CASES["bf16" if dtype == BF else "mixed"]
    sargs = _scan_bwd_inputs(cuda, case, 25)
    s1 = ops._ssm_bwd(*sargs, case[5])
    s2 = ops._ssm_bwd(*sargs, case[5])
    torch.cuda.synchronize()
    for a, b in zip(first + n1 + s1, second + n2 + s2):
        assert torch.equal(a, b)
    assert rms_kernel.bwd_route(dy, x, w, torch.empty_like(x)) == "one_pass"


def test_cuda_bwd_route_counters_move_by_one_a_call(cuda):
    """A backward call adds one launch to its kernel's counter and one to
    its route's, and nothing to the others: fp32 flash at qwen2's heads on
    ``tf32x3``, the scan's all-bf16 and mixed routes."""
    g = torch.Generator(device=cuda).manual_seed(26)
    q = torch.randn(2, 128, 14, 64, device=cuda, generator=g)
    k, v = (torch.randn(2, 128, 2, 64, device=cuda, generator=g)
            for _ in range(2))
    o, lse = ops._flash_fwd(q, k, v, True, 0, True)
    ops.reset_flash_counts()
    ops._flash_bwd(torch.randn_like(q), q, k, v, o, lse, True, 0)
    assert ops.flash_bwd_launches == 1
    assert ops.flash_bwd_route_launches == {"tensor_cores": 0, "tf32x3": 1,
                                            "cuda_cores": 0}
    for route, case in SCAN_BWD_ROUTE_CASES.items():
        case = (1, 200) + case[2:]
        args = _scan_bwd_inputs(cuda, case, 27)
        ops.reset_ssm_scan_counts()
        ops._ssm_bwd(*args, case[5])
        torch.cuda.synchronize()
        assert ops.ssm_scan_bwd_launches == 1
        assert ops.ssm_scan_bwd_route_launches == {
            r: int(r == route) for r in ("bf16", "mixed")}


def test_cuda_scan_bwd_resident_design_takes_misaligned_rows(cuda):
    """The scan backward's design follows dtypes and shapes alone: at
    hymba's widths, dy and v whose rows start off 16-byte boundaries (views
    at an odd offset) give the same bits as aligned copies, since the
    wrapper copies them aligned; the launcher itself refuses such rows
    rather than taking another design."""
    from repro_torch.kernels import ssm_scan as ssm
    case = (1, 200, 8, 16, 400, 64, BF, BF, True, False)
    dy, dh, q, k, v, la = _scan_bwd_inputs(cuda, case, 28)
    B, S, H, N, P = case[:5]
    assert ssm.bwd_resident(q.dtype, k.dtype, v.dtype, N, P)
    odd = [torch.empty(B, S, H, P + 1, dtype=BF, device=cuda)[..., 1:]
           for _ in range(2)]
    for t, src in zip(odd, (dy, v)):
        t.copy_(src)
    assert all(t.data_ptr() % 16 for t in odd)
    want = ops._ssm_bwd(dy, dh, q, k, v, la, 64)
    got = ops._ssm_bwd(odd[0], dh, q, k, odd[1], la, 64)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    outs = [torch.empty_like(t) for t in (q, k, v)]
    outs.append(torch.empty_like(la))
    bws = torch.empty(ssm.bwd_workspace_numel(B, H, S, N, P), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        ssm.ssm_scan_bwd_cuda(odd[0], dh, q, k, odd[1], la, *outs, bws)


def _lm_cfg(impl="pallas", **kw):
    return dataclasses.replace(ARCHS["qwen2-0.5b"].reduced(),
                               attention_impl=impl, **kw)


def _lm_batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("inputs", "labels")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_lm_forward_gives_every_param_a_gradient(cuda, dtype):
    """``loss.backward()`` through ``lm.forward`` on the card reaches every
    parameter (the norms' and flash's outputs are no longer detached), and
    the gradients are the CPU's (fp32: 1e-4; bf16: finite and nonzero)."""
    cfg = _lm_cfg(dtype=dtype)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _lm_batch(cfg)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree.map(lambda t: t.detach().to(dev).requires_grad_(), params)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        ops.reset_flash_counts()
        ops.reset_ssm_scan_counts()
        ops.reset_rmsnorm_counts()
        lm.loss_and_aux(p, b, cfg).backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts() == {
                "flash": 2, "flash_bwd": 2, "ssm_scan": 0,
                "ssm_scan_bwd": 0, "rmsnorm": 5,
                "rmsnorm_bwd": 5}
        grads[dev.type] = [t.grad for t in tree.leaves(p)]
    for gc, gp in zip(grads["cuda"], grads["cpu"]):
        assert gc is not None and bool(torch.isfinite(gc).all())
        assert bool(gc.abs().sum() > 0)
        if dtype == "float32":
            torch.testing.assert_close(gc.cpu(), gp, atol=1e-4, rtol=1e-4)


def test_cuda_vmapped_grad_launches_once_a_block_and_equals_cpu(cuda):
    """``torch.func.vmap(grad)`` of the LM loss over a block of 3 clients
    on the card: one launch of each kernel a layer for the whole block, and
    each client's gradient the CPU's."""
    cfg = _lm_cfg()
    params = lm.init_params(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(2)
    batches = {k: rng.integers(0, cfg.vocab_size, (3, 2, 16)).astype(np.int32)
               for k in ("inputs", "labels")}
    fn = T.value_and_grad(lambda p, b: lm.loss_and_aux(p, b, cfg))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree.map(lambda t: t.to(dev), params)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batches.items()}
        ops.reset_flash_counts()
        ops.reset_ssm_scan_counts()
        ops.reset_rmsnorm_counts()
        out[dev.type] = torch.func.vmap(fn, in_dims=(None, 0))(p, b)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts() == {
                "flash": 2, "flash_bwd": 2, "ssm_scan": 0,
                "ssm_scan_bwd": 0, "rmsnorm": 5,
                "rmsnorm_bwd": 5}
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0],
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(tree.leaves(out["cuda"][1]), tree.leaves(out["cpu"][1])):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


# (B, S, H, N, P, chunk, q/v dtype, k dtype, q and k shared by the heads,
# dh given): several 64-step chunks and a ragged one, S % chunk != 0, the
# heads sharing q and k, the mLSTM's fp32 k beside bf16 q and v; then the
# new tilings' edges: hymba's widths over a ragged last chunk (the
# chunk-resident design, a partial last P-panel), with q and k shared by
# the heads as hymba has them and per head, and xlstm's widths (six
# 64-wide N-tiles, a partial P-tile)
SCAN_BWD_CASES = [(1, 256, 3, 16, 32, 64, torch.float32, torch.float32,
                   False, True),
                  (2, 200, 3, 16, 33, 64, torch.float32, torch.float32, True,
                   False),
                  (2, 130, 2, 16, 40, 64, torch.bfloat16, torch.bfloat16,
                   True, True),
                  (1, 100, 2, 70, 71, 16, torch.bfloat16, torch.float32,
                   False, False),
                  (1, 300, 8, 16, 400, 64, torch.bfloat16, torch.bfloat16,
                   True, True),
                  (1, 300, 8, 16, 400, 64, torch.bfloat16, torch.bfloat16,
                   False, True),
                  (2, 130, 4, 384, 385, 64, torch.bfloat16, torch.float32,
                   False, False)]


@pytest.mark.parametrize("case", SCAN_BWD_CASES, ids=str)
def test_cuda_gradient_through_ssm_scan_matches_the_plain_backward(cuda,
                                                                   case):
    """A gradient through ``ops.ssm_scan`` on the card launches the
    backward kernel once; it equals ``ssm_scan_bwd_plain`` (fp32 2e-4 /
    1e-3, bf16 2e-2 / 1e-2: ``tests/test_kernels.py``'s scan bounds; where
    the heads share q and k, dq and dk are sums of H heads' gradients, each
    rounded to its dtype, and take H times the absolute bound, as
    ``tests/test_torch_recurrent_train.py`` holds the plain version to
    JAX's), gives the same bits on a second call, and ``torch.func.grad``
    through the scan takes the same kernels.  A no-grad call is the forward
    launch alone."""
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_plain
    B, S, H, N, P, chunk, dt, kdt, shared, with_dh = case
    g = torch.Generator(device=cuda).manual_seed(3)
    Hq = 1 if shared else H
    q = torch.randn(B, S, Hq, N, device=cuda, generator=g).to(dt)
    k = (0.3 * torch.randn(B, S, Hq, N, device=cuda, generator=g)).to(kdt)
    v = torch.randn(B, S, H, P, device=cuda, generator=g).to(dt)
    la = -torch.nn.functional.softplus(
        torch.randn(B, S, H, device=cuda, generator=g))
    dy = torch.randn(B, S, H, P, device=cuda, generator=g).to(dt)
    dh = (torch.randn(B, H, N, P, device=cuda, generator=g) if with_dh
          else None)

    def loss(q, k, v, la):
        y, h = ops.ssm_scan(q.expand(B, S, H, N), k.expand(B, S, H, N), v,
                            la, chunk=chunk)
        out = (y.float() * dy.float()).sum()
        return out + (h * dh).sum() if with_dh else out

    ops.reset_ssm_scan_counts()
    got = torch.func.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, la)
    again = torch.func.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, la)
    torch.cuda.synchronize()
    assert (ops.ssm_scan_launches, ops.ssm_scan_bwd_launches) == (2, 2)
    want = ssm_scan_bwd_plain(dy, dh, q.expand(B, S, H, N),
                              k.expand(B, S, H, N), v, la, chunk)
    want = (want[0].float().sum(2, keepdim=True).to(dt) if shared
            else want[0],
            want[1].float().sum(2, keepdim=True).to(kdt) if shared
            else want[1], *want[2:])
    for i, (a, b, w, d) in enumerate(zip(got, again, want,
                                         (dt, kdt, dt, torch.float32))):
        assert torch.equal(a, b) and a.dtype == d and a.shape == w.shape
        atol, rtol = (2e-4, 1e-3) if d == torch.float32 else (2e-2, 1e-2)
        torch.testing.assert_close(a.float(), w.float(), atol=atol * H
                                   if shared and i < 2 else atol, rtol=rtol)
    with torch.no_grad():
        ops.ssm_scan(q.expand(B, S, H, N), k.expand(B, S, H, N), v, la,
                     chunk=chunk)
    assert (ops.ssm_scan_launches, ops.ssm_scan_bwd_launches) == (3, 2)


@pytest.mark.parametrize("case", SCAN_BWD_CASES, ids=str)
def test_cuda_scan_vjp_under_vmap_of_cotangents_equals_a_loop(cuda, case):
    """The forward once outside vmap, its vjp vmapped over 3 cotangents
    (what ``torch.func.jacrev`` does): the saved inputs are unbatched, the
    cotangents batched.  One backward launch serves the block, and each
    cotangent's gradient equals its own vjp call within the scan bounds."""
    B, S, H, N, P, chunk, dt, kdt, shared, with_dh = case
    V = 3
    g = torch.Generator(device=cuda).manual_seed(4)
    Hq = 1 if shared else H
    q = torch.randn(B, S, Hq, N, device=cuda, generator=g).to(dt)
    k = (0.3 * torch.randn(B, S, Hq, N, device=cuda, generator=g)).to(kdt)
    v = torch.randn(B, S, H, P, device=cuda, generator=g).to(dt)
    la = -torch.nn.functional.softplus(
        torch.randn(B, S, H, device=cuda, generator=g))
    dys = torch.randn(V, B, S, H, P, device=cuda, generator=g).to(dt)
    dhs = torch.randn(V, B, H, N, P, device=cuda, generator=g) \
        * float(with_dh)

    def scan(q, k, v, la):
        return ops.ssm_scan(q.expand(B, S, H, N), k.expand(B, S, H, N), v,
                            la, chunk=chunk)

    ops.reset_ssm_scan_counts()
    _, vjp = torch.func.vjp(scan, q, k, v, la)
    block = torch.func.vmap(vjp)((dys, dhs))
    torch.cuda.synchronize()
    assert (ops.ssm_scan_launches, ops.ssm_scan_bwd_launches) == (1, 1)
    for i in range(V):
        for got, want in zip(block, vjp((dys[i], dhs[i]))):
            assert got[i].dtype == want.dtype and got[i].shape == want.shape
            atol, rtol = ((2e-4, 1e-3) if want.dtype == torch.float32
                          else (2e-2, 1e-2))
            torch.testing.assert_close(got[i].float(), want.float(),
                                       atol=atol, rtol=rtol)


def test_cuda_serving_launches_no_backward_and_no_lse(cuda, monkeypatch):
    """Serving (``generate`` under ``no_grad``) takes the forward alone:
    its flash launches pass no log-sum-exp buffer, and no backward kernel
    launches."""
    from repro_torch.kernels import flash_attention as fa
    cfg = _lm_cfg()
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    seen = []
    inner = fa.flash_attention_cuda

    def spy(*a, lse=None, **kw):
        seen.append(lse)
        return inner(*a, lse=lse, **kw)

    monkeypatch.setattr(fa, "flash_attention_cuda", spy)
    ops.reset_flash_counts()
    ops.reset_rmsnorm_counts()
    _, _, t = generate(params, make_prompt(cfg, 2, 32, 0), cfg, 4, cuda)
    assert t["prefill_flash_launches"] == cfg.n_layers
    assert seen == [None] * cfg.n_layers
    assert all(t[f"{part}_{k}_launches"] == 0 for part in ("prefill", "decode")
               for k in ("flash_bwd", "ssm_scan_bwd", "rmsnorm_bwd"))


MOE_ARCHS = ["grok-1-314b", "llama4-scout-17b-a16e"]


def _moe_cut(name, impl, dtype="bfloat16"):
    """The arch's reduced widths at the full configs' capacity 1.25."""
    c = ARCHS[name].reduced()
    return dataclasses.replace(c, dtype=dtype, moe=dataclasses.replace(
        c.moe, dispatch_impl=impl, capacity_factor=1.25))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_cuda_moe_routing_breaks_ties_to_the_lower_index(cuda, name):
    """Router column 2 copied over column 0 and 1 over 3: every token's two
    copies tie, and the card's top-k takes the lower index first; the
    card's probabilities routed on the CPU give the same selections and
    slots bit for bit (the bf16 router product itself rounds otherwise on
    the card than on the CPU)."""
    from repro_torch.models import moe
    cfg = _moe_cut(name, "gather")
    k = cfg.moe.top_k
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    p["router"][:, 0] = p["router"][:, 2]
    p["router"][:, 3] = p["router"][:, 1]
    x = torch.randn(2, 48, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(
                        torch.bfloat16)
    st = moe.routing_stats(tree.map(lambda a: a.to(cuda), p), x.to(cuda), cfg)
    idx_cpu = moe.top_k(st["probs"].cpu(), k)[1]
    assert torch.equal(st["topk_idx"].cpu(), idx_cpu)
    C = moe.capacity(cfg.moe, st["topk_idx"].shape[1])
    assert torch.equal(st["kept"].cpu(),
                       moe._slots(idx_cpu, cfg.moe.n_experts)[1] < C)
    # the 96 real tokens (the rest is the group's zero pad)
    real = st["topk_idx"].reshape(-1, k)[:96].cpu()
    assert set(real[:, 0].tolist()) <= {0, 1}
    if k == 2:
        assert torch.equal(real[:, 1], real[:, 0] + 2)
    probs = torch.tensor([.25, .5, .25, .5, .1, .5, 0, .3], device=cuda)
    assert moe.top_k(probs, 2)[1].tolist() == [1, 3]


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_dispatches_agree_and_match_cpu(cuda, name, dtype):
    """On the card the gshard and gather dispatches keep the same
    assignments and agree (fp32 1e-5; bf16 2e-2 + 2e-2 relative), and each
    equals the CPU's within the same bounds."""
    from repro_torch.models import moe
    tol = (dict(atol=1e-5, rtol=0) if dtype == "float32"
           else dict(atol=2e-2, rtol=2e-2))
    cfgs = [_moe_cut(name, impl, dtype) for impl in
            ("gshard_einsum", "gather")]
    p = moe.moe_init(torch.Generator().manual_seed(2), cfgs[0])
    x = torch.randn(2, 48, cfgs[0].d_model,
                    generator=torch.Generator().manual_seed(3)).to(
                        getattr(torch, dtype))
    pc = tree.map(lambda a: a.to(cuda), p)
    outs = []
    for cfg in cfgs:
        y, aux = moe.moe_ffn(pc, x.to(cuda), cfg)
        y_cpu, aux_cpu = moe.moe_ffn(p, x, cfg)
        torch.testing.assert_close(y.cpu().float(), y_cpu.float(), **tol)
        assert abs(float(aux) - float(aux_cpu)) <= 1e-6
        outs.append(y)
    torch.testing.assert_close(outs[0].float(), outs[1].float(), **tol)
    st = moe.routing_stats(pc, x.to(cuda), cfgs[0])
    assert st["dropped"] > 0
    assert st["dropped"] == moe.routing_stats(p, x, cfgs[1])["dropped"]


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_cuda_moe_lm_vmapped_grad_equals_cpu(cuda, name):
    """A reduced MoE model's gradients under the client engine's form
    (``vmap(grad)`` over 2 clients, the gather dispatch) on the card equal
    the CPU's within 1e-4 relative a leaf."""
    cfg = dataclasses.replace(_moe_cut(name, "gather", "float32"),
                              attention_impl="pallas")
    p = lm.init_params(torch.Generator().manual_seed(4), cfg)
    rng = np.random.default_rng(5)
    shape = (2, 2, 32) + ((cfg.d_model,) if cfg.input_kind == "embeddings"
                          else ())
    inputs = (rng.standard_normal(shape).astype(np.float32)
              if cfg.input_kind == "embeddings"
              else rng.integers(0, cfg.vocab_size, shape).astype(np.int64))
    labels = rng.integers(0, cfg.vocab_size, (2, 2, 32)).astype(np.int64)
    grad = torch.func.vmap(torch.func.grad(
        lambda q, b: lm.loss_and_aux(q, b, cfg)), in_dims=(None, 0))
    res = {}
    for dev in ("cpu", cuda):
        b = {"inputs": torch.as_tensor(inputs, device=dev),
             "labels": torch.as_tensor(labels, device=dev)}
        res[str(dev)] = grad(tree.map(lambda a: a.to(dev), p), b)
    for a, b in zip(tree.leaves(res[str(cuda)]), tree.leaves(res["cpu"])):
        assert float((a.cpu() - b).norm()) <= 1e-4 * float(b.norm()) + 1e-7


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_cuda_dryrun_execute_equals_the_abstract_trace(cuda, kind, tmp_path):
    """``launch/dryrun.run_cell(..., execute=True)`` on the card: a reduced
    qwen2 step, flash on the kernel route, counts the FLOPs and argument
    bytes of its meta trace exactly (each launch counted as its plain
    version on meta tensors), launches each kernel, and reports a peak
    allocation."""
    import dataclasses as dc
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    cfg = dc.replace(ARCHS["qwen2-0.5b"].reduced(), attention_impl="pallas",
                     dtype="bfloat16")
    ov = {f.name: getattr(cfg, f.name) for f in dc.fields(cfg)
          if f.name != "name"}
    rec = dryrun.run_cell("qwen2-0.5b", {"train": "train_4k",
                                         "prefill": "prefill_32k"}[kind],
                          mesh=make_host_mesh(1), overrides=ov,
                          shape_overrides={"global_batch": 2,
                                           "seq_len": 64},
                          execute=True, device=str(cuda),
                          out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    ex = rec["execute"]
    assert ex["flops"] == rec["flops_per_device"] > 0
    assert ex["argument_size_in_bytes"] == \
        rec["memory"]["argument_size_in_bytes"]
    L = cfg.n_layers
    want = {"flash": L, "rmsnorm": 2 * L + 1,
            "flash_bwd": L if kind == "train" else 0,
            "rmsnorm_bwd": 2 * L + 1 if kind == "train" else 0}
    assert {k: ex["launches"][k] for k in want} == want
    assert ex["max_memory_allocated"] > ex["argument_size_in_bytes"]

#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on any mismatch):

1. Card identity: ``nvidia-smi`` name and power limit; TF32 off for
   matrix products and cuDNN, so fp32 means fp32 on the card.
2. Every kernel is built from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` each, in parallel).  The fold ``agg_weighted_sum`` and the
   fused top-k ``topk_compress`` are each held against their plain
   PyTorch version on the card, over a grid of shapes and inputs, in
   every call form (the top-k bit for bit, with planted ties, ±0, NaN
   payloads, spans whose keys all share the first radix digit or are all
   equal, and spans at an odd offset); the fold's leaves form also bit
   for bit against its rows form on the rows of the concatenated block,
   over ragged, misaligned, mixed fp32/bf16 and 2,000-leaf segment tables
   and the full-width block.  Then each is timed with CUDA events at the
   main path's shapes (the fold in the form the main path launches, its
   rows form beside it) beside the plain version, the one PyTorch call
   that computes the same function, the memory bound and, for the fold, a
   ``copy_`` of the same bytes.  The profiler counts the device
   operations of one top-k call: at most two kernels (the design launches
   one) and no memset.
3. The quickstart configuration (100 clients, 4 executors, 20 per round)
   under a ``TickTimer``, on the card and on the CPU: 10 FedAvg rounds,
   then 4 SCAFFOLD rounds with a spilling ``ClientStateManager``, an
   executor failure and a checkpoint every 2 rounds, restored by
   ``restore_latest`` into a fresh 7-executor server (6 run: the failed
   one retires) for 2 more rounds; then 10 FedAvg rounds with a top-k
   codec (fraction 0.1).  Makespan histories and comm bytes must be
   identical, params allclose.
4. The full-width client model of ``benchmarks/bench_client_training.py``
   (a 142-leaf MLP, 1,207,440 params) under FedProx: 3 BSP rounds on the
   card, timed, every block folded by the leaves form, and the same
   rounds on the CPU for the params check; then one full-width
   ``fold_block`` under the profiler: exactly one kernel and no other
   device operation, with its device time, host time and bytes.
5. The compressed full-width round: phase 4's model with
   ``compressor="topk"`` (fraction 0.01): 3 rounds on the card, timed, the
   fused top-k held bit for bit to its plain version on one executor's
   real partial and carried residual, its device time and kernels in one
   more round from the profiler, then a card and a CPU run under a
   ``TickTimer``: params after round 0 allclose, later rounds' selection
   differences and partial differences reported beside how far a 1e-7
   perturbation of the CPU run's own params moves them.
6. The LM serving path (``repro_torch.launch.serve.generate``): (a) the
   flash-attention kernel held against its plain version on the JAX
   kernel grid, windows, a non-causal case, KV heads read in place at every
   head dim and the serving shapes, bf16 on the tensor cores and fp32 on the
   CUDA cores; (b) timed at the serving shape, KV heads as the model passes
   them, beside its plain version, ``scaled_dot_product_attention`` (the
   ratio printed) and its bound; (c) full-width
   qwen2-0.5b (494,032,768 params, bf16, random weights from seed 0): a
   batch of 4 prompts of 1024 tokens, prefill and 32 greedy tokens, with
   exactly 24 kernel launches in the prefill (all on the tensor cores) and
   none in the decode, and a profile of each; (d) the same model and prompt through the plain
   ``chunked`` attention: bf16 differences reported, an fp32 copy held to
   identical tokens and logits within 1e-4; (e) the config cut to 2
   layers, fp32: the card (kernel) and the CPU (plain) give identical
   tokens and logits within 1e-4.  Every norm runs the RMSNorm kernel:
   exactly 49 launches in the prefill and 49 a decode step.
7. The recurrent serving path: (a) the chunk-parallel SSD-scan kernels
   held against their plain version on the JAX kernel grid, ragged S, and
   hymba's and xlstm's serving shapes, ragged S and P with heads sharing q
   and k on both routes, and N = 384 on the tensor cores; (b) the RMSNorm
   kernel on the JAX grid, hymba's and qwen2's prefill and decode rows,
   T = 1-8, rows of 3072 to 40,000 and an odd d, every one of its four
   routes run; (c) each timed at its serving shape beside its plain
   version, the library call where there is one (``F.rms_norm``; none for
   the scan) and its bound -- the norm at (4096, 1600), (4096, 896),
   (4, 1600) and (4, 896) bf16, cold and with x in L2 -- the scan's three
   kernels split by the profiler, and flash at hymba's attention shape
   (25 query heads on 5 KV heads) beside
   ``scaled_dot_product_attention``; (d) full-width hymba-1.5b
   (1,640,555,968 params, bf16, seed 0), B=4, prompt 1024, 32 tokens, with
   exactly 32 flash, 32 scan and 65 norm launches in the prefill and
   0 / 0 / 65 a decode step, and a profile of each part; (e) full-width
   xlstm-125m, B=4, prompt 512, 16 tokens, 6 scan and 13 norm launches in
   the prefill and 0 / 13 a decode step; (f) both cut to 2 layers, fp32:
   card and CPU give identical tokens and logits within 1e-4, and hymba's
   decode logit after the prefill equals a full forward within 2e-4.

8. The DES round engines: (a) the quickstart under semi-sync (a 19×-slow
   executor, deadline 0.5 of the predicted makespan, over-selection 1.5,
   chunks of 2) and async (a 16×-slow executor, round-robin placement,
   λ 0.5, chunks of 2), 6 windows each under a ``TickTimer`` on the card
   and on the CPU: windows identical (makespans and every ``extra`` key),
   params allclose, every fold a launch of the leaves form, and tasks
   carried, chunks stolen and stale chunks folded; (b) phase 4's model
   under ``dynamic_env(4, 5)`` with ``benchmarks/bench_round_modes.py``'s
   engine options: 3 timed windows of each engine, every fold a launch of
   the leaves form and one launch for each group the chunks folded; a
   profiled window of each; one async window with top-k 0.01 (one launch
   for each span shipped, the kernel equal to its plain version on a real
   chunk partial); 2 windows of each on card and CPU under a
   ``TickTimer``: windows identical, params after the first within 1e-4.
9. Checkpoints and the streamed population: (a) phase 4's model, data and
   executors under SCAFFOLD with a state manager holding 4 client states
   (the rest spill), a ``TickTimer`` and a checkpoint every round, under
   BSP, semi-sync and async (phase 8b's options; async with top-k 0.01):
   an uninterrupted 4-round reference, the same server killed mid-round
   by a ``run_queue`` that raises ``KeyboardInterrupt``, and a fresh
   server's ``run(4, auto_resume=True)``: ``params_digest``, makespans and
   cohorts equal to the reference's, every fold after the resume a
   leaves-form launch; for async one top-k launch for each span shipped,
   the kernel equal to plain on the first resumed partial (with its
   restored residual), and another wire when the restored codec state is
   dropped; save and restore walls, blob bytes, shard bytes written and
   linked.  (b) ``make_classification_population(1_000_000)`` with the
   quickstart's model, SCAFFOLD, 64 a round, 3 rounds on the card: the
   registry's bytes, the fetch cache against its bound, ``select_clients``
   at M = 1,000 and 1,000,000, the process's RSS; then M = 2,000 lazy
   against its ``materialize()`` eager twin, bit for bit.
10. The network, availability and fault model on phase 4's model under
   ``dynamic_env(4, 5)`` with phase 8b's options: (a) BSP, semi-sync and
   async under ``benchmarks/bench_network.py``'s constrained lognormal
   uplink (median 40 kbps, trace seed 13), each without a codec and with
   top-k 0.01, 3 rounds: per round the virtual makespan, the comm keys,
   the wall and the launches; one top-k launch for each span shipped,
   every fold of the leaves form and one launch a folded group,
   ``comm_wire_bytes`` equal to the bytes shipped, the kernel equal to
   plain on a real shipped partial, and top-k's makespan cut; (b) BSP and
   async under diurnal churn: no offline client selected, drops and
   fast-forwards printed; (c) ``benchmarks/bench_fault_tolerance.py``'s
   plan at rate 0.05 (seed 46, each cell's horizon the span of its
   fault-free run) with a uniform 12 MB/s link and a retry policy, BSP
   and semi-sync at quorum 1.0 and 0.7 and async, 3 rounds under a
   ``TickTimer`` on the card, each engine's first cell's first 2 on the
   CPU: windows and fault counters identical, params within 1e-5;
   crashes, restarts, retries and corrupt payloads each nonzero over the
   phase; the host time of the pricing and fault checks a round; (d)
   phase 9a's kill and auto-resume
   on async with top-k 0.01 under a fault plan: ``params_digest``,
   makespans, cohorts and fault counters equal the uninterrupted run's.
11. Placement, gang dispatch and collective comm on phase 4's model under
   a ``TickTimer`` (each executor one block of 4 a round), 1 warm-up and
   3 timed rounds a variant (1 for (b) and (c), each held to serial's
   params after as many rounds), every number printed beside the card's name
   and power limit: (a) serial against a one-device
   ``DevicePlacement`` with the gang: schedules and makespans equal,
   params within 1e-5, one client-step dispatch a wave in every timed
   round (a round that fell back to serial fails the phase), walls,
   client-steps/s and a device-only profiled round each (launches, busy,
   idle share); (b) nonblocking executors (synchronize calls a round,
   params equal serial's bit for bit); (c) ``parallel_dispatch`` on
   per-executor streams (params within 1e-5); (d) the placement's global
   fold on a round's four real partials: one fold launch a weight group,
   bit for bit the host left fold, timed beside K-1 ``torch.add``s; (e)
   ``CollectiveComm``: ``comm_bytes`` a round == the broadcast once + 2x
   each partial's sums, params equal the ``LocalComm`` run; (f) 10(c)'s
   first cell whose plan restarts an executor, under the placement: the
   restart re-pinned, card == CPU window by window; (g) serial, gang
   and parallel dispatch under the default timer (``perf_counter``), as a
   user runs them: rounds ganged, makespans and per-client record times,
   printed and held to nothing (parallel dispatch 1 timed round).  Cases
   that need several cards print that they were not run on one.
12. The control plane and telemetry on phase 4's model, data and
   executors: (a) ``examples/trace_round.py``'s setting at full width
   (``dynamic_env(4, 3)``, the uniform 2e5 / 1e6 B/s link with 0.05 s
   latency, ``telemetry=True``, ``ControlPlane.adaptive()``) under BSP,
   semi-sync (deadline 0.7, over-selection 1.2, chunks of 4) and async
   (λ 0.5, chunks of 4), 2 rounds each on the card and on the CPU under a
   ``TickTimer``: traces, registries without ``host/`` and the λ and
   deadline trajectories identical, params after each round within 1e-4,
   each exported trace valid, every fold of the leaves form; (b) the same
   engines, 3 rounds each under the default ``perf_counter`` timer on the
   card: per round the per-executor busy/comm/idle fractions, λ and
   deadline_frac, the host ms of ``Telemetry.on_round`` and the spans and
   instants emitted; (c) semi-sync and async with ``gang_waves`` off and
   on, a one-device placement, phase 8b's options, no network, a
   ``TickTimer``, 3 windows each: gang == serial makespans exactly,
   params within 1e-6, every ganged wave one client-step dispatch, per
   window the dispatches and fold launches, and a profiled semi-sync gang
   window.

Every phase prints its seconds (``phase N: X s``).  Phases 3, 4, 5, 6(c),
7(d), 7(e), 8(a), 8(b), 9(a) (the resumed run), 9(b), 10(a)-(d), 11(a)'s
gang rounds, 12(a)'s card runs and 12(c)'s gang runs are the main path:
kernel launch counters are set to 0 just before each and read just after,
and every kernel of the path must have launched.  The second-to-last line is the ``{"kernels": [...]}``
record; the last line is ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 << 20


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of single launches on the device, each after
    an L2 flush (the main path's fold reads deltas that other work has just
    pushed out of the 50 MB L2).  A spin kernel queued before the start
    event keeps the device busy while the host prepares the call, so the
    events bracket device work only, not the wrapper's host time (which
    ``host_ms`` measures on its own)."""

    SPIN_CYCLES = 4_000_000        # ~2 ms at the H100's boost clock

    def __init__(self):
        self.flush_buf = torch.empty(4 * L2_BYTES // 4, dtype=torch.float32,
                                     device="cuda")

    def ms(self, fn, reps=30, warmup=3, flush=True):
        """``flush=False`` leaves the inputs in L2 from the call before, as
        a caller that has just written them finds them."""
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            if flush:
                self.flush_buf.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def host_ms(self, fn, reps=30, inner=8):
        """Host time to issue ``fn``: the median over ``reps`` rounds of the
        mean of ``inner`` calls issued back to back, the device kept busy
        by a spin long enough that no call waits on it.  Back-to-back calls
        keep the host thread running, as a caller's loop does; a single
        call after each synchronise measured the host's wake-up as well
        (spreads of 2x within one run)."""
        times = []
        for _ in range(reps):
            torch.cuda._sleep(4 * self.SPIN_CYCLES)
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / inner)
            torch.cuda.synchronize()
        return float(np.median(times))


def fold_bound_ms(n, C, itemsize):
    """Least time for acc + Σ w_c·D_c: bytes (C rows read, acc read, out
    written, each once) over the memory rate vs 2·C·n fp32 operations over
    the fp32 rate; the larger bounds it."""
    t_bytes = (C * itemsize + 8) * n / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * C * n / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 1: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernel against plain, on the card
# ---------------------------------------------------------------------------

GRID_N = (1000, 65536, 100001, 1207440, 1 << 25)
GRID_C = (1, 4, 5, 8, 16)
# n, C of the fold phase 4 launches: 16 clients over 4 executors gives each
# executor one 4-client block per round, folded at C=4
MAIN_SHAPE = (1207440, 4)


def phase_kernel_grid(ops, plain):
    """Max |kernel - plain| over the grid, every form; raises past
    |kernel - plain| <= 1e-5 (|acc| + Σ|w_c·D_c|) (both sum the clients in
    one order in fp32, so FMA contraction is the only difference)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    n_cases = 0
    for n in GRID_N:
        for C in GRID_C:
            for dt in (torch.float32, torch.bfloat16):
                acc = torch.randn(n, device="cuda", generator=gen)
                D = torch.randn(C, n, device="cuda", generator=gen).to(dt)
                rows = [D[c].clone() for c in range(C)]   # separate buffers
                w = np.linspace(0.5, 2.0, C).tolist()
                ref = plain(acc, D, w)
                scale = acc.abs()
                for c in range(C):
                    scale = scale + abs(w[c]) * D[c].float().abs()
                outs = {
                    "contiguous": ops.agg_weighted_sum(acc, D, w),
                    "pointer-array": ops.agg_fold_batch(acc, rows, w),
                    "contiguous in place": ops.agg_weighted_sum(
                        acc.clone(), D, w, inplace=True),
                    "pointer-array in place": ops.agg_fold_batch(
                        acc.clone(), rows, w, inplace=True),
                }
                torch.cuda.synchronize()
                for form, out in outs.items():
                    diff = (out - ref).abs()
                    bad = diff > 1e-5 * scale
                    if bool(bad.any()):
                        raise AssertionError(
                            f"agg_weighted_sum {form} n={n} C={C} {dt}: "
                            f"{int(bad.sum())} elements past tolerance, max "
                            f"err {float(diff.max())}")
                    max_err = max(max_err, float(diff.max()))
                    n_cases += 1
                del acc, D, rows, ref, scale, outs
    log(f"phase 2: agg_weighted_sum matches its plain version on "
        f"{n_cases} cases (n in {GRID_N}, C in {GRID_C}, fp32/bf16, "
        f"contiguous/pointer-array, fresh/in place); max |err| {max_err:.3g}")
    return max_err


# leaf shapes a client for the leaves form's grid (tests/test_torch_cuda.py's
# cases): odd sizes and 0-d leaves (segment edges in every 16-byte phase,
# the scalar edge beside vectors); bf16 leaves among fp32 ones; a first leaf
# of 3 elements that puts every later offset off the 16-byte phase; 2,000
# leaves (past one launch's parameter space); and, apart, the full-width
# MLP's 142 leaves in their layout order
LEAF_CASES = {
    "odd": ([(3, 3), (), (13,), (1,), (2, 5, 3), (), (1000,), (77, 3)], ()),
    "mixed": ([(7, 5), (9,), (), (33,), (256, 16), (100,)], (1, 2, 4)),
    "misaligned": ([(3,), (4096,), (1,), (517, 9), (64,)], (3,)),
    "many": ([(5,)] * 1000 + [(64,)] * 1000, (7,)),
}
LEAF_C = (1, 4, 5, 16, 64)


def mlp_block(T, C, gen, dtype=torch.float32):
    """A full-width client block on the card: the 142 leaves of the MLP's
    delta with a leading (C, ...) axis (random, from ``gen``), and the
    weighted group's segments in layout order, as ``fold_block`` hands them
    to the leaves form."""
    stacked = {"delta": {}}
    for i, (a, b) in enumerate(zip(DIMS[:-1], DIMS[1:])):
        stacked["delta"][f"w{i}"] = torch.randn(
            C, a, b, device="cuda", generator=gen).to(dtype)
        stacked["delta"][f"b{i}"] = torch.randn(
            C, b, device="cuda", generator=gen).to(dtype)
    layout = T.FlatLayout.build(
        {"delta": T.Op.WEIGHTED_AVG},
        {"delta": {k: v[0] for k, v in stacked["delta"].items()}})
    segs = layout.batch_segments(
        stacked, readable=(torch.float32, torch.bfloat16))["weighted"] \
        if hasattr(layout, "batch_segments") else None   # a tree before it
    return stacked, layout, segs


def case_leaves(shapes, C, bf16, gen):
    """Leaves of the given shapes a client on the card, their segments and
    the (C, n) block they concatenate to (bf16 leaves widened to fp32)."""
    segs, cols, off = [], [], 0
    for i, shape in enumerate(shapes):
        t = torch.randn((C,) + shape, device="cuda", generator=gen)
        if i in bf16:
            t = t.to(torch.bfloat16)
        segs.append((t, off))
        cols.append(t.reshape(C, -1).float())
        off += cols[-1].shape[1]
    return segs, torch.cat(cols, 1)


def phase_leaves_grid(T, ops, plain):
    """The leaves form -- over the leaves, fresh and in place, and over the
    concatenated (C, n) block as one segment -- against the rows form on
    that block's rows, bit for bit, and against the plain version within
    the grid's tolerance (``phase_kernel_grid``), over ``LEAF_CASES`` and
    the full-width block in fp32 and bf16.  Returns the largest
    |kernel - plain|."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err, n_cases, launches = 0.0, 0, ops.agg_leaves_launches
    cases = [(name, C) for name in LEAF_CASES for C in LEAF_C]
    cases += [("full_width " + str(dt).replace("torch.", ""), C)
              for dt in (torch.float32, torch.bfloat16) for C in (1, 4, 16)]
    for name, C in cases:
        if name.startswith("full_width"):
            dt = torch.bfloat16 if name.endswith("bfloat16") else \
                torch.float32
            stacked, layout, segs = mlp_block(T, C, gen, dt)
            block = layout.flatten_batch(stacked)["weighted"]
        else:
            shapes, bf16 = LEAF_CASES[name]
            segs, block = case_leaves(shapes, C, bf16, gen)
        acc = torch.randn(block.shape[1], device="cuda", generator=gen)
        w = np.linspace(0.5, 2.0, C).tolist()
        rows = ops.agg_fold_batch(acc, list(block), w)
        outs = [ops.agg_fold_leaves(acc, segs, w),
                ops.agg_fold_leaves(acc.clone(), segs, w, inplace=True),
                ops.agg_weighted_sum(acc, block, w)]     # one segment
        ref = plain(acc, block, w)
        scale = acc.abs()
        for c in range(C):
            scale = scale + abs(w[c]) * block[c].float().abs()
        torch.cuda.synchronize()
        for out in outs:
            if not torch.equal(out.view(torch.int32), rows.view(torch.int32)):
                raise AssertionError(
                    f"agg_fold_leaves {name} C={C}: differs from the rows "
                    f"form on the rows of the concatenated block in "
                    f"{int((out != rows).sum())} elements")
            diff = (out - ref).abs()
            if bool((diff > 1e-5 * scale).any()):
                raise AssertionError(
                    f"agg_fold_leaves {name} C={C}: max err "
                    f"{float(diff.max())} past tolerance")
            max_err = max(max_err, float(diff.max()))
            n_cases += 1
    log(f"phase 2: agg_fold_leaves equals the rows form bit for bit and "
        f"matches the plain version on {n_cases} cases ({sorted(LEAF_CASES)}"
        f" x C in {LEAF_C}, the full-width block fp32/bf16 at C = 1, 4, 16; "
        f"fresh/in place/one segment) in "
        f"{ops.agg_leaves_launches - launches} launches;"
        f" max |err| {max_err:.3g}")
    return max_err


def copy_bytes_ms(timer, nbytes, flush=True):
    """A ``copy_`` that moves ``nbytes`` (half read, half written), timed
    as the kernels are: the yardstick of a memory-bound kernel."""
    src = torch.empty(nbytes // 8, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    return timer.ms(lambda: dst.copy_(src), flush=flush)


def fold_timing(T, ops, plain, timer, n, C, dt, gen):
    """The fold at (n, C, dt) in the form the main path launches -- the
    leaves form over the full-width block's 142 leaves at n = 1,207,440,
    over one (C, n) leaf otherwise; in a tree without the leaves form, the
    rows form on the (C, n) block, as its ``fold_block`` ran it -- cold,
    warm, its wrapper's host time and its share of the bound; the rows
    form on C separate (n,) rows (the micro-batch flush's pointer array)
    the same way; the plain version; ``torch.addmv`` (fp32); a ``copy_``
    of the same bytes; the bound."""
    acc = torch.randn(n, device="cuda", generator=gen)
    if n == MAIN_SHAPE[0]:
        stacked, layout, segs = mlp_block(T, C, gen, dt)
        D = layout.flatten_batch(stacked)["weighted"]
    else:
        D = torch.randn(C, n, device="cuda", generator=gen).to(dt)
        segs = [(D, 0)]
    staged = [D[c] for c in range(C)]      # contiguous rows: a pointer array
    w = np.linspace(0.5, 2.0, C).tolist()
    work = acc.clone()
    leaves = hasattr(ops, "agg_fold_leaves")

    def fold():
        if leaves:
            return ops.agg_fold_leaves(work, segs, w, inplace=True)
        return ops.agg_weighted_sum(work, D, w, inplace=True)

    def flush():
        return ops.agg_fold_batch(work, staged, w, inplace=True)

    bound, by = fold_bound_ms(n, C, D.element_size())
    nbytes = (C * D.element_size() + 8) * n
    ms = timer.ms(fold)
    row = {"n": n, "C": C, "dtype": str(dt).replace("torch.", ""),
           "form": "leaves" if leaves else "block",
           "segments": len(segs) if leaves else 1,
           "ms": ms, "warm_ms": timer.ms(fold, flush=False),
           "host_ms": timer.host_ms(fold), "bound_share": bound / ms,
           "rows_ms": timer.ms(flush),
           "rows_warm_ms": timer.ms(flush, flush=False),
           "rows_host_ms": timer.host_ms(flush),
           "plain_ms": timer.ms(lambda: plain(acc, D, w)),
           "library_ms": None,
           "copy_ms": copy_bytes_ms(timer, nbytes),
           "copy_warm_ms": copy_bytes_ms(timer, nbytes, flush=False),
           "bound_ms": bound, "bound_by": by, "bytes": nbytes}
    if dt == torch.float32:     # yardstick only: the port never calls it
        wt = torch.tensor(w, dtype=torch.float32, device="cuda")
        row["library_ms"] = timer.ms(lambda: torch.addmv(acc, D.t(), wt))
    return row


def phase_kernel_timing(T, ops, plain):
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    shapes = [(1207440, C, torch.float32) for C in (1, 2, 4, 8, 16)]
    shapes += [(1207440, 8, torch.bfloat16), (1 << 25, 16, torch.float32),
               (1 << 25, 16, torch.bfloat16)]
    for n, C, dt in shapes:
        row = fold_timing(T, ops, plain, timer, n, C, dt, gen)
        rows.append(row)
        lib = row["library_ms"]
        log(f"phase 2 timing: n={n} C={C} {row['dtype']}: leaves form over "
            f"{row['segments']} segments {row['ms']:.4f} ms cold, "
            f"{row['warm_ms']:.4f} warm (wrapper host time "
            f"{row['host_ms']:.4f} ms), at {100 * row['bound_share']:.1f}% "
            f"of the bound and {row['ms'] / row['copy_ms']:.3f}x the copy_; "
            f"rows form {row['rows_ms']:.4f} cold, {row['rows_warm_ms']:.4f} "
            f"warm (host {row['rows_host_ms']:.4f} ms); copy_ of the same "
            f"{row['bytes']} B {row['copy_ms']:.4f} ms cold, "
            f"{row['copy_warm_ms']:.4f} warm; plain {row['plain_ms']:.4f} "
            f"ms, torch.addmv {'n/a' if lib is None else f'{lib:.4f} ms'}, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    ops.reset_agg_counts()         # comparison launches do not count
    return rows


TOPK_GRID_N = (1, 300, 1000, 65536, 100001, 1207440, 1 << 25)
# n, k of the top-k phase 5 launches: the 1,207,440-param delta at fraction
# 0.01, one span per executor partial
TOPK_MAIN = (1207440, 12074)
NAN_PAYLOADS = (0x7FC00001, 0xFFC00002, 0x7F800003, 0x7FA00000)


def topk_bound_ms(n, k):
    """Least time for the fused top-k: bytes (x and res read, new_res
    written, idx and vals written, each once: 12n + 8k) over the memory
    rate vs the n fp32 adds over the fp32 rate; the larger bounds it."""
    t_bytes = (12 * n + 8 * k) / HBM_BYTES_PER_S * 1e3
    t_ops = n / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


TOPK_KINDS = ("normal", "ties", "one_bin", "equal")


def topk_inputs(n, kind, gen):
    """(buffer, residual buffer) of n + 7 values; the span is [3, 3 + n),
    at an odd offset.  ``ties``: values quantised to halves with planted
    -0.0, NaNs of several payloads and infs, the residual quantised too.
    ``one_bin``: |f| in [1.5, 1.5625) with either sign, so every key shares
    the first radix digit (exponent and 3 mantissa bits) and every element
    is a candidate; ``equal``: every |f| is 1.5.  Both with a zero
    residual."""
    if kind in ("one_bin", "equal"):
        mag = torch.full((n + 7,), 1.5, device="cuda")
        if kind == "one_bin":
            mag += torch.rand(n + 7, device="cuda", generator=gen) / 16
        sign = torch.rand(n + 7, device="cuda", generator=gen) < 0.5
        return torch.where(sign, -mag, mag), torch.zeros_like(mag)
    buf = torch.randn(n + 7, device="cuda", generator=gen)
    rbuf = torch.randn(n + 7, device="cuda", generator=gen) \
        * (torch.rand(n + 7, device="cuda", generator=gen) < 0.5)
    if kind == "ties":
        buf = torch.round(buf * 2) / 2
        rbuf = torch.round(rbuf * 2) / 2
        buf[::97] = -0.0
        nan = torch.tensor(NAN_PAYLOADS, dtype=torch.int64).to(torch.int32) \
            .view(torch.float32).to("cuda")
        sites = torch.arange(1, n + 7, 89, device="cuda")
        buf[sites] = nan[torch.arange(sites.numel(), device="cuda") % 4]
        buf[5::1001] = float("inf")
        buf[6::1003] = float("-inf")
    return buf, rbuf


def topk_abs_err(a, b):
    """Largest |a - b| over two float tensors, 0 where their bits agree
    (so equal NaNs and infs count as no error), inf where a NaN or an inf
    meets anything else."""
    same = a.view(torch.int32) == b.view(torch.int32)
    diff = (a.double() - b.double()).abs().nan_to_num(nan=float("inf"))
    return float(torch.where(same, 0.0, diff).max()) if a.numel() else 0.0


def phase_topk_grid(ops, plain):
    """Kernel against plain, bit for bit on idx, vals and new_res, fresh
    and in place, over n in TOPK_GRID_N and k in {1, 7, n // 100, n}.
    Returns the largest |kernel - plain| over vals and new_res."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_cases = 0
    max_err = 0.0
    for n in TOPK_GRID_N:
        for k in sorted({1, 7, n // 100, n}):
            if not 1 <= k <= n:
                continue
            for kind in TOPK_KINDS:
                buf, rbuf = topk_inputs(n, kind, gen)
                x, res = buf[3:3 + n], rbuf[3:3 + n]
                want = plain(x, res, k)
                got = ops.fused_topk(x, res, k)
                inplace = rbuf.clone()
                got_in = ops.fused_topk(x, inplace[3:3 + n], k, inplace=True)
                torch.cuda.synchronize()
                for form, out in (("fresh", got), ("in place", got_in)):
                    max_err = max(max_err, topk_abs_err(want[1], out[1]),
                                  topk_abs_err(want[2], out[2]))
                    for name, a, b in zip(("idx", "vals", "new_res"), want,
                                          out):
                        if not torch.equal(a.view(torch.int32),
                                           b.view(torch.int32)):
                            raise AssertionError(
                                f"topk_compress {form} n={n} k={k} {kind}: "
                                f"{name} differs from the plain version in "
                                f"{int((a.view(torch.int32) != b.view(torch.int32)).sum())}"
                                f" places")
                    n_cases += 1
                if not (torch.equal(inplace[:3], rbuf[:3])
                        and torch.equal(inplace[3 + n:], rbuf[3 + n:])):
                    raise AssertionError("in-place top-k wrote outside its span")
                del buf, rbuf, want, got, got_in, inplace
    log(f"phase 2: topk_compress matches its plain version bit for bit on "
        f"{n_cases} cases (n in {TOPK_GRID_N}, k in {{1, 7, n//100, n}}, "
        f"normal / ties+±0+NaN+inf / one first-digit bin / all equal, odd "
        f"offset, fresh / in place); "
        f"max |kernel - plain| {max_err}")
    return max_err


TOPK_MAX_KERNELS = 2             # CUDA kernels a top-k call, at most


def topk_device_ops(ops, x, res, k):
    """Kernels and memsets one fused top-k call puts on the card, counted
    by the profiler; raises past TOPK_MAX_KERNELS kernels or on any
    memset."""
    per_call = device_ops(lambda: ops.fused_topk(x, res, k))
    memsets = sum(c for key, (c, _) in per_call.items()
                  if key.startswith("Memset"))
    kernels = sum(c for key, (c, _) in per_call.items()
                  if not key.startswith(("Memset", "Memcpy")))
    if kernels > TOPK_MAX_KERNELS or memsets:
        raise AssertionError(f"a top-k call ran {kernels} kernels and "
                             f"{memsets} memsets: {per_call}")
    return kernels, memsets, per_call


def phase_topk_timing(ops, plain, blocks):
    """The fused top-k at the main path's n, k beside its plain version and
    torch.topk (selection only, tie rule unpinned; the port never calls
    it), and the device operations of one call by the profiler."""
    timer = Timer()
    n, k = TOPK_MAIN
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(n, device="cuda", generator=gen) * 1e-3
    res = torch.randn(n, device="cuda", generator=gen) * 1e-4
    f_abs = (x + res).abs()
    k_ms = timer.ms(lambda: ops.fused_topk(x, res, k))
    warm_ms = timer.ms(lambda: ops.fused_topk(x, res, k), flush=False)
    host_ms = timer.host_ms(lambda: ops.fused_topk(x, res, k))
    p_ms = timer.ms(lambda: plain(x, res, k))
    lib_ms = timer.ms(lambda: torch.topk(f_abs, k))
    kernels, memsets, per_call = topk_device_ops(ops, x, res, k)
    bound, by = topk_bound_ms(n, k)
    row = {"n": n, "k": k, "ms": k_ms, "warm_ms": warm_ms,
           "host_ms": host_ms, "plain_ms": p_ms, "library_ms": lib_ms,
           "bound_ms": bound, "bound_by": by, "kernels_per_call": kernels,
           "memsets_per_call": memsets, "grid_blocks": blocks(n),
           "device_ops_per_call": {key: {"count": c, "device_ms": t}
                                   for key, (c, t) in per_call.items()}}
    log(f"phase 2 timing: topk_compress n={n} k={k}: kernel {k_ms:.4f} ms "
        f"cold, {warm_ms:.4f} ms with x and res in L2 (wrapper host time "
        f"{host_ms:.4f} ms), plain {p_ms:.4f} ms, torch.topk (selection "
        f"only, tie rule unpinned) {lib_ms:.4f} ms, bound {bound:.4f} ms "
        f"({by}, {12 * n + 8 * k} B); kernel at {100 * bound / k_ms:.1f}% "
        f"of the bound; a call is {kernels} CUDA kernel(s) and {memsets} "
        f"memsets on the profiler ({row['grid_blocks']} blocks): "
        f"{row['device_ops_per_call']}")
    ops.reset_topk_counts()        # comparison launches do not count
    return row


# ---------------------------------------------------------------------------
# phase 3: quickstart on the card and on the CPU
# ---------------------------------------------------------------------------

def softmax_loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


def quickstart(T, make_clients, device, work):
    """examples/quickstart.py (FedAvg, 10 rounds) then the
    examples/stateful_scaffold.py wiring (SCAFFOLD, 4 rounds, state spilled
    to disk, executor 5 failing in round 2, a checkpoint every 2 rounds;
    then ``restore_latest`` into a fresh 7-executor server with a fresh
    state manager and 2 more rounds), all under TickTimer(1.0)."""
    from repro_torch.checkpoint import CheckpointManager, restore_latest
    grad_fn = T.value_and_grad(softmax_loss)
    data = make_clients(100, dim=32, n_classes=10, partition="natural",
                        seed=0)
    algo = T.make_algorithm("fedavg", grad_fn, lr=0.05, local_epochs=2)
    sm = T.ClientStateManager(os.path.join(work, f"qs_{device}"))
    timer = T.TickTimer(1.0)
    execs = [T.SequentialExecutor(k, algo, state_manager=sm, timer=timer,
                                  device=device) for k in range(4)]
    srv = T.ParrotServer(params={"w": torch.zeros(32, 10),
                                 "b": torch.zeros(10)},
                         algorithm=algo, executors=execs,
                         data_by_client=data, clients_per_round=20, seed=0,
                         device=device)
    fedavg = [srv.run_round() for _ in range(10)]

    data2 = make_clients(1000, dim=16, n_classes=8, mean_samples=30, seed=0)
    algo2 = T.make_algorithm("scaffold", grad_fn, lr=0.1)
    sm2 = T.ClientStateManager(os.path.join(work, f"sc_{device}"),
                               memory_budget_bytes=8 * 2048)
    timer2 = T.TickTimer(1.0)
    execs2 = [T.SequentialExecutor(k, algo2, state_manager=sm2, timer=timer2,
                                   device=device) for k in range(8)]
    execs2[5].fail_at = (2, 2)
    ckpt = os.path.join(work, f"ckpt_{device}")
    srv2 = T.ParrotServer(params={"w": torch.zeros(16, 8),
                                  "b": torch.zeros(8)},
                          algorithm=algo2, executors=execs2,
                          data_by_client=data2, clients_per_round=50, seed=0,
                          device=device,
                          checkpoint_manager=CheckpointManager(
                              ckpt, every_rounds=2))
    scaffold = [srv2.run_round() for _ in range(4)]

    # the crash and restart: the step of round 4 holds executors {0-4, 6,
    # 7}; the new server has 0-6, so 5 retires and 7 cannot rejoin
    algo3 = T.make_algorithm("scaffold", grad_fn, lr=0.1)
    sm3 = T.ClientStateManager(os.path.join(work, f"sc2_{device}"),
                               memory_budget_bytes=8 * 2048)
    timer3 = T.TickTimer(1.0)
    execs3 = [T.SequentialExecutor(k, algo3, state_manager=sm3, timer=timer3,
                                   device=device) for k in range(7)]
    srv3 = T.ParrotServer(params={"w": torch.zeros(16, 8),
                                  "b": torch.zeros(8)},
                          algorithm=algo3, executors=execs3,
                          data_by_client=data2, clients_per_round=50, seed=0,
                          device=device)
    restored = restore_latest(srv3, ckpt)
    if restored != 4 or sorted(srv3.executors) != [0, 1, 2, 3, 4, 6]:
        raise AssertionError(f"restore on {device}: round {restored}, "
                             f"executors {sorted(srv3.executors)}")
    if any(not torch.equal(srv3.params[k], srv2.params[k])
           for k in srv2.params):
        raise AssertionError(f"restore on {device}: params differ from the "
                             f"checkpointed run's")
    resumed = [srv3.run_round() for _ in range(2)]
    return fedavg, scaffold + resumed, srv.params, srv3.params, sm2


def phase_quickstart(T, make_clients, ops, work):
    ops.reset_agg_counts()
    t0 = time.perf_counter()
    fa_g, sc_g, p_g, p2_g, sm_g = quickstart(T, make_clients, "cuda", work)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = ops.agg_launches
    t0 = time.perf_counter()
    fa_c, sc_c, p_c, p2_c, _ = quickstart(T, make_clients, "cpu", work)
    t_cpu = time.perf_counter() - t0
    for name, hg, hc in (("fedavg", fa_g, fa_c), ("scaffold", sc_g, sc_c)):
        mg, mc = [m.makespan for m in hg], [m.makespan for m in hc]
        if mg != mc:
            raise AssertionError(f"{name} makespans differ: {mg} vs {mc}")
        if [m.n_executors for m in hg] != [m.n_executors for m in hc]:
            raise AssertionError(f"{name}: executor counts differ")
    if sc_g[2].failures != 1 or sc_g[2].n_executors != 7:
        raise AssertionError("the injected executor failure did not re-run")
    if [m.n_executors for m in sc_g[4:]] != [6, 6]:
        raise AssertionError("the restored server should run 6 executors")
    if sm_g.stats["spills"] == 0:
        raise AssertionError("SCAFFOLD state never spilled")
    # tolerance: same clients, schedules and fold order; only the order of
    # sums inside the card's matrix products and folds differs
    for name, pg, pc in (("fedavg", p_g, p_c), ("scaffold", p2_g, p2_c)):
        for k in pg:
            torch.testing.assert_close(pg[k].cpu(), pc[k], atol=1e-5,
                                       rtol=1e-5, msg=f"{name} param {k}")
    if launches <= 0:
        raise AssertionError("quickstart on the card launched no fold kernel")
    log(f"phase 3: quickstart makespans {[m.makespan for m in fa_g]} and "
        f"SCAFFOLD makespans {[m.makespan for m in sc_g]} (4 rounds, then 2 "
        f"restored from the round-4 checkpoint onto 6 executors) identical "
        f"on card and CPU; params allclose (1e-5); fold launches "
        f"{launches}; wall {t_gpu:.2f} s card, {t_cpu:.2f} s CPU")
    return launches


def quickstart_topk(T, make_clients, device):
    """examples/quickstart.py (FedAvg, 10 rounds) with a top-k codec at
    fraction 0.1, under TickTimer(1.0)."""
    algo = T.make_algorithm("fedavg", T.value_and_grad(softmax_loss),
                            lr=0.05, local_epochs=2)
    timer = T.TickTimer(1.0)
    execs = [T.SequentialExecutor(k, algo, timer=timer, device=device)
             for k in range(4)]
    srv = T.ParrotServer(params={"w": torch.zeros(32, 10),
                                 "b": torch.zeros(10)},
                         algorithm=algo, executors=execs,
                         data_by_client=make_clients(
                             100, dim=32, n_classes=10, partition="natural",
                             seed=0),
                         clients_per_round=20, seed=0, device=device,
                         compressor=T.make_compressor("topk", 0.1))
    return [srv.run_round() for _ in range(10)], srv.params


def phase_quickstart_topk(T, make_clients, ops):
    ops.reset_agg_counts()
    ops.reset_topk_counts()
    hist_g, p_g = quickstart_topk(T, make_clients, "cuda")
    torch.cuda.synchronize()
    launches = {"agg_weighted_sum": ops.agg_launches,
                "topk_compress": ops.topk_launches}
    hist_c, p_c = quickstart_topk(T, make_clients, "cpu")
    got = [(m.makespan, m.comm_bytes) for m in hist_g]
    if got != [(m.makespan, m.comm_bytes) for m in hist_c]:
        raise AssertionError(f"compressed quickstart makespans/comm bytes "
                             f"differ: {got} vs "
                             f"{[(m.makespan, m.comm_bytes) for m in hist_c]}")
    # same clients, schedules and fold order; a selection could flip only
    # at a near-tie of card and CPU sums (~1e-8 apart), none at this size
    for k in p_g:
        torch.testing.assert_close(p_g[k].cpu(), p_c[k], atol=1e-5,
                                   rtol=1e-5, msg=f"topk quickstart {k}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"compressed quickstart missed a kernel: "
                             f"{launches}")
    log(f"phase 3: top-k quickstart makespans {[m.makespan for m in hist_g]},"
        f" comm bytes {[m.comm_bytes for m in hist_g]} identical on card and "
        f"CPU; params allclose (1e-5); launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 4: full-width client model
# ---------------------------------------------------------------------------

DIMS = [128] * 71 + [400]        # benchmarks/bench_client_training.py:32
BS, NB, M = 4, 8, 64


def mlp_loss(params, batch):
    h = batch["x"]
    last = len(DIMS) - 2
    for i in range(last):
        h = torch.relu(h @ params[f"w{i}"] + params[f"b{i}"])
    logits = h @ params[f"w{last}"] + params[f"b{last}"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.mean(lse - gold)


def mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    p = {}
    for i, (a, b) in enumerate(zip(DIMS[:-1], DIMS[1:])):
        p[f"w{i}"] = torch.from_numpy(
            (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32))
        p[f"b{i}"] = torch.zeros(b)
    return p


def mlp_clients(T):
    out = {}
    for c in range(M):
        rng = np.random.default_rng(c)
        out[c] = T.ClientData(
            batches=[{"x": rng.normal(size=(BS, DIMS[0])).astype(np.float32),
                      "y": rng.integers(0, DIMS[-1], size=(BS,))
                      .astype(np.int32)} for _ in range(NB)],
            n_samples=BS * NB)
    return out


def full_width(T, device, rounds, on_round=None, compressor=None,
               timer=None, prepare=None, speed_model=None, **server_kw):
    algo = T.make_algorithm("fedprox", T.value_and_grad(mlp_loss), 0.05,
                            local_epochs=1)
    execs = [T.SequentialExecutor(k, algo, client_block=8, device=device,
                                  timer=timer,
                                  speed_model=speed_model or T.homogeneous)
             for k in range(4)]
    srv = T.ParrotServer(params=mlp_params(), algorithm=algo,
                         executors=execs, data_by_client=mlp_clients(T),
                         clients_per_round=16, seed=0, device=device,
                         compressor=compressor, **server_kw)
    if prepare is not None:
        prepare(srv)
    for r in range(rounds):
        t0 = time.perf_counter()
        m = srv.run_round()
        if on_round is not None:
            on_round(r, m, time.perf_counter() - t0)
    return srv


# the fold's device kernels by symbol name: the leaves form, the rows form
FOLD_KERNELS = ("agg_leaves_kernel", "agg_rows_kernel")


def profile_round(srv):
    """Device busy share and kernel time by name over one more full-width
    round (a window under a DES engine), from torch.profiler (CUPTI).
    None where the trace holds no device time.  The device activity alone:
    the host ops' trace added ~45 s of processing a round and changed no
    device number."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    fold = [e for e in kernels if any(k in e.key for k in FOLD_KERNELS)]
    fold_us = sum(e.self_device_time_total for e in fold)
    topk = [e for e in kernels if "topk_" in e.key]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernel_launches": int(sum(e.count for e in kernels)),
            "fold_device_s": fold_us / 1e6,
            "fold_kernels": int(sum(e.count for e in fold)),
            "topk_device_s": sum(e.self_device_time_total
                                 for e in topk) / 1e6,
            "topk_kernels": int(sum(e.count for e in topk)),
            "top_kernels": [{"name": e.key[:80], "count": int(e.count),
                             "device_s": e.self_device_time_total / 1e6}
                            for e in top]}


def fold_block_profile(T, ops, timer):
    """One full-width ``fold_block`` (the 142-leaf block at B = 4, fp32, in
    place) as the main path calls it: its device operations by name
    (``device_ops``), their device time, its host time (``Timer.host_ms``)
    and the bytes the fold path must move, from the shapes: the leaves
    form reads the block once beside acc; the parent's flatten path also
    wrote and read the (B, n) buffer of its ``torch.cat``."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    B = MAIN_SHAPE[1]
    stacked, layout, _ = mlp_block(T, B, gen)
    agg = T.LocalAggregator({"delta": T.Op.WEIGHTED_AVG}, layout=layout)
    ws = [32.0, 32.0, 16.0, 8.0]
    agg.fold_block(stacked, ws)
    for _ in range(3):
        per_call = {k: v for k, v in
                    device_ops(lambda: agg.fold_block(stacked, ws)).items()
                    if not k.startswith("ProfilerStep")}   # the step's span
        # a profile that lost kernel records (fewer than one a call; seen
        # once after the round profile) is taken again
        if sum(c for c, _ in per_call.values()) >= 1.0:
            break
    n = layout.group_sizes["weighted"]
    fold_bytes = (B * 4 + 8) * n
    leaves = hasattr(ops, "agg_fold_leaves")
    return {"path": "leaves" if leaves else "flatten_batch + rows",
            "device_ops_per_call": {k: {"count": c, "device_ms": t}
                                    for k, (c, t) in per_call.items()},
            "device_ms": sum(t for _, t in per_call.values()),
            "host_ms": timer.host_ms(lambda: agg.fold_block(stacked, ws)),
            "bytes": fold_bytes if leaves else fold_bytes + 2 * B * 4 * n,
            "bytes_leaves": fold_bytes,
            "bytes_flatten": fold_bytes + 2 * B * 4 * n}


def phase_full_width(T, ops):
    n_params = sum(int(np.prod(v.shape)) for v in mlp_params().values())
    rows = []

    def on_round(r, m, wall):
        torch.cuda.synchronize()
        rows.append({"round": r, "makespan_s": m.makespan, "wall_s": wall,
                     "client_steps_per_s": m.n_clients * NB / wall,
                     "fold_launches": ops.agg_launches,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()})
        log(f"phase 4 round {r}: makespan {m.makespan:.4f} s, wall "
            f"{wall:.3f} s, {rows[-1]['client_steps_per_s']:.1f} "
            f"client-steps/s, fold launches {ops.agg_launches} (cumulative),"
            f" max_memory_allocated {rows[-1]['max_memory_allocated']} B")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_agg_counts()
    srv = full_width(T, "cuda", 3, on_round)
    torch.cuda.synchronize()
    launches = ops.agg_launches
    leaves_launches = ops.agg_leaves_launches
    if launches <= 0 or leaves_launches <= 0 or ops.agg_leaf_copies:
        raise AssertionError(
            f"full-width rounds: {launches} fold launches, "
            f"{leaves_launches} of the leaves form, {ops.agg_leaf_copies} "
            f"leaves copied (expected launches of the leaves form and no "
            f"copy)")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in mlp_clients(T)[0].batches[0].items()}
    with torch.no_grad():
        loss = float(mlp_loss(srv.params, batch))
    if not np.isfinite(loss):
        raise AssertionError(f"full-width loss is not finite: {loss}")
    shapes = {k: tuple(v.shape) for k, v in srv.params.items()}
    if shapes != {k: tuple(v.shape) for k, v in mlp_params().items()}:
        raise AssertionError("full-width params changed shape")
    params3 = {k: v.cpu() for k, v in srv.params.items()}
    prof = profile_round(srv)      # one more round, after the count
    if prof is None:
        log("phase 4 profile: the trace holds no device time (not measured)")
    else:
        log(f"phase 4 profile (one more round): wall {prof['wall_s']:.3f} s,"
            f" device busy {prof['device_busy_s']:.4f} s, idle share "
            f"{prof['device_idle_share']:.3f}, {prof['kernel_launches']} "
            f"kernel launches, fold {prof['fold_device_s'] * 1e3:.4f} ms")
        for k in prof["top_kernels"]:
            log(f"    {k['device_s'] * 1e3:9.3f} ms  x{k['count']:<6d} "
                f"{k['name']}")
    block = fold_block_profile(T, ops, Timer())
    dev_ops = block["device_ops_per_call"]
    if len(dev_ops) != 1 or "agg_leaves_kernel" not in next(iter(dev_ops)) \
            or next(iter(dev_ops.values()))["count"] != 1.0:
        raise AssertionError(f"one full-width fold_block should be one "
                             f"leaves-form kernel and no other device "
                             f"operation, got {dev_ops}")
    log(f"phase 4 fold_block (B = 4, one group): one kernel, "
        f"{block['device_ms']:.4f} ms of device time, host time "
        f"{block['host_ms']:.4f} ms, {block['bytes']} B moved (the flatten "
        f"path moved {block['bytes_flatten']} B)")
    ops.reset_agg_counts()         # the profile's launches do not count
    # the same rounds on the CPU: identical cohorts; schedules may differ
    # (they follow measured times), which reorders fp32 sums only
    ref = full_width(T, "cpu", 3)
    err = max(float((params3[k] - ref.params[k]).abs().max())
              for k in ref.params)
    for k in ref.params:
        torch.testing.assert_close(params3[k], ref.params[k],
                                   atol=1e-4, rtol=1e-4,
                                   msg=f"full-width param {k}")
    log(f"phase 4: {n_params} params in {len(shapes)} leaves; loss after 3 "
        f"rounds {loss:.6f}; max |card - CPU| param difference {err:.3g}; "
        f"fold launches {launches}, {leaves_launches} of them the leaves "
        f"form")
    return launches, leaves_launches, rows, prof, block


# ---------------------------------------------------------------------------
# phase 5: the compressed full-width round
# ---------------------------------------------------------------------------

def capture_wires(srv, dense_round=None, all_dense=False, first=False):
    """Wrap the server's codec: keep every shipped top-k selection by
    (round, executor) and count the compressed spans shipped; with
    ``all_dense`` every dense partial buffer too; in ``dense_round``
    (with ``first``: at the first partial shipped, whoever sends it) the
    sender's dense partial buffer with the residual it carries from before
    (zeros where it has none), the wire it shipped and the residual
    after."""
    comp, inner = srv.compressor, srv.compressor.compress_partial
    seen = {"idx": {}, "dense": {}, "srv": srv, "spans": 0}

    def compress_partial(partial, key=None):
        rnd = srv.round
        if "weighted" not in partial["sums"]["buffers"]:
            return inner(partial, key=key)          # an executor with no work
        keep = ("wire" not in seen) if first else \
            (key == "exec0" and rnd == dense_round)
        dense = partial["sums"]["buffers"]["weighted"]
        if keep:
            # a restored residual is host numpy until its first use
            res = comp._residual.get(f"{key}/weighted")
            seen["res_carried"] = res is not None
            seen["res_before"] = (torch.zeros_like(dense) if res is None
                                  else torch.as_tensor(
                                      res, dtype=torch.float32,
                                      device=dense.device).clone())
        if keep or all_dense:
            seen["dense"][(rnd, key)] = dense.clone()
        out = inner(partial, key=key)
        seen["spans"] += sum(
            kind == "comp" for buf in out["sums"]["buffers"].values()
            if isinstance(buf, dict) for kind, _ in buf["segments"])
        [(idx, vals)] = [(x.data["idx"], x.data["vals"]) for kind, x in
                         out["sums"]["buffers"]["weighted"]["segments"]
                         if kind == "comp"]
        seen["idx"][(rnd, key)] = idx
        if keep:
            seen["key"] = (rnd, key)
            seen["wire"] = (idx.clone(), vals.clone())
            seen["res_after"] = comp._residual[f"{key}/weighted"].clone()
        return out

    comp.compress_partial = compress_partial
    return seen


def phase_full_width_topk(T, ops, plain):
    n, k = TOPK_MAIN
    rows = []
    per_round = []

    def on_round(r, m, wall):
        torch.cuda.synchronize()
        per_round.append(ops.topk_launches)
        rows.append({"round": r, "makespan_s": m.makespan, "wall_s": wall,
                     "client_steps_per_s": m.n_clients * NB / wall,
                     "comm_bytes": m.comm_bytes,
                     "topk_launches": ops.topk_launches,
                     "fold_launches": ops.agg_launches,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()})
        log(f"phase 5 round {r}: makespan {m.makespan:.4f} s, wall "
            f"{wall:.3f} s, {rows[-1]['client_steps_per_s']:.1f} "
            f"client-steps/s, comm_bytes {m.comm_bytes}, top-k launches "
            f"{ops.topk_launches} and fold launches {ops.agg_launches} "
            f"(cumulative), max_memory_allocated "
            f"{rows[-1]['max_memory_allocated']} B")

    seen = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_agg_counts()
    ops.reset_topk_counts()
    srv = full_width(T, "cuda", 3, on_round,
                     compressor=T.make_compressor("topk", 0.01),
                     prepare=lambda s: seen.update(
                         wires=capture_wires(s, dense_round=2)))
    torch.cuda.synchronize()
    launches = {"agg_weighted_sum": ops.agg_launches,
                "topk_compress": ops.topk_launches}
    log(f"phase 5: raw launch counts over 3 rounds: {launches}")
    steps = [b - a for a, b in zip([0] + per_round[:-1], per_round)]
    if steps != [4, 4, 4] or launches["agg_weighted_sum"] <= 0:
        raise AssertionError(f"expected 4 top-k launches a round (one span "
                             f"per executor) and folds, got {steps}, "
                             f"{launches}")

    # the kernel against its plain version on executor 0's real partial of
    # round 2, with the residual carried from round 1
    w = seen["wires"]
    x, r0 = w["dense"][(2, "exec0")], w["res_before"]
    if not w["res_carried"] or x.numel() != n:
        raise AssertionError("no carried residual / unexpected partial size")
    want = plain(x, r0, k)
    got = ops.fused_topk(x, r0.clone(), k)
    torch.cuda.synchronize()
    for name, a, b in zip(("idx", "vals", "new_res"), want, got):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"round buffer: kernel {name} != plain")
    if not (torch.equal(w["wire"][0], want[0])
            and torch.equal(w["wire"][1].view(torch.int32),
                            want[1].view(torch.int32))
            and torch.equal(w["res_after"].view(torch.int32),
                            want[2].view(torch.int32))):
        raise AssertionError("the shipped wire / residual differ from plain")
    ops.reset_topk_counts()        # comparison launches do not count
    log(f"phase 5: on executor 0's round-2 partial (n={n}, k={k}, carried "
        f"residual |r|max {float(r0.abs().max()):.3g}) kernel == plain == "
        f"shipped wire, bit for bit")

    prof = profile_round(srv)      # one more round, after the count
    if prof is None:
        log("phase 5 profile: the trace holds no device time (not measured)")
    else:
        log(f"phase 5 profile (one more round): wall {prof['wall_s']:.3f} s,"
            f" device busy {prof['device_busy_s']:.4f} s, idle share "
            f"{prof['device_idle_share']:.3f}, {prof['kernel_launches']} "
            f"kernel launches, top-k {prof['topk_device_s'] * 1e3:.4f} ms "
            f"in {prof['topk_kernels']} kernels, fold "
            f"{prof['fold_device_s'] * 1e3:.4f} ms")

    # card against CPU under a TickTimer: identical schedules, so in round 0
    # the codec gets the same partials up to fp32 sum order and the params
    # after it must agree.  Later rounds are reported, not held: after a
    # sparse update 99% of this deep ReLU model's biases are still 0, and
    # round-1 training then amplifies sum-order differences (measured below
    # by perturbing the CPU run itself)
    runs = {}
    for dev in ("cuda", "cpu"):
        got = {}

        def after_round(r, m, wall, got=got):
            if r == 0:
                got["params0"] = {key: v.detach().cpu().clone()
                                  for key, v in got["srv"].params.items()}

        full_width(T, dev, 3, after_round,
                   compressor=T.make_compressor("topk", 0.01),
                   timer=T.TickTimer(1.0),
                   prepare=lambda s, got=got: got.update(
                       capture_wires(s, all_dense=True)))
        runs[dev] = got
    g, c = runs["cuda"], runs["cpu"]
    hg, hc = g["srv"].history, c["srv"].history
    if [(m.makespan, m.comm_bytes) for m in hg] != \
            [(m.makespan, m.comm_bytes) for m in hc]:
        raise AssertionError("TickTimer card/CPU makespans or bytes differ")
    for name, pc in c["params0"].items():
        torch.testing.assert_close(g["params0"][name], pc, atol=1e-5,
                                   rtol=1e-5,
                                   msg=f"compressed full width, round 0: {name}")
    err0 = max(float((g["params0"][q] - pc).abs().max())
               for q, pc in c["params0"].items())
    per_round = []
    for r in range(3):
        keys = [key for key in c["idx"] if key[0] == r]
        per_round.append({
            "round": r,
            "selections_differing": sum(
                len(set(g["idx"][key].cpu().tolist())
                    - set(c["idx"][key].tolist())) for key in keys),
            "max_partial_diff": max(
                float((g["dense"][key].cpu() - c["dense"][key]).abs().max())
                for key in keys)})
    err3 = max(float((g["srv"].params[q].cpu() - pc).abs().max())
               for q, pc in c["srv"].params.items())
    # how far the model itself amplifies a tiny difference: the CPU run
    # again, its params after round 0 scaled by (1 ± 1e-7) elementwise
    pert = {}

    def perturb(r, m, wall):
        if r == 0:
            gen = torch.Generator().manual_seed(1)
            for v in pert["srv"].params.values():
                v.mul_(1 + 1e-7 * torch.sign(torch.randn(v.shape,
                                                         generator=gen)))

    full_width(T, "cpu", 2, perturb,
               compressor=T.make_compressor("topk", 0.01),
               timer=T.TickTimer(1.0),
               prepare=lambda s: pert.update(capture_wires(s,
                                                           all_dense=True)))
    sens = max(float((pert["dense"][key] - c["dense"][key]).abs().max())
               for key in c["dense"] if key[0] == 1)
    for q, v in g["srv"].params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"compressed full width: {q} not finite")
    log(f"phase 5: card vs CPU under TickTimer: params after round 0 allclose "
        f"(1e-5, max |diff| {err0:.3g}); per round, shipped selections that "
        f"differ (of {4 * k}) and the largest |card - CPU| difference of an "
        f"executor's dense partial: "
        + ", ".join(f"r{d['round']}: {d['selections_differing']} / "
                    f"{d['max_partial_diff']:.3g}" for d in per_round)
        + f"; max |card - CPU| param difference after 3 rounds {err3:.3g};"
        f" on the CPU alone, a 1e-7 relative perturbation of the round-0 "
        f"params moves a round-1 partial by up to {sens:.3g}")
    return launches, rows, prof, {"params_round0_max_err": err0,
                                  "rounds": per_round,
                                  "params_round3_max_err": err3,
                                  "cpu_perturbation_round1_diff": sens}


# ---------------------------------------------------------------------------
# phase 6: the LM serving path (qwen2-0.5b prefill and decode)
# ---------------------------------------------------------------------------

BF16_FLOP_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense

# (B, S, H, KV, hd, causal, window, dtype): the JAX kernel grid of
# tests/test_kernels.py:20-50 in fp32 and bf16, causal, KV = H; its windows;
# one non-causal case; KV heads read in place (KV < H) at every head dim and
# a ragged S; the serving shapes with their KV heads in fp32 and bf16
FLASH_GRID = ([(B, S, H, H, hd, True, 0, dt)
               for B, S, H, hd in ((2, 256, 4, 64), (1, 128, 2, 128),
                                   (2, 256, 3, 96), (1, 512, 1, 192))
               for dt in (torch.float32, torch.bfloat16)]
              + [(1, 256, 2, 2, 64, True, w, torch.float32)
                 for w in (32, 64, 128)]
              + [(2, 256, 4, 4, 64, False, 0, torch.float32)]
              + [(2, 256, 4, 2, hd, True, 0, torch.bfloat16)
                 for hd in (16, 32, 64, 96, 128, 192)]
              + [(2, 200, 6, 3, 64, True, 48, dt)
                 for dt in (torch.float32, torch.bfloat16)]
              + [(4, 1024, 14, 2, 64, True, 0, dt)
                 for dt in (torch.float32, torch.bfloat16)]
              + [(4, 1024, 25, 5, 64, True, 1024, torch.bfloat16)])
# qwen2-0.5b serving: 4 prompts of 1024 tokens, 32 generated; each prefill
# layer hands the kernel q of (4, 1024, 14, 64) and k, v of (4, 1024, 2, 64)
# in bf16
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 32
SERVE_SHAPE = (SERVE_BATCH, SERVE_PROMPT, 14, 2, 64)       # B, S, H, KV, hd
# hymba-1.5b's attention: 25 query heads on 5 KV heads, window 1024
HYMBA_FLASH = (SERVE_BATCH, SERVE_PROMPT, 25, 5, 64)


def flash_tol(dtype):
    """tests/test_kernels.py's (atol, rtol): the kernel sums in another
    order than the plain version; bf16 output is rounded once more."""
    return (2e-5, 1e-3) if dtype == torch.float32 else (2e-2, 1e-2)


def flash_bound_ms(B, S, H, KV, hd, itemsize):
    """Least time for causal attention: q read and o written at the H query
    heads, k and v read at the KV heads they are stored at (the kernel reads
    them in place), each once — (2·H + 2·KV)·B·S·hd·itemsize bytes — over the
    memory rate, vs 4·hd operations for each of the B·H·S(S+1)/2 unmasked
    (q, k) pairs (q·k and p·v) over the bf16 tensor-core rate; the larger
    bounds it."""
    nbytes = (2 * H + 2 * KV) * B * S * hd * itemsize
    flops = 4 * hd * B * H * S * (S + 1) // 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def flash_inputs(B, S, H, KV, hd, dt, gen):
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dt)
    k, v = (torch.randn(B, S, KV, hd, device="cuda", generator=gen).to(dt)
            for _ in range(2))
    return q, k, v


def phase_flash_grid(ops, plain):
    """Kernel against plain on the card over FLASH_GRID; raises past
    |kernel - plain| <= atol + rtol·|plain|, or if a bf16 case did not run
    on the tensor cores (an fp32 one on the CUDA cores).  Returns the
    largest |kernel - plain| by dtype."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for B, S, H, KV, hd, causal, window, dt in FLASH_GRID:
        q, k, v = flash_inputs(B, S, H, KV, hd, dt, gen)
        routes = dict(ops.flash_route_launches)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        routes["tensor_cores" if dt == torch.bfloat16 else "cuda_cores"] += 1
        atol, rtol = flash_tol(dt)
        diff = (got.float() - want.float()).abs()
        bad = diff > atol + rtol * want.float().abs()
        case = (f"(B,S,H,KV,hd)=({B},{S},{H},{KV},{hd}) {dt} causal={causal} "
                f"window={window}")
        if got.dtype != dt or not bool(torch.isfinite(got).all()) \
                or bool(bad.any()) or ops.flash_route_launches != routes:
            raise AssertionError(f"flash_attention {case}: "
                                 f"{int(bad.sum())} elements past tolerance,"
                                 f" max err {float(diff.max())}, routes "
                                 f"{ops.flash_route_launches}")
        key = str(dt).replace("torch.", "")
        max_err[key] = max(max_err[key], float(diff.max()))
        del q, k, v, got, want, diff, bad
    ops.reset_flash_counts()       # comparison launches do not count
    log(f"phase 6: flash_attention matches its plain version on "
        f"{len(FLASH_GRID)} cases (the JAX grid in fp32/bf16, windows 32/64/"
        f"128, non-causal, KV heads in place at hd 16-192 and a ragged S, the "
        f"serving shapes {SERVE_SHAPE} fp32/bf16 and {HYMBA_FLASH} bf16), bf16"
        f" on the tensor cores and fp32 on the CUDA cores; max |err| fp32 "
        f"{max_err['float32']:.3g}, bf16 {max_err['bfloat16']:.3g}")
    return max_err


def time_flash(label, ops, plain, timer, shape, window, gen):
    """The bf16 kernel at a serving shape, KV heads as the model passes
    them, beside its plain version and scaled_dot_product_attention (the
    yardstick; the port never calls it): one call on the same inputs
    (``enable_gqa``), and on KV heads repeated beforehand."""
    import torch.nn.functional as F
    B, S, H, KV, hd = shape
    q, k, v = flash_inputs(B, S, H, KV, hd, torch.bfloat16, gen)
    k_ms = timer.ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                window=window))
    host_ms = timer.host_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                        window=window))
    p_ms = timer.ms(lambda: plain(q, k, v, causal=True, window=window),
                    reps=10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    kr, vr = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
    lib_rep_ms = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kr, vr, is_causal=True))
    # the window covers the whole prompt at both shapes, so causal SDPA is
    # the same function
    lib_diff = float((F.scaled_dot_product_attention(
        qt, kr, vr, is_causal=True).transpose(1, 2).float()
        - ops.flash_attention(q, k, v, causal=True, window=window).float())
        .abs().max())
    bound, by, nbytes, flops = flash_bound_ms(B, S, H, KV, hd, 2)
    ops.reset_flash_counts()       # comparison launches do not count
    lib_best = min(lib_ms, lib_rep_ms)
    row = {"shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                     "dtype": "bfloat16", "causal": True, "window": window},
           "ms": k_ms, "host_ms": host_ms, "plain_ms": p_ms,
           "library_ms": lib_ms, "library_repeated_kv_ms": lib_rep_ms,
           "kernel_over_library": k_ms / lib_best,
           "bound_ms": bound, "bound_by": by, "bound_share": bound / k_ms,
           "bytes": nbytes, "flops": flops,
           "library_max_abs_diff": lib_diff}
    log(f"{label} timing: flash_attention {shape} bf16 causal window {window}"
        f": kernel {k_ms:.4f} ms (wrapper host time {host_ms:.4f} ms), plain "
        f"{p_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms "
        f"(enable_gqa) / {lib_rep_ms:.4f} ms (KV repeated first; |diff| "
        f"{lib_diff:.3g}); kernel_ms / library_ms {k_ms / lib_best:.2f}; "
        f"bound {bound:.4f} ms ({by}: {nbytes} B, {flops} FLOP), kernel at "
        f"{100 * bound / k_ms:.1f}% of the bound")
    del q, k, v, qt, kt, vt, kr, vr
    return row


def phase_flash_timing(ops, plain):
    """(b) the kernel at qwen2's serving shape."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    return time_flash("phase 6", ops, plain, Timer(), SERVE_SHAPE, 0, gen)


# the device kernels of each LM kernel wrapper, by symbol name
PORT_KERNEL_SYMBOLS = {
    "flash_attention": ("flash_tc_kernel", "flash_fp32_kernel"),
    "ssm_scan": ("ssm_chunk_state_", "ssm_state_pass_", "ssm_chunk_out_"),
    "rmsnorm": ("rms_reg_kernel", "rms_loop_kernel", "rms_scalar_kernel")}


SPLIT_REPS = 20


def device_ops(fn):
    """Every device operation (kernels, memsets, copies) of a call of
    ``fn``, by name: (launches a call, mean device ms a call), from
    torch.profiler over SPLIT_REPS calls.  The profile's schedule runs the
    calls twice: a warm-up step with the profiler on, whose records are
    dropped (a session's first window can come back without its kernels
    while CUPTI starts up), then the step that is read."""
    from torch.profiler import ProfilerActivity, profile, schedule
    got = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.append(p.key_averages())) \
            as prof:
        for _ in range(2):
            for _ in range(SPLIT_REPS):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return {e.key.split("(")[0].strip() or e.key:
            (e.count / SPLIT_REPS, e.self_device_time_total / SPLIT_REPS / 1e3)
            for e in (got[0] if got else [])
            if e.device_type == torch.autograd.DeviceType.CUDA}


def kernel_split(fn, symbols):
    """Mean device time a call (ms) and launches a call of each named
    kernel (``device_ops``).  Raises if the profile holds none of them."""
    hits = {key: v for key, v in device_ops(fn).items()
            if any(s in key for s in symbols)}
    if not hits:
        raise AssertionError(f"the profile holds none of {symbols}")
    return ({key: t for key, (_, t) in hits.items()},
            {key: c for key, (c, _) in hits.items()})


def profile_generate(generate, params, prompt, cfg, gen):
    """Device busy time and kernel time by name over one ``generate``,
    from torch.profiler (CUPTI); None where the trace holds no device
    time.  The device activity alone, as ``profile_round``: every number
    read here is a device number, and tracing the host ops too (a
    hymba decode launches 138,043 kernels) only added processing time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(params, prompt, cfg, gen, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    by_kernel = {name: sum(e.self_device_time_total for e in kernels
                           if any(s in e.key for s in symbols)) / 1e6
                 for name, symbols in PORT_KERNEL_SYMBOLS.items()}
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernel_launches": int(sum(e.count for e in kernels)),
            "port_kernel_device_s": by_kernel,
            "top_kernels": [{"name": e.key[:80], "count": int(e.count),
                             "device_s": e.self_device_time_total / 1e6}
                            for e in top]}


def phase_serve(ops, lm, tree, generate, make_prompt, qwen):
    """(c) full-width qwen2-0.5b serving through the kernels; (d) the same
    model and prompt through the plain chunked path, in bf16 and in an
    fp32 copy; (e) the config cut to 2 layers, fp32, card against CPU."""
    cfg = dataclasses.replace(qwen, attention_impl="pallas")
    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    L, n_norms = cfg.n_layers, 2 * cfg.n_layers + 1
    params, prompt, toks, logits, t, serve = serve_main_run(
        "phase 6", ops, lm, tree, generate, make_prompt, cfg,
        cfg.n_params(), B, P, G,
        {"prefill": (L, 0, n_norms), "decode": (0, 0, n_norms * (G - 1))})
    profile_serve("phase 6", generate, params, prompt, cfg, G, t, serve)

    # (d) the kernel path against the plain chunked path on the card
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    toks_c, logits_c, _ = generate(params, prompt, chunked, G, "cuda")
    bf16_diff = float((logits.float() - logits_c.float()).abs().max())
    bf16_agree = int((toks == toks_c).sum())
    del params, logits, logits_c
    params32 = tree.map(lambda a: a.float(), lm.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks_k, logits_k, _ = generate(params32, prompt, cfg32, G, "cuda")
    toks_p, logits_p, _ = generate(
        params32, prompt, dataclasses.replace(cfg32, attention_impl="chunked"),
        G, "cuda")
    fp32_diff = float((logits_k - logits_p).abs().max())
    # tolerance: the same fp32 model, attention summed in another order
    torch.testing.assert_close(logits_k, logits_p, atol=1e-4, rtol=0,
                               msg="fp32 kernel vs chunked prefill logits")
    if not torch.equal(toks_k, toks_p):
        raise AssertionError(f"fp32 kernel vs chunked tokens differ in "
                             f"{int((toks_k != toks_p).sum())} places")
    del params32, logits_k, logits_p
    log(f"phase 6: kernel path vs plain chunked path on the card: bf16 "
        f"prefill logits max |diff| {bf16_diff:.4g}, {bf16_agree} of "
        f"{B * G} tokens agree; fp32 copy: logits max |diff| "
        f"{fp32_diff:.3g} (<= 1e-4), all {B * G} tokens identical")

    # (e) card (kernel) against CPU (plain version), 2 layers, fp32
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    p2 = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg2)
    prompt2 = make_prompt(cfg2, 1, 128, 0)
    ops.reset_flash_counts()
    toks_g, logits_g, _ = generate(p2, prompt2, cfg2, 8, "cuda")
    launches2 = ops.flash_launches
    toks_h, logits_h, _ = generate(tree.map(lambda a: a.cpu(), p2), prompt2,
                                   cfg2, 8, "cpu")
    cpu_diff = float((logits_g.cpu() - logits_h).abs().max())
    torch.testing.assert_close(logits_g.cpu(), logits_h, atol=1e-4, rtol=0,
                               msg="2-layer card vs CPU prefill logits")
    if not torch.equal(toks_g.cpu(), toks_h) or launches2 != 2:
        raise AssertionError(f"2-layer card vs CPU: tokens {toks_g.tolist()}"
                             f" vs {toks_h.tolist()}, {launches2} launches")
    ops.reset_flash_counts()
    log(f"phase 6: 2-layer fp32 config, B=1 prompt=128 gen=8: card (kernel,"
        f" {launches2} launches) vs CPU (plain): logits max |diff| "
        f"{cpu_diff:.3g} (<= 1e-4), tokens identical {toks_g[0].tolist()}")
    serve.update({"kernel_vs_chunked_bf16_logit_max_diff": bf16_diff,
                  "kernel_vs_chunked_bf16_tokens_agreeing": bf16_agree,
                  "kernel_vs_chunked_fp32_logit_max_diff": fp32_diff,
                  "card_vs_cpu_2_layer_logit_max_diff": cpu_diff})
    return serve


# ---------------------------------------------------------------------------
# phase 7: the recurrent serving path (hymba-1.5b and xlstm-125m)
# ---------------------------------------------------------------------------

BF, F32 = torch.bfloat16, torch.float32
# (B, S, H, N, P, chunk, q/v dtype, k dtype, q and k shared by the heads):
# the JAX kernel grid of tests/test_kernels.py:98-99 (B*H = 3); ragged S
# (1, 200); hymba's serving shape in bf16 (q and k broadcast over its 8
# heads) and fp32; xlstm's at S = 512 with the model's fp32 k beside bf16 q
# and v, and all in bf16; then ragged S (1, 40, 200) and P with q and k
# shared by the heads (a head stride of 0) on both routes, and N = 384 on
# the tensor cores
SCAN_GRID = ([(1, S, 3, N, P, ch, F32, F32, False)
              for S, ch in ((256, 64), (256, 128), (512, 256))
              for N, P in ((16, 32), (8, 64))]
             + [(1, S, 3, 16, 32, 64, F32, F32, False) for S in (1, 200)]
             + [(4, 1024, 8, 16, 400, 256, dt, dt, True) for dt in (BF, F32)]
             + [(4, 512, 4, 384, 385, 256, BF, kdt, False)
                for kdt in (F32, BF)]
             + [(2, S, 3, 16, 33, 64, dt, dt, True)
                for S in (1, 40, 200) for dt in (BF, F32)]
             + [(1, 300, 2, 384, 400, 256, BF, BF, False)])
HYMBA_SCAN = SCAN_GRID[8]           # the prefill's shape, bf16
XLSTM_SCAN = SCAN_GRID[10]          # the prefill's shape, fp32 k
# (rows, d): tests/test_kernels.py:140's grid, an odd d (the scalar route),
# hymba's prefill and decode rows; then the decode's few rows at qwen2's and
# hymba's widths, qwen2's prefill rows, the registry's 3072 and 5120 on both
# register routes, rows too long for registers (the looped route) at many
# and at few rows, and a d that is not a multiple of 8
RMS_GRID = ([(100, 64), (1000, 896), (256, 128), (7, 33), (4096, 1600),
             (4, 1600)]
            + [(T, d) for d in (896, 1600) for T in (1, 2, 8)]
            + [(4, 896), (4096, 896), (300, 3072), (4, 3072), (300, 5120),
               (4, 5120), (300, 16400), (4, 40000), (5, 1001)])
RMS_SERVE = (4096, 1600)
# the shapes phase 7c times: hymba's and qwen2's prefill and decode rows
RMS_TIMED = [(4096, 1600), (4096, 896), (4, 1600), (4, 896)]
HYMBA_PARAMS = 1640555968           # jax.eval_shape leaf total (the tests)
XLSTM_PARAMS = 172920624
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_GEN = 4, 512, 16


def scan_tol(dtype):
    """tests/test_kernels.py:109 (atol 2e-4, rtol 1e-3) for fp32 y and
    every h_final; bf16 y is rounded once to bf16, where a rounding of
    either side can flip one bf16 step: the repo's bf16 (2e-2, 1e-2)."""
    return (2e-4, 1e-3) if dtype == F32 else (2e-2, 1e-2)


def scan_inputs(case, gen):
    B, S, H, N, P, chunk, dt, kdt, shared = case
    Hq = 1 if shared else H
    q = torch.randn(B, S, Hq, N, device="cuda", generator=gen).to(dt)
    k = (torch.randn(B, S, Hq, N, device="cuda", generator=gen)
         * (0.05 if N > 100 else 0.3)).to(kdt)
    v = torch.randn(B, S, H, P, device="cuda", generator=gen).to(dt)
    la = -torch.nn.functional.softplus(
        torch.randn(B, S, H, device="cuda", generator=gen))
    return (q.expand(B, S, H, N), k.expand(B, S, H, N), v, la, chunk)


def scan_bound_ms(case):
    """Least time for the scan function: q, k, v and log_a read once (q and
    k once for all heads where the heads share them), y and h_final written
    once, over the memory rate, vs the recurrence's operations — a
    multiply-add a state element a step for the update and one for the
    readout, 4·N·P·S·B·H — over the bf16 tensor-core rate when q, k and v
    are all bf16, else over the fp32 rate (an fp32 operand keeps the
    products in fp32); the larger bounds it.  Beside it, this design's own
    floor: the same bytes plus its workspace's traffic — an (N, P) fp32
    state for each chunk of 64 steps, written by the chunk-state pass, read
    and rewritten by the state-passing pass and read by the output pass, 4
    times its size, and the chunk totals written and read — against the
    same operations.  Returns (bound, what sets it, bytes, operations,
    floor, bytes with the workspace)."""
    B, S, H, N, P, _, dt, kdt, shared = case
    isz, ksz = (2 if dt == BF else 4), (2 if kdt == BF else 4)
    Hq = 1 if shared else H
    nc = -(-S // 64)
    nbytes = (B * S * Hq * N * (isz + ksz) + 2 * B * S * H * P * isz
              + B * S * H * 4 + B * H * N * P * 4)
    ws_nbytes = nbytes + 4 * (4 * B * H * nc * N * P) + 2 * 4 * B * H * nc
    flops = 4 * N * P * S * B * H
    rate = BF16_FLOP_PER_S if dt == BF and kdt == BF else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    floor = max(ws_nbytes / HBM_BYTES_PER_S * 1e3, t_ops)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops, floor, ws_nbytes)


def rms_bound_ms(T, d, itemsize):
    """Least time for RMSNorm: x read and y written once (and g) over the
    memory rate vs 4 fp32 operations an element over the fp32 rate."""
    nbytes = 2 * T * d * itemsize + d * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * T * d / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def phase_scan_grid(ops, plain):
    """(a) the scan kernel against its plain version over SCAN_GRID;
    raises past |kernel - plain| <= atol + rtol·|plain|.  Returns the
    largest |kernel - plain| of y by dtype and of h_final."""
    gen = torch.Generator(device="cuda").manual_seed(70)
    max_err = {"float32": 0.0, "bfloat16": 0.0, "h_final": 0.0}
    for case in SCAN_GRID:
        q, k, v, la, chunk = scan_inputs(case, gen)
        y, h = ops.ssm_scan(q, k, v, la, chunk=chunk)
        wy, wh = plain(q, k, v, la, chunk)
        torch.cuda.synchronize()
        for got, want, (atol, rtol), key in (
                (y, wy, scan_tol(v.dtype), str(v.dtype)[6:]),
                (h, wh, scan_tol(F32), "h_final")):
            diff = (got.float() - want.float()).abs()
            bad = diff > atol + rtol * want.float().abs()
            if got.dtype != want.dtype or got.shape != want.shape \
                    or not bool(torch.isfinite(got).all()) or bool(bad.any()):
                raise AssertionError(f"ssm_scan {case} {key}: "
                                     f"{int(bad.sum())} elements past "
                                     f"tolerance, max err {float(diff.max())}")
            max_err[key] = max(max_err[key], float(diff.max()))
        del q, k, v, la, y, h, wy, wh
    ops.reset_ssm_scan_counts()    # comparison launches do not count
    log(f"phase 7: ssm_scan matches its plain version on {len(SCAN_GRID)} "
        f"cases (the JAX grid, S = 1 and 200, hymba (4, 1024, 8, 16, 400) "
        f"bf16/fp32 with q, k broadcast, xlstm (4, 512, 4, 384, 385) with an "
        f"fp32 or bf16 k, ragged S and P with shared heads on both routes, N "
        f"= 384 in bf16); max |err| y fp32 {max_err['float32']:.3g}, y bf16 "
        f"{max_err['bfloat16']:.3g}, h_final {max_err['h_final']:.3g}")
    return max_err


def phase_rms_grid(ops, plain, route, all_routes):
    """(b) the norm kernel against its plain version over RMS_GRID at
    tests/test_kernels.py's tolerances (fp32 atol 2e-5, bf16 2e-2, rtol
    1e-2).  Raises unless every route of the kernel ran."""
    gen = torch.Generator(device="cuda").manual_seed(71)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    routes = {}
    for T, d in RMS_GRID:
        for dt in (F32, BF):
            x = torch.randn(T, d, device="cuda", generator=gen).to(dt)
            g = torch.randn(d, device="cuda", generator=gen).to(dt)
            got = ops.rmsnorm(x, g)
            routes.setdefault(route(x, g, got), []).append(
                (T, d, str(dt)[6:]))
            want = plain(x, g)
            torch.cuda.synchronize()
            atol = 2e-5 if dt == F32 else 2e-2
            diff = (got.float() - want.float()).abs()
            if got.dtype != dt or bool(
                    (diff > atol + 1e-2 * want.float().abs()).any()):
                raise AssertionError(f"rmsnorm ({T}, {d}) {dt}: max err "
                                     f"{float(diff.max())}")
            key = str(dt)[6:]
            max_err[key] = max(max_err[key], float(diff.max()))
    ops.reset_rmsnorm_counts()     # comparison launches do not count
    if sorted(routes) != sorted(all_routes):
        raise AssertionError(f"rmsnorm routes run: {sorted(routes)}")
    log(f"phase 7: rmsnorm matches its plain version on "
        f"{2 * len(RMS_GRID)} cases {RMS_GRID} x (fp32, bf16); max |err| "
        f"fp32 {max_err['float32']:.3g}, bf16 {max_err['bfloat16']:.3g}; "
        f"routes {routes}")
    return max_err


def phase_recurrent_timing(ops, scan_plain, rms_plain, rms_route,
                           flash_plain):
    """(c) each kernel at its serving shape beside its plain version, the
    one PyTorch call that computes the same function where there is one,
    and its bound."""
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(72)
    rows = {}
    for name, case in (("hymba", HYMBA_SCAN), ("xlstm", XLSTM_SCAN)):
        q, k, v, la, chunk = scan_inputs(case, gen)
        k_ms = timer.ms(lambda: ops.ssm_scan(q, k, v, la, chunk=chunk))
        host_ms = timer.host_ms(lambda: ops.ssm_scan(q, k, v, la,
                                                     chunk=chunk))
        p_ms = timer.ms(lambda: scan_plain(q, k, v, la, chunk), reps=10)
        split, per_call = kernel_split(
            lambda: ops.ssm_scan(q, k, v, la, chunk=chunk),
            PORT_KERNEL_SYMBOLS["ssm_scan"])
        bound, by, nbytes, flops, floor_ms, ws_nbytes = scan_bound_ms(case)
        B, S, H, N, P = case[:5]
        rows[f"ssm_scan_{name}"] = {
            "shape": {"B": B, "S": S, "H": H, "N": N, "P": P,
                      "dtype": str(case[6])[6:], "k_dtype": str(case[7])[6:],
                      "qk_shared_by_heads": case[8]},
            "ms": k_ms, "host_ms": host_ms, "plain_ms": p_ms,
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "flops": flops,
            "bytes_with_workspace": ws_nbytes, "design_floor_ms": floor_ms,
            "kernel_split_ms": split,
            "launches_per_call": sum(per_call.values()),
            "launches_per_call_by_kernel": per_call}
        log(f"phase 7 timing: ssm_scan {name} {(B, S, H, N, P)}: kernel "
            f"{k_ms:.4f} ms (wrapper host time {host_ms:.4f} ms; by kernel "
            f"{split}, launches a call {per_call}), plain {p_ms:.4f} ms, no "
            f"library call, bound {bound:.4f} ms ({by}: {nbytes} B, {flops} "
            f"FLOP); kernel at {100 * bound / k_ms:.2f}% of the bound; the "
            f"design's floor with its workspace {floor_ms:.4f} ms "
            f"({ws_nbytes} B); kernel / plain {k_ms / p_ms:.3f}")
        del q, k, v, la
    rows["rmsnorm"] = [time_rms(ops, rms_plain, rms_route, timer, T, d,
                                gen) for T, d in RMS_TIMED]
    rows["flash_hymba"] = time_flash("phase 7", ops, flash_plain, timer,
                                     HYMBA_FLASH, 1024, gen)
    ops.reset_ssm_scan_counts()    # comparison launches do not count
    ops.reset_rmsnorm_counts()
    ops.reset_flash_counts()
    return rows


def time_rms(ops, plain, route, timer, T, d, gen):
    """The norm at (T, d) bf16: cold (L2 flushed) and warm (x in L2, as the
    decode finds it), beside its plain version, ``F.rms_norm`` and its
    bound."""
    import torch.nn.functional as F
    x = torch.randn(T, d, device="cuda", generator=gen).to(BF)
    g = torch.randn(d, device="cuda", generator=gen).to(BF)
    k_ms = timer.ms(lambda: ops.rmsnorm(x, g))
    warm_ms = timer.ms(lambda: ops.rmsnorm(x, g), flush=False)
    host_ms = timer.host_ms(lambda: ops.rmsnorm(x, g))
    p_ms = timer.ms(lambda: plain(x, g))
    lib_ms = lib_warm_ms = lib_diff = None
    if hasattr(F, "rms_norm"):
        lib_ms = timer.ms(lambda: F.rms_norm(x, (d,), g, 1e-5))
        lib_warm_ms = timer.ms(lambda: F.rms_norm(x, (d,), g, 1e-5),
                               flush=False)
        lib_diff = float((F.rms_norm(x, (d,), g, 1e-5).float()
                          - ops.rmsnorm(x, g).float()).abs().max())
    bound, by, nbytes = rms_bound_ms(T, d, 2)
    row = {"shape": {"T": T, "d": d, "dtype": "bfloat16"},
           "route": route(x, g, torch.empty_like(x)), "ms": k_ms,
           "warm_ms": warm_ms, "host_ms": host_ms, "plain_ms": p_ms,
           "library_ms": lib_ms, "library_warm_ms": lib_warm_ms,
           "library_max_abs_diff": lib_diff, "bound_ms": bound,
           "bound_by": by, "bytes": nbytes}
    log(f"phase 7 timing: rmsnorm ({T}, {d}) bf16, {row['route']} route: "
        f"kernel {k_ms:.4f} ms cold, {warm_ms:.4f} ms warm (wrapper host "
        f"time {host_ms:.4f} ms), plain {p_ms:.4f} ms, F.rms_norm {lib_ms} "
        f"ms cold, {lib_warm_ms} ms warm (|diff| {lib_diff}), bound "
        f"{bound:.4f} ms ({by}: {nbytes} B); kernel at "
        f"{100 * bound / k_ms:.2f}% of the bound")
    return row


def reset_counts(ops):
    ops.reset_agg_counts()
    ops.reset_topk_counts()
    ops.reset_flash_counts()
    ops.reset_ssm_scan_counts()
    ops.reset_rmsnorm_counts()


def lm_launches(t):
    """{part: (flash, ssm_scan, rmsnorm)} launches of one generate."""
    return {part: tuple(t[f"{part}_{k}_launches"]
                        for k in ("flash", "ssm_scan", "rmsnorm"))
            for part in ("prefill", "decode")}


def serve_main_run(label, ops, lm, tree, generate, make_prompt, cfg,
                   n_params, B, P, G, expect):
    """A full-width main run through ``generate``, after a one-token
    warm-up (a prefill alone, timed only as the first call): counts set to
    0 just before and read just after, held to ``expect`` = {part: (flash,
    ssm_scan, rmsnorm)}; finite logits, tokens in range; the serving
    numbers."""
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    got_params = sum(a.numel() for a in tree.leaves(params))
    if got_params != n_params:
        raise AssertionError(f"{cfg.name}: {got_params} params, expected "
                             f"{n_params}")
    prompt = make_prompt(cfg, B, P, 0)
    _, _, first = generate(params, prompt, cfg, 1, "cuda")  # warm-up
    reset_counts(ops)
    torch.cuda.reset_peak_memory_stats()
    toks, logits, t = generate(params, prompt, cfg, G, "cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = lm_launches(t)
    counters = {"flash": ops.flash_launches, "ssm_scan": ops.ssm_scan_launches,
                "rmsnorm": ops.rmsnorm_launches}
    routes = dict(ops.flash_route_launches)
    log(f"{label}: {cfg.name} launches (flash, ssm_scan, rmsnorm) in the "
        f"main run: prefill {launches['prefill']}, {G - 1} decode steps "
        f"{launches['decode']}; counters {counters}; flash by route {routes}")
    if launches != expect or tuple(counters.values()) != tuple(
            a + b for a, b in zip(expect["prefill"], expect["decode"])) \
            or routes["tensor_cores"] != counters["flash"]:
        raise AssertionError(f"{cfg.name}: expected launches {expect}, got "
                             f"{launches}, counters {counters}, every bf16 "
                             f"flash launch on the tensor cores: {routes}")
    if tuple(toks.shape) != (B, G) or tuple(logits.shape) != \
            (B, 1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()) \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: shapes {tuple(toks.shape)}, "
                             f"{tuple(logits.shape)}, non-finite logits or "
                             f"tokens out of range")
    serve = {"arch": cfg.name, "n_params": got_params, "batch": B,
             "prompt": P, "gen": G, "dtype": cfg.dtype, "init_s": t_init,
             "first_prefill_s": first["prefill_s"],
             "prefill_ms": t["prefill_s"] * 1e3,
             "prefill_tok_per_s": B * P / t["prefill_s"],
             "decode_ms": t["decode_s"] * 1e3,
             "decode_tok_per_s": B * (G - 1) / t["decode_s"],
             "max_memory_allocated": peak, "launches": launches,
             "flash_routes": routes}
    log(f"{label} serve: {cfg.name} ({got_params} params, {cfg.dtype}) "
        f"B={B} prompt={P} gen={G}: prefill {serve['prefill_ms']:.2f} ms "
        f"({serve['prefill_tok_per_s']:.0f} tok/s; first call "
        f"{first['prefill_s'] * 1e3:.2f} ms), decode "
        f"{serve['decode_ms']:.2f} ms ({serve['decode_tok_per_s']:.1f} "
        f"tok/s), max_memory_allocated {peak} B; sample tokens "
        f"{toks[0, :8].tolist()}")
    return params, prompt, toks, logits, t, serve


def profile_serve(label, generate, params, prompt, cfg, G, t, serve):
    """A torch.profiler pass of the prefill and of the whole generate; the
    decode loop is their difference."""
    prof_p = profile_generate(generate, params, prompt, cfg, 1)
    prof_all = profile_generate(generate, params, prompt, cfg, G)
    if prof_p is None or prof_all is None:
        log(f"{label} profile ({cfg.name}): the trace holds no device time "
            f"(not measured)")
        return
    dec_busy = prof_all["device_busy_s"] - prof_p["device_busy_s"]
    dec_wall = prof_all["wall_s"] - prof_p["wall_s"]
    prof_p["device_idle_share_unprofiled"] = \
        1.0 - prof_p["device_busy_s"] / t["prefill_s"]
    serve["profile_prefill"] = prof_p
    serve["profile_decode"] = {
        "wall_s": dec_wall, "device_busy_s": dec_busy,
        "device_idle_share": 1.0 - dec_busy / dec_wall,
        "device_idle_share_unprofiled": 1.0 - dec_busy / t["decode_s"],
        "kernel_launches": prof_all["kernel_launches"]
        - prof_p["kernel_launches"],
        "port_kernel_device_s": {
            k: prof_all["port_kernel_device_s"][k] - v
            for k, v in prof_p["port_kernel_device_s"].items()}}
    pk = {k: round(v * 1e3, 4) for k, v in
          prof_p["port_kernel_device_s"].items()}
    log(f"{label} profile ({cfg.name}), prefill: wall "
        f"{prof_p['wall_s']:.4f} s, device busy {prof_p['device_busy_s']:.4f}"
        f" s, idle share {prof_p['device_idle_share']:.3f} (against the "
        f"unprofiled prefill {prof_p['device_idle_share_unprofiled']:.3f}), "
        f"{prof_p['kernel_launches']} kernel launches; port kernels (ms) {pk}")
    for k in prof_p["top_kernels"]:
        log(f"    {k['device_s'] * 1e3:9.3f} ms  x{k['count']:<6d} "
            f"{k['name']}")
    pd = serve["profile_decode"]
    log(f"{label} profile ({cfg.name}), {G - 1} decode steps: wall "
        f"{dec_wall:.4f} s, device busy {dec_busy:.4f} s, idle share "
        f"{pd['device_idle_share']:.3f} (against the unprofiled decode "
        f"{pd['device_idle_share_unprofiled']:.3f}), "
        f"{pd['kernel_launches']} kernel launches")


def card_vs_cpu(ops, lm, tree, generate, make_prompt, full_cfg):
    """(f) the config cut to 2 layers, fp32, B=1, prompt 512, 8 tokens:
    the card (kernels) and the CPU (plain versions) give identical tokens
    and logits within 1e-4 (the same fp32 model, summed in another order);
    for hymba, on the card, the decode logit after the prefill equals a
    full forward over the prompt and that token within 2e-4 (the kernel's
    h_final and the conv tail seed the decode state)."""
    cfg = dataclasses.replace(full_cfg, n_layers=2, dtype="float32")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    prompt = make_prompt(cfg, 1, 512, 0)
    reset_counts(ops)
    toks_g, logits_g, t = generate(params, prompt, cfg, 8, "cuda")
    launches = lm_launches(t)
    toks_h, logits_h, _ = generate(tree.map(lambda a: a.cpu(), params),
                                   prompt, cfg, 8, "cpu")
    diff = float((logits_g.cpu() - logits_h).abs().max())
    torch.testing.assert_close(logits_g.cpu(), logits_h, atol=1e-4, rtol=0,
                               msg=f"{cfg.name} 2-layer card vs CPU logits")
    if not torch.equal(toks_g.cpu(), toks_h) or \
            launches["prefill"][1] != (2 if cfg.family == "hybrid" else 1):
        raise AssertionError(f"{cfg.name} 2-layer card vs CPU: tokens "
                             f"{toks_g.tolist()} vs {toks_h.tolist()}, "
                             f"launches {launches}")
    out = {"logit_max_diff": diff, "launches": launches}
    msg = ""
    if cfg.family == "hybrid":
        x = torch.from_numpy(prompt).to("cuda")
        with torch.no_grad():
            logits_p, caches = lm.make_prefill_step(cfg, 1, 512,
                                                    cache_len=513)(params, x)
            nxt = torch.argmax(logits_p[:, -1], dim=-1)[:, None]
            logits_d, _ = lm.make_decode_step(cfg)(params, nxt, caches, 512)
            h, _, _ = lm.forward(params, torch.cat([x, nxt], dim=1), cfg)
            full = lm._head(params, h[:, -1:], cfg)
        out["decode_vs_full_forward_max_diff"] = float(
            (logits_d - full).abs().max())
        torch.testing.assert_close(logits_d, full, atol=2e-4, rtol=0,
                                   msg="hymba decode vs full forward")
        msg = (f"; decode logit after the prefill vs a full forward "
               f"{out['decode_vs_full_forward_max_diff']:.3g} (<= 2e-4)")
    reset_counts(ops)
    log(f"phase 7: {cfg.name} cut to 2 layers, fp32, B=1 prompt=512 gen=8: "
        f"card (kernels, launches {launches}) vs CPU (plain): logits max "
        f"|diff| {diff:.3g} (<= 1e-4), tokens identical "
        f"{toks_g[0].tolist()}{msg}")
    return out


def phase_recurrent_serve(ops, lm, tree, generate, make_prompt, hymba,
                          xlstm):
    """(d) full-width hymba-1.5b, (e) full-width xlstm-125m, each through
    the kernels; (f) both cut to 2 layers, card against CPU."""
    cfg = dataclasses.replace(hymba, attention_impl="pallas")
    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    L = cfg.n_layers
    params, prompt, _, _, t, h_serve = serve_main_run(
        "phase 7", ops, lm, tree, generate, make_prompt, cfg, HYMBA_PARAMS,
        B, P, G, {"prefill": (L, L, 2 * L + 1),
                  "decode": (0, 0, (2 * L + 1) * (G - 1))})
    profile_serve("phase 7", generate, params, prompt, cfg, G, t, h_serve)
    del params
    reset_counts(ops)

    B, P, G = XLSTM_BATCH, XLSTM_PROMPT, XLSTM_GEN
    L = xlstm.n_layers
    params, prompt, _, _, t, x_serve = serve_main_run(
        "phase 7", ops, lm, tree, generate, make_prompt, xlstm, XLSTM_PARAMS,
        B, P, G, {"prefill": (0, L // 2, L + 1),
                  "decode": (0, 0, (L + 1) * (G - 1))})
    del params
    reset_counts(ops)

    h_serve["card_vs_cpu_2_layer"] = card_vs_cpu(ops, lm, tree, generate,
                                                 make_prompt, cfg)
    x_serve["card_vs_cpu_2_layer"] = card_vs_cpu(ops, lm, tree, generate,
                                                 make_prompt, xlstm)
    return h_serve, x_serve


# ---------------------------------------------------------------------------
# phase 8: the DES round engines (semi-sync and async)
# ---------------------------------------------------------------------------

# engine -> (engine_opts, hetero_gpus ratios, scheduler policy) at the
# quickstart size: the straggler configurations of
# tests/test_round_engine.py (deadline carry-over; stealing from a slow
# executor under round-robin placement)
DES_QUICKSTART = {
    "semi-sync": ({"deadline_frac": 0.5, "over_select": 1.5,
                   "chunk_size": 2}, {3: 18.0}, "parrot"),
    "async": ({"staleness_lambda": 0.5, "chunk_size": 2}, {0: 15.0}, "none"),
}
# benchmarks/bench_round_modes.py:33-38, under dynamic_env(4, DES_WINDOWS)
DES_FULL = {
    "semi-sync": {"deadline_frac": 0.55, "over_select": 1.2,
                  "chunk_size": 4},
    "async": {"staleness_lambda": 0.5, "chunk_size": 8},
}
DES_WINDOWS = 5        # the dynamic_env horizon of phases 8-10
DES_TIMED = 3          # timed windows an engine in 8b
DES_KEYS = ("carried_tasks", "landed_clients", "steals", "stale_folds",
            "mean_staleness", "in_system")


def window_key(m):
    """What a window must reproduce exactly on another device."""
    return (m.round, m.makespan, m.n_clients, m.n_executors, m.failures,
            m.extra)


def des_quickstart(T, make_clients, device, engine, windows=6):
    """The quickstart (FedAvg, 100 clients, 4 executors, 20 a round) under
    a DES engine and a TickTimer(1.0)."""
    opts, ratios, policy = DES_QUICKSTART[engine]
    algo = T.make_algorithm("fedavg", T.value_and_grad(softmax_loss),
                            lr=0.05, local_epochs=2)
    timer = T.TickTimer(1.0)
    execs = [T.SequentialExecutor(k, algo, timer=timer, device=device,
                                  speed_model=T.hetero_gpus(ratios))
             for k in range(4)]
    srv = T.ParrotServer(params={"w": torch.zeros(32, 10),
                                 "b": torch.zeros(10)},
                         algorithm=algo, executors=execs,
                         data_by_client=make_clients(
                             100, dim=32, n_classes=10, partition="natural",
                             seed=0),
                         clients_per_round=20, seed=0, device=device,
                         round_engine=engine, engine_opts=opts,
                         scheduler_policy=policy)
    return [srv.run_round() for _ in range(windows)], srv.params


def phase_des_quickstart(T, make_clients, ops):
    """8a: each engine on the card and on the CPU, 6 windows: windows equal
    exactly, params within 1e-5, every fold a launch of the leaves form,
    and the carry, steal and stale-fold branches taken."""
    out = {}
    for engine in DES_QUICKSTART:
        ops.reset_agg_counts()
        t0 = time.perf_counter()
        hg, pg = des_quickstart(T, make_clients, "cuda", engine)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        launches, leaves = ops.agg_launches, ops.agg_leaves_launches
        copies = ops.agg_leaf_copies
        t0 = time.perf_counter()
        hc, pc = des_quickstart(T, make_clients, "cpu", engine)
        t_cpu = time.perf_counter() - t0
        if [window_key(m) for m in hg] != [window_key(m) for m in hc]:
            raise AssertionError(
                f"{engine} quickstart windows differ card vs CPU: "
                f"{[window_key(m) for m in hg]} vs "
                f"{[window_key(m) for m in hc]}")
        for k in pc:
            torch.testing.assert_close(pg[k].cpu(), pc[k], atol=1e-5,
                                       rtol=1e-5,
                                       msg=f"{engine} quickstart param {k}")
        if launches <= 0 or leaves != launches or copies:
            raise AssertionError(
                f"{engine} quickstart: {launches} fold launches, {leaves} "
                f"of the leaves form, {copies} leaves copied")
        totals = {k: sum(m.extra.get(k, 0.0) for m in hg)
                  for k in ("carried_tasks", "steals", "stale_folds")}
        out[engine] = {"makespans": [m.makespan for m in hg],
                       "fold_launches": launches, "wall_s_card": t_card,
                       "wall_s_cpu": t_cpu, **totals}
        log(f"phase 8a: {engine} quickstart, 6 windows: makespans "
            f"{out[engine]['makespans']} and extra identical on card and "
            f"CPU, params allclose (1e-5); {launches} fold launches, all of "
            f"the leaves form; totals {totals}; wall {t_card:.2f} s card, "
            f"{t_cpu:.2f} s CPU")
    if not (out["semi-sync"]["carried_tasks"] > 0
            and out["async"]["steals"] > 0
            and out["async"]["stale_folds"] > 0):
        raise AssertionError(f"a DES branch never ran: {out}")
    return out


class FoldGroups:
    """While active, counts the groups ``LocalAggregator.fold_block``
    folds: each is one launch of the leaves form (blocks of at most 64
    clients, 142 leaves: one table)."""

    def __init__(self, T):
        self.cls, self.n = T.LocalAggregator, 0

    def __enter__(self):
        inner = self.inner = self.cls.fold_block

        def fold_block(agg, stacked, weights):
            inner(agg, stacked, weights)
            self.n += len(agg._acc)

        self.cls.fold_block = fold_block
        return self

    def __exit__(self, *exc):
        self.cls.fold_block = self.inner


def des_full_width(T, device, engine, windows, **kw):
    return full_width(T, device, windows,
                      speed_model=T.dynamic_env(4, DES_WINDOWS),
                      round_engine=engine, engine_opts=DES_FULL[engine],
                      warmup_rounds=2, **kw)


def phase_des_full_width(T, ops, plain):
    """8b: phase 4's model under each engine: measured windows on the card
    (every fold of the leaves form, one launch for each folded group), a
    profiled window, an async window with top-k 0.01, and card against
    CPU under a TickTimer."""
    n, k = TOPK_MAIN
    out = {}
    for engine in DES_FULL:
        rows = []
        last = [0]

        def on_window(w, m, wall, rows=rows, last=last):
            torch.cuda.synchronize()
            rows.append({"window": w, "wall_s": wall,
                         "makespan_s": m.makespan, "n_clients": m.n_clients,
                         "fold_launches": ops.agg_launches - last[0],
                         **{key: m.extra[key] for key in DES_KEYS
                            if key in m.extra}})
            last[0] = ops.agg_launches
            log(f"phase 8b {engine} window {w}: wall {wall:.3f} s, makespan "
                f"{m.makespan:.4f} s, {m.n_clients} clients, "
                + ", ".join(f"{key} {m.extra[key]:g}" for key in DES_KEYS
                            if key in m.extra)
                + f", fold launches {rows[-1]['fold_launches']}")

        ops.reset_agg_counts()
        with FoldGroups(T) as groups:
            srv = des_full_width(T, "cuda", engine, DES_TIMED,
                                 on_round=on_window)
            torch.cuda.synchronize()
        launches, leaves = ops.agg_launches, ops.agg_leaves_launches
        if launches <= 0 or leaves != launches or ops.agg_leaf_copies \
                or launches != groups.n:
            raise AssertionError(
                f"{engine} full width: {launches} fold launches, {leaves} of "
                f"the leaves form, {ops.agg_leaf_copies} leaves copied, "
                f"{groups.n} groups folded by fold_block")
        for key, v in srv.params.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{engine} full width: {key} not finite")
        t0 = time.perf_counter()
        prof = profile_round(srv)          # one more window, after the count
        t_prof = time.perf_counter() - t0
        if prof is None:
            log(f"phase 8b {engine} profile: the trace holds no device time "
                f"(not measured)")
        else:
            log(f"phase 8b {engine} profile (one more window): wall "
                f"{prof['wall_s']:.3f} s, device busy "
                f"{prof['device_busy_s']:.4f} s, idle share "
                f"{prof['device_idle_share']:.3f}, "
                f"{prof['kernel_launches']} kernel launches, fold "
                f"{prof['fold_device_s'] * 1e3:.4f} ms in "
                f"{prof['fold_kernels']} kernels; the profiled call took "
                f"{t_prof:.1f} s with the trace's processing")
        out[engine] = {"windows": rows, "fold_launches": launches,
                       "fold_block_groups": groups.n, "profile": prof}
        log(f"phase 8b {engine}: {launches} fold launches in "
            f"{DES_TIMED} windows, all of the leaves form, one for each "
            f"of the {groups.n} groups the chunks folded")

    # one async window with top-k 0.01: one launch for each span shipped,
    # and the kernel equal to its plain version on a real chunk partial
    box = {}
    ops.reset_topk_counts()
    t0 = time.perf_counter()
    des_full_width(T, "cuda", "async", 1,
                   compressor=T.TopKCompressor(0.01),
                   prepare=lambda s: box.update(
                       seen=capture_wires(s, first=True)))
    torch.cuda.synchronize()
    t_topk = time.perf_counter() - t0
    seen = box["seen"]
    topk_launches = ops.topk_launches
    if topk_launches <= 0 or topk_launches != seen["spans"]:
        raise AssertionError(f"async top-k window: {topk_launches} top-k "
                             f"launches for {seen['spans']} spans shipped")
    check_topk_partial(ops, plain, seen, "async top-k window chunk partial")
    ops.reset_topk_counts()        # comparison launches do not count
    out["async_topk"] = {"topk_launches": topk_launches,
                         "spans_shipped": seen["spans"],
                         "checked_partial": list(seen["key"]),
                         "residual_carried": seen["res_carried"],
                         "wall_s": t_topk}
    log(f"phase 8b async, one window with top-k 0.01: {topk_launches} top-k "
        f"launches for {seen['spans']} chunk-partial spans shipped; on "
        f"{seen['key'][1]}'s first shipped chunk partial (n={n}, k={k}, "
        f"residual carried: {seen['res_carried']}) kernel == plain == "
        f"shipped wire, bit for bit; wall {t_topk:.2f} s")

    # card against CPU under a TickTimer, 2 windows each: windows equal
    # exactly, params after window 0 within 1e-4; window 1 reported (the
    # deep ReLU model amplifies sum-order differences after round 0, as in
    # phase 5)
    for engine in DES_FULL:
        runs, walls = {}, {}
        for dev in ("cuda", "cpu"):
            got = {"params": []}
            t0 = time.perf_counter()

            def keep(w, m, wall, got=got):
                got["params"].append({q: v.detach().cpu().clone()
                                      for q, v in got["srv"].params.items()})
                got.setdefault("windows", []).append(window_key(m))

            des_full_width(T, dev, engine, 2, on_round=keep,
                           timer=T.TickTimer(1.0),
                           prepare=lambda s, got=got: got.update(srv=s))
            runs[dev], walls[dev] = got, time.perf_counter() - t0
        g, c = runs["cuda"], runs["cpu"]
        if g["windows"] != c["windows"]:
            raise AssertionError(f"{engine} full width, TickTimer: windows "
                                 f"differ: {g['windows']} vs {c['windows']}")
        for q, pc in c["params"][0].items():
            torch.testing.assert_close(g["params"][0][q], pc, atol=1e-4,
                                       rtol=1e-4,
                                       msg=f"{engine} full width window 0 "
                                           f"{q}")
        errs = [max(float((g["params"][w][q] - pc).abs().max())
                    for q, pc in c["params"][w].items()) for w in range(2)]
        out[engine]["card_vs_cpu"] = {"windows": g["windows"],
                                      "params_max_err": errs,
                                      "wall_s": walls}
        log(f"phase 8b {engine}, card vs CPU under TickTimer, 2 windows: "
            f"makespans {[wk[1] for wk in g['windows']]} and extra identical;"
            f" params after window 0 allclose (1e-4, max |diff| "
            f"{errs[0]:.3g}); after window 1 max |diff| {errs[1]:.3g} "
            f"(reported, not held); wall {walls['cuda']:.2f} s card, "
            f"{walls['cpu']:.2f} s CPU")
    return out


def phase_des(T, make_clients, ops, plain):
    t0 = time.perf_counter()
    quick = phase_des_quickstart(T, make_clients, ops)
    full = phase_des_full_width(T, ops, plain)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    return {"quickstart": quick, "full_width": full}


# ---------------------------------------------------------------------------
# phase 9: checkpoints and auto-resume; the streamed population
# ---------------------------------------------------------------------------

CKPT_ROUNDS = 4
MLP_STATE_BYTES = 4 * MAIN_SHAPE[0]     # one SCAFFOLD control variate
# engine -> (engine_opts, top-k fraction): phase 8b's options, and top-k
# 0.01 on the async run
CKPT_ENGINES = {"bsp": (None, None),
                "semi-sync": (DES_FULL["semi-sync"], None),
                "async": (DES_FULL["async"], 0.01)}


def ckpt_server(T, device, engine, work, ckpt, knobs=dict):
    """Phase 4's model, data and executors under SCAFFOLD: a state manager
    that holds 4 client states (the rest spill, one client a shard file),
    virtual time from a TickTimer, a checkpoint every round; ``knobs()``
    builds the network / fault kwargs afresh for each server."""
    from repro_torch.checkpoint import CheckpointManager
    opts, frac = CKPT_ENGINES[engine]
    algo = T.make_algorithm("scaffold", T.value_and_grad(mlp_loss), 0.05,
                            local_epochs=1)
    sm = T.ClientStateManager(tempfile.mkdtemp(dir=work, prefix="spill_"),
                              memory_budget_bytes=4 * MLP_STATE_BYTES,
                              shard_clients=1)
    timer = T.TickTimer(1.0)
    execs = [T.SequentialExecutor(k, algo, client_block=8, device=device,
                                  timer=timer, state_manager=sm,
                                  speed_model=T.dynamic_env(4, DES_WINDOWS))
             for k in range(4)]
    return T.ParrotServer(
        params=mlp_params(), algorithm=algo, executors=execs,
        data_by_client=mlp_clients(T), clients_per_round=16, seed=0,
        device=device, round_engine=engine, engine_opts=opts,
        warmup_rounds=2 if opts else 1,
        compressor=None if frac is None else T.TopKCompressor(frac),
        checkpoint_manager=CheckpointManager(ckpt, every_rounds=1, keep=2),
        **knobs())


def record_cohorts(srv):
    seen, inner = [], srv.scheduler.schedule

    def schedule(rnd, tasks, executors, **kw):
        seen.append((rnd, [t.client for t in tasks]))
        return inner(rnd, tasks, executors, **kw)

    srv.scheduler.schedule = schedule
    return seen


def timed_saves(srv, sync):
    """Time each save (wall, ms), its blob's bytes, and the shard bytes it
    wrote since the save before (files of a new inode) against the bytes
    it hard-linked."""
    cm, rows, inodes = srv.checkpoint_manager, [], set()
    inner = cm.save

    def save(server):
        sync()
        t0 = time.perf_counter()
        path = inner(server)
        ms = (time.perf_counter() - t0) * 1e3
        written = linked = 0
        state = os.path.join(path, "state")
        for f in sorted(os.listdir(state)) if os.path.isdir(state) else []:
            st = os.stat(os.path.join(state, f))
            if not f.startswith("shard_"):
                continue
            if st.st_ino not in inodes:
                written += st.st_size
                inodes.add(st.st_ino)
            if st.st_nlink > 1:
                linked += st.st_size
        rows.append({"round": server.round, "ms": ms,
                     "blob_bytes": os.path.getsize(
                         os.path.join(path, "server.pkl")),
                     "shard_bytes_written": written,
                     "shard_bytes_linked": linked})
        return path

    cm.save = save
    return rows


def ckpt_engine_run(T, device, engine, work, on_resumed=None, knobs=dict):
    """One engine: an uninterrupted CKPT_ROUNDS-round reference; the same
    server killed mid-round by a ``run_queue`` that raises
    KeyboardInterrupt at the middle one of executor 0's calls made in
    rounds 1 to CKPT_ROUNDS - 1 (the reference's count); a fresh server's
    ``run(CKPT_ROUNDS, auto_resume=True)``.  ``on_resumed(srv)`` runs on the
    resumed server before it restores (counters, wraps)."""
    from repro_torch.checkpoint import manager as ckm
    from repro_torch.checkpoint import params_digest
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    out = {}
    ref = ckpt_server(T, device, engine, work, os.path.join(work, "ref"),
                      knobs)
    ref_cohorts, saves = record_cohorts(ref), timed_saves(ref, sync)
    ex0, rounds = ref.executors[0], []
    real = ex0.run_queue

    def counting(*a, **kw):
        rounds.append(ref.round)
        return real(*a, **kw)

    ex0.run_queue = counting
    t0 = time.perf_counter()
    ref.run(CKPT_ROUNDS)
    sync()
    out["ref_wall_s"] = time.perf_counter() - t0
    out["digest"] = params_digest(ref.params)
    out["makespans"] = [m.makespan for m in ref.history]
    out["saves"] = saves
    mid = [i + 1 for i, r in enumerate(rounds) if 1 <= r < CKPT_ROUNDS]
    kill_at = mid[len(mid) // 2]

    ck = os.path.join(work, "ck")
    victim = ckpt_server(T, device, engine, work, ck, knobs)
    ex0, calls = victim.executors[0], [0]
    real = ex0.run_queue

    def dying(*a, **kw):
        calls[0] += 1
        if calls[0] >= kill_at:
            raise KeyboardInterrupt
        return real(*a, **kw)

    ex0.run_queue = dying
    try:
        victim.run(CKPT_ROUNDS)
    except KeyboardInterrupt:
        pass
    else:
        raise AssertionError(f"{engine}: the kill at call {kill_at} of "
                             f"executor 0 never fired")
    out["killed_in_round"] = victim.round
    if not 1 <= victim.round < CKPT_ROUNDS:
        raise AssertionError(f"{engine}: killed in round {victim.round}")
    del victim

    resumed = ckpt_server(T, device, engine, work, ck, knobs)
    cohorts = record_cohorts(resumed)
    box = {}
    inner = ckm.CheckpointManager.restore

    def restore(self, server, step_dir):
        sync()
        t0 = time.perf_counter()
        rnd = inner(self, server, step_dir)
        sync()
        box["ms"] = (time.perf_counter() - t0) * 1e3
        return rnd

    if on_resumed is not None:
        on_resumed(resumed)
    ckm.CheckpointManager.restore = restore
    try:
        t0 = time.perf_counter()
        hist = resumed.run(CKPT_ROUNDS, auto_resume=True)
        sync()
    finally:
        ckm.CheckpointManager.restore = inner
    out["resumed_wall_s"] = time.perf_counter() - t0
    out["restore_ms"] = box["ms"]
    out["resumed_digest"] = params_digest(resumed.params)
    out["resumed_makespans"] = [m.makespan for m in hist]
    out["cohorts_equal"] = bool(cohorts) and \
        ref_cohorts[-len(cohorts):] == cohorts
    out["n_clients_equal"] = [m.n_clients for m in hist] == \
        [m.n_clients for m in ref.history]
    out["fault_counters"] = [fault_counters(m) for m in ref.history]
    out["resumed_fault_counters"] = [fault_counters(m) for m in hist]
    return out


def check_topk_partial(ops, plain, seen, label):
    """The fused top-k equals its plain version bit for bit on the first
    partial ``capture_wires(first=True)`` kept, with the residual its
    sender carried, and both equal the wire shipped and the residual
    kept."""
    n, k = TOPK_MAIN
    x, r0 = seen["dense"][seen["key"]], seen["res_before"]
    if x.numel() != n:
        raise AssertionError(f"{label}: unexpected partial size {x.numel()}")
    want = plain(x, r0, k)
    got = ops.fused_topk(x, r0.clone(), k)
    torch.cuda.synchronize()
    for name, a, b in zip(("idx", "vals", "new_res"), want, got):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{label}: kernel {name} != plain")
    if not (torch.equal(seen["wire"][0], want[0])
            and torch.equal(seen["wire"][1].view(torch.int32),
                            want[1].view(torch.int32))
            and torch.equal(seen["res_after"].view(torch.int32),
                            want[2].view(torch.int32))):
        raise AssertionError(f"{label}: the shipped wire / residual differ "
                             f"from plain")


def phase_checkpoint(T, ops, plain):
    """9a: kill and auto-resume at full width for each engine, bit for bit
    against the uninterrupted run, every fold after the resume a
    leaves-form launch; for async, one top-k launch for each span shipped
    after the resume, the kernel equal to plain on a resumed partial, and
    a different wire when the codec's restored state is dropped."""
    from repro_torch.checkpoint import CheckpointManager
    out = {}
    for engine in CKPT_ENGINES:
        work = tempfile.mkdtemp(prefix=f"chip_smoke_ckpt_{engine}_")
        try:
            box = {}

            def on_resumed(srv, box=box):
                if srv.compressor is not None:
                    box["seen"] = capture_wires(srv, first=True)
                ops.reset_agg_counts()
                ops.reset_topk_counts()

            r = ckpt_engine_run(T, "cuda", engine, work, on_resumed)
            launches, leaves = ops.agg_launches, ops.agg_leaves_launches
            copies, topk = ops.agg_leaf_copies, ops.topk_launches
            if r["resumed_digest"] != r["digest"]:
                raise AssertionError(f"{engine}: resumed params_digest "
                                     f"{r['resumed_digest'][:16]} != "
                                     f"{r['digest'][:16]}")
            if r["resumed_makespans"] != r["makespans"] \
                    or not r["cohorts_equal"] or not r["n_clients_equal"]:
                raise AssertionError(
                    f"{engine}: resumed makespans / cohorts differ: "
                    f"{r['resumed_makespans']} vs {r['makespans']}, "
                    f"cohorts equal {r['cohorts_equal']}")
            if launches <= 0 or leaves != launches or copies:
                raise AssertionError(
                    f"{engine} after the resume: {launches} fold launches, "
                    f"{leaves} of the leaves form, {copies} leaves copied")
            r.update(fold_launches=launches, topk_launches=topk)
            if "seen" in box:
                seen = box["seen"]
                if topk <= 0 or topk != seen["spans"]:
                    raise AssertionError(f"{engine}: {topk} top-k launches "
                                         f"for {seen['spans']} spans shipped")
                if not seen["res_carried"]:
                    raise AssertionError(f"{engine}: the first partial after "
                                         f"the resume carried no residual")
                check_topk_partial(ops, plain, seen,
                                   f"{engine} resumed partial")
                ops.reset_topk_counts()     # comparison launches
                # the same restore with the codec's state dropped ships
                # another first wire
                skip = ckpt_server(T, "cuda", engine, work,
                                   os.path.join(work, "skip"))
                ck = os.path.join(work, "ck")
                CheckpointManager(ck).restore(skip, os.path.join(
                    ck, f"step_{r['killed_in_round']:08d}"))
                skip.compressor.load_state_dict(None)
                seen_skip = capture_wires(skip, first=True)
                skip.run_round()
                torch.cuda.synchronize()
                if seen_skip["key"] != seen["key"] or torch.equal(
                        seen_skip["wire"][0], seen["wire"][0]):
                    raise AssertionError(
                        f"{engine}: dropping the restored residuals left the "
                        f"first wire unchanged ({seen_skip['key']} vs "
                        f"{seen['key']})")
                ops.reset_topk_counts()
                r.update(spans_shipped=seen["spans"],
                         checked_partial=list(seen["key"]),
                         wire_differs_without_residuals=True)
                del skip
            out[engine] = r
            saves = r["saves"]
            log(f"phase 9a {engine}: killed in round {r['killed_in_round']},"
                f" auto-resumed: params_digest {r['digest'][:16]} equal, "
                f"makespans {r['makespans']} and cohorts equal; after the "
                f"resume {launches} fold launches, all of the leaves form"
                + (f"; {topk} top-k launches for {r['spans_shipped']} spans "
                   f"shipped, kernel == plain on the resumed partial "
                   f"{r['checked_partial']}, another wire without the "
                   f"restored residuals" if "seen" in box else "")
                + f"; save {[round(v['ms'], 1) for v in saves]} ms, blob "
                f"{[v['blob_bytes'] for v in saves]} B, shard bytes written "
                f"{[v['shard_bytes_written'] for v in saves]} of linked "
                f"{[v['shard_bytes_linked'] for v in saves]}; restore "
                f"{r['restore_ms']:.1f} ms; walls {r['ref_wall_s']:.2f} s "
                f"(4 rounds) / {r['resumed_wall_s']:.2f} s (resume)")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return out


def rss_bytes():
    """(current, peak) resident set of this process: VmRSS from /proc and
    ``ru_maxrss`` (KiB on Linux)."""
    import resource
    cur = 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                cur = int(line.split()[1]) * 1024
    return cur, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def population_server(T, device, data, work):
    """The quickstart's model under SCAFFOLD, 4 executors, 64 clients a
    round, a TickTimer."""
    algo = T.make_algorithm("scaffold", T.value_and_grad(softmax_loss),
                            lr=0.05, local_epochs=1)
    sm = T.ClientStateManager(tempfile.mkdtemp(dir=work, prefix="pop_"))
    timer = T.TickTimer(1.0)
    execs = [T.SequentialExecutor(k, algo, timer=timer, device=device,
                                  state_manager=sm) for k in range(4)]
    return T.ParrotServer(params={"w": torch.zeros(32, 10),
                                  "b": torch.zeros(10)},
                          algorithm=algo, executors=execs,
                          data_by_client=data, clients_per_round=64, seed=0,
                          device=device)


def select_us(T, data, draws=200):
    srv = T.ParrotServer(params={"w": torch.zeros(2)},
                         algorithm=T.make_algorithm(
                             "fedavg", T.value_and_grad(softmax_loss), 0.1),
                         executors=[], data_by_client=data,
                         clients_per_round=64, seed=1, device="cpu")
    srv.select_clients()
    t0 = time.perf_counter()
    for _ in range(draws):
        srv.select_clients()
    return (time.perf_counter() - t0) / draws * 1e6


def phase_population(T, ops, make_population):
    """9b: a 1,000,000-client streamed population on the card (SCAFFOLD,
    64 a round, 3 rounds) with its registry, fetch cache and selection
    cost; then M = 2,000 lazy against its ``materialize()`` twin, bit for
    bit."""
    work = tempfile.mkdtemp(prefix="chip_smoke_pop_")
    try:
        rss0 = rss_bytes()
        t0 = time.perf_counter()
        pop = make_population(1_000_000, dim=32, n_classes=10, seed=0,
                              fetch_cache_bytes=1 << 20)
        t_reg = time.perf_counter() - t0
        reg_bytes = pop._sizes.nbytes
        sel = {m: select_us(T, p) for m, p in (
            (1000, make_population(1000, dim=32, n_classes=10, seed=0)),
            (1_000_000, pop))}
        srv = population_server(T, "cuda", pop, work)
        ops.reset_agg_counts()
        t0 = time.perf_counter()
        hist = srv.run(3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, leaves = ops.agg_launches, ops.agg_leaves_launches
        rss1 = rss_bytes()
        if launches <= 0 or leaves != launches:
            raise AssertionError(f"1M population: {launches} fold launches, "
                                 f"{leaves} of the leaves form")
        if pop.cache_bytes > pop.fetch_cache_bytes:
            raise AssertionError(f"fetch cache {pop.cache_bytes} B over its "
                                 f"{pop.fetch_cache_bytes} B")
        if any(m.n_clients != 64 for m in hist) or not all(
                bool(torch.isfinite(v).all()) for v in srv.params.values()):
            raise AssertionError("1M population: a round lost clients or "
                                 "the params are not finite")
        out = {"clients": len(pop), "registry_bytes": reg_bytes,
               "registry_s": t_reg, "cache_bytes": pop.cache_bytes,
               "fetch_cache_bytes": pop.fetch_cache_bytes,
               "stats": dict(pop.stats), "select_us": sel,
               "makespans": [m.makespan for m in hist], "wall_s": wall,
               "fold_launches": launches,
               "rss_bytes_before": rss0[0], "rss_bytes_after": rss1[0],
               "peak_rss_bytes": rss1[1]}
        log(f"phase 9b: 1,000,000 streamed clients, registry {reg_bytes} B "
            f"({reg_bytes / len(pop):.0f} B a client, built in {t_reg:.3f} "
            f"s); 3 SCAFFOLD rounds of 64 on the card in {wall:.2f} s, "
            f"makespans {out['makespans']}, {launches} fold launches all of "
            f"the leaves form; fetch cache {pop.cache_bytes} B of "
            f"{pop.fetch_cache_bytes} B, {pop.stats}; select_clients "
            f"{sel[1000]:.1f} us a draw at M = 1,000, "
            f"{sel[1_000_000]:.1f} us at M = 1,000,000; RSS "
            f"{rss0[0]} -> {rss1[0]} B, peak {rss1[1]} B")

        def twin_run(data):
            s = population_server(T, "cuda", data, work)
            s.run(3)
            torch.cuda.synchronize()
            return s

        def small():
            return make_population(2000, dim=32, n_classes=10, seed=0,
                                   fetch_cache_bytes=64 << 10)

        eager = twin_run(small().materialize())
        lazy_pop = small()
        lazy = twin_run(lazy_pop)
        if any(not torch.equal(eager.params[k], lazy.params[k])
               for k in eager.params) or \
                [m.makespan for m in eager.history] != \
                [m.makespan for m in lazy.history]:
            raise AssertionError("M = 2,000: the lazy run differs from its "
                                 "eager twin")
        if lazy_pop.cache_bytes > lazy_pop.fetch_cache_bytes:
            raise AssertionError("M = 2,000: fetch cache over its bound")
        out["twin"] = {"clients": 2000, "bit_exact": True,
                       "stats": dict(lazy_pop.stats)}
        log(f"phase 9b: M = 2,000 lazy run == its materialize() eager twin "
            f"bit for bit on the card (params, makespans "
            f"{[m.makespan for m in lazy.history]}); fetch cache "
            f"{lazy_pop.stats}")
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_ckpt(T, ops, plain, make_population):
    t0 = time.perf_counter()
    ckpt = phase_checkpoint(T, ops, plain)
    pop = phase_population(T, ops, make_population)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return {"checkpoint": ckpt, "population": pop}


# ---------------------------------------------------------------------------
# phase 10: the network, availability and fault model
# ---------------------------------------------------------------------------

NET_ROUNDS = 3
# engine -> engine_opts: phase 8b's options (BSP takes none)
NET_ENGINES = {"bsp": None, "semi-sync": DES_FULL["semi-sync"],
               "async": DES_FULL["async"]}
NET_KEYS = ("comm_time_up", "comm_time_down", "comm_wire_bytes")
FAULT_KEYS = ("retries", "corrupt_payloads", "dropped_clients",
              "fault_crashes", "fault_restarts", "chunk_timeouts",
              "quorum_commits")
AVAIL_PERIOD = 30.0             # virtual seconds: ~5 full-width rounds
FAULT_ROUNDS = 3
FAULT_RATE = 0.05               # benchmarks/bench_fault_tolerance.py's top
# the plan seed: the first seed (in order from 0) whose per-cell plans,
# over the horizons the fault-free runs set, hold a crash early enough for
# its restart to fire inside the run and a corrupt event, and whose run
# then moved crashes, restarts, retries and corrupt payloads over the
# phase -- found by rehearsing 10(c) on the CPU under the same TickTimer,
# whose virtual times are the card's
FAULT_SEED = 46
# 10(d)'s plan: ten times the benchmark's rate over the first 8 virtual s
# of the 4-window SCAFFOLD run, so that a crash, retries and the crash's
# restart fall inside it with the kill between them (rehearsed on the CPU)
RESUME_RATE, RESUME_HORIZON = 0.5, 8.0
FAULT_CELLS = (("bsp", 1.0), ("bsp", 0.7), ("semi-sync", 1.0),
               ("semi-sync", 0.7), ("async", None))


def fault_counters(m):
    return {k: m.extra.get(k, 0.0) for k in FAULT_KEYS}


def lognormal_net(T):
    """benchmarks/bench_network.py:40, 58-60's constrained uplink (median
    40 kbps, lognormal σ 1, trace seed 13) over phase 4's 64 clients."""
    from repro_torch.data import synthesize_capacity_trace
    return T.NetworkModel.from_trace(synthesize_capacity_trace(
        M, seed=13, dist="lognormal", median_uplink_kbps=40.0))


def engine_run(T, device, engine, rounds, opts=None, **kw):
    """Phase 4's model under ``engine`` with phase 8b's options (``opts``
    merged in), ``dynamic_env(4, 5)`` and warmup 2, as phase 8b runs it."""
    opts = dict(NET_ENGINES[engine] or {}, **(opts or {}))
    return full_width(T, device, rounds,
                      speed_model=T.dynamic_env(4, DES_WINDOWS),
                      round_engine=engine, engine_opts=opts,
                      warmup_rounds=2, **kw)


class ShippedBytes:
    """While active, sums the achieved wire bytes of every partial the
    network pricer ships (``_NetSim.ship``: compress, measure, send), by
    the round the server stood at when it shipped — an async window's tail
    ships bill the next window."""

    def __init__(self):
        from repro_torch.core import engine
        self.cls = engine._NetSim

    def __enter__(self):
        inner = self.inner = self.cls.ship
        self.by_round, self.n = {}, 0

        def ship(ns, executor, partial):
            wire, nb = inner(ns, executor, partial)
            rnd = ns.srv.round
            self.by_round[rnd] = self.by_round.get(rnd, 0) + nb
            self.n += 1
            return wire, nb

        self.cls.ship = ship
        return self

    def __exit__(self, *exc):
        self.cls.ship = self.inner


class HostCost:
    """While active, the host seconds spent in the network pricer's and
    the fault injector's checks (``_NetSim``'s pricing and availability
    methods, every public ``FaultInjector`` method; the outermost call
    only, so ``price_upload``'s re-pricing counts once), read and reset
    per round by ``take()``.  ``ship`` (the codec and the comm layer) is
    not among them."""

    NETSIM = ("down", "up", "comm_pred", "split_available", "extra")
    FAULTS = ("crash_due", "crash_in", "fire_crash", "restarts_due",
              "slowdown", "scaled_model", "client_down", "dropout_in",
              "split_up", "upload_lost", "take_corrupt", "xfer_end",
              "charge_retry", "clear_retries", "price_upload")

    def __enter__(self):
        from repro_torch.core import engine, faults
        self.saved, self.s, depth = [], 0.0, [0]
        for cls, names in ((engine._NetSim, self.NETSIM),
                           (faults.FaultInjector, self.FAULTS)):
            for name in names:
                inner = getattr(cls, name)

                def timed(*a, inner=inner, **kw):
                    if depth[0]:
                        return inner(*a, **kw)
                    depth[0] += 1
                    t0 = time.perf_counter()
                    try:
                        return inner(*a, **kw)
                    finally:
                        self.s += time.perf_counter() - t0
                        depth[0] -= 1

                self.saved.append((cls, name, inner))
                setattr(cls, name, timed)
        return self

    def take(self):
        s, self.s = self.s, 0.0
        return s

    def __exit__(self, *exc):
        for cls, name, inner in self.saved:
            setattr(cls, name, inner)


def phase_network(T, ops, plain):
    """10a: each engine under the constrained lognormal uplink, without a
    codec and with top-k 0.01, NET_ROUNDS rounds on the card: per round
    the makespan, the comm keys, the wall and the launches; top-k launches
    == spans shipped, every fold of the leaves form and one launch a
    folded group, ``comm_wire_bytes`` == the bytes shipped, the kernel
    equal to plain on a real shipped partial."""
    out = {}
    for engine in NET_ENGINES:
        for codec in (None, 0.01):
            label = f"{engine}, {'top-k 0.01' if codec else 'no codec'}"
            rows, last, box = [], {"topk": 0, "fold": 0}, {}

            def on_round(r, m, wall, rows=rows, last=last, label=label):
                torch.cuda.synchronize()
                row = {"round": r, "makespan_s": m.makespan, "wall_s": wall,
                       "n_clients": m.n_clients,
                       "netsim_host_ms": cost.take() * 1e3,
                       "topk_launches": ops.topk_launches - last["topk"],
                       "fold_launches": ops.agg_launches - last["fold"],
                       **{k: m.extra[k] for k in NET_KEYS}}
                last.update(topk=ops.topk_launches, fold=ops.agg_launches)
                rows.append(row)
                log(f"phase 10a {label} round {r}: makespan "
                    f"{m.makespan:.4f} virtual s (comm up "
                    f"{row['comm_time_up']:.4f}, down "
                    f"{row['comm_time_down']:.4f}), "
                    f"{row['comm_wire_bytes']:.0f} wire bytes, wall "
                    f"{wall:.3f} s (pricing {row['netsim_host_ms']:.3f} ms "
                    f"of host), {row['topk_launches']} top-k and "
                    f"{row['fold_launches']} fold launches")

            ops.reset_agg_counts()
            ops.reset_topk_counts()
            prepare = (lambda s: box.update(seen=capture_wires(
                s, first=True))) if codec else None
            t0 = time.perf_counter()
            with FoldGroups(T) as groups, ShippedBytes() as shipped, \
                    HostCost() as cost:
                srv = engine_run(
                    T, "cuda", engine, NET_ROUNDS, on_round=on_round,
                    network=lognormal_net(T), prepare=prepare,
                    compressor=T.TopKCompressor(codec) if codec else None)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, leaves = ops.agg_launches, ops.agg_leaves_launches
            topk = ops.topk_launches
            if launches <= 0 or leaves != launches or ops.agg_leaf_copies \
                    or launches != groups.n:
                raise AssertionError(
                    f"10a {label}: {launches} fold launches, {leaves} of the "
                    f"leaves form, {groups.n} groups folded")
            wire = [m.extra["comm_wire_bytes"] for m in srv.history]
            want = [float(shipped.by_round.get(r, 0))
                    for r in range(NET_ROUNDS)]
            if wire != want or not all(w > 0 for w in wire):
                raise AssertionError(f"10a {label}: comm_wire_bytes {wire} "
                                     f"!= bytes shipped {want}")
            for key, v in srv.params.items():
                if not bool(torch.isfinite(v).all()):
                    raise AssertionError(f"10a {label}: {key} not finite")
            row = {"rounds": rows, "fold_launches": launches,
                   "topk_launches": topk, "partials_shipped": shipped.n,
                   "makespan_s": sum(m.makespan for m in srv.history),
                   "wall_s": wall}
            if codec:
                seen = box["seen"]
                if topk <= 0 or topk != seen["spans"]:
                    raise AssertionError(f"10a {label}: {topk} top-k "
                                         f"launches for {seen['spans']} "
                                         f"spans shipped")
                check_topk_partial(ops, plain, seen, f"10a {label}")
                ops.reset_topk_counts()       # comparison launches
                row.update(spans_shipped=seen["spans"],
                           checked_partial=list(seen["key"]))
            elif topk:
                raise AssertionError(f"10a {label}: {topk} top-k launches")
            out[(engine, codec)] = row
            log(f"phase 10a {label}: {launches} fold launches (all of the "
                f"leaves form, one a group), {topk} top-k launches for "
                f"{shipped.n} partials shipped; comm_wire_bytes == bytes "
                f"shipped each round"
                + (f"; kernel == plain on {seen['key'][1]}'s shipped partial "
                   f"of round {seen['key'][0]}" if codec else "")
                + f"; {NET_ROUNDS} rounds {row['makespan_s']:.2f} virtual s,"
                f" wall {wall:.2f} s")
    cuts = {}
    for engine in NET_ENGINES:
        dense = out[(engine, None)]["makespan_s"]
        comp = out[(engine, 0.01)]["makespan_s"]
        cuts[engine] = {"makespan_s": dense, "topk_makespan_s": comp,
                        "cut": 1.0 - comp / dense}
        log(f"phase 10a {engine}: top-k 0.01 makespan {comp:.2f} against "
            f"{dense:.2f} virtual s uncompressed over {NET_ROUNDS} rounds: "
            f"{100 * cuts[engine]['cut']:.1f} % cut (full width; "
            f"BENCH_network.json's 71.6-74.3 % is the pre-port 32-dim MLP)")
    return {"runs": {f"{e}/{c or 'none'}": v for (e, c), v in out.items()},
            "topk_cut": cuts}


def availability_run(T, device, engine, rounds):
    """10b: phase 4's model under diurnal churn (64 clients, period
    AVAIL_PERIOD virtual s, duty 0.6, seed 22) and a TickTimer; every
    client selected is recorded with the virtual time it was picked at."""
    av = T.ClientAvailability.diurnal(M, period_s=AVAIL_PERIOD,
                                      duty_mean=0.6, seed=22)
    picked = []

    def prepare(s):
        inner = s.select_clients

        def select(*a, **kw):
            tasks = inner(*a, **kw)
            picked.extend((t.client, s.virtual_now) for t in tasks)
            return tasks

        s.select_clients = select

    srv = engine_run(T, device, engine, rounds, availability=av,
                     timer=T.TickTimer(1.0), prepare=prepare)
    return srv, av, picked


def phase_availability(T, ops):
    out = {}
    for engine in ("bsp", "async"):
        ops.reset_agg_counts()
        t0 = time.perf_counter()
        srv, av, picked = availability_run(T, "cuda", engine, NET_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        offline = [(c, t) for c, t in picked if not av.available(c, t)]
        if offline or not picked:
            raise AssertionError(f"10b {engine}: offline clients selected: "
                                 f"{offline[:5]}")
        if ops.agg_launches <= 0 \
                or ops.agg_leaves_launches != ops.agg_launches:
            raise AssertionError(f"10b {engine}: fold launches not all of "
                                 f"the leaves form")
        dropped = [m.extra["dropped_clients"] for m in srv.history]
        idle = [m.extra.get("idle_time", 0.0) for m in srv.history]
        out[engine] = {"makespans": [m.makespan for m in srv.history],
                       "dropped_clients": dropped, "idle_time": idle,
                       "selected": len(picked),
                       "fold_launches": ops.agg_launches, "wall_s": wall}
        log(f"phase 10b {engine}, diurnal availability: {len(picked)} "
            f"clients selected, none offline; dropped {dropped}, "
            f"fast-forwards {idle} virtual s; makespans "
            f"{out[engine]['makespans']}; {ops.agg_launches} fold launches, "
            f"all of the leaves form; wall {wall:.2f} s")
    return out


def fault_knobs(T, plan):
    return {"faults": plan,
            "retry": T.RetryPolicy(timeout_s=8.0, max_retries=2,
                                   backoff_s=0.5),
            "network": T.NetworkModel.uniform(12e6, 24e6, latency_s=0.03)}


def fault_plan(T, seed, horizon, rate=FAULT_RATE):
    """benchmarks/bench_fault_tolerance.py:39-54's plan at ``rate`` over
    phase 4's 4 executors and 64 clients."""
    return T.FaultPlan.random(
        seed=seed, horizon=horizon, executors=list(range(4)),
        clients=list(range(M)), crash_rate=rate * 0.3, restart_delay=6.0,
        dropout_rate=rate, dropout_duration=5.0, corrupt_rate=rate * 0.5,
        blackout_rate=rate * 0.2, blackout_duration=1.5,
        slowdown_rate=rate * 0.3, slowdown_duration=8.0,
        slowdown_factor=3.0)


def fault_run(T, device, engine, quorum, rounds, plan, **kw):
    """One 10(c) cell under a TickTimer: the uniform 12 MB/s link, the
    retry policy and ``plan`` (None: the fault-free run whose span sets
    the cell's horizon)."""
    opts = {} if quorum is None else {"quorum_frac": quorum}
    return engine_run(T, device, engine, rounds, opts=opts,
                      timer=T.TickTimer(1.0), **fault_knobs(T, plan), **kw)


def fault_cell(T, ops, device, engine, quorum, rounds, seed=FAULT_SEED,
               horizon=None):
    """One cell on ``device``: the horizon (the fault-free span of
    ``rounds`` rounds unless given), then the plan's run: its windows,
    history, walls, params after round 2 and fold launches."""
    if horizon is None:
        horizon = fault_run(T, device, engine, quorum, rounds,
                            None).virtual_now
    got = {"horizon_s": horizon, "windows": [], "walls": [], "host_ms": []}

    def keep(r, m, wall):
        got["windows"].append(window_key(m))
        got["walls"].append(wall)
        got["host_ms"].append(cost.take() * 1e3)
        if r == 1:
            got["params"] = {q: v.detach().cpu().clone()
                             for q, v in got["srv"].params.items()}

    ops.reset_agg_counts()
    with HostCost() as cost:
        srv = fault_run(T, device, engine, quorum, rounds,
                        fault_plan(T, seed, horizon), on_round=keep,
                        prepare=lambda s: got.update(srv=s))
    if device != "cpu":
        torch.cuda.synchronize()
    got.update(history=list(srv.history), fold_launches=ops.agg_launches,
               leaves_launches=ops.agg_leaves_launches)
    return got


def phase_faults(T, ops):
    """10c: every cell's fault-free span sets its horizon; the plan's
    FAULT_ROUNDS rounds on the card; each engine's first cell's first 2
    rounds on the CPU too: windows and fault counters identical, params
    after round 2 within 1e-5."""
    out, totals, spans = {}, {k: 0.0 for k in FAULT_KEYS}, {}
    for engine, quorum in FAULT_CELLS:
        label = engine if quorum is None else f"{engine} q{quorum}"
        # BSP's quorum acts only when an executor fails: one fault-free
        # span serves both of its cells
        span_key = (engine, None if engine == "bsp" else quorum)
        g = fault_cell(T, ops, "cuda", engine, quorum, FAULT_ROUNDS,
                       horizon=spans.get(span_key))
        if g["fold_launches"] <= 0 \
                or g["leaves_launches"] != g["fold_launches"]:
            raise AssertionError(f"10c {label}: fold launches not all of "
                                 f"the leaves form")
        err = None
        if engine not in {e for e, _ in spans}:     # the engine's twin
            c = fault_cell(T, ops, "cpu", engine, quorum, 2,
                           horizon=g["horizon_s"])
            if g["windows"][:2] != c["windows"]:
                raise AssertionError(
                    f"10c {label}: windows differ card vs CPU: "
                    f"{g['windows'][:2]} vs {c['windows']}")
            err = max(float((g["params"][q] - pc).abs().max())
                      for q, pc in c["params"].items())
            for q, pc in c["params"].items():
                torch.testing.assert_close(g["params"][q], pc, atol=1e-5,
                                           rtol=1e-5,
                                           msg=f"10c {label} {q}")
        spans[span_key] = g["horizon_s"]
        counters = [fault_counters(m) for m in g["history"]]
        for row in counters:
            for k, v in row.items():
                totals[k] += v
        out[label] = {"horizon_s": g["horizon_s"],
                      "makespans": [m.makespan for m in g["history"]],
                      "fault_counters": counters,
                      "comm": [{k: m.extra[k] for k in NET_KEYS}
                               for m in g["history"]],
                      "fold_launches": g["fold_launches"],
                      "walls_s": g["walls"], "check_host_ms": g["host_ms"],
                      "params_max_err": err}
        log(f"phase 10c {label}: horizon {g['horizon_s']:.3f} virtual s "
            f"(the fault-free span of {FAULT_ROUNDS} rounds), plan seed "
            f"{FAULT_SEED}; makespans {out[label]['makespans']}; fault "
            f"counters {counters}; "
            + ("" if err is None else
               f"card == CPU over 2 rounds (windows and counters identical, "
               f"params max |diff| {err:.3g} <= 1e-5); ")
            + f"{g['fold_launches']} fold launches, all of the leaves form; "
            f"walls {[round(w, 3) for w in g['walls']]} s, pricing and "
            f"fault checks {[round(h, 3) for h in g['host_ms']]} ms of "
            f"host a round")
    for key in ("fault_crashes", "fault_restarts", "retries",
                "corrupt_payloads"):
        if totals[key] <= 0:
            raise AssertionError(f"10c: plan seed {FAULT_SEED} never moved "
                                 f"{key} over the phase: {totals}")
    log(f"phase 10c: plan seed {FAULT_SEED}: the first seed whose plans "
        f"put a crash early enough for its restart to fire and a corrupt "
        f"event in some cell, and whose run then moved crashes, restarts, "
        f"retries and corrupt payloads (rehearsed on the CPU under the same "
        f"TickTimer, whose virtual times are the card's); totals {totals}")
    out["totals"] = totals
    return out


def phase_fault_resume(T, ops, plain):
    """10d: phase 9a's kill and auto-resume on async with top-k 0.01 under
    a fault plan (seed FAULT_SEED at RESUME_RATE over RESUME_HORIZON) with
    10c's network and retry policy."""
    work = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    try:
        box = {}

        def on_resumed(srv):
            box["seen"] = capture_wires(srv, first=True)
            ops.reset_agg_counts()
            ops.reset_topk_counts()

        r = ckpt_engine_run(
            T, "cuda", "async", work, on_resumed,
            knobs=lambda: fault_knobs(T, fault_plan(
                T, FAULT_SEED, RESUME_HORIZON, RESUME_RATE)))
        topk, seen = ops.topk_launches, box["seen"]
        if r["resumed_digest"] != r["digest"] \
                or r["resumed_makespans"] != r["makespans"] \
                or not r["cohorts_equal"] or not r["n_clients_equal"] \
                or r["resumed_fault_counters"] != r["fault_counters"]:
            raise AssertionError(
                f"10d: the resumed run differs: digest "
                f"{r['resumed_digest'][:16]} vs {r['digest'][:16]}, "
                f"makespans {r['resumed_makespans']} vs {r['makespans']}, "
                f"counters {r['resumed_fault_counters']} vs "
                f"{r['fault_counters']}")
        fired = {k: sum(row[k] for row in r["fault_counters"])
                 for k in ("fault_crashes", "fault_restarts", "retries")}
        if not all(fired.values()):
            raise AssertionError(f"10d: the plan left a counter at 0: "
                                 f"{fired}")
        if topk <= 0 or topk != seen["spans"] \
                or ops.agg_leaves_launches != ops.agg_launches:
            raise AssertionError(f"10d: {topk} top-k launches for "
                                 f"{seen['spans']} spans shipped")
        check_topk_partial(ops, plain, seen, "10d resumed partial")
        ops.reset_topk_counts()
        r.update(topk_launches=topk, spans_shipped=seen["spans"],
                 fold_launches=ops.agg_launches)
        log(f"phase 10d async top-k 0.01 under the fault plan: killed in "
            f"round {r['killed_in_round']}, auto-resumed: params_digest "
            f"{r['digest'][:16]}, makespans {r['makespans']}, cohorts and "
            f"fault counters {r['fault_counters']} equal; {topk} top-k "
            f"launches for {seen['spans']} spans after the resume, kernel "
            f"== plain on the first; walls {r['ref_wall_s']:.2f} / "
            f"{r['resumed_wall_s']:.2f} s")
        return r
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_net_faults(T, ops, plain):
    t0 = time.perf_counter()
    net = phase_network(T, ops, plain)
    avail = phase_availability(T, ops)
    faults = phase_faults(T, ops)
    resume = phase_fault_resume(T, ops, plain)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return {"network": net, "availability": avail, "faults": faults,
            "resume": resume}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 11: placement, gang dispatch and collective comm
# ---------------------------------------------------------------------------

GANG_TIMED = 3        # timed rounds a variant, after one warm-up round
SHORT_TIMED = 1       # timed rounds of the nonblocking and parallel variants


def gang_server(T, device, placement=True, nonblocking=False, tick=True,
                **kw):
    """Phase 4's model, data and FedProx with 4 executors under a
    TickTimer (``tick=False``: the default timer, ``time.perf_counter``),
    pinned to ``device`` by a one-device placement (``placement=False``:
    none).  The TickTimer measures every block alike, so LPT hands each
    executor 4 of the 16 equal clients: one block of 4 a round, aligned
    waves for the gang."""
    algo = T.make_algorithm("fedprox", T.value_and_grad(mlp_loss), 0.05,
                            local_epochs=1)
    timer = T.TickTimer(1.0) if tick else None
    execs = [T.SequentialExecutor(k, algo, client_block=8, device=device,
                                  timer=timer, nonblocking=nonblocking)
             for k in range(4)]
    pl = (T.DevicePlacement(range(4), devices=[device]) if placement
          else None)
    return T.ParrotServer(params=mlp_params(), algorithm=algo,
                          executors=execs, data_by_client=mlp_clients(T),
                          clients_per_round=16, seed=0, device=device,
                          placement=pl, **kw)


class SyncCount:
    """While active, counts the executors' (and the gang's) synchronize
    calls."""

    def __enter__(self):
        from repro_torch.core import executor
        self.mod, self.inner, self.n = executor, executor.synchronize, 0

        def sync(device):
            self.n += 1
            return self.inner(device)

        executor.synchronize = sync
        return self

    def __exit__(self, *exc):
        self.mod.synchronize = self.inner


def record_queues(srv):
    """Keep every (round, queues) the scheduler hands out."""
    seen, inner = [], srv.scheduler.schedule

    def schedule(rnd, tasks, executors, **kw):
        s = inner(rnd, tasks, executors, **kw)
        seen.append((rnd, {k: [t.client for t in q]
                           for k, q in s.assignment.items()}))
        return s

    srv.scheduler.schedule = schedule
    return seen


def gang_rounds(T, srv, rounds, keep=None):
    """``rounds`` rounds, each timed on the host around work that ends in a
    synchronise: wall, client-steps/s, makespan, client-step dispatches
    (``ClientStepEngine.n_dispatches``) and synchronize calls; ``keep``
    (a list) receives a copy of the params after each round."""
    eng = T.engine_for(srv.algorithm, torch.device("cuda", 0))
    rows = []
    with SyncCount() as sc:
        for _ in range(rounds):
            d0, s0 = eng.n_dispatches, sc.n
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = srv.run_round()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rows.append({"round": m.round, "makespan_s": m.makespan,
                         "wall_s": wall,
                         "client_steps_per_s": m.n_clients * NB / wall,
                         "dispatches": eng.n_dispatches - d0,
                         "synchronize_calls": sc.n - s0,
                         "comm_bytes": m.comm_bytes})
            if keep is not None:
                keep.append({k: v.detach().clone()
                             for k, v in srv.params.items()})
    return rows


def gang_variant(T, ops, label, card, prepare=None, timed=GANG_TIMED,
                 **kw):
    """One phase-11 variant on the card: the warm-up and ``timed`` rounds
    (the fold counters set to 0 just before them and read just after), the
    params after them, then one device-only profiled round."""
    srv = gang_server(T, "cuda", **kw)
    if prepare is not None:
        prepare(srv)
    queues = record_queues(srv)
    ops.reset_agg_counts()
    params_at = []
    rows = gang_rounds(T, srv, 1 + timed, keep=params_at)
    launches = {"fold": ops.agg_launches, "leaves": ops.agg_leaves_launches}
    params = params_at[-1]
    prof = profile_round(srv)
    timed = rows[1:]
    walls = [r["wall_s"] for r in timed]
    log(f"phase 11 {label} [{card}]: timed round walls "
        f"{[round(w, 4) for w in walls]} s, client-steps/s "
        f"{[round(r['client_steps_per_s'], 1) for r in timed]}, "
        f"client-step dispatches {[r['dispatches'] for r in rows]} and "
        f"synchronize calls {[r['synchronize_calls'] for r in rows]} a "
        f"round (warm-up first), makespans "
        f"{[r['makespan_s'] for r in rows]}, fold launches "
        f"{launches['fold']} ({launches['leaves']} of the leaves form)")
    if prof is None:
        log(f"phase 11 {label} profile: the trace holds no device time "
            f"(not measured)")
    else:
        log(f"phase 11 {label} profile (one more round) [{card}]: wall "
            f"{prof['wall_s']:.3f} s, device busy "
            f"{prof['device_busy_s']:.4f} s, idle share "
            f"{prof['device_idle_share']:.3f}, {prof['kernel_launches']} "
            f"kernel launches, fold {prof['fold_kernels']} kernels "
            f"{prof['fold_device_s'] * 1e3:.4f} ms")
    return {"queues": queues, "rows": rows, "params": params,
            "params_at": params_at, "profile": prof,
            "fold_launches": launches,
            "median_wall_s": float(np.median(walls)),
            "median_client_steps_per_s": float(np.median(
                [r["client_steps_per_s"] for r in timed]))}


def bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def phase_gang_fold(T, ops, parts, card):
    """11(d): the placement's global fold on a round's four real partials:
    bit for bit the host left fold, one launch a fp32 weight group, and
    its device time beside K-1 ``torch.add``s."""
    from repro_torch.core import tree
    from repro_torch.core.placement import rank_ordered_reduce
    ops_ = {"delta": T.Op.WEIGHTED_AVG}
    groups = sorted(parts[0]["sums"]["buffers"])
    ref = T.global_aggregate(parts, ops_)
    pl = T.DevicePlacement(range(4), devices=["cuda"])
    ops.reset_agg_counts()
    got = pl.global_fold(parts, ops_)
    torch.cuda.synchronize()
    launches = ops.agg_launches
    if launches != len(groups):
        raise AssertionError(f"11d: {launches} fold launches for "
                             f"{len(groups)} weight groups")
    leaves_g, leaves_r = tree.leaves(got), tree.leaves(ref)
    if len(leaves_g) != len(leaves_r) or not all(
            bits_equal(a, b) for a, b in zip(leaves_g, leaves_r)):
        raise AssertionError("11d: the placement's fold differs from the "
                             "host left fold")
    bufs = [p["sums"]["buffers"][groups[0]] for p in parts]
    n = bufs[0].numel()
    timer = Timer()

    def adds():
        t = bufs[0]
        for b in bufs[1:]:
            t = t + b
        return t

    fold_ms = timer.ms(lambda: rank_ordered_reduce(bufs, bufs[0].device))
    add_ms = timer.ms(adds)
    bound, by = fold_bound_ms(n, len(bufs) - 1, 4)
    ops.reset_agg_counts()         # the timing's launches do not count
    log(f"phase 11d [{card}]: global fold of the 4 partials (n={n}): "
        f"{launches} launch for {len(groups)} weight group, bit for bit the "
        f"host left fold over {len(leaves_g)} leaves; kernel {fold_ms:.4f} "
        f"ms vs {len(bufs) - 1} torch.add {add_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by})")
    return {"launches": launches, "groups": len(groups), "n": n,
            "ms": fold_ms, "adds_ms": add_ms, "bound_ms": bound,
            "bound_by": by}


def phase_gang_comm(T, ops, serial_params, card):
    """11(e): BSP under ``CollectiveComm``: a round bills the broadcast
    once plus twice each partial's sums; params equal the ``LocalComm``
    run (11a's serial variant) bit for bit."""
    from repro_torch.comm import CollectiveComm
    from repro_torch.core.aggregation import payload_bytes
    comm = CollectiveComm()
    expect = {"b": 0}
    inner_b, inner_s = comm.broadcast, comm.executor_send

    def broadcast(payload, executors, tag):
        expect["b"] += payload_bytes(payload)
        return inner_b(payload, executors, tag)

    def executor_send(executor, payload, tag):
        expect["b"] += 2 * payload_bytes(payload["sums"])
        return inner_s(executor, payload, tag)

    comm.broadcast, comm.executor_send = broadcast, executor_send
    srv = gang_server(T, "cuda", placement=False, comm=comm)
    billed = []
    for _ in range(1 + GANG_TIMED):
        expect["b"] = 0
        m = srv.run_round()
        billed.append((m.comm_bytes, expect["b"]))
    if any(a != b for a, b in billed):
        raise AssertionError(f"11e: comm_bytes vs broadcast + 2 x partials: "
                             f"{billed}")
    if not all(bits_equal(srv.params[k], serial_params[k])
               for k in serial_params):
        raise AssertionError("11e: CollectiveComm params differ from the "
                             "LocalComm run")
    log(f"phase 11e [{card}]: CollectiveComm comm_bytes a round "
        f"{[a for a, _ in billed]} == the broadcast once + 2 x each "
        f"partial's sums; params equal the LocalComm run bit for bit")
    return {"comm_bytes": [a for a, _ in billed]}


def phase_gang_faults(T, ops, faults, card):
    """11(f): 10(c)'s first cell whose plan restarted an executor, under a
    one-device placement: the crash releases the pin, the restart re-pins
    through ``placement.pin``; card == CPU window by window under the
    TickTimer, and == 10(c)'s placement-free run."""
    cell = next(c for c in FAULT_CELLS
                if sum(r["fault_restarts"] for r in faults[
                    c[0] if c[1] is None else f"{c[0]} q{c[1]}"][
                        "fault_counters"]) > 0)
    engine, quorum = cell
    label = engine if quorum is None else f"{engine} q{quorum}"
    ref = faults[label]
    out = {}
    for device in ("cuda", "cpu"):
        pins, windows = [], []

        def prepare(srv, pins=pins):
            inner = srv.placement.pin

            def pin(k):
                d = inner(k)
                pins.append((srv.round, k, str(d)))
                return d

            srv.placement.pin = pin

        srv = fault_run(T, device, engine, quorum, FAULT_ROUNDS,
                        fault_plan(T, FAULT_SEED, ref["horizon_s"]),
                        placement=T.DevicePlacement(range(4),
                                                    devices=[device]),
                        prepare=prepare,
                        on_round=lambda r, m, w, win=windows: win.append(
                            window_key(m)))
        if device == "cuda":
            torch.cuda.synchronize()
        out[device] = {"windows": windows, "pins": pins,
                       "devices": {k: str(srv.placement.device(k))
                                   for k in srv.placement.executors()},
                       "executor_devices": {k: str(ex.device) for k, ex in
                                            srv.executors.items()}}
    got = out["cuda"]
    if not got["pins"]:
        raise AssertionError(f"11f {label}: no restart re-pinned")
    if got["windows"] != out["cpu"]["windows"]:
        raise AssertionError(f"11f {label}: card and CPU windows differ: "
                             f"{got['windows']} vs {out['cpu']['windows']}")
    if [w[1] for w in got["windows"]] != ref["makespans"]:
        raise AssertionError(f"11f {label}: makespans differ from 10(c)'s "
                             f"placement-free run")
    if any(got["devices"][k] != got["executor_devices"][k]
           for k in got["executor_devices"]):
        raise AssertionError(f"11f {label}: an executor is not on its pin")
    log(f"phase 11f {label} [{card}]: restarts re-pinned (round, executor,"
        f" device) {got['pins']}; placement.device(k) {got['devices']}; "
        f"card == CPU window by window over {FAULT_ROUNDS} rounds and == "
        f"10(c)'s placement-free makespans {ref['makespans']}")
    return {"cell": label, **got}


def rounds_ganged(rows, queues):
    """Per round: did it gang (one client-step dispatch a wave, a wave
    being every executor's i-th block of 8)?"""
    return [r["dispatches"] == max(-(-len(q) // 8) for q in qs.values())
            for r, (_, qs) in zip(rows, queues)]


def phase_gang_real_timer(T, card):
    """11(g): serial, gang and parallel dispatch under the default timer
    (``time.perf_counter``), as a user runs them: how many timed rounds
    ganged, each round's queue lengths, the makespans, and the per-client
    record times (``RunRecord.time``, what the estimator fits).  A
    measurement: nothing here is held to a bound."""
    out = {}
    for label, n_timed, kw in (
            ("serial", GANG_TIMED, {"placement": False}),
            ("gang", GANG_TIMED, {}),
            ("parallel", SHORT_TIMED, {"placement": False,
                                          "parallel_dispatch": True})):
        srv = gang_server(T, "cuda", tick=False, **kw)
        queues = record_queues(srv)
        rows = gang_rounds(T, srv, 1 + n_timed)
        timed = {r["round"] for r in rows[1:]}
        recs = [rec.time for rs in srv.estimator._records.values()
                for rec in rs if rec.round in timed]
        ganged = rounds_ganged(rows, queues)[1:]
        v = {"walls_s": [r["wall_s"] for r in rows[1:]],
             "makespans_s": [r["makespan_s"] for r in rows[1:]],
             "dispatches": [r["dispatches"] for r in rows],
             "queue_lengths": [sorted(len(q) for q in qs.values())
                               for _, qs in queues],
             "rounds_ganged": int(sum(ganged)),
             "record_time_median_s": float(np.median(recs)),
             "record_time_range_s": [float(min(recs)), float(max(recs))]}
        out[label] = v
        log(f"phase 11g {label}, default timer [{card}]: timed round walls "
            f"{[round(w, 4) for w in v['walls_s']]} s, makespans "
            f"{[round(m, 4) for m in v['makespans_s']]} s, queue lengths "
            f"{v['queue_lengths']} (warm-up first), client-step dispatches "
            f"{v['dispatches']}, {v['rounds_ganged']} of {n_timed} "
            f"timed rounds ganged, per-client record time median "
            f"{v['record_time_median_s'] * 1e3:.3f} ms (range "
            f"{v['record_time_range_s'][0] * 1e3:.3f}-"
            f"{v['record_time_range_s'][1] * 1e3:.3f} ms)")
    s, g = out["serial"], out["gang"]
    log(f"phase 11g [{card}]: gang / serial under the default timer: "
        f"median makespan {np.median(g['makespans_s']):.4f} / "
        f"{np.median(s['makespans_s']):.4f} s, median record time "
        f"{g['record_time_median_s'] * 1e3:.3f} / "
        f"{s['record_time_median_s'] * 1e3:.3f} ms (the gang charges each "
        f"lane the whole wave)")
    return out


def phase_gang(T, ops, card, faults):
    """Phase 11: (a) serial vs gang, (b) nonblocking, (c) parallel
    dispatch on streams, (d) the global fold on the fold kernel, (e)
    CollectiveComm, (f) a fault-plan restart re-pinned, (g) serial, gang
    and parallel under the default timer."""
    t_phase = time.perf_counter()
    ndev = torch.cuda.device_count()
    if ndev < 2:
        log(f"phase 11: {ndev} CUDA device: K-device cases not run")
    serial = gang_variant(T, ops, "(a) serial", card, placement=False)
    parts_box = []

    def capture(srv):
        """Keep the last round's partials, as the global fold gets them."""
        inner = srv.placement.global_fold

        def fold(partials, ops_):
            parts_box[:] = [partials]
            return inner(partials, ops_)

        srv.placement.global_fold = fold

    # 11a's gang rounds are the main path: gang_variant sets the fold
    # counters to 0 just before them and reads them just after
    gang = gang_variant(T, ops, "(a) gang", card, prepare=capture)
    # every timed round ganged: one client-step dispatch a wave (each
    # executor's queue is one block of 4: one wave a round); the warm-up
    # round under the serial count too
    waves = [max(-(-len(q) // 8) for q in qs.values())
             for _, qs in gang["queues"][1:1 + GANG_TIMED]]
    dispatches = [r["dispatches"] for r in gang["rows"]]
    if dispatches[1:] != waves or \
            dispatches[0] >= serial["rows"][0]["dispatches"]:
        raise AssertionError(f"11a: gang dispatches {dispatches} (warm-up "
                             f"first) vs waves {waves}: a round fell back "
                             f"to serial")
    if gang["fold_launches"]["fold"] <= 0 or \
            gang["fold_launches"]["leaves"] >= gang["fold_launches"]["fold"]:
        raise AssertionError(f"11a: fold launches {gang['fold_launches']}: "
                             f"expected the leaves form's and the global "
                             f"fold's rows form")
    if gang["queues"] != serial["queues"][:len(gang["queues"])] or \
            [r["makespan_s"] for r in gang["rows"]] != \
            [r["makespan_s"] for r in serial["rows"]]:
        raise AssertionError("11a: gang and serial schedules or makespans "
                             "differ under the TickTimer")
    err = max(float((gang["params"][k] - serial["params"][k]).abs().max())
              for k in serial["params"])
    for k in serial["params"]:
        torch.testing.assert_close(gang["params"][k], serial["params"][k],
                                   atol=1e-5, rtol=1e-5,
                                   msg=f"11a gang vs serial {k}")
    log(f"phase 11 (a) [{card}]: gang == serial schedules and makespans "
        f"exactly over {1 + GANG_TIMED} rounds; params max |gang - serial| "
        f"{err:.3g} <= 1e-5; median wall {gang['median_wall_s']:.4f} vs "
        f"{serial['median_wall_s']:.4f} s")
    nonblocking = gang_variant(T, ops, "(b) nonblocking", card,
                               nonblocking=True, gang_dispatch=False,
                               timed=SHORT_TIMED)
    # (b) and (c) run 1 + SHORT_TIMED rounds: each is held to serial's
    # params after as many
    ref = serial["params_at"][SHORT_TIMED]
    if not all(bits_equal(nonblocking["params"][k], ref[k]) for k in ref):
        raise AssertionError("11b: nonblocking params differ from serial")
    parallel = gang_variant(T, ops, "(c) parallel", card, placement=False,
                            parallel_dispatch=True, timed=SHORT_TIMED)
    perr = max(float((parallel["params"][k] - ref[k]).abs().max())
               for k in ref)
    for k in ref:
        torch.testing.assert_close(parallel["params"][k], ref[k], atol=1e-5,
                                   rtol=1e-5, msg=f"11c parallel {k}")
    log(f"phase 11 (b), (c) [{card}]: nonblocking params == serial bit for "
        f"bit; parallel params max |diff| {perr:.3g} <= 1e-5")
    fold = phase_gang_fold(T, ops, parts_box[0], card)
    comm = phase_gang_comm(T, ops, serial["params"], card)
    fault = phase_gang_faults(T, ops, faults, card)
    real_timer = phase_gang_real_timer(T, card)
    seconds = time.perf_counter() - t_phase
    log(f"phase 11: {seconds:.1f} s")

    def summary(v):
        return {k: v[k] for k in ("rows", "profile", "fold_launches",
                                  "median_wall_s",
                                  "median_client_steps_per_s")}

    return {"card": card, "devices": ndev,
            "serial": summary(serial), "gang": summary(gang),
            "nonblocking": summary(nonblocking),
            "parallel": summary(parallel), "gang_params_max_err": err,
            "parallel_params_max_err": perr,
            "gang_fold_launches": gang["fold_launches"]["fold"],
            "global_fold": fold, "collective": comm, "fault_repin": fault,
            "real_timer": real_timer, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 12: the control plane and telemetry
# ---------------------------------------------------------------------------

# examples/trace_round.py's engines and options
CTRL_ENGINES = {
    "bsp": {},
    "semi-sync": {"deadline_frac": 0.7, "over_select": 1.2, "chunk_size": 4},
    "async": {"staleness_lambda": 0.5, "chunk_size": 4},
}
CTRL_ROUNDS = 3        # the perf_counter rounds (12b); dynamic_env(4, 3)
CTRL_CHECKED = 2       # rounds card vs CPU under a TickTimer (12a)
GANG_DES_WINDOWS = 3   # windows a (engine, gang on/off) cell (12c)


def ctrl_run(T, device, engine, rounds, **kw):
    """``examples/trace_round.py``'s setting at full width: phase 4's model,
    data and executors under ``dynamic_env(4, 3)``, the uniform 2e5 / 1e6
    B/s link with 0.05 s latency, ``telemetry=True`` and
    ``ControlPlane.adaptive()``."""
    return full_width(T, device, rounds,
                      speed_model=T.dynamic_env(4, CTRL_ROUNDS),
                      round_engine=engine, engine_opts=CTRL_ENGINES[engine],
                      network=T.NetworkModel.uniform(
                          uplink_bps=2e5, downlink_bps=1e6, latency_s=0.05),
                      telemetry=True, control=T.ControlPlane.adaptive(),
                      **kw)


def ctrl_state(srv):
    """What a card run must reproduce on the CPU: the trace, the registry
    without ``host/`` and the controller trajectories."""
    tele = srv.telemetry
    return {"spans": list(tele.tracer.spans),
            "instants": list(tele.tracer.instants),
            "registry": tele.registry.snapshot(exclude=("host/",)),
            "trajectory": [(m.extra.get("staleness_lambda"),
                            m.extra.get("deadline_frac"))
                           for m in srv.history],
            "control": srv.control.state_dict()}


def phase_ctrl_check(T, ops, card, work):
    """12(a): each engine 2 rounds on the card and on the CPU under a
    TickTimer: traces, registries (without ``host/``) and controller
    trajectories identical; params after each round within 1e-4; each
    exported trace validates; every fold of the card run a leaves-form
    launch."""
    out = {}
    for engine in CTRL_ENGINES:
        runs, params = {}, {}
        for dev in ("cuda", "cpu"):
            got, box = [], {}

            def keep(r, m, wall, got=got, box=box):
                got.append({q: v.detach().cpu().clone()
                            for q, v in box["srv"].params.items()})

            if dev == "cuda":
                ops.reset_agg_counts()
            srv = ctrl_run(T, dev, engine, CTRL_CHECKED,
                           timer=T.TickTimer(1.0), on_round=keep,
                           prepare=lambda s, box=box: box.update(srv=s))
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = ops.agg_launches
                leaves = ops.agg_leaves_launches
            runs[dev], params[dev] = ctrl_state(srv), got
            if dev == "cuda":
                path = srv.telemetry.tracer.export(
                    os.path.join(work, f"trace_{engine}.json"))
                problems = T.validate_trace(path)
                if problems:
                    raise AssertionError(f"12a {engine}: exported trace "
                                         f"fails validation: {problems}")
        g, c = runs["cuda"], runs["cpu"]
        for key in g:
            if g[key] != c[key]:
                raise AssertionError(f"12a {engine}: card and CPU {key} "
                                     f"differ")
        if launches <= 0 or leaves != launches or ops.agg_leaf_copies:
            raise AssertionError(f"12a {engine}: {launches} fold launches, "
                                 f"{leaves} of the leaves form")
        for r in range(CTRL_CHECKED):
            for q, pc in params["cpu"][r].items():
                torch.testing.assert_close(params["cuda"][r][q], pc,
                                           atol=1e-4, rtol=1e-4,
                                           msg=f"12a {engine} round {r} {q}")
        errs = [max(float((params["cuda"][r][q] - pc).abs().max())
                    for q, pc in params["cpu"][r].items())
                for r in range(CTRL_CHECKED)]
        out[engine] = {"fold_launches": launches,
                       "spans": len(g["spans"]),
                       "instants": len(g["instants"]),
                       "trajectory": g["trajectory"],
                       "params_max_err": errs}
        log(f"phase 12a {engine} [{card}]: card == CPU under the TickTimer "
            f"over {CTRL_CHECKED} rounds: {len(g['spans'])} spans, "
            f"{len(g['instants'])} instants, the registry without host/ "
            f"and the (λ, deadline_frac) trajectory {g['trajectory']} "
            f"identical; the exported trace validates; params within 1e-4 "
            f"after each round (max |diff| {[float(f'{e:.3g}') for e in errs]}"
            f"); {launches} fold launches, all of the leaves form")
    return out


def phase_ctrl_timed(T, ops, card):
    """12(b): each engine 3 rounds on the card under the default timer
    (``perf_counter``): per round the per-executor busy/comm/idle
    fractions, λ and deadline_frac, the host ms of ``Telemetry.on_round``
    and the spans and instants it emitted."""
    out = {}
    for engine in CTRL_ENGINES:
        rows = []
        seen = {"spans": 0, "instants": 0, "on_round_ms": []}

        def prepare(srv, seen=seen):
            inner = srv.telemetry.on_round

            def on_round(s, metrics, t0):
                h0 = time.perf_counter()
                inner(s, metrics, t0)
                seen["on_round_ms"].append(
                    (time.perf_counter() - h0) * 1e3)

            srv.telemetry.on_round = on_round
            seen["srv"] = srv

        def on_round(r, m, wall, rows=rows, seen=seen):
            tr = seen["srv"].telemetry.tracer
            util = {k: {f: round(v, 4) for f, v in u.items()}
                    for k, u in m.extra["utilization"].items()}
            rows.append({"round": r, "wall_s": wall, "makespan_s": m.makespan,
                         "utilization": m.extra["utilization"],
                         "staleness_lambda": m.extra.get("staleness_lambda"),
                         "deadline_frac": m.extra.get("deadline_frac"),
                         "on_round_ms": seen["on_round_ms"][-1],
                         "spans": len(tr.spans) - seen["spans"],
                         "instants": len(tr.instants) - seen["instants"]})
            seen["spans"], seen["instants"] = len(tr.spans), len(tr.instants)
            log(f"phase 12b {engine} round {r} [{card}]: wall {wall:.3f} s, "
                f"virtual makespan {m.makespan:.4f} s, λ "
                f"{rows[-1]['staleness_lambda']}, deadline_frac "
                f"{rows[-1]['deadline_frac']}, on_round "
                f"{rows[-1]['on_round_ms']:.3f} ms, {rows[-1]['spans']} "
                f"spans and {rows[-1]['instants']} instants emitted; "
                f"busy/comm/idle by executor {util}")

        ctrl_run(T, "cuda", engine, CTRL_ROUNDS, on_round=on_round,
                 prepare=prepare)
        torch.cuda.synchronize()
        ms = [r["on_round_ms"] for r in rows]
        out[engine] = {"rows": rows, "on_round_ms_first": ms[0],
                       "on_round_ms_last": ms[-1]}
        log(f"phase 12b {engine} [{card}]: Telemetry.on_round host "
            f"{ms[0]:.3f} ms at round 1, {ms[-1]:.3f} ms at round "
            f"{len(ms)} (utilization walks every span of the run)")
    return out


class GangWaves:
    """While active, records every DES gang wave the engines try: (round,
    lanes, ganged, client-step dispatches it made)."""

    def __init__(self):
        from repro_torch.core import engine as eng_mod
        self.mod, self.eng, self.waves = eng_mod, None, []

    def __enter__(self):
        inner = self.inner = self.mod.run_queues_ganged

        def gang(executors, rnd, queues, *a, **kw):
            d0 = self.eng.n_dispatches
            reps = inner(executors, rnd, queues, *a, **kw)
            self.waves.append({"round": rnd, "lanes": len(queues),
                               "ganged": reps is not None,
                               "dispatches": self.eng.n_dispatches - d0})
            return reps

        self.mod.run_queues_ganged = gang
        return self

    def __exit__(self, *exc):
        self.mod.run_queues_ganged = self.inner


def phase_ctrl_gang(T, ops, card):
    """12(c): semi-sync and async with ``gang_waves`` off and on, under a
    one-device placement, no network and a TickTimer: gang == serial in
    makespans exactly, params within 1e-6; per window the client-step
    dispatches and fold launches; every ganged wave one dispatch; one
    profiled window of the semi-sync gang."""
    out = {}
    for engine in ("semi-sync", "async"):
        cell = {}
        for gang in (False, True):
            rows, box, waves = [], {}, GangWaves()

            def prepare(srv, box=box, waves=waves):
                # the executors' client-step engine on the card
                box["eng"] = waves.eng = T.engine_for(
                    srv.algorithm, torch.device("cuda", 0))
                box["d"], box["f"] = 0, 0

            def on_window(w, m, wall, rows=rows, box=box):
                torch.cuda.synchronize()
                d = box["eng"].n_dispatches
                rows.append({"window": w, "wall_s": wall,
                             "makespan_s": m.makespan,
                             "dispatches": d - box["d"],
                             "fold_launches": ops.agg_launches - box["f"]})
                box["d"], box["f"] = d, ops.agg_launches

            ops.reset_agg_counts()
            with waves:
                srv = des_full_width(
                    T, "cuda", engine, GANG_DES_WINDOWS, on_round=on_window,
                    timer=T.TickTimer(1.0), prepare=prepare,
                    placement=T.DevicePlacement(range(4), devices=["cuda"]),
                    control=T.ControlPlane(gang_waves=gang))
                torch.cuda.synchronize()
            launches = ops.agg_launches
            params = {q: v.detach().clone() for q, v in srv.params.items()}
            # one profiled window: the semi-sync gang's
            prof = (profile_round(srv) if gang and engine == "semi-sync"
                    else None)
            ops.reset_agg_counts()     # the profile's launches do not count
            cell["on" if gang else "off"] = {
                "rows": rows, "waves": waves.waves, "params": params,
                "fold_launches": launches, "profile": prof}
            label = "gang" if gang else "serial"
            log(f"phase 12c {engine} {label} [{card}]: per window "
                f"client-step dispatches {[r['dispatches'] for r in rows]}, "
                f"fold launches {[r['fold_launches'] for r in rows]}, walls "
                f"{[round(r['wall_s'], 4) for r in rows]} s, makespans "
                f"{[r['makespan_s'] for r in rows]}; gang waves tried "
                f"{len(waves.waves)}, ganged "
                f"{sum(w['ganged'] for w in waves.waves)}")
            if prof is not None:
                log(f"phase 12c {engine} gang profile (one more window) "
                    f"[{card}]: wall {prof['wall_s']:.3f} s, device busy "
                    f"{prof['device_busy_s']:.4f} s, idle share "
                    f"{prof['device_idle_share']:.3f}, "
                    f"{prof['kernel_launches']} kernel launches")
        on, off = cell["on"], cell["off"]
        ganged = [w for w in on["waves"] if w["ganged"]]
        if not ganged or any(w["dispatches"] != 1 for w in ganged):
            raise AssertionError(f"12c {engine}: ganged waves {on['waves']}:"
                                 f" expected at least one, each exactly one "
                                 f"client-step dispatch")
        if off["waves"]:
            raise AssertionError(f"12c {engine}: gang_waves off tried "
                                 f"{off['waves']}")
        if [r["makespan_s"] for r in on["rows"]] != \
                [r["makespan_s"] for r in off["rows"]]:
            raise AssertionError(f"12c {engine}: gang and serial makespans "
                                 f"differ")
        if on["fold_launches"] <= 0:
            raise AssertionError(f"12c {engine}: no fold launch")
        err = max(float((on["params"][q] - p).abs().max())
                  for q, p in off["params"].items())
        for q, p in off["params"].items():
            torch.testing.assert_close(on["params"][q], p, atol=1e-6,
                                       rtol=1e-6, msg=f"12c {engine} {q}")
        for v in (on, off):
            del v["params"]
        out[engine] = {**cell, "params_max_err": err,
                       "ganged_waves": len(ganged)}
        log(f"phase 12c {engine} [{card}]: gang == serial makespans "
            f"exactly over {GANG_DES_WINDOWS} windows, params max |diff| "
            f"{err:.3g} <= 1e-6; {len(ganged)} ganged waves, each one "
            f"client-step dispatch")
    return out


def phase_ctrl(T, ops, card):
    """Phase 12: (a) telemetry and adaptive control card == CPU, (b) the
    same engines under the default timer, (c) the DES gang wave."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_traces_") as work:
        check = phase_ctrl_check(T, ops, card, work)
    timed = phase_ctrl_timed(T, ops, card)
    gang = phase_ctrl_gang(T, ops, card)
    seconds = time.perf_counter() - t0
    log(f"phase 12: {seconds:.1f} s")
    return {"check": check, "timed": timed, "gang": gang,
            "seconds": seconds}


def phase_seconds(n, t0):
    """Log phase ``n``'s seconds since ``t0``; return the time now."""
    t = time.perf_counter()
    log(f"phase {n}: {t - t0:.1f} s")
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch.core as T
    from repro_torch.data import (make_classification_clients,
                                  make_classification_population)
    from repro_torch.kernels import _build, ops
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tree
    from repro_torch.kernels.agg_weighted_sum import agg_weighted_sum_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm import ROUTES as RMS_ROUTES
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    from repro_torch.kernels.rmsnorm import route as rms_route
    from repro_torch.kernels.ssm_scan import ssm_scan_plain
    from repro_torch.kernels.topk_compress import blocks as topk_blocks
    from repro_torch.kernels.topk_compress import topk_with_residual_plain
    from repro_torch.launch.serve import generate, make_prompt
    from repro_torch.models import lm

    t_start = time.perf_counter()
    t_ph = time.perf_counter()
    card = phase_card()
    t_ph = phase_seconds(1, t_ph)
    t0 = time.perf_counter()
    paths = _build.build(["agg_weighted_sum", "topk_compress",
                          "flash_attention", "ssm_scan", "rmsnorm"])
    log(f"phase 2: built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log(f"--- nvcc -Xptxas -v for {name} ---")
        log(open(str(path) + ".log").read().strip())
    max_err = phase_kernel_grid(ops, agg_weighted_sum_plain)
    leaves_err = phase_leaves_grid(T, ops, agg_weighted_sum_plain)
    timings = phase_kernel_timing(T, ops, agg_weighted_sum_plain)
    topk_err = phase_topk_grid(ops, topk_with_residual_plain)
    topk_t = phase_topk_timing(ops, topk_with_residual_plain, topk_blocks)
    t_ph = phase_seconds(2, t_ph)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        qs_launches = phase_quickstart(T, make_classification_clients, ops,
                                       work)
    qs_topk_launches = phase_quickstart_topk(T, make_classification_clients,
                                             ops)
    t_ph = phase_seconds(3, t_ph)
    fw_launches, fw_leaves, fw_rows, fw_prof, fw_block = \
        phase_full_width(T, ops)
    t_ph = phase_seconds(4, t_ph)
    c_launches, c_rows, c_prof, c_check = phase_full_width_topk(
        T, ops, topk_with_residual_plain)
    t_ph = phase_seconds(5, t_ph)
    flash_err = phase_flash_grid(ops, flash_attention_plain)
    flash_t = phase_flash_timing(ops, flash_attention_plain)
    serve = phase_serve(ops, lm, tree, generate, make_prompt,
                        get_arch("qwen2-0.5b"))
    q_launch = serve["launches"]
    t_ph = phase_seconds(6, t_ph)
    scan_err = phase_scan_grid(ops, ssm_scan_plain)
    rms_err = phase_rms_grid(ops, rmsnorm_plain, rms_route, RMS_ROUTES)
    rec_t = phase_recurrent_timing(ops, ssm_scan_plain, rmsnorm_plain,
                                   rms_route, flash_attention_plain)
    h_serve, x_serve = phase_recurrent_serve(
        ops, lm, tree, generate, make_prompt, get_arch("hymba-1.5b"),
        get_arch("xlstm-125m"))
    h_launch, x_launch = h_serve["launches"], x_serve["launches"]
    phase_seconds(7, t_ph)
    des = phase_des(T, make_classification_clients, ops,
                    topk_with_residual_plain)
    des_fold = {e: des["full_width"][e]["fold_launches"] for e in DES_FULL}
    ckpt = phase_ckpt(T, ops, topk_with_residual_plain,
                      make_classification_population)
    ckpt_fold = {e: ckpt["checkpoint"][e]["fold_launches"]
                 for e in CKPT_ENGINES}
    nf = phase_net_faults(T, ops, topk_with_residual_plain)
    nf_runs = nf["network"]["runs"]
    gang = phase_gang(T, ops, card, nf["faults"])
    ctrl = phase_ctrl(T, ops, card)

    main_t = next(t for t in timings if (t["n"], t["C"]) == MAIN_SHAPE)
    rms_main = next(t for t in rec_t["rmsnorm"]
                    if (t["shape"]["T"], t["shape"]["d"]) == RMS_SERVE)
    record = {"kernels": [{
        "name": "agg_weighted_sum",
        "route": "cuda",
        "compute_units": "CUDA cores",
        "source": "src/repro_torch/kernels/csrc/agg_weighted_sum.cu",
        "replaces": "src/repro/kernels/agg_weighted_sum.py:30",
        "launches": fw_launches,
        "leaves_launches": fw_leaves,
        "max_abs_err": max(max_err, leaves_err),
        "max_abs_err_by_form": {"rows": max_err, "leaves": leaves_err},
        "ms": main_t["ms"],
        "time_ms": main_t["ms"],
        "warm_ms": main_t["warm_ms"],
        "host_ms": main_t["host_ms"],
        "bound_share": main_t["bound_share"],
        "rows_ms": main_t["rows_ms"],
        "rows_warm_ms": main_t["rows_warm_ms"],
        "rows_host_ms": main_t["rows_host_ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "copy_ms": main_t["copy_ms"],
        "segments": main_t["segments"],
        "shape": {"n": main_t["n"], "C": main_t["C"],
                  "dtype": main_t["dtype"]},
        "quickstart_launches": qs_launches,
        "topk_quickstart_launches": qs_topk_launches["agg_weighted_sum"],
        "compressed_full_width_launches": c_launches["agg_weighted_sum"],
        "timings": timings,
        "full_width_rounds": fw_rows,
        "full_width_profile": fw_prof,
        "fold_block": fw_block,
        "des_quickstart_launches": {e: des["quickstart"][e]["fold_launches"]
                                    for e in DES_QUICKSTART},
        "des_full_width_launches": des_fold,
        "des": des,
        "checkpoint_resume_launches": ckpt_fold,
        "population_launches": ckpt["population"]["fold_launches"],
        "checkpoint": ckpt,
        "network_launches": {k: v["fold_launches"]
                             for k, v in nf_runs.items()},
        "availability_launches": {k: v["fold_launches"] for k, v in
                                  nf["availability"].items()},
        "fault_launches": {k: v["fold_launches"]
                           for k, v in nf["faults"].items()
                           if k != "totals"},
        "fault_resume_launches": nf["resume"]["fold_launches"],
        "network_faults": nf,
        "gang_launches": gang["gang_fold_launches"],
        "global_fold": gang["global_fold"],
        "placement": gang,
        "control_telemetry_launches": {
            e: v["fold_launches"] for e, v in ctrl["check"].items()},
        "des_gang_launches": {e: v["on"]["fold_launches"]
                              for e, v in ctrl["gang"].items()},
        "control_telemetry": ctrl,
    }, {
        "name": "topk_compress",
        "route": "cuda",
        "compute_units": "CUDA cores",
        "source": "src/repro_torch/kernels/csrc/topk_compress.cu",
        "replaces": "src/repro/kernels/topk_compress.py:47",
        "launches": c_launches["topk_compress"],
        "max_abs_err": topk_err,
        "ms": topk_t["ms"],
        "time_ms": topk_t["ms"],
        "host_ms": topk_t["host_ms"],
        "plain_ms": topk_t["plain_ms"],
        "bound_ms": topk_t["bound_ms"],
        "bound_by": topk_t["bound_by"],
        "library_ms": topk_t["library_ms"],
        "library_call": "torch.topk(|f|, k): selection only, tie rule "
                        "unpinned",
        "shape": {"n": topk_t["n"], "k": topk_t["k"]},
        "timing": topk_t,
        "kernels_per_call": topk_t["kernels_per_call"],
        "memsets_per_call": topk_t["memsets_per_call"],
        "round_device_ms": (None if c_prof is None
                            else c_prof["topk_device_s"] * 1e3),
        "quickstart_launches": qs_topk_launches["topk_compress"],
        "compressed_full_width_rounds": c_rows,
        "compressed_full_width_profile": c_prof,
        "card_vs_cpu": c_check,
        "des_async_launches": des["full_width"]["async_topk"]["topk_launches"],
        "checkpoint_resume_launches":
            ckpt["checkpoint"]["async"]["topk_launches"],
        "network_launches": {k: v["topk_launches"]
                             for k, v in nf_runs.items()},
        "fault_resume_launches": nf["resume"]["topk_launches"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "compute_units": "tensor cores (wgmma, TMA loads) for bf16, the main "
                         "path; CUDA cores (exact fp32) for fp32",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": q_launch["prefill"][0] + q_launch["decode"][0],
        "max_abs_err": max(flash_err.values()),
        "max_abs_err_by_dtype": flash_err,
        "ms": flash_t["ms"],
        "time_ms": flash_t["ms"],
        "host_ms": flash_t["host_ms"],
        "plain_ms": flash_t["plain_ms"],
        "bound_ms": flash_t["bound_ms"],
        "bound_by": flash_t["bound_by"],
        "library_ms": flash_t["library_ms"],
        "library_call": "torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True, enable_gqa=True) on (B, H, S, hd) "
                        "views of the same inputs",
        "kernel_over_library": flash_t["kernel_over_library"],
        "shape": flash_t["shape"],
        "timing": flash_t,
        "serving": serve,
        "hymba_prefill_launches": h_launch["prefill"][0],
        "hymba_timing": rec_t["flash_hymba"],
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "compute_units": "tensor cores (mma.sync bf16) when q, k, v are all "
                         "bf16 (hymba, the main path); CUDA cores (fp32) "
                         "otherwise (xlstm's fp32 k)",
        "launches_per_call": rec_t["ssm_scan_hymba"]["launches_per_call"],
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:22",
        "launches": h_launch["prefill"][1] + h_launch["decode"][1],
        "max_abs_err": max(scan_err.values()),
        "max_abs_err_by_output": scan_err,
        "ms": rec_t["ssm_scan_hymba"]["ms"],
        "time_ms": rec_t["ssm_scan_hymba"]["ms"],
        "host_ms": rec_t["ssm_scan_hymba"]["host_ms"],
        "plain_ms": rec_t["ssm_scan_hymba"]["plain_ms"],
        "bound_ms": rec_t["ssm_scan_hymba"]["bound_ms"],
        "bound_by": rec_t["ssm_scan_hymba"]["bound_by"],
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the scan",
        "shape": rec_t["ssm_scan_hymba"]["shape"],
        "timing": rec_t["ssm_scan_hymba"],
        "xlstm_timing": rec_t["ssm_scan_xlstm"],
        "xlstm_launches": x_launch["prefill"][1] + x_launch["decode"][1],
        "serving_hymba": h_serve,
        "serving_xlstm": x_serve,
    }, {
        "name": "rmsnorm",
        "route": "cuda",
        "compute_units": "CUDA cores",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:17",
        "launches": h_launch["prefill"][2] + h_launch["decode"][2],
        "max_abs_err": max(rms_err.values()),
        "max_abs_err_by_dtype": rms_err,
        "ms": rms_main["ms"],
        "time_ms": rms_main["ms"],
        "host_ms": rms_main["host_ms"],
        "plain_ms": rms_main["plain_ms"],
        "bound_ms": rms_main["bound_ms"],
        "bound_by": rms_main["bound_by"],
        "library_ms": rms_main["library_ms"],
        "library_call": "torch.nn.functional.rms_norm(x, (d,), g, 1e-5)",
        "shape": rms_main["shape"],
        "route_taken": rms_main["route"],
        "timings": rec_t["rmsnorm"],
        "qwen_launches": q_launch["prefill"][2] + q_launch["decode"][2],
        "xlstm_launches": x_launch["prefill"][2] + x_launch["decode"][2],
    }]}
    log(f"chip_smoke: all phases held in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

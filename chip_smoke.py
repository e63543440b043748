#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on any mismatch):

1. Card identity: ``nvidia-smi`` name and power limit; TF32 off for
   matrix products and cuDNN, so fp32 means fp32 on the card.
2. Every kernel of the main path is built from ``src/repro_torch/kernels/
   csrc`` and held against its plain PyTorch version on the card, over a
   grid of shapes and dtypes, in every call form; then timed with CUDA
   events at the main path's shapes beside its plain version, the one
   PyTorch call that computes the same function, and its memory bound.
3. The quickstart configuration (100 clients, 4 executors, 20 per round)
   under a ``TickTimer``, on the card and on the CPU: 10 FedAvg rounds,
   then 3 SCAFFOLD rounds with a spilling ``ClientStateManager`` and an
   executor failure.  Makespan histories must be identical, params
   allclose.
4. The full-width client model of ``benchmarks/bench_client_training.py``
   (a 142-leaf MLP, 1,207,440 params) under FedProx: 3 BSP rounds on the
   card, timed, and the same rounds on the CPU for the params check.

Phases 3 and 4 are the main path: kernel launch counters are set to 0 just
before each and read just after, and every kernel of the path must have
launched.  The second-to-last line is the ``{"kernels": [...]}`` record;
the last line is ``{"ok": true, "device": {...}}``.
"""
import json
import os
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

    def ms(self, fn, reps=30, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
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

    def host_ms(self, fn, reps=30):
        """Median host time to issue ``fn`` (the device kept busy, so the
        call never waits on it)."""
        times = []
        for _ in range(reps):
            torch.cuda._sleep(self.SPIN_CYCLES)
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
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


def phase_kernel_timing(ops, plain):
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    shapes = [(1207440, C, torch.float32) for C in (1, 2, 4, 8, 16)]
    shapes += [(1207440, 8, torch.bfloat16), (1 << 25, 16, torch.float32),
               (1 << 25, 16, torch.bfloat16)]
    for n, C, dt in shapes:
        acc = torch.randn(n, device="cuda", generator=gen)
        D = torch.randn(C, n, device="cuda", generator=gen).to(dt)
        w = np.linspace(0.5, 2.0, C).tolist()
        wt = torch.tensor(w, dtype=torch.float32, device="cuda")
        work = acc.clone()
        k_ms = timer.ms(lambda: ops.agg_weighted_sum(work, D, w,
                                                     inplace=True))
        host_ms = timer.host_ms(lambda: ops.agg_weighted_sum(work, D, w,
                                                             inplace=True))
        p_ms = timer.ms(lambda: plain(acc, D, w))
        lib_ms = None
        if dt == torch.float32:     # yardstick only: the port never calls it
            lib_ms = timer.ms(lambda: torch.addmv(acc, D.t(), wt))
        bound, by = fold_bound_ms(n, C, D.element_size())
        row = {"n": n, "C": C, "dtype": str(dt).replace("torch.", ""),
               "ms": k_ms, "host_ms": host_ms, "plain_ms": p_ms,
               "library_ms": lib_ms,
               "bound_ms": bound, "bound_by": by}
        rows.append(row)
        log(f"phase 2 timing: n={n} C={C} {row['dtype']}: kernel "
            f"{k_ms:.4f} ms (wrapper host time {host_ms:.4f} ms), plain "
            f"{p_ms:.4f} ms, torch.addmv "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound:.4f} ms ({by}); kernel at "
            f"{100 * bound / k_ms:.1f}% of the bound")
        del acc, D, work
    ops.reset_agg_counts()         # comparison launches do not count
    return rows


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
    examples/stateful_scaffold.py wiring (SCAFFOLD, 3 rounds, state spilled
    to disk, executor 5 failing in round 2), both under TickTimer(1.0)."""
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
    srv2 = T.ParrotServer(params={"w": torch.zeros(16, 8),
                                  "b": torch.zeros(8)},
                          algorithm=algo2, executors=execs2,
                          data_by_client=data2, clients_per_round=50, seed=0,
                          device=device)
    scaffold = [srv2.run_round() for _ in range(3)]
    return fedavg, scaffold, srv.params, srv2.params, sm2


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
        f"SCAFFOLD makespans {[m.makespan for m in sc_g]} identical on card "
        f"and CPU; params allclose (1e-5); fold launches {launches}; "
        f"wall {t_gpu:.2f} s card, {t_cpu:.2f} s CPU")
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


def full_width(T, device, rounds, on_round=None):
    algo = T.make_algorithm("fedprox", T.value_and_grad(mlp_loss), 0.05,
                            local_epochs=1)
    execs = [T.SequentialExecutor(k, algo, client_block=8, device=device)
             for k in range(4)]
    srv = T.ParrotServer(params=mlp_params(), algorithm=algo,
                         executors=execs, data_by_client=mlp_clients(T),
                         clients_per_round=16, seed=0, device=device)
    for r in range(rounds):
        t0 = time.perf_counter()
        m = srv.run_round()
        if on_round is not None:
            on_round(r, m, time.perf_counter() - t0)
    return srv


def profile_round(srv):
    """Device busy share and kernel time by name over one more full-width
    round, from torch.profiler (CUPTI).  None where the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    fold_us = sum(e.self_device_time_total for e in kernels
                  if "agg_weighted_sum" in e.key)
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernel_launches": int(sum(e.count for e in kernels)),
            "fold_device_s": fold_us / 1e6,
            "top_kernels": [{"name": e.key[:80], "count": int(e.count),
                             "device_s": e.self_device_time_total / 1e6}
                            for e in top]}


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
    if launches <= 0:
        raise AssertionError("full-width rounds launched no fold kernel")
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
        f"fold launches {launches}")
    return launches, rows, prof


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch.core as T
    from repro_torch.data import make_classification_clients
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.agg_weighted_sum import agg_weighted_sum_plain

    phase_card()
    t0 = time.perf_counter()
    paths = _build.build(["agg_weighted_sum"])
    log(f"phase 2: built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log(f"--- nvcc -Xptxas -v for {name} ---")
        log(open(str(path) + ".log").read().strip())
    max_err = phase_kernel_grid(ops, agg_weighted_sum_plain)
    timings = phase_kernel_timing(ops, agg_weighted_sum_plain)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        qs_launches = phase_quickstart(T, make_classification_clients, ops,
                                       work)
    fw_launches, fw_rows, fw_prof = phase_full_width(T, ops)

    main_t = next(t for t in timings if (t["n"], t["C"]) == MAIN_SHAPE)
    record = {"kernels": [{
        "name": "agg_weighted_sum",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/agg_weighted_sum.cu",
        "replaces": "src/repro/kernels/agg_weighted_sum.py:30",
        "launches": fw_launches,
        "max_abs_err": max_err,
        "ms": main_t["ms"],
        "time_ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "shape": {"n": main_t["n"], "C": main_t["C"],
                  "dtype": main_t["dtype"]},
        "quickstart_launches": qs_launches,
        "timings": timings,
        "full_width_rounds": fw_rows,
        "full_width_profile": fw_prof,
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Dry run: trace every (arch × shape × mesh) cell's step once on abstract
tensors and write its per-device cost.

Port of ``repro/launch/dryrun.py``.  Where the JAX package lowers and
compiles each cell for the 256- / 512-chip production meshes, the port
runs the step once over DTensors whose shards are meta tensors, on a fake
process group of as many ranks (``launch/mesh.py``), under the dispatch
trace of ``launch/hlo_analysis.py``: sharding mismatches, ops that DTensor
cannot shard and data-dependent ops all fail here, and nothing is
allocated or launched.  One JSON a cell under ``results/dryrun_torch/``,
with the JAX record's keys (``trace_s`` in place of ``lower_s`` /
``compile_s``; no XLA cost analysis exists, so ``xla_*`` repeat the
trace's counts).

``run_cell(..., execute=True)`` also runs the step for real on a
one-device mesh (on ``device``, the card unless the caller passes a CPU
device) at the shape the caller cuts to, under the same counter, and
records its FLOPs, argument bytes and peak allocation beside the trace's.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--arch-filter moe] [--mesh DATA,MODEL]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs.base import ALL_SHAPES, shape_by_name
from repro_torch.configs.registry import ARCHS, cell_is_runnable, get_arch
from repro_torch.kernels import ops
from repro_torch.launch.hlo_analysis import (DispatchTrace, collective_stats,
                                             compute_stats, count_alltoalls,
                                             memory_stats)
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import make_production_mesh, use_mesh
from repro_torch.sharding import specs as shard_specs

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def trace_step(spec, device_type: str = "meta"):
    """Run ``spec``'s step once under a :class:`DispatchTrace` ->
    (trace, outputs, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication
    trace = DispatchTrace(device_type)
    t0 = time.perf_counter()
    with implicit_replication(), trace, count_alltoalls(trace):
        out = spec.step_fn(*spec.args)
    if device_type == "cuda":
        torch.cuda.synchronize()
    return trace, out, time.perf_counter() - t0


def _tag(arch: str, shape_name: str, multi_pod: bool, mesh) -> str:
    if mesh is None:
        where = "multipod" if multi_pod else "pod"
    else:
        where = "x".join(str(n) for n in mesh.sizes)
    return f"{arch}__{shape_name}__{where}"


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: str = RESULTS_DIR, verbose: bool = True,
             overrides: Optional[dict] = None, mesh=None, *,
             shape_overrides: Optional[dict] = None, execute: bool = False,
             device: str = "cuda:0", seed: int = 0) -> dict:
    """Trace one cell and write its record.  ``mesh``: a ``MeshShape`` in
    place of the production mesh; ``overrides`` / ``shape_overrides``:
    fields of the config / the shape to replace; ``execute``: also run the
    step for real on ``device`` (a one-device mesh only)."""
    cfg = get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape_by_name(shape_name)
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    ok, why = cell_is_runnable(cfg, shape)
    tag = _tag(arch, shape_name, multi_pod, mesh)
    if not ok:
        rec = {"cell": tag, "status": "skipped", "reason": why}
        _save(rec, out_dir, tag)
        if verbose:
            print(f"[dryrun] {tag}: SKIP ({why})")
        return rec

    plan = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    rec = {"cell": tag, "arch": arch, "shape": shape_name,
           "multi_pod": multi_pod,
           "mesh": dict(zip(plan.names, plan.sizes))}
    try:
        if execute and plan.size != 1:
            raise ValueError("execute=True runs on a one-device mesh")
        with use_mesh(plan) as dmesh:
            shard_specs.enable_activation_policy(dmesh)
            try:
                spec = input_specs(cfg, shape, dmesh)
                trace, out, t_trace = trace_step(spec)
                mem = memory_stats(trace, spec.args, out,
                                   spec.donate_argnums, spec.unused_argnums)
                step_desc = spec.static_desc
                del out, spec
            finally:
                shard_specs.enable_activation_policy(None)
        comp = compute_stats(trace)
        coll = collective_stats(trace)
        rec.update({
            "status": "ok",
            "step": step_desc,
            "trace_s": round(t_trace, 2),
            "n_devices": plan.size,
            "memory": mem,
            # no XLA cost analysis: the trace counts every op as it runs
            "xla_flops_per_device": comp["flops_per_device"],
            "xla_bytes_per_device": comp["bytes_per_device_est"],
            "flops_per_device": comp["flops_per_device"],
            "bytes_per_device": comp["bytes_per_device_est"],
            "collectives": coll,
            "model": {"n_params": cfg.n_params(),
                      "n_active_params": cfg.n_active_params()},
        })
        if execute:
            rec["execute"] = execute_step(cfg, shape, plan, device, seed)
        if verbose:
            print(f"[dryrun] {tag}: OK  trace {t_trace:.1f}s")
            print(f"  memory: {rec['memory']}")
            print(f"  flops/dev={rec['flops_per_device']:.3e} "
                  f"bytes/dev={rec['bytes_per_device']:.3e}")
            print(f"  collectives: {coll['summary']}")
            if execute:
                print(f"  execute: {rec['execute']}")
    except Exception as e:  # noqa: BLE001 -- report and continue the sweep
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[dryrun] {tag}: ERROR {type(e).__name__}: {e}")
    _save(rec, out_dir, tag)
    return rec


def execute_step(cfg, shape, plan, device: str, seed: int = 0) -> dict:
    """Run the cell's step once for real on ``device`` (one-device mesh)
    under the dispatch counter: its FLOPs, bytes, argument bytes, the
    kernels it launched and, on the card, its peak allocation (raw, and
    less what was allocated before its arguments were built)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)      # what earlier work holds
    spec = input_specs(cfg, shape, plan, device=str(dev), seed=seed)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = ops.launch_counts()
    trace, out, secs = trace_step(spec, dev.type)
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    mem = memory_stats(trace, spec.args, out, spec.donate_argnums,
                       spec.unused_argnums)
    return {
        "device": str(dev),
        "flops": float(trace.flops),
        "bytes_est": float(trace.bytes),
        "argument_size_in_bytes": mem["argument_size_in_bytes"],
        "max_memory_allocated": (int(torch.cuda.max_memory_allocated(dev))
                                 if cuda else None),
        # the step's own peak: its arguments and what it allocated
        "peak_allocated": (int(torch.cuda.max_memory_allocated(dev)) - held
                           if cuda else None),
        "launches": launches,
        "seconds": round(secs, 4),
    }


def _save(rec: dict, out_dir: str, tag: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def _parse_mesh(text: str):
    from repro_torch.launch.mesh import make_fake_mesh
    data, model = (int(x) for x in text.split(","))
    return make_fake_mesh(data, model)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--arch-filter", default="")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="a (data, model) fake mesh in place of the "
                         "production ones")
    args = ap.parse_args(argv)

    if args.mesh:
        meshes = [(False, _parse_mesh(args.mesh))]
    else:
        meshes = [(mp, None) for mp in
                  ([False, True] if args.both_meshes else [args.multi_pod])]
    if args.all:
        cells = [(name, shape.name) for name in ARCHS
                 if not args.arch_filter or args.arch_filter in name
                 for shape in ALL_SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]
    n_ok = n_err = n_skip = 0
    for name, shape_name in cells:
        for mp, mesh in meshes:
            rec = run_cell(name, shape_name, mp, args.out_dir, mesh=mesh)
            n_ok += rec["status"] == "ok"
            n_err += rec["status"] == "error"
            n_skip += rec["status"] == "skipped"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

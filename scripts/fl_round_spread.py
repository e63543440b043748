"""Readings behind ``tests/test_torch_lm_train.py``'s recurrent FL rounds,
on the CPU.

Runs the test's two rounds of a reduced arch (``fl_train_lm``'s wiring in
the port, ``examples/fl_train_lm.py``'s in JAX, both under a
``TickTimer``), each round from JAX's params, beside a JAX run from params
one ulp apart (the twin).  After each round it prints, for every leaf and
then for the worst leaf: the 2-norm distances port-JAX (err) and twin-JAX
(spread), their ratio, the round's own update of JAX's params, and whether
the leaf is within 1e-5 / 1e-4 elementwise.  ``--fault`` plants a fault in
the port first, to show what the test's bounds catch:

* ``tie``: ``max``'s derivative passes the whole gradient at a tie (as
  ``torch.clamp_min`` does) in the sLSTM's backward, not JAX's 0.5 / 0.5;
* ``dwh``: the sLSTM's backward returns a zero gradient for ``wh``;
* ``dk``: the scan's plain backward returns ``dk`` 1 % too large;
* ``dla``: the scan's plain backward returns ``dlog_a`` 10 % too small.

    PYTHONPATH=src:tests python scripts/fl_round_spread.py \
        --arch hymba-1.5b [--fault dk]

~3 min an arch on 6 CPU cores.
"""
from __future__ import annotations

import argparse
import tempfile

import jax
import numpy as np
import torch

import repro_torch.core as T
import test_torch_lm_train as tt
from repro_torch.core import tree
from repro_torch.kernels import ssm_scan
from repro_torch.launch import fl_train_lm
from repro_torch.models import ssm


def plant(fault: str) -> None:
    if fault == "tie":
        ssm._tie_split = lambda x, y: torch.where(x >= y, 1.0, 0.0)
    elif fault == "dwh":
        real = ssm._slstm_chunk_bwd

        def bwd(*args):
            dgx, dwh, *rest = real(*args)
            return (dgx, torch.zeros_like(dwh), *rest)
        ssm._slstm_chunk_bwd = bwd
    elif fault in ("dk", "dla"):
        real = ssm_scan.ssm_scan_bwd_plain

        def scan_bwd(*args, **kw):
            dq, dk, dv, dla = real(*args, **kw)
            if fault == "dk":
                return dq, dk * 1.01, dv, dla
            return dq, dk, dv, dla * 0.9
        ssm_scan.ssm_scan_bwd_plain = scan_bwd


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b",
                    choices=["hymba-1.5b", "xlstm-125m"])
    ap.add_argument("--fault", default="none",
                    choices=["none", "tie", "dwh", "dk", "dla"])
    args = ap.parse_args()
    plant(args.fault)
    jcfg, tcfg = tt._cfgs(args.arch, "pallas")
    jp, tp = tt._params(jcfg)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    with tempfile.TemporaryDirectory() as jd, \
            tempfile.TemporaryDirectory() as jd2, \
            tempfile.TemporaryDirectory() as td:
        js = tt._jax_server(jcfg, jp, jd)
        twin = tt._jax_server(jcfg, tt._one_ulp(jp), jd2)
        ts = fl_train_lm.build(tcfg, tp, "cpu", td, timer=T.TickTimer(1.0))
        for r in range(2):
            if r:
                tt._start_from(ts, js.params)
                twin.params = tt._one_ulp(js.params, seed=r)
            start = jax.tree.leaves(js.params)
            js.run_round()
            ts.run_round()
            twin.run_round()
            jl = jax.tree.leaves(js.params)
            tl = [t.numpy() for t in tree.leaves(ts.params)]
            err = tt._leaf_dists(tl, jl)
            spread = tt._leaf_dists(jax.tree.leaves(twin.params), jl)
            update = tt._leaf_dists(jl, start)
            close = [bool(np.all(np.abs(a - np.asarray(b)) <= tt.ATOL
                                 + tt.RTOL * np.abs(np.asarray(b))))
                     for a, b in zip(tl, jl)]
            for i, nm in enumerate(names):
                print(f"  round {r} {nm:44s} err {err[i]:.3e} spread "
                      f"{spread[i]:.3e} ratio {err[i] / spread[i]:8.3f} "
                      f"update {update[i]:.3e} within 1e-5/1e-4 {close[i]}")
            worst = int(np.argmax(err / spread))
            amax = max(float(np.abs(a - np.asarray(b)).max())
                       for a, b in zip(tl, jl))
            smax = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                       for a, b in zip(jax.tree.leaves(twin.params), jl))
            print(f"{args.arch} fault={args.fault} round {r}: max|port-JAX| "
                  f"{amax:.3e}, max|twin-JAX| {smax:.3e}, every leaf within "
                  f"1e-5/1e-4 {all(close)}; worst leaf {names[worst]} "
                  f"err/spread {err[worst] / spread[worst]:.3f}; whole tree "
                  f"err {np.linalg.norm(err):.3e} spread "
                  f"{np.linalg.norm(spread):.3e} update "
                  f"{np.linalg.norm(update):.3e}", flush=True)


if __name__ == "__main__":
    main()

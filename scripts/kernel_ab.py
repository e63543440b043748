"""Device times of the port's fold, RMSNorm and fused top-k kernels in one
checkout of this repo, on a CUDA card, printed as one JSON line that starts
with ``AB``.

To compare two checkouts (say a parent commit and a change) on the same
card, unpack both and run this script once per checkout, back to back on
one machine, alternating them (parent, change, change, parent):

    python3 scripts/kernel_ab.py --tree <checkout> --label <name>

``--tree`` is the checkout whose ``src/repro_torch`` is imported (its
kernels are built into its own ``build/kernels``); the timing code is this
checkout's ``chip_smoke.py`` (its ``Timer``: CUDA events, median of 30, a
spin kernel ahead of each call), so both trees are measured alike.  It
times, in bf16 with inputs from seed 0:

* the timer's floor: an empty kernel (``torch.cuda._sleep(0)``) timed the
  same way;
* the fold (``chip_smoke.fold_timing``, fp32 unless named) at
  n = 1,207,440 with C = 1, 4 and 8 and C = 8 in bf16, and at n = 2^25 with
  C = 16 in fp32 and bf16: the form the tree's main path launches (the
  leaves form over the full-width block's 142 leaves at n = 1,207,440 and
  over one (C, n) leaf at 2^25; in a tree without it, the rows form on the
  (C, n) block) cold and warm with its wrapper's host time, the rows form
  on C separate rows the same way, a ``copy_`` of the same bytes cold and
  warm, ``torch.addmv``, the plain version and the bound;
  then one full-width ``LocalAggregator.fold_block`` as the main path calls
  it (``chip_smoke.fold_block_profile``: device operations and device time
  by ``torch.profiler``, host time, bytes);
* ``ops.rmsnorm`` at (4096, 1600), (4096, 896), (4, 1600) and (4, 896):
  cold (L2 flushed before each call) and warm (x left in L2 by the call
  before), beside ``F.rms_norm``, a ``copy_`` of x (the same bytes read
  and written) and the bytes bound;
* ``ops.fused_topk`` at n = 1,207,440, k = 12,074 cold and warm, beside
  ``torch.topk`` and the bound, and the device operations of one call
  (kernels and memsets, by ``torch.profiler``);
* the card's name and power limit from ``nvidia-smi``.

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = torch.bfloat16
NORM_SHAPES = [(4096, 1600), (4096, 896), (4, 1600), (4, 896)]
FOLD_SHAPES = [(1207440, 1, torch.float32), (1207440, 4, torch.float32),
               (1207440, 8, torch.float32), (1207440, 8, BF),
               (1 << 25, 16, torch.float32), (1 << 25, 16, BF)]
TOPK = (1207440, 12074)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    import torch.nn.functional as F
    import repro_torch.core as T
    from repro_torch.kernels import ops
    from repro_torch.kernels.agg_weighted_sum import agg_weighted_sum_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    timer = cs.Timer()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": args.label, "card": card,
           "timer_floor_ms": timer.ms(lambda: torch.cuda._sleep(0)),
           "fold": [], "rmsnorm": [], "topk": {}}
    for n, C, dt in FOLD_SHAPES:
        out["fold"].append(cs.fold_timing(T, ops, agg_weighted_sum_plain,
                                          timer, n, C, dt, gen))
    out["fold_block"] = cs.fold_block_profile(T, ops, timer)
    for T, d in NORM_SHAPES:
        x = torch.randn(T, d, device="cuda", generator=gen).to(BF)
        g = torch.randn(d, device="cuda", generator=gen).to(BF)
        y = torch.empty_like(x)
        bound, _, nbytes = cs.rms_bound_ms(T, d, 2)
        out["rmsnorm"].append({
            "T": T, "d": d,
            "ms": timer.ms(lambda: ops.rmsnorm(x, g)),
            "warm_ms": timer.ms(lambda: ops.rmsnorm(x, g), flush=False),
            "library_ms": timer.ms(lambda: F.rms_norm(x, (d,), g, 1e-5)),
            "library_warm_ms": timer.ms(
                lambda: F.rms_norm(x, (d,), g, 1e-5), flush=False),
            "copy_ms": timer.ms(lambda: y.copy_(x)),
            "copy_warm_ms": timer.ms(lambda: y.copy_(x), flush=False),
            "bound_ms": bound, "bytes": nbytes})
    n, k = TOPK
    x = torch.randn(n, device="cuda", generator=gen) * 1e-3
    res = torch.randn(n, device="cuda", generator=gen) * 1e-4
    f_abs = (x + res).abs()
    per_call = cs.device_ops(lambda: ops.fused_topk(x, res, k))
    out["topk"] = {
        "n": n, "k": k,
        "ms": timer.ms(lambda: ops.fused_topk(x, res, k)),
        "warm_ms": timer.ms(lambda: ops.fused_topk(x, res, k), flush=False),
        "library_ms": timer.ms(lambda: torch.topk(f_abs, k)),
        "bound_ms": cs.topk_bound_ms(n, k)[0],
        "device_ops_per_call": {key: {"count": c, "device_ms": t}
                                for key, (c, t) in per_call.items()}}
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

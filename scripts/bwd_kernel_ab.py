"""Device times of the port's three backward kernels (flash attention's,
RMSNorm's and the scan's) in one checkout of this repo, on a CUDA card,
printed as one JSON line that starts with ``AB``.

To compare two checkouts (say a parent commit and a change) on the same
card, unpack both and run this script once per checkout, back to back on
one machine, alternating them (parent, change, change, parent):

    python3 scripts/bwd_kernel_ab.py --tree <checkout> --label <name>

``--tree`` is the checkout whose ``src/repro_torch`` is imported (its
kernels are built into its own ``build/kernels``); the timing code is this
checkout's ``chip_smoke.py`` (``time_flash_bwd``, ``time_rms_bwd`` and
``time_scan_bwd``: its
``Timer``, CUDA events, median of 30 after an L2 flush, a spin kernel ahead
of each call), so both trees are measured alike.  It times:

* the flash backward at qwen2-0.5b's training shape (4, 1024, 14 / 2, 64),
  causal, in bf16 and fp32, beside the backward of
  ``scaled_dot_product_attention(is_causal, enable_gqa)``, the plain
  version and the bound, with each call's device operations by
  ``torch.profiler`` (kernel name: launches and device ms a call);
* the norm backward at (4096, 896) in bf16 and fp32, beside
  ``F.rms_norm``'s backward, a ``copy_`` of the same bytes, the plain
  version and the bound, with its device operations;
* the scan backward at hymba-1.5b's (4, 1024, 8, 16, 400) bf16 (q and k
  shared by the heads) and xlstm-125m's (4, 1024, 4, 384, 385) fp32-k
  training shapes, beside ``torch.autograd.grad`` of the plain scan and
  the bound, with its device operations;
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain
    from repro_torch.kernels.ssm_scan import ssm_scan_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    timer = cs.Timer()
    out = {"label": args.label, "card": card, "flash_bwd": {},
           "rmsnorm_bwd": {}, "ssm_scan_bwd": {}}
    B, S, H, KV, hd = cs.TRAIN_FLASH
    T, d = cs.TRAIN_RMS
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).replace("torch.", "")
        row = cs.time_flash_bwd(ops, flash_attention_bwd_plain, timer, dt)
        gen = torch.Generator(device="cuda").manual_seed(15)
        q, k, v = cs.flash_inputs(B, S, H, KV, hd, dt, gen)
        do = torch.randn_like(q)
        o, lse = ops._flash_fwd(q, k, v, True, 0, True)
        row["device_ops"] = cs.device_ops(
            lambda: ops._flash_bwd(do, q, k, v, o, lse, True, 0))
        out["flash_bwd"][name] = row
        row = cs.time_rms_bwd(ops, rmsnorm_bwd_plain, timer, dt)
        x, dy = (torch.randn(T, d, device="cuda").to(dt) for _ in range(2))
        g = torch.ones(1, d, device="cuda", dtype=dt)
        row["device_ops"] = cs.device_ops(
            lambda: ops._rms_bwd(dy, x, g, 1e-5))
        out["rmsnorm_bwd"][name] = row
    for label, case in (("hymba", cs.HYMBA_TRAIN_SCAN),
                        ("xlstm", cs.XLSTM_TRAIN_SCAN)):
        row = cs.time_scan_bwd(ops, ssm_scan_plain, timer, case, label)
        gen = torch.Generator(device="cuda").manual_seed(72)
        q, k, v, la, chunk, dy, _ = cs.scan_bwd_inputs(case, gen)
        row["device_ops"] = cs.device_ops(
            lambda: ops._ssm_bwd(dy, None, q, k, v, la, chunk))
        out["ssm_scan_bwd"][label] = row
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

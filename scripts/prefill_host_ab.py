"""Prefill walls and LM-kernel wrapper host times of one checkout of this
repo, on a CUDA card, printed as one JSON line that starts with ``AB``.

To compare two checkouts (say a parent commit and a change) on the same
card, unpack both and run this script once per checkout, back to back on
one machine, alternating them (parent, change, change, parent):

    python3 scripts/prefill_host_ab.py --tree <checkout> --label <name>

``--tree`` is the checkout whose ``src/repro_torch`` is imported (its
kernels are built into its own ``build/kernels``); the script needs only
what every version of the port's serving path offers.  At full width, with
random bf16 weights from seed 0, B = 4 and a 1024-token prompt, it measures:

* the prefill wall of qwen2-0.5b and hymba-1.5b (``attention_impl
  "pallas"``): host seconds around ``lm.make_prefill_step``'s call ending
  in a synchronise, as ``launch.serve.generate`` times it; median of
  ``--reps`` after two warm-up prefills, with every sample;
* the host time to issue one call of each LM kernel wrapper at its serving
  shape (median of 50, a spin kernel keeping the card busy so the call
  never waits): ``ops.flash_attention`` at qwen2's (4, 1024, 14, 64) with
  K and V at all 14 heads (the form every version takes), ``ops.ssm_scan``
  at hymba's (4, 1024, 8, 16, 400) with q and k shared by the heads, and
  ``ops.rmsnorm`` at (4096, 1600);
* the card's name and power limit from ``nvidia-smi``.

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SPIN_CYCLES = 4_000_000        # ~2 ms at the H100's boost clock
BF = torch.bfloat16


def host_ms(fn, reps=50, warmup=3):
    """Median host time to issue ``fn`` with the card kept busy."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(times))


def prefill_walls(lm, make_prompt, cfg, B, P, reps):
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    prompt = torch.as_tensor(make_prompt(cfg, B, P, 0), device="cuda")
    prefill = lm.make_prefill_step(cfg, B, P, cache_len=P + 32)
    walls = []
    with torch.no_grad():
        for i in range(2 + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = prefill(params, prompt)
            torch.cuda.synchronize()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    del params
    torch.cuda.empty_cache()
    return {"median_ms": float(np.median(walls)), "samples_ms": walls}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_host_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prompt
    from repro_torch.models import lm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(4, 1024, 14, 64, device="cuda", generator=gen).to(BF)
    k, v = (torch.randn(4, 1024, 14, 64, device="cuda",
                        generator=gen).to(BF) for _ in range(2))
    qs = torch.randn(4, 1024, 1, 16, device="cuda",
                     generator=gen).to(BF).expand(4, 1024, 8, 16)
    ks = (0.3 * torch.randn(4, 1024, 1, 16, device="cuda",
                            generator=gen)).to(BF).expand(4, 1024, 8, 16)
    vs = torch.randn(4, 1024, 8, 400, device="cuda", generator=gen).to(BF)
    la = -torch.nn.functional.softplus(
        torch.randn(4, 1024, 8, device="cuda", generator=gen))
    x = torch.randn(4096, 1600, device="cuda", generator=gen).to(BF)
    g = torch.randn(1600, device="cuda", generator=gen).to(BF)
    wrappers = {
        "flash_attention": host_ms(
            lambda: ops.flash_attention(q, k, v, causal=True)),
        "ssm_scan": host_ms(lambda: ops.ssm_scan(qs, ks, vs, la, chunk=256)),
        "rmsnorm": host_ms(lambda: ops.rmsnorm(x, g))}
    del q, k, v, qs, ks, vs, la, x, g
    walls = {}
    for arch in ("qwen2-0.5b", "hymba-1.5b"):
        cfg = dataclasses.replace(get_arch(arch), attention_impl="pallas")
        walls[arch] = prefill_walls(lm, make_prompt, cfg, 4, 1024, args.reps)
    print("AB " + json.dumps({"label": args.label, "card": card,
                              "wrapper_host_ms": wrappers,
                              "prefill_wall": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Host time of two steps that the dry run's sharding hooks sit on, for the
``repro_torch`` package under ``--src``: a greedy decode step of
grok-1-314b at 2 of its 64 layers (``chip_smoke.py`` 15(b): bf16, the
pallas route, a (4, 1024) prompt, 32 tokens) and one ``make_train_step``
of qwen2-0.5b at full width on a (4, 1024) batch (13(d)).  With no
activation policy every hook is the identity; this measures what the
identity costs, by running the same script against two trees on one card
in one go, e.g. the parent and the change in the order parent, change,
change, parent:

    python3 scripts/hook_cost.py --src parent/src --label parent

Prints one JSON line: the card's name and power limit, each step's
milliseconds over ``--reps`` timed repeats (min and median), and the
kernels' launches of the last repeat.  Needs a CUDA card.
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="the src directory that holds repro_torch")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hook_cost: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import generate, make_prompt
    from repro_torch.models import lm
    _build.build(_build.KERNELS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    out = {"label": args.label, "src": args.src, "card": card}

    # 15(b): grok-1-314b at 2 layers, a decode step
    cfg = dataclasses.replace(get_arch("grok-1-314b"), n_layers=2,
                              attention_impl="pallas")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    prompt = torch.as_tensor(make_prompt(cfg, 4, 1024, 0), device="cuda")
    gen = 32
    generate(params, prompt, cfg, 2, "cuda")                 # warm-up
    steps = []
    for _ in range(args.reps):
        _, _, t = generate(params, prompt, cfg, gen, "cuda")
        steps.append(t["decode_s"] / (gen - 1) * 1e3)
    out["grok_decode_step_ms"] = {"min": min(steps),
                                  "median": statistics.median(steps),
                                  "all": steps}
    del params, prompt
    torch.cuda.empty_cache()

    # 13(d): qwen2-0.5b full width, one train step
    cfg = dataclasses.replace(get_arch("qwen2-0.5b"),
                              attention_impl="pallas")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(1),
                            cfg)
    step = lm.make_train_step(cfg, lr=0.05)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, size=(4, 1024),
                             dtype=np.int32) for k in ("inputs", "labels")}
    params, _ = step(params, batch)                          # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.reps):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        params, met = step(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    out["qwen2_train_step_ms"] = {"min": min(walls),
                                  "median": statistics.median(walls),
                                  "all": walls}
    out["qwen2_train_step_launches"] = launches
    out["qwen2_loss"] = float(met["loss"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

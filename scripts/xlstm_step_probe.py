"""Full-depth peak memory of ``chip_smoke.py`` 14(c)'s xlstm-125m step,
with the sLSTM's chunk recompute against its plain loop, on a CUDA card.

14(c) compares the two at 2 layers; this runs its step
(``chip_smoke.rec_step_run``: full-width xlstm-125m ``make_train_step`` at
(4, 1024), bf16, the ``pallas`` route, launches held to 14(c)'s counts) at
all 12 layers: two steps with ``ssm.slstm_apply`` (the chunk Function),
then two with ``ssm.slstm_apply_plain`` (every step's gates kept for
autograd), one line each with its wall and ``max_memory_allocated``.  The
first step of these shapes pays one-off costs; compare the later ones.
~2 min; exits non-zero without a card:

    python3 scripts/xlstm_step_probe.py
"""
import dataclasses
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    if not torch.cuda.is_available():
        print("xlstm_step_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import lm, ssm
    cfg = dataclasses.replace(get_arch("xlstm-125m"), attention_impl="pallas")
    batch = cs.lm_batch(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, 3)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(1),
                            cfg)
    chunked = ssm.slstm_apply
    for label, fn in (("chunked", chunked), ("plain", ssm.slstm_apply_plain)):
        ssm.slstm_apply = fn
        try:
            for i in (1, 2):
                _, wall, _, loss, peak = cs.rec_step_run(ops, lm, cfg, params,
                                                         batch, warm=False)
                print(f"{label} {i}: wall {wall:.2f} s, loss {loss:.4f}, "
                      f"max_memory_allocated {peak} B", flush=True)
        finally:
            ssm.slstm_apply = chunked
    return 0


if __name__ == "__main__":
    sys.exit(main())

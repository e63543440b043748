"""``chip_smoke.py`` phase 17 (the training CLI ``launch/train.py`` and
the quickstart / stateful_scaffold twins) alone, on a CUDA card: phase 1
(the card's name and power limit; TF32 off), the kernels' build, then
``phase_cli`` with the checks and log lines of the whole script.  ~2 min
with the build; exits non-zero without a card or on a failed check:

    python3 scripts/cli_phase.py
"""
import os
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    if not torch.cuda.is_available():
        print("cli_phase: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch.core as T
    from repro_torch.core import tree
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import (fl_train_lm, quickstart,
                                    stateful_scaffold, train)
    t0 = time.perf_counter()
    card = cs.phase_card()
    _build.build(_build.KERNELS)
    cs.log(f"cli_phase: built in {time.perf_counter() - t0:.1f} s")
    cs.phase_cli(T, ops, tree, train, quickstart, stateful_scaffold,
                 fl_train_lm, card)
    cs.log(f"cli_phase: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

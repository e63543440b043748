"""``chip_smoke.py`` phase 18 (the dry run, ``launch/dryrun.py``) alone, on
a CUDA card: phase 1 (the card's name and power limit; TF32 off), the
kernels' build, then ``phase_dryrun`` with the checks and log lines of the
whole script.  Exits non-zero without a card or on a failed check:

    python3 scripts/dryrun_phase.py
"""
import os
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    if not torch.cuda.is_available():
        print("dryrun_phase: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import dryrun, mesh
    t0 = time.perf_counter()
    cs.phase_card()
    _build.build(_build.KERNELS)
    cs.log(f"dryrun_phase: built in {time.perf_counter() - t0:.1f} s")
    cs.phase_dryrun(ops, dryrun, mesh)
    cs.log(f"dryrun_phase: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

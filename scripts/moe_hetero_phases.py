"""``chip_smoke.py`` phases 15 (the MoE FFN) and 16 (the heterogeneous
cluster example's twin) alone, on a CUDA card: phase 1 (the card's name
and power limit; TF32 off), the kernels' build, then ``phase_moe`` and
``phase_hetero`` with the checks and log lines of the whole script.
~2-3 min with the build; exits non-zero without a card or on a failed
check:

    python3 scripts/moe_hetero_phases.py [moe] [hetero]
"""
import os
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("moe_hetero_phases: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch.core as T
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tree
    from repro_torch.data import make_lm_clients
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import heterogeneous_cluster
    from repro_torch.launch.serve import generate, make_prompt
    from repro_torch.models import lm, moe
    t0 = time.perf_counter()
    card = cs.phase_card()
    _build.build(_build.KERNELS)
    cs.log(f"moe_hetero_phases: built in {time.perf_counter() - t0:.1f} s")
    what = argv or ["moe", "hetero"]
    if "moe" in what:
        cs.phase_moe(T, ops, lm, moe, tree, generate, make_prompt, get_arch,
                     make_lm_clients, card)
    if "hetero" in what:
        cs.phase_hetero(T, ops, heterogeneous_cluster, card)
    cs.log(f"moe_hetero_phases: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

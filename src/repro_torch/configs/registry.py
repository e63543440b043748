"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (ALL_SHAPES, ModelConfig,
                                      ShapeConfig, shape_by_name)
from repro_torch.configs import (grok1_314b, hymba_1_5b, llama3_2_3b,
                                 llama4_scout_17b_a16e, musicgen_large,
                                 phi3_mini_3_8b, phi3_vision_4_2b,
                                 qwen2_0_5b, qwen2_5_14b, xlstm_125m)

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        musicgen_large.CONFIG,
        phi3_mini_3_8b.CONFIG,
        qwen2_0_5b.CONFIG,
        llama3_2_3b.CONFIG,
        qwen2_5_14b.CONFIG,
        phi3_vision_4_2b.CONFIG,
        grok1_314b.CONFIG,
        llama4_scout_17b_a16e.CONFIG,
        hymba_1_5b.CONFIG,
        xlstm_125m.CONFIG,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch × shape) dry-run cell applies (DESIGN.md §Shape)."""
    if shape.kind == "long_decode" and not cfg.is_recurrent:
        return False, ("skipped: pure full-attention arch has no sub-quadratic "
                       "path for 524k context (DESIGN.md §Shape handling)")
    return True, ""


def all_cells():
    for name, cfg in ARCHS.items():
        for shape in ALL_SHAPES:
            ok, why = cell_is_runnable(cfg, shape)
            yield name, cfg, shape, ok, why

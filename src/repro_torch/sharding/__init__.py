"""Sharding rules of the port (``repro/sharding``) as DTensor placements."""
from repro_torch.sharding.specs import (MeshShape, batch_spec, cache_spec,
                                        caches_shardings, constrain, dp_axes,
                                        enable_activation_policy, param_spec,
                                        params_shardings, to_placements)

__all__ = ["MeshShape", "batch_spec", "cache_spec", "caches_shardings",
           "constrain", "dp_axes", "enable_activation_policy", "param_spec",
           "params_shardings", "to_placements"]

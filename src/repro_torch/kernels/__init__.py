"""Hand-written Hopper kernels of the port, with their plain versions.

  agg_weighted_sum  — Parrot hierarchical-aggregation fold (CUDA C++,
                      ``csrc/agg_weighted_sum.cu``; memory-bound)
  topk_compress     — fused error-feedback top-k of the compressed wire
                      (CUDA C++, ``csrc/topk_compress.cu``; radix select
                      and a stable compaction; memory-bound)

``ops`` holds the public wrappers and launch counters.  The three other TPU
kernels of the JAX package (flash attention, rmsnorm, ssm scan) are not
ported yet (ROADMAP.md, kernels queue).
"""
from repro_torch.kernels import ops

__all__ = ["ops"]

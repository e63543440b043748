"""Hand-written Hopper kernels of the port, with their plain versions.

  agg_weighted_sum  — Parrot hierarchical-aggregation fold (CUDA C++,
                      ``csrc/agg_weighted_sum.cu``; memory-bound)
  topk_compress     — fused error-feedback top-k of the compressed wire
                      (CUDA C++, ``csrc/topk_compress.cu``; radix select
                      and a stable compaction; memory-bound)
  flash_attention   — online-softmax attention of the LM prefill and
                      training (CUDA C++, ``csrc/flash_attention.cu``;
                      bound by operations); its backward for training
                      (``csrc/flash_attention_bwd.cu``, which replaces no
                      TPU kernel: the Pallas kernel has no VJP)
  ssm_scan          — chunked SSD / mLSTM scan of the recurrent prefill
                      (CUDA C++, ``csrc/ssm_scan.cu``; fp32 products on the
                      CUDA cores, bound by operations)
  rmsnorm           — every block norm of every LM and its backward
                      (CUDA C++, ``csrc/rmsnorm.cu``; memory-bound)

``ops`` holds the public wrappers, their autograd and vmap rules, and the
launch counters.  Every TPU kernel of the JAX package has its counterpart
here.
"""
from repro_torch.kernels import ops

__all__ = ["ops"]

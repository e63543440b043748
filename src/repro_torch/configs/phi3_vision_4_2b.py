"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct]
The CLIP vision tower is a stub per the assignment: ``input_specs()`` feeds
precomputed patch embeddings interleaved with text embeddings as (B,S,d).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    input_kind="embeddings",
    logit_chunk=32768,
)

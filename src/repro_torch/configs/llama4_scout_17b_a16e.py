"""llama4-scout-17b-a16e [moe] — 16 experts top-1, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E]
Early-fusion multimodal frontend is a stub (precomputed embeddings).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=1, group_size=4096),
    input_kind="embeddings",
    train_microbatches=4,
    logit_chunk=8192,
)

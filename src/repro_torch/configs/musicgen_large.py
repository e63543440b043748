"""musicgen-large [audio] — decoder-only LM over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048  [arXiv:2306.05284; hf]
The EnCodec frontend is a stub: ``input_specs()`` supplies precomputed frame
embeddings (B, S, d_model); the decoder backbone is what is modelled here.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    input_kind="embeddings",
    logit_chunk=32768,
)

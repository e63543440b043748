"""hymba-1.5b [hybrid] — parallel attention + mamba heads, sliding window.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676; hf]
Each block runs GQA attention and SSD(mamba) heads in parallel on the same
normalised input and fuses by averaging (the Hymba "parallel heads" design).
Sliding-window attention + O(1) SSM state make long_500k decode runnable.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    sliding_window=1024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, n_heads=8, chunk_size=256),
    logit_chunk=32768,
)

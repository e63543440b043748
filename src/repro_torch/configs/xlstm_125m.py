"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks.

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304  [arXiv:2405.04517]
d_ff=0: xLSTM blocks carry their own up/down projections (mLSTM expand=2);
no separate FFN.  Fully recurrent -> long_500k decode is O(1) state.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    xlstm=XLSTMConfig(pattern=("mlstm", "slstm"), mlstm_expand=2,
                      slstm_n_heads=4, chunk_size=256),
    logit_chunk=32768,
)

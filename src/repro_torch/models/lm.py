"""Top-level language model: embedding → decoder stack → head.

Port of ``repro/models/lm.py``, the serving side:

  init_params(gen, cfg)                         -> params tree
  forward(params, inputs, cfg, ...)             -> hidden states
  make_prefill_step(cfg, batch, seq)            -> serve prefill
  make_decode_step(cfg)                         -> serve one-token decode

``input_kind == "embeddings"`` (audio/vlm stubs) feeds precomputed frontend
embeddings of shape (B, S, d_model) instead of token ids.  The training
side (``loss_and_aux``, ``chunked_xent``, ``make_train_step``) is not
ported yet (ROADMAP.md modules item 17b).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, transformer


def init_params(gen: torch.Generator, cfg) -> dict:
    """Random params on ``gen``'s device, in ``cfg.dtype``, with the JAX
    package's tree structure, shapes and dtypes."""
    dtype = layers.dtype_of(cfg.dtype)
    p = {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype),
        "blocks": transformer.stack_init(gen, cfg),
        "final_norm": layers.rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype)
    return p


def _embed_inputs(params, inputs, cfg):
    if cfg.input_kind == "embeddings":
        return inputs.to(layers.dtype_of(cfg.dtype))
    return layers.embed(params["embed"], inputs)


def _head(params, h, cfg):
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].T
    return layers.dense(params["lm_head"], h)


def forward(params, inputs, cfg, *, positions=None, caches=None,
            cache_index=None, decode=False):
    """inputs: (B,S) ids or (B,S,d) embeddings -> (hidden (B,S,d), caches,
    aux); aux is the blocks' auxiliary loss, 0.0 for every ported block."""
    x = _embed_inputs(params, inputs, cfg)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, new_caches, aux = transformer.stack_apply(
        params["blocks"], x, cfg, positions=positions, caches=caches,
        cache_index=cache_index, decode=decode)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, new_caches, aux


def _device(params) -> torch.device:
    return params["embed"]["w"].device


def make_prefill_step(cfg, batch: int, seq_len: int, cache_len: int = 0):
    """Full-sequence forward that fills fresh decode caches.

    ``cache_len`` (>= seq_len) sizes the cache; defaults to seq_len.
    Returns ``prefill_step(params, inputs) -> (last logits (B,1,V),
    caches)``."""
    cache_len = cache_len or seq_len

    def prefill_step(params, inputs):
        caches = transformer.stack_cache(cfg, batch, cache_len,
                                         layers.dtype_of(cfg.dtype),
                                         _device(params))
        h, new_caches, _ = forward(params, inputs, cfg, caches=caches,
                                   cache_index=0)
        logits = _head(params, h[:, -1:], cfg)
        return logits, new_caches

    return prefill_step


def make_decode_step(cfg):
    """One-token decode against existing caches (updated in place).

    inputs: token ids (B,1) or embeddings (B,1,d); ``pos``: the current
    absolute position, an int.  Returns (logits (B,1,V), caches)."""

    def decode_step(params, inputs, caches, pos):
        pos = int(pos)
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=_device(params))
        h, new_caches, _ = forward(params, inputs, cfg, positions=positions,
                                   caches=caches, cache_index=pos,
                                   decode=True)
        logits = _head(params, h, cfg)
        return logits, new_caches

    return decode_step

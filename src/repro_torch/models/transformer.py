"""Decoder stack: block composition over a repeating unit of block kinds.

Port of ``repro/models/transformer.py`` for the ``dense`` block kind
(RMSNorm → GQA attention → residual → RMSNorm → SwiGLU → residual).  The
param tree is the JAX package's: a tuple over the unit's pattern positions
of dicts whose leaves are stacked over the ``n_layers / len(unit)``
repetitions, so ``convert.params_from_jax`` carries weights straight
across.  A Python loop over the repetitions takes the place of
``lax.scan``; ``cfg.remat`` and ``cfg.scan_layers`` have no effect here.

Not ported yet (each raises ``NotImplementedError``): the MoE FFN and the
``hybrid``, ``mlstm`` and ``slstm`` block kinds (ROADMAP.md modules item
17c).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tree
from repro_torch.models import attention, layers

_NOT_PORTED = ("the {what} is not ported yet (ROADMAP.md modules item 17c: "
               "MoE, hybrid and xLSTM blocks)")


def unit_pattern(cfg) -> Tuple[str, ...]:
    if cfg.family == "ssm":
        return tuple(cfg.xlstm.pattern if cfg.xlstm else ("mlstm", "slstm"))
    if cfg.family == "hybrid":
        return ("hybrid",)
    return ("dense",)


def n_rep(cfg) -> int:
    pat = unit_pattern(cfg)
    assert cfg.n_layers % len(pat) == 0
    return cfg.n_layers // len(pat)


def _check_kind(cfg, kind: str) -> None:
    if kind != "dense":
        raise NotImplementedError(_NOT_PORTED.format(what=f"{kind!r} block"))
    if cfg.moe is not None:
        raise NotImplementedError(_NOT_PORTED.format(what="MoE FFN"))


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg, kind: str) -> dict:
    _check_kind(cfg, kind)
    dtype = layers.dtype_of(cfg.dtype)
    d = cfg.d_model
    p = {"norm1": layers.rmsnorm_init(d, dtype, gen.device),
         "attn": attention.attn_init(gen, cfg)}
    if cfg.d_ff > 0:
        p["norm2"] = layers.rmsnorm_init(d, dtype, gen.device)
        p["ffn"] = layers.swiglu_init(gen, d, cfg.d_ff, dtype)
    return p


def block_cache(cfg, kind: str, batch: int, seq_len: int, dtype,
                device=None) -> dict:
    """Decode cache pytree for one block."""
    _check_kind(cfg, kind)
    return {"attn": attention.init_cache(cfg, batch, seq_len, dtype, device)}


def block_apply(p, x, cfg, kind: str, *, positions, cache=None,
                cache_index=None, decode: bool = False):
    """Returns (x_out, cache, aux); the cache is updated in place.  A dense
    block has no auxiliary loss: aux is 0.0."""
    _check_kind(cfg, kind)
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    attn_cache = cache.get("attn") if cache else None
    a_out, new_attn = attention.attention(
        p["attn"], h, cfg, positions=positions, cache=attn_cache,
        cache_index=cache_index)
    new_cache = {} if new_attn is None else {"attn": new_attn}
    x = x + a_out
    if cfg.d_ff > 0:
        h2 = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + layers.swiglu(p["ffn"], h2)
    return x, new_cache, 0.0


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def _stack(trees):
    return tree.map(lambda *xs: torch.stack(xs), *trees)


def stack_init(gen: torch.Generator, cfg) -> Tuple[dict, ...]:
    reps = n_rep(cfg)
    return tuple(_stack([block_init(gen, cfg, kind) for _ in range(reps)])
                 for kind in unit_pattern(cfg))


def stack_cache(cfg, batch: int, seq_len: int, dtype, device=None):
    reps = n_rep(cfg)
    return tuple(
        tree.map(lambda a: a[None].repeat((reps,) + (1,) * a.dim()),
                 block_cache(cfg, kind, batch, seq_len, dtype, device))
        for kind in unit_pattern(cfg))


def stack_apply(params, x, cfg, *, positions, caches=None, cache_index=None,
                decode: bool = False):
    """params/caches: tuple over pattern positions of stacked pytrees.

    Returns (x, caches, aux_total); each repetition's cache is a view of
    the stacked one and is updated in place."""
    pat = unit_pattern(cfg)
    has_cache = caches is not None
    aux_tot = 0.0
    for r in range(n_rep(cfg)):
        for i, kind in enumerate(pat):
            up = tree.map(lambda a: a[r], params[i])
            uc = tree.map(lambda a: a[r], caches[i]) if has_cache else None
            x, _, a = block_apply(up, x, cfg, kind, positions=positions,
                                  cache=uc, cache_index=cache_index,
                                  decode=decode)
            aux_tot = aux_tot + a
    return x, caches, aux_tot

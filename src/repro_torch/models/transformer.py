"""Decoder stack: block composition over a repeating unit of block kinds.

Port of ``repro/models/transformer.py``.  Block kinds:
  dense   — RMSNorm → GQA attention → residual → RMSNorm → SwiGLU or MoE
            → residual
  hybrid  — parallel attention + mamba(SSD) heads fused by averaging (Hymba)
  mlstm   — RMSNorm → mLSTM mixer → residual (xLSTM, no FFN)
  slstm   — RMSNorm → sLSTM mixer → residual

The param tree is the JAX package's: a tuple over the unit's pattern
positions of dicts whose leaves are stacked over the ``n_layers /
len(unit)`` repetitions, so ``convert.params_from_jax`` carries weights
straight across.  A Python loop over the repetitions takes the place of
``lax.scan``; ``cfg.remat`` and ``cfg.scan_layers`` have no effect here.
Caches are updated in place: the attention layer writes its ring buffer,
and the recurrent states, which the mixers return as new tensors (as in
JAX), are copied into the stacked cache's views.  A ``dense`` block of an
MoE config (``cfg.moe`` set) runs the MoE FFN (``models/moe.py``) and
returns its auxiliary loss; every other block's is 0.0.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tree
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.sharding.specs import constrain

KINDS = ("dense", "hybrid", "mlstm", "slstm")


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


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg, kind: str) -> dict:
    _check_kind(kind)
    dtype = layers.dtype_of(cfg.dtype)
    d = cfg.d_model
    p = {"norm1": layers.rmsnorm_init(d, dtype, gen.device)}
    if kind in ("dense", "hybrid"):
        p["attn"] = attention.attn_init(gen, cfg)
        if kind == "hybrid":
            p["mamba"] = ssm.mamba_init(gen, cfg)
        if cfg.d_ff > 0:
            p["norm2"] = layers.rmsnorm_init(d, dtype, gen.device)
            if cfg.moe is not None and kind == "dense":
                p["ffn"] = moe.moe_init(gen, cfg)
            else:
                p["ffn"] = layers.swiglu_init(gen, d, cfg.d_ff, dtype)
    elif kind == "mlstm":
        p["mixer"] = ssm.mlstm_init(gen, cfg)
    else:
        p["mixer"] = ssm.slstm_init(gen, cfg)
    return p


def block_cache(cfg, kind: str, batch: int, seq_len: int, dtype,
                device=None) -> dict:
    """Decode cache/state pytree for one block."""
    _check_kind(kind)
    c = {}
    if kind in ("dense", "hybrid"):
        c["attn"] = attention.init_cache(cfg, batch, seq_len, dtype, device)
    if kind == "hybrid":
        c["mamba"] = ssm.mamba_init_state(cfg, batch, dtype, device)
    if kind == "mlstm":
        c["mixer"] = ssm.mlstm_init_state(cfg, batch, dtype, device)
    if kind == "slstm":
        c["mixer"] = ssm.slstm_init_state(cfg, batch, dtype, device)
    return c


def _store(cache: dict, state: dict) -> None:
    """Copy a mixer's new state into the cache's views, key by key."""
    for key, val in state.items():
        cache[key].copy_(val)


def _conv_tail(p, h, cfg):
    """Streaming conv state after a prefill pass: last (K-1) pre-conv inputs.

    The mamba conv operates on the in_proj output, so recompute that tail
    from the normalised input."""
    u = layers.dense(p["mamba"]["in_proj"], h[:, -(cfg.ssm.d_conv - 1):, :])
    xs, _ = torch.chunk(u, 2, dim=-1)
    return xs


def block_apply(p, x, cfg, kind: str, *, positions, cache=None,
                cache_index=None, decode: bool = False):
    """Returns (x_out, cache, aux); the cache is updated in place.  aux is
    the MoE FFN's auxiliary loss, an fp32 scalar tensor, for a ``dense``
    block of an MoE config, and 0.0 for every other block."""
    _check_kind(kind)
    aux = 0.0
    # under a dry run's policy the products read the normed input as the
    # residual lays it out (``specs.matmul`` gathers the sequence only for
    # weights sharded over "model"), the recurrent mixers read it whole
    # along the sequence, and each output is laid out as the residual
    # before the add, so the backward's products see the batch alone
    # sharded
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in ("dense", "hybrid"):
        attn_cache = cache.get("attn") if cache else None
        a_out, _ = attention.attention(
            p["attn"], h, cfg, positions=positions, cache=attn_cache,
            cache_index=cache_index)
        if kind == "hybrid":
            h = constrain(h, "tokens")
            if decode:
                m_out, new_m = ssm.mamba_step(p["mamba"], h, cache["mamba"],
                                              cfg)
                _store(cache["mamba"], new_m)
            else:
                m_out, (_, h_st) = ssm.mamba_apply(p["mamba"], h, cfg)
                if cache is not None:
                    # prefill: seed the decode state from the scan tail
                    _store(cache["mamba"], {"conv": _conv_tail(p, h, cfg),
                                            "h": h_st})
            a_out = (constrain(a_out, "residual")
                     + constrain(m_out, "residual")) * 0.5
        x = x + constrain(a_out, "residual")
        if cfg.d_ff > 0:
            h2 = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
            if cfg.moe is not None and kind == "dense":
                f_out, aux = moe.moe_ffn(p["ffn"], h2, cfg)
            else:
                f_out = layers.swiglu(p["ffn"], h2)
            x = x + constrain(f_out, "residual")
    elif kind == "mlstm":
        h = constrain(h, "tokens")
        if decode:
            m_out, st = ssm.mlstm_step(p["mixer"], h, cache["mixer"], cfg)
            _store(cache["mixer"], st)
        else:
            m_out, h_final = ssm.mlstm_apply(p["mixer"], h, cfg)
            if cache is not None:
                _store(cache["mixer"], {"h": h_final})
        x = x + constrain(m_out, "residual")
    else:
        h = constrain(h, "tokens")
        if decode:
            m_out, st = ssm.slstm_step(p["mixer"], h, cache["mixer"], cfg)
        else:
            m_out, st = ssm.slstm_apply(p["mixer"], h, cfg)
        if cache is not None:
            _store(cache["mixer"], st)
        x = x + constrain(m_out, "residual")
    return x, cache, aux


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


def _unstack(stacked, n):
    """The per-repetition trees of a stacked one, as views: one ``unbind`` a
    leaf, whose backward stacks the repetitions' gradients once, where
    indexing ``a[r]`` would write a zero-filled copy of the whole leaf for
    every repetition."""
    leaves, treedef = tree.flatten(stacked)
    cols = [a.unbind(0) for a in leaves]
    return [tree.unflatten(treedef, [c[r] for c in cols]) for r in range(n)]


def stack_apply(params, x, cfg, *, positions, caches=None, cache_index=None,
                decode: bool = False):
    """params/caches: tuple over pattern positions of stacked pytrees.

    Returns (x, caches, aux_total): the blocks' auxiliary losses summed
    over the repetitions (0.0 without an MoE block); each repetition's
    cache is a view of the stacked one and is updated in place."""
    pat = unit_pattern(cfg)
    has_cache = caches is not None
    aux_tot = 0.0
    per_rep = [_unstack(p, n_rep(cfg)) for p in params]
    for r in range(n_rep(cfg)):
        x = constrain(x, "residual")
        for i, kind in enumerate(pat):
            up = per_rep[i][r]
            uc = tree.map(lambda a: a[r], caches[i]) if has_cache else None
            x, _, a = block_apply(up, x, cfg, kind, positions=positions,
                                  cache=uc, cache_index=cache_index,
                                  decode=decode)
            aux_tot = aux_tot + a
    return x, caches, aux_tot

"""Attention: GQA with dense, chunked online-softmax and flash-kernel impls.

Port of ``repro/models/attention.py``.  ``chunked`` is the plain PyTorch
expression of the online-softmax algorithm of the flash kernel; ``pallas``
(the config's name for the kernel route) calls ``kernels/ops.flash_attention``,
which launches the hand-written Hopper kernel for a CUDA tensor and its
plain version for a CPU tensor; it takes the KV heads as they are, where the
``dense`` and ``chunked`` impls repeat them to H first, as in JAX.

KV caches are ring buffers: ``{"k": (B,Smax,KV,hd), "v": ..., "pos": (Smax,)}``
where ``pos[s]`` is the absolute position stored in slot ``s`` (-1 = empty).
For full-attention archs Smax == seq_len and the ring never wraps; for
sliding-window archs Smax == window and old entries are overwritten.

One intended difference from the JAX package: the caches are updated in
place (the layer returns the same dict it was given, so a decode step copies
no cache).  The ``constrain`` hints and the tensor-parallel head padding
are JAX's: identities unless a dry run's activation policy is active
(``sharding/specs.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.sharding.specs import (constrain, head_tp_active,
                                        local_call, matmul, model_offset,
                                        on_mesh, placed_like, reshape,
                                        shardwise, tp_padded_heads,
                                        zero_gather)

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg) -> dict:
    """Projection weights keep an explicit head axis: (d, H, hd), biases
    (H, hd), the output projection (H, hd, d)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dtype = layers.dtype_of(cfg.dtype)
    scale = 1.0 / math.sqrt(d)

    def proj(n_heads):
        p = {"w": layers.normal(gen, (d, n_heads, hd), scale).to(dtype)}
        if cfg.qkv_bias:
            p["b"] = torch.zeros((n_heads, hd), dtype=dtype,
                                 device=gen.device)
        return p

    return {
        "wq": proj(H),
        "wk": proj(KV),
        "wv": proj(KV),
        "wo": {"w": layers.normal(gen, (H, hd, d),
                                  1.0 / math.sqrt(H * hd)).to(dtype)},
    }


def _proj_heads(p, x):
    """x: (B,S,d) @ (d,Hn,hd) -> (B,S,Hn,hd)."""
    d, Hn, hd = p["w"].shape
    y = reshape(matmul(x, reshape(p["w"], d, Hn * hd)), *x.shape[:-1], Hn,
                hd)
    if "b" in p:
        y = y + zero_gather(p["b"])
    return y


def init_cache(cfg, batch: int, seq_len: int, dtype, device=None) -> dict:
    smax = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    KV, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, smax, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, smax, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((smax,), -1, dtype=torch.int32, device=device),
    }


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*groups, hd), each KV head repeated
    ``groups`` times in place (``jnp.repeat``'s order)."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _mask(qpos, kpos, causal: bool, window: int):
    mask = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > (qpos - window)
    return mask


def dense_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Reference attention.  q: (B,Sq,H,hd); k,v: (B,Skv,H,hd); the
    queries sit at positions ``q_offset + [0, Sq)`` of the keys'."""
    Sq, hd = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = _mask(qpos, kpos, causal, window)
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash-style), a Python loop
    in place of ``lax.scan``.  Never materialises the (Sq, Skv) score
    matrix; peak transient is (B, H, Sq, chunk).  The queries sit at
    positions ``q_offset + [0, Sq)`` of the keys'."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    if Skv % chunk:
        chunk = Skv  # degenerate fallback for tiny shapes
    n_chunks = Skv // chunk
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    qf = q.to(torch.float32) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]

    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    for idx in range(n_chunks):
        kb = k[:, idx * chunk:(idx + 1) * chunk].to(torch.float32)
        vb = v[:, idx * chunk:(idx + 1) * chunk].to(torch.float32)
        kpos = idx * chunk + torch.arange(chunk, device=q.device)[None, :]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        mask = _mask(qpos, kpos, causal, window)
        s = s + torch.where(mask, 0.0, NEG_INF)[None, None]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])                # (B,H,Sq,chunk)
        corr = torch.exp(m - m_new)                        # (B,H,Sq)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vb)
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = acc / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _cache_attend(q, cache, cfg, qpos):
    """Attend new-token queries over the ring-buffer cache (decode path)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    groups = H // KV
    kk = _repeat_kv(cache["k"], groups)
    vv = _repeat_kv(cache["v"], groups)
    kpos = cache["pos"]                                    # (Smax,)
    valid = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
    if cfg.sliding_window:
        valid &= kpos[None, :] > (qpos[:, None] - cfg.sliding_window)
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale,
                     kk.to(torch.float32))
    s = torch.where(valid[None, None], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, vv.to(torch.float32))
    return out.to(q.dtype)


def _self_attend(q, k, v, cfg, use: str, q_offset: int = 0):
    """Causal self-attention of q (B,Sq,H,hd) over k, v (B,S,KV,hd) by the
    impl ``use``; the queries at positions ``q_offset + [0, Sq)``."""
    if use == "pallas":
        if q_offset or q.shape[1] != k.shape[1]:
            raise ValueError("the pallas route attends aligned sequences")
        # the kernel reads each KV head in place for its query heads
        return kops.flash_attention(q, k, v, causal=True,
                                    window=cfg.sliding_window)
    groups = q.shape[2] // k.shape[2]
    kk = _repeat_kv(k, groups)
    vv = _repeat_kv(v, groups)
    if use == "dense":
        return dense_attention(q, kk, vv, causal=True,
                               window=cfg.sliding_window, q_offset=q_offset)
    # chunked reference
    return chunked_attention(q, kk, vv, causal=True,
                             window=cfg.sliding_window,
                             chunk=min(cfg.attn_chunk, k.shape[1]),
                             q_offset=q_offset)


def _local_attend(q, k, v, cfg, use: str):
    """``_self_attend``; for DTensors (a dry run) on each device's own part:
    its batch rows and heads, k and v repeated to q's heads first (DTensor
    would gather the heads to merge them with the batch in the products);
    where the heads do not divide the model axis and the policy shards the
    sequence there instead (its sequence-TP fallback), its own query rows
    over the whole of k and v."""
    if not on_mesh(q):
        return _self_attend(q, k, v, cfg, use)
    groups = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
    B, S, H = q.shape[:3]
    if head_tp_active(H) or S == 1 or not head_tp_active(S):
        bh = (0, 2)
        return local_call(lambda *a: _self_attend(*a, cfg, use), (q, k, v),
                          (bh, bh, bh), (bh,), B, H)
    off = model_offset(q, S)
    rows, whole = (0, 1), (0, None)
    return local_call(
        lambda *a: _self_attend(*a, cfg, use, q_offset=off), (q, k, v),
        (rows, whole, whole), (rows,), B, S)


def _write_slots(ring, slot, tail) -> None:
    """``ring[:, slot] = tail`` in place.  A DTensor ring (a dry run) is
    written row-locally on a copy whose slots are replicated, then copied
    back: DTensor has no in-place indexed write into a sharded dim."""
    if not on_mesh(ring):
        ring[:, slot] = tail
        return

    def write(r, t):
        r = r.clone()
        r[:, slot] = t
        return r

    rows = (0, None)
    ring.copy_(placed_like(local_call(write, (ring, tail), (rows, rows),
                                      (rows,), ring.shape[0]), ring))


def attention(params, x, cfg, *, positions, cache=None, cache_index=None,
              impl: Optional[str] = None):
    """Full GQA attention layer.

    x: (B, S, d); positions: (S,) integer tensor.  Three modes:
      - training (cache is None): causal self-attention over S.
      - prefill (cache given, S > 1): causal self-attention, cache filled.
      - decode (cache given, S == 1): attend over the ring-buffer cache;
        ``cache_index`` is the absolute position (an int).

    Returns (out, cache): the cache dict updated in place, or None.
    """
    B, S, _ = x.shape
    H, KV = cfg.n_heads, cfg.n_kv_heads
    wq, wo = params["wq"], zero_gather(params["wo"]["w"])
    Hp = tp_padded_heads(H, KV) if cache is None else H
    if Hp != H:
        # zero-pad query heads to the TP multiple (exact: padded wo rows are
        # zero, so phantom heads contribute nothing)
        wq = {k_: shardwise(lambda t: F.pad(t, (0, 0, 0, Hp - H)), v_)
              for k_, v_ in wq.items()}
        wo = shardwise(lambda t: F.pad(t, (0, 0, 0, 0, 0, Hp - H)), wo)
        H = Hp
    kv_kind = "kv_heads" if head_tp_active(H) else "heads"
    q = constrain(_proj_heads(wq, x), "heads")             # (B,S,H,hd)
    k = constrain(_proj_heads(params["wk"], x), kv_kind)
    v = constrain(_proj_heads(params["wv"], x), kv_kind)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    groups = H // KV

    if cache is not None and S == 1:
        smax = cache["k"].shape[1]
        slot = int(cache_index) % smax
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][slot] = positions.reshape(1)[0].to(torch.int32)
        out = _cache_attend(q, cache, cfg, positions.reshape(1))
    else:
        use = impl or cfg.attention_impl
        out = _local_attend(q, k, v, cfg, use)
        if cache is not None:  # prefill: write the (possibly windowed) tail
            smax = cache["k"].shape[1]
            ktail = placed_like(k[:, -smax:].to(cache["k"].dtype),
                                cache["k"])
            vtail = placed_like(v[:, -smax:].to(cache["v"].dtype),
                                cache["v"])
            tailpos = positions[-smax:].to(torch.int32)
            if smax == S:
                # full cache, prefill from position 0: slots are identity
                cache["k"].copy_(ktail)
                cache["v"].copy_(vtail)
                cache["pos"].copy_(tailpos)
            else:
                # sliding window or a longer cache: the tail at its slots
                slot = tailpos.long() % smax
                _write_slots(cache["k"], slot, ktail)
                _write_slots(cache["v"], slot, vtail)
                cache["pos"][slot] = tailpos
    Hn, hd, d = wo.shape
    out = matmul(reshape(out, B, S, Hn * hd), reshape(wo, Hn * hd, d))
    return out, cache

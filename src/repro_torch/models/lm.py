"""Top-level language model: embedding → decoder stack → head → loss.

Port of ``repro/models/lm.py``:

  init_params(gen, cfg)                         -> params tree
  forward(params, inputs, cfg, ...)             -> hidden states
  loss_and_aux(params, batch, cfg)              -> scalar loss (chunked xent)
  make_train_step(cfg, lr)                      -> SGD client step
  make_prefill_step(cfg, batch, seq)            -> serve prefill
  make_decode_step(cfg)                         -> serve one-token decode

``input_kind == "embeddings"`` (audio/vlm stubs) feeds precomputed frontend
embeddings of shape (B, S, d_model) instead of token ids; the label side is
always token ids.

Training differentiates with ``torch.func`` (``grad_and_value``), which
composes with the client engine's ``vmap``; on the card the norms and the
``pallas`` attention route backpropagate through hand-written kernels
(``kernels/ops.py``).  One intended difference: ``chunked_xent`` does not
recompute each chunk's logits in the backward (JAX's ``jax.checkpoint``;
``torch.utils.checkpoint`` does not compose with ``torch.func.grad``), so
the logits of every chunk stay alive until the backward.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import tree
from repro_torch.device import as_tensor
from repro_torch.models import layers, transformer
from repro_torch.sharding.specs import (constrain, logsumexp, matmul,
                                        place_caches, placed_like,
                                        reduce_partial)


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
        return matmul(h, params["embed"]["w"].T)
    return layers.dense(params["lm_head"], h)


def forward(params, inputs, cfg, *, positions=None, caches=None,
            cache_index=None, decode=False):
    """inputs: (B,S) ids or (B,S,d) embeddings -> (hidden (B,S,d), caches,
    aux); aux is the blocks' summed auxiliary loss: the MoE FFNs' in fp32,
    0.0 for a model without one."""
    x = constrain(_embed_inputs(params, inputs, cfg), "residual")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, new_caches, aux = transformer.stack_apply(
        params["blocks"], x, cfg, positions=positions, caches=caches,
        cache_index=cache_index, decode=decode)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, new_caches, aux


def _device(params) -> torch.device:
    return params["embed"]["w"].device


def _xent(logits, labels):
    """Summed token cross-entropy, fp32.  logits: (..., V); labels:
    (...)."""
    logits = logits.to(torch.float32)
    lse = logsumexp(logits)
    gold = reduce_partial(torch.gather(logits, -1,
                                       labels[..., None].long()))
    gold = gold[..., 0]
    return torch.sum(lse - gold)


def chunked_xent(params, h, labels, cfg):
    """Mean token cross entropy over sequence chunks of the head: the
    smallest split nc | S with B·(S/nc) <= ``cfg.logit_chunk`` (the whole
    sequence when it is 0), each chunk's summed loss added in order into an
    fp32 total, as the JAX package's scan does.  The head's product runs in
    the parameter dtype; the logits are upcast to fp32 for the loss."""
    B, S, _ = h.shape
    # undo sequence parallelism before the vocab-parallel head (JAX
    # constrains each chunk; here the whole h, once, before the slices,
    # each of which would otherwise gather the sharded sequence)
    h = constrain(h, "loss_chunk")
    T = B * S
    chunk_tokens = cfg.logit_chunk or T
    nc = 1
    while nc < S and (B * (S // nc) > chunk_tokens or S % nc):
        nc += 1
    Sc = S // nc

    def one(hc, lc):
        return _xent(_head(params, hc, cfg), lc)

    if nc == 1:
        return one(h, labels) / T
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nc):
        sl = slice(c * Sc, (c + 1) * Sc)
        tot = tot + one(h[:, sl], labels[:, sl])
    return tot / T


def loss_and_aux(params, batch, cfg):
    """batch: {"inputs": (B,S)[ids]|(B,S,d)[embeds], "labels": (B,S)}."""
    h, _, aux = forward(params, batch["inputs"], cfg)
    loss = chunked_xent(params, h, batch["labels"], cfg)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss


def _batch_on(batch: Dict[str, Any], device: torch.device):
    return {k: as_tensor(v, device) for k, v in batch.items()}


def _autograd_grad_and_value(params, batch, cfg):
    """``grad_and_value(loss_and_aux)`` through ``torch.autograd.grad``
    (for DTensor params, which ``torch.func`` transforms wrap)."""
    leaves, treedef = tree.flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = loss_and_aux(tree.unflatten(treedef, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not read (an embedding fed precomputed
    # embeddings) gets zeros, as under torch.func
    grads = [torch.zeros_like(p) if g is None else placed_like(g, p)
             for g, p in zip(grads, leaves)]
    return tree.unflatten(treedef, grads), loss.detach()


def make_train_step(cfg, lr: float = 0.05, micro_batches: int = 0, *,
                    functional: bool = True):
    """Plain-SGD client local step (the FL inner loop; see core/algorithms
    for the federated wrappers).  ``train_step(params, batch) -> (new
    params, {"loss": fp32 scalar})``; the batch may be numpy or tensors.

    ``micro_batches`` > 1 accumulates gradients over k slices of the batch
    in fp32 (a Python loop in place of ``lax.scan``; the sums in place, each
    slice's gradients freed before the next slice's), then divides the loss
    and the gradients by k.  The update is ``(p − lr·g)`` in fp32, cast
    back to the parameter's dtype, leaf by leaf, with at most one leaf's
    fp32 buffer beyond the fp32 accumulators.

    ``functional=False`` takes the gradients with ``torch.autograd.grad``
    in place of ``torch.func`` (the dry run's DTensor params; the step then
    does not compose with ``vmap``)."""
    micro = micro_batches or getattr(cfg, "train_microbatches", 1) or 1
    grad_fn = (torch.func.grad_and_value(loss_and_aux) if functional
               else _autograd_grad_and_value)

    def train_step(params, batch):
        batch = _batch_on(batch, _device(params))
        if micro <= 1:
            grads, loss = grad_fn(params, batch, cfg)
        else:
            B = batch["labels"].shape[0]
            if B % micro:
                raise ValueError(f"batch {B} does not split into {micro} "
                                 f"micro-batches")
            n = B // micro
            loss = torch.zeros((), dtype=torch.float32,
                               device=_device(params))
            grads = tree.map(lambda p: torch.zeros_like(
                p, dtype=torch.float32,
                memory_format=torch.contiguous_format), params)
            for i in range(micro):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, l = grad_fn(params, mb, cfg)
                loss = loss + l
                for acc, gi in zip(tree.leaves(grads), tree.leaves(g)):
                    acc.add_(gi.to(torch.float32))
                del g
            loss = loss / micro
            for acc in tree.leaves(grads):
                acc.div_(micro)
        # −(lr·g) + p rounds as (p − lr·g) does, so it can be formed in one
        # fp32 buffer: the accumulator itself, or a copy of the gradient
        p_leaves, treedef = tree.flatten(params)
        g_leaves = tree.leaves(grads)
        del grads
        new = []
        for i, p in enumerate(p_leaves):
            t = g_leaves[i].to(torch.float32, copy=micro <= 1)
            g_leaves[i] = None
            new.append(t.mul_(lr).neg_().add_(p).to(p.dtype))
        return tree.unflatten(treedef, new), {"loss": loss}

    return train_step


def make_prefill_step(cfg, batch: int, seq_len: int, cache_len: int = 0):
    """Full-sequence forward that fills fresh decode caches.

    ``cache_len`` (>= seq_len) sizes the cache; defaults to seq_len.
    Returns ``prefill_step(params, inputs) -> (last logits (B,1,V),
    caches)``."""
    cache_len = cache_len or seq_len

    def prefill_step(params, inputs):
        caches = place_caches(transformer.stack_cache(
            cfg, batch, cache_len, layers.dtype_of(cfg.dtype),
            _device(params)))
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

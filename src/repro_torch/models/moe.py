"""Mixture-of-Experts FFN with top-k routing and fixed expert capacity.

Port of ``repro/models/moe.py``.  Two dispatch implementations, selected by
``MoEConfig.dispatch_impl``:

- ``gshard_einsum``: the GShard one-hot dispatch and combine einsums over
  token groups (the configs' default).
- ``gather``: index-based dispatch: a stable sort of the (token, k)
  assignments by expert, fixed-capacity buffers, a scatter-add combine.

Both rank an expert's assignments in the same order (token-major, then k),
so they keep and drop the same assignments.  Experts are SwiGLU, run as
batched products over the expert axis.  An auxiliary load-balancing loss
(Switch-style) is returned beside the output, in fp32.

How the port keeps JAX's results where PyTorch's defaults differ:

- The top-k takes the first k of a stable descending sort, so ties go to
  the lower expert index as in ``jax.lax.top_k`` (``torch.topk`` pins no
  order).  Equal router logits do occur in bf16, and the k-order decides
  each assignment's slot, hence which tokens are dropped.
- One-hot rows come from comparing an index with an ``arange``: an index
  past the last class (a slot ``pos >= C``, capacity overflow) gives an
  all-zero row, as ``jax.nn.one_hot`` does, on every device and under
  ``torch.func.vmap`` (``F.one_hot`` raises outside ``vmap``).
- Every index operation is out of place, so the layer runs under the client
  engine's ``vmap(grad)``.

There is no ``constrain`` (no mesh policy in the port; JAX's is an
identity without one).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.sharding.specs import constrain, local_call, reshape


def moe_init(gen: torch.Generator, cfg) -> dict:
    """Router ``N(0,1)·0.02`` (d, E); experts ``wi``, ``wg`` (E, d, f) at
    ``1/√d`` and ``wo`` (E, f, d) at ``1/√f``; each drawn in fp32 and cast
    to the model dtype."""
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.n_experts
    dtype = layers.dtype_of(cfg.dtype)
    return {
        "router": layers.normal(gen, (d, E), 0.02).to(dtype),
        "wi": layers.normal(gen, (E, d, f), 1.0 / math.sqrt(d)).to(dtype),
        "wg": layers.normal(gen, (E, d, f), 1.0 / math.sqrt(d)).to(dtype),
        "wo": layers.normal(gen, (E, f, d), 1.0 / math.sqrt(f)).to(dtype),
    }


def capacity(m, S: int) -> int:
    """Slots an expert holds in a group of S tokens."""
    return max(1, int(m.capacity_factor * S * m.top_k / m.n_experts))


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index
    (``jax.lax.top_k``'s rule): the first k of a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(params, xg, m):
    """xg: (G, S, d) grouped tokens -> (probs (G,S,E) fp32, topk_prob
    (G,S,k), topk_idx (G,S,k), aux fp32 scalar).

    The router product runs in the model dtype and is cast to fp32 after,
    as in JAX: upcasting x first would move near-ties at bf16."""
    logits = (xg @ params["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topk_prob, topk_idx = top_k(probs, m.top_k)
    # normalise the combine weights over the selected experts
    topk_prob = topk_prob / torch.clamp_min(
        torch.sum(topk_prob, dim=-1, keepdim=True), 1e-9)
    # Switch-style aux loss: E * sum_e (fraction routed to e * mean prob e)
    E = probs.shape[-1]
    sel = one_hot(topk_idx[..., 0], E, torch.float32)     # top-1 counts
    frac = torch.mean(sel, dim=(0, 1))
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(frac * mean_prob)
    return probs, topk_prob, topk_idx, aux


def _expert_ffn(params, h):
    """h: (G, E, C, d) -> (G, E, C, d): each expert's SwiGLU on its
    slots, as batched products over the expert axis.  The weights pass
    JAX's explicit ZeRO gather points (``constrain``); on DTensors (a dry
    run) each device runs its own groups through its f shards, the output
    a sum over the f shards."""
    wi = constrain(params["wi"], "moe_weight")
    wg = constrain(params["wg"], "moe_weight")
    wo = constrain(params["wo"], "moe_weight_row")
    f = params["wi"].shape[-1]
    return local_call(_swiglu_experts, (h, wi, wg, wo),
                      ((0, None), (None, 2), (None, 2), (None, 1)),
                      ((0, "sum"),), h.shape[0], f)


def _swiglu_experts(h, wi, wg, wo):
    up = torch.einsum("...ecd,edf->...ecf", h, wi)
    gate = torch.einsum("...ecd,edf->...ecf", h, wg)
    return torch.einsum("...ecf,efd->...ecd", F.silu(gate) * up, wo)


def _slots(topk_idx, E):
    """Each (token, k) assignment's position in its expert's buffer, in
    token-major then k order: (onehot_e (G,S,k,E) int32, pos (G,S,k))."""
    G, S, k = topk_idx.shape
    onehot_e = one_hot(topk_idx, E, torch.int32)
    flat = onehot_e.reshape(G, S * k, E)
    pos = torch.cumsum(flat, dim=1) - 1
    pos = torch.sum(pos * flat, dim=-1).reshape(G, S, k)
    return onehot_e, pos


def _moe_gshard(params, xg, m):
    """GShard einsum dispatch.  xg: (G, S, d)."""
    G, S, d = xg.shape
    E = m.n_experts
    C = capacity(m, S)
    _, topk_prob, topk_idx, aux = _routing(params, xg, m)
    onehot_e, pos = _slots(topk_idx, E)
    # an out-of-range slot (pos >= C) is a zero row: the overflow is dropped
    onehot_c = one_hot(pos, C, xg.dtype)                  # (G,S,k,C)
    oe = onehot_e.to(xg.dtype)
    # dispatch tensor (G,S,E,C): 1 where token s fills slot (e,c)
    disp = torch.einsum("gske,gskc->gsec", oe, onehot_c)
    comb = torch.einsum("gsk,gske,gskc->gsec", topk_prob.to(xg.dtype), oe,
                        onehot_c)
    h = torch.einsum("gsec,gsd->gecd", disp, xg)          # (G,E,C,d)
    out_e = _expert_ffn(params, h)                        # (G,E,C,d)
    out = torch.einsum("gsec,gecd->gsd", comb, out_e)
    return out, aux


def _gather_plan(topk_idx, topk_prob, E: int, C: int):
    """The gather dispatch's plan for (G, S, k) selections: the (token, k)
    assignments stably sorted by expert -> (source token, combine weight,
    buffer row, kept), each (G, S·k).  A slot is an assignment's rank in
    its expert's segment; a slot past C goes to the overflow row E·C."""
    G, S, k = topk_idx.shape
    dev = topk_idx.device
    fi = topk_idx.reshape(G, S * k)
    order = torch.argsort(fi, dim=-1, stable=True)
    fi_s = torch.gather(fi, 1, order)
    fw_s = torch.gather(topk_prob.reshape(G, S * k), 1, order)
    seg_start = torch.searchsorted(
        fi_s, torch.arange(E, device=dev).expand(G, E).contiguous())
    slot = torch.arange(S * k, device=dev) - torch.gather(seg_start, 1, fi_s)
    keep = slot < C
    buf_idx = torch.where(keep, fi_s * C + slot,
                          torch.full_like(slot, E * C))
    return order // k, fw_s, buf_idx, keep


def _moe_gather(params, xg, m):
    """Index-based dispatch, every group at once.  xg: (G, S, d).

    The combine adds each token's k weighted expert outputs into zero in
    x's dtype; JAX adds them in the sorted order of the assignments.  For
    k <= 2 the order cannot change the sum (the first add into zero is
    exact, and two-term addition commutes); for k > 2 it may round
    otherwise."""
    G, S, d = xg.shape
    E, k = m.n_experts, m.top_k
    C = capacity(m, S)
    _, topk_prob, topk_idx, aux = _routing(params, xg, m)
    tok_s, fw_s, buf_idx, keep = _gather_plan(topk_idx, topk_prob, E, C)
    rows = torch.gather(xg, 1, tok_s[..., None].expand(G, S * k, d))
    buf = torch.zeros((G, E * C + 1, d), dtype=xg.dtype,
                      device=xg.device).scatter(
        1, buf_idx[..., None].expand(G, S * k, d), rows)
    out_e = _expert_ffn(params, buf[:, :E * C].reshape(G, E, C, d))
    flat_out = out_e.reshape(G, E * C, d)
    got = torch.gather(flat_out, 1, torch.where(
        keep, buf_idx, torch.zeros_like(buf_idx))[..., None].expand(
            G, S * k, d))
    gathered = torch.where(keep[..., None], got, torch.zeros_like(got))
    y = torch.zeros((G, S, d), dtype=xg.dtype, device=xg.device).scatter_add(
        1, tok_s[..., None].expand(G, S * k, d),
        gathered * fw_s[..., None].to(xg.dtype))
    return y, aux


def _group(x, m):
    """x: (B, S, d) -> (xg (G, gs, d), pad).  Tokens are routed in groups of
    ``gs = min(group_size, B·S)``: rows are split (S % gs == 0) or batched
    together (gs % S == 0); otherwise the flat tokens are zero-padded to a
    whole number of groups, the pad dropped after, as in JAX."""
    B, S, d = x.shape
    T = B * S
    gs = min(m.group_size, T)
    pad = 0 if (S % gs == 0 or gs % S == 0) else (-T) % gs
    xf = reshape(x, T, d)
    if pad:
        xf = torch.cat([xf, torch.zeros((pad, d), dtype=x.dtype,
                                        device=x.device)])
    return reshape(xf, (T + pad) // gs, gs, d), pad


def moe_ffn(params, x, cfg):
    """x: (B, S, d) -> (out (B,S,d), aux fp32 scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    # tokens over dp alone before the grouping merges batch and sequence
    xg, pad = _group(constrain(x, "tokens"), m)
    xg = constrain(xg, "moe_group")
    if m.dispatch_impl == "gather":
        out, aux = _moe_gather(params, xg, m)
    else:
        out, aux = _moe_gshard(params, xg, m)
    if pad:
        out = reshape(out, B * S + pad, d)[:B * S]
    return reshape(out, B, S, d), aux


def routing_stats(params, x, cfg) -> dict:
    """The routing ``moe_ffn`` takes for ``x`` (B, S, d), for checks and
    reports: ``probs`` and ``topk_idx`` (G, gs, k), the assignments the
    gshard dispatch keeps (``kept``, a bool (G, gs, k): slot < capacity),
    how many each dispatch drops (``dropped``, ``dropped_gather``), and how
    many tokens have a tie at their top-k boundary (the k-th and (k+1)-th
    largest probabilities equal)."""
    m = cfg.moe
    xg, _ = _group(x, m)
    C = capacity(m, xg.shape[1])
    probs, topk_prob, topk_idx, _ = _routing(params, xg, m)
    _, pos = _slots(topk_idx, m.n_experts)
    kept = pos < C
    keep = _gather_plan(topk_idx, topk_prob, m.n_experts, C)[3]
    ties = 0
    if m.top_k < m.n_experts:
        srt = torch.sort(probs, dim=-1, descending=True).values
        ties = int((srt[..., m.top_k - 1] == srt[..., m.top_k]).sum())
    return {"probs": probs, "topk_idx": topk_idx, "kept": kept,
            "dropped": int((~kept).sum()),
            "dropped_gather": int((~keep).sum()), "boundary_ties": ties}

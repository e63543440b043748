"""State-space / recurrent sequence mixers: Mamba-style SSD and xLSTM blocks.

Port of ``repro/models/ssm.py``.  The SSD and mLSTM mixers share the
chunked scalar-decay linear recurrence; its prefill (a scan from a zero
state) goes through ``kernels/ops.ssm_scan`` — the hand-written Hopper
kernel for a CUDA tensor, its plain version for a CPU one — and a decode
step, which carries a state, runs the plain chunked form, as attention runs
the flash kernel in the prefill and plain PyTorch over the cache in the
decode.  The sLSTM mixes its hidden state at every step and is a plain time
loop, as in JAX.

All mixers expose, with the JAX package's names, param trees and dtypes:
  *_init(gen, cfg) -> params
  *_apply(params, x, cfg) -> (y, state)              (prefill)
  *_step(params, x_t, state, cfg) -> (y_t, state)    (decode)
  *_init_state(cfg, batch, dtype, device) -> state
States are new tensors, as in JAX; the decoder stack copies them into its
cache.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssm_scan import ssm_scan_plain
from repro_torch.models import layers

f32 = torch.float32


# ---------------------------------------------------------------------------
# Chunked scalar-decay linear recurrence (shared by SSD and mLSTM)
#
#   h_t = a_t * h_{t-1} + k_t (outer) v_t        h: (N, P)
#   y_t = q_t @ h_t                              q,k: (N,), v: (P,)
# with a_t in (0, 1] a scalar per (batch, head, t).
# ---------------------------------------------------------------------------

def chunked_linear_scan(q, k, v, log_a, h0: Optional[torch.Tensor],
                        chunk: int):
    """q,k: (B,S,H,N); v: (B,S,H,P); log_a: (B,S,H) (<= 0); h0: (B,H,N,P)
    or None (a zero state: the prefill, which takes ``ops.ssm_scan``).

    Returns (y: (B,S,H,P) in v's dtype, h_final: (B,H,N,P) fp32)."""
    if h0 is None:
        return kops.ssm_scan(q, k, v, log_a, chunk=chunk)
    return ssm_scan_plain(q, k, v, log_a, chunk, h0)


def linear_scan_step(q_t, k_t, v_t, a_t, h):
    """Single decode step of the same recurrence.  q_t,k_t: (B,H,N);
    v_t: (B,H,P); a_t: (B,H); h: (B,H,N,P)."""
    h = a_t[..., None, None] * h + \
        k_t[..., :, None].to(f32) * v_t[..., None, :].to(f32)
    y = torch.einsum("bhn,bhnp->bhp", q_t.to(f32), h)
    return y.to(v_t.dtype), h


def sequential_linear_scan(q, k, v, log_a, h0):
    """Step-by-step reference for testing the chunked form."""
    h = h0.to(f32)
    ys = []
    for t in range(q.shape[1]):
        y, h = linear_scan_step(q[:, t], k[:, t], v[:, t],
                                torch.exp(log_a[:, t].to(f32)), h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# Mamba-style SSD mixer (used by hymba's mamba heads)
# ---------------------------------------------------------------------------

def mamba_init(gen: torch.Generator, cfg) -> dict:
    sc = cfg.ssm
    d = cfg.d_model
    di = sc.expand * d
    H = sc.n_heads
    N = sc.d_state
    dtype = layers.dtype_of(cfg.dtype)
    return {
        "in_proj": layers.dense_init(gen, d, 2 * di, dtype),
        "conv": layers.normal(gen, (sc.d_conv, di),
                              1.0 / np.sqrt(sc.d_conv)).to(dtype),
        "bc_proj": layers.dense_init(gen, di, 2 * N, dtype),
        "dt_proj": layers.dense_init(gen, di, H, dtype, bias=True),
        "out_proj": layers.dense_init(gen, di, d, dtype),
        # A < 0 per head; D skip per head; fp32 whatever cfg.dtype is
        "log_neg_a": torch.zeros((H,), dtype=f32, device=gen.device),
        "d_skip": torch.ones((H,), dtype=f32, device=gen.device),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B,S,di); w: (K,di).
    If state (B,K-1,di) is given, runs in streaming mode and returns
    (y, new_state); else pads with zeros.  The K products are summed in
    x's dtype, as in JAX."""
    K = w.shape[0]
    if state is not None:
        xx = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = xx[:, -(K - 1):] if K > 1 else state
    else:
        xx = F.pad(x, (0, 0, K - 1, 0))
        new_state = None
    S = x.shape[1]
    y = xx[:, 0:S] * w[0][None, None, :]
    for i in range(1, K):
        y = y + xx[:, i:i + S] * w[i][None, None, :]
    return y, new_state


def mamba_apply(params, x, cfg, conv_state=None, h0=None):
    """x: (B,S,d) -> (y, (conv_state, h_final))."""
    sc = cfg.ssm
    B, S, _ = x.shape
    di = sc.expand * cfg.d_model
    H, N = sc.n_heads, sc.d_state
    P = di // H
    xs, z = torch.chunk(layers.dense(params["in_proj"], x), 2, dim=-1)
    xc, new_conv = _causal_conv(xs, params["conv"], conv_state)
    xc = F.silu(xc)
    Bm, Cm = torch.chunk(layers.dense(params["bc_proj"], xc), 2, dim=-1)
    dt = F.softplus(layers.dense(params["dt_proj"], xc).to(f32))
    A = -torch.exp(params["log_neg_a"])                      # (H,) < 0
    log_a = dt * A                                           # (B,S,H)
    v = xc.reshape(B, S, H, P) * dt[..., None].to(xc.dtype)
    # the heads share q and k: views with a stride of 0 along H
    q = Cm[:, :, None, :].expand(B, S, H, N)
    k = Bm[:, :, None, :].expand(B, S, H, N)
    y, h_final = chunked_linear_scan(q, k, v, log_a, h0, sc.chunk_size)
    y = y + xc.reshape(B, S, H, P) * \
        params["d_skip"][None, None, :, None].to(xc.dtype)
    y = y.reshape(B, S, H * P) * F.silu(z)
    return layers.dense(params["out_proj"], y), (new_conv, h_final)


def mamba_init_state(cfg, batch: int, dtype, device=None) -> dict:
    sc = cfg.ssm
    di = sc.expand * cfg.d_model
    H, N, P = sc.n_heads, sc.d_state, di // sc.n_heads
    return {
        "conv": torch.zeros((batch, sc.d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, H, N, P), dtype=f32, device=device),
    }


def mamba_step(params, x_t, state, cfg):
    """x_t: (B,1,d) decode step -> (y_t (B,1,d), new state)."""
    y, (conv, h) = mamba_apply(params, x_t, cfg, conv_state=state["conv"],
                               h0=state["h"])
    return y, {"conv": conv, "h": h}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (chunked) and sLSTM (sequential) blocks
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    di = cfg.xlstm.mlstm_expand * d
    H = cfg.n_heads
    dtype = layers.dtype_of(cfg.dtype)
    return {
        "up": layers.dense_init(gen, d, 2 * di, dtype),
        "wq": layers.dense_init(gen, di, di, dtype),
        "wk": layers.dense_init(gen, di, di, dtype),
        "wv": layers.dense_init(gen, di, di, dtype),
        "wi": layers.dense_init(gen, di, H, dtype, bias=True),
        "wf": layers.dense_init(gen, di, H, dtype, bias=True),
        "down": layers.dense_init(gen, di, d, dtype),
    }


def _mlstm_core(params, xs, cfg, h0):
    """xs: (B,S,di).  Returns (y (B,S,di), h_final)."""
    B, S, di = xs.shape
    H = cfg.n_heads
    P = di // H
    q = layers.dense(params["wq"], xs).reshape(B, S, H, P)
    # JAX divides by the numpy scalar np.sqrt(P), which is not weakly typed:
    # k is promoted to fp32 whatever cfg.dtype is, and the port keeps that
    k = layers.dense(params["wk"], xs).reshape(B, S, H, P).to(f32) / \
        math.sqrt(P)
    v = layers.dense(params["wv"], xs).reshape(B, S, H, P)
    # exponential-family gates kept in (0,1) via log-sigmoid for stability
    log_f = F.logsigmoid(layers.dense(params["wf"], xs).to(f32))   # (B,S,H)
    i_gate = torch.exp(F.logsigmoid(layers.dense(params["wi"], xs).to(f32)))
    kg = k * i_gate[..., None].to(k.dtype)
    # append a ones-channel to v to carry the normaliser n_t
    v1 = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    y1, h_final = chunked_linear_scan(q, kg, v1, log_f, h0,
                                      cfg.xlstm.chunk_size)
    y, n = y1[..., :P], y1[..., P:]
    y = y / torch.clamp_min(torch.abs(n), 1.0).to(y.dtype)
    return y.reshape(B, S, di), h_final


def mlstm_apply(params, x, cfg, h0=None):
    """x: (B,S,d) -> (y, h_final); h0 None is the zero state (the
    prefill, through the scan kernel)."""
    xs, z = torch.chunk(layers.dense(params["up"], x), 2, dim=-1)
    y, h_final = _mlstm_core(params, xs, cfg, h0)
    y = y * F.silu(z)
    return layers.dense(params["down"], y), h_final


def mlstm_init_state(cfg, batch: int, dtype, device=None) -> dict:
    di = cfg.xlstm.mlstm_expand * cfg.d_model
    H, P = cfg.n_heads, di // cfg.n_heads
    return {"h": torch.zeros((batch, H, P, P + 1), dtype=f32, device=device)}


def mlstm_step(params, x_t, state, cfg):
    y, h = mlstm_apply(params, x_t, cfg, h0=state["h"])
    return y, {"h": h}


def slstm_init(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    dtype = layers.dtype_of(cfg.dtype)
    return {
        # 4 gates (i, f, z, o) from input and recurrent hidden state
        "wx": layers.dense_init(gen, d, 4 * d, dtype, bias=True),
        "wh": layers.dense_init(gen, d, 4 * d, dtype),
        "out": layers.dense_init(gen, d, d, dtype),
    }


def slstm_init_state(cfg, batch: int, dtype, device=None) -> dict:
    """fp32 zeros whatever ``dtype`` is, as in JAX."""
    d = cfg.d_model
    return {key: torch.zeros((batch, d), dtype=f32, device=device)
            for key in ("c", "n", "h", "m")}


def _slstm_cell(gx_t, wh, st):
    """gx_t: (B,4d) fp32, the input's gate pre-activations; wh: (d,4d)
    fp32.  Stabilised exponential-gating sLSTM cell."""
    gates = gx_t + st["h"] @ wh
    gi, gf, gz, go = torch.chunk(gates, 4, dim=-1)
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(log_f + st["m"], gi)               # stabiliser
    i_p = torch.exp(gi - m_new)
    f_p = torch.exp(log_f + st["m"] - m_new)
    c = f_p * st["c"] + i_p * torch.tanh(gz)
    n = f_p * st["n"] + i_p
    h = torch.sigmoid(go) * c / torch.clamp_min(n, 1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_apply(params, x, cfg, state=None):
    """x: (B,S,d) -> (y, final state).  A Python loop over time; the input
    projection of every step is one product before the loop (JAX computes
    it inside its scan: the same values, another summation blocking).  The
    JAX version's per-chunk ``jax.checkpoint`` is a training-memory device
    and has no counterpart here."""
    B, S, _ = x.shape
    st = state or slstm_init_state(cfg, B, x.dtype, x.device)
    gx = layers.dense(params["wx"], x).to(f32)               # (B,S,4d)
    wh = params["wh"]["w"].to(f32)
    hs = []
    for t in range(S):
        st = _slstm_cell(gx[:, t], wh, st)
        hs.append(st["h"])
    y = torch.stack(hs, dim=1).to(x.dtype)
    return layers.dense(params["out"], y), st


def slstm_step(params, x_t, state, cfg):
    """x_t: (B,1,d)."""
    gx = layers.dense(params["wx"], x_t[:, 0]).to(f32)
    st = _slstm_cell(gx, params["wh"]["w"].to(f32), state)
    y = layers.dense(params["out"], st["h"].to(x_t.dtype))
    return y[:, None], st

"""State-space / recurrent sequence mixers: Mamba-style SSD and xLSTM blocks.

Port of ``repro/models/ssm.py``.  The SSD and mLSTM mixers share the
chunked scalar-decay linear recurrence; its prefill (a scan from a zero
state) goes through ``kernels/ops.ssm_scan`` — the hand-written Hopper
kernel for a CUDA tensor, its plain version for a CPU one — and a decode
step, which carries a state, runs the plain chunked form, as attention runs
the flash kernel in the prefill and plain PyTorch over the cache in the
decode.  Under autograd the scan's gradient goes through its backward
kernel (``ops.ssm_scan``'s Function).  The sLSTM mixes its hidden state at
every step and is a time loop, as in JAX, run in time chunks whose
backward recomputes the chunk's steps (JAX's per-chunk ``jax.checkpoint``).

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
from repro_torch.sharding.specs import (head_tp_active, local_call, reshape,
                                        shardwise)

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

    Returns (y: (B,S,H,P) in v's dtype, h_final: (B,H,N,P) fp32).  On
    DTensors (a dry run) each device scans its own batch rows and heads, or,
    where the heads do not divide the model axis and the value columns do,
    its own value columns (each column of v, the state and y is a scan of
    its own)."""
    def scan(q, k, v, log_a, h0):
        if h0 is None:
            return kops.ssm_scan(q, k, v, log_a, chunk=chunk)
        return ssm_scan_plain(q, k, v, log_a, chunk, h0)

    H, P = v.shape[2], v.shape[3]
    if head_tp_active(H) or not head_tp_active(P):
        bh = (0, 2)
        return local_call(scan, (q, k, v, log_a, h0),
                          (bh, bh, bh, bh, (0, 1)), (bh, (0, 1)), q.shape[0],
                          H)
    rows, cols = (0, None), (0, 3)
    return local_call(scan, (q, k, v, log_a, h0),
                      (rows, rows, cols, rows, cols), (cols, cols),
                      q.shape[0], P)


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
    v = reshape(xc, B, S, H, P) * dt[..., None].to(xc.dtype)
    # the heads share q and k: views with a stride of 0 along H
    q = Cm[:, :, None, :].expand(B, S, H, N)
    k = Bm[:, :, None, :].expand(B, S, H, N)
    y, h_final = chunked_linear_scan(q, k, v, log_a, h0, sc.chunk_size)
    y = y + reshape(xc, B, S, H, P) * \
        params["d_skip"][None, None, :, None].to(xc.dtype)
    y = reshape(y, B, S, H * P) * F.silu(z)
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
    q = reshape(layers.dense(params["wq"], xs), B, S, H, P)
    # JAX divides by the numpy scalar np.sqrt(P), which is not weakly typed:
    # k is promoted to fp32 whatever cfg.dtype is, and the port keeps that
    k = reshape(layers.dense(params["wk"], xs), B, S, H, P).to(f32) / \
        math.sqrt(P)
    v = reshape(layers.dense(params["wv"], xs), B, S, H, P)
    # exponential-family gates kept in (0,1) via log-sigmoid for stability
    log_f = shardwise(F.logsigmoid,
                      layers.dense(params["wf"], xs).to(f32))     # (B,S,H)
    i_gate = torch.exp(shardwise(F.logsigmoid,
                                 layers.dense(params["wi"], xs).to(f32)))
    kg = k * i_gate[..., None].to(k.dtype)
    # append a ones-channel to v to carry the normaliser n_t
    v1 = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    y1, h_final = chunked_linear_scan(q, kg, v1, log_f, h0,
                                      cfg.xlstm.chunk_size)
    y, n = y1[..., :P], y1[..., P:]
    y = y / torch.clamp_min(torch.abs(n), 1.0).to(y.dtype)
    return reshape(y, B, S, di), h_final


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


def _slstm_steps(gx, wh, st):
    """The cell over gx's steps -> (hs (B,T,d), final state)."""
    hs = []
    for gx_t in gx.unbind(1):
        st = _slstm_cell(gx_t, wh, st)
        hs.append(st["h"])
    return torch.stack(hs, dim=1), st


def _tie_split(x, y):
    """d max(x, y) / dx as JAX takes it: 1 where x > y, 0 where x < y and
    0.5 at a tie (``torch.clamp_min`` would pass the whole gradient)."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


class _SlstmChunkFn(torch.autograd.Function):
    """One time chunk of the sLSTM: ``(hs, c, n, h, m) = steps(gx, wh, c0,
    n0, h0, m0)``, gx (B,T,4d) and wh (d,4d) fp32, the state (B,d) fp32.

    JAX's per-chunk ``jax.checkpoint`` (``repro/models/ssm.py``
    ``slstm_apply``): the forward saves the chunk's inputs and starting
    state only, and the backward recomputes the chunk's steps and
    back-propagates through them in closed form.  The BPTT is written out
    because ``torch.utils.checkpoint`` and a nested ``torch.autograd.grad``
    do not compose with ``torch.func.grad``.  ``wh`` differs per client
    under the client engine's vmap, so the vmap rule is generated (the
    backward's products batch over the clients)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(gx, wh, c, n, h, m):
        hs, st = _slstm_steps(gx, wh, {"c": c, "n": n, "h": h, "m": m})
        return hs, st["c"], st["n"], st["h"], st["m"]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        # torch.func.grad differentiates with create_graph=True, which
        # would record (and keep until the whole backward ends) every
        # intermediate of this chunk's BPTT; the gradient is not
        # differentiable again
        with torch.no_grad():
            return _slstm_chunk_bwd(ctx.saved_tensors, dhs, dc, dn, dh, dm)


def _slstm_chunk_bwd(saved, dhs, dc, dn, dh, dm):
    """:class:`_SlstmChunkFn`'s backward: recompute the chunk, then its
    BPTT in closed form -> (dgx, dwh, dc0, dn0, dh0, dm0)."""
    gx, wh, c, n, h, m = saved
    T = gx.shape[1]
    # recompute the chunk's steps, keeping each step's starting state
    carries = [(c, n, h, m)]
    for gx_t in gx.unbind(1)[:-1]:
        st = _slstm_cell(gx_t, wh, dict(zip("cnhm", carries[-1])))
        carries.append((st["c"], st["n"], st["h"], st["m"]))
    c0, n0, h0, m0 = (torch.stack(x, dim=1) for x in zip(*carries))
    # the cell's forward and every factor of its derivative that does
    # not depend on the gradient carried back, for all T steps at once
    gi, gf, gz, go = torch.chunk(gx + h0 @ wh, 4, dim=-1)
    a = F.logsigmoid(gf) + m0
    m1 = torch.maximum(a, gi)
    i_p = torch.exp(gi - m1)
    f_p = torch.exp(a - m1)
    tz = torch.tanh(gz)
    c1 = f_p * c0 + i_p * tz
    n1 = f_p * n0 + i_p
    sg = torch.sigmoid(go)
    nc = torch.clamp_min(n1, 1.0)
    wa = _tie_split(a, gi)
    per_step = [x.unbind(1) for x in (
        sg / nc,                                   # dh -> dc
        sg * c1 / (nc * nc) * _tie_split(n1, 1.0),  # dh -> -dn
        c1 / nc * sg * (1.0 - sg),                 # dh -> dgo
        c0, n0, tz, f_p, i_p, wa, 1.0 - wa, torch.sigmoid(-gf),
        i_p * (1.0 - tz * tz))]
    dhs = dhs.unbind(1)
    whT = wh.T
    dgs = [None] * T
    for t in reversed(range(T)):
        (k_c, k_n, k_o, c0_t, n0_t, tz_t, f_t, i_t, wa_t, wg_t, sf_t,
         k_z) = (x[t] for x in per_step)
        dh_t = dhs[t] + dh
        # h = sg·c / max(n, 1);  c = f·c0 + i·tanh(gz);  n = f·n0 + i
        dc1 = torch.addcmul(dc, dh_t, k_c)
        dn1 = dn - dh_t * k_n
        d_f = torch.addcmul(dc1 * c0_t, dn1, n0_t) * f_t
        d_i = torch.addcmul(dn1, dc1, tz_t) * i_t
        dc, dn = dc1 * f_t, dn1 * f_t
        # f = exp(a - m), i = exp(gi - m), m = max(a, gi)
        dm1 = dm - d_f - d_i
        dm = torch.addcmul(d_f, dm1, wa_t)                    # da
        dgs[t] = torch.cat([torch.addcmul(d_i, dm1, wg_t), dm * sf_t,
                            dc1 * k_z, dh_t * k_o], dim=-1)
        dh = dgs[t] @ whT
    dgx = torch.stack(dgs, dim=1)
    dwh = torch.einsum("btd,bte->de", h0, dgx)
    return dgx, dwh, dc, dn, dh, dm


def _slstm_chunk(cfg, S: int) -> int:
    """JAX's recompute chunk: ``xlstm.chunk_size`` (256 without an xlstm
    config), or the whole sequence when it does not split into more than
    one chunk."""
    Tc = cfg.xlstm.chunk_size if cfg.xlstm else 256
    return S if S % Tc or S <= Tc else Tc


def slstm_apply(params, x, cfg, state=None):
    """x: (B,S,d) -> (y, final state).  The input projection of every step
    is one product before the time loop (JAX computes it inside its scan:
    the same values, another summation blocking); the loop runs in
    :class:`_SlstmChunkFn` chunks, JAX's chunked-remat BPTT."""
    B, S, _ = x.shape
    st = state or slstm_init_state(cfg, B, x.dtype, x.device)
    gx = layers.dense(params["wx"], x).to(f32)               # (B,S,4d)
    wh = params["wh"]["w"].to(f32)
    Tc = _slstm_chunk(cfg, S)
    carry = (st["c"], st["n"], st["h"], st["m"])
    hs = []
    rows, whole = (0, None), (None, None)
    for c0 in range(0, S, Tc):
        # on DTensors (a dry run) each device runs its own batch rows
        hc, *carry = local_call(_SlstmChunkFn.apply,
                                (gx[:, c0:c0 + Tc], wh, *carry),
                                (rows, whole) + (rows,) * 4, (rows,) * 5, B)
        hs.append(hc)
    y = torch.cat(hs, dim=1).to(x.dtype)
    return layers.dense(params["out"], y), dict(zip("cnhm", carry))


def slstm_apply_plain(params, x, cfg, state=None):
    """:func:`slstm_apply` as one plain time loop, differentiated by
    autograd step by step (every step's gates stay alive for the
    backward): the plain version the tests hold the chunk Function to."""
    B, S, _ = x.shape
    st = state or slstm_init_state(cfg, B, x.dtype, x.device)
    gx = layers.dense(params["wx"], x).to(f32)
    hs, st = _slstm_steps(gx, params["wh"]["w"].to(f32), st)
    return layers.dense(params["out"], hs.to(x.dtype)), st


def slstm_step(params, x_t, state, cfg):
    """x_t: (B,1,d)."""
    gx = layers.dense(params["wx"], x_t[:, 0]).to(f32)
    st = _slstm_cell(gx, params["wh"]["w"].to(f32), state)
    y = layers.dense(params["out"], st["h"].to(x_t.dtype))
    return y[:, None], st

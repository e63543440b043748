"""Basic neural-net layers (functional, nested-dict params).

Port of ``repro/models/layers.py``.  Every layer is an ``*_init`` function
that returns a params dict and a pure apply function over it, with the JAX
package's param names and shapes, so ``convert.params_from_jax`` carries a
JAX tree across leaf for leaf.  The ``*_init`` functions draw from an
explicit ``torch.Generator`` (on the device the params are made on) in
place of a ``jax.random`` key: the two give different numbers from the same
seed, so the parity tests hand JAX's params over instead.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.sharding.specs import lookup, matmul, rowwise, zero_gather

Params = dict


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    """fp32 N(0, std^2) draws on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * std


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               bias: bool = False, scale: Optional[float] = None) -> Params:
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p = {"w": normal(gen, (d_in, d_out), scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + zero_gather(p["b"])
    return y


def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    return {"w": normal(gen, (vocab, d), 0.02).to(dtype)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return lookup(p["w"], ids)


def rmsnorm_init(d: int, dtype, device=None) -> Params:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in fp32, cast back to x's dtype: the hand-written kernel
    for a CUDA tensor, its plain version for a CPU one (``ops.rmsnorm``);
    a DTensor's rows on each shard (``specs.rowwise``)."""
    return rowwise(lambda x_, g: kops.rmsnorm(x_, g, eps), x, p["g"])


def layernorm_init(d: int, dtype, device=None) -> Params:
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].to(torch.float32)
            + p["b"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotates
    the two halves of hd (not interleaved pairs), with fp32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd//2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd//2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, hd//2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d: int, f: int, dtype) -> Params:
    return {
        "wi": dense_init(gen, d, f, dtype),
        "wg": dense_init(gen, d, f, dtype),
        "wo": dense_init(gen, f, d, dtype),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(p["wg"], x)) * dense(p["wi"], x)
    return dense(p["wo"], h)

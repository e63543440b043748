"""Flash attention: online-softmax attention, causal with an optional
sliding window (``kpos > qpos - window``), with grouped KV heads read in
place.

Port of ``repro/kernels/flash_attention.py``.  The Pallas TPU kernel
(``_flash_kernel``) becomes ``csrc/flash_attention.cu``, CUDA C++ for
Hopper written by hand; its source note gives the bound and the design.
This module holds its forms, all on the JAX public layout: q ``(B, Sq, H,
hd)``, k and v ``(B, Skv, KV, hd)`` with ``H % KV == 0`` (query head h reads
KV head ``h // (H // KV)``, ``jnp.repeat``'s order; ``KV == H`` is the JAX
call form):

* :func:`flash_attention_plain` — the plain PyTorch version, a port of
  ``repro/kernels/ref.py:flash_attention_ref`` on the repeated heads (fp32
  scores, ``-1e30`` masking, softmax, output in q's dtype).  The CPU tests
  use it, and ``chip_smoke.py`` holds the kernel against it on the card.
* :func:`flash_attention_cuda` — the launch of a CUDA kernel, picked by the
  dtype: bf16 runs the tensor-core kernel (wgmma, TMA loads), fp32 the
  CUDA-core kernel (exact fp32 products).  Both read and write the tensors
  in place through their strides, and write the rows' log-sum-exp when
  given a buffer for it (training; serving passes none).
* :func:`flash_attention_fwd_plain` — the plain forward with that
  log-sum-exp (:func:`flash_attention_plain` is its output alone), for the
  CPU route of training.
* :func:`flash_attention_bwd_plain` / :func:`flash_attention_bwd_cuda` —
  the backward, FlashAttention-2's algorithm (``D = rowsum(dO∘O)``, ``P =
  exp(S·scale − lse)``, ``dS = P∘(dO·Vᵀ − D)``), in plain PyTorch and as the
  launch of the hand-written CUDA kernels of ``csrc/flash_attention_bwd.cu``
  on the route :func:`bwd_route` picks from the dtype and the head dim
  (bf16 at ``BWD_TC_HEAD_DIMS`` through wgmma, fp32 at
  ``BWD_TF32_HEAD_DIMS`` on the tensor cores as three TF32 passes a
  product, the rest on the CUDA cores); it replaces no TPU kernel (the
  Pallas kernel has no VJP).

The public wrapper (its autograd and vmap rules, and the launch counters)
is ``ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# head dims the kernel is instantiated for: the JAX kernel's {64, 96, 128,
# 192}, plus 16 and 32 so the reduced test configs run through it too
HEAD_DIMS = (16, 32, 64, 96, 128, 192)
DTYPES = (torch.float32, torch.bfloat16)
MAX_BH = 65535          # B*H rides on the fp32 kernel's grid y dimension
# the route each dtype's forward launches: bf16 on the tensor cores, fp32 on
# the CUDA cores (one pass of TF32 would break the fp32 tolerances)
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
# the head dims whose backward runs on the tensor cores: bf16 through
# wgmma, fp32 as three TF32 passes a product (route "tf32x3", which keeps
# fp32's accuracy).  Past them a thread's share of the dK and dV
# accumulators beside S and dP would pass its registers (the kernel's
# note: the fp32 kernel spills at hd 96), so those backwards run on the
# CUDA cores
BWD_TC_HEAD_DIMS = (16, 32, 64, 96, 128)
BWD_TF32_HEAD_DIMS = (16, 32, 64)
BWD_ROUTES = ("tensor_cores", "tf32x3", "cuda_cores")
# rows a tile of the tensor-core backward: its workspace pads each (b, h)
# row block of lse and D to a whole tile
BWD_TILE = 64
# the tensor-core launchers' answer to a layout TMA cannot load
# (cudaErrorMisalignedAddress)
_RC_TMA_LAYOUT = 716


def _repeat_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """k and v at q's head count (each KV head serves H // KV heads)."""
    H = q.shape[2]
    if k.shape[2] != H:
        k = torch.repeat_interleave(k, H // k.shape[2], dim=2)
        v = torch.repeat_interleave(v, H // v.shape[2], dim=2)
    return k, v


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """Scaled fp32 scores (B, H, Sq, Skv) of repeated-head k, masked with
    ``NEG_INF``."""
    Sq, hd, Skv = q.shape[1], q.shape[3], k.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > (qpos - window)
    return torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H % KV == 0 -> (B, Sq,
    H, hd) in q's dtype."""
    return flash_attention_fwd_plain(q, k, v, causal=causal,
                                     window=window)[0]


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0):
    """The plain forward and the rows' log-sum-exp of the scaled scores:
    ``(o (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) fp32)``."""
    kk, vv = _repeat_heads(q, k, v)
    s = _scores(q, kk, causal, window)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv.to(torch.float32))
    return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def flash_attention_bwd_plain(do: torch.Tensor, q: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True, window: int = 0):
    """The backward of the forward that gave ``o`` and ``lse``: ``(dq, dk,
    dv)`` in q's dtype, dk and dv at k's KV heads (the sum over each KV
    head's group of query heads).  The kernel's algorithm on dense tiles in
    fp32: ``D = rowsum(dO∘O)``, ``P = exp(S·scale − lse)`` (0 where
    masked), ``dV = Pᵀ·dO``, ``dS = P∘(dO·Vᵀ − D)``, ``dQ = scale·dS·K``,
    ``dK = scale·dSᵀ·Q``."""
    B, Skv, KV, hd = k.shape
    H = q.shape[2]
    kk, vv = _repeat_heads(q, k, v)
    s = _scores(q, kk, causal, window)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dof = do.to(torch.float32)
    dd = torch.sum(dof * o.to(torch.float32), dim=-1).transpose(1, 2)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vv.to(torch.float32))
    ds = p * (dp - dd[..., None])
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kk.to(torch.float32)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(torch.float32)) * scale
    if KV != H:                      # sum each KV head's group
        dk = dk.reshape(B, Skv, KV, H // KV, hd).sum(dim=3)
        dv = dv.reshape(B, Skv, KV, H // KV, hd).sum(dim=3)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


_launchers = {}


def _launcher(route: str):
    fn = _launchers.get(route)
    if fn is None:
        lib = _build.load("flash_attention")
        fn = (lib.flash_attention_bf16_launch if route == "tensor_cores"
              else lib.flash_attention_fp32_launch)
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launchers[route] = fn
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, *, causal: bool, window: int,
                         lse: Optional[torch.Tensor] = None) -> str:
    """Launch the dtype's kernel on the current stream, writing ``out`` (B,
    Sq, H, hd) and, when given, ``lse`` (B, H, Sq) fp32 contiguous; returns
    the route it took (``ROUTES``).  The caller has checked devices, dtypes,
    shapes and strides (``ops._check_flash``); the tensor-core launcher
    checks what TMA needs (a ValueError here).  Raises if the launch
    fails."""
    B, Sq, H, hd = q.shape
    strides = [t.stride(a) for t in (q, k, v, out) for a in (0, 1, 2)]
    arr = (ctypes.c_longlong * 12)(*strides)
    route = ROUTES[q.dtype]
    scale = 1.0 / math.sqrt(hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher(route)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(),
                              None if lse is None else lse.data_ptr(),
                              arr, B, H, k.shape[2], Sq,
                              k.shape[1], hd, int(causal), int(window), scale,
                              stream)
    if rc == _RC_TMA_LAYOUT and route == "tensor_cores":
        raise ValueError(f"bf16 q, k and v need 16-byte aligned addresses "
                         f"and (batch, seq, head) strides that are multiples"
                         f" of 8 elements (TMA), got strides {q.stride()}, "
                         f"{k.stride()}, {v.stride()}")
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: error {rc} "
                           f"(q {tuple(q.shape)}, kv {tuple(k.shape)}, "
                           f"{q.dtype}, {route})")
    return route


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The route of the backward for this dtype and head dim (one of
    ``BWD_ROUTES``), by shape alone: bf16 ``tensor_cores`` at
    ``BWD_TC_HEAD_DIMS``, fp32 ``tf32x3`` at ``BWD_TF32_HEAD_DIMS``, else
    ``cuda_cores``."""
    if dtype == torch.bfloat16:
        return "tensor_cores" if hd in BWD_TC_HEAD_DIMS else "cuda_cores"
    return "tf32x3" if hd in BWD_TF32_HEAD_DIMS else "cuda_cores"


def bwd_workspace_numel(B: int, H: int, Sq: int) -> int:
    """fp32 elements of the backward's workspace, for either route: the
    tensor-core route's lse·log2(e) and D rows, each (b, h) padded to a
    whole ``BWD_TILE`` (the CUDA-core route uses the first B·H·Sq for
    D)."""
    return 2 * B * H * (-(-Sq // BWD_TILE) * BWD_TILE)


_bwd_launchers = {}


def _bwd_launcher(route: str):
    fn = _bwd_launchers.get(route)
    if fn is None:
        lib = _build.load("flash_attention_bwd")
        if route in ("tensor_cores", "tf32x3"):
            fn = (lib.flash_attention_bwd_bf16_launch
                  if route == "tensor_cores"
                  else lib.flash_attention_bwd_tf32_launch)
            tail = [ctypes.c_float, ctypes.c_void_p]
        else:
            fn = lib.flash_attention_bwd_launch
            tail = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 8 + tail)
        fn.restype = ctypes.c_int
        _bwd_launchers[route] = fn
    return fn


def flash_attention_bwd_cuda(do: torch.Tensor, q: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor,
                             dq: torch.Tensor, dk: torch.Tensor,
                             dv: torch.Tensor, ws: torch.Tensor, *,
                             causal: bool, window: int) -> str:
    """Launch the backward of :func:`bwd_route`'s route on the current
    stream, writing ``dq`` (q's shape) and ``dk``, ``dv`` (k's shape), all
    in q's dtype; ``lse`` the forward's (B, H, Sq) fp32, ``ws`` fp32
    scratch of :func:`bwd_workspace_numel` elements.  Every tensor is read
    or written through its (batch, seq, head) strides with a unit stride
    along hd; the tensor-core route loads q, k, v and ``do`` with TMA and
    reads ``o`` in 16-byte packs (a ValueError on a layout it cannot
    load).  Returns the route; the caller has checked the rest; raises if
    the launch fails."""
    B, Sq, H, hd = q.shape
    route = bwd_route(q.dtype, hd)
    strides = [t.stride(a) for t in (q, k, v, o, do, dq, dk, dv)
               for a in (0, 1, 2)]
    arr = (ctypes.c_longlong * 24)(*strides)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ws.data_ptr(), arr, B, H, k.shape[2], Sq,
            k.shape[1], hd, int(causal), int(window), 1.0 / math.sqrt(hd)]
    if route == "cuda_cores":
        args.append(0 if q.dtype == torch.float32 else 1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_launcher(route)(*args, stream)
    if rc == _RC_TMA_LAYOUT and route == "tensor_cores":
        raise ValueError(f"the bf16 backward needs q, k, v, o and dO at "
                         f"16-byte aligned addresses with (batch, seq, head) "
                         f"strides that are multiples of 8 elements (TMA and "
                         f"16-byte loads), got strides {q.stride()}, "
                         f"{k.stride()}, {v.stride()}, {o.stride()}, "
                         f"{do.stride()}")
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: error "
                           f"{rc} (q {tuple(q.shape)}, kv {tuple(k.shape)}, "
                           f"{q.dtype}, {route})")
    return route

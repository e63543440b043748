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
  in place through their strides.

The public wrapper (and the launch counters) is ``ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import math
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# head dims the kernel is instantiated for: the JAX kernel's {64, 96, 128,
# 192}, plus 16 and 32 so the reduced test configs run through it too
HEAD_DIMS = (16, 32, 64, 96, 128, 192)
DTYPES = (torch.float32, torch.bfloat16)
MAX_BH = 65535          # B*H rides on the fp32 kernel's grid y dimension
# the route each dtype launches: bf16 on the tensor cores, fp32 on the CUDA
# cores (TF32 would break the fp32 tolerances)
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
# the tensor-core launcher's answer to a layout TMA cannot load
# (cudaErrorMisalignedAddress)
_RC_TMA_LAYOUT = 716


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H % KV == 0 -> (B, Sq,
    H, hd) in q's dtype."""
    Sq, H, hd = q.shape[1], q.shape[2], q.shape[3]
    if k.shape[2] != H:                  # each KV head serves H // KV heads
        k = torch.repeat_interleave(k, H // k.shape[2], dim=2)
        v = torch.repeat_interleave(v, H // v.shape[2], dim=2)
    Skv = k.shape[1]
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
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


_launchers = {}


def _launcher(route: str):
    fn = _launchers.get(route)
    if fn is None:
        lib = _build.load("flash_attention")
        fn = (lib.flash_attention_bf16_launch if route == "tensor_cores"
              else lib.flash_attention_fp32_launch)
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launchers[route] = fn
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, *, causal: bool,
                         window: int) -> str:
    """Launch the dtype's kernel on the current stream, writing ``out`` (B,
    Sq, H, hd); returns the route it took (``ROUTES``).  The caller has
    checked devices, dtypes, shapes and strides (``ops._check_flash``); the
    tensor-core launcher checks what TMA needs (a ValueError here).  Raises
    if the launch fails."""
    B, Sq, H, hd = q.shape
    strides = [t.stride(a) for t in (q, k, v, out) for a in (0, 1, 2)]
    arr = (ctypes.c_longlong * 12)(*strides)
    route = ROUTES[q.dtype]
    scale = 1.0 / math.sqrt(hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher(route)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), arr, B, H, k.shape[2], Sq,
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

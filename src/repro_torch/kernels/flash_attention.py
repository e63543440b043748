"""Flash attention: online-softmax attention, causal with an optional
sliding window (``kpos > qpos - window``).

Port of ``repro/kernels/flash_attention.py``.  The Pallas TPU kernel
(``_flash_kernel``) becomes ``csrc/flash_attention.cu``, a CUDA C++ kernel
for Hopper written by hand; its source note gives the bound and the design.
This module holds its two forms, both on the JAX public layout
``(B, S, H, hd)`` (GQA callers pre-repeat the KV heads):

* :func:`flash_attention_plain` — the plain PyTorch version, a port of
  ``repro/kernels/ref.py:flash_attention_ref`` (fp32 scores, ``-1e30``
  masking, softmax, output in q's dtype).  The CPU tests use it, and
  ``chip_smoke.py`` holds the kernel against it on the card.
* :func:`flash_attention_cuda` — the launch of the CUDA kernel, which reads
  and writes the four tensors in place through their strides (no
  ``(B, S, H, hd) -> (BH, S, hd)`` transpose copies).

The public wrapper (and the launch counter) is ``ops.flash_attention``.
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
MAX_BH = 65535          # B*H rides on the grid's y dimension


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, H, hd) -> (B, Sq, H, hd) in q's
    dtype."""
    Sq, hd = q.shape[1], q.shape[3]
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


_lib = None


def _launcher():
    global _lib
    if _lib is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, *, causal: bool,
                         window: int) -> None:
    """Launch the kernel on the current stream, writing ``out`` (B, Sq, H,
    hd).  The caller has checked devices, dtypes, shapes and the unit
    stride along hd (``ops._check_flash``); raises if the launch fails."""
    B, Sq, H, hd = q.shape
    strides = [t.stride(a) for t in (q, k, v, out) for a in (0, 1, 2)]
    arr = (ctypes.c_longlong * 12)(*strides)
    dtype = 0 if q.dtype == torch.float32 else 1
    scale = 1.0 / math.sqrt(hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), arr, B, H, Sq, k.shape[1], hd,
                         dtype, int(causal), int(window), scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: error {rc} "
                           f"(q {tuple(q.shape)}, kv {tuple(k.shape)}, "
                           f"{q.dtype})")

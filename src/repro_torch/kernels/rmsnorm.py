"""RMSNorm over the last axis: ``x·rsqrt(mean(x²) + eps)·g``, computed in
fp32 and returned in x's dtype.

Port of ``repro/kernels/rmsnorm.py``.  The Pallas TPU kernel
(``_rmsnorm_kernel``) becomes ``csrc/rmsnorm.cu``, a CUDA C++ kernel for
Hopper written by hand; its source note gives the bound and the design
(four routes picked by the launcher from T, d, the dtypes and the
alignment: ``rows`` and ``few_rows`` hold a row in registers, ``looped``
walks rows too long for them, ``scalar`` takes rows that are not in
16-byte packs).  This module holds its two forms:

* :func:`rmsnorm_plain` — the plain PyTorch version (the math of
  ``repro/models/layers.py:rmsnorm`` and ``repro/kernels/ref.py:
  rmsnorm_ref``).  The CPU route and the tests use it, and ``chip_smoke.py``
  holds the kernel against it on the card.
* :func:`rmsnorm_cuda` — the launch of the CUDA kernel, which reads rows
  through their stride and writes a contiguous output.

:func:`route` names the route a launch takes (the tests and
``chip_smoke.py`` check it; the wrapper does not ask).

The public wrapper (and the launch counter) is ``ops.rmsnorm``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("scalar", "rows", "few_rows", "looped")


def rmsnorm_plain(x: torch.Tensor, g: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); g: (d,) -> (..., d) in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * g.to(torch.float32)).to(x.dtype)


_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = _build.load("rmsnorm")
        fn = lib.rmsnorm_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        which = lib.rmsnorm_route
        which.argtypes = fn.argtypes[:8]
        which.restype = ctypes.c_int
        _lib = (fn, which)
    return _lib


def _code(dtype: torch.dtype) -> int:
    return 0 if dtype == torch.float32 else 1


def rmsnorm_cuda(x2: torch.Tensor, g: torch.Tensor, out: torch.Tensor,
                 eps: float) -> None:
    """Launch the kernel on the current stream: ``x2`` (T, d) with a unit
    stride along d, ``out`` (T, d) contiguous.  The caller has checked
    devices, dtypes and shapes (``ops._check_rmsnorm``); raises if the
    launch fails."""
    T, d = x2.shape
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = _launcher()[0](x2.data_ptr(), g.data_ptr(), out.data_ptr(), T,
                            d, x2.stride(0), _code(x2.dtype), _code(g.dtype),
                            float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm launch failed: error {rc} "
                           f"(x {tuple(x2.shape)} {x2.dtype}, g {g.dtype})")


def route(x2: torch.Tensor, g: torch.Tensor, out: torch.Tensor) -> str:
    """The route :func:`rmsnorm_cuda` takes for these tensors (one of
    :data:`ROUTES`), as the launcher picks it."""
    T, d = x2.shape
    code = _launcher()[1](x2.data_ptr(), g.data_ptr(), out.data_ptr(), T, d,
                          x2.stride(0), _code(x2.dtype), _code(g.dtype))
    if not 0 <= code < len(ROUTES):
        raise ValueError(f"rmsnorm takes no route for x {x2.dtype}, "
                         f"g {g.dtype}")
    return ROUTES[code]

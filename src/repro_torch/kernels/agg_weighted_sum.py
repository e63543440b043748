"""Hierarchical-aggregation fold: ``out = acc + Σ_c w_c · D_c``.

Port of ``repro/kernels/agg_weighted_sum.py``.  The Pallas TPU kernel
(``_agg_kernel``) becomes ``csrc/agg_weighted_sum.cu``, a CUDA C++ kernel
for Hopper written by hand; its source note gives the bound and the design.
This module holds its two forms:

* :func:`agg_weighted_sum_plain` — the plain PyTorch version, summing the C
  rows in client order in fp32.  The CPU tests use it, and ``chip_smoke.py``
  holds the kernel against it on the card.
* :func:`agg_weighted_sum_cuda` — the launch of the CUDA kernel.

``rows`` is either a ``(C, n)`` tensor or a sequence of C ``(n,)`` tensors:
the kernel reads its rows through a pointer array, so a stacked client
block and C separately staged buffers go through it alike, with no stack
copy.  The public wrappers (and the launch counter) are in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from repro_torch.kernels import _build

MAX_ROWS = 64      # AGG_MAX_ROWS in the CUDA source: rows ride by value

Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


def agg_weighted_sum_plain(acc: torch.Tensor, rows: Rows,
                           weights: Sequence[float]) -> torch.Tensor:
    """acc (n,) fp32 + Σ_c w_c · rows[c] (any float dtype), accumulated in
    fp32 over c in index order.  Returns a new tensor."""
    out = acc.to(torch.float32, copy=True)
    for w, row in zip(weights, rows):
        out = out + w * row.to(torch.float32)
    return out


_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = _build.load("agg_weighted_sum")
        fn = lib.agg_weighted_sum_launch
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def agg_weighted_sum_cuda(acc: torch.Tensor, rows: Rows,
                          weights: Sequence[float],
                          out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``out = acc + Σ w_c·rows[c]``
    (``out`` may be ``acc``).  The caller has checked devices, dtypes,
    shapes and contiguity (``ops._check``); raises if the launch fails."""
    C = len(weights)
    ptrs = (ctypes.c_void_p * C)(*[r.data_ptr() for r in rows])
    w = (ctypes.c_float * C)(*weights)
    dtype = 0 if rows[0].dtype == torch.float32 else 1
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = _launcher()(ptrs, w, C, acc.data_ptr(), out.data_ptr(),
                         acc.numel(), dtype, stream)
    if rc != 0:
        raise RuntimeError(f"agg_weighted_sum launch failed: error {rc} "
                           f"(C={C}, n={acc.numel()}, dtype={rows[0].dtype})")

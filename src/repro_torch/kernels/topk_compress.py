"""Fused error-feedback top-k: ``f = x + res``; the k largest ``|f|``, exact
ties to the LOWER index; ``idx`` ascending int32, ``vals = f[idx]``,
``new_res = f`` with ``idx`` zeroed.

Port of ``repro/kernels/topk_compress.py``.  The Pallas TPU kernel
(``_topk_kernel``) becomes ``csrc/topk_compress.cu``, a CUDA C++ kernel for
Hopper written by hand: one cooperative launch a span, a three-pass radix
select whose later passes read only the candidates, and a stable
compaction (its source note gives the bound and the design).  This module
holds its two forms:

* :func:`topk_with_residual_plain` — the plain PyTorch version.  The CPU
  tests hold it to the JAX package, and ``chip_smoke.py`` holds the kernel
  to it on the card, bit for bit.
* :func:`topk_with_residual_cuda` — the launch of the CUDA kernel.

Both rank by the same key, ``bits(f) & 0x7fffffff`` as an integer: the
magnitude order, with -0.0 tying +0.0 and NaNs above +inf ordered by their
payload bits (the order ``lax.top_k`` gives ``|f|``).  ``torch.topk`` is no
substitute: it promises no tie rule.  The public wrapper (and the launch
counter) is ``ops.fused_topk``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def magnitude_key(f: torch.Tensor) -> torch.Tensor:
    """The ranking key of fp32 values: their bits with the sign cleared, as
    a non-negative int32."""
    return f.view(torch.int32) & 0x7FFFFFFF


def topk_with_residual_plain(x: torch.Tensor, res: torch.Tensor,
                             k: int) -> Triple:
    """``(idx, vals, new_res)`` by a stable descending sort of the key: the
    first k positions are the k largest keys, ties in index order."""
    f = x.to(torch.float32) + res.to(torch.float32)
    order = torch.sort(magnitude_key(f), descending=True, stable=True).indices
    idx = torch.sort(order[:k]).values
    vals = f[idx]
    new_res = f.index_fill_(0, idx, 0.0)
    return idx.to(torch.int32), vals, new_res


_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = _build.load("topk_compress")
        fn = lib.topk_compress_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sizes = []
        for name in ("topk_compress_scratch_words", "topk_compress_blocks"):
            f = getattr(lib, name)
            f.argtypes = [ctypes.c_longlong]
            f.restype = ctypes.c_longlong
            sizes.append(f)
        _lib = (fn, *sizes)
    return _lib


def _size(which: int, n: int) -> int:
    got = int(_launcher()[which](n))
    if got < 0:
        raise RuntimeError(f"topk_compress cannot plan a span of n={n} on "
                           f"this device")
    return got


def scratch_words(n: int) -> int:
    """Device scratch one launch on a span of n needs, in 32-bit words:
    histograms, per-block counts and a candidate buffer of at least n
    words (every key may share the first digit's bin).  Needs no zeroing."""
    return _size(1, n)


def blocks(n: int) -> int:
    """Blocks of the cooperative grid for a span of n (one an SM at most,
    fewer for a short span)."""
    return _size(2, n)


def topk_with_residual_cuda(x: torch.Tensor, res: torch.Tensor, k: int,
                            idx: torch.Tensor, vals: torch.Tensor,
                            new_res: torch.Tensor,
                            scratch: torch.Tensor) -> None:
    """Launch the kernel (one cooperative launch) on the current stream.
    ``new_res`` may be ``res`` (the residual updated in place); ``scratch``
    holds :func:`scratch_words` words.  The caller has checked devices,
    dtypes, shapes and contiguity (``ops._check_topk``); raises if the
    launch fails, a grid that cannot be resident at once included."""
    fn = _launcher()[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), res.data_ptr(), x.numel(), k, idx.data_ptr(),
                vals.data_ptr(), new_res.data_ptr(), scratch.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"topk_compress launch failed: error {rc} "
                           f"(n={x.numel()}, k={k})")

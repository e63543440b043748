"""Hierarchical-aggregation fold: ``out = acc + Σ_c w_c · D_c``.

Port of ``repro/kernels/agg_weighted_sum.py``.  The Pallas TPU kernel
(``_agg_kernel``) becomes ``csrc/agg_weighted_sum.cu``, a CUDA C++ kernel
for Hopper written by hand; its source note gives the bound and the design.
The kernel has two forms, and this module holds the plain version and the
launch of each:

* the leaves form — :func:`agg_fold_leaves_plain` and
  :func:`agg_fold_leaves_cuda`: a client block folded from where it lies,
  a table of segments each with its offset in the flat buffer — the
  stacked ``(C, ...)`` parameter leaves of a block (so the ``(C, n)`` block
  is never built), or one segment for a ``(C, n)`` tensor, read through its
  base pointer and row stride.  :func:`leaves_table` packs the table;
* the rows form — :func:`agg_weighted_sum_plain` and
  :func:`agg_weighted_sum_cuda`: C separately staged ``(n,)`` buffers read
  through a pointer array (the micro-batch flush), never stacked.

Both plain versions sum the C rows in client order in fp32; the CPU tests
use them, and ``chip_smoke.py`` holds the kernel against them on the card.
The public wrappers (and the launch counters) are in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from array import array
from typing import List, Sequence, Tuple, Union

import torch

from repro_torch.kernels import _build

MAX_ROWS = 64        # MAX_ROWS in the CUDA source: weights ride by value
MAX_SEGMENTS = 150   # MAX_SEGS: the segments one launch's parameters hold
_BF16 = 1 << 62      # SEG_BF16: the dtype bit of a segment's stride word
DTYPES = (torch.float32, torch.bfloat16)   # the row and leaf dtypes it reads

Rows = Union[torch.Tensor, Sequence[torch.Tensor]]
Segments = Sequence[Tuple[torch.Tensor, int]]


def agg_weighted_sum_plain(acc: torch.Tensor, rows: Rows,
                           weights: Sequence[float]) -> torch.Tensor:
    """acc (n,) fp32 + Σ_c w_c · rows[c] (any float dtype), accumulated in
    fp32 over c in index order.  Returns a new tensor."""
    out = acc.to(torch.float32, copy=True)
    for w, row in zip(weights, rows):
        out = out + w * row.to(torch.float32)
    return out


def agg_fold_leaves_plain(acc: torch.Tensor, segments: Segments,
                          weights: Sequence[float]) -> torch.Tensor:
    """The leaves form's function: for each ``(leaf, offset)``, with leaf a
    ``(C, ...)`` tensor, ``out[offset:offset + size] = acc[...] +
    Σ_c w_c · leaf[c]`` in fp32, in client order — per element the same
    operations as :func:`agg_weighted_sum_plain` on the concatenated block.
    Returns a new tensor."""
    out = acc.to(torch.float32, copy=True)
    C = len(weights)
    for leaf, off in segments:
        rows = leaf.reshape(C, -1)
        seg = out[off:off + rows.shape[1]]
        s = seg
        for w, row in zip(weights, rows):
            s = s + w * row.to(torch.float32)
        seg.copy_(s)
    return out


def leaves_table(segments: Segments, C: int, n: int,
                 device: torch.device) -> Tuple[array, List[torch.Tensor],
                                                int]:
    """Check the segments and pack them for the kernel: ``(table, keep,
    copies)``.  ``table`` holds a (base pointer, row stride | dtype bit,
    offset) triple a non-empty segment, then ``n``; ``keep`` the tensors the
    pointers point into; ``copies`` how many leaves had to be made
    contiguous (a leaf that cannot be viewed as ``(C, -1)`` with a unit
    inner stride).  Raises unless the segments tile ``[0, n)`` in order with
    ``(C, ...)`` fp32 or bf16 leaves on ``device``."""
    table = array("q")
    keep = []
    copies = 0
    cpu = device.type == "cpu"
    dev = -1 if cpu else device.index            # what get_device() gives
    end = 0
    for leaf, off in segments:
        dt = leaf.dtype
        if dt is torch.float32:
            flag = 0
        elif dt is torch.bfloat16:
            flag = _BF16
        else:
            raise ValueError(f"fold leaves must be float32 or bfloat16, got "
                             f"{dt}")
        if off != end:
            raise ValueError(f"segments must tile the flat buffer in order: "
                             f"a segment at {off}, expected {end}")
        if leaf.get_device() != dev or (cpu and not leaf.is_cpu):
            raise ValueError(f"every leaf must lie on acc's device {device}")
        shape = leaf.shape
        if not shape or shape[0] != C:
            raise ValueError(f"a leaf of shape {tuple(shape)} for {C} "
                             f"clients")
        size = leaf.numel() // C
        end = off + size
        if not size:
            continue
        if leaf.is_contiguous():
            stride = size
        else:
            rows = leaf.reshape(C, size)     # a view where the strides allow
            if rows.data_ptr() == leaf.data_ptr() and rows.stride(1) == 1:
                stride = rows.stride(0)
            else:
                rows = rows.contiguous()
                copies += 1
                stride = size
            leaf = rows
        keep.append(leaf)
        table.extend((leaf.data_ptr(), stride | flag, off))
    if end != n:
        raise ValueError(f"segments cover [0, {end}) of a flat buffer of "
                         f"{n}")
    table.append(n)
    return table, keep, copies


_rows = None
_leaves = None


def _launchers():
    global _rows, _leaves
    if _rows is None:
        lib = _build.load("agg_weighted_sum")
        rows = lib.agg_weighted_sum_launch
        rows.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_void_p]
        rows.restype = ctypes.c_int
        leaves = lib.agg_fold_leaves_launch
        leaves.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        leaves.restype = ctypes.c_int
        _rows, _leaves = rows, leaves
    return _rows, _leaves


def _stream() -> int:
    """The current device's current stream (the caller makes acc's device
    current, ``ops._on_device``)."""
    return torch.cuda.current_stream().cuda_stream


def agg_weighted_sum_cuda(acc: torch.Tensor, rows: Sequence[torch.Tensor],
                          w: array, out: torch.Tensor) -> None:
    """Launch the rows form on the current stream: ``out = acc + Σ
    w_c·rows[c]`` (``out`` may be ``acc``), the C rows read through a
    pointer array.  ``w`` holds C fp32 weights.  The caller has checked
    devices, dtypes and shapes (``ops._check``); raises if the launch
    fails."""
    C = len(w)
    ptrs = (ctypes.c_void_p * C)(*[r.data_ptr() for r in rows])
    dt = rows[0].dtype
    rc = _launchers()[0](ptrs, C, w.buffer_info()[0], acc.data_ptr(),
                         out.data_ptr(), acc.numel(),
                         0 if dt is torch.float32 else 1, _stream())
    if rc != 0:
        raise RuntimeError(f"agg_weighted_sum launch failed: error {rc} "
                           f"(C={C}, n={acc.numel()}, dtype={dt})")


def agg_fold_leaves_cuda(acc: torch.Tensor, table: array, w: array,
                         out: torch.Tensor) -> int:
    """Launch the leaves form on the current stream over a table from
    :func:`leaves_table`: ``out = acc + Σ w_c·D_c`` with D read from the
    leaves (``out`` may be ``acc``).  Returns the kernels launched (one for
    every ``MAX_SEGMENTS`` segments); raises if a launch fails."""
    nseg = (len(table) - 1) // 3
    launches = ctypes.c_int(0)
    rc = _launchers()[1](table.buffer_info()[0], nseg, len(w),
                         w.buffer_info()[0], acc.data_ptr(), out.data_ptr(),
                         _stream(), ctypes.byref(launches))
    if rc != 0:
        raise RuntimeError(f"agg_fold_leaves launch failed: error {rc} "
                           f"(C={len(w)}, {nseg} segments, n="
                           f"{acc.numel()})")
    return launches.value

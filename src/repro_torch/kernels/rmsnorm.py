"""RMSNorm over the last axis: ``x·rsqrt(mean(x²) + eps)·g``, computed in
fp32 and returned in x's dtype.

Port of ``repro/kernels/rmsnorm.py``.  The Pallas TPU kernel
(``_rmsnorm_kernel``) becomes ``csrc/rmsnorm.cu``, a CUDA C++ kernel for
Hopper written by hand; its source note gives the bound and the design
(four routes picked by the launcher from T, d, the dtypes and the
alignment: ``rows`` and ``few_rows`` hold a row in registers, ``looped``
walks rows too long for them, ``scalar`` takes rows that are not in
16-byte packs).  Beside it stands its backward, which replaces no TPU
kernel (the JAX package trains through its ``jnp`` norm; this port's
forward is the kernel on the card, so its gradient is a kernel too).

The kernels take g as a table of rows, row t of x reading g row ``t //
rpg`` (``rpg = T // len(g_table)``): a plain call passes one row, a vmapped
one each client's row (or one shared row at a stride of 0), so a vmapped
call is one launch.  This module holds the forms:

* :func:`rmsnorm_plain` — the plain PyTorch version (the math of
  ``repro/models/layers.py:rmsnorm`` and ``repro/kernels/ref.py:
  rmsnorm_ref``).  The CPU route and the tests use it, and ``chip_smoke.py``
  holds the kernel against it on the card.
* :func:`rmsnorm_bwd_plain` — the plain backward: ``dx = r·(dy·g −
  x̂·mean(dy·g·x̂))`` and ``dg = Σ_rows dy·x̂`` in fp32, with ``x̂ = x·r``.
* :func:`rmsnorm_cuda` / :func:`rmsnorm_bwd_cuda` — the launches of the CUDA
  kernels, which read rows of x through their stride and write contiguous
  outputs.  The backward reads x and dy once where a warp holds a row in
  registers (``one_pass``: the forward's ``rows`` shapes) and twice
  otherwise (``two_pass``); both sum dg's chunk partials in a fixed order.

:func:`route` and :func:`bwd_route` name the route a forward or backward
launch takes (the tests and ``chip_smoke.py`` check them; the wrapper does
not ask).

The public wrapper (its autograd and vmap rules, and the launch counters)
is ``ops.rmsnorm``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("scalar", "rows", "few_rows", "looped")
BWD_ROUTES = ("two_pass", "one_pass")


def rmsnorm_plain(x: torch.Tensor, g: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); g: (d,) or any shape that broadcasts against x -> (...,
    d) in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * g.to(torch.float32)).to(x.dtype)


def _groups(t: torch.Tensor, V: int) -> torch.Tensor:
    """(T, d) rows as (V, T // V, d): group v reads g row v."""
    return t.reshape(V, -1, t.shape[-1])


def rmsnorm_grouped_plain(x2: torch.Tensor, g_table: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """x2: (T, d) rows; g_table: (V, d) with V | T, row t reading g row
    ``t // (T // V)`` -> (T, d) in x's dtype."""
    y = rmsnorm_plain(_groups(x2, g_table.shape[0]), g_table[:, None, :], eps)
    return y.reshape(x2.shape)


def rmsnorm_bwd_plain(dy: torch.Tensor, x2: torch.Tensor,
                      g_table: torch.Tensor, eps: float = 1e-5):
    """The backward of :func:`rmsnorm_grouped_plain`: dy, x2 (T, d); g_table
    (V, d) -> ``(dx (T, d) in x's dtype, dg (V, d) in g's dtype)``, computed
    in fp32."""
    V = g_table.shape[0]
    xf = _groups(x2, V).to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xh = xf * r
    dyf = _groups(dy, V).to(torch.float32)
    u = dyf * g_table[:, None, :].to(torch.float32)
    dx = r * (u - xh * torch.mean(u * xh, dim=-1, keepdim=True))
    dg = torch.sum(dyf * xh, dim=1)
    return dx.reshape(x2.shape).to(x2.dtype), dg.to(g_table.dtype)


_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = _build.load("rmsnorm")
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn = lib.rmsnorm_launch
        fn.argtypes = [p, p, p, ll, i, ll, ll, ll, i, i, ctypes.c_float, p]
        fn.restype = i
        which = lib.rmsnorm_route
        which.argtypes = [p, p, p, ll, i, ll, ll, i, i]
        which.restype = i
        bwd = lib.rmsnorm_bwd_launch
        bwd.argtypes = [p, p, p, p, p, p, ll, i, ll, ll, ll, i, i,
                        ctypes.c_float, p]
        bwd.restype = i
        ws = lib.rmsnorm_bwd_workspace
        ws.argtypes = [ll, i, ll]
        ws.restype = ll
        bwd_which = lib.rmsnorm_bwd_route
        bwd_which.argtypes = [p, p, p, p, i, ll, ll, i, i]
        bwd_which.restype = i
        _lib = (fn, which, bwd, ws, bwd_which)
    return _lib


def _code(dtype: torch.dtype) -> int:
    return 0 if dtype == torch.float32 else 1


def _table(g: torch.Tensor, T: int):
    """(g row stride, rows per g row) of a (d,) g or a (V, d) table (one
    row is read at a stride of 0)."""
    if g.dim() == 1 or g.shape[0] == 1:
        return 0, T
    return g.stride(0), T // g.shape[0]


def rmsnorm_cuda(x2: torch.Tensor, g: torch.Tensor, out: torch.Tensor,
                 eps: float) -> None:
    """Launch the kernel on the current stream: ``x2`` (T, d) with a unit
    stride along d, ``g`` (d,) or a (V, d) table with V | T and a unit
    stride along d, ``out`` (T, d) contiguous.  The caller has checked
    devices, dtypes and shapes (``ops._check_rmsnorm``); raises if the
    launch fails."""
    T, d = x2.shape
    gs, rpg = _table(g, T)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = _launcher()[0](x2.data_ptr(), g.data_ptr(), out.data_ptr(), T,
                            d, x2.stride(0), gs, rpg, _code(x2.dtype),
                            _code(g.dtype), float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm launch failed: error {rc} "
                           f"(x {tuple(x2.shape)} {x2.dtype}, g "
                           f"{tuple(g.shape)} {g.dtype})")


def bwd_workspace_numel(T: int, d: int, V: int) -> int:
    """fp32 elements of :func:`rmsnorm_bwd_cuda`'s workspace (r of each
    row, which the ``two_pass`` route keeps, then the dg partials of each
    32-row chunk of each g row's rows)."""
    n = _launcher()[3](T, d, T // V)
    if n < 0:
        raise ValueError(f"rmsnorm backward takes T % V == 0, got T={T}, "
                         f"V={V}")
    return n


def rmsnorm_bwd_cuda(dy: torch.Tensor, x2: torch.Tensor,
                     g_table: torch.Tensor, dx: torch.Tensor,
                     dg: torch.Tensor, ws: torch.Tensor, eps: float) -> None:
    """Launch the backward on the current stream: ``dy`` and ``dx`` (T, d)
    contiguous in x's dtype, ``x2`` (T, d) with a unit stride along d,
    ``g_table`` (V, d) (any row stride, 0 included), ``dg`` (V, d)
    contiguous in g's dtype, ``ws`` fp32 of :func:`bwd_workspace_numel`
    elements.  The caller has checked the rest; raises if the launch
    fails."""
    T, d = x2.shape
    gs, rpg = _table(g_table, T)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = _launcher()[2](x2.data_ptr(), dy.data_ptr(), g_table.data_ptr(),
                            dx.data_ptr(), dg.data_ptr(), ws.data_ptr(), T,
                            d, x2.stride(0), gs, rpg, _code(x2.dtype),
                            _code(g_table.dtype), float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm backward launch failed: error {rc} "
                           f"(x {tuple(x2.shape)} {x2.dtype}, g "
                           f"{tuple(g_table.shape)} {g_table.dtype})")


def route(x2: torch.Tensor, g: torch.Tensor, out: torch.Tensor) -> str:
    """The route :func:`rmsnorm_cuda` takes for these tensors (one of
    :data:`ROUTES`), as the launcher picks it."""
    T, d = x2.shape
    code = _launcher()[1](x2.data_ptr(), g.data_ptr(), out.data_ptr(), T, d,
                          x2.stride(0), _table(g, T)[0], _code(x2.dtype),
                          _code(g.dtype))
    if not 0 <= code < len(ROUTES):
        raise ValueError(f"rmsnorm takes no route for x {x2.dtype}, "
                         f"g {g.dtype}")
    return ROUTES[code]


def bwd_route(dy: torch.Tensor, x2: torch.Tensor, g_table: torch.Tensor,
              dx: torch.Tensor) -> str:
    """The route :func:`rmsnorm_bwd_cuda` takes for these tensors (one of
    :data:`BWD_ROUTES`), as the launcher picks it."""
    d = x2.shape[1]
    code = _launcher()[4](x2.data_ptr(), dy.data_ptr(), g_table.data_ptr(),
                          dx.data_ptr(), d, x2.stride(0),
                          _table(g_table, x2.shape[0])[0], _code(x2.dtype),
                          _code(g_table.dtype))
    if not 0 <= code < len(BWD_ROUTES):
        raise ValueError(f"the rmsnorm backward takes no route for x "
                         f"{x2.dtype}, g {g_table.dtype}")
    return BWD_ROUTES[code]

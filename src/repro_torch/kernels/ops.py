"""Public wrappers around the port's kernels (port of
``repro/kernels/ops.py``: the aggregation fold, the fused top-k, flash
attention, the SSD scan and RMSNorm).

A wrapper picks the kernel or its plain version by the tensor it is given,
and by nothing else: a CPU tensor takes the plain PyTorch version; a CUDA
tensor launches the hand-written Hopper kernel or raises.  A tensor without
data -- on the meta device, a ``FakeTensor`` on any device, or a
``DTensor`` over such local shards (the dry run's abstract trace,
``launch/dryrun.py``) -- takes the plain version too, which then only
propagates shapes.  There is no fallback from a failed build or launch.

While a dispatch-trace counter counts (``launch/hlo_analysis.py`` sets
:data:`shadow_plain`), each kernel launch also runs its plain version on
meta tensors of the launch's shapes, so the counter sees the same ops on
the card as on an abstract trace of the same step.

Each kernel has two plain-integer counters (``agg_dispatch_count``'s
counterparts):

* :data:`agg_dispatches` / :data:`topk_dispatches` /
  :data:`flash_dispatches` / :data:`ssm_scan_dispatches` /
  :data:`rmsnorm_dispatches` — every call of the kernel's wrapper, either
  route;
* :data:`agg_launches` / :data:`topk_launches` / :data:`flash_launches` /
  :data:`ssm_scan_launches` / :data:`rmsnorm_launches` — CUDA launches
  only, incremented exactly where the kernel is launched (``chip_smoke.py``
  reads them to show that the main path went through the kernels).  A
  top-k launch is one cooperative kernel, for one span, and a scan launch
  the three kernels of one call.  A fold launch is one kernel of either
  form; :data:`agg_leaves_launches` counts the leaves form's alone (a
  block's leaves, or a ``(C, n)`` block as one segment).

:data:`flash_route_launches` splits the flash launches by the kernel the
dtype picked: ``tensor_cores`` (bf16) and ``cuda_cores`` (fp32);
:data:`flash_bwd_route_launches` the backward's by the route the dtype and
head dim picked (``flash_attention.bwd_route``: ``tensor_cores`` for bf16,
``tf32x3`` for fp32 -- the tensor cores, three TF32 passes a product --
and ``cuda_cores`` at hd 192).

Gradients.  ``flash_attention``, ``rmsnorm`` and ``ssm_scan`` are
differentiable through ``torch.autograd.Function``s whose backward is a
hand-written kernel on a CUDA tensor (its plain version on a CPU tensor),
counted by :data:`flash_bwd_dispatches` / :data:`flash_bwd_launches`,
:data:`rmsnorm_bwd_dispatches` / :data:`rmsnorm_bwd_launches` and
:data:`ssm_scan_bwd_dispatches` / :data:`ssm_scan_bwd_launches` (one launch
a call, whatever its kernels; reset with the forward's counters), the
scan's split by route in :data:`ssm_scan_bwd_route_launches`
(``ssm_scan.bwd_route``: ``bf16`` when q, k and v are all bf16, else
``mixed``).  Each
Function has a ``vmap`` rule that folds the vmapped axis into the rows (the
batch for flash and the scan, the rows and a g table for the norm), so
``torch.func.vmap`` of ``torch.func.grad`` — the client engine — launches
each kernel once for a block of clients.  A call takes the Function when an
input requires grad or is a ``torch.func`` transform's tensor; a plain call
(serving, under ``no_grad``) launches the forward alone, and flash then
writes no log-sum-exp.  The scan's Function saves its inputs alone: its
backward kernel, like the plain backward on the CPU, recomputes every
64-step chunk's starting state (in fp32).

The fold and top-k counters are updated under a lock: executors that run
in threads (``ParrotServer(parallel_dispatch=True)``) fold concurrently.
"""
from __future__ import annotations

import contextlib
import threading
from array import array
from typing import Sequence, Tuple, Union

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro_torch.kernels import agg_weighted_sum as _agg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import topk_compress as _tkc

MAX_FOLD_ROWS = _agg.MAX_ROWS     # clients one fold call takes
FOLD_DTYPES = _agg.DTYPES         # the row and leaf dtypes the fold reads

agg_dispatches = 0
agg_launches = 0
# the leaves form's share of agg_launches, and the leaves it had to copy
agg_leaves_launches = 0
agg_leaf_copies = 0
topk_dispatches = 0
topk_launches = 0
flash_dispatches = 0
flash_launches = 0
# flash launches by route: bf16 on the tensor cores, fp32 on the CUDA cores
flash_route_launches = {"tensor_cores": 0, "cuda_cores": 0}
flash_bwd_dispatches = 0
flash_bwd_launches = 0
flash_bwd_route_launches = {route: 0 for route in _fa.BWD_ROUTES}
ssm_scan_dispatches = 0
ssm_scan_launches = 0
ssm_scan_bwd_dispatches = 0
ssm_scan_bwd_launches = 0
# scan backward launches by route: q, k, v all bf16, or any other mix
ssm_scan_bwd_route_launches = {route: 0 for route in _ssm.BWD_ROUTES}
rmsnorm_dispatches = 0
rmsnorm_launches = 0
rmsnorm_bwd_dispatches = 0
rmsnorm_bwd_launches = 0
_count_lock = threading.Lock()
# set by a dispatch-trace counter while it counts (see the module docstring)
shadow_plain = False


def _abstract(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no data: a meta tensor or a ``FakeTensor``."""
    return t.is_meta or isinstance(t, FakeTensor)


def _plain(t: torch.Tensor, what: str) -> bool:
    """The route of a call on ``t``: True for the plain version (a CPU
    tensor, a tensor without data, a ``DTensor`` over CPU or data-less
    shards), False for the kernel (a real CUDA tensor); raises for any
    other tensor."""
    if type(t) is torch.Tensor:                 # the main path's tensors
        kind = t.device.type
        if kind == "cuda":
            return False
        if kind in ("cpu", "meta"):
            return True
        raise ValueError(f"no {what} kernel for device {t.device}")
    if isinstance(t, DTensor):
        local = t.to_local()
        if _abstract(local) or local.device.type == "cpu":
            return True
        raise ValueError(f"no {what} kernel for a DTensor on {local.device}")
    kind = t.device.type
    if kind in ("cpu", "meta") or isinstance(t, FakeTensor):
        return True
    if kind == "cuda":
        return False
    raise ValueError(f"no {what} kernel for device {t.device}")


def _meta(t):
    return (torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                device="meta")
            if isinstance(t, torch.Tensor) else t)


def _shadow(plain, *args, **kwargs) -> None:
    """Run ``plain`` on meta copies of ``args`` while a counter counts."""
    if shadow_plain:
        plain(*[_meta(a) for a in args], **kwargs)


def reset_agg_counts() -> None:
    global agg_dispatches, agg_launches, agg_leaves_launches, agg_leaf_copies
    agg_dispatches = 0
    agg_launches = 0
    agg_leaves_launches = 0
    agg_leaf_copies = 0


def _weights(weights) -> array:
    """Host weights rounded to fp32 (the kernel takes them by value; the
    plain version reads the same values back with ``tolist()``)."""
    if isinstance(weights, torch.Tensor):
        if weights.device.type != "cpu":
            raise ValueError("fold weights must be host values (a sequence "
                             "of floats or a CPU tensor)")
        weights = weights.tolist()
    return array("f", [float(x) for x in weights])


def _on_device(t: torch.Tensor):
    """A context that makes t's device current, unless it already is."""
    if t.get_device() == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _check_acc(acc: torch.Tensor, C: int) -> None:
    """Raise on an accumulator or a row count the kernel does not take (the
    output is acc itself or ``empty_like(acc)``)."""
    if acc.dtype is not torch.float32 or acc.dim() != 1 \
            or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous 1-D float32 tensor")
    if not 1 <= C <= _agg.MAX_ROWS:
        raise ValueError(f"fold takes 1..{_agg.MAX_ROWS} rows, got {C}")


def _check(acc: torch.Tensor, rows, w: array) -> None:
    """Raise on what ``agg_weighted_sum`` does not take: a (C, n) tensor
    with a unit inner stride, or C contiguous (n,) tensors, of one dtype
    (fp32 or bf16) on acc's device."""
    C = rows.shape[0] if isinstance(rows, torch.Tensor) else len(rows)
    _check_acc(acc, C)
    if len(w) != C:
        raise ValueError(f"{len(w)} weights for {C} rows")
    n = acc.numel()
    dev = acc.get_device()
    if isinstance(rows, torch.Tensor):
        if rows.dtype not in _agg.DTYPES:
            raise ValueError(f"fold rows must be float32 or bfloat16, got "
                             f"{rows.dtype}")
        if rows.dim() != 2 or rows.shape[1] != n \
                or (n > 1 and rows.stride(1) != 1) or rows.stride(0) < 0 \
                or rows.get_device() != dev:
            raise ValueError("the rows must be a (C, n) tensor with a unit "
                             "stride along n, on acc's device")
        return
    dt = rows[0].dtype
    if dt not in _agg.DTYPES:
        raise ValueError(f"fold rows must be float32 or bfloat16, got {dt}")
    for r in rows:
        if r.dtype != dt or r.shape != acc.shape or not r.is_contiguous() \
                or r.get_device() != dev:
            raise ValueError("every row must be a contiguous (n,) tensor of "
                             "one dtype on acc's device")


def agg_weighted_sum(acc: torch.Tensor,
                     deltas: Union[torch.Tensor, Sequence[torch.Tensor]],
                     weights, *, inplace: bool = False) -> torch.Tensor:
    """acc: (n,) fp32; deltas: (C, n) tensor or C (n,) tensors, fp32 or
    bf16; weights: C host floats -> acc + Σ_c w_c·deltas[c] in fp32.

    One call folds C clients with one launch: a stacked (C, n) block goes
    to the leaves form as one segment (read through its base pointer and
    row stride), C separately staged buffers (``agg_fold_batch``) to the
    rows form (read through a pointer array).  ``inplace=True`` writes the
    result into ``acc`` (the counterpart of the TPU path's donated
    accumulator); only pass it when no other reference to ``acc`` must keep
    its value."""
    global agg_dispatches, agg_launches
    with _count_lock:
        agg_dispatches += 1
    w = _weights(weights)
    if not isinstance(deltas, torch.Tensor):
        deltas = list(deltas)
    if acc.device.type == "cpu":
        res = _agg.agg_weighted_sum_plain(acc, deltas, w.tolist())
        if inplace:
            acc.copy_(res)
            return acc
        return res
    if acc.device.type != "cuda":
        raise ValueError(f"no fold kernel for device {acc.device}")
    _check(acc, deltas, w)
    out = acc if inplace else torch.empty_like(acc)
    if isinstance(deltas, torch.Tensor):
        table, _, _ = _agg.leaves_table([(deltas, 0)], len(w), acc.numel(),
                                        acc.device)
        _launch_leaves(acc, table, w, out)
        return out
    with _on_device(acc):
        _agg.agg_weighted_sum_cuda(acc, deltas, w, out)
    with _count_lock:
        agg_launches += 1
    return out


def _launch_leaves(acc: torch.Tensor, table: array, w: array,
                   out: torch.Tensor) -> None:
    """Launch the leaves form over a table from ``leaves_table`` on acc's
    device, and count its kernels."""
    global agg_launches, agg_leaves_launches
    if len(table) == 1:            # nothing to fold: n == 0
        return
    with _on_device(acc):
        n = _agg.agg_fold_leaves_cuda(acc, table, w, out)
    with _count_lock:
        agg_launches += n
        agg_leaves_launches += n


def agg_fold_leaves(acc: torch.Tensor,
                    segments: Sequence[Tuple[torch.Tensor, int]], weights,
                    *, inplace: bool = False) -> torch.Tensor:
    """The leaves form: fold a client block straight from its parameter
    leaves, ``out[off + j] = acc[off + j] + Σ_c w_c·leaf[c, j]`` in fp32 in
    client order, for each ``(leaf, off)`` of ``segments``.

    acc: (n,) fp32; segments: the group's stacked ``(C, ...)`` fp32 or bf16
    leaves in layout order, each with its offset in the flat buffer, tiling
    ``[0, n)``; weights: C host floats.  Per element it computes what
    :func:`agg_weighted_sum` computes on the concatenated ``(C, n)`` block,
    bit for bit, without building that block: one launch for every
    ``MAX_SEGMENTS`` leaves.  A leaf that cannot be viewed as ``(C, -1)``
    with a unit inner stride is made contiguous first (and counted in
    :data:`agg_leaf_copies`).  ``inplace`` as for :func:`agg_weighted_sum`."""
    global agg_dispatches, agg_leaf_copies
    with _count_lock:
        agg_dispatches += 1
    w = _weights(weights)
    kind = acc.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no fold kernel for device {acc.device}")
    _check_acc(acc, len(w))
    # `keep` holds any leaf copied for the kernel until its launch is queued
    table, keep, copies = _agg.leaves_table(segments, len(w), acc.numel(),
                                            acc.device)
    if kind == "cpu":
        res = _agg.agg_fold_leaves_plain(acc, segments, w.tolist())
        if inplace:
            acc.copy_(res)
            return acc
        return res
    with _count_lock:
        agg_leaf_copies += copies
    out = acc if inplace else torch.empty_like(acc)
    _launch_leaves(acc, table, w, out)
    return out


def agg_fold_batch(acc: torch.Tensor, staged: Sequence[torch.Tensor],
                   weights, *, inplace: bool = False) -> torch.Tensor:
    """Fused micro-batch flush: fold B staged (n,) client buffers into the
    fp32 accumulator with ONE kernel launch.  The kernel reads the buffers
    through its pointer array, so they are never stacked."""
    return agg_weighted_sum(acc, list(staged), weights, inplace=inplace)


def agg_fold(acc: torch.Tensor, delta: torch.Tensor,
             weight: float) -> torch.Tensor:
    """Fold a single client delta (any leaf shape) into the fp32
    accumulator, returning a new tensor: the per-leaf C=1 fold, for ad-hoc
    use."""
    flat_acc = acc.reshape(-1).to(torch.float32).contiguous()
    out = agg_weighted_sum(flat_acc, [delta.reshape(-1).contiguous()],
                           [weight])
    return out.reshape(acc.shape)


def reset_topk_counts() -> None:
    global topk_dispatches, topk_launches
    topk_dispatches = 0
    topk_launches = 0


def _check_topk(x: torch.Tensor, res: torch.Tensor, k: int) -> None:
    for name, t in (("x", x), ("res", res)):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D float32 tensor")
    if res.shape != x.shape or res.device != x.device:
        raise ValueError("res must have x's shape and device")
    if not 1 <= k <= x.numel() or x.numel() > 2**31 - 1:
        raise ValueError(f"top-k takes 1 <= k <= n < 2^31, got k={k} "
                         f"n={x.numel()}")


def fused_topk(x: torch.Tensor, res: torch.Tensor, k: int, *,
               inplace: bool = False):
    """Fused error-feedback top-k for one 1-D fp32 span: residual-add, the
    k largest ``|x + res|`` (ties to the lower index), gather, scatter-zero
    residual.  Returns ``(idx, vals, new_res)``; ``idx`` is ascending int32.

    ``inplace=True`` writes ``new_res`` into ``res`` (the compressor's own
    residual buffer; never pass the partial).  ``x`` and ``res`` may be
    views into larger buffers (a span of a group buffer)."""
    global topk_dispatches, topk_launches
    with _count_lock:
        topk_dispatches += 1
    k = int(k)
    if x.device.type == "cpu":
        idx, vals, new_res = _tkc.topk_with_residual_plain(x, res, k)
        if inplace:
            res.copy_(new_res)
            new_res = res
        return idx, vals, new_res
    if x.device.type != "cuda":
        raise ValueError(f"no top-k kernel for device {x.device}")
    _check_topk(x, res, k)
    idx = torch.empty(k, dtype=torch.int32, device=x.device)
    vals = torch.empty(k, dtype=torch.float32, device=x.device)
    new_res = res if inplace else torch.empty_like(x)
    with torch.cuda.device(x.device):
        words = _tkc.scratch_words(x.numel())
    scratch = torch.empty(words, dtype=torch.int32, device=x.device)
    _tkc.topk_with_residual_cuda(x, res, k, idx, vals, new_res, scratch)
    with _count_lock:
        topk_launches += 1
    return idx, vals, new_res


def reset_flash_counts() -> None:
    global flash_dispatches, flash_launches
    global flash_bwd_dispatches, flash_bwd_launches
    flash_dispatches = 0
    flash_launches = 0
    flash_bwd_dispatches = 0
    flash_bwd_launches = 0
    for routes in (flash_route_launches, flash_bwd_route_launches):
        for route in routes:
            routes[route] = 0


def _traced(*ts: torch.Tensor) -> bool:
    """Whether a call must take the autograd Function: an input requires
    grad, or is a ``torch.func`` transform's tensor (vmap, grad)."""
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in ts) or (torch.is_grad_enabled()
                                and any(t.requires_grad for t in ts))


def _front(t: torch.Tensor, dim, V: int) -> torch.Tensor:
    """A vmap rule's input with the vmapped axis (``dim``; None: not
    vmapped, broadcast) moved to the front at size V."""
    if dim is None:
        return t.expand((V,) + tuple(t.shape))
    return t.movedim(dim, 0)


def _fold(t: torch.Tensor, dim, V: int) -> torch.Tensor:
    """(V, B, ...) -> contiguous (V·B, ...): the vmapped axis folded into
    the batch (contiguous, so TMA can load it)."""
    t = _front(t, dim, V)
    return t.reshape((V * t.shape[1],) + tuple(t.shape[2:])).contiguous()


def _unfold(t: torch.Tensor, V: int) -> torch.Tensor:
    return t.reshape((V, t.shape[0] // V) + tuple(t.shape[1:]))


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, S, H, hd) q and (B, S, "
                         "KV, hd) k and v")
    if q.dtype not in _fa.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q, k and "
                         f"v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    B, _, H, hd = q.shape
    if hd not in _fa.HEAD_DIMS:
        raise ValueError(f"flash attention takes hd in {_fa.HEAD_DIMS}, "
                         f"got {hd}")
    KV = k.shape[2]
    if k.shape != v.shape or (k.shape[0], k.shape[3]) != (B, hd) \
            or KV < 1 or H % KV:
        raise ValueError(f"k and v must be (B, Skv, KV, hd) with H % KV == 0"
                         f" for q {tuple(q.shape)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if min(q.shape[1], k.shape[1]) < 1 or B * H > _fa.MAX_BH:
        raise ValueError(f"flash attention takes S >= 1 and B*H <= "
                         f"{_fa.MAX_BH}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride along hd")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0 — query
    head h reads KV head ``h // (H // KV)``, ``jnp.repeat``'s order, so
    grouped-query callers pass their KV heads as they are (``KV == H`` is
    the MHA form) -> (B, Sq, H, hd) in q's dtype.

    Online-softmax attention with scale ``1/sqrt(hd)``, causal when asked
    and with the optional sliding window ``kpos > qpos - window``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel of its
    dtype (bf16 on the tensor cores, fp32 on the CUDA cores), or raises on
    what it does not take (hd, dtype, rank, head counts, a device mix, a
    bf16 layout TMA cannot load)."""
    global flash_dispatches
    flash_dispatches += 1
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must lie on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    _plain(q, "flash attention")
    if _traced(q, k, v):
        return _FlashFn.apply(q, k, v, bool(causal), int(window))[0]
    return _flash_fwd(q, k, v, bool(causal), int(window), False)


def _flash_fwd(q, k, v, causal: bool, window: int, with_lse: bool):
    """The forward on plain tensors: ``o``, or ``(o, lse)`` with the rows'
    log-sum-exp (B, H, Sq) fp32."""
    global flash_launches
    if _plain(q, "flash attention"):
        o, lse = _fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                               window=window)
        return (o, lse) if with_lse else o
    _check_flash(q, k, v)
    _shadow(_fa.flash_attention_fwd_plain, q, k, v, causal=causal,
            window=window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                       dtype=torch.float32, device=q.device)
           if with_lse else None)
    route = _fa.flash_attention_cuda(q, k, v, out, causal=causal,
                                     window=window, lse=lse)
    flash_launches += 1
    flash_route_launches[route] += 1
    return (out, lse) if with_lse else out


def _flash_bwd(do, q, k, v, o, lse, causal: bool, window: int):
    """The backward on plain tensors -> (dq, dk, dv) in q's dtype."""
    global flash_bwd_dispatches, flash_bwd_launches
    flash_bwd_dispatches += 1
    do = do.to(q.dtype)
    if _plain(q, "flash attention"):
        return _fa.flash_attention_bwd_plain(do, q, k, v, o, lse,
                                             causal=causal, window=window)
    _check_flash(q, k, v)
    _shadow(_fa.flash_attention_bwd_plain, do, q, k, v, o, lse,
            causal=causal, window=window)
    do, o = do.contiguous(), o.contiguous()
    lse = lse.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    B, Sq, H, _ = q.shape
    ws = torch.empty(_fa.bwd_workspace_numel(B, H, Sq), dtype=torch.float32,
                     device=q.device)
    route = _fa.flash_attention_bwd_cuda(do, q, k, v, o, lse, dq, dk, dv, ws,
                                         causal=causal, window=window)
    flash_bwd_launches += 1
    flash_bwd_route_launches[route] += 1
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """``(o, lse) = flash(q, k, v)``; the gradient of o through the
    backward kernel (lse is not differentiable)."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return _flash_fwd(q, k, v, causal, window, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashBwdFn.apply(do, q, k, v, o, lse, ctx.causal,
                                       ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        V = info.batch_size
        q, k, v = (_fold(t, d, V) for t, d in zip((q, k, v), in_dims))
        o, lse = _FlashFn.apply(q, k, v, causal, window)
        return (_unfold(o, V), _unfold(lse, V)), (0, 0)


class _FlashBwdFn(torch.autograd.Function):
    """``(dq, dk, dv)`` of :class:`_FlashFn`; not differentiable again."""

    @staticmethod
    def forward(do, q, k, v, o, lse, causal, window):
        return _flash_bwd(do, q, k, v, o, lse, causal, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the flash attention backward has no gradient")

    @staticmethod
    def vmap(info, in_dims, do, q, k, v, o, lse, causal, window):
        V = info.batch_size
        args = [_fold(t, d, V) for t, d in zip((do, q, k, v, o, lse),
                                               in_dims)]
        out = _FlashBwdFn.apply(*args, causal, window)
        return tuple(_unfold(t, V) for t in out), (0, 0, 0)


def reset_ssm_scan_counts() -> None:
    global ssm_scan_dispatches, ssm_scan_launches
    global ssm_scan_bwd_dispatches, ssm_scan_bwd_launches
    ssm_scan_dispatches = 0
    ssm_scan_launches = 0
    ssm_scan_bwd_dispatches = 0
    ssm_scan_bwd_launches = 0
    for route in ssm_scan_bwd_route_launches:
        ssm_scan_bwd_route_launches[route] = 0


def _check_ssm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_a: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or log_a.dim() != 3:
        raise ValueError("the scan takes q, k (B, S, H, N), v (B, S, H, P) "
                         "and log_a (B, S, H)")
    B, S, H, N = q.shape
    if v.shape[:3] != (B, S, H) or log_a.shape != (B, S, H):
        raise ValueError(f"v {tuple(v.shape)} and log_a "
                         f"{tuple(log_a.shape)} must match q {tuple(q.shape)}"
                         f" in (B, S, H)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _ssm.DTYPES:
            raise ValueError(f"the scan takes float32 or bfloat16 {name}, "
                             f"got {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride along its last "
                             f"axis")
    if log_a.dtype != torch.float32:
        raise ValueError(f"log_a must be float32, got {log_a.dtype}")
    if min(q.shape) < 1 or v.shape[3] < 1 or B * H > _ssm.MAX_BH \
            or S > _ssm.MAX_S:
        raise ValueError(f"the scan takes non-empty shapes, B*H <= "
                         f"{_ssm.MAX_BH} and S <= {_ssm.MAX_S}")


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, *, chunk: int):
    """q, k: (B, S, H, N); v: (B, S, H, P); log_a: (B, S, H) fp32 (<= 0)
    -> ``(y (B, S, H, P) in v's dtype, h_final (B, H, N, P) fp32)``, from
    h0 = 0 (the prefill; a carried state takes ``ssm_scan_plain``).

    ``chunk`` is the model's chunk, which sets the plain versions'
    summation order; the kernels chunk by their own length (``CHUNK``).  A
    CPU tensor takes the plain version; a CUDA tensor launches the three
    kernels of the chunk-parallel scan (one launch on the counter), reading
    q, k, v and log_a through their strides (a stride of 0 along H
    included), or raises on what it does not take.  A traced call (an
    input requires grad, or is a ``torch.func`` tensor) goes through
    :class:`_SsmScanFn` on either device."""
    global ssm_scan_dispatches
    ssm_scan_dispatches += 1
    if any(t.device != q.device for t in (k, v, log_a)):
        raise ValueError(f"q, k, v and log_a must lie on one device, got "
                         f"{q.device}, {k.device}, {v.device}, "
                         f"{log_a.device}")
    _plain(q, "scan")
    if _traced(q, k, v, log_a):
        return _SsmScanFn.apply(q, k, v, log_a, int(chunk))
    return _ssm_fwd(q, k, v, log_a, int(chunk))


def _ssm_fwd(q, k, v, log_a, chunk: int):
    """The forward on plain tensors -> (y, h_final)."""
    global ssm_scan_launches
    if _plain(q, "scan"):
        return _ssm.ssm_scan_plain(q, k, v, log_a, chunk)
    _check_ssm(q, k, v, log_a)
    _shadow(_ssm.ssm_scan_plain, q, k, v, log_a, chunk)
    B, S, H, N = q.shape
    y = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    P = v.shape[3]
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=q.device)
    ws = torch.empty(_ssm.workspace_numel(B, H, S, N, P),
                     dtype=torch.float32, device=q.device)
    _ssm.ssm_scan_cuda(q, k, v, log_a, y, h, ws)
    ssm_scan_launches += 1
    return y, h


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, S, H, P) bf16 with a unit inner stride, or a fresh
    contiguous copy where its (batch, seq, head) rows do not all start at
    16-byte aligned addresses (a dimension of size 1 is never stepped)."""
    if t.data_ptr() % 16 == 0 and all(
            n == 1 or st % 8 == 0 for n, st in zip(t.shape[:3],
                                                    t.stride()[:3])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _ssm_bwd(dy, dh, q, k, v, log_a, chunk: int):
    """The backward on plain tensors -> (dq, dk, dv in the inputs' dtypes,
    dlog_a fp32); ``dh`` None when h_final is unused.  On the card the
    kernels recompute the chunks' starting states from q, k, v and
    log_a."""
    global ssm_scan_bwd_dispatches, ssm_scan_bwd_launches
    ssm_scan_bwd_dispatches += 1
    if dy is None:
        dy = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
    if _plain(q, "scan"):
        return _ssm.ssm_scan_bwd_plain(dy, dh, q, k, v, log_a, chunk)
    _check_ssm(q, k, v, log_a)
    _shadow(_ssm.ssm_scan_bwd_plain, dy, dh, q, k, v, log_a, chunk)
    B, S, H, N = q.shape
    P = v.shape[3]
    if dy.shape != v.shape or (dh is not None and dh.shape != (B, H, N, P)):
        raise ValueError(f"the scan's backward takes dy {tuple(v.shape)} and "
                         f"dh {(B, H, N, P)} or None")
    dy = dy.to(v.dtype)
    if dy.stride(3) != 1:
        dy = dy.contiguous()
    if _ssm.bwd_resident(q.dtype, k.dtype, v.dtype, N, P):
        v, dy = _rows_aligned(v), _rows_aligned(dy)
    if dh is not None:
        dh = dh.to(torch.float32).contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    dla = torch.empty(log_a.shape, dtype=torch.float32, device=q.device)
    bws = torch.empty(_ssm.bwd_workspace_numel(B, H, S, N, P),
                      dtype=torch.float32, device=q.device)
    route = _ssm.ssm_scan_bwd_cuda(dy, dh, q, k, v, log_a, dq, dk, dv, dla,
                                   bws)
    ssm_scan_bwd_launches += 1
    ssm_scan_bwd_route_launches[route] += 1
    return dq, dk, dv, dla


class _SsmScanFn(torch.autograd.Function):
    """``(y, h_final) = scan(q, k, v, log_a)`` from h0 = 0; the gradients
    of y and h_final through the backward kernel, which needs the inputs
    alone."""

    @staticmethod
    def forward(q, k, v, log_a, chunk):
        return _ssm_fwd(q, k, v, log_a, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, log_a, chunk = inputs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, log_a)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, dy, dh):
        dq, dk, dv, dla = _SsmScanBwdFn.apply(dy, dh, *ctx.saved_tensors,
                                              ctx.chunk)
        return dq, dk, dv, dla, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, log_a, chunk):
        V = info.batch_size
        args = [_fold(t, d, V) for t, d in zip((q, k, v, log_a), in_dims)]
        out = _SsmScanFn.apply(*args, chunk)
        return tuple(_unfold(t, V) for t in out), (0, 0)


class _SsmScanBwdFn(torch.autograd.Function):
    """``(dq, dk, dv, dlog_a)`` of :class:`_SsmScanFn`; not differentiable
    again."""

    @staticmethod
    def forward(dy, dh, q, k, v, log_a, chunk):
        return _ssm_bwd(dy, dh, q, k, v, log_a, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the scan's backward has no gradient")

    @staticmethod
    def vmap(info, in_dims, dy, dh, q, k, v, log_a, chunk):
        # the vmapped axis folded into the batch
        V = info.batch_size
        args = [None if t is None else _fold(t, d, V)
                for t, d in zip((dy, dh, q, k, v, log_a), in_dims)]
        out = _SsmScanBwdFn.apply(*args, chunk)
        return tuple(_unfold(t, V) for t in out), (0, 0, 0, 0)


def reset_rmsnorm_counts() -> None:
    global rmsnorm_dispatches, rmsnorm_launches
    global rmsnorm_bwd_dispatches, rmsnorm_bwd_launches
    rmsnorm_dispatches = 0
    rmsnorm_launches = 0
    rmsnorm_bwd_dispatches = 0
    rmsnorm_bwd_launches = 0


def _check_rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The (T, d) row view of x the kernel reads, for g (d,) contiguous or
    a (V, d) table with V | T, a unit stride along d and any row stride;
    raises on what it does not take."""
    if x.dtype not in _rms.DTYPES or g.dtype not in _rms.DTYPES:
        raise ValueError(f"rmsnorm takes float32 or bfloat16 x and g, got "
                         f"{x.dtype}, {g.dtype}")
    if x.dim() < 1 or g.dim() not in (1, 2) or g.shape[-1] != x.shape[-1] \
            or (g.shape[-1] > 1 and g.stride(-1) != 1) \
            or (g.dim() == 2 and (g.shape[0] < 1 or g.stride(0) < 0)):
        raise ValueError(f"rmsnorm takes x (..., d) and g (d,) or (V, d) "
                         f"with a unit stride along d, got {tuple(x.shape)},"
                         f" {tuple(g.shape)} {g.stride()}")
    if x.numel() == 0:
        raise ValueError("rmsnorm takes a non-empty x")
    if x.is_contiguous():
        x2 = x.reshape(-1, x.shape[-1])
    elif x.dim() == 2 and x.stride(1) == 1:
        x2 = x
    else:
        raise ValueError("rmsnorm takes x contiguous, or 2-D with a unit "
                         "stride along d")
    if g.dim() == 2 and x2.shape[0] % g.shape[0]:
        raise ValueError(f"rmsnorm takes a g table of V rows with V | T, "
                         f"got V={g.shape[0]}, T={x2.shape[0]}")
    return x2


def rmsnorm(x: torch.Tensor, g: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); g: (d,) -> ``x·rsqrt(mean(x²) + eps)·g`` over the last
    axis, computed in fp32, in x's dtype.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel, or raises on what it does
    not take."""
    global rmsnorm_dispatches
    rmsnorm_dispatches += 1
    if g.device != x.device:
        raise ValueError(f"x and g must lie on one device, got {x.device}, "
                         f"{g.device}")
    _plain(x, "rmsnorm")
    if _traced(x, g):
        return _RmsNormFn.apply(x, g[None], float(eps))
    return _rms_fwd(x, g, float(eps))


def _rms_fwd_plain(x, g, eps: float):
    if g.dim() == 1 or g.shape[0] == 1:
        return _rms.rmsnorm_plain(x, g.reshape(-1), eps)
    x2 = x.reshape(-1, x.shape[-1])
    return _rms.rmsnorm_grouped_plain(x2, g, eps).reshape(x.shape)


def _rms_fwd(x, g, eps: float):
    """The forward on plain tensors; g (d,) or a (V, d) table (row t of
    x's rows reads g row ``t // (T // V)``)."""
    global rmsnorm_launches
    if _plain(x, "rmsnorm"):
        return _rms_fwd_plain(x, g, eps)
    x2 = _check_rmsnorm(x, g)
    _shadow(_rms_fwd_plain, x, g, eps)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _rms.rmsnorm_cuda(x2, g, out.view(-1, x.shape[-1]), eps)
    rmsnorm_launches += 1
    return out


def _rms_bwd(dy, x, g_table, eps: float):
    """The backward on plain tensors -> (dx in x's shape and dtype, dg
    (V, d) in g's dtype)."""
    global rmsnorm_bwd_dispatches, rmsnorm_bwd_launches
    rmsnorm_bwd_dispatches += 1
    d = x.shape[-1]
    dy2 = dy.to(x.dtype).reshape(-1, d)
    if _plain(x, "rmsnorm"):
        dx, dg = _rms.rmsnorm_bwd_plain(dy2, x.reshape(-1, d), g_table, eps)
        return dx.reshape(x.shape), dg
    x2 = _check_rmsnorm(x, g_table)
    _shadow(_rms.rmsnorm_bwd_plain, dy2, x.reshape(-1, d), g_table, eps)
    dy2 = dy2.contiguous()
    T, V = x2.shape[0], g_table.shape[0]
    dx = torch.empty((T, d), dtype=x.dtype, device=x.device)
    dg = torch.empty((V, d), dtype=g_table.dtype, device=x.device)
    ws = torch.empty(_rms.bwd_workspace_numel(T, d, V), dtype=torch.float32,
                     device=x.device)
    _rms.rmsnorm_bwd_cuda(dy2, x2, g_table, dx, dg, ws, eps)
    rmsnorm_bwd_launches += 1
    return dx.reshape(x.shape), dg


def _rows(t: torch.Tensor, dim, V: int) -> torch.Tensor:
    """A vmap rule's (V, ..., d) input as (V·T, d) rows."""
    t = _front(t, dim, V)
    return t.reshape(-1, t.shape[-1])


class _RmsNormFn(torch.autograd.Function):
    """``y = rmsnorm(x, g_table)`` (g_table (V, d), V | rows); the gradient
    through the backward kernel."""

    @staticmethod
    def forward(x, g_table, eps):
        return _rms_fwd(x, g_table, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, g_table, eps = inputs
        ctx.save_for_backward(x, g_table)
        ctx.eps = eps

    @staticmethod
    def backward(ctx, dy):
        x, g_table = ctx.saved_tensors
        dx, dg = _RmsNormBwdFn.apply(dy, x, g_table, ctx.eps)
        return dx, dg, None

    @staticmethod
    def vmap(info, in_dims, x, g_table, eps):
        # client v's rows read its g rows: a shared g is a stride-0 table
        V = info.batch_size
        xs = _front(x, in_dims[0], V)
        y = _RmsNormFn.apply(xs.reshape(-1, xs.shape[-1]),
                             _rows(g_table, in_dims[1], V), eps)
        return y.reshape(xs.shape), 0


class _RmsNormBwdFn(torch.autograd.Function):
    """``(dx, dg_table)`` of :class:`_RmsNormFn`; not differentiable
    again."""

    @staticmethod
    def forward(dy, x, g_table, eps):
        return _rms_bwd(dy, x, g_table, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the rmsnorm backward has no gradient")

    @staticmethod
    def vmap(info, in_dims, dy, x, g_table, eps):
        V = info.batch_size
        xs = _front(x, in_dims[1], V)
        gs = _front(g_table, in_dims[2], V)
        dx, dg = _RmsNormBwdFn.apply(_rows(dy, in_dims[0], V),
                                     xs.reshape(-1, xs.shape[-1]),
                                     gs.reshape(-1, gs.shape[-1]), eps)
        return (dx.reshape(xs.shape), dg.reshape(gs.shape)), (0, 0)


def launch_counts() -> dict:
    """The launch counters of the LM kernels, by kernel name (forward and
    backward)."""
    return {"flash": flash_launches, "flash_bwd": flash_bwd_launches,
            "ssm_scan": ssm_scan_launches,
            "ssm_scan_bwd": ssm_scan_bwd_launches,
            "rmsnorm": rmsnorm_launches, "rmsnorm_bwd": rmsnorm_bwd_launches}

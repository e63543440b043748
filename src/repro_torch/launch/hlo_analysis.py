"""Per-device cost analysis of a dispatch trace: FLOPs, bytes, collective
bytes and peak live memory.

Port of ``repro/launch/hlo_analysis.py``.  The JAX package parses the
compiled HLO; the port never produces HLO, so it counts the ops of one run
of the step as PyTorch dispatches them.  :class:`DispatchTrace` is a
``TorchDispatchMode`` that sits below DTensor: an op on DTensors is handed
on to DTensor (which shards it, inserts the collectives and runs the op on
the local shards), and the local ops come back to the mode, so every count
is per device, on local shard shapes.

1. FLOPs: the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``) as
   ``torch.utils.flop_counter`` counts it, 2 × |result| × contracted dims
   -- what the JAX parser counts for each ``dot``;
2. bytes: per op, result + operand bytes (at most 6 operands), skipping
   ops that move no data (views, fresh allocations, waits) as JAX skips
   ``bitcast``, ``parameter`` and ``copy-done`` -- an estimate;
3. collectives: result bytes by kind with ring factors (all-reduce 2×,
   reduce-scatter × group size, others 1×).  A collective is classified by
   what the program asked for: DTensor's shard-to-shard all-to-all, which
   a CPU process group runs as an all-gather and a chunk, counts as one
   all-to-all of its result;
4. memory: the peak of live bytes the ops allocated over the run (the
   ``temp_size_in_bytes`` of the record).

The trace counts only the program's tensors: those on ``device_type``
(``meta`` for an abstract trace, the card or the CPU for a real run) and
on the meta device (the shadow runs of ``kernels/ops.py``, which count a
kernel launch as its plain version); DTensor's own index bookkeeping on
the CPU is not counted.  JAX's loop multipliers have no counterpart: the
port's layers run in a Python loop, so each layer's ops are counted as
they run.
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import tree

_FACTORS = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
            "all-to-all": 1.0, "collective-permute": 1.0}

# funcol op name -> kind (the functional collectives DTensor issues)
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}

# ops that move no data: fresh allocations (JAX's parameter/constant),
# collective waits (copy-done) and autograd wrappers of collectives
_SKIP_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "wait_tensor",
               "_wrap_tensor_autograd", "_local_scalar_dense"}

_MATMULS = ("mm", "addmm", "bmm", "baddbmm")


def _tensors(xs) -> list:
    """The tensors of an op's arguments or results: ``xs`` a tensor, or a
    sequence of tensors, lists of tensors and other values."""
    if isinstance(xs, torch.Tensor):
        return [xs]
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """Whether every result of ``func`` aliases an input without writing
    it (a view: ``view``, ``permute``, ``select``, ``expand``, ...)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _flop_formulas() -> dict:
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    return {getattr(aten, n): flop_registry[getattr(aten, n)]
            for n in _MATMULS}


class DispatchTrace(TorchDispatchMode):
    """Counts the ops of the code run under it (see the module docstring).

    ``device_type``: the device of the program's tensors (``"meta"`` for
    an abstract trace).  After the run: :attr:`flops`, :attr:`bytes`,
    :attr:`bytes_by_kind` / :attr:`count_by_kind` (collectives),
    :attr:`peak_bytes` (live bytes allocated by the ops), :attr:`ops`
    (op -> count)."""

    def __init__(self, device_type: str = "meta"):
        super().__init__()
        self.device_types = {device_type, "meta"}
        self.flops = 0
        self.bytes = 0
        self.bytes_by_kind: Dict[str, float] = collections.defaultdict(float)
        self.count_by_kind: Dict[str, int] = collections.defaultdict(int)
        self.ops: Dict[str, int] = collections.Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._formulas = _flop_formulas()
        self._infos: Dict = {}
        self._quiet = 0

    # -- the program's tensors and their lifetimes ------------------------
    def _ours(self, ts) -> bool:
        return any(t.device.type in self.device_types for t in ts)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _allocated(self, outs) -> None:
        for t in outs:
            n = _nbytes(t)
            if n:
                self.live_bytes += n
                weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- collectives --------------------------------------------------------
    def _collective(self, kind: str, func, args, kwargs, outs) -> None:
        b = sum(_nbytes(t) for t in outs)
        factor = _FACTORS[kind]
        if kind == "reduce-scatter":
            g = _group_size(func, args, kwargs)
            factor = float(g) if g else 8.0
        self.bytes_by_kind[kind] += b * factor
        self.count_by_kind[kind] += 1

    @contextlib.contextmanager
    def as_collective(self, kind: str):
        """Count what runs inside as one collective of ``kind`` whose result
        is the value of the call (see :func:`count_alltoalls`); the ops
        that implement it are not counted."""
        box = []
        self._quiet += 1
        try:
            yield box
        finally:
            self._quiet -= 1
        outs = _tensors(box)
        if outs and self._ours(outs):
            self.bytes_by_kind[kind] += sum(map(_nbytes, outs)) \
                * _FACTORS[kind]
            self.count_by_kind[kind] += 1
            self.ops[f"<{kind}>"] += 1
            self.bytes += 2 * sum(map(_nbytes, outs))
            self._allocated(outs)

    # -- dispatch -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor shards it, then we see
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out) if isinstance(out, (torch.Tensor, list,
                                                  tuple)) else []
        if not self._ours(ins + outs):
            return out
        formula, kind, moves = self._info(func)
        self.ops[func] += 1
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if kind is not None:
            self._collective(kind, func, args, kwargs, outs)
        if moves is not None:
            if moves:
                self.bytes += sum(map(_nbytes, outs)) \
                    + sum(map(_nbytes, ins[:6]))
            self._allocated([t for t in outs
                             if not any(t is i for i in ins)])
        return out

    def _info(self, func):
        """(flop formula or None, collective kind or None, whether the op
        moves bytes -- None for a view, which allocates nothing), cached a
        func."""
        info = self._infos.get(func)
        if info is None:
            qual = func._schema.name
            name = qual.split("::")[-1]
            kind = (None if qual.startswith("aten::")
                    else _COLLECTIVES.get(name))
            moves = None if _is_view(func) else name not in _SKIP_BYTES
            info = (self._formulas.get(func._overloadpacket), kind, moves)
            self._infos[func] = info
        return info

    def __enter__(self):
        from repro_torch.kernels import ops
        self._shadow_before = ops.shadow_plain
        ops.shadow_plain = True
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.shadow_plain = self._shadow_before
        return super().__exit__(*exc)


def _group_size(func, args, kwargs) -> int:
    for a, v in zip(func._schema.arguments, args):
        if a.name == "group_size":
            return int(v)
    return int(kwargs.get("group_size", 0))


@contextlib.contextmanager
def count_alltoalls(trace: DispatchTrace):
    """Make DTensor's shard-to-shard all-to-all count as one all-to-all in
    ``trace`` whatever the process group runs it as (a CPU group runs an
    all-gather and a chunk)."""
    from torch.distributed.tensor import placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def alltoall(*args, **kwargs):
        with trace.as_collective("all-to-all") as box:
            out = orig(*args, **kwargs)
            box.append(out)
        return out

    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


def compute_stats(trace: DispatchTrace) -> dict:
    return {"flops_per_device": float(trace.flops),
            "bytes_per_device_est": float(trace.bytes)}


def collective_stats(trace: DispatchTrace) -> dict:
    total = sum(trace.bytes_by_kind.values())
    return {
        "bytes_by_kind": dict(trace.bytes_by_kind),
        "count_by_kind": dict(trace.count_by_kind),
        "total_bytes_per_device": total,
        "summary": {k: f"{v:.3e}" for k, v in trace.bytes_by_kind.items()},
    }


def analyze(trace: DispatchTrace) -> dict:
    return {**compute_stats(trace), "collectives": collective_stats(trace)}


def memory_stats(trace: Optional[DispatchTrace], args, outputs,
                 donate_argnums=(), unused_argnums=()) -> dict:
    """JAX's ``memory_analysis`` keys for one traced step: argument,
    output and donated (alias) bytes on this device, and the peak of the
    trace's live intermediates as ``temp_size_in_bytes``.  A Python int
    argument counts as an int32 scalar (JAX's ``pos``); arguments in
    ``unused_argnums`` do not count (JAX's jit drops what the step never
    reads)."""
    def size(x) -> int:
        if isinstance(x, bool):
            return 1
        if isinstance(x, int):
            return 4
        return sum(_local_nbytes(t) for t in tree.leaves(x)
                   if isinstance(t, torch.Tensor))

    return {
        "argument_size_in_bytes": sum(size(a) for i, a in enumerate(args)
                                      if i not in unused_argnums),
        "output_size_in_bytes": size(outputs),
        "alias_size_in_bytes": sum(size(args[i]) for i in donate_argnums),
        "temp_size_in_bytes": int(trace.peak_bytes) if trace else 0,
    }


def _local_nbytes(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return _nbytes(t)

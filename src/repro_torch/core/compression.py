"""Delta compression for the executor→server partials (DESIGN.md §7).  Port
of ``repro/core/compression.py``.

The hierarchical scheme already cuts comm from O(s_a·M_p) to O(s_a·K);
compression attacks the remaining s_a factor on the reducible entries:

- ``TopKCompressor``: per-executor top-|k| magnitude sparsification with
  error feedback (the residual is added to the next round's partial, so the
  scheme stays unbiased in the long run).
- ``Int8Compressor``: per-entry symmetric int8 quantisation (4x over fp32).
- ``PowerSGDCompressor``: low-rank factorisation by one step of warm-started
  power iteration per round (wire = P + Q instead of the dense buffer).

All three operate on the FLAT partial wire format: an entry occupies one
contiguous span of its group buffer (``core.flat.FlatLayout``), so the span
table of a group is static (``PartialCompressor._span_plans``):

- compress (``compiled=True``, the default) walks the
  targeted spans of a group buffer as contiguous views, with no copy.  The
  top-k path calls ``kernels.ops.fused_topk`` once per span: on the card
  the hand-written CUDA kernel, which writes the new residual into the
  compressor's own per-(sender, group) residual buffer on the device.  No
  value comes back to the host.
- decompress is LAZY: ``decompress_partial`` leaves the buffers in
  compressed wire form and the fold sites (``merge_partials`` /
  ``reduce_flat_partials`` / ``scale_partial``) consume them through
  ``densify_buffer`` / ``fold_buffer_into`` / ``scale_buffer`` below: top-k
  segments scatter-add (``index_add_``) straight into the accumulator.

Tie rule (top-k, both paths): the k entries of largest ``|x + residual|``
win; exact magnitude ties go to the LOWER index and indices ship sorted
ascending, so compiled and eager wires are bit-identical (and bit-identical
to the JAX package's).

The eager per-segment path (``compiled=False``) is kept as the reference;
the top-k one runs on the host in numpy and refuses a tensor on the card.
The JAX package's legacy nested ``{entry: pytree}`` partials are not
ported: every partial of the port is flat.  Compressors expose
``state_dict``/``load_state_dict`` (host numpy arrays, the JAX package's
format), so residuals and PowerSGD warm starts carry across from it.

PowerSGD's first Q is drawn with a ``torch.Generator`` seeded like the JAX
key (``(crc32(span key) ^ seed) & 0x7FFFFFFF``), so the two packages start
from different Q0; hand the JAX Q0 over through ``load_state_dict`` to
compare them.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.flat import flat_sums, is_compressed_buffer, is_flat_sums
from repro_torch.kernels import ops as kops


@dataclass
class CompressedTensor:
    kind: str
    shape: tuple
    dtype: str
    data: Dict[str, Any]

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(a) for a in self.data.values())


def _nbytes(a: Any) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def _numel(shape: tuple) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _host(t: Any) -> np.ndarray:
    """A host numpy copy (state dicts never alias live device buffers)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return np.array(t, copy=True)


def _f32_on(a: Any, device: torch.device) -> torch.Tensor:
    """``a`` as an fp32 tensor on ``device``, always a fresh copy unless it
    is already one of ours there."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


_codec_dispatches = 0


def codec_dispatch_count() -> int:
    """Group-level codec dispatches so far (one per compress / densify /
    fold / scale call on a group buffer): O(groups), not O(segments), per
    partial."""
    return _codec_dispatches


def reset_codec_dispatch_count() -> None:
    global _codec_dispatches
    _codec_dispatches = 0


def _bump() -> None:
    global _codec_dispatches
    _codec_dispatches += 1


# ---------------------------------------------------------------------------
# compressed-buffer consumers (the fused decompress-into-fold)
# ---------------------------------------------------------------------------
#
# A compressed group buffer is {"__compressed__": True, "segments": [...],
# "size": n} with ordered ("raw", tensor) | ("comp", CompressedTensor)
# segments covering [0, n).

def _walk(segments, out: torch.Tensor, combine) -> torch.Tensor:
    """Apply every segment to ``out`` in place: ``combine(view, dense)``
    for raw, int8 and low-rank segments; top-k segments scatter-add."""
    dev = out.device
    off = 0
    for kind, x in segments:
        if kind == "raw":
            n = x.numel()
            if n:
                combine(out[off:off + n], x.to(dev, torch.float32))
        elif x.kind == "topk":
            n = _numel(x.shape)
            idx, vals = x.data["idx"], x.data["vals"]
            if n and idx.numel():
                out[off:off + n].index_add_(0, idx.to(dev),
                                            vals.to(dev, torch.float32))
        elif x.kind == "int8":
            n = _numel(x.shape)
            if n:
                combine(out[off:off + n],
                        x.data["q"].to(dev, torch.float32)
                        * x.data["scale"].to(dev))
        elif x.kind == "powersgd":
            n = _numel(x.shape)
            p, q = x.data["p"].to(dev), x.data["q"].to(dev)
            combine(out[off:off + n], (p @ q.T).reshape(-1)[:n])
        else:
            raise ValueError(f"unknown compressed kind: {x.kind}")
        off += n
    return out


def _buffer_device(buf: Dict[str, Any]) -> torch.device:
    for kind, x in buf["segments"]:
        for t in ([x] if kind == "raw" else x.data.values()):
            if isinstance(t, torch.Tensor):
                return t.device
    return torch.device("cpu")


def densify_buffer(buf: Dict[str, Any]) -> torch.Tensor:
    """Decode a compressed group buffer to its dense (n,) fp32 form (top-k
    values scatter-add into zeros, as the JAX package's decode does)."""
    _bump()
    out = torch.zeros(int(buf["size"]), dtype=torch.float32,
                      device=_buffer_device(buf))
    return _walk(buf["segments"], out, lambda view, seg: view.copy_(seg))


def fold_buffer_into(acc: torch.Tensor, buf: Dict[str, Any]) -> torch.Tensor:
    """Fused decompress-into-fold: a new tensor ``acc + decode(buf)`` —
    raw/int8/low-rank segments add as slices, top-k segments scatter-add —
    with no dense intermediate per partial.  ``acc`` is left as it was."""
    _bump()
    out = acc.to(torch.float32, copy=True)
    return _walk(buf["segments"], out, lambda view, seg: view.add_(seg))


def scale_buffer(buf: Dict[str, Any], gamma: float) -> Dict[str, Any]:
    """Scale a compressed group buffer by ``gamma`` WITHOUT decoding it
    (staleness discounts): raw segments and top-k values scale directly,
    int8 folds gamma into the scale, PowerSGD into P."""
    _bump()
    g = float(np.float32(gamma))       # an fp32 factor, as on the JAX side
    out_segs: List[Tuple[str, Any]] = []
    for kind, x in buf["segments"]:
        if kind == "raw":
            out_segs.append(("raw", x.to(torch.float32) * g))
            continue
        d = x.data
        if x.kind == "topk":
            new = {"idx": d["idx"], "vals": d["vals"] * g}
        elif x.kind == "int8":
            new = {"q": d["q"], "scale": d["scale"] * g}
        elif x.kind == "powersgd":
            new = {"p": d["p"] * g, "q": d["q"]}
        else:
            raise ValueError(f"unknown compressed kind: {x.kind}")
        out_segs.append(("comp", CompressedTensor(x.kind, x.shape, x.dtype,
                                                  new)))
    return {"__compressed__": True, "segments": out_segs,
            "size": int(buf["size"])}


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------

class PartialCompressor:
    """Shared compress/decompress plumbing over the flat partial format.

    Subclasses provide ``_compress(a, key) -> CompressedTensor`` and
    ``_decompress(c) -> tensor`` (the eager reference), and — when
    ``compiled`` — ``_group_compress(group, buf, plan, prefix)`` processing
    a whole group buffer in one call.  ``entries`` names the target entries
    (everything else rides raw)."""

    entries: Tuple[str, ...] = ("delta",)
    compiled: bool = False

    # --- subclass hooks ---------------------------------------------------
    def _compress(self, a: torch.Tensor, key: str) -> CompressedTensor:
        raise NotImplementedError

    def _decompress(self, c: CompressedTensor) -> torch.Tensor:
        raise NotImplementedError

    def _group_compress(self, group: str, buf: torch.Tensor, plan: tuple,
                        prefix: str) -> Dict[str, Any]:
        raise NotImplementedError

    # --- checkpointable state --------------------------------------------
    def state_dict(self) -> Optional[Dict[str, Any]]:
        return None

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        pass

    # --- flat path --------------------------------------------------------
    def _span_plans(self, layout) -> Dict[str, tuple]:
        """Per-group STATIC segment plan: ordered ("raw"|"comp", off, size,
        entry|None) tuples covering [0, group_size) — the comp spans are the
        targeted entries, everything between rides raw."""
        spans_by_group: Dict[str, List[Tuple[int, int, str]]] = {}
        for name in self.entries:
            span = layout.spans.get(name)
            if span is not None:
                spans_by_group.setdefault(span.group, []).append(
                    (span.offset, span.size, name))
        plans: Dict[str, tuple] = {}
        for g, spans in spans_by_group.items():
            total = int(layout.group_sizes[g])
            plan: List[tuple] = []
            cursor = 0
            for off, size, name in sorted(spans):
                if off > cursor:             # untargeted entries ride raw
                    plan.append(("raw", cursor, off - cursor, None))
                plan.append(("comp", off, size, name))
                cursor = off + size
            if cursor < total:
                plan.append(("raw", cursor, total - cursor, None))
            plans[g] = tuple(plan)
        return plans

    def _compress_flat(self, sums: Dict, layout, prefix: str = "") -> Dict:
        buffers = dict(sums["buffers"])
        if layout is None:
            return flat_sums(buffers)
        for g, plan in self._span_plans(layout).items():
            buf = buffers.get(g)
            if buf is None or isinstance(buf, dict):
                continue
            if self.compiled:
                buffers[g] = self._group_compress(g, buf, plan, prefix)
                continue
            arr = buf.to(torch.float32).reshape(-1)
            segments: List[Tuple[str, Any]] = []
            for kind, off, sz, name in plan:
                if kind == "raw":
                    segments.append(("raw", arr[off:off + sz]))
                else:
                    segments.append(
                        ("comp", self._compress(arr[off:off + sz],
                                                f"{prefix}{g}/{name}")))
            buffers[g] = {"__compressed__": True, "segments": segments,
                          "size": int(arr.numel())}
        return flat_sums(buffers)

    def _decompress_flat(self, sums: Dict) -> Dict:
        buffers = {}
        for g, buf in sums["buffers"].items():
            if is_compressed_buffer(buf):
                pieces = [x.to(torch.float32) if kind == "raw"
                          else self._decompress(x).reshape(-1)
                          for kind, x in buf["segments"]]
                buffers[g] = pieces[0] if len(pieces) == 1 \
                    else torch.cat(pieces)
            else:
                buffers[g] = buf
        return flat_sums(buffers)

    # --- public API -------------------------------------------------------
    def compress_partial(self, partial: Dict,
                         key: Optional[str] = None) -> Dict:
        """``key`` namespaces stateful compressor state (error-feedback
        residuals, PowerSGD warm starts): the server passes the sending
        executor's id, so each executor carries its OWN state stream."""
        sums = partial["sums"]
        if not is_flat_sums(sums):
            raise ValueError("the port compresses flat partials only")
        out = dict(partial)
        prefix = "" if key is None else f"{key}/"
        out["sums"] = self._compress_flat(sums, partial.get("layout"), prefix)
        out["_wire_bytes"] = _wire_bytes(out["sums"])
        return out

    def decompress_partial(self, partial: Dict) -> Dict:
        """Compiled codecs decompress LAZILY: the buffers stay in wire form
        and the fold consumes their segments straight into the
        accumulator."""
        out = dict(partial)
        sums = partial["sums"]
        if not is_flat_sums(sums):
            raise ValueError("the port decompresses flat partials only")
        out["sums"] = sums if self.compiled else self._decompress_flat(sums)
        return out


class TopKCompressor(PartialCompressor):
    """Magnitude top-k with per-sender error feedback.

    ``compiled=True`` (the default) holds the residual as one (n,) fp32
    tensor per (sender, group) on the partial's device and runs
    ``kernels.ops.fused_topk`` on every targeted span of a group buffer,
    updating that residual in place; ``compiled=False`` is the eager
    per-span numpy reference (host residual dict), for CPU tensors only.
    Both obey the same tie rule, so their wire bytes are bit-identical."""

    def __init__(self, fraction: float = 0.01, entries: tuple = ("delta",),
                 compiled: bool = True):
        self.fraction = float(fraction)
        self.entries = tuple(entries)
        self.compiled = bool(compiled)
        # eager: span-keyed host residuals; compiled: group-keyed residual
        # tensors on the device
        self._residual: Dict[str, Any] = {}

    def _k_of(self, n: int) -> int:
        return max(1, int(n * self.fraction)) if n else 0

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": "topk",
                "residual": {k: _host(v) for k, v in self._residual.items()}}

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        self._residual = {} if not state else \
            {k: np.array(v, copy=True)
             for k, v in state.get("residual", {}).items()}

    # --- eager reference --------------------------------------------------
    def _compress(self, a: torch.Tensor, key: str) -> CompressedTensor:
        if a.device.type != "cpu":
            raise ValueError("the eager top-k reference runs on the host; "
                             "use compiled=True for a tensor on the card")
        host = a.detach().numpy()
        flat = np.asarray(host, np.float32).reshape(-1)
        res = self._residual.get(key)
        if res is not None and np.shape(res) == flat.shape:
            flat = flat + np.asarray(res, np.float32)
        k = self._k_of(flat.size)
        # stable sort on -|f|: largest magnitudes first, ties -> lower index
        order = np.argsort(-np.abs(flat), kind="stable")[:k]
        idx = np.sort(order).astype(np.int32)
        vals = flat[idx]
        new_res = flat.copy()
        new_res[idx] = 0.0                      # error feedback residual
        self._residual[key] = new_res
        return CompressedTensor("topk", tuple(host.shape), str(host.dtype),
                                {"idx": torch.from_numpy(idx).to(a.device),
                                 "vals": torch.from_numpy(vals).to(a.device)})

    def _decompress(self, c: CompressedTensor) -> torch.Tensor:
        vals = c.data["vals"]
        flat = torch.zeros(_numel(c.shape), dtype=torch.float32,
                           device=vals.device)
        flat[c.data["idx"].long()] = vals.to(torch.float32)
        return flat.reshape(c.shape)

    # --- compiled group path ---------------------------------------------
    def _group_compress(self, g: str, buf: torch.Tensor, plan: tuple,
                        prefix: str) -> Dict[str, Any]:
        arr = buf.to(torch.float32).reshape(-1)     # a view when fp32
        n = arr.numel()
        skey = f"{prefix}{g}"
        res = self._residual.get(skey)
        if res is None or tuple(np.shape(res)) != (n,):
            res = torch.zeros(n, dtype=torch.float32, device=arr.device)
        elif not (isinstance(res, torch.Tensor) and res.device == arr.device):
            res = _f32_on(res, arr.device)
        _bump()
        segments: List[Tuple[str, Any]] = []
        for kind, off, sz, _name in plan:
            if kind == "raw":
                segments.append(("raw", arr[off:off + sz]))
                continue
            k = self._k_of(sz)
            if k <= 0:
                idx = torch.zeros(0, dtype=torch.int32, device=arr.device)
                vals = torch.zeros(0, dtype=torch.float32, device=arr.device)
            else:
                idx, vals, _ = kops.fused_topk(arr[off:off + sz],
                                               res[off:off + sz], k,
                                               inplace=True)
            segments.append(("comp", CompressedTensor(
                "topk", (sz,), "float32", {"idx": idx, "vals": vals})))
        self._residual[skey] = res           # stays on the device
        return {"__compressed__": True, "segments": segments, "size": n}


def _int8_quantize(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale fp32 0-d) with the JAX package's operations:
    scale = max(max|f| / 127, 1e-12); q = clip(round(f / scale))."""
    scale = torch.clamp_min(f.abs().max() / 127.0, 1e-12)
    q = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    return q, scale


class Int8Compressor(PartialCompressor):
    """Symmetric per-entry int8 quantisation with an fp32 scale.

    ``compiled=True`` (the default) quantises every targeted span of a
    group buffer in one call and decompresses lazily into the fold;
    ``compiled=False`` is the per-segment reference with an eager decode."""

    def __init__(self, entries: tuple = ("delta",), compiled: bool = True):
        self.entries = tuple(entries)
        self.compiled = bool(compiled)

    @staticmethod
    def _empty(shape: tuple, device: torch.device) -> Dict[str, Any]:
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": torch.tensor(1.0, dtype=torch.float32,
                                      device=device)}

    def _compress(self, a: torch.Tensor, key: str) -> CompressedTensor:
        if a.numel() == 0:
            return CompressedTensor("int8", tuple(a.shape), "float32",
                                    self._empty(tuple(a.shape), a.device))
        q, scale = _int8_quantize(a.to(torch.float32))
        return CompressedTensor("int8", tuple(a.shape), "float32",
                                {"q": q, "scale": scale})

    def _decompress(self, c: CompressedTensor) -> torch.Tensor:
        q = c.data["q"]
        if q.numel() == 0:
            return torch.zeros(c.shape, dtype=torch.float32, device=q.device)
        return q.to(torch.float32) * c.data["scale"]

    def _group_compress(self, g: str, buf: torch.Tensor, plan: tuple,
                        prefix: str) -> Dict[str, Any]:
        arr = buf.to(torch.float32).reshape(-1)
        _bump()
        segments: List[Tuple[str, Any]] = []
        for kind, off, sz, _name in plan:
            x = arr[off:off + sz]
            if kind == "raw":
                segments.append(("raw", x))
                continue
            data = self._empty((0,), arr.device) if sz == 0 else \
                dict(zip(("q", "scale"), _int8_quantize(x)))
            segments.append(("comp", CompressedTensor("int8", (sz,),
                                                      "float32", data)))
        return {"__compressed__": True, "segments": segments,
                "size": arr.numel()}


def _psgd_shape(n: int, rank: int) -> Tuple[int, int, int]:
    """Near-square (rows, cols) factorisation of a flat span plus the
    effective rank (clipped so P/Q stay skinny)."""
    cols = max(1, int(math.ceil(math.sqrt(max(n, 1)))))
    rows = -(-n // cols)
    r = max(1, min(int(rank), rows, cols))
    return rows, cols, r


def _psgd_step(seg: torch.Tensor, q0: torch.Tensor, res: torch.Tensor,
               rows: int, cols: int):
    """One power-iteration step: M = reshape(seg + res); P = orth(M Q0);
    Q' = Mᵀ P; residual = seg + res − unravel(P Q'ᵀ)."""
    sz = seg.numel()
    f = seg + res
    m = f if rows * cols == sz else \
        torch.nn.functional.pad(f, (0, rows * cols - sz))
    m = m.reshape(rows, cols)
    p = torch.linalg.qr(m @ q0).Q          # orthonormalise P
    q1 = m.T @ p
    approx = (p @ q1.T).reshape(-1)[:sz]
    return p, q1, f - approx


class PowerSGDCompressor(PartialCompressor):
    """PowerSGD-style low-rank compression of the flat group buffers.

    Each targeted span reshapes to a near-square (rows, cols) matrix M of
    the residual-corrected update; one warm-started power-iteration step
    gives ``P = orth(M Q)`` (rows×r) and ``Q' = Mᵀ P`` (cols×r), and the
    wire carries P and Q'.  The decoded update is ``P Q'ᵀ``; the
    approximation error feeds back into the next round's residual, and Q'
    warm-starts the next iteration.  State (Q, res) is keyed per (sender,
    group, entry).  Always compiled (plain PyTorch matrix products and QR:
    the JAX package has no kernel of its own here)."""

    def __init__(self, rank: int = 4, entries: tuple = ("delta",),
                 seed: int = 0):
        self.rank = int(max(1, rank))
        self.entries = tuple(entries)
        self.seed = int(seed)
        self.compiled = True
        self._state: Dict[str, Dict[str, Any]] = {}

    def _init_q(self, skey: str, cols: int, r: int,
                device: torch.device) -> torch.Tensor:
        # deterministic per span key: a resume from scratch re-derives the
        # identical init, and distinct senders/entries decorrelate
        gen = torch.Generator().manual_seed(
            (zlib.crc32(skey.encode()) ^ self.seed) & 0x7FFFFFFF)
        return torch.randn((cols, r), generator=gen,
                           dtype=torch.float32).to(device)

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": "powersgd",
                "state": {k: {"q": _host(v["q"]), "res": _host(v["res"])}
                          for k, v in self._state.items()}}

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        self._state = {} if not state else \
            {k: {"q": np.array(v["q"], copy=True),
                 "res": np.array(v["res"], copy=True)}
             for k, v in state.get("state", {}).items()}

    def _group_compress(self, g: str, buf: torch.Tensor, plan: tuple,
                        prefix: str) -> Dict[str, Any]:
        arr = buf.to(torch.float32).reshape(-1)
        dev = arr.device
        _bump()
        segments: List[Tuple[str, Any]] = []
        for kind, off, sz, name in plan:
            seg = arr[off:off + sz]
            if kind == "raw" or sz == 0:     # nothing to factorise
                segments.append(("raw", seg))
                continue
            rows, cols, r = _psgd_shape(sz, self.rank)
            skey = f"{prefix}{g}/{name}"
            st = self._state.get(skey)
            if st is None or tuple(np.shape(st["q"])) != (cols, r):
                q0 = self._init_q(skey, cols, r, dev)
                res = torch.zeros(sz, dtype=torch.float32, device=dev)
            else:
                q0, res = _f32_on(st["q"], dev), _f32_on(st["res"], dev)
            p, q1, new_res = _psgd_step(seg, q0, res, rows, cols)
            self._state[skey] = {"q": q1, "res": new_res}
            segments.append(("comp", CompressedTensor(
                "powersgd", (sz,), "float32", {"p": p, "q": q1})))
        return {"__compressed__": True, "segments": segments,
                "size": arr.numel()}


def _wire_bytes(sums: Dict) -> int:
    """Bytes the flat sums occupy on the wire: compressed segments at their
    data arrays' bytes, dense buffers at numel x itemsize."""
    if not is_flat_sums(sums):
        raise ValueError("the port sizes flat sums only")
    tot = 0
    for buf in sums["buffers"].values():
        if is_compressed_buffer(buf):
            tot += sum(_nbytes(x) if kind == "raw" else x.nbytes
                       for kind, x in buf["segments"])
        else:
            tot += _nbytes(buf)
    return tot


def make_compressor(kind: str, arg: Optional[float] = None, *,
                    entries: tuple = ("delta",),
                    rank: Optional[int] = None,
                    compiled: bool = True, seed: int = 0):
    """Build a compressor by name.

    ``arg`` is the top-k fraction (default 0.01); for "powersgd" it doubles
    as the rank when ``rank=`` is not given.  ``entries=`` targets extra
    reducible entries beyond "delta" (e.g. SCAFFOLD's control variates:
    ``entries=("delta", "delta_c")``).  ``compiled=False`` selects the eager
    per-segment reference paths for topk/int8 (PowerSGD is only
    compiled)."""
    if not kind or kind == "none":
        return None
    if kind == "topk":
        return TopKCompressor(fraction=0.01 if arg is None else float(arg),
                              entries=entries, compiled=compiled)
    if kind == "int8":
        return Int8Compressor(entries=entries, compiled=compiled)
    if kind == "powersgd":
        r = int(rank if rank is not None else (arg if arg else 4))
        return PowerSGDCompressor(rank=r, entries=entries, seed=seed)
    raise ValueError(kind)

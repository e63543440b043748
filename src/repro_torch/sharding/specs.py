"""Sharding rules: parameter / activation / cache specs as DTensor
placements.

Port of ``repro/sharding/specs.py`` (DESIGN.md §5: FSDP×TP 2-D sharding).
- Every large weight shards its biggest eligible dim over the data-parallel
  axes (``("pod","data")`` multi-pod, ``("data",)`` single-pod — ZeRO-3
  style, DTensor inserts the all-gathers) and a second dim over ``"model"``
  (Megatron TP).
- Rules are *name-aware* where structure matters (embeddings, attention,
  MoE experts, KV caches) and fall back to a size heuristic for anything
  else.
- Stacked-layer params (leading ``n_rep`` dim) get ``None`` for the layer
  dim automatically.

A spec is a plain tuple with one entry per tensor dim: ``None``, an axis
name, or a tuple of axis names — the entry list of a JAX ``PartitionSpec``.
:func:`to_placements` turns it into DTensor placements over a
``DeviceMesh``, one per mesh dim.  The rules read only ``axis_names`` and a
shape by axis name, so :class:`MeshShape` (the analogue of JAX's
``AbstractMesh``) serves the spec-only sweeps without a process group.
"""
from __future__ import annotations

import math
import re
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without devices or a process group."""
    sizes: Tuple[int, ...]
    names: Tuple[str, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_shape(mesh) -> MeshShape:
    """The logical axes of a mesh: a ``MeshShape`` as it is; a
    ``DeviceMesh`` by its own dims, or by the axes it was built for
    (``launch/mesh.py`` folds the multi-pod ``("pod", "data")`` into one
    dim: see :func:`axis_groups`)."""
    if isinstance(mesh, MeshShape):
        return mesh
    logical = getattr(mesh, "repro_axes", None)
    if logical is not None:
        return logical
    return MeshShape(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def axis_groups(mesh) -> Tuple[Tuple[str, ...], ...]:
    """The logical axes behind each dim of a mesh: one axis a dim, except
    on a ``DeviceMesh`` built with folded axes (``repro_groups``)."""
    groups = getattr(mesh, "repro_groups", None)
    if groups is not None:
        return groups
    return tuple((a,) for a in mesh_shape(mesh).axis_names)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh (everything but 'model')."""
    return tuple(a for a in mesh_shape(mesh).axis_names if a != "model")


def stacked_partial_spec(mesh, ndim: int = 2,
                         axes: Optional[Sequence[str]] = None) -> Spec:
    """Spec for per-executor flat partials stacked on axis 0 — rows over
    the data-parallel axes (or an explicit ``axes`` subset), the buffer
    payload unsharded."""
    row = tuple(axes) if axes is not None else dp_axes(mesh)
    return (row,) + (None,) * (ndim - 1)


def axis_size(mesh, axes) -> int:
    shape = mesh_shape(mesh).shape
    n = 1
    for a in ([axes] if isinstance(axes, str) else axes):
        n *= shape[a]
    return n


def _divisible(dim: int, n: int) -> bool:
    return dim > 0 and dim % n == 0


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``: one per mesh dim,
    ``Shard(i)`` where tensor dim ``i`` names that dim's axes, else
    ``Replicate()``.  A dim sharded over ``("pod", "data")`` shards on both
    mesh dims, in mesh order (DTensor's order for one tensor dim over
    several mesh dims), or on the one dim that folds them."""
    groups = axis_groups(mesh)
    out = [Replicate() for _ in groups]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [j for j, g in enumerate(groups) if set(g) <= set(axes)]
        if sum((groups[j] for j in dims), ()) != axes:
            raise ValueError(f"spec entry {entry} is not a run of the mesh "
                             f"dims {groups} in order")
        for j in dims:
            out[j] = Shard(i)
    return out


@dataclass(frozen=True)
class Sharding:
    """A spec with its placements over one mesh: one leaf of a sharding
    tree, as ``NamedSharding`` is in JAX."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-device shard shape of a (divisible) ``spec`` layout."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            out[i] //= axis_size(mesh, entry)
    return tuple(out)


def map_with_path(fn, t, path: Tuple = ()):
    """``jax.tree_util.tree_map_with_path`` over the port's nested
    dict/tuple/list trees: ``fn(path, leaf)``, path entries being dict keys
    and sequence indices."""
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: map_with_path(fn, t[k], path + (k,)) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        out = [map_with_path(fn, v, path + (i,)) for i, v in enumerate(t)]
        return out if isinstance(t, list) else tuple(out)
    return fn(path, t)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def param_spec(path, shape: Tuple[int, ...], mesh,
               stacked: bool = True, tied_embeddings: bool = False) -> Spec:
    """Spec for one parameter leaf.

    ``stacked``: model params carry a leading layer dim; it is detected
    per leaf by name (block params live under 'blocks').
    ``tied_embeddings``: the embedding doubles as the LM head, so it gets
    the Megatron vocab-parallel layout (V over model, d over dp).
    """
    name = _path_str(path)
    dp = dp_axes(mesh)
    ndp = axis_size(mesh, dp)
    ntp = mesh_shape(mesh).shape["model"]
    is_stacked = stacked and "blocks" in name
    dims = list(shape[1:]) if is_stacked else list(shape)
    off = 1 if is_stacked else 0

    spec: list = [None] * len(shape)

    def assign(local_idx: int, axes) -> None:
        spec[local_idx + off] = axes

    small = math.prod(dims) <= 4096 if dims else True

    if not dims or small:
        pass                                            # replicate
    elif len(dims) == 1:
        if _divisible(dims[0], ntp) and dims[0] >= 8192:
            assign(0, "model")
    else:
        # name-aware fast paths ------------------------------------------
        lowered = name.lower()
        handled = True
        if re.search(r"embed/w$", lowered) and len(dims) == 2:
            if tied_embeddings:
                # vocab-parallel: V over model, d over dp
                if _divisible(dims[0], ntp):
                    assign(0, "model")
                if _divisible(dims[1], ndp):
                    assign(1, dp)
            else:
                # (V, d): vocab over dp (ZeRO), d over model
                if _divisible(dims[0], ndp):
                    assign(0, dp)
                if _divisible(dims[1], ntp):
                    assign(1, "model")
        elif re.search(r"lm_head/w$", lowered) and len(dims) == 2:
            # (d, V): d over dp, vocab over model (column-parallel head)
            if _divisible(dims[0], ndp):
                assign(0, dp)
            if _divisible(dims[1], ntp):
                assign(1, "model")
        elif re.search(r"attn/(wq|wk|wv)/(w|b)$", lowered):
            # (d, Hn, hd) / bias (Hn, hd): heads over model when divisible;
            # otherwise replicate over model (the activation policy falls
            # back to sequence-TP).  d over dp (ZeRO).
            h_dim = len(dims) - 2
            if _divisible(dims[h_dim], ntp):
                assign(h_dim, "model")
            if len(dims) == 3 and _divisible(dims[0], ndp):
                assign(0, dp)
        elif re.search(r"attn/wo/w$", lowered) and len(dims) == 3:
            # (H, hd, d): heads over model (row-parallel), d over dp
            if _divisible(dims[0], ntp):
                assign(0, "model")
            if _divisible(dims[2], ndp):
                assign(2, dp)
        elif re.search(r"ffn/(wi|wg)/?w?$", lowered) and len(dims) == 3:
            # MoE experts (E, d, f): d over dp (ZeRO storage), f over model;
            # the use site gathers d explicitly (constrain "moe_weight")
            if _divisible(dims[1], ndp):
                assign(1, dp)
            if _divisible(dims[2], ntp):
                assign(2, "model")
        elif re.search(r"ffn/wo/?w?$", lowered) and len(dims) == 3:
            # MoE experts (E, f, d): f over model (row-parallel), d over dp
            if _divisible(dims[1], ntp):
                assign(1, "model")
            if _divisible(dims[2], ndp):
                assign(2, dp)
        elif len(dims) == 2 and re.search(
                r"/(wo|down|out_proj|out)/w$", lowered):
            # second matmul of a block (row-parallel): in-dim over model
            if _divisible(dims[0], ntp):
                assign(0, "model")
            if _divisible(dims[1], ndp):
                assign(1, dp)
        elif len(dims) == 2:
            # first matmul (column-parallel): in over dp, out over model
            if _divisible(dims[0], ndp):
                assign(0, dp)
            if _divisible(dims[1], ntp):
                assign(1, "model")
        else:
            handled = False
        if not handled:
            # generic heuristic: biggest divisible dim -> dp, next -> tp
            order = sorted(range(len(dims)), key=lambda i: -dims[i])
            dp_dim = next((i for i in order if _divisible(dims[i], ndp)), None)
            if dp_dim is not None:
                assign(dp_dim, dp)
            tp_dim = next((i for i in order
                           if i != dp_dim and _divisible(dims[i], ntp)), None)
            if tp_dim is not None:
                assign(tp_dim, "model")
    return tuple(spec)


def params_shardings(params_tree, mesh):
    """``Sharding`` tree matching a params tree."""
    tied = isinstance(params_tree, dict) and "lm_head" not in params_tree
    return map_with_path(
        lambda path, leaf: Sharding(mesh, param_spec(
            path, tuple(leaf.shape), mesh, tied_embeddings=tied)),
        params_tree)


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------

def batch_spec(shape: Tuple[int, ...], mesh,
               seq_axis: Optional[int] = None) -> Spec:
    """Inputs/labels (B, S[, d]): batch over dp; if batch=1 (long-context)
    shard the sequence dim over dp instead (sequence parallelism)."""
    dp = dp_axes(mesh)
    ndp = axis_size(mesh, dp)
    spec: list = [None] * len(shape)
    if _divisible(shape[0], ndp):
        spec[0] = dp
    elif len(shape) > 1 and seq_axis is not None \
            and _divisible(shape[seq_axis], ndp):
        spec[seq_axis] = dp
    return tuple(spec)


def cache_spec(path, shape: Tuple[int, ...], mesh) -> Spec:
    """KV-cache / decode-state leaves (stacked: leading n_rep dim).

    k/v: (L, B, Smax, KV, hd) — batch over dp; kv-heads over model when
    divisible, else the ring buffer's seq dim, else head_dim.  pos:
    replicated.  SSM states (L, B, H, N, P): batch over dp, heads/P over
    model.
    """
    name = _path_str(path)
    dp = dp_axes(mesh)
    ndp = axis_size(mesh, dp)
    ntp = mesh_shape(mesh).shape["model"]
    spec: list = [None] * len(shape)
    if name.endswith("pos") or len(shape) < 3:
        return tuple(spec)
    # dims[0] = layer stack; dims[1] = batch
    if _divisible(shape[1], ndp):
        spec[1] = dp
    if re.search(r"attn/(k|v)$", name) and len(shape) == 5:
        for i in (3, 2, 4):
            if _divisible(shape[i], ntp) and shape[i] >= ntp:
                spec[i] = "model"
                break
    else:
        # SSM/conv decode states: model axis on the largest divisible
        # trailing dim
        for i in range(len(shape) - 1, 1, -1):
            if spec[i] is None and _divisible(shape[i], ntp) \
                    and shape[i] >= ntp:
                spec[i] = "model"
                break
    if all(s is None for s in spec[1:]) and _divisible(shape[2], ndp):
        spec[2] = dp   # batch=1 long-context: shard the ring buffer seq dim
    return tuple(spec)


def caches_shardings(cache_tree, mesh):
    """``Sharding`` tree matching a cache tree."""
    return map_with_path(
        lambda path, leaf: Sharding(mesh, cache_spec(path, tuple(leaf.shape),
                                                     mesh)), cache_tree)


# ---------------------------------------------------------------------------
# activation sharding constraints (enabled only under a mesh; the model code
# calls ``constrain(x, kind)`` and it is the identity without a policy or on
# a tensor that is not a DTensor)
# ---------------------------------------------------------------------------

_ACTIVE_POLICY: Optional["ActivationPolicy"] = None


class ActivationPolicy:
    """Decides activation specs per tensor kind.

    kinds:
      residual — (B, S, d): batch over dp (seq over dp when B=1)
      heads    — (B, S, Hn, hd): batch over dp; heads over model when
                 divisible, else *sequence-TP* (S over model)
      tokens   — (T, ...) flattened token-major tensors: T over dp
    and kv_heads, loss_chunk, moe_weight, moe_weight_row, moe_group (see
    :meth:`spec`).
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self.dp = dp_axes(mesh)
        self.ndp = axis_size(mesh, self.dp)
        self.ntp = mesh_shape(mesh).shape["model"]

    KINDS = ("residual", "heads", "tokens", "loss_chunk", "moe_group")

    def spec(self, kind: str, shape: Tuple[int, ...]) -> Optional[Spec]:
        dp, ndp, ntp = self.dp, self.ndp, self.ntp
        s: list = [None] * len(shape)
        if kind == "residual" and len(shape) == 3:
            if _divisible(shape[0], ndp):
                s[0] = dp
            elif _divisible(shape[1], ndp):
                s[1] = dp
            # Megatron-style sequence parallelism: the residual stream also
            # shards its seq dim over "model"
            if s[1] is None and shape[1] > 1 and _divisible(shape[1], ntp):
                s[1] = "model"
            return tuple(s)
        if kind == "heads" and len(shape) == 4:
            if _divisible(shape[0], ndp):
                s[0] = dp
            elif _divisible(shape[1], ndp):
                s[1] = dp
            if _divisible(shape[2], ntp):
                s[2] = "model"
            elif s[1] is None and _divisible(shape[1], ntp) and shape[1] > 1:
                s[1] = "model"          # sequence-TP fallback
            return tuple(s)
        if kind == "kv_heads" and len(shape) == 4:
            # GQA k/v when q runs head-TP: batch over dp, replicated over
            # model unless the kv heads divide it
            if _divisible(shape[0], ndp):
                s[0] = dp
            if _divisible(shape[2], ntp):
                s[2] = "model"
            return tuple(s)
        if kind == "tokens" and len(shape) >= 2:
            if _divisible(shape[0], ndp):
                s[0] = dp
            return tuple(s)
        if kind == "loss_chunk" and len(shape) == 3:
            # (B, Sc, d): batch over dp, seq/d replicated (pre-head gather)
            if _divisible(shape[0], ndp):
                s[0] = dp
            return tuple(s)
        if kind == "moe_weight" and len(shape) == 3:
            # explicit ZeRO gather point: (E, d, f) replicated over dp,
            # f stays on model
            if _divisible(shape[2], ntp):
                s[2] = "model"
            return tuple(s)
        if kind == "moe_weight_row" and len(shape) == 3:
            # (E, f, d): f on model, d replicated (gathered over dp)
            if _divisible(shape[1], ntp):
                s[1] = "model"
            return tuple(s)
        if kind == "moe_group" and len(shape) == 3:
            # (G, gs, d): groups over dp, tokens/d replicated
            if _divisible(shape[0], ndp):
                s[0] = dp
            return tuple(s)
        return None


def head_tp_active(H: int) -> bool:
    """True when the activation policy will shard H heads over model."""
    pol = _ACTIVE_POLICY
    return pol is not None and H % pol.ntp == 0


def tp_padded_heads(H: int, KV: int) -> int:
    """Head count padded up to the model-axis multiple, when profitable.

    Zero-padded query heads make head-TP available to archs whose H does
    not divide the model axis — exact math (padded wo rows are zero), at
    most 50 % extra attention FLOPs.  The padded H must stay a multiple of
    KV (GQA groups) and the overhead is capped at 1.5x.  Without a policy
    this is H.
    """
    pol = _ACTIVE_POLICY
    if pol is None or H % pol.ntp == 0:
        return H
    Hp = -(-H // pol.ntp) * pol.ntp
    if KV > 0 and Hp % KV != 0:
        return H
    if Hp > 1.5 * H:
        return H
    return Hp


def enable_activation_policy(mesh) -> None:
    global _ACTIVE_POLICY
    _GATHERED[:] = [None, None]
    _ACTIVE_POLICY = ActivationPolicy(mesh) if mesh is not None else None


def on_mesh(x) -> bool:
    """Whether ``x`` is laid out by the active policy: a policy is on and
    ``x`` is a DTensor.  Every hook below is the identity (or the plain op)
    otherwise, and checks the policy first, so the main path pays one
    global read a hook."""
    return _ACTIVE_POLICY is not None and isinstance(x, DTensor)


def model_offset(x, n: int) -> int:
    """Where this device's part of a length-``n`` dim split over "model"
    starts, for a DTensor ``x`` on the mesh (0 on the fake group's rank
    0)."""
    mesh = x.device_mesh
    return mesh.get_local_rank("model") * (n // mesh.size(
        mesh.mesh_dim_names.index("model")))


def constrain(x, kind: str):
    """Redistribute a DTensor to the active policy's placements for
    ``kind``; the identity without a policy, for a kind the policy leaves
    alone, or when ``x`` is not a DTensor."""
    if not on_mesh(x):
        return x
    spec = _ACTIVE_POLICY.spec(kind, tuple(x.shape))
    if spec is None:
        return x
    placements = to_placements(spec, x.device_mesh)
    if list(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def reduce_partial(x):
    """A DTensor's pending partial sums reduced (``Partial`` placements made
    ``Replicate``); the identity for any other tensor.  DTensor's
    vocab-parallel gather leaves a masked partial that must be reduced
    while it keeps its gathered dim."""
    if not on_mesh(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def place(t, mesh, spec: Spec):
    """The meta tensor ``t`` (global shape) as a DTensor laid out by
    ``spec`` over the ``DeviceMesh`` ``mesh``: its shard a fresh meta
    tensor of the local shape (no data, no collective)."""
    if not t.is_meta:
        raise ValueError("place lays out meta tensors (the dry run's)")
    local = torch.empty(local_shape(tuple(t.shape), spec, mesh),
                        dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())


def place_caches(caches):
    """A fresh cache tree laid out by :func:`cache_spec` over the active
    policy's ``DeviceMesh``; the identity without a policy, on a
    ``MeshShape`` or on a one-device mesh (the prefill step's hook)."""
    pol = _ACTIVE_POLICY
    if pol is None or isinstance(pol.mesh, MeshShape) \
            or mesh_shape(pol.mesh).size == 1:
        return caches
    return map_with_path(
        lambda path, leaf: place(leaf, pol.mesh,
                                 cache_spec(path, tuple(leaf.shape),
                                            pol.mesh)), caches)


def logsumexp(x):
    """``torch.logsumexp`` over the last axis.  A DTensor (vocab-parallel
    logits in a dry run) takes its composite form, whose max and sum
    DTensor reduces across shards, where ``torch.logsumexp`` would gather
    the whole vocabulary."""
    if not on_mesh(x):
        return torch.logsumexp(x, dim=-1)
    m = torch.amax(x.detach(), dim=-1, keepdim=True)
    return (torch.log(torch.sum(torch.exp(x - m), dim=-1, keepdim=True))
            + m)[..., 0]


def placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements when both are DTensors
    (a gradient laid out as its parameter: partial sums reduce-scattered);
    the identity for any other tensor."""
    if not on_mesh(x) or not isinstance(ref, DTensor) \
            or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def reshape(x, *shape):
    """``x.reshape(*shape)``.  A DTensor whose layout DTensor cannot carry
    through the reshape (a sharded dim split into parts the shards do not
    divide, or merged unevenly) is first replicated on the dims the reshape
    changes; its gradient likewise on the way back.  Any other tensor:
    ``x.reshape(*shape)``."""
    if not on_mesh(x):
        return x.reshape(*shape)
    out = _reshapeable(x, shape).reshape(*shape)
    if out.requires_grad:
        in_shape = tuple(x.shape)
        out.register_hook(lambda g: _reshapeable(g, in_shape))
    return out


def _reshapeable(x, shape):
    """``x`` as it is when DTensor can reshape it to ``shape``, else
    replicated on the dims the reshape changes."""
    try:
        x.reshape(*shape)
        return x
    except RuntimeError:
        return _replicate_from(x, shape)


def _replicate_from(x, shape):
    """``x`` with its sharding dropped on every dim from the first one the
    reshape to ``shape`` changes."""
    new = list(shape)
    if -1 in new:
        i = new.index(-1)
        new[i] = x.numel() // max(1, math.prod(n for n in new if n != -1))
    keep = 0
    while keep < min(x.ndim, len(new)) and x.shape[keep] == new[keep]:
        keep += 1
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim >= keep else p
        for p in x.placements])


def zero_gather(w):
    """A weight at its point of use, gathered over the data-parallel axes
    (ZeRO-3: the shards are stored over dp, the product reads them whole
    and the backward reduce-scatters the gradient); its "model" sharding
    stays.  The identity without a policy or for a tensor that is not a
    DTensor."""
    if not on_mesh(w):
        return w
    names = w.device_mesh.mesh_dim_names
    placements = [p if names[i] == "model" else Replicate()
                  for i, p in enumerate(w.placements)]
    if placements == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, placements)


def matmul(x, w):
    """``x @ w`` for an activation ``x`` (..., d_in) and a weight ``w``
    (d_in, n).  On DTensors (a dry run) the weight is read gathered over
    the data-parallel axes (:func:`zero_gather`) and the product is laid
    out as Megatron lays it out, mesh dim by mesh dim, on each device's
    local tensors (DTensor's own strategy picks the least communication,
    not the least work: it repeats a backward product on every device
    when the operands it saved are replicated, and flattens a batch with
    a sharded sequence, a view some releases refuse):

    - rows of ``x`` (its batch, or the sequence under sequence
      parallelism) sharded where ``w`` is replicated: each device
      multiplies its own rows, and ``w``'s gradient sums the devices';
    - ``w``'s columns sharded (column-parallel): ``x`` is read whole
      along its inner dims there, gathered once for all the weights that
      read the same ``x``, and its gradient sums the devices';
    - the contraction sharded on either side (row-parallel): the other
      side reads its matching slice, and the product is a sum over the
      devices (``Partial``)."""
    if not on_mesh(x):
        return x @ w
    w = zero_gather(w)
    if not isinstance(w, DTensor):
        return x @ w
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    last = x.ndim - 1
    x = reduce_partial(x)
    if any(isinstance(q, Shard) and q.dim == 1 and isinstance(p, Shard)
           and p.dim < last for p, q in zip(x.placements, w.placements)):
        x = _inner_gathered(x)
    xp, wp, op, xg, wg = [], [], [], [], []
    for p, q in zip(x.placements, w.placements):
        if isinstance(q, Shard) and q.dim == 1:          # column-parallel
            xp.append(Replicate()); wp.append(q); op.append(Shard(last))
            xg.append(Partial()); wg.append(q)
        elif (isinstance(p, Shard) and p.dim == last) or \
                (isinstance(q, Shard) and q.dim == 0):   # row-parallel
            xp.append(Shard(last)); wp.append(Shard(0)); op.append(Partial())
            xg.append(Shard(last)); wg.append(Shard(0))
        else:                                            # rows, or whole
            xp.append(p); wp.append(q); op.append(p)
            xg.append(p); wg.append(Partial() if isinstance(p, Shard)
                                    else q)
    mesh = x.device_mesh
    xp, wp = tuple(xp), tuple(wp)
    if xp != tuple(x.placements):
        x = x.redistribute(mesh, xp)
    if wp != tuple(w.placements):
        w = w.redistribute(mesh, wp)
    return local_map(torch.matmul, out_placements=(tuple(op),),
                     in_placements=(xp, wp),
                     in_grad_placements=(tuple(xg), tuple(wg)),
                     device_mesh=mesh)(x, w)


# the last activation gathered along its inner dims by :func:`matmul`,
# kept while that activation lives: (weak reference to it, the gather)
_GATHERED: list = [None, None]


def _inner_gathered(x):
    ref, g = _GATHERED
    if ref is not None and ref() is x:
        return g
    g = x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim > 0 else p
        for p in x.placements])
    _GATHERED[:] = [weakref.ref(x, _forget_gathered), g]
    return g


def _forget_gathered(ref) -> None:
    if _GATHERED[0] is ref:
        _GATHERED[:] = [None, None]


def _summed_over(pl) -> tuple:
    """The gradient placements of a tensor read whole by work split as
    ``pl``: a sum (``Partial``) over each mesh dim the work is split on."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in pl)


def local_call(fn, args, dims, out_dims, batch: int, heads: int = 0):
    """``fn(*args)`` on each device's own shard, for work that is
    independent across batch rows (and across heads): each DTensor
    argument is laid out with its batch dim ``dims[i][0]`` over the
    data-parallel mesh dims and its head dim ``dims[i][1]`` over "model"
    (None: replicated there; a size that does not divide stays
    replicated), ``fn`` runs on the local tensors, and its outputs come
    back as DTensors laid out by ``out_dims`` the same way; an output head
    dim ``"sum"`` is a sum over the "model" shards (``Partial``) where the
    heads are split.  An argument replicated on a mesh dim the work is
    split on gets a summed gradient there.  Where DTensor would shard such
    work op by op it gathers heads or sequence to merge them with the
    batch.  Without a policy or a DTensor among ``args``: ``fn(*args)``."""
    mesh = (next((a.device_mesh for a in args if isinstance(a, DTensor)),
                 None) if _ACTIVE_POLICY is not None else None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    names = mesh.mesh_dim_names

    def layout(bd, hd):
        out = []
        for j, name in enumerate(names):
            n = mesh.size(j)
            if name == "model":
                ok = hd is not None and heads and heads % n == 0
                out.append((Partial() if hd == "sum" else Shard(hd))
                           if ok else Replicate())
            else:
                ok = bd is not None and batch % n == 0
                out.append(Shard(bd) if ok else Replicate())
        return tuple(out)

    in_pl = tuple(None if a is None else layout(*d)
                  for a, d in zip(args, dims))
    split = [any(pl is not None and isinstance(pl[j], Shard)
                 for pl in in_pl) for j in range(len(names))]
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if split[j] and isinstance(p, Replicate) else p
        for j, p in enumerate(pl)) for pl in in_pl)
    # a plain tensor (a fresh state) is the same on every device
    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
            else a for a in args]
    args = [a.redistribute(mesh, pl) if isinstance(a, DTensor) and
            tuple(a.placements) != pl else a
            for a, pl in zip(args, in_pl)]
    out_pl = tuple(layout(*d) for d in out_dims)
    single = len(out_pl) == 1
    res = local_map(fn, out_placements=out_pl, in_placements=in_pl,
                    in_grad_placements=grad_pl, device_mesh=mesh)(*args)
    return res[0] if single and isinstance(res, (tuple, list)) else res


def shardwise(fn, x):
    """``fn(x)`` for an ``fn`` whose result on a shard is that shard of
    its result (an elementwise op; a pad along a dim ``x`` is not sharded
    on).  A DTensor without pending partial sums runs ``fn`` on its local
    shard and keeps its layout: for ops DTensor has no sharding rule for
    (``log_sigmoid_backward``) or mishandles (``constant_pad_nd`` in some
    releases)."""
    if not on_mesh(x) or any(p.is_partial() for p in x.placements):
        return fn(x)
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(x.placements)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def rowwise(fn, x, *params):
    """``fn(x, *params)`` for an ``fn`` that works row by row along ``x``'s
    last dim, ``params`` per feature (a norm).  A DTensor ``x`` runs it on
    its own rows, its last dim and the params whole (their gradients summed
    over the devices' rows): DTensor would merge a sharded batch and
    sequence into rows on the way back, a view some releases refuse."""
    if not on_mesh(x):
        return fn(x, *params)
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    last = x.ndim - 1
    pl = tuple(Replicate() if p.is_partial()
               or (isinstance(p, Shard) and p.dim == last) else p
               for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(mesh, pl)
    whole = (Replicate(),) * mesh.ndim
    params = [q.redistribute(mesh, whole) if isinstance(q, DTensor)
              else DTensor.from_local(q, mesh, whole, run_check=False)
              for q in params]
    return local_map(fn, out_placements=(pl,),
                     in_placements=(pl,) + (whole,) * len(params),
                     in_grad_placements=(pl,) + (_summed_over(pl),)
                     * len(params), device_mesh=mesh)(x, *params)


def lookup(w, ids):
    """``w[ids]`` (an embedding).  With DTensors each device looks its own
    ids up in the whole table, and the table's gradient is a partial sum
    over the devices whose ids differ (DTensor's own indexed write for
    it fails in some releases)."""
    if not on_mesh(w):
        return w[ids.long()]
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    whole = (Replicate(),) * mesh.ndim
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, whole, run_check=False)
    pl = tuple(Replicate() if p.is_partial() else p for p in ids.placements)
    return local_map(lambda w_, i_: w_[i_.long()], out_placements=(pl,),
                     in_placements=(whole, pl),
                     in_grad_placements=(_summed_over(pl), pl),
                     device_mesh=mesh)(w.redistribute(mesh, whole),
                                       ids.redistribute(mesh, pl))

"""Abstract stand-ins for every model input, placed by the sharding rules.

Port of ``repro/launch/inputs.py``.  ``input_specs(cfg, shape, mesh)``
returns everything the dry run needs to trace a cell: the step function,
the arguments and their placements.  On a ``DeviceMesh`` the arguments are
DTensors over meta shards of the local shapes (no allocation); on a
one-device mesh they are plain meta tensors.  With ``device`` given (a
one-device mesh only) the same builders make real arguments: params drawn
from ``seed`` and random ids, as the launchers make them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import tree
from repro_torch.models import layers, lm, transformer
from repro_torch.sharding import specs as shard_specs


@dataclass
class CellSpec:
    step_fn: Callable
    args: Tuple[Any, ...]
    placements: Tuple[Any, ...]           # Sharding trees, None: replicated
    donate_argnums: Tuple[int, ...] = ()
    static_desc: str = ""
    # arguments the step never reads (JAX's jit drops them from its
    # argument bytes): the decode position of a model without attention
    unused_argnums: Tuple[int, ...] = ()


def params_abstract(cfg):
    """The param tree as ``FakeTensor``s (shapes and dtypes, no data)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return lm.init_params(torch.Generator(), cfg)


def _distributed(mesh) -> bool:
    return shard_specs.mesh_shape(mesh).size > 1


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _lay_out(x, shardings, mesh):
    """Meta tensors placed by a ``Sharding`` tree (plain on one device)."""
    if not _distributed(mesh):
        return x
    return tree.map(lambda t, s: shard_specs.place(t, mesh, s.spec), x,
                    shardings)


def _ids(cfg, batch: int, seq: int, device, gen):
    if device == "meta":
        return torch.empty((batch, seq), dtype=torch.int32, device="meta")
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=device, dtype=torch.int32)


def _inputs(cfg, batch: int, seq: int, device, gen):
    if cfg.input_kind != "embeddings":
        return _ids(cfg, batch, seq, device, gen)
    shape, dtype = (batch, seq, cfg.d_model), layers.dtype_of(cfg.dtype)
    if device == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def input_specs(cfg, shape, mesh, lr: float = 0.05, *,
                device: Optional[str] = None, seed: int = 0) -> CellSpec:
    """The cell's step, its arguments and their placements over ``mesh``
    (a ``DeviceMesh``, or a one-device ``MeshShape``).  ``device`` None:
    abstract arguments; else real ones on ``device`` (one-device meshes
    only).  Ids are int32, as in JAX; the decode position is a Python
    int."""
    if device is not None and _distributed(mesh):
        raise ValueError("real arguments are built for a one-device mesh")
    B, S = shape.global_batch, shape.seq_len
    dev = device or "meta"
    gen = None
    if device is None:
        params = tree.map(_meta, params_abstract(cfg))
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = lm.init_params(gen, cfg)
    p_shard = shard_specs.params_shardings(params, mesh)
    params = _lay_out(params, p_shard, mesh)

    def batched(x, seq_axis=None):
        s = shard_specs.Sharding(
            mesh, shard_specs.batch_spec(tuple(x.shape), mesh, seq_axis))
        return _lay_out(x, s, mesh), s

    if shape.kind == "train":
        step = lm.make_train_step(cfg, lr, functional=False)
        inputs, in_s = batched(_inputs(cfg, B, S, dev, gen), 1)
        labels, lab_s = batched(_ids(cfg, B, S, dev, gen), 1)
        batch = {"inputs": inputs, "labels": labels}
        return CellSpec(step, (params, batch),
                        (p_shard, {"inputs": in_s, "labels": lab_s}),
                        donate_argnums=(0,),
                        static_desc=f"train_step B={B} S={S}")

    if shape.kind == "prefill":
        step = lm.make_prefill_step(cfg, B, S)
        inputs, in_s = batched(_inputs(cfg, B, S, dev, gen), 1)
        return CellSpec(step, (params, inputs), (p_shard, in_s),
                        static_desc=f"prefill B={B} S={S}")

    # decode / long_decode: one new token against a seq_len cache
    step = lm.make_decode_step(cfg)
    inputs, in_s = batched(_inputs(cfg, B, 1, dev, gen))
    caches = transformer.stack_cache(cfg, B, S, layers.dtype_of(cfg.dtype),
                                     dev)
    cache_shard = shard_specs.caches_shardings(caches, mesh)
    caches = _lay_out(caches, cache_shard, mesh)
    pos = 0
    attends = any(k in ("dense", "hybrid")
                  for k in transformer.unit_pattern(cfg))
    return CellSpec(step, (params, inputs, caches, pos),
                    (p_shard, in_s, cache_shard, None),
                    donate_argnums=(2,),
                    static_desc=f"decode B={B} cache={S}",
                    unused_argnums=() if attends else (3,))

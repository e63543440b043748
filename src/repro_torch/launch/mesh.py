"""Production and host meshes.

Port of ``repro/launch/mesh.py``.  A mesh here is a
:class:`~repro_torch.sharding.specs.MeshShape`: its axis sizes and names.
Building one touches no process group; :func:`use_mesh` brings a ``'fake'``
process group of as many ranks up (``torch.testing``'s ``FakeStore``:
this process plays rank 0, and every collective returns at once), yields
its ``DeviceMesh`` and destroys the group on exit, so no later code in the
process sees an initialised group.  That is what the dry run needs:
DTensor shards each op and inserts the collectives, and no data moves.  The
multi-pod mesh's ``("pod", "data")`` axes are one dim of 32 in the
``DeviceMesh`` (pod-major, as JAX flattens them when it shards a dim over
both); the sharding rules still see three axes (:func:`fold_groups`).

A mesh of one device needs no group at all (every placement is
``Replicate``): :func:`use_mesh` then yields the shape itself and the step
runs on plain tensors, on the card or the CPU.  No caller runs a step on a
mesh of several real devices, so there is no NCCL / gloo branch.  The
device-placement layer (``core/placement.py``) keeps its own device list:
a one-card gang needs no mesh.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch

from repro_torch.sharding.specs import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod, traced on
    a fake process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(shape, axes)


def make_fake_mesh(data: int, model: int) -> MeshShape:
    """A ``(data, model)`` mesh traced on a fake process group (tests,
    small dry runs)."""
    return MeshShape((data, model), ("data", "model"))


def make_host_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
                   devices: Optional[Sequence] = None) -> MeshShape:
    """A ``("data", "model")`` mesh of this host's cards (one, the CPU,
    without a card), or of ``devices``.  One device runs the step for real
    (``launch/dryrun.py``'s ``execute``); more are traced on a fake
    group."""
    if devices is not None:
        n = len(devices)
    else:
        n = n_devices or (torch.cuda.device_count()
                          if torch.cuda.is_available() else 1)
    if n % model_axis:
        raise ValueError(f"{n} devices do not split into a model axis of "
                         f"{model_axis}")
    return MeshShape((n // model_axis, model_axis), ("data", "model"))


@contextlib.contextmanager
def use_mesh(plan: MeshShape):
    """Bring a fake process group of ``plan.size`` ranks up and yield its
    ``DeviceMesh``; the group is destroyed on exit.  A one-device plan
    yields itself (no group)."""
    if plan.size == 1:
        yield plan
        return
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; use_mesh brings "
                           "its own up and down")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=plan.size)
    try:
        groups = fold_groups(plan)
        shape = plan.shape
        dmesh = init_device_mesh(
            "cpu", tuple(math.prod(shape[a] for a in g) for g in groups),
            mesh_dim_names=tuple("_".join(g) for g in groups))
        dmesh.repro_axes = MeshShape(tuple(plan.sizes), tuple(plan.names))
        dmesh.repro_groups = groups
        yield dmesh
    finally:
        dist.destroy_process_group()


def fold_groups(plan: MeshShape):
    """The mesh dims a plan is built with: its data-parallel axes folded
    into one dim (the multi-pod mesh's ``("pod", "data")``, which every
    rule shards over together), ``"model"`` on its own.  DTensor then never
    shards one tensor dim over two mesh dims, which its view rules mishandle
    and its redistribution planner searches slowly."""
    dp = tuple(a for a in plan.names if a != "model")
    return tuple(g for g in (dp, ("model",) if "model" in plan.names
                             else ()) if g)

"""The port's sharding rules (``repro_torch/sharding/specs.py``) against
the JAX package's (``repro/sharding/specs.py``) on the two production
meshes, for all ten archs: every param leaf's spec, every cache and batch
spec of every runnable shape, the activation policy's eight kinds over a
grid of shapes, and the tensor-parallel head padding.  The port's side
uses ``MeshShape`` and JAX's ``AbstractMesh``: no process group, no
devices.  Then the port's own checks (JAX's): specs divide their dims,
every > 32 MB param is sharded, and ``to_placements`` lays a tensor out
with the local shape the spec implies.
"""
import itertools

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs.base import ALL_SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JARCHS
from repro.launch.inputs import params_abstract as jparams_abstract
from repro.models import transformer as jtransformer
from repro.sharding import specs as jspecs
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.configs.registry import ARCHS, cell_is_runnable
from repro_torch.launch.inputs import params_abstract
from repro_torch.launch.mesh import make_fake_mesh, use_mesh
from repro_torch.models import layers, transformer
from repro_torch.sharding import specs

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("residual", "heads", "kv_heads", "tokens", "loss_chunk",
         "moe_weight", "moe_weight_row", "moe_group")


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


def _meshes(name):
    sizes, names = MESHES[name]
    return specs.MeshShape(sizes, names), _abstract_mesh(sizes, names)


def _jax_leaves(tree, fn):
    out = {}

    def leaf(path, x):
        out[jspecs._path_str(path)] = fn(path, x)
    jax.tree_util.tree_map_with_path(leaf, tree)
    return out


def _port_leaves(tree, fn):
    out = {}

    def leaf(path, x):
        out[specs._path_str(path)] = fn(path, x)
    specs.map_with_path(leaf, tree)
    return out


def _pad(spec, n):
    """A spec's entries padded to n dims, a one-axis tuple written as its
    axis (``PartitionSpec`` stores ``("data",)`` as ``"data"``)."""
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)
    return spec + (None,) * (n - len(spec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_jax(mesh_name, arch):
    mesh, jmesh = _meshes(mesh_name)
    jp = jparams_abstract(JARCHS[arch])
    tp = params_abstract(ARCHS[arch])
    jtied, tied = "lm_head" not in jp, "lm_head" not in tp
    assert jtied == tied
    want = _jax_leaves(jp, lambda path, x: (tuple(x.shape), _pad(
        jspecs.param_spec(path, x.shape, jmesh, tied_embeddings=jtied),
        len(x.shape))))
    got = _port_leaves(tp, lambda path, x: (tuple(x.shape), _pad(
        specs.param_spec(path, tuple(x.shape), mesh, tied_embeddings=tied),
        len(x.shape))))
    assert got == want
    sh = specs.params_shardings(tp, mesh)
    assert _port_leaves(sh, lambda path, s: (None, _pad(s.spec, 0))) == {
        k: (None, v[1]) for k, v in want.items()}


def _caches(cfg, shape, device):
    return transformer.stack_cache(cfg, shape.global_batch, shape.seq_len,
                                   layers.dtype_of(cfg.dtype), device)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_and_batch_specs_equal_jax(mesh_name, arch):
    mesh, jmesh = _meshes(mesh_name)
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    for shape, jshape in zip(ALL_SHAPES, JSHAPES):
        ok, _ = cell_is_runnable(cfg, shape)
        if not ok:
            continue
        B, S = shape.global_batch, shape.seq_len
        for dims, seq_axis in (((B, S), 1), ((B, 1), None),
                               ((B, S, cfg.d_model), 1)):
            assert _pad(specs.batch_spec(dims, mesh, seq_axis), 0) == _pad(
                jspecs.batch_spec(dims, jmesh, seq_axis=seq_axis),
                len(dims))
        if shape.kind not in ("decode", "long_decode"):
            continue
        jc = jax.eval_shape(lambda: jtransformer.stack_cache(
            jcfg, B, S, jnp.dtype(jcfg.dtype)))
        want = _jax_leaves(jc, lambda path, x: (tuple(x.shape), _pad(
            jspecs.cache_spec(path, x.shape, jmesh), len(x.shape))))
        got = _port_leaves(_caches(cfg, shape, "meta"),
                           lambda path, x: (tuple(x.shape), _pad(
                               specs.cache_spec(path, tuple(x.shape), mesh),
                               0)))
        assert got == want, (arch, shape.name)


SHAPE_GRID = [s for n in (1, 2, 3, 4)
              for s in itertools.product((1, 2, 14, 16, 32, 256),
                                         repeat=n)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_policy_equals_jax(mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    pol, jpol = specs.ActivationPolicy(mesh), jspecs.ActivationPolicy(jmesh)
    for kind in KINDS:
        for shape in SHAPE_GRID:
            want = jpol.spec(kind, shape)
            got = pol.spec(kind, shape)
            assert (None if got is None else _pad(got, 0)) == (
                None if want is None else _pad(want, len(shape))), \
                (kind, shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_head_padding_equals_jax(mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    grid = [(H, KV) for H in range(1, 66) for KV in (0, 1, 2, 4, 5, 7, 8, H)]
    try:
        specs.enable_activation_policy(None)
        jspecs.enable_activation_policy(None)
        for H, KV in grid:          # no policy: no padding anywhere
            assert specs.tp_padded_heads(H, KV) == H
            assert not specs.head_tp_active(H)
        specs.enable_activation_policy(mesh)
        jspecs.enable_activation_policy(jmesh)
        for H, KV in grid:
            assert specs.tp_padded_heads(H, KV) == \
                jspecs.tp_padded_heads(H, KV), (H, KV)
            assert specs.head_tp_active(H) == jspecs.head_tp_active(H)
    finally:
        specs.enable_activation_policy(None)
        jspecs.enable_activation_policy(None)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_small_helpers_equal_jax(mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    assert specs.dp_axes(mesh) == jspecs.dp_axes(jmesh)
    for axes in ("model", ("data",), ("data", "model"), specs.dp_axes(mesh)):
        assert specs.axis_size(mesh, axes) == jspecs.axis_size(jmesh, axes)
    for ndim in (1, 2, 3):
        for axes in (None, ("data",)):
            assert _pad(specs.stacked_partial_spec(mesh, ndim, axes), 0) == \
                _pad(jspecs.stacked_partial_spec(jmesh, ndim, axes), ndim)


def _divides(spec, shape, mesh):
    for i, axes in enumerate(spec):
        if axes is not None:
            assert shape[i] % specs.axis_size(mesh, axes) == 0, \
                (spec, shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_divide_and_big_params_are_sharded(mesh_name):
    mesh, _ = _meshes(mesh_name)
    for arch in sorted(ARCHS):
        tp = params_abstract(ARCHS[arch])
        tied = "lm_head" not in tp

        def check(path, x):
            spec = specs.param_spec(path, tuple(x.shape), mesh,
                                    tied_embeddings=tied)
            _divides(spec, x.shape, mesh)
            if x.numel() * x.element_size() >= (32 << 20):
                assert any(a is not None for a in spec), \
                    (arch, specs._path_str(path))
        specs.map_with_path(check, tp)
        cfg = ARCHS[arch]
        for shape in ALL_SHAPES:
            if cell_is_runnable(cfg, shape)[0] and \
                    shape.kind in ("decode", "long_decode"):
                specs.map_with_path(lambda path, x: _divides(
                    specs.cache_spec(path, tuple(x.shape), mesh), x.shape,
                    mesh), _caches(cfg, shape, "meta"))


def test_to_placements_lays_out_the_local_shape():
    """Each spec's DTensor over a 4×2 fake mesh holds the local shard the
    spec implies, ("data",) and "model" alike; specs that name axes out of
    mesh order are refused."""
    from torch.distributed.tensor import Replicate, Shard
    shape = (8, 4, 6)
    with use_mesh(make_fake_mesh(4, 2)) as mesh:
        for spec in [(None, None, None), (("data",), None, None),
                     (None, "model", None), (("data",), "model", None),
                     ("model", None, ("data",)), (None, None, "model")]:
            pl = specs.to_placements(spec, mesh)
            assert len(pl) == 2
            t = specs.place(torch.empty(shape, device="meta"), mesh, spec)
            assert list(t.placements) == pl
            assert tuple(t.shape) == shape
            assert tuple(t.to_local().shape) == specs.local_shape(
                shape, spec, mesh)
        assert specs.to_placements((("data", "model"),), mesh) == \
            [Shard(0), Shard(0)]
        assert specs.to_placements((None,), mesh) == [Replicate()] * 2
        with pytest.raises(ValueError, match="in order"):
            specs.to_placements((("model", "data"),), mesh)
    assert not dist.is_initialized()


def test_constrain_is_the_identity_without_a_policy_or_a_dtensor():
    x = torch.ones(4, 8, 16)
    specs.enable_activation_policy(None)
    for kind in KINDS:
        assert specs.constrain(x, kind) is x
    specs.enable_activation_policy(specs.MeshShape((4, 2),
                                                   ("data", "model")))
    try:
        for kind in KINDS:
            assert specs.constrain(x, kind) is x
        assert specs.zero_gather(x) is x
        assert specs.place_caches({"k": x}) == {"k": x}
    finally:
        specs.enable_activation_policy(None)
    assert specs.reshape(x, 4, 128).shape == (4, 128)
    assert specs.reduce_partial(x) is x and specs.placed_like(x, x) is x

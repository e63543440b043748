"""The port's dry run on a mesh of several devices: a 4×2 ``("data",
"model")`` mesh on a fake process group of 8 ranks, built and destroyed
in this process.

JAX's four integration cells (``tests/test_dryrun_integration.py``: the
reduced configs at 4 layers, bf16, B 8, S 128) trace ``ok`` with FLOPs,
temp and collective bytes above 0; 8 layers count 1.5–2.6× the FLOPs of
4; 8 × the per-device FLOPs cover the 1×1 count of the same step (no
sharded work is lost) and exceed it by at most 1.2× (little is
repeated).  The dispatch trace's per-device counts on
hand-built DTensor cases with known answers; no process group outlives a
cell.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_fake_mesh, make_host_mesh, use_mesh
from repro_torch.sharding import specs

CUT = {"global_batch": 8, "seq_len": 128}
CELLS = [("qwen2-0.5b", "train"), ("grok-1-314b", "train"),
         ("hymba-1.5b", "decode"), ("xlstm-125m", "prefill")]
# 8 × the per-device FLOPs over the 1×1 count: the sLSTM's recurrence runs
# whole on each "model" rank (xlstm prefill 1.139), the rest is split
MAX_REPEAT = 1.2
SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
          "decode": "decode_32k"}


def overrides(arch, n_layers=4):
    cfg = dataclasses.replace(
        get_arch(arch).reduced(), n_layers=n_layers, d_model=128, d_ff=256,
        n_heads=4, n_kv_heads=2, head_dim=32, vocab_size=512,
        dtype="bfloat16", remat=True, logit_chunk=0)
    if cfg.xlstm is not None:
        cfg = dataclasses.replace(cfg, d_ff=0)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name"}


def cell(arch, kind, mesh, tmp_path, n_layers=4):
    rec = dryrun.run_cell(arch, SHAPES[kind], mesh=mesh,
                          out_dir=str(tmp_path), verbose=False,
                          overrides=overrides(arch, n_layers),
                          shape_overrides=CUT)
    assert rec["status"] == "ok", rec.get("traceback")
    assert not dist.is_initialized()
    return rec


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_small_mesh_cell(arch, kind, tmp_path):
    rec = cell(arch, kind, make_fake_mesh(4, 2), tmp_path)
    assert rec["n_devices"] == 8 and rec["mesh"] == {"data": 4, "model": 2}
    assert rec["flops_per_device"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["collectives"]["total_bytes_per_device"] > 0
    one = cell(arch, kind, make_host_mesh(1, devices=["cpu"]), tmp_path)
    # no sharded work is lost, and little is repeated across devices
    ratio = 8 * rec["flops_per_device"] / one["flops_per_device"]
    assert 1.0 <= ratio <= MAX_REPEAT, ratio


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b"])
def test_heads_that_do_not_divide_the_model_axis_repeat_little_work(
        arch, tmp_path):
    """5 query heads on 5 KV heads and a model axis of 4 (no padding makes
    them divide): attention runs sequence-parallel, each device its own
    query rows; hymba's 2-head scan splits its value columns; the
    projections, whose weights are replicated over "model", take each
    device's own rows of the sequence-sharded input.  8 × the per-device
    FLOPs stay within MAX_REPEAT of the 1×1 count."""
    ov = dict(overrides(arch), n_heads=5, n_kv_heads=5)
    recs = [dryrun.run_cell(arch, "train_4k", mesh=mesh,
                            out_dir=str(tmp_path), verbose=False,
                            overrides=ov, shape_overrides=CUT)
            for mesh in (make_fake_mesh(2, 4),
                         make_host_mesh(1, devices=["cpu"]))]
    assert [r["status"] for r in recs] == ["ok", "ok"], \
        [r.get("traceback") for r in recs]
    ratio = 8 * recs[0]["flops_per_device"] / recs[1]["flops_per_device"]
    assert 1.0 <= ratio <= MAX_REPEAT, ratio
    assert not dist.is_initialized()


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_query_rows_at_an_offset_attend_as_in_the_whole_sequence(impl):
    """Sequence-parallel attention's local call: a block of query rows at
    ``q_offset`` over the whole of k and v gives those rows of the whole
    sequence's attention, causal and windowed."""
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, 3, 16, generator=gen) for _ in range(3))
    for window in (0, 24):
        kw = dict(causal=True, window=window)
        if impl == "chunked":
            kw["chunk"] = 16
        fn = getattr(attention, f"{impl}_attention")
        whole = fn(q, k, v, **kw)
        for lo in (0, 16, 48):
            part = fn(q[:, lo:lo + 16], k, v, q_offset=lo, **kw)
            torch.testing.assert_close(part, whole[:, lo:lo + 16],
                                       rtol=1e-5, atol=1e-6)


def test_eight_layers_count_about_twice_four(tmp_path):
    mesh = make_fake_mesh(4, 2)
    f4 = cell("qwen2-0.5b", "train", mesh, tmp_path)["flops_per_device"]
    f8 = cell("qwen2-0.5b", "train", mesh, tmp_path,
              n_layers=8)["flops_per_device"]
    assert 1.5 < f8 / f4 < 2.6, f8 / f4


def _meta_dtensor(mesh, shape, placements):
    spec = [None] * len(shape)
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            spec[p.dim] = mesh.mesh_dim_names[j]
    local = specs.local_shape(shape, spec, mesh)
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def test_per_device_counts_on_hand_built_cases():
    """A product split over all 8 devices counts a 1/8 of the global
    FLOPs on each, a replicated one counts whole; an all-reduce counts its
    result twice, a reduce-scatter its result times the group, and a
    shard-to-shard move one all-to-all of its result."""
    M, K, N = 64, 32, 16
    with use_mesh(make_fake_mesh(4, 2)) as mesh:
        x = _meta_dtensor(mesh, (M, K), [Shard(0), Replicate()])
        w = _meta_dtensor(mesh, (K, N), [Replicate(), Shard(1)])
        t = hlo_analysis.DispatchTrace()
        with t:
            y = x @ w                         # rows over data, cols over model
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert t.flops == 2 * M * K * N // 8
        xr = _meta_dtensor(mesh, (M, K), [Replicate(), Replicate()])
        wr = _meta_dtensor(mesh, (K, N), [Replicate(), Replicate()])
        t = hlo_analysis.DispatchTrace()
        with t:
            xr @ wr
        assert t.flops == 2 * M * K * N
        # a product over a contraction split on "model": a partial sum,
        # reduced by an all-reduce of the (M/4, N) result
        xk = _meta_dtensor(mesh, (M, K), [Shard(0), Shard(1)])
        wk = _meta_dtensor(mesh, (K, N), [Replicate(), Shard(0)])
        t = hlo_analysis.DispatchTrace()
        with t:
            p = xk @ wk
            assert p.placements[1].is_partial()
            p.redistribute(mesh, [Shard(0), Replicate()])
        assert t.flops == 2 * (M // 4) * (K // 2) * N
        assert t.bytes_by_kind == {"all-reduce": 2.0 * (M // 4) * N * 4}
        assert t.count_by_kind == {"all-reduce": 1}
        t = hlo_analysis.DispatchTrace()
        with t:
            p = xk @ wk
            p.redistribute(mesh, [Shard(0), Shard(1)])
        assert t.bytes_by_kind == {"reduce-scatter":
                                   2.0 * (M // 4) * (N // 2) * 4}
        # the CPU group runs DTensor's all-to-all as an all-gather and a
        # chunk; the trace counts what was asked for
        ran = hlo_analysis.DispatchTrace()
        with ran:
            y.redistribute(mesh, [Shard(1), Shard(0)])
        asked = hlo_analysis.DispatchTrace()
        with asked, hlo_analysis.count_alltoalls(asked):
            y.redistribute(mesh, [Shard(1), Shard(0)])
        assert "all-to-all" not in ran.bytes_by_kind
        assert asked.count_by_kind["all-to-all"] >= 1
        assert asked.bytes_by_kind.get("all-gather", 0) < \
            ran.bytes_by_kind["all-gather"]
    assert not dist.is_initialized()


def test_use_mesh_destroys_its_group_even_on_error():
    with pytest.raises(RuntimeError, match="boom"):
        with use_mesh(make_fake_mesh(2, 2)):
            assert dist.is_initialized()
            raise RuntimeError("boom")
    assert not dist.is_initialized()


def test_multi_pod_mesh_folds_the_data_parallel_axes():
    """The (2, 16, 16) mesh is built with ("pod", "data") as one dim of 32;
    the rules still see three axes, and a dp-sharded leaf's local shape is
    its global / 32."""
    from repro_torch.launch.mesh import make_production_mesh
    plan = make_production_mesh(multi_pod=True)
    with use_mesh(plan) as mesh:
        assert tuple(mesh.shape) == (32, 16)
        assert specs.mesh_shape(mesh) == specs.MeshShape(
            (2, 16, 16), ("pod", "data", "model"))
        spec = specs.batch_spec((64, 128), mesh, seq_axis=1)
        assert spec == (("pod", "data"), None)
        t = specs.place(torch.empty(64, 128, device="meta"), mesh, spec)
        assert t.to_local().shape == (2, 128)
    assert not dist.is_initialized()

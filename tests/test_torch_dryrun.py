"""The port's dry run (``launch/{inputs,hlo_analysis,dryrun}.py``) against
the JAX package's on one device, and the dispatch trace's counts on
hand-built cases with known answers.

On a 1×1 mesh the port traces a step on meta tensors and JAX compiles it
for one CPU device; the trace's FLOPs (the matmul family on local shapes)
equal JAX's ``compute_stats`` of the compiled HLO exactly for prefill and
decode.  A train step's count differs where the two backward passes are
built differently; each difference is pinned exactly:

* hymba-1.5b +17,825,792 (+0.24 %): the port's scan backward
  (``ssm_scan_bwd_plain``, the backward kernel's algorithm) recomputes
  each chunk's starting state (32 more ``bshn,bshp->bhnp`` products of
  524,288 FLOPs) and takes dlog_a's state term as a product (32 of
  32,768) where JAX differentiates its chunked scan;
* xlstm-125m +55,640,064 (+0.80 %, an intended difference past the 0.5 %
  the other archs hold): the same two in the mLSTM's scan (16 of
  4,259,840 and 16 of 266,240); the sLSTM's chunk Function takes the
  recurrent products of a chunk's forward recompute and of dW_h as one
  product each (32 of 16,777,216) where JAX takes 1,296 more per-step
  products (of 1,048,576); and six more products of 134,217,728 FLOPs
  (the (1024-token) projections' size) in the port's backward;
* grok-1-314b -65,536: JAX's gradient of the gate weights through the
  GShard dispatch einsum ``gsk,gske,gskc->gsec`` is a batched product
  (16·64·2 results over 4, 16,384 FLOPs, a layer); the port's autograd
  takes it as a multiply and a sum, which the matmul family does not
  count.

Each difference is pinned by the size of the products that make it
(:func:`test_train_delta_by_product_size`).

Argument bytes equal JAX's ``memory_analysis().argument_size_in_bytes``:
the params plus int32 ids (and labels), as the port's ids are int32.
The configs are ``tests/test_dryrun_integration.py``'s reduced ones
(4 layers, d 128, B 8, S 128) in fp32 with ``remat=False`` and
``logit_chunk=0``.  The meshes of more than one device:
``tests/test_torch_dryrun_mesh.py``.
"""
import collections
import dataclasses
import json
import math

import jax
import pytest
import torch

from repro.configs.base import ShapeConfig
from repro.configs.registry import get_arch as jget_arch
from repro.launch.hlo_analysis import compute_stats as jcompute_stats
from repro.launch.inputs import input_specs as jinput_specs
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_host_mesh

ARCHS = ["qwen2-0.5b", "hymba-1.5b", "xlstm-125m", "grok-1-314b"]
KINDS = ["train", "prefill", "decode"]
SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
          "decode": "decode_32k"}
CUT = {"global_batch": 8, "seq_len": 128}
# port - JAX FLOPs of a train step (see the module docstring)
TRAIN_DELTA = {"qwen2-0.5b": 0, "hymba-1.5b": 17_825_792,
               "xlstm-125m": 55_640_064, "grok-1-314b": -65_536}
# port - JAX count of a train step's products, by the FLOPs of a product
TRAIN_DELTA_BY_SIZE = {
    "qwen2-0.5b": {},
    "hymba-1.5b": {32_768: 32, 524_288: 32},
    "xlstm-125m": {266_240: 16, 1_048_576: -1_296, 4_259_840: 16,
                   16_777_216: 32, 134_217_728: 6},
    "grok-1-314b": {16_384: -4}}
JAX_KEYS = {"cell", "arch", "shape", "multi_pod", "mesh", "status", "step",
            "lower_s", "compile_s", "n_devices", "memory",
            "xla_flops_per_device", "xla_bytes_per_device",
            "flops_per_device", "bytes_per_device", "collectives", "model"}


FIELDS = dict(n_layers=4, d_model=128, d_ff=256, n_heads=4, n_kv_heads=2,
              head_dim=32, vocab_size=512, dtype="float32", remat=False,
              logit_chunk=0)


def _reduced(cfg):
    cfg = dataclasses.replace(cfg.reduced(), **FIELDS)
    return dataclasses.replace(cfg, d_ff=0) if cfg.xlstm is not None \
        else cfg


def overrides(arch):
    """The reduced config's fields, for ``run_cell(overrides=)``."""
    cfg = _reduced(get_arch(arch))
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name"}


def _jax_cell(arch, kind):
    shape = ShapeConfig("c", CUT["seq_len"], CUT["global_batch"], kind)
    spec = jinput_specs(_reduced(jget_arch(arch)), shape,
                        jax.make_mesh((1, 1), ("data", "model")))
    compiled = jax.jit(spec.step_fn, donate_argnums=spec.donate_argnums) \
        .lower(*spec.args).compile()
    return (jcompute_stats(compiled.as_text())["flops_per_device"],
            int(compiled.memory_analysis().argument_size_in_bytes))


def _port_cell(arch, kind, tmp_path, **kw):
    rec = dryrun.run_cell(arch, SHAPES[kind], mesh=make_host_mesh(
        1, devices=["cpu"]), out_dir=str(tmp_path), verbose=False,
        overrides=overrides(arch), shape_overrides=CUT, **kw)
    assert rec["status"] == "ok", rec.get("traceback")
    return rec


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_flops_and_argument_bytes_match_jax(arch, kind,
                                                       tmp_path):
    rec = _port_cell(arch, kind, tmp_path)
    jflops, jargs = _jax_cell(arch, kind)
    flops = rec["flops_per_device"]
    assert rec["memory"]["argument_size_in_bytes"] == jargs
    assert flops - jflops == (TRAIN_DELTA[arch] if kind == "train" else 0)


def _jax_products(arch):
    """JAX's train-step ``dot``s by FLOPs a product, each counted as many
    times as its loops run it (the JAX analyser's own multipliers)."""
    from repro.launch import hlo_analysis as jh
    shape = ShapeConfig("c", CUT["seq_len"], CUT["global_batch"], "train")
    spec = jinput_specs(_reduced(jget_arch(arch)), shape,
                        jax.make_mesh((1, 1), ("data", "model")))
    mod = jh.Module(jax.jit(spec.step_fn, donate_argnums=spec.donate_argnums)
                    .lower(*spec.args).compile().as_text())
    out = collections.Counter()
    for comp, instrs in mod.comps.items():
        for _, rtype, opcode, rest in instrs:
            if opcode != "dot":
                continue
            n = math.prod(jh._type_dims(rtype))
            lhs = jh._OPERAND_RE.findall(rest.split("),")[0])[0]
            lhs_dims = jh._type_dims(mod.types[lhs])
            for i in jh._DOT_LHS_C.search(rest).group(1).split(","):
                n *= lhs_dims[int(i)]
            out[2 * n] += mod.mult.get(comp, 1)
    return out


class _Products(hlo_analysis.DispatchTrace):
    """The trace, with its products counted by FLOPs a product."""

    def __init__(self):
        super().__init__("meta")
        self.by_size = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.flops != before:
            self.by_size[self.flops - before] += 1
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_delta_by_product_size(arch):
    """The train steps' FLOP differences (the module docstring), product
    size by product size."""
    from repro_torch.launch.inputs import input_specs
    from repro_torch.sharding import specs
    from repro_torch.configs.base import shape_by_name
    cfg = dataclasses.replace(get_arch(arch), **overrides(arch))
    shape = dataclasses.replace(shape_by_name("train_4k"), **CUT)
    plan = make_host_mesh(1, devices=["cpu"])
    specs.enable_activation_policy(plan)
    try:
        spec = input_specs(cfg, shape, plan)
        with _Products() as port:
            spec.step_fn(*spec.args)
    finally:
        specs.enable_activation_policy(None)
    theirs = _jax_products(arch)
    delta = {k: port.by_size[k] - theirs[k]
             for k in set(port.by_size) | set(theirs)
             if port.by_size[k] != theirs[k]}
    assert delta == TRAIN_DELTA_BY_SIZE[arch]
    assert sum(k * n for k, n in delta.items()) == TRAIN_DELTA[arch]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b"])
def test_abstract_trace_equals_a_real_cpu_run(arch, kind, tmp_path):
    rec = _port_cell(arch, kind, tmp_path, execute=True, device="cpu")
    ex = rec["execute"]
    assert ex["flops"] == rec["flops_per_device"] > 0
    assert ex["argument_size_in_bytes"] == \
        rec["memory"]["argument_size_in_bytes"]
    assert ex["device"] == "cpu" and ex["max_memory_allocated"] is None
    assert not any(ex["launches"].values())


def test_execute_refuses_a_mesh_of_several_devices(tmp_path):
    from repro_torch.launch.mesh import make_fake_mesh
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k",
                          mesh=make_fake_mesh(2, 1), execute=True,
                          device="cpu", out_dir=str(tmp_path),
                          verbose=False)
    assert rec["status"] == "error" and "one-device" in rec["error"]
    assert not torch.distributed.is_initialized()


def test_skipped_cell_is_written(tmp_path):
    rec = dryrun.run_cell("qwen2-0.5b", "long_500k", out_dir=str(tmp_path),
                          verbose=False)
    assert rec["status"] == "skipped"
    saved = json.loads((tmp_path / "qwen2-0.5b__long_500k__pod.json")
                       .read_text())
    assert saved == rec


def test_cli_writes_jax_record_keys(tmp_path, capsys):
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh",
                 "1,1", "--out-dir", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen2-0.5b__decode_32k__1x1.json")
                     .read_text())
    assert rec["status"] == "ok"
    want = (JAX_KEYS - {"lower_s", "compile_s"}) | {"trace_s"}
    assert set(rec) == want
    assert set(rec["memory"]) >= {"argument_size_in_bytes",
                                   "output_size_in_bytes",
                                   "temp_size_in_bytes",
                                   "alias_size_in_bytes"}
    assert rec["mesh"] == {"data": 1, "model": 1}
    assert "1 ok, 0 skipped, 0 errors" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the dispatch trace on hand-built cases
# ---------------------------------------------------------------------------

def _trace(fn, device_type="meta"):
    with hlo_analysis.DispatchTrace(device_type) as t:
        out = fn()
    return t, out


def test_matmul_family_flops():
    m = lambda *s: torch.empty(*s, device="meta")
    t, _ = _trace(lambda: (m(8, 16) @ m(16, 32),
                           torch.bmm(m(3, 8, 16), m(3, 16, 4)),
                           torch.addmm(m(32), m(8, 16), m(16, 32)),
                           torch.einsum("bqd,bkd->bqk", m(2, 5, 7),
                                        m(2, 6, 7))))
    assert t.flops == (2 * 8 * 16 * 32 + 2 * 3 * 8 * 16 * 4
                       + 2 * 8 * 16 * 32 + 2 * 2 * 5 * 6 * 7)
    assert hlo_analysis.compute_stats(t)["flops_per_device"] == t.flops


def test_elementwise_ops_count_no_flops_and_views_no_bytes():
    x = torch.empty(4, 8, device="meta")
    t, _ = _trace(lambda: (x.view(8, 4), x.t(), x[1:]))
    assert t.flops == 0 and t.bytes == 0 and t.peak_bytes == 0
    t, _ = _trace(lambda: torch.exp(x))
    assert t.flops == 0
    assert t.bytes == 2 * 4 * 8 * 4          # one read, one write


def test_peak_follows_live_intermediates():
    x = torch.empty(1024, device="meta")     # 4 KB a tensor

    def run():
        a = x * 2                             # +4 KB
        b = a * 2                             # +4 KB: peak 8 KB
        del a                                 # -4 KB
        c = b * 2                             # +4 KB: 8 KB again
        return c

    t, out = _trace(run)
    assert t.peak_bytes == 2 * 4096
    assert t.live_bytes == 4096              # only the result is alive
    mem = hlo_analysis.memory_stats(t, (x, 3), out, donate_argnums=(0,))
    assert mem == {"argument_size_in_bytes": 4096 + 4,
                   "output_size_in_bytes": 4096,
                   "alias_size_in_bytes": 4096,
                   "temp_size_in_bytes": 2 * 4096}


def test_only_the_programs_device_is_counted():
    cpu = torch.ones(4, 4)
    t, _ = _trace(lambda: cpu @ cpu, "meta")
    assert t.flops == 0 and not t.ops
    t, _ = _trace(lambda: cpu @ cpu, "cpu")
    assert t.flops == 2 * 4 * 4 * 4


def test_a_kernel_launch_is_counted_as_its_plain_version():
    """The shadow run that stands for a kernel launch on the card counts
    what the plain version counts on the same shapes."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.empty(2, 64, 4, 32, device="meta")
    k = torch.empty(2, 64, 2, 32, device="meta")
    plain, _ = _trace(lambda: fa.flash_attention_fwd_plain(q, k, k))
    assert plain.flops > 0
    with hlo_analysis.DispatchTrace("cuda") as shadow:
        assert ops.shadow_plain
        ops._shadow(fa.flash_attention_fwd_plain, q, k, k)
    assert not ops.shadow_plain
    assert shadow.flops == plain.flops


def test_abstract_tensors_take_the_plain_version_and_real_ones_do_not():
    """A meta tensor or a FakeTensor (on any device) takes the plain
    version; a real tensor is routed by its device alone: a CPU tensor
    plain, and never a real CUDA tensor (there the kernel or an error)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    real = torch.ones(4, 8)
    assert not ops._abstract(real)
    assert ops._plain(real, "rmsnorm")
    meta = torch.empty(4, 8, device="meta")
    assert ops._abstract(meta) and ops._plain(meta, "rmsnorm")
    with FakeTensorMode():
        fake = torch.empty(4, 8, device="cuda")
        g = torch.ones(8, device="cuda")
        assert fake.is_cuda and ops._abstract(fake)
        ops.reset_rmsnorm_counts()
        y = ops.rmsnorm(fake, g)
        assert y.shape == (4, 8) and y.is_cuda
    assert ops.rmsnorm_launches == 0 and ops.rmsnorm_dispatches == 1

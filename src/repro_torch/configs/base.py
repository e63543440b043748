"""Configuration dataclasses for models, shapes, meshes and FL runs.

The port's copy of ``repro/configs/base.py`` (which imports no JAX), kept
field for field so a config means the same in both packages.  In the port,
``attention_impl="pallas"`` selects the hand-written Hopper flash-attention
kernel; ``remat`` and ``scan_layers`` have no effect (the stack is a Python
loop over repetitions).

Every assigned architecture is expressed as a :class:`ModelConfig`; the four
assigned input shapes are :class:`ShapeConfig` instances.  Full configs are
exercised only through the dry-run (``launch/dryrun.py``); smoke tests call
``reduced()`` to obtain a tiny same-family config that runs on CPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Tokens are dispatched in groups of this many; the dispatch/combine
    # einsums are O(group_size * n_experts * capacity) per group.
    group_size: int = 4096
    # "gshard_einsum" (SPMD-safe one-hot dispatch) or "gather" (index based,
    # cheaper FLOPs — used by the perf hillclimb).
    dispatch_impl: str = "gshard_einsum"
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    n_heads: int = 8            # SSD heads (mamba2-style scalar-decay heads)
    chunk_size: int = 256       # chunk length for the SSD chunked scan


@dataclass(frozen=True)
class XLSTMConfig:
    # Alternating block pattern, e.g. ("mlstm", "slstm") repeated.
    pattern: Tuple[str, ...] = ("mlstm", "slstm")
    mlstm_expand: int = 2
    slstm_n_heads: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0     # 0 -> full attention
    attention_impl: str = "chunked"   # dense | chunked | pallas
    attn_chunk: int = 512       # kv-chunk for the online-softmax reference
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # "tokens" -> int ids; "embeddings" -> precomputed frontend embeddings
    # (audio frames / vision patches are stubs per the assignment).
    input_kind: str = "tokens"
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    logit_chunk: int = 0        # 0 -> unchunked loss; >0 -> chunked xent
    train_microbatches: int = 1  # gradient accumulation for train shapes

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_recurrent(self) -> bool:
        """True when decode state is O(1) in context length (SSM/xLSTM/hybrid
        with sliding window) — required for the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        n = V * d  # embedding
        if not self.tie_embeddings:
            n += d * V
        per_layer = 0
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        if self.family == "ssm":  # xLSTM
            xc = self.xlstm or XLSTMConfig()
            di = xc.mlstm_expand * d
            # mLSTM: up/gate proj (2*d*di), q/k/v (3*di*di), out (di*d), gates
            mlstm = 2 * d * di + 3 * di * di + di * d + 3 * di
            # sLSTM: 4 gates input + recurrent per head + out
            slstm = 4 * d * d + 4 * d * d + d * d
            n += (L // 2) * (mlstm + slstm) + (L % 2) * mlstm
            n += 2 * L * d  # norms
            return n
        # attention part
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        if self.qkv_bias:
            attn += H * hd + 2 * KV * hd
        per_layer += attn
        if self.family == "hybrid":
            sc = self.ssm or SSMConfig()
            di = sc.expand * d
            per_layer += d * 2 * di + di * d + di * (2 * sc.d_state) + di
        if self.moe is not None:
            per_layer += d * self.moe.n_experts            # router
            per_layer += self.moe.n_experts * 3 * d * f    # swiglu experts
        elif f > 0:
            per_layer += 3 * d * f
        per_layer += 2 * d  # norms
        n += L * per_layer + d  # final norm
        return n

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        dense_experts = self.n_layers * m.n_experts * 3 * self.d_model * self.d_ff
        active_experts = self.n_layers * m.top_k * 3 * self.d_model * self.d_ff
        return self.n_params() - dense_experts + active_experts

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            head_dim=16,
            sliding_window=32 if self.sliding_window else 0,
            attn_chunk=32,
            dtype="float32",
            remat=False,
            logit_chunk=0,
            train_microbatches=1,
        )
        if self.moe is not None:
            # capacity_factor=4 -> drop-free routing, so smoke tests can
            # compare prefill/decode against the full forward exactly.
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=self.moe.top_k, group_size=64,
                capacity_factor=4.0)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=8, n_heads=2, chunk_size=16)
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(self.xlstm, chunk_size=16,
                                              slstm_n_heads=2)
        return dataclasses.replace(self, **kw)


def hd_safe(d: int, h: int) -> int:
    return d // h


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode | long_decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "long_decode")
ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@dataclass(frozen=True)
class FLConfig:
    """Parrot federated-learning round configuration."""
    n_clients: int = 1000              # M
    clients_per_round: int = 100       # M_p
    n_executors: int = 8               # K
    local_epochs: int = 1              # E
    local_batch_size: int = 20
    client_lr: float = 0.05
    server_lr: float = 1.0
    algorithm: str = "fedavg"
    scheduler: str = "parrot"          # parrot | uniform | none
    time_window: int = 0               # tau; 0 -> all history
    warmup_rounds: int = 1             # R_w: uniform scheduling warmup
    seed: int = 0
    partition: str = "natural"         # natural | dirichlet | quantity_skew
    partition_arg: float = 0.1
    compression: str = "none"          # none | topk | int8
    compression_arg: float = 0.01

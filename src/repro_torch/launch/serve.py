"""Serving driver: batched prefill + greedy decode against a registry arch.

Port of ``repro/launch/serve.py``.  Runs on the card unless asked for the
CPU; on the CPU use a reduced config (the default), on the card the full
one:

  python -m repro_torch.launch.serve --device cpu --arch qwen2-0.5b
  python -m repro_torch.launch.serve --device cpu --arch hymba-1.5b
  python -m repro_torch.launch.serve --full-config --batch 4 \\
      --prompt-len 1024 --gen 32 [--arch hymba-1.5b | --arch xlstm-125m]

Every registry arch is served, the MoE ones (grok-1-314b,
llama4-scout-17b-a16e) included; their full configs do not fit one card
whole, so ``chip_smoke.py`` serves them at full width with fewer layers.
``--attention-impl`` sets ``ModelConfig.attention_impl`` for the prefill:
``pallas`` (the default here) runs the hand-written Hopper flash-attention
kernel, ``chunked`` and ``dense`` the plain PyTorch paths.  The decode step
attends over the ring-buffer cache in plain PyTorch, as in the JAX package.
On the card every norm runs the RMSNorm kernel, and the recurrent mixers'
prefill scan the SSD-scan kernel; their decode steps carry the state in
plain PyTorch.

Intended differences from the JAX driver: the prompt comes from
``numpy.random.default_rng(seed)`` (not ``jax.random``), the params from a
``torch.Generator`` seeded with ``seed`` on the target device, and
``--attention-impl`` defaults to ``pallas``.  :func:`generate` is the loop
the CLI runs, factored out for the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import as_tensor, resolve_device, synchronize


def make_prompt(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """(B, P) int32 token ids, or (B, P, d) fp32 embeddings for an
    embedding-input arch, from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeddings":
        return rng.standard_normal((batch, prompt_len, cfg.d_model),
                                   dtype=np.float32)
    return rng.integers(0, cfg.vocab_size, size=(batch, prompt_len),
                        dtype=np.int32)


def generate(params, prompt, cfg, gen: int,
             device: Optional[Any] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Prefill ``prompt`` (B, P) ids or (B, P, d) embeddings, then decode
    greedily to ``gen`` tokens in all (the first from the prefill logits).

    ``params`` must already lie on ``device``.  Argmax takes the lowest
    index on ties, as ``jnp.argmax`` does.  Returns ``(tokens (B, gen)
    int64, prefill logits (B, 1, V), timings)``; the timings are host
    seconds around work that ends in a device synchronise
    (``prefill_s``, ``decode_s``), beside the launches of each LM kernel
    that each part made (``prefill_<name>_launches`` and
    ``decode_<name>_launches`` for each name of ``ops.launch_counts()``:
    ``flash``, ``ssm_scan``, ``rmsnorm`` and the backward kernels
    ``flash_bwd``, ``ssm_scan_bwd`` and ``rmsnorm_bwd``, which serving never
    launches)."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    dev = resolve_device(device)
    prompt = as_tensor(prompt, dev)
    B, P = prompt.shape[0], prompt.shape[1]
    prefill = lm.make_prefill_step(cfg, B, P, cache_len=P + gen)
    decode = lm.make_decode_step(cfg)
    with torch.no_grad():
        synchronize(dev)
        n0 = ops.launch_counts()
        t0 = time.perf_counter()
        logits, caches = prefill(params, prompt)
        synchronize(dev)
        t_prefill = time.perf_counter() - t0
        n1 = ops.launch_counts()

        toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out_tokens = [toks]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            step_in = toks
            if cfg.input_kind == "embeddings":
                # stub frontend: embed generated ids through the token table
                step_in = params["embed"]["w"][toks]
            step_logits, caches = decode(params, step_in, caches, P + i)
            toks = torch.argmax(step_logits[:, -1], dim=-1)[:, None]
            out_tokens.append(toks)
        synchronize(dev)
        t_decode = time.perf_counter() - t0
    n2 = ops.launch_counts()
    timings = {"prefill_s": t_prefill, "decode_s": t_decode}
    for name in n0:
        timings[f"prefill_{name}_launches"] = n1[name] - n0[name]
        timings[f"decode_{name}_launches"] = n2[name] - n1[name]
    return torch.cat(out_tokens, dim=1), logits, timings


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device to serve on (cpu on request)")
    ap.add_argument("--attention-impl", default="pallas",
                    choices=("pallas", "chunked", "dense"),
                    help="prefill attention: pallas = the Hopper kernel")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import lm

    cfg = get_arch(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    dev = resolve_device(args.device)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                            cfg)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompt = make_prompt(cfg, B, P, args.seed)
    gen, _, t = generate(params, prompt, cfg, G, dev)
    t_prefill, t_decode = t["prefill_s"], t["decode_s"]

    print(f"[serve] arch={cfg.name} B={B} prompt={P} gen={G} device={dev} "
          f"attention={cfg.attention_impl}")
    print(f"[serve] prefill {t_prefill*1e3:.1f} ms "
          f"({B*P/t_prefill:.0f} tok/s); decode {t_decode*1e3:.1f} ms "
          f"({B*(G-1)/max(t_decode,1e-9):.0f} tok/s)")
    print(f"[serve] sample tokens: {gen[0, :16].tolist()}")


if __name__ == "__main__":
    main()

"""Per-leaf gradient differences at ``chip_smoke.py`` 13(e)'s cut, on the CPU.

qwen2-0.5b's widths cut to 2 layers, fp32, params from seed 0 and one
(2, 32) token batch from seed 5, as 13(e) makes them.  For each leaf of
``loss_and_aux``'s gradient it prints ``|g_a - g_b| / |g_b|`` (2-norms):

* the ``pallas`` route (on the CPU, the plain flash version) against the
  ``dense`` route: how far two fp32 orders of the same sums fall apart,
  the scale 13(e)'s bound on card kernels against CPU plain sits above;
* the ``pallas`` route with the flash backward's dq, dk or dv zeroed
  against the intact one: what a wrong backward moves.

    PYTHONPATH=src python scripts/cut_grad_routes.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import repro_torch.core as T
from repro_torch.configs.registry import get_arch
from repro_torch.core import tree
from repro_torch.kernels import ops
from repro_torch.models import lm


def grads(cfg, params, batch):
    return T.value_and_grad(lambda p, b: lm.loss_and_aux(p, b, cfg))(
        params, batch)[1]


def rel(got, want):
    return [float((a - b).norm()) / float(b.norm())
            for a, b in zip(tree.leaves(got), tree.leaves(want))]


def main() -> None:
    cut = dataclasses.replace(get_arch("qwen2-0.5b"), n_layers=2,
                              dtype="float32", attention_impl="pallas")
    params = lm.init_params(torch.Generator().manual_seed(0), cut)
    rng = np.random.default_rng(5)
    batch = {k: torch.as_tensor(rng.integers(0, cut.vocab_size, size=(2, 32),
                                             dtype=np.int32))
             for k in ("inputs", "labels")}
    ref = grads(cut, params, batch)
    dense = grads(dataclasses.replace(cut, attention_impl="dense"), params,
                  batch)
    r = rel(ref, dense)
    print(f"pallas vs dense: per leaf {min(r):.3g} to {max(r):.3g}")
    real = ops._flash_bwd
    for i, name in enumerate(("dq", "dk", "dv")):
        def zeroed(*args, i=i):
            out = list(real(*args))
            out[i] = torch.zeros_like(out[i])
            return tuple(out)
        ops._flash_bwd = zeroed
        try:
            r = rel(grads(cut, params, batch), ref)
        finally:
            ops._flash_bwd = real
        print(f"{name} zeroed vs intact: largest leaf {max(r):.3g}")


if __name__ == "__main__":
    main()

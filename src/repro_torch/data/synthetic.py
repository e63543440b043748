"""Synthetic federated datasets; port of ``make_classification_clients``
from ``repro/data/synthetic.py``.

Gaussian-blob classification (FEMNIST-like): each client draws from a
Dir(α) or natural mixture of class blobs.  The data rng is numpy
``default_rng``, so both packages produce byte-identical clients from one
seed; batches stay numpy and become tensors on the executor's device at
training time.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.algorithms import ClientData
from repro_torch.data.partition import partition_sizes


def _blob_means(n_classes: int, dim: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_classes, dim)) * 2.0


def make_classification_clients(
        n_clients: int, dim: int = 32, n_classes: int = 10,
        partition: str = "natural", partition_arg: float = 0.1,
        mean_samples: int = 64, batch_size: int = 20, seed: int = 0
) -> Dict[int, ClientData]:
    """Returns client_id -> ClientData of (x, y) numpy batches."""
    rng = np.random.default_rng(seed)
    means = _blob_means(n_classes, dim, seed)
    sizes = partition_sizes(partition, n_clients, partition_arg,
                            mean_samples, seed)
    out: Dict[int, ClientData] = {}
    for c in range(n_clients):
        n = int(sizes[c])
        if partition == "dirichlet":
            mix = rng.dirichlet(np.full(n_classes, partition_arg))
        else:
            mix = rng.dirichlet(np.full(n_classes, 1.0))
        ys = rng.choice(n_classes, size=n, p=mix)
        xs = means[ys] + rng.normal(size=(n, dim)).astype(np.float32)
        batches = []
        for i in range(0, n, batch_size):
            xb = xs[i:i + batch_size].astype(np.float32)
            yb = ys[i:i + batch_size].astype(np.int32)
            if len(xb) < batch_size:   # pad to a fixed batch shape
                pad = batch_size - len(xb)
                xb = np.concatenate([xb, xb[:pad] if len(xb) >= pad
                                     else np.repeat(xb, pad, 0)[:pad]])
                yb = np.concatenate([yb, yb[:pad] if len(yb) >= pad
                                     else np.repeat(yb, pad, 0)[:pad]])
            batches.append({"x": xb, "y": yb})
        out[c] = ClientData(batches=batches, n_samples=n)
    return out

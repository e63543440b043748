"""Synthetic federated datasets; port of ``make_classification_clients``,
``make_classification_population`` and ``make_lm_clients`` from
``repro/data/synthetic.py``.

Gaussian-blob classification (FEMNIST-like): each client draws from a
Dir(α) or natural mixture of class blobs.  The data rng is numpy
``default_rng``, so both packages produce byte-identical clients from one
seed; batches stay numpy and become tensors on the executor's device at
training time.  ``make_classification_population`` is the streamed twin:
an O(M)-words registry plus a per-client factory with per-client derived
rng streams, wrapped in a ``LazyPopulation`` — million-client populations
at O(cohort) resident data (DESIGN.md §11).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.algorithms import ClientData
from repro_torch.core.population import LazyPopulation
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
    alpha = partition_arg if partition == "dirichlet" else 1.0
    for c in range(n_clients):
        mix = rng.dirichlet(np.full(n_classes, alpha))
        out[c] = _build_classification_client(int(sizes[c]), mix, means,
                                              batch_size, rng)
    return out


def _build_classification_client(n: int, mix: np.ndarray, means: np.ndarray,
                                 batch_size: int, rng: np.random.Generator
                                 ) -> ClientData:
    """One client's gaussian-blob batches, drawn from ``rng`` after its
    class mixture (shared by the eager generator and the streamed
    factory)."""
    n_classes, dim = means.shape
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
    return ClientData(batches=batches, n_samples=n)


def make_classification_population(
        n_clients: int, dim: int = 32, n_classes: int = 10,
        partition: str = "natural", partition_arg: float = 0.1,
        mean_samples: int = 64, batch_size: int = 20, seed: int = 0,
        fetch_cache_bytes: int = 256 << 20) -> LazyPopulation:
    """Streamed classification population: only the registry (per-client
    sample counts — one vectorized partition draw) is materialised up
    front; each client's batches synthesize on demand from a rng stream
    derived from ``(seed, client_id)``, so any access order (or an eager
    ``materialize()``) yields identical data.  Dataset memory is bounded by
    ``fetch_cache_bytes``, independent of ``n_clients``."""
    means = _blob_means(n_classes, dim, seed)
    sizes = partition_sizes(partition, n_clients, partition_arg,
                            mean_samples, seed)
    alpha = partition_arg if partition == "dirichlet" else 1.0

    def factory(c: int) -> ClientData:
        rng = np.random.default_rng((seed, 0x5EED, c))
        mix = rng.dirichlet(np.full(n_classes, alpha))
        return _build_classification_client(int(sizes[c]), mix, means,
                                            batch_size, rng)

    return LazyPopulation(sizes, factory,
                          fetch_cache_bytes=fetch_cache_bytes,
                          signature=("blobs", dim, n_classes, batch_size),
                          meta={"seed": seed, "partition": partition})


def make_lm_clients(
        n_clients: int, vocab: int = 256, seq_len: int = 64,
        partition: str = "natural", partition_arg: float = 5.0,
        mean_samples: int = 8, batch_size: int = 4, seed: int = 0
) -> Dict[int, ClientData]:
    """Per-client token streams (a sample = one sequence of ``seq_len + 1``
    tokens): ``{"inputs", "labels"}`` int32 batches, byte for byte the JAX
    package's."""
    rng = np.random.default_rng(seed)
    sizes = partition_sizes(partition, n_clients, partition_arg,
                            mean_samples, seed)
    out: Dict[int, ClientData] = {}
    for c in range(n_clients):
        n = int(sizes[c])
        # cheap per-client distribution: biased unigram sampling
        bias = rng.dirichlet(np.full(vocab, 0.5))
        toks = rng.choice(vocab, size=(n, seq_len + 1), p=bias)
        batches = []
        for i in range(0, n, batch_size):
            tb = toks[i:i + batch_size]
            if len(tb) < batch_size:
                tb = np.concatenate(
                    [tb, np.repeat(tb, batch_size, 0)[:batch_size - len(tb)]])
            batches.append({"inputs": tb[:, :-1].astype(np.int32),
                            "labels": tb[:, 1:].astype(np.int32)})
        out[c] = ClientData(batches=batches, n_samples=n)
    return out

"""Federated dataset partitioners (paper §5.1 / Appendix Table 4); port of
``repro/data/partition.py``, unchanged: it is numpy only, so both packages
draw byte-identical client sizes from one seed.

  natural        — LEAF-style per-client sizes (lognormal, like FEMNIST's
                   writer-based split: many small clients, a long tail)
  dirichlet(α)   — label-distribution skew (Hsu et al.): client class mix
                   drawn from Dir(α); sizes roughly balanced
  quantity_skew(σ) — sizes drawn lognormal(σ): pure quantity heterogeneity,
                   the axis the paper notes is what stresses scheduling

Only quantity skew affects system performance (paper footnote 1); dirichlet
matters for the algorithm-convergence experiments.
"""
from __future__ import annotations

from typing import List

import numpy as np


def natural_sizes(n_clients: int, mean_samples: int = 200,
                  seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sizes = rng.lognormal(mean=np.log(mean_samples), sigma=0.8,
                          size=n_clients)
    return np.maximum(sizes.astype(int), 4)


def quantity_skew_sizes(n_clients: int, sigma: float = 5.0,
                        mean_samples: int = 200, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # the paper's "Quantity Skew(5.0)": heavier tail than natural
    sigma = np.log(max(sigma, 1.2))
    sizes = rng.lognormal(mean=np.log(mean_samples), sigma=sigma,
                          size=n_clients)
    return np.maximum(sizes.astype(int), 4)


def dirichlet_label_partition(labels: np.ndarray, n_clients: int,
                              alpha: float = 0.1, seed: int = 0
                              ) -> List[np.ndarray]:
    """Partition example indices by Dir(α)-skewed label distribution."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for idx in by_class:
        rng.shuffle(idx)
    client_indices: List[List[int]] = [[] for _ in range(n_clients)]
    for c, idx in enumerate(by_class):
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client, part in enumerate(np.split(idx, cuts)):
            client_indices[client].extend(part.tolist())
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in client_indices]


def partition_sizes(method: str, n_clients: int, arg: float = 0.1,
                    mean_samples: int = 200, seed: int = 0) -> np.ndarray:
    if method == "natural":
        return natural_sizes(n_clients, mean_samples, seed)
    if method == "quantity_skew":
        return quantity_skew_sizes(n_clients, arg, mean_samples, seed)
    if method == "dirichlet":
        # dirichlet skews labels, sizes stay near-uniform
        rng = np.random.default_rng(seed)
        sizes = rng.poisson(mean_samples, size=n_clients)
        return np.maximum(sizes, 4)
    raise ValueError(method)

"""Client populations — the axis behind ``data_by_client``.  Port of
``repro/core/population.py`` (numpy only, so cohorts are rng-identical to
the JAX package's, id for id); the streamed ``LazyPopulation`` comes with a
later slice (ROADMAP item 14).

  ``ClientPopulation``   read-only ``Mapping[int, ClientData]`` plus a
                         compact registry view (sorted int64 id array and
                         per-client sample counts) that never requires
                         materialising batches.
  ``EagerPopulation``    wraps the classic dict; the sorted-id registry is
                         built once and reused across rounds (rebuilt only
                         when membership changes), fixing the per-round
                         O(M log M) re-sort for eager populations too.

Selection (``ClientPopulation.sample``) is O(cohort): it draws positional
indices with ``rng.choice(pool_len, size, replace=False)`` — numpy's
Generator consumes the bit stream identically for ``choice(pool, size)``
and ``choice(len(pool), size)`` — and rank-adjusts the drawn indices past
excluded positions instead of materialising ``sorted(ids) - exclude``.
The resulting cohorts are rng-identical to the legacy
``rng.choice(sorted_pool, ...)`` path (pinned by tests/test_population.py),
so every engine bit-exactness pin holds unchanged.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.algorithms import ClientData

__all__ = ["ClientPopulation", "EagerPopulation", "as_population"]


class ClientPopulation(Mapping):
    """Read-only ``Mapping[int, ClientData]`` with a registry fast path.

    Subclasses provide ``ids_array()`` (sorted int64 ids — the compact
    registry), ``n_samples(c)`` (the scheduling signal, no batch
    materialisation), and ``__getitem__`` (batches, possibly synthesized on
    demand).  ``keys/values/items/get`` come from the Mapping mixins, so a
    population drops in anywhere a ``data_by_client`` dict was read.
    """

    def ids_array(self) -> np.ndarray:
        raise NotImplementedError

    def n_samples(self, client: int) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        return int(self.ids_array().size)

    def __iter__(self) -> Iterator[int]:
        return (int(c) for c in self.ids_array())

    def __contains__(self, client: object) -> bool:
        try:
            c = int(client)  # type: ignore[arg-type]
        except (TypeError, ValueError):
            return False
        ids = self.ids_array()
        i = int(np.searchsorted(ids, c))
        return i < ids.size and int(ids[i]) == c

    # ------------------------------------------------------------------
    def sample(self, rng: np.random.Generator, k: int,
               exclude: Optional[Sequence[int]] = None) -> List[int]:
        """Draw ``min(k, pool)`` distinct client ids, rng-identical to the
        legacy ``rng.choice(sorted(ids) - exclude, size, replace=False)``.

        The pool is never materialised: positional indices are drawn
        against the virtual pool length and rank-adjusted past the excluded
        ids' positions in the sorted registry — O(k log k + |exclude| log M)
        per call.  (Availability and fault filters come with ROADMAP item
        13.)"""
        ids = self.ids_array()
        P = np.empty(0, dtype=np.int64)
        if exclude:
            ex = np.unique(np.asarray([int(c) for c in exclude],
                                      dtype=np.int64))
            pos = np.searchsorted(ids, ex)
            ok = pos < ids.size
            ok[ok] = ids[pos[ok]] == ex[ok]
            P = pos[ok].astype(np.int64)
        pool_len = int(ids.size - P.size)
        size = min(int(k), pool_len)
        if size <= 0:
            return []
        idx = np.asarray(rng.choice(pool_len, size=size, replace=False),
                         dtype=np.int64)
        if P.size:
            # j-th element of (ids minus excluded) sits at original position
            # j + |{p in P : p - rank(p) <= j}| — a searchsorted over the
            # rank-shifted excluded positions recovers it without building
            # the pool.
            idx = idx + np.searchsorted(P - np.arange(P.size, dtype=np.int64),
                                        idx, side="right")
        return [int(c) for c in ids[idx]]


class EagerPopulation(ClientPopulation):
    """The classic ``{id: ClientData}`` dict, with the sorted-id registry
    cached across rounds (the legacy selection re-sorted the population
    every call).  The cache revalidates only when the dict's size changes —
    the only membership edits the engines ever make."""

    def __init__(self, data_by_client: Dict[int, ClientData]):
        self._data = data_by_client
        self._ids: Optional[np.ndarray] = None
        self._ids_len = -1

    def ids_array(self) -> np.ndarray:
        if self._ids is None or self._ids_len != len(self._data):
            self._ids = np.sort(np.fromiter(self._data.keys(), dtype=np.int64,
                                            count=len(self._data)))
            self._ids_len = len(self._data)
        return self._ids

    def n_samples(self, client: int) -> int:
        return self._data[int(client)].n_samples

    def __getitem__(self, client: int) -> ClientData:
        return self._data[int(client)]

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, client: object) -> bool:
        try:
            return int(client) in self._data  # type: ignore[arg-type]
        except (TypeError, ValueError):
            return False


def as_population(data: Any) -> ClientPopulation:
    """Adopt a ``ClientPopulation`` as-is; wrap a plain dict eagerly."""
    if isinstance(data, ClientPopulation):
        return data
    return EagerPopulation(data)

"""Client populations — the streamed axis behind ``data_by_client``.  Port
of ``repro/core/population.py`` (numpy only, so cohorts are rng-identical
to the JAX package's, id for id).

The paper stops at ~1000 clients; the north star is millions.  At that
scale the server cannot hold every client's batches (O(M) dataset RSS) or
re-sort the full id set per selection (O(M log M) per round), so the
population is a *lazy* axis:

  ``ClientPopulation``   read-only ``Mapping[int, ClientData]`` plus a
                         compact registry view (sorted int64 id array and
                         per-client sample counts) that never requires
                         materialising batches.
  ``EagerPopulation``    wraps the classic dict; the sorted-id registry is
                         built once and reused across rounds (rebuilt only
                         when membership changes), fixing the per-round
                         O(M log M) re-sort for eager populations too.
  ``LazyPopulation``     registry arrays + an ``id -> ClientData`` factory
                         behind a bounded LRU byte cache, so dataset memory
                         is O(cohort), not O(population).

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

import threading
from collections import OrderedDict
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core import tree
from repro_torch.core.algorithms import ClientData

__all__ = ["ClientPopulation", "EagerPopulation", "LazyPopulation",
           "as_population"]


def _data_nbytes(data: ClientData) -> int:
    """Approximate host bytes held by one client's batches (for the fetch
    cache's byte budget): every array leaf of every batch, dict batches
    included (the JAX package counts a dict batch as one 64-byte leaf);
    a leaf without ``nbytes`` counts 64."""
    total = sum(int(getattr(a, "nbytes", 64))
                for a in tree.leaves(list(data.batches)))
    return max(total, 1)


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
               exclude: Optional[Sequence[int]] = None,
               filters: Sequence[Callable[[int], bool]] = ()) -> List[int]:
        """Draw ``min(k, pool)`` distinct client ids, rng-identical to the
        legacy ``rng.choice(sorted(ids) - exclude, size, replace=False)``.

        Without filters the pool is never materialised: positional indices
        are drawn against the virtual pool length and rank-adjusted past the
        excluded ids' positions in the sorted registry — O(k log k +
        |exclude| log M) per call.  With availability/fault filters each
        candidate is tested individually (in sorted order) and survivors
        pack into an int64 array, so the filtered pool costs one machine
        word per available client, not a boxed-int Python list."""
        ids = self.ids_array()
        if filters:
            excl = {int(c) for c in exclude} if exclude else None
            pool = np.fromiter(
                (c for c in ids
                 if (excl is None or int(c) not in excl)
                 and all(f(int(c)) for f in filters)),
                dtype=np.int64)
            size = min(int(k), int(pool.size))
            if size <= 0:
                return []
            idx = rng.choice(pool.size, size=size, replace=False)
            return [int(c) for c in pool[np.asarray(idx, dtype=np.int64)]]

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


class LazyPopulation(ClientPopulation):
    """Registry-backed streamed population.

    ``n_samples`` is an O(M)-words array (the whole registry for 1M clients
    is ~8 MB); batches come from ``factory(client_id)`` on demand through a
    bounded LRU byte cache (``fetch_cache_bytes``), so only the active
    cohort's data is resident.  Cached ``ClientData`` objects keep a stable
    identity while resident, which is what the executors' weakref-keyed
    batch caches key on; an evicted + re-fetched client simply re-enters
    those caches.

    ``ids=None`` means clients are ``0..M-1`` (the common case — no explicit
    id array is stored).  ``signature``/``meta`` carry optional registry
    annotations for schedulers that want them; they are never required.
    """

    def __init__(self, n_samples: Sequence[int],
                 factory: Callable[[int], ClientData], *,
                 ids: Optional[Sequence[int]] = None,
                 fetch_cache_bytes: int = 256 << 20,
                 signature: Any = None,
                 meta: Optional[Dict[str, Any]] = None):
        sizes = np.asarray(n_samples, dtype=np.int64)
        if ids is None:
            self._explicit_ids: Optional[np.ndarray] = None
        else:
            arr = np.asarray(ids, dtype=np.int64)
            if arr.shape != sizes.shape:
                raise ValueError("ids and n_samples length mismatch")
            order = np.argsort(arr, kind="stable")
            arr = arr[order]
            if arr.size and np.any(arr[1:] == arr[:-1]):
                raise ValueError("duplicate client ids")
            self._explicit_ids = arr
            sizes = sizes[order]
        self._sizes = sizes
        self._factory = factory
        self.signature = signature
        self.meta = dict(meta or {})
        self.fetch_cache_bytes = int(fetch_cache_bytes)
        self._cache: "OrderedDict[int, Any]" = OrderedDict()
        self._cache_nbytes: Dict[int, int] = {}
        self._cache_bytes = 0
        self._ids_cache: Optional[np.ndarray] = None
        self._lock = threading.RLock()
        self.stats = {"fetches": 0, "cache_hits": 0, "evictions": 0}

    # -- registry ------------------------------------------------------
    def ids_array(self) -> np.ndarray:
        if self._explicit_ids is not None:
            return self._explicit_ids
        if self._ids_cache is None:
            self._ids_cache = np.arange(self._sizes.size, dtype=np.int64)
        return self._ids_cache

    def _pos(self, client: int) -> int:
        if self._explicit_ids is None:
            if 0 <= client < self._sizes.size:
                return client
            raise KeyError(client)
        i = int(np.searchsorted(self._explicit_ids, client))
        if i < self._explicit_ids.size and int(self._explicit_ids[i]) == client:
            return i
        raise KeyError(client)

    def n_samples(self, client: int) -> int:
        return int(self._sizes[self._pos(int(client))])

    def __len__(self) -> int:
        return int(self._sizes.size)

    def __contains__(self, client: object) -> bool:
        try:
            self._pos(int(client))  # type: ignore[arg-type]
            return True
        except (KeyError, TypeError, ValueError):
            return False

    # -- bounded fetch cache -------------------------------------------
    @property
    def cache_bytes(self) -> int:
        return self._cache_bytes

    def __getitem__(self, client: int) -> ClientData:
        c = int(client)
        with self._lock:
            data = self._cache.get(c)
            if data is not None:
                self._cache.move_to_end(c)
                self.stats["cache_hits"] += 1
                return data
        self._pos(c)                      # KeyError for unknown ids
        data = self._factory(c)           # synthesize outside the lock
        nbytes = _data_nbytes(data)
        with self._lock:
            cur = self._cache.get(c)
            if cur is not None:           # raced fetch: keep the first
                self._cache.move_to_end(c)
                self.stats["cache_hits"] += 1
                return cur
            self.stats["fetches"] += 1
            self._cache[c] = data
            self._cache_nbytes[c] = nbytes
            self._cache_bytes += nbytes
            while (self.fetch_cache_bytes > 0
                   and self._cache_bytes > self.fetch_cache_bytes
                   and len(self._cache) > 1):
                old, _ = self._cache.popitem(last=False)
                self._cache_bytes -= self._cache_nbytes.pop(old)
                self.stats["evictions"] += 1
        return data

    def materialize(self) -> Dict[int, ClientData]:
        """Build the equivalent eager dict straight from the factory (fresh
        objects, cache untouched) — the eager twin for parity tests."""
        return {int(c): self._factory(int(c)) for c in self.ids_array()}


def as_population(data: Any) -> ClientPopulation:
    """Adopt a ``ClientPopulation`` as-is; wrap a plain dict eagerly."""
    if isinstance(data, ClientPopulation):
        return data
    return EagerPopulation(data)

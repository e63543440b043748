"""Workload model and estimation (paper §4.3); port of
``repro/core/workload.py``, unchanged: it is numpy only.

The per-task running time on executor ``k`` is modelled as

    T_{m,k} = N_m * t_k^sample + b_k                       (Eq. 2)

with ``t_k^sample`` and ``b_k`` fitted by least squares on *measured*
(N_m, T̂_{m,k}) pairs recorded by the executors.  The Time-Window variant
(§4.4, "Tackling Dynamic Hardware Environments") restricts the fit to the
most recent ``tau`` rounds so drifting device speeds don't poison the model.

Under the event-driven round engines (semi-sync / async) the unit of
execution is a *chunk* of tasks rather than a single client, and timing is
recorded per chunk: one :class:`RunRecord` with ``n_samples`` = the chunk's
total sample count, ``time`` = the chunk's virtual duration and ``n_tasks``
= the number of clients it covered.  Eq. 2 is linear in N, so chunk records
fit the same model (the offset ``b`` then absorbs per-chunk instead of
per-task overhead — consistent as long as predictions are made at the same
granularity, which the engines do).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np


@dataclass(frozen=True)
class RunRecord:
    round: int
    client: int          # first client of the span (chunk records cover more)
    executor: int
    n_samples: int       # total samples in the span
    time: float
    n_tasks: int = 1     # clients covered: 1 (per-client) or chunk size


@dataclass
class WorkloadModel:
    """Fitted (t_sample, b) per executor."""
    t_sample: float
    b: float

    def predict(self, n_samples: float) -> float:
        return n_samples * self.t_sample + self.b


DEFAULT_MODEL = WorkloadModel(t_sample=1.0, b=0.0)


def fleet_average(models: Dict[int, "WorkloadModel"]
                  ) -> Optional["WorkloadModel"]:
    """Mean (t_sample, b) over the fitted executors — the stand-in for
    executors with no history yet (fresh/elastic joiners) and for
    executor-agnostic span predictions (window-fit selection, which must
    price a client before knowing where it will be scheduled).  None when
    nothing has been fitted."""
    if not models:
        return None
    return WorkloadModel(
        t_sample=sum(m.t_sample for m in models.values()) / len(models),
        b=sum(m.b for m in models.values()) / len(models))


def _lstsq(n: np.ndarray, t: np.ndarray) -> WorkloadModel:
    A = np.stack([n, np.ones_like(n)], axis=1)
    (ts, b), *_ = np.linalg.lstsq(A, t, rcond=None)
    # physical constraints: non-negative per-sample time and offset
    return WorkloadModel(t_sample=max(float(ts), 1e-9), b=max(float(b), 0.0))


def _robust_fit(n: np.ndarray, t: np.ndarray) -> WorkloadModel:
    """Least squares with one outlier-rejection pass: first-execution jit
    compiles and GC pauses produce multi-hundred-x residuals that would
    otherwise poison the model for the whole run (paper Fig. 6 assumes clean
    timings; real executors do not provide them)."""
    m = _lstsq(n, t)
    if len(n) < 6:
        return m
    resid = np.abs(t - (n * m.t_sample + m.b))
    cut = 4.0 * max(float(np.median(resid)), 1e-9)
    keep = resid <= cut
    if keep.sum() >= 4 and keep.sum() < len(n):
        m = _lstsq(n[keep], t[keep])
    return m


class WorkloadEstimator:
    """Records run times and fits Eq. 2 per executor.

    ``time_window=0`` uses all history (the paper's default); ``tau > 0``
    keeps only rounds in ``[r - tau, r - 1]``.
    """

    def __init__(self, time_window: int = 0):
        self.time_window = time_window
        self._records: Dict[int, List[RunRecord]] = collections.defaultdict(list)
        self.last_fit: Dict[int, WorkloadModel] = {}
        self.fit_time_s: float = 0.0

    def record(self, rec: RunRecord) -> None:
        self._records[rec.executor].append(rec)

    def record_many(self, recs: Iterable[RunRecord]) -> None:
        for r in recs:
            self.record(r)

    def executors(self) -> List[int]:
        return sorted(self._records)

    def n_records(self, executor: Optional[int] = None) -> int:
        if executor is not None:
            return len(self._records.get(executor, ()))
        return sum(len(v) for v in self._records.values())

    def fit(self, current_round: int) -> Dict[int, WorkloadModel]:
        """Least-squares fit of Eq. 2 for each executor (paper Alg. 3,
        Estimate_Workload)."""
        import time as _time
        t0 = _time.perf_counter()
        models: Dict[int, WorkloadModel] = {}
        lo = current_round - self.time_window if self.time_window else -1
        for k, recs in self._records.items():
            use = [r for r in recs if r.round >= lo] if self.time_window else recs
            if len(use) < 2:
                # too little data: reuse the previous fit if any, otherwise
                # leave the executor absent so the scheduler substitutes the
                # fleet average (a DEFAULT here starves fresh executors)
                if k in self.last_fit:
                    models[k] = self.last_fit[k]
                continue
            n = np.asarray([r.n_samples for r in use], np.float64)
            t = np.asarray([r.time for r in use], np.float64)
            if np.ptp(n) < 1e-12:
                # degenerate: all tasks same size -> pure-offset model
                models[k] = WorkloadModel(t_sample=float(np.median(t) / max(n[0], 1.0)),
                                          b=0.0)
                continue
            models[k] = _robust_fit(n, t)
        self.last_fit = models
        self.fit_time_s = _time.perf_counter() - t0
        return models

    def estimation_error(self, models: Dict[int, WorkloadModel],
                         recs: Iterable[RunRecord]) -> float:
        """Mean relative |predicted - measured| / measured (paper Fig. 6/11)."""
        errs = []
        for r in recs:
            m = models.get(r.executor)
            if m is None or r.time <= 0:
                continue
            errs.append(abs(m.predict(r.n_samples) - r.time) / r.time)
        return float(np.mean(errs)) if errs else float("nan")

"""Fault injection & recovery (DESIGN.md §10).  Port of
``repro/core/faults.py`` (host data and numpy only: ``FaultPlan.random``
draws the same events from the same seed in both packages).

Parrot's pitch is simulation→production without code change, but production
means executors crash, uploads stall and payloads corrupt.  This module
makes those behaviours first-class *virtual-time events* so every recovery
path is exercised — and testable — inside the deterministic simulation:

* :class:`FaultEvent` — one declarative fault on the virtual-time axis.
  Kinds:

  - ``crash``    — executor ``executor`` dies at ``time`` (in-flight chunk
                   lost; queue re-homes through the engine's failure path;
                   K shrinks until a matching ``restart``).
  - ``restart``  — a previously crashed executor rejoins at ``time``
                   through ``ParrotServer._revive_executor`` and picks up
                   work at the next schedule, re-pinned through the
                   server's device placement when it has one.
  - ``dropout``  — client ``client`` goes offline for ``duration`` seconds
                   starting at ``time``.  A chunk *dispatched* into the
                   window loses the client up front (mid-compute dropout);
                   an upload whose flight window contains the dropout start
                   is lost in transit (mid-upload dropout) and the chunk's
                   clients re-enter the engine's re-run pool.
  - ``corrupt``  — the next partial executor ``executor`` ships at or after
                   ``time`` arrives corrupted; the server detects and
                   discards it, and the chunk's clients retry through the
                   re-run pool (bounded by the :class:`RetryPolicy`).
  - ``blackout`` — no traffic moves on the (global, or ``executor``-local)
                   server link during ``[time, time+duration)``; transfers
                   in flight pause and resume, which can trip the chunk
                   timeout.
  - ``slowdown`` — executor ``executor`` computes ``factor``× slower during
                   ``[time, time+duration)``; chunk virtual durations AND
                   the scheduler's span predictions both see the factor.

* :class:`FaultPlan` — an immutable, seeded collection of events.
  ``FaultPlan.random`` synthesizes a chaos plan deterministically from a
  seed (crashes always paired with restarts; ``spare`` executors are never
  crashed so the run cannot lose its last device).

* :class:`RetryPolicy` — chunk-level timeouts with bounded retry and
  exponential backoff, all priced on the virtual clock: a chunk upload that
  exceeds ``timeout_s`` (e.g. across a blackout) is re-sent after
  ``backoff_s · mult^(attempt-1)`` and re-priced through the network model;
  a client whose chunk keeps failing (corruption, lost uploads) re-runs at
  most ``max_retries`` times before it is dropped from the round.

* :class:`FaultInjector` — the runtime the engines consult.  The plan is
  immutable; the injector's only mutable state is which one-shot events
  (crashes, restarts, corruptions) have fired and each client's retry
  budget — a tiny plain-data blob that checkpoints with the server, so a
  killed run resumed with ``auto_resume=True`` replays the remaining faults
  deterministically.

With ``faults=None`` (the default) none of this is consulted and every
engine keeps its pre-fault code path bit-exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

CRASH = "crash"
RESTART = "restart"
DROPOUT = "dropout"
CORRUPT = "corrupt"
BLACKOUT = "blackout"
SLOWDOWN = "slowdown"

KINDS = (CRASH, RESTART, DROPOUT, CORRUPT, BLACKOUT, SLOWDOWN)


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault on the virtual-time axis (plain data: pickles
    into checkpoint blobs and across process boundaries)."""
    time: float
    kind: str
    executor: Optional[int] = None     # crash/restart/corrupt/slowdown;
    #                                    blackout: None = the global link
    client: Optional[int] = None       # dropout
    duration: float = 0.0              # dropout/blackout/slowdown window
    factor: float = 1.0                # slowdown multiplier (>= 1 slows)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {KINDS}")

    @property
    def end(self) -> float:
        return self.time + max(self.duration, 0.0)


@dataclass(frozen=True)
class RetryPolicy:
    """Chunk timeout / retry / backoff knobs, priced on the virtual clock.

    ``timeout_s`` bounds one upload attempt (inf disables the timeout);
    ``max_retries`` bounds per-client re-runs after corruption or payload
    loss AND per-upload re-sends after a timeout; ``backoff_s`` is the base
    delay before retry 1, doubling (``backoff_mult``) per further attempt.
    """
    timeout_s: float = math.inf
    max_retries: int = 2
    backoff_s: float = 1.0
    backoff_mult: float = 2.0

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based)."""
        return self.backoff_s * (self.backoff_mult ** max(attempt - 1, 0))


class FaultPlan:
    """An immutable, seeded, declarative set of fault events.

    Events are kept sorted by ``(time, kind, executor, client)`` so every
    consumer sees one canonical order; the ``seed`` is carried for
    provenance (two plans built from the same seed are identical).
    """

    def __init__(self, events: Iterable[FaultEvent], seed: Optional[int] = None):
        self.events: Tuple[FaultEvent, ...] = tuple(sorted(
            events, key=lambda e: (e.time, KINDS.index(e.kind),
                                   -1 if e.executor is None else e.executor,
                                   -1 if e.client is None else e.client)))
        self.seed = seed
        for ev in self.events:
            if ev.kind in (CRASH, RESTART, CORRUPT, SLOWDOWN) \
                    and ev.executor is None:
                raise ValueError(f"{ev.kind} event needs an executor: {ev}")
            if ev.kind == DROPOUT and ev.client is None:
                raise ValueError(f"dropout event needs a client: {ev}")

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def of_kind(self, kind: str) -> List[FaultEvent]:
        return [e for e in self.events if e.kind == kind]

    # ------------------------------------------------------------------
    @classmethod
    def random(cls, *, seed: int, horizon: float,
               executors: Sequence[int], clients: Sequence[int],
               crash_rate: float = 0.0, restart_delay: float = 5.0,
               dropout_rate: float = 0.0, dropout_duration: float = 5.0,
               corrupt_rate: float = 0.0,
               blackout_rate: float = 0.0, blackout_duration: float = 2.0,
               slowdown_rate: float = 0.0, slowdown_duration: float = 5.0,
               slowdown_factor: float = 4.0,
               spare: int = 1) -> "FaultPlan":
        """Seeded chaos plan over ``[0, horizon)`` virtual seconds.

        ``*_rate`` are expected events per virtual second (Poisson counts,
        uniform placement — all drawn from one ``np.random.default_rng(seed)``
        stream, so the plan is a pure function of its arguments).  Every
        crash is paired with a restart ``restart_delay`` later; the first
        ``spare`` executors (sorted order) are never crashed, so a plan can
        never strand the run with zero live executors.
        """
        rng = np.random.default_rng(seed)
        executors = sorted(executors)
        clients = sorted(clients)
        crashable = executors[spare:] if spare > 0 else list(executors)
        events: List[FaultEvent] = []

        def times(rate: float) -> np.ndarray:
            n = rng.poisson(rate * horizon)
            return np.sort(rng.uniform(0.0, horizon, size=n))

        if crashable:
            # at most one outstanding crash per executor: pair each crash
            # with its restart before the executor may crash again
            busy_until = {k: 0.0 for k in crashable}
            for t in times(crash_rate):
                k = int(rng.choice(crashable))
                if t < busy_until[k]:
                    continue
                events.append(FaultEvent(time=float(t), kind=CRASH,
                                         executor=k))
                events.append(FaultEvent(time=float(t + restart_delay),
                                         kind=RESTART, executor=k))
                busy_until[k] = t + restart_delay
        if clients:
            for t in times(dropout_rate):
                c = int(rng.choice(clients))
                events.append(FaultEvent(time=float(t), kind=DROPOUT,
                                         client=c,
                                         duration=float(dropout_duration)))
        for t in times(corrupt_rate):
            k = int(rng.choice(executors))
            events.append(FaultEvent(time=float(t), kind=CORRUPT, executor=k))
        for t in times(blackout_rate):
            events.append(FaultEvent(time=float(t), kind=BLACKOUT,
                                     duration=float(blackout_duration)))
        for t in times(slowdown_rate):
            k = int(rng.choice(executors))
            events.append(FaultEvent(time=float(t), kind=SLOWDOWN,
                                     executor=k,
                                     duration=float(slowdown_duration),
                                     factor=float(slowdown_factor)))
        return cls(events, seed=seed)


@dataclass
class FaultCounters:
    """Per-round fault accounting — the engines zero one of these each
    round and surface it through the unified ``RoundMetrics`` schema."""
    retries: int = 0
    corrupt_payloads: int = 0
    dropped_clients: int = 0
    crashes: int = 0
    restarts: int = 0
    timeouts: int = 0
    quorum_commits: int = 0


class FaultInjector:
    """Runtime view of a :class:`FaultPlan` + :class:`RetryPolicy`.

    Almost every query is a pure function of the immutable plan; the only
    mutable state is the set of fired one-shot events (crashes, restarts,
    corruptions — each fires exactly once) and the per-client retry
    budgets, which ``state_dict``/``load_state_dict`` round-trip through
    checkpoints so a resumed run replays the remaining faults exactly.
    """

    def __init__(self, plan: Optional[FaultPlan],
                 retry: Optional[RetryPolicy] = None):
        self.plan = plan if plan is not None else FaultPlan(())
        self.retry = retry or RetryPolicy()
        # the crash / timeout / resend telemetry instants: ROADMAP item 16
        # one-shot events by index into plan.events
        self._fired: Set[int] = set()
        self._retry_count: Dict[int, int] = {}     # client -> failed runs
        # fast per-kind views (index, event) preserving canonical order
        self._by_kind: Dict[str, List[Tuple[int, FaultEvent]]] = {
            k: [] for k in KINDS}
        for i, ev in enumerate(self.plan.events):
            self._by_kind[ev.kind].append((i, ev))

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"fired": sorted(self._fired),
                "retry_count": dict(self._retry_count)}

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        if not state:
            return
        self._fired = set(state["fired"])
        self._retry_count = {int(c): int(n)
                             for c, n in state["retry_count"].items()}

    # -- crash / restart lifecycle -----------------------------------------
    def crash_due(self, executor: int, t: float) -> Optional[float]:
        """Earliest unfired crash for ``executor`` at or before ``t`` (the
        executor is dead *now*), or None.  Does not mark fired — callers
        mark via :meth:`fire` once the engine has actually processed it."""
        for i, ev in self._by_kind[CRASH]:
            if i not in self._fired and ev.executor == executor \
                    and ev.time <= t:
                return ev.time
        return None

    def crash_in(self, executor: int, t_lo: float,
                 t_hi: float) -> Optional[Tuple[int, float]]:
        """Earliest unfired crash for ``executor`` in ``[t_lo, t_hi)`` —
        returns ``(event_index, time)`` or None."""
        for i, ev in self._by_kind[CRASH]:
            if i not in self._fired and ev.executor == executor \
                    and t_lo <= ev.time < t_hi:
                return i, ev.time
        return None

    def fire_crash(self, executor: int, t: float) -> bool:
        """Mark every unfired crash for ``executor`` at or before ``t`` as
        fired (one death consumes stale duplicates too).  True if any."""
        fired = False
        for i, ev in self._by_kind[CRASH]:
            if i not in self._fired and ev.executor == executor \
                    and ev.time <= t:
                self._fired.add(i)
                fired = True
        return fired

    def restarts_due(self, t: float) -> List[int]:
        """Executors whose unfired restart events are due at ``t`` (marked
        fired — a restart is consumed whether or not the executor was ever
        down; event order is the canonical plan order)."""
        out: List[int] = []
        for i, ev in self._by_kind[RESTART]:
            if i not in self._fired and ev.time <= t:
                self._fired.add(i)
                out.append(ev.executor)
        return out

    # -- slowdown ----------------------------------------------------------
    def slowdown(self, executor: int, t: float) -> float:
        """Compound slowdown multiplier active on ``executor`` at ``t``
        (1.0 outside every window).  Sampled at a chunk's dispatch time and
        applied to its whole span — windows are long relative to chunks."""
        f = 1.0
        for _, ev in self._by_kind[SLOWDOWN]:
            if ev.executor == executor and ev.time <= t < ev.end:
                f *= max(ev.factor, 0.0)
        return f

    def scaled_model(self, model, executor: int, t: float):
        """The scheduler's fitted model with the active slowdown applied —
        what ``predict_span`` must see so deadline/steal decisions anticipate
        a slowed device (Eq. 2 scales linearly)."""
        if model is None:
            return None
        f = self.slowdown(executor, t)
        if f == 1.0:
            return model
        return replace(model, t_sample=model.t_sample * f, b=model.b * f)

    # -- dropout -----------------------------------------------------------
    def client_down(self, client: int, t: float) -> bool:
        return any(ev.client == client and ev.time <= t < ev.end
                   for _, ev in self._by_kind[DROPOUT])

    def dropout_in(self, client: int, t_lo: float, t_hi: float) -> bool:
        """True when ``client`` is down at ``t_lo`` or a dropout window
        *starts* inside ``[t_lo, t_hi)`` — the mid-compute (dispatch-time)
        and mid-upload (flight-window) checks share this predicate."""
        if self.client_down(client, t_lo):
            return True
        return any(ev.client == client and t_lo <= ev.time < t_hi
                   for _, ev in self._by_kind[DROPOUT])

    def split_up(self, tasks: Sequence[Any], t: float,
                 pred_dur: float) -> Tuple[List[Any], List[Any]]:
        """(up, down) split of a chunk's tasks at dispatch: a client down
        now, or whose dropout window opens inside the chunk's predicted
        span, leaves the chunk before it runs (mid-compute dropout)."""
        up, down = [], []
        for task in tasks:
            (down if self.dropout_in(task.client, t, t + max(pred_dur, 0.0))
             else up).append(task)
        return up, down

    def upload_lost(self, clients: Iterable[int], t_lo: float,
                    t_hi: float) -> bool:
        """Mid-upload dropout: the partial is lost in transit when any
        constituent client's dropout window opens during the flight."""
        return any(self.dropout_in(c, t_lo, t_hi) for c in clients)

    # -- corruption --------------------------------------------------------
    def take_corrupt(self, executor: int, t: float) -> bool:
        """Consume (at most) one pending corruption for a partial shipped
        by ``executor`` at time ``t`` — the oldest unfired corrupt event at
        or before ``t`` fires, exactly once."""
        for i, ev in self._by_kind[CORRUPT]:
            if i not in self._fired and ev.executor == executor \
                    and ev.time <= t:
                self._fired.add(i)
                return True
        return False

    # -- blackout / transfer pricing ---------------------------------------
    def _blackouts(self, executor: Optional[int]
                   ) -> List[Tuple[float, float]]:
        return [(ev.time, ev.end) for _, ev in self._by_kind[BLACKOUT]
                if ev.executor is None or ev.executor == executor]

    def xfer_end(self, t_start: float, duration: float,
                 executor: Optional[int] = None) -> float:
        """Completion time of a transfer starting at ``t_start`` with
        ``duration`` seconds of link time, pausing through every blackout
        window that overlaps it (global windows plus ``executor``-local
        ones).  ``duration`` 0 still waits out a blackout covering
        ``t_start`` — the link is down, nothing moves."""
        t, left = t_start, max(duration, 0.0)
        for a, b in sorted(self._blackouts(executor)):
            if b <= t:
                continue
            if a > t + left:
                break
            # link time spent before this window opens
            left -= max(a - t, 0.0)
            t = max(t, b)
        return t + left

    # -- retry budget ------------------------------------------------------
    def charge_retry(self, clients: Iterable[int]
                     ) -> Tuple[List[int], List[int]]:
        """Charge one failed run against each client's retry budget.
        Returns ``(retry, give_up)``: clients with budget left re-enter the
        engine's re-run pool; the rest are dropped from the round."""
        retry, give_up = [], []
        for c in clients:
            n = self._retry_count.get(c, 0) + 1
            self._retry_count[c] = n
            (retry if n <= self.retry.max_retries else give_up).append(c)
        return retry, give_up

    def clear_retries(self, clients: Iterable[int]) -> None:
        """A successful fold resets the client's budget."""
        for c in clients:
            self._retry_count.pop(c, None)

    # -- upload pricing with timeout/retry ---------------------------------
    def price_upload(self, t_send: float, attempt_s: float, netsim,
                     clients: Sequence[int], nbytes: int,
                     counters: Optional[FaultCounters] = None,
                     executor: Optional[int] = None
                     ) -> Optional[float]:
        """Arrival time of a chunk upload under blackouts + the chunk
        timeout, or None when every attempt timed out (payload lost).

        Attempt 1 starts at ``t_send`` and takes ``attempt_s`` of link
        time, paused through blackouts; an attempt whose wall span exceeds
        ``timeout_s`` is abandoned at the timeout and re-sent after the
        exponential backoff, re-priced through the network model (each
        re-send bills comm time and bytes again — retries are not free).
        """
        timeout = self.retry.timeout_s
        t = t_send
        for attempt in range(self.retry.max_retries + 1):
            if attempt > 0:
                # re-price the re-send through the network model (the link
                # is re-acquired; bytes and comm time bill again)
                attempt_s = (netsim.up(clients, nbytes)
                             if netsim is not None and netsim.net is not None
                             else attempt_s)
                if counters is not None:
                    counters.retries += 1
            arrival = self.xfer_end(t, attempt_s, executor)
            if arrival - t <= timeout:
                return arrival
            if counters is not None:
                counters.timeouts += 1
            t = t + timeout + self.retry.backoff(attempt + 1)
        return None


def scale_report(rep, factor: float) -> None:
    """Apply an active slowdown factor to a chunk report in place: the
    chunk's virtual span and each per-client record stretch by ``factor``
    (so the workload estimator learns the slowed device, and the engines'
    busy-until arithmetic prices the slowed chunk).  1.0 is an exact
    no-op — no float op touches the report."""
    if factor == 1.0:
        return
    rep.virtual_time *= factor
    rep.records = [replace(r, time=r.time * factor) for r in rep.records]

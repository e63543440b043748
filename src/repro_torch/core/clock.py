"""Shared virtual-time clock (port of ``repro/core/clock.py``, unchanged:
it holds no arrays).

The paper's timing experiments run on *virtual* time: executors measure the
wall time of each block of client work and scale it by the speed model's
η_k(r), so heterogeneity experiments are deterministic and fast on
homogeneous hardware.  Under BSP the only consumer of those durations is the
end-of-round ``max_k Σ`` makespan, so each executor could keep its own
running sum.  Under semi-sync and async the *interleaving* of executors
matters — which chunk lands first decides fold order, staleness weights and
work stealing — so the clock moves out of the executors into one shared
discrete-event queue:

* :class:`VirtualClock` orders events by ``(time, seq)`` where ``seq`` is a
  monotonic tie-breaker assigned at push time.  Two events at the same
  virtual time therefore pop in push order, which makes the engines'
  behaviour a pure function of the per-chunk durations — deterministic under
  any ``speed_model``, independent of host scheduling.

* Engines run chunks *lazily*: an executor's next chunk is physically
  executed only when its previous completion event pops, i.e. at the chunk's
  virtual dispatch time.  Every event earlier in virtual time has already
  been processed, so the chunk sees exactly the server state (params
  version, queue contents) that a causally-correct parallel execution would
  have shown it.

Timers: executors take an injectable ``timer`` (default
``time.perf_counter``).  :class:`TickTimer` advances a fixed amount per
call, which makes measured durations a pure function of the *call sequence*
— the bit-exactness tests run the legacy loop and the BSP engine under the
same TickTimer and assert identical makespan histories, proving the call
sequences are identical.
"""
from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Tuple

SystemTimer = time.perf_counter


class TickTimer:
    """Deterministic timer: every call advances virtual wall time by ``dt``.

    Durations measured with a TickTimer depend only on how many timer calls
    the measured span contains — i.e. on the exact code path taken — which is
    what the engine-equivalence tests want to pin down.  A call is atomic:
    executors that run in threads (``parallel_dispatch``) may share one.
    """

    def __init__(self, dt: float = 1.0):
        self.dt = float(dt)
        self.now = 0.0
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self.now += self.dt
            return self.now


@dataclass(frozen=True)
class Event:
    """One scheduled occurrence: ``kind`` names the handler, ``data`` is the
    engine-defined payload."""
    time: float
    seq: int
    kind: str
    data: Any = field(compare=False, default=None)


class VirtualClock:
    """Deterministic discrete-event queue on the simulated (virtual) axis.

    ``now`` is the virtual time of the last popped event and never moves
    backwards; pushing an event earlier than ``now`` is a causality bug and
    raises.
    """

    def __init__(self):
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = 0
        self.now: float = 0.0

    def push(self, at: float, kind: str, data: Any = None) -> Event:
        if at < self.now - 1e-12:
            raise ValueError(
                f"event '{kind}' at t={at} is earlier than now={self.now}")
        ev = Event(time=float(at), seq=self._seq, kind=kind, data=data)
        self._seq += 1
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    # ------------------------------------------------------------------
    # checkpointing (async engine in-flight state): the queue is plain data
    # — (time, seq, kind, data) tuples — plus the seq counter and ``now``.
    # The seq counter must round-trip exactly: it breaks same-time ties, so
    # a resumed clock must keep numbering where the saved one stopped.
    def state_dict(self) -> Dict[str, Any]:
        return {"now": self.now, "seq": self._seq,
                "events": [(ev.time, ev.seq, ev.kind, ev.data)
                           for _, _, ev in sorted(self._heap,
                                                  key=lambda e: e[:2])]}

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any]) -> "VirtualClock":
        clock = cls()
        clock.now = float(state["now"])
        clock._seq = int(state["seq"])
        for t, seq, kind, data in state["events"]:
            ev = Event(time=float(t), seq=int(seq), kind=kind, data=data)
            heapq.heappush(clock._heap, (ev.time, ev.seq, ev))
        return clock

    def pop(self) -> Event:
        _, _, ev = heapq.heappop(self._heap)
        self.now = max(self.now, ev.time)
        return ev

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield self.pop()

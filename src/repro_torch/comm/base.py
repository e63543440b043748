"""Abstract communication layer (paper §3.2, "Easy Migration"); port of
``repro/comm/base.py``, unchanged: it holds no arrays.

FL algorithm code never touches a transport directly: the round engine talks
to a :class:`Communicator`, and swapping the implementation moves the same
code between (a) in-process simulation (:class:`LocalComm`), (b) SPMD
collectives on a TPU mesh (:class:`CollectiveComm` in ``collective.py``), and
(c) a real cross-silo deployment (a gRPC/MQTT transport would implement the
same five methods) — the paper's zero-code-change migration claim.

Every implementation records :class:`CommStats` (bytes and trips per round),
which is how the Table-1 communication-complexity benchmark measures the
hierarchical-aggregation saving.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class CommStats:
    bytes_sent: int = 0
    bytes_received: int = 0
    trips: int = 0
    by_tag: Dict[str, int] = field(default_factory=dict)

    def add(self, tag: str, nbytes: int, trips: int = 1) -> None:
        self.bytes_sent += nbytes
        self.trips += trips
        self.by_tag[tag] = self.by_tag.get(tag, 0) + nbytes

    def reset(self) -> "CommStats":
        snap = CommStats(self.bytes_sent, self.bytes_received, self.trips,
                         dict(self.by_tag))
        self.bytes_sent = self.bytes_received = self.trips = 0
        self.by_tag = {}
        return snap


class Communicator(abc.ABC):
    """Server <-> executor transport."""

    def __init__(self):
        self.stats = CommStats()

    @abc.abstractmethod
    def broadcast(self, payload: Any, executors: List[int], tag: str) -> None:
        """Server -> all executors (Θ^r and the task lists)."""

    @abc.abstractmethod
    def send_to_executor(self, executor: int, payload: Any, tag: str) -> None:
        """Server -> one executor."""

    @abc.abstractmethod
    def recv_from_executor(self, executor: int, tag: str) -> Any:
        """Server <- one executor (the partial aggregate G_k: one trip)."""

    @abc.abstractmethod
    def executor_send(self, executor: int, payload: Any, tag: str) -> None:
        """Executor -> server."""

    @abc.abstractmethod
    def executor_recv(self, executor: int, tag: str) -> Any:
        """Executor <- server."""

    @abc.abstractmethod
    def poll(self, executor: int, tag: str) -> Any:
        """Non-blocking server <- executor receive.

        Returns the oldest pending ``executor_send`` payload for ``(executor,
        tag)`` and consumes it, or ``None`` when nothing has landed yet.  The
        ``executor_send`` / ``poll`` pair is the transport contract of the
        event-driven round engines (DESIGN.md §3): executors push per-chunk
        partials as they complete, the server drains them whenever the event
        loop gives it control — no blocking rendezvous, so a straggler can
        never stall the fold path.
        """

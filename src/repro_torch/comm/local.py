"""In-process Communicator used by the simulation (and the unit tests);
port of ``repro/comm/local.py``.

Messages are passed by reference (zero-copy, like executors sharing a host)
but *accounted* at their serialised size, so the comm-complexity benchmarks
measure exactly what a networked transport would move.

Because messages move by reference, a partial on the card reaches the
server-side fold as the same tensors, with no host round-trip and no sync
(the byte accounting reads shapes and dtypes only, never values).
"""
from __future__ import annotations

import collections
import queue
from typing import Any, Dict, Tuple

from repro_torch.comm.base import Communicator


def _nbytes(payload: Any) -> int:
    # lazy import: repro_torch.core.round imports this module (cycle
    # otherwise)
    from repro_torch.core.aggregation import payload_bytes
    return payload_bytes(payload)


class LocalComm(Communicator):
    def __init__(self):
        super().__init__()
        self._to_exec: Dict[Tuple[int, str], "queue.Queue"] = \
            collections.defaultdict(queue.Queue)
        self._to_server: Dict[Tuple[int, str], "queue.Queue"] = \
            collections.defaultdict(queue.Queue)

    def broadcast(self, payload, executors, tag):
        nb = _nbytes(payload)
        for k in executors:
            self._to_exec[(k, tag)].put(payload)
        # one logical trip per executor (server pushes K messages)
        self.stats.add(tag, nb * len(executors), trips=len(executors))

    def send_to_executor(self, executor, payload, tag):
        self._to_exec[(executor, tag)].put(payload)
        self.stats.add(tag, _nbytes(payload), trips=1)

    def recv_from_executor(self, executor, tag):
        return self._to_server[(executor, tag)].get()

    def executor_send(self, executor, payload, tag):
        self._to_server[(executor, tag)].put(payload)
        self.stats.add(tag, _nbytes(payload), trips=1)

    def executor_recv(self, executor, tag):
        return self._to_exec[(executor, tag)].get()

    def poll(self, executor, tag):
        try:
            return self._to_server[(executor, tag)].get_nowait()
        except queue.Empty:
            return None

"""Trace-driven network & availability simulation (DESIGN.md §9).  Port of
``repro/core/network.py``: host float math in the JAX package's expression
order, so every virtual time equals the JAX package's to the bit.

The virtual clock (§4) prices compute only; without this module uploads,
downloads and client churn are free and instantaneous, so compression and
the scheduler's per-executor offset have zero observable effect on the
simulated makespan.  This module adds the comm axis:

* :class:`NetworkModel` — per-client uplink/downlink bandwidth and latency
  (:class:`LinkProfile`), either uniform, sampled deterministically from a
  seeded distribution, or loaded from FedScale-style trace rows
  (``data/traces.py``).  A chunk's upload is priced
  ``latency + wire_bytes / uplink_bw`` at the chunk's *bottleneck* client
  (min bandwidth, max latency: the executor's partial is not ready before
  its slowest constituent has shipped), using the compressor's achieved
  wire size — top-k / int8 finally move the makespan.  A round's model
  broadcast is priced the same way on the downlink.

* :class:`ClientAvailability` — per-client active windows (join/leave), a
  synthetic diurnal generator, or FedScale behavior-trace rows.
  Unavailable clients are filtered at selection; a client predicted to
  leave mid-chunk is dropped at dispatch and re-enters through the engine's
  existing re-run path (semi-sync carry pool / async re-selection).

* :class:`CommEvent` — the payload of a ``"chunk_arrived"`` event on the
  shared :class:`~repro_torch.core.clock.VirtualClock`: the engines push it at
  ``compute_done + upload_time`` and fold the carried wire partial when it
  pops, so uploads overlap the executor's next chunk exactly as they would
  on a real link.

With ``network=None`` and ``availability=None`` (the defaults) none of
this is consulted and the engines take their pre-existing code paths
bit-exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple


@dataclass(frozen=True)
class LinkProfile:
    """One client's link: bandwidths in bytes/second, latency in seconds."""
    uplink_bps: float
    downlink_bps: float
    latency_s: float = 0.0


#: infinite bandwidth, zero latency — comm-transparent (the pre-network
#: behaviour expressed as a link)
FREE_LINK = LinkProfile(uplink_bps=math.inf, downlink_bps=math.inf,
                        latency_s=0.0)

_KBPS_TO_BPS = 1000.0 / 8.0          # FedScale kbps -> bytes/second


@dataclass(frozen=True)
class CommEvent:
    """A partial in flight: pushed on the VirtualClock at its arrival time.

    ``partial`` is the decompressed wire copy (it crossed the comm layer at
    send time, keeping error-feedback residual order deterministic; its
    tensors stay on the server's device while the event waits in the
    clock, whose heap orders by (time, seq) and never compares payloads);
    ``version`` is the payload round the chunk trained against, so the
    async staleness count includes the comm delay.
    """
    executor: int
    partial: Any
    record: Optional[Any]            # workload RunRecord (or None)
    n_tasks: int
    completed_clients: Tuple[int, ...]
    wire_bytes: int
    version: int = 0
    # local virtual time the upload left the executor (telemetry: the
    # arrival-minus-sent delta feeds the upload-delay histogram)
    t_sent: float = 0.0


class NetworkModel:
    """Per-client link parameters with deterministic constructors.

    ``links`` maps client id -> :class:`LinkProfile`; absent clients take
    ``default`` (``FREE_LINK`` unless overridden, so a partial trace only
    constrains the clients it names).
    """

    def __init__(self, links: Dict[int, LinkProfile],
                 default: LinkProfile = FREE_LINK):
        self._links = dict(links)
        self.default = default

    def link(self, client: int) -> LinkProfile:
        return self._links.get(client, self.default)

    # -- pricing -----------------------------------------------------------
    @staticmethod
    def _xfer(nbytes: float, bw: float, latency: float) -> float:
        if nbytes <= 0:
            return max(latency, 0.0)
        if bw <= 0:
            return math.inf
        return max(latency, 0.0) + nbytes / bw

    def upload_time(self, clients: Iterable[int], nbytes: int) -> float:
        """Latency + wire time of one upload whose content gates on every
        named client (bottleneck: min uplink, max latency).  No clients ->
        0 (nothing shipped)."""
        links = [self.link(c) for c in clients]
        if not links:
            return 0.0
        return self._xfer(nbytes, min(l.uplink_bps for l in links),
                          max(l.latency_s for l in links))

    def download_time(self, clients: Iterable[int], nbytes: int) -> float:
        """One model broadcast to the named clients (they download in
        parallel; the chunk starts when the slowest has the payload)."""
        links = [self.link(c) for c in clients]
        if not links:
            return 0.0
        return self._xfer(nbytes, min(l.downlink_bps for l in links),
                          max(l.latency_s for l in links))

    def client_comm_time(self, client: int, down_bytes: int,
                         up_bytes: int) -> float:
        """One client's round-trip comm (Eq. 4's bandwidth-aware addend):
        download the model, upload the update."""
        l = self.link(client)
        return (self._xfer(down_bytes, l.downlink_bps, l.latency_s)
                + self._xfer(up_bytes, l.uplink_bps, l.latency_s))

    def chunk_comm_time(self, clients: Iterable[int], down_bytes: int,
                        up_bytes: int) -> float:
        """Predicted comm span of one chunk: broadcast down + partial up."""
        clients = list(clients)
        return (self.download_time(clients, down_bytes)
                + self.upload_time(clients, up_bytes))

    # -- transforms --------------------------------------------------------
    def scaled(self, factor: float) -> "NetworkModel":
        """Every bandwidth multiplied by ``factor`` (latency unchanged) —
        the makespan-monotonicity property's knob."""

        def s(l: LinkProfile) -> LinkProfile:
            return LinkProfile(l.uplink_bps * factor,
                               l.downlink_bps * factor, l.latency_s)

        return NetworkModel({c: s(l) for c, l in self._links.items()},
                            default=s(self.default))

    # -- constructors ------------------------------------------------------
    @classmethod
    def uniform(cls, uplink_bps: float, downlink_bps: Optional[float] = None,
                latency_s: float = 0.0) -> "NetworkModel":
        """Every client on the same link."""
        down = uplink_bps if downlink_bps is None else downlink_bps
        return cls({}, default=LinkProfile(uplink_bps, down, latency_s))

    @classmethod
    def from_trace(cls, rows: Sequence[Any],
                   default: LinkProfile = FREE_LINK) -> "NetworkModel":
        """FedScale-style capacity rows (``data/traces.py: CapacityRow`` or
        equivalent dicts; kbps / ms units)."""
        links = {}
        for r in rows:
            get = r.get if isinstance(r, dict) else lambda k, _r=r: getattr(_r, k)
            links[int(get("client_id"))] = LinkProfile(
                uplink_bps=float(get("uplink_kbps")) * _KBPS_TO_BPS,
                downlink_bps=float(get("downlink_kbps")) * _KBPS_TO_BPS,
                latency_s=float(get("latency_ms")) / 1000.0)
        return cls(links, default=default)

    @classmethod
    def lognormal(cls, n_clients: int, seed: int = 0,
                  median_uplink_kbps: float = 12_000.0, sigma: float = 1.0,
                  down_up_ratio: float = 5.0,
                  latency_ms_range: Tuple[float, float] = (20.0, 120.0)
                  ) -> "NetworkModel":
        """Seeded lognormal bandwidth population (the measured-trace shape)."""
        from repro_torch.data.traces import synthesize_capacity_trace
        return cls.from_trace(synthesize_capacity_trace(
            n_clients, seed=seed, dist="lognormal",
            median_uplink_kbps=median_uplink_kbps, sigma=sigma,
            down_up_ratio=down_up_ratio, latency_ms_range=latency_ms_range))


class ClientAvailability:
    """Per-client active windows on the virtual-time axis.

    ``windows`` maps client id -> sorted ``(start, end)`` active spans; a
    ``period`` folds the query time (diurnal traces), otherwise spans are
    absolute.  Clients without an entry take ``default`` (available).  With
    a periodic wrap-around window split in two, ``remaining`` is evaluated
    within the current span only — a conservative (never optimistic)
    under-estimate across the period boundary.
    """

    def __init__(self, windows: Dict[int, Sequence[Tuple[float, float]]],
                 period: Optional[float] = None, default: bool = True):
        self.period = None if period is None else float(period)
        self.default = bool(default)
        self._win: Dict[int, Tuple[Tuple[float, float], ...]] = {
            int(c): tuple(sorted((float(a), float(b)) for a, b in ws))
            for c, ws in windows.items()}

    def _fold(self, t: float) -> float:
        return t % self.period if self.period else t

    def available(self, client: int, t: float) -> bool:
        ws = self._win.get(client)
        if ws is None:
            return self.default
        lt = self._fold(t)
        return any(a <= lt < b for a, b in ws)

    def remaining(self, client: int, t: float) -> float:
        """Seconds until the client leaves (0 when unavailable, inf when
        unconstrained)."""
        ws = self._win.get(client)
        if ws is None:
            return math.inf if self.default else 0.0
        lt = self._fold(t)
        for a, b in ws:
            if a <= lt < b:
                return b - lt
        return 0.0

    def next_available(self, client: int, t: float) -> float:
        """Earliest virtual time >= ``t`` at which the client is available
        (``t`` itself if available now; inf if never again)."""
        ws = self._win.get(client)
        if ws is None:
            return t if self.default else math.inf
        if not ws:                   # trace row with no active windows
            return math.inf
        lt = self._fold(t)
        for a, b in ws:
            if a <= lt < b:
                return t
        nxt = [a for a, _ in ws if a > lt]
        if nxt:
            return t + (nxt[0] - lt)
        if self.period is None:
            return math.inf
        return t + (self.period - lt) + ws[0][0]

    def fits(self, client: int, t: float, duration: float) -> bool:
        """True when the client is available at ``t`` AND stays available
        for the next ``duration`` seconds — the window-fit selection test
        (DESIGN.md §12): a client whose window closes mid-span would land a
        dispatch-time skip or a lost upload, so the control plane filters
        it at selection instead."""
        return self.available(client, t) and self.remaining(client, t) >= duration

    # -- constructors ------------------------------------------------------
    @classmethod
    def always(cls) -> "ClientAvailability":
        return cls({}, period=None, default=True)

    @classmethod
    def diurnal(cls, n_clients: int, period_s: float = 86_400.0,
                duty_mean: float = 0.6, duty_jitter: float = 0.15,
                seed: int = 0) -> "ClientAvailability":
        """Seeded synthetic diurnal churn (``data/traces.py`` generator)."""
        from repro_torch.data.traces import synthesize_behavior_trace
        return cls.from_trace(synthesize_behavior_trace(
            n_clients, seed=seed, period_s=period_s, duty_mean=duty_mean,
            duty_jitter=duty_jitter))

    @classmethod
    def from_trace(cls, rows: Sequence[Any],
                   default: bool = True) -> "ClientAvailability":
        """FedScale-style behavior rows (``data/traces.py: BehaviorRow`` or
        equivalent dicts).  All rows must share one ``period_s`` (or none)."""
        windows: Dict[int, Sequence[Tuple[float, float]]] = {}
        periods = set()
        for r in rows:
            get = r.get if isinstance(r, dict) else lambda k, _r=r: getattr(_r, k)
            windows[int(get("client_id"))] = list(get("active"))
            periods.add(get("period_s"))
        if len(periods) > 1:
            raise ValueError(f"behavior trace mixes periods: {periods}")
        period = periods.pop() if periods else None
        return cls(windows, period=period, default=default)

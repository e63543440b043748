"""FedScale-style client traces: load, save, and deterministic synthesis.
Port of ``repro/data/traces.py`` (numpy only: the same seed draws the
same rows in both packages, and a file saved by one loads in the other).

Two trace families drive the network/availability simulation
(``core/network.py``, DESIGN.md §9), mirroring the FedScale benchmark's
device traces (arXiv:2105.11367):

``capacity``
    Per-client link capability: uplink/downlink bandwidth (kbps, the
    FedScale unit) and last-mile latency (ms).  One row per client.

``behavior``
    Per-client availability: a list of ``(start_s, end_s)`` *active*
    windows, optionally repeating with ``period_s`` (diurnal traces use a
    24 h period).  A client is reachable only inside an active window.

Rows are plain dataclasses; loaders accept JSON (a list of row dicts) and
CSV (a header row naming the fields), so real FedScale dumps can be
converted with a one-line script.  The synthesizers generate rows
deterministically from a seed — same seed, same trace, same simulated
schedule — which is what the seeded-determinism tests pin down.
"""
from __future__ import annotations

import csv
import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class CapacityRow:
    """One client's link capability (FedScale device_capacity units)."""
    client_id: int
    uplink_kbps: float
    downlink_kbps: float
    latency_ms: float


@dataclass(frozen=True)
class BehaviorRow:
    """One client's availability: active windows within one period (or on
    an absolute axis when ``period_s`` is None)."""
    client_id: int
    active: Tuple[Tuple[float, float], ...]
    period_s: Optional[float] = None


# ---------------------------------------------------------------------------
# deterministic synthesis
# ---------------------------------------------------------------------------

def synthesize_capacity_trace(
        n_clients: int, seed: int = 0, dist: str = "lognormal",
        median_uplink_kbps: float = 12_000.0, sigma: float = 1.0,
        down_up_ratio: float = 5.0,
        latency_ms_range: Tuple[float, float] = (20.0, 120.0)
) -> List[CapacityRow]:
    """Sample per-client link rows from a seeded distribution.

    ``lognormal`` matches the measured FedScale/MobiPerf bandwidth shape
    (median ``median_uplink_kbps``, log-σ ``sigma``); ``uniform`` draws
    uplinks from ``[0.5, 1.5] × median`` (the benchmark's control cell).
    Downlink is ``down_up_ratio ×`` uplink (asymmetric consumer links);
    latency is uniform over ``latency_ms_range``.
    """
    rng = np.random.default_rng(seed)
    if dist == "lognormal":
        up = median_uplink_kbps * np.exp(
            sigma * rng.standard_normal(n_clients))
    elif dist == "uniform":
        up = rng.uniform(0.5 * median_uplink_kbps,
                         1.5 * median_uplink_kbps, size=n_clients)
    else:
        raise ValueError(f"unknown capacity dist {dist!r}")
    lat = rng.uniform(*latency_ms_range, size=n_clients)
    return [CapacityRow(client_id=c,
                        uplink_kbps=float(up[c]),
                        downlink_kbps=float(up[c] * down_up_ratio),
                        latency_ms=float(lat[c]))
            for c in range(n_clients)]


def synthesize_behavior_trace(
        n_clients: int, seed: int = 0, period_s: float = 86_400.0,
        duty_mean: float = 0.6, duty_jitter: float = 0.15
) -> List[BehaviorRow]:
    """Diurnal availability: each client is active for one contiguous
    window of ``duty × period`` seconds per period, phase-shifted uniformly
    (a window crossing the period boundary splits into two).  ``duty`` is
    clipped to [0.05, 0.95] so no client is always-on or always-off."""
    rng = np.random.default_rng(seed)
    rows: List[BehaviorRow] = []
    for c in range(n_clients):
        duty = float(np.clip(duty_mean + duty_jitter * rng.standard_normal(),
                             0.05, 0.95))
        start = float(rng.uniform(0.0, period_s))
        end = start + duty * period_s
        if end <= period_s:
            active: Tuple[Tuple[float, float], ...] = ((start, end),)
        else:
            active = ((0.0, end - period_s), (start, period_s))
        rows.append(BehaviorRow(client_id=c, active=active,
                                period_s=period_s))
    return rows


# ---------------------------------------------------------------------------
# load / save
# ---------------------------------------------------------------------------

_CAP_FIELDS = ("client_id", "uplink_kbps", "downlink_kbps", "latency_ms")


def _cap_from_dict(d: Dict) -> CapacityRow:
    return CapacityRow(client_id=int(d["client_id"]),
                       uplink_kbps=float(d["uplink_kbps"]),
                       downlink_kbps=float(d["downlink_kbps"]),
                       latency_ms=float(d["latency_ms"]))


def _beh_from_dict(d: Dict) -> BehaviorRow:
    period = d.get("period_s")
    return BehaviorRow(
        client_id=int(d["client_id"]),
        active=tuple((float(a), float(b)) for a, b in d["active"]),
        period_s=None if period is None else float(period))


def load_capacity_trace(path: str) -> List[CapacityRow]:
    """JSON (list of row dicts) or CSV (header = field names) by suffix."""
    if path.endswith(".csv"):
        with open(path, newline="") as f:
            return [_cap_from_dict(row) for row in csv.DictReader(f)]
    with open(path) as f:
        return [_cap_from_dict(row) for row in json.load(f)]


def load_behavior_trace(path: str) -> List[BehaviorRow]:
    """JSON only (windows don't flatten into CSV cells cleanly)."""
    with open(path) as f:
        return [_beh_from_dict(row) for row in json.load(f)]


def save_capacity_trace(path: str, rows: Sequence[CapacityRow]) -> None:
    if path.endswith(".csv"):
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=_CAP_FIELDS)
            w.writeheader()
            for r in rows:
                w.writerow(asdict(r))
        return
    with open(path, "w") as f:
        json.dump([asdict(r) for r in rows], f, indent=2)
        f.write("\n")


def save_behavior_trace(path: str, rows: Sequence[BehaviorRow]) -> None:
    with open(path, "w") as f:
        json.dump([asdict(r) for r in rows], f, indent=2)
        f.write("\n")

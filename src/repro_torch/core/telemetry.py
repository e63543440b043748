"""Virtual-time telemetry: span tracer + metrics registry (DESIGN.md §13).
Port of ``repro/core/telemetry.py`` (host data only): every span, instant
and registry value equals the JAX package's on the same run, ``host/``
aside.

The simulator's virtual clock makes every scheduling claim in the paper an
*observable*: when each executor computed, waited and shipped is a pure
function of the run.  This module turns that event stream into a
measurement instrument:

* :class:`Tracer` — append-only spans and instants on named lanes
  (``exec:{k}`` compute, ``exec:{k}:up`` uploads, ``server`` folds/commits,
  ``rounds`` one span per round, ``control`` controller moves, ``faults``
  planned windows), all on the VIRTUAL axis.  ``export(path)`` writes
  Chrome-trace / Perfetto JSON so a heterogeneous round renders as an
  executor-lane timeline; :func:`validate_trace` checks the documented
  schema (finite non-negative times, spans nest within a lane).

* :class:`MetricsRegistry` — typed counters / gauges / histograms with a
  stable naming scheme.  ``ingest_extra`` absorbs the engines' ad-hoc
  ``RoundMetrics.extra`` keys through :data:`EXTRA_SCHEMA` (cumulative
  counters under ``total/``, per-round gauges under ``round/``), with
  ``extra_last`` / ``extra_total`` as compatibility accessors.  The
  ``host/`` namespace carries host-side cost attribution (wall seconds,
  and the first-seen block shapes ``client_step.compile_events`` counts
  where the JAX package counts jit compiles) and is explicitly
  process-local: it is the only namespace excluded from the
  determinism and resume guarantees below.

* :class:`Telemetry` — the bundle a
  :class:`~repro_torch.core.round.ParrotServer` owns (``telemetry=``).
  ``on_round`` runs at each round commit: it ingests the round's extra,
  derives per-executor **utilization** (busy/comm/idle fractions of the
  round window — the paper's "computing utility" metric) from the spans,
  and appends the round span.

Zero-overhead off: ``telemetry=None`` (the default) is consulted nowhere —
every engine stays bit-exact (params AND makespans), following the
``network=None`` / ``faults=None`` / ``control=None`` pattern.  When ON,
emission only *reads* already-computed values (no timer calls, no RNG, no
device ops), so enabling the tracer is bit-exact too.  Tracer and registry
state are plain data and ride the checkpoint blob (key ``"telemetry"``),
so ``auto_resume`` reproduces the uninterrupted run's trace exactly.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: RoundMetrics.extra key -> (kind, doc).  ``counter`` keys accumulate
#: across rounds under ``total/<key>``; ``gauge`` keys keep the round's
#: value under ``round/<key>``.  Nested ``state_manager`` stats flatten to
#: ``state_manager/<key>`` (``*_bytes`` are tier-size gauges, the rest
#: per-round deltas -> counters).  Unknown keys default to counter.
EXTRA_SCHEMA: Dict[str, Tuple[str, str]] = {
    # scheduling / BSP
    "backup_tasks": ("counter", "speculative backup duplicates planned"),
    "remapped_tasks": ("counter", "overlapped-schedule tasks re-homed"),
    "idle_time": ("counter", "virtual seconds fast-forwarded (gaps)"),
    # comm (netsim)
    "comm_time_up": ("counter", "accounted upload seconds"),
    "comm_time_down": ("counter", "accounted download seconds"),
    "comm_wire_bytes": ("counter", "achieved wire bytes uploaded"),
    "dropped_clients": ("counter", "clients lost to availability/faults"),
    # faults
    "retries": ("counter", "client re-runs / upload re-sends"),
    "corrupt_payloads": ("counter", "partials discarded as corrupt"),
    "fault_crashes": ("counter", "executor crashes fired"),
    "fault_restarts": ("counter", "executor restarts fired"),
    "chunk_timeouts": ("counter", "upload attempts that timed out"),
    "quorum_commits": ("counter", "rounds committed degraded at quorum"),
    # semi-sync
    "landed_clients": ("counter", "clients folded before the deadline"),
    "carried_tasks": ("gauge", "carry-pool size at round end"),
    "deadline": ("gauge", "the round's virtual-time deadline"),
    "deadline_frac": ("gauge", "deadline fraction in force"),
    # async
    "steals": ("counter", "work-steal events"),
    "stale_folds": ("counter", "folds with staleness > 0"),
    "mean_staleness": ("gauge", "window mean staleness"),
    "in_system": ("gauge", "clients in flight after the commit"),
    "staleness_lambda": ("gauge", "λ the window folded with"),
    # control plane
    "oracle_makespan": ("gauge", "hindsight-optimal LPT makespan"),
    "rebalanced_tasks": ("counter", "tasks moved by rebalance/steal"),
}


def _extra_kind(key: str) -> str:
    if key.startswith("state_manager/"):
        return "gauge" if key.endswith("_bytes") else "counter"
    return EXTRA_SCHEMA.get(key, ("counter", ""))[0]


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotone cumulative value."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def inc(self, v: float = 1.0) -> None:
        self.value += float(v)


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def set(self, v: float) -> None:
        self.value = float(v)


#: default histogram bucket upper bounds (last bucket is +inf)
DEFAULT_BOUNDS: Tuple[float, ...] = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0)


class Histogram:
    """Fixed-bucket histogram with count/total/min/max."""

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, bounds: Iterable[float] = DEFAULT_BOUNDS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def state_dict(self) -> Dict[str, Any]:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "total": self.total,
                "min": self.vmin, "max": self.vmax}

    @classmethod
    def from_state_dict(cls, st: Dict[str, Any]) -> "Histogram":
        h = cls(st["bounds"])
        h.counts = list(st["counts"])
        h.count = int(st["count"])
        h.total = float(st["total"])
        h.vmin = st["min"]
        h.vmax = st["max"]
        return h


class MetricsRegistry:
    """Typed named metrics.  Names are slash-namespaced:

    ``total/<key>``   cumulative counters absorbed from RoundMetrics.extra
    ``round/<key>``   the last round's gauge values from extra
    ``round/*``       core per-round gauges (makespan, n_clients, ...)
    ``util/exec<k>/*``  busy/comm/idle fractions of the last round window
    ``hist/*``        histograms (async staleness, queue depth, upload delay)
    ``control/<name>``  last controller outputs (ControlPlane.note)
    ``host/*``        host-side cost attribution — PROCESS-LOCAL (wall
                      seconds, first-seen shapes); excluded from determinism /
                      resume equality guarantees
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self.last_extra: Dict[str, Any] = {}

    # -- accessors ---------------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  bounds: Optional[Iterable[float]] = None) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(bounds or DEFAULT_BOUNDS)
        return h

    def value(self, name: str) -> Optional[float]:
        """The metric's scalar value (histograms report their mean)."""
        if name in self._counters:
            return self._counters[name].value
        if name in self._gauges:
            return self._gauges[name].value
        if name in self._hists:
            return self._hists[name].mean
        return None

    # -- the extra[...] compatibility layer --------------------------------
    def ingest_extra(self, extra: Dict[str, Any]) -> None:
        """Absorb one round's ``RoundMetrics.extra`` through
        :data:`EXTRA_SCHEMA`: numeric values route to ``total/`` counters
        or ``round/`` gauges by declared kind; the nested ``state_manager``
        dict flattens with a ``/``."""
        self.last_extra = dict(extra)
        flat: List[Tuple[str, Any]] = []
        for key, val in extra.items():
            if isinstance(val, dict):
                flat.extend((f"{key}/{k}", v) for k, v in val.items())
            else:
                flat.append((key, val))
        for key, val in flat:
            if not isinstance(val, (int, float)) or isinstance(val, bool):
                continue
            v = float(val)
            if _extra_kind(key) == "gauge":
                self.gauge(f"round/{key}").set(v)
            elif math.isfinite(v):
                self.counter(f"total/{key}").inc(v)

    def extra_last(self, key: str, default: float = 0.0) -> float:
        """The last round's value of an extra key (compat accessor)."""
        v = self.last_extra.get(key, default)
        return float(v) if isinstance(v, (int, float)) else default

    def extra_total(self, key: str, default: float = 0.0) -> float:
        """Cumulative total of a counter-kind extra key (compat accessor)."""
        c = self._counters.get(f"total/{key}")
        return c.value if c is not None else default

    # -- snapshots / checkpointing -----------------------------------------
    def snapshot(self, exclude: Tuple[str, ...] = ()) -> Dict[str, Any]:
        """Plain-data view; ``exclude`` drops name prefixes (the resume /
        determinism tests compare snapshots with ``("host/",)``)."""

        def keep(name: str) -> bool:
            return not any(name.startswith(p) for p in exclude)

        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())
                         if keep(n)},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())
                       if keep(n)},
            "histograms": {n: h.state_dict()
                           for n, h in sorted(self._hists.items())
                           if keep(n)},
        }

    def state_dict(self) -> Dict[str, Any]:
        st = self.snapshot()
        st["last_extra"] = dict(self.last_extra)
        return st

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        if not state:
            return
        self._counters = {n: Counter(v)
                          for n, v in state.get("counters", {}).items()}
        self._gauges = {n: Gauge(v)
                        for n, v in state.get("gauges", {}).items()}
        self._hists = {n: Histogram.from_state_dict(h)
                       for n, h in state.get("histograms", {}).items()}
        self.last_extra = dict(state.get("last_extra", {}))


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

class Tracer:
    """Append-only virtual-time spans and instants on named lanes.

    A span is ``(lane, name, t0, t1, cat, args)``; an instant is
    ``(lane, name, t, cat, args)``.  Lanes:

    ``exec:{k}``     one ``cat="busy"`` span per chunk, covering the
                     executor's whole occupancy (download/wait + compute);
                     ``args["down_s"]`` is the non-compute share.  Crash /
                     restart / steal / failure instants ride here too.
    ``exec:{k}:up``  ``cat="comm"`` upload spans (may overlap each other —
                     uploads overlap the next chunk by design), with
                     ``wire_bytes`` and ``billed_bytes`` (retries re-bill).
    ``server``       fold / commit / rebalance instants.
    ``rounds``       one ``cat="server"`` span per committed round.
    ``control``      controller-move instants (ControlPlane.note).
    ``faults``       the plan's blackout/slowdown/dropout windows as
                     ``cat="fault"`` spans (emitted once at attach time).

    All times are virtual seconds on the server's absolute axis.  Emission
    is pure recording — callers pass values they already computed.
    """

    def __init__(self):
        self.spans: List[Tuple[str, str, float, float, str,
                               Optional[Dict[str, Any]]]] = []
        self.instants: List[Tuple[str, str, float, str,
                                  Optional[Dict[str, Any]]]] = []

    def span(self, lane: str, name: str, t0: float, t1: float,
             cat: str = "busy",
             args: Optional[Dict[str, Any]] = None) -> None:
        self.spans.append((lane, name, float(t0), float(t1), cat, args))

    def instant(self, lane: str, name: str, t: float, cat: str = "mark",
                args: Optional[Dict[str, Any]] = None) -> None:
        self.instants.append((lane, name, float(t), cat, args))

    def lanes(self) -> List[str]:
        seen: Dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s[0])
        for i in self.instants:
            seen.setdefault(i[0])
        return sorted(seen)

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome-trace / Perfetto JSON object.  Virtual seconds map to
        microseconds; every lane is a named thread of pid 0.  Up-lanes
        export as async ``b``/``e`` pairs (their spans legitimately
        overlap); every other lane as complete ``X`` events."""
        tids = {lane: i for i, lane in enumerate(self.lanes())}
        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
             "args": {"name": lane}} for lane, tid in tids.items()]
        aid = 0
        for lane, name, t0, t1, cat, args in self.spans:
            base = {"name": name, "cat": cat, "pid": 0, "tid": tids[lane],
                    "args": dict(args) if args else {}}
            if lane.endswith(":up"):
                aid += 1
                events.append({**base, "ph": "b", "id": aid,
                               "ts": t0 * 1e6})
                events.append({"ph": "e", "id": aid, "name": name,
                               "cat": cat, "pid": 0, "tid": tids[lane],
                               "ts": t1 * 1e6})
            else:
                events.append({**base, "ph": "X", "ts": t0 * 1e6,
                               "dur": (t1 - t0) * 1e6})
        for lane, name, t, cat, args in self.instants:
            events.append({"ph": "i", "s": "t", "name": name, "cat": cat,
                           "pid": 0, "tid": tids[lane], "ts": t * 1e6,
                           "args": dict(args) if args else {}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")
        return path

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"spans": [list(s) for s in self.spans],
                "instants": [list(i) for i in self.instants]}

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        if not state:
            return
        self.spans = [tuple(s) for s in state.get("spans", [])]
        self.instants = [tuple(i) for i in state.get("instants", [])]


def _spans_from(src: Any) -> Tuple[List[Tuple], List[Tuple]]:
    """(spans, instants) from a Tracer, a tracer state_dict, a Chrome-trace
    dict, or a path to an exported trace file."""
    if isinstance(src, Tracer):
        return list(src.spans), list(src.instants)
    if isinstance(src, str):
        with open(src) as f:
            src = json.load(f)
    if not isinstance(src, dict):
        raise TypeError(f"cannot validate {type(src).__name__}")
    if "traceEvents" in src:
        lanes: Dict[int, str] = {}
        for ev in src["traceEvents"]:
            if ev.get("ph") == "M" and ev.get("name") == "thread_name":
                lanes[ev["tid"]] = ev["args"]["name"]
        spans, instants, open_async = [], [], {}
        for ev in src["traceEvents"]:
            lane = lanes.get(ev.get("tid"), f"tid{ev.get('tid')}")
            if ev.get("ph") == "X":
                t0 = ev["ts"] / 1e6
                spans.append((lane, ev["name"], t0,
                              t0 + ev["dur"] / 1e6, ev.get("cat", ""),
                              ev.get("args")))
            elif ev.get("ph") == "b":
                open_async[ev["id"]] = ev
            elif ev.get("ph") == "e":
                b = open_async.pop(ev["id"], None)
                if b is not None:
                    spans.append((lane, b["name"], b["ts"] / 1e6,
                                  ev["ts"] / 1e6, b.get("cat", ""),
                                  b.get("args")))
            elif ev.get("ph") == "i":
                instants.append((lane, ev["name"], ev["ts"] / 1e6,
                                 ev.get("cat", ""), ev.get("args")))
        for b in open_async.values():   # unmatched begin: surfaced as a span
            spans.append((lanes.get(b.get("tid"), "?"), b["name"],
                          b["ts"] / 1e6, float("nan"), b.get("cat", ""),
                          b.get("args")))
        return spans, instants
    return ([tuple(s) for s in src.get("spans", [])],
            [tuple(i) for i in src.get("instants", [])])


def validate_trace(src: Any) -> List[str]:
    """Schema check (DESIGN.md §13).  Returns a list of problems (empty =
    valid): every time finite and non-negative, spans end at or after they
    start, and within each lane the ``busy``/``server`` spans are disjoint
    or properly nested (uploads are exempt: they overlap by design).
    Accepts a :class:`Tracer`, its ``state_dict()``, a Chrome-trace dict,
    or a path to an exported file."""
    spans, instants = _spans_from(src)
    problems: List[str] = []
    for lane, name, t0, t1, cat, args in spans:
        if not (math.isfinite(t0) and math.isfinite(t1)):
            problems.append(f"span {lane}/{name}: non-finite time "
                            f"[{t0}, {t1}]")
        elif t0 < 0.0:
            problems.append(f"span {lane}/{name}: negative start {t0}")
        elif t1 < t0:
            problems.append(f"span {lane}/{name}: ends before it starts "
                            f"[{t0}, {t1}]")
        if args and float(args.get("wire_bytes", 0)) < 0:
            problems.append(f"span {lane}/{name}: negative wire_bytes")
    for lane, name, t, cat, args in instants:
        if not math.isfinite(t) or t < 0.0:
            problems.append(f"instant {lane}/{name}: bad time {t}")
    by_lane: Dict[str, List[Tuple[float, float, str]]] = {}
    for lane, name, t0, t1, cat, args in spans:
        if cat in ("busy", "server") and math.isfinite(t0) \
                and math.isfinite(t1) and t1 >= t0:
            by_lane.setdefault(lane, []).append((t0, t1, name))
    for lane, ss in by_lane.items():
        stack: List[Tuple[float, float, str]] = []
        for t0, t1, name in sorted(ss, key=lambda s: (s[0], -s[1])):
            while stack:
                tol = 1e-9 * (1.0 + abs(stack[-1][1]))
                if t0 >= stack[-1][1] - tol:
                    stack.pop()
                else:
                    break
            if stack:
                tol = 1e-9 * (1.0 + abs(stack[-1][1]))
                if t1 > stack[-1][1] + tol:
                    problems.append(
                        f"lane {lane}: span {name} [{t0}, {t1}] overlaps "
                        f"{stack[-1][2]} [.., {stack[-1][1]}] without "
                        f"nesting")
            stack.append((t0, t1, name))
    return problems


# ---------------------------------------------------------------------------
# the server-side bundle
# ---------------------------------------------------------------------------

class Telemetry:
    """Tracer + registry + the round-commit hook the server drives.

    Attach with ``ParrotServer(telemetry=Telemetry())`` (or
    ``telemetry=True``).  The server wires the same object into the fault
    injector and control plane so their events land on the shared lanes.
    """

    def __init__(self, tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.tracer = tracer or Tracer()
        self.registry = registry or MetricsRegistry()
        # compile-count anchor for host/ attribution (process-local;
        # client_step counts first-seen block shapes)
        from repro_torch.core import client_step
        self._compiles_seen = client_step.compile_events()

    # -- emission hooks ----------------------------------------------------
    def control_event(self, name: str, value: float, t: float) -> None:
        """One controller move (``ControlPlane.note``): an instant on the
        ``control`` lane plus a ``control/<name>`` gauge."""
        self.tracer.instant("control", name, t, cat="control",
                            args={"value": float(value)})
        self.registry.gauge(f"control/{name}").set(float(value))

    def trace_plan(self, plan: Any) -> None:
        """Pre-trace a fault plan's windowed events (blackout / slowdown /
        dropout) as spans on the ``faults`` lane — the one-shot events
        (crash, restart, corrupt) are emitted live when they fire."""
        plan = getattr(plan, "plan", plan)    # accept a FaultInjector
        if plan is None:
            return
        for ev in plan:
            if ev.kind == "blackout":
                self.tracer.span("faults", "blackout", ev.time, ev.end,
                                 cat="fault",
                                 args={"executor": (-1 if ev.executor is None
                                                    else ev.executor)})
            elif ev.kind == "slowdown":
                self.tracer.span("faults", "slowdown", ev.time, ev.end,
                                 cat="fault",
                                 args={"executor": ev.executor,
                                       "factor": ev.factor})
            elif ev.kind == "dropout":
                self.tracer.span("faults", "dropout", ev.time, ev.end,
                                 cat="fault", args={"client": ev.client})

    # -- utilization accounting --------------------------------------------
    def utilization(self, t0: float, t1: float,
                    executors: Iterable[int] = ()
                    ) -> Dict[int, Dict[str, float]]:
        """Per-executor busy/comm/idle fractions of the window ``[t0, t1]``
        derived from the spans: a busy span's compute share is its length
        minus ``args["down_s"]`` (download + in-span wait), up-lane spans
        count as comm, both clipped to the window; idle is the remainder.
        Fractions sum to 1 per executor (up to float rounding)."""
        W = t1 - t0
        busy: Dict[int, float] = {}
        comm: Dict[int, float] = {}
        execs = {int(k) for k in executors}
        for lane, name, s0, s1, cat, args in self.tracer.spans:
            if not lane.startswith("exec:"):
                continue
            rest = lane[5:]
            is_up = rest.endswith(":up")
            if is_up:
                rest = rest[:-3]
            try:
                k = int(rest)
            except ValueError:
                continue
            ov = min(s1, t1) - max(s0, t0)
            if ov <= 0.0:
                continue
            execs.add(k)
            if is_up:
                comm[k] = comm.get(k, 0.0) + ov
            elif cat == "busy":
                full = s1 - s0
                f = ov / full if full > 0.0 else 1.0
                d = float(args.get("down_s", 0.0)) if args else 0.0
                d = min(max(d, 0.0), full)
                comm[k] = comm.get(k, 0.0) + d * f
                busy[k] = busy.get(k, 0.0) + (full - d) * f
        out: Dict[int, Dict[str, float]] = {}
        for k in sorted(execs):
            if not (W > 0.0):
                out[k] = {"busy_frac": 0.0, "comm_frac": 0.0,
                          "idle_frac": 1.0}
                continue
            b = min(busy.get(k, 0.0) / W, 1.0)
            c = max(min(comm.get(k, 0.0) / W, 1.0 - b), 0.0)
            out[k] = {"busy_frac": b, "comm_frac": c,
                      "idle_frac": 1.0 - b - c}
        return out

    # -- the round-commit hook (ParrotServer._commit_metrics) --------------
    def on_round(self, srv: Any, metrics: Any, t0: float) -> None:
        """Ingest one committed round: extra -> registry, core gauges,
        host-side attribution, per-executor utilization (attached to
        ``metrics.extra["utilization"]`` BEFORE the metrics join history,
        so checkpointed history carries it too), and the round span."""
        reg = self.registry
        reg.ingest_extra(metrics.extra)
        t1 = t0 + metrics.makespan if math.isfinite(metrics.makespan) else t0
        reg.gauge("round/makespan").set(metrics.makespan)
        reg.gauge("round/n_clients").set(float(metrics.n_clients))
        reg.gauge("round/n_executors").set(float(metrics.n_executors))
        reg.counter("total/rounds").inc(1.0)
        reg.counter("total/virtual_time").inc(metrics.makespan)
        reg.counter("total/comm_bytes").inc(float(metrics.comm_bytes))
        reg.counter("total/failures").inc(float(metrics.failures))
        # host-side cost attribution (PROCESS-LOCAL: wall vs virtual time,
        # first-seen shapes) — never compared across runs or resumes
        reg.gauge("host/round_wall_s").set(metrics.wall_time)
        reg.counter("host/wall_s").inc(metrics.wall_time)
        from repro_torch.core import client_step
        c = client_step.compile_events()
        reg.counter("host/compiles").inc(float(c - self._compiles_seen))
        self._compiles_seen = c
        util = self.utilization(t0, t1, srv.executors)
        metrics.extra["utilization"] = util
        for k, u in util.items():
            reg.gauge(f"util/exec{k}/busy_frac").set(u["busy_frac"])
            reg.gauge(f"util/exec{k}/comm_frac").set(u["comm_frac"])
            reg.gauge(f"util/exec{k}/idle_frac").set(u["idle_frac"])
        self.tracer.span(
            "rounds", f"round {metrics.round}", t0, t1, cat="server",
            args={"round": metrics.round, "engine": srv.engine.mode,
                  "makespan": metrics.makespan,
                  "n_clients": metrics.n_clients})

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"tracer": self.tracer.state_dict(),
                "registry": self.registry.state_dict()}

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        if not state:
            return
        self.tracer.load_state_dict(state.get("tracer"))
        self.registry.load_state_dict(state.get("registry"))
        # host/ attribution re-anchors to THIS process's compile counter
        from repro_torch.core import client_step
        self._compiles_seen = client_step.compile_events()

"""Serve-stack observability: metrics, step-span tracing, snapshots
(counterpart of ``repro.serve.telemetry``, DESIGN.md §observability).

  * ``MetricsRegistry`` — counters, gauges and *mergeable* fixed-bucket
    streaming histograms, keyed by free-form labels (the serve stack
    uses ``lane`` and ``shard``; the shard is 0 on one device).
    Histograms share one log-spaced bucket grid, so registries of
    different lanes merge by bucket-count addition; percentiles are
    computed online from the buckets, not from stored samples.
  * ``StepTracer`` — a ring-buffered span recorder.  The runtime emits
    engine-step / admit / prefill-chunk / decode / handoff spans and
    compile / cancel / preempt / free / spill / rebalance instants with
    start/end stamps; ``export`` writes Chrome trace-event JSON (``pid``
    the lane, ``tid`` the shard) loadable in Perfetto.
  * ``Telemetry`` — the facade the serve stack passes around: one
    registry + one tracer + an ``enabled`` flag, periodic registry
    snapshots (``snapshot_every`` engine steps), JSON /
    Prometheus-text exposition (``write_metrics``), the Chrome trace
    (``write_trace``), and optional ``torch.profiler.record_function``
    ranges around the spans (``annotate=True``).

**The no-host-sync invariant**: telemetry must not change what the serve
stack computes.  All instrumentation is host-side Python at EXISTING step
boundaries — a span brackets a step call that the runtime was already
dispatching (and, where the runtime already reads the result back, that
existing sync); telemetry never synchronizes the device and never adds
device work, so token streams and kernel launches are identical with
telemetry on or off.  On the GPU a span therefore measures host-side
dispatch plus whatever syncs the runtime already performs.  When
disabled, every hook degenerates to one attribute check
(``Telemetry.enabled``) or a shared no-op span — no clocks are read,
nothing is allocated per event.
"""
from __future__ import annotations

import collections
import json
import pathlib
import time


# ---------------------------------------------------------------------------
# streaming histograms
# ---------------------------------------------------------------------------

def default_edges(lo: float = 1e-5, hi: float = 100.0,
                  per_decade: int = 4) -> tuple:
    """Log-spaced bucket upper bounds: ``per_decade`` buckets per decade
    from ``lo`` to >= ``hi`` (seconds).  Every histogram in a registry
    shares one grid so histograms merge by bucket addition."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad bucket grid lo={lo} hi={hi}/{per_decade}")
    factor = 10.0 ** (1.0 / per_decade)
    edges, e = [], lo
    while e < hi * factor:
        edges.append(e)
        e *= factor
    return tuple(edges)


class StreamingHistogram:
    """Fixed-bucket online histogram: O(#buckets) memory, mergeable.

    ``edges`` are bucket UPPER bounds; an implicit overflow bucket
    catches values above ``edges[-1]``.  Alongside the bucket counts it
    tracks count / sum / min / max exactly, so means are exact and
    percentile estimates are clamped to the observed range.
    """

    __slots__ = ("edges", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, edges=None):
        self.edges = tuple(edges) if edges is not None else default_edges()
        if list(self.edges) != sorted(self.edges) or len(self.edges) < 1:
            raise ValueError("edges must be non-empty and sorted")
        self.counts = [0] * (len(self.edges) + 1)      # + overflow
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def observe(self, value: float):
        v = float(value)
        lo, hi = 0, len(self.edges)                    # bisect over edges
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def merge(self, other: "StreamingHistogram"):
        """Add ``other``'s buckets into this histogram (same edge grid
        required — the point of fixed buckets)."""
        if self.edges != other.edges:
            raise ValueError("cannot merge histograms with different edges")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        for v in (other.vmin, other.vmax):
            if v is not None:
                self.vmin = v if self.vmin is None else min(self.vmin, v)
                self.vmax = v if self.vmax is None else max(self.vmax, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]) from the bucket
        counts: linear interpolation inside the holding bucket, clamped
        to the exact observed [min, max]."""
        if not 0 <= q <= 100:
            raise ValueError(f"q must be in [0, 100], got {q}")
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lower = self.edges[i - 1] if i > 0 else 0.0
                upper = (self.edges[i] if i < len(self.edges)
                         else self.vmax)
                frac = (rank - cum) / c
                est = lower + (upper - lower) * frac
                return min(max(est, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "buckets": [[e, c] for e, c
                            in zip(self.edges + ("+Inf",), self.counts)
                            if c]}


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Counters, gauges and streaming histograms keyed by (name, labels).

    Labels are free-form keyword arguments; the serve stack keys its
    metrics by ``lane`` and ``shard`` (DESIGN.md §observability lists
    every metric name).  All three families are mergeable across
    registries — counters/histograms add, gauges last-write-wins — so
    per-lane or per-process registries can be combined for exposition.
    """

    def __init__(self, edges=None):
        self.edges = tuple(edges) if edges is not None else default_edges()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}

    @staticmethod
    def _key(name: str, labels: dict):
        return (name, tuple(sorted(labels.items())))

    # -- write path --------------------------------------------------------
    def inc(self, name: str, n: int = 1, **labels):
        k = self._key(name, labels)
        self._counters[k] = self._counters.get(k, 0) + n

    def gauge(self, name: str, value: float, **labels):
        self._gauges[self._key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels):
        k = self._key(name, labels)
        h = self._hists.get(k)
        if h is None:
            h = self._hists[k] = StreamingHistogram(self.edges)
        h.observe(value)

    # -- read path ---------------------------------------------------------
    def value(self, name: str, default=0, **labels):
        """Counter or gauge value (counters win on a name clash)."""
        k = self._key(name, labels)
        if k in self._counters:
            return self._counters[k]
        return self._gauges.get(k, default)

    def hist(self, name: str, **labels) -> StreamingHistogram | None:
        return self._hists.get(self._key(name, labels))

    def merge(self, other: "MetricsRegistry"):
        for k, v in other._counters.items():
            self._counters[k] = self._counters.get(k, 0) + v
        self._gauges.update(other._gauges)
        for k, h in other._hists.items():
            mine = self._hists.get(k)
            if mine is None:
                mine = self._hists[k] = StreamingHistogram(h.edges)
            mine.merge(h)

    # -- exposition --------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable dump of every metric."""
        def rows(d, render):
            return [{"name": name, "labels": dict(labels),
                     **render(v)}
                    for (name, labels), v in sorted(d.items())]
        return {
            "counters": rows(self._counters, lambda v: {"value": v}),
            "gauges": rows(self._gauges, lambda v: {"value": v}),
            "histograms": rows(self._hists, lambda h: h.snapshot()),
        }

    def to_prometheus(self, prefix: str = "repro_") -> str:
        """Prometheus text exposition (counters, gauges, histograms with
        cumulative ``_bucket{le=...}`` series)."""
        def fmt_labels(labels, extra=()):
            items = [*sorted(labels.items()), *extra]
            if not items:
                return ""
            return ("{" + ",".join(f'{k}="{v}"' for k, v in items) + "}")

        out, seen_type = [], set()

        def typeline(name, kind):
            if name not in seen_type:
                seen_type.add(name)
                out.append(f"# TYPE {prefix}{name} {kind}")

        for (name, labels), v in sorted(self._counters.items()):
            typeline(name, "counter")
            out.append(f"{prefix}{name}{fmt_labels(dict(labels))} {v}")
        for (name, labels), v in sorted(self._gauges.items()):
            typeline(name, "gauge")
            out.append(f"{prefix}{name}{fmt_labels(dict(labels))} {v}")
        for (name, labels), h in sorted(self._hists.items()):
            typeline(name, "histogram")
            lb = dict(labels)
            cum = 0
            for e, c in zip(h.edges + ("+Inf",), h.counts):
                cum += c
                out.append(f"{prefix}{name}_bucket"
                           f"{fmt_labels(lb, (('le', e),))} {cum}")
            out.append(f"{prefix}{name}_sum{fmt_labels(lb)} {h.total}")
            out.append(f"{prefix}{name}_count{fmt_labels(lb)} {h.count}")
        return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# step-span tracer
# ---------------------------------------------------------------------------

class StepTracer:
    """Ring-buffered span recorder exporting Chrome trace-event JSON.

    Events are stored as tuples in a bounded deque (oldest dropped
    first, ``dropped`` counts evictions), timestamps in microseconds
    since the tracer's construction (``perf_counter`` based — monotonic,
    sub-µs resolution).  In the exported trace the ``pid`` is the
    serving lane and the ``tid`` the data shard, so Perfetto renders one
    process track per lane with per-shard rows.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._pid_names: dict = {}

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def process_name(self, pid: int, name: str):
        """Label a pid (= serving lane) track in the exported trace."""
        self._pid_names[pid] = name

    def _push(self, ev: tuple):
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 pid: int = 0, tid: int = 0, args: dict | None = None):
        """Record a complete ('X') span with explicit start/duration."""
        self._push(("X", name, ts_us, dur_us, pid, tid, args))

    def instant(self, name: str, *, pid: int = 0, tid: int = 0,
                args: dict | None = None):
        self._push(("i", name, self.now_us(), None, pid, tid, args))

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": label}}
                  for pid, label in sorted(self._pid_names.items())]
        for ph, name, ts, dur, pid, tid, args in self.events:
            ev = {"ph": ph, "name": name, "ts": ts, "pid": pid, "tid": tid,
                  "cat": "serve"}
            if ph == "X":
                ev["dur"] = dur
            else:
                ev["s"] = "t"                      # thread-scoped instant
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


# ---------------------------------------------------------------------------
# the facade the serve stack passes around
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op span: the disabled path's only per-event cost."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one traced span: start/end stamps into
    the tracer, optionally the duration into a registry histogram and a
    ``torch.profiler.record_function`` range around the body."""

    __slots__ = ("tele", "name", "lane", "shard", "metric", "args",
                 "_t0", "_ann")

    def __init__(self, tele, name, lane, shard, metric, args):
        self.tele = tele
        self.name = name
        self.lane = lane
        self.shard = shard
        self.metric = metric
        self.args = args or None
        self._ann = None

    def __enter__(self):
        if self.tele.annotate:
            self._ann = _trace_annotation(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tracer = self.tele.tracer
        tracer.complete(self.name, (self._t0 - tracer._t0) * 1e6,
                        (t1 - self._t0) * 1e6, pid=self.lane,
                        tid=self.shard, args=self.args)
        if self.metric is not None:
            self.tele.registry.observe(self.metric, t1 - self._t0,
                                       lane=self.lane, shard=self.shard)
        return False


def _trace_annotation(name: str):
    """A ``torch.profiler.record_function`` range, visible in
    ``torch.profiler`` traces."""
    import torch
    return torch.profiler.record_function(name)


class Telemetry:
    """Serve-wide telemetry handle: registry + tracer + snapshot policy.

    enabled: master switch — when False every hook is a no-op (no
    clocks read, nothing recorded; the no-host-sync invariant's
    "zero overhead when disabled" leg).  snapshot_every: take a registry
    snapshot every K engine steps via ``maybe_snapshot`` (0 = final
    only).  annotate: additionally wrap spans in
    ``torch.profiler.record_function`` so they show up in torch profiler
    timelines.  trace_capacity: ring-buffer size of the tracer.
    """

    def __init__(self, *, enabled: bool = True, snapshot_every: int = 0,
                 annotate: bool = False, trace_capacity: int = 65536,
                 registry: MetricsRegistry | None = None,
                 tracer: StepTracer | None = None):
        self.enabled = enabled
        self.snapshot_every = snapshot_every
        self.annotate = annotate
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = (tracer if tracer is not None
                       else StepTracer(capacity=trace_capacity))
        self.snapshots: list = []

    # -- hooks (all no-ops when disabled) ----------------------------------
    def span(self, name: str, *, lane: int = 0, shard: int = 0,
             metric: str | None = None, **args):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, lane, shard, metric, args)

    def instant(self, name: str, *, lane: int = 0, shard: int = 0, **args):
        if self.enabled:
            self.tracer.instant(name, pid=lane, tid=shard,
                                args=args or None)

    def inc(self, name: str, n: int = 1, **labels):
        if self.enabled:
            self.registry.inc(name, n, **labels)

    def observe(self, name: str, value: float, **labels):
        if self.enabled:
            self.registry.observe(name, value, **labels)

    def gauge(self, name: str, value: float, **labels):
        if self.enabled:
            self.registry.gauge(name, value, **labels)

    # -- snapshots / exposition -------------------------------------------
    def take_snapshot(self, step: int | None = None):
        if self.enabled:
            self.snapshots.append({"step": step,
                                   "t_us": self.tracer.now_us(),
                                   **self.registry.snapshot()})

    def maybe_snapshot(self, step: int):
        """Periodic snapshot hook for serve loops: records every
        ``snapshot_every`` engine steps (disabled when 0)."""
        if (self.enabled and self.snapshot_every > 0
                and step % self.snapshot_every == 0):
            self.take_snapshot(step)

    def metrics_json(self) -> dict:
        return {"snapshots": self.snapshots,
                "final": self.registry.snapshot()}

    def write_metrics(self, path) -> pathlib.Path:
        """Write the JSON metrics dump to ``path`` and a Prometheus text
        dump next to it (same stem, ``.prom`` suffix).  Returns the
        Prometheus path."""
        p = pathlib.Path(path)
        with open(p, "w") as f:
            json.dump(self.metrics_json(), f, indent=1)
        prom = p.with_suffix(".prom")
        prom.write_text(self.registry.to_prometheus())
        return prom

    def write_trace(self, path):
        self.tracer.export(path)


NULL_TELEMETRY = Telemetry(enabled=False)

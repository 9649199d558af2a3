"""Serve-stack observability: metrics and step-span tracing.

Host-side copy of the part of ``repro.serve.telemetry`` (DESIGN.md
§observability) that the runtime and scheduler write and the serve loop's
callers read; the optional trace annotation is
``torch.profiler.record_function`` here:

  * ``MetricsRegistry`` — counters, gauges and fixed-bucket streaming
    histograms, keyed by free-form labels.  Percentiles are computed
    online from the buckets, not from stored samples.
  * ``StepTracer`` — a ring-buffered span recorder.  The runtime emits
    engine-step / prefill-chunk / decode spans with start/end stamps and
    compile instants into ``events``.
  * ``Telemetry`` — the facade the serve stack passes around: one
    registry + one tracer + an ``enabled`` flag, and optional
    ``torch.profiler`` annotations around the spans (``annotate=True``).

The reference's exporters (histogram and registry merge, Prometheus text,
Chrome-trace JSON, periodic snapshots) and its lane/shard span labels
port with the telemetry CLI flags and the lanes (ROADMAP §1 items 8, 10).

**The no-host-sync invariant**: telemetry must not change what the serve
stack computes.  All instrumentation is host-side Python at EXISTING step
boundaries — a span brackets a step call that the runtime was already
dispatching (and, where the runtime already reads the result back, that
existing sync); telemetry never synchronizes the device and never adds
device work, so token streams are identical with telemetry on or off.
On the GPU a span therefore measures host-side dispatch plus whatever
syncs the runtime already performs.  When disabled, every hook
degenerates to one attribute check
(``Telemetry.enabled``) or a shared no-op span — no clocks are read,
nothing is allocated per event.
"""
from __future__ import annotations

import collections
import time


# ---------------------------------------------------------------------------
# streaming histograms
# ---------------------------------------------------------------------------

def default_edges(lo: float = 1e-5, hi: float = 100.0,
                  per_decade: int = 4) -> tuple:
    """Log-spaced bucket upper bounds: ``per_decade`` buckets per decade
    from ``lo`` to >= ``hi`` (seconds)."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad bucket grid lo={lo} hi={hi}/{per_decade}")
    factor = 10.0 ** (1.0 / per_decade)
    edges, e = [], lo
    while e < hi * factor:
        edges.append(e)
        e *= factor
    return tuple(edges)


class StreamingHistogram:
    """Fixed-bucket online histogram: O(#buckets) memory.

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


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Counters, gauges and streaming histograms keyed by (name, labels).

    Labels are free-form keyword arguments (DESIGN.md §observability
    lists every metric name)."""

    def __init__(self):
        self.edges = default_edges()
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


# ---------------------------------------------------------------------------
# step-span tracer
# ---------------------------------------------------------------------------

class StepTracer:
    """Ring-buffered span recorder.

    Events are tuples ``(ph, name, ts_us, dur_us, args)`` in a bounded
    deque (oldest dropped first, ``dropped`` counts evictions): ``ph`` is
    "X" for a complete span and "i" for an instant, timestamps in
    microseconds since the tracer's construction (``perf_counter`` based —
    monotonic, sub-µs resolution).
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._t0 = time.perf_counter()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _push(self, ev: tuple):
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 args: dict | None = None):
        """Record a complete ('X') span with explicit start/duration."""
        self._push(("X", name, ts_us, dur_us, args))

    def instant(self, name: str, *, args: dict | None = None):
        self._push(("i", name, self.now_us(), None, args))


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
    ``torch.profiler`` annotation around the body."""

    __slots__ = ("tele", "name", "metric", "args", "_t0", "_ann")

    def __init__(self, tele, name, metric, args):
        self.tele = tele
        self.name = name
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
                        (t1 - self._t0) * 1e6, args=self.args)
        if self.metric is not None:
            self.tele.registry.observe(self.metric, t1 - self._t0)
        return False


def _trace_annotation(name: str):
    """A ``torch.profiler.record_function`` range, visible in
    ``torch.profiler`` traces."""
    import torch
    return torch.profiler.record_function(name)


class Telemetry:
    """Serve-wide telemetry handle: registry + tracer.

    enabled: master switch — when False every hook is a no-op (no
    clocks read, nothing recorded; the no-host-sync invariant's
    "zero overhead when disabled" leg).  annotate: additionally wrap
    spans in ``torch.profiler.record_function`` so they show up in torch
    profiler timelines.
    """

    def __init__(self, *, enabled: bool = True, annotate: bool = False):
        self.enabled = enabled
        self.annotate = annotate
        self.registry = MetricsRegistry()
        self.tracer = StepTracer()

    # -- hooks (all no-ops when disabled) ----------------------------------
    def span(self, name: str, *, metric: str | None = None, **args):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, metric, args)

    def instant(self, name: str, **args):
        if self.enabled:
            self.tracer.instant(name, args=args or None)

    def inc(self, name: str, n: int = 1, **labels):
        if self.enabled:
            self.registry.inc(name, n, **labels)

    def observe(self, name: str, value: float, **labels):
        if self.enabled:
            self.registry.observe(name, value, **labels)

    def gauge(self, name: str, value: float, **labels):
        if self.enabled:
            self.registry.gauge(name, value, **labels)


NULL_TELEMETRY = Telemetry(enabled=False)
